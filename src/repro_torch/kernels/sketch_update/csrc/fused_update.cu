// Fused SpaceSaving± bank update, one CTA per bank row, for sm_90a.
//
// Replaces the Pallas TPU kernel sketch_update_kernel_fused
// (src/repro/kernels/sketch_update/kernel.py:144, body _fused_kernel_tile
// at :75). Per row, in place and in the reference's order:
//   1. saturating add of the monitored delta;
//   2. bulk empty fill: the j-th residual insert takes the j-th EMPTY slot;
//   3. unit-weight water-fill: search the water level T, then one pass with
//      two prefix counts places every unit insert;
//   4. non-unit inserts evict the minimum-count slot one at a time;
//   5. (SS±, variant 2) the unmonitored deletion weight drains greedily
//      from the maximum-error slots.
// Steps 4-5 are bank.residual_phase_banked, which kernel 2 computes alone.
// A row reads its residual inserts from one flat grouped layout at its own
// offset: the dense prep's (R, B) rows, row r at r * B, or the partition
// prep's runs back to back (bank._fused_partition, reference bank.py:560).
//
// The same file holds kernel 2, residual_banked_kernel: steps 4-5 alone,
// for the split path whose phase 1 ran in torch. It replaces the Pallas
// TPU kernel sketch_residual_kernel_banked (kernel.py:278, body
// _residual_kernel_banked at :258 -> bank.residual_phase_banked).
//
// Rows never read each other, so the TPU grid over row tiles and its
// lockstep "frozen lane" masks become independent CTAs, each running its
// own row's trip counts. Integer semantics are common.cuh's.
#include "residual_common.cuh"

namespace {

// threads per CTA (8 warps). Chosen, not tuned: no other width was timed.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Largest row either kernel stages in shared memory (the caller names the
// layout it expects, and a launch whose name disagrees is refused): the
// row's counts and errors and its 32-slot chunk minima, 195 KB.
constexpr int kStageSlots = 24576;    // kernel 2
constexpr int kFusedStageSlots = 24576;   // kernel 1

__host__ __device__ constexpr int chunks(int K) { return (K + 31) / 32; }

// The eviction chain of one row, carried by warp 0 alone: each insert i in
// [i0, i1), read at h[clip(off + i, 0, g_last)], evicts the first slot at
// the minimum count mc (count sat_add(mc, w), error mc). Counts and errors
// at ct/er (shared or global), written through to gct/ger where staged;
// ids written at gid. cmin[q] holds the minimum count of slots
// 32q .. 32q + 31 on entry and is kept so.
__device__ void banked_chain(int* ct, int* er, int* gid, int* gct, int* ger,
                             bool staged, int* cmin, int K,
                             const int* __restrict__ h_uids,
                             const int* __restrict__ h_net, int off, int i0,
                             int i1, int g_last) {
  const int lane = threadIdx.x & 31;
  const int nc = chunks(K);
  Inserts ins(h_uids, h_net, off, g_last, i0, i1);
  for (int i = i0; i < i1; ++i) {
    int uid, w;
    ins.get(i, uid, w);
    int v = kIntMax, j = kIntMax;
    for (int q = lane; q < nc; q += 32) take_min(v, j, cmin[q], q);
    const int mc = __reduce_min_sync(kFull, v);
    j = __reduce_min_sync(kFull, v == mc ? j : kIntMax);
    // chunk j's minimum is mc: its first slot at mc
    const int s = 32 * j + lane;
    int c = s < K ? ct[s] : kIntMax;
    const int l = __ffs(__ballot_sync(kFull, c == mc)) - 1;
    const int nv = sat_add(mc, w);
    if (lane == l) {
      c = nv;
      ct[s] = nv;
      er[s] = mc;
      gid[s] = uid;
      if (staged) {
        gct[s] = nv;
        ger[s] = mc;
      }
    }
    const int m = __reduce_min_sync(kFull, c);
    if (lane == 0) cmin[j] = m;
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// Kernel 1
//
// What bounds it: the function moves the bank once (a bytes bound), but a
// row's steps are latency chains: each step needs all of the previous one,
// and step 4 is one dependent eviction after another. So the row is staged
// in shared memory once and every step works there (kFusedStageSlots; past
// it, the same code runs on the row in device memory, its chunk minima in
// a scratch):
//   - step 1 reads counts + delta (and the errors by cp.async, where the
//     row drains), summing on the way in, and keeps the minimum of every
//     32-slot chunk; a warp has kBatch chunks' loads in flight at once;
//   - steps 2 and 3's placement take the row in index order as 8 warp runs
//     of whole chunks: a ballot ranks a chunk's slots, one exchange of the
//     runs' totals ranks the runs (one block scan per step, not one per
//     256 slots); each pass that writes a chunk keeps its minimum;
//   - the water level is the reference's bisection, kLevels of its trips
//     per pass over the row: the pass sums n_leq at every threshold the
//     next kLevels trips can probe (the tree of their midpoints), in
//     wrapping uint32 as the reference's int32 sums, then every thread
//     walks the trips with those sums. So T is the bisection's, wrap
//     included. Off the int32 rails a sum is a count and a sum of counts
//     (off_rails), slot by slot a compare and two adds;
//   - steps 4-5 are kernel 2's: banked_chain over the chunk minima, then
//     residual_common.cuh's drain selection (sat_add, as
//     bank.residual_phase_banked);
//   - ids are read only where the row has EMPTY slots to fill, and written
//     through where they change; a staged row's counts (and errors) are
//     written back once.

constexpr int kLevels = 3;                 // bisection trips per pass
constexpr int kNodes = (1 << kLevels) - 1; // thresholds per pass
// 32-slot chunks a warp reads from device memory before it uses the first:
// the loads of a batch are in flight together, not one latency each
constexpr int kBatch = 8;

struct FusedScratch {
  unsigned part[2][kWarps][kNodes];  // per-warp level sums, by pass parity
  int run[kWarps][4];                // per-warp run totals
  DrainScratch drain;
};

// x // 2 with floor rounding (jnp's //), for x >= -(2^31-1)
__device__ __forceinline__ int floor_half(int x) {
  return (x - (x < 0 ? 1 : 0)) / 2;
}

// the bisection's probe of [lo, hi] (phases.waterfill_unit_inserts)
__device__ __forceinline__ int midpoint(int lo, int hi) {
  return sat_add(lo, floor_half(sat_add(hi, -lo)));
}

// #values <= x of the union {c, c+1, ...} clipped to m + 1 (phases.n_leq)
__device__ __forceinline__ unsigned n_leq(int c, int x, int m) {
  if (c > x) return 0u;
  return static_cast<unsigned>(clip(sat_add(x, -c), 0, m)) + 1u;
}

// Warp w's run of the row: whole 32-slot chunks, [w0, w1).
__device__ __forceinline__ void warp_run(int K, int& w0, int& w1) {
  const int per = (chunks(K) + kWarps - 1) / kWarps * 32;
  const long long a = static_cast<long long>(threadIdx.x >> 5) * per;
  w0 = static_cast<int>(min(a, static_cast<long long>(K)));
  w1 = static_cast<int>(min(a + per, static_cast<long long>(K)));
}

// The least count of the row, from its chunk minima; every thread gets it.
__device__ int row_min(const int* cmin, int K) {
  int lo = kIntMax;
  for (int q = threadIdx.x & 31; q < chunks(K); q += 32) lo = min(lo, cmin[q]);
  return __reduce_min_sync(kFull, lo);
}

// Whether the row's water-fill is off both rails: with lo the least count,
// lo > INT_MIN and lo + m <= INT_MAX. Then every probe x and every count c
// <= x lie in [lo, lo + m], so n_leq(c, x) = x - c + 1 exactly (no
// saturation, no clip), and a level sum is (x + 1) #{c <= x} - sum{c <= x},
// which taken mod 2^32 is the reference's int32 sum, wrap included.
__device__ __forceinline__ bool off_rails(int lo, int m) {
  return lo != kIntMin && lo <= kIntMax - m;
}

// The water level T of m > 0 unit inserts over the row's counts ct, the
// bisection of [lo, lo + m] run to its fixed point (see below), kLevels
// trips a pass. lo: the least count; cmin: the chunk minima.
__device__ int water_level(const int* ct, const int* cmin, int K, int lo,
                           int m, FusedScratch& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool exact = off_rails(lo, m);
  int hi = sat_add(lo, m);
  // The reference runs a fixed number of trips (bit_length(R*B) + 1). A
  // trip is a function of (lo, hi) alone, so once a trip changes neither,
  // every later trip repeats it, and stopping there gives the same T. It
  // gets there first: while hi - lo >= 1 each trip shrinks [lo, hi] to at
  // most half, rounded up; from hi == lo a trip is fixed (probe true) or
  // moves lo to hi + 1 (false), which is fixed. That is at most
  // bit_length(m) + 1 trips, and m <= G, the flat layout's length, whose
  // bit_length(G) + 1 trips the reference runs: a row's m units are
  // entries of its own run (m <= B <= R*B = G in the dense layout, m <=
  // G = B in the partition layout).
  for (int buf = 0;; buf ^= 1) {
    // the thresholds of the next kLevels trips: node n's interval and
    // midpoint, its children 2n + 1 (probe true) and 2n + 2 (false)
    int l[kNodes], h[kNodes], mid[kNodes];
    l[0] = lo;
    h[0] = hi;
    int top = kIntMin;
#pragma unroll
    for (int n = 0; n < kNodes; ++n) {
      mid[n] = midpoint(l[n], h[n]);
      top = max(top, mid[n]);
      if (2 * n + 2 < kNodes) {
        l[2 * n + 1] = l[n];
        h[2 * n + 1] = mid[n];
        l[2 * n + 2] = sat_add(mid[n], 1);
        h[2 * n + 2] = h[n];
      }
    }
    // warp-strided chunks; a chunk whose minimum is above every threshold
    // adds nothing. part: the level sums (off the rails: the count and
    // the sum of the counts at or under each threshold)
    unsigned part[kNodes] = {}, under[kNodes] = {};
    for (int base = 32 * warp; base < K; base += kThreads) {
      if (cmin[base >> 5] > top) continue;
      const int s = base + lane;
      if (s >= K) continue;
      const int c = ct[s];
      if (exact) {
#pragma unroll
        for (int n = 0; n < kNodes; ++n) {
          if (c <= mid[n]) {
            ++under[n];
            part[n] += static_cast<unsigned>(c);
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < kNodes; ++n) part[n] += n_leq(c, mid[n], m);
      }
    }
    if (exact) {
#pragma unroll
      for (int n = 0; n < kNodes; ++n)
        part[n] = (static_cast<unsigned>(mid[n]) + 1u) * under[n] - part[n];
    }
#pragma unroll
    for (int n = 0; n < kNodes; ++n) {
      const unsigned t = __reduce_add_sync(kFull, part[n]);
      if (lane == 0) sh.part[buf][warp][n] = t;
    }
    // one barrier a pass: the next pass writes the other buffer, and the
    // one after this buffer only once every thread has passed the next
    // pass's barrier, after its reads below
    __syncthreads();
    // lane n of every warp holds node n's sum
    unsigned sum = 0;
    if (lane < kNodes)
      for (int w = 0; w < kWarps; ++w) sum += sh.part[buf][w][lane];
    for (int n = 0, level = 0; level < kLevels; ++level) {
      const unsigned f = __shfl_sync(kFull, sum, n);
      const bool ge = static_cast<int>(f) >= m;
      const int md = midpoint(lo, hi);
      const int nlo = ge ? lo : sat_add(md, 1), nhi = ge ? md : hi;
      if (nlo == lo && nhi == hi) return lo;
      lo = nlo;
      hi = nhi;
      n = 2 * n + (ge ? 1 : 2);
    }
  }
}

__global__ void __launch_bounds__(kThreads) fused_update_kernel(
    int* __restrict__ ids, int* __restrict__ counts, int* __restrict__ errors,
    const int* __restrict__ delta, const int* __restrict__ h_uids,
    const int* __restrict__ h_net, const int* __restrict__ i0,
    const int* __restrict__ mu, const int* __restrict__ nnu,
    const int* __restrict__ w_del, const int* __restrict__ uoff,
    int* __restrict__ scratch, int K, int G, int variant) {
  extern __shared__ int4 smem4[];
  __shared__ FusedScratch sh;
  const int r = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1;
  const size_t base = static_cast<size_t>(r) * K;
  int* rid = ids + base;
  int* gct = counts + base;
  int* ger = errors + base;
  const int* rd = delta + base;
  // the grouped layout is one flat (G,) array; row r's run starts at
  // uoff[r], or with no uoff (the dense prep's (R, B) rows, G = R * B) at
  // r * B; every read clips to the array, as the reference's bank phases
  // clip to the whole array
  const int g_last = G - 1;
  const int row0 = uoff != nullptr ? uoff[r] : r * (G / gridDim.x);
  const int n_fill = i0[r], m = mu[r], nn = nnu[r];
  const int rem = variant == 1 ? 0 : w_del[r];
  const bool staged = K <= kFusedStageSlots;
  const bool drain = rem > 0;
  const int kp = (K + 3) & ~3;
  int* sm = reinterpret_cast<int*>(smem4);
  int* ct = staged ? sm : gct;
  int* er = staged && drain ? sm + kp : ger;
  int* cmin = staged ? sm + 2 * kp : scratch + static_cast<size_t>(r) * chunks(K);
  int w0, w1;
  warp_run(K, w0, w1);

  // 1. monitored delta, into the staged row; the chunk minima (warp w
  // takes chunks w, w + 8, ...)
  if (staged && drain) stage(er, ger, K);
  for (int b0 = 32 * warp; b0 < K; b0 += kBatch * kThreads) {
    int c[kBatch], d[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int s = b0 + u * kThreads + lane;
      c[u] = s < K ? gct[s] : 0;
      d[u] = s < K ? rd[s] : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int b = b0 + u * kThreads, s = b + lane;
      if (b >= K) break;
      int v = kIntMax;
      if (s < K) {
        v = sat_add(c[u], d[u]);
        ct[s] = v;
      }
      const int mn = __reduce_min_sync(kFull, v);
      if (lane == 0) cmin[b >> 5] = mn;
    }
  }
  if (staged) cp_async_wait();
  else __syncthreads();

  // 2. bulk empty fill: residual inserts [mu + nnu, mu + nnu + i0), the
  // j-th to the j-th EMPTY slot in index order
  if (n_fill > 0) {
    const int off = row0 + m + nn;
    int n_empty = 0;
    for (int b0 = w0; b0 < w1; b0 += 32 * kBatch) {
      bool empty[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int s = b0 + 32 * u + lane;
        empty[u] = s < w1 && rid[s] == -1;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        n_empty += __popc(__ballot_sync(kFull, empty[u]));
    }
    if (lane == 0) sh.run[warp][0] = n_empty;
    __syncthreads();
    int seen = 0;   // EMPTY slots before this warp's next chunk
    for (int w = 0; w < warp; ++w) seen += sh.run[w][0];
    for (int b0 = w0; b0 < w1 && seen < n_fill; b0 += 32 * kBatch) {
      // the batch's fills and their sources, then their loads, then the
      // writes and the chunks' minima
      int src[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int s = b0 + 32 * u + lane;
        const bool empty = s < w1 && rid[s] == -1;
        const unsigned e = __ballot_sync(kFull, empty);
        const int e_rank = seen + __popc(e & below);
        src[u] = empty && e_rank < n_fill
                     ? clip(wrap_add(off, e_rank), 0, g_last) : -1;
        seen += __popc(e);
      }
      int uid[kBatch], net[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (src[u] >= 0) {
          uid[u] = h_uids[src[u]];
          net[u] = h_net[src[u]];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int b = b0 + 32 * u, s = b + lane;
        if (b >= w1) break;
        int c = s < w1 ? ct[s] : kIntMax;
        if (src[u] >= 0) {
          rid[s] = uid[u];
          c = net[u];
          ct[s] = c;
          er[s] = 0;
        }
        const int mn = __reduce_min_sync(kFull, c);
        if (lane == 0) cmin[b >> 5] = mn;
      }
    }
    __syncthreads();
  }

  // 3. unit-weight water-fill of inserts [0, mu)
  if (m > 0) {
    const int lo = row_min(cmin, K);
    const bool exact = off_rails(lo, m);
    const int T = water_level(ct, cmin, K, lo, m, sh), tm1 = wrap_sub(T, 1);
    // a chunk whose minimum is above T holds no slot at or under the
    // level (tm1 < T but where T - 1 wraps)
    const bool skip_ok = T != kIntMin;
    // the level sums at T - 1 (off the rails: the sum of the counts
    // under the level, in p1) and the runs' eligible and under counts
    unsigned p1 = 0, p2 = 0;
    int ne = 0, nu = 0;
    for (int b = w0; b < w1; b += 32) {
      if (skip_ok && cmin[b >> 5] > T) continue;
      const int s = b + lane;
      const bool in = s < w1;
      const int c = in ? ct[s] : 0;
      if (in && exact) {
        if (c <= tm1) p1 += static_cast<unsigned>(c);
      } else if (in) {
        p1 += n_leq(c, tm1, m);
        if (c < tm1) p2 += static_cast<unsigned>(clip(sat_add(tm1, -c), 0, m));
      }
      ne += __popc(__ballot_sync(kFull, in && c <= T));
      nu += __popc(__ballot_sync(kFull, in && c <= tm1));
    }
    p1 = __reduce_add_sync(kFull, p1);
    p2 = __reduce_add_sync(kFull, p2);
    if (lane == 0) {
      sh.run[warp][0] = ne;
      sh.run[warp][1] = nu;
      sh.run[warp][2] = static_cast<int>(p1);
      sh.run[warp][3] = static_cast<int>(p2);
    }
    __syncthreads();
    int seen_e = 0, seen_u = 0;
    unsigned f1 = 0, f2 = 0, n_under = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) {
        seen_e += sh.run[w][0];
        seen_u += sh.run[w][1];
      }
      n_under += static_cast<unsigned>(sh.run[w][1]);
      f1 += static_cast<unsigned>(sh.run[w][2]);
      f2 += static_cast<unsigned>(sh.run[w][3]);
    }
    if (exact) {
      // a slot under the level has T - c values <= T - 1, T - 1 - c of
      // them below T - 1
      const unsigned s_under = f1;
      f1 = static_cast<unsigned>(T) * n_under - s_under;
      f2 = static_cast<unsigned>(tm1) * n_under - s_under;
    }
    const int f_tm1 = static_cast<int>(f1), f_tm2 = static_cast<int>(f2);
    const int extra_n = wrap_sub(m, f_tm1);
    for (int b0 = w0; b0 < w1; b0 += 32 * kBatch) {
      // the batch's counts and sources, then the loads of its uids, then
      // their writes
      int src[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int b = b0 + 32 * u, s = b + lane;
        src[u] = -1;
        if (b >= w1 || (skip_ok && cmin[b >> 5] > T)) continue;
        const bool in = s < w1;
        const int c = in ? ct[s] : kIntMax;
        const bool elig = in && c <= T;
        const bool under = in && c <= tm1;
        const unsigned be = __ballot_sync(kFull, elig);
        const unsigned bu = __ballot_sync(kFull, under);
        const int rank = seen_e + __popc(be & below);
        const int under_before = seen_u + __popc(bu & below);
        const bool extra = elig && rank < extra_n;
        const int t = (under ? clip(sat_add(T, -c), 0, m) : 0) + extra;
        int nc = c;
        if (t > 0) {
          const int pos = extra ? wrap_add(f_tm1, min(rank, extra_n))
                                : wrap_add(f_tm2, under_before);
          src[u] = clip(wrap_add(row0, pos), 0, g_last);
          nc = sat_add(c, t);
          ct[s] = nc;
          er[s] = nc - 1;
        }
        seen_e += __popc(be);
        seen_u += __popc(bu);
        const int mn = __reduce_min_sync(kFull, nc);
        if (lane == 0) cmin[b >> 5] = mn;
      }
      int uid[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (src[u] >= 0) uid[u] = h_uids[src[u]];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (src[u] >= 0) rid[b0 + 32 * u + lane] = uid[u];
    }
    __syncthreads();
  }

  // 4. non-unit inserts [mu, mu + nnu) evict, one warp over the chunk minima
  if (nn > 0) {
    if (warp == 0)
      banked_chain(ct, er, rid, nullptr, nullptr, false, cmin, K, h_uids,
                   h_net, row0, m, m + nn, g_last);
    __syncthreads();
  }

  // 5. SS± only: drain rem from the maximum-error slots
  if (drain) {
    drain_select<true>(ct, er, ct, er, K, rem, sh.drain);
    __syncthreads();
  }

  if (staged) {
    for (int s = tid; s < K; s += kThreads) {
      gct[s] = ct[s];
      if (drain) ger[s] = er[s];
    }
  }
}

// Kernel 1's layout of rows of K slots: 0 staged, 1 unstaged.
int fused_layout(int K) { return K <= kFusedStageSlots ? 0 : 1; }

// Ints of device scratch kernel 1's layout needs over R rows (the unstaged
// layout's chunk minima).
long long fused_scratch_ints(int R, int K) {
  return K <= kFusedStageSlots ? 0 : static_cast<long long>(R) * chunks(K);
}

// ---------------------------------------------------------------------------
// Kernel 2: steps 4-5 alone on a bank whose phase 1 ran outside (the split
// path). Row r reads the flat (G,) layout at uoff[r] + i for i in
// [start[r], n_ins[r]), then drains w_del[r].
//
// What bounds it: the evictions form one dependent chain, so latency, not
// the one read of the working rows the bound counts. So the row's counts
// (and errors where it drains) are staged into shared memory with
// cp.async, where K <= kStageSlots;
// the ids are only written, at the evicted slots. One warp carries the
// evictions over per-chunk minima of 32 slots: a step is a chunk pick (the
// lanes read the chunk minima), a slot pick in the chunk (a lane a slot),
// the write (through to device memory) and the chunk's minimum anew, with
// no __syncthreads. The drain is residual_common.cuh's selection, with
// bank.residual_phase_banked's sat_add. Unlike kernel 3, the eviction's
// argmin is over the counts alone (EMPTY slots included), as the plain
// version's. Two layouts, by K: staged (K <= kStageSlots), and unstaged,
// where the row stays in device memory and its chunk minima go to the
// scratch.
__global__ void __launch_bounds__(kThreads) residual_banked_kernel(
    int* __restrict__ ids, int* __restrict__ counts, int* __restrict__ errors,
    const int* __restrict__ h_uids, const int* __restrict__ h_net,
    const int* __restrict__ uoff, const int* __restrict__ start,
    const int* __restrict__ n_ins, const int* __restrict__ w_del,
    int* __restrict__ scratch, int K, int G, int variant) {
  extern __shared__ int4 smem4[];
  __shared__ DrainScratch dsh;
  const int r = blockIdx.x;
  const int i0 = start[r], i1 = n_ins[r];
  const int rem = variant == 1 ? 0 : w_del[r];
  if (i0 >= i1 && rem <= 0) return;
  const size_t base = static_cast<size_t>(r) * K;
  int* gct = counts + base;
  int* ger = errors + base;
  const bool staged = K <= kStageSlots;
  const int kp = (K + 3) & ~3;
  int* sm = reinterpret_cast<int*>(smem4);
  int* ct = staged ? sm : gct;
  int* er = staged ? sm + kp : ger;
  int* cmin = staged ? sm + 2 * kp : scratch + static_cast<size_t>(r) * chunks(K);
  if (staged) {
    if (i0 < i1) stage(ct, gct, K);
    if (rem > 0) stage(er, ger, K);
    cp_async_wait();
  }
  if (i0 < i1) {
    // the chunk minima, warp w taking chunks w, w + nw, ...
    const int lane = threadIdx.x & 31;
    for (int q = threadIdx.x >> 5; q < chunks(K); q += blockDim.x >> 5) {
      const int s = 32 * q + lane;
      const int m = __reduce_min_sync(kFull, s < K ? ct[s] : kIntMax);
      if (lane == 0) cmin[q] = m;
    }
    __syncthreads();
    if (threadIdx.x < 32)
      banked_chain(ct, er, ids + base, gct, ger, staged, cmin, K, h_uids,
                   h_net, uoff[r], i0, i1, G - 1);
    __syncthreads();
  }
  // the drain reads a count only where it writes one: from device memory,
  // which the chain wrote through
  if (rem > 0) drain_select<true>(gct, er, gct, ger, K, rem, dsh);
}

// Kernel 2's layout of rows of K slots: 0 staged, 1 unstaged.
int banked_layout(int K) { return K <= kStageSlots ? 0 : 1; }

// Ints of device scratch the layout needs over R rows (the unstaged
// layout's chunk minima).
long long banked_scratch_ints(int R, int K) {
  return K <= kStageSlots ? 0 : static_cast<long long>(R) * chunks(K);
}

// Dynamic shared memory of a staged row of K slots (either kernel).
int staged_bytes(int K) { return 4 * (2 * ((K + 3) & ~3) + chunks(K)); }

}  // namespace

// C entry point of kernel 1 (bound with ctypes). `h_uids`/`h_net` are the
// flat (G,) grouped layout, row r's run from `uoff[r]` (`uoff` NULL: the
// (R, B) rows, G = R * B, row r's run at r * B). Launches on `stream`,
// returns cudaGetLastError() as an int (0 = launched). `layout` is the
// caller's name for the layout of rows of K slots and `scratch` holds
// `n_scratch` ints; a launch where either disagrees with what this file
// needs is refused with cudaErrorInvalidValue.
extern "C" int sketch_fused_update(void* ids, void* counts, void* errors,
                                   const void* delta, const void* h_uids,
                                   const void* h_net, const void* i0,
                                   const void* mu, const void* nnu,
                                   const void* w_del, const void* uoff,
                                   void* scratch, int R, int K, int G,
                                   int variant, int layout, int n_scratch,
                                   void* stream) {
  if (layout != fused_layout(K) || n_scratch < fused_scratch_ints(R, K))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = layout == 0 ? staged_bytes(K) : 0;
  const cudaError_t err = allow_smem(fused_update_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_update_kernel<<<R, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(ids), static_cast<int*>(counts),
      static_cast<int*>(errors), static_cast<const int*>(delta),
      static_cast<const int*>(h_uids), static_cast<const int*>(h_net),
      static_cast<const int*>(i0), static_cast<const int*>(mu),
      static_cast<const int*>(nnu), static_cast<const int*>(w_del),
      static_cast<const int*>(uoff), static_cast<int*>(scratch), K, G,
      variant);
  return static_cast<int>(cudaGetLastError());
}

// C entry point of kernel 2 (bound with ctypes); as above.
extern "C" int sketch_residual_banked(void* ids, void* counts, void* errors,
                                      const void* h_uids, const void* h_net,
                                      const void* uoff, const void* start,
                                      const void* n_ins, const void* w_del,
                                      void* scratch, int R, int K, int G,
                                      int variant, int layout, int n_scratch,
                                      void* stream) {
  if (layout != banked_layout(K) || n_scratch < banked_scratch_ints(R, K))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = layout == 0 ? staged_bytes(K) : 0;
  const cudaError_t err = allow_smem(residual_banked_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  residual_banked_kernel<<<R, kThreads, bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(ids), static_cast<int*>(counts),
      static_cast<int*>(errors), static_cast<const int*>(h_uids),
      static_cast<const int*>(h_net), static_cast<const int*>(uoff),
      static_cast<const int*>(start), static_cast<const int*>(n_ins),
      static_cast<const int*>(w_del), static_cast<int*>(scratch), K, G,
      variant);
  return static_cast<int>(cudaGetLastError());
}
