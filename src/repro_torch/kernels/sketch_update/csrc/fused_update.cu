// Fused SpaceSaving± bank update, one CTA per bank row, for sm_90a.
//
// Replaces the Pallas TPU kernel sketch_update_kernel_fused
// (src/repro/kernels/sketch_update/kernel.py:144, body _fused_kernel_tile
// at :75). Per row, in place and in the reference's order:
//   1. saturating add of the monitored delta;
//   2. bulk empty fill: the j-th residual insert takes the j-th EMPTY slot;
//   3. unit-weight water-fill: bisect the water level T, then one pass with
//      two prefix counts places every unit insert;
//   4. non-unit inserts evict the minimum-count slot one at a time;
//   5. (SS±, variant 2) the unmonitored deletion weight drains greedily
//      from the maximum-error slots.
//
// The same file holds kernel 2, residual_banked_kernel: steps 4-5 alone,
// for the split path whose phase 1 ran in torch. It replaces the Pallas
// TPU kernel sketch_residual_kernel_banked (kernel.py:278, body
// _residual_kernel_banked at :258 -> bank.residual_phase_banked). It has
// its own steps 4-5 (banked_chain and residual_common.cuh's drain), not
// kernel 1's evict_then_spread.
//
// Rows never read each other, so the TPU grid over row tiles and its
// lockstep "frozen lane" masks become independent CTAs, each running its
// own row's trip counts. The row stays in global memory (L2-resident), so
// any K is legal. Slot j of a row is only ever read and written by thread
// j % blockDim.x; threads meet only in block reductions and scans (warp
// shuffles plus a small shared scratch).
//
// Bound: the function moves the bank (ids/counts/errors read and written,
// delta read) and reads the few grouped-layout entries each row uses; its
// integer work per slot is small, so it is bound by bytes. The sequential
// eviction/spread loops are latency chains of block reductions; each
// thread keeps the running min/max of its own slots so a trip rescans only
// the one slot's owner.
//
// Integer semantics and the reductions are common.cuh's.
#include "residual_common.cuh"

namespace {

// threads per CTA: one pass covers 256 slots of the row (13 passes at the
// main path's K = 3200). Chosen, not tuned: no other width was timed.
constexpr int kThreads = 256;

// x // 2 with floor rounding (jnp's //), for x >= -(2^31-1)
__device__ __forceinline__ int floor_half(int x) {
  return (x - (x < 0 ? 1 : 0)) / 2;
}

// #values <= x of the union {c, c+1, ...} clipped to m + 1 (phases.n_leq)
__device__ __forceinline__ unsigned n_leq(int c, int x, int m) {
  if (c > x) return 0u;
  return static_cast<unsigned>(clip(sat_add(x, -c), 0, m)) + 1u;
}

// Steps 4-5 on one row of K slots: the inserts i in [i_begin, i_end),
// read at h[clip(off + i, 0, g_last)], each evict the minimum-count slot;
// then (SS±) the deletion weight rem drains from the maximum-error slots.
// The fused kernel runs it after steps 1-3; residual_banked_kernel alone.
__device__ void evict_then_spread(int* __restrict__ rid, int* __restrict__ rc,
                                  int* __restrict__ re, int K,
                                  const int* __restrict__ h_uids,
                                  const int* __restrict__ h_net, int off,
                                  int i_begin, int i_end, int g_last, int rem,
                                  int variant, Scratch& sh) {
  const int tid = threadIdx.x, nt = blockDim.x;
  // 4. non-unit inserts: evict the minimum count
  if (i_begin < i_end) {
    int lv = kIntMax, li = kIntMax;
    for (int j = tid; j < K; j += nt) take_min(lv, li, rc[j], j);
    for (int i = i_begin; i < i_end; ++i) {
      int v = lv, sel = li;
      block_arg<false>(v, sel, sh);
      if (sel % nt == tid) {
        const int g = clip(wrap_add(off, i), 0, g_last);
        rid[sel] = h_uids[g];
        rc[sel] = sat_add(v, h_net[g]);
        re[sel] = v;
        lv = kIntMax;
        li = kIntMax;
        for (int j = tid; j < K; j += nt) take_min(lv, li, rc[j], j);
      }
    }
  }

  // 5. SS± only: drain rem from the maximum-error slots
  if (variant != 1 && rem > 0) {
    int lv = kIntMin, li = kIntMax;
    for (int j = tid; j < K; j += nt) take_max(lv, li, re[j], j);
    for (;;) {
      int v = lv, sel = li;
      block_arg<true>(v, sel, sh);
      if (!(rem > 0 && v > 0)) break;
      const int d = min(rem, v);
      if (sel % nt == tid) {
        rc[sel] = sat_add(rc[sel], -d);
        re[sel] = sat_add(re[sel], -d);
        lv = kIntMin;
        li = kIntMax;
        for (int j = tid; j < K; j += nt) take_max(lv, li, re[j], j);
      }
      rem = sat_add(rem, -d);
    }
  }
}

__global__ void __launch_bounds__(kThreads) fused_update_kernel(int* __restrict__ ids,
                                    int* __restrict__ counts,
                                    int* __restrict__ errors,
                                    const int* __restrict__ delta,
                                    const int* __restrict__ h_uids,
                                    const int* __restrict__ h_net,
                                    const int* __restrict__ i0,
                                    const int* __restrict__ mu,
                                    const int* __restrict__ nnu,
                                    const int* __restrict__ w_del,
                                    int K, int B, int variant) {
  __shared__ Scratch sh;
  const int r = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t base = static_cast<size_t>(r) * K;
  int* rid = ids + base;
  int* rc = counts + base;
  int* re = errors + base;
  const int* rd = delta + base;
  // the grouped layout is one flat (R*B,) array; row r's run starts at r*B
  const int g_last = gridDim.x * B - 1;
  const int row0 = r * B;
  const int n_fill = i0[r], m = mu[r], nn = nnu[r];

  // 1. monitored delta
  for (int j = tid; j < K; j += nt) rc[j] = sat_add(rc[j], rd[j]);

  // 2. bulk empty fill: residual inserts [mu + nnu, mu + nnu + i0)
  if (n_fill > 0) {
    const int off = row0 + m + nn;
    int seen = 0;
    for (int t0 = 0; t0 < K && seen < n_fill; t0 += nt) {
      const int j = t0 + tid;
      const bool empty = j < K && rid[j] == -1;
      unsigned long long total;
      const int e_rank = seen + static_cast<int>(block_scan(empty, &total, sh)) - 1;
      if (empty && e_rank < n_fill) {
        const int src = clip(wrap_add(off, e_rank), 0, g_last);
        rid[j] = h_uids[src];
        rc[j] = h_net[src];
        re[j] = 0;
      }
      seen += static_cast<int>(total);
    }
  }

  // 3. unit-weight water-fill of inserts [0, mu)
  if (m > 0) {
    int lo = kIntMax, unused = kIntMax;
    for (int j = tid; j < K; j += nt) take_min(lo, unused, rc[j], j);
    block_arg<false>(lo, unused, sh);
    int hi = sat_add(lo, m);
    // The reference runs a fixed number of trips (bit_length(R*B) + 1).
    // A trip is a function of (lo, hi) alone, so once a trip changes
    // neither, every later trip repeats it, and stopping there gives the
    // same T. It gets there first: while hi - lo >= 1 each trip shrinks
    // [lo, hi] to at most half, rounded up; from hi == lo a trip is fixed
    // (probe true) or moves lo to hi + 1 (false), which is fixed. That is
    // at most bit_length(m) + 1 trips, and m <= B <= R*B.
    for (;;) {
      const int mid = sat_add(lo, floor_half(sat_add(hi, -lo)));
      unsigned part = 0;
      for (int j = tid; j < K; j += nt) part += n_leq(rc[j], mid, m);
      const bool ge = static_cast<int>(block_sum(part, sh)) >= m;
      const int nlo = ge ? lo : sat_add(mid, 1), nhi = ge ? mid : hi;
      if (nlo == lo && nhi == hi) break;
      lo = nlo;
      hi = nhi;
    }
    const int T = lo, tm1 = wrap_sub(T, 1);
    unsigned p1 = 0, p2 = 0;
    for (int j = tid; j < K; j += nt) {
      const int c = rc[j];
      p1 += n_leq(c, tm1, m);
      if (c < tm1) p2 += static_cast<unsigned>(clip(sat_add(tm1, -c), 0, m));
    }
    const int f_tm1 = static_cast<int>(block_sum(p1, sh));
    const int f_tm2 = static_cast<int>(block_sum(p2, sh));
    const int extra_n = wrap_sub(m, f_tm1);
    int seen_e = 0, seen_u = 0;
    for (int t0 = 0; t0 < K; t0 += nt) {
      const int j = t0 + tid;
      const bool in = j < K;
      const int c = in ? rc[j] : 0;
      const bool elig = in && c <= T;
      const bool under = in && c <= tm1;
      unsigned long long total;
      const unsigned long long inc = block_scan(
          (static_cast<unsigned long long>(elig) << 32) | under, &total, sh);
      const int rank = seen_e + static_cast<int>(inc >> 32) - 1;
      const int below = seen_u + static_cast<int>(inc & 0xffffffffu) - under;
      const bool extra = elig && rank < extra_n;
      const int t = (under ? clip(sat_add(T, -c), 0, m) : 0) + extra;
      if (in && t > 0) {
        const int pos = extra ? wrap_add(f_tm1, min(rank, extra_n))
                              : wrap_add(f_tm2, below);
        const int nc = sat_add(c, t);
        rid[j] = h_uids[clip(wrap_add(row0, pos), 0, g_last)];
        rc[j] = nc;
        re[j] = nc - 1;
      }
      seen_e += static_cast<int>(total >> 32);
      seen_u += static_cast<int>(total & 0xffffffffu);
    }
  }

  // 4-5. non-unit inserts [mu, mu + nnu), then the SS± spread of w_del
  evict_then_spread(rid, rc, re, K, h_uids, h_net, row0, m, m + nn, g_last,
                    w_del[r], variant, sh);
}

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
// version's. Two layouts, by K (the caller names the one it expects, and
// a launch whose name disagrees is refused): staged (K <= kStageSlots),
// and unstaged, where the row stays in device memory and its chunk minima
// go to the scratch.
constexpr int kStageSlots = 24576;   // counts + errors: 192 KB

__host__ __device__ constexpr int chunks(int K) { return (K + 31) / 32; }

// The eviction chain of one row, carried by warp 0 alone: each insert i in
// [i0, i1), read at h[clip(off + i, 0, g_last)], evicts the first slot at
// the minimum count mc (count sat_add(mc, w), error mc). Counts and errors
// at ct/er (shared or global), written through to gct/ger where staged;
// ids written at gid.
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

}  // namespace

// C entry point (bound with ctypes). Launches on `stream`, returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int sketch_fused_update(void* ids, void* counts, void* errors,
                                   const void* delta, const void* h_uids,
                                   const void* h_net, const void* i0,
                                   const void* mu, const void* nnu,
                                   const void* w_del, int R, int K, int B,
                                   int variant, void* stream) {
  fused_update_kernel<<<R, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(ids), static_cast<int*>(counts),
      static_cast<int*>(errors), static_cast<const int*>(delta),
      static_cast<const int*>(h_uids), static_cast<const int*>(h_net),
      static_cast<const int*>(i0), static_cast<const int*>(mu),
      static_cast<const int*>(nnu), static_cast<const int*>(w_del), K, B,
      variant);
  return static_cast<int>(cudaGetLastError());
}

// C entry point of kernel 2 (bound with ctypes); as above. `layout` is the
// caller's name for the layout of rows of K slots and `scratch` holds
// `n_scratch` ints; a launch where either disagrees with what this file
// needs is refused with cudaErrorInvalidValue.
extern "C" int sketch_residual_banked(void* ids, void* counts, void* errors,
                                      const void* h_uids, const void* h_net,
                                      const void* uoff, const void* start,
                                      const void* n_ins, const void* w_del,
                                      void* scratch, int R, int K, int G,
                                      int variant, int layout, int n_scratch,
                                      void* stream) {
  if (layout != banked_layout(K) || n_scratch < banked_scratch_ints(R, K))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = layout == 0 ? 4 * (2 * ((K + 3) & ~3) + chunks(K)) : 0;
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
