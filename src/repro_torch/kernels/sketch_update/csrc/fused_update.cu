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
// Integer semantics follow the reference exactly: sat_add clamps at
// +-(2^31-1); sums that JAX takes in int32 (and may wrap) are taken in
// unsigned 32-bit here, where wrapping is defined.
#include <cuda_runtime.h>

namespace {

constexpr int kIntMax = 2147483647;
constexpr int kIntMin = -2147483647 - 1;
// threads per CTA: one pass covers 256 slots of the row (13 passes at the
// main path's K = 3200). Chosen, not tuned: no other width was timed.
constexpr int kThreads = 256;
constexpr int kMaxWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Scratch {
  int val[kMaxWarps];
  int idx[kMaxWarps];
  unsigned long long scan[kMaxWarps];
};

__device__ __forceinline__ int sat_add(int a, int b) {
  const int lo = -kIntMax - min(a, 0);
  const int hi = kIntMax - max(a, 0);
  return a + min(max(b, lo), hi);
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__device__ __forceinline__ int clip(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// x // 2 with floor rounding (jnp's //), for x >= -(2^31-1)
__device__ __forceinline__ int floor_half(int x) {
  return (x - (x < 0 ? 1 : 0)) / 2;
}

// #values <= x of the union {c, c+1, ...} clipped to m + 1 (phases.n_leq)
__device__ __forceinline__ unsigned n_leq(int c, int x, int m) {
  if (c > x) return 0u;
  return static_cast<unsigned>(clip(sat_add(x, -c), 0, m)) + 1u;
}

__device__ __forceinline__ void take_min(int& v, int& i, int v2, int i2) {
  if (v2 < v || (v2 == v && i2 < i)) { v = v2; i = i2; }
}

__device__ __forceinline__ void take_max(int& v, int& i, int v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) { v = v2; i = i2; }
}

// Block-wide wrapping sum; every thread gets the total.
__device__ unsigned block_sum(unsigned v, Scratch& sh) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh.val[warp] = static_cast<int>(v);
  __syncthreads();
  unsigned t = 0;
  for (int w = 0; w < nw; ++w) t += static_cast<unsigned>(sh.val[w]);
  return t;
}

// Block-wide (value, index) argmin or argmax, lowest index among equals.
template <bool kMax>
__device__ void block_arg(int& v, int& i, Scratch& sh) {
  for (int o = 16; o > 0; o >>= 1) {
    const int v2 = __shfl_xor_sync(kFull, v, o);
    const int i2 = __shfl_xor_sync(kFull, i, o);
    if (kMax) take_max(v, i, v2, i2); else take_min(v, i, v2, i2);
  }
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) { sh.val[warp] = v; sh.idx[warp] = i; }
  __syncthreads();
  v = sh.val[0];
  i = sh.idx[0];
  for (int w = 1; w < nw; ++w) {
    if (kMax) take_max(v, i, sh.val[w], sh.idx[w]);
    else take_min(v, i, sh.val[w], sh.idx[w]);
  }
}

// Block-wide inclusive scan of one value per thread; *total = block sum.
__device__ unsigned long long block_scan(unsigned long long x,
                                         unsigned long long* total,
                                         Scratch& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();
  if (lane == 31) sh.scan[warp] = x;
  __syncthreads();
  unsigned long long before = 0, all = 0;
  for (int w = 0; w < nw; ++w) {
    if (w < warp) before += sh.scan[w];
    all += sh.scan[w];
  }
  *total = all;
  return x + before;
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

  // 4. non-unit inserts [mu, mu + nnu): evict the minimum count
  if (nn > 0) {
    int lv = kIntMax, li = kIntMax;
    for (int j = tid; j < K; j += nt) take_min(lv, li, rc[j], j);
    for (int i = m; i < m + nn; ++i) {
      int v = lv, sel = li;
      block_arg<false>(v, sel, sh);
      if (sel % nt == tid) {
        const int g = clip(row0 + i, 0, g_last);
        rid[sel] = h_uids[g];
        rc[sel] = sat_add(v, h_net[g]);
        re[sel] = v;
        lv = kIntMax;
        li = kIntMax;
        for (int j = tid; j < K; j += nt) take_min(lv, li, rc[j], j);
      }
    }
  }

  // 5. SS± only: drain w_del from the maximum-error slots
  int rem = w_del[r];
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
