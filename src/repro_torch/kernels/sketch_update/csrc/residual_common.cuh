// What the residual phases share (kernels 1 and 2 in fused_update.cu,
// kernel 3 in residual.cu): staging with cp.async, the eviction chains'
// insert stream, and the SS± drain as one parallel selection.
//
// The drain. Both plain versions drain rem greedily: while rem > 0 and some
// error is positive, the slot with the largest error (the lowest flat index
// among equals) gives up d = min(rem, error) from its count and its error.
// Each step but the last empties the chosen slot's error, and a slot that
// is not chosen keeps its error, so the steps take the positive errors in
// (error descending, index ascending) order. With F(t) the sum of the
// errors above t, let t* be the least t >= 0 with F(t) <= rem. If t* = 0,
// every positive error drains fully. Else every slot above t* drains fully
// (F(t*) <= rem), and the rest, rem' = rem - F(t*) < t* * #{error == t*},
// is taken t* at a time from the slots at exactly t* in index order: the
// first q = rem' / t* give up t*, the next gives up rem' % t* (if > 0),
// the others nothing. So the drain is a search for t* (passes of kProbes
// thresholds at once, 64-bit sums) and one pass in index order; no chain.
// The kernels differ only in how a count gives up d: kernel 3 with a
// wrapping subtract (the reference's phases.residual_phase), kernels 1 and
// 2 with sat_add (bank.residual_phase_banked); an error gives up d exactly
// in all (0 < d <= error), and so does rem.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kProbes = 7;                       // thresholds per pass: 8-way
constexpr unsigned long long kLow27 = (1ull << 27) - 1;

struct DrainScratch {
  unsigned long long part[kMaxWarps][kProbes];   // per-warp partial sums
  unsigned long long f_hi;                       // F(hi)
  int lo, hi;                                    // F(lo) > rem >= F(hi)
  Scratch red;
};

// n ints from global src to shared dst by cp.async: 16 bytes a thread where
// both are 16-byte aligned, else 4. The caller waits (cp_async_wait).
__device__ void stage(int* dst, const int* src, int n) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const bool vec = ((reinterpret_cast<uintptr_t>(src) | d) & 15) == 0;
  const int nv = vec ? n / 4 : 0;
  for (int i = tid; i < nv; i += nt)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d + 16 * i),
                 "l"(src + 4 * i));
  for (int i = 4 * nv + tid; i < n; i += nt)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d + 4 * i),
                 "l"(src + i));
  asm volatile("cp.async.commit_group;\n" ::);
}

// The (uid, net) of a warp's eviction chain, inserts i0 .. i1 - 1 in
// order, read at h[clip(off + i, 0, last)] (off + i wrapping as the
// reference's int32 add): 32 at a time, one per lane, the next 32 in flight.
struct Inserts {
  const int* uids;
  const int* net;
  int off, last, i0, i1;
  int cu = 0, cw = 0, nu = 0, nw = 0;

  __device__ Inserts(const int* uids, const int* net, int off, int last,
                     int i0, int i1)
      : uids(uids), net(net), off(off), last(last), i0(i0), i1(i1) {
    fetch(i0);
  }

  __device__ void fetch(int i) {
    const int lane = threadIdx.x & 31;
    if (lane < i1 - i) {
      const int g = clip(wrap_add(off, i + lane), 0, last);
      nu = uids[g];
      nw = net[g];
    }
  }

  // insert i's (uid, net); every lane calls it, for i = i0, i0 + 1, ...
  __device__ void get(int i, int& uid, int& w) {
    const int k = (i - i0) & 31;
    if (k == 0) {
      cu = nu;
      cw = nw;
      if (i1 - i > 32) fetch(i + 32);
    }
    uid = __shfl_sync(kFull, cu, k);
    w = __shfl_sync(kFull, cw, k);
  }
};

// Lets `kernel` take `bytes` of dynamic shared memory (past the default
// 48 KB only after this call).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// Waits for this thread's cp.async copies, then for the block's.
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// Block-wide sums of N per-thread values, each below 2^54 (two 27-bit halves
// summed by warp reductions: 32 * (2^27 - 1) < 2^32). Lane j < N of warp 0
// returns sum j; every other thread returns 0. Holds one __syncthreads.
template <int N>
__device__ unsigned long long block_sums(const unsigned long long (&v)[N],
                                         DrainScratch& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const unsigned lo = __reduce_add_sync(kFull, static_cast<unsigned>(v[j] & kLow27));
    const unsigned hi = __reduce_add_sync(kFull, static_cast<unsigned>(v[j] >> 27));
    if (lane == 0)
      sh.part[warp][j] = lo + (static_cast<unsigned long long>(hi) << 27);
  }
  __syncthreads();
  unsigned long long t = 0;
  if (warp == 0 && lane < N)
    for (int w = 0; w < (blockDim.x >> 5); ++w) t += sh.part[w][lane];
  return t;
}

// Threshold j of a search pass over (lo, hi]: lo + (j + 1) * step, at most hi.
__device__ __forceinline__ int probe(int lo, int hi, int step, int j) {
  return static_cast<int>(min(static_cast<long long>(lo) +
                                  static_cast<long long>(j + 1) * step,
                              static_cast<long long>(hi)));
}

// Drains rem > 0 from the n slots (flat index order) whose errors and counts
// are read at er, ct (shared or global) and written at ger, gct (global).
// kSat: counts give up d by sat_add (kernels 1, 2), else by wrapping (3).
// Every thread of the block calls it.
template <bool kSat>
__device__ void drain_select(const int* ct, const int* er, int* gct, int* ger,
                             int n, int rem, DrainScratch& sh) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;

  // 1. the largest error and F(0), the sum of the positive ones
  int mx = kIntMin, unused = 0;
  unsigned long long f0[1] = {0};
  for (int s = tid; s < n; s += nt) {
    const int e = er[s];
    mx = max(mx, e);
    f0[0] += e > 0 ? static_cast<unsigned>(e) : 0u;
  }
  block_arg<true>(mx, unused, sh.red);
  if (mx <= 0) return;
  const unsigned long long total = block_sums<1>(f0, sh);
  if (tid == 0) sh.f_hi = total;  // F(0)
  __syncthreads();
  // the next write to sh follows a __syncthreads every thread reaches
  // after this read
  const bool all = sh.f_hi <= static_cast<unsigned long long>(rem);

  // 2. t*: F(lo) > rem >= F(hi), kProbes thresholds a pass
  int lo = 0, hi = mx;
  unsigned long long f_hi = 0;                   // F(mx) = 0
  while (!all && hi - lo > 1) {
    const int step = static_cast<int>(
        (static_cast<long long>(hi) - lo + kProbes) / (kProbes + 1));
    int t[kProbes];
#pragma unroll
    for (int j = 0; j < kProbes; ++j) t[j] = probe(lo, hi, step, j);
    unsigned long long acc[kProbes] = {};
    for (int s = tid; s < n; s += nt) {
      const int e = er[s];
#pragma unroll
      for (int j = 0; j < kProbes; ++j)
        acc[j] += e > t[j] ? static_cast<unsigned>(e) : 0u;
    }
    const unsigned long long f = block_sums<kProbes>(acc, sh);
    if (warp == 0) {
      // the first threshold whose sum is within rem (t clamps to hi, so
      // one is unless the last probe lies below hi)
      const unsigned ok = __ballot_sync(
          kFull, lane < kProbes && f <= static_cast<unsigned long long>(rem));
      const int j = ok ? __ffs(ok) - 1 : 0;
      const unsigned long long fj = __shfl_sync(kFull, f, j);
      if (lane == 0) {
        if (ok) {
          sh.lo = j ? probe(lo, hi, step, j - 1) : lo;
          sh.hi = probe(lo, hi, step, j);
          sh.f_hi = fj;
        } else {
          sh.lo = t[kProbes - 1];
          sh.hi = hi;
          sh.f_hi = f_hi;
        }
      }
    }
    __syncthreads();
    lo = sh.lo;
    hi = sh.hi;
    f_hi = sh.f_hi;
  }
  const int ts = all ? 0 : hi;
  const unsigned long long rest = all ? 0 : rem - f_hi;
  const unsigned long long q = all ? 0 : rest / static_cast<unsigned>(ts);
  const int last = all ? 0 : static_cast<int>(rest % static_cast<unsigned>(ts));

  // 3. one pass in index order: warp w takes a contiguous run of slots,
  // 32 at a time; a slot at exactly t* learns its rank among those before
  // it from a ballot and the runs before its warp's
  const int per = ((n + nw - 1) / nw + 31) & ~31;
  const long long w0l = static_cast<long long>(warp) * per;
  const int w0 = static_cast<int>(min(w0l, static_cast<long long>(n)));
  const int w1 = static_cast<int>(min(w0l + per, static_cast<long long>(n)));
  int at = 0;
  if (!all)
    for (int s = w0 + lane; s < w1; s += 32) at += er[s] == ts;
  at = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(at)));
  if (lane == 0) sh.red.val[warp] = at;
  __syncthreads();
  long long rank = 0;
  for (int w = 0; w < warp; ++w) rank += sh.red.val[w];
  const unsigned below = (1u << lane) - 1;
  for (int base = w0; base < w1; base += 32) {
    const int s = base + lane;
    const int e = s < w1 ? er[s] : 0;
    const bool eq = !all && s < w1 && e == ts;
    const unsigned b = __ballot_sync(kFull, eq);
    int d = e > ts ? e : 0;
    if (eq) {
      const long long r = rank + __popc(b & below);
      d = r < static_cast<long long>(q) ? ts
          : (r == static_cast<long long>(q) ? last : 0);
    }
    rank += __popc(b);
    if (d > 0) {
      const int c = ct[s];
      gct[s] = kSat ? sat_add(c, -d) : wrap_sub(c, d);
      ger[s] = e - d;
    }
  }
}

}  // namespace
