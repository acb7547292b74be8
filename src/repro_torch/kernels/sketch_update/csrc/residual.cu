// Phase 2 of E stacked single sketches, one CTA per sketch, for sm_90a.
//
// Replaces the Pallas TPU kernel sketch_residual_kernel
// (src/repro/kernels/sketch_update/kernel.py:220, body _residual_kernel at
// :203 -> phases.residual_phase at src/repro/sketch/phases.py:287), which
// the reference vmaps over stacked sketches. Each sketch is viewed as
// (R, 128) rows (phases.pad_rows: padding slots BLOCKED, INT_MAX, 0, inert
// here). In place and in the reference's order:
//   1. per-row summaries: has an EMPTY slot, minimum count (EMPTY slots
//      counted as INT_MAX), maximum error;
//   2. for each insert i in [start, n_ins) of the grouped residual layout,
//      a two-level tournament: the first row with an EMPTY slot, else the
//      first row at the minimum row minimum; within it, the first EMPTY
//      column, else the first minimum-count column. The slot takes the id,
//      count has_empty ? w : sat_add(mc, w) and error has_empty ? 0 : mc,
//      where mc is the minimum over all rows; the row's summaries are then
//      refreshed;
//   3. (SS±, variant 2) while rem = w_del > 0 and some error is positive,
//      the first column at the maximum of the first row at the maximum row
//      error gives up d = min(rem, error) from its count and its error with
//      a plain wrapping subtract (not sat_add, as in the reference).
//
// The row summaries live in a global scratch of (3, E, R) ints that the
// wrapper allocates, so any R (any k) is legal. Warp w summarises rows
// w, w + 8, ...; a tournament is one strided pass of every thread over the
// R summaries and two block reductions; the chosen row is rewritten and
// re-summarised by warp 0 alone, whose lane l owns columns l + 32 j.
//
// Bound: each step reads O(R + 128) ints and the loop is a chain of
// dependent block reductions, so the kernel is bound by that latency, not
// by bytes or operations; its least work is one read of the state and the
// few slots it writes (chip_smoke.py counts it).
#include "common.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;

// Warp-wide summaries of row r, written by lane 0.
__device__ void summarize_row(const int* id, const int* ct, const int* er,
                              int r, int* he, int* mn, int* mx) {
  const int lane = threadIdx.x & 31;
  const size_t o = static_cast<size_t>(r) * kLanes;
  bool any_empty = false;
  int lo = kIntMax, hi = kIntMin;
  for (int c = lane; c < kLanes; c += 32) {
    const bool empty = id[o + c] == -1;
    any_empty |= empty;
    lo = min(lo, empty ? kIntMax : ct[o + c]);
    hi = max(hi, er[o + c]);
  }
  any_empty = __any_sync(kFull, any_empty);
  for (int s = 16; s > 0; s >>= 1) {
    lo = min(lo, __shfl_xor_sync(kFull, lo, s));
    hi = max(hi, __shfl_xor_sync(kFull, hi, s));
  }
  if (lane == 0) {
    he[r] = any_empty;
    mn[r] = lo;
    mx[r] = hi;
  }
}

__global__ void __launch_bounds__(kThreads) residual_kernel(
    int* __restrict__ ids, int* __restrict__ counts, int* __restrict__ errors,
    const int* __restrict__ r_uids, const int* __restrict__ r_net,
    const int* __restrict__ start, const int* __restrict__ n_ins,
    const int* __restrict__ w_del, int* __restrict__ summary, int E, int R,
    int B, int variant) {
  __shared__ Scratch sh;
  const int e = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
  const size_t base = static_cast<size_t>(e) * R * kLanes;
  int* id = ids + base;
  int* ct = counts + base;
  int* er = errors + base;
  const int* uids = r_uids + static_cast<size_t>(e) * B;
  const int* net = r_net + static_cast<size_t>(e) * B;
  int* he = summary + static_cast<size_t>(e) * R;
  int* mn = he + static_cast<size_t>(E) * R;
  int* mx = mn + static_cast<size_t>(E) * R;

  // 1. per-row summaries
  for (int r = warp; r < R; r += nw) summarize_row(id, ct, er, r, he, mn, mx);
  __syncthreads();

  // 2. evictions of the non-unit residual inserts
  const int i_end = n_ins[e];
  for (int i = start[e]; i < i_end; ++i) {
    int ev = kIntMax, ei = kIntMax, mv = kIntMax, mi = kIntMax;
    for (int r = tid; r < R; r += nt) {
      if (he[r] && r < ev) ev = ei = r;
      take_min(mv, mi, mn[r], r);
    }
    block_arg<false>(ev, ei, sh);
    block_arg<false>(mv, mi, sh);
    const bool has_empty = ev != kIntMax;
    const int r_sel = has_empty ? ev : mi;
    const int mc = mv;
    if (warp == 0) {
      const size_t o = static_cast<size_t>(r_sel) * kLanes;
      int ce = kIntMax, cunused = kIntMax, cv = kIntMax, ci = kIntMax;
      for (int c = lane; c < kLanes; c += 32) {
        const bool empty = id[o + c] == -1;
        if (empty && c < ce) ce = cunused = c;
        take_min(cv, ci, empty ? kIntMax : ct[o + c], c);
      }
      warp_arg<false>(ce, cunused);
      warp_arg<false>(cv, ci);
      const int c_sel = has_empty ? ce : ci;
      if (lane == 0) {
        const int g = clip(i, 0, B - 1);
        const int w = net[g];
        id[o + c_sel] = uids[g];
        ct[o + c_sel] = has_empty ? w : sat_add(mc, w);
        er[o + c_sel] = has_empty ? 0 : mc;
      }
      __syncwarp();
      summarize_row(id, ct, er, r_sel, he, mn, mx);
    }
    __syncthreads();
  }

  // 3. SS± only: drain w_del from the maximum-error slots
  if (variant == 1) return;
  int rem = w_del[e];
  for (;;) {
    int v = kIntMin, r_max = kIntMax;
    for (int r = tid; r < R; r += nt) take_max(v, r_max, mx[r], r);
    block_arg<true>(v, r_max, sh);
    if (!(rem > 0 && v > 0)) break;
    // v is row r_max's maximum error exactly (the summaries are refreshed
    // after every write), so the slot found below gives up d
    const int d = min(rem, v);
    if (warp == 0) {
      const size_t o = static_cast<size_t>(r_max) * kLanes;
      int cv = kIntMin, ci = kIntMax;
      for (int c = lane; c < kLanes; c += 32) take_max(cv, ci, er[o + c], c);
      warp_arg<true>(cv, ci);
      if (lane == 0) {
        ct[o + ci] = wrap_sub(ct[o + ci], d);
        er[o + ci] = wrap_sub(er[o + ci], d);
      }
      __syncwarp();
      summarize_row(id, ct, er, r_max, he, mn, mx);
    }
    rem -= d;
    __syncthreads();
  }
}

}  // namespace

// C entry point (bound with ctypes). Launches on `stream`, returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int sketch_residual(void* ids, void* counts, void* errors,
                               const void* r_uids, const void* r_net,
                               const void* start, const void* n_ins,
                               const void* w_del, void* summary, int E, int R,
                               int B, int variant, void* stream) {
  residual_kernel<<<E, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(ids), static_cast<int*>(counts),
      static_cast<int*>(errors), static_cast<const int*>(r_uids),
      static_cast<const int*>(r_net), static_cast<const int*>(start),
      static_cast<const int*>(n_ins), static_cast<const int*>(w_del),
      static_cast<int*>(summary), E, R, B, variant);
  return static_cast<int>(cudaGetLastError());
}
