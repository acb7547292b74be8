// Phase 2 of E stacked single sketches, for sm_90a.
//
// Replaces the Pallas TPU kernel sketch_residual_kernel
// (src/repro/kernels/sketch_update/kernel.py:220, body _residual_kernel at
// :203 -> phases.residual_phase at src/repro/sketch/phases.py:287), which
// the reference vmaps over stacked sketches. Each sketch is viewed as
// (R, 128) rows (phases.pad_rows: padding slots BLOCKED, INT_MAX, 0, inert
// here). In place and in the reference's order:
//   1. each insert i in [start, n_ins) of the grouped residual layout (read
//      at clip(i, 0, B - 1)) takes the first EMPTY slot in flat order if
//      the sketch has one (count w, error 0), else the first slot at the
//      minimum count mc (count sat_add(mc, w), error mc);
//   2. (SS±, variant 2) rem = w_del drains from the maximum-error slots,
//      each giving up d = min(rem, error) from its count and its error by a
//      plain wrapping subtract (not sat_add, as in the reference).
//
// What bounds it: the evictions form one dependent chain, so latency, not
// the one read of the state the bound counts (chip_smoke.py); the design
// keeps each step short and out of device memory, and the drain out of
// the chain:
//   - A sketch with no insert to place and nothing to drain returns at once.
//   - Row summaries: per row of 128 slots, the minimum count over non-EMPTY
//     slots, the first column at it and the first EMPTY column, so a pick
//     needs no column scan. One warp carries the chain and refreshes a
//     row's summary from the four slots per lane it has just read; no
//     __syncthreads per step. Staged, the warp keeps the row summaries in
//     registers; unstaged, in shared memory, under a second level per
//     group of 32 rows (the minimum of its rows' minima, and whether one
//     of them has an EMPTY slot).
//   - The drain is not a chain: residual_common.cuh's selection.
// Three layouts, by R (the caller names the one it expects, and a launch
// whose name disagrees is refused):
//   - staged (R <= kStageRows = 128, k <= 16,384): one CTA per sketch copies
//     ids and counts (and errors where it drains) into shared memory with
//     cp.async, summarises the rows there and runs the chain and the drain
//     there, writing each changed slot through to device memory;
//   - unstaged (R > 128): the rows stay in device memory (L2-resident after
//     the first pass). A summary pass spreads every sketch's rows over the
//     card, one CTA per group of 32 rows; a second launch on the same stream
//     runs the chain and the drain, one CTA per sketch, with the summaries
//     copied into shared memory (summary+chain: R <= kSumRows = 8,192, k <=
//     1,048,576) or read from the scratch (summary+chain/scratch: any
//     larger R). Two launches, not one with a last-CTA ticket: a ticket
//     needs a counter zeroed before every launch, which costs a launch
//     too, plus fences between CTAs.
#include "residual_common.cuh"

namespace {

constexpr int kLanes = 128;      // slots per row
constexpr int kThreads = 256;
constexpr int kStageRows = 128;  // largest R of the staged layout
constexpr int kSumRows = 8192;   // largest R with summaries in shared memory
constexpr int kNone = kLanes;    // "no EMPTY column"

__host__ __device__ constexpr int groups(int R) { return (R + 31) / 32; }

// The summary of one row from the slots 4 * lane + q (q < 4) each lane holds:
// mn, the minimum count with EMPTY slots as INT_MAX; cols, the first column
// at mn | the first EMPTY column << 8 (kNone if none). Every lane gets both.
__device__ __forceinline__ void row_summary(const int (&id)[4],
                                            const int (&ct)[4], int& mn,
                                            int& cols) {
  const int lane = threadIdx.x & 31;
  int lv = kIntMax, lc = kNone, fe = kNone;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = 4 * lane + q;
    const bool empty = id[q] == -1;
    if (empty && fe == kNone) fe = c;
    take_min(lv, lc, empty ? kIntMax : ct[q], c);
  }
  // a lane's columns are 4 lane + q: the lowest lane at the minimum (or
  // with an EMPTY slot) holds the lowest column
  mn = __reduce_min_sync(kFull, lv);
  const int c = __shfl_sync(kFull, lc, __ffs(__ballot_sync(kFull, lv == mn)) - 1);
  const unsigned eb = __ballot_sync(kFull, fe != kNone);
  cols = c | (eb ? __shfl_sync(kFull, fe, __ffs(eb) - 1) : kNone) << 8;
}

__device__ __forceinline__ void load_row(const int* id, const int* ct, int r,
                                         int (&idv)[4], int (&ctv)[4]) {
  const int lane = threadIdx.x & 31;
  const int4 a = reinterpret_cast<const int4*>(id + static_cast<size_t>(r) * kLanes)[lane];
  const int4 b = reinterpret_cast<const int4*>(ct + static_cast<size_t>(r) * kLanes)[lane];
  idv[0] = a.x; idv[1] = a.y; idv[2] = a.z; idv[3] = a.w;
  ctv[0] = b.x; ctv[1] = b.y; ctv[2] = b.z; ctv[3] = b.w;
}

// Slot q of the four a lane holds takes (uid, nc) where `mine`: selects,
// not an indexed store, so the slots stay in registers.
__device__ __forceinline__ void put_slot(int (&idv)[4], int (&ctv)[4],
                                         bool mine, int q, int uid, int nc) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool hit = mine && j == q;
    idv[j] = hit ? uid : idv[j];
    ctv[j] = hit ? nc : ctv[j];
  }
}

// Group g's summary from its rows' (lane l: row 32 g + l; rows past R hold
// INT_MAX and no EMPTY column), written by lane 0.
__device__ __forceinline__ void put_group(int g, int mn, int cols, int* gmin,
                                          int* gemp) {
  const int m = __reduce_min_sync(kFull, mn);
  const bool e = __any_sync(kFull, (cols >> 8) != kNone);
  if ((threadIdx.x & 31) == 0) {
    gmin[g] = m;
    gemp[g] = e;
  }
}

// Every row's summary of one staged sketch, warp w taking rows w, w + nw,
// ... Every thread calls it.
__device__ void summarize(const int* id, const int* ct, int R, int* rmin,
                          int* rcol) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < R; r += blockDim.x >> 5) {
    int idv[4], ctv[4], mn, cols;
    load_row(id, ct, r, idv, ctv);
    row_summary(idv, ctv, mn, cols);
    if (lane == 0) {
      rmin[r] = mn;
      rcol[r] = cols;
    }
  }
  __syncthreads();
}

// The eviction chain of a staged sketch (R <= 32 * NQ), carried by warp 0
// alone with the row summaries in registers: lane l holds rows NQ l + q,
// q < NQ, so the lowest lane at the minimum (or with an EMPTY slot) holds
// the lowest such row. A step is one warp reduction and two ballots (the
// first row with an EMPTY slot, else the first at the minimum), the row's
// slots from shared memory (lane l: slots 4 l .. 4 l + 3), the write, and
// the row's summary anew. A lane reads and writes only its own four slots
// of a row and its own summaries, so the steps need no __syncwarp. Writes
// go through to device memory (gid/gct/ger). unstaged_chain's group and
// row picks over the staged copy took 1.5x as long per eviction on an
// H100 (tools/residual_ab.py, the block-lazy block).
template <int NQ>
__device__ void staged_chain(int* id, int* ct, int* er, int* gid, int* gct,
                             int* ger, const int* rmin, const int* rcol,
                             int R, const int* uids, const int* net, int B,
                             int i0, int i1) {
  const int lane = threadIdx.x & 31;
  int rmn[NQ], rcl[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int r = NQ * lane + q;
    rmn[q] = r < R ? rmin[r] : kIntMax;
    rcl[q] = r < R ? rcol[r] : kNone << 8;
  }
  Inserts ins(uids, net, 0, B - 1, i0, i1);
  for (int i = i0; i < i1; ++i) {
    int uid, w;
    ins.get(i, uid, w);

    // this lane's first row at its minimum and first row with an EMPTY slot
    int lv = rmn[0], lq = 0, le = (rcl[0] >> 8) != kNone ? 0 : -1;
#pragma unroll
    for (int q = 1; q < NQ; ++q) {
      if (rmn[q] < lv) {
        lv = rmn[q];
        lq = q;
      }
      if (le < 0 && (rcl[q] >> 8) != kNone) le = q;
    }
    const unsigned eb = __ballot_sync(kFull, le >= 0);
    const int mc = __reduce_min_sync(kFull, lv);
    const bool has_empty = eb != 0;
    const int owner = __ffs(has_empty ? eb : __ballot_sync(kFull, lv == mc)) - 1;
    const int qm = has_empty ? le : lq;
    int cols_m = rcl[0];
#pragma unroll
    for (int q = 1; q < NQ; ++q)
      if (q == qm) cols_m = rcl[q];
    const int sel = __shfl_sync(kFull, qm << 16 | cols_m, owner);
    const int qs = sel >> 16, rs = NQ * owner + qs;
    const int c = has_empty ? (sel >> 8) & 0xff : sel & 0xff;

    int idv[4], ctv[4];
    load_row(id, ct, rs, idv, ctv);
    const int nc = has_empty ? w : sat_add(mc, w);
    const int ne = has_empty ? 0 : mc;
    const bool mine = lane == c >> 2;
    put_slot(idv, ctv, mine, c & 3, uid, nc);
    if (mine) {
      const size_t o = static_cast<size_t>(rs) * kLanes + c;
      id[o] = uid;
      ct[o] = nc;
      er[o] = ne;
      gid[o] = uid;
      gct[o] = nc;
      ger[o] = ne;
    }
    int mn2, cols2;
    row_summary(idv, ctv, mn2, cols2);
    if (lane == owner) {
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        if (q == qs) {
          rmn[q] = mn2;
          rcl[q] = cols2;
        }
    }
  }
}

// The eviction chain of an unstaged sketch, carried by warp 0 alone: the
// rows in device memory, their summaries and the group summaries at
// rmin/rcol/gmin/gemp (shared memory, or the scratch past kSumRows). A
// step picks a group from the group summaries, a row from its 32 row
// summaries, writes, and refreshes the row's and the group's summaries.
__device__ void unstaged_chain(int* id, int* ct, int* er, int* rmin,
                               int* rcol, int* gmin, int* gemp, int R,
                               const int* uids, const int* net, int B, int i0,
                               int i1) {
  const int lane = threadIdx.x & 31;
  const int G = groups(R);
  Inserts ins(uids, net, 0, B - 1, i0, i1);
  for (int i = i0; i < i1; ++i) {
    int uid, w;
    ins.get(i, uid, w);

    // the group: the first with an EMPTY slot, else the first at the minimum
    int ge = kIntMax, gv = kIntMax, gi = kIntMax;
    for (int j = lane; j < G; j += 32) {
      if (gemp[j] && ge == kIntMax) ge = j;
      take_min(gv, gi, gmin[j], j);
    }
    ge = __reduce_min_sync(kFull, ge);
    const int mc = __reduce_min_sync(kFull, gv);
    const bool has_empty = ge != kIntMax;
    const int g = has_empty ? ge : __reduce_min_sync(kFull, gv == mc ? gi : kIntMax);

    // the row: lane l holds row 32 g + l's summary
    const int r = 32 * g + lane;
    int mn = r < R ? rmin[r] : kIntMax;
    int cols = r < R ? rcol[r] : kNone << 8;
    const int l = __ffs(__ballot_sync(
        kFull, has_empty ? (cols >> 8) != kNone : mn == mc)) - 1;
    const int rs = 32 * g + l;
    const int sel_cols = __shfl_sync(kFull, cols, l);
    const int c = has_empty ? sel_cols >> 8 : sel_cols & 0xff;

    // the write, into the row the lanes have just read
    int idv[4], ctv[4];
    load_row(id, ct, rs, idv, ctv);
    const int nc = has_empty ? w : sat_add(mc, w);
    const int ne = has_empty ? 0 : mc;
    const bool mine = lane == c >> 2;
    put_slot(idv, ctv, mine, c & 3, uid, nc);
    if (mine) {
      const size_t o = static_cast<size_t>(rs) * kLanes + c;
      id[o] = uid;
      ct[o] = nc;
      er[o] = ne;
    }

    // the row's summary and its group's anew
    int mn2, cols2;
    row_summary(idv, ctv, mn2, cols2);
    if (lane == l) {
      mn = mn2;
      cols = cols2;
    }
    if (lane == 0) {
      rmin[rs] = mn2;
      rcol[rs] = cols2;
    }
    put_group(g, mn, cols, gmin, gemp);
    __syncwarp();
  }
}

// The staged layout: one CTA per sketch, everything in shared memory.
__global__ void __launch_bounds__(kThreads) residual_staged_kernel(
    int* __restrict__ ids, int* __restrict__ counts, int* __restrict__ errors,
    const int* __restrict__ r_uids, const int* __restrict__ r_net,
    const int* __restrict__ start, const int* __restrict__ n_ins,
    const int* __restrict__ w_del, int R, int B, int variant) {
  extern __shared__ int4 smem4[];
  __shared__ DrainScratch dsh;
  const int e = blockIdx.x;
  const int i0 = start[e], i1 = n_ins[e];
  const int rem = variant == 1 ? 0 : w_del[e];
  if (i0 >= i1 && rem <= 0) return;
  const int n = R * kLanes;
  const size_t base = static_cast<size_t>(e) * n;
  int* gid = ids + base;
  int* gct = counts + base;
  int* ger = errors + base;
  int* id = reinterpret_cast<int*>(smem4);
  int* ct = id + n;
  int* er = ct + n;
  int* rmin = er + n;
  int* rcol = rmin + R;

  if (i0 < i1) {
    stage(id, gid, n);
    stage(ct, gct, n);
  }
  if (rem > 0) stage(er, ger, n);
  cp_async_wait();
  if (i0 < i1) {
    summarize(id, ct, R, rmin, rcol);
    const int* uids = r_uids + static_cast<size_t>(e) * B;
    const int* net = r_net + static_cast<size_t>(e) * B;
    if (threadIdx.x < 32) {
      if (R <= 32)
        staged_chain<1>(id, ct, er, gid, gct, ger, rmin, rcol, R, uids, net,
                        B, i0, i1);
      else if (R <= 64)
        staged_chain<2>(id, ct, er, gid, gct, ger, rmin, rcol, R, uids, net,
                        B, i0, i1);
      else
        staged_chain<4>(id, ct, er, gid, gct, ger, rmin, rcol, R, uids, net,
                        B, i0, i1);
    }
    __syncthreads();
  }
  // the drain reads a count only where it writes one: from device memory,
  // which the chain wrote through
  if (rem > 0) drain_select<false>(gct, er, gct, ger, n, rem, dsh);
}

// The unstaged layout, launch 1: block b summarises group b % G of sketch
// b / G, each warp four of its rows, their loads in flight together.
__global__ void __launch_bounds__(kThreads) residual_summary_kernel(
    const int* __restrict__ ids, const int* __restrict__ counts,
    const int* __restrict__ start, const int* __restrict__ n_ins,
    int* __restrict__ scratch, int R) {
  __shared__ int tile_min[32], tile_col[32];
  const int G = groups(R);
  const int e = blockIdx.x / G, g = blockIdx.x % G;
  if (start[e] >= n_ins[e]) return;  // nothing to place: no summaries needed
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t base = static_cast<size_t>(e) * R * kLanes;
  int* rmin = scratch + static_cast<size_t>(e) * (2 * R + 2 * G);
  int* rcol = rmin + R;
  int* gmin = rcol + R;
  int* gemp = gmin + G;
  int idv[4][4], ctv[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = min(32 * g + 4 * warp + q, R - 1);
    load_row(ids + base, counts + base, r, idv[q], ctv[q]);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int t = 4 * warp + q, r = 32 * g + t;
    int mn, cols;
    row_summary(idv[q], ctv[q], mn, cols);
    if (r >= R) {
      mn = kIntMax;
      cols = kNone << 8;
    } else if (lane == 0) {
      rmin[r] = mn;
      rcol[r] = cols;
    }
    if (lane == 0) {
      tile_min[t] = mn;
      tile_col[t] = cols;
    }
  }
  __syncthreads();
  if (warp == 0) put_group(g, tile_min[lane], tile_col[lane], gmin, gemp);
}

// The unstaged layout, launch 2: one CTA per sketch runs the chain over
// rows in device memory, then the drain.
__global__ void __launch_bounds__(kThreads) residual_chain_kernel(
    int* __restrict__ ids, int* __restrict__ counts, int* __restrict__ errors,
    const int* __restrict__ r_uids, const int* __restrict__ r_net,
    const int* __restrict__ start, const int* __restrict__ n_ins,
    const int* __restrict__ w_del, int* __restrict__ scratch, int R, int B,
    int variant) {
  extern __shared__ int4 smem4[];
  __shared__ DrainScratch dsh;
  const int e = blockIdx.x;
  const int i0 = start[e], i1 = n_ins[e];
  const int rem = variant == 1 ? 0 : w_del[e];
  if (i0 >= i1 && rem <= 0) return;
  const int n = R * kLanes, G = groups(R);
  const size_t base = static_cast<size_t>(e) * n;
  int* id = ids + base;
  int* ct = counts + base;
  int* er = errors + base;
  if (i0 < i1) {
    int* sums = scratch + static_cast<size_t>(e) * (2 * R + 2 * G);
    if (R <= kSumRows) {
      int* s = reinterpret_cast<int*>(smem4);
      stage(s, sums, 2 * R + 2 * G);
      cp_async_wait();
      sums = s;
    }
    if (threadIdx.x < 32)
      unstaged_chain(id, ct, er, sums, sums + R, sums + 2 * R,
                     sums + 2 * R + G, R, r_uids + static_cast<size_t>(e) * B,
                     r_net + static_cast<size_t>(e) * B, B, i0, i1);
    __syncthreads();
  }
  if (rem > 0) drain_select<false>(ct, er, ct, er, n, rem, dsh);
}

// The layout of sketches of R rows: 0 staged, 1 summary+chain, 2
// summary+chain/scratch.
int layout_of(int R) { return R <= kStageRows ? 0 : R <= kSumRows ? 1 : 2; }

// Ints of device scratch the layout needs over E sketches (the unstaged
// layouts' row and group summaries).
long long scratch_ints(int E, int R) {
  return R <= kStageRows ? 0
                         : static_cast<long long>(E) * (2LL * R + 2 * groups(R));
}

}  // namespace

// C entry point (bound with ctypes). `layout` is the caller's name for the
// layout of R rows and `scratch` holds `n_scratch` ints; a launch where
// either disagrees with what this file needs is refused with
// cudaErrorInvalidValue. Launches on `stream` (two launches where
// unstaged), returns cudaGetLastError() as an int (0 = launched).
extern "C" int sketch_residual(void* ids, void* counts, void* errors,
                               const void* r_uids, const void* r_net,
                               const void* start, const void* n_ins,
                               const void* w_del, void* scratch, int E, int R,
                               int B, int variant, int layout, int n_scratch,
                               void* stream) {
  if (layout != layout_of(R) || n_scratch < scratch_ints(E, R))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* id = static_cast<int*>(ids);
  int* ct = static_cast<int*>(counts);
  int* er = static_cast<int*>(errors);
  const int* uids = static_cast<const int*>(r_uids);
  const int* net = static_cast<const int*>(r_net);
  const int* st = static_cast<const int*>(start);
  const int* ni = static_cast<const int*>(n_ins);
  const int* wd = static_cast<const int*>(w_del);
  int* scr = static_cast<int*>(scratch);
  if (layout == 0) {
    const int bytes = 4 * (3 * R * kLanes + 2 * R);
    const cudaError_t err = allow_smem(residual_staged_kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    residual_staged_kernel<<<E, kThreads, bytes, s>>>(id, ct, er, uids, net,
                                                      st, ni, wd, R, B, variant);
    return static_cast<int>(cudaGetLastError());
  }
  const long long blocks = static_cast<long long>(E) * groups(R);
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidConfiguration);
  residual_summary_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      id, ct, st, ni, scr, R);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bytes = layout == 1 ? 4 * (2 * R + 2 * groups(R)) : 0;
  err = allow_smem(residual_chain_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  residual_chain_kernel<<<E, kThreads, bytes, s>>>(id, ct, er, uids, net, st,
                                                   ni, wd, scr, R, B, variant);
  return static_cast<int>(cudaGetLastError());
}
