// Unbiased SpaceSaving± row update: the randomized eviction of the
// family's unbiased variant on both coupled banks, in one launch.
//
// It replaces no Pallas kernel. The reference runs this update in plain
// JAX, a lax.scan over the block's positions in which every bank row does
// a one-hot update of its entry at each step (src/repro/sketch/family.py:123,
// _unbiased_rows). In PyTorch that scan would be some 20 launches a
// position, 1.3M for a block of 65,536 updates, so the port runs it as
// this kernel.
//
// One CTA per bank row of both banks: block c < R is row c of the insert
// bank, block R + r row r of the delete bank. A row reads its entries from
// the owner-sorted flat layout of family.unbiased_prep: the positions
// perm[roff[c]], ..., perm[roff[c + 1] - 1] of the id-sorted block, in
// block order, each with its id, its weight (the delete bank takes -w) and
// its uniform u[bank][position]. Per entry of weight w > 0:
//   - the first slot holding the id: its count += w (sat_add);
//   - else the first EMPTY slot: the id, count w, error 0;
//   - else the lowest-index minimum count mc among the non-EMPTY slots
//     (BLOCKED slots carry INT_MAX): count sat_add(mc, w), error mc, and
//     the id adopted iff u * (mc + w) < w in float32, each operation
//     rounded on its own (__fadd_rn, __fmul_rn: no contraction), as the
//     reference computes it; else the evicted id stays.
//
// Thread t owns the row's slots t, t + T, t + 2T, ...: it alone reads and
// writes them, so a slot's update needs no barrier. One __syncthreads an
// entry publishes the warps' partial results (first match, first EMPTY,
// argmin), double-buffered so the next entry's writes cannot race the
// reads. The block is id-sorted, so an id's entries are adjacent in a
// row's list: after an entry that leaves the id in the row, its following
// entries are monitored hits on that slot, which the slot's owner adds
// without a search (a heavy hitter's thousands of repeats in a block cost
// no barrier). Entries are brought into shared memory T at a time. The
// row lives in shared memory up to kStageSlots slots, else in device
// memory (the "global" layout).
//
// What bounds it: bytes. Any implementation reads and writes each touched
// row once and reads the block's ids, weights, positions and uniforms
// once. This design also searches the row once an entry (K/T slots a
// thread), which a hashed slot index would avoid.
#include "common.cuh"

namespace {

constexpr int kStageSlots = 16384;   // kernel.UNBIASED_STAGE_SLOTS
constexpr int kMaxThreads = 256;
constexpr int kEmpty = -1;

// A warp's or the block's partial search result: the first slot holding
// the id, the first EMPTY slot, and the (value, index) minimum count among
// the non-EMPTY slots; kIntMax where there is none.
struct Part {
  int mon, emp, mcv, mci;
};

__device__ __forceinline__ void combine(Part& a, const Part& b) {
  a.mon = min(a.mon, b.mon);
  a.emp = min(a.emp, b.emp);
  take_min(a.mcv, a.mci, b.mcv, b.mci);
}

__device__ __forceinline__ void warp_combine(Part& p) {
  for (int o = 16; o > 0; o >>= 1) {
    Part q;
    q.mon = __shfl_xor_sync(kFull, p.mon, o);
    q.emp = __shfl_xor_sync(kFull, p.emp, o);
    q.mcv = __shfl_xor_sync(kFull, p.mcv, o);
    q.mci = __shfl_xor_sync(kFull, p.mci, o);
    combine(p, q);
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kMaxThreads) unbiased_kernel(
    int* __restrict__ ids_i, int* __restrict__ cnt_i, int* __restrict__ err_i,
    int* __restrict__ ids_d, int* __restrict__ cnt_d, int* __restrict__ err_d,
    const int* __restrict__ items, const int* __restrict__ weights,
    const float* __restrict__ u, const int* __restrict__ perm,
    const int* __restrict__ roff, int R, int Ki, int Kd, int B) {
  extern __shared__ int row_smem[];
  __shared__ Part part[2][kMaxThreads / 32];
  __shared__ int e_item[kMaxThreads];
  __shared__ int e_w[kMaxThreads];
  __shared__ float e_u[kMaxThreads];

  const int c = blockIdx.x;
  const int e0 = roff[c], e1 = roff[c + 1];
  if (e0 >= e1) return;   // the row has no entry this block
  const bool del = c >= R;
  const int row = del ? c - R : c;
  const int K = del ? Kd : Ki;
  const size_t at = static_cast<size_t>(row) * K;
  int* gid = (del ? ids_d : ids_i) + at;
  int* gcnt = (del ? cnt_d : cnt_i) + at;
  int* gerr = (del ? err_d : err_i) + at;
  const float* ub = u + (del ? B : 0);
  const int T = blockDim.x, tid = threadIdx.x;
  const int warp = tid >> 5, nw = T >> 5;

  int* ids = gid;
  int* cnt = gcnt;
  int* err = gerr;
  if (kStaged) {
    ids = row_smem;
    cnt = row_smem + K;
    err = row_smem + 2 * K;
    for (int j = tid; j < K; j += T) {   // each thread its own slots
      ids[j] = gid[j];
      cnt[j] = gcnt[j];
      err[j] = gerr[j];
    }
  }

  int buf = 0;
  for (int base = e0; base < e1; base += T) {
    const int n = min(T, e1 - base);
    __syncthreads();   // the last chunk is read by every thread
    if (tid < n) {
      const int p = perm[base + tid];
      const int w = weights[p];
      e_item[tid] = items[p];
      e_w[tid] = max(del ? wrap_sub(0, w) : w, 0);
      e_u[tid] = ub[p];
    }
    __syncthreads();
    int i = 0;
    while (i < n) {
      const int x = e_item[i], w = e_w[i];
      if (w <= 0 || x < 0) {   // a no-op entry, as the reference's mask
        ++i;
        continue;
      }
      Part p{kIntMax, kIntMax, kIntMax, kIntMax};
      for (int j = tid; j < K; j += T) {
        const int id = ids[j];
        if (id == x) p.mon = min(p.mon, j);
        if (id == kEmpty) {
          p.emp = min(p.emp, j);
        } else {
          take_min(p.mcv, p.mci, cnt[j], j);
        }
      }
      warp_combine(p);
      if ((tid & 31) == 0) part[buf][warp] = p;
      __syncthreads();
      Part q = part[buf][0];
      for (int v = 1; v < nw; ++v) combine(q, part[buf][v]);
      buf ^= 1;

      int sel;
      bool adopt = true;
      if (q.mon != kIntMax) {
        sel = q.mon;
      } else if (q.emp != kIntMax) {
        sel = q.emp;
      } else {
        sel = q.mci;
        const float fw = __int2float_rn(w);
        adopt = __fmul_rn(e_u[i], __fadd_rn(__int2float_rn(q.mcv), fw)) < fw;
      }
      const bool mine = sel % T == tid;
      if (mine) {
        if (q.mon != kIntMax) {
          cnt[sel] = sat_add(cnt[sel], w);
        } else if (q.emp != kIntMax) {
          ids[sel] = x;
          cnt[sel] = w;
          err[sel] = 0;
        } else {
          if (adopt) ids[sel] = x;
          cnt[sel] = sat_add(q.mcv, w);
          err[sel] = q.mcv;
        }
      }
      ++i;
      if (adopt) {
        // the id sits at sel now: its next entries are monitored hits
        while (i < n && e_item[i] == x) {
          if (mine && e_w[i] > 0) cnt[sel] = sat_add(cnt[sel], e_w[i]);
          ++i;
        }
      }
    }
  }
  if (kStaged) {
    for (int j = tid; j < K; j += T) {
      gid[j] = ids[j];
      gcnt[j] = cnt[j];
      gerr[j] = err[j];
    }
  }
}

}  // namespace

// Both banks of (R, Ki) and (R, Kd) int32 updated in place from the flat
// layout: items, weights (B,) int32 (id-sorted, weights signed), u (2, B)
// float32, perm (B,) int32, roff (2R + 1,) int32. layout: 0 staged (the
// larger K at most kStageSlots), 1 global; a layout that disagrees with
// that rule is refused.
extern "C" int sketch_unbiased_update(
    int* ids_i, int* cnt_i, int* err_i, int* ids_d, int* cnt_d, int* err_d,
    const int* items, const int* weights, const float* u, const int* perm,
    const int* roff, int R, int Ki, int Kd, int B, int layout,
    cudaStream_t stream) {
  const int K = max(Ki, Kd);
  if (R < 1 || Ki < 1 || Kd < 1 || B < 1) return cudaErrorInvalidValue;
  const bool staged = K <= kStageSlots;
  if (layout != (staged ? 0 : 1)) return cudaErrorInvalidValue;
  const int threads = min(kMaxThreads, (K + 31) / 32 * 32);
  const dim3 grid(2 * R);
  if (staged) {
    const int smem = 3 * K * static_cast<int>(sizeof(int));
    cudaError_t err = cudaFuncSetAttribute(
        unbiased_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    unbiased_kernel<true><<<grid, threads, smem, stream>>>(
        ids_i, cnt_i, err_i, ids_d, cnt_d, err_d, items, weights, u, perm,
        roff, R, Ki, Kd, B);
  } else {
    unbiased_kernel<false><<<grid, threads, 0, stream>>>(
        ids_i, cnt_i, err_i, ids_d, cnt_d, err_d, items, weights, u, perm,
        roff, R, Ki, Kd, B);
  }
  return cudaGetLastError();
}
