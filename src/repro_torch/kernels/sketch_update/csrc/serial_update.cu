// Serial SpaceSaving± baseline: one update per raw item, for sm_90a.
//
// Replaces the Pallas TPU kernel sketch_update_kernel_serial
// (src/repro/kernels/sketch_update/kernel.py:396, body _serial_kernel at
// :379, one _apply_one at :317 per item). One CTA walks the B items of the
// block in order over the n = R * 128 slots of one padded sketch
// (phases.pad_rows). Per item of weight w != 0, one pass over the slots
// finds together the first slot monitoring the item (id == item, id >= 0),
// the first EMPTY slot (id == -1; BLOCKED padding is not empty) and the
// first slot at the minimum of where(empty, INT_MAX, counts); then
//   w > 0: the monitored slot adds w; else the first EMPTY slot takes
//          (item, w, 0); else the minimum slot mc takes (item, mc + w, mc);
//   w < 0: the monitored slot subtracts -w; else (SS±, variant 2) -w
//          drains greedily from the first maximum-error slots; Lazy drops
//          it.
// The adds are the reference's plain int32 adds, which wrap: they are
// taken in unsigned 32-bit here (signed overflow is undefined in CUDA).
//
// Bound: every item reads all n slots, so the least work is n operations
// per item; the items form one dependent chain of block reductions, so the
// kernel is bound by that chain's latency.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Pass {
  int mon;   // first monitoring slot, kIntMax if none
  int emp;   // first EMPTY slot, kIntMax if none
  int mv;    // minimum of where(empty, INT_MAX, counts)
  int mi;    // its first slot
};

__device__ __forceinline__ void merge(Pass& a, const Pass& b) {
  a.mon = min(a.mon, b.mon);
  a.emp = min(a.emp, b.emp);
  take_min(a.mv, a.mi, b.mv, b.mi);
}

// The three finds of one item in one pass and one block reduction.
__device__ Pass scan_slots(const int* ids, const int* counts, int n, int item,
                           Scratch& sh, int* shared_pass) {
  Pass p{kIntMax, kIntMax, kIntMax, kIntMax};
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int id = ids[j];
    const bool empty = id == -1;
    if (id == item && id >= 0 && j < p.mon) p.mon = j;
    if (empty && j < p.emp) p.emp = j;
    take_min(p.mv, p.mi, empty ? kIntMax : counts[j], j);
  }
  for (int o = 16; o > 0; o >>= 1) {
    Pass q;
    q.mon = __shfl_xor_sync(kFull, p.mon, o);
    q.emp = __shfl_xor_sync(kFull, p.emp, o);
    q.mv = __shfl_xor_sync(kFull, p.mv, o);
    q.mi = __shfl_xor_sync(kFull, p.mi, o);
    merge(p, q);
  }
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    sh.val[warp] = p.mon;
    sh.idx[warp] = p.emp;
    shared_pass[2 * warp] = p.mv;
    shared_pass[2 * warp + 1] = p.mi;
  }
  __syncthreads();
  Pass all{sh.val[0], sh.idx[0], shared_pass[0], shared_pass[1]};
  for (int w = 1; w < nw; ++w)
    merge(all, Pass{sh.val[w], sh.idx[w], shared_pass[2 * w],
                    shared_pass[2 * w + 1]});
  return all;
}

__global__ void __launch_bounds__(kThreads) serial_kernel(
    int* __restrict__ ids, int* __restrict__ counts, int* __restrict__ errors,
    const int* __restrict__ items, const int* __restrict__ weights, int n,
    int B, int variant) {
  __shared__ Scratch sh;
  __shared__ int shared_pass[2 * kMaxWarps];
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int b = 0; b < B; ++b) {
    const int item = items[b], w = weights[b];
    if (w == 0) continue;  // padding: the reference selects the old state
    const Pass p = scan_slots(ids, counts, n, item, sh, shared_pass);
    const bool monitored = p.mon != kIntMax;
    if (w > 0) {
      if (tid == 0) {
        if (monitored) {
          counts[p.mon] = wrap_add(counts[p.mon], w);
        } else if (p.emp != kIntMax) {
          ids[p.emp] = item;
          counts[p.emp] = w;
          errors[p.emp] = 0;
        } else {
          ids[p.mi] = item;
          counts[p.mi] = wrap_add(p.mv, w);
          errors[p.mi] = p.mv;
        }
      }
    } else {
      // jnp.maximum(-w, 0) in int32: -INT_MIN wraps to INT_MIN, hence 0
      const int wd = max(wrap_sub(0, w), 0);
      if (monitored) {
        if (tid == 0) counts[p.mon] = wrap_sub(counts[p.mon], wd);
      } else if (variant != 1) {
        int rem = wd;
        for (;;) {
          int v = kIntMin, j_max = kIntMax;
          for (int j = tid; j < n; j += nt) take_max(v, j_max, errors[j], j);
          block_arg<true>(v, j_max, sh);
          if (!(rem > 0 && v > 0)) break;
          const int d = min(rem, v);
          if (tid == 0) {
            counts[j_max] = wrap_sub(counts[j_max], d);
            errors[j_max] = wrap_sub(errors[j_max], d);
          }
          rem -= d;
          __syncthreads();
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

// C entry point (bound with ctypes). Launches on `stream`, returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int sketch_serial_update(void* ids, void* counts, void* errors,
                                    const void* items, const void* weights,
                                    int n, int B, int variant, void* stream) {
  serial_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(ids), static_cast<int*>(counts),
      static_cast<int*>(errors), static_cast<const int*>(items),
      static_cast<const int*>(weights), n, B, variant);
  return static_cast<int>(cudaGetLastError());
}
