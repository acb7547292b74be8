// Integer helpers and block reductions shared by the sketch_update kernels.
//
// Integer semantics follow the reference exactly: sat_add clamps at
// +-(2^31-1) (the reference's one-sided form, state.py:31); sums that JAX
// takes in int32, and may wrap, are taken in unsigned 32-bit here, where
// wrapping is defined. Every (value, index) reduction keeps the lowest
// index among equal values, as jnp.argmin and jnp.argmax do.
//
// The reductions assume blockDim.x is a multiple of 32, at most 1024, and
// that every thread of the block calls them (they hold __syncthreads).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kIntMax = 2147483647;
constexpr int kIntMin = -2147483647 - 1;
constexpr int kMaxWarps = 32;
constexpr unsigned kFull = 0xffffffffu;

struct Scratch {
  int val[kMaxWarps];
  int idx[kMaxWarps];
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

__device__ __forceinline__ void take_min(int& v, int& i, int v2, int i2) {
  if (v2 < v || (v2 == v && i2 < i)) { v = v2; i = i2; }
}

__device__ __forceinline__ void take_max(int& v, int& i, int v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) { v = v2; i = i2; }
}

// Warp-wide (value, index) argmin or argmax; every lane gets the result.
template <bool kMax>
__device__ __forceinline__ void warp_arg(int& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const int v2 = __shfl_xor_sync(kFull, v, o);
    const int i2 = __shfl_xor_sync(kFull, i, o);
    if (kMax) take_max(v, i, v2, i2); else take_min(v, i, v2, i2);
  }
}

// Block-wide (value, index) argmin or argmax; every thread gets the result.
template <bool kMax>
__device__ void block_arg(int& v, int& i, Scratch& sh) {
  warp_arg<kMax>(v, i);
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

}  // namespace
