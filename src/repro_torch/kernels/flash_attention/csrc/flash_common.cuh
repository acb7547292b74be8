// What the flash-attention kernels share (flash_attention.cu: mma.sync
// and f32; flash_wgmma.cu: wgmma): the launch parameters and the mask.
//
// Query and key positions are aligned at the sequence ends (q_offset =
// T - S). A pair is allowed when the key exists, is not after the query
// (causal) and lies within the window. Masked scores are -inf and m
// starts at M_INIT, so a row with no allowed key in a tile gets p = 0
// there exactly.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float M_INIT = -1e30f;  // the reference's NEG_INF, m before any key
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, T, H, KV, G, hd;
  int causal, window, q_offset;  // q_offset = T - S aligns the sequence ends
  int vec;                       // rows may be read 16 bytes at a time
  float scale;                   // 1 / sqrt(hd)
};

__device__ __forceinline__ bool allowed(const Params& p, int qpos, int kp) {
  return kp < p.T && (!p.causal || kp <= qpos) &&
         (!p.window || kp > qpos - p.window);
}

// Key positions [lo, hi) that query rows [q0, q1) may see.
__device__ __forceinline__ void kv_band(const Params& p, int q0, int q1,
                                        int* lo, int* hi) {
  *lo = p.window ? max(0, q0 + p.q_offset - p.window + 1) : 0;
  *hi = p.causal ? min(p.T, q1 + p.q_offset) : p.T;
}

// Whether every (query, key) pair of rows [q0, q1) and keys [k0, k1) is
// allowed: such a tile needs no mask.
__device__ __forceinline__ bool inside_band(const Params& p, int q0, int q1,
                                            int k0, int k1) {
  return k1 <= p.T && (!p.causal || k1 - 1 <= q0 + p.q_offset) &&
         (!p.window || k0 > q1 - 1 + p.q_offset - p.window);
}

__device__ __forceinline__ size_t row_offset(int b, int r, int L, int NH,
                                             int head, int hd) {
  return ((size_t)(b * L + r) * NH + head) * hd;
}

}  // namespace
