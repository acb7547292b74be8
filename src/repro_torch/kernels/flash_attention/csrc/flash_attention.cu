// Flash attention forward for the H100 (sm_90a), bound with ctypes.
//
// Replaces the Pallas TPU kernel flash_attention_kernel
// (src/repro/kernels/flash_attention/kernel.py:82): blocked online-softmax
// GQA attention with a causal and a sliding-window mask, f32 running max m,
// denominator l and numerator acc, the output in q's dtype. The plain
// version is ../ref.py.
//
// What bounds it: at the widths the port serves (Gemma3-27B: H = 32, KV = 16,
// hd = 128, bf16, a 4k prefill) each allowed (q, k) pair costs 4·hd FLOPs
// per head against 2·hd bytes of q, k, v and out per row, so the work is
// far above the card's ridge point: the tensor cores bound it, not memory.
//
// Design (not the TPU's):
// - one CTA per (q tile, b·h); the q-head's kv-head is h / G, and K and V
//   are read in place in the model layout (B, T, KV, hd): nothing is
//   transposed, expanded to H heads, or padded in device memory;
// - a CTA visits only the kv tiles that meet its rows' causal/window band
//   (the Pallas kernel's allowed.any() skip, without visiting the rest),
//   and masks only the tiles that cross the band's edges; the grid starts
//   with the q tiles that have the most kv tiles;
// - tiles are staged in shared memory and zero-filled past T, S and hd, so
//   any S, T and hd <= 256 run (rows past S are computed, never stored);
// - bf16: mma.sync m16n8k16 (bf16 in, f32 accumulate), q tiles of 128 rows
//   on 8 warps of 16; fragments come from shared memory by ldmatrix (V
//   transposed on the fly); the K and V tiles are double-buffered with
//   cp.async, the next tile in flight while this one is computed; scores
//   and probabilities stay in registers, and P is rounded to bf16 for the
//   P·V product, its f32 sum kept for l;
// - f32: CUDA-core FMAs in full f32 (TF32 tensor cores would round the
//   inputs to 10 bits), q tiles of 64 rows, 256 threads, 4 per q row;
// - a row that has no allowed key in a tile gets -inf scores there, so its
//   p is exactly 0 and m stays at its -1e30 start: the row is guarded, and
//   the result equals the Pallas kernel's whenever every query row has an
//   allowed key (causal with T >= S, or no mask), where that kernel lets
//   exp(0) leak into l and acc until alpha = 0 wipes it out.
//
// Entry point: flash_attention_fwd (C ABI), returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ size_t row_offset(int b, int r, int L, int NH,
                                             int head, int hd) {
  return ((size_t)(b * L + r) * NH + head) * hd;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_BQ = 128;  // q rows per CTA, 16 per warp
constexpr int MMA_BKV = 64;  // kv rows per tile
constexpr int MMA_THREADS = 256;

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes from global to shared memory without a register round trip;
// zeros where `full` is false (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + rows) of `head` of a (B, L, NH, hd) bf16 tensor into a
// [rows][LD] shared tile, zero past row L and past column hd up to HDP:
// asynchronously (cp.async) where rows are 16-byte aligned multiples.
template <int HDP, int LD>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               const Params& p, int b,
                                               int head, int NH, int L,
                                               int r0, int rows) {
  if (p.vec) {  // hd % 8 == 0 and 16-byte aligned rows
    constexpr int CPR = HDP / 8;
    for (int i = threadIdx.x; i < rows * CPR; i += blockDim.x) {
      const int r = i / CPR, c = (i - r * CPR) * 8, gr = r0 + r;
      const bool full = gr < L && c < p.hd;
      cp_async16(dst + r * LD + c,
                 full ? src + row_offset(b, gr, L, NH, head, p.hd) + c : src,
                 full);
    }
  } else {
    for (int i = threadIdx.x; i < rows * HDP; i += blockDim.x) {
      const int r = i / HDP, c = i - r * HDP, gr = r0 + r;
      __nv_bfloat16 val = __float2bfloat16(0.f);
      if (gr < L && c < p.hd) val = src[row_offset(b, gr, L, NH, head, p.hd) + c];
      dst[r * LD + c] = val;
    }
  }
}

// Four 8x8 b16 matrices, one per 8 lanes' row addresses; lane 4 g + t gets
// row g, columns 2t and 2t + 1 of each (with .trans, column g, rows 2t and
// 2t + 1): the mma.sync fragment layout.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r,
                                              const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a · b, a 16x16 (row), b 16x8 (col), c 16x8 f32.
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the q tile and two stages of K and V tiles
template <int HDP>
constexpr size_t mma_smem_bytes() {
  return (size_t)(MMA_BQ + 4 * MMA_BKV) * (HDP + 8) * sizeof(__nv_bfloat16);
}

// Fragment layout of m16n8k16 (lane = 4 g + t): a thread holds score rows
// g and g + 8 of its warp's 16, columns 2t and 2t + 1 of each 8-wide n-tile.
// The K and V tiles are double-buffered: tile i + 1 is in flight while
// tile i is computed.
template <int HDP>
__global__ void __launch_bounds__(MMA_THREADS, HDP <= 128 ? 2 : 1)
    flash_mma_kernel(const Params p) {
  constexpr int LD = HDP + 8;  // 16-byte rows on distinct banks for ldmatrix
  constexpr int NT_S = MMA_BKV / 8;
  constexpr int NT_O = HDP / 8;
  constexpr int TILE = MMA_BKV * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + MMA_BQ * LD;  // [2][MMA_BKV][LD]
  __nv_bfloat16* Vs = Ks + 2 * TILE;     // [2][MMA_BKV][LD]
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o);

  const int nq = (p.S + MMA_BQ - 1) / MMA_BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * MMA_BQ;
  const int q1 = min(p.S, q0 + MMA_BQ);
  const int b = blockIdx.y / p.H, h = blockIdx.y - b * p.H, kvh = h / p.G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16 + g;  // this thread's tile rows: row0, row0 + 8
  const int qpos0 = q0 + row0 + p.q_offset;
  const float scale2 = p.scale * LOG2E;  // scores in log2 units: exp2f below

  int lo, hi;
  kv_band(p, q0, q1, &lo, &hi);
  const int first = lo - lo % MMA_BKV;
  const int ntiles = hi > first ? (hi - first + MMA_BKV - 1) / MMA_BKV : 0;

  load_tile_bf16<HDP, LD>(Qs, q, p, b, h, p.H, p.S, q0, MMA_BQ);
  if (ntiles > 0) {
    load_tile_bf16<HDP, LD>(Ks, k, p, b, kvh, p.KV, p.T, first, MMA_BKV);
    load_tile_bf16<HDP, LD>(Vs, v, p, b, kvh, p.KV, p.T, first, MMA_BKV);
  }
  cp_async_commit();

  // ldmatrix row addresses of this lane (see ldsm_x4)
  const int a_row = warp * 16 + (lane & 15), a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3), v_col = (lane >> 4) * 8;

  float o[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {M_INIT, M_INIT}, l_run[2] = {0.f, 0.f};

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = first + it * MMA_BKV;
    const __nv_bfloat16* Kt = Ks + (it & 1) * TILE;
    const __nv_bfloat16* Vt = Vs + (it & 1) * TILE;
    if (it + 1 < ntiles) {  // the other stage was freed by the last sync
      load_tile_bf16<HDP, LD>(Ks + ((it + 1) & 1) * TILE, k, p, b, kvh, p.KV,
                              p.T, k0 + MMA_BKV, MMA_BKV);
      load_tile_bf16<HDP, LD>(Vs + ((it + 1) & 1) * TILE, v, p, b, kvh, p.KV,
                              p.T, k0 + MMA_BKV, MMA_BKV);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the tile just requested
    __syncthreads();

    float s[NT_S][4];
#pragma unroll
    for (int n = 0; n < NT_S; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, Qs + a_row * LD + kk * 16 + a_col);
#pragma unroll
      for (int n = 0; n < NT_S; n += 2) {
        uint32_t bk[4];  // b0, b1 of n-tiles n and n + 1
        ldsm_x4(bk, Kt + (n * 8 + k_row) * LD + kk * 16 + k_col);
        mma_16816(s[n], a, bk[0], bk[1]);
        mma_16816(s[n + 1], a, bk[2], bk[3]);
      }
    }

    // scale and mask (-inf: p = 0 exactly), then the rows' maxima; a tile
    // inside the band for every row of the CTA skips the mask
    const bool inside = k0 + MMA_BKV <= p.T &&
                        (!p.causal || k0 + MMA_BKV - 1 <= q0 + p.q_offset) &&
                        (!p.window || k0 > q1 - 1 + p.q_offset - p.window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT_S; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + n * 8 + 2 * t + (j & 1);
        const float x = inside || allowed(p, qpos0 + (j >> 1) * 8, kp)
                            ? s[n][j] * scale2 : -INFINITY;
        s[n][j] = x;
        mx[j >> 1] = fmaxf(mx[j >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      alpha[i] = exp2f(m_run[i] - m_new);
      m_run[i] = m_new;
      l_run[i] *= alpha[i];  // this thread's share of l; summed at the end
    }
#pragma unroll
    for (int n = 0; n < NT_S; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[n][j] = exp2f(s[n][j] - m_run[j >> 1]);
        l_run[j >> 1] += s[n][j];
      }
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    // o += P · V: the score fragments of n-tiles 2kk, 2kk + 1 are the A
    // fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < MMA_BKV / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NT_O; n += 2) {
        uint32_t bv[4];  // b0, b1 of n-tiles n and n + 1
        ldsm_x4_trans(bv, Vt + (kk * 16 + v_row) * LD + n * 8 + v_col);
        mma_16816(o[n], a, bv[0], bv[1]);
        mma_16816(o[n + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this stage is read; the next iteration refills it
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    l_run[i] = fmaxf(l_run[i], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      const int r = q0 + row0 + (j >> 1) * 8, c = n * 8 + 2 * t;
      if (r >= p.S) continue;
      __nv_bfloat16* dst = out + row_offset(b, r, p.S, p.H, h, p.hd) + c;
      const float inv = l_run[j >> 1];
      if (c + 1 < p.hd && (p.hd & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(o[n][j] / inv, o[n][j + 1] / inv);
      } else {
        if (c < p.hd) dst[0] = __float2bfloat16(o[n][j] / inv);
        if (c + 1 < p.hd) dst[1] = __float2bfloat16(o[n][j + 1] / inv);
      }
    }
}

// ---------------------------------------------------------------------------
// f32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int F_BQ = 64;   // q rows per CTA, 4 threads each
constexpr int F_BKV = 32;  // kv rows per tile
constexpr int F_THREADS = 256;

// Rows [r0, r0 + rows) of `head` of a (B, L, NH, hd) f32 tensor into a
// [rows][LD] shared tile, zero past row L and past column hd up to HDP.
template <int HDP, int LD>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              const Params& p, int b,
                                              int head, int NH, int L, int r0,
                                              int rows) {
  if (p.vec) {  // hd % 4 == 0 and 16-byte aligned rows
    constexpr int CPR = HDP / 4;
    for (int i = threadIdx.x; i < rows * CPR; i += blockDim.x) {
      const int r = i / CPR, c = (i - r * CPR) * 4, gr = r0 + r;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gr < L && c < p.hd)
        val = __ldg(reinterpret_cast<const float4*>(
            src + row_offset(b, gr, L, NH, head, p.hd) + c));
      float* d = dst + r * LD + c;  // LD is odd: four scalar stores
      d[0] = val.x;
      d[1] = val.y;
      d[2] = val.z;
      d[3] = val.w;
    }
  } else {
    for (int i = threadIdx.x; i < rows * HDP; i += blockDim.x) {
      const int r = i / HDP, c = i - r * HDP, gr = r0 + r;
      dst[r * LD + c] = (gr < L && c < p.hd)
                            ? src[row_offset(b, gr, L, NH, head, p.hd) + c]
                            : 0.f;
    }
  }
}

template <int HDP>
constexpr size_t f32_smem_bytes() {
  return ((size_t)(F_BQ + 2 * F_BKV) * (HDP + 1) + F_BQ * (F_BKV + 1)) *
         sizeof(float);
}

// Thread 4 r + u holds q row r, scores of columns u + 4 j of each kv tile,
// and output columns u + 4 i.
template <int HDP>
__global__ void __launch_bounds__(F_THREADS) flash_f32_kernel(const Params p) {
  constexpr int LD = HDP + 1;  // odd: rows fall on distinct banks
  constexpr int LDP = F_BKV + 1;
  constexpr int NJ = F_BKV / 4;
  constexpr int ND = HDP / 4;
  extern __shared__ float fsm[];
  float* Qs = fsm;
  float* Ks = Qs + F_BQ * LD;
  float* Vs = Ks + F_BKV * LD;
  float* Ps = Vs + F_BKV * LD;
  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  float* out = static_cast<float*>(p.o);

  const int nq = (p.S + F_BQ - 1) / F_BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * F_BQ;
  const int q1 = min(p.S, q0 + F_BQ);
  const int b = blockIdx.y / p.H, h = blockIdx.y - b * p.H, kvh = h / p.G;
  const int r = threadIdx.x >> 2, u = threadIdx.x & 3;
  const int qpos = q0 + r + p.q_offset;

  load_tile_f32<HDP, LD>(Qs, q, p, b, h, p.H, p.S, q0, F_BQ);
  int lo, hi;
  kv_band(p, q0, q1, &lo, &hi);

  float acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.f;
  float m_run = M_INIT, l_run = 0.f;

  for (int k0 = lo - lo % F_BKV; k0 < hi; k0 += F_BKV) {
    __syncthreads();
    load_tile_f32<HDP, LD>(Ks, k, p, b, kvh, p.KV, p.T, k0, F_BKV);
    load_tile_f32<HDP, LD>(Vs, v, p, b, kvh, p.KV, p.T, k0, F_BKV);
    __syncthreads();

    float s[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j] = 0.f;
    for (int d = 0; d < p.hd; ++d) {
      const float qd = Qs[r * LD + d];
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[j] = fmaf(qd, Ks[(u + 4 * j) * LD + d], s[j]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      s[j] = allowed(p, qpos, k0 + u + 4 * j) ? s[j] * p.scale : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    m_run = m_new;
    l_run *= alpha;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float e = expf(s[j] - m_new);
      l_run += e;
      Ps[r * LDP + u + 4 * j] = e;
    }
    __syncwarp();  // a row's four threads share one warp
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] *= alpha;
    for (int c = 0; c < F_BKV; ++c) {
      const float pc = Ps[r * LDP + c];
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[i] = fmaf(pc, Vs[c * LD + u + 4 * i], acc[i]);
    }
  }

  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
  l_run = fmaxf(l_run, 1e-30f);
  const int row = q0 + r;
  if (row < p.S) {
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const int c = u + 4 * i;
      if (c < p.hd) out[row_offset(b, row, p.S, p.H, h, p.hd) + c] = acc[i] / l_run;
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, const Params& p) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q (B, S, H, hd), k and v (B, T, KV, hd), o (B, S, H, hd), all bf16 or all
// f32, contiguous; H a multiple of KV; hd <= 256; B·H <= 65535.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int bf16, int B,
                                   int S, int T, int H, int KV, int hd,
                                   int causal, int window, int vec,
                                   float scale, void* stream) {
  if (hd < 1 || hd > 256 || KV < 1 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, o, S, T, H, KV, H / KV, hd,
                 causal, window, T - S, vec, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const dim3 grid((S + MMA_BQ - 1) / MMA_BQ, B * H);
    if (hd <= 64)
      return (int)launch(flash_mma_kernel<64>, grid, MMA_THREADS,
                         mma_smem_bytes<64>(), st, p);
    if (hd <= 128)
      return (int)launch(flash_mma_kernel<128>, grid, MMA_THREADS,
                         mma_smem_bytes<128>(), st, p);
    return (int)launch(flash_mma_kernel<256>, grid, MMA_THREADS,
                       mma_smem_bytes<256>(), st, p);
  }
  const dim3 grid((S + F_BQ - 1) / F_BQ, B * H);
  if (hd <= 64)
    return (int)launch(flash_f32_kernel<64>, grid, F_THREADS,
                       f32_smem_bytes<64>(), st, p);
  if (hd <= 128)
    return (int)launch(flash_f32_kernel<128>, grid, F_THREADS,
                       f32_smem_bytes<128>(), st, p);
  return (int)launch(flash_f32_kernel<256>, grid, F_THREADS,
                     f32_smem_bytes<256>(), st, p);
}
