// Flash attention forward in bf16 on Hopper's warpgroup matrix multiplies,
// fed by the Tensor Memory Accelerator (sm_90a), bound with ctypes.
//
// Replaces the Pallas TPU kernel flash_attention_kernel
// (src/repro/kernels/flash_attention/kernel.py:82) for the bf16 shapes the
// port serves: hd of 64, 128 or 256 with 16-byte aligned operands
// (flash_attention.cu takes every other shape). Blocked online-softmax GQA
// attention with a causal and a sliding-window mask, f32 running max m,
// denominator l and numerator acc, the output in bf16. The plain version
// is ../ref.py.
//
// What bounds it: at the widths the port serves (Gemma3-27B: H = 32, KV =
// 16, hd = 128, a 4k prefill) each allowed (q, k) pair costs 4·hd FLOPs
// per head against 2·hd bytes of q, k, v and out per row: the tensor cores
// bound it, and only wgmma reaches their full rate.
//
// Design:
// - persistent: one CTA per SM walks the work items (128-row q tile,
//   b·h), the q tiles with the most kv tiles first, in three warpgroups: a
//   producer whose one thread issues the TMA copies (its registers cut to
//   24 by setmaxnreg) and two consumers of 64 q rows each (raised to 240);
//   the next item's Q and first K/V tiles load while this one finishes;
// - the TMA reads q (B, S, H, hd) and k, v (B, T, KV, hd) in place through
//   4-D tensor maps over (hd, heads, rows, batch), the kv-head h / G: boxes
//   of 64 columns (128 bytes, the 128-byte swizzle), so a row of hd 128 is
//   two boxes; rows past S and T arrive as zeros (the TMA's out-of-bounds
//   fill), and rows past S are never stored. Nothing is transposed,
//   expanded or padded in device memory;
// - Q is loaded once per item, then K and V tiles of BKV keys (128 at hd
//   <= 128, 64 at hd 256) into a ring of as many stages as shared memory
//   holds (4, 3 and 2 at hd 64, 128 and 256), each stage with a full
//   mbarrier (the TMA's bytes) and an empty one (the 8 consumer warps'
//   arrivals);
// - S = Q·Kᵀ: wgmma m64nBKVk16, both operands K-major in shared memory;
//   O += P·V: wgmma m64nHDk16, P from registers (the f32 scores rounded to
//   bf16 in the A-fragment layout, their f32 sum kept for l) and V read
//   MN-major (the transpose bit), since its rows are keys with hd
//   contiguous;
// - each consumer pipelines its tiles: it issues tile i's Q·Kᵀ and tile
//   i - 1's P·V together and runs tile i's softmax as soon as the first is
//   done, while the tensor cores run the second; the two consumers take
//   turns at issuing (named barriers), so one's softmax overlaps the
//   other's products;
// - the online softmax stays in registers (2^x on the special-function
//   unit of scores scaled by scale·log2e, the rows' maxima and sums in
//   partial chains); the CTA visits only the kv tiles that meet its rows'
//   causal/window band, and a warpgroup masks only those that cross its
//   own band's edges; a row with no allowed key keeps m = -1e30 and p = 0
//   (flash_common.cuh).
//
// Entry point: flash_wgmma_fwd (C ABI), returns a cudaError_t.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 128;            // q rows per CTA
constexpr int BOX = 64;            // columns per TMA box (128 bytes)
constexpr int THREADS = 384;       // producer + two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;  // arrivals that free a stage

template <int HD>
struct Tiles {
  static constexpr int BKV = HD <= 128 ? 128 : 64;  // keys per kv tile
  // K/V ring stages: as many as shared memory holds, up to 4
  static constexpr int STAGES = HD == 64 ? 4 : HD == 128 ? 3 : 2;
  static constexpr int Q_ELEMS = BQ * HD;
  static constexpr int KV_ELEMS = BKV * HD;
  static constexpr uint32_t Q_BYTES = Q_ELEMS * 2;
  static constexpr uint32_t KV_BYTES = KV_ELEMS * 2;
  // 1,024 bytes of slack to align the tiles (the swizzle's period), the
  // tiles, and 2 + 2 STAGES mbarriers
  static constexpr size_t SMEM =
      1024 + 2 * (size_t)(Q_ELEMS + 2 * STAGES * KV_ELEMS) +
      8 * (2 + 2 * STAGES);
  static_assert(SMEM <= 232448, "the tiles must fit a block's shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
// one arrival that also expects `bytes` of TMA traffic in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// Until the phase of parity `parity` has completed. A wait of more than
// some 2^34 cycles (seconds) can only be a broken pipeline: it traps, so
// the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

// One box of a 4-D tensor map at coordinates (c0 innermost) into shared
// memory; its bytes complete on `bar`.
__device__ __forceinline__ void tma_load(bf16* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// 2^x on the special-function unit (2^-inf = +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The work items, heaviest first: item w is q tile nq - 1 - w / BH of
// (b, h) = divmod(w % BH, H), BH = B·H. Its rows [q0, q1) see the kv tiles
// [first, first + ntiles·BKV).
struct Item {
  int q0, q1, b, h, first, ntiles;
};

template <int BKV>
__device__ __forceinline__ Item item_at(const Params& p, int w, int nq,
                                        int BH) {
  Item it;
  const int qt = nq - 1 - w / BH, bh = w % BH;
  it.q0 = qt * BQ;
  it.q1 = min(p.S, it.q0 + BQ);
  it.b = bh / p.H;
  it.h = bh - it.b * p.H;
  int lo, hi;
  kv_band(p, it.q0, it.q1, &lo, &hi);
  it.first = lo - lo % BKV;
  it.ntiles = hi > it.first ? (hi - it.first + BKV - 1) / BKV : 0;
  return it;
}

// Shared memory, from a 1,024-byte boundary: Q [HD/64][BQ][64], then per
// stage K [HD/64][BKV][64] and V the same (each box a run of 128-byte rows
// as the TMA swizzles them), then the mbarriers. Persistent: each CTA
// takes one item of every round of gridDim.x items (item_of); the K/V ring
// runs on across items, and the next item's Q is loaded as soon as the
// last Q·Kᵀ of this one is done.
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const Params p,
                       int BH) {
  using C = Tiles<HD>;
  constexpr int BKV = C::BKV;
  constexpr int STAGES = C::STAGES;
  constexpr int NBOX = HD / BOX;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* Qs = reinterpret_cast<bf16*>(base);
  bf16* Ks = Qs + C::Q_ELEMS;
  bf16* Vs = Ks + STAGES * C::KV_ELEMS;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + STAGES * C::KV_ELEMS);
  uint64_t* q_empty = q_full + 1;
  uint64_t* full = q_empty + 1;
  uint64_t* empty = full + STAGES;
  const int nq = (p.S + BQ - 1) / BQ;
  const int n_items = nq * BH;
  // round k's item of this CTA: the rounds snake (even rounds in CTA
  // order, odd ones reversed), so the heaviest-first items even out
  auto item_of = [&](int k) {
    const int c = k & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    return k * (int)gridDim.x + c;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMER_WARPS);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread keeps Q and the ring full -----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int n = 0;  // tiles loaded so far: the ring's position
      for (int k = 0, j = 0; k * (int)gridDim.x < n_items; ++k) {
        const int w = item_of(k);
        if (w >= n_items) continue;
        const Item it = item_at<BKV>(p, w, nq, BH);
        const int kvh = it.h / p.G;
        mbar_wait(q_empty, (j++ & 1) ^ 1);  // the first item: free
        mbar_expect_tx(q_full, C::Q_BYTES);
        for (int c = 0; c < NBOX; ++c)
          tma_load(Qs + c * BQ * BOX, &tq, q_full, c * BOX, it.h, it.q0, it.b);
        for (int i = 0; i < it.ntiles; ++i, ++n) {
          const int s = n % STAGES;
          mbar_wait(empty + s, ((n / STAGES) & 1) ^ 1);  // round 0: free
          mbar_expect_tx(full + s, 2 * C::KV_BYTES);
          const int k0 = it.first + i * BKV;
          bf16* kd = Ks + s * C::KV_ELEMS;
          bf16* vd = Vs + s * C::KV_ELEMS;
          for (int c = 0; c < NBOX; ++c) {
            tma_load(kd + c * BKV * BOX, &tk, full + s, c * BOX, kvh, k0, it.b);
            tma_load(vd + c * BKV * BOX, &tv, full + s, c * BOX, kvh, k0, it.b);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: 64 q rows each --------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const float scale2 = p.scale * LOG2E;  // scores in log2 units
  const bf16* Qw = Qs + 64 * wg * BOX;   // rows 64 wg.. of each Q box

  float o[HD / 2];
  float sc[BKV / 2];
  uint32_t pa[BKV / 16][4];
  float m_run[2], l_run[2];
  int r0, r1, qpos, first;

  // ring position n: its stage and phase
  auto wait_full = [&](int n) {
    mbar_wait(full + n % STAGES, (n / STAGES) & 1);
  };
  auto release = [&](int n) {  // this warp is done with the stage
    if (lane == 0) mbar_arrive(empty + n % STAGES);
  };
  auto release_q = [&]() {
    if (lane == 0) mbar_arrive(q_empty);
  };
  // S = Q · Kᵀ: 16 columns of hd per wgmma, 4 per 128-byte box
  auto issue_qk = [&](int n) {
    const bf16* Kt = Ks + (n % STAGES) * C::KV_ELEMS;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int c = kk / 4, col = (kk % 4) * 16;
      wgmma_ss<BKV>(sc, sw128_desc(Qw + c * BQ * BOX + col, 16, 1024),
                    sw128_desc(Kt + c * BKV * BOX + col, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // O += P · V: the score columns 16 kk.. are the A fragment of step kk
  auto issue_pv = [&](int n) {
    const bf16* Vt = Vs + (n % STAGES) * C::KV_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma_rs<HD>(o, pa[kk],
                   sw128_desc(Vt + kk * 16 * BOX, BKV * BOX * 2, 1024));
    wgmma_commit();
  };
  // The online softmax of tile i's scores: mask (raw scores, -inf: p = 0
  // exactly) where the tile crosses the band's edges, the rows' maxima,
  // p = 2^(s·scale2 - m) in place, l; returns the rows' rescale factors.
  auto softmax = [&](int i, float* alpha) {
    const int k0 = first + i * BKV;
    const bool inside = inside_band(p, r0, r1, k0, k0 + BKV);
    // the rows' maxima and sums in four partial chains each (short
    // dependent chains), joined at the end
    float mx4[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) mx4[r][c] = -INFINITY;
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * j + 2 * t + (e & 1);
        if (!inside && !allowed(p, qpos + (e >> 1) * 8, kp))
          sc[4 * j + e] = -INFINITY;
        float& m = mx4[e >> 1][(j & 1) * 2 + (e & 1)];
        m = fmaxf(m, sc[4 * j + e]);
      }
    float mx[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      mx[r] = fmaxf(fmaxf(mx4[r][0], mx4[r][1]),
                    fmaxf(mx4[r][2], mx4[r][3]));
    float neg_m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r] * scale2);
      alpha[r] = ex2(m_run[r] - m_new);
      m_run[r] = m_new;
      neg_m[r] = -m_new;
      l_run[r] *= alpha[r];  // this thread's share of l; summed at the end
    }
    float ls[2][4] = {};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], scale2, neg_m[e >> 1]));
        ls[e >> 1][(j & 1) * 2 + (e & 1)] += sc[4 * j + e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l_run[r] += (ls[r][0] + ls[r][1]) + (ls[r][2] + ls[r][3]);
  };
  auto rescale = [&](const float* alpha) {
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j + 0] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
  };
  auto pack_p = [&]() {  // P in bf16, in the A-fragment layout
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };
  // The two consumers take turns at issuing their wgmmas (named barriers
  // 1 and 2, consumer 0 first), so one's softmax overlaps the other's
  // products instead of both waiting on the tensor cores at once. Both
  // visit every tile of an item's band (a tile outside a warpgroup's own
  // band is masked whole: p = 0), so their turns pair up: consumer 1 opens
  // with a pass and consumer 0 closes with a take.
  const int my_turn = 1 + wg, other_turn = 2 - wg;
  auto take_turn = [&]() {
    asm volatile("bar.sync %0, 256;\n" ::"r"(my_turn) : "memory");
  };
  auto pass_turn = [&]() {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(other_turn) : "memory");
  };
  if (wg == 1) pass_turn();

  int n = 0;  // tiles consumed so far: the ring's position
  for (int k = 0, j = 0; k * (int)gridDim.x < n_items; ++k) {
    const int w = item_of(k);
    if (w >= n_items) continue;
    const Item it = item_at<BKV>(p, w, nq, BH);
    r0 = it.q0 + 64 * wg;                  // this warpgroup's rows [r0, r1)
    r1 = min(p.S, r0 + 64);
    const int row = r0 + 16 * warp + g;    // this thread's rows: row, row + 8
    qpos = row + p.q_offset;
    first = it.first;
    const int nt = it.ntiles;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    m_run[0] = m_run[1] = M_INIT;
    l_run[0] = l_run[1] = 0.f;

    mbar_wait(q_full, j++ & 1);
    if (nt == 0) {
      release_q();
    } else {
      // Software pipeline: while the tensor cores run tile i's Q·Kᵀ and
      // then tile i - 1's P·V, the softmax of tile i waits only for the
      // first; O is rescaled once the second is done.
      float alpha[2];
      wait_full(n);
      take_turn();
      wgmma_fence();
      issue_qk(n);
      pass_turn();
      wgmma_wait<0>();
      fence_operands<BKV / 2>(sc);
      if (nt == 1) release_q();
      softmax(0, alpha);
      pack_p();
      for (int i = 1; i < nt; ++i) {
        wait_full(n + i);
        take_turn();
        wgmma_fence();
        issue_qk(n + i);
        issue_pv(n + i - 1);
        pass_turn();
        wgmma_wait<1>();
        fence_operands<BKV / 2>(sc);
        if (i == nt - 1) release_q();
        softmax(i, alpha);
        wgmma_wait<0>();
        fence_operands<HD / 2>(o);
        release(n + i - 1);
        rescale(alpha);
        pack_p();
      }
      take_turn();
      wgmma_fence();
      issue_pv(n + nt - 1);
      pass_turn();
      wgmma_wait<0>();
      fence_operands<HD / 2>(o);
      release(n + nt - 1);
      n += nt;
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
      l_run[r] = fmaxf(l_run[r], 1e-30f);
    }
    bf16* out = static_cast<bf16*>(p.o);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = row + 8 * r;
      if (q >= p.S) continue;
      bf16* dst = out + row_offset(it.b, q, p.S, p.H, it.h, HD) + 2 * t;
      const float inv = 1.f / l_run[r];
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                  o[4 * j + 2 * r + 1] * inv);
    }
  }
  if (wg == 0) take_turn();  // consumer 1's last pass
}

// cuTensorMapEncodeTiled from the driver the runtime has loaded: the
// library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A (B, L, NH, hd) bf16 tensor as a 4-D map over (hd, NH, L, B): boxes of
// 64 columns x 1 head x `rows` rows x 1 batch, 128-byte swizzle, zeros
// outside the tensor.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B,
              int L, int NH, int hd, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)NH, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)NH * hd * 2,
                                 (cuuint64_t)L * NH * hd * 2};
  const cuuint32_t box[4] = {BOX, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elems[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elems,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  using C = Tiles<HD>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map(encode, &tq, p.q, B, p.S, p.H, HD, BQ) ||
      !make_map(encode, &tk, p.k, B, p.T, p.KV, HD, C::BKV) ||
      !make_map(encode, &tv, p.v, B, p.T, p.KV, HD, C::BKV))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return cudaGetLastError();
  const long long items = (long long)((p.S + BQ - 1) / BQ) * B * p.H;
  const int grid = (int)(items < sms ? items : sms);  // one CTA per SM
  flash_wgmma_kernel<HD><<<grid, THREADS, C::SMEM, stream>>>(tq, tk, tv, p,
                                                             B * p.H);
  return cudaGetLastError();
}

}  // namespace

// q (B, S, H, hd), k and v (B, T, KV, hd), o (B, S, H, hd), all bf16,
// contiguous and 16-byte aligned; hd 64, 128 or 256; H a multiple of KV;
// B·H <= 65535.
extern "C" int flash_wgmma_fwd(const void* q, const void* k, const void* v,
                               void* o, int B, int S, int T, int H, int KV,
                               int hd, int causal, int window, float scale,
                               void* stream) {
  if (KV < 1 || H % KV != 0 || B < 1 || S < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) & 15)
    return (int)cudaErrorMisalignedAddress;
  const Params p{q, k, v, o, S, T, H, KV, H / KV, hd,
                 causal, window, T - S, 1, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return (int)launch<64>(p, B, st);
    case 128: return (int)launch<128>(p, B, st);
    case 256: return (int)launch<256>(p, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
