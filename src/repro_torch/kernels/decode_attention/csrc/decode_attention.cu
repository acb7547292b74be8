// Decode attention with per-slot attention mass for the H100 (sm_90a),
// bound with ctypes.
//
// Replaces the Pallas TPU kernel decode_attention_kernel
// (src/repro/kernels/decode_attention/kernel.py:61): one new token per
// sequence attends, per q-head, over a budgeted cache of C slots with a
// validity mask (single-shot softmax), and the kernel also returns the
// per-slot probability mass summed over every q-head: the weighted-insert
// stream of the SS± heavy-hitter cache (serve/h2o.py). The plain version is
// ../ref.py.
//
// What bounds it: reading the cache. Each valid slot's K and V rows are read
// once (2·hd elements per kv-head) for 4·G·hd FLOPs, far below the card's
// ridge point: it is bound by bytes.
//
// Design (not the TPU's): the Pallas kernel keeps a whole (C, hd) cache row
// of a kv-head in VMEM; at C = 8,192, hd = 128 that is 2 MB per tensor, and
// an SM has 228 KB of shared memory. So the C axis is split across CTAs
// (split-K, "flash decoding"), in three passes on one stream:
// 1. grid (C / chunk, KV, B): a CTA stages its chunk of K and V rows of one
//    kv-head in shared memory, read in place from the serve layout
//    (B, C, KV, hd) (a slot's row of a kv-head is contiguous: 256 bytes at
//    hd = 128 in bf16), by cp.async 16 bytes a thread where alignment
//    allows, the whole chunk in flight at once, with no transposed copy;
//    invalid slots are not read. One thread per slot computes its G scores
//    (a pass of dependent shuffle reductions per slot was latency-bound)
//    and writes them to an f32 scratch (B, KV, G, C); then the chunk's max
//    m, sum l and unnormalised context go to a partials scratch. A chunk
//    is CHUNK = 64 slots, so 6 CTAs fit an SM at hd = 128;
// 2. grid (KV, B): combine the chunks into the final m, l and ctx, each
//    chunk's weight exp(m_j - m) / l computed once in shared memory;
// 3. one thread per (b, c): mass = sum over kv of (sum over g of
//    exp(s - m) / max(l, 1e-30)), kv in order 0..KV-1, 0 for invalid
//    slots and for rows with no valid slot. No float atomics: the mass is
//    the same, bit for bit, from run to run.
// valid arrives as torch.bool and is read as bytes.
//
// Entry points (C ABI): decode_attention_fwd, which returns a cudaError_t,
// and decode_attention_chunk, the slots per chunk (the wrapper sizes the
// partials scratch by it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int MASS_THREADS = 256;
constexpr int MAX_SMEM = 227 * 1024;
constexpr int CHUNK = 64;  // cache slots per pass-1 CTA

struct Params {
  const void* q;        // (B, KV, G, hd)
  const void* k;        // (B, C, KV, hd)
  const void* v;        // (B, C, KV, hd)
  const uint8_t* valid; // (B, C)
  void* ctx;            // (B, KV, G, hd), v's dtype
  float* mass;          // (B, C)
  float* scores;        // (B, KV, G, C) scratch
  float* part_m;        // (B, KV, nchunks, G) scratch
  float* part_l;        // (B, KV, nchunks, G) scratch
  float* part_ctx;      // (B, KV, nchunks, G, hd) scratch
  float* row_m;         // (B, KV, G) scratch
  float* row_l;         // (B, KV, G) scratch
  int C, KV, G, hd, nchunks;
  int vec;              // cache rows may be read 16 bytes at a time
  float scale;          // 1 / sqrt(hd)
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// 16 bytes from global to shared memory without a register round trip;
// zeros where `full` is false (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// 16 bytes of shared memory as f32: 4 floats or 8 bf16.
__device__ __forceinline__ void load16_f32(const float* src, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void load16_f32(const __nv_bfloat16* src,
                                           float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// A staged cache row: hd rounded up to 16-byte units, then to an odd number
// of units, so one thread per row reading 16 bytes at a time meets no bank
// conflict.
template <typename T>
struct RowLayout {
  static constexpr int E = 16 / sizeof(T);  // elements per 16 bytes
  int units, ld;                            // 16-byte units of hd; row stride
  __device__ __host__ explicit RowLayout(int hd)
      : units((hd + E - 1) / E), ld((((hd + E - 1) / E) | 1) * E) {}
};

template <typename T>
size_t chunk_smem_bytes(const Params& p) {
  const RowLayout<T> row(p.hd);
  return 2 * (size_t)CHUNK * row.ld * sizeof(T) +
         (size_t)p.G * (row.units * RowLayout<T>::E + CHUNK) * sizeof(float) +
         CHUNK;
}

// Pass 1: one CTA per (chunk, kv-head, b).
template <typename T>
__global__ void __launch_bounds__(THREADS) decode_chunk_kernel(const Params p) {
  constexpr int E = RowLayout<T>::E;
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunk = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int c0 = chunk * CHUNK, n = min(CHUNK, p.C - c0);
  const int hd = p.hd, G = p.G;
  const RowLayout<T> row(hd);
  const int hdp = row.units * E;                  // hd padded to 16 bytes
  T* Ks = reinterpret_cast<T*>(smem);         // [CHUNK][row.ld]
  T* Vs = Ks + (size_t)CHUNK * row.ld;        // [CHUNK][row.ld]
  float* qs = reinterpret_cast<float*>(Vs + (size_t)CHUNK * row.ld);  // [G][hdp]
  float* ps = qs + G * hdp;                   // [G][CHUNK]
  uint8_t* live = reinterpret_cast<uint8_t*>(ps + G * CHUNK);  // [CHUNK]
  const T* kc = static_cast<const T*>(p.k);
  const T* vc = static_cast<const T*>(p.v);
  const T* qh = static_cast<const T*>(p.q) + ((size_t)b * p.KV + kvh) * G * hd;
  const size_t row0 = ((size_t)b * p.C + c0) * p.KV + kvh;  // slot c0's row

  for (int c = threadIdx.x; c < n; c += THREADS)
    live[c] = p.valid[(size_t)b * p.C + c0 + c];
  for (int i = threadIdx.x; i < G * hdp; i += THREADS) {
    const int g = i / hdp, d = i - g * hdp;
    qs[i] = d < hd ? to_f32(qh[g * hd + d]) : 0.f;
  }
  __syncthreads();

  // stage the chunk's K and V rows (zeros at invalid slots and past hd):
  // with cp.async every row of the chunk is in flight at once
  if (p.vec) {  // hd is a whole number of 16-byte units
    for (int i = threadIdx.x; i < n * row.units; i += THREADS) {
      const int c = i / row.units, d = (i - c * row.units) * E;
      const bool full = live[c] != 0;
      const size_t off = full ? (row0 + (size_t)c * p.KV) * hd + d : 0;
      cp_async16(Ks + c * row.ld + d, kc + off, full);
      cp_async16(Vs + c * row.ld + d, vc + off, full);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
  } else {
    for (int i = threadIdx.x; i < n * hdp; i += THREADS) {
      const int c = i / hdp, d = i - c * hdp;
      T kx = from_f32<T>(0.f), vx = kx;
      if (live[c] && d < hd) {
        const size_t off = (row0 + (size_t)c * p.KV) * hd + d;
        kx = kc[off];
        vx = vc[off];
      }
      Ks[c * row.ld + d] = kx;
      Vs[c * row.ld + d] = vx;
    }
  }
  __syncthreads();

  // scores: one thread per slot, 16 bytes of its K row at a time; -inf at
  // invalid slots; into shared memory and the scores scratch
  float* sc = p.scores + ((size_t)b * p.KV + kvh) * G * p.C + c0;
  for (int c = threadIdx.x; c < n; c += THREADS) {
    const T* krow = Ks + c * row.ld;
    for (int g = 0; g < G; ++g) {
      float x = -INFINITY;
      if (live[c]) {
        const float* qg = qs + g * hdp;
        float acc = 0.f;
        for (int u = 0; u < row.units; ++u) {
          float kf[E], qf[E];
          load16_f32(krow + u * E, kf);
#pragma unroll
          for (int e = 0; e < E; e += 4) load16_f32(qg + u * E + e, qf + e);
#pragma unroll
          for (int e = 0; e < E; ++e) acc = fmaf(qf[e], kf[e], acc);
        }
        x = acc * p.scale;
      }
      ps[g * CHUNK + c] = x;
      sc[(size_t)g * p.C + c] = x;
    }
  }
  __syncthreads();

  // the chunk's softmax: p = exp(s - m) in place, one warp per q-head
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t part = (((size_t)b * p.KV + kvh) * p.nchunks + chunk) * G;
  for (int g = warp; g < G; g += THREADS / 32) {
    float* pg = ps + g * CHUNK;
    float m = -INFINITY;
    for (int c = lane; c < n; c += 32) m = fmaxf(m, pg[c]);
    m = warp_max(m);
    float l = 0.f;
    for (int c = lane; c < n; c += 32) {
      const float e = m == -INFINITY ? 0.f : expf(pg[c] - m);
      pg[c] = e;
      l += e;
    }
    l = warp_sum(l);
    if (lane == 0) {
      p.part_m[part + g] = m;
      p.part_l[part + g] = l;
    }
  }
  __syncthreads();

  // the chunk's unnormalised context: one thread per column
  for (int d = threadIdx.x; d < hd; d += THREADS)
    for (int g = 0; g < G; ++g) {
      const float* pg = ps + g * CHUNK;
      float acc = 0.f;
#pragma unroll 4
      for (int c = 0; c < n; ++c)
        acc = fmaf(pg[c], to_f32(Vs[c * row.ld + d]), acc);
      p.part_ctx[(part + g) * hd + d] = acc;
    }
}

// Pass 2: one CTA per (kv-head, b) combines its chunks: per q-head, warp 0
// finds the final m and l and each chunk's weight exp(m_j - m) / l, then
// every thread sums the weighted partial contexts of its columns.
template <typename T>
__global__ void __launch_bounds__(THREADS) decode_combine_kernel(const Params p) {
  extern __shared__ float weight[];  // [nchunks]
  const int kvh = blockIdx.x, b = blockIdx.y, lane = threadIdx.x & 31;
  const size_t head = (size_t)b * p.KV + kvh;
  const int nc = p.nchunks, G = p.G;
  T* ctx = static_cast<T*>(p.ctx) + head * G * p.hd;
  for (int g = 0; g < G; ++g) {
    const float* pm = p.part_m + head * nc * G + g;
    const float* pl = p.part_l + head * nc * G + g;
    if (threadIdx.x < 32) {
      float m = -INFINITY;
      for (int j = lane; j < nc; j += 32) m = fmaxf(m, pm[(size_t)j * G]);
      m = warp_max(m);
      float l = 0.f;
      if (m != -INFINITY)
        for (int j = lane; j < nc; j += 32)
          l += pl[(size_t)j * G] * expf(pm[(size_t)j * G] - m);
      l = warp_sum(l);
      const float denom = fmaxf(l, 1e-30f);
      for (int j = lane; j < nc; j += 32)
        weight[j] = m == -INFINITY ? 0.f : expf(pm[(size_t)j * G] - m) / denom;
      if (lane == 0) {
        p.row_m[head * G + g] = m;
        p.row_l[head * G + g] = l;
      }
    }
    __syncthreads();
    for (int d = threadIdx.x; d < p.hd; d += THREADS) {
      const float* part = p.part_ctx + (head * nc * G + g) * p.hd + d;
      float acc = 0.f;
#pragma unroll 8
      for (int j = 0; j < nc; ++j)
        acc = fmaf(part[(size_t)j * G * p.hd], weight[j], acc);
      ctx[g * p.hd + d] = from_f32<T>(acc);
    }
    __syncthreads();  // before the next q-head's weights
  }
}

// Pass 3: one thread per (b, c).
__global__ void __launch_bounds__(MASS_THREADS) decode_mass_kernel(const Params p) {
  const int c = blockIdx.x * MASS_THREADS + threadIdx.x, b = blockIdx.y;
  if (c >= p.C) return;
  float total = 0.f;
  if (p.valid[(size_t)b * p.C + c]) {  // then every (kv, g) has a finite m
#pragma unroll 4
    for (int kvh = 0; kvh < p.KV; ++kvh) {
      const size_t head = ((size_t)b * p.KV + kvh) * p.G;
      float t = 0.f;
      for (int g = 0; g < p.G; ++g)
        t += expf(p.scores[(head + g) * p.C + c] - p.row_m[head + g]) /
             fmaxf(p.row_l[head + g], 1e-30f);
      total += t;
    }
  }
  p.mass[(size_t)b * p.C + c] = total;
}

template <typename T>
cudaError_t run(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = chunk_smem_bytes<T>(p);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  decode_chunk_kernel<T><<<dim3(p.nchunks, p.KV, B), THREADS, smem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t weights = (size_t)p.nchunks * sizeof(float);
  if (weights > MAX_SMEM) return cudaErrorInvalidValue;
  if (weights > 48 * 1024) {
    err = cudaFuncSetAttribute(decode_combine_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)weights);
    if (err != cudaSuccess) return err;
  }
  decode_combine_kernel<T><<<dim3(p.KV, B), THREADS, weights, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_mass_kernel<<<dim3((p.C + MASS_THREADS - 1) / MASS_THREADS, B),
                       MASS_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The three passes on `stream`. Tensors contiguous; q, k, v one dtype (bf16
// or f32); the scratch f32 buffers sized as in Params; KV, B <= 65535.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* valid, void* ctx,
    void* mass, void* scores, void* part_m, void* part_l, void* part_ctx,
    void* row_m, void* row_l, int bf16, int B, int C, int KV, int G, int hd,
    int vec, float scale, void* stream) {
  if (B < 1 || C < 1 || KV < 1 || G < 1 || hd < 1)
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, static_cast<const uint8_t*>(valid), ctx,
                 static_cast<float*>(mass), static_cast<float*>(scores),
                 static_cast<float*>(part_m), static_cast<float*>(part_l),
                 static_cast<float*>(part_ctx), static_cast<float*>(row_m),
                 static_cast<float*>(row_l), C, KV, G, hd,
                 (C + CHUNK - 1) / CHUNK, vec, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? run<__nv_bfloat16>(p, B, st) : run<float>(p, B, st));
}

// Cache slots per chunk of pass 1.
extern "C" int decode_attention_chunk(void) { return CHUNK; }
