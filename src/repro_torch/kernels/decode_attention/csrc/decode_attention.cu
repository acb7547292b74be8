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
// once (2·KV·hd elements) for 4·KV·G·hd FLOPs, far below the card's ridge
// point: it is bound by bytes.
//
// Design (not the TPU's, which keeps a whole (C, hd) row of one kv-head in
// VMEM): two launches on one stream.
// 1. Split (grid (chunks, head groups, B)): a CTA takes `chunk` slots of one
//    sequence and every kv-head of them (a head group is all KV kv-heads and
//    up to kGMax q-heads each, unless KV·lanes passes the thread budget). In
//    the serve layout (B, C, KV, hd) those rows are one contiguous span. A
//    producer warp streams it in sub-chunks of `sub` slots through a ring
//    of shared-memory stages by TMA bulk copies (cp.async.bulk, one copy per
//    sub-chunk whose slots are all valid, else one per valid slot; completed
//    on the stage's mbarrier; invalid slots and sub-chunks with no valid
//    slot are not read), first every K sub-chunk, then every V sub-chunk,
//    so the math on one stage overlaps the copies of the next. Rows that are
//    not a whole number of 8 elements (or operands off a 16-byte boundary)
//    are staged element by element by the same warp into the same ring.
//    Consumers: a group of `lanes` lanes per (kv-head, share of the slots),
//    each lane 8 elements of the row with its q in registers, all G q-heads
//    scored per K row read. The dot products of NB slots are taken at once
//    without branches (every load, then every product, then each shuffle
//    level of a butterfly for all of them: the scoring was latency-bound
//    one slot at a time); every lane of a group ends with the same bits.
//    The chunk's max m is exact (its scores are all in shared memory before
//    any exp), so p = exp(s - m) is taken once per score, l = sum p, and
//    the context sum p·V accumulates in registers over the V stages. Out:
//    the scores (B, C, KV, G) and the chunk's m, l and context to one flat
//    f32 scratch.
// 2. Combine (grid (P, B), P·B >= kCombineCtas, at most kCombineSlots slots
//    each): every CTA folds its sequence's chunk m and l (small) into the
//    row's M and L, writes the mass of its slot range (sum over kv-heads in
//    order 0..KV-1 of the sum over g of exp(s - M) / max(L, 1e-30); 0 at
//    invalid slots and on rows with no valid slot; the exps taken by every
//    thread, the ordered sums by a thread per slot) and combines its share
//    of ctx over the chunks in a fixed order. Its loads go kLoadBatch at a
//    time before any use. No float atomics: every output is the same, bit
//    for bit, from launch to launch. (A programmatic dependent launch of
//    the combine, triggered at the split's start or after its V stages,
//    measured slower a call at every serving shape: PERF.md §6.)
// The layout (chunk, sub, lanes, head groups, combine CTAs) is a function
// of (B, C, KV, G, hd) alone, never of the dtype, so an f32 q over a bf16
// cache computes exactly what it computes over the cache upcast to f32.
// The wrapper (../kernel.py, decode_layout) computes the same layout; the
// entry point refuses a launch whose chunk or scratch size disagrees.
//
// Entry points (C ABI): decode_attention_fwd, which returns a cudaError_t,
// and decode_attention_layout, this file's layout of a shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGMax = 8;            // q-heads per head group
constexpr int kThreadsMax = 512;      // consumer threads, up to 2 q-heads
constexpr int kThreadsMaxWide = 256;  // consumer threads, 3-8 q-heads
constexpr int kMinThreads = 128;    // consumer threads at least
constexpr int kStageF32Bytes = 65536;  // a sub-chunk's K rows, counted in f32
constexpr int kSubMax = 32;         // slots per sub-chunk at most
constexpr int kScoreFloats = 8192;  // a chunk's scores in shared memory
constexpr int kChunkMax = 256;      // slots per chunk at most
constexpr int kTargetCtas = 264;    // 2 per SM on 132 SMs
constexpr int kCombineCtas = 264;   // the combine's CTAs at least
constexpr int kCombineSlots = 256;  // slots per combine CTA at most
constexpr int kCombineThreads = 256;
constexpr int kPairTile = 1024;     // (kv-head, q-head) pairs per combine tile
constexpr int kMassPairs = 32;      // pairs of scores staged per mass pass
constexpr int kBatch = 4;           // slots a lane group takes at once (2 at 8 q-heads)
constexpr int kLoadBatch = 8;       // the combine's loads in flight a thread
constexpr int kRingBytes = 65536;   // the split's ring of stages
constexpr int kMaxStages = 6;
constexpr int kMaxSmem = 227 * 1024;

struct Layout {
  int hdp;        // hd rounded up to 8 elements
  int units;      // 8-element units of a row
  int lanes;      // lanes per row: units rounded up to a power of 2
  int kvh;        // kv-heads per head group
  int gh;         // q-heads per head group
  int gmax;       // gh rounded up to a power of 2 (1, 2, 4 or 8)
  int rep;        // lane groups per kv-head (each a share of the slots)
  int threads;    // consumer threads of the split
  int sub;        // slots per sub-chunk
  int chunk;      // slots per split CTA
  int nchunks;    // chunks per sequence
  int kv_groups;  // head groups along KV
  int g_groups;   // head groups along G
  int combine;    // combine CTAs per sequence
};

int pow2ceil(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}
long long cdiv(long long a, long long b) { return (a + b - 1) / b; }
long long clampll(long long x, long long lo, long long hi) {
  return x < lo ? lo : x > hi ? hi : x;
}

Layout make_layout(int B, int C, int KV, int G, int hd) {
  Layout L;
  L.hdp = (hd + 7) / 8 * 8;
  L.units = L.hdp / 8;
  L.lanes = pow2ceil(L.units);
  L.gh = G < kGMax ? G : kGMax;
  L.gmax = pow2ceil(L.gh);
  const int tmax = L.gmax <= 2 ? kThreadsMax : kThreadsMaxWide;
  L.kvh = KV < tmax / L.lanes ? KV : tmax / L.lanes;
  const int rows = L.kvh * L.lanes;
  const int tmin = kMinThreads < tmax ? kMinThreads : tmax;
  L.rep = rows >= tmin ? 1 : tmin / rows;
  L.threads = (rows * L.rep + 31) / 32 * 32;
  L.sub = (int)clampll(kStageF32Bytes / (L.kvh * L.hdp * 4), 1, kSubMax);
  L.kv_groups = (int)cdiv(KV, L.kvh);
  L.g_groups = (int)cdiv(G, L.gh);
  const long long heads = (long long)L.kv_groups * L.g_groups;
  const long long want = cdiv(kTargetCtas, heads * B);  // chunks a sequence
  long long chunk = cdiv(cdiv(C, want), L.sub) * L.sub;
  long long cmax = kScoreFloats / (L.kvh * L.gh);
  cmax = (cmax < kChunkMax ? cmax : kChunkMax) / L.sub * L.sub;
  if (cmax < L.sub) cmax = L.sub;
  L.chunk = (int)clampll(chunk, L.sub, cmax);
  L.nchunks = (int)cdiv(C, L.chunk);
  const long long p2 = cdiv(kCombineCtas, B), p2s = cdiv(C, kCombineSlots);
  L.combine = (int)(p2 > p2s ? p2 : p2s);
  return L;
}

// f32 words of the scratch: chunk contexts (B, nchunks, KV, G, hdp) first
// (16-byte aligned rows), scores (B, C, KV, G), chunk m and l
// (B, nchunks, KV, G) each
long long scratch_floats(const Layout& L, int B, int C, int KV, int G) {
  const long long pairs = (long long)B * L.nchunks * KV * G;
  return (long long)B * C * KV * G + pairs * (2 + L.hdp);
}

struct Params {
  const void* q;         // (B, KV, G, hd), TQ
  const void* k;         // (B, C, KV, hd), TC
  const void* v;         // (B, C, KV, hd), TC
  const uint8_t* valid;  // (B, C)
  void* ctx;             // (B, KV, G, hd), TC
  float* mass;           // (B, C)
  float* part_ctx;       // (B, nchunks, KV, G, hdp)
  float* scores;         // (B, C, KV, G)
  float* part_m;         // (B, nchunks, KV, G)
  float* part_l;         // (B, nchunks, KV, G)
  int B, C, KV, G, hd;
  int vec;               // rows go by TMA bulk copies
  int stages;            // ring stages of the split
  float scale;           // 1 / sqrt(hd)
  Layout L;
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
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory by the TMA; they complete on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// the consumer threads' own barrier (the producer warp is not in it)
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

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

// 8 elements of shared memory (16-byte aligned) as f32
__device__ __forceinline__ void load8(const float* src, float* out) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Bytes of the split's ring, or of the lane groups' merge where that is
// larger ([rep][kvh][gh] contexts of hdp, then sums l), rounded up to 128.
__host__ __device__ inline size_t ring_region(const Layout& L, int stages,
                                              size_t esize) {
  const size_t ring = (size_t)stages * L.sub * L.kvh * L.hdp * esize;
  const size_t merge =
      L.rep > 1 ? (size_t)L.rep * L.kvh * L.gh * (L.hdp + 1) * sizeof(float) : 0;
  return ((ring > merge ? ring : merge) + 127) / 128 * 128;
}

// The running (max, sum) of exponentials (m, l) with one more (mj, lj)
// folded in: l is kept relative to m.
__device__ __forceinline__ void fold(float& m, float& l, float mj, float lj) {
  if (mj == -INFINITY) return;
  if (mj > m) {
    l = l * expf(m - mj) + lj;   // expf(-inf) = 0 on the first fold
    m = mj;
  } else {
    l += lj * expf(mj - m);
  }
}

// Pass 1: one CTA per (chunk, head group, b); `threads` consumers, then one
// producer warp.
template <typename TQ, typename TC, int GMAX>
__global__ void __launch_bounds__(GMAX <= 2 ? kThreadsMax + 32
                                            : kThreadsMaxWide + 32)
    decode_split_kernel(const Params p) {
  constexpr int NB = GMAX >= 8 ? 2 : kBatch;  // slots a lane group takes at once
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = p.L;
  const int j = blockIdx.x, hg = blockIdx.y, b = blockIdx.z;
  const int h0 = (hg % L.kv_groups) * L.kvh, g0 = (hg / L.kv_groups) * L.gh;
  const int KVH = min(L.kvh, p.KV - h0), GH = min(L.gh, p.G - g0);
  const int C = p.C, KV = p.KV, G = p.G, hd = p.hd, hdp = L.hdp;
  const int c0 = j * L.chunk, n = min(L.chunk, C - c0);
  const int sub = L.sub, nsub = (n + sub - 1) / sub;
  const int stages = p.stages, cs = L.chunk + 1;  // score row stride
  const size_t slot_elems = (size_t)KVH * hdp;     // a slot's rows, staged
  const size_t stage_elems = (size_t)sub * L.kvh * hdp;

  // shared memory (split_smem): the ring (reused for the lane groups'
  // merge), the mbarriers, the scores [kvh][g][slot], the sub-chunks' valid
  // counts, the valid bytes
  TC* ring = reinterpret_cast<TC*>(smem);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + ring_region(L, stages, sizeof(TC)));
  uint64_t* empty = full + kMaxStages;
  float* scs = reinterpret_cast<float*>(empty + kMaxStages);
  int* subcnt = reinterpret_cast<int*>(scs + (size_t)L.kvh * L.gh * cs);
  uint8_t* vs = reinterpret_cast<uint8_t*>(subcnt + kChunkMax);

  const int t = threadIdx.x;
  const int NTC = L.threads;
  if (t == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], p.vec ? 1 : 32);
      mbar_init(&empty[s], NTC / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = t; i < n; i += blockDim.x)
    vs[i] = p.valid[(size_t)b * C + c0 + i];

  // the consumer's cell: kv-head kvl, 8 elements at u·8, the slots of share
  // r; its lane group's shuffle mask
  const int lanes = L.lanes, u = t & (lanes - 1), grp = t / lanes;
  const int kvl = grp % L.kvh, r = grp / L.kvh;
  const bool active = t < NTC && r < L.rep && kvl < KVH;
  const bool unit = active && u < L.units;
  const int uu = u < L.units ? u : 0;  // a lane past the row reads unit 0
  const unsigned gmask =
      lanes == 32 ? 0xffffffffu
                  : ((1u << lanes) - 1u) << ((t & 31) & ~(lanes - 1));
  float q[GMAX][8];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) q[g][e] = 0.f;
  if (unit) {
    const TQ* qh = static_cast<const TQ*>(p.q) +
                   (((size_t)b * KV + h0 + kvl) * G + g0) * hd;
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g < GH)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int d = u * 8 + e;
          if (d < hd) q[g][e] = to_f32(qh[(size_t)g * hd + d]);
        }
  }
  __syncthreads();
  for (int sc = t; sc < nsub; sc += blockDim.x) {
    int cnt = 0;
    for (int s = sc * sub; s < min(n, (sc + 1) * sub); ++s) cnt += vs[s] != 0;
    subcnt[sc] = cnt;
  }
  __syncthreads();

  const TC* kc = static_cast<const TC*>(p.k);
  const TC* vc = static_cast<const TC*>(p.v);
  const size_t span = ((size_t)b * C + c0) * KV + h0;  // slot c0's first row

  if (t >= NTC) {  // the producer warp: K sub-chunks, then V sub-chunks
    const int lane = t & 31;
    const uint32_t slot_bytes = (uint32_t)(slot_elems * sizeof(TC));
    int i = 0;
    for (int kind = 0; kind < 2; ++kind) {
      const TC* src = kind ? vc : kc;
      for (int sc = 0; sc < nsub; ++sc) {
        if (subcnt[sc] == 0) continue;
        const int st = i % stages;
        if (i >= stages) mbar_wait(&empty[st], ((i / stages) & 1) ^ 1);
        TC* dst = ring + st * stage_elems;
        const int s_lo = sc * sub, ns = min(sub, n - s_lo);
        if (p.vec) {
          if (lane == 0) mbar_expect_tx(&full[st], subcnt[sc] * slot_bytes);
          __syncwarp();
          if (subcnt[sc] == ns && KVH == KV) {  // one span: one copy
            if (lane == 0)
              bulk_load(dst, src + (span + (size_t)s_lo * KV) * hd,
                        ns * slot_bytes, &full[st]);
          } else if (lane < ns && vs[s_lo + lane]) {
            bulk_load(dst + lane * slot_elems,
                      src + (span + (size_t)(s_lo + lane) * KV) * hd,
                      slot_bytes, &full[st]);
          }
        } else {
          const size_t total = (size_t)ns * slot_elems;
          for (size_t e = lane; e < total; e += 32) {
            const int sl = (int)(e / slot_elems);
            if (!vs[s_lo + sl]) continue;
            const int rem = (int)(e - sl * slot_elems);
            const int kv = rem / hdp, d = rem - kv * hdp;
            dst[e] = d < hd ? src[(span + (size_t)(s_lo + sl) * KV + kv) * hd + d]
                            : from_f32<TC>(0.f);
          }
          mbar_arrive(&full[st]);
        }
        ++i;
      }
    }
    return;
  }

  // K stages: the scores of every valid slot, into shared memory and the
  // scores scratch
  float* sc_row = scs + (size_t)kvl * L.gh * cs;  // [g][slot] of kv-head kvl
  float* sg = p.scores + (span + kvl) * G + g0;    // slot c0, kv-head h0+kvl
  int i = 0;
  for (int sc = 0; sc < nsub; ++sc) {
    if (subcnt[sc] == 0) continue;
    const int st = i % stages;
    mbar_wait(&full[st], (i / stages) & 1);
    const TC* buf = ring + st * stage_elems + kvl * hdp + uu * 8;
    const int s_lo = sc * sub, ns = min(sub, n - s_lo);
    if (active)
      for (int sl0 = r; sl0 < ns; sl0 += NB * L.rep) {
        // NB slots of share r at once, without branches: every load,
        // then every product, then each shuffle level of every slot
        float kf[NB][8], part[NB][GMAX];
        bool ok[NB];
#pragma unroll
        for (int x = 0; x < NB; ++x) {
          const int sl = sl0 + x * L.rep;
          ok[x] = sl < ns && vs[s_lo + (sl < ns ? sl : 0)];
          load8(buf + (sl < ns ? sl : 0) * slot_elems, kf[x]);
#pragma unroll
          for (int e = 0; e < 8; ++e) kf[x][e] = unit ? kf[x][e] : 0.f;
        }
#pragma unroll
        for (int x = 0; x < NB; ++x)
#pragma unroll
          for (int g = 0; g < GMAX; ++g) {
            float a = 0.f;
#pragma unroll
            for (int e = 0; e < 8; ++e) a = fmaf(q[g][e], kf[x][e], a);
            part[x][g] = a;
          }
        for (int o = lanes >> 1; o > 0; o >>= 1)
#pragma unroll
          for (int x = 0; x < NB; ++x)
#pragma unroll
            for (int g = 0; g < GMAX; ++g)
              part[x][g] += __shfl_xor_sync(gmask, part[x][g], o);
#pragma unroll
        for (int x = 0; x < NB; ++x)
#pragma unroll
          for (int g = 0; g < GMAX; ++g)
            if (ok[x] && g < GH && (g & (lanes - 1)) == u) {
              const int s = s_lo + sl0 + x * L.rep;
              const float y = part[x][g] * p.scale;
              sc_row[g * cs + s] = y;
              sg[(size_t)s * KV * G + g] = y;
            }
      }
    __syncwarp();
    if ((t & 31) == 0) mbar_arrive(&empty[st]);
    ++i;
  }

  // the chunk's softmax: m over every valid slot (exact), then p = exp(s - m)
  // in place at the slots of share r, and their sum
  consumers_sync(NTC);
  float m[GMAX], l[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
  }
  if (active) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= GH) continue;
      float x = -INFINITY;
      for (int s = u; s < n; s += lanes)
        if (vs[s]) x = fmaxf(x, sc_row[g * cs + s]);
      for (int o = lanes >> 1; o > 0; o >>= 1)
        x = fmaxf(x, __shfl_xor_sync(gmask, x, o));
      m[g] = x;
    }
  }
  consumers_sync(NTC);  // every max read before p overwrites a score
  if (active) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= GH) continue;
      float sum = 0.f;
      for (int s = r + L.rep * u; s < n; s += L.rep * lanes) {
        float e = 0.f;
        if (vs[s] && m[g] != -INFINITY) e = expf(sc_row[g * cs + s] - m[g]);
        sc_row[g * cs + s] = e;
        sum += e;
      }
      for (int o = lanes >> 1; o > 0; o >>= 1)
        sum += __shfl_xor_sync(gmask, sum, o);
      l[g] = sum;
    }
  }
  consumers_sync(NTC);  // every p written before the V stages read them

  // V stages: the chunk's unnormalised context, in registers
  float acc[GMAX][8];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  for (int sc = 0; sc < nsub; ++sc) {
    if (subcnt[sc] == 0) continue;
    const int st = i % stages;
    mbar_wait(&full[st], (i / stages) & 1);
    const TC* buf = ring + st * stage_elems + kvl * hdp + u * 8;
    const int s_lo = sc * sub, ns = min(sub, n - s_lo);
    if (unit)
      for (int sl0 = r; sl0 < ns; sl0 += NB * L.rep) {
        float vf[NB][8], pg[NB][GMAX];
#pragma unroll
        for (int x = 0; x < NB; ++x) {
          const int sl = sl0 + x * L.rep, sc0 = sl < ns ? sl : 0;
          const bool ok = sl < ns && vs[s_lo + sc0];
          load8(buf + sc0 * slot_elems, vf[x]);
#pragma unroll
          for (int e = 0; e < 8; ++e) vf[x][e] = ok ? vf[x][e] : 0.f;
#pragma unroll
          for (int g = 0; g < GMAX; ++g)
            pg[x][g] = ok && g < GH ? sc_row[g * cs + s_lo + sc0] : 0.f;
        }
#pragma unroll
        for (int x = 0; x < NB; ++x)
#pragma unroll
          for (int g = 0; g < GMAX; ++g)
#pragma unroll
            for (int e = 0; e < 8; ++e)
              acc[g][e] = fmaf(pg[x][g], vf[x][e], acc[g][e]);
      }
    __syncwarp();
    if ((t & 31) == 0) mbar_arrive(&empty[st]);
    ++i;
  }

  // out: the chunk's m, l and context; the shares of a kv-head summed in
  // order r = 0, 1, ... through shared memory (the ring, free by now)
  const size_t pair0 = (((size_t)b * L.nchunks + j) * KV + h0 + kvl) * G + g0;
  if (L.rep > 1) {
    consumers_sync(NTC);
    float* macc = reinterpret_cast<float*>(smem);  // [r][kvh][gh][hdp]
    float* ml = macc + (size_t)L.rep * L.kvh * L.gh * hdp;  // [r][kvh][gh]
    const size_t cell = ((size_t)r * L.kvh + kvl) * L.gh;
    if (active) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= GH) continue;
        if (unit)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            macc[(cell + g) * hdp + u * 8 + e] = acc[g][e];
        if (u == 0) ml[cell + g] = l[g];
      }
    }
    consumers_sync(NTC);
    if (!active || r != 0) return;
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= GH) continue;
      for (int rr = 1; rr < L.rep; ++rr) {
        const size_t other = ((size_t)rr * L.kvh + kvl) * L.gh + g;
        if (unit)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] += macc[other * hdp + u * 8 + e];
        l[g] += ml[other];
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= GH) continue;
    if (unit) {
      float4* dst = reinterpret_cast<float4*>(p.part_ctx + (pair0 + g) * hdp +
                                              u * 8);
      dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
    }
    if (u == 0) {
      p.part_m[pair0 + g] = m[g];
      p.part_l[pair0 + g] = l[g];
    }
  }
}

// fold() over chunks j = j0, j0 + step, ... < nc of one pair (pm and pl
// point at the pair's chunk 0; chunks are `stride` apart), kLoadBatch
// chunks' loads at a time before their folds.
__device__ __forceinline__ void fold_chunks(float& m, float& l,
                                            const float* pm, const float* pl,
                                            int j0, int step, int nc,
                                            int stride) {
  for (; j0 < nc; j0 += kLoadBatch * step) {
    float mb[kLoadBatch], lb[kLoadBatch];
#pragma unroll
    for (int x = 0; x < kLoadBatch; ++x) {
      const int j = j0 + x * step, jj = j < nc ? j : 0;
      mb[x] = j < nc ? pm[(size_t)jj * stride] : -INFINITY;
      lb[x] = pl[(size_t)jj * stride];
    }
#pragma unroll
    for (int x = 0; x < kLoadBatch; ++x) fold(m, l, mb[x], lb[x]);
  }
}

// Pass 2: one CTA per (share of the sequence, b). Per tile of kv-heads:
// each (kv-head, q-head) pair's M = max_j m_j and L = sum_j l_j e^(m_j - M)
// over the chunks j, the chunks split over threads and the slices folded
// in order; the mass of the CTA's slots; the CTA's share of ctx,
// sum_j ctx_j e^(m_j - M) / max(L, 1e-30), the chunks likewise split and
// the slices summed in order. Loops over global memory are unrolled so
// their loads are in flight together.
template <typename TO>
__global__ void __launch_bounds__(kCombineThreads)
    decode_combine_kernel(const Params p) {
  extern __shared__ float sm2[];
  const int k = blockIdx.x, P = gridDim.x, b = blockIdx.y, t = threadIdx.x;
  const int C = p.C, KV = p.KV, G = p.G, hd = p.hd, hdp = p.L.hdp;
  const int nc = p.L.nchunks, KVG = KV * G;
  const int tkv = G >= kPairTile ? 1 : kPairTile / G;  // kv-heads a tile
  const int npmax = (tkv < KV ? tkv : KV) * G;
  float* red = sm2;                        // [2][kCombineThreads]
  float* Ms = red + 2 * kCombineThreads;   // [npmax]
  float* Ds = Ms + npmax;                  // [npmax]
  float* stage = Ds + npmax;  // [kCombineSlots][kMassPairs + 1]

  const int c0 = (int)((long long)C * k / P), c1 = (int)((long long)C * (k + 1) / P);
  const long long E = (long long)KVG * hd;
  const long long e0 = E * k / P, e1 = E * (k + 1) / P;
  const int c = c0 + t;
  const bool live = c < c1 && p.valid[(size_t)b * C + c];
  TO* ctx = static_cast<TO*>(p.ctx) + (size_t)b * KVG * hd;
  const float* pm = p.part_m + (size_t)b * nc * KVG;  // [j][pair]
  const float* pl = p.part_l + (size_t)b * nc * KVG;
  float total = 0.f, tt = 0.f;  // the slot's mass, its kv-head's part
  int g = 0;                      // q-heads of that kv-head summed in tt

  for (int h0 = 0; h0 < KV; h0 += tkv) {
    const int h1 = min(KV, h0 + tkv), np = (h1 - h0) * G, pa0 = h0 * G;
    // M and max(L, 1e-30) of the tile's pairs
    if (np < kCombineThreads) {
      const int JS = kCombineThreads / np, pi = t % np, js = t / np;
      float m = -INFINITY, l = 0.f;
      if (js < JS) fold_chunks(m, l, pm + pa0 + pi, pl + pa0 + pi, js, JS, nc, KVG);
      red[t] = m;
      red[kCombineThreads + t] = l;
      __syncthreads();
      if (t < np) {
        float M = -INFINITY, Ls = 0.f;
        for (int s = 0; s < JS; ++s)
          fold(M, Ls, red[s * np + t], red[kCombineThreads + s * np + t]);
        Ms[t] = M;
        Ds[t] = fmaxf(Ls, 1e-30f);
      }
    } else {
      for (int pi = t; pi < np; pi += kCombineThreads) {
        float M = -INFINITY, Ls = 0.f;
        fold_chunks(M, Ls, pm + pa0 + pi, pl + pa0 + pi, 0, 1, nc, KVG);
        Ms[pi] = M;
        Ds[pi] = fmaxf(Ls, 1e-30f);
      }
    }
    __syncthreads();

    // the mass of slot c: kv-heads in order, q-heads summed within each.
    // kMassPairs pairs at a time: the CTA's scores come into shared memory
    // row by row (coalesced), every thread turns its share of them into
    // e^(s - M) / max(L, 1e-30) in place, then each slot's thread sums its
    // row in order
    const int ns = c1 - c0;
    for (int q0 = 0; q0 < np; q0 += kMassPairs) {
      const int nq = min(kMassPairs, np - q0), n_el = ns * nq;
      const float* src = p.scores + ((size_t)b * C + c0) * KVG + pa0 + q0;
      for (int i0 = t; i0 < n_el; i0 += kLoadBatch * kCombineThreads) {
        float vb[kLoadBatch];
#pragma unroll
        for (int x = 0; x < kLoadBatch; ++x) {
          const int i = i0 + x * kCombineThreads, ii = i < n_el ? i : 0;
          const int cc = ii / nq;
          vb[x] = src[(size_t)cc * KVG + ii - cc * nq];
        }
#pragma unroll
        for (int x = 0; x < kLoadBatch; ++x) {
          const int i = i0 + x * kCombineThreads;
          if (i < n_el) {
            const int cc = i / nq, qq = i - cc * nq;
            stage[cc * (kMassPairs + 1) + qq] =
                expf(vb[x] - Ms[q0 + qq]) / Ds[q0 + qq];
          }
        }
      }
      __syncthreads();
      if (live) {
        const float* row = stage + t * (kMassPairs + 1);
        for (int qq = 0; qq < nq; ++qq) {
          tt += row[qq];
          if (++g == G) {
            total += tt;
            tt = 0.f;
            g = 0;
          }
        }
      }
      __syncthreads();
    }

    // this CTA's ctx elements of the tile, each summed over the chunks
    const long long lo = e0 > (long long)pa0 * hd ? e0 : (long long)pa0 * hd;
    const long long hi = e1 < (long long)(pa0 + np) * hd ? e1
                                                         : (long long)(pa0 + np) * hd;
    const int EC = hi > lo ? (int)(hi - lo) : 0;
    const int JS = EC >= kCombineThreads ? 1 : kCombineThreads / (EC > 0 ? EC : 1);
    const int IR = kCombineThreads / JS;  // elements a round
    for (int r0 = 0; r0 < EC; r0 += IR) {
      const int il = t % IR, js = t / IR;
      const bool act = r0 + il < EC && js < JS;
      float acc = 0.f;
      long long e = lo + r0 + il;
      const int pair = act ? (int)(e / hd) : pa0;
      const float M = Ms[pair - pa0];
      if (act && M != -INFINITY) {
        const float* pc = p.part_ctx + ((size_t)b * nc * KVG + pair) * hdp +
                          (e - (long long)pair * hd);
        for (int j0 = js; j0 < nc; j0 += kLoadBatch * JS) {
          // the batch's loads first (a chunk past the end or with no valid
          // slot weighs 0: its ctx_j is 0)
          float mb[kLoadBatch], cb[kLoadBatch];
#pragma unroll
          for (int x = 0; x < kLoadBatch; ++x) {
            const int j = j0 + x * JS, jj = j < nc ? j : 0;
            mb[x] = j < nc ? pm[(size_t)jj * KVG + pair] : -INFINITY;
            cb[x] = pc[(size_t)jj * KVG * hdp];
          }
#pragma unroll
          for (int x = 0; x < kLoadBatch; ++x) {
            const float w = mb[x] == -INFINITY ? 0.f : expf(mb[x] - M);
            acc = fmaf(cb[x], w, acc);
          }
        }
      }
      if (JS > 1) {
        red[t] = acc;
        __syncthreads();
        if (t < IR && r0 + t < EC) {
          float s = 0.f;
          for (int x = 0; x < JS; ++x) s += red[x * IR + t];
          const long long ee = lo + r0 + t;
          const int pr = (int)(ee / hd);
          ctx[ee] = from_f32<TO>(Ms[pr - pa0] == -INFINITY ? 0.f
                                                           : s / Ds[pr - pa0]);
        }
        __syncthreads();
      } else if (act) {
        ctx[e] = from_f32<TO>(M == -INFINITY ? 0.f : acc / Ds[pair - pa0]);
      }
    }
    __syncthreads();  // before the next tile's M and L
  }
  if (c < c1) p.mass[(size_t)b * C + c] = total;
}

size_t split_smem(const Layout& L, int stages, size_t esize) {
  return ring_region(L, stages, esize) + 2 * kMaxStages * sizeof(uint64_t) +
         (size_t)L.kvh * L.gh * (L.chunk + 1) * sizeof(float) +
         kChunkMax * sizeof(int) + kChunkMax;
}

size_t combine_smem(const Params& p) {
  const int tkv = p.G >= kPairTile ? 1 : kPairTile / p.G;
  const int npmax = (tkv < p.KV ? tkv : p.KV) * p.G;
  return (2 * kCombineThreads + 2 * (size_t)npmax +
          (size_t)kCombineSlots * (kMassPairs + 1)) *
         sizeof(float);
}

// Lets `fn` take `bytes` of dynamic shared memory on the current device;
// the attribute is set once per kernel, device and size reached (a CUDA
// API call each launch would be host time for nothing).
cudaError_t allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  struct Set { const void* fn; int device; size_t bytes; };
  static Set done[64];
  static int used = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < used; ++i)
    if (done[i].fn == fn && done[i].device == device && done[i].bytes >= bytes)
      return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && used < 64) done[used++] = Set{fn, device, bytes};
  return err;
}

template <typename TQ, typename TC, int GMAX>
cudaError_t launch_split(const Params& p, size_t smem, cudaStream_t stream) {
  auto fn = decode_split_kernel<TQ, TC, GMAX>;
  cudaError_t err = allow_smem((const void*)fn, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.L.nchunks, p.L.kv_groups * p.L.g_groups, p.B);
  fn<<<grid, p.L.threads + 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename TQ, typename TC>
cudaError_t run(Params p, cudaStream_t stream) {
  const Layout& L = p.L;
  const size_t stage = (size_t)L.sub * L.kvh * L.hdp * sizeof(TC);
  p.stages = (int)clampll((long long)(kRingBytes / stage), 2, kMaxStages);
  const size_t smem = split_smem(L, p.stages, sizeof(TC));
  const size_t smem2 = combine_smem(p);
  if (smem > kMaxSmem || smem2 > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err;
  switch (L.gmax) {
    case 1: err = launch_split<TQ, TC, 1>(p, smem, stream); break;
    case 2: err = launch_split<TQ, TC, 2>(p, smem, stream); break;
    case 4: err = launch_split<TQ, TC, 4>(p, smem, stream); break;
    default: err = launch_split<TQ, TC, 8>(p, smem, stream); break;
  }
  if (err != cudaSuccess) return err;
  auto combine = decode_combine_kernel<TC>;
  err = allow_smem((const void*)combine, smem2);
  if (err != cudaSuccess) return err;
  combine<<<dim3(L.combine, p.B), kCombineThreads, smem2, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The split and the combine on `stream`. Tensors contiguous; the caches one
// dtype (bf16 or f32), q the caches' dtype or f32 over a bf16 cache; ctx in
// the caches' dtype; `scratch` f32 of at least scratch_floats words;
// `chunk` the wrapper's slots per chunk, refused unless it is this file's.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* valid, void* ctx,
    void* mass, void* scratch, long long scratch_words, int q_bf16,
    int cache_bf16, int B, int C, int KV, int G, int hd, int vec, int chunk,
    float scale, void* stream) {
  if (B < 1 || C < 1 || KV < 1 || G < 1 || hd < 1 || hd > 256 || B > 65535 ||
      (q_bf16 && !cache_bf16))
    return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(B, C, KV, G, hd);
  if (chunk != L.chunk || scratch_words < scratch_floats(L, B, C, KV, G) ||
      (long long)L.kv_groups * L.g_groups > 65535)
    return (int)cudaErrorInvalidValue;
  float* s = static_cast<float*>(scratch);
  const size_t pairs = (size_t)B * L.nchunks * KV * G;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.valid = static_cast<const uint8_t*>(valid);
  p.ctx = ctx;
  p.mass = static_cast<float*>(mass);
  p.part_ctx = s;
  p.scores = s + pairs * L.hdp;
  p.part_m = p.scores + (size_t)B * C * KV * G;
  p.part_l = p.part_m + pairs;
  p.B = B;
  p.C = C;
  p.KV = KV;
  p.G = G;
  p.hd = hd;
  p.vec = vec && hd % 8 == 0;
  p.stages = 2;
  p.scale = scale;
  p.L = L;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!cache_bf16) return (int)run<float, float>(p, st);
  return (int)(q_bf16 ? run<__nv_bfloat16, __nv_bfloat16>(p, st)
                      : run<float, __nv_bfloat16>(p, st));
}

// This file's layout of a shape, in the order of Layout's fields, then the
// scratch's f32 words (as two ints, low then high): 16 ints.
extern "C" void decode_attention_layout(int B, int C, int KV, int G, int hd,
                                        int* out) {
  const Layout L = make_layout(B, C, KV, G, hd);
  const int fields[] = {L.hdp,   L.units, L.lanes,   L.kvh,      L.gh,
                        L.gmax,  L.rep,   L.threads, L.sub,      L.chunk,
                        L.nchunks, L.kv_groups, L.g_groups, L.combine};
  for (int i = 0; i < 14; ++i) out[i] = fields[i];
  const long long words = scratch_floats(L, B, C, KV, G);
  out[14] = (int)(words & 0xffffffffll);
  out[15] = (int)(words >> 32);
}
