// Serial SpaceSaving± baseline: one update per raw item, for sm_90a.
//
// Replaces the Pallas TPU kernel sketch_update_kernel_serial
// (src/repro/kernels/sketch_update/kernel.py:396, body _serial_kernel at
// :379, one _apply_one at :317 per item). One CTA walks the B items of the
// block in order over the n = R * 128 slots of one padded sketch
// (phases.pad_rows). Per item of weight w != 0:
//   w > 0: the first slot monitoring the item (id == item, id >= 0) adds
//          w; else the first EMPTY slot (id == -1; BLOCKED padding is not
//          empty) takes (item, w, 0); else the first slot at the minimum
//          of where(empty, INT_MAX, counts), mc, takes (item, mc + w, mc);
//   w < 0: the monitored slot subtracts -w; else (SS±, variant 2) -w
//          drains greedily from the first maximum-error slots; Lazy drops
//          it.
// The adds are the reference's plain int32 adds, which wrap: they are
// taken in unsigned 32-bit here (signed overflow is undefined in CUDA).
// With `saturate` set, the two insert adds (a monitored slot's count + w,
// and mc + w) saturate at +-(2^31 - 1) instead: the reference's
// blocks.apply_update (sat_add), which its serial backend
// (blocks.block_update_serial) and process_stream scan item by item.
//
// Design: the paper's efficient implementation, not a rescan per item.
// The four answers an item needs come from structures kept beside the
// slots, each updated where a slot changes:
// - the monitored slot: an open-addressing (linear probing) table from id
//   (>= 0) to the lowest slot holding it, probed 32 entries at a time by
//   one warp; bit 31 of an entry marks an id held by more than one slot
//   (a state may hold duplicates), and only when such a slot loses its id
//   are the slots rescanned for the next-lowest holder. Deletion shifts
//   the probe run back, so no tombstones build up;
// - the first EMPTY slot: one bit per slot, and one bit per group of 32
//   slots saying whether its word is not zero: a ballot and a find-first-
//   set per level;
// - the minimum of where(empty, INT_MAX, counts) and the maximum error,
//   lowest index on ties: (value, first index) per group of 32 slots and
//   per group of 32 groups, a changed slot recomputing its group with one
//   warp (__reduce_min_sync / __reduce_max_sync and a ballot), then its
//   group of groups if the group's pair moved; the answer reduces the
//   n / 1024 top pairs.
// The slots are staged in shared memory with the structures where all of
// them fit (n <= 8,064 on the 227 KB of an H100; n = 4,096: 48 KB of
// slots, 64 KB of table), and written back once; for a larger n the slots
// stay in global memory and the structures live in a scratch the wrapper
// allocates.
//
// Work layout: every warp stages the slots and builds the structures; one
// warp then carries the chain of items, all 32 lanes on the same scalar
// path (so every write is the same value from every lane and no
// __syncwarp is needed), the lanes spreading only the 32-wide probes and
// reductions. No item waits on a __syncthreads.
//
// Bound: the items form one dependent chain; per item the structures need
// a 32-entry probe, one 32-slot group and one 32-group summary per changed
// slot and n / 1024 top pairs per query, so the kernel is bound by that
// chain's latency (shared-memory round trips, warp reductions), not by a
// rate of bytes or operations.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kEmpty = -1;            // the sketch's EMPTY id
constexpr int kNoKey = -1;            // a free table entry (keys are >= 0)
constexpr int kDup = kIntMin;         // bit 31 of a table value
constexpr int kSlotMask = kIntMax;    // its low 31 bits: the lowest slot
constexpr unsigned kNone = 0xffffffffu;  // no table position (T < 2^32)

// Where every array of one launch lives: shared memory, or the global
// scratch (the slots: the caller's tensors).
struct View {
  int *ids, *counts, *errors;   // n slots
  int2* tab;                    // T table entries (id, lowest slot | dup)
  int *gmin_v, *gmin_i, *smin_v, *smin_i;  // min pairs of groups, supers
  int *gmax_v, *gmax_i, *smax_v, *smax_i;  // max-error pairs
  unsigned *ebits, *esup;       // EMPTY bits per slot, per group
  int n, groups, supers;
  unsigned T;                   // 2n: n < 2^31, so T + 32 < 2^32
};

// Sizes in ints of the three regions, laid out in this order: the
// summaries, the table, the staged slots. Two layouts: all three in shared
// memory where they fit together (kShared), else the slots stay in the
// caller's tensors and the summaries and the table in a global scratch.
struct Plan {
  int n, groups, supers;
  unsigned T;
  long long sum_ints, tab_ints, slot_ints;
  bool shared;
  long long smem_bytes;  // 0 when not shared
};

inline Plan make_plan(int n, long long budget) {
  Plan p;
  p.n = n;
  p.groups = n / 32;  // n is a multiple of 128
  p.supers = (p.groups + 31) / 32;
  p.T = 2u * n;  // load factor at most 1/2
  p.sum_ints = (5LL * (p.groups + p.supers) + 3) / 4 * 4;  // 16-byte multiple
  p.tab_ints = 2LL * p.T;
  p.slot_ints = 3LL * n;
  const long long all = 4 * (p.sum_ints + p.tab_ints + p.slot_ints);
  p.shared = all <= budget;
  p.smem_bytes = p.shared ? all : 0;
  return p;
}

// Global scratch: the summaries and the table where they are not shared.
inline long long scratch_ints(const Plan& p) {
  return p.shared ? 0 : p.sum_ints + p.tab_ints;
}

// kShared: every region in shared memory (the compiler then addresses it
// as such); else the summaries and the table in `scratch`, the slots in
// the caller's tensors.
template <bool kShared>
__device__ __forceinline__ View make_view(const Plan& p, int* smem,
                                          int* scratch, int* ids, int* counts,
                                          int* errors) {
  View v;
  v.n = p.n;
  v.groups = p.groups;
  v.supers = p.supers;
  v.T = p.T;
  int* sum = kShared ? smem : scratch;
  int* tab = sum + p.sum_ints;
  v.ids = kShared ? tab + p.tab_ints : ids;
  v.counts = kShared ? v.ids + p.n : counts;
  v.errors = kShared ? v.counts + p.n : errors;
  const int G = p.groups, S = p.supers;
  v.gmin_v = sum;
  v.gmin_i = sum + G;
  v.gmax_v = sum + 2 * G;
  v.gmax_i = sum + 3 * G;
  v.ebits = reinterpret_cast<unsigned*>(sum + 4 * G);
  v.smin_v = sum + 5 * G;
  v.smin_i = sum + 5 * G + S;
  v.smax_v = sum + 5 * G + 2 * S;
  v.smax_i = sum + 5 * G + 3 * S;
  v.esup = reinterpret_cast<unsigned*>(sum + 5 * G + 4 * S);
  v.tab = reinterpret_cast<int2*>(tab);
  return v;
}

__device__ __forceinline__ unsigned home(int id, unsigned T) {
  const unsigned h = static_cast<unsigned>(id) * 0x9E3779B1u;
  return static_cast<unsigned>((static_cast<unsigned long long>(h) * T) >> 32);
}

__device__ __forceinline__ unsigned next(unsigned pos, unsigned T) {
  return pos + 1 == T ? 0u : pos + 1;
}

__device__ __forceinline__ unsigned wrap(unsigned pos, unsigned T) {
  return pos >= T ? pos - T : pos;
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

__device__ __forceinline__ int* key_of(const View& v, unsigned pos) {
  return reinterpret_cast<int*>(v.tab + pos);
}
__device__ __forceinline__ int* val_of(const View& v, unsigned pos) {
  return reinterpret_cast<int*>(v.tab + pos) + 1;
}

// (value, first index) over the lanes' values x, lane l's index base + l;
// kMax: the maximum, else the minimum. Every lane gets the pair.
template <bool kMax>
__device__ __forceinline__ void warp_first(int x, int base, int& v, int& i) {
  v = kMax ? __reduce_max_sync(kFull, x) : __reduce_min_sync(kFull, x);
  i = base + __ffs(__ballot_sync(kFull, x == v)) - 1;
}

// (a, ai) comes before (b, bi): lower (kMax: higher) value, then index
template <bool kMax>
__device__ __forceinline__ bool before(int a, int ai, int b, int bi) {
  return (kMax ? a > b : a < b) || (a == b && ai < bi);
}

// slot j's key in the min summary: where(empty, INT_MAX, counts)
__device__ __forceinline__ int min_key(const View& v, int j) {
  return v.ids[j] == kEmpty ? kIntMax : v.counts[j];
}

template <bool kMax>
__device__ __forceinline__ int slot_key(const View& v, int j) {
  return kMax ? v.errors[j] : min_key(v, j);
}

// ---------------------------------------------------------------------------
// Building the structures (all threads)
// ---------------------------------------------------------------------------

// The table entry of `id` (>= 0), claiming a free one if it is new.
__device__ __forceinline__ unsigned claim(View& v, int id) {
  unsigned pos = home(id, v.T);
  for (;;) {
    const int k = atomicCAS(key_of(v, pos), kNoKey, id);
    if (k == kNoKey || k == id) return pos;
    pos = next(pos, v.T);
  }
}

// The table entry of `id` (>= 0), which is there.
__device__ __forceinline__ unsigned entry_of(const View& v, int id) {
  unsigned pos = home(id, v.T);
  while (*key_of(v, pos) != id) pos = next(pos, v.T);
  return pos;
}

// Group g's pairs and EMPTY word from its slots (one warp).
__device__ __forceinline__ void build_group(View& v, int g) {
  const int j = 32 * g + lane_id();
  const int id = v.ids[j];
  int mv, mi, xv, xi;
  warp_first<false>(id == kEmpty ? kIntMax : v.counts[j], 32 * g, mv, mi);
  warp_first<true>(v.errors[j], 32 * g, xv, xi);
  const unsigned bits = __ballot_sync(kFull, id == kEmpty);
  if (lane_id() == 0) {
    v.gmin_v[g] = mv;
    v.gmin_i[g] = mi;
    v.gmax_v[g] = xv;
    v.gmax_i[g] = xi;
    v.ebits[g] = bits;
  }
}

// Super s's pair from its groups' pairs (one warp); every lane gets it.
template <bool kMax>
__device__ __forceinline__ void scan_super(const int* gv, const int* gi,
                                           int groups, int s, int& sv,
                                           int& si) {
  const int h = 32 * s + lane_id();
  const bool in = h < groups;
  int l;
  warp_first<kMax>(in ? gv[h] : (kMax ? kIntMin : kIntMax), 0, sv, l);
  si = __shfl_sync(kFull, in ? gi[h] : kIntMax, l);
}

// ---------------------------------------------------------------------------
// The chain (one warp, every lane on the same path)
// ---------------------------------------------------------------------------

// Table position of `id` (>= 0) and its value, or kNone: probes 32
// entries at a time.
__device__ __forceinline__ unsigned find(const View& v, int id, int& val) {
  unsigned pos = home(id, v.T);
  for (;;) {
    const int2 e = v.tab[wrap(pos + lane_id(), v.T)];
    const unsigned hit = __ballot_sync(kFull, e.x == id);
    const unsigned stop = __ballot_sync(kFull, e.x == kNoKey);
    if (hit && (!stop || __ffs(hit) < __ffs(stop))) {
      const int l = __ffs(hit) - 1;
      val = __shfl_sync(kFull, e.y, l);
      return wrap(pos + l, v.T);
    }
    if (stop) return kNone;
    pos = wrap(pos + 32, v.T);
  }
}

// `id` (>= 0, not in the table) now held by slot j alone.
__device__ __forceinline__ void table_insert(View& v, int id, int j) {
  unsigned pos = home(id, v.T);
  for (;;) {
    const int k = *key_of(v, wrap(pos + lane_id(), v.T));
    const unsigned stop = __ballot_sync(kFull, k == kNoKey);
    if (stop) {
      v.tab[wrap(pos + __ffs(stop) - 1, v.T)] = make_int2(id, j);
      return;
    }
    pos = wrap(pos + 32, v.T);
  }
}

// Free entry i, shifting later entries of its probe run back into the hole
// (an entry may move to i unless its home lies cyclically in (i, j]).
__device__ __forceinline__ void table_erase(View& v, unsigned i) {
  unsigned j = i;
  for (;;) {
    j = next(j, v.T);
    const int2 e = v.tab[j];
    if (e.x == kNoKey) break;
    const unsigned h = home(e.x, v.T);
    const bool between = i <= j ? (i < h && h <= j) : (i < h || h <= j);
    if (!between) {
      v.tab[i] = e;
      i = j;
    }
  }
  *key_of(v, i) = kNoKey;
}

// A slot (already rewritten) no longer holds `id` (>= 0).
__device__ __forceinline__ void table_remove(View& v, int id) {
  int val;
  const unsigned pos = find(v, id, val);
  if (val >= 0) {  // that slot was its only holder
    table_erase(v, pos);
    return;
  }
  // held by several: the next-lowest holder and whether it is still shared
  int count = 0, lowest = kIntMax;
  for (int b = 0; b < v.n; b += 32) {
    const unsigned m = __ballot_sync(kFull, v.ids[b + lane_id()] == id);
    if (m && lowest == kIntMax) lowest = b + __ffs(m) - 1;
    count += __popc(m);
  }
  if (count == 0)
    table_erase(v, pos);
  else
    *val_of(v, pos) = lowest | (count > 1 ? kDup : 0);
}

// Slot j's key (kMax: its error, else its min key) is now x: its group's
// pair, then its super's, follow. Only where the changed slot held the
// pair and lost it is a group (or super) scanned again.
template <bool kMax>
__device__ __forceinline__ void refresh(View& v, int j, int x) {
  int* gv = kMax ? v.gmax_v : v.gmin_v;
  int* gi = kMax ? v.gmax_i : v.gmin_i;
  int* sv = kMax ? v.smax_v : v.smin_v;
  int* si = kMax ? v.smax_i : v.smin_i;
  const int g = j >> 5;
  const int ov = gv[g], oi = gi[g];
  int nv, ni;
  if (before<kMax>(x, j, ov, oi)) {
    nv = x;
    ni = j;
  } else if (oi == j) {
    warp_first<kMax>(slot_key<kMax>(v, 32 * g + lane_id()), 32 * g, nv, ni);
  } else {
    return;
  }
  if (nv == ov && ni == oi) return;
  gv[g] = nv;
  gi[g] = ni;
  const int s = g >> 5;
  const int bv = sv[s], bi = si[s];
  if (before<kMax>(nv, ni, bv, bi)) {
    sv[s] = nv;
    si[s] = ni;
  } else if (bi == oi) {
    int rv, ri;
    scan_super<kMax>(gv, gi, v.groups, s, rv, ri);
    sv[s] = rv;
    si[s] = ri;
  }
}

// The first pair over the supers: the min count's slot, or the max error.
template <bool kMax>
__device__ __forceinline__ void top(const View& v, int& best, int& at) {
  const int* sv = kMax ? v.smax_v : v.smin_v;
  const int* si = kMax ? v.smax_i : v.smin_i;
  best = kMax ? kIntMin : kIntMax;
  at = kIntMax;
  for (int s0 = 0; s0 < v.supers; s0 += 32) {
    const int s = s0 + lane_id();
    const bool in = s < v.supers;
    int cv, cl;
    warp_first<kMax>(in ? sv[s] : best, 0, cv, cl);
    const int ci = __shfl_sync(kFull, in ? si[s] : kIntMax, cl);
    if (at == kIntMax || before<kMax>(cv, ci, best, at)) {
      best = cv;
      at = ci;
    }
  }
}

// The first EMPTY slot, or -1.
__device__ __forceinline__ int first_empty(const View& v) {
  for (int s0 = 0; s0 < v.supers; s0 += 32) {
    const int s = s0 + lane_id();
    const unsigned word = s < v.supers ? v.esup[s] : 0u;
    const unsigned any = __ballot_sync(kFull, word != 0u);
    if (any) {
      const int l = __ffs(any) - 1;
      const int g = 32 * (s0 + l) + __ffs(__shfl_sync(kFull, word, l)) - 1;
      return 32 * g + __ffs(v.ebits[g]) - 1;
    }
  }
  return -1;
}

__device__ __forceinline__ void set_empty_bit(View& v, int j, bool empty) {
  const int g = j >> 5;
  const unsigned bit = 1u << (j & 31);
  const unsigned word = empty ? (v.ebits[g] | bit) : (v.ebits[g] & ~bit);
  v.ebits[g] = word;
  const unsigned gbit = 1u << (g & 31);
  const unsigned sup = v.esup[g >> 5];
  v.esup[g >> 5] = word ? (sup | gbit) : (sup & ~gbit);
}

// Slot j takes (id, c, e); every structure follows.
__device__ __forceinline__ void place(View& v, int j, int id, int c, int e) {
  const int old = v.ids[j];
  const int old_e = v.errors[j];
  v.ids[j] = id;
  v.counts[j] = c;
  v.errors[j] = e;
  if (old >= 0) table_remove(v, old);
  if (id >= 0) table_insert(v, id, j);
  if ((old == kEmpty) != (id == kEmpty)) set_empty_bit(v, j, id == kEmpty);
  refresh<false>(v, j, id == kEmpty ? kIntMax : c);
  if (e != old_e) refresh<true>(v, j, e);
}

__device__ __forceinline__ void apply(View& v, int item, int w, int variant,
                                      bool saturate) {
  int val = 0;
  const unsigned pos = item >= 0 ? find(v, item, val) : kNone;
  const int mon = pos != kNone ? (val & kSlotMask) : -1;
  if (w > 0) {
    if (mon >= 0) {
      const int c = saturate ? sat_add(v.counts[mon], w)
                             : wrap_add(v.counts[mon], w);
      v.counts[mon] = c;
      refresh<false>(v, mon, c);
      return;
    }
    int j = first_empty(v);
    if (j >= 0) {
      place(v, j, item, w, 0);
    } else {
      int mc;
      top<false>(v, mc, j);
      place(v, j, item, saturate ? sat_add(mc, w) : wrap_add(mc, w), mc);
    }
    return;
  }
  // jnp.maximum(-w, 0) in int32: -INT_MIN wraps to INT_MIN, hence 0
  const int wd = max(wrap_sub(0, w), 0);
  if (mon >= 0) {
    const int c = wrap_sub(v.counts[mon], wd);
    v.counts[mon] = c;
    refresh<false>(v, mon, c);
    return;
  }
  if (variant == 1) return;  // Lazy: an unmonitored deletion is dropped
  for (int rem = wd; rem > 0;) {
    int e, j;
    top<true>(v, e, j);
    if (e <= 0) break;
    const int d = min(rem, e);
    v.counts[j] = wrap_sub(v.counts[j], d);
    v.errors[j] = e - d;
    refresh<false>(v, j, min_key(v, j));
    refresh<true>(v, j, e - d);
    rem -= d;
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads) serial_kernel(
    int* __restrict__ ids, int* __restrict__ counts, int* __restrict__ errors,
    const int* __restrict__ items, const int* __restrict__ weights,
    int* __restrict__ scratch, Plan plan, int B, int variant, bool saturate) {
  extern __shared__ int4 smem4[];
  int* smem = reinterpret_cast<int*>(smem4);
  View v = make_view<kShared>(plan, smem, scratch, ids, counts, errors);
  // 64-bit loop counters: n and T may come close to 2^31 and 2^32
  const long long tid = threadIdx.x, nt = blockDim.x, n = v.n;
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  if (kShared) {
    for (long long j = tid; j < n; j += nt) {
      v.ids[j] = ids[j];
      v.counts[j] = counts[j];
      v.errors[j] = errors[j];
    }
  }
  for (long long i = tid; i < v.T; i += nt)
    v.tab[i] = make_int2(kNoKey, kIntMax);
  __syncthreads();
  for (int g = warp; g < v.groups; g += nw) build_group(v, g);
  for (long long j = tid; j < n; j += nt) {
    const int id = v.ids[j];
    if (id >= 0) atomicMin(val_of(v, claim(v, id)), static_cast<int>(j));
  }
  __syncthreads();
  for (long long j = tid; j < n; j += nt) {  // ids held by several slots
    const int id = v.ids[j];
    if (id >= 0) {
      int* val = val_of(v, entry_of(v, id));
      if ((*val & kSlotMask) != j) atomicOr(val, kDup);
    }
  }
  for (int s = warp; s < v.supers; s += nw) {
    int mv, mi, xv, xi;
    scan_super<false>(v.gmin_v, v.gmin_i, v.groups, s, mv, mi);
    scan_super<true>(v.gmax_v, v.gmax_i, v.groups, s, xv, xi);
    const int h = 32 * s + lane_id();
    const unsigned any = __ballot_sync(kFull, h < v.groups && v.ebits[h]);
    if (lane_id() == 0) {
      v.smin_v[s] = mv;
      v.smin_i[s] = mi;
      v.smax_v[s] = xv;
      v.smax_i[s] = xi;
      v.esup[s] = any;
    }
  }
  __syncthreads();

  if (warp == 0) {
    // the next 32 items' (item, weight) are in flight while these run
    int it = lane_id() < B ? items[lane_id()] : 0;
    int wt = lane_id() < B ? weights[lane_id()] : 0;
    for (int b0 = 0; b0 < B; b0 += 32) {
      const int nx = b0 + 32 + lane_id();
      const int it_next = nx < B ? items[nx] : 0;
      const int wt_next = nx < B ? weights[nx] : 0;
      const int m = min(32, B - b0);
      for (int i = 0; i < m; ++i) {
        const int w = __shfl_sync(kFull, wt, i);
        const int item = __shfl_sync(kFull, it, i);
        // 0: padding, no change
        if (w != 0) apply(v, item, w, variant, saturate);
      }
      it = it_next;
      wt = wt_next;
    }
  }
  __syncthreads();

  if (kShared) {
    for (long long j = tid; j < n; j += nt) {
      ids[j] = v.ids[j];
      counts[j] = v.counts[j];
      errors[j] = v.errors[j];
    }
  }
}

long long smem_budget() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 48 * 1024;
  return optin;
}

template <bool kShared>
cudaError_t launch(int* ids, int* counts, int* errors, const int* items,
                   const int* weights, int* scratch, const Plan& plan, int B,
                   int variant, bool saturate, cudaStream_t stream) {
  if (plan.smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        serial_kernel<kShared>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(plan.smem_bytes));
    if (err != cudaSuccess) return err;
  }
  serial_kernel<kShared><<<1, kThreads, plan.smem_bytes, stream>>>(
      ids, counts, errors, items, weights, scratch, plan, B, variant,
      saturate);
  return cudaGetLastError();
}

}  // namespace

// Ints of global scratch the launch for n slots needs (0 when every
// structure fits in shared memory); the wrapper allocates them.
extern "C" long long sketch_serial_scratch_ints(int n) {
  return scratch_ints(make_plan(n, smem_budget()));
}

// C entry point (bound with ctypes). n is a multiple of 128; `scratch`
// holds sketch_serial_scratch_ints(n) ints; `saturate` (0 or 1) picks the
// insert adds (see the top). Launches on `stream`, returns a cudaError_t
// as an int (0 = launched).
extern "C" int sketch_serial_update(void* ids, void* counts, void* errors,
                                    const void* items, const void* weights,
                                    void* scratch, int n, int B, int variant,
                                    int saturate, void* stream) {
  if (n < 128 || n % 128 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan = make_plan(n, smem_budget());
  auto* st = static_cast<cudaStream_t>(stream);
  auto* i = static_cast<int*>(ids);
  auto* c = static_cast<int*>(counts);
  auto* e = static_cast<int*>(errors);
  auto* it = static_cast<const int*>(items);
  auto* w = static_cast<const int*>(weights);
  auto* scr = static_cast<int*>(scratch);
  return static_cast<int>(
      plan.shared
          ? launch<true>(i, c, e, it, w, scr, plan, B, variant, saturate, st)
          : launch<false>(i, c, e, it, w, scr, plan, B, variant, saturate,
                          st));
}
