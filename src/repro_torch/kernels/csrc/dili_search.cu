// Batched DILI point lookup for Hopper, sm_90a: the Alg. 6 walk and the
// Alg. 1 dense-leaf probe, one thread per query, in one launch.
//
// Replaces the Pallas TPU kernel `_kernel` / `dili_search_pallas` in
// src/repro/kernels/dili_search.py together with the XLA recheck that its
// wrapper ran on flagged lanes (src/repro/kernels/ops.py::dili_search):
// per query it returns the final (val, found), bit for bit what that pair
// returns, which lane for lane is `core/search.py::search_batch` at f32.
// The TPU kernel stopped at every dense leaf and flagged the lane; at f32
// placement nearly every lane ends on one, so on this card the flag cost a
// second pass of the whole batch through dozens of torch kernels.  Here
// nothing is flagged: a lane that reaches a dense leaf runs the leaf's
// exponential + binary search in place.
//
// The tables: row-packed records, one vector load per node and one per
// slot (kernels/ops.py::pack_tables).  A node is {a, b, base, fo}, its
// dense flag in fo's sign; a slot is {key bits, val}, whose key holds a
// NaN sentinel for the tags other than PAIR (a child's, or the quiet NaN
// of an empty slot), so that a level is two sectors where the reference's
// column layout made it six to eight.  The dense probe reads the
// contiguous `key` column, so its neighbouring probes fall in one sector.
// Arithmetic is the reference's: slot prediction as two roundings,
// add_rn(a, mul_rn(b, q)) (nvcc would contract a + b*q into an FMA with
// one), floor, a float -> int32 cast that saturates as XLA's does (+inf and
// >= 2^31 give INT_MAX, NaN gives 0), then the clips.  The probe is
// `_dense_search`'s: at most 16 doubling and 16 halving steps; a thread
// stops a phase as soon as the fixed-trip vector code would leave its lane
// unchanged, which gives the same result.
//
// What bounds it on this card.  A lane's walk is a chain of dependent
// loads, a node record then a slot record a level, each at an address
// that the last one's payload decides, and a scattered load costs a
// 32-byte sector and an L1/L2 request however few of its bytes are used.
// At full occupancy (8 blocks of 256 threads an SM, under 32 registers a
// thread) the requests and their latency, not HBM bytes or arithmetic,
// set the time: every instance runs at 5-13x the bytes its batch must
// move (PERF.md, section 6, where each number below comes from).
//   * f32 keys, i32 payloads (`dili_search_f32_launch`, the `pallas`
//     engine): 16-byte nodes and 8-byte slots that sit in the 50 MB L2
//     (3.2 MB at 250k keys; nearly every lane ends in a dense leaf's
//     probe).  An 8-byte slot keeps a slot at 12 bytes with the key
//     column; a persistent grid and a shared-memory copy of the root were
//     measured at f32 and were slower.  This instance takes none of the
//     choices below.
//   * f64 keys, i64 payloads (`dili_search_f64_launch`, the local engine,
//     `IndexConfig()`'s default): in place of the XLA dispatch of the
//     reference's `core/search.py::search_with_overlay`, the f64 walk, the
//     dense probe and, as an epilogue in the same launch, `resolve_overlay`
//     over the pending-write overlay (lower bound over its sorted keys, a
//     tombstone hides the snapshot's hit, a live entry's val wins).  Nodes
//     are 32 bytes {a, b, base, fo, padding}, slots 16 bytes {key bits,
//     val}, the sentinels 64-bit NaNs; at 1M keys the tables are
//     about 75 MB and overflow the L2, so a lane's slot in the leaf level
//     (645k distinct in a 2^20 batch) mostly comes from HBM.  A standard
//     f64 build has no dense leaf.  Measured at 1M keys: the overlay
//     epilogue, a 12-step bisection of the 4096-entry overlay in L1 for
//     every lane, was 29% of the kernel, and the walk the rest.
//   * f32 keys, i64 payloads (`dili_search_f32_i64_launch`, the local
//     engine at dtype=float32): the same `search_with_overlay` at f32 with
//     int64 payloads.  The node record is the f32 instance's 16 bytes; a
//     slot is 16 bytes {f32 key bits, 4 bytes of padding, i64 val}; the
//     tables (15 MB at 250k keys) fit the L2, and the overlay epilogue
//     was 36% of the kernel.  Its prediction is the one exception to the
//     two roundings: __fmaf_rn(b, q, a), one rounding, because that is what
//     the reference computes there.  XLA on the CPU contracts a + b*q
//     into an FMA despite its optimization barrier; where keys were placed
//     in the search's own precision, construction's nudges off integer
//     boundaries make both roundings agree, but these tables are f32 casts
//     of an f64-placed tree, and two roundings would find keys the
//     reference misses.
// What the design of the two i64 instances does about it, each choice
// fixed at compile time and kept only where it measured faster in one
// call (kernel_bench.py; PERF.md, section 6):
//   * both: the overlay membership filter.  The local engine's overlay
//     mirror carries a bitmap of 16 bits a key (8 KB at capacity 4096,
//     L1-resident); a lane whose bit is clear equals no overlay key and
//     skips the bisection, so most lanes make one L1 request for the
//     overlay instead of thirteen.  A mirror without one (the argument is
//     null) is bisected on every lane;
//   * f64/i64 only: child fields (a CHILD slot carries the child's base
//     and fo in its key and val words' spare halves, so the walk reads one
//     v4, a and b, of each child's record instead of two) and streaming
//     (the queries in and (val, found) out with the .cs cache operator; at
//     f32/i64 it was slower);
//   * measured and dropped, their code removed: node records and the
//     slots of all-child nodes under an L2 evict_last policy (createpolicy
//     and ld.global.nc.L2::cache_hint; no faster: the upper tree stays in
//     the L2 as it is), the other slots under evict_first (slower), the
//     overlay's lower bound over samples staged in shared memory, then a
//     short bisection in global memory (no faster at f64, slower at f32,
//     where staging the 16 KB overlay in every block costs more than the
//     divergent loads it saves), and two queries a thread with their loads
//     interleaved (slower: the SM is at full occupancy already).
// The overlay epilogue runs when the caller passes an overlay (length > 0);
// the f32/i32 entry point passes none.  The kernel allocates nothing and does
// not synchronise; each C entry point launches on the caller's stream and
// returns the first CUDA error, or 0.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kProbeSteps = 16;              // `_dense_search`'s trip counts

// the filter's multiplicative hash (kernels/ref.py::FILTER_HASH)
constexpr unsigned long long kFilterHash = 0x9E3779B97F4A7C15ull;

template <typename Key>
struct KeyTraits;

template <>
struct KeyTraits<float> {
  using Bits = uint32_t;
  static constexpr Bits kChildBits = 0x7fc00002u;   // CHILD slot sentinel
  __device__ static bool is_child(Bits k) { return k == kChildBits; }
  __device__ static Bits bits(float k) { return __float_as_uint(k); }
  __device__ static float mul_rn(float x, float y) { return __fmul_rn(x, y); }
  __device__ static float add_rn(float x, float y) { return __fadd_rn(x, y); }
  __device__ static float fma_rn(float x, float y, float z) {
    return __fmaf_rn(x, y, z);
  }
};

template <>
struct KeyTraits<double> {
  using Bits = unsigned long long;
  // a CHILD slot's key word: this NaN's high half, the child's signed
  // fanout in the low half (kernels/ref.py::CHILD_KEY_HI_F64)
  static constexpr uint32_t kChildHi = 0x7ff80002u;
  __device__ static bool is_child(Bits k) { return (k >> 32) == kChildHi; }
  __device__ static Bits bits(double k) {
    return static_cast<Bits>(__double_as_longlong(k));
  }
  __device__ static double mul_rn(double x, double y) { return __dmul_rn(x, y); }
  __device__ static double add_rn(double x, double y) { return __dadd_rn(x, y); }
  __device__ static double fma_rn(double x, double y, double z) {
    return __fma_rn(x, y, z);
  }
};

// node record, 16 bytes at f32 and 32 at f64 (padded); fo < 0 marks a
// dense leaf of fanout -fo
template <typename Key>
struct alignas(16) NodeRec {
  Key a, b;
  int base, fo;
};

// a node's model, the first 16 bytes of its f64 record
struct alignas(16) ModelF64 {
  double a, b;
};

// slot record: PAIR -> {key, payload}; CHILD -> {kChildBits, node id} at
// f32, and at f64 {kChildHi << 32 | the child's signed fo, the child's id
// | its base << 32}; EMPTY -> {quiet NaN, payload}.  Aligned to twice its
// wider field, so an f32 key with an i64 payload is {key, 4 bytes of
// padding, val}.
template <typename Key, typename Val>
struct alignas(2 * (sizeof(Key) > sizeof(Val) ? sizeof(Key) : sizeof(Val)))
    SlotRec {
  Key key;
  Val val;
};

static_assert(sizeof(NodeRec<float>) == 16, "node record is one v4 load");
static_assert(sizeof(SlotRec<float, int>) == 8, "slot record is one v2 load");
static_assert(sizeof(NodeRec<double>) == 32, "node record is two v4 loads");
static_assert(sizeof(ModelF64) == 16, "a model is one v4 load");
static_assert(sizeof(SlotRec<double, long long>) == 16,
              "slot record is one v4 load");
using SlotRecF32I64 = SlotRec<float, long long>;
static_assert(sizeof(SlotRecF32I64) == 16 &&
                  offsetof(SlotRecF32I64, val) == 8,
              "slot record is {f32 key, pad, i64 val}, one v4 load");

// read-only vector load of a whole record (ld.global.nc.v4 / .v2)
template <typename T>
__device__ __forceinline__ T ld_record(const T* p) {
  static_assert(sizeof(T) % 16 == 0 || sizeof(T) == 8, "record width");
  T out;
  if constexpr (sizeof(T) == 8) {
    const int2 v = __ldg(reinterpret_cast<const int2*>(p));
    memcpy(&out, &v, 8);
  } else {
#pragma unroll
    for (int c = 0; c < static_cast<int>(sizeof(T) / 16); ++c) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(p) + c);
      memcpy(reinterpret_cast<char*>(&out) + 16 * c, &v, 16);
    }
  }
  return out;
}

// child n's record into nd; at f64 its model alone, one v4 load instead
// of two, since its parent's CHILD slot already put its base and fo in nd
template <typename Key>
__device__ __forceinline__ void load_child(const NodeRec<Key>* nodes, int n,
                                           NodeRec<Key>& nd) {
  if constexpr (sizeof(Key) == 8) {
    const ModelF64 m = ld_record(reinterpret_cast<const ModelF64*>(nodes + n));
    nd.a = m.a;
    nd.b = m.b;
  } else {
    nd = ld_record(nodes + n);
  }
}

template <typename Key>
__device__ __forceinline__ int sat_to_i32(Key x) {
  // x is already floored; saturate like XLA's convert before the cast.
  // +-2^31 is exact in both key types, so the constants are of the key's
  // own type (double for the f64 instance).
  constexpr Key kTwo31 = static_cast<Key>(2147483648.0);
  if (x != x) return 0;
  if (x >= kTwo31) return 2147483647;
  if (x < -kTwo31) return (-2147483647 - 1);
  return static_cast<int>(x);
}

// floor(a + b*q) clipped to [0, fo - 1]: two roundings, or one where the
// instance is Fused (the f32/i64 instance, see the top of the file)
template <typename Key, bool Fused>
__device__ __forceinline__ int predict_slot(Key a, Key b, Key q, int fo) {
  using T = KeyTraits<Key>;
  const Key s = Fused ? T::fma_rn(b, q, a) : T::add_rn(a, T::mul_rn(b, q));
  // floor is the overload of the key's type
  const int p = sat_to_i32(floor(s));
  return min(max(p, 0), fo - 1);
}

// `_dense_search` on one lane: exponential search around the model's
// prediction, then binary search for the first key >= q, then the PAIR
// test at that slot.  `nd` is a dense node's record (nd.fo < 0).
template <typename Key, typename Val, bool Fused>
__device__ __forceinline__ void dense_probe(
    const NodeRec<Key>& nd, const SlotRec<Key, Val>* __restrict__ slots,
    const Key* __restrict__ keys, Key q, Val& out, bool& hit) {
  const int fo = -nd.fo;
  const int m1 = max(fo - 1, 0);
  const int pred = min(max(predict_slot<Key, Fused>(nd.a, nd.b, q, fo), 0),
                       m1);
  const Key* leaf = keys + nd.base;
  auto key_at = [&](int i) { return __ldg(leaf + min(max(i, 0), m1)); };

  const bool going_up = key_at(pred) < q;
  int bound = 1;
  for (int it = 0; it < kProbeSteps; ++it) {
    // in range, the clip of pred +- bound is the identity
    const bool need = going_up
        ? (pred + bound < m1 && key_at(pred + bound) < q)
        : (pred - bound > 0 && key_at(pred - bound) > q);
    if (!need) break;
    bound *= 2;
  }
  int lo = going_up ? pred : max(pred - bound, 0);
  int hi = going_up ? min(pred + bound, m1) : pred;
  for (int it = 0; it < kProbeSteps && lo < hi; ++it) {
    const int mid = (lo + hi) >> 1;            // lo, hi >= 0
    if (key_at(mid) < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  // the record's key equals q only for a PAIR (other tags hold NaN)
  const SlotRec<Key, Val> s =
      ld_record(slots + nd.base + min(max(lo, 0), m1));
  if (s.key == q) {
    out = s.val;
    hit = true;
  }
}

// The pending-write overlay: n keys sorted ascending (the +inf padding of
// its capacity included; the facade refuses non-finite keys, so no NaN),
// their vals and tombstone bytes, and, where the mirror carries one, a
// bitmap of 1 << filter_log2 bits with bit h(k) set for every key k.
template <typename Key, typename Val>
struct Overlay {
  const Key* keys;
  const Val* vals;
  const int8_t* tomb;
  int64_t n;
  const uint32_t* filter;           // or null
  int filter_log2;
};

// false only if no overlay key equals q: the bit of q's hash is clear.
// Equal keys have equal bits once -0 is made +0 (q + 0 does it), and a
// NaN equals no key, whatever its bit.
template <typename Key, typename Val>
__device__ __forceinline__ bool may_hold(const Overlay<Key, Val>& ov, Key q) {
  using T = KeyTraits<Key>;
  const unsigned long long b = T::bits(T::add_rn(q, Key(0)));
  const unsigned long long h = (b * kFilterHash) >> (64 - ov.filter_log2);
  return (__ldg(ov.filter + (h >> 5)) >> (h & 31)) & 1u;
}

// `resolve_overlay` on one lane: the lower bound of q over all n overlay
// keys (as torch.searchsorted bisects them), clipped to n - 1; if that key
// equals q (never for a NaN lane), a tombstone hides the snapshot's hit
// and keeps its val, and a live entry's val wins.
template <typename Key, typename Val>
__device__ __forceinline__ void overlay_resolve(const Overlay<Key, Val>& ov,
                                                Key q, Val& out, bool& hit) {
  int64_t lo = 0, hi = ov.n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(ov.keys + mid) < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int64_t i = lo < ov.n - 1 ? lo : ov.n - 1;
  if (__ldg(ov.keys + i) == q) {
    if (__ldg(ov.tomb + i) > 0) {
      hit = false;
    } else {
      out = __ldg(ov.vals + i);
      hit = true;
    }
  }
}

template <typename Key, typename Val, bool Fused>
__global__ void __launch_bounds__(kThreads)
dili_search_kernel(const NodeRec<Key>* __restrict__ nodes,
                   const SlotRec<Key, Val>* __restrict__ slots,
                   const Key* __restrict__ keys, int root,
                   const Key* __restrict__ queries, int64_t nq,
                   int max_depth, Overlay<Key, Val> ov,
                   Val* __restrict__ out, bool* __restrict__ found) {
  using T = KeyTraits<Key>;
  // the f64/i64 instance streams its queries and results (.cs)
  constexpr bool kStream = sizeof(Key) == 8;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  Key q;
  if constexpr (kStream) {
    q = __ldcs(queries + i);
  } else {
    q = queries[i];
  }
  Val v = Val(-1);
  bool hit = false;
  int n = root;
  NodeRec<Key> nd = ld_record(nodes + n);
  bool loaded = true;               // nd holds node n's record
  for (int d = 0; d < max_depth; ++d) {
    if (!loaded) {
      load_child(nodes, n, nd);
      loaded = true;
    }
    if (nd.fo < 0) break;                     // dense leaf: probe below
    const int pos = predict_slot<Key, Fused>(nd.a, nd.b, q, nd.fo);
    const SlotRec<Key, Val> s = ld_record(slots + nd.base + pos);
    const auto bits = T::bits(s.key);
    if (T::is_child(bits)) {
      n = static_cast<int>(static_cast<uint32_t>(s.val));
      if constexpr (sizeof(Key) == 8) {       // the child's base and fo
        nd.base = static_cast<int>(static_cast<unsigned long long>(s.val) >> 32);
        nd.fo = static_cast<int>(static_cast<uint32_t>(bits));
      }
      loaded = false;
      continue;
    }
    if (s.key == q) {                         // a PAIR holding q
      v = s.val;
      hit = true;
    }
    nd.fo = 0;                                // done at a non-dense node
    break;
  }
  // a lane still on its way after max_depth trips is probed if the node it
  // stands on is dense (search_batch's exit does the same)
  if (!loaded) load_child(nodes, n, nd);
  if (nd.fo < 0) dense_probe<Key, Val, Fused>(nd, slots, keys, q, v, hit);
  if (ov.n > 0 && (ov.filter == nullptr || may_hold(ov, q))) {
    overlay_resolve(ov, q, v, hit);
  }
  if constexpr (kStream) {
    __stcs(out + i, v);
    asm volatile("st.global.cs.u8 [%0], %1;"
                 :
                 : "l"(found + i), "h"(static_cast<unsigned short>(hit)));
  } else {
    out[i] = v;
    found[i] = hit;
  }
}

template <typename Key, typename Val, bool Fused>
int launch(const void* nodes, const void* slots, const void* keys, int root,
           const void* queries, long long nq, int max_depth,
           const void* ov_keys, const void* ov_vals, const void* ov_tomb,
           long long ov_n, const void* ov_filter, int filter_log2,
           void* out, void* found, void* stream) {
  if (nq <= 0) return static_cast<int>(cudaSuccess);
  const bool filtered = ov_n > 0 && ov_filter != nullptr;
  if (ov_n < 0 || (filtered && (filter_log2 < 5 || filter_log2 > 40))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Overlay<Key, Val> ov{
      static_cast<const Key*>(ov_keys), static_cast<const Val*>(ov_vals),
      static_cast<const int8_t*>(ov_tomb), static_cast<int64_t>(ov_n),
      filtered ? static_cast<const uint32_t*>(ov_filter) : nullptr,
      filter_log2};
  const long long blocks = (nq + kThreads - 1) / kThreads;
  dili_search_kernel<Key, Val, Fused>
      <<<static_cast<unsigned int>(blocks), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const NodeRec<Key>*>(nodes),
      static_cast<const SlotRec<Key, Val>*>(slots),
      static_cast<const Key*>(keys), root, static_cast<const Key*>(queries),
      static_cast<int64_t>(nq), max_depth, ov,
      static_cast<Val*>(out), static_cast<bool*>(found));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 keys, i32 payloads, no overlay: the `pallas` engine's lookup
extern "C" int dili_search_f32_launch(const void* nodes, const void* slots,
                                      const void* keys, int root,
                                      const void* queries, long long nq,
                                      int max_depth, void* out, void* found,
                                      void* stream) {
  return launch<float, int, false>(nodes, slots, keys, root, queries, nq,
                                   max_depth, nullptr, nullptr, nullptr, 0,
                                   nullptr, 0, out, found, stream);
}

// f64 keys, i64 payloads, with the overlay resolve fused in when ov_n > 0
// (ov_n is the overlay's capacity, its +inf padding included; the bitmap
// of 1 << filter_log2 bits at ov_filter is consulted unless ov_filter is
// null): the local engine's lookup
extern "C" int dili_search_f64_launch(
    const void* nodes, const void* slots, const void* keys, int root,
    const void* queries, long long nq, int max_depth, const void* ov_keys,
    const void* ov_vals, const void* ov_tomb, long long ov_n,
    const void* ov_filter, int filter_log2, void* out, void* found,
    void* stream) {
  return launch<double, long long, false>(
      nodes, slots, keys, root, queries, nq, max_depth, ov_keys, ov_vals,
      ov_tomb, ov_n, ov_filter, filter_log2, out, found, stream);
}

// f32 keys, i64 payloads, with the overlay resolve fused in when ov_n > 0
// (the overlay's keys cast to f32): the local engine at dtype=float32
extern "C" int dili_search_f32_i64_launch(
    const void* nodes, const void* slots, const void* keys, int root,
    const void* queries, long long nq, int max_depth, const void* ov_keys,
    const void* ov_vals, const void* ov_tomb, long long ov_n,
    const void* ov_filter, int filter_log2, void* out, void* found,
    void* stream) {
  return launch<float, long long, true>(
      nodes, slots, keys, root, queries, nq, max_depth, ov_keys, ov_vals,
      ov_tomb, ov_n, ov_filter, filter_log2, out, found, stream);
}

// Registers, local (spill) bytes and resident blocks of kThreads threads
// per SM of one instance's kernel (0 f32/i32, 1 f64/i64, 2 f32/i64), from
// the runtime; returns the first CUDA error.
extern "C" int dili_search_occupancy(int instance, int* regs,
                                     int* local_bytes, int* blocks_per_sm) {
  const void* fn =
      instance == 0 ? reinterpret_cast<const void*>(
                          dili_search_kernel<float, int, false>)
      : instance == 1 ? reinterpret_cast<const void*>(
                            dili_search_kernel<double, long long, false>)
                      : reinterpret_cast<const void*>(
                            dili_search_kernel<float, long long, true>);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fn, kThreads, 0));
}
