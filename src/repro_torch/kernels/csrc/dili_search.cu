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
// What bounds it on this card: a dependent chase through tables that sit
// in the 50 MB L2 (16 B a node, 12 B a slot; 12.5 MB at 1M keys).  Each
// level's address depends on the last level's payload, and a scattered
// load costs one 32-byte L2 sector however few of its bytes are used, so
// the time goes in L2 sectors and their latency, not in HBM bytes or
// arithmetic.  The design cuts the sectors a lane needs:
//   * one vector load per node and one per slot.  A node is one 16-byte
//     record {a bits, b bits, base, fo}, its dense flag in fo's sign
//     (ld.global.nc.v4); a slot is one 8-byte record {key bits, val}
//     (ld.global.nc.v2) whose key holds a NaN sentinel for the tags other
//     than PAIR: kChildBits for a child, the quiet NaN for an empty slot
//     (see kernels/ops.py::pack_tables).  A level is two sectors instead of
//     the column layout's six to eight (five node columns, then tag, key
//     and val).  The slot record is 8 bytes rather than 16: both are one
//     sector per lane and load, and a replay of the walk counted within
//     1% the same distinct sectors per warp for either width (PERF.md),
//     but 8 bytes keep a slot at 12 B with the key column, as in the
//     column layout, where 16 would make it 20 B of a table that must
//     stay in L2;
//   * the dense probe reads the contiguous f32 `key` column, so its
//     neighbouring probes fall in one sector and hit L1;
//   * one thread per query, with no persistent grid and no shared-memory
//     copy of the root: both were measured at the main index and were
//     slower (the root's slots stay in L1 anyway; see PERF.md).
// Arithmetic is the reference's: slot prediction as two roundings,
// add_rn(a, mul_rn(b, q)) (nvcc would contract a + b*q into an FMA with
// one), floor, a float -> int32 cast that saturates as XLA's does (+inf and
// >= 2^31 give INT_MAX, NaN gives 0), then the clips.  The probe is
// `_dense_search`'s: at most 16 doubling and 16 halving steps; a thread
// stops a phase as soon as the fixed-trip vector code would leave its lane
// unchanged, which gives the same result.
//
// Three instances of one template on the key and payload types:
//   * f32 keys, i32 payloads (`dili_search_f32_launch`): the `pallas`
//     engine's kernel, above;
//   * f64 keys, i64 payloads (`dili_search_f64_launch`): the local engine's
//     read path.  It replaces the XLA dispatch of the reference's
//     `core/search.py::search_with_overlay`: the f64 walk, the dense probe
//     and, as an epilogue in the same launch, `resolve_overlay` over the
//     pending-write overlay (lower bound over its sorted keys, a tombstone
//     hides the snapshot's hit, a live entry's val wins).  Its records are
//     twice as wide: a node is 32 bytes {a, b, base, fo, pad}, two v4
//     loads; a slot 16 bytes {key bits, val}, one v4 load; the sentinels
//     are 64-bit NaNs.  The prediction is __dadd_rn(a, __dmul_rn(b, q)).
//     A standard f64 build has no dense leaf, so the walk is the whole
//     cost, and at 1M keys its tables (about 75 MB) no longer fit the L2.
//   * f32 keys, i64 payloads (`dili_search_f32_i64_launch`): the local
//     engine at dtype=float32, which in the reference runs the same
//     `search_with_overlay` through XLA at f32 with int64 payloads.  The
//     node record is the f32 instance's 16 bytes; a slot is 16 bytes {f32
//     key bits, 4 bytes of padding, i64 val}, one v4 load; the sentinels
//     are the f32 instance's; the overlay epilogue compares f32 keys and
//     returns i64 vals.  Its prediction is the one exception to the two
//     roundings: __fmaf_rn(b, q, a), one rounding, because that is what
//     the reference computes there.  XLA on the CPU contracts a + b*q
//     into an FMA despite its optimization barrier; where keys were placed
//     in the search's own precision, construction's nudges off integer
//     boundaries make both roundings agree, but these tables are f32 casts
//     of an f64-placed tree, and two roundings would find keys the
//     reference misses (PERF.md, section 6).
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

template <typename Key>
struct KeyTraits;

template <>
struct KeyTraits<float> {
  using Bits = uint32_t;
  static constexpr Bits kChildBits = 0x7fc00002u;   // CHILD slot sentinel
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
  static constexpr Bits kChildBits = 0x7ff8000000000002ull;  // CHILD sentinel
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

// slot record: PAIR -> {key, payload}; CHILD -> {kChildBits, node id};
// EMPTY -> {quiet NaN, payload}.  Aligned to twice its wider field, so an
// f32 key with an i64 payload is {key, 4 bytes of padding, val}.
template <typename Key, typename Val>
struct alignas(2 * (sizeof(Key) > sizeof(Val) ? sizeof(Key) : sizeof(Val)))
    SlotRec {
  Key key;
  Val val;
};

static_assert(sizeof(NodeRec<float>) == 16, "node record is one v4 load");
static_assert(sizeof(SlotRec<float, int>) == 8, "slot record is one v2 load");
static_assert(sizeof(NodeRec<double>) == 32, "node record is two v4 loads");
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

// `resolve_overlay` on one lane: the lower bound of q over all n overlay
// keys (the +inf padding of the capacity included, as torch.searchsorted
// bisects it), clipped to n - 1; if that key equals q (never for a NaN
// lane), a tombstone hides the snapshot's hit and keeps its val, and a live
// entry's val wins.
template <typename Key, typename Val>
__device__ __forceinline__ void overlay_resolve(
    const Key* __restrict__ ov_keys, const Val* __restrict__ ov_vals,
    const int8_t* __restrict__ ov_tomb, int64_t n, Key q, Val& out,
    bool& hit) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(ov_keys + mid) < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int64_t i = lo < n - 1 ? lo : n - 1;
  if (__ldg(ov_keys + i) == q) {
    if (__ldg(ov_tomb + i) > 0) {
      hit = false;
    } else {
      out = __ldg(ov_vals + i);
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
                   int max_depth, const Key* __restrict__ ov_keys,
                   const Val* __restrict__ ov_vals,
                   const int8_t* __restrict__ ov_tomb, int64_t ov_n,
                   Val* __restrict__ out, bool* __restrict__ found) {
  using T = KeyTraits<Key>;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const Key q = queries[i];
  Val v = Val(-1);
  bool hit = false;
  int n = root;
  NodeRec<Key> nd = ld_record(nodes + n);
  bool loaded = true;               // nd holds node n's record
  for (int d = 0; d < max_depth; ++d) {
    if (!loaded) {
      nd = ld_record(nodes + n);
      loaded = true;
    }
    if (nd.fo < 0) break;                     // dense leaf: probe below
    const int pos = predict_slot<Key, Fused>(nd.a, nd.b, q, nd.fo);
    const SlotRec<Key, Val> s = ld_record(slots + nd.base + pos);
    if (T::bits(s.key) == T::kChildBits) {
      n = static_cast<int>(s.val);
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
  if (!loaded) nd = ld_record(nodes + n);
  if (nd.fo < 0) dense_probe<Key, Val, Fused>(nd, slots, keys, q, v, hit);
  if (ov_n > 0) overlay_resolve(ov_keys, ov_vals, ov_tomb, ov_n, q, v, hit);
  out[i] = v;
  found[i] = hit;
}

template <typename Key, typename Val, bool Fused>
int launch(const void* nodes, const void* slots, const void* keys, int root,
           const void* queries, long long nq, int max_depth,
           const void* ov_keys, const void* ov_vals, const void* ov_tomb,
           long long ov_n, void* out, void* found, void* stream) {
  if (nq <= 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (nq + kThreads - 1) / kThreads;
  dili_search_kernel<Key, Val, Fused>
      <<<static_cast<unsigned int>(blocks), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const NodeRec<Key>*>(nodes),
          static_cast<const SlotRec<Key, Val>*>(slots),
          static_cast<const Key*>(keys), root,
          static_cast<const Key*>(queries), static_cast<int64_t>(nq),
          max_depth, static_cast<const Key*>(ov_keys),
          static_cast<const Val*>(ov_vals),
          static_cast<const int8_t*>(ov_tomb), static_cast<int64_t>(ov_n),
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
                                   out, found, stream);
}

// f64 keys, i64 payloads, with the overlay resolve fused in when ov_n > 0
// (ov_n is the overlay's capacity, its +inf padding included): the local
// engine's lookup
extern "C" int dili_search_f64_launch(const void* nodes, const void* slots,
                                      const void* keys, int root,
                                      const void* queries, long long nq,
                                      int max_depth, const void* ov_keys,
                                      const void* ov_vals,
                                      const void* ov_tomb, long long ov_n,
                                      void* out, void* found, void* stream) {
  return launch<double, long long, false>(nodes, slots, keys, root,
                                          queries, nq, max_depth, ov_keys,
                                          ov_vals, ov_tomb, ov_n, out, found,
                                          stream);
}

// f32 keys, i64 payloads, with the overlay resolve fused in when ov_n > 0
// (the overlay's keys cast to f32): the local engine at dtype=float32
extern "C" int dili_search_f32_i64_launch(const void* nodes,
                                          const void* slots,
                                          const void* keys, int root,
                                          const void* queries, long long nq,
                                          int max_depth, const void* ov_keys,
                                          const void* ov_vals,
                                          const void* ov_tomb,
                                          long long ov_n, void* out,
                                          void* found, void* stream) {
  return launch<float, long long, true>(nodes, slots, keys, root, queries,
                                        nq, max_depth, ov_keys, ov_vals,
                                        ov_tomb, ov_n, out, found, stream);
}
