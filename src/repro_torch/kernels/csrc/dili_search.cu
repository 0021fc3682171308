// Batched DILI point lookup (Algorithm 6) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_kernel` / `dili_search_pallas` in
// src/repro/kernels/dili_search.py.  Same contract, bit for bit: f32 keys
// and models, int32 tables, and per query the triple
// (val int32, found bool, needs_fallback bool).
//
// What bounds it on this card: a dependent pointer chase.  Each level of
// the walk is about 8 scattered 4-byte reads per lane (a, b, fo, dense,
// base of the node, then tag, key, val of the slot), and the next level's
// address depends on this level's val.  At the index sizes served here the
// tables (tens of MB at most) sit in the 50 MB L2, so the cost is gather
// latency, not HBM bandwidth.  The TPU kernel kept every table in VMEM and
// ran a fixed-trip loop over 2048-lane tiles; here there is no VMEM, so
// the design is:
//   * one thread per query, tables read straight from global memory
//     through the read-only path (__ldg), any table size;
//   * a per-thread loop over max_depth trips that stops as soon as the lane
//     is done (hit, miss, child chain ended, dense leaf) — free per-lane
//     early exit, which a SIMD tile could not have;
//   * slot prediction as __fadd_rn(a, __fmul_rn(b, q)): two IEEE roundings,
//     as construction placed the keys (nvcc would contract a + b*q into an
//     FMA with one rounding otherwise);
//   * float -> int32 that saturates as XLA does (+inf and >= 2^31 give
//     INT_MAX, NaN gives 0), then the clip to [0, fo - 1].
// The kernel allocates nothing and does not synchronise; the C entry point
// launches it on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTagEmpty = 0;
constexpr int kTagPair = 1;
constexpr int kTagChild = 2;
constexpr int kThreads = 256;

__device__ __forceinline__ int sat_f32_to_i32(float x) {
  // x is already floored; saturate like XLA's convert before the cast
  if (x != x) return 0;
  if (x >= 2147483648.0f) return 2147483647;
  if (x < -2147483648.0f) return (-2147483647 - 1);
  return static_cast<int>(x);
}

__global__ void __launch_bounds__(kThreads)
dili_search_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const int* __restrict__ base, const int* __restrict__ fo,
                   const int* __restrict__ dense, const int* __restrict__ tag,
                   const float* __restrict__ key, const int* __restrict__ val,
                   const int* __restrict__ root,
                   const float* __restrict__ queries, int64_t nq,
                   int max_depth, int* __restrict__ out,
                   bool* __restrict__ found, bool* __restrict__ fallback) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const float q = queries[i];
  int n = __ldg(root);
  int o = -1;
  bool hit = false;
  bool flag = false;
  bool done = false;
  for (int d = 0; d < max_depth; ++d) {
    if (__ldg(dense + n) > 0) {       // dense leaf: the wrapper rechecks
      flag = true;
      done = true;
      break;
    }
    const float an = __ldg(a + n);
    const float bn = __ldg(b + n);
    const int fon = __ldg(fo + n);
    const float p = floorf(__fadd_rn(an, __fmul_rn(bn, q)));
    const int pos = min(max(sat_f32_to_i32(p), 0), fon - 1);
    const int s = __ldg(base + n) + pos;
    const int t = __ldg(tag + s);
    if (t == kTagChild) {
      n = __ldg(val + s);
      continue;
    }
    if (t == kTagPair && __ldg(key + s) == q) {
      o = __ldg(val + s);
      hit = true;
    }
    // EMPTY, or a PAIR with another key: a miss.  Other tags do not occur.
    if (t == kTagPair || t == kTagEmpty) {
      done = true;
      break;
    }
  }
  out[i] = o;
  found[i] = hit;
  fallback[i] = flag || !done;        // dense leaf or ran out of depth
}

}  // namespace

extern "C" int dili_search_launch(const void* a, const void* b,
                                  const void* base, const void* fo,
                                  const void* dense, const void* tag,
                                  const void* key, const void* val,
                                  const void* root, const void* queries,
                                  long long nq, int max_depth, void* out,
                                  void* found, void* fallback, void* stream) {
  if (nq <= 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (nq + kThreads - 1) / kThreads;
  dili_search_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const int*>(base), static_cast<const int*>(fo),
      static_cast<const int*>(dense), static_cast<const int*>(tag),
      static_cast<const float*>(key), static_cast<const int*>(val),
      static_cast<const int*>(root), static_cast<const float*>(queries),
      static_cast<int64_t>(nq), max_depth, static_cast<int*>(out),
      static_cast<bool*>(found), static_cast<bool*>(fallback));
  return static_cast<int>(cudaGetLastError());
}
