// The five scoring programs that no solve path calls, as one [P, N] kernel:
// a thread a (pod, node) pair, the program's pair function inside.
//
// Replaces the XLA-compiled device programs of
// koordinator_tpu/ops/costs.py:least_allocated_cost (:90-100),
// most_allocated_cost (:102-113), scarce_resource_cost (:115-132),
// fit_plus_cost (:134-160) and koordinator_tpu/ops/numa.py:
// numa_alignment_cost (:146-172). Each program's plain twin is in
// ops/costs.py or ops/numa.py.
//
// What bounds it on an H100: the output. Each pair writes 4 bytes and
// reads its node's row (a few floats, from L2 after the first pod row of
// a block); the arithmetic is a handful of operations a dim, up to two
// IEEE divisions a dim for the LoadAware scores. At P=512, N=10,000 the
// [P, N] output is 20.5 MB: ~6 us at 3.35 TB/s.
//
// Design, simple first: one thread a pair, a block a pod and a tile of
// 256 nodes (a grid of P x ceil(N / 256): no index division), so a warp's
// threads read neighbouring node rows and write neighbouring outputs. The
// dims unroll (D, or DN for the NUMA program, is a template argument); the
// zones of the NUMA program are a run-time loop. Every float operation is written in the reference's order; the
// source is compiled with -fmad=false and IEEE division. Two orders are
// the reference's own: a weighted sum adds the dims one after another,
// and jnp.mean multiplies the sum by the float32 reciprocal of DN (XLA
// rewrites a division by a constant so).

#include "loadaware.cuh"

namespace {

using namespace koord;

constexpr int kThreads = 256;
constexpr int kMaxDims = 8;

enum Program { kLeast = 0, kMost = 1, kScarce = 2, kFitPlus = 3, kNuma = 4 };

struct Args {
  const float* req;     // [P, D]
  const float* node_a;  // requested [N, DS], or the zone table [N, Z, DN]
  const float* node_b;  // allocatable [N, DS]
  const float* w;       // [DS]
  const bool* flags;    // [DS]: scarce dims, MostAllocated dims, NUMA MostAllocated
  float* out;           // [P, N]
  int P, N, D, Z;
  cudaStream_t stream;
};

// -floor(weighted least-used score of requested + req) (costs.py:25-47),
// or MostAllocated's -(100 - it).
template <int DS, bool kMostAllocated>
__device__ __forceinline__ float allocated(const Args& a, const float* rq, int n) {
  float w[DS];
  const float wsum = weights_sum<DS>(a.w, w);
  float total = 0.0f;
#pragma unroll
  for (int d = 0; d < DS; ++d) {
    const size_t at = (size_t)n * DS + d;
    const float alloc = a.node_b[at];
    const float after = a.node_a[at] + rq[d];
    const float term = score_term(alloc, alloc_safe(alloc), after, w[d]);
    total = d == 0 ? term : total + term;
  }
  const float score = floorf(total / wsum);
  return kMostAllocated ? -(100.0f - score) : -score;
}

// count of scarce dims the node has and the pod does not ask for, times
// 100 / max(n_scarce, 1) (costs.py:115-132).
template <int DS>
__device__ __forceinline__ float scarce(const Args& a, const float* rq, int n) {
  int n_scarce = 0, wasted = 0;
#pragma unroll
  for (int d = 0; d < DS; ++d) {
    const bool s = a.flags[d];
    n_scarce += s;
    wasted += (a.node_b[(size_t)n * DS + d] > 0.0f && s) && !(rq[d] > 0.0f);
  }
  return (float)wasted * (100.0f / (float)max(n_scarce, 1));
}

// NodeResourcesFitPlus (costs.py:134-160).
template <int DS>
__device__ __forceinline__ float fit_plus(const Args& a, const float* rq, int n) {
  float total = 0.0f, wsum = 0.0f;
#pragma unroll
  for (int d = 0; d < DS; ++d) {
    const size_t at = (size_t)n * DS + d;
    const float alloc = a.node_b[at];
    const float after = a.node_a[at] + rq[d];
    const float frac = alloc > 0.0f ? fminf(fmaxf(after / (alloc + kSafe), 0.0f), 1.0f) : 0.0f;
    const float per_dim = (a.flags[d] ? frac : 1.0f - frac) * 100.0f;
    const float wd = a.w[d] * (rq[d] > 0.0f ? 1.0f : 0.0f);
    const float term = per_dim * wd;
    total = d == 0 ? term : total + term;
    wsum = d == 0 ? wd : wsum + wd;
  }
  return -(total / (wsum + kSafe));
}

// numa_alignment_cost (numa.py:146-172): minus the best zone's mean
// clipped free fraction after the pod, x 100 (MostAllocated: 100 minus
// it), -1 for a zone the pod does not fit within EPS.
template <int DN>
__device__ __forceinline__ float numa_alignment(const Args& a, const float* rq, int n) {
  const float* zf = a.node_a + (size_t)n * a.Z * DN;
  float total[DN];
#pragma unroll
  for (int d = 0; d < DN; ++d) total[d] = zf[d];
  for (int z = 1; z < a.Z; ++z)
#pragma unroll
    for (int d = 0; d < DN; ++d) total[d] = fmaxf(total[d], zf[z * DN + d]);
#pragma unroll
  for (int d = 0; d < DN; ++d) total[d] = fmaxf(total[d], 1e-9f);
  const float inv_dn = 1.0f / (float)DN;
  const bool most = a.flags[0];
  float best = 0.0f;
  for (int z = 0; z < a.Z; ++z) {
    bool fits = true;
    float sum = 0.0f;
#pragma unroll
    for (int d = 0; d < DN; ++d) {
      const float after = zf[z * DN + d] - rq[d];
      fits = fits && after >= -kEps;
      const float frac = fminf(fmaxf(after / total[d], 0.0f), 1.0f);
      sum = d == 0 ? frac : sum + frac;
    }
    float zs = sum * inv_dn * 100.0f;
    if (most) zs = 100.0f - zs;
    zs = fits ? zs : -1.0f;
    best = z == 0 ? zs : fmaxf(best, zs);
  }
  return -best;
}

// Block (p, t) prices pod p against nodes t * kThreads .. + kThreads - 1.
template <int kProgram, int DS>
__global__ void __launch_bounds__(kThreads) score_program_kernel(const Args a) {
  const int p = blockIdx.x;
  const int n = blockIdx.y * kThreads + threadIdx.x;
  if (n >= a.N) return;
  const float* rq = a.req + (size_t)p * a.D;
  float c;
  if constexpr (kProgram == kLeast) c = allocated<DS, false>(a, rq, n);
  else if constexpr (kProgram == kMost) c = allocated<DS, true>(a, rq, n);
  else if constexpr (kProgram == kScarce) c = scarce<DS>(a, rq, n);
  else if constexpr (kProgram == kFitPlus) c = fit_plus<DS>(a, rq, n);
  else c = numa_alignment<DS>(a, rq, n);
  a.out[(size_t)p * a.N + n] = c;
}

template <int kProgram>
struct Launch {
  const Args& a;
  template <int DS>
  cudaError_t run() const {
    const dim3 grid(a.P, (a.N + kThreads - 1) / kThreads);
    score_program_kernel<kProgram, DS><<<grid, kThreads, 0, a.stream>>>(a);
    return cudaGetLastError();
  }
};

// The NUMA program's DN (its dims unroll): 1..kMaxZoneDims.
cudaError_t launch_numa(const Args& a, int dn) {
  const Launch<kNuma> l{a};
  switch (dn) {
    case 1: return l.run<1>();
    case 2: return l.run<2>();
    case 3: return l.run<3>();
    case 4: return l.run<4>();
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// program: 0 LeastAllocated, 1 MostAllocated, 2 ScarceResourceAvoidance,
// 3 NodeResourcesFitPlus, 4 NUMA alignment. Pods req [P, D] float32; for
// 0, 1 and 3 node_a = requested and node_b = allocatable [N, DS], weights
// [DS]; for 2 node_b = allocatable [N, DS] and flags = the scarce dims
// [DS]; for 3 flags = the MostAllocated dims [DS]; for 4 node_a = the zone
// table [N, Z, DS] (DS = DN <= 4, Z <= 8) and flags[0] MostAllocated. DS
// <= D: a program reads the first DS dims of each pod. Writes out [P, N]
// float32.
extern "C" int koord_score_program(int program, const void* req, const void* node_a,
                                   const void* node_b, const void* weights, const void* flags,
                                   void* out, int P, int N, int D, int DS, int Z, void* stream) {
  if (P <= 0 || N <= 0) return (int)cudaSuccess;
  if ((N + kThreads - 1) / kThreads > 65535) return (int)cudaErrorInvalidValue;
  if (DS < 1 || DS > kMaxDims || DS > D) return (int)cudaErrorInvalidValue;
  const bool numa = program == kNuma;
  if (numa && (Z < 1 || Z > kMaxZones || DS > kMaxZoneDims)) return (int)cudaErrorInvalidValue;
  if ((program == kLeast || program == kMost || program == kFitPlus) &&
      (node_a == nullptr || node_b == nullptr || weights == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((program == kScarce || program == kFitPlus || numa) && flags == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((program == kScarce && node_b == nullptr) || (numa && node_a == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{(const float*)req, (const float*)node_a, (const float*)node_b,
               (const float*)weights, (const bool*)flags, (float*)out, P, N, D, Z,
               (cudaStream_t)stream};
  switch (program) {
    case kLeast: return (int)with_d8(DS, Launch<kLeast>{a});
    case kMost: return (int)with_d8(DS, Launch<kMost>{a});
    case kScarce: return (int)with_d8(DS, Launch<kScarce>{a});
    case kFitPlus: return (int)with_d8(DS, Launch<kFitPlus>{a});
    case kNuma: return (int)launch_numa(a, DS);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* koord_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
