// The NUMA zones of a batch as its pricing reads them, once a batch
// (solver.py:771-818 prices every pair from the zone table as the batch
// began): a snapshot of the carried table, which the round tails then
// charge while the pricing kernels read the copy, and the nodes' side
// table (loadaware.cuh: Zones, numa_fit, numa_score): per node the bits
// of dim_on (numa.py:116), has_zones (:133), the SINGLE_NUMA_NODE policy
// (:135) and each zone's "some capacity" (:62-65), the zones' free totals
// (:126, jnp.sum over the zones, added in zone order as XLA's CPU backend
// lowers it) and each zone's aligned-score key (cap0 - free0 + 1) /
// (cap0 + 1) (costs.py:240-246). Every pair of the batch would otherwise
// work these out again from its node's Z x DN rows.
//
// What bounds it on an H100: bytes. One thread a node reads its 2 Z DN
// capacities and free values and its policy and writes Z DN + 1 + DN + Z
// words: about 3 KB a call at 10,000 nodes, Z = 2, DN = 2 — far below a
// microsecond of bandwidth; the launch itself is the cost.

#include <cuda_runtime.h>
#include <stdint.h>

#include "loadaware.cuh"

namespace {

using namespace koord;

__global__ void zone_prep_kernel(const float* __restrict__ free, const float* __restrict__ cap,
                                 const int8_t* __restrict__ policy, float* __restrict__ snapshot,
                                 uint32_t* __restrict__ side, int N, int Z, int DN) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t at = (size_t)n * Z * DN;
  const float* fr = free + at;
  const float* cp = cap + at;
  for (int i = 0; i < Z * DN; ++i) snapshot[at + i] = fr[i];
  uint32_t* sd = side + (size_t)n * side_words(Z, DN);
  uint32_t info = policy[n] == kPolicySingleNuma ? kSideSingle : 0u;
  for (int d = 0; d < DN; ++d) {
    float csum = cp[d], fsum = fr[d];
    for (int q = 1; q < Z; ++q) {
      csum = csum + cp[q * DN + d];
      fsum = fsum + fr[q * DN + d];
    }
    if (csum > 0.0f) info |= kSideDimOn << d;
    sd[1 + d] = __float_as_uint(fsum);
  }
  for (int q = 0; q < Z; ++q) {
    float csum = 0.0f;
    bool real = false;
    for (int d = 0; d < DN; ++d) {
      const float c = cp[q * DN + d];
      csum = d == 0 ? c : csum + c;
      real = real || c > 0.0f;
    }
    if (csum > 0.0f) info |= kSideHasZones;
    if (real) info |= 1u << (kSideReal + q);
    const float used0 = cp[q * DN] - fr[q * DN];
    sd[1 + DN + q] = __float_as_uint((used0 + 1.0f) / (cp[q * DN] + 1.0f));
  }
  sd[0] = info;
}

}  // namespace

// free, cap: [N, Z, DN] float; policy [N] int8; snapshot: [N, Z, DN]
// float, written; side: [N, 1 + DN + Z] uint32, written.
extern "C" int koord_zone_prep(const void* free, const void* cap, const void* policy,
                               void* snapshot, void* side, int N, int Z, int DN, void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  if (Z < 1 || Z > kMaxZones || DN < 1 || DN > kMaxZoneDims) return (int)cudaErrorInvalidValue;
  constexpr int kBlock = 256;
  zone_prep_kernel<<<(N + kBlock - 1) / kBlock, kBlock, 0, (cudaStream_t)stream>>>(
      (const float*)free, (const float*)cap, (const int8_t*)policy, (float*)snapshot,
      (uint32_t*)side, N, Z, DN);
  return (int)cudaGetLastError();
}

extern "C" const char* koord_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
