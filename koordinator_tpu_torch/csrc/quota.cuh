// ElasticQuota admission of one pod along its quota chain, shared by the
// gate of a batch's first round (quota.cu) and the round tail (round.cu),
// which writes the next round's gate.
//
// Port of koordinator_tpu/ops/solver.py:_quota_headroom (:489-501): the pod
// fits when used + request <= runtime + EPS in every dim at every level of
// its chain; a level of -1 is open. Written in the reference's order and
// compiled with -fmad=false, so each comparison sees the reference's bits.

#pragma once

#include <cuda_runtime.h>

namespace koord_quota {

constexpr float kEps = 1e-3f;  // masks.EPS

// req: the pod's [D] request; chain: its [L] quota rows (leaf to root, -1
// open); runtime, used: [Q, D] tables. Rows past the table read its last
// row, as jnp.clip does. `used` is not __restrict__: the round tail reads
// it after writing it in the same launch, so it must not come through the
// read-only cache.
__device__ __forceinline__ bool headroom(const float* __restrict__ req,
                                         const int* __restrict__ chain, int L,
                                         const float* __restrict__ runtime, const float* used,
                                         int Q, int D) {
  bool ok = true;
  for (int l = 0; l < L; ++l) {
    const int key = chain[l];
    if (key < 0) continue;
    const size_t q = (size_t)min(key, Q - 1) * D;
    for (int d = 0; d < D; ++d) ok = ok && (used[q + d] + req[d] <= runtime[q + d] + kEps);
  }
  return ok;
}

}  // namespace koord_quota
