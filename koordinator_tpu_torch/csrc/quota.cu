// The quota gate of a batch's first round: which pods the pricing kernels
// price.
//
// Replaces koordinator_tpu/ops/solver.py:_quota_headroom (:489-501) as
// assign's round body uses it (gate = active & q_head, :1105-1112) for
// round 0; the round tail (round.cu) writes the gate of every later round
// from the quota table it has just committed.
//
// What bounds it on an H100: latency. At P=512 with a chain of 4 levels it
// reads ~16 KB (requests, chains, the [Q, D] rows the chains name, which
// stay in L2) and does ~8 operations a level and dim; a launch costs more
// than the work.
//
// Design: one thread a pod, quota.cuh's headroom test.

#include "quota.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
quota_gate_kernel(const bool* __restrict__ active, const float* __restrict__ req,
                  const int* __restrict__ chain, const float* __restrict__ runtime,
                  const float* __restrict__ used, bool* __restrict__ gate, int P, int D,
                  int Q, int L) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= P) return;
  gate[i] = active[i] && koord_quota::headroom(req + (size_t)i * D, chain + (size_t)i * L, L,
                                               runtime, used, Q, D);
}

}  // namespace

// Pods are priority-sorted: active [P] bool, req [P, D], chain [P, L]
// int32; runtime and used [Q, D]. Writes gate [P] bool.
extern "C" int koord_quota_gate(const void* active, const void* req, const void* chain,
                                const void* runtime, const void* used, void* gate, int P,
                                int D, int Q, int L, void* stream) {
  if (P <= 0) return (int)cudaSuccess;
  if (D < 1 || Q < 1 || L < 0) return (int)cudaErrorInvalidValue;
  quota_gate_kernel<<<(P + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      (const bool*)active, (const float*)req, (const int*)chain, (const float*)runtime,
      (const float*)used, (bool*)gate, P, D, Q, L);
  return (int)cudaGetLastError();
}

extern "C" const char* koord_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
