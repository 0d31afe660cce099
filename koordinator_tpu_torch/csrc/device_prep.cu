// The devices of a batch as its pricing reads them, once a batch: each
// node's round-start reductions of the carried slot table (slot_stats,
// koordinator_tpu/ops/device.py:58-70): its fully free slots, its best
// partly free slot, its largest slot and its free total. The reference
// works them out at the start of every round (solver.py:1113-1117); the
// port works them out here once a batch, and the round tail refreshes the
// rows of the nodes it charges (round.cuh's device phase), which gives
// the same bits: an uncharged row's reductions do not change. The pricing
// kernels (loadaware.cuh: device_fit, device_score) and the round tail's
// acceptance read the table.
//
// What bounds it on an H100: bytes. One thread a node reads its G slots
// and writes four floats: at 10,000 nodes and G = 8 about 0.5 MB, a
// fraction of a microsecond of bandwidth; the launch itself is the cost.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"

namespace {

using namespace koord_device;

__global__ void device_prep_kernel(const float* __restrict__ slots, float* __restrict__ stats,
                                   int N, int G) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  slot_stats_row(slots + (size_t)n * G, G, stats + (size_t)n * kStats);
}

}  // namespace

// slots: [N, G] float; stats: [N, 4] float, written.
extern "C" int koord_device_prep(const void* slots, void* stats, int N, int G, void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  if (G < 1 || G > kMaxSlots) return (int)cudaErrorInvalidValue;
  constexpr int kBlock = 256;
  device_prep_kernel<<<(N + kBlock - 1) / kBlock, kBlock, 0, (cudaStream_t)stream>>>(
      (const float*)slots, (float*)stats, N, G);
  return (int)cudaGetLastError();
}

extern "C" const char* koord_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
