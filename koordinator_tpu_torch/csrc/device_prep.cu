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
//
// With the batch's asks, one more block of the same launch raises the
// batch's wide flag: the round tail's device phase sums each node
// segment's whole GPUs (plus one for a share pod that opens a slot), RDMA
// and FPGA as integers, which equal the reference's float prefix sums
// (solver.py:1246-1274, a cumsum over every sorted row of the round, less
// the cumsum before the segment) only while every partial sum is a whole
// number float32 holds exactly. That holds when each series' absolute
// values sum to at most 2^24 over the batch's pods: every partial sum of
// the cumsum, chunk total and offset is then an integer of at most 2^24.
// A batch past that (a negative ask is fine; huge asks are not) gets the
// flag, and its rounds take the reference's float walk instead.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"

namespace {

using namespace koord_device;

constexpr int kBlock = 256;
constexpr long long kExact = 1ll << 24;  // float32 holds every integer up to here

__device__ __forceinline__ long long abs_ll(int v) { return v < 0 ? -(long long)v : v; }

// The blocks before the last: one thread a node. With asks, the last
// block: the batch's three series (|whole| + 1, |rdma|, |fpga|) summed in
// 64 bits, and the flag.
__global__ void __launch_bounds__(kBlock)
device_prep_kernel(const float* __restrict__ slots, float* __restrict__ stats, int N, int G,
                   const int* __restrict__ whole, const int* __restrict__ rdma_req,
                   const int* __restrict__ fpga_req, int P, int* __restrict__ wide) {
  const int node_blocks = (N + kBlock - 1) / kBlock;
  if ((int)blockIdx.x < node_blocks) {
    const int n = blockIdx.x * kBlock + threadIdx.x;
    if (n < N) slot_stats_row(slots + (size_t)n * G, G, stats + (size_t)n * kStats);
    return;
  }
  __shared__ long long part[3][kBlock / 32];
  long long s[3] = {0, 0, 0};
  for (int p = threadIdx.x; p < P; p += kBlock) {
    s[0] += abs_ll(whole[p]) + 1;
    s[1] += abs_ll(rdma_req[p]);
    s[2] += abs_ll(fpga_req[p]);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int f = 0; f < 3; ++f) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s[f] += __shfl_down_sync(0xFFFFFFFFu, s[f], off);
    if (lane == 0) part[f][warp] = s[f];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bool out = false;
    for (int f = 0; f < 3; ++f) {
      long long t = 0;
      for (int w = 0; w < kBlock / 32; ++w) t += part[f][w];
      out = out || t > kExact;
    }
    wide[0] = out ? 1 : 0;
  }
}

}  // namespace

// slots: [N, G] float; stats: [N, 4] float, written. With `wide` (else
// null): the batch's P pods' whole GPUs, RDMA and FPGA [P] int32, and the
// flag [1] int32, written: 1 where a device sum may leave float32's exact
// integers.
extern "C" int koord_device_prep(const void* slots, void* stats, int N, int G,
                                 const void* whole, const void* rdma_req, const void* fpga_req,
                                 int P, void* wide, void* stream) {
  if (N < 0 || P < 0) return (int)cudaErrorInvalidValue;
  if (N == 0 && wide == nullptr) return (int)cudaSuccess;
  if (G < 1 || G > kMaxSlots) return (int)cudaErrorInvalidValue;
  if (wide != nullptr && P > 0 && (whole == nullptr || rdma_req == nullptr || fpga_req == nullptr))
    return (int)cudaErrorInvalidValue;
  const int blocks = (N + kBlock - 1) / kBlock + (wide != nullptr ? 1 : 0);
  device_prep_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      (const float*)slots, (float*)stats, N, G, (const int*)whole, (const int*)rdma_req,
      (const int*)fpga_req, P, (int*)wide);
  return (int)cudaGetLastError();
}

extern "C" const char* koord_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
