// Round nomination with the NUMA zone and DeviceShare terms: the term
// instantiations of nominate.cuh's kernel, with the fit under each node's
// topology policy and the aligned score (numa.py:numa_fit_mask :77-145, costs.py:numa_aligned_cost
// :212-263, at solver.py:898-899 and :923-924), the device fit and score
// (device.py:device_fit_mask :73-116 with the untracked rules,
// costs.py:device_cost :162-211, at solver.py:900-919 and :929-940), or
// both, with a node mask or none, for D <= 8.
//
// The kernel, its design and the terms' staging are nominate.cuh's; here
// are the instantiations (modes 2-4), their entries and the batch's pod
// order.

#include "nominate.cuh"

namespace {

// The batch's pod order for the term kernels (ops/nominate.py:pod_order):
// the priority-sorted pods stably sorted by a key of 9 values, with zones
// 3 x (0 wants no alignment, 1 cpuset-bound, 2 required), with devices
// plus (0 asks for nothing, 1 RDMA or FPGA alone, 2 GPUs). One block: each
// thread counts the keys of a span of pods, a block-wide scan of the 9
// counts gives each span's place in each key's run, and each thread
// writes its span's pods there, in order. Integer adds only.
constexpr int kOrderThreads = 1024;
constexpr int kOrderKeys = 9;

__device__ __forceinline__ int order_key(int p, const bool* bind, const bool* required,
                                         const int* whole, const float* share,
                                         const int* rdma, const int* fpga) {
  int key = 0;
  if (required != nullptr) key = 3 * (required[p] ? 2 : bind[p] ? 1 : 0);
  if (whole != nullptr) {
    const bool gpu = whole[p] != 0 || share[p] > kEps;
    key += gpu ? 2 : (rdma[p] != 0 || fpga[p] != 0) ? 1 : 0;
  }
  return key;
}

__global__ void __launch_bounds__(kOrderThreads)
pod_order_kernel(const bool* __restrict__ bind, const bool* __restrict__ required,
                 const int* __restrict__ whole, const float* __restrict__ share,
                 const int* __restrict__ rdma, const int* __restrict__ fpga, int P,
                 int* __restrict__ order) {
  __shared__ int warp_tot[kOrderThreads / 32][kOrderKeys];
  __shared__ int key_start[kOrderKeys];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int span = (P + kOrderThreads - 1) / kOrderThreads;
  const int j0 = min(P, tid * span), j1 = min(P, j0 + span);
  int cnt[kOrderKeys];
#pragma unroll
  for (int k = 0; k < kOrderKeys; ++k) cnt[k] = 0;
  for (int j = j0; j < j1; ++j) {
    const int key = order_key(j, bind, required, whole, share, rdma, fpga);
#pragma unroll
    for (int k = 0; k < kOrderKeys; ++k) cnt[k] += key == k;
  }
  // each key's exclusive prefix over the threads: warp shuffles, then the
  // warps' totals
  int before[kOrderKeys];
#pragma unroll
  for (int k = 0; k < kOrderKeys; ++k) {
    int x = cnt[k];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x += y;
    }
    before[k] = x - cnt[k];
    if (lane == 31) warp_tot[warp][k] = x;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < kOrderKeys; ++k) {
      const int t = warp_tot[lane][k];
      int x = t;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, x, off);
        if (lane >= off) x += y;
      }
      warp_tot[lane][k] = x - t;  // the warps before
      if (lane == 31) key_start[k] = x;  // the key's total, for now
    }
    __syncwarp();
    if (lane == 0) {
      int at = 0;
      for (int k = 0; k < kOrderKeys; ++k) {
        const int total = key_start[k];
        key_start[k] = at;
        at += total;
      }
    }
  }
  __syncthreads();
  int next[kOrderKeys];
#pragma unroll
  for (int k = 0; k < kOrderKeys; ++k) next[k] = key_start[k] + warp_tot[warp][k] + before[k];
  for (int j = j0; j < j1; ++j) {
    const int key = order_key(j, bind, required, whole, share, rdma, fpga);
#pragma unroll
    for (int k = 0; k < kOrderKeys; ++k) {
      if (key == k) order[next[k]++] = j;
    }
  }
}

// The term instantiations: modes 2 (zones), 3 (devices) and 4 (both),
// each with a node mask or none, D <= 8; with zones the compiled shape of
// the run-time (Z, DN), or the generic one.
struct TermsFamily {
  static bool accepts(int mode, int D, int Z, int DN) {
    if (mode < kNumaMode || mode > kDevNumaMode || D > 8) return false;
    return mode == kDevMode || (Z >= 1 && Z <= kMaxZones && DN >= 1 && DN <= kMaxZoneDims);
  }

  template <int D, int C, bool kNuma, bool kDev>
  static auto zoned(int Z, int DN) {
    if constexpr (D >= 2) {
      if (Z == 2 && DN == 2) return nominate_kernel<D, C, true, kNuma, kDev, 2, 2>;
      if (Z == 4 && DN == 2) return nominate_kernel<D, C, true, kNuma, kDev, 4, 2>;
    }
    return nominate_kernel<D, C, true, kNuma, kDev, kMaxZones, kMaxZoneDims>;
  }

  template <int D, int C>
  static auto kernel(int mode, int Z, int DN) {
    if constexpr (D <= 8) {
      if (mode == kDevMode) return nominate_kernel<D, C, true, false, true, 1, 1>;
      if (mode == kNumaMode) return zoned<D, C, true, false>(Z, DN);
      return zoned<D, C, true, true>(Z, DN);
    } else {
      // never taken (accepts refuses D > 8): one instantiation of the type
      return decltype(&nominate_kernel<1, C, true, false, true, 1, 1>)(nullptr);
    }
  }
};

}  // namespace

// koord_nominate_chunk: nodes each block walks for P pods and N nodes at
// width D and fan-out K on a card of `sms` SMs (mode: 0 LoadAware only, 1
// with a node mask, 2 with NUMA zones, 3 with devices, 4 with devices and
// NUMA zones; Z and DN the zone table's shape, 0 without zones).
// koord_nominate: one call (`order`: the term kernels' pod order, [P]
// int32 or null). The caller makes room for partial lists of
// [P, ceil(N / chunk), kMaxK] pairs when there is more than one chunk.
extern "C" int koord_nominate_chunk(int P, int N, int D, int K, int sms, int mode, int Z,
                                    int DN, int* chunk) {
  return nominate_chunk<TermsFamily>(P, N, D, K, sms, mode, Z, DN, chunk);
}

extern "C" int koord_nominate(
    const void* req, const void* est, const void* is_prod, const void* cpu_bind,
    const void* gate, const void* alloc, const void* requested, const void* est_used,
    const void* prod_used, const void* fresh, const void* sched, const void* cpu_amp,
    const void* thr, const void* pthr, const void* weights, int P, int N, int D, int K,
    int chunk, float jitter_scale, int jitter_on, int approx, void* part_cost,
    void* part_idx, void* out_cost, void* out_idx, const void* state,
    const void* trigger, const void* mask, const void* mask_row, const void* zone_free,
    const void* zone_cap, const void* side, const void* required, int Z, int DN,
    int scoring, const void* dev_stats, const void* rdma_free, const void* fpga_free,
    const void* cap_total, const void* gpu_whole, const void* gpu_share,
    const void* rdma_req, const void* fpga_req, const void* units, int dev_scoring,
    int dev_clamp, const void* order, void* stream) {
  return nominate_entry<TermsFamily>(
      req, est, is_prod, cpu_bind, gate, alloc, requested, est_used, prod_used, fresh, sched,
      cpu_amp, thr, pthr, weights, P, N, D, K, chunk, jitter_scale, jitter_on, approx,
      part_cost, part_idx, out_cost, out_idx, state, trigger, mask, mask_row, zone_free,
      zone_cap, side, required, Z, DN, scoring, dev_stats, rdma_free, fpga_free, cap_total,
      gpu_whole, gpu_share, rdma_req, fpga_req, units, dev_scoring, dev_clamp, order, stream);
}

// The batch's pod order (pod_order_kernel): the sorted pods' cpu-bind
// flags [P] and, with zones, their required flags (null: no zones), with
// devices their whole GPUs, share, RDMA and FPGA (null: no devices); the
// order [P] int32, written.
extern "C" int koord_pod_order(const void* bind, const void* required, const void* whole,
                               const void* share, const void* rdma, const void* fpga, int P,
                               void* order, void* stream) {
  if (P <= 0) return (int)cudaSuccess;
  if (bind == nullptr || order == nullptr || (required == nullptr && whole == nullptr) ||
      (whole != nullptr && (share == nullptr || rdma == nullptr || fpga == nullptr)))
    return (int)cudaErrorInvalidValue;
  pod_order_kernel<<<1, kOrderThreads, 0, (cudaStream_t)stream>>>(
      (const bool*)bind, (const bool*)required, (const int*)whole, (const float*)share,
      (const int*)rdma, (const int*)fpga, P, (int*)order);
  return (int)cudaGetLastError();
}

extern "C" const char* koord_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
