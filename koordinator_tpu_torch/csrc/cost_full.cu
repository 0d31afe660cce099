// The materialized round cost of the cost-transform route: the pre-jitter
// cost of every (pod, node) pair, fp32 [P, N], and the pair's
// feasibility, uint8 [P, N].
//
// Replaces koordinator_tpu/ops/solver.py:assign's full_feas_cost (:864-941)
// up to the BeforeScore transform (:942-946): the part of the program XLA
// fused into one TPU kernel before the user's rewrite of the cost. The
// transform then runs in torch on the buffer, and nominate_cost.cu takes
// the jitter, the infeasible +inf and the top-k.
//
// What bounds it on an H100: the bytes it writes, 5 a pair (the cost and
// the flag); at P=4,096, N=10,000 that is 205 MB, 61 us at 3.35 TB/s. Per
// pair it also does ~40 fp32 operations, up to 2D + 1 of them IEEE
// divisions, over node rows of ~55 bytes that stay in L2, so instruction
// throughput is close behind.
//
// Design: one thread a pair, a block of 256 consecutive nodes of one pod
// (grid: node blocks x pods), so each warp writes 128 consecutive bytes of
// cost and 32 of flags, and every thread of a block reads the same pod
// columns (a broadcast). The pair arithmetic is loadaware.cuh's (fit,
// usage_percent, score_term, numa_fit, numa_score, device_fit,
// device_score), evaluated for every pair with no early exit: the
// reference computes the cost of infeasible pairs too, and the transform
// sees them. NUMA zones and devices are instantiations of their own
// (kNuma, kDev, D <= 8); the node mask is a run-time pointer. The kernel
// returns at once when the round loop's `done` is set (csrc/round.cu), as
// nomination does.
//
// Bit-exactness: every float operation is written in the reference's
// order, division is IEEE `/`, and the file is compiled with -fmad=false.

#include "loadaware.cuh"

namespace {

using namespace koord;

constexpr int kThreads = 256;
constexpr int kMaxDims = 16;

template <int D, bool kNuma, bool kDev>
__global__ void __launch_bounds__(kThreads)
cost_full_kernel(const float* __restrict__ req, const float* __restrict__ est,
                 const bool* __restrict__ is_prod, const bool* __restrict__ cpu_bind,
                 const bool* __restrict__ gate, const float* __restrict__ alloc,
                 const float* __restrict__ requested, const float* __restrict__ est_used,
                 const float* __restrict__ prod_used, const bool* __restrict__ fresh,
                 const bool* __restrict__ sched, const float* __restrict__ cpu_amp,
                 const float* __restrict__ thr, const float* __restrict__ pthr,
                 const float* __restrict__ weights, int P, int N,
                 float* __restrict__ out_cost, uint8_t* __restrict__ out_feas,
                 const int* __restrict__ state, const bool* __restrict__ mask,
                 const long long* __restrict__ mask_row, const Zones zones,
                 const Devices devs) {
  if (state != nullptr && state[0] != 0) return;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const int p = blockIdx.y;
  if (n >= N || p >= P) return;

  float w[D];
  const float wsum = weights_sum<D>(weights, w);
  float rq[D], es[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    rq[d] = req[(size_t)p * D + d];
    es[d] = est[(size_t)p * D + d];
  }
  const bool bind = cpu_bind[p];
  const bool prod = is_prod[p];
  const bool node_fresh = fresh[n];

  // _feasible (:625-657): schedulable, the pod gate, the node mask, fit,
  // amplified-CPU fit, then usage and prod thresholds on fresh nodes
  bool feas = gate[p] && sched[n];
  const bool* row = mask_row_of(mask, mask_row, p, N);
  if (row != nullptr) feas = feas && row[n];
  float a[D], after[D];
  float fe0 = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const size_t at = (size_t)n * D + d;
    a[d] = alloc[at];
    const float fe = free_eps(a[d], requested[at]);
    if (d == 0) fe0 = fe;
    feas = feas & (rq[d] <= fe);
    after[d] = est_used[at] + es[d];
  }
  feas = feas & (!bind | (rq[0] * amp_of(cpu_amp[n]) <= fe0));
  if (node_fresh) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const size_t at = (size_t)n * D + d;
      const float t = thr[at];
      if (t > 0.0f) feas = feas & !(usage_percent(after[d], a[d]) > t);
      const float pt = pthr[at];
      if (pt > 0.0f) feas = feas & !(prod & (usage_percent(prod_used[at] + es[d], a[d]) > pt));
    }
  }
  bool required = false;
  if constexpr (kNuma) {
    required = zones.required[p];
    feas = feas && numa_fit<D>(rq, bind, required, cpu_amp[n], n, zones);
  }
  DevPod dpod;
  if constexpr (kDev) {
    dpod.load(p, devs);
    feas = feas && device_fit(dpod, n, devs);
  }

  // load_aware_cost (costs.py:25-69): integer-floor least-used score, 0
  // on a stale node, negated; then the NUMA aligned term (:923-924) and
  // the device term (:929-938), for every pair
  float score = 0.0f;
  if (node_fresh) {
    float total = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float term = score_term(a[d], alloc_safe(a[d]), after[d], w[d]);
      total = d == 0 ? term : total + term;
    }
    score = floorf(total / wsum);
  }
  float c = -score;
  if constexpr (kNuma) {
    if (zones.scoring != 0)
      c = c + numa_score<D>(rq, bind, required, n, zones, w, zone_weights_sum<D>(w, zones.DN));
  }
  if constexpr (kDev) {
    if (devs.scoring != 0) c = c + device_score(dpod, n, devs);
  }
  const size_t at = (size_t)p * N + n;
  out_cost[at] = c;
  out_feas[at] = feas ? 1 : 0;
}

struct Args {
  const float *req, *est;
  const bool *is_prod, *cpu_bind, *gate;
  const float *alloc, *requested, *est_used, *prod_used;
  const bool *fresh, *sched;
  const float *cpu_amp, *thr, *pthr, *weights;
  int P, N;
  float* out_cost;
  uint8_t* out_feas;
  const int* state;
  const bool* mask;
  const long long* mask_row;
  Zones zones;   // zones.free == nullptr: no NUMA
  Devices devs;  // devs.stats == nullptr: no devices
  cudaStream_t stream;
};

struct Launch {
  const Args& a;

  template <int D, bool kNuma, bool kDev>
  cudaError_t go() const {
    const dim3 grid((a.N + kThreads - 1) / kThreads, a.P);
    cost_full_kernel<D, kNuma, kDev><<<grid, kThreads, 0, a.stream>>>(
        a.req, a.est, a.is_prod, a.cpu_bind, a.gate, a.alloc, a.requested, a.est_used,
        a.prod_used, a.fresh, a.sched, a.cpu_amp, a.thr, a.pthr, a.weights, a.P, a.N,
        a.out_cost, a.out_feas, a.state, a.mask, a.mask_row, a.zones, a.devs);
    return cudaGetLastError();
  }

  template <int D>
  cudaError_t run() const {
    const bool numa = a.zones.free != nullptr, dev = a.devs.stats != nullptr;
    if constexpr (D <= 8) {
      if (numa && dev) return go<D, true, true>();
      if (numa) return go<D, true, false>();
      if (dev) return go<D, false, true>();
    } else {
      if (numa || dev) return cudaErrorInvalidValue;
    }
    return go<D, false, false>();
  }
};

cudaError_t with_d16(int D, const Launch& op) {
  switch (D) {
    case 1: return op.run<1>();
    case 2: return op.run<2>();
    case 3: return op.run<3>();
    case 4: return op.run<4>();
    case 5: return op.run<5>();
    case 6: return op.run<6>();
    case 7: return op.run<7>();
    case 8: return op.run<8>();
    case 9: return op.run<9>();
    case 10: return op.run<10>();
    case 11: return op.run<11>();
    case 12: return op.run<12>();
    case 13: return op.run<13>();
    case 14: return op.run<14>();
    case 15: return op.run<15>();
    case 16: return op.run<16>();
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int koord_cost_full(
    const void* req, const void* est, const void* is_prod, const void* cpu_bind,
    const void* gate, const void* alloc, const void* requested, const void* est_used,
    const void* prod_used, const void* fresh, const void* sched, const void* cpu_amp,
    const void* thr, const void* pthr, const void* weights, int P, int N, int D,
    void* out_cost, void* out_feas, const void* state, const void* mask,
    const void* mask_row, const void* zone_free, const void* zone_cap, const void* side,
    const void* required, int Z, int DN, int scoring, const void* dev_stats,
    const void* rdma_free, const void* fpga_free, const void* cap_total,
    const void* gpu_whole, const void* gpu_share, const void* rdma_req,
    const void* fpga_req, const void* units, int dev_scoring, void* stream) {
  if (P <= 0) return (int)cudaSuccess;
  if (D < 1 || D > kMaxDims || N < 1 || P > 65535) return (int)cudaErrorInvalidValue;
  if (zone_free != nullptr &&
      (Z < 1 || Z > kMaxZones || DN < 1 || DN > kMaxZoneDims || DN > D || D > 8))
    return (int)cudaErrorInvalidValue;
  if (dev_stats != nullptr && (D > 8 || (dev_scoring != 0 && cap_total == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a{(const float*)req, (const float*)est, (const bool*)is_prod,
               (const bool*)cpu_bind, (const bool*)gate, (const float*)alloc,
               (const float*)requested, (const float*)est_used, (const float*)prod_used,
               (const bool*)fresh, (const bool*)sched, (const float*)cpu_amp,
               (const float*)thr, (const float*)pthr, (const float*)weights, P, N,
               (float*)out_cost, (uint8_t*)out_feas, (const int*)state, (const bool*)mask,
               (const long long*)mask_row,
               Zones{(const float*)zone_free, (const float*)zone_cap, (const uint32_t*)side,
                     (const bool*)required, Z, DN, scoring},
               Devices{(const float*)dev_stats, (const float*)rdma_free, (const float*)fpga_free,
                       (const float*)cap_total, (const int*)gpu_whole, (const float*)gpu_share,
                       (const int*)rdma_req, (const int*)fpga_req, (const float*)units,
                       dev_scoring, 0},
               (cudaStream_t)stream};
  return (int)with_d16(D, Launch{a});
}

extern "C" const char* koord_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
