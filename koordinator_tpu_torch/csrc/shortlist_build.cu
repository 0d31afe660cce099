// Candidate-shortlist build: each pod's K+1 lowest (cost, node) pairs over
// the whole node axis at round-0 state, returned as its K candidate ids in
// ascending order and the (K+1)-th cost as the bound.
//
// Replaces the build block of koordinator_tpu/ops/solver.py:assign
// (:949-1015: full_feas_cost at round 0 with every pod gate open, lax.top_k
// of K+1, the candidates sorted ascending, the bound -neg_b[:, K]) and
// shortlist_plan (:1547-1657) — a device program XLA fused on the TPU.
// The candidate gathers of that block (:982-995) are not done here: the
// round kernel (shortlist_round.cu) reads the candidates' rows itself.
//
// What bounds it on an H100: arithmetic, as nomination (nominate.cu) — at
// P=512, N=10,000 ~2.6e8 fp32 operations (up to five IEEE divisions a
// pair) over ~0.55 MB of node tables that stay in L2. The selection adds
// a few passes over each pod's N keys in shared memory.
//
// Design, simple first: one block a pod.
// - Each thread prices a strided share of the nodes with loadaware.cuh's
//   pair_cost (so a pair costs here what it costs in nomination and in the
//   shortlist round) into an order-preserving 64-bit key: the cost's bits,
//   flipped so that unsigned order is float order, then the node id. The
//   keys are unique, and their order is the (cost, index) order lax.top_k
//   ranks by. Within one call every zero cost has one sign (+0 with the
//   jitter on, -0 without), so bit order and float order agree on ties.
// - The keys' cost halves stay in shared memory, at the node's place (4
//   bytes a node: 40 KB at N=10,000, up to 51,200 nodes), so four blocks
//   of 512 threads fit an SM; above that each pass prices the nodes again.
//   No [P, N] cost matrix reaches device memory.
// - A radix select over the keys finds the (K+1)-th: 8 bits a pass, from
//   the cost's high byte down, skipping the id bytes every node id leaves
//   at zero (6 passes at N=10,000). Each pass counts the keys that match
//   the digits found so far in a 256-bin histogram; a warp's lanes with one
//   digit add once (__match_any_sync), and one warp scans the bins.
// - The K keys below it are collected (integer atomics for the slots: the
//   order they land in does not matter) and put in ascending order by
//   rank: each id's place is the number of ids below it.
// - With NUMA zones the pair's fit and aligned score are loadaware.cuh's
//   numa_fit and numa_score over the batch-start table (shortlist_plan's
//   :1590-1600, the build's :898-899 and :923-924), in their own
//   instantiation (kNuma).
// - With devices the pair's device fit and score are loadaware.cuh's
//   device_fit and device_score over the batch-start stats table, the
//   score clamped at <= 0 (clamp_device, solver.py:939-940, :1645), in
//   the device instantiations (kDev, with kNuma or without).
// - Its cost is the bound: +inf when fewer than K+1 pairs are feasible,
//   and then the shortlist holds the lowest infeasible ids, as top_k's
//   -inf ties do. A pod whose node-mask row is all false prices every
//   node +inf: its bound is +inf and its shortlist complete.

#include "loadaware.cuh"

namespace {

using namespace koord;

constexpr int kThreads = 512;
constexpr int kMaxShortlist = 1024;
// keys are kept in shared memory up to this many bytes (51,200 nodes)
constexpr int kStoredBytes = 200 * 1024;

// An unsigned form of cost c that sorts as the float does.
__device__ __forceinline__ uint32_t order_of(float c) {
  const uint32_t u = __float_as_uint(c);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The key of node n at ordered cost u.
__device__ __forceinline__ uint64_t key_of(uint32_t u, int n) {
  return ((uint64_t)u << 32) | (uint32_t)n;
}

// The cost a key was made from, bit for bit.
__device__ __forceinline__ float cost_of(uint64_t key) {
  uint32_t u = (uint32_t)(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u;
  return __uint_as_float(u);
}

struct Args {
  const float *req, *est;
  const bool *is_prod, *cpu_bind;
  Nodes nodes;
  const float* weights;
  int P, N, K, index_bits;
  float jitter_scale;
  int jitter_on;
  int* out_cand;
  float* out_bound;
  const bool* mask;
  const long long* mask_row;
  Zones zones;   // zones.free == nullptr: no NUMA
  Devices devs;  // devs.stats == nullptr: no devices
  cudaStream_t stream;
};

template <int D, bool kStored, bool kNuma, bool kDev>
__global__ void __launch_bounds__(kThreads) shortlist_build_kernel(const Args a) {
  extern __shared__ uint32_t costs[];  // [N] ordered costs when kStored
  __shared__ int hist[256];
  __shared__ int s_digit, s_below, s_count;
  __shared__ int s_cand[kMaxShortlist];

  const int p = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const int N = a.N, K = a.K;
  Pod<D> pod;
  pod.load(p, a.req, a.est, a.is_prod, a.cpu_bind);
  pod.mask = mask_row_of(a.mask, a.mask_row, p, N);
  if constexpr (kNuma) pod.required = a.zones.required[p];
  if constexpr (kDev) pod.dev.load(p, a.devs);
  float w[D];
  const float wsum = weights_sum<D>(a.weights, w);
  const float zwsum = kNuma ? zone_weights_sum<D>(w, a.zones.DN) : 0.0f;
  // every pod gate open: a pod that is not active now may be later
  auto price = [&](int n) {
    return order_of(pair_cost<D, kNuma, kDev>(pod, true, n, a.nodes, w, wsum, a.jitter_scale,
                                              a.jitter_on != 0, &a.zones, zwsum, &a.devs));
  };
  auto key_at = [&](int n) { return key_of(kStored ? costs[n] : price(n), n); };

  if (kStored)
    for (int n = tid; n < N; n += kThreads) costs[n] = price(n);
  if (tid == 0) s_count = 0;
  __syncthreads();

  // radix select of the key of rank K (0-based): the (K+1)-th smallest
  uint64_t prefix = 0, mask = 0;
  int rank = K;
  for (int shift = 56; shift >= 0; shift -= 8) {
    // an id byte above N - 1's bits is zero in every key
    if (shift < 32 && shift >= a.index_bits) continue;
    for (int b = tid; b < 256; b += kThreads) hist[b] = 0;
    __syncthreads();
    for (int base = 0; base < N; base += kThreads) {
      const int n = base + tid;
      int digit = -1;
      if (n < N) {
        const uint64_t key = key_at(n);
        if ((key & mask) == prefix) digit = (int)((key >> shift) & 255);
      }
      const unsigned peers = __match_any_sync(kFull, digit);
      if (digit >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[digit], __popc(peers));
    }
    __syncthreads();
    if (tid < 32) {
      // lane l holds bins 8l..8l+7; the lane whose range holds `rank`
      // finds the bin
      int local[8];
      int sum = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        local[i] = hist[tid * 8 + i];
        sum += local[i];
      }
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += t;
      }
      int below = incl - sum;
      if (below <= rank && rank < incl) {
        int b = 0;
        while (rank >= below + local[b]) below += local[b++];
        s_digit = tid * 8 + b;
        s_below = below;
      }
    }
    __syncthreads();
    prefix |= (uint64_t)s_digit << shift;
    mask |= (uint64_t)255 << shift;
    rank -= s_below;
  }

  // the K keys below the (K+1)-th are the shortlist
  for (int n = tid; n < N; n += kThreads)
    if (key_at(n) < prefix) s_cand[atomicAdd(&s_count, 1)] = n;
  __syncthreads();
  for (int i = tid; i < K; i += kThreads) {
    const int id = s_cand[i];
    int place = 0;
    for (int j = 0; j < K; ++j) place += s_cand[j] < id;
    a.out_cand[(size_t)p * K + place] = id;
  }
  if (tid == 0) a.out_bound[p] = cost_of(prefix);
}

template <int D, bool kStored, bool kNuma, bool kDev>
cudaError_t launch_stored(const Args& a) {
  const size_t smem = kStored ? (size_t)a.N * sizeof(uint32_t) : 0;
  static bool sized = false;
  if (kStored && !sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        shortlist_build_kernel<D, kStored, kNuma, kDev>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kStoredBytes);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  shortlist_build_kernel<D, kStored, kNuma, kDev><<<a.P, kThreads, smem, a.stream>>>(a);
  return cudaGetLastError();
}

template <int D, bool kNuma, bool kDev>
cudaError_t launch_terms(const Args& a) {
  return (size_t)a.N * sizeof(uint32_t) <= (size_t)kStoredBytes
             ? launch_stored<D, true, kNuma, kDev>(a)
             : launch_stored<D, false, kNuma, kDev>(a);
}

struct Launch {
  const Args& a;
  template <int D>
  cudaError_t run() const {
    const bool numa = a.zones.free != nullptr;
    if (a.devs.stats != nullptr)
      return numa ? launch_terms<D, true, true>(a) : launch_terms<D, false, true>(a);
    return numa ? launch_terms<D, true, false>(a) : launch_terms<D, false, false>(a);
  }
};

}  // namespace

// Pods are priority-sorted [P, D] / [P]; node tables [N, D] / [N]; thr and
// pthr the effective [N, D] thresholds; mask [M, N] bool and mask_row [P]
// int64 the pods' node constraints (both null: none); the zone terms
// (zone_free null: none) and the device terms (dev_stats null: none,
// rdma_free / fpga_free null: not tracked; dev_clamp the build's clamp).
// Writes cand [P, K] int32 (ids ascending) and bound [P] float32. Needs
// 1 <= K <= 1024, K < N, D <= 8.
extern "C" int koord_shortlist_build(
    const void* req, const void* est, const void* is_prod, const void* cpu_bind,
    const void* alloc, const void* requested, const void* est_used,
    const void* prod_used, const void* fresh, const void* sched,
    const void* cpu_amp, const void* thr, const void* pthr, const void* weights,
    int P, int N, int D, int K, float jitter_scale, int jitter_on, void* cand,
    void* bound, const void* mask, const void* mask_row, const void* zone_free,
    const void* zone_cap, const void* side, const void* required, int Z, int DN,
    int scoring, const void* dev_stats, const void* rdma_free, const void* fpga_free,
    const void* cap_total, const void* gpu_whole, const void* gpu_share, const void* rdma_req,
    const void* fpga_req, const void* units, int dev_scoring, int dev_clamp, void* stream) {
  if (P <= 0) return (int)cudaSuccess;
  if (K < 1 || K > kMaxShortlist || K >= N) return (int)cudaErrorInvalidValue;
  if (zone_free != nullptr &&
      (Z < 1 || Z > kMaxZones || DN < 1 || DN > kMaxZoneDims || DN > D))
    return (int)cudaErrorInvalidValue;
  if (dev_stats != nullptr && dev_scoring != 0 && cap_total == nullptr)
    return (int)cudaErrorInvalidValue;
  int index_bits = 1;
  while ((1 << index_bits) < N) ++index_bits;
  const Args a{(const float*)req, (const float*)est, (const bool*)is_prod,
               (const bool*)cpu_bind,
               Nodes{(const float*)alloc, (const float*)requested, (const float*)est_used,
                     (const float*)prod_used, (const bool*)fresh, (const bool*)sched,
                     (const float*)cpu_amp, (const float*)thr, (const float*)pthr},
               (const float*)weights, P, N, K, index_bits, jitter_scale, jitter_on,
               (int*)cand, (float*)bound, (const bool*)mask, (const long long*)mask_row,
               Zones{(const float*)zone_free, (const float*)zone_cap, (const uint32_t*)side,
                     (const bool*)required, Z, DN, scoring},
               Devices{(const float*)dev_stats, (const float*)rdma_free, (const float*)fpga_free,
                       (const float*)cap_total, (const int*)gpu_whole, (const float*)gpu_share,
                       (const int*)rdma_req, (const int*)fpga_req, (const float*)units,
                       dev_scoring, dev_clamp},
               (cudaStream_t)stream};
  return (int)with_d8(D, Launch{a});
}

extern "C" const char* koord_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
