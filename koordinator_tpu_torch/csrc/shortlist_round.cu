// Candidate-shortlist round: each pod's cost over its K build-time
// candidates, their exact top-k, the round's nomination vector, and the
// exactness check that decides on the device whether the round falls back
// to the full-axis nomination.
//
// Replaces shortlist_feas_cost (koordinator_tpu/ops/solver.py:1017-1086,
// with the candidate gathers of :982-995) and the round's shortlist branch
// (:1158-1201): the gathered [P, K] cost, lax.top_k of it, the nomination
// vector ([best, best, 2nd, ...] under approx_topk, :1165-1176), kth <
// bound strictly or an unbounded shortlist, and the [2] fallback counts
// (bound, exhausted). The lax.cond itself is the trigger word this kernel
// sets: the full-axis nomination (nominate.cu) runs only when it is set.
//
// What bounds it on an H100: latency. At P=512, K=64 the work is 32,768
// pairs (~4e6 fp32 operations) over 64 scattered node rows a pod, ~3.5 MB
// of row reads that hit L2 (the node tables are ~0.55 MB). Nothing is
// large enough to fill the card for long; what a launch costs is a chain
// of dependent loads and the top-k.
//
// Design: one warp a pod, eight pods a block; lane l prices candidates l,
// l + 32, ... with loadaware.cuh's pair_cost — the candidate's rows read
// from the full tables by its original id, so the gathers cost no launch
// and a candidate prices exactly as on the full axis — into a register
// top-C by (cost, node id). plan_cand is ascending, so node-id order is
// position order, the order lax.top_k breaks the reference's ties by. k
// rounds of a warp-wide (cost, id) minimum (__shfl_xor_sync) then give the
// exact top-k; lane 0 writes the nomination vector and tests the pod. The
// flags (any unsafe pod; any with a finite candidate; any without) are
// ORed into the round's word with integer atomics, and the block that
// finishes last (a ticket in the same word, after __threadfence) adds the
// two flags to the [2] count: ordered by the stream, no host sync, no
// float atomics. The kernel returns at once on the round loop's `done`, so
// a trip after the fixed point counts nothing. With NUMA zones a candidate
// prices its NUMA fit and aligned score from the batch-start table through
// loadaware.cuh (the reference gathers them from the build's [P, N] terms,
// :1001-1008, :1050-1051, :1076-1077: the same bits), in their own
// instantiation (kNuma); with devices its device fit and score from the
// round-start stats table and the carried RDMA and FPGA counts at its id
// (device_fit_mask_cols, device_cost_cols, :1052-1068, :1078-1084), in the
// device instantiations (kDev).

#include "loadaware.cuh"

namespace {

using namespace koord;

constexpr int kWarps = 8;  // pods a block

struct Args {
  const float *req, *est;
  const bool *is_prod, *cpu_bind, *gate;
  Nodes nodes;
  const float* weights;
  const int* cand;
  const float* bound;
  int P, N, K, k;
  float jitter_scale;
  int jitter_on, approx;
  float* out_cost;
  int* out_idx;
  int* word;    // [4]: trigger, bound flag, exhausted flag, ticket
  int* counts;  // [2]
  const int* state;
  const bool* mask;
  const long long* mask_row;
  Zones zones;   // zones.free == nullptr: no NUMA
  Devices devs;  // devs.stats == nullptr: no devices
  cudaStream_t stream;
};

template <int D, int C, bool kNuma, bool kDev>
__global__ void __launch_bounds__(kWarps * 32) shortlist_round_kernel(const Args a) {
  // the round loop reached its fixed point: no round, nothing counted
  if (a.state[0] != 0) return;
  __shared__ int s_flags[3];
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < 3) s_flags[tid] = 0;
  __syncthreads();

  const int p = blockIdx.x * kWarps + (tid >> 5);
  if (p < a.P) {  // uniform across the warp
    Pod<D> pod;
    pod.load(p, a.req, a.est, a.is_prod, a.cpu_bind);
    pod.mask = mask_row_of(a.mask, a.mask_row, p, a.N);  // read at each candidate's id
    if constexpr (kNuma) pod.required = a.zones.required[p];
    if constexpr (kDev) pod.dev.load(p, a.devs);
    const bool gate = a.gate[p];
    float w[D];
    const float wsum = weights_sum<D>(a.weights, w);
    const float zwsum = kNuma ? zone_weights_sum<D>(w, a.zones.DN) : 0.0f;
    TopK<C> top;
    top.clear(C);
    bool finite = false;
    const int* cand = a.cand + (size_t)p * a.K;
    for (int c = lane; c < a.K; c += 32) {
      const int n = cand[c];
      const float cost = pair_cost<D, kNuma, kDev>(pod, gate, n, a.nodes, w, wsum,
                                                   a.jitter_scale, a.jitter_on != 0, &a.zones,
                                                   zwsum, &a.devs);
      finite = finite | (cost < CUDART_INF_F);
      top.insert(cost, n);
    }
    const bool cand_any = __any_sync(kFull, finite);
    float kth = CUDART_INF_F;
    float* oc = a.out_cost + (size_t)p * a.k;
    int* oi = a.out_idx + (size_t)p * a.k;
#pragma unroll
    for (int r = 0; r < C; ++r) {
      if (r >= a.k) break;
      float v = top.v[C - 1];
      int i = top.i[C - 1];
      const float own_v = v;
      const int own_i = i;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, v, off);
        const int oi_ = __shfl_xor_sync(kFull, i, off);
        if (less_pair(ov, oi_, v, i)) {
          v = ov;
          i = oi_;
        }
      }
      if (lane == 0) put_ranked(oc, oi, r, a.k, a.approx != 0, v, i);
      kth = v;  // after the last round: the k-th of the exact top-k
      if (own_i == i && own_v == v) {
        // pop: every pair moves one slot toward the best end
#pragma unroll
        for (int s = C - 1; s > 0; --s) {
          top.v[s] = top.v[s - 1];
          top.i[s] = top.i[s - 1];
        }
        top.v[0] = CUDART_INF_F;
        top.i[0] = INT32_MAX;
      }
    }
    if (lane == 0) {
      // exact when every nomination beats the best excluded node's bound
      // strictly (a tie could hand the full axis a lower id), or when the
      // shortlist holds every feasible node
      const float b = a.bound[p];
      const bool safe = !isfinite(b) || (isfinite(kth) && kth < b);
      if (gate && !safe) {
        atomicOr(&s_flags[0], 1);
        atomicOr(&s_flags[cand_any ? 1 : 2], 1);
      }
    }
  }
  __syncthreads();
  if (tid != 0) return;
#pragma unroll
  for (int f = 0; f < 3; ++f)
    if (s_flags[f]) atomicOr(&a.word[f], 1);
  __threadfence();
  const int ticket = atomicAdd(&a.word[3], 1);
  if (ticket == (int)gridDim.x - 1) {
    // every block's flags are in: count them once for the round
    __threadfence();
    a.counts[0] += atomicOr(&a.word[1], 0);
    a.counts[1] += atomicOr(&a.word[2], 0);
  }
}

template <int D, bool kNuma, bool kDev>
cudaError_t launch(const Args& a) {
  const int blocks = (a.P + kWarps - 1) / kWarps;
  if (a.k <= 4)
    shortlist_round_kernel<D, 4, kNuma, kDev><<<blocks, kWarps * 32, 0, a.stream>>>(a);
  else
    shortlist_round_kernel<D, 8, kNuma, kDev><<<blocks, kWarps * 32, 0, a.stream>>>(a);
  return cudaGetLastError();
}

struct Launch {
  const Args& a;
  template <int D>
  cudaError_t run() const {
    const bool numa = a.zones.free != nullptr;
    if (a.devs.stats != nullptr)
      return numa ? launch<D, true, true>(a) : launch<D, false, true>(a);
    return numa ? launch<D, true, false>(a) : launch<D, false, false>(a);
  }
};

}  // namespace

// Pods are priority-sorted [P, D] / [P] with the round's gate (active
// flags, with quotas those with headroom); node tables [N, D] / [N] with
// the effective thresholds; cand [P, K] int32 ascending and bound [P] from
// the build; mask [M, N] bool and mask_row [P] int64 the pods' node
// constraints (both null: none); the zone and device terms as
// koord_shortlist_build takes them (no clamp). Writes the nomination [P, k] into
// out_cost / out_idx, ORs the round's flags into word [4] (zero before the
// round) and adds them to counts [2]. Needs 1 <= k <= min(8, K), D <= 8;
// `state` is the round loop's state word.
extern "C" int koord_shortlist_round(
    const void* req, const void* est, const void* is_prod, const void* cpu_bind,
    const void* gate, const void* alloc, const void* requested,
    const void* est_used, const void* prod_used, const void* fresh,
    const void* sched, const void* cpu_amp, const void* thr, const void* pthr,
    const void* weights, const void* cand, const void* bound, int P, int N, int D,
    int K, int k, float jitter_scale, int jitter_on, int approx, void* out_cost,
    void* out_idx, void* word, void* counts, const void* state, const void* mask,
    const void* mask_row, const void* zone_free, const void* zone_cap, const void* side,
    const void* required, int Z, int DN, int scoring, const void* dev_stats,
    const void* rdma_free, const void* fpga_free, const void* cap_total, const void* gpu_whole,
    const void* gpu_share, const void* rdma_req, const void* fpga_req, const void* units,
    int dev_scoring, void* stream) {
  if (P <= 0) return (int)cudaSuccess;
  if (k < 1 || k > 8 || k > K) return (int)cudaErrorInvalidValue;
  if (zone_free != nullptr &&
      (Z < 1 || Z > kMaxZones || DN < 1 || DN > kMaxZoneDims || DN > D))
    return (int)cudaErrorInvalidValue;
  if (dev_stats != nullptr && dev_scoring != 0 && cap_total == nullptr)
    return (int)cudaErrorInvalidValue;
  const Args a{(const float*)req, (const float*)est, (const bool*)is_prod,
               (const bool*)cpu_bind, (const bool*)gate,
               Nodes{(const float*)alloc, (const float*)requested, (const float*)est_used,
                     (const float*)prod_used, (const bool*)fresh, (const bool*)sched,
                     (const float*)cpu_amp, (const float*)thr, (const float*)pthr},
               (const float*)weights, (const int*)cand, (const float*)bound, P, N, K, k,
               jitter_scale, jitter_on, approx, (float*)out_cost, (int*)out_idx,
               (int*)word, (int*)counts, (const int*)state, (const bool*)mask,
               (const long long*)mask_row,
               Zones{(const float*)zone_free, (const float*)zone_cap, (const uint32_t*)side,
                     (const bool*)required, Z, DN, scoring},
               Devices{(const float*)dev_stats, (const float*)rdma_free, (const float*)fpga_free,
                       (const float*)cap_total, (const int*)gpu_whole, (const float*)gpu_share,
                       (const int*)rdma_req, (const int*)fpga_req, (const float*)units,
                       dev_scoring, 0},
               (cudaStream_t)stream};
  return (int)with_d8(D, Launch{a});
}

extern "C" const char* koord_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
