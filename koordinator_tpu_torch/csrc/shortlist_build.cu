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
// pair) over ~0.55 MB of node tables that stay in L2 — and then the
// selection of K+1 of N keys a pod. Measured on an H100
// (tools/build_phases.py), a build that kept each pod's N keys in shared
// memory and took six radix passes over them, every key through a warp
// vote and a shared-memory atomic, priced in 0.0505 ms, as fast as
// nomination, and selected in 0.0636. A design that priced tiles of 32
// pods over node chunks from staged node rows, as nomination does, had to
// keep each pair's key in shared memory for the chunk's selection; that
// storage held an SM to 16 warps, and its pricing took 0.068 ms.
//
// Design: one block of 512 threads a pod, pricing at the occupancy that
// gives (no [P, N] matrix anywhere); the selection reads most keys once,
// with one compare.
// - Warp w prices a contiguous range of the node axis, 32 nodes a step
//   (loadaware.cuh's pair_cost, so a pair costs here what it costs in
//   nomination and the shortlist round), into an order-preserving 64-bit
//   key: the cost's bits, flipped so that unsigned order is float order,
//   then the node id. The keys are unique, and their order is the
//   (cost, index) order lax.top_k ranks by. Within one call every zero
//   cost has one sign (+0 with the jitter on, -0 without), so bit order
//   and float order agree on ties.
// - A. Each warp keeps the keys of the first S nodes of its range (S = 64
//   at K = 64: 1,024 keys a pod at N = 10,000). A block-wide radix select
//   over their costs (8 bits a pass from the high byte, stopping as soon
//   as one key is left in the bin that holds rank K; the warps count into
//   one histogram, one warp narrows, two barriers a pass) finds the cost
//   of their (K+1)-th; tau is the largest sampled key of that cost: K+1
//   sampled keys are at or below it, so it bounds the pod's (K+1)-th. Each
//   warp keeps its keys of that cost and below.
// - B. The rest of the range: a key joins its warp's buffer only at or
//   below tau — a compare and a ballot a key, ~6% of them at N = 10,000.
//   A buffer that would overflow keeps its own K+1 lowest (a warp's radix
//   select over the whole key), whose largest then tightens tau for every
//   warp (an integer atomicMin in shared memory). Tau is always a key:
//   bits found with the rest set would let a bin's worth of keys in, every
//   infeasible one of a pod that fits few nodes.
// - C. The block-wide select over the buffers gives the (K+1)-th key's
//   cost, the bound. The candidates are the keys below that cost and, of
//   the keys of that cost (one, unless costs tie), the first ones in node
//   order, as the (cost, index) order takes them: the buffers, taken in
//   warp order, are in node order, and each warp writes its own at the
//   offset the warps before it take.
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
constexpr int kWarps = kThreads / 32;
constexpr int kMaxShortlist = 1024;
constexpr int kDigit = 8;  // bits a select pass
constexpr int kBins = 1 << kDigit;

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

__host__ __device__ inline int round32(int x) { return (x + 31) / 32 * 32; }

// Nodes each warp keeps unfiltered (A.): twice K+1 over the block, at
// least 64.
__host__ __device__ inline int sample_of(int K) {
  const int s = round32(2 * ((K + 1 + kWarps - 1) / kWarps));
  return s > 64 ? s : 64;
}

// Keys a warp's buffer holds: the sample, or K+1 kept with a step's 32
// joining them.
__host__ __device__ inline int buffer_of(int K) {
  const int b = round32(K + 1 + 32), s = sample_of(K);
  return b > s ? b : s;
}

struct Args {
  const float *req, *est;
  const bool *is_prod, *cpu_bind;
  Nodes nodes;
  const float* weights;
  int P, N, K, index_bits, B, S;
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

// A radix select's state: the bits of the key sought found so far
// (prefix under mask) and its rank among the keys that share them.
struct Sel {
  uint64_t prefix, mask;
  int rank;
};

// Counts into hist, by their bits lo..lo + 7, the keys of buf[0..cnt)
// whose masked bits equal the prefix: a warp, its lanes with one digit
// adding once.
__device__ __forceinline__ void warp_count(const uint64_t* buf, int cnt, const Sel& s, int lo,
                                           int* hist) {
  const int lane = threadIdx.x & 31;
  for (int j0 = 0; j0 < cnt; j0 += 32) {
    const int j = j0 + lane;
    int digit = -1;
    if (j < cnt) {
      const uint64_t k = buf[j];
      if ((k & s.mask) == s.prefix) digit = (int)((k >> lo) & (kBins - 1));
    }
    const unsigned peers = __match_any_sync(kFull, digit);
    if (digit >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[digit], __popc(peers));
  }
}

// Narrows a select to the bin of hist[kBins] that holds its rank (a warp:
// lane l takes bins 8l..8l+7, read in an order that keeps the lanes on
// distinct banks); returns the keys left in that bin.
__device__ __forceinline__ int warp_narrow(const int* hist, int lo, Sel& s) {
  const int lane = threadIdx.x & 31;
  int local[8];
  int sum = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int b = (i + lane) & 7;
    local[b] = hist[lane * 8 + b];
    sum += local[b];
  }
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += t;
  }
  int b = 0, at = incl - sum;
  const bool hit = at <= s.rank && s.rank < incl;
  if (hit)
    while (s.rank >= at + local[b]) at += local[b++];
  const int src = __ffs(__ballot_sync(kFull, hit)) - 1;
  s.prefix |= (uint64_t)__shfl_sync(kFull, lane * 8 + b, src) << lo;
  s.mask |= (uint64_t)(kBins - 1) << lo;
  s.rank -= __shfl_sync(kFull, at, src);
  return __shfl_sync(kFull, hit ? local[b] : 0, src);
}

// A warp's radix select of the key of rank `rank` in buf[0..cnt), eight
// bits a pass from the top, skipping the id bits at and above id_bits
// (zero in every key), until one key is left in the bin that holds the
// rank (hist: kBins counts of the warp's own). That key is then the one
// whose masked bits equal the prefix; a key whose masked bits are below
// the prefix ranks before it.
__device__ Sel warp_select(const uint64_t* buf, int cnt, int rank, int id_bits, int* hist) {
  const int lane = threadIdx.x & 31;
  Sel s{0, 0, rank};
  for (int lo = 56; lo >= 0; lo -= kDigit) {
    if (lo < 32 && lo >= id_bits) continue;
    for (int b = lane; b < kBins; b += 32) hist[b] = 0;
    __syncwarp();
    warp_count(buf, cnt, s, lo, hist);
    __syncwarp();
    const int left = warp_narrow(hist, lo, s);
    __syncwarp();
    if (left == 1) break;
  }
  return s;
}

// The block-wide select over every warp's buffer (bufs + w * B, cnt[w]
// keys) of the cost of the key of rank `rank`: eight bits a pass over the
// cost's 32 bits, until one key is left in the bin that holds the rank.
// The warps count into one histogram (two in h, the pass's and the next
// one's, cleared side by side) and one warp narrows: two barriers a pass.
// On return the keys whose masked bits equal the prefix are the key
// sought alone, or (the mask over every cost bit) the keys of its cost,
// the key sought the (rank)-th of them in node order; a key whose masked
// bits are below the prefix ranks before it. The whole block calls it.
__device__ Sel block_select(const uint64_t* bufs, int B, const int* cnt, int rank, int* h,
                            Sel* shared) {
  const int tid = threadIdx.x, warp = tid >> 5;
  for (int b = tid; b < 2 * kBins; b += blockDim.x) h[b] = 0;
  Sel s{0, 0, rank};
  if (tid == 0) *shared = s;
  __syncthreads();
  for (int lo = 56, pass = 0; lo >= 32; lo -= kDigit, ++pass) {
    int* hist = h + (pass & 1) * kBins;
    warp_count(bufs + (size_t)warp * B, cnt[warp], s, lo, hist);
    __syncthreads();
    int left = 0;
    if (warp == 0) {
      left = warp_narrow(hist, lo, s);
      if (tid == 0) *shared = s;
    } else if (tid < 32 + kBins) {
      h[((pass + 1) & 1) * kBins + tid - 32] = 0;
    }
    const int done = __syncthreads_or(warp == 0 && left == 1);
    s = *shared;
    if (done) break;
  }
  return s;
}

// Keeps, in order and in place, the keys of buf[0..cnt) whose masked bits
// are at or below the prefix; returns how many, and in `top` (every lane)
// the largest key whose masked bits equal it (0 when none): the key
// selected, or the last of its ties. A warp.
__device__ __forceinline__ int warp_keep(uint64_t* buf, int cnt, const Sel& s, uint64_t& top) {
  const int lane = threadIdx.x & 31;
  int kept = 0;
  top = 0;
  for (int j0 = 0; j0 < cnt; j0 += 32) {
    const int j = j0 + lane;
    const uint64_t k = j < cnt ? buf[j] : UINT64_MAX;
    const uint64_t km = k & s.mask;
    const bool keep = j < cnt && km <= s.prefix;
    if (j < cnt && km == s.prefix && k > top) top = k;
    const unsigned votes = __ballot_sync(kFull, keep);
    if (keep) buf[kept + __popc(votes & ((1u << lane) - 1u))] = k;
    kept += __popc(votes);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const uint64_t o = __shfl_xor_sync(kFull, top, off);
    if (o > top) top = o;
  }
  return kept;
}

// Blocks an SM holds: four for the LoadAware pricing (32 registers a
// thread, a few spilled), whose selects then overlap the other blocks'
// pricing; two (64 registers) with the NUMA or device terms, which spill
// heavily at 32 and leave an SM one block at their own 72-75.
template <int D, bool kNuma, bool kDev>
__global__ void __launch_bounds__(kThreads, kNuma || kDev ? 2 : 4)
    shortlist_build_kernel(const Args a) {
  extern __shared__ uint64_t bufs[];  // [kWarps][B] each warp's kept keys, in node order
  // the block-wide select's two histograms, or each warp's own (B.)
  __shared__ int hists[kWarps * kBins];
  __shared__ int cnt[kWarps], below_of[kWarps], ties_of[kWarps];
  __shared__ Sel sel;
  __shared__ unsigned long long s_top, s_tau;

  const int p = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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
  auto key_at = [&](int n) {
    return key_of(order_of(pair_cost<D, kNuma, kDev>(pod, true, n, a.nodes, w, wsum,
                                                      a.jitter_scale, a.jitter_on != 0,
                                                      &a.zones, zwsum, &a.devs)),
                  n);
  };
  const int span = (N + kWarps - 1) / kWarps;
  const int w0 = min(N, warp * span), w1 = min(N, w0 + span);
  uint64_t* buf = bufs + (size_t)warp * a.B;

  // A. The keys of the first S nodes of each warp's range.
  const int a1 = min(w1, w0 + a.S);
  for (int n = w0 + lane; n < a1; n += 32) buf[n - w0] = key_at(n);
  int c = a1 - w0;
  if (lane == 0) cnt[warp] = c;
  if (tid == 0) s_top = 0, s_tau = UINT64_MAX;
  __syncthreads();
  int sampled = 0;
  for (int v = 0; v < kWarps; ++v) sampled += cnt[v];
  if (sampled > K) {
    // the cost of their (K+1)-th: every key of that cost and below stays,
    // and the largest key of that cost bounds the pod's (K+1)-th
    const Sel s = block_select(bufs, a.B, cnt, K, hists, &sel);
    uint64_t top;
    c = warp_keep(buf, c, s, top);
    if (lane == 0 && top != 0) atomicMax(&s_top, (unsigned long long)top);
    __syncthreads();
    if (tid == 0) s_tau = s_top;
  }
  __syncthreads();
  uint64_t tau = s_tau;

  // B. The rest of the range: a key joins the buffer only at or below tau.
  for (int n0 = a1; n0 < w1; n0 += 32) {
    if (c + 32 > a.B) {
      // the buffer keeps its K+1 lowest, whose largest bounds the pod's
      // (K+1)-th too
      const Sel s = warp_select(buf, c, K, a.index_bits, hists + warp * kBins);
      uint64_t top;
      c = warp_keep(buf, c, s, top);
      if (top < tau) tau = top;
      if (lane == 0) atomicMin(&s_tau, (unsigned long long)tau);
    }
    const uint64_t shared_tau = *(volatile unsigned long long*)&s_tau;
    if (shared_tau < tau) tau = shared_tau;
    const int n = n0 + lane;
    const uint64_t k = n < w1 ? key_at(n) : UINT64_MAX;
    const bool join = k <= tau;
    const unsigned votes = __ballot_sync(kFull, join);
    if (join) buf[c + __popc(votes & ((1u << lane) - 1u))] = k;
    c += __popc(votes);
  }
  if (lane == 0) cnt[warp] = c;
  __syncthreads();

  // C. The cost of the (K+1)-th kept key is the bound; the candidates are
  // the keys below that cost and, of the keys of that cost (one, unless
  // costs tie), the first ones in node order.
  const Sel s = block_select(bufs, a.B, cnt, K, hists, &sel);
  int below = 0, ties = 0;
  for (int j0 = 0; j0 < c; j0 += 32) {
    const int j = j0 + lane;
    const uint64_t km = j < c ? buf[j] & s.mask : UINT64_MAX;
    below += __popc(__ballot_sync(kFull, j < c && km < s.prefix));
    ties += __popc(__ballot_sync(kFull, j < c && km == s.prefix));
  }
  if (lane == 0) below_of[warp] = below, ties_of[warp] = ties;
  __syncthreads();
  // this warp's offset: what the warps before it take, each its keys below
  // and its share of the s.rank first ties
  int at = 0, ties_before = 0;
  for (int v = 0; v < warp; ++v) {
    at += below_of[v] + max(0, min(s.rank - ties_before, ties_of[v]));
    ties_before += ties_of[v];
  }
  const int tie_take = s.rank - ties_before;  // ties this warp takes (when in 0..ties)
  int* out = a.out_cand + (size_t)p * K;
  int tie_at = 0;
  for (int j0 = 0; j0 < c; j0 += 32) {
    const int j = j0 + lane;
    const uint64_t k = j < c ? buf[j] : UINT64_MAX;
    const uint64_t km = k & s.mask;
    const bool tie = j < c && km == s.prefix;
    const unsigned tie_votes = __ballot_sync(kFull, tie);
    const int tie_index = tie_at + __popc(tie_votes & ((1u << lane) - 1u));
    if (tie && tie_index == tie_take) a.out_bound[p] = cost_of(k);
    const bool take = j < c && (km < s.prefix || (tie && tie_index < tie_take));
    const unsigned votes = __ballot_sync(kFull, take);
    if (take) out[at + __popc(votes & ((1u << lane) - 1u))] = (int)(uint32_t)k;
    at += __popc(votes);
    tie_at += __popc(tie_votes);
  }
}

template <int D, bool kNuma, bool kDev>
cudaError_t launch_terms(const Args& a) {
  const size_t smem = (size_t)kWarps * a.B * sizeof(uint64_t);
  // the attribute is set once per size, so a launch captured into a CUDA
  // graph after a warm-up makes no such call
  static size_t configured = 0;
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(shortlist_build_kernel<D, kNuma, kDev>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  shortlist_build_kernel<D, kNuma, kDev><<<a.P, kThreads, smem, a.stream>>>(a);
  return cudaGetLastError();
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
               (const float*)weights, P, N, K, index_bits, buffer_of(K), sample_of(K),
               jitter_scale, jitter_on, (int*)cand, (float*)bound, (const bool*)mask,
               (const long long*)mask_row,
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
