// The LoadAware arithmetic of one (pod, node) pair, shared by every kernel
// that prices a pair: the full-axis nomination (nominate.cu), the shortlist
// build (shortlist_build.cu) and the shortlist round (shortlist_round.cu).
// A candidate then prices the same on the full axis and in the shortlist
// by construction, which the reference's decision identity rests on
// (koordinator_tpu/ops/masks.py:109-116, costs.py:72-87).
//
// Port of _feasible (koordinator_tpu/ops/solver.py:625-657), masks.py:20-106
// and their _cols forms (:109-170), costs.py:25-87 and the jitter
// (add_jitter :732-742, add_jitter_cols :744-753), and with NUMA zones the
// fit under each node's topology policy (numa.py:numa_fit_mask :77-145,
// ANDed in at solver.py:898-899) and the aligned score
// (costs.py:numa_aligned_cost :212-263, added at solver.py:923-924), both
// read from the zone table as the batch began, and with DeviceShare the
// GPU, RDMA and FPGA fit (device.py:device_fit_mask :73-116 and the
// untracked rules, ANDed in at solver.py:900-919) and the device score
// (costs.py:device_cost :162-211, added at :929-940), both read from the
// round-start stats table (device_prep.cu) and the carried RDMA and FPGA
// counts. Every float operation is written in the reference's order; the
// sources are compiled with -fmad=false and IEEE division, so each gives
// the reference's bits.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace koord {

constexpr float kEps = 1e-3f;   // masks.EPS
constexpr float kSafe = 1e-9f;  // costs._SAFE
constexpr unsigned kFull = 0xFFFFFFFFu;

// (cost, index) order: the order jax.lax.top_k and jnp.argmin give ties.
__device__ __forceinline__ bool less_pair(float va, int ia, float vb, int ib) {
  return va < vb || (va == vb && ia < ib);
}

// Go's math.Round of the utilization percent (masks.usage_percent).
__device__ __forceinline__ float usage_percent(float used, float alloc) {
  float pct = alloc > 0.0f ? used * 100.0f / alloc : 0.0f;
  return floorf(pct + 0.5f);
}

// The room a request is held against: (alloc - requested) + EPS.
__device__ __forceinline__ float free_eps(float alloc, float requested) {
  return (alloc - requested) + kEps;
}

// alloc + _SAFE, the score's denominator.
__device__ __forceinline__ float alloc_safe(float alloc) { return alloc + kSafe; }

// max(cpu_amp, 1): the CPU amplification a cpuset-bound pod is charged.
__device__ __forceinline__ float amp_of(float cpu_amp) { return fmaxf(cpu_amp, 1.0f); }

// One dim's weighted term of the least-used score (costs.py:25-47):
// floor(max(alloc - after, 0) * 100 / (alloc + _SAFE)) * w, 0 when alloc <= 0.
__device__ __forceinline__ float score_term(float alloc, float alloc_s, float after, float w) {
  const float free_d = fmaxf(alloc - after, 0.0f);
  const float per_dim = alloc > 0.0f ? floorf(free_d * 100.0f / alloc_s) : 0.0f;
  return per_dim * w;
}

// jnp.sum(weights) + _SAFE, summed in d order; w receives the weights.
template <int D>
__device__ __forceinline__ float weights_sum(const float* weights, float (&w)[D]) {
  float wsum = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    w[d] = weights[d];
    wsum = wsum + w[d];
  }
  return wsum + kSafe;
}

// _jitter_hash's pod half for the priority-sorted pod position p (uint32 wrap).
__device__ __forceinline__ uint32_t jitter_pod(int p) { return (uint32_t)p * 2654435761u; }

// cost + the 16-bit jitter of (pod, original node id n), in score points.
__device__ __forceinline__ float add_jitter(float cost, uint32_t pod_hash, int n, float scale) {
  const uint32_t h = (pod_hash + (uint32_t)n * 40503u) & 0xFFFFu;
  return cost + (float)h * scale;
}

// A register top-K by (cost, index) with room for C pairs, for a run-time
// K <= C, kept worst first: v[0] holds the K-th best pair, v[K-1] the
// best. Slots K..C-1 hold (-inf, INT32_MIN), which ranks before every pair
// a kernel ranks (costs are finite or +inf), so an inserted pair stops
// below them and the insertion never reads K.
template <int C>
struct TopK {
  float v[C];
  int i[C];

  __device__ __forceinline__ void clear(int K) {
#pragma unroll
    for (int s = 0; s < C; ++s) {
      v[s] = s < K ? CUDART_INF_F : -CUDART_INF_F;
      i[s] = s < K ? INT32_MAX : INT32_MIN;
    }
  }

  // (cv, ci) replaces the K-th best if it ranks before it, then moves up.
  __device__ __forceinline__ void insert(float cv, int ci) {
    if (!less_pair(cv, ci, v[0], i[0])) return;
    v[0] = cv;
    i[0] = ci;
#pragma unroll
    for (int s = 0; s + 1 < C; ++s) {
      if (less_pair(v[s], i[s], v[s + 1], i[s + 1])) {
        const float tv = v[s];
        v[s] = v[s + 1];
        v[s + 1] = tv;
        const int ti = i[s];
        i[s] = i[s + 1];
        i[s + 1] = ti;
      }
    }
  }
};

// Writes the pair of rank r (0 = best) of a top-K into the round's
// nomination vector: the top-K itself, or with approx_topk
// [best, best, 2nd, ..., (K-1)th] (solver.py:1147-1153, :1165-1176).
__device__ __forceinline__ void put_ranked(float* oc, int* oi, int r, int K, bool approx,
                                           float v, int i) {
  const int at = approx ? r + 1 : r;
  if (at < K) {
    oc[at] = v;
    oi[at] = i;
  }
  if (approx && r == 0) {
    oc[0] = v;
    oi[0] = i;
  }
}

// The node tables a pair is priced from: [N, D] row-major tables and [N]
// flags; thr/pthr are the effective usage and prod thresholds.
struct Nodes {
  const float *alloc, *requested, *est_used, *prod_used;
  const bool *fresh, *sched;
  const float *cpu_amp, *thr, *pthr;
};

// The row of the node mask (the pods' hard node constraints: [M, N] bool)
// sorted pod p reads: row rows[p], or none (every node allowed) without a
// mask. A stream's stacked [C, P, N] mask is read in place through rows
// that already hold the chunk's offset.
__device__ __forceinline__ const bool* mask_row_of(const bool* mask, const long long* rows,
                                                   int p, int N) {
  return mask == nullptr ? nullptr : mask + rows[p] * (long long)N;
}

// The NUMA zones a pair is priced from: the zone table as the batch began
// (a snapshot the round tail never writes) and the capacities, [N, Z, DN]
// each, the nodes' side table (below), the priority-sorted pods'
// SingleNUMANode `required` flags [P], and the aligned score's strategy
// (0 off, 1 LeastAllocated, 2 MostAllocated). Z <= kMaxZones, DN <=
// kMaxZoneDims and DN <= D: the zone dims are the prefix of the resource
// axis.
constexpr int kMaxZones = 8;
constexpr int kMaxZoneDims = 4;
constexpr int kPolicySingleNuma = 3;  // numa.POLICY_SINGLE_NUMA_NODE

// What the pairs of one node share, worked out once a batch from the
// snapshot (zone_prep.cu): a row of 1 + DN + Z words a node — the bits
// below, then the zones' free totals [DN] (added in zone order, as
// jnp.sum lowers on the CPU) and each zone's (cap0 - free0 + 1) /
// (cap0 + 1) [Z] (the aligned score's key), as float bits.
constexpr uint32_t kSideDimOn = 1u;         // bit d < DN: some zone reports dim d
constexpr uint32_t kSideHasZones = 1u << 4; // a zone whose capacities sum > 0
constexpr uint32_t kSideSingle = 1u << 5;   // SINGLE_NUMA_NODE policy
constexpr int kSideReal = 8;                // bit 8 + z: zone z has some capacity

__host__ __device__ inline int side_words(int Z, int DN) { return 1 + DN + Z; }

struct Zones {
  const float *free, *cap;
  const uint32_t* side;
  const bool* required;
  int Z, DN, scoring;
};

// numa_fit_mask for one pair (numa.py:77-145): the request of a pod that
// wants alignment (cpuset-bound or required) amplified as the reference
// writes it, req * (1 + wants * (max(amp, 1) - 1)) on the CPU dim and
// req * (1 + wants * (1 - 1)) on the others; a dim no zone of the node
// reports is not checked; a strict pair (SINGLE_NUMA_NODE node, or a
// required pod) needs one zone that holds the request, another pair that
// wants alignment the sum of the zones; a node with no zone capacity fits
// every pod. The node's terms come from its side row.
template <int D>
__device__ __forceinline__ bool numa_fit(const float (&req)[D], bool bind, bool required,
                                         float cpu_amp, int n, const Zones& z) {
  const uint32_t* sd = z.side + (size_t)n * side_words(z.Z, z.DN);
  const uint32_t info = sd[0];
  if (!(info & kSideHasZones)) return true;
  const bool wants = bind || required;
  const float wf = wants ? 1.0f : 0.0f;
  const float amp = fmaxf(cpu_amp, 1.0f);
  const float* fr = z.free + (size_t)n * z.Z * z.DN;
  float re[kMaxZoneDims];
  constexpr int DZ = D < kMaxZoneDims ? D : kMaxZoneDims;
#pragma unroll
  for (int d = 0; d < DZ; ++d) {
    if (d >= z.DN) break;
    const float scale = d == 0 ? amp : 1.0f;
    re[d] = req[d] * (1.0f + wf * (scale - 1.0f));
  }
  if ((info & kSideSingle) || required) {
    for (int q = 0; q < z.Z; ++q) {
      bool fit = true;
#pragma unroll
      for (int d = 0; d < DZ; ++d) {
        if (d >= z.DN) break;
        fit = fit && (re[d] <= fr[q * z.DN + d] + kEps || !((info >> d) & kSideDimOn));
      }
      if (fit) return true;
    }
    return false;
  }
  if (!wants) return true;
  bool total_fit = true;
#pragma unroll
  for (int d = 0; d < DZ; ++d) {
    if (d >= z.DN) break;
    total_fit = total_fit &&
                (re[d] <= __uint_as_float(sd[1 + d]) + kEps || !((info >> d) & kSideDimOn));
  }
  return total_fit;
}

// numa_aligned_cost for one pair (costs.py:212-263): the pod's request
// (not amplified) goes into the fitting zone of least (used0 + 1) /
// (cap0 + 1) (the side row's key), the first on ties; the node scores on
// that zone with the integer-floor per-dim score (Least- or
// MostAllocated), 0 where a dim is over capacity or has none, weighted by
// the first DN weights (zwsum = their sum + _SAFE). Returns the cost term
// -score, -0 where the pod does not want alignment or no zone fits.
template <int D>
__device__ __forceinline__ float numa_score(const float (&req)[D], bool bind, bool required,
                                            int n, const Zones& z, const float (&w)[D],
                                            float zwsum) {
  if (!(bind || required)) return -0.0f;
  constexpr int DZ = D < kMaxZoneDims ? D : kMaxZoneDims;
  const uint32_t* sd = z.side + (size_t)n * side_words(z.Z, z.DN);
  const uint32_t info = sd[0];
  const float* fr = z.free + (size_t)n * z.Z * z.DN;
  const float* cp = z.cap + (size_t)n * z.Z * z.DN;
  int best = -1;
  float best_key = CUDART_INF_F;
  for (int q = 0; q < z.Z; ++q) {
    if (!((info >> (kSideReal + q)) & 1u)) continue;
    bool fit = true;
#pragma unroll
    for (int d = 0; d < DZ; ++d) {
      if (d >= z.DN) break;
      fit = fit && req[d] <= fr[q * z.DN + d] + 1e-6f;
    }
    if (!fit) continue;
    const float util = __uint_as_float(sd[1 + z.DN + q]);
    if (best < 0 || util < best_key) {
      best = q;
      best_key = util;
    }
  }
  if (best < 0) return -0.0f;
  float total = 0.0f;
#pragma unroll
  for (int d = 0; d < DZ; ++d) {
    if (d >= z.DN) break;
    const float cap = cp[best * z.DN + d];
    const float after = (cap - fr[best * z.DN + d]) + req[d];
    const float raw = z.scoring == 2 ? floorf(after * 100.0f / (cap + kSafe))
                                     : floorf((cap - after) * 100.0f / (cap + kSafe));
    const float per_dim = cap > 0.0f && after <= cap + 1e-6f ? raw : 0.0f;
    const float term = per_dim * w[d];
    total = d == 0 ? term : total + term;
  }
  return -floorf(total / zwsum);
}

// jnp.sum(weights[:DN]) + _SAFE, summed in d order: the aligned score's
// denominator.
template <int D>
__device__ __forceinline__ float zone_weights_sum(const float (&w)[D], int DN) {
  float s = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d)
    if (d < DN) s = d == 0 ? w[d] : s + w[d];
  return s + kSafe;
}

// The devices a pair is priced from: the round-start stats table [N, 4]
// (full count, best partial, largest slot, free total: device_prep.cu,
// refreshed by the round tail), the free RDMA and FPGA counts [N] (nullptr:
// not tracked, and a pod asking for one is refused), the capacities
// cap_total [N] (the score's), the priority-sorted pods' whole GPUs,
// share, RDMA, FPGA and units (whole * 100 + share) [P], the score's
// strategy (0 off, 1 LeastAllocated, 2 MostAllocated) and `clamp`, the
// build's min(term, 0) (solver.py:939-940).
struct Devices {
  const float* stats;
  const float *rdma, *fpga, *cap;
  const int* whole;
  const float* share;
  const int *rdma_req, *fpga_req;
  const float* units;
  int scoring, clamp;
};

// One pod's device demand, in registers.
struct DevPod {
  int whole, rdma, fpga;
  float share, units;

  __device__ __forceinline__ void load(int p, const Devices& v) {
    whole = v.whole[p];
    share = v.share[p];
    rdma = v.rdma_req[p];
    fpga = v.fpga_req[p];
    units = v.units[p];
  }
};

// device_fit_mask for one pair (device.py:73-116, with the slot maximum
// given): the whole GPUs against the full slots; a share against the
// largest slot; whole+share one more full slot or a partial slot that
// holds the share; RDMA and FPGA against the free counts where tracked,
// and refused where a pod asks for an untracked kind (solver.py:916-919).
__device__ __forceinline__ bool device_fit(const DevPod& q, int n, const Devices& v) {
  const float* st = v.stats + (size_t)n * 4;
  const float full = st[0], partial = st[1], smax = st[2];
  const float wf = (float)q.whole;
  const bool whole_ok = wf <= full + kEps;
  const bool frac_ok = q.share <= smax + kEps || q.share <= kEps;
  const bool both = q.whole > 0 && q.share > kEps;
  const bool both_ok = wf + 1.0f <= full + kEps || q.share <= partial + kEps;
  bool ok = whole_ok && (both ? both_ok : frac_ok);
  ok = ok && (v.rdma != nullptr ? (float)q.rdma <= v.rdma[n] + kEps : q.rdma == 0);
  ok = ok && (v.fpga != nullptr ? (float)q.fpga <= v.fpga[n] + kEps : q.fpga == 0);
  return ok;
}

// device_cost for one pair (costs.py:162-211): the integer-floor score of
// the GPU capacity used after the pod (MostAllocated) or left
// (LeastAllocated), 0 where the node has no GPU, the pod would overflow it
// or asks for none; returns -score, with `clamp` min(-score, 0) as
// jnp.minimum gives it (the first operand on equal zeros).
__device__ __forceinline__ float device_score(const DevPod& q, int n, const Devices& v) {
  const float free = v.stats[(size_t)n * 4 + 3];
  const float cap = v.cap[n];
  const float used_after = (cap - free) + q.units;
  const float raw = v.scoring == 2 ? floorf(used_after * 100.0f / (cap + kSafe))
                                   : floorf((cap - used_after) * 100.0f / (cap + kSafe));
  float score = cap > 0.0f && used_after <= cap + 1e-6f ? raw : 0.0f;
  score = q.units > 0.0f ? score : 0.0f;
  const float term = -score;
  return v.clamp && term > 0.0f ? 0.0f : term;
}

// A pod's columns: requests, estimate, prod flag, cpuset binding, its
// half of the jitter hash and its node-mask row (nullptr: no mask); with
// NUMA zones its `required` flag; with devices its demand.
template <int D>
struct Pod {
  float req[D], est[D];
  bool prod, bind, required;
  uint32_t hash;
  const bool* mask;
  DevPod dev;

  __device__ __forceinline__ void load(int p, const float* req_, const float* est_,
                                       const bool* is_prod, const bool* cpu_bind) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      req[d] = req_[(size_t)p * D + d];
      est[d] = est_[(size_t)p * D + d];
    }
    prod = is_prod[p];
    bind = cpu_bind[p];
    required = false;
    hash = jitter_pod(p);
    mask = nullptr;
  }
};

// The masked, jittered LoadAware cost of `pod` on node n, +inf where the
// pair is infeasible (full_feas_cost :864-947 and shortlist_feas_cost
// :1017-1086 for one pair): schedulable and the pod gate, fit, amplified
// CPU fit for cpuset-bound pods, usage and prod thresholds on nodes with a
// fresh metric, then the integer-floor score (0 on a stale node), negated,
// plus the jitter keyed on the node's original id. The node mask
// (:896-897, :1070-1071) is one more feasibility term, and with kNuma the
// NUMA fit (:898-899, :1072-1073) another, the aligned score (zwsum its
// denominator) added to the cost before the jitter (:923-924, :1076-1077);
// with kDev the device fit another (:900-919, :1052-1068), its score added
// after the NUMA one (:929-940, :1078-1084).
template <int D, bool kNuma = false, bool kDev = false>
__device__ __forceinline__ float pair_cost(const Pod<D>& pod, bool gate, int n, const Nodes& t,
                                           const float (&w)[D], float wsum, float jitter_scale,
                                           bool jitter_on, const Zones* zones = nullptr,
                                           float zwsum = 0.0f, const Devices* dev = nullptr) {
  const bool fresh = t.fresh[n];
  bool feas = gate && t.sched[n] && (pod.mask == nullptr || pod.mask[n]);
  float a[D], fe[D], after[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const size_t at = (size_t)n * D + d;
    a[d] = t.alloc[at];
    fe[d] = free_eps(a[d], t.requested[at]);
    feas = feas & (pod.req[d] <= fe[d]);
    after[d] = t.est_used[at] + pod.est[d];
  }
  feas = feas & (!pod.bind | (pod.req[0] * amp_of(t.cpu_amp[n]) <= fe[0]));
  if (!feas) return CUDART_INF_F;
  if constexpr (kNuma) {
    if (!numa_fit<D>(pod.req, pod.bind, pod.required, t.cpu_amp[n], n, *zones))
      return CUDART_INF_F;
  }
  if constexpr (kDev) {
    if (!device_fit(pod.dev, n, *dev)) return CUDART_INF_F;
  }
  float score = 0.0f;
  if (fresh) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float thr = t.thr[(size_t)n * D + d];
      if (thr > 0.0f && usage_percent(after[d], a[d]) > thr) return CUDART_INF_F;
    }
    if (pod.prod) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const size_t at = (size_t)n * D + d;
        const float thr = t.pthr[at];
        if (thr > 0.0f && usage_percent(t.prod_used[at] + pod.est[d], a[d]) > thr)
          return CUDART_INF_F;
      }
    }
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
    if (zones->scoring != 0)
      c = c + numa_score<D>(pod.req, pod.bind, pod.required, n, *zones, w, zwsum);
  }
  if constexpr (kDev) {
    if (dev->scoring != 0) c = c + device_score(pod.dev, n, *dev);
  }
  return jitter_on ? add_jitter(c, pod.hash, n, jitter_scale) : c;
}

// op.template run<D>() for a run-time D in 1..8: the loops over dims unroll.
template <class Op>
cudaError_t with_d8(int D, const Op& op) {
  switch (D) {
    case 1: return op.template run<1>();
    case 2: return op.template run<2>();
    case 3: return op.template run<3>();
    case 4: return op.template run<4>();
    case 5: return op.template run<5>();
    case 6: return op.template run<6>();
    case 7: return op.template run<7>();
    case 8: return op.template run<8>();
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace koord
