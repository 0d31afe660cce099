// The LoadAware arithmetic of one (pod, node) pair, shared by every kernel
// that prices a pair: the full-axis nomination (nominate.cu), the shortlist
// build (shortlist_build.cu) and the shortlist round (shortlist_round.cu).
// A candidate then prices the same on the full axis and in the shortlist
// by construction, which the reference's decision identity rests on
// (koordinator_tpu/ops/masks.py:109-116, costs.py:72-87).
//
// Port of _feasible (koordinator_tpu/ops/solver.py:625-657), masks.py:20-106
// and their _cols forms (:109-170), costs.py:25-87 and the jitter
// (add_jitter :732-742, add_jitter_cols :744-753). Every float operation is
// written in the reference's order; the sources are compiled with
// -fmad=false and IEEE division, so each gives the reference's bits.

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

// A pod's columns: requests, estimate, prod flag, cpuset binding, its
// half of the jitter hash and its node-mask row (nullptr: no mask).
template <int D>
struct Pod {
  float req[D], est[D];
  bool prod, bind;
  uint32_t hash;
  const bool* mask;

  __device__ __forceinline__ void load(int p, const float* req_, const float* est_,
                                       const bool* is_prod, const bool* cpu_bind) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      req[d] = req_[(size_t)p * D + d];
      est[d] = est_[(size_t)p * D + d];
    }
    prod = is_prod[p];
    bind = cpu_bind[p];
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
// (:896-897, :1070-1071) is one more feasibility term.
template <int D>
__device__ __forceinline__ float pair_cost(const Pod<D>& pod, bool gate, int n, const Nodes& t,
                                           const float (&w)[D], float wsum, float jitter_scale,
                                           bool jitter_on) {
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
  const float c = -score;
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
