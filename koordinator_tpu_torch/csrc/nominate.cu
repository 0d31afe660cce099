// Fused LoadAware nomination: masked, jittered cost of every (pod, node)
// pair and each pod's K lowest (cost, node) pairs.
//
// Replaces koordinator_tpu/ops/solver.py:_full_nominate (:1121-1156) with
// full_feas_cost (:864-947), _feasible (:625-657), masks.py:30-106,
// costs.py:25-69 and add_jitter (:732-742) — the work of the Pallas
// nomination kernel the JAX package once had (solver.py:34-43), which XLA
// fused into one program on the TPU.
//
// What bounds it on an H100: arithmetic. Per pair it does ~40 fp32
// operations, three of them IEEE divisions, over node tables of ~55 bytes a
// node that stay in L2 (10k nodes ≈ 0.55 MB). At P=512, N=10,000 that is
// ~2e8 operations against ~0.6 MB of traffic, so the fp32 rate, not memory,
// sets the floor.
//
// Design: one block per pod row. Threads stride over the node axis, so
// neighbouring threads read neighbouring node rows; each keeps a register
// top-K ordered by (cost, node index). A shared-memory tree merge then
// reduces the block's lists to one. No atomics, no [P, N] buffer.
//
// Bit-exactness with the reference: every float operation is written in
// the reference's order, division is IEEE `/` and the file is compiled
// with -fmad=false so no a*b+c is contracted into an FMA. Ties of cost go
// to the lower node index, as jax.lax.top_k and jnp.argmin break them.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDims = 16;
constexpr float kEps = 1e-3f;   // masks.EPS
constexpr float kSafe = 1e-9f;  // costs._SAFE

__device__ __forceinline__ bool less_pair(float va, int ia, float vb, int ib) {
  return va < vb || (va == vb && ia < ib);
}

// Go's math.Round of the utilization percent (masks.usage_percent).
__device__ __forceinline__ float usage_percent(float used, float alloc) {
  float pct = alloc > 0.0f ? used * 100.0f / alloc : 0.0f;
  return floorf(pct + 0.5f);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
nominate_kernel(const float* __restrict__ req, const float* __restrict__ est,
                const bool* __restrict__ is_prod,
                const bool* __restrict__ cpu_bind,
                const bool* __restrict__ gate,
                const float* __restrict__ alloc,
                const float* __restrict__ requested,
                const float* __restrict__ est_used,
                const float* __restrict__ prod_used,
                const bool* __restrict__ fresh,
                const bool* __restrict__ sched,
                const float* __restrict__ cpu_amp,
                const float* __restrict__ thr,
                const float* __restrict__ pthr,
                const float* __restrict__ weights, int N, int D,
                float jitter_scale, int jitter_on,
                float* __restrict__ out_cost, int* __restrict__ out_idx) {
  __shared__ float s_req[kMaxDims];
  __shared__ float s_est[kMaxDims];
  __shared__ float s_w[kMaxDims];
  __shared__ float s_val[kThreads * K];
  __shared__ int s_idx[kThreads * K];

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < D) {
    s_req[tid] = req[p * D + tid];
    s_est[tid] = est[p * D + tid];
    s_w[tid] = weights[tid];
  }
  __syncthreads();

  const bool pod_gate = gate[p];
  const bool pod_bind = cpu_bind[p];
  const bool pod_prod = is_prod[p];
  // jnp.sum(weights) + _SAFE, summed in d order
  float wsum = 0.0f;
  for (int d = 0; d < D; ++d) wsum = wsum + s_w[d];
  wsum = wsum + kSafe;

  float best_v[K];
  int best_i[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    best_v[j] = CUDART_INF_F;
    best_i[j] = INT32_MAX;
  }

  for (int n = tid; n < N; n += kThreads) {
    const float* a_row = alloc + (size_t)n * D;
    const float* r_row = requested + (size_t)n * D;
    const float* e_row = est_used + (size_t)n * D;
    const float* pr_row = prod_used + (size_t)n * D;
    const float* t_row = thr + (size_t)n * D;
    const float* pt_row = pthr + (size_t)n * D;
    const bool node_fresh = fresh[n];

    // _feasible: fit, amplified-CPU fit, usage and prod thresholds,
    // schedulable, pod gate
    bool feas = pod_gate && sched[n];
    for (int d = 0; d < D; ++d) {
      float free_d = a_row[d] - r_row[d];
      feas = feas && (s_req[d] <= free_d + kEps);
    }
    if (pod_bind) {
      float amp = fmaxf(cpu_amp[n], 1.0f);
      float eff_cpu = s_req[0] * amp;
      float free0 = a_row[0] - r_row[0];
      feas = feas && (eff_cpu <= free0 + kEps);
    }
    if (node_fresh) {
      for (int d = 0; d < D; ++d) {
        float t = t_row[d];
        float pct = usage_percent(e_row[d] + s_est[d], a_row[d]);
        feas = feas && !(t > 0.0f && pct > t);
      }
      if (pod_prod) {
        for (int d = 0; d < D; ++d) {
          float t = pt_row[d];
          float pct = usage_percent(pr_row[d] + s_est[d], a_row[d]);
          feas = feas && !(t > 0.0f && pct > t);
        }
      }
    }
    if (!feas) {
      // +inf cost: still ranked, by index, as top_k ranks -inf entries
      if (less_pair(CUDART_INF_F, n, best_v[K - 1], best_i[K - 1])) {
        best_v[K - 1] = CUDART_INF_F;
        best_i[K - 1] = n;
      } else {
        continue;
      }
    } else {
      // load_aware_cost: integer-floor least-used score, 0 when stale
      float score = 0.0f;
      if (node_fresh) {
        float total = 0.0f;
        for (int d = 0; d < D; ++d) {
          float a = a_row[d];
          float after = e_row[d] + s_est[d];
          float free_d = fmaxf(a - after, 0.0f);
          float per_dim = a > 0.0f ? floorf(free_d * 100.0f / (a + kSafe)) : 0.0f;
          float term = per_dim * s_w[d];
          total = d == 0 ? term : total + term;
        }
        score = floorf(total / wsum);
      }
      float cost = -score;
      if (jitter_on) {
        // _jitter_hash on the priority-sorted pod position, uint32 wrap
        uint32_t h = ((uint32_t)p * 2654435761u + (uint32_t)n * 40503u) & 0xFFFFu;
        cost = cost + (float)h * jitter_scale;
      }
      if (!less_pair(cost, n, best_v[K - 1], best_i[K - 1])) continue;
      best_v[K - 1] = cost;
      best_i[K - 1] = n;
    }
#pragma unroll
    for (int j = K - 1; j > 0; --j) {
      if (less_pair(best_v[j], best_i[j], best_v[j - 1], best_i[j - 1])) {
        float tv = best_v[j];
        best_v[j] = best_v[j - 1];
        best_v[j - 1] = tv;
        int ti = best_i[j];
        best_i[j] = best_i[j - 1];
        best_i[j - 1] = ti;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < K; ++j) {
    s_val[tid * K + j] = best_v[j];
    s_idx[tid * K + j] = best_i[j];
  }
  __syncthreads();

  // tree merge of sorted K-lists: list tid absorbs list tid + s
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
      const int A = tid * K;
      const int B = (tid + s) * K;
      float mv[K];
      int mi[K];
      int a = 0, b = 0;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        // a + b == j < K, so both cursors stay in range
        float va = s_val[A + a], vb = s_val[B + b];
        int ia = s_idx[A + a], ib = s_idx[B + b];
        if (less_pair(va, ia, vb, ib)) {
          mv[j] = va;
          mi[j] = ia;
          ++a;
        } else {
          mv[j] = vb;
          mi[j] = ib;
          ++b;
        }
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        s_val[A + j] = mv[j];
        s_idx[A + j] = mi[j];
      }
    }
    __syncthreads();
  }
  if (tid < K) {
    out_cost[p * K + tid] = s_val[tid];
    out_idx[p * K + tid] = s_idx[tid];
  }
}

template <int K>
cudaError_t launch(const float* req, const float* est, const bool* is_prod,
                   const bool* cpu_bind, const bool* gate, const float* alloc,
                   const float* requested, const float* est_used,
                   const float* prod_used, const bool* fresh,
                   const bool* sched, const float* cpu_amp, const float* thr,
                   const float* pthr, const float* weights, int P, int N,
                   int D, float jitter_scale, int jitter_on, float* out_cost,
                   int* out_idx, cudaStream_t stream) {
  nominate_kernel<K><<<P, kThreads, 0, stream>>>(
      req, est, is_prod, cpu_bind, gate, alloc, requested, est_used,
      prod_used, fresh, sched, cpu_amp, thr, pthr, weights, N, D,
      jitter_scale, jitter_on, out_cost, out_idx);
  return cudaGetLastError();
}

}  // namespace

extern "C" int koord_nominate(
    const void* req, const void* est, const void* is_prod,
    const void* cpu_bind, const void* gate, const void* alloc,
    const void* requested, const void* est_used, const void* prod_used,
    const void* fresh, const void* sched, const void* cpu_amp,
    const void* thr, const void* pthr, const void* weights, int P, int N,
    int D, int K, float jitter_scale, int jitter_on, void* out_cost,
    void* out_idx, void* stream) {
  if (P <= 0) return (int)cudaSuccess;
  if (D < 1 || D > kMaxDims || N < 1) return (int)cudaErrorInvalidValue;
#define KOORD_NOMINATE_CASE(KK)                                              \
  case KK:                                                                   \
    return (int)launch<KK>(                                                  \
        (const float*)req, (const float*)est, (const bool*)is_prod,          \
        (const bool*)cpu_bind, (const bool*)gate, (const float*)alloc,       \
        (const float*)requested, (const float*)est_used,                     \
        (const float*)prod_used, (const bool*)fresh, (const bool*)sched,     \
        (const float*)cpu_amp, (const float*)thr, (const float*)pthr,        \
        (const float*)weights, P, N, D, jitter_scale, jitter_on,             \
        (float*)out_cost, (int*)out_idx, (cudaStream_t)stream);
  switch (K) {
    KOORD_NOMINATE_CASE(1)
    KOORD_NOMINATE_CASE(2)
    KOORD_NOMINATE_CASE(3)
    KOORD_NOMINATE_CASE(4)
    KOORD_NOMINATE_CASE(5)
    KOORD_NOMINATE_CASE(6)
    KOORD_NOMINATE_CASE(7)
    KOORD_NOMINATE_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef KOORD_NOMINATE_CASE
}

extern "C" const char* koord_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
