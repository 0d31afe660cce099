// The exact sequential-commit solver: one persistent launch walks every pod
// in priority order, prices it over the nodes as they stand after the pods
// before it, and commits its pick before the next pod is priced.
//
// Replaces the lax.scan of koordinator_tpu/ops/solver.py:assign_sequential
// (:1990-2241; the step :2087-2203): the quota admission along the pod's
// chain (:2093-2104), the full-axis step (:2106-2136: fit with amplified
// CPU, usage and prod thresholds, schedulable, the floored LeastAllocated
// score, argmax with the first node winning ties), with shortlist_k the
// gathered step over the pod's K build-time candidates and its exactness
// test (:2138-2183), and the one-row commit to the node tables and the
// chain's quotas (:2186-2199). The build (:2044-2085) is shortlist_build.cu
// with the jitter off (ops/sequential.py), enforce_gangs (:2241) is
// gangs.cu; the scatter back to pod order is a torch op.
//
// What bounds it on an H100: the chain of steps. The arithmetic is P·N
// pairs (~8e8 fp32 operations at P=16,384, N=10,000: 0.012 ms at 67
// TFLOP/s), but step j reads what step j-1 wrote, so the P steps run one
// after another, each at least one block-wide reduction and one barrier.
//
// Design, simple first: one block of 1,024 threads.
// - The node tables stay in device memory and are served from L2 (the
//   three tables the steps write are 240 KB at N=10,000, D=2: more than
//   the 227 KB of shared memory). They are written in place: the wrapper
//   hands the kernel copies.
// - A step prices the nodes with loadaware.cuh's pair_cost, the jitter off
//   (-score, +inf where infeasible), each thread a strided share, so a
//   node costs here what it costs in the build. The full-axis step's fit
//   multiplies only dim 0 by the amplification where the pod is
//   cpuset-bound; pair_cost tests every dim unamplified and dim 0
//   amplified: the same answer, since amp >= 1 and a bound pod asks for
//   CPU > 0.
// - The least (cost, node) of the block is the reference's argmax of the
//   score with the first node winning: a warp reduction, one word a warp
//   in shared memory, then warp 0. Thread 0 commits the winner's row and
//   the chain's quotas (each distinct quota once), then works out the next
//   pod's quota gate; one barrier ends the step. A pod whose gate is shut
//   (invalid, or no headroom) places nowhere and is not priced: on both
//   of the reference's paths its pick is -1 and it is "safe".
// - With shortlist_k each step first prices the pod's K candidates
//   (ascending node ids, so the least (cost, node) is the positional
//   argmax) and broadcasts the least; the step is safe when the build's
//   bound is -inf (complete shortlist) or the best candidate's score
//   beats it strictly. An unsafe step runs the full-axis step in the same
//   launch and counts a fallback (bound, or exhausted when no candidate
//   was feasible). The counts are written at the end.

#include "loadaware.cuh"

namespace {

using namespace koord;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

struct Args {
  // priority-sorted pods: [P, D], [P] flags, quota chains [P, L]
  const float *req, *est;
  const bool *is_prod, *valid, *bind;
  const int* chain;
  // node tables; requested, est_used and prod_used are written in place
  Nodes nodes;
  float *requested, *est_used, *prod_used;
  const float* weights;
  // quotas: runtime and used [Q, D] (Q == 0: no quotas)
  const float* runtime;
  float* qused;
  // the shortlist: candidates [P, K] ascending, the (K+1)-th build score
  // [P] (cand == nullptr: off)
  const int* cand;
  const float* bound;
  int* assigned;   // [P], sorted order
  int* fallbacks;  // [2]: (bound, exhausted)
  int P, N, L, Q, K;
};

// The pod's quota admission (solver.py:2093-2104): every level of its chain
// with a quota (index >= 0, clipped to Q-1) holds used + req <= runtime +
// EPS in every dim.
template <int D>
__device__ bool quota_gate(const Args& a, int j) {
  if (!a.valid[j]) return false;
  if (a.Q == 0) return true;
  const float* rq = a.req + (size_t)j * D;
  for (int l = 0; l < a.L; ++l) {
    const int q = a.chain[(size_t)j * a.L + l];
    if (q < 0) continue;
    const int qi = min(q, a.Q - 1);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const size_t at = (size_t)qi * D + d;
      if (!(a.qused[at] + rq[d] <= a.runtime[at] + kEps)) return false;
    }
  }
  return true;
}

// The charge of a placed pod on its chain (solver.py:2193-2199): each
// distinct quota of the chain once, used + req.
template <int D>
__device__ void quota_charge(const Args& a, int j) {
  const float* rq = a.req + (size_t)j * D;
  const int* ch = a.chain + (size_t)j * a.L;
  for (int l = 0; l < a.L; ++l) {
    if (ch[l] < 0) continue;
    const int qi = min(ch[l], a.Q - 1);
    bool seen = false;
    for (int m = 0; m < l; ++m) seen = seen || (ch[m] >= 0 && min(ch[m], a.Q - 1) == qi);
    if (seen) continue;
#pragma unroll
    for (int d = 0; d < D; ++d) a.qused[(size_t)qi * D + d] += rq[d];
  }
}

// The least (cost, node) of the block into warp 0's lanes; every thread
// passes its own. Lane 0 of warp 0 ends with the block's.
__device__ __forceinline__ void reduce_to_warp0(float& c, int& n, float* s_c, int* s_n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float oc = __shfl_down_sync(kFull, c, off);
    const int on = __shfl_down_sync(kFull, n, off);
    if (less_pair(oc, on, c, n)) {
      c = oc;
      n = on;
    }
  }
  if (lane == 0) {
    s_c[warp] = c;
    s_n[warp] = n;
  }
  __syncthreads();
  if (warp == 0) {
    c = s_c[lane];
    n = s_n[lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float oc = __shfl_down_sync(kFull, c, off);
      const int on = __shfl_down_sync(kFull, n, off);
      if (less_pair(oc, on, c, n)) {
        c = oc;
        n = on;
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) sequential_kernel(const Args a) {
  static_assert(kWarps == 32, "warp 0 reduces one word a warp");
  __shared__ float s_c[kWarps];
  __shared__ int s_n[kWarps];
  __shared__ float s_best_c;
  __shared__ int s_best_n;
  __shared__ bool s_gate[2];  // step j reads [j & 1], thread 0 writes the next

  const int tid = threadIdx.x;
  float w[D];
  const float wsum = weights_sum<D>(a.weights, w);
  int fb_bound = 0, fb_exhausted = 0;
  if (tid == 0 && a.P > 0) s_gate[0] = quota_gate<D>(a, 0);
  __syncthreads();

  for (int j = 0; j < a.P; ++j) {
    const bool gate = s_gate[j & 1];
    float best_c = CUDART_INF_F;
    int best_n = INT32_MAX;
    if (gate) {
      Pod<D> pod;
      pod.load(j, a.req, a.est, a.is_prod, a.bind);
      bool full = true;
      if (a.cand != nullptr) {
        float c = CUDART_INF_F;
        int n = INT32_MAX;
        for (int i = tid; i < a.K; i += kThreads) {
          const int node = a.cand[(size_t)j * a.K + i];
          const float ci = pair_cost<D>(pod, true, node, a.nodes, w, wsum, 0.0f, false);
          if (less_pair(ci, node, c, n)) {
            c = ci;
            n = node;
          }
        }
        reduce_to_warp0(c, n, s_c, s_n);
        if (tid == 0) {
          s_best_c = c;
          s_best_n = n;
        }
        __syncthreads();
        best_c = s_best_c;
        best_n = s_best_n;
        const float bound = a.bound[j];
        // safe: a complete shortlist, or a best score strictly above every
        // excluded node's build score
        full = !(bound == -CUDART_INF_F || -best_c > bound);
        if (tid == 0 && full) {
          if (best_c < CUDART_INF_F) ++fb_bound;
          else ++fb_exhausted;
        }
      }
      if (full) {
        float c = CUDART_INF_F;
        int n = INT32_MAX;
        for (int node = tid; node < a.N; node += kThreads) {
          const float ci = pair_cost<D>(pod, true, node, a.nodes, w, wsum, 0.0f, false);
          if (less_pair(ci, node, c, n)) {
            c = ci;
            n = node;
          }
        }
        reduce_to_warp0(c, n, s_c, s_n);
        best_c = c;
        best_n = n;
      }
      if (tid == 0 && best_c < CUDART_INF_F) {
        const size_t row = (size_t)best_n * D;
        const float amp = pod.bind ? amp_of(a.nodes.cpu_amp[best_n]) : 1.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          a.requested[row + d] += d == 0 ? pod.req[0] * amp : pod.req[d];
          a.est_used[row + d] += pod.est[d];
          if (pod.prod) a.prod_used[row + d] += pod.est[d];
        }
        if (a.Q > 0) quota_charge<D>(a, j);
      }
    }
    if (tid == 0) {
      a.assigned[j] = best_c < CUDART_INF_F ? best_n : -1;
      if (j + 1 < a.P) s_gate[(j + 1) & 1] = quota_gate<D>(a, j + 1);
    }
    __syncthreads();
  }
  if (tid == 0) {
    a.fallbacks[0] = fb_bound;
    a.fallbacks[1] = fb_exhausted;
  }
}

struct Launch {
  const Args& a;
  cudaStream_t stream;
  template <int D>
  cudaError_t run() const {
    sequential_kernel<D><<<1, kThreads, 0, stream>>>(a);
    return cudaGetLastError();
  }
};

}  // namespace

// Pods are priority-sorted: req/est [P, D] float32, is_prod/valid/bind [P]
// bool, chain [P, L] int32 (read only when Q > 0). Node tables [N, D] / [N];
// requested, est_used and prod_used are updated in place; thr/pthr the
// effective [N, D] thresholds. runtime/qused [Q, D] (Q == 0: no quotas;
// qused is updated in place). cand [P, K] int32 ascending and bound [P]
// float32 the shortlist (cand null: off). Writes assigned [P] int32 (-1:
// nowhere) and fallbacks [2] int32. Needs D <= 8.
extern "C" int koord_sequential(
    const void* req, const void* est, const void* is_prod, const void* valid, const void* bind,
    const void* alloc, void* requested, void* est_used, void* prod_used, const void* fresh,
    const void* sched, const void* cpu_amp, const void* thr, const void* pthr,
    const void* weights, int P, int N, int D, const void* chain, int L, const void* runtime,
    void* qused, int Q, const void* cand, const void* bound, int K, void* assigned,
    void* fallbacks, void* stream) {
  if (P < 0 || N < 1 || Q < 0 || (Q > 0 && (L < 1 || chain == nullptr || runtime == nullptr ||
                                              qused == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (cand != nullptr && (K < 1 || K >= N || bound == nullptr)) return (int)cudaErrorInvalidValue;
  const Args a{(const float*)req, (const float*)est, (const bool*)is_prod, (const bool*)valid,
               (const bool*)bind, (const int*)chain,
               Nodes{(const float*)alloc, (const float*)requested, (const float*)est_used,
                     (const float*)prod_used, (const bool*)fresh, (const bool*)sched,
                     (const float*)cpu_amp, (const float*)thr, (const float*)pthr},
               (float*)requested, (float*)est_used, (float*)prod_used, (const float*)weights,
               (const float*)runtime, (float*)qused, (const int*)cand, (const float*)bound,
               (int*)assigned, (int*)fallbacks, P, N, L, Q, K};
  return (int)with_d8(D, Launch{a, (cudaStream_t)stream});
}

extern "C" const char* koord_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
