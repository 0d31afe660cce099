// Segmented commit of one solver round, and an ordered segment sum.
//
// koord_commit replaces the LoadAware commit block of
// koordinator_tpu/ops/solver.py:assign (:1204-1385): given the pods of one
// round stably sorted by nominated node, it takes the segmented prefix sums
// of request, estimate and prod estimate, runs the acceptance tests (fit,
// rounded-percent usage and prod thresholds, spread quantum) and adds the
// winners' charges to the node tables in place.
//
// koord_segment_sum replaces the jax.ops.segment_sum refunds of
// enforce_gangs (:1858-1987): an ordered sum over rows already sorted by
// segment, one sequential sum per segment.
//
// What bounds them on an H100: neither has enough work to fill the card
// (one round is 512 rows × 2 dims; the bytes needed are a few tens of KB).
// They are latency-bound: the commit's floor is the sequential walk over
// the round's rows.
//
// Design: determinism and the reference's rounding come first. The
// reference computes a segment's inclusive prefix as a global cumsum minus
// the cumsum just before the segment start (_segment_prefix_sums,
// :574-584); a per-segment restart would round differently. The global
// cumsum is taken in the order XLA's CPU backend sums it (block_cumsum:
// sequential chunks of 16, chunk totals scanned recursively), in shared
// memory. Every row then tests its acceptance in parallel, and one thread
// per segment adds its winners' charges to the table row by row. No float
// atomics. Compiled with -fmad=false so `quantum * alloc + EPS` rounds
// twice, as the reference does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCommitThreads = 1024;
constexpr int kMaxDims = 8;
constexpr float kEps = 1e-3f;  // masks.EPS

__device__ __forceinline__ float usage_percent(float used, float alloc) {
  float pct = alloc > 0.0f ? used * 100.0f / alloc : 0.0f;
  return floorf(pct + 0.5f);
}

// The reference's cumsum order. XLA on the CPU rewrites a cumulative sum
// of length m > 16 into chunks of 16: a sequential sum inside each chunk,
// the chunk totals scanned the same way (recursively), and each chunk then
// offset by the scanned total of the chunks before it. Level l of a series
// holds the chunk totals of level l-1; kScanBase is that chunk length.
constexpr int kScanBase = 16;
constexpr int kMaxLevels = 8;

struct ScanLevels {
  int n;                   // levels above the base array
  int len[kMaxLevels];
  int off[kMaxLevels];
  int total;               // floats per series
};

__host__ __device__ inline ScanLevels scan_levels(int P) {
  ScanLevels lv;
  lv.n = 0;
  lv.len[0] = P;
  lv.off[0] = 0;
  while (lv.len[lv.n] > kScanBase && lv.n + 1 < kMaxLevels) {
    lv.off[lv.n + 1] = lv.off[lv.n] + lv.len[lv.n];
    lv.len[lv.n + 1] = (lv.len[lv.n] + kScanBase - 1) / kScanBase;
    ++lv.n;
  }
  lv.total = lv.off[lv.n] + lv.len[lv.n];
  return lv;
}

// In-place inclusive cumsum of S series of length P held at
// sm[s * lv.total + i], in the reference's order. The whole block calls it.
__device__ void block_cumsum(float* sm, int S, const ScanLevels& lv) {
  const int tid = threadIdx.x;
  for (int l = 0; l < lv.n; ++l) {
    const int chunks = lv.len[l + 1];
    for (int w = tid; w < S * chunks; w += blockDim.x) {
      const int s = w / chunks, c = w % chunks;
      float* L = sm + s * lv.total + lv.off[l];
      const int beg = c * kScanBase;
      const int end = min(beg + kScanBase, lv.len[l]);
      float acc = L[beg];
      for (int i = beg + 1; i < end; ++i) {
        acc = acc + L[i];
        L[i] = acc;
      }
      sm[s * lv.total + lv.off[l + 1] + c] = acc;
    }
    __syncthreads();
  }
  for (int s = tid; s < S; s += blockDim.x) {
    float* L = sm + s * lv.total + lv.off[lv.n];
    float acc = L[0];
    for (int i = 1; i < lv.len[lv.n]; ++i) {
      acc = acc + L[i];
      L[i] = acc;
    }
  }
  __syncthreads();
  for (int l = lv.n - 1; l >= 0; --l) {
    const int len = lv.len[l];
    for (int w = tid; w < S * len; w += blockDim.x) {
      const int s = w / len, e = w % len, c = e / kScanBase;
      if (c > 0) {
        float* base = sm + s * lv.total;
        base[lv.off[l] + e] = base[lv.off[l] + e] + base[lv.off[l + 1] + c - 1];
      }
    }
    __syncthreads();
  }
}

// Shared layout: 3*D scan series (request, estimate, prod estimate; series
// q*D + d) of lv.total floats each, then snode[P], seg_start[P], accept[P].
__global__ void __launch_bounds__(kCommitThreads)
commit_kernel(const int* __restrict__ snode, const float* __restrict__ sreq,
              const float* __restrict__ sest, const bool* __restrict__ sprod,
              const float* __restrict__ alloc, const bool* __restrict__ fresh,
              const float* __restrict__ thr, const float* __restrict__ pthr,
              float* __restrict__ requested, float* __restrict__ est_used,
              float* __restrict__ prod_used, float round_quantum, int P,
              int N, int D, bool* __restrict__ accept_out) {
  extern __shared__ float smem[];
  const ScanLevels lv = scan_levels(P);
  const int S = 3 * D;
  float* cums = smem;                                  // [S, lv.total]
  int* s_node = (int*)(cums + S * lv.total);           // [P]
  int* s_start = s_node + P;                           // [P]
  int* s_acc = s_start + P;                            // [P]
  const int tid = threadIdx.x;

  for (int i = tid; i < P; i += blockDim.x) s_node[i] = snode[i];
  for (int e = tid; e < P * D; e += blockDim.x) {
    const int i = e / D, d = e % D;
    cums[(0 * D + d) * lv.total + i] = sreq[e];
    cums[(1 * D + d) * lv.total + i] = sest[e];
    cums[(2 * D + d) * lv.total + i] = sprod[i] ? sest[e] : 0.0f;
  }
  __syncthreads();
  // each row's segment start (jax.lax.cummax of start positions)
  if (tid == 0) {
    int start = 0;
    s_start[0] = 0;
    for (int i = 1; i < P; ++i) {
      if (s_node[i] != s_node[i - 1]) start = i;
      s_start[i] = start;
    }
  }
  block_cumsum(cums, S, lv);

  // Acceptance, every row at once, against the round-start tables.
  for (int i = tid; i < P; i += blockDim.x) {
    const int node = s_node[i];
    bool acc = node >= 0 && node < N;
    if (acc) {
      const int st = s_start[i];
      const bool node_fresh = fresh[node];
      const bool prod = sprod[i];
      bool over = false, pover = false;
      for (int d = 0; d < D; ++d) {
        const float a = alloc[node * D + d];
        float seg[3];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float* c = cums + (q * D + d) * lv.total;
          seg[q] = st > 0 ? c[i] - c[st - 1] : c[i] - 0.0f;
        }
        acc = acc && (requested[node * D + d] + seg[0] <= a + kEps);
        const float t = thr[node * D + d];
        over = over || (t > 0.0f && usage_percent(est_used[node * D + d] + seg[1], a) > t);
        const float pt = pthr[node * D + d];
        pover = pover || (pt > 0.0f && usage_percent(prod_used[node * D + d] + seg[2], a) > pt);
        const float prior_est = seg[1] - sest[i * D + d];
        acc = acc && (a <= 0.0f || prior_est <= round_quantum * a + kEps);
      }
      acc = acc && !(node_fresh && over);
      acc = acc && !(prod && node_fresh && pover);
    }
    s_acc[i] = acc ? 1 : 0;
    accept_out[i] = acc;
  }
  __syncthreads();

  // Winners' charges, one thread per segment, added to the table row by
  // row in sorted order: XLA folds the reference's
  // `table + segment_sum(...)` into a scatter-add onto the table itself.
  for (int i = tid; i < P; i += blockDim.x) {
    const int node = s_node[i];
    if (node < 0 || node >= N || (i > 0 && s_node[i - 1] == node)) continue;
    for (int d = 0; d < D; ++d) {
      float r = requested[node * D + d];
      float e = est_used[node * D + d];
      float pr = prod_used[node * D + d];
      for (int j = i; j < P && s_node[j] == node; ++j) {
        if (!s_acc[j]) continue;
        r = r + sreq[j * D + d];
        e = e + sest[j * D + d];
        if (sprod[j]) pr = pr + sest[j * D + d];
      }
      requested[node * D + d] = r;
      est_used[node * D + d] = e;
      prod_used[node * D + d] = pr;
    }
  }
}

__global__ void segment_sum_kernel(const int* __restrict__ skey,
                                   const float* __restrict__ vals, int M,
                                   int C, int S, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const int key = skey[i];
  if (key < 0 || key >= S || (i > 0 && skey[i - 1] == key)) return;
  for (int c = 0; c < C; ++c) {
    float acc = 0.0f;
    for (int j = i; j < M && skey[j] == key; ++j) acc = acc + vals[(size_t)j * C + c];
    out[(size_t)key * C + c] = acc;
  }
}

size_t commit_smem_bytes(int P, int D) {
  return (size_t)3 * D * scan_levels(P).total * sizeof(float) +
         (size_t)3 * P * sizeof(int);
}

}  // namespace

extern "C" int koord_commit(const void* snode, const void* sreq,
                            const void* sest, const void* sprod,
                            const void* alloc, const void* fresh,
                            const void* thr, const void* pthr,
                            void* requested, void* est_used, void* prod_used,
                            float round_quantum, int P, int N, int D,
                            void* accept_out, void* stream) {
  if (P <= 0) return (int)cudaSuccess;
  if (D < 1 || D > kMaxDims || N < 1) return (int)cudaErrorInvalidValue;
  // one block holds the whole round; a round too large for the card's
  // shared memory is refused here (cudaFuncSetAttribute's error)
  const size_t smem = commit_smem_bytes(P, D);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        commit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so the next launch's check is clean
      return (int)err;
    }
  }
  commit_kernel<<<1, kCommitThreads, smem, (cudaStream_t)stream>>>(
      (const int*)snode, (const float*)sreq, (const float*)sest,
      (const bool*)sprod, (const float*)alloc, (const bool*)fresh,
      (const float*)thr, (const float*)pthr, (float*)requested,
      (float*)est_used, (float*)prod_used, round_quantum, P, N, D,
      (bool*)accept_out);
  return (int)cudaGetLastError();
}

extern "C" int koord_segment_sum(const void* skey, const void* vals, int M,
                                 int C, int S, void* out, void* stream) {
  if (M <= 0) return (int)cudaSuccess;
  const int threads = 256;
  segment_sum_kernel<<<(M + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>((const int*)skey,
                                               (const float*)vals, M, C, S,
                                               (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* koord_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
