// Nomination over a given cost: the cost-transform route's jitter, the
// infeasible +inf and each pod's top-k, written as the round's nomination
// vector.
//
// Replaces koordinator_tpu/ops/solver.py:assign's add_jitter (:732-742),
// the where(feas, cost, inf) of full_feas_cost (:941) and _full_nominate
// (:1121-1156) after the BeforeScore transform: the part of the program
// XLA fused into one TPU kernel after the user's rewrite of the cost.
//
// What bounds it on an H100: the bytes it reads, 5 a pair (the
// transformed cost and cost_full.cu's flag); at P=4,096, N=10,000 that is
// 205 MB, 61 us at 3.35 TB/s.
//
// Design: one warp a pod, streamed over the pod's row in tiles of 32
// nodes, lane l reading nodes l, l + 32, ... (coalesced). Each lane keeps
// a register top-k of the nodes it reads and the row's first NaN and
// first least value; then k rounds of a warp-wide (key, index) minimum
// over __shfl_xor_sync give the row's k first, the winning lane popping
// its best each round (as nominate.cu's merge kernel does).
//
// What a transform may write decides the order: the reference ranks with
// approx_max_k of -cost inside its compiled round, which on the CPU takes
// -inf first, then the finite costs (-0.0 before +0.0: the IEEE total
// order), +inf, and every NaN last whatever its sign, ties by the lower
// index; the keys here are that order as int32 (the sign bit flips the
// other 31 bits of a negative value; a NaN is INT32_MAX). With approx_topk
// slot 0 is jnp.argmin's pick: the first NaN of a row that holds one, else
// the first least value (-0.0 == +0.0). Each value written is re-read at
// its index, so a NaN keeps its bits. The jitter is added with
// loadaware.cuh's add_jitter, -fmad=false, as in every pricing kernel. The
// kernel returns at once when the round loop's `done` is set.

#include "loadaware.cuh"

namespace {

using namespace koord;

constexpr int kWarps = 8;  // pods a block
constexpr int kMaxK = 8;

// The rank of a float as an int32 key: its IEEE total order, every NaN
// last.
__device__ __forceinline__ int rank_key(float v) {
  const int bits = __float_as_int(v);
  return isnan(v) ? INT32_MAX : bits ^ ((bits >> 31) & 0x7FFFFFFF);
}

__device__ __forceinline__ bool less_key(int ka, int ia, int kb, int ib) {
  return ka < kb || (ka == kb && ia < ib);
}

// A lane's register top-kMaxK by (key, index), kept worst first: slot 0
// holds the kMaxK-th best, slot kMaxK - 1 the best. Empty slots hold
// (INT32_MAX, INT32_MAX), which ranks after every real pair (indices are
// below N).
struct KeyTopK {
  int key[kMaxK];
  int idx[kMaxK];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int s = 0; s < kMaxK; ++s) {
      key[s] = INT32_MAX;
      idx[s] = INT32_MAX;
    }
  }

  __device__ __forceinline__ void insert(int k, int i) {
    if (!less_key(k, i, key[0], idx[0])) return;
    key[0] = k;
    idx[0] = i;
#pragma unroll
    for (int s = 0; s + 1 < kMaxK; ++s) {
      if (less_key(key[s], idx[s], key[s + 1], idx[s + 1])) {
        const int tk = key[s];
        key[s] = key[s + 1];
        key[s + 1] = tk;
        const int ti = idx[s];
        idx[s] = idx[s + 1];
        idx[s + 1] = ti;
      }
    }
  }
};

// The ranked value of pair (p, n): the jittered cost, +inf where infeasible.
__device__ __forceinline__ float ranked(const float* cost, const uint8_t* feas, size_t at,
                                        uint32_t hp, int n, bool jitter_on, float scale) {
  if (feas[at] == 0) return CUDART_INF_F;
  const float c = cost[at];
  return jitter_on ? add_jitter(c, hp, n, scale) : c;
}

__global__ void __launch_bounds__(kWarps * 32)
nominate_cost_kernel(const float* __restrict__ cost, const uint8_t* __restrict__ feas, int P,
                     int N, int K, float jitter_scale, int jitter_on, int approx,
                     float* __restrict__ out_cost, int* __restrict__ out_idx,
                     const int* __restrict__ state) {
  if (state != nullptr && state[0] != 0) return;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= P) return;
  const uint32_t hp = jitter_pod(p);
  const size_t row = (size_t)p * N;

  KeyTopK top;
  top.clear();
  int nan_i = INT32_MAX;  // the lane's first NaN
  float best_v = CUDART_INF_F;
  int best_i = INT32_MAX;  // the lane's first least non-NaN value
  for (int n = lane; n < N; n += 32) {
    const float v = ranked(cost, feas, row + n, hp, n, jitter_on, jitter_scale);
    top.insert(rank_key(v), n);
    if (isnan(v)) {
      if (nan_i == INT32_MAX) nan_i = n;
    } else if (best_i == INT32_MAX || v < best_v) {
      best_v = v;
      best_i = n;
    }
  }

  // jnp.argmin: the first NaN, else the first least value
  int arg = (int)__reduce_min_sync(kFull, (unsigned)nan_i);
  if (arg == INT32_MAX) {
    float v = best_v;
    int i = best_i;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, v, off);
      const int oi = __shfl_xor_sync(kFull, i, off);
      if (ov < v || (ov == v && oi < i)) {
        v = ov;
        i = oi;
      }
    }
    arg = i;
  }
  float* oc = out_cost + (size_t)p * K;
  int* oi = out_idx + (size_t)p * K;
  if (approx && lane == 0) {
    oc[0] = ranked(cost, feas, row + arg, hp, arg, jitter_on, jitter_scale);
    oi[0] = arg;
  }

  // k rounds of a warp-wide (key, index) minimum of the lanes' best pairs
  const int first = approx ? 1 : 0;
  for (int r = 0; r + first < K; ++r) {
    int k = top.key[kMaxK - 1];
    int i = top.idx[kMaxK - 1];
    const int own_k = k, own_i = i;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int ok = __shfl_xor_sync(kFull, k, off);
      const int oi2 = __shfl_xor_sync(kFull, i, off);
      if (less_key(ok, oi2, k, i)) {
        k = ok;
        i = oi2;
      }
    }
    if (lane == 0) {
      oc[r + first] = ranked(cost, feas, row + i, hp, i, jitter_on, jitter_scale);
      oi[r + first] = i;
    }
    if (own_k == k && own_i == i) {
      // pop: every pair moves one slot toward the best end
#pragma unroll
      for (int s = kMaxK - 1; s > 0; --s) {
        top.key[s] = top.key[s - 1];
        top.idx[s] = top.idx[s - 1];
      }
      top.key[0] = INT32_MAX;
      top.idx[0] = INT32_MAX;
    }
  }
}

}  // namespace

extern "C" int koord_nominate_cost(const void* cost, const void* feas, int P, int N, int K,
                                   float jitter_scale, int jitter_on, int approx,
                                   void* out_cost, void* out_idx, const void* state,
                                   void* stream) {
  if (P <= 0) return (int)cudaSuccess;
  if (N < 1 || K < 1 || K > kMaxK || K > N) return (int)cudaErrorInvalidValue;
  nominate_cost_kernel<<<(P + kWarps - 1) / kWarps, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)cost, (const uint8_t*)feas, P, N, K, jitter_scale, jitter_on, approx,
      (float*)out_cost, (int*)out_idx, (const int*)state);
  return (int)cudaGetLastError();
}

extern "C" const char* koord_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
