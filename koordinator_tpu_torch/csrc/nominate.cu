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
// operations, up to five of them IEEE divisions (each ~10 instructions),
// over node tables of ~55 bytes a node that stay in L2 (10k nodes ≈
// 0.55 MB). At P=512, N=10,000 that is ~2.6e8 operations against ~0.6 MB of
// traffic, so the fp32 rate, not memory, sets the floor.
//
// Design:
// - A block holds kPods pods, two a thread (lane l of every warp holds pods
//   l and l + 32 of the tile), and walks one chunk of the node axis; its
//   kWarps warps take turns over the chunk's nodes. Node rows are staged in
//   shared memory as SoA columns, a tile at a time, double-buffered: the
//   next tile's loads are in registers while the current tile is
//   evaluated. Every lane of a warp reads the same node at once (a
//   broadcast), so a node row leaves L2 once per kPods pods, not once per
//   pod. The staging also does the per-node arithmetic once for all pods
//   (alloc - requested + EPS, alloc + _SAFE, max(cpu_amp, 1)): the same
//   operations on the same values, so the same bits.
// - What limits it on an H100 is instruction issue along each pair's chain
//   of dependent tests, divisions and top-K insertion: a lone warp spends
//   ~900 cycles a pair; at P=512, N=10,000 the kernel takes ~0.047 ms.
//   Two pods a thread share the node loads and the warp votes and give
//   each warp two chains to interleave; kWarps warps a block multiply the
//   chains an SM holds without cutting the node axis finer.
// - Node-dependent branches (fresh, a threshold of 0) are uniform across
//   a warp, so skipped work is really skipped: a percent whose threshold is
//   ≤ 0 is never computed. Pod-dependent tests are predicated, not
//   branched; a test, or the score's divisions, is skipped for the warp
//   once every pair it holds is infeasible (__any_sync).
// - D is a template parameter, so every loop over dims unrolls. K is a
//   run-time count; a top-K list has C register slots, C = 4 for K <= 4
//   and 8 above (32 instantiations, and as many with a node mask), kept worst first, so its entry
//   test reads the fixed slot 0 and the slots past K hold pairs that rank
//   before every real one, where an insertion stops. On an H100, eight
//   slots at K = 4 cost the kernel 14 registers a thread, a resident block
//   an SM and a fifth of its time.
// - The warps' lists of a pod are merged in shared memory at the end of
//   the chunk. Enough blocks for the card: at P=512 a pod tile alone gives
//   8 blocks, so the node axis is cut into as many chunks as fill one wave
//   of resident blocks (koord_nominate_chunk; a second, partial wave would
//   cost nearly a whole one). Each block then writes its pods' partial
//   top-K, padded to C pairs, and a merge kernel (one warp a pod) takes the
//   K best of the partial lists by warp-wide (cost, index) minima over
//   __shfl_xor_sync. (cost, index) is a total order with unique indices,
//   so the merges give what one pass over all nodes gives.
// - The epilogue writes the round's nomination vector itself: with
//   approx_topk the reference's [best, best, 2nd, ...] (solver.py:1147-1153).
// - Both kernels take the round loop's state word (csrc/round.cu) and
//   return at once when its `done` is set, so a round loop of a fixed trip
//   count costs two near-empty launches a trip after its fixed point.
// - The pods' hard node constraints (a node mask, solver.py:896-897) are
//   one more feasibility term: pod p reads row mask_row[p] of an [M, N]
//   bool table in place (a stream's stacked [C, P, N] mask, its rows
//   offset by the chunk), one byte a pair, which L1 keeps for the node
//   chunk a warp walks. The masked kernel is its own instantiation
//   (kMasked), so the kernel without a mask keeps its registers.
// - NUMA zones (numa.py:numa_fit_mask, costs.py:numa_aligned_cost; their
//   per-pair arithmetic is loadaware.cuh's numa_fit and numa_score) are
//   the NUMA instantiation (kNuma, which also takes a node mask): each
//   pair reads the node's zone rows of the batch-start table and of the
//   capacities, Z x DN floats each, which every lane of a warp reads at
//   once and L1 keeps. It is instantiated for D <= 8, the widths the
//   round tail takes.
// - DeviceShare (device.py:device_fit_mask, costs.py:device_cost; their
//   per-pair arithmetic is loadaware.cuh's device_fit and device_score)
//   is the device instantiations (kDev, with a node mask or none, with
//   NUMA zones or without): each pair reads its node's row of the
//   round-start stats table (device_prep.cu) and the free RDMA and FPGA
//   counts, five words a node that every lane of a warp reads at once;
//   the pod's demand stays in registers. D <= 8.
// - With the candidate shortlist on, this is the round's fallback: both
//   kernels also take the trigger word the shortlist round sets
//   (csrc/shortlist_round.cu) and return at once while it is clear — the
//   port's form of the reference's lax.cond (solver.py:1158-1201). They
//   then write into the buffers the shortlist round wrote, so the round
//   tail reads one address whichever branch ran.
//
// Bit-exactness with the reference: every float operation is written in
// the reference's order (the arithmetic of a pair is loadaware.cuh's),
// division is IEEE `/` and the file is compiled with -fmad=false so no
// a*b+c is contracted into an FMA. Ties of cost go
// to the lower node index, as jax.lax.top_k and jnp.argmin break them;
// infeasible slots keep the lowest infeasible indices at +inf, as top_k
// ranks them.

#include "loadaware.cuh"

namespace {

using namespace koord;

constexpr int kWarps = 4;  // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kPodsPerThread = 2;
constexpr int kPods = 32 * kPodsPerThread;  // pods a block
constexpr int kMaxDims = 16;
constexpr int kMaxK = 8;
constexpr int kMinChunk = 32;     // fewest nodes a block walks
constexpr int kMergeWarps = 8;    // pods a merge block
constexpr uint8_t kFresh = 1, kSched = 2;

// nodes a tile: two tiles stay under 32 KB of shared memory
__host__ __device__ constexpr int tile_nodes(int D) { return D <= 4 ? 128 : D <= 8 ? 64 : 32; }

// One tile of node rows, SoA, with the per-node arithmetic done.
template <int D>
struct Tile {
  static constexpr int T = tile_nodes(D);
  float fe[D][T];   // alloc - requested + EPS
  float a[D][T];    // alloc
  float as[D][T];   // alloc + _SAFE
  float e[D][T];    // estimated used
  float pr[D][T];   // prod used
  float t[D][T];    // effective usage threshold
  float pt[D][T];   // effective prod threshold
  float amp[T];     // max(cpu_amp, 1)
  uint8_t flags[T]; // kFresh | kSched
};

// A node row in registers, between its loads and its store into a tile.
template <int D>
struct Row {
  float a[D], r[D], e[D], pr[D], t[D], pt[D];
  float amp;
  bool fresh, sched;

  __device__ __forceinline__ void load(int n, const float* alloc, const float* requested,
                                       const float* est_used, const float* prod_used,
                                       const bool* fresh_, const bool* sched_,
                                       const float* cpu_amp, const float* thr,
                                       const float* pthr) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const size_t at = (size_t)n * D + d;
      a[d] = alloc[at];
      r[d] = requested[at];
      e[d] = est_used[at];
      pr[d] = prod_used[at];
      t[d] = thr[at];
      pt[d] = pthr[at];
    }
    amp = cpu_amp[n];
    fresh = fresh_[n];
    sched = sched_[n];
  }

  __device__ __forceinline__ void store(Tile<D>& s, int j) const {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      s.fe[d][j] = free_eps(a[d], r[d]);
      s.a[d][j] = a[d];
      s.as[d][j] = alloc_safe(a[d]);
      s.e[d][j] = e[d];
      s.pr[d][j] = pr[d];
      s.t[d][j] = t[d];
      s.pt[d][j] = pt[d];
    }
    s.amp[j] = amp_of(amp);
    s.flags[j] = (fresh ? kFresh : 0) | (sched ? kSched : 0);
  }
};

template <int D, int C>
union Shared {
  Tile<D> tiles[2];
  struct {
    float v[kWarps][kPods][C];
    int i[kWarps][kPods][C];
  } lists;  // each warp's top-K of each pod, after the last tile
};

template <int D, int C, bool kMasked, bool kNuma, bool kDev>
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
                const float* __restrict__ weights, int P, int N, int K, int chunk,
                float jitter_scale, int jitter_on, int approx,
                float* __restrict__ out_cost, int* __restrict__ out_idx,
                const int* __restrict__ state, const int* __restrict__ trigger,
                const bool* __restrict__ mask, const long long* __restrict__ mask_row,
                const Zones zones, const Devices devs) {
  // the round loop reached its fixed point, or the shortlist round needs
  // no fallback: nothing to nominate
  if (state != nullptr && state[0] != 0) return;
  if (trigger != nullptr && trigger[0] == 0) return;
  constexpr int T = tile_nodes(D);
  constexpr int Q = kPodsPerThread;
  __shared__ Shared<D, C> sh;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int c0 = blockIdx.y * chunk;
  const int c1 = min(N, c0 + chunk);

  float w[D];
  const float wsum = weights_sum<D>(weights, w);
  const float zwsum = kNuma ? zone_weights_sum<D>(w, zones.DN) : 0.0f;

  float rq[Q][D], es[Q][D];
  TopK<C> top[Q];
  bool pod_gate[Q], pod_bind[Q], pod_prod[Q], pod_required[Q];
  DevPod pod_dev[Q];  // kDev only
  uint32_t hp[Q];
  // each pod's row of the node mask (kMasked only)
  const bool* pod_mask[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int p = blockIdx.x * kPods + lane + 32 * q;
    pod_gate[q] = pod_bind[q] = pod_prod[q] = pod_required[q] = false;
    pod_mask[q] = nullptr;
    if (p < P) {
      if constexpr (kMasked) pod_mask[q] = mask_row_of(mask, mask_row, p, N);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        rq[q][d] = req[(size_t)p * D + d];
        es[q][d] = est[(size_t)p * D + d];
      }
      pod_gate[q] = gate[p];
      pod_bind[q] = cpu_bind[p];
      pod_prod[q] = is_prod[p];
      if constexpr (kNuma) pod_required[q] = zones.required[p];
      if constexpr (kDev) pod_dev[q].load(p, devs);
    } else {
#pragma unroll
      for (int d = 0; d < D; ++d) rq[q][d] = es[q][d] = 0.0f;
    }
    // _jitter_hash on the priority-sorted pod position
    hp[q] = jitter_pod(p);
    top[q].clear(K);
  }

  Row<D> row;
  if (tid < T && c0 + tid < c1)
    row.load(c0 + tid, alloc, requested, est_used, prod_used, fresh, sched,
             cpu_amp, thr, pthr);
  if (tid < T) row.store(sh.tiles[0], tid);
  __syncthreads();

  int buf = 0;
  for (int base = c0; base < c1; base += T) {
    const int next = base + T;
    const bool more = next < c1;
    if (more && tid < T && next + tid < c1)
      row.load(next + tid, alloc, requested, est_used, prod_used, fresh, sched,
               cpu_amp, thr, pthr);
    const Tile<D>& s = sh.tiles[buf];
    const int count = min(T, c1 - base);
    for (int j = warp; j < count; j += kWarps) {
      const int n = base + j;
      // the node's columns, loaded once for both pods: every lane of the
      // block reads the same words (a broadcast)
      const uint8_t fl = s.flags[j];
      const float amp = s.amp[j];
      float fe[D], a[D], after[Q][D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        fe[d] = s.fe[d][j];
        a[d] = s.a[d][j];
        const float e = s.e[d][j];
#pragma unroll
        for (int q = 0; q < Q; ++q) after[q][d] = e + es[q][d];
      }
      // _feasible: schedulable, pod gate, fit, amplified-CPU fit, then
      // usage and prod thresholds on fresh nodes
      bool feas[Q];
      bool any = false;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        feas[q] = pod_gate[q] && (fl & kSched) != 0;
        if constexpr (kMasked) feas[q] = feas[q] && (pod_mask[q] == nullptr || pod_mask[q][n]);
#pragma unroll
        for (int d = 0; d < D; ++d) feas[q] = feas[q] & (rq[q][d] <= fe[d]);
        feas[q] = feas[q] & (!pod_bind[q] | (rq[q][0] * amp <= fe[0]));
        if constexpr (kNuma)
          feas[q] = feas[q] && numa_fit<D>(rq[q], pod_bind[q], pod_required[q], amp, n, zones);
        if constexpr (kDev) feas[q] = feas[q] && device_fit(pod_dev[q], n, devs);
        any = any | feas[q];
      }
      const bool node_fresh = (fl & kFresh) != 0;
      if (node_fresh && __any_sync(kFull, any)) {
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float t = s.t[d][j];
          if (t > 0.0f && __any_sync(kFull, any)) {
            any = false;
#pragma unroll
            for (int q = 0; q < Q; ++q) {
              feas[q] = feas[q] & !(usage_percent(after[q][d], a[d]) > t);
              any = any | feas[q];
            }
          }
        }
        bool any_prod = false;
#pragma unroll
        for (int q = 0; q < Q; ++q) any_prod = any_prod | (feas[q] & pod_prod[q]);
        if (__any_sync(kFull, any_prod)) {
#pragma unroll
          for (int d = 0; d < D; ++d) {
            const float t = s.pt[d][j];
            if (t > 0.0f) {
              const float pr = s.pr[d][j];
#pragma unroll
              for (int q = 0; q < Q; ++q)
                feas[q] = feas[q] & !(pod_prod[q] & (usage_percent(pr + es[q][d], a[d]) > t));
            }
          }
          any = false;
#pragma unroll
          for (int q = 0; q < Q; ++q) any = any | feas[q];
        }
      }
      // +inf for an infeasible pair: still ranked, by index, as top_k
      // ranks -inf entries
      float cost[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) cost[q] = CUDART_INF_F;
      if (__any_sync(kFull, any)) {
        float as[D];
#pragma unroll
        for (int d = 0; d < D; ++d) as[d] = s.as[d][j];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          // load_aware_cost: integer-floor least-used score, 0 when stale
          float score = 0.0f;
          if (node_fresh) {
            float total = 0.0f;
#pragma unroll
            for (int d = 0; d < D; ++d) {
              const float term = score_term(a[d], as[d], after[q][d], w[d]);
              total = d == 0 ? term : total + term;
            }
            score = floorf(total / wsum);
          }
          float c = -score;
          if constexpr (kNuma) {
            if (zones.scoring != 0 && feas[q])
              c = c + numa_score<D>(rq[q], pod_bind[q], pod_required[q], n, zones, w, zwsum);
          }
          if constexpr (kDev) {
            if (devs.scoring != 0 && feas[q]) c = c + device_score(pod_dev[q], n, devs);
          }
          if (jitter_on) c = add_jitter(c, hp[q], n, jitter_scale);
          if (feas[q]) cost[q] = c;
        }
      }
#pragma unroll
      for (int q = 0; q < Q; ++q) top[q].insert(cost[q], n);
    }
    if (more && tid < T) row.store(sh.tiles[buf ^ 1], tid);
    buf ^= 1;
    __syncthreads();
  }

  // the warps' lists of each pod, merged in shared memory
#pragma unroll
  for (int q = 0; q < Q; ++q) {
#pragma unroll
    for (int s = 0; s < C; ++s) {
      sh.lists.v[warp][lane + 32 * q][s] = top[q].v[s];
      sh.lists.i[warp][lane + 32 * q][s] = top[q].i[s];
    }
  }
  __syncthreads();
  if (tid >= kPods) return;
  const int p = blockIdx.x * kPods + tid;
  if (p >= P) return;
  TopK<C> m;
#pragma unroll
  for (int s = 0; s < C; ++s) {
    m.v[s] = sh.lists.v[0][tid][s];
    m.i[s] = sh.lists.i[0][tid][s];
  }
#pragma unroll
  for (int u = 1; u < kWarps; ++u) {
#pragma unroll
    for (int s = 0; s < C; ++s)
      if (s < K) m.insert(sh.lists.v[u][tid][s], sh.lists.i[u][tid][s]);
  }
  if (gridDim.y == 1) {
#pragma unroll
    for (int s = 0; s < C; ++s)
      if (s < K)
        put_ranked(out_cost + (size_t)p * K, out_idx + (size_t)p * K, K - 1 - s, K, approx,
                   m.v[s], m.i[s]);
  } else {
    // partial list of this chunk, in any order, padded to C pairs with
    // (+inf, INT32_MAX), which rank after every real pair: [P, chunks, C]
    const size_t at = ((size_t)p * gridDim.y + blockIdx.y) * C;
#pragma unroll
    for (int s = 0; s < C; ++s) {
      out_cost[at + s] = s < K ? m.v[s] : CUDART_INF_F;
      out_idx[at + s] = s < K ? m.i[s] : INT32_MAX;
    }
  }
}

// Merge of the chunks' partial lists: one warp a pod. Each lane keeps a
// register top-C of the entries it reads; then K rounds of a warp-wide
// (cost, index) minimum over __shfl_xor_sync, the winning lane popping its
// best pair each round. The lists hold C real pairs (the padding ranks
// last), so every slot index is fixed.
template <int C>
__global__ void __launch_bounds__(kMergeWarps * 32)
nominate_merge_kernel(const float* __restrict__ part_cost,
                      const int* __restrict__ part_idx, int P, int K, int chunks,
                      int approx, float* __restrict__ out_cost,
                      int* __restrict__ out_idx, const int* __restrict__ state,
                      const int* __restrict__ trigger) {
  if (state != nullptr && state[0] != 0) return;
  if (trigger != nullptr && trigger[0] == 0) return;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kMergeWarps + (threadIdx.x >> 5);
  if (p >= P) return;
  TopK<C> top;
  top.clear(C);
  const int m = chunks * C;
  const float* pc = part_cost + (size_t)p * m;
  const int* pi = part_idx + (size_t)p * m;
  for (int e = lane; e < m; e += 32) top.insert(pc[e], pi[e]);

#pragma unroll
  for (int r = 0; r < C; ++r) {
    if (r >= K) break;
    float v = top.v[C - 1];
    int i = top.i[C - 1];
    const float own_v = v;
    const int own_i = i;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, v, off);
      const int oi = __shfl_xor_sync(kFull, i, off);
      if (less_pair(ov, oi, v, i)) {
        v = ov;
        i = oi;
      }
    }
    if (lane == 0)
      put_ranked(out_cost + (size_t)p * K, out_idx + (size_t)p * K, r, K, approx, v, i);
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
}

struct Args {
  const float *req, *est;
  const bool *is_prod, *cpu_bind, *gate;
  const float *alloc, *requested, *est_used, *prod_used;
  const bool *fresh, *sched;
  const float *cpu_amp, *thr, *pthr, *weights;
  int P, N, K, chunk;
  float jitter_scale;
  int jitter_on, approx;
  float* part_cost;
  int* part_idx;
  float* out_cost;
  int* out_idx;
  const int* state;
  const int* trigger;
  const bool* mask;
  const long long* mask_row;
  Zones zones;   // zones.free == nullptr: no NUMA
  Devices devs;  // devs.stats == nullptr: no devices
  cudaStream_t stream;
};

// The kernels by mode: 0 LoadAware only, 1 with a node mask, 2 with NUMA
// zones, 3 with devices, 4 with devices and NUMA zones (2-4 with a node
// mask or none); 2-4 only up to D = 8.
enum Mode { kPlainMode = 0, kMaskedMode = 1, kNumaMode = 2, kDevMode = 3, kDevNumaMode = 4 };

template <int D, int C>
auto kernel_of(int mode) {
  if constexpr (D <= 8) {
    if (mode == kNumaMode) return nominate_kernel<D, C, true, true, false>;
    if (mode == kDevMode) return nominate_kernel<D, C, true, false, true>;
    if (mode == kDevNumaMode) return nominate_kernel<D, C, true, true, true>;
  }
  return mode == kMaskedMode ? nominate_kernel<D, C, true, false, false>
                             : nominate_kernel<D, C, false, false, false>;
}

__host__ __device__ inline int mode_of(bool zones, bool devs, bool mask) {
  if (devs) return zones ? kDevNumaMode : kDevMode;
  return zones ? kNumaMode : mask ? kMaskedMode : kPlainMode;
}

template <int D, int C>
cudaError_t launch(const Args& a) {
  const int chunks = (a.N + a.chunk - 1) / a.chunk;
  const dim3 grid((a.P + kPods - 1) / kPods, chunks);
  const bool split = chunks > 1;
  const int mode = mode_of(a.zones.free != nullptr, a.devs.stats != nullptr, a.mask != nullptr);
  if (mode >= kNumaMode && D > 8) return cudaErrorInvalidValue;
  auto kernel = kernel_of<D, C>(mode);
  kernel<<<grid, kThreads, 0, a.stream>>>(
      a.req, a.est, a.is_prod, a.cpu_bind, a.gate, a.alloc, a.requested,
      a.est_used, a.prod_used, a.fresh, a.sched, a.cpu_amp, a.thr, a.pthr,
      a.weights, a.P, a.N, a.K, a.chunk, a.jitter_scale, a.jitter_on, a.approx,
      split ? a.part_cost : a.out_cost, split ? a.part_idx : a.out_idx, a.state, a.trigger,
      a.mask, a.mask_row, a.zones, a.devs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !split) return err;
  nominate_merge_kernel<C><<<(a.P + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32, 0,
                          a.stream>>>(a.part_cost, a.part_idx, a.P, a.K, chunks, a.approx,
                                      a.out_cost, a.out_idx, a.state, a.trigger);
  return cudaGetLastError();
}

// op.run<D, C>() for a runtime D in 1..16 and list capacity C: every width
// the wrapper accepts is instantiated, so the loops over dims unroll.
template <int C, class Op>
cudaError_t with_d(int D, const Op& op) {
  switch (D) {
    case 1: return op.template run<1, C>();
    case 2: return op.template run<2, C>();
    case 3: return op.template run<3, C>();
    case 4: return op.template run<4, C>();
    case 5: return op.template run<5, C>();
    case 6: return op.template run<6, C>();
    case 7: return op.template run<7, C>();
    case 8: return op.template run<8, C>();
    case 9: return op.template run<9, C>();
    case 10: return op.template run<10, C>();
    case 11: return op.template run<11, C>();
    case 12: return op.template run<12, C>();
    case 13: return op.template run<13, C>();
    case 14: return op.template run<14, C>();
    case 15: return op.template run<15, C>();
    case 16: return op.template run<16, C>();
    default: return cudaErrorInvalidValue;
  }
}

// The instantiation for width D and fan-out K: lists of 4 slots up to
// K = 4, of kMaxK above.
template <class Op>
cudaError_t with_dk(int D, int K, const Op& op) {
  return K <= 4 ? with_d<4>(D, op) : with_d<kMaxK>(D, op);
}

struct Launch {
  const Args& a;
  template <int D, int C>
  cudaError_t run() const { return launch<D, C>(a); }
};

struct Resident {
  int* blocks;
  int mode;
  template <int D, int C>
  cudaError_t run() const {
    if (mode >= kNumaMode && D > 8) return cudaErrorInvalidValue;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel_of<D, C>(mode),
                                                         kThreads, 0);
  }
};

}  // namespace

// Nodes each block walks, for P pods and N nodes at width D and fan-out K
// (`mode`: 0 LoadAware only, 1 with a node mask, 2 with NUMA zones, 3 with
// devices, 4 with devices and NUMA zones) on a card of `sms` SMs: as many
// chunks
// as fill one wave of resident blocks (the occupancy of this
// instantiation), none shorter than kMinChunk nodes. The caller makes
// room for partial lists of [P, ceil(N / chunk), kMaxK] pairs when there
// is more than one chunk.
extern "C" int koord_nominate_chunk(int P, int N, int D, int K, int sms, int mode,
                                    int* chunk) {
  if (P < 1 || N < 1 || sms < 1 || K < 1 || K > kMaxK || mode < 0 || mode > kDevNumaMode)
    return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  const cudaError_t err = with_dk(D, K, Resident{&per_sm, mode});
  if (err != cudaSuccess) return (int)err;
  const int pod_blocks = (P + kPods - 1) / kPods;
  const int most = (N + kMinChunk - 1) / kMinChunk;
  int chunks = (int)((long long)per_sm * sms / pod_blocks);
  chunks = chunks < 1 ? 1 : chunks > most ? most : chunks;
  *chunk = (N + chunks - 1) / chunks;
  return (int)cudaSuccess;
}

extern "C" int koord_nominate(
    const void* req, const void* est, const void* is_prod,
    const void* cpu_bind, const void* gate, const void* alloc,
    const void* requested, const void* est_used, const void* prod_used,
    const void* fresh, const void* sched, const void* cpu_amp,
    const void* thr, const void* pthr, const void* weights, int P, int N,
    int D, int K, int chunk, float jitter_scale, int jitter_on, int approx,
    void* part_cost, void* part_idx, void* out_cost, void* out_idx,
    const void* state, const void* trigger, const void* mask, const void* mask_row,
    const void* zone_free, const void* zone_cap, const void* side, const void* required,
    int Z, int DN, int scoring, const void* dev_stats, const void* rdma_free,
    const void* fpga_free, const void* cap_total, const void* gpu_whole, const void* gpu_share,
    const void* rdma_req, const void* fpga_req, const void* units, int dev_scoring,
    int dev_clamp, void* stream) {
  if (P <= 0) return (int)cudaSuccess;
  if (D < 1 || D > kMaxDims || N < 1 || K < 1 || K > kMaxK || chunk < 1)
    return (int)cudaErrorInvalidValue;
  if (zone_free != nullptr &&
      (Z < 1 || Z > kMaxZones || DN < 1 || DN > kMaxZoneDims || DN > D || D > 8))
    return (int)cudaErrorInvalidValue;
  if (dev_stats != nullptr && (D > 8 || (dev_scoring != 0 && cap_total == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a{(const float*)req, (const float*)est, (const bool*)is_prod,
               (const bool*)cpu_bind, (const bool*)gate, (const float*)alloc,
               (const float*)requested, (const float*)est_used,
               (const float*)prod_used, (const bool*)fresh, (const bool*)sched,
               (const float*)cpu_amp, (const float*)thr, (const float*)pthr,
               (const float*)weights, P, N, K, chunk, jitter_scale, jitter_on,
               approx, (float*)part_cost, (int*)part_idx, (float*)out_cost,
               (int*)out_idx, (const int*)state, (const int*)trigger, (const bool*)mask,
               (const long long*)mask_row,
               Zones{(const float*)zone_free, (const float*)zone_cap, (const uint32_t*)side,
                     (const bool*)required, Z, DN, scoring},
               Devices{(const float*)dev_stats, (const float*)rdma_free, (const float*)fpga_free,
                       (const float*)cap_total, (const int*)gpu_whole, (const float*)gpu_share,
                       (const int*)rdma_req, (const int*)fpga_req, (const float*)units,
                       dev_scoring, dev_clamp},
               (cudaStream_t)stream};
  return (int)with_dk(D, K, Launch{a});
}

extern "C" const char* koord_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
