// The tail of one solver round, in one launch: choice, stable node sort,
// segmented commit and the round loop's state.
//
// koord_round_tail replaces, for the LoadAware branch of
// koordinator_tpu/ops/solver.py:assign, everything a round does between
// nomination and the next round: the rank-modular choice (:1204-1213), the
// stable sort of the pods by nominated node (:1215), the gather of the
// sorted rows with amplified CPU (:1217-1229), the segmented prefix sums and
// acceptance tests (:1230-1359), the winners' charges (:1362-1380), the
// carry update (:1433-1447) and the loop condition round_cond
// (:1450-1452). The loop state lives on the card: assigned [P], active [P]
// and a state word {done, rounds}. A launch that finds `done` set returns
// at once, so a caller may run a fixed number of rounds with no host read:
// a trip after the fixed point changes nothing.
//
// What bounds it on an H100: a chain of dependent steps, not bytes or
// operations. A round is a few hundred rows and a few tens of KB (a 10 ns
// byte bound); its floor is a scan, a sort, a scan and a segmented walk,
// each depending on the one before, on one SM.
//
// Design: one block holds the round in shared memory (sized by P, set
// through cudaFuncSetAttribute above 48 KB); up to 1,024 pods each thread
// holds one row in registers from its load to its last use, and the block
// has as many threads as pods.
// - Integer scans (the active rank, the segment starts) are warp-shuffle
//   scans with one shared word a warp.
// - The stable sort is over unique keys (node_key << 32 | position,
//   packed into 32 bits when N leaves room), which gives
//   argsort(stable=True) exactly, pods keyed N last: a bitonic network of
//   shuffles inside each warp, then merges of sorted runs by binary
//   search, one barrier a merge.
// - The cumsums keep XLA's CPU order (sequential chunks of 16, chunk
//   totals scanned the same way, then offset): a thread sums a chunk in
//   registers (chunks padded in shared memory so their threads hit
//   distinct banks), one warp a series takes the levels above, and a row
//   adds its chunk's offset when it reads its value. Each row's segment
//   prefix is cums[i] - cums[start - 1], as _segment_prefix_sums
//   (:574-584) takes it.
// - Every row is tested in parallel against the tables as they stood at
//   the start of the round. The winners' charges land on the tables row by
//   row in sorted order within each node — the scatter-add XLA folds
//   `table + segment_sum(...)` into — one thread a node, from the table
//   values its tests read. No float atomics. Compiled with -fmad=false and
//   IEEE division, so `quantum * alloc + EPS` and the percents round as the
//   reference's do.
// - One SM sends every scattered load and store of the round, a line a
//   lane, so they are kept few: the pods' columns are read once, coalesced,
//   in priority order and gathered from shared memory after the sort; node
//   rows move as float2 / float4.
// - Above 1,024 pods (the JAX scheduler's batch bucket is 4,096) a thread
//   holds 4 or 16 rows and the sort is a bitonic network in shared memory;
//   where shared memory is short, fewer dims go through the cumsums at a
//   time and the pods' columns are read from device memory instead.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDims = 8;
constexpr int kMaxK = 8;  // nomination slots (ops/nominate.py MAX_K)
constexpr float kEps = 1e-3f;  // masks.EPS
constexpr unsigned kFull = 0xFFFFFFFFu;

// flags of a sorted row, for the charge walk
constexpr int kAcc = 1;   // accepted
constexpr int kProd = 2;  // a prod pod

__device__ __forceinline__ float usage_percent(float used, float alloc) {
  float pct = alloc > 0.0f ? used * 100.0f / alloc : 0.0f;
  return floorf(pct + 0.5f);
}

// The reference's cumsum order. XLA on the CPU rewrites a cumulative sum
// of length m > 16 into chunks of 16: a sequential sum inside each chunk,
// the chunk totals scanned the same way (recursively), and each chunk then
// offset by the scanned total of the chunks before it. Level l of a series
// holds the chunk totals of level l-1.
constexpr int kScanBase = 16;
constexpr int kMaxLevels = 8;

struct ScanLevels {
  int n;  // levels above the base array
  int len[kMaxLevels];
  int off[kMaxLevels];
  int total;  // floats per series
};

// Level 0 keeps a gap after each chunk of 16 (element i at pad0(i)), so
// the threads that take one chunk each read and write distinct banks.
__host__ __device__ inline int pad0(int i) { return i + i / kScanBase; }

__host__ __device__ inline ScanLevels scan_levels(int P) {
  ScanLevels lv;
  lv.n = 0;
  lv.len[0] = P;
  lv.off[0] = 0;
  while (lv.len[lv.n] > kScanBase && lv.n + 1 < kMaxLevels) {
    const int chunks = (lv.len[lv.n] + kScanBase - 1) / kScanBase;
    lv.off[lv.n + 1] = lv.off[lv.n] + (lv.n == 0 ? chunks * (kScanBase + 1) : lv.len[lv.n]);
    lv.len[lv.n + 1] = chunks;
    ++lv.n;
  }
  lv.total = lv.off[lv.n] + lv.len[lv.n];
  return lv;
}

// Inclusive cumsums of S series at sm[s * lv.total + i], in the
// reference's order, except the last offset of level 0: level 0 is left as
// the sums inside each chunk of 16, and cum_at() adds the scanned total of
// the chunks before, the one add the reference makes there. Level 0's
// chunks take a thread each; the levels above take one warp a series, so
// they need no block-wide barrier. The whole block calls it.
__device__ void series_cumsum(float* sm, int S, const ScanLevels& lv) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  if (lv.n > 0) {
    const int chunks = lv.len[1];
    for (int w = tid; w < S * chunks; w += blockDim.x) {
      const int s = w / chunks, c = w - s * chunks;
      float* L = sm + s * lv.total + c * (kScanBase + 1);  // the chunk, padded
      const int cnt = min(kScanBase, lv.len[0] - c * kScanBase);
      // the chunk's values in registers, every load before the first add
      float v[kScanBase];
#pragma unroll
      for (int u = 0; u < kScanBase; ++u) v[u] = u < cnt ? L[u] : 0.0f;
#pragma unroll
      for (int u = 1; u < kScanBase; ++u)
        if (u < cnt) v[u] = v[u - 1] + v[u];
      float last = v[0];
#pragma unroll
      for (int u = 0; u < kScanBase; ++u)
        if (u < cnt) {
          L[u] = v[u];
          last = v[u];
        }
      sm[s * lv.total + lv.off[1] + c] = last;
    }
    __syncthreads();
  }
  for (int s = warp; s < S; s += nwarps) {
    float* base = sm + s * lv.total;
    for (int l = 1; l < lv.n; ++l) {
      float* L = base + lv.off[l];
      for (int c = lane; c < lv.len[l + 1]; c += 32) {
        const int beg = c * kScanBase, end = min(beg + kScanBase, lv.len[l]);
        float acc = L[beg];
        for (int i = beg + 1; i < end; ++i) {
          acc = acc + L[i];
          L[i] = acc;
        }
        base[lv.off[l + 1] + c] = acc;
      }
      __syncwarp();
    }
    if (lane == 0) {
      float* L = base + lv.off[lv.n];
      float acc = L[0];
      for (int i = 1; i < lv.len[lv.n]; ++i) {
        acc = acc + L[i];
        L[i] = acc;
      }
    }
    __syncwarp();
    for (int l = lv.n - 1; l >= 1; --l) {
      for (int e = kScanBase + lane; e < lv.len[l]; e += 32)
        base[lv.off[l] + e] = base[lv.off[l] + e] + base[lv.off[l + 1] + e / kScanBase - 1];
      __syncwarp();
    }
  }
  __syncthreads();
}

// The inclusive cumsum at row i of a series after series_cumsum: the sum
// inside its chunk, offset by the scanned total of the chunks before.
__device__ __forceinline__ float cum_at(const float* base, int i, const ScanLevels& lv) {
  const int c = i / kScanBase;
  return lv.n > 0 && c > 0 ? base[pad0(i)] + base[lv.off[1] + c - 1] : base[pad0(i)];
}

struct Add {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct Max {
  __device__ int operator()(int a, int b) const { return max(a, b); }
};

// Inclusive scan of one int a thread across the block, by warp shuffles
// and one shared word a warp; `carry` (the previous tile's total, 0 on the
// first: the identity of both ops here, whose values are >= 0) is folded
// in, and becomes this tile's running total. `warp_sums` holds kWarps ints.
template <class Op>
__device__ int block_scan(int v, int* warp_sums, int& carry, Op op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x = op(x, y);
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w = op(w, y);
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  if (warp > 0) x = op(warp_sums[warp - 1], x);
  x = op(carry, x);
  carry = op(carry, warp_sums[nwarps - 1]);
  __syncthreads();  // warp_sums is reused by the next tile
  return x;
}

// A pod's nomination vector in registers: its active flag, its K <= kMaxK
// nominated nodes, which slots are finite and how many.
struct Nomination {
  bool act;
  int n_feas;
  uint32_t finite;
  int idx[kMaxK];
};

__device__ __forceinline__ Nomination load_nomination(
    int i, int P, int K, const bool* __restrict__ active,
    const float* __restrict__ top_cost, const int* __restrict__ top_idx) {
  Nomination m;
  m.act = false;
  m.n_feas = 0;
  m.finite = 0;
#pragma unroll
  for (int s = 0; s < kMaxK; ++s) m.idx[s] = 0;
  if (i < P) {
    m.act = active[i];
#pragma unroll
    for (int s = 0; s < kMaxK; ++s) {
      if (s < K) {
        m.idx[s] = top_idx[(size_t)i * K + s];
        if (isfinite(top_cost[(size_t)i * K + s])) {
          m.finite |= 1u << s;
          ++m.n_feas;
        }
      }
    }
  }
  return m;
}

// The 64-bit sort key of a pod: its node key (N without a finite slot at
// its rank-modular slot, :1204-1213) above its priority-sorted position.
__device__ __forceinline__ uint64_t choice_key(const Nomination& m, int rank, int i, int N) {
  // jnp's `%` (and torch.remainder) is floored, C's truncates. A negative
  // rank only occurs with n_feas == 0 (an inactive pod before the first
  // active one, every slot +inf), where the slot is 0; the floored form
  // keeps the reference's value in every case.
  int slot = 0;
  if (m.n_feas > 0) {
    slot = rank % m.n_feas;
    if (slot < 0) slot += m.n_feas;
  }
  int choice = 0;
#pragma unroll
  for (int s = 0; s < kMaxK; ++s)
    if (s == slot) choice = m.idx[s];
  const bool has = (m.finite >> slot) & 1u;
  const uint32_t node_key = has ? (uint32_t)choice : (uint32_t)N;
  return ((uint64_t)node_key << 32) | (uint64_t)i;
}

// A node-table or pod row of D floats, by the widest loads and stores
// the row's alignment allows (the entry refuses pointers not aligned so).
template <int D>
__device__ __forceinline__ void load_row(const float* __restrict__ p, size_t row, float (&v)[D]) {
  const float* q = p + row * D;
  if constexpr (D % 4 == 0) {
#pragma unroll
    for (int k = 0; k < D / 4; ++k) {
      const float4 x = reinterpret_cast<const float4*>(q)[k];
      v[4 * k] = x.x, v[4 * k + 1] = x.y, v[4 * k + 2] = x.z, v[4 * k + 3] = x.w;
    }
  } else if constexpr (D % 2 == 0) {
#pragma unroll
    for (int k = 0; k < D / 2; ++k) {
      const float2 x = reinterpret_cast<const float2*>(q)[k];
      v[2 * k] = x.x, v[2 * k + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) v[d] = q[d];
  }
}

template <int D>
__device__ __forceinline__ void store_row(float* __restrict__ p, size_t row, const float (&v)[D]) {
  float* q = p + row * D;
  if constexpr (D % 4 == 0) {
#pragma unroll
    for (int k = 0; k < D / 4; ++k)
      reinterpret_cast<float4*>(q)[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  } else if constexpr (D % 2 == 0) {
#pragma unroll
    for (int k = 0; k < D / 2; ++k)
      reinterpret_cast<float2*>(q)[k] = make_float2(v[2 * k], v[2 * k + 1]);
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) q[d] = v[d];
  }
}

// bits of a staged pod
constexpr int kStagedProd = 1, kStagedBind = 2, kStagedActive = 4;

// Sorts one key a thread (P <= blockDim.x; threads past P hold `inf`):
// each warp sorts its 32 keys by a bitonic network of shuffles, every
// comparator putting the smaller key at the lower lane; then runs of 32,
// 64, ... are merged in pairs through shared memory (two buffers in turn,
// one barrier a merge): a key's place in the merged run is its place in
// its own run plus the count of the other run's keys below it, found by a
// binary search (the keys are unique). Returns the key of rank tid.
template <class KeyT>
__device__ KeyT block_sort(KeyT key, int P, KeyT* buf0, KeyT* buf1, KeyT inf) {
  const int tid = threadIdx.x, lane = tid & 31;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int mask = j == (k >> 1) ? k - 1 : j;
      const KeyT other = __shfl_xor_sync(kFull, key, mask);
      key = (lane < (lane ^ mask)) == (other < key) ? other : key;
    }
  }
  KeyT* in = buf0;
  KeyT* out = buf1;
  if (tid < P) in[tid] = key;
  for (int m = 32; m < P; m <<= 1) {
    __syncthreads();
    if (tid < P) {
      const KeyT k = in[tid];
      const int base = tid & ~(2 * m - 1);
      const bool first = (tid & m) == 0;
      // the other run: [lo, hi), cut at P
      const int lo = base + (first ? m : 0);
      const int hi = min(lo + m, P);
      int a = lo, b = max(lo, hi);
      while (a < b) {
        const int mid = (a + b) >> 1;
        if (in[mid] < k) a = mid + 1;
        else b = mid;
      }
      out[tid + (a - lo) - (first ? 0 : m)] = k;
    }
    KeyT* t = in;
    in = out;
    out = t;
  }
  __syncthreads();
  return tid < P ? in[tid] : inf;
}

// Shared layout: keys[P] uint64, then one area used in turn, then
// s_flags[P] int (a sorted row's accept and prod flags). The area holds
// - while choosing and sorting, the sort's second buffer of P keys and,
//   when `staged`, the pods' columns in priority order: request [P, D],
//   estimate [P, D], bits [P], assigned [P];
// - from the tests on, 3 G series of lv.total floats (G dims a pass).
__host__ __device__ inline size_t area_bytes(int P, int D, int G, int staged) {
  const size_t series = (size_t)3 * G * scan_levels(P).total * sizeof(float);
  const size_t sorting = (size_t)P * (sizeof(uint64_t) + (staged ? 8 * D + 8 : 0));
  return series > sorting ? series : sorting;
}

size_t round_smem_bytes(int P, int D, int G, int staged) {
  return (size_t)P * (sizeof(uint64_t) + sizeof(int)) + area_bytes(P, D, G, staged);
}

// R rows a thread: row i = tid + r * blockDim.x. A row's values stay in
// registers from its load to its last use; only what other rows read
// (keys, cumsums, flags, the values the charge walk adds) goes through
// shared memory. A single SM sends the whole round's scattered loads and
// stores, each warp instruction a line a lane, so the design keeps them
// few: the pods' columns are read once, coalesced, in priority order and
// gathered from shared memory after the sort; node rows are read with
// vector loads, once, and the charges start from the values the tests
// read.
template <int D, int R>
__global__ void __launch_bounds__(kThreads)
round_tail_kernel(const float* __restrict__ top_cost,
                  const int* __restrict__ top_idx,
                  const float* __restrict__ req, const float* __restrict__ est,
                  const bool* __restrict__ is_prod,
                  const bool* __restrict__ cpu_bind,
                  const float* __restrict__ cpu_amp,
                  const float* __restrict__ alloc,
                  const bool* __restrict__ fresh,
                  const float* __restrict__ thr,
                  const float* __restrict__ pthr,
                  float* __restrict__ requested, float* __restrict__ est_used,
                  float* __restrict__ prod_used, int* __restrict__ assigned,
                  bool* __restrict__ active, int* __restrict__ state,
                  float round_quantum, int P, int N, int K, int G, int staged) {
  // A trip after the fixed point returns at once (state[0] is `done`; only
  // thread 0 writes the word, at the very end of a launch).
  if (state[0] != 0) return;
  // The row loops unroll (their arrays in registers) up to 4 rows a
  // thread; above, the arrays live in local memory and the build stays
  // short.
  extern __shared__ uint64_t smem_u64[];
  __shared__ ScanLevels s_lv;
  __shared__ int warp_sums[kWarps];
  uint64_t* keys = smem_u64;                            // [P]
  uint64_t* keys2 = keys + P;                           // [P], the area
  float* series = (float*)keys2;                        // [3 G, lv.total]
  float* st_req = (float*)(keys2 + P);                  // [P, D] if staged
  float* st_est = st_req + (size_t)P * D;               // [P, D]
  int* st_bits = (int*)(st_est + (size_t)P * D);        // [P]
  int* st_asg = st_bits + P;                            // [P]
  int* s_flags = (int*)((char*)keys2 + area_bytes(P, D, G, staged));  // [P]
  const int tid = threadIdx.x, T = blockDim.x;
  if (tid == 0) s_lv = scan_levels(P);

  // 1. The rank-modular choice (:1204-1213): rank is the inclusive count of
  // active pods minus 1, an exact integer scan, tile by tile. The pods'
  // columns are staged on the way, in priority order.
  uint64_t key[R];
  int carry = 0;
#pragma unroll (R <= 4 ? R : 1)
  for (int r = 0; r < R; ++r) {
    const int i = tid + r * T;
    const Nomination m = load_nomination(i, P, K, active, top_cost, top_idx);
    // the pod's columns, loaded now and stored after the scan, so their
    // latency overlaps its barriers
    float srq[D], ses[D];
    int sbits = 0, sasg = 0;
    if (staged && i < P) {
      load_row<D>(req, i, srq);
      load_row<D>(est, i, ses);
      sbits = (is_prod[i] ? kStagedProd : 0) | (cpu_bind[i] ? kStagedBind : 0);
      sasg = assigned[i];
    }
    const int rank = block_scan(m.act ? 1 : 0, warp_sums, carry, Add()) - 1;
    if (staged && i < P) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        st_req[(size_t)i * D + d] = srq[d];
        st_est[(size_t)i * D + d] = ses[d];
      }
      st_bits[i] = sbits | (m.act ? kStagedActive : 0);
      st_asg[i] = sasg;
    }
    key[r] = UINT64_MAX;
    if (i < P) {
      key[r] = choice_key(m, rank, i, N);
      keys[i] = key[r];
    }
  }
  const ScanLevels& lv = s_lv;  // written before block_scan's barriers

  // 2. The stable sort by node key (:1215): a bitonic network over the
  // virtual power-of-two length L, every comparator putting the smaller
  // key at the lower position (a flip, then half-cleaners); positions past
  // P hold +inf and are never stored.
  int L = 1;
  while (L < P) L <<= 1;
  if (R == 1) {
    // one key a thread, in a register; packed into 32 bits (node key above
    // the position's bits) when N leaves room, which halves the shuffles
    const int pbits = 32 - __clz(max(P - 1, 1));
    if ((((uint64_t)N + 1) << pbits) < (1ull << 32)) {
      const uint32_t packed = key[0] == UINT64_MAX
          ? UINT32_MAX : (uint32_t)((key[0] >> 32) << pbits | (key[0] & 0xFFFFFFFFu));
      const uint32_t k32 = block_sort<uint32_t>(
          packed, P, (uint32_t*)keys, (uint32_t*)keys2, UINT32_MAX);
      key[0] = k32 == UINT32_MAX
          ? UINT64_MAX : ((uint64_t)(k32 >> pbits) << 32) | (k32 & ((1u << pbits) - 1));
    } else {
      key[0] = block_sort<uint64_t>(key[0], P, keys, keys2, UINT64_MAX);
    }
    __syncthreads();
    if (tid < P) keys[tid] = key[0];
  } else {
    __syncthreads();
    for (int k = 2; k <= L; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        const bool flip = j == (k >> 1);
        for (int t = tid; t < (L >> 1); t += T) {
          const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1));
          const int hi = flip ? (lo ^ (k - 1)) : lo + j;
          if (hi < P) {
            const uint64_t a = keys[lo], b = keys[hi];
            if (b < a) {
              keys[lo] = b;
              keys[hi] = a;
            }
          }
        }
        __syncthreads();
      }
    }
#pragma unroll (R <= 4 ? R : 1)
    for (int r = 0; r < R; ++r) {
      const int i = tid + r * T;
      if (i < P) key[r] = keys[i];
    }
  }
  __syncthreads();

  // 3. Each sorted row: its pod's columns (CPU x amp for cpu-bind pods,
  // :1217-1229) and loop state, and its segment start (jax.lax.cummax of
  // the start positions) by a max-scan.
  float rq[R][D], es[R][D];
  int start[R], asg[R];
  bool prod[R], act[R];
  carry = 0;
#pragma unroll (R <= 4 ? R : 1)
  for (int r = 0; r < R; ++r) {
    const int i = tid + r * T;
    int node = -1, prev = -1;
    prod[r] = act[r] = false;
    asg[r] = -1;
#pragma unroll
    for (int d = 0; d < D; ++d) rq[r][d] = es[r][d] = 0.0f;
    if (i < P) {
      const int row = (int)(key[r] & 0xFFFFFFFFu);
      node = (int)(key[r] >> 32);
      prev = i > 0 ? (int)(keys[i - 1] >> 32) : -1;
      bool bind;
      if (staged) {
#pragma unroll
        for (int d = 0; d < D; ++d) {
          rq[r][d] = st_req[(size_t)row * D + d];
          es[r][d] = st_est[(size_t)row * D + d];
        }
        const int bits = st_bits[row];
        prod[r] = bits & kStagedProd;
        bind = bits & kStagedBind;
        act[r] = bits & kStagedActive;
        asg[r] = st_asg[row];
      } else {
        load_row<D>(req, row, rq[r]);
        load_row<D>(est, row, es[r]);
        prod[r] = is_prod[row];
        bind = cpu_bind[row];
        act[r] = active[row];
        asg[r] = assigned[row];
      }
      if (bind) rq[r][0] = rq[r][0] * fmaxf(cpu_amp[min(node, N - 1)], 1.0f);
    }
    start[r] = block_scan(i < P && node != prev ? i : 0, warp_sums, carry, Max());
  }

  // 4-5. G dims a pass: the series (request, estimate, prod estimate) x G
  // of the sorted rows, their cumsums, and each row's tests against the
  // round-start tables (node rows loaded before the cumsums, so their
  // latency overlaps them).
  bool ok[R], over[R], pover[R], node_fresh[R];
  float a[R][D], t[R][D], pt[R][D], rq0[R][D], eu0[R][D], pu0[R][D];
#pragma unroll (R <= 4 ? R : 1)
  for (int r = 0; r < R; ++r) {
    const int i = tid + r * T;
    const int node = (int)(key[r] >> 32);
    ok[r] = i < P && node < N;
    over[r] = pover[r] = node_fresh[r] = false;
    if (ok[r]) {
      node_fresh[r] = fresh[node];
      if (G == D) {  // every dim in one pass: whole rows
        load_row<D>(alloc, node, a[r]);
        load_row<D>(thr, node, t[r]);
        load_row<D>(pthr, node, pt[r]);
        load_row<D>(requested, node, rq0[r]);
        load_row<D>(est_used, node, eu0[r]);
        load_row<D>(prod_used, node, pu0[r]);
      } else {
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const size_t at = (size_t)node * D + d;
          a[r][d] = alloc[at], t[r][d] = thr[at], pt[r][d] = pthr[at];
          rq0[r][d] = requested[at], eu0[r][d] = est_used[at], pu0[r][d] = prod_used[at];
        }
      }
    }
  }
#pragma unroll 1
  for (int d0 = 0; d0 < D; d0 += G) {
    const int gn = min(G, D - d0);
#pragma unroll (R <= 4 ? R : 1)
    for (int r = 0; r < R; ++r) {
      const int i = tid + r * T;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (i < P && d >= d0 && d < d0 + gn) {
          const int g = d - d0;
          series[(0 * gn + g) * lv.total + pad0(i)] = rq[r][d];
          series[(1 * gn + g) * lv.total + pad0(i)] = es[r][d];
          series[(2 * gn + g) * lv.total + pad0(i)] = prod[r] ? es[r][d] : 0.0f;
        }
      }
    }
    __syncthreads();
    series_cumsum(series, 3 * gn, lv);
#pragma unroll (R <= 4 ? R : 1)
    for (int r = 0; r < R; ++r) {
      const int i = tid + r * T;
      const int st = start[r];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (ok[r] && d >= d0 && d < d0 + gn) {
          const int g = d - d0;
          float seg[3];
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const float* c = series + (q * gn + g) * lv.total;
            seg[q] = st > 0 ? cum_at(c, i, lv) - cum_at(c, st - 1, lv) : cum_at(c, i, lv) - 0.0f;
          }
          ok[r] = ok[r] && rq0[r][d] + seg[0] <= a[r][d] + kEps;
          const float prior_est = seg[1] - es[r][d];
          ok[r] = ok[r] && (a[r][d] <= 0.0f || prior_est <= round_quantum * a[r][d] + kEps);
          over[r] = over[r] || (t[r][d] > 0.0f && usage_percent(eu0[r][d] + seg[1], a[r][d]) > t[r][d]);
          pover[r] = pover[r] || (pt[r][d] > 0.0f && usage_percent(pu0[r][d] + seg[2], a[r][d]) > pt[r][d]);
        }
      }
    }
    __syncthreads();
  }
  // the final accepts: fit and quantum in every dim, no threshold exceeded
  // on a fresh node
#pragma unroll (R <= 4 ? R : 1)
  for (int r = 0; r < R; ++r) {
    const int i = tid + r * T;
    ok[r] = ok[r] && !(node_fresh[r] && over[r]) && !(prod[r] && node_fresh[r] && pover[r]);
    if (i < P) s_flags[i] = (ok[r] ? kAcc : 0) | (prod[r] ? kProd : 0);
  }

  // 6. The winners' charges, G dims a pass: the thread of each segment's
  // first row adds the segment's winners to its node's rows of the three
  // tables, row by row in sorted order, from the values its tests read.
#pragma unroll 1
  for (int d0 = 0; d0 < D; d0 += G) {
    const int gn = min(G, D - d0);
    // raw values of the gn dims, and each segment's last row (written by
    // that row, at the segment's first) in the third series' room
    int* s_end = (int*)(series + 2 * gn * lv.total);
#pragma unroll (R <= 4 ? R : 1)
    for (int r = 0; r < R; ++r) {
      const int i = tid + r * T;
      if (i >= P) continue;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (d >= d0 && d < d0 + gn) {
          series[(0 * gn + d - d0) * lv.total + i] = rq[r][d];
          series[(1 * gn + d - d0) * lv.total + i] = es[r][d];
        }
      }
      if (i == P - 1 || (keys[i + 1] >> 32) != (key[r] >> 32)) s_end[start[r]] = i;
    }
    __syncthreads();
#pragma unroll (R <= 4 ? R : 1)
    for (int r = 0; r < R; ++r) {
      const int i = tid + r * T;
      const int node = (int)(key[r] >> 32);
      if (i >= P || start[r] != i || node >= N) continue;
      float tr[D], te[D], tp[D];
#pragma unroll
      for (int d = 0; d < D; ++d) tr[d] = rq0[r][d], te[d] = eu0[r][d], tp[d] = pu0[r][d];
      // the adds are selected, not branched on, so the loads of later
      // rows do not wait for the sums of earlier ones
      bool any = false;
      const int end = s_end[i];
#pragma unroll 4
      for (int j = i; j <= end; ++j) {
        const int f = s_flags[j];
        const bool take = (f & kAcc) != 0, take_prod = take && (f & kProd);
        any = any || take;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          if (d >= d0 && d < d0 + gn) {
            const float v = series[(0 * gn + d - d0) * lv.total + j];
            const float e = series[(1 * gn + d - d0) * lv.total + j];
            tr[d] = take ? tr[d] + v : tr[d];
            te[d] = take ? te[d] + e : te[d];
            tp[d] = take_prod ? tp[d] + e : tp[d];
          }
        }
      }
      if (!any) continue;
      if (G == D) {
        store_row<D>(requested, node, tr);
        store_row<D>(est_used, node, te);
        store_row<D>(prod_used, node, tp);
      } else {
#pragma unroll
        for (int d = 0; d < D; ++d) {
          if (d >= d0 && d < d0 + gn) {
            const size_t at = (size_t)node * D + d;
            requested[at] = tr[d], est_used[at] = te[d], prod_used[at] = tp[d];
          }
        }
      }
    }
    __syncthreads();
  }

  // 7. The loop state (:1433-1452): un-sort the accepts onto `assigned`
  // (an accepted row's node key is its choice), active &= assigned < 0,
  // rounds += 1, done = !any(accepted) || !any(active).
  bool any_acc = false, any_active = false;
#pragma unroll (R <= 4 ? R : 1)
  for (int r = 0; r < R; ++r) {
    const int i = tid + r * T;
    if (i >= P) continue;
    const int row = (int)(key[r] & 0xFFFFFFFFu);
    if (ok[r]) {
      asg[r] = (int)(key[r] >> 32);
      assigned[row] = asg[r];
    }
    act[r] = act[r] && asg[r] < 0;
    active[row] = act[r];
    any_acc = any_acc || ok[r];
    any_active = any_active || act[r];
  }
  any_acc = __syncthreads_or(any_acc);
  any_active = __syncthreads_or(any_active);
  if (tid == 0) {
    state[1] = state[1] + 1;
    state[0] = any_acc && any_active ? 0 : 1;
  }
}

struct Args {
  const float *top_cost;
  const int* top_idx;
  const float *req, *est;
  const bool *is_prod, *cpu_bind;
  const float *cpu_amp, *alloc;
  const bool* fresh;
  const float *thr, *pthr;
  float *requested, *est_used, *prod_used;
  int* assigned;
  bool* active;
  int* state;
  float round_quantum;
  int P, N, K;
  cudaStream_t stream;
};

// The most shared memory a block may take on the current device.
int max_smem() {
  static int bytes = 0;
  if (bytes == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return bytes;
}

template <int D, int R>
cudaError_t launch(const Args& a, int threads) {
  // One block holds the whole round. The widest layout that fits: staged
  // pods and every dim in one pass first, then fewer dims a pass, then
  // the pods read from device memory; a round that fits in none is
  // refused. The attribute is set once per size, so a launch captured
  // into a CUDA graph after a warm-up makes no such call.
  const size_t most = (size_t)max_smem() - sizeof(ScanLevels) - kWarps * sizeof(int);
  int G = 0, staged = 1;
  for (; staged >= 0 && G == 0; --staged)
    for (int g = D; g >= 1 && G == 0; --g)
      if (round_smem_bytes(a.P, D, g, staged) <= most) G = g;
  ++staged;
  if (G == 0) return cudaErrorInvalidValue;
  const size_t smem = round_smem_bytes(a.P, D, G, staged);
  static size_t configured = 48 * 1024 - sizeof(ScanLevels) - kWarps * sizeof(int);
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        round_tail_kernel<D, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so the next launch's check is clean
      return err;
    }
    configured = smem;
  }
  round_tail_kernel<D, R><<<1, threads, smem, a.stream>>>(
      a.top_cost, a.top_idx, a.req, a.est, a.is_prod, a.cpu_bind, a.cpu_amp,
      a.alloc, a.fresh, a.thr, a.pthr, a.requested, a.est_used, a.prod_used,
      a.assigned, a.active, a.state, a.round_quantum, a.P, a.N, a.K, G, staged);
  return cudaGetLastError();
}

// Rows a thread: 1 up to a block of threads (the block then has P threads,
// rounded up to a warp), 4 up to 4 blocks' worth, else 16. Rounds above
// 4,096 pods fit in shared memory only at D <= 3 (12 P bytes and three
// series of 1.07 P floats), so only those widths build the 16-row kernel.
template <int D>
cudaError_t launch_rows(const Args& a) {
  if (a.P <= kThreads) return launch<D, 1>(a, max(32, (a.P + 31) / 32 * 32));
  if (a.P <= 4 * kThreads) return launch<D, 4>(a, kThreads);
  if constexpr (D <= 3) {
    if (a.P <= 16 * kThreads) return launch<D, 16>(a, kThreads);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int koord_round_tail(
    const void* top_cost, const void* top_idx, const void* req,
    const void* est, const void* is_prod, const void* cpu_bind,
    const void* cpu_amp, const void* alloc, const void* fresh,
    const void* thr, const void* pthr, void* requested, void* est_used,
    void* prod_used, void* assigned, void* active, void* state,
    float round_quantum, int P, int N, int D, int K, void* stream) {
  if (P <= 0) return (int)cudaSuccess;
  if (D < 1 || D > kMaxDims || N < 1 || K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  // rows are read and written as float2 / float4 where D allows
  const uintptr_t align = D % 4 == 0 ? 16 : D % 2 == 0 ? 8 : 4;
  for (const void* p : {req, est, alloc, thr, pthr, (const void*)requested,
                        (const void*)est_used, (const void*)prod_used})
    if ((uintptr_t)p % align != 0) return (int)cudaErrorMisalignedAddress;
  const Args a{(const float*)top_cost, (const int*)top_idx, (const float*)req,
               (const float*)est, (const bool*)is_prod, (const bool*)cpu_bind,
               (const float*)cpu_amp, (const float*)alloc, (const bool*)fresh,
               (const float*)thr, (const float*)pthr, (float*)requested,
               (float*)est_used, (float*)prod_used, (int*)assigned,
               (bool*)active, (int*)state, round_quantum, P, N, K,
               (cudaStream_t)stream};
  switch (D) {
    case 1: return (int)launch_rows<1>(a);
    case 2: return (int)launch_rows<2>(a);
    case 3: return (int)launch_rows<3>(a);
    case 4: return (int)launch_rows<4>(a);
    case 5: return (int)launch_rows<5>(a);
    case 6: return (int)launch_rows<6>(a);
    case 7: return (int)launch_rows<7>(a);
    case 8: return (int)launch_rows<8>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* koord_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
