// The tail of one solver round, in one launch: choice, stable node sort,
// segmented commit, with ElasticQuota the quota commit, and the round
// loop's state.
//
// koord_round_tail replaces, for the LoadAware branch of
// koordinator_tpu/ops/solver.py:assign, everything a round does between
// nomination and the next round: the rank-modular choice (:1204-1213), the
// stable sort of the pods by nominated node (:1215), the gather of the
// sorted rows with amplified CPU (:1217-1229), the segmented prefix sums and
// acceptance tests (:1230-1359), with quotas the cumulative admission along
// each pod's chain (_quota_commit :504-571, both static branches, called at
// :1362-1370), the winners' charges (:1362-1380), the carry update
// (:1433-1447, with quotas the next round's gate = active & headroom,
// :1105-1112) and the loop condition round_cond (:1450-1452). The loop
// state lives on the card: assigned [P], active [P] and a state word
// {done, rounds}. A launch that finds `done` set returns at once, so a
// caller may run a fixed number of rounds with no host read: a trip after
// the fixed point changes nothing.
//
// What bounds it on an H100: a chain of dependent steps, not bytes or
// operations. A round is a few hundred rows and a few tens of KB (a 10 ns
// byte bound); its floor is a scan, a sort, a scan and a segmented walk,
// each depending on the one before, on one SM. With quotas each chain
// level adds a sort and a prefix, and the charges a serial walk as long as
// the root's share of the round.
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
// - The quota commit (quota_commit below, its own instantiation: the round
//   without quotas keeps its registers) runs between the node acceptance
//   and the charges, in the shared memory of the node sort's keys and the
//   area, by priority position: per chain level a stable sort of
//   (quota, position) keys; the one-hot branch's per-column cumsum in XLA's
//   chunked order from chunk groups (a thread a quota's pods in one chunk
//   of 16) and one thread a quota scanning its chunk totals (ChunkScan);
//   the sorted branch's segmented prefix through the same cumsum machinery
//   as the node commit; then the final pods' requests onto the quota table
//   in the order XLA's CPU backend gives the reference's chain of adds
//   (ops/quota.py:charge_folds), a thread a quota, no float atomics.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <initializer_list>

#include "quota.cuh"

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


// ------------------------------------------------------------------ quotas
//
// The quota commit (koordinator_tpu/ops/solver.py:_quota_commit, :504-571)
// between the node acceptance and the winners' charges (:1362-1370), and
// the next round's gate (:1105-1112). Pods are handled by their priority
// position; a level's pods are sorted by (quota, position) with the pods
// that do not take part keyed Q, after them: the reference's stable
// argsort of the sorted branch, and, for the one-hot branch, the members
// of each quota column in position order.

// Bits of a priority position's quota flag.
constexpr int kNodeAcc = 1;  // accepted by its node this round
constexpr int kRefused = 2;  // refused at some level of its chain

// _quota_commit's static branch on the table's shape (:519).
__host__ __device__ inline bool onehot_branch(int Q, int D) { return (long long)Q * D <= 1024; }

// Bits of a priority position in a level's 32-bit sort key: at least 4,
// so that key >> 4 is the pair (quota, chunk of 16 positions).
__host__ __device__ inline int pos_bits(int P) {
  int b = 4;
  while ((1 << b) < P) ++b;
  return b;
}

// The quota phase's shared memory: it takes the node sort's keys and the
// area after them (the keys are read no more once each row knows whether
// it ends its node's segment). flags [P] int by priority position; the
// sorted keys of every level [L][P] uint32 (kept for the charges); the
// sort's second buffer [P] at one row a thread; the requests [P, D] by
// priority position; then, one-hot, each chunk group's total and then its
// chunk offset [P, D] at the group's first row and each row's group start
// and each group's end [P] uint16, or, sorted, D cumsum series.
struct QuotaLayout {
  size_t flags, lkey, buf1, sreq, ext, gs, gend, total;
};

__host__ __device__ inline QuotaLayout quota_layout(int P, int D, int Q, int L, int R) {
  QuotaLayout q{};
  if (L <= 0) return q;
  const bool onehot = onehot_branch(Q, D);
  size_t at = 0;
  q.flags = at;
  at += (size_t)P * sizeof(int);
  q.lkey = at;
  at += (size_t)L * P * sizeof(uint32_t);
  q.buf1 = at;
  if (R == 1) at += (size_t)P * sizeof(uint32_t);
  q.sreq = at;
  at += (size_t)P * D * sizeof(float);
  q.ext = at;
  at += onehot ? (size_t)P * D * sizeof(float) : (size_t)D * scan_levels(P).total * sizeof(float);
  q.gs = at;
  if (onehot) at += (size_t)P * sizeof(uint16_t);
  q.gend = at;
  if (onehot) at += (size_t)P * sizeof(uint16_t);
  q.total = at;
  return q;
}

// Sorts P unique 32-bit keys, k[r] of row tid + r * blockDim.x (rows past P
// ignored), ascending: on return k[r] holds the key of rank tid + r *
// blockDim.x and sk[0, P) the sorted keys. The whole block calls it.
template <int R>
__device__ void sort_rows_u32(uint32_t (&k)[R], int P, uint32_t* sk, uint32_t* buf1) {
  const int tid = threadIdx.x, T = blockDim.x;
  if constexpr (R == 1) {
    k[0] = block_sort<uint32_t>(tid < P ? k[0] : UINT32_MAX, P, sk, buf1, UINT32_MAX);
    __syncthreads();
    if (tid < P) sk[tid] = k[0];
  } else {
    int Lp = 1;
    while (Lp < P) Lp <<= 1;
#pragma unroll (R <= 4 ? R : 1)
    for (int r = 0; r < R; ++r)
      if (tid + r * T < P) sk[tid + r * T] = k[r];
    __syncthreads();
    for (int kk = 2; kk <= Lp; kk <<= 1) {
      for (int j = kk >> 1; j > 0; j >>= 1) {
        const bool flip = j == (kk >> 1);
        for (int t = tid; t < (Lp >> 1); t += T) {
          const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1));
          const int hi = flip ? (lo ^ (kk - 1)) : lo + j;
          if (hi < P) {
            const uint32_t a = sk[lo], b = sk[hi];
            if (b < a) {
              sk[lo] = b;
              sk[hi] = a;
            }
          }
        }
        __syncthreads();
      }
    }
#pragma unroll (R <= 4 ? R : 1)
    for (int r = 0; r < R; ++r)
      if (tid + r * T < P) k[r] = sk[tid + r * T];
  }
  __syncthreads();
}

// XLA's CPU cumsum order (chunks of 16, the chunk totals scanned the same
// way) over the chunk totals of one quota's column, a sparse series whose
// elements (y, the chunk; v, its total) arrive in increasing y: push adds
// one, query returns the cumsum at an index no element before it passes.
// Adding XLA's zeros of absent elements changes no bit, so only the
// elements are summed, in the reference's grouping. Rounds of up to 4,096
// pods (lv.n <= 2) have at most one level above the chunk totals, so the
// state fits in registers: level 1 holds the totals of the current chunk
// of 16 chunk totals, level 2 (the top, a plain running sum) the totals
// of level 1's chunks before it.
template <int D>
struct ChunkScan {
  bool chunked;  // level 1 is cut into chunks of 16 (lv.n == 2)
  int ch;
  bool has1, has2;
  float acc1[D], acc2[D];

  __device__ __forceinline__ void init(int levels) {
    chunked = levels >= 2;
    has1 = has2 = false;
    ch = 0;
  }

  // level 1's chunk before chunk c is complete: its total moves up
  __device__ __forceinline__ void close_before(int c) {
    if (!has1 || ch == c) return;
#pragma unroll
    for (int d = 0; d < D; ++d) acc2[d] = has2 ? acc2[d] + acc1[d] : acc1[d];
    has2 = true;
    has1 = false;
  }

  // element y (a chunk total) of level 1
  __device__ __forceinline__ void push(int y, const float (&v)[D]) {
    const int c = chunked ? y / kScanBase : 0;
    close_before(c);
#pragma unroll
    for (int d = 0; d < D; ++d) acc1[d] = has1 ? acc1[d] + v[d] : v[d];
    has1 = true;
    ch = c;
  }

  // level 1's cumsum at x: the sum inside x's chunk plus the top's
  __device__ __forceinline__ void query(int x, float (&out)[D]) {
    const int c = chunked ? x / kScanBase : 0;
    close_before(c);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float inner = has1 ? acc1[d] : 0.0f;
      out[d] = c > 0 ? inner + (has2 ? acc2[d] : 0.0f) : inner;
    }
  }
};

// One quota's groups in order (group g ends at gend[g]): each group's
// chunk offset — the chunk totals' cumsum at the chunk before it —
// replaces its total in ext, which then joins the scan.
template <int D>
__device__ void walk_groups(ChunkScan<D>& scan, int i, uint32_t q, int P, int pb, uint32_t pmask,
                            const uint32_t* sk, const uint16_t* gend, float* ext) {
  for (int g = i; g < P && (sk[g] >> pb) == q; g = gend[g] + 1) {
    const int c0 = (int)(sk[g] & pmask) / kScanBase;
    float tot[D];
#pragma unroll
    for (int d = 0; d < D; ++d) tot[d] = ext[(size_t)g * D + d];
    if (c0 > 0) {
      float off[D];
      scan.query(c0 - 1, off);
#pragma unroll
      for (int d = 0; d < D; ++d) ext[(size_t)g * D + d] = off[d];
    }
    scan.push(c0, tot);
  }
}

// The end of quota q's run of the level's sorted keys sk that starts at
// row i: the first row whose key is of a later quota (or P).
__device__ __forceinline__ int segment_end(const uint32_t* sk, int i, int P, uint32_t q, int pb) {
  int lo = i + 1, hi = P;
  const uint32_t next = (q + 1u) << pb;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sk[mid] < next) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// _quota_commit on the round's node acceptance: ok[r] (row tid + r * T of
// the node sort, pod key[r] & 0xFFFFFFFF) is cleared where the pod fails a
// level of its chain, counting the node-accepted pods of its quota before
// it in priority order; qused takes the final pods' requests. `qarea` is
// the shared memory from the node sort's keys on (quota_layout), free
// from here to the charges. The whole block calls it.
//
// Costs: a sort of P keys a level; the one-hot branch's chunk sums (a
// thread a group of at most 16) and one thread a quota walking its groups;
// the sorted branch's series cumsum; and the charges, one thread a quota
// adding its final pods in order — a serial chain as long as the largest
// quota's share of the round (the root's: every pod), read from shared
// memory.
template <int D, int R>
__device__ void quota_commit(bool (&ok)[R], const uint64_t (&key)[R], int P, char* qarea,
                             const ScanLevels& lv, int* warp_sums,
                             const float* __restrict__ req, const int* __restrict__ chain,
                             const float* __restrict__ runtime, float* qused, int Q, int L) {
  const int tid = threadIdx.x, T = blockDim.x;
  const QuotaLayout ql = quota_layout(P, D, Q, L, R);
  int* flags = (int*)(qarea + ql.flags);
  uint32_t* lkeys = (uint32_t*)(qarea + ql.lkey);
  uint32_t* buf1 = (uint32_t*)(qarea + ql.buf1);
  float* sreq = (float*)(qarea + ql.sreq);
  float* ext = (float*)(qarea + ql.ext);
  uint16_t* gs = (uint16_t*)(qarea + ql.gs);
  uint16_t* gend = (uint16_t*)(qarea + ql.gend);
  const bool onehot = onehot_branch(Q, D);
  const int pb = pos_bits(P);
  const uint32_t pmask = (1u << pb) - 1u;

  __syncthreads();  // the node sort's keys are read no more
  for (int i = tid; i < P * D; i += T) sreq[i] = req[i];
#pragma unroll (R <= 4 ? R : 1)
  for (int r = 0; r < R; ++r)
    if (tid + r * T < P) flags[(int)(key[r] & 0xFFFFFFFFu)] = ok[r] ? kNodeAcc : 0;
  __syncthreads();

  // levels where some pod takes part (a level no pod takes part in, as an
  // open top level, admits and charges nothing: it is skipped)
  unsigned long long live = 0;
  for (int l = 0; l < L; ++l) {
    // q1. The level's stable sort: (quota << pb | position), the pods that
    // do not take part keyed Q
    uint32_t* sk = lkeys + (size_t)l * P;
    uint32_t k[R];
    bool part = false;
#pragma unroll (R <= 4 ? R : 1)
    for (int r = 0; r < R; ++r) {
      const int pos = tid + r * T;
      k[r] = UINT32_MAX;
      if (pos < P) {
        const int c = chain[(size_t)pos * L + l];
        const int q = (flags[pos] & kNodeAcc) && c >= 0 && c < Q ? c : Q;
        k[r] = ((uint32_t)q << pb) | (uint32_t)pos;
        part = part || q < Q;
      }
    }
    if (l < 64) {
      if (!__syncthreads_or(part)) continue;
      live |= 1ull << l;
    }
    sort_rows_u32<R>(k, P, sk, buf1);

    if (onehot) {
      // q2. One-hot, each quota column's cumsum along P in XLA's order:
      // (a) a thread a group (a quota's pods in one chunk of 16
      // positions): the group's total, each row's group start and the
      // group's end
#pragma unroll (R <= 4 ? R : 1)
      for (int r = 0; r < R; ++r) {
        const int i = tid + r * T;
        if (i >= P) continue;
        const uint32_t head = k[r] >> 4;  // quota and chunk
        if ((int)(k[r] >> pb) >= Q || (i > 0 && (sk[i - 1] >> 4) == head)) continue;
        float tot[D];
        int j = i;
        for (; j < P && (sk[j] >> 4) == head; ++j) {
          const float* v = sreq + (size_t)(sk[j] & pmask) * D;
#pragma unroll
          for (int d = 0; d < D; ++d) tot[d] = j == i ? v[d] : tot[d] + v[d];
          gs[j] = (uint16_t)i;
        }
        gend[i] = (uint16_t)(j - 1);
#pragma unroll
        for (int d = 0; d < D; ++d) ext[(size_t)i * D + d] = tot[d];
      }
      __syncthreads();
      // q3. (b) a thread a quota: the chunk totals' scan, each group's
      // offset (its total read first, then overwritten)
      if (lv.n > 0) {
#pragma unroll (R <= 4 ? R : 1)
        for (int r = 0; r < R; ++r) {
          const int i = tid + r * T;
          if (i >= P) continue;
          const uint32_t q = k[r] >> pb;
          if ((int)q >= Q || (i > 0 && (sk[i - 1] >> pb) == q)) continue;
          ChunkScan<D> scan;
          scan.init(lv.n);
          walk_groups<D>(scan, i, q, P, pb, pmask, sk, gend, ext);
        }
        __syncthreads();
      }
      // q4. (c) each pod: its column's cumsum at its place — the sum
      // inside its chunk, from its group's first row, plus the chunk
      // offset — and the test
#pragma unroll (R <= 4 ? R : 1)
      for (int r = 0; r < R; ++r) {
        const int i = tid + r * T;
        const int q = (int)(k[r] >> pb), pos = (int)(k[r] & pmask);
        if (i >= P || q >= Q) continue;
        const int g = gs[i];
        float own[D];
        for (int j = g; j <= i; ++j) {
          const float* v = sreq + (size_t)(sk[j] & pmask) * D;
#pragma unroll
          for (int d = 0; d < D; ++d) own[d] = j == g ? v[d] : own[d] + v[d];
        }
        bool fits = true;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float o = pos >= kScanBase ? own[d] + ext[(size_t)g * D + d] : own[d];
          fits = fits && qused[(size_t)q * D + d] + o <= runtime[(size_t)q * D + d] + kEps;
        }
        if (!fits) flags[pos] |= kRefused;
      }
    } else {
      // q5. Sorted: the segmented prefix of the key-sorted rows
      // (_segment_prefix_sums, :574-584) — the round's cumsum machinery
      int start[R];
      int carry = 0;
#pragma unroll (R <= 4 ? R : 1)
      for (int r = 0; r < R; ++r) {
        const int i = tid + r * T;
        const int q = (int)(k[r] >> pb), pos = (int)(k[r] & pmask);
        if (i < P) {
#pragma unroll
          for (int d = 0; d < D; ++d)
            ext[(size_t)d * lv.total + pad0(i)] = q < Q ? sreq[(size_t)pos * D + d] : 0.0f;
        }
        const bool first = i < P && (i == 0 || (int)(sk[i - 1] >> pb) != q);
        start[r] = block_scan(first ? i : 0, warp_sums, carry, Max());
      }
      __syncthreads();
      series_cumsum(ext, D, lv);
#pragma unroll (R <= 4 ? R : 1)
      for (int r = 0; r < R; ++r) {
        const int i = tid + r * T;
        const int q = (int)(k[r] >> pb), pos = (int)(k[r] & pmask);
        if (i >= P || q >= Q) continue;
        const int st = start[r];
        bool fits = true;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float* c = ext + (size_t)d * lv.total;
          const float seg = st > 0 ? cum_at(c, i, lv) - cum_at(c, st - 1, lv) : cum_at(c, i, lv) - 0.0f;
          fits = fits && qused[(size_t)q * D + d] + seg <= runtime[(size_t)q * D + d] + kEps;
        }
        if (!fits) flags[pos] |= kRefused;
      }
    }
    __syncthreads();
  }

  // q6. The final pods' requests onto their quotas, level after level, in
  // the order XLA's CPU backend evaluates used + segment_sum(level 0) + ...:
  // a level is folded (added row by row onto the running table) when the
  // table is not a scatter's result, or merged into that scatter (its rows
  // after the scatter's) while the merged rows stay fewer than Q; else its
  // sum is taken first (0 + v0 + v1 + ...) and added whole
  // (ops/quota.py:charge_folds)
  bool scatter = false;
  int rows = 0;
  for (int l = 0; l < L; ++l) {
    bool fold = true;
    if (scatter && rows + P < Q) {
      rows += P;
    } else if (scatter) {
      fold = false;
      scatter = false;
    } else {
      scatter = true;
      rows = P;
    }
    if (l < 64 && !((live >> l) & 1)) continue;  // nothing charged at this level
    const uint32_t* sk = lkeys + (size_t)l * P;
#pragma unroll (R <= 4 ? R : 1)
    for (int r = 0; r < R; ++r) {
      const int i = tid + r * T;
      if (i >= P) continue;
      const uint32_t q = sk[i] >> pb;
      if ((int)q >= Q || (i > 0 && (sk[i - 1] >> pb) == q)) continue;
      const int end = segment_end(sk, i, P, q, pb);
      float run[D], sum[D];
      bool any = false;
#pragma unroll
      for (int d = 0; d < D; ++d) run[d] = sum[d] = qused[(size_t)q * D + d];
#pragma unroll 4
      for (int j = i; j < end; ++j) {
        const int pj = (int)(sk[j] & pmask);
        const bool take = !(flags[pj] & kRefused);
        const float* v = sreq + (size_t)pj * D;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          if (fold) run[d] = take ? run[d] + v[d] : run[d];
          else sum[d] = take ? (any ? sum[d] + v[d] : v[d]) : sum[d];
        }
        any = any || take;
      }
      if (any) {
#pragma unroll
        for (int d = 0; d < D; ++d)
          qused[(size_t)q * D + d] = fold ? run[d] : run[d] + sum[d];
      }
    }
    __syncthreads();
  }

  // q7. A node-accepted pod refused by a quota is not accepted
#pragma unroll (R <= 4 ? R : 1)
  for (int r = 0; r < R; ++r)
    if (tid + r * T < P) ok[r] = ok[r] && !(flags[(int)(key[r] & 0xFFFFFFFFu)] & kRefused);
  __syncthreads();
}

// Shared layout: keys[P] uint64, then one area used in turn, then
// s_flags[P] int (a sorted row's accept and prod flags). The area holds
// - while choosing and sorting, the sort's second buffer of P keys and,
//   when `staged`, the pods' columns in priority order: request [P, D],
//   estimate [P, D], bits [P], assigned [P];
// - from the tests on, 3 G series of lv.total floats (G dims a pass);
// - with quotas, between the tests and the charges, the quota phase's
//   `qbytes` (quota_layout), from the keys on: the keys and the area.
__host__ __device__ inline size_t area_bytes(int P, int D, int G, int staged, size_t qbytes) {
  const size_t series = (size_t)3 * G * scan_levels(P).total * sizeof(float);
  const size_t sorting = (size_t)P * (sizeof(uint64_t) + (staged ? 8 * D + 8 : 0));
  const size_t keys = (size_t)P * sizeof(uint64_t);
  const size_t quota = qbytes > keys ? qbytes - keys : 0;
  const size_t most = series > sorting ? series : sorting;
  return most > quota ? most : quota;
}

size_t round_smem_bytes(int P, int D, int G, int staged, size_t qbytes) {
  return (size_t)P * (sizeof(uint64_t) + sizeof(int)) + area_bytes(P, D, G, staged, qbytes);
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
template <int D, int R, bool kQuota>
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
                  float round_quantum, int P, int N, int K, int G, int staged,
                  const int* __restrict__ chain, const float* __restrict__ runtime,
                  float* qused, bool* __restrict__ gate, int Q, int levels, int qbytes) {
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
  int* s_flags = (int*)((char*)keys2 + area_bytes(P, D, G, staged, qbytes));  // [P]
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
  // the node's accepts: fit and quantum in every dim, no threshold
  // exceeded on a fresh node
#pragma unroll (R <= 4 ? R : 1)
  for (int r = 0; r < R; ++r)
    ok[r] = ok[r] && !(node_fresh[r] && over[r]) && !(prod[r] && node_fresh[r] && pover[r]);
  // 6. With quotas, the quota commit: each row first notes whether it ends
  // its node's segment (the charges below need it; the quota phase then
  // takes the keys' room), and only the pods that also clear their chains
  // stay accepted (:1362-1370)
  bool last[R];
  if constexpr (kQuota) {
#pragma unroll (R <= 4 ? R : 1)
    for (int r = 0; r < R; ++r) {
      const int i = tid + r * T;
      last[r] = i < P && (i == P - 1 || (keys[i + 1] >> 32) != (key[r] >> 32));
    }
    quota_commit<D, R>(ok, key, P, (char*)keys, lv, warp_sums, req, chain, runtime, qused, Q,
                       levels);
  }
#pragma unroll (R <= 4 ? R : 1)
  for (int r = 0; r < R; ++r) {
    const int i = tid + r * T;
    if (i < P) s_flags[i] = (ok[r] ? kAcc : 0) | (prod[r] ? kProd : 0);
  }

  // 7. The winners' charges, G dims a pass: the thread of each segment's
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
      const bool ends = kQuota ? last[r]
                               : i == P - 1 || (keys[i + 1] >> 32) != (key[r] >> 32);
      if (ends) s_end[start[r]] = i;
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

  // 8. The loop state (:1433-1452): un-sort the accepts onto `assigned`
  // (an accepted row's node key is its choice), active &= assigned < 0,
  // rounds += 1, done = !any(accepted) || !any(active); with quotas the
  // accepts are the pods that cleared them (progress = any(final_prio),
  // :1446), and each pod's gate for the next round is its active flag and
  // its headroom in the table just committed.
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
    if constexpr (kQuota)
      gate[row] = act[r] && koord_quota::headroom(req + (size_t)row * D,
                                                  chain + (size_t)row * levels, levels, runtime,
                                                  qused, Q, D);
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
  int P, N, D, K;
  const int* chain;
  const float* runtime;
  float* qused;
  bool* gate;
  int Q, L;
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

template <int D, int R, bool kQuota>
cudaError_t launch(const Args& a, int threads) {
  // One block holds the whole round. The widest layout that fits: staged
  // pods and every dim in one pass first, then fewer dims a pass, then
  // the pods read from device memory; a round that fits in none is
  // refused. The attribute is set once per size, so a launch captured
  // into a CUDA graph after a warm-up makes no such call.
  const size_t most = (size_t)max_smem() - sizeof(ScanLevels) - kWarps * sizeof(int);
  const size_t qbytes = kQuota ? quota_layout(a.P, D, a.Q, a.L, R).total : 0;
  int G = 0, staged = 1;
  for (; staged >= 0 && G == 0; --staged)
    for (int g = D; g >= 1 && G == 0; --g)
      if (round_smem_bytes(a.P, D, g, staged, qbytes) <= most) G = g;
  ++staged;
  if (G == 0) return cudaErrorInvalidValue;
  const size_t smem = round_smem_bytes(a.P, D, G, staged, qbytes);
  static size_t configured = 48 * 1024 - sizeof(ScanLevels) - kWarps * sizeof(int);
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        round_tail_kernel<D, R, kQuota>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so the next launch's check is clean
      return err;
    }
    configured = smem;
  }
  round_tail_kernel<D, R, kQuota><<<1, threads, smem, a.stream>>>(
      a.top_cost, a.top_idx, a.req, a.est, a.is_prod, a.cpu_bind, a.cpu_amp,
      a.alloc, a.fresh, a.thr, a.pthr, a.requested, a.est_used, a.prod_used,
      a.assigned, a.active, a.state, a.round_quantum, a.P, a.N, a.K, G, staged, a.chain,
      a.runtime, a.qused, a.gate, a.Q, a.L, (int)qbytes);
  return cudaGetLastError();
}

// Rows a thread: 1 up to a block of threads (the block then has P threads,
// rounded up to a warp), 4 up to 4 blocks' worth, else 16. Rounds above
// 4,096 pods fit in shared memory only at D <= 3 (12 P bytes and three
// series of 1.07 P floats), so only those widths build the 16-row kernel.
// The round with quotas is its own instantiation (kQuota), so the round
// without them keeps its registers; it takes up to 4,096 pods (the JAX
// scheduler's batch bucket: the chunk totals' scan keeps at most two
// levels in registers).
template <int D, bool kQuota>
cudaError_t launch_rows(const Args& a) {
  if (a.P <= kThreads) return launch<D, 1, kQuota>(a, max(32, (a.P + 31) / 32 * 32));
  if (a.P <= 4 * kThreads) return launch<D, 4, kQuota>(a, kThreads);
  if constexpr (D <= 3 && !kQuota) {
    if (a.P <= 16 * kThreads) return launch<D, 16, kQuota>(a, kThreads);
  }
  return cudaErrorInvalidValue;
}

template <bool kQuota>
cudaError_t launch_d(const Args& a) {
  switch (a.D) {
    case 1: return launch_rows<1, kQuota>(a);
    case 2: return launch_rows<2, kQuota>(a);
    case 3: return launch_rows<3, kQuota>(a);
    case 4: return launch_rows<4, kQuota>(a);
    case 5: return launch_rows<5, kQuota>(a);
    case 6: return launch_rows<6, kQuota>(a);
    case 7: return launch_rows<7, kQuota>(a);
    case 8: return launch_rows<8, kQuota>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int koord_round_tail(
    const void* top_cost, const void* top_idx, const void* req,
    const void* est, const void* is_prod, const void* cpu_bind,
    const void* cpu_amp, const void* alloc, const void* fresh,
    const void* thr, const void* pthr, void* requested, void* est_used,
    void* prod_used, void* assigned, void* active, void* state,
    float round_quantum, int P, int N, int D, int K, const void* chain,
    const void* runtime, void* qused, void* gate, int Q, int L, void* stream) {
  if (P <= 0) return (int)cudaSuccess;
  if (D < 1 || D > kMaxDims || N < 1 || K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  // a level's sort key (quota << position bits | position) must fit 32 bits
  if (chain != nullptr &&
      (Q < 1 || L < 1 || ((unsigned long long)Q + 1) << pos_bits(P) >= (1ull << 32)))
    return (int)cudaErrorInvalidValue;
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
               (bool*)active, (int*)state, round_quantum, P, N, D, K, (const int*)chain,
               (const float*)runtime, (float*)qused, (bool*)gate, Q, L,
               (cudaStream_t)stream};
  return (int)(chain != nullptr ? launch_d<true>(a) : launch_d<false>(a));
}

extern "C" const char* koord_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
