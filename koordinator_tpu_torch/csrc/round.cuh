// The tail of one solver round, in one launch: choice, stable node sort,
// segmented commit, with ElasticQuota the quota commit, with NUMA zones the
// zone selection and charges, with DeviceShare the device acceptance and
// charges, and the round loop's state. The kernel and its launch; the
// entries are round.cu (LoadAware and quotas, up to 4,096 pods, and 16,384
// at D <= 3), round_zone.cu (the zone instantiations) and round_big.cu (any
// round up to 32,768 pods, its working set in device memory, and the route
// that picks among the three).
//
// The kernel replaces, for the LoadAware branch of
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
// - The zone phase (kZone, its own instantiation: the rounds without NUMA
//   keep their registers) replaces the zone selection of :1275-1332 and
//   the zone charges of :1417-1432. It runs on the node acceptance of the
//   fit tests alone, as the reference's does (the threshold and quantum
//   tests come after it there; all are ANDed): one thread a node segment
//   walks its rows in sorted order, counting the zone candidates
//   (SINGLE_NUMA_NODE node, cpuset-bound or required pod, a node with
//   zones); the fifth and later are refused this round; each of the first
//   four still accepted takes the strategy-ordered zone of zone_pick
//   (numa.py:48-75) against a copy of the node's zone rows that the ranks
//   before it charged — the ranks one after another, as the reference's
//   fori_loop runs them — and a candidate that must align and finds no
//   zone is refused. After the quota commit the same thread takes the
//   final winners' requests off their zones, each zone's charges summed
//   first in row order and then subtracted (`zone_free - segment_sum`,
//   the order XLA's CPU backend gives the reference), and each winner's
//   pick is written to its pod. The zone rows are Z x DN floats a node;
//   the phase's per-row flags, picks, ends and requests take P (3 + DN)
//   words after the flags.
// - Above 4,096 pods, or where shared memory is short, or with quotas
//   whose 32-bit level keys would overflow, the round runs with 32 rows a
//   thread and its whole working set (the keys, the cumsum series, the
//   quota, zone and device areas) in a device-memory scratch buffer of the
//   launch's own (kGlobal; a few MB at 32,768 pods, which stays in L2).
//   The code is the same: the working set is reached through generic
//   pointers, and barriers order device memory within the block as they
//   order shared memory. There the quota levels' sort keys are 64 bits and
//   the chunk totals' scan keeps any number of levels (ChunkScanDeep), and
//   the quota commit and the zone phase run in frames of their own (see
//   quota_commit_apart). Its rounds reach 32,768 pods (a gang larger than
//   the JAX scheduler's bucket, padded); the row loops with a barrier run
//   over the rows present only, so a smaller round pays no barrier for
//   rows it does not have.
// - The device phase (DeviceShare, solver.py:1246-1274 and :1386-1416) is
//   a run-time branch of every instantiation (devices.slots != nullptr),
//   each half in a frame of its own that takes only the working set and
//   the tables (device_accept, device_charge): after the fit tests, one
//   thread a node segment walks its rows in sorted order with the whole
//   GPUs asked for so far (plus one for each share pod that opens a full
//   slot: its share above the node's round-start best partial slot), the
//   share pods so far and the RDMA and FPGA so far — small whole numbers,
//   exact in any order — against the node's round-start stats and free
//   counts, and refuses the rows past them and every share pod but the
//   segment's first; it runs before the zone selection, as the
//   reference's acceptance does. After the node charges the same thread
//   applies slot_commit to the node's slot row (device.cuh) from its final
//   winners, takes their RDMA and FPGA off the free counts, and refreshes
//   the node's row of the stats table, which the next round's pricing
//   reads (device_prep.cu works it out once a batch). The rows hand their
//   flags to the phase through two words a row of the working set.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "device.cuh"
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
constexpr int kLast = 4;  // the last row of its node's segment (with quotas)

// rows a thread of the shared-memory round at D <= 3 (up to 16,384 pods)
constexpr int kBigRows = 16;
// rows a thread of the device-memory round (up to 32,768 pods)
constexpr int kGlobalRows = 32;

// NUMA zones (ops/numa.py): at most this many a node and dims a zone
constexpr int kMaxZones = 8;
constexpr int kMaxZoneDims = 4;
constexpr int kZoneWinners = 4;       // solver.ZONE_WINNERS_PER_ROUND
constexpr int kPolicySingleNuma = 3;  // numa.POLICY_SINGLE_NUMA_NODE
// bits of a sorted row in the zone phase
constexpr int kZoneCand = 1, kZoneStrict = 2, kZoneFit = 4;
constexpr int kZoneRefused = -2;  // a row's result: refused (-1: no zone)

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
// sorted keys of every level [L][P] (QuotaKey, kept for the charges); the
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
  const size_t kb = R > 4 ? sizeof(uint64_t) : sizeof(uint32_t);  // QuotaKey<R>
  at = (at + 7) / 8 * 8;
  q.lkey = at;
  at += (size_t)L * P * kb;
  q.buf1 = at;
  if (R == 1) at += (size_t)P * kb;
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

// The key type of a quota level's sort: 32 bits in shared memory, 64 in
// the device-memory round (where Q may be as large as an int).
template <int R>
using QuotaKey = typename std::conditional<(R > 4), uint64_t, uint32_t>::type;

// Sorts P unique keys, k[r] of row tid + r * blockDim.x (rows past P
// ignored), ascending: on return k[r] holds the key of rank tid + r *
// blockDim.x and sk[0, P) the sorted keys. The whole block calls it.
template <class KeyT, int R>
__device__ void sort_rows(KeyT (&k)[R], int P, KeyT* sk, KeyT* buf1) {
  const int tid = threadIdx.x, T = blockDim.x;
  if constexpr (R == 1) {
    k[0] = block_sort<KeyT>(tid < P ? k[0] : (KeyT)~(KeyT)0, P, sk, buf1, (KeyT)~(KeyT)0);
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
            const KeyT a = sk[lo], b = sk[hi];
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

// ChunkScan for any number of levels (the device-memory round: 32,768
// pods have three levels above the base). Level k of 1..n (n = lv.n) is
// cut into chunks of 16 below the top, level n, a plain running sum. Each
// level keeps its open chunk's sum; when an element of a later chunk
// arrives, the open chunks it passes move up, the highest first, so each
// level receives its elements in increasing order and sums them in the
// reference's grouping.
template <int D>
struct ChunkScanDeep {
  int n;
  bool has[kMaxLevels];
  int ch[kMaxLevels];
  float acc[kMaxLevels][D];

  __device__ __forceinline__ void init(int levels) {
    n = levels;
    for (int k = 0; k < kMaxLevels; ++k) {
      has[k] = false;
      ch[k] = 0;
    }
  }

  __device__ __forceinline__ void add(int k, const float (&v)[D]) {
#pragma unroll
    for (int d = 0; d < D; ++d) acc[k][d] = has[k] ? acc[k][d] + v[d] : v[d];
    has[k] = true;
  }

  // An element of index x arrives at level k (< n): every open chunk it
  // passes moves up.
  __device__ __forceinline__ void settle(int k, int x) {
    int m = k - 1, xin = x;
    for (int j = k; j < n && has[j] && ch[j] != xin / kScanBase; ++j) {
      m = j;
      xin = ch[j];
    }
    for (int j = m; j >= k; --j) {
      if (j + 1 < n && !has[j + 1]) ch[j + 1] = ch[j] / kScanBase;
      add(j + 1, acc[j]);
      has[j] = false;
    }
  }

  // element y (a chunk total) of level 1
  __device__ __forceinline__ void push(int y, const float (&v)[D]) {
    if (n > 1) {
      settle(1, y);
      if (!has[1]) ch[1] = y / kScanBase;
    }
    add(1, v);
  }

  // level 1's cumsum at x: the sum inside x's chunk plus the cumsum of the
  // level above at the chunk before, and so on up
  __device__ __forceinline__ void query(int x, float (&out)[D]) {
    float part[kMaxLevels][D];
    int depth = 0;
    for (int k = 1;; ++k) {
      if (k < n) settle(k, x);
#pragma unroll
      for (int d = 0; d < D; ++d) part[depth][d] = has[k] ? acc[k][d] : 0.0f;
      ++depth;
      const int c = x / kScanBase;
      if (k >= n || c == 0) break;
      x = c - 1;
    }
#pragma unroll
    for (int d = 0; d < D; ++d) out[d] = part[depth - 1][d];
    for (int i = depth - 2; i >= 0; --i) {
#pragma unroll
      for (int d = 0; d < D; ++d) out[d] = part[i][d] + out[d];
    }
  }
};

// One quota's groups in order (group g ends at gend[g]): each group's
// chunk offset — the chunk totals' cumsum at the chunk before it —
// replaces its total in ext, which then joins the scan.
template <int D, class Scan, class KeyT>
__device__ void walk_groups(Scan& scan, int i, KeyT q, int P, int pb, KeyT pmask,
                            const KeyT* sk, const uint16_t* gend, float* ext) {
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
template <class KeyT>
__device__ __forceinline__ int segment_end(const KeyT* sk, int i, int P, KeyT q, int pb) {
  int lo = i + 1, hi = P;
  const KeyT next = (q + 1) << pb;
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
  using KeyT = QuotaKey<R>;
  const int tid = threadIdx.x, T = blockDim.x;
  const QuotaLayout ql = quota_layout(P, D, Q, L, R);
  int* flags = (int*)(qarea + ql.flags);
  KeyT* lkeys = (KeyT*)(qarea + ql.lkey);
  KeyT* buf1 = (KeyT*)(qarea + ql.buf1);
  float* sreq = (float*)(qarea + ql.sreq);
  float* ext = (float*)(qarea + ql.ext);
  uint16_t* gs = (uint16_t*)(qarea + ql.gs);
  uint16_t* gend = (uint16_t*)(qarea + ql.gend);
  const bool onehot = onehot_branch(Q, D);
  const int pb = pos_bits(P);
  const KeyT pmask = ((KeyT)1 << pb) - 1;

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
    KeyT* sk = lkeys + (size_t)l * P;
    KeyT k[R];
    bool part = false;
#pragma unroll (R <= 4 ? R : 1)
    for (int r = 0; r < R; ++r) {
      const int pos = tid + r * T;
      k[r] = (KeyT)~(KeyT)0;
      if (pos < P) {
        const int c = chain[(size_t)pos * L + l];
        const int q = (flags[pos] & kNodeAcc) && c >= 0 && c < Q ? c : Q;
        k[r] = ((KeyT)q << pb) | (KeyT)pos;
        part = part || q < Q;
      }
    }
    if (l < 64) {
      if (!__syncthreads_or(part)) continue;
      live |= 1ull << l;
    }
    sort_rows<KeyT, R>(k, P, sk, buf1);

    if (onehot) {
      // q2. One-hot, each quota column's cumsum along P in XLA's order:
      // (a) a thread a group (a quota's pods in one chunk of 16
      // positions): the group's total, each row's group start and the
      // group's end
#pragma unroll (R <= 4 ? R : 1)
      for (int r = 0; r < R; ++r) {
        const int i = tid + r * T;
        if (i >= P) continue;
        const KeyT head = k[r] >> 4;  // quota and chunk
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
          const KeyT q = k[r] >> pb;
          if ((long long)q >= Q || (i > 0 && (sk[i - 1] >> pb) == q)) continue;
          if constexpr (R > 4) {
            ChunkScanDeep<D> scan;
            scan.init(lv.n);
            walk_groups<D>(scan, i, q, P, pb, pmask, sk, gend, ext);
          } else {
            ChunkScan<D> scan;
            scan.init(lv.n);
            walk_groups<D>(scan, i, q, P, pb, pmask, sk, gend, ext);
          }
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
    const KeyT* sk = lkeys + (size_t)l * P;
#pragma unroll (R <= 4 ? R : 1)
    for (int r = 0; r < R; ++r) {
      const int i = tid + r * T;
      if (i >= P) continue;
      const KeyT q = sk[i] >> pb;
      if ((long long)q >= Q || (i > 0 && (sk[i - 1] >> pb) == q)) continue;
      const int end = segment_end<KeyT>(sk, i, P, q, pb);
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
// s_flags[P] int (a sorted row's accept and prod flags), then with zones
// the zone phase's `zbytes` (zone_bytes). The area holds
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

// The zone phase's words: each sorted row's bits, result and (at a
// segment's first row) the segment's end, then its zone request [P, DN].
__host__ __device__ inline size_t zone_bytes(int P, int DN) {
  return (size_t)P * (3 + DN) * sizeof(int);
}

size_t round_smem_bytes(int P, int D, int G, int staged, size_t qbytes, size_t zbytes = 0) {
  return (size_t)P * (sizeof(uint64_t) + sizeof(int)) + area_bytes(P, D, G, staged, qbytes) +
         zbytes;
}

// The NUMA zones of a round: the carried table [N, Z, DN] (charged in
// place), the capacities, the nodes' policies and MostAllocated flags, the
// priority-sorted pods' required flags and zone picks [P] (-1: none).
struct RoundZones {
  float* free;
  const float* cap;
  const int8_t* policy;
  const bool* most;
  const bool* required;
  int* pod_zone;
  int Z, DN;
};

// zone_pick (numa.py:48-75) of one request against a node's zone rows zf
// (the copy the ranks before charged) and capacities cp: the zone where it
// fits within 1e-3 in every dim, among zones with some capacity, of least
// (cap0 - free0 + 1) / (cap0 + 1), or of greatest under MostAllocated; the
// first on ties. -1 when none fits.
__device__ __forceinline__ int zone_pick(const float (&zf)[kMaxZones][kMaxZoneDims],
                                         const float* cp, const float* req, bool most, int Z,
                                         int DN) {
  int best = -1;
  float best_key = CUDART_INF_F;
  for (int z = 0; z < Z; ++z) {
    bool fit = true, real = false;
    for (int d = 0; d < DN; ++d) {
      fit = fit && zf[z][d] >= req[d] - 1e-3f;
      real = real || cp[z * DN + d] > 0.0f;
    }
    if (!(fit && real)) continue;
    const float used0 = cp[z * DN] - zf[z][0];
    const float util = (used0 + 1.0f) / (cp[z * DN] + 1.0f);
    const float key = most ? -util : util;
    if (best < 0 || key < best_key) {
      best = z;
      best_key = key;
    }
  }
  return best;
}

// The zone selection (solver.py:1275-1332) on the rows' fit acceptance
// ok[r]: each row's bits and zone request (its first DN dims, CPU already
// amplified for cpuset-bound pods) go to z_bits / z_req; the thread of
// each node segment's first row walks the segment in sorted order with a
// copy of the node's zone rows, ranks the candidates, refuses the fifth
// and later, picks a zone for each of the first four still accepted (the
// pick charged to the copy before the next rank's) and refuses a strict
// candidate with none; then each row reads its result: ok[r] cleared when
// refused, zsel[r] the pick (-1 none). It also notes each segment's end
// for the charges. The whole block calls it.
template <int D, int R>
__device__ void zone_select(bool (&ok)[R], int (&zsel)[R], const uint64_t (&key)[R],
                            const int (&start)[R], const float (&rq)[R][D],
                            const bool (&bound)[R], int P, int N, const uint64_t* keys,
                            int* z_bits, int* z_res, int* z_end, float* z_req,
                            const RoundZones& zn) {
  const int tid = threadIdx.x, T = blockDim.x;
  const int Z = zn.Z, DN = zn.DN;
  // z1. Each row's bits (candidate, strict, fit) and zone request
#pragma unroll (R <= 4 ? R : 1)
  for (int r = 0; r < R; ++r) {
    const int i = tid + r * T;
    if (i >= P) continue;
    const int node = (int)(key[r] >> 32);
    int bits = 0;
    if (node < N) {
      const int row = (int)(key[r] & 0xFFFFFFFFu);
      const bool single = zn.policy[node] == kPolicySingleNuma;
      const bool required = zn.required[row];
      // node_has_zones: a zone whose capacities sum (over DN, in order) > 0
      bool has_zones = false;
      for (int z = 0; z < Z; ++z) {
        float s = 0.0f;
        for (int d = 0; d < DN; ++d) s = d == 0 ? zn.cap[((size_t)node * Z + z) * DN]
                                                : s + zn.cap[((size_t)node * Z + z) * DN + d];
        has_zones = has_zones || s > 0.0f;
      }
      if ((single || bound[r] || required) && has_zones) bits |= kZoneCand;
      if (single || required) bits |= kZoneStrict;
      if (ok[r]) bits |= kZoneFit;
    }
    z_bits[i] = bits;
    constexpr int DZ = D < kMaxZoneDims ? D : kMaxZoneDims;
#pragma unroll
    for (int d = 0; d < DZ; ++d)
      if (d < DN) z_req[(size_t)i * DN + d] = rq[r][d];
  }
  __syncthreads();
  // z2. A thread a node segment: the candidates' ranks and zone picks
#pragma unroll (R <= 4 ? R : 1)
  for (int r = 0; r < R; ++r) {
    const int i = tid + r * T;
    const int node = (int)(key[r] >> 32);
    if (i >= P || start[r] != i || node >= N) continue;
    const float* cp = zn.cap + (size_t)node * Z * DN;
    float zf[kMaxZones][kMaxZoneDims];
    for (int z = 0; z < Z; ++z)
      for (int d = 0; d < DN; ++d) zf[z][d] = zn.free[((size_t)node * Z + z) * DN + d];
    const bool most = zn.most[node];
    int rank = 0, j = i;
    for (; j < P && (int)(keys[j] >> 32) == node; ++j) {
      const int bits = z_bits[j];
      int res = -1;
      if (bits & kZoneCand) {
        if (rank >= kZoneWinners) {
          res = kZoneRefused;
        } else if (bits & kZoneFit) {
          const float* req = z_req + (size_t)j * DN;
          const int pick = zone_pick(zf, cp, req, most, Z, DN);
          if (pick >= 0) {
            res = pick;
            for (int d = 0; d < DN; ++d) zf[pick][d] = zf[pick][d] - req[d];
          } else if (bits & kZoneStrict) {
            res = kZoneRefused;
          }
        }
        ++rank;
      }
      z_res[j] = res;
    }
    z_end[i] = j;
  }
  __syncthreads();
  // z3. Each row reads its result
#pragma unroll (R <= 4 ? R : 1)
  for (int r = 0; r < R; ++r) {
    const int i = tid + r * T;
    const int node = (int)(key[r] >> 32);
    zsel[r] = -1;
    if (i >= P || node >= N) continue;
    const int res = z_res[i];
    if (res == kZoneRefused) ok[r] = false;
    zsel[r] = res >= 0 ? res : -1;
  }
  __syncthreads();
}

// The round's zone charges (:1417-1432): each final winner's zone request
// off its picked zone, zone_free - segment_sum(...): the thread of each
// node segment's first row sums each zone's charges in row order (from
// the first, 0 + v0 + v1 + ...), then subtracts the sums from the table.
// The whole block calls it.
template <int D, int R>
__device__ void zone_charge(const bool (&ok)[R], const int (&zsel)[R], const uint64_t (&key)[R],
                            const int (&start)[R], int P, int N, int* z_res, const int* z_end,
                            const float* z_req, const RoundZones& zn) {
  const int tid = threadIdx.x, T = blockDim.x;
  const int Z = zn.Z, DN = zn.DN;
  // z4. Each row's final zone
#pragma unroll (R <= 4 ? R : 1)
  for (int r = 0; r < R; ++r) {
    const int i = tid + r * T;
    if (i < P) z_res[i] = ok[r] ? zsel[r] : -1;
  }
  __syncthreads();
  // z5. A thread a node segment: the charges summed, then subtracted
#pragma unroll (R <= 4 ? R : 1)
  for (int r = 0; r < R; ++r) {
    const int i = tid + r * T;
    const int node = (int)(key[r] >> 32);
    if (i >= P || start[r] != i || node >= N) continue;
    float sum[kMaxZones][kMaxZoneDims];
    bool any[kMaxZones];
    for (int z = 0; z < Z; ++z) any[z] = false;
    const int end = z_end[i];
    for (int j = i; j < end; ++j) {
      const int z = z_res[j];
      if (z < 0) continue;
      for (int d = 0; d < DN; ++d) {
        const float v = z_req[(size_t)j * DN + d];
        sum[z][d] = any[z] ? sum[z][d] + v : v;
      }
      any[z] = true;
    }
    for (int z = 0; z < Z; ++z) {
      if (!any[z]) continue;
      for (int d = 0; d < DN; ++d) {
        const size_t at = ((size_t)node * Z + z) * DN + d;
        zn.free[at] = zn.free[at] - sum[z][d];
      }
    }
  }
  __syncthreads();
}

// --------------------------------------------------------------- devices
//
// The device phase (DeviceShare): a round's tables — the carried slot
// table [N, G] and free RDMA / FPGA counts [N] (nullptr: not tracked),
// charged in place, and the stats table [N, 4] (full count, best partial,
// largest slot, total) the round's pricing read, refreshed for the nodes
// charged — and the priority-sorted pods' whole GPUs, share, RDMA and
// FPGA [P]. slots == nullptr: no devices.
struct RoundDevices {
  float* slots;
  float* stats;
  float* rdma;
  float* fpga;
  const int* whole;
  const float* share;
  const int* rdma_req;
  const int* fpga_req;
  int G;
};

// A sorted row's device word: its pod row (low 16 bits: P <= 32,768) and
// flags. The segment word of a segment's first row is its node, of any
// other row -1.
constexpr int kDevRowMask = 0xFFFF;
constexpr int kDevOk = 1 << 16;     // accepted (in: by the fit tests; out: and the devices)
constexpr int kDevOpens = 1 << 17;  // a share pod that opens a full slot
constexpr int kDevFinal = 1 << 18;  // a final winner

// Two words a row: the device word and the segment word.
__host__ __device__ inline size_t dev_bytes(int P) { return (size_t)P * 2 * sizeof(int); }

// The device acceptance (solver.py:1246-1274) on the rows' fit acceptance
// (kDevOk in d_info, written by each row): one thread a node segment, its
// rows in sorted order. The whole block calls it; every loop is a walk of
// the working set and the tables, so it keeps no array.
__device__ __noinline__ void device_accept(const uint64_t* keys, int P, int N, int* d_info,
                                           int* d_seg, const RoundDevices dv) {
  __syncthreads();  // every row's fit acceptance is in
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const int node = (int)(keys[i] >> 32);
    if (i > 0 && (int)(keys[i - 1] >> 32) == node) {
      d_seg[i] = -1;
      continue;
    }
    d_seg[i] = node;
    const bool real = node < N;
    const float* st = dv.stats + (size_t)min(node, N - 1) * koord_device::kStats;
    const float full = st[0], partial = st[1];
    const float rfree = dv.rdma != nullptr && real ? dv.rdma[node] : 0.0f;
    const float ffree = dv.fpga != nullptr && real ? dv.fpga[node] : 0.0f;
    float seg_full = 0.0f, seg_frac = 0.0f, seg_rdma = 0.0f, seg_fpga = 0.0f;
    for (int j = i; j < P && (int)(keys[j] >> 32) == node; ++j) {
      const int row = (int)(keys[j] & 0xFFFFFFFFu);
      const float whole = (float)dv.whole[row], share = dv.share[row];
      const bool frac = share > kEps;
      const bool opens = frac && share > partial + kEps;
      seg_full = seg_full + (whole + (opens ? 1.0f : 0.0f));
      seg_frac = seg_frac + (frac ? 1.0f : 0.0f);
      bool ok = (d_info[j] & kDevOk) != 0 && real;
      ok = ok && seg_full <= full + kEps;
      ok = ok && (!frac || seg_frac - 1.0f < 0.5f);
      if (dv.rdma != nullptr) {
        seg_rdma = seg_rdma + (float)dv.rdma_req[row];
        ok = ok && seg_rdma <= rfree + kEps;
      }
      if (dv.fpga != nullptr) {
        seg_fpga = seg_fpga + (float)dv.fpga_req[row];
        ok = ok && seg_fpga <= ffree + kEps;
      }
      d_info[j] = row | (ok ? kDevOk : 0) | (opens ? kDevOpens : 0);
    }
  }
  __syncthreads();
}

// The device charges (solver.py:1386-1416) of the final winners (kDevFinal
// in d_info): one thread a node segment sums its winners' whole GPUs,
// RDMA and FPGA (whole numbers, exact in any order), takes its one share
// winner, applies slot_commit to the node's slot row, subtracts the sums
// from the free counts and refreshes the node's stats row. Nodes without
// a winner are not touched (slot_commit and `free - 0` leave them as they
// are). The whole block calls it.
__device__ __noinline__ void device_charge(int P, int N, const int* d_info, const int* d_seg,
                                           const RoundDevices dv) {
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const int node = d_seg[i];
    if (node < 0 || node >= N) continue;
    float whole = 0.0f, frac = 0.0f, rdma = 0.0f, fpga = 0.0f;
    bool opens = false, any = false;
    for (int j = i; j < P && (j == i || d_seg[j] < 0); ++j) {
      const int info = d_info[j];
      if (!(info & kDevFinal)) continue;
      const int row = info & kDevRowMask;
      any = true;
      whole = whole + (float)dv.whole[row];
      const float share = dv.share[row];
      if (share > kEps) {
        frac = share;
        opens = (info & kDevOpens) != 0;
      }
      rdma = rdma + (float)dv.rdma_req[row];
      fpga = fpga + (float)dv.fpga_req[row];
    }
    if (!any) continue;
    float* row = dv.slots + (size_t)node * dv.G;
    koord_device::slot_commit_row(row, dv.G, whole, frac, opens);
    if (dv.rdma != nullptr) dv.rdma[node] = dv.rdma[node] - rdma;
    if (dv.fpga != nullptr) dv.fpga[node] = dv.fpga[node] - fpga;
    koord_device::slot_stats_row(row, dv.G, dv.stats + (size_t)node * koord_device::kStats);
  }
  __syncthreads();
}

// The device-memory round (32 rows a thread) keeps its rows' arrays in
// local memory, and so do its phases. Each phase with local objects of its
// own runs there in a frame of its own (not inlined), so that none of its
// objects can take the local-memory slot of a kernel array that is live
// across the phase: NVVM's -O3 gave the quota commit's ChunkScanDeep state
// the slot of a bool[16] the charges read after the commit
// (tools/round_miscompile.py). The rounds of up to 4 rows a thread keep
// these arrays in registers and the phases inlined.
template <int D, int R>
__device__ __noinline__ void quota_commit_apart(bool (&ok)[R], const uint64_t (&key)[R], int P,
                                                char* qarea, const ScanLevels& lv, int* warp_sums,
                                                const float* __restrict__ req,
                                                const int* __restrict__ chain,
                                                const float* __restrict__ runtime, float* qused,
                                                int Q, int L) {
  quota_commit<D, R>(ok, key, P, qarea, lv, warp_sums, req, chain, runtime, qused, Q, L);
}

template <int D, int R>
__device__ __noinline__ void zone_select_apart(bool (&ok)[R], int (&zsel)[R],
                                               const uint64_t (&key)[R], const int (&start)[R],
                                               const float (&rq)[R][D], const bool (&bound)[R],
                                               int P, int N, const uint64_t* keys, int* z_bits,
                                               int* z_res, int* z_end, float* z_req,
                                               const RoundZones& zn) {
  zone_select<D, R>(ok, zsel, key, start, rq, bound, P, N, keys, z_bits, z_res, z_end, z_req, zn);
}

template <int D, int R>
__device__ __noinline__ void zone_charge_apart(const bool (&ok)[R], const int (&zsel)[R],
                                               const uint64_t (&key)[R], const int (&start)[R],
                                               int P, int N, int* z_res, const int* z_end,
                                               const float* z_req, const RoundZones& zn) {
  zone_charge<D, R>(ok, zsel, key, start, P, N, z_res, z_end, z_req, zn);
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
template <int D, int R, bool kQuota, bool kZone, bool kGlobal>
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
                  float* qused, bool* __restrict__ gate, int Q, int levels, int qbytes,
                  const RoundZones zn, const RoundDevices dv, char* scratch) {
  // A trip after the fixed point returns at once (state[0] is `done`; only
  // thread 0 writes the word, at the very end of a launch).
  if (state[0] != 0) return;
  // The row loops unroll (their arrays in registers) up to 4 rows a
  // thread; above, the arrays live in local memory and the build stays
  // short.
  extern __shared__ uint64_t smem_u64[];
  __shared__ ScanLevels s_lv;
  __shared__ int warp_sums[kWarps];
  // the working set: shared memory, or (kGlobal) the device-memory scratch
  uint64_t* keys = kGlobal ? (uint64_t*)scratch : smem_u64;  // [P]
  uint64_t* keys2 = keys + P;                           // [P], the area
  float* series = (float*)keys2;                        // [3 G, lv.total]
  float* st_req = (float*)(keys2 + P);                  // [P, D] if staged
  float* st_est = st_req + (size_t)P * D;               // [P, D]
  int* st_bits = (int*)(st_est + (size_t)P * D);        // [P]
  int* st_asg = st_bits + P;                            // [P]
  int* s_flags = (int*)((char*)keys2 + area_bytes(P, D, G, staged, qbytes));  // [P]
  // the zone phase's words (kZone): bits, result, segment end [P] each,
  // then the zone requests [P, DN]
  int* z_bits = s_flags + P;
  int* z_res = z_bits + P;
  int* z_end = z_res + P;
  float* z_req = (float*)(z_end + P);
  // the device phase's words (devices): each sorted row's device word and
  // segment word [P] each, after the zone phase's
  int* d_info = (int*)((char*)z_bits + (kZone ? zone_bytes(P, zn.DN) : 0));
  int* d_seg = d_info + P;
  const bool devices = dv.slots != nullptr;
  const int tid = threadIdx.x, T = blockDim.x;
  // the rows present: the loops with a barrier run over these only (above
  // 4 rows a thread; up to 4 they unroll over R)
  const int RN = R > 4 ? min(R, (P + T - 1) / T) : R;
  if (tid == 0) s_lv = scan_levels(P);

  // 1. The rank-modular choice (:1204-1213): rank is the inclusive count of
  // active pods minus 1, an exact integer scan, tile by tile. The pods'
  // columns are staged on the way, in priority order.
  uint64_t key[R];
  int carry = 0;
#pragma unroll (R <= 4 ? R : 1)
  for (int r = 0; r < R; ++r) key[r] = UINT64_MAX;
#pragma unroll (R <= 4 ? R : 1)
  for (int r = 0; r < RN; ++r) {
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
  bool prod[R], act[R], bound[R];
  carry = 0;
#pragma unroll (R <= 4 ? R : 1)
  for (int r = 0; r < RN; ++r) {
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
      bound[r] = bind;
    } else {
      bound[r] = false;
    }
    start[r] = block_scan(i < P && node != prev ? i : 0, warp_sums, carry, Max());
  }

  // 4-5. G dims a pass: the series (request, estimate, prod estimate) x G
  // of the sorted rows, their cumsums, and each row's tests against the
  // round-start tables (node rows loaded before the cumsums, so their
  // latency overlaps them).
  bool ok[R], over[R], pover[R], node_fresh[R], qok[R];
  float a[R][D], t[R][D], pt[R][D], rq0[R][D], eu0[R][D], pu0[R][D];
#pragma unroll (R <= 4 ? R : 1)
  for (int r = 0; r < R; ++r) {
    const int i = tid + r * T;
    const int node = (int)(key[r] >> 32);
    ok[r] = i < P && node < N;
    qok[r] = true;
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
          // with zones the quantum is kept apart: the zone phase runs on the
          // fit alone, as the reference's does
          if constexpr (kZone)
            qok[r] = qok[r] && (a[r][d] <= 0.0f || prior_est <= round_quantum * a[r][d] + kEps);
          else
            ok[r] = ok[r] && (a[r][d] <= 0.0f || prior_est <= round_quantum * a[r][d] + kEps);
          over[r] = over[r] || (t[r][d] > 0.0f && usage_percent(eu0[r][d] + seg[1], a[r][d]) > t[r][d]);
          pover[r] = pover[r] || (pt[r][d] > 0.0f && usage_percent(pu0[r][d] + seg[2], a[r][d]) > pt[r][d]);
        }
      }
    }
    __syncthreads();
  }
  // D. With devices, the device acceptance on the fit acceptance
  // (:1246-1274), before the zone selection as in the reference
  if (devices) {
#pragma unroll (R <= 4 ? R : 1)
    for (int r = 0; r < R; ++r) {
      const int i = tid + r * T;
      if (i < P) d_info[i] = ok[r] ? kDevOk : 0;
    }
    device_accept(keys, P, N, d_info, d_seg, dv);
#pragma unroll (R <= 4 ? R : 1)
    for (int r = 0; r < R; ++r) {
      const int i = tid + r * T;
      if (i < P) ok[r] = ok[r] && (d_info[i] & kDevOk) != 0;
    }
  }
  // Z. With zones, the zone selection on the fit acceptance (:1275-1332)
  int zsel[R];
  if constexpr (kZone) {
    if constexpr (kGlobal)
      zone_select_apart<D, R>(ok, zsel, key, start, rq, bound, P, N, keys, z_bits, z_res, z_end,
                              z_req, zn);
    else
      zone_select<D, R>(ok, zsel, key, start, rq, bound, P, N, keys, z_bits, z_res, z_end, z_req,
                        zn);
#pragma unroll (R <= 4 ? R : 1)
    for (int r = 0; r < R; ++r) ok[r] = ok[r] && qok[r];
  }
  // the node's accepts: fit and quantum in every dim, no threshold
  // exceeded on a fresh node
#pragma unroll (R <= 4 ? R : 1)
  for (int r = 0; r < R; ++r)
    ok[r] = ok[r] && !(node_fresh[r] && over[r]) && !(prod[r] && node_fresh[r] && pover[r]);
  // 6. With quotas, the quota commit: each row first notes in its flags
  // whether it ends its node's segment (the charges below need it; the
  // quota phase then takes the keys' room), and only the pods that also
  // clear their chains stay accepted (:1362-1370). The note goes to the
  // working set, which the charges read anyway.
  if constexpr (kQuota) {
#pragma unroll (R <= 4 ? R : 1)
    for (int r = 0; r < R; ++r) {
      const int i = tid + r * T;
      if (i < P)
        s_flags[i] = i == P - 1 || (keys[i + 1] >> 32) != (key[r] >> 32) ? kLast : 0;
    }
    if constexpr (kGlobal)
      quota_commit_apart<D, R>(ok, key, P, (char*)keys, lv, warp_sums, req, chain, runtime,
                               qused, Q, levels);
    else
      quota_commit<D, R>(ok, key, P, (char*)keys, lv, warp_sums, req, chain, runtime, qused, Q,
                         levels);
  }
#pragma unroll (R <= 4 ? R : 1)
  for (int r = 0; r < R; ++r) {
    const int i = tid + r * T;
    if (i < P)
      s_flags[i] = (kQuota ? s_flags[i] & kLast : 0) | (ok[r] ? kAcc : 0) | (prod[r] ? kProd : 0);
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
      const bool ends = kQuota ? (s_flags[i] & kLast) != 0
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

  // 7z. With zones, the final winners' zone charges (:1417-1432)
  if constexpr (kZone && kGlobal)
    zone_charge_apart<D, R>(ok, zsel, key, start, P, N, z_res, z_end, z_req, zn);
  else if constexpr (kZone)
    zone_charge<D, R>(ok, zsel, key, start, P, N, z_res, z_end, z_req, zn);

  // 7d. With devices, the final winners' device charges (:1386-1416) and
  // the charged nodes' stats
  if (devices) {
#pragma unroll (R <= 4 ? R : 1)
    for (int r = 0; r < R; ++r) {
      const int i = tid + r * T;
      if (i < P && ok[r]) d_info[i] |= kDevFinal;
    }
    __syncthreads();
    device_charge(P, N, d_info, d_seg, dv);
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
      if constexpr (kZone) {
        if (zsel[r] >= 0) zn.pod_zone[row] = zsel[r];
      }
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
  RoundZones zones;      // zones.free == nullptr: no NUMA
  RoundDevices devices;  // devices.slots == nullptr: no devices
  char* scratch;         // the device-memory working set (kGlobal)
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

// The widest shared-memory layout of a round at R rows a thread: staged
// pods and every dim in one pass first, then fewer dims a pass, then the
// pods read from device memory. G == 0 when none fits.
struct Config {
  int G, staged;
  size_t qbytes, smem;
};

inline Config smem_config(int P, int D, int R, bool quota, int Q, int L, bool zone, int DN,
                          bool dev) {
  const size_t most = (size_t)max_smem() - sizeof(ScanLevels) - kWarps * sizeof(int);
  const size_t qbytes = quota ? quota_layout(P, D, Q, L, R).total : 0;
  const size_t zbytes = (zone ? zone_bytes(P, DN) : 0) + (dev ? dev_bytes(P) : 0);
  for (int staged = 1; staged >= 0; --staged)
    for (int g = D; g >= 1; --g) {
      const size_t smem = round_smem_bytes(P, D, g, staged, qbytes, zbytes);
      if (smem <= most) return Config{g, staged, qbytes, smem};
    }
  return Config{0, 0, qbytes, 0};
}

// Bytes of the device-memory working set of a round (kGlobal): every dim
// in one pass, pods staged, kGlobalRows rows a thread.
inline size_t big_bytes(int P, int D, bool quota, int Q, int L, bool zone, int DN, bool dev) {
  const size_t qbytes = quota ? quota_layout(P, D, Q, L, kGlobalRows).total : 0;
  return round_smem_bytes(P, D, D, 1, qbytes,
                          (zone ? zone_bytes(P, DN) : 0) + (dev ? dev_bytes(P) : 0));
}

template <int D, int R, bool kQuota, bool kZone, bool kGlobal>
cudaError_t launch(const Args& a, int threads) {
  // One block holds the whole round: in shared memory at the widest layout
  // that fits (a round that fits in none is refused), or (kGlobal) in the
  // caller's scratch. The attribute is set once per size, so a launch
  // captured into a CUDA graph after a warm-up makes no such call.
  int G = D, staged = 1;
  size_t smem = 0, qbytes = 0;
  if constexpr (kGlobal) {
    if (a.scratch == nullptr) return cudaErrorInvalidValue;
    qbytes = kQuota ? quota_layout(a.P, D, a.Q, a.L, R).total : 0;
  } else {
    const Config c = smem_config(a.P, D, R, kQuota, a.Q, a.L, kZone, a.zones.DN,
                                 a.devices.slots != nullptr);
    if (c.G == 0) return cudaErrorInvalidValue;
    G = c.G, staged = c.staged, smem = c.smem, qbytes = c.qbytes;
    static size_t configured = 48 * 1024 - sizeof(ScanLevels) - kWarps * sizeof(int);
    if (smem > configured) {
      cudaError_t err = cudaFuncSetAttribute(round_tail_kernel<D, R, kQuota, kZone, kGlobal>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
      if (err != cudaSuccess) {
        cudaGetLastError();  // clear it, so the next launch's check is clean
        return err;
      }
      configured = smem;
    }
  }
  round_tail_kernel<D, R, kQuota, kZone, kGlobal><<<1, threads, smem, a.stream>>>(
      a.top_cost, a.top_idx, a.req, a.est, a.is_prod, a.cpu_bind, a.cpu_amp,
      a.alloc, a.fresh, a.thr, a.pthr, a.requested, a.est_used, a.prod_used,
      a.assigned, a.active, a.state, a.round_quantum, a.P, a.N, a.K, G, staged, a.chain,
      a.runtime, a.qused, a.gate, a.Q, a.L, (int)qbytes, a.zones, a.devices, a.scratch);
  return cudaGetLastError();
}

// Rows a thread of the shared-memory kernels: 1 up to a block of threads
// (the block then has P threads, rounded up to a warp), 4 up to 4 blocks'
// worth, 16 up to 16 blocks' worth at D <= 3 without quotas or zones (12 P
// bytes and three series of 1.07 P floats fit then); 0: none takes it.
inline int smem_rows(int P, int D, bool quota, bool zone) {
  if (P <= kThreads) return 1;
  if (P <= 4 * kThreads) return 4;
  if (D <= 3 && !quota && !zone && P <= kBigRows * kThreads) return kBigRows;
  return 0;
}

// Threads of a block at R rows a thread.
inline int threads_of(int P, int R) { return R == 1 ? max(32, (P + 31) / 32 * 32) : kThreads; }

// Which kernel takes a round: 0 the shared-memory kernels (round.cu, or
// round_zone.cu with zones), 1 the device-memory kernel (round_big.cu,
// with `bytes` of scratch), -1 none (above kGlobalRows * kThreads pods).
// Shared memory takes a round when it fits and, with quotas, when each
// level's 32-bit sort key (quota << position bits | position) does.
inline int round_route(int P, int D, bool quota, int Q, int L, bool zone, int DN, bool dev,
                       size_t* bytes) {
  *bytes = 0;
  const int R = smem_rows(P, D, quota, zone);
  const bool key32 = !quota || (((unsigned long long)Q + 1) << pos_bits(P)) < (1ull << 32);
  if (R > 0 && key32 && smem_config(P, D, R, quota, Q, L, zone, DN, dev).G > 0) return 0;
  if (P > kGlobalRows * kThreads) return -1;
  *bytes = big_bytes(P, D, quota, Q, L, zone, DN, dev);
  return 1;
}

// op.template run<D>() for a run-time D in 1..8.
template <class Op>
cudaError_t with_d(int D, const Op& op) {
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

// The arguments every entry checks: sizes, and rows read and written as
// float2 / float4 where D allows.
inline cudaError_t check_args(const Args& a) {
  if (a.D < 1 || a.D > kMaxDims || a.N < 1 || a.K < 1 || a.K > kMaxK) return cudaErrorInvalidValue;
  if (a.chain != nullptr && (a.Q < 1 || a.L < 1)) return cudaErrorInvalidValue;
  if (a.zones.free != nullptr &&
      (a.zones.Z < 1 || a.zones.Z > kMaxZones || a.zones.DN < 1 || a.zones.DN > kMaxZoneDims ||
       a.zones.DN > a.D))
    return cudaErrorInvalidValue;
  if (a.devices.slots != nullptr &&
      (a.devices.G < 1 || a.devices.G > koord_device::kMaxSlots || a.P > kDevRowMask + 1 ||
       a.devices.stats == nullptr))
    return cudaErrorInvalidValue;
  const uintptr_t align = a.D % 4 == 0 ? 16 : a.D % 2 == 0 ? 8 : 4;
  for (const void* p : {(const void*)a.req, (const void*)a.est, (const void*)a.alloc,
                        (const void*)a.thr, (const void*)a.pthr, (const void*)a.requested,
                        (const void*)a.est_used, (const void*)a.prod_used})
    if ((uintptr_t)p % align != 0) return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

inline Args make_args(const void* top_cost, const void* top_idx, const void* req,
                      const void* est, const void* is_prod, const void* cpu_bind,
                      const void* cpu_amp, const void* alloc, const void* fresh,
                      const void* thr, const void* pthr, void* requested, void* est_used,
                      void* prod_used, void* assigned, void* active, void* state,
                      float round_quantum, int P, int N, int D, int K, const void* chain,
                      const void* runtime, void* qused, void* gate, int Q, int L,
                      RoundZones zones, RoundDevices devices, void* scratch, void* stream) {
  return Args{(const float*)top_cost, (const int*)top_idx, (const float*)req,
              (const float*)est, (const bool*)is_prod, (const bool*)cpu_bind,
              (const float*)cpu_amp, (const float*)alloc, (const bool*)fresh,
              (const float*)thr, (const float*)pthr, (float*)requested,
              (float*)est_used, (float*)prod_used, (int*)assigned,
              (bool*)active, (int*)state, round_quantum, P, N, D, K, (const int*)chain,
              (const float*)runtime, (float*)qused, (bool*)gate, Q, L, zones, devices,
              (char*)scratch, (cudaStream_t)stream};
}

inline RoundZones make_zones(void* zone_free, const void* zone_cap, const void* policy,
                             const void* most, const void* required, void* pod_zone, int Z,
                             int DN) {
  return RoundZones{(float*)zone_free, (const float*)zone_cap, (const int8_t*)policy,
                    (const bool*)most, (const bool*)required, (int*)pod_zone, Z, DN};
}

inline RoundDevices make_devices(void* slots, void* stats, void* rdma, void* fpga,
                                 const void* whole, const void* share, const void* rdma_req,
                                 const void* fpga_req, int G) {
  return RoundDevices{(float*)slots, (float*)stats, (float*)rdma, (float*)fpga,
                      (const int*)whole, (const float*)share, (const int*)rdma_req,
                      (const int*)fpga_req, G};
}

}  // namespace
