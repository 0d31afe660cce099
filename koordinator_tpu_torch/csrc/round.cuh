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
// - The stable sort is over unique keys (node_key << 32 | position),
//   which gives argsort(stable=True) exactly, pods keyed N last. At one
//   row a thread (packed into 32 bits when N leaves room) a bitonic
//   network of shuffles inside each warp, then merges of sorted runs by
//   binary search, one barrier a merge; above, the stable radix split of
//   split.cuh on the node key (the keys arrive in position order): two
//   passes of 7 bits at 10,000 nodes, integer counts a warp and one block
//   scan a pass. The segments' first rows are numbered by one block scan
//   over a span of sorted rows a thread; each row keeps its segment's
//   index and start.
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
//   `table + segment_sum(...)` into — a thread a (segment, table, dim)
//   chain from the round-start value, the rows' values and flags loaded
//   ahead of its adds. No float atomics. Compiled with -fmad=false and
//   IEEE division, so `quantum * alloc + EPS` and the percents round as the
//   reference's do.
// - One SM sends every scattered load and store of the round, a line a
//   lane, so they are kept few: the pods' columns are read once, coalesced,
//   in priority order and gathered from shared memory after the sort; node
//   rows move as float2 / float4.
// - Above 1,024 pods (the JAX scheduler's batch bucket is 4,096) a thread
//   holds 4 or 16 rows; where shared memory is short, fewer dims go
//   through the cumsums at a time and the pods' columns are read from
//   device memory instead.
// - The quota commit (quota_commit below, its own instantiation: the round
//   without quotas keeps its registers) runs between the node acceptance
//   and the charges, in the shared memory of the node sort's keys and the
//   area, by priority position: per chain level the (quota, position) keys
//   in order, by a stable radix split on the quota id (integer counts by
//   warp, one block scan a pass; the comparison sort above 4,096 quota
//   ids and in device memory); the one-hot branch's per-column cumsum in
//   XLA's chunked order from chunk groups (a thread a quota's pods in one
//   chunk of 16), the chunk totals in runs of at most 16 (a thread a run)
//   and the runs' totals (a thread a quota, at most P / 256); the sorted
//   branch's segmented prefix through the same cumsum machinery as the
//   node commit; then the final pods' requests onto the quota table in the
//   order XLA's CPU backend gives the reference's chain of adds
//   (ops/quota.py:charge_folds): each level's final pods packed by a block
//   scan, then a thread a (quota, dim) streams its run, the loads ahead of
//   the adds (at 128 rows a thread, a thread a quota walks its rows), no
//   float atomics.
// - The zone phase (kZone, its own instantiation: the rounds without NUMA
//   keep their registers) replaces the zone selection of :1275-1332 and
//   the zone charges of :1417-1432. It runs on the node acceptance of the
//   fit tests alone, as the reference's does (the threshold and quantum
//   tests come after it there; all are ANDed). Each row's candidate and
//   strict bits come from one load, its node's side word (zone_prep.cu
//   writes it once a batch from the capacities and policies, which the
//   rounds do not change): a zone candidate is a row on a node with zones
//   that is SINGLE_NUMA_NODE, or whose pod is cpuset-bound or required.
//   The candidates' ranks are a block-wide segmented integer scan (the
//   reference's float cumsum of 0/1 flags is exact below 2^24 pods, so
//   the same ranks); the fifth and later are refused this round, and each
//   of the first four enters a four-slot list at its segment's first row.
//   Only those rows can take a zone, so the thread of the segment's first
//   row loads the node's zone rows into registers once and takes its
//   listed rows in rank order: each still accepted takes the
//   strategy-ordered zone of zone_pick (numa.py:48-75) against the rows
//   the ranks before it charged, and a candidate that must align and
//   finds no zone is refused. After the quota commit the same thread sums
//   each zone's charges over its listed rows that are final winners, in
//   row order, and subtracts them (`zone_free - segment_sum`, the order
//   XLA's CPU backend gives the reference); each winner's pick is written
//   to its pod. The depth no longer grows with the longest segment. The
//   zone rows are Z x DN floats a node, compiled for (Z, DN) = (2, 2) and
//   (4, 2); the phase's per-row words take P (3 + DN) words after the
//   flags in shared memory (5 + DN in device memory).
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
//   compiled into the instantiations with kDev only (the shared-memory
//   entries round_dev.cu and round_zone_dev.cu; in the device-memory ones
//   a run-time branch, devices.slots != nullptr), so the rounds without
//   devices carry none of its code or registers. Each half runs in a frame
//   of its own that takes only the working set and the tables
//   (device_accept, device_charge). After the fit tests, each
//   row needs its node segment's running sums: the whole GPUs asked for
//   so far (plus one for each share pod that opens a full slot: its share
//   above the node's round-start best partial slot), the share pods so far
//   and the RDMA and FPGA so far, against the node's round-start stats and
//   free counts; the rows past them and every share pod but the segment's
//   first are refused. The sums are whole numbers, exact in any order, so
//   they are a block-wide segmented scan of integers (a span of rows a
//   thread, the spans' sums scanned by warp shuffles): no thread walks a
//   segment, however many pods crowd onto one node as a fleet runs out. It
//   runs before the zone selection, as the reference's acceptance does.
//   After the node charges the same scan over the final winners gives each
//   segment's whole GPUs, RDMA, FPGA and share winner, and the thread of
//   its last row applies slot_commit to the node's slot row (device.cuh),
//   takes the RDMA and FPGA off the free counts, and refreshes the node's
//   row of the stats table, which the next round's pricing reads
//   (device_prep.cu works it out once a batch). The rows hand their flags
//   to the phase through two words a row of the working set.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "device.cuh"
#include "quota.cuh"
#include "split.cuh"

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
constexpr int kNodeShift = 3;  // the row's node above the flags
constexpr int kAhead = 16;     // rows a charge chain loads ahead of its adds

// rows a thread of the shared-memory round at D <= 3 (up to 16,384 pods)
constexpr int kBigRows = 16;
// rows a thread of the device-memory round (up to 32,768 pods)
constexpr int kGlobalRows = 32;
// rows a thread of the device-memory round above that (up to 131,072 pods)
constexpr int kHugeRows = 128;

// NUMA zones (ops/numa.py): at most this many a node and dims a zone
constexpr int kMaxZones = 8;
constexpr int kMaxZoneDims = 4;
constexpr int kZoneWinners = 4;       // solver.ZONE_WINNERS_PER_ROUND
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
// A segment's start and the count of segments so far, (start << 16 |
// count), for rounds of at most 1,024 rows: the start's max, the counts'
// sum.
struct StartCount {
  __device__ int operator()(int a, int b) const {
    return max(a >> 16, b >> 16) << 16 | ((a & 0xFFFF) + (b & 0xFFFF));
  }
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

// The block-wide sort of one key a thread (split.cuh).
using koord_split::block_sort;


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

// The stable split of q1: the rounds in shared memory sort a level's keys
// (quota << pb | position, arriving in position order) by a radix split
// on the quota id, kSplitBits a pass, while the ids fit kSplitPasses
// passes; above that (and in device memory, 64-bit keys) the comparison
// sort of sort_rows runs.
constexpr int kSplitBits = 6;
constexpr int kSplitBins = 1 << kSplitBits;
constexpr int kSplitPasses = 2;

// Passes of the split over quota ids 0..Q (Q keys the pods that do not
// take part); more than kSplitPasses: the sort runs instead.
__host__ __device__ inline int split_passes(int Q) {
  int passes = 0;
  for (long long top = Q; top > 0; top >>= kSplitBits) ++passes;
  return passes;
}

__host__ __device__ inline bool split_fits(int Q, int R) {
  return R <= 4 && split_passes(Q) <= kSplitPasses;
}

// Bytes of the split's count table: kSplitBins digits x one slice of 32
// rows each, 16-bit counts.
__host__ __device__ inline size_t split_table_bytes(int P) {
  return (size_t)kSplitBins * ((P + 31) / 32) * sizeof(uint16_t);
}

// The quota phase's shared memory: it takes the node sort's keys and the
// area after them (the keys are read no more once each row knows whether
// it ends its node's segment). flags [P] int by priority position; the
// sorted keys of every level [L][P] (QuotaKey, kept for the charges); the
// sort's second buffer [P] at one row a thread where the sort runs; the
// requests [P, D] by priority position; then `ext`: one-hot, each chunk
// group's total and then its chunk offset [P, D] at the group's first row,
// or, sorted, D cumsum series; in turn the split's count table and, for
// the charges, a level's packed requests, D runs of P floats; then, one-hot,
// each row's group start and each group's end [P] uint16.
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
  const bool split = split_fits(Q, R);
  q.buf1 = at;
  if (R == 1 && !split) at += (size_t)P * kb;
  q.sreq = at;
  at += (size_t)P * D * sizeof(float);
  q.ext = at;
  size_t ext = onehot ? (size_t)P * D * sizeof(float)
                      : (size_t)D * scan_levels(P).total * sizeof(float);
  if (split && split_table_bytes(P) > ext) ext = split_table_bytes(P);
  at += (ext + 3) / 4 * 4;
  const size_t pos = R > kGlobalRows ? sizeof(uint32_t) : sizeof(uint16_t);  // QuotaPos<R>
  q.gs = at;
  if (onehot) at += (size_t)P * pos;
  q.gend = at;
  if (onehot) at += (size_t)P * pos;
  q.total = at;
  return q;
}

// The key type of a quota level's sort: 32 bits in shared memory, 64 in
// the device-memory round (where Q may be as large as an int).
template <int R>
using QuotaKey = typename std::conditional<(R > 4), uint64_t, uint32_t>::type;

// The type of a row position in the one-hot branch's group starts and
// ends: 16 bits up to 65,536 pods, 32 in the rounds above.
template <int R>
using QuotaPos = typename std::conditional<(R > kGlobalRows), uint32_t, uint16_t>::type;

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
// elements are summed, in the reference's grouping. For the device-memory
// round (32,768 pods have three levels above the base), any number of
// levels: level k of 1..n (n = lv.n) is cut into chunks of 16 below the
// top, level n, a plain running sum. Each level keeps its open chunk's
// sum; when an element of a later chunk arrives, the open chunks it
// passes move up, the highest first, so each level receives its elements
// in increasing order and sums them in the reference's grouping.
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
template <int D, class Scan, class KeyT, class PosT>
__device__ void walk_groups(Scan& scan, int i, KeyT q, int P, int pb, KeyT pmask,
                            const KeyT* sk, const PosT* gend, float* ext) {
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

// Sorts the P unique keys k[r] (row tid + r * T, in position order on
// entry) as sort_rows does, by the stable radix split (split.cuh) on the
// key k >> shift, at most top, in the passes of `pl`: each pass the rows
// present (RN a thread) count their digits into `table`, one block scan,
// then each row goes to its place in sk and is read back. The whole block
// calls it; on return sk[0, P) holds the sorted keys.
template <class KeyT, int R, class C>
__device__ void split_rows(KeyT (&k)[R], int P, int RN, int shift, koord_split::Plan pl,
                           KeyT* sk, C* table, int* warp_sums) {
  const int tid = threadIdx.x, T = blockDim.x, S = (P + 31) / 32;
  const KeyT mask = ((KeyT)1 << pl.bits) - 1;
  constexpr int RR = R <= 4 ? R : 1;  // the digits kept in registers up to 4 rows
  for (int pass = 0; pass < pl.passes; ++pass) {
    const int sh = shift + pass * pl.bits;
    koord_split::clear(table, P, pl.bits);
    int dig[RR];
    unsigned peers[RR];
#pragma unroll (R <= 4 ? R : 1)
    for (int r = 0; r < RN; ++r) {
      const int i = tid + r * T;
      const int dg = i < P ? (int)((k[r] >> sh) & mask) : -1;
      const unsigned pe = koord_split::count(dg, i >> 5, S, table);
      if constexpr (R <= 4) dig[r] = dg, peers[r] = pe;
    }
    koord_split::scan(table, P, pl.bits, warp_sums);
#pragma unroll (R <= 4 ? R : 1)
    for (int r = 0; r < RN; ++r) {
      const int i = tid + r * T;
      int dg;
      unsigned pe;
      if constexpr (R <= 4) {
        dg = dig[r], pe = peers[r];
      } else {
        dg = i < P ? (int)((k[r] >> sh) & mask) : -1;
        pe = __match_any_sync(kFull, dg);
      }
      if (i < P) sk[koord_split::place(dg, pe, i >> 5, S, table)] = k[r];
    }
    __syncthreads();
#pragma unroll (R <= 4 ? R : 1)
    for (int r = 0; r < RN; ++r)
      if (tid + r * T < P) k[r] = sk[tid + r * T];
  }
}

// The reference's chain of adds over one dim's n packed values v[0, n) of
// a quota: onto `run` one at a time (fold), or summed first and the sum
// added to `run`. The sum starts from -0, the additive identity, so it is
// v0 + v1 + ... bit for bit. Whole batches of B load before their adds,
// so only the adds' chain is serial.
template <int B>
__device__ __forceinline__ float charge_stream(const float* v, int n, float run, bool fold) {
  float acc = fold ? run : -0.0f;
  int j = 0;
  for (; j + B <= n; j += B) {
    float x[B];
#pragma unroll
    for (int u = 0; u < B; ++u) x[u] = v[j + u];
#pragma unroll
    for (int u = 0; u < B; ++u) acc = acc + x[u];
  }
  for (; j < n; ++j) acc = acc + v[j];
  return fold ? acc : run + acc;
}

// _quota_commit on the round's node acceptance: ok[r] (row tid + r * T of
// the node sort, pod key[r] & 0xFFFFFFFF) is cleared where the pod fails a
// level of its chain, counting the node-accepted pods of its quota before
// it in priority order; qused takes the final pods' requests. `qarea` is
// the shared memory from the node sort's keys on (quota_layout), free
// from here to the charges. The whole block calls it.
//
// Costs: a split (one or two passes of a few barriers) or a sort of P keys
// a level; the one-hot branch's chunk sums (a thread a group of at most
// 16), its offsets (a thread a run of at most 16 groups, then a thread a
// quota over at most P / 256 runs; in device memory a thread a quota
// walking its groups); the sorted branch's series cumsum; and the charges:
// a block scan a level, then the reference's chain of adds, as long as the
// largest quota's final pods at the level (the root's: every final pod),
// streamed from packed values — the floor this order leaves (at 128 rows
// a thread, a thread a quota walks its sorted rows instead).
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
  using PosT = QuotaPos<R>;
  PosT* gs = (PosT*)(qarea + ql.gs);
  PosT* gend = (PosT*)(qarea + ql.gend);
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
    // q1. The level's stable split on the quota id: (quota << pb |
    // position), the pods that do not take part keyed Q (split_rows, or
    // the sort where the split does not fit)
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
    if (split_fits(Q, R))
      split_rows<KeyT, R>(k, P, R, pb, koord_split::plan(Q, kSplitBits), sk, (uint16_t*)ext,
                          warp_sums);
    else
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
          gs[j] = (PosT)i;
        }
        gend[i] = (PosT)(j - 1);
#pragma unroll
        for (int d = 0; d < D; ++d) ext[(size_t)i * D + d] = tot[d];
      }
      __syncthreads();
      // q3. (b) each group's chunk offset, the column's cumsum at the chunk
      // before it. In shared memory (at most two levels above the chunks)
      // the chunk totals of a quota fall into runs of at most 16 (one
      // chunk of level 1): a thread a run sums its groups in order, each
      // non-first group keeping the sum of those before it and its run's
      // first row, the first group the run's total and last row; then a
      // thread a quota takes its runs' totals in order (the top level, at
      // most P / 256 of them), each run's first group keeping the total
      // of the runs before it, which is its offset; then each other group
      // with runs before it adds that to its own. In device memory a
      // thread a quota walks its groups (walk_groups).
      if (lv.n > 0) {
        if constexpr (R > 4) {
#pragma unroll 1
          for (int r = 0; r < R; ++r) {
            const int i = tid + r * T;
            if (i >= P) continue;
            const KeyT q = k[r] >> pb;
            if ((long long)q >= Q || (i > 0 && (sk[i - 1] >> pb) == q)) continue;
            ChunkScanDeep<D> scan;
            scan.init(lv.n);
            walk_groups<D>(scan, i, q, P, pb, pmask, sk, gend, ext);
          }
        } else {
          // a row's run: (quota, level-1 chunk)
          auto run_of = [&](KeyT kk) {
            return ((kk >> pb) << 8) | (KeyT)((int)(kk & pmask) >> 8);
          };
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int i = tid + r * T;
            if (i >= P || (int)(k[r] >> pb) >= Q || (i > 0 && run_of(sk[i - 1]) == run_of(k[r])))
              continue;
            float acc[D];
#pragma unroll
            for (int d = 0; d < D; ++d) acc[d] = ext[(size_t)i * D + d];
            int last = gend[i];
            for (int g = last + 1; g < P && run_of(sk[g]) == run_of(k[r]); g = last + 1) {
              last = gend[g];
#pragma unroll
              for (int d = 0; d < D; ++d) {
                const float tot = ext[(size_t)g * D + d];
                ext[(size_t)g * D + d] = acc[d];
                acc[d] = acc[d] + tot;
              }
              gend[g] = (PosT)i;
            }
#pragma unroll
            for (int d = 0; d < D; ++d) ext[(size_t)i * D + d] = acc[d];
            gend[i] = (PosT)last;
          }
          __syncthreads();
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int i = tid + r * T;
            const KeyT q = k[r] >> pb;
            if (i >= P || (int)q >= Q || (i > 0 && (sk[i - 1] >> pb) == q)) continue;
            float top[D];
            bool has = false;
            for (int h = i; h < P && (sk[h] >> pb) == q; h = gend[h] + 1) {
#pragma unroll
              for (int d = 0; d < D; ++d) {
                const float tot = ext[(size_t)h * D + d];
                ext[(size_t)h * D + d] = has ? top[d] : 0.0f;
                top[d] = has ? top[d] + tot : tot;
              }
              has = true;
            }
          }
          __syncthreads();
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int i = tid + r * T;
            if (i >= P || i == 0 || (int)(k[r] >> pb) >= Q || ((int)(k[r] & pmask) >> 8) == 0 ||
                (sk[i - 1] >> 4) == (k[r] >> 4) || run_of(sk[i - 1]) != run_of(k[r]))
              continue;
            const int h = gend[i];
#pragma unroll
            for (int d = 0; d < D; ++d)
              ext[(size_t)i * D + d] = ext[(size_t)i * D + d] + ext[(size_t)h * D + d];
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
  // sum is taken first (v0 + v1 + ...) and added whole
  // (ops/quota.py:charge_folds). Each live level's final pods are packed
  // first: an exclusive block scan of the take flags over the level's
  // sorted rows gives each its place, where its key goes in the level's
  // key array and its requests in D dim-major runs of P floats in `ext`;
  // then one thread a (quota, dim) streams its run (charge_stream). At
  // 128 rows a thread a thread a quota walks its sorted rows instead.
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
    KeyT* sk = lkeys + (size_t)l * P;
    if constexpr (R > kGlobalRows) {
      // at 128 rows a thread the packing's R block scans a level cost more
      // than they save (PERF.md section 6): a thread a quota walks its
      // sorted rows, summing those its level takes
#pragma unroll 1
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
    } else {
      KeyT kt[R];
      int at[R];
      int taken = 0;
#pragma unroll (R <= 4 ? R : 1)
      for (int r = 0; r < R; ++r) {
        const int i = tid + r * T;
        bool take = false;
        kt[r] = 0;
        if (i < P) {
          kt[r] = sk[i];
          take = (long long)(kt[r] >> pb) < Q && !(flags[(int)(kt[r] & pmask)] & kRefused);
        }
        const int place = block_scan(take ? 1 : 0, warp_sums, taken, Add()) - 1;
        at[r] = take ? place : -1;
      }
      // every row read its key before the scans' last barrier
#pragma unroll (R <= 4 ? R : 1)
      for (int r = 0; r < R; ++r) {
        if (at[r] < 0) continue;
        const int pos = (int)(kt[r] & pmask);
        sk[at[r]] = kt[r];
#pragma unroll
        for (int d = 0; d < D; ++d) ext[(size_t)d * P + at[r]] = sreq[(size_t)pos * D + d];
      }
      __syncthreads();
      for (int t = tid; t < taken * D; t += T) {
        const int j = t / D, d = t - j * D;
        const KeyT q = sk[j] >> pb;
        if (j > 0 && (sk[j - 1] >> pb) == q) continue;
        float* u = qused + (size_t)q * D + d;
        const float run = *u;  // its latency overlaps the search
        const int end = segment_end<KeyT>(sk, j, taken, q, pb);
        *u = charge_stream<16>(ext + (size_t)d * P + j, end - j, run, fold);
      }
      __syncthreads();
    }
  }

  // q7. A node-accepted pod refused by a quota is not accepted
#pragma unroll (R <= 4 ? R : 1)
  for (int r = 0; r < R; ++r)
    if (tid + r * T < P) ok[r] = ok[r] && !(flags[(int)(key[r] & 0xFFFFFFFFu)] & kRefused);
  __syncthreads();
}

// The area's room for the node sort, before the staged columns: the
// sort's second buffer of P keys at one row a thread, or the split's
// count table (16-bit entries up to 65,536 rows, 32-bit above); then each
// segment's first row, until the tests.
__host__ __device__ inline size_t sort_room(int P) {
  const size_t table = P > 65536 ? koord_split::table_bytes<uint32_t>(P)
                                 : koord_split::table_bytes<uint16_t>(P);
  const size_t keys = (size_t)P * sizeof(uint64_t);
  return ((table > keys ? table : keys) + 15) / 16 * 16;
}

// Shared layout: keys[P] uint64, then one area used in turn, then
// s_flags[P] int (a sorted row's segment, then its accept and prod flags
// and node), then with zones the zone phase's `zbytes` (zone_bytes). The
// area holds
// - while choosing and sorting, the sort's room (sort_room) and, when
//   `staged`, the pods' columns in priority order: request [P, D],
//   estimate [P, D], bits [P], assigned [P];
// - from the tests on, 3 G series of lv.total floats (G dims a pass);
// - with quotas, between the tests and the charges, the quota phase's
//   `qbytes` (quota_layout), from the keys on: the keys and the area.
__host__ __device__ inline size_t area_bytes(int P, int D, int G, int staged, size_t qbytes) {
  const size_t series = (size_t)3 * G * scan_levels(P).total * sizeof(float);
  const size_t sorting = sort_room(P) + (size_t)P * (staged ? 8 * D + 8 : 0);
  const size_t keys = (size_t)P * sizeof(uint64_t);
  const size_t quota = qbytes > keys ? qbytes - keys : 0;
  const size_t most = series > sorting ? series : sorting;
  return most > quota ? most : quota;
}

// Thread t's span of the sorted rows: C = ceil(P / T) in a row from t * C.
__device__ __forceinline__ void dev_span(int P, int& j0, int& j1) {
  const int c = (P + blockDim.x - 1) / blockDim.x;
  j0 = min(P, (int)threadIdx.x * c);
  j1 = min(P, j0 + c);
}

// The zone phase's words: each sorted row's bits and segment start (then,
// from the ranks on, its result in the same word), the four-slot list of
// its segment's first zone candidates (used at a segment's first row;
// 16-bit entries in shared memory, where a round has at most 4,096 rows,
// 32-bit in device memory), then its zone request [P, DN].
constexpr int kZoneListSlots = 4;  // kZoneWinners rows a segment
__host__ __device__ inline size_t zone_bytes(int P, int DN, bool global) {
  return (size_t)P * (sizeof(int) + kZoneListSlots * (global ? sizeof(int) : sizeof(uint16_t)) +
                      DN * sizeof(float));
}

size_t round_smem_bytes(int P, int D, int G, int staged, size_t qbytes, size_t zbytes = 0) {
  return (size_t)P * (sizeof(uint64_t) + sizeof(int)) + area_bytes(P, D, G, staged, qbytes) +
         zbytes;
}

// The NUMA zones of a round: the carried table [N, Z, DN] (charged in
// place), the capacities, the nodes' MostAllocated flags, the
// priority-sorted pods' required flags and zone picks [P] (-1: none), and
// the nodes' side table [N, 1 + DN + Z] (zone_prep.cu, once a batch: its
// first word's bits say whether the node has zones, is SINGLE_NUMA_NODE
// and which zones have some capacity; only the capacities and policies
// decide them, and the rounds change neither).
struct RoundZones {
  float* free;
  const float* cap;
  const bool* most;
  const bool* required;
  int* pod_zone;
  const uint32_t* side;
  int Z, DN;
};

// bits of a side row's first word (loadaware.cuh's kSideHasZones,
// kSideSingle, kSideReal)
constexpr uint32_t kSideHasZones = 1u << 4, kSideSingle = 1u << 5;
constexpr int kSideReal = 8;  // bit 8 + z: zone z has some capacity

// A segment's zone rows in registers: the round-start free values and
// zone 0's capacity of each zone, at compile-time (ZC, DNC) where they are
// (2, 2) or (4, 2), else at run time (ZC = DNC = 0, the arrays in local
// memory). DN = 2 rows move as float2.
template <int ZC, int DNC>
struct ZoneRows {
  static constexpr int kZ = ZC ? ZC : kMaxZones, kDN = DNC ? DNC : kMaxZoneDims;
  float f[kZ][kDN];
  float cap0[kZ];

  __device__ __forceinline__ void load(const RoundZones& zn, int node, bool caps) {
    const int Z = ZC ? ZC : zn.Z, DN = DNC ? DNC : zn.DN;
    const size_t at = (size_t)node * Z * DN;
#pragma unroll
    for (int z = 0; z < kZ; ++z) {
      if (z >= Z) break;
      if constexpr (DNC == 2) {
        const float2 v = reinterpret_cast<const float2*>(zn.free + at)[z];
        f[z][0] = v.x, f[z][1] = v.y;
      } else {
#pragma unroll
        for (int d = 0; d < kDN; ++d)
          if (d < DN) f[z][d] = zn.free[at + z * DN + d];
      }
      if (caps) cap0[z] = zn.cap[at + z * DN];
    }
  }
};

// zone_pick (numa.py:48-75) of one request against a node's zone rows zf
// (the copy the ranks before charged): the zone where it fits within 1e-3
// in every dim, among zones with some capacity (the side word's bits), of
// least (cap0 - free0 + 1) / (cap0 + 1), or of greatest under
// MostAllocated; the first on ties. -1 when none fits.
template <int ZC, int DNC>
__device__ __forceinline__ int zone_pick(const ZoneRows<ZC, DNC>& zr, uint32_t info,
                                         const float* req, bool most, int Z, int DN) {
  int best = -1;
  float best_key = CUDART_INF_F;
#pragma unroll
  for (int z = 0; z < ZoneRows<ZC, DNC>::kZ; ++z) {
    if (z >= Z) break;
    bool fit = true;
#pragma unroll
    for (int d = 0; d < ZoneRows<ZC, DNC>::kDN; ++d)
      if (d < DN) fit = fit && zr.f[z][d] >= req[d] - 1e-3f;
    if (!(fit && ((info >> (kSideReal + z)) & 1u))) continue;
    const float used0 = zr.cap0[z] - zr.f[z][0];
    const float util = (used0 + 1.0f) / (zr.cap0[z] + 1.0f);
    const float key = most ? -util : util;
    if (best < 0 || key < best_key) {
      best = z;
      best_key = key;
    }
  }
  return best;
}

// A row's entry in its segment's list: the sorted row and its bits (above
// bit 13 of a 16-bit entry, bit 24 of a 32-bit one; all ones: an empty
// slot). The picks and charges take them as 32-bit words, -1 empty.
constexpr int kZoneEntryShift = 24;
constexpr int kZoneRowMask = (1 << kZoneEntryShift) - 1;

template <class E>
__device__ __forceinline__ E zone_entry(int j, int bits) {
  return (E)(j | bits << (sizeof(E) == 2 ? 13 : kZoneEntryShift));
}

template <class E>
__device__ __forceinline__ int zone_entry_word(E e) {
  if (e == (E)-1) return -1;
  if constexpr (sizeof(E) == 2) return (e & ((1 << 13) - 1)) | (e >> 13) << kZoneEntryShift;
  return (int)e;
}

// A segment's list, from the slots at its first row i.
template <class E>
__device__ __forceinline__ void zone_list_load(const E* z_list, int i,
                                               int (&list)[kZoneListSlots]) {
#pragma unroll
  for (int k = 0; k < kZoneListSlots; ++k)
    list[k] = zone_entry_word(z_list[(size_t)i * kZoneListSlots + k]);
}

// The picks of one node's listed candidates (at most four, in rank order,
// which is row order): the node's zone rows loaded once, each fitting
// candidate's strategy-ordered zone against the rows the ranks before it
// charged; a strict candidate with no zone is refused. Each listed row's
// result goes to z_res.
template <int ZC, int DNC>
__device__ __forceinline__ void zone_segment_picks(const int (&list)[kZoneListSlots], int node,
                                                   int* z_res, const float* z_req,
                                                   const RoundZones& zn) {
  const int Z = ZC ? ZC : zn.Z, DN = DNC ? DNC : zn.DN;
  ZoneRows<ZC, DNC> zr;
  zr.load(zn, node, true);
  const uint32_t info = zn.side[(size_t)node * (1 + DN + Z)];
  const bool most = zn.most[node];
#pragma unroll
  for (int k = 0; k < kZoneListSlots; ++k) {
    const int e = list[k];
    if (e < 0) break;
    const int j = e & kZoneRowMask, bits = e >> kZoneEntryShift;
    int res = -1;
    if (bits & kZoneFit) {
      float req[ZoneRows<ZC, DNC>::kDN];
#pragma unroll
      for (int d = 0; d < ZoneRows<ZC, DNC>::kDN; ++d)
        if (d < DN) req[d] = z_req[(size_t)j * DN + d];
      const int pick = zone_pick(zr, info, req, most, Z, DN);
      if (pick >= 0) {
        res = pick;
#pragma unroll
        for (int z = 0; z < ZoneRows<ZC, DNC>::kZ; ++z)
          if (z == pick) {
#pragma unroll
            for (int d = 0; d < ZoneRows<ZC, DNC>::kDN; ++d)
              if (d < DN) zr.f[z][d] = zr.f[z][d] - req[d];
          }
      } else if (bits & kZoneStrict) {
        res = kZoneRefused;
      }
    }
    z_res[j] = res;
  }
}

// The charges of one node's listed rows that are final winners (z_res: a
// winner's zone, else < 0): each zone's charges summed in row order (from
// the first, 0 + v0 + v1 + ...), then subtracted from the table, the zones
// no winner took left as they are.
template <int ZC, int DNC>
__device__ __forceinline__ void zone_segment_charges(const int (&list)[kZoneListSlots], int node,
                                                     const int* z_res, const float* z_req,
                                                     const RoundZones& zn) {
  const int Z = ZC ? ZC : zn.Z, DN = DNC ? DNC : zn.DN;
  constexpr int kZ = ZoneRows<ZC, DNC>::kZ, kDN = ZoneRows<ZC, DNC>::kDN;
  float sum[kZ][kDN];
  bool any[kZ];
#pragma unroll
  for (int z = 0; z < kZ; ++z) any[z] = false;
#pragma unroll
  for (int k = 0; k < kZoneListSlots; ++k) {
    const int e = list[k];
    if (e < 0) break;
    const int j = e & kZoneRowMask;
    const int zz = z_res[j];
    if (zz < 0) continue;
#pragma unroll
    for (int z = 0; z < kZ; ++z) {
      if (z != zz) continue;
#pragma unroll
      for (int d = 0; d < kDN; ++d) {
        if (d >= DN) continue;
        const float v = z_req[(size_t)j * DN + d];
        sum[z][d] = any[z] ? sum[z][d] + v : v;
      }
      any[z] = true;
    }
  }
  ZoneRows<ZC, DNC> zr;
  zr.load(zn, node, false);
  const size_t at = (size_t)node * Z * DN;
#pragma unroll
  for (int z = 0; z < kZ; ++z) {
    if (z >= Z || !any[z]) continue;
#pragma unroll
    for (int d = 0; d < kDN; ++d)
      if (d < DN) zn.free[at + z * DN + d] = zr.f[z][d] - sum[z][d];
  }
}

// A segment-packed count: the head bit (a segment starts in the span it
// covers) and the zone candidates since the latest head.
constexpr int kZoneHead = 1 << 30;

__device__ __forceinline__ int zone_then(int l, int r) { return (r & kZoneHead) ? r : l + r; }

// One int of a block-wide segmented scan: its shuffle, and its word in
// the scan's area.
__device__ __forceinline__ int seg_shfl_up(int x, int off) { return __shfl_up_sync(kFull, x, off); }
__device__ __forceinline__ void seg_store(int* area, int w, int x) { area[w] = x; }
__device__ __forceinline__ int seg_load(const int* area, int w, int) { return area[w]; }

// The exclusive segmented scan of one T a thread, in thread order, across
// the block: warp shuffles, then the warps' totals through `area` (read
// until the caller's next barrier). then(l, r) joins l and the r after it
// (r restarts at a segment's head); T{} is its identity. The whole block
// calls it.
template <class T, class Then>
__device__ T seg_block_scan(T x, int* area, Then then) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T y = seg_shfl_up(x, off);
    if (lane >= off) x = then(y, x);
  }
  T before = seg_shfl_up(x, 1);
  if (lane == 0) before = T{};
  if (lane == 31) seg_store(area, warp, x);
  __syncthreads();
  if (warp == 0) {
    T t = lane < nwarps ? seg_load(area, lane, T{}) : T{};
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const T y = seg_shfl_up(t, off);
      if (lane >= off) t = then(y, t);
    }
    if (lane < nwarps) seg_store(area, lane, t);
  }
  __syncthreads();
  if (warp > 0) before = then(seg_load(area, warp - 1, T{}), before);
  return before;
}

// Sorted row j's term in the rank scan: its segment's head and whether it
// is a zone candidate, from its word (start << 4 | bits).
__device__ __forceinline__ int zone_term(int w, int j) {
  return ((w >> 4) == j ? kZoneHead : 0) | ((w & kZoneCand) ? 1 : 0);
}

// The zone selection (solver.py:1275-1332) on the rows' fit acceptance
// ok[r]. z1: each row's bits (candidate: its node has zones, is
// SINGLE_NUMA_NODE or its pod cpuset-bound or required; strict: the node
// SINGLE_NUMA_NODE or the pod required; fit) from its node's side word,
// its segment start and its zone request (its first DN dims, CPU already
// amplified for cpuset-bound pods) go to the working set; each segment's
// first row clears its list. z2: the candidates' ranks, a block-wide
// segmented integer scan over spans of rows a thread (the reference takes
// the float cumsum of 0/1 flags, exact below 2^24 pods, so the same
// ranks); rank 4 and up is refused, ranks 0-3 enter their segment's list.
// z3: the thread of each segment's first row picks zones for its listed
// rows only (zone_segment_picks). z4: each row reads its result: ok[r]
// cleared when refused, zsel[r] the pick (-1 none). The whole block calls
// it.
template <int D, int R, class E>
__device__ void zone_select(bool (&ok)[R], int (&zsel)[R], const uint64_t (&key)[R],
                            const int (&start)[R], const float (&rq)[R][D],
                            const bool (&bound)[R], int P, int N, int* z_bits, E* z_list,
                            float* z_req, int* area, const RoundZones& zn) {
  int* z_res = z_bits;  // a row's result takes its bits' word once the ranks are in
  const int tid = threadIdx.x, T = blockDim.x;
  const int Z = zn.Z, DN = zn.DN, W = 1 + DN + Z;
  // z1. Each row's bits (candidate, strict, fit), segment start and zone
  // request
#pragma unroll (R <= 4 ? R : 1)
  for (int r = 0; r < R; ++r) {
    const int i = tid + r * T;
    if (i >= P) continue;
    const int node = (int)(key[r] >> 32);
    int bits = 0;
    if (node < N) {
      const int row = (int)(key[r] & 0xFFFFFFFFu);
      const uint32_t info = zn.side[(size_t)node * W];
      const bool single = (info & kSideSingle) != 0;
      const bool required = zn.required[row];
      if ((single || bound[r] || required) && (info & kSideHasZones)) bits |= kZoneCand;
      if (single || required) bits |= kZoneStrict;
      if (ok[r]) bits |= kZoneFit;
    }
    z_bits[i] = start[r] << 4 | bits;
    if (start[r] == i) {
#pragma unroll
      for (int k = 0; k < kZoneListSlots; ++k) z_list[(size_t)i * kZoneListSlots + k] = (E)-1;
    }
    constexpr int DZ = D < kMaxZoneDims ? D : kMaxZoneDims;
#pragma unroll
    for (int d = 0; d < DZ; ++d)
      if (d < DN) z_req[(size_t)i * DN + d] = rq[r][d];
  }
  __syncthreads();
  // z2. The candidates' ranks by a segmented scan: the fifth and later
  // refused, the first four listed at their segment's first row
  int j0, j1;
  dev_span(P, j0, j1);
  int run = 0;
  for (int j = j0; j < j1; ++j) run = zone_then(run, zone_term(z_bits[j], j));
  run = seg_block_scan(run, area, [](int l, int r) { return zone_then(l, r); });
  for (int j = j0; j < j1; ++j) {
    const int w = z_bits[j];
    run = zone_then(run, zone_term(w, j));
    int res = -1;
    if (w & kZoneCand) {
      const int rank = (run & ~kZoneHead) - 1;
      if (rank < kZoneWinners)
        z_list[(size_t)(w >> 4) * kZoneListSlots + rank] = zone_entry<E>(j, w & 7);
      else
        res = kZoneRefused;
    }
    z_res[j] = res;  // this thread's row: its bits were read above
  }
  __syncthreads();
  // z3. A thread a segment with a candidate: its listed rows' picks
#pragma unroll (R <= 4 ? R : 1)
  for (int r = 0; r < R; ++r) {
    const int i = tid + r * T;
    const int node = (int)(key[r] >> 32);
    if (i >= P || start[r] != i || node >= N) continue;
    int list[kZoneListSlots];
    zone_list_load(z_list, i, list);
    if (list[0] < 0) continue;
    if (Z == 2 && DN == 2)
      zone_segment_picks<2, 2>(list, node, z_res, z_req, zn);
    else if (Z == 4 && DN == 2)
      zone_segment_picks<4, 2>(list, node, z_res, z_req, zn);
    else
      zone_segment_picks<0, 0>(list, node, z_res, z_req, zn);
  }
  __syncthreads();
  // z4. Each row reads its result
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
// off its picked zone, zone_free - segment_sum(...). z5: each row with a
// pick writes its final zone (-1 when it lost at a later test); z6: the
// thread of each segment's first row sums its listed rows' charges and
// subtracts them (zone_segment_charges): only a listed row can hold a
// pick. The whole block calls it.
template <int D, int R, class E>
__device__ void zone_charge(const bool (&ok)[R], const int (&zsel)[R], const uint64_t (&key)[R],
                            const int (&start)[R], int P, int N, const E* z_list, int* z_res,
                            const float* z_req, const RoundZones& zn) {
  const int tid = threadIdx.x, T = blockDim.x;
  const int Z = zn.Z, DN = zn.DN;
  // z5. Each row with a pick: its final zone
#pragma unroll (R <= 4 ? R : 1)
  for (int r = 0; r < R; ++r) {
    const int i = tid + r * T;
    if (i < P && zsel[r] >= 0) z_res[i] = ok[r] ? zsel[r] : -1;
  }
  __syncthreads();
  // z6. A thread a segment with a candidate: the charges summed, then
  // subtracted
#pragma unroll (R <= 4 ? R : 1)
  for (int r = 0; r < R; ++r) {
    const int i = tid + r * T;
    const int node = (int)(key[r] >> 32);
    if (i >= P || start[r] != i || node >= N) continue;
    int list[kZoneListSlots];
    zone_list_load(z_list, i, list);
    if (list[0] < 0) continue;
    if (Z == 2 && DN == 2)
      zone_segment_charges<2, 2>(list, node, z_res, z_req, zn);
    else if (Z == 4 && DN == 2)
      zone_segment_charges<4, 2>(list, node, z_res, z_req, zn);
    else
      zone_segment_charges<0, 0>(list, node, z_res, z_req, zn);
  }
  __syncthreads();
}

// --------------------------------------------------------------- devices
//
// The device phase (DeviceShare): a round's tables — the carried slot
// table [N, G] and free RDMA / FPGA counts [N] (nullptr: not tracked),
// charged in place, and the stats table [N, 4] (full count, best partial,
// largest slot, total) the round's pricing read, refreshed for the nodes
// charged — the priority-sorted pods' whole GPUs, share, RDMA and FPGA
// [P], and the batch's wide flag [1] (device_prep.cu). slots == nullptr:
// no devices.
struct RoundDevices {
  float* slots;
  float* stats;
  float* rdma;
  float* fpga;
  const int* whole;
  const float* share;
  const int* rdma_req;
  const int* fpga_req;
  const int* wide;
  int G;
};

// A sorted row's device word: its pod row (low 20 bits: P <= 2^20) and
// flags. The segment word of a sorted row is its node: the keys' high half,
// kept because the quota commit takes the keys' room before the charges.
constexpr int kDevRowMask = (1 << 20) - 1;
constexpr int kDevOk = 1 << 20;     // accepted (in: by the fit tests; out: and the devices)
constexpr int kDevOpens = 1 << 21;  // a share pod that opens a full slot
constexpr int kDevFinal = 1 << 22;  // a final winner

// The device phase's running sums: four whole numbers and whether a
// segment starts in the span they cover. The reference takes float prefix
// sums of the round's sorted rows (a cumsum less the cumsum before the
// segment); while the batch is not wide (device_prep.cu: each series'
// absolute values sum to at most 2^24) every partial sum of that walk is
// an integer float32 holds, so the signed integer sum is its value, a
// negative ask included. A wide batch takes the float walk (device_walk).
constexpr int kDevScanWords = 5;  // a warp's total in the scan area: head, four sums

struct DevSums {
  int v[4];
  bool head;
};

__device__ __forceinline__ DevSums dev_none() { return DevSums{{0, 0, 0, 0}, false}; }

// l then r. In the charges (kCharge) the fourth sum is the share winner's
// word, OR-ed: a segment has at most one share winner.
template <bool kCharge>
__device__ __forceinline__ DevSums dev_then(const DevSums& l, const DevSums& r) {
  if (r.head) return r;
  DevSums o;
  o.head = l.head;
#pragma unroll
  for (int f = 0; f < 4; ++f) o.v[f] = kCharge && f == 3 ? (l.v[f] | r.v[f]) : l.v[f] + r.v[f];
  return o;
}

__device__ __forceinline__ DevSums seg_shfl_up(const DevSums& x, int off) {
  DevSums y;
#pragma unroll
  for (int f = 0; f < 4; ++f) y.v[f] = __shfl_up_sync(kFull, x.v[f], off);
  y.head = __shfl_up_sync(kFull, (int)x.head, off) != 0;
  return y;
}

// A warp's total in the scan area: kDevScanWords words.
__device__ __forceinline__ DevSums seg_load(const int* area, int w, const DevSums&) {
  const int* a = area + w * kDevScanWords;
  DevSums x;
  x.head = a[0] != 0;
#pragma unroll
  for (int f = 0; f < 4; ++f) x.v[f] = a[1 + f];
  return x;
}

__device__ __forceinline__ void seg_store(int* area, int w, const DevSums& x) {
  int* a = area + w * kDevScanWords;
  a[0] = x.head;
#pragma unroll
  for (int f = 0; f < 4; ++f) a[1 + f] = x.v[f];
}

// Two words a row, the device word and the segment word, then the scan
// area.
__host__ __device__ inline size_t dev_bytes(int P) {
  return ((size_t)P * 2 + kWarps * kDevScanWords) * sizeof(int);
}

// Sorted row j's terms in the acceptance: its node, whether its segment
// starts there, its pod row, whether it opens a full slot, and the whole
// GPUs (plus one when it opens), its share count (0 or 1), RDMA and FPGA.
struct DevRow {
  int node, row;
  bool head, frac, opens;
  DevSums t;
};

__device__ __forceinline__ DevRow dev_row(const uint64_t* keys, int j, int N,
                                          const RoundDevices& dv) {
  DevRow r;
  r.node = (int)(keys[j] >> 32);
  r.row = (int)(keys[j] & 0xFFFFFFFFu);
  r.head = j == 0 || (int)(keys[j - 1] >> 32) != r.node;
  const float partial = dv.stats[(size_t)min(r.node, N - 1) * koord_device::kStats + 1];
  const float share = dv.share[r.row];
  r.frac = share > kEps;
  r.opens = r.frac && share > partial + kEps;
  r.t.head = r.head;
  r.t.v[0] = dv.whole[r.row] + (r.opens ? 1 : 0);
  r.t.v[1] = r.frac ? 1 : 0;
  r.t.v[2] = dv.rdma != nullptr ? dv.rdma_req[r.row] : 0;
  r.t.v[3] = dv.fpga != nullptr ? dv.fpga_req[r.row] : 0;
  return r;
}

// XLA's CPU cumsum (chunks of 16, the chunk totals scanned the same way,
// each chunk then offset by the scanned total of the chunks before) taken
// one element at a time, in order: each level keeps its open chunk's
// inner sum and the cumsum at its latest element, and a chunk that closes
// moves its total up a level after the element's cumsum is taken. The
// same float adds as series_cumsum, so the same bits.
struct WalkCumsum {
  int n;                    // levels above the base (ScanLevels.n)
  int len[kMaxLevels];
  float acc[kMaxLevels];    // the open chunk's running sum, each level
  float last[kMaxLevels];   // the cumsum at the latest element, levels >= 1

  __device__ __forceinline__ void init(const ScanLevels& lv) {
    n = lv.n;
    for (int l = 0; l < kMaxLevels; ++l) {
      len[l] = lv.len[l];
      acc[l] = last[l] = 0.0f;
    }
  }

  // element k of the base with value v; returns the cumsum there
  __device__ __forceinline__ float push(int k, float v) {
    float base_cum = 0.0f;
    for (int l = 0;; ++l) {
      acc[l] = k % kScanBase == 0 ? v : acc[l] + v;
      const bool up = l < n;
      const float cum = up && k / kScanBase > 0 ? acc[l] + last[l + 1] : acc[l];
      if (l == 0) base_cum = cum;
      else last[l] = cum;
      if (!up || !(k % kScanBase == kScanBase - 1 || k == len[l] - 1)) break;
      v = acc[l];
      k /= kScanBase;
    }
    return base_cum;
  }
};

// The acceptance of a wide batch (device_prep.cu), in the reference's
// float order: one thread walks the four series (the whole GPUs plus the
// slot a share opens, the share count, RDMA, FPGA) over every sorted row,
// takes each row's segment prefix as the cumsum less the cumsum before
// the segment (_segment_prefix_sums), and clears kDevOk where the row
// fails a test. Each row's word and segment are written first. A serial
// walk: such a batch asks for more than 2^24 GPUs, NICs or FPGAs, which
// no cluster holds. The whole block calls it.
__device__ __noinline__ void device_walk(const uint64_t* keys, int P, int N, int* d_info,
                                         int* d_seg, const RoundDevices dv) {
  int j0, j1;
  dev_span(P, j0, j1);
  for (int j = j0; j < j1; ++j) {
    const DevRow r = dev_row(keys, j, N, dv);
    const bool ok = (d_info[j] & kDevOk) != 0 && r.node < N;
    d_info[j] = r.row | (ok ? kDevOk : 0) | (r.opens ? kDevOpens : 0);
    d_seg[j] = r.node;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const ScanLevels lv = scan_levels(P);
    WalkCumsum w[4];
    float prev[4], base[4];
    for (int f = 0; f < 4; ++f) {
      w[f].init(lv);
      prev[f] = base[f] = 0.0f;
    }
    for (int j = 0; j < P; ++j) {
      const int info = d_info[j], row = info & kDevRowMask, node = d_seg[j];
      const int g = min(node, N - 1);
      const bool head = j == 0 || d_seg[j - 1] != node;
      const bool frac = dv.share[row] > kEps;
      const float x[4] = {(float)dv.whole[row] + ((info & kDevOpens) ? 1.0f : 0.0f),
                          frac ? 1.0f : 0.0f, (float)dv.rdma_req[row], (float)dv.fpga_req[row]};
      float seg[4];
      for (int f = 0; f < 4; ++f) {
        const float cum = w[f].push(j, x[f]);
        if (head) base[f] = j > 0 ? prev[f] : 0.0f;
        prev[f] = cum;
        seg[f] = cum - base[f];
      }
      bool ok = seg[0] <= dv.stats[(size_t)g * koord_device::kStats] + kEps;
      ok = ok && (!frac || seg[1] - x[1] < 0.5f);
      if (dv.rdma != nullptr) ok = ok && seg[2] <= dv.rdma[g] + kEps;
      if (dv.fpga != nullptr) ok = ok && seg[3] <= dv.fpga[g] + kEps;
      if (!ok) d_info[j] = info & ~kDevOk;
    }
  }
  __syncthreads();
}

// The device acceptance (solver.py:1246-1274) on the rows' fit acceptance
// (kDevOk in d_info, written by each row). Within each node's segment of
// the sorted rows: the whole GPUs asked so far (plus one for each share pod
// that opens a full slot) within the node's full slots, only the
// segment's first share pod, the RDMA and FPGA asked so far within the
// free counts. The four running sums are whole numbers, so they are a
// segmented scan of integers: each thread takes a span of rows in order,
// sums it, the block scans the spans' sums, and each row then holds its
// own prefixes against the node's round-start stats and counts. A wide
// batch takes device_walk instead. The whole block calls it.
__device__ __noinline__ void device_accept(const uint64_t* keys, int P, int N, int* d_info,
                                           int* d_seg, int* d_scan, const RoundDevices dv) {
  __syncthreads();  // every row's fit acceptance is in
  if (dv.wide[0] != 0) {
    device_walk(keys, P, N, d_info, d_seg, dv);
    return;
  }
  int j0, j1;
  dev_span(P, j0, j1);
  DevSums run = dev_none();
  for (int j = j0; j < j1; ++j) run = dev_then<false>(run, dev_row(keys, j, N, dv).t);
  run = seg_block_scan(run, d_scan,
                       [](const DevSums& l, const DevSums& r) { return dev_then<false>(l, r); });
  for (int j = j0; j < j1; ++j) {
    const DevRow r = dev_row(keys, j, N, dv);
    run = dev_then<false>(run, r.t);
    const bool real = r.node < N;
    const float full = dv.stats[(size_t)min(r.node, N - 1) * koord_device::kStats];
    bool ok = (d_info[j] & kDevOk) != 0 && real;
    ok = ok && (float)run.v[0] <= full + kEps;
    ok = ok && (!r.frac || (float)run.v[1] - 1.0f < 0.5f);
    if (dv.rdma != nullptr) ok = ok && (float)run.v[2] <= (real ? dv.rdma[r.node] : 0.0f) + kEps;
    if (dv.fpga != nullptr) ok = ok && (float)run.v[3] <= (real ? dv.fpga[r.node] : 0.0f) + kEps;
    d_info[j] = r.row | (ok ? kDevOk : 0) | (r.opens ? kDevOpens : 0);
    d_seg[j] = r.node;
  }
  __syncthreads();
}

// One node's device charges: slot_commit of its winners' whole GPUs and
// share winner onto its slot row, the RDMA and FPGA off the free counts,
// and its stats row refreshed.
__device__ __forceinline__ void dev_apply(const RoundDevices& dv, int node, float whole,
                                          float frac, bool opens, float rdma, float fpga) {
  float* row = dv.slots + (size_t)node * dv.G;
  koord_device::slot_commit_row(row, dv.G, whole, frac, opens);
  if (dv.rdma != nullptr) dv.rdma[node] = dv.rdma[node] - rdma;
  if (dv.fpga != nullptr) dv.fpga[node] = dv.fpga[node] - fpga;
  koord_device::slot_stats_row(row, dv.G, dv.stats + (size_t)node * koord_device::kStats);
}

// The device charges (solver.py:1386-1416) of the final winners (kDevFinal
// in d_info): the same segmented scan sums each segment's winners' whole
// GPUs, RDMA and FPGA (whole numbers, exact in any order) and finds its
// one share winner; the thread of the segment's last row applies
// slot_commit to the node's slot row, subtracts the sums from the free
// counts and refreshes the node's stats row. In a wide batch the thread of
// the segment's first row sums the winners in row order as floats
// (segment_sum's order, from 0). Nodes without a winner are not touched
// (slot_commit and `free - 0` leave them as they are). The whole block
// calls it.
__device__ __noinline__ void device_charge(int P, int N, const int* d_info, const int* d_seg,
                                           int* d_scan, const RoundDevices dv) {
  int j0, j1;
  dev_span(P, j0, j1);
  if (dv.wide[0] != 0) {
    for (int j = j0; j < j1; ++j) {
      const int node = d_seg[j];
      if ((j > 0 && d_seg[j - 1] == node) || node >= N) continue;
      float whole = 0.0f, frac = 0.0f, rdma = 0.0f, fpga = 0.0f;
      bool any = false, opens = false;
      for (int k = j; k < P && d_seg[k] == node; ++k) {
        const int info = d_info[k];
        if (!(info & kDevFinal)) continue;
        const int row = info & kDevRowMask;
        any = true;
        whole = whole + (float)dv.whole[row];
        if (dv.share[row] > kEps) frac = frac + dv.share[row];
        opens = opens || (info & kDevOpens) != 0;
        rdma = rdma + (float)dv.rdma_req[row];
        fpga = fpga + (float)dv.fpga_req[row];
      }
      if (any) dev_apply(dv, node, whole, frac, opens, rdma, fpga);
    }
    __syncthreads();
    return;
  }
  auto terms = [&](int j) {
    const int info = d_info[j];
    DevSums t = dev_none();
    t.head = j == 0 || d_seg[j - 1] != d_seg[j];
    if (info & kDevFinal) {
      const int row = info & kDevRowMask;
      t.v[0] = dv.whole[row];
      t.v[1] = dv.rdma_req[row];
      t.v[2] = dv.fpga_req[row];
      // bit 0: a winner; above it, the share winner's sorted row + 1
      t.v[3] = 1 | (dv.share[row] > kEps ? (j + 1) << 1 : 0);
    }
    return t;
  };
  DevSums run = dev_none();
  for (int j = j0; j < j1; ++j) run = dev_then<true>(run, terms(j));
  run = seg_block_scan(run, d_scan,
                       [](const DevSums& l, const DevSums& r) { return dev_then<true>(l, r); });
  for (int j = j0; j < j1; ++j) {
    run = dev_then<true>(run, terms(j));
    const int node = d_seg[j];
    if ((j + 1 < P && d_seg[j + 1] == node) || node >= N || !(run.v[3] & 1)) continue;
    float frac = 0.0f;
    bool opens = false;
    if (run.v[3] >> 1) {
      const int info = d_info[(run.v[3] >> 1) - 1];
      frac = dv.share[info & kDevRowMask];
      opens = (info & kDevOpens) != 0;
    }
    dev_apply(dv, node, (float)run.v[0], frac, opens, (float)run.v[1], (float)run.v[2]);
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
                                               int P, int N, int* z_bits, int* z_list,
                                               float* z_req, int* area, const RoundZones& zn) {
  zone_select<D, R>(ok, zsel, key, start, rq, bound, P, N, z_bits, z_list, z_req, area, zn);
}

template <int D, int R>
__device__ __noinline__ void zone_charge_apart(const bool (&ok)[R], const int (&zsel)[R],
                                               const uint64_t (&key)[R], const int (&start)[R],
                                               int P, int N, const int* z_list, int* z_res,
                                               const float* z_req, const RoundZones& zn) {
  zone_charge<D, R>(ok, zsel, key, start, P, N, z_list, z_res, z_req, zn);
}

// R rows a thread: row i = tid + r * blockDim.x. A row's values stay in
// registers from its load to its last use; only what other rows read
// (keys, cumsums, flags, the values the charge chains add) goes through
// shared memory. A single SM sends the whole round's scattered loads and
// stores, each warp instruction a line a lane, so the design keeps them
// few: the pods' columns are read once, coalesced, in priority order and
// gathered from shared memory after the sort; node rows are read with
// vector loads, once.
template <int D, int R, bool kQuota, bool kZone, bool kGlobal, bool kDev>
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
  uint64_t* keys2 = keys + P;                           // the area
  float* series = (float*)keys2;                        // [3 G, lv.total]
  float* st_req = (float*)((char*)keys2 + sort_room(P));  // [P, D] if staged
  float* st_est = st_req + (size_t)P * D;               // [P, D]
  int* st_bits = (int*)(st_est + (size_t)P * D);        // [P]
  int* st_asg = st_bits + P;                            // [P]
  int* s_flags = (int*)((char*)keys2 + area_bytes(P, D, G, staged, qbytes));  // [P]
  // the zone phase's words (kZone): bits, then result [P], the segments'
  // lists [P, 4] (16-bit entries in shared memory), then the zone
  // requests [P, DN]
  using ZoneEntryT = std::conditional_t<kGlobal, int, uint16_t>;
  int* z_bits = s_flags + P;
  ZoneEntryT* z_list = (ZoneEntryT*)(z_bits + P);
  float* z_req = (float*)(z_list + (size_t)P * kZoneListSlots);
  // the device phase's words (devices): each sorted row's device word and
  // segment word [P] each, after the zone phase's
  int* d_info = (int*)((char*)z_bits + (kZone ? zone_bytes(P, zn.DN, kGlobal) : 0));
  int* d_seg = d_info + P;
  int* d_scan = d_seg + P;
  const bool devices = kDev && dv.slots != nullptr;
  const int tid = threadIdx.x, T = blockDim.x;
  // the rows present: the loops with a barrier run over these only (above
  // 4 rows a thread; up to 4 they unroll over R)
  const int RN = R > 4 ? min(R, (P + T - 1) / T) : R;
  if (tid == 0) s_lv = scan_levels(P);

  // 1. The rank-modular choice (:1204-1213): rank is the inclusive count of
  // active pods minus 1, an exact integer scan: at one row a thread a
  // block scan of the rows' flags, above one block scan over a span of
  // positions a thread (the flags read from device memory), the ranks
  // noted in the sort's room. The pods' columns are staged on the way, in
  // priority order.
  uint64_t key[R];
  int carry = 0;
  int* s_rank = (int*)keys2;
  if constexpr (R > 1) {
    int j0, j1;
    dev_span(P, j0, j1);
    int mine = 0;
    for (int j = j0; j < j1; ++j) mine += active[j] ? 1 : 0;
    int total;
    int at = koord_split::excl(mine, warp_sums, total);
    for (int j = j0; j < j1; ++j) {
      at += active[j] ? 1 : 0;
      s_rank[j] = at - 1;
    }
    __syncthreads();
  }
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
    int rank;
    if constexpr (R > 1)
      rank = i < P ? s_rank[i] : 0;
    else
      rank = block_scan(m.act ? 1 : 0, warp_sums, carry, Add()) - 1;
    if (staged && i < P) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        st_req[(size_t)i * D + d] = srq[d];
        st_est[(size_t)i * D + d] = ses[d];
      }
      st_bits[i] = sbits | (m.act ? kStagedActive : 0);
      st_asg[i] = sasg;
    }
    key[r] = i < P ? choice_key(m, rank, i, N) : UINT64_MAX;
  }
  const ScanLevels& lv = s_lv;  // written before block_scan's barriers

  // 2. The stable sort by node key (:1215): at one row a thread a sort of
  // the keys in registers (block_sort); above, the stable radix split on
  // the node key (split.cuh), the keys arriving in position order, its
  // count table in the sort's room of the area.
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
    // n1. the split's passes (the ranks in the sort's room are read)
    __syncthreads();
    const koord_split::Plan pl = koord_split::plan(N);
    bool wide = false;  // 32-bit counts above 65,536 rows
    if constexpr (R > kGlobalRows) {
      wide = P > 65536;
      if (wide) split_rows<uint64_t, R>(key, P, RN, 32, pl, keys, (uint32_t*)keys2, warp_sums);
    }
    if (!wide) split_rows<uint64_t, R>(key, P, RN, 32, pl, keys, (uint16_t*)keys2, warp_sums);
  }
  __syncthreads();

  // 3. Each sorted row's node segment (jax.lax.cummax of the segments'
  // start positions) and its index: at one row a thread one block scan of
  // (start, count) pairs in the row loop; above, the segments' first rows
  // numbered by one block scan over a span of rows a thread, each row
  // noting its segment in s_flags and each first row its position in the
  // sort's room. Then each row's pod's columns (CPU x amp for cpu-bind
  // pods, :1217-1229) and loop state.
  int nseg = 0;
  if constexpr (R > 1) {
    // n2. the segments
    int* s_first = (int*)keys2;
    int j0, j1;
    dev_span(P, j0, j1);
    int heads = 0;
    for (int j = j0; j < j1; ++j) heads += j == 0 || (keys[j] >> 32) != (keys[j - 1] >> 32);
    int at = koord_split::excl(heads, warp_sums, nseg) - 1;
    for (int j = j0; j < j1; ++j) {
      if (j == 0 || (keys[j] >> 32) != (keys[j - 1] >> 32)) s_first[++at] = j;
      s_flags[j] = at;
    }
    __syncthreads();
  }
  // n3. the rows
  carry = 0;
  float rq[R][D], es[R][D];
  int start[R], seg[R], asg[R];
  bool prod[R], act[R], bound[R];
#pragma unroll (R <= 4 ? R : 1)
  for (int r = 0; r < RN; ++r) {
    const int i = tid + r * T;
    prod[r] = act[r] = false;
    asg[r] = -1;
    start[r] = seg[r] = 0;
#pragma unroll
    for (int d = 0; d < D; ++d) rq[r][d] = es[r][d] = 0.0f;
    if (i < P) {
      const int row = (int)(key[r] & 0xFFFFFFFFu);
      const int node = (int)(key[r] >> 32);
      if constexpr (R > 1) {
        seg[r] = s_flags[i];
        start[r] = ((const int*)keys2)[seg[r]];
      }
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
    if constexpr (R == 1) {
      const bool head = i < P && (i == 0 || (keys[i - 1] >> 32) != (key[r] >> 32));
      const int x = block_scan(head ? i << 16 | 1 : 0, warp_sums, carry, StartCount());
      start[r] = x >> 16;
      seg[r] = (x & 0xFFFF) - 1;
    }
  }
  if constexpr (R == 1) nseg = carry & 0xFFFF;
  __syncthreads();  // the segments' starts are read before the series take the area

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
    // n4. the cumsums
    series_cumsum(series, 3 * gn, lv);
    // n5. the tests
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
    device_accept(keys, P, N, d_info, d_seg, d_scan, dv);
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
      zone_select_apart<D, R>(ok, zsel, key, start, rq, bound, P, N, z_bits, z_list, z_req,
                              warp_sums, zn);
    else
      zone_select<D, R>(ok, zsel, key, start, rq, bound, P, N, z_bits, z_list, z_req, warp_sums,
                        zn);
#pragma unroll (R <= 4 ? R : 1)
    for (int r = 0; r < R; ++r) ok[r] = ok[r] && qok[r];
  }
  // the node's accepts: fit and quantum in every dim, no threshold
  // exceeded on a fresh node
#pragma unroll (R <= 4 ? R : 1)
  for (int r = 0; r < R; ++r)
    ok[r] = ok[r] && !(node_fresh[r] && over[r]) && !(prod[r] && node_fresh[r] && pover[r]);
  // 6. With quotas, the quota commit (it takes the keys' room: the
  // charges below read the segments from registers): only the pods that
  // also clear their chains stay accepted (:1362-1370).
  if constexpr (kQuota) {
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
      s_flags[i] = (ok[r] ? kAcc : 0) | (prod[r] ? kProd : 0) | (int)(key[r] >> 32) << kNodeShift;
  }

  // 7. The winners' charges, G dims a pass: each node segment's winners
  // onto its node's rows of the three tables, row by row in sorted order,
  // from the round-start values (the scatter-add XLA folds `table +
  // segment_sum(...)` into). A thread a (segment, table, dim) chain, the
  // rows' flags and values loaded kAhead ahead of the adds, the next
  // chain's round-start value loaded while this one adds; a non-winner's
  // add is selected away, never added as zero (x + 0 turns -0 into +0).
  // Each segment's first row is listed in the third series' room.
#pragma unroll 1
  for (int d0 = 0; d0 < D; d0 += G) {
    const int gn = min(G, D - d0);
    int* s_first = (int*)(series + 2 * gn * lv.total);
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
      if (start[r] == i) s_first[seg[r]] = i;
    }
    __syncthreads();
    // n6. the chains
    const int W = 3 * gn, chains = nseg * W;
    // chain c's node (N: the unchosen pods' segment, no chain) and table
    auto chain_node = [&](int c) { return s_flags[s_first[c / W]] >> kNodeShift; };
    auto chain_table = [&](int c) {
      const int t = (c % W) / gn;
      return t == 0 ? requested : t == 1 ? est_used : prod_used;
    };
    float next = 0.0f;
    if (tid < chains) {
      const int node = chain_node(tid);
      if (node < N) next = chain_table(tid)[(size_t)node * D + d0 + tid % gn];
    }
    for (int c = tid; c < chains; c += T) {
      const float run = next;
      if (c + T < chains) {
        const int node = chain_node(c + T);
        if (node < N) next = chain_table(c + T)[(size_t)node * D + d0 + (c + T) % gn];
      }
      const int k = c / W, w = c - k * W, t = w / gn, g = w - t * gn;
      const int s0 = s_first[k], s1 = k + 1 < nseg ? s_first[k + 1] : P;
      const int node = s_flags[s0] >> kNodeShift;
      if (node >= N) continue;
      const float* v = series + ((t == 0 ? 0 : gn) + g) * lv.total;
      const int need = t == 2 ? (kAcc | kProd) : kAcc;
      float acc = run;
      bool took = false;
      int j = s0;
      for (; j + kAhead <= s1; j += kAhead) {
        int f[kAhead];
        float x[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) f[u] = s_flags[j + u], x[u] = v[j + u];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const bool take = (f[u] & need) == need;
          acc = take ? acc + x[u] : acc;
          took = took || take;
        }
      }
      for (; j < s1; ++j) {
        const bool take = (s_flags[j] & need) == need;
        acc = take ? acc + v[j] : acc;
        took = took || take;
      }
      if (took) chain_table(c)[(size_t)node * D + d0 + g] = acc;
    }
    __syncthreads();
  }

  // 7z. With zones, the final winners' zone charges (:1417-1432)
  if constexpr (kZone && kGlobal)
    zone_charge_apart<D, R>(ok, zsel, key, start, P, N, z_list, z_bits, z_req, zn);
  else if constexpr (kZone)
    zone_charge<D, R>(ok, zsel, key, start, P, N, z_list, z_bits, z_req, zn);

  // 7d. With devices, the final winners' device charges (:1386-1416) and
  // the charged nodes' stats
  if (devices) {
#pragma unroll (R <= 4 ? R : 1)
    for (int r = 0; r < R; ++r) {
      const int i = tid + r * T;
      if (i < P && ok[r]) d_info[i] |= kDevFinal;
    }
    __syncthreads();
    device_charge(P, N, d_info, d_seg, d_scan, dv);
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
  const size_t zbytes = (zone ? zone_bytes(P, DN, false) : 0) + (dev ? dev_bytes(P) : 0);
  for (int staged = 1; staged >= 0; --staged)
    for (int g = D; g >= 1; --g) {
      const size_t smem = round_smem_bytes(P, D, g, staged, qbytes, zbytes);
      if (smem <= most) return Config{g, staged, qbytes, smem};
    }
  return Config{0, 0, qbytes, 0};
}

// Bytes of the device-memory working set of a round (kGlobal): every dim
// in one pass, pods staged, R rows a thread.
inline size_t big_bytes(int P, int D, int R, bool quota, int Q, int L, bool zone, int DN,
                        bool dev) {
  const size_t qbytes = quota ? quota_layout(P, D, Q, L, R).total : 0;
  return round_smem_bytes(P, D, D, 1, qbytes,
                          (zone ? zone_bytes(P, DN, true) : 0) + (dev ? dev_bytes(P) : 0));
}

template <int D, int R, bool kQuota, bool kZone, bool kGlobal, bool kDev>
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
      cudaError_t err = cudaFuncSetAttribute(
          round_tail_kernel<D, R, kQuota, kZone, kGlobal, kDev>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) {
        cudaGetLastError();  // clear it, so the next launch's check is clean
        return err;
      }
      configured = smem;
    }
  }
  round_tail_kernel<D, R, kQuota, kZone, kGlobal, kDev><<<1, threads, smem, a.stream>>>(
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
// round_zone.cu with zones; with devices round_dev.cu, round_zone_dev.cu), 1 the device-memory kernel (round_big.cu,
// with `bytes` of scratch), 2 the device-memory kernel of the rounds above
// kGlobalRows * kThreads pods (round_huge.cu), -1 none (above
// kHugeRows * kThreads pods).
// Shared memory takes a round when it fits and, with quotas, when each
// level's 32-bit sort key (quota << position bits | position) does.
inline int round_route(int P, int D, bool quota, int Q, int L, bool zone, int DN, bool dev,
                       size_t* bytes) {
  *bytes = 0;
  const int R = smem_rows(P, D, quota, zone);
  const bool key32 = !quota || (((unsigned long long)Q + 1) << pos_bits(P)) < (1ull << 32);
  if (R > 0 && key32 && smem_config(P, D, R, quota, Q, L, zone, DN, dev).G > 0) return 0;
  if (P > kHugeRows * kThreads) return -1;
  const int rows = P > kGlobalRows * kThreads ? kHugeRows : kGlobalRows;
  *bytes = big_bytes(P, D, rows, quota, Q, L, zone, DN, dev);
  return rows == kHugeRows ? 2 : 1;
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
  if (a.D < 1 || a.D > kMaxDims || a.N < 1 || a.N >= (1 << (31 - kNodeShift)) || a.K < 1 ||
      a.K > kMaxK)
    return cudaErrorInvalidValue;
  if (a.chain != nullptr && (a.Q < 1 || a.L < 1)) return cudaErrorInvalidValue;
  if (a.zones.free != nullptr &&
      (a.zones.Z < 1 || a.zones.Z > kMaxZones || a.zones.DN < 1 || a.zones.DN > kMaxZoneDims ||
       a.zones.DN > a.D || a.zones.side == nullptr))
    return cudaErrorInvalidValue;
  if (a.devices.slots != nullptr &&
      (a.devices.G < 1 || a.devices.G > koord_device::kMaxSlots || a.P > kDevRowMask + 1 ||
       a.devices.stats == nullptr || a.devices.wide == nullptr))
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

inline RoundZones make_zones(void* zone_free, const void* zone_cap, const void* side,
                             const void* most, const void* required, void* pod_zone, int Z,
                             int DN) {
  return RoundZones{(float*)zone_free, (const float*)zone_cap, (const bool*)most,
                    (const bool*)required, (int*)pod_zone, (const uint32_t*)side, Z, DN};
}

inline RoundDevices make_devices(void* slots, void* stats, void* rdma, void* fpga,
                                 const void* whole, const void* share, const void* rdma_req,
                                 const void* fpga_req, const void* wide, int G) {
  return RoundDevices{(float*)slots, (float*)stats, (float*)rdma, (float*)fpga,
                      (const int*)whole, (const float*)share, (const int*)rdma_req,
                      (const int*)fpga_req, (const int*)wide, G};
}

// The shared-memory round (round.cu, round_zone.cu; with devices
// round_dev.cu, round_zone_dev.cu): the instantiation for the rows a
// thread the round takes.
template <int D, bool kQuota, bool kZone, bool kDev>
cudaError_t launch_rows(const Args& a) {
  const int R = smem_rows(a.P, D, kQuota, kZone);
  if (R == 1) return launch<D, 1, kQuota, kZone, false, kDev>(a, threads_of(a.P, 1));
  if (R == 4) return launch<D, 4, kQuota, kZone, false, kDev>(a, kThreads);
  if constexpr (D <= 3 && !kQuota && !kZone) {
    if (R == kBigRows) return launch<D, kBigRows, kQuota, kZone, false, kDev>(a, kThreads);
  }
  return cudaErrorInvalidValue;
}

template <bool kQuota, bool kZone, bool kDev>
struct SmemLaunch {
  const Args& a;
  template <int D>
  cudaError_t run() const { return launch_rows<D, kQuota, kZone, kDev>(a); }
};

// One shared-memory entry's call: zones exactly when kZone, devices
// exactly when kDev, each level's 32-bit sort key (quota << position bits
// | position) in range.
template <bool kZone, bool kDev>
cudaError_t launch_shared_memory(const Args& a) {
  if ((a.zones.free != nullptr) != kZone || (a.devices.slots != nullptr) != kDev)
    return cudaErrorInvalidValue;
  const cudaError_t err = check_args(a);
  if (err != cudaSuccess) return err;
  if (a.chain != nullptr && ((unsigned long long)a.Q + 1) << pos_bits(a.P) >= (1ull << 32))
    return cudaErrorInvalidValue;
  return a.chain != nullptr ? with_d(a.D, SmemLaunch<true, kZone, kDev>{a})
                            : with_d(a.D, SmemLaunch<false, kZone, kDev>{a});
}

// The device-memory round at R rows a thread, for each of its
// instantiations (the device phase a run-time branch of each).
template <int R, bool kQuota, bool kZone>
struct BigLaunch {
  const Args& a;
  template <int D>
  cudaError_t run() const { return launch<D, R, kQuota, kZone, true, true>(a, kThreads); }
};

template <int R>
cudaError_t launch_device_memory(const Args& a) {
  if (a.P > R * kThreads || a.scratch == nullptr) return cudaErrorInvalidValue;
  const cudaError_t err = check_args(a);
  if (err != cudaSuccess) return err;
  const bool quota = a.chain != nullptr, zone = a.zones.free != nullptr;
  if (quota && zone) return with_d(a.D, BigLaunch<R, true, true>{a});
  if (quota) return with_d(a.D, BigLaunch<R, true, false>{a});
  if (zone) return with_d(a.D, BigLaunch<R, false, true>{a});
  return with_d(a.D, BigLaunch<R, false, false>{a});
}

}  // namespace
