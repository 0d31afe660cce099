// A stable LSD radix split of a block's rows on a small integer key: the
// node sort of the round tail (round.cuh) and of the gang rollback
// (gangs.cu), each level's quota order of both, and the priority order of
// a batch's set-up (batch.cu); and the comparison sort of one key a thread
// (block_sort) both the round tail and the set-up take up to a row a
// thread.
//
// Rows arrive in an order of their own (priority position, pod row) and
// leave ordered by key, rows of one key in their order of arrival: the
// reference's argsort(stable=True) of the key. A pass takes `bits` bits of
// the key, least significant first; each pass is stable, so the last
// leaves the rows in (key, arrival) order. A pass:
// - each warp's 32 rows (a slice) count their digits by __match_any_sync
//   into `table` [digit][slice] (the lane first of its digit writes);
// - one exclusive block scan of the table in (digit, slice) order gives
//   each (digit, slice) its first place;
// - a row goes to that place plus the rows of its digit in the lanes
//   before it.
// Integer counts only, no atomics: the order is the rows' own. At most
// kMaxBits bits a pass (128 digits), as few passes as the key's top needs,
// the bits spread evenly over them (14 bits at 10,000 nodes: two passes of
// 7). Counts and places fit 16 bits up to 65,536 rows, 32 above.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace koord_split {

constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr int kMaxBits = 7;

struct Plan {
  int passes, bits;
};

// The passes and the bits a pass (at most max_bits) for keys 0..top.
__host__ __device__ inline Plan plan(long long top, int max_bits = kMaxBits) {
  int b = 1;
  while (b < 62 && (1ll << b) <= top) ++b;
  const int passes = (b + max_bits - 1) / max_bits;
  return Plan{passes, (b + passes - 1) / passes};
}

// Bytes of the count table for n rows at most kMaxBits a pass.
template <class C>
__host__ __device__ inline size_t table_bytes(long long n) {
  return (size_t)(1 << kMaxBits) * (size_t)((n + 31) / 32) * sizeof(C);
}

// Lanes before this one in the warp.
__device__ __forceinline__ unsigned lanes_before() { return (1u << (threadIdx.x & 31)) - 1u; }

// The count step of one row a lane (its warp one slice, `dig` -1 for a
// lane without a row): the lane first of its digit writes the slice's
// count of it. Returns the lanes of the same digit. The whole warp calls it.
template <class C>
__device__ __forceinline__ unsigned count(int dig, int slice, int S, C* table) {
  const unsigned peers = __match_any_sync(kAll, dig);
  if (dig >= 0 && (peers & lanes_before()) == 0) table[(size_t)dig * S + slice] = (C)__popc(peers);
  return peers;
}

// A row's place after the scan: its (digit, slice)'s first place and the
// rows of its digit in the lanes before it.
template <class C>
__device__ __forceinline__ int place(int dig, unsigned peers, int slice, int S, const C* table) {
  return (int)table[(size_t)dig * S + slice] + __popc(peers & lanes_before());
}

// Zeroes the table for a pass of n rows at `bits` bits (barrier after).
template <class C>
__device__ __forceinline__ void clear(C* table, int n, int bits) {
  const int E = ((n + 31) / 32) << bits;
  for (int e = threadIdx.x; e < E; e += blockDim.x) table[e] = 0;
  __syncthreads();
}

// The exclusive prefix of v over the block's threads in thread order, by
// warp shuffles and one shared word a warp (`warp_sums`, 32 ints); `total`
// takes the sum of all. The whole block calls it; barriers inside and after.
__device__ inline int excl(int v, int* warp_sums, int& total) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kAll, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kAll, w, off);
      if (lane >= off) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  const int at = x - v + (warp > 0 ? warp_sums[warp - 1] : 0);
  total = warp_sums[nw - 1];
  __syncthreads();  // warp_sums is reused by the next scan
  return at;
}

// The exclusive scan of the table of a pass of n rows at `bits` bits, in
// place, in (digit, slice) order. A table of at most four entries a
// thread: each thread a run of consecutive entries, the runs' sums
// scanned by excl. A larger one (where a thread's run would be read with
// bank conflicts, or a line a lane in device memory): each warp a run,
// read 32 entries at a time by its lanes, the runs' sums scanned by excl,
// then each warp scans its run 32 entries at a time by shuffles, carrying
// the sum before. The whole block calls it; barriers before and after.
template <class C>
__device__ void scan(C* table, int n, int bits, int* warp_sums) {
  __syncthreads();  // every count is written
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int E = ((n + 31) / 32) << bits;
  int total;
  if (E <= 4 * (int)blockDim.x) {
    const int e0 = min((int)threadIdx.x * 4, E), e1 = min(e0 + 4, E);
    int sum = 0;
    for (int e = e0; e < e1; ++e) sum += (int)table[e];
    int at = excl(sum, warp_sums, total);
    for (int e = e0; e < e1; ++e) {
      const int c = (int)table[e];
      table[e] = (C)at;
      at += c;
    }
    __syncthreads();
    return;
  }
  const int per = (E + nw - 1) / nw, e0 = min(warp * per, E), e1 = min(e0 + per, E);
  int sum = 0;
#pragma unroll 4
  for (int e = e0 + lane; e < e1; e += 32) sum += (int)table[e];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kAll, sum, off);
  int at = excl(lane == 0 ? sum : 0, warp_sums, total);
  at = __shfl_sync(kAll, at, 0);
  for (int e = e0; e < e1; e += 32) {
    const int c = e + lane < e1 ? (int)table[e + lane] : 0;
    int x = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kAll, x, off);
      if (lane >= off) x += y;
    }
    if (e + lane < e1) table[e + lane] = (C)(at + x - c);
    at += __shfl_sync(kAll, x, 31);
  }
  __syncthreads();
}

// One pass over 64-bit rows in memory, src[0, n) to dst[0, n), by the
// digit (row >> shift) & (2^bits - 1). The whole block calls it; dst is
// complete after its last barrier.
template <class C>
__device__ void pass(const uint64_t* src, uint64_t* dst, int n, int shift, int bits, C* table,
                     int* warp_sums) {
  const int T = blockDim.x, S = (n + 31) / 32;
  const int rounds = (n + T - 1) / T;
  const uint64_t mask = (1ull << bits) - 1;
  clear(table, n, bits);
  for (int r = 0; r < rounds; ++r) {
    const int i = threadIdx.x + r * T;
    count(i < n ? (int)((src[i] >> shift) & mask) : -1, i >> 5, S, table);
  }
  scan(table, n, bits, warp_sums);
  for (int r = 0; r < rounds; ++r) {
    const int i = threadIdx.x + r * T;
    const uint64_t row = i < n ? src[i] : 0;
    const int dig = i < n ? (int)((row >> shift) & mask) : -1;
    const unsigned peers = __match_any_sync(kAll, dig);
    if (i < n) dst[place(dig, peers, i >> 5, S, table)] = row;
  }
  __syncthreads();
}

// At most one row a thread, the rows' places by counting: a row's place
// is the count of rows below it (the rows are unique words), each thread
// reading every row from src (one broadcast load a row); one barrier,
// where a split's passes take a dozen. The whole block calls it.
__device__ inline void rank(const uint64_t* src, uint64_t* dst, int n) {
  const int i = threadIdx.x;
  if (i < n) {
    const uint64_t me = src[i];
    int at = 0;
#pragma unroll 4
    for (int j = 0; j < n; ++j) at += src[j] < me ? 1 : 0;
    dst[at] = me;
  }
  __syncthreads();
}

// The rows of a[0, n) (unique 64-bit words) in the order of their key,
// (row >> shift), at most top, rows of one key in their order in a: by
// counting (rank) up to a row a thread, above by the split's passes, a
// then b in turn. Returns the buffer that holds the result.
template <class C>
__device__ uint64_t* sort(uint64_t* a, uint64_t* b, int n, int shift, long long top, C* table,
                          int* warp_sums) {
  if (n <= (int)blockDim.x) {
    // unique words in arrival order: the word order within a key is the
    // arrival order exactly when the low words rise with it, as the
    // callers' payloads (a row's rank in arrival order) do
    rank(a, b, n);
    return b;
  }
  const Plan pl = plan(top);
  for (int p = 0; p < pl.passes; ++p) {
    pass(a, b, n, shift + p * pl.bits, pl.bits, table, warp_sums);
    uint64_t* t = a;
    a = b;
    b = t;
  }
  return a;
}

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
      const KeyT other = __shfl_xor_sync(kAll, key, mask);
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

}  // namespace koord_split
