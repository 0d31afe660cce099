// A batch's set-up before its first round and its teardown after its last
// round tail, each in one launch.
//
// Replaces what XLA fuses around the round loop of
// koordinator_tpu/ops/solver.py:assign inside the stream's scan step
// (:1704, :1805):
// - the priority order, _priority_order (:660-663,
//   jnp.argsort(-priority, stable=True)), and every pod field gathered in
//   it (:720-724), with the node mask's rows (:724);
// - the cpu-bind flags (_cpu_bind :612-622, taken at :756), the device
//   units (device.py:device_consumption :151-162) and the loop's initial
//   state (:1454-1470: nothing assigned, no zone, the pods' valid flags,
//   done when none is valid);
// - the un-sort (:1494-1496) and the zone charges (:1497-1509);
// - the stream step's gather of batch `index` and its writes of row
//   `index` of the outputs (:1704-1733, :1805-1855: assignments, placed
//   count, rounds, fallback counts, zone picks), and the index's advance.
//
// What bounds it on an H100: latency. At 512 pods a batch moves ~60 KB;
// the bytes take ~20 ns. What costs is the launches (the PyTorch version
// is ~42 a batch) and the chains of dependent steps: the first loads from
// device memory, the sort's barriers, each gathered row's load.
//
// Design:
// - batch_setup: block 0 sorts and gathers, blocks 1.. copy. Block 0
//   asks L2 for the sorted fields' rows, then packs each pod's key
//   (-priority, wrapped as int32 negation wraps, made unsigned by its sign
//   bit, less the batch's least) above its row and sorts the words: up to
//   a row a thread in registers (split.cuh's block_sort: a warp's bitonic
//   network, then merges through shared memory; in 32 bits where the
//   keys' span leaves room), above by split.cuh's stable radix split over
//   only the bits the keys span; up to 4,096 pods in shared memory, above
//   in a device-memory buffer of the caller's. Rows of one key keep their
//   arrival order: the words are unique and rise with the row. Then the
//   block's threads take (field, sorted row) items, a field's rows over
//   consecutive threads, each copying a row from the stacked batch
//   (16-byte words where aligned), and each sorted row's order, mask row,
//   bind flag, units and loop state as one more field. The other blocks
//   copy the rollback's fields in pod order as runs of words, zero the
//   shortlist's words and counts and count each node's real slots for the
//   device refund.
// - batch_teardown, mode 0: a thread a sorted row writes its assignment,
//   zone pick and zone charge at the pod's row. Mode 1, one block, after
//   the rollback: the placed count (an integer block sum), row `index` of
//   the stream's outputs and the index's advance.
// No atomics; every value is a copy or the plain version's arithmetic,
// without contraction (-fmad=false), so the results are bitwise its.

#include <cuda_runtime.h>
#include <stdint.h>

#include "split.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxFields = 16;
// the sort's rows in shared memory up to this many pods
constexpr int kSharedPods = 4096;
// MAX_ROUND_PODS (ops/commit.py)
constexpr int kMaxPods = 131072;
// bits of a word that hold the row (kMaxPods = 2^17)
constexpr int kRowBits = 17;
constexpr uint64_t kRowMask = (1ull << kRowBits) - 1;
constexpr int kTeardownThreads = 256;
// the words (or slot rows) a copying block takes before one more is launched
constexpr int kCopyPerBlock = 16 * kThreads;
constexpr int kMaxCopyBlocks = 64;

// The pod fields a set-up copies: field f's rows of `bytes` bytes from the
// stacked batch `src` [B, P, ...] (batch `index`) to `sorted` in priority
// order and to `unsorted` in pod order, either null.
struct Fields {
  const char* src[kMaxFields];
  char* sorted[kMaxFields];
  char* unsorted[kMaxFields];
  int bytes[kMaxFields];
  int n;
};

struct Setup {
  const long long* index;  // [1], or null: batch 0
  int P, D;
  // the stacked batch's fields the set-up reads besides its copies
  const int* priority;
  const bool* valid;
  const int8_t* qos;
  const float* requests;
  const int* whole;    // null without devices
  const float* share;
  // outputs in priority order, each null when not asked for
  long long* order;
  long long* mask_rows;  // order + index * P
  bool* bind;
  float* units;
  int* assigned;
  int* azone;
  int* state;  // [2]: (done, rounds)
  // zeroed: the shortlist's words and fallback counts
  int* zeros;
  int n_zeros;
  // the device refund's capacities: slot_cap[n] = 100 * #{g < G : g < cap_total[n] / 100}
  const float* cap_total;
  float* slot_cap;
  int N, G;
  uint64_t* scratch;  // 2 P words and the split's table, above kSharedPods
};

__device__ __forceinline__ void copy_row(const char* __restrict__ s, char* __restrict__ d,
                                         int bytes) {
  const uintptr_t a = (uintptr_t)s | (uintptr_t)d | (uintptr_t)bytes;
  if ((a & 15) == 0) {
    for (int k = 0; k < bytes; k += 16) *(uint4*)(d + k) = *(const uint4*)(s + k);
  } else if ((a & 7) == 0) {
    for (int k = 0; k < bytes; k += 8) *(uint2*)(d + k) = *(const uint2*)(s + k);
  } else if ((a & 3) == 0) {
    for (int k = 0; k < bytes; k += 4) *(uint32_t*)(d + k) = *(const uint32_t*)(s + k);
  } else {
    for (int k = 0; k < bytes; ++k) d[k] = s[k];
  }
}

// Copies `bytes` contiguous bytes by the threads t of `threads`, in the
// widest word both ends and the length align to.
__device__ __forceinline__ void copy_run(const char* __restrict__ s, char* __restrict__ d,
                                         size_t bytes, size_t t, size_t threads) {
  const uintptr_t a = (uintptr_t)s | (uintptr_t)d | (uintptr_t)bytes;
  if ((a & 15) == 0) {
    for (size_t e = t; e < bytes / 16; e += threads) ((uint4*)d)[e] = ((const uint4*)s)[e];
  } else if ((a & 3) == 0) {
    for (size_t e = t; e < bytes / 4; e += threads)
      ((uint32_t*)d)[e] = ((const uint32_t*)s)[e];
  } else {
    for (size_t e = t; e < bytes; e += threads) d[e] = s[e];
  }
}

// The order key of a priority: ascending keys are the stable order of
// -priority as int32 (the negation wraps: INT32_MIN stays itself and sorts
// first), the sign bit flipped so that unsigned order is signed order.
__device__ __forceinline__ unsigned key_of(int priority) {
  return (0u - (unsigned)priority) ^ 0x80000000u;
}

// The least and largest key and whether any flag is set, over the block.
__device__ void block_reduce(unsigned& lo, unsigned& hi, int& any, unsigned* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(koord_split::kAll, lo, off));
    hi = max(hi, __shfl_xor_sync(koord_split::kAll, hi, off));
    any |= __shfl_xor_sync(koord_split::kAll, any, off);
  }
  if (lane == 0) {
    red[warp] = lo;
    red[32 + warp] = hi;
    red[64 + warp] = (unsigned)any;
  }
  __syncthreads();
  if (warp == 0) {
    unsigned l = lane < nw ? red[lane] : 0xFFFFFFFFu;
    unsigned h = lane < nw ? red[32 + lane] : 0u;
    unsigned a = lane < nw ? red[64 + lane] : 0u;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      l = min(l, __shfl_xor_sync(koord_split::kAll, l, off));
      h = max(h, __shfl_xor_sync(koord_split::kAll, h, off));
      a |= __shfl_xor_sync(koord_split::kAll, a, off);
    }
    if (lane == 0) {
      red[96] = l;
      red[97] = h;
      red[98] = a;
    }
  }
  __syncthreads();
  lo = red[96];
  hi = red[97];
  any = (int)red[98];
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// Blocks 1..: the rollback's fields in pod order, the zeroed words, the
// nodes' real slots.
__device__ void setup_copies(const Fields& f, const Setup& s, size_t base) {
  const size_t t = (size_t)(blockIdx.x - 1) * blockDim.x + threadIdx.x;
  const size_t threads = (size_t)(gridDim.x - 1) * blockDim.x;
#pragma unroll
  for (int k = 0; k < kMaxFields; ++k) {  // unrolled: the fields stay in the parameter space
    if (k >= f.n || f.unsorted[k] == nullptr) continue;
    const size_t row = (size_t)f.bytes[k];
    copy_run(f.src[k] + base * row, f.unsorted[k], (size_t)s.P * row, t, threads);
  }
  for (size_t e = t; e < (size_t)s.n_zeros; e += threads) s.zeros[e] = 0;
  if (s.slot_cap != nullptr) {
    for (size_t n = t; n < (size_t)s.N; n += threads) {
      const float q = s.cap_total[n] / 100.0f;
      int real = 0;
      for (int g = 0; g < s.G; ++g) real += (float)g < q ? 1 : 0;
      s.slot_cap[n] = __fmul_rn((float)real, 100.0f);
    }
  }
}

// One sorted row's own outputs: the order, the mask row, the bind flag,
// the units and the loop state.
__device__ __forceinline__ void row_outputs(const Setup& s, int j, int i, size_t at) {
  if (s.order != nullptr) s.order[j] = i;
  if (s.mask_rows != nullptr) s.mask_rows[j] = (long long)at;
  if (s.bind != nullptr) {
    const float cpu = s.requests[at * s.D];
    const int q = s.qos[at];
    s.bind[j] = (q == 3 || q == 4) && cpu > 0.0f && fmodf(cpu, 1000.0f) == 0.0f;
  }
  if (s.units != nullptr)
    s.units[j] = __fadd_rn(__fmul_rn((float)s.whole[at], 100.0f), s.share[at]);
  if (s.assigned != nullptr) s.assigned[j] = -1;
  if (s.azone != nullptr) s.azone[j] = -1;
}

__global__ void __launch_bounds__(kThreads)
batch_setup_kernel(const Fields f, const Setup s) {
  extern __shared__ uint64_t smem[];
  __shared__ unsigned red[100];
  __shared__ int warp_sums[32];
  __shared__ const char* fsrc[kMaxFields];
  __shared__ char* fdst[kMaxFields];
  __shared__ int fbytes[kMaxFields];
  const int P = s.P, T = blockDim.x, t = threadIdx.x;
  const long long b = s.index != nullptr ? *s.index : 0;
  const size_t base = (size_t)b * P;
  if (blockIdx.x > 0) {
    setup_copies(f, s, base);
    return;
  }
  const bool shared = P <= kSharedPods;
  uint64_t* a = shared ? smem : s.scratch;
  uint64_t* w = a + P;
  // 0. the sorted fields' table in shared memory (read at run-time
  // indices), and their rows asked of L2 ahead of the gathers
#pragma unroll
  for (int k = 0; k < kMaxFields; ++k) {
    if (k >= f.n) continue;
    if (t == k) {
      fsrc[k] = f.src[k] + base * f.bytes[k];
      fdst[k] = f.sorted[k];
      fbytes[k] = f.bytes[k];
    }
    if (f.sorted[k] == nullptr) continue;
    const size_t bytes = shared ? (size_t)P * f.bytes[k] : 0;
    for (size_t off = (size_t)t * 128; off < bytes; off += (size_t)T * 128)
      prefetch_l2(f.src[k] + base * f.bytes[k] + off);
  }
  // 1. the keys, their span, any valid pod
  unsigned lo = 0xFFFFFFFFu, hi = 0u;
  int any = 0;
  for (int i = t; i < P; i += T) {
    const unsigned k = key_of(s.priority[base + i]);
    a[i] = k;
    lo = min(lo, k);
    hi = max(hi, k);
    any |= s.valid[base + i] ? 1 : 0;
  }
  block_reduce(lo, hi, any, red);
  // 2. the words (key - least, row), sorted: a key a thread in registers
  // up to a row a thread (in 32 bits where the keys' span leaves room),
  // above by the radix split; one key: the rows' own order
  const uint64_t* rows = w;
  if (P <= T) {
    const uint64_t word = t < P ? ((a[t] - lo) << kRowBits) | (uint64_t)t : ~0ull;
    __syncthreads();  // every key is read before the sort writes over a
    uint64_t mine = word;
    if (hi != lo && hi - lo < (1u << (32 - kRowBits))) {
      uint32_t* a32 = (uint32_t*)a;
      const uint32_t k32 = koord_split::block_sort<uint32_t>(
          t < P ? (uint32_t)word : ~0u, P, a32, a32 + P, ~0u);
      mine = t < P ? k32 : word;
    } else if (hi != lo) {
      mine = koord_split::block_sort<uint64_t>(word, P, a, w, ~0ull);
    }
    if (t < P) w[t] = mine;  // w: no other thread reads this slot now
    __syncthreads();
  } else {
    for (int i = t; i < P; i += T) a[i] = ((a[i] - lo) << kRowBits) | (uint64_t)i;
    __syncthreads();
    rows = a;
    if (hi != lo) {
      if (shared) {
        rows = koord_split::sort<uint16_t>(a, w, P, kRowBits, (long long)(hi - lo),
                                           (uint16_t*)(w + P), warp_sums);
      } else {
        rows = koord_split::sort<int>(a, w, P, kRowBits, (long long)(hi - lo), (int*)(w + P),
                                      warp_sums);
      }
    }
  }
  // 3. items (field, sorted row), a field's rows over consecutive threads,
  // then each sorted row's own outputs as one more field
  const int items = (f.n + 1) * P;
  for (int e = t; e < items; e += T) {
    const int k = e / P, j = e - k * P;
    const int i = (int)(rows[j] & kRowMask);
    if (k == f.n) {
      row_outputs(s, j, i, base + i);
    } else if (fdst[k] != nullptr) {
      const size_t row = (size_t)fbytes[k];
      copy_row(fsrc[k] + (size_t)i * row, fdst[k] + (size_t)j * row, (int)row);
    }
  }
  if (s.state != nullptr && t == 0) {
    s.state[0] = any ? 0 : 1;
    s.state[1] = 0;
  }
}

size_t shared_bytes(int P) {
  if (P > kSharedPods) return 0;
  size_t bytes = 2 * (size_t)P * sizeof(uint64_t);
  if (P > kThreads) bytes += koord_split::table_bytes<uint16_t>(P);
  return bytes;
}

size_t scratch_bytes(int P) {
  if (P <= kSharedPods) return 0;
  return 2 * (size_t)P * sizeof(uint64_t) + koord_split::table_bytes<int>(P);
}

struct Teardown {
  int P, D, N, DN;
  // the rounds' outputs, in priority order
  const long long* order;
  const int* assigned;
  const int* azone;        // null without zones
  const float* requests;   // sorted [P, D]
  const bool* bind;
  const float* cpu_amp;    // [N]
  // in pod order
  int* assignment;
  int* pod_zone;
  float* zone_charge;      // [P, DN]
  // mode 1: row `index` of the stream's outputs, then index + 1
  long long* index;
  const int* rounds;
  const int* fallbacks;    // [2] or null
  int* asg_out;            // [B, P]
  int* placed_out;         // [B]
  int* rounds_out;         // [B]
  int* fb_out;             // [B, 2] or null
  int* zsel_out;           // [B, P] or null
};

__global__ void __launch_bounds__(kTeardownThreads) unsort_kernel(const Teardown t) {
  const int j = blockIdx.x * kTeardownThreads + threadIdx.x;
  if (j >= t.P) return;
  const long long i = t.order[j];
  const int node = t.assigned[j];
  t.assignment[i] = node;
  if (t.azone == nullptr) return;
  const int z = t.azone[j];
  t.pod_zone[i] = z;
  for (int d = 0; d < t.DN; ++d) {
    float v = 0.0f;
    if (z >= 0) {
      v = t.requests[(size_t)j * t.D + d];
      if (d == 0 && t.bind[j]) {
        const float amp = t.cpu_amp[min(max(node, 0), t.N - 1)];
        v = __fmul_rn(v, amp < 1.0f ? 1.0f : amp);
      }
    }
    t.zone_charge[(size_t)i * t.DN + d] = v;
  }
}

__global__ void __launch_bounds__(kThreads) outputs_kernel(const Teardown t) {
  __shared__ int sums[32];
  const long long b = *t.index;
  const size_t base = (size_t)b * t.P;
  int placed = 0;
  for (int i = threadIdx.x; i < t.P; i += blockDim.x) {
    const int node = t.assignment[i];
    placed += node >= 0 ? 1 : 0;
    t.asg_out[base + i] = node;
    if (t.zsel_out != nullptr) t.zsel_out[base + i] = t.pod_zone[i];
  }
  int total;
  koord_split::excl(placed, sums, total);  // every thread has read the index
  if (threadIdx.x == 0) {
    t.placed_out[b] = total;
    t.rounds_out[b] = *t.rounds;
    if (t.fb_out != nullptr) {
      t.fb_out[2 * b] = t.fallbacks[0];
      t.fb_out[2 * b + 1] = t.fallbacks[1];
    }
    *t.index = b + 1;
  }
}

}  // namespace

// fields: 4 F int64 (src, sorted, unsorted, bytes of a row) for F fields,
// the pointers null where not asked for. index: [1] int64 or null (batch
// 0 of a stack of one). priority [B, P] int32, valid [B, P] bool, qos
// [B, P] int8, requests [B, P, D] float; whole [B, P] int32 and share
// [B, P] float, or null. Writes, each only where given: order [P] int64,
// mask_rows [P] int64, bind [P] bool, units [P] float, assigned and azone
// [P] int32 (-1), state [2] int32, zeros [n_zeros] int32 (0), slot_cap [N]
// float from cap_total [N] float at G slots. scratch: koord_batch_scratch
// bytes of device memory, or null where that is 0.
extern "C" int koord_batch_setup(const void* fields, int F, const void* index, int P,
                                 const void* priority, const void* valid, const void* qos,
                                 const void* requests, int D, const void* whole,
                                 const void* share, void* order, void* mask_rows, void* bind,
                                 void* units, void* assigned, void* azone, void* state,
                                 void* zeros, int n_zeros, const void* cap_total,
                                 void* slot_cap, int N, int G, void* scratch, void* stream) {
  if (P <= 0) return (int)cudaSuccess;
  if (P > kMaxPods || F < 0 || F > kMaxFields || D < 1 || n_zeros < 0 ||
      (slot_cap != nullptr && (cap_total == nullptr || N < 0 || G < 1)) ||
      (P > kSharedPods && scratch == nullptr) || (units != nullptr && whole == nullptr))
    return (int)cudaErrorInvalidValue;
  Fields f{};
  const long long* table = (const long long*)fields;
  size_t copies = 0;
  for (int k = 0; k < F; ++k) {
    f.src[k] = (const char*)table[4 * k];
    f.sorted[k] = (char*)table[4 * k + 1];
    f.unsorted[k] = (char*)table[4 * k + 2];
    f.bytes[k] = (int)table[4 * k + 3];
    if (f.src[k] == nullptr || f.bytes[k] <= 0) return (int)cudaErrorInvalidValue;
    if (f.unsorted[k] != nullptr) copies += ((size_t)P * f.bytes[k] + 3) / 4;
  }
  f.n = F;
  Setup s{(const long long*)index, P, D, (const int*)priority, (const bool*)valid,
          (const int8_t*)qos, (const float*)requests, (const int*)whole, (const float*)share,
          (long long*)order, (long long*)mask_rows, (bool*)bind, (float*)units,
          (int*)assigned, (int*)azone, (int*)state, (int*)zeros, n_zeros,
          (const float*)cap_total, (float*)slot_cap, N, G, (uint64_t*)scratch};
  size_t work = copies;
  if ((size_t)n_zeros > work) work = (size_t)n_zeros;
  // rounded up, so that any copy, zeroed word or real-slot count asked
  // for gets a helper block to write it
  if (slot_cap != nullptr && ((size_t)N * G + 3) / 4 > work) work = ((size_t)N * G + 3) / 4;
  int helpers = 0;
  if (work > 0) {
    helpers = (int)((work + kCopyPerBlock - 1) / kCopyPerBlock);
    helpers = helpers < 1 ? 1 : (helpers > kMaxCopyBlocks ? kMaxCopyBlocks : helpers);
  }
  const size_t smem = shared_bytes(P);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        batch_setup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so the next launch's check is clean
      return (int)err;
    }
  }
  batch_setup_kernel<<<1 + helpers, kThreads, smem, (cudaStream_t)stream>>>(f, s);
  return (int)cudaGetLastError();
}

// Bytes of device memory a set-up of P pods needs (0 up to 4,096 pods).
extern "C" int koord_batch_scratch(int P, long long* bytes) {
  if (P < 0 || P > kMaxPods) return (int)cudaErrorInvalidValue;
  *bytes = (long long)scratch_bytes(P);
  return (int)cudaSuccess;
}

// mode 0, the un-sort: order [P] int64, assigned [P] int32, azone [P]
// int32 or null, requests [P, D] float and bind [P] bool in priority
// order, cpu_amp [N] float; writes assignment [P] int32 and, with azone,
// pod_zone [P] int32 and zone_charge [P, DN] float in pod order.
// mode 1, the stream's outputs (one block): reads assignment, pod_zone
// (or null), rounds [1] int32 and fallbacks [2] int32 (or null); writes
// row index of asg_out [B, P], placed_out [B], rounds_out [B], fb_out
// [B, 2] and zsel_out [B, P] (each of the last two or null), then
// advances index [1] int64.
extern "C" int koord_batch_teardown(int mode, int P, const void* order, const void* assigned,
                                    const void* azone, const void* requests, const void* bind,
                                    int D, const void* cpu_amp, int N, int DN, void* assignment,
                                    void* pod_zone, void* zone_charge, void* index,
                                    const void* rounds, const void* fallbacks, void* asg_out,
                                    void* placed_out, void* rounds_out, void* fb_out,
                                    void* zsel_out, void* stream) {
  if (P < 0 || P > kMaxPods) return (int)cudaErrorInvalidValue;
  Teardown t{P, D, N, DN, (const long long*)order, (const int*)assigned, (const int*)azone,
             (const float*)requests, (const bool*)bind, (const float*)cpu_amp,
             (int*)assignment, (int*)pod_zone, (float*)zone_charge, (long long*)index,
             (const int*)rounds, (const int*)fallbacks, (int*)asg_out, (int*)placed_out,
             (int*)rounds_out, (int*)fb_out, (int*)zsel_out};
  if (mode == 0) {
    if (azone != nullptr && (DN < 1 || DN > D || N < 1)) return (int)cudaErrorInvalidValue;
    if (P == 0) return (int)cudaSuccess;
    unsort_kernel<<<(P + kTeardownThreads - 1) / kTeardownThreads, kTeardownThreads, 0,
                    (cudaStream_t)stream>>>(t);
  } else if (mode == 1) {
    if (index == nullptr || rounds == nullptr || (fb_out != nullptr && fallbacks == nullptr))
      return (int)cudaErrorInvalidValue;
    outputs_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(t);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* koord_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
