// All-or-nothing gang rollback of one solved batch, in one launch.
//
// Replaces the LoadAware and quota parts of
// koordinator_tpu/ops/solver.py:enforce_gangs (:1858-1987, the counts and
// decisions at :1883-1894, the node-table refunds at :1896-1912 and
// :1973-1978, the zone refund at :1941-1960, the quota refund at
// :1963-1973): count each gang's placed members, roll back every pod of a
// Strict gang below its minMember, take the rolled-back pods' request,
// estimate and prod estimate off the node tables, with NUMA zones give
// each rolled-back pod's zone charge back to its zone and clear its pick,
// and with a quota tree take their requests off every quota of their
// chains.
//
// What bounds it on an H100: latency. A batch is a few hundred rows and a
// few KB; the bytes it must move take nanoseconds. What costs is launches:
// done in PyTorch ops it is ~20 launches and a stable sort a batch.
//
// Design: one block holds the batch in shared memory. Gang counts are
// integer adds in shared memory (exact in any order). Rolled-back rows are
// compacted into 64-bit keys (node << 32 | row), which a bitonic sort puts
// in (node, row) order — the keys are unique, so the order does not depend
// on the compaction's. One thread per touched node then sums its rows'
// refunds 0 + v0 + v1 + ... in original row order, the order the plain
// version (index_add_ on the CPU) sums in, and subtracts the sum from the
// table in place. Rows with nothing to refund are not touched, which equals
// the reference's `table - segment_sum(...)` bit for bit since x - 0 == x.
// No float atomics. A batch without rollbacks skips the sort and the sums.
// The quota refund, level by level (the reference's `used - segment_sum`
// per level, not folded by XLA): the rolled-back rows keyed (quota << 32 |
// row) and sorted again, one thread a quota sums 0 + v0 + v1 + ... in row
// order and subtracts the sum. Q == 1 (the disabled sentinel) passes no
// chain and refunds nothing. The zone refund, in the same node walk: the
// node's rolled-back rows that hold a zone add their charge [DN] onto its
// zone's row one after another in row order — the reference's
// `node_zone_free + segment_sum(...)`, which XLA's CPU backend folds into
// a scatter-add onto the table — and their picks are cleared after it.
// The device refunds, in the same node walk (solver.py:1913-1940): the
// node's rolled-back whole GPUs and shares, whole * 100 + share summed
// 0 + v0 + v1 + ... in row order (a segment_sum onto zeros), are
// water-filled back onto its slot row (device.cuh: slot_refund_row, the
// emptiest slot first by a stable order, the headroom's running sum in
// XLA's chunked order, padding slots past cap_total / 100 given none), and
// their RDMA and FPGA added back to the free counts that are tracked.
// A batch whose working set outgrows shared memory (above ~8,000 pods
// with quotas) keeps it in a device-memory scratch buffer the caller
// allocates once, through the same generic pointers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"

namespace {

constexpr int kThreads = 1024;

__host__ __device__ inline int pow2_at_least(int x) {
  int v = 1;
  while (v < x) v <<= 1;
  return v;
}

// Shared layout: s_asg[P] int, s_count[P] int, s_rb (the rollback count)
// and one int of padding, then keys[pow2(P)] uint64 (8-byte aligned) and,
// with a quota tree, qkeys[pow2(P)] uint64.
size_t gangs_smem_bytes(int P, bool quota) {
  return ((size_t)2 * P + 2) * sizeof(int) +
         (size_t)pow2_at_least(P) * sizeof(uint64_t) * (quota ? 2 : 1);
}

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

// Sorts keys[0, L) ascending (L a power of two), the whole block.
__device__ void bitonic_sort(uint64_t* keys, int L) {
  const int tid = threadIdx.x;
  for (int k = 2; k <= L; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < L; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const uint64_t a = keys[i], b = keys[ixj];
          const bool up = (i & k) == 0;
          if (up ? a > b : a < b) {
            keys[i] = b;
            keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kThreads)
enforce_gangs_kernel(int* __restrict__ assignment,
                     const int* __restrict__ gang_id,
                     const int* __restrict__ gang_min,
                     const bool* __restrict__ gang_nonstrict,
                     const float* __restrict__ requests,
                     const float* __restrict__ estimate,
                     const bool* __restrict__ is_prod,
                     float* __restrict__ requested,
                     float* __restrict__ est_used,
                     float* __restrict__ prod_used,
                     int* __restrict__ pod_zone, int P, int N, int D,
                     const int* __restrict__ chain, float* __restrict__ quota_used,
                     int Q, int levels, float* __restrict__ zone_free,
                     const float* __restrict__ zone_charge, int Z, int DN,
                     const koord_device::Refund dv, int* __restrict__ scratch) {
  extern __shared__ int smem[];
  // the working set: shared memory, or the device-memory scratch
  int* s_asg = scratch != nullptr ? scratch : smem;
  int* s_count = s_asg + P;
  int* s_rb = s_count + P;
  uint64_t* keys = (uint64_t*)(s_asg + 2 * P + 2);
  const int tid = threadIdx.x;

  for (int i = tid; i < P; i += blockDim.x) {
    s_asg[i] = assignment[i];
    s_count[i] = 0;
  }
  if (tid == 0) *s_rb = 0;
  __syncthreads();
  // placed members per gang (gid clipped to [0, P-1], as the reference)
  for (int i = tid; i < P; i += blockDim.x) {
    const int g = gang_id[i];
    if (g >= 0 && s_asg[i] >= 0) atomicAdd(&s_count[min(g, P - 1)], 1);
  }
  __syncthreads();
  for (int i = tid; i < P; i += blockDim.x) {
    const int a = s_asg[i];
    const int g = gang_id[i];
    const int gid = min(max(g, 0), P - 1);
    const bool gang_ok = s_count[gid] >= gang_min[gid] || gang_nonstrict[gid];
    const bool placed = a >= 0;
    const bool keep = placed && (g < 0 || gang_ok);
    assignment[i] = keep ? a : -1;
    if (placed && !keep) {
      const uint64_t node = (uint64_t)min(max(a, 0), N - 1);
      keys[atomicAdd(s_rb, 1)] = (node << 32) | (uint64_t)i;
    }
  }
  __syncthreads();
  const int R = *s_rb;
  if (R == 0) return;

  const int L = pow2_at_least(R);
  for (int i = R + tid; i < L; i += blockDim.x) keys[i] = UINT64_MAX;
  __syncthreads();
  bitonic_sort(keys, L);

  // one thread per touched node: ordered sums, subtracted in place
  for (int s = tid; s < R; s += blockDim.x) {
    const int node = (int)(keys[s] >> 32);
    if (s > 0 && (int)(keys[s - 1] >> 32) == node) continue;
    for (int d = 0; d < D; ++d) {
      float r = 0.0f, e = 0.0f, pr = 0.0f;
      for (int j = s; j < R && (int)(keys[j] >> 32) == node; ++j) {
        const int row = (int)(keys[j] & 0xFFFFFFFFu);
        const float est = estimate[(size_t)row * D + d];
        r = r + requests[(size_t)row * D + d];
        e = e + est;
        pr = pr + (is_prod[row] ? est : 0.0f);
      }
      const size_t at = (size_t)node * D + d;
      requested[at] = requested[at] - r;
      est_used[at] = est_used[at] - e;
      prod_used[at] = prod_used[at] - pr;
    }
    if (dv.slots != nullptr) {
      // the device refunds: the shares summed in row order, then
      // water-filled; RDMA and FPGA added back
      float refund = 0.0f, rdma = 0.0f, fpga = 0.0f;
      for (int j = s; j < R && (int)(keys[j] >> 32) == node; ++j) {
        const int row = (int)(keys[j] & 0xFFFFFFFFu);
        refund = refund + ((float)dv.whole[row] * 100.0f + dv.share[row]);
        rdma = rdma + (float)dv.rdma_req[row];
        fpga = fpga + (float)dv.fpga_req[row];
      }
      koord_device::slot_refund_row(dv.slots + (size_t)node * dv.G, dv.G, refund,
                                    dv.cap != nullptr, dv.cap != nullptr ? dv.cap[node] : 0.0f);
      if (dv.rdma != nullptr) dv.rdma[node] = dv.rdma[node] + rdma;
      if (dv.fpga != nullptr) dv.fpga[node] = dv.fpga[node] + fpga;
    }
    if (zone_free == nullptr) continue;
    // the zone refund: each row's charge onto its zone (clipped to Z - 1,
    // as the reference's one-hot clips it), row by row
    for (int j = s; j < R && (int)(keys[j] >> 32) == node; ++j) {
      const int row = (int)(keys[j] & 0xFFFFFFFFu);
      const int pz = pod_zone[row];
      if (pz < 0) continue;
      float* zrow = zone_free + ((size_t)node * Z + min(pz, Z - 1)) * DN;
      for (int d = 0; d < DN; ++d) zrow[d] = zrow[d] + zone_charge[(size_t)row * DN + d];
    }
  }
  if (pod_zone != nullptr) {
    __syncthreads();  // the zone refund has read the picks
    for (int s = tid; s < R; s += blockDim.x) pod_zone[(int)(keys[s] & 0xFFFFFFFFu)] = -1;
  }
  if (chain == nullptr) return;

  // the quota refund, one chain level after another: rows keyed (quota <<
  // 32 | row), rows without a quota at this level last
  uint64_t* qkeys = keys + pow2_at_least(P);
  for (int level = 0; level < levels; ++level) {
    for (int s = tid; s < L; s += blockDim.x) {
      uint64_t key = UINT64_MAX;
      if (s < R) {
        const int row = (int)(keys[s] & 0xFFFFFFFFu);
        const int q = chain[(size_t)row * levels + level];
        // a row past the table is dropped, as segment_sum drops it
        key = ((uint64_t)(q >= 0 && q < Q ? q : Q) << 32) | (uint64_t)row;
      }
      qkeys[s] = key;
    }
    __syncthreads();
    bitonic_sort(qkeys, L);
    for (int s = tid; s < R; s += blockDim.x) {
      const int q = (int)(qkeys[s] >> 32);
      if (q >= Q || (s > 0 && (int)(qkeys[s - 1] >> 32) == q)) continue;
      for (int d = 0; d < D; ++d) {
        float r = 0.0f;
        for (int j = s; j < R && (int)(qkeys[j] >> 32) == q; ++j)
          r = r + requests[(size_t)(qkeys[j] & 0xFFFFFFFFu) * D + d];
        const size_t at = (size_t)q * D + d;
        quota_used[at] = quota_used[at] - r;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int koord_enforce_gangs(void* assignment, const void* gang_id,
                                   const void* gang_min,
                                   const void* gang_nonstrict,
                                   const void* requests, const void* estimate,
                                   const void* is_prod, void* requested,
                                   void* est_used, void* prod_used,
                                   void* pod_zone, int P, int N, int D,
                                   const void* chain, void* quota_used, int Q,
                                   int levels, void* zone_free, const void* zone_charge,
                                   int Z, int DN, void* dev_slots, const void* cap_total,
                                   void* rdma_free, void* fpga_free, const void* gpu_whole,
                                   const void* gpu_share, const void* rdma_req,
                                   const void* fpga_req, int G, void* scratch, void* stream) {
  if (P <= 0) return (int)cudaSuccess;
  if (D < 1 || N < 1) return (int)cudaErrorInvalidValue;
  if (dev_slots != nullptr && (G < 1 || G > koord_device::kMaxSlots))
    return (int)cudaErrorInvalidValue;
  if (zone_free != nullptr && (Z < 1 || DN < 1 || pod_zone == nullptr || zone_charge == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool quota = chain != nullptr && quota_used != nullptr && Q > 1;
  // one block holds the whole batch, in shared memory or, where it does
  // not fit (koord_gangs_scratch), in the caller's scratch
  const size_t smem = scratch != nullptr ? 0 : gangs_smem_bytes(P, quota);
  if (scratch == nullptr && smem > (size_t)max_smem()) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        enforce_gangs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so the next launch's check is clean
      return (int)err;
    }
  }
  enforce_gangs_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (int*)assignment, (const int*)gang_id, (const int*)gang_min,
      (const bool*)gang_nonstrict, (const float*)requests,
      (const float*)estimate, (const bool*)is_prod, (float*)requested,
      (float*)est_used, (float*)prod_used, (int*)pod_zone, P, N, D,
      quota ? (const int*)chain : nullptr, quota ? (float*)quota_used : nullptr, Q, levels,
      (float*)zone_free, (const float*)zone_charge, Z, DN,
      koord_device::Refund{(float*)dev_slots, (const float*)cap_total, (float*)rdma_free,
                           (float*)fpga_free, (const int*)gpu_whole, (const float*)gpu_share,
                           (const int*)rdma_req, (const int*)fpga_req, G},
      (int*)scratch);
  return (int)cudaGetLastError();
}

// The scratch a batch of P pods needs (with a quota refund when `quota`):
// 0 while its working set fits in shared memory.
extern "C" int koord_gangs_scratch(int P, int quota, long long* bytes) {
  if (P < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = gangs_smem_bytes(P, quota != 0);
  *bytes = smem > (size_t)max_smem() ? (long long)smem : 0;
  return (int)cudaSuccess;
}

extern "C" const char* koord_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
