// All-or-nothing gang rollback of one solved batch, in one launch.
//
// Replaces the LoadAware and quota parts of
// koordinator_tpu/ops/solver.py:enforce_gangs (:1858-1987, the counts and
// decisions at :1883-1894, the node-table refunds at :1896-1912 and
// :1973-1978, the device refunds at :1913-1940, the zone refund at
// :1941-1960, the quota refund at :1963-1973): count each gang's placed
// members, roll back every pod of a Strict gang below its minMember, take
// the rolled-back pods' request, estimate and prod estimate off the node
// tables, with devices give their GPUs, RDMA and FPGA back, with NUMA zones
// give each rolled-back pod's zone charge back to its zone and clear its
// pick, and with a quota tree take their requests off every quota of their
// chains.
//
// What bounds it on an H100: latency. A batch is a few hundred rows and a
// few KB; the bytes it must move take nanoseconds. What costs is the
// chains of dependent steps: the barriers of the orders, and the ordered
// sums, each as long as the rows of its node or quota (at the root quota,
// every rolled-back row).
//
// Design: one block holds the batch in its working set (shared memory, or
// above ~1,100 pods with a four-level quota tree and ~3,400 without, a
// device-memory scratch buffer the caller allocates, through the same
// pointers).
// - Gang counts are integer adds in shared memory (exact in any order).
//   A batch where nothing rolls back returns after them.
// - The rolled-back rows are listed in row order by a block scan (a span
//   of rows a thread), then put in (node, row) order by the stable radix
//   split on the node (split.cuh): the rows arrive in row order, so the
//   split keeps it within a node. No row bits in the key, no comparison
//   sort.
// - Their requests, estimates, prod flags, device asks and zone charges
//   are gathered once, by the whole block, in that order into the working
//   set.
// - Every ordered sum is a chain of its own on a thread, its loads ahead
//   of its adds (kAhead at a time): a (node, table, dim) sum 0 + v0 + v1 +
//   ... in row order, the order the plain version (index_add_ on the CPU)
//   sums in, then subtracted from the table in place (x - 0 == x for the
//   rows not touched, so the reference's `table - segment_sum(...)` bit for
//   bit); the device refunds (whole * 100 + share, RDMA, FPGA: a
//   segment_sum onto zeros, then the shares water-filled by
//   device.cuh:slot_refund_row, the emptiest slot first by a stable order,
//   padding slots past cap_total / 100 given none); and a (node, zone, dim)
//   fold of the node's rolled-back rows that hold that zone onto its row
//   of the zone table, row by row — the reference's
//   `node_zone_free + segment_sum(...)`, which XLA's CPU backend folds into
//   a scatter-add onto the table. The picks are cleared after the gather
//   read them.
// - The quota refund (the reference's `used - segment_sum` per level, not
//   folded by XLA): the rows of every chain level keyed (level, quota) in
//   row order and split at once (a row past the table keyed Q and
//   dropped, as segment_sum drops it); then level by level a (quota, dim)
//   chain on a thread sums 0 + v0 + v1 + ... and subtracts it. Q == 1 (the
//   disabled sentinel) passes no chain and refunds nothing.
// No float atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"
#include "split.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kAhead = 16;  // loads of a chain ahead of its adds
constexpr uint64_t kLow = 0xFFFFFFFFull;

inline size_t up8(size_t x) { return (x + 7) / 8 * 8; }

// The working set of a batch of P pods, D dims, L quota levels (0: no
// quota refund), with devices, with zones of DN dims (0: none). The split's
// rows: the rolled-back rows for the node sort, L of them each for the
// quota refund.
struct GangLayout {
  size_t asg, cnt, rows, inv, ka, kb, table, rq, es, fl, dvv, pz, zc, seg, qseg, total;
};

inline GangLayout gang_layout(int P, int D, int L, bool dev, int DN) {
  GangLayout g{};
  const size_t E = (size_t)P * (L > 1 ? L : 1);
  size_t at = 0;
  g.asg = at;   // [P] int: the assignment, then a rolled-back row's node (-1: kept)
  at = up8(at + (size_t)P * 4);
  g.cnt = at;   // [P] int: placed members a gang
  at = up8(at + (size_t)P * 4);
  g.rows = at;  // [P] int: the rolled-back rows in row order
  at = up8(at + (size_t)P * 4);
  g.inv = at;   // [P] int: each one's place in (node, row) order
  at = up8(at + (size_t)P * 4);
  g.ka = at;    // [E] u64: the split's rows, (key << 32 | payload)
  at = up8(at + E * 8);
  g.kb = at;    // [E] u64: its second buffer
  at = up8(at + E * 8);
  g.table = at;
  at = up8(at + koord_split::table_bytes<uint32_t>((long long)E));
  g.rq = at;    // [P, D] the rolled-back rows' requests, in (node, row) order
  at = up8(at + (size_t)P * D * 4);
  g.es = at;    // [P, D] their estimates
  at = up8(at + (size_t)P * D * 4);
  g.fl = at;    // [P] int: their prod flags
  at = up8(at + (size_t)P * 4);
  g.dvv = at;   // [P, 3] with devices: whole * 100 + share, RDMA, FPGA
  if (dev) at = up8(at + (size_t)P * 3 * 4);
  g.pz = at;    // [P] int with zones: their picks
  if (DN > 0) at = up8(at + (size_t)P * 4);
  g.zc = at;    // [P, DN] their zone charges
  if (DN > 0) at = up8(at + (size_t)P * DN * 4);
  g.seg = at;   // [P + 1] int: each node segment's first row, then R
  at = up8(at + ((size_t)P + 1) * 4);
  g.qseg = at;  // [E + 1] int: each (level, quota) segment's first row, then L R
  if (L > 0) at = up8(at + (E + 1) * 4);
  g.total = at;
  return g;
}

// The most shared memory a block may take on the current device, less the
// kernel's static words.
int max_smem() {
  static int bytes = 0;
  if (bytes == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return bytes - 256;
}

// 0 + v[s0] + v[s0 + 1] + ... + v[s1 - 1], each v[s] at v + s * stride;
// with `flagged`, 0 + (fl[s] ? v[s] : 0) + ... (the prod estimates). The
// loads of kAhead rows before their adds. Every node and device sum takes
// this one path, so a warp's lanes on different tables do not diverge.
__device__ __forceinline__ float chain_sum(const float* v, int stride, const int* fl,
                                           bool flagged, int s0, int s1) {
  float acc = 0.0f;
  int s = s0;
  for (; s + kAhead <= s1; s += kAhead) {
    float x[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const float e = v[(size_t)(s + u) * stride];
      x[u] = flagged && !fl[s + u] ? 0.0f : e;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) acc = acc + x[u];
  }
  for (; s < s1; ++s) acc = acc + (flagged && !fl[s] ? 0.0f : v[(size_t)s * stride]);
  return acc;
}

// 0 + the requests of rows q[e0, e1) (each row's rank in row order in the
// low word, its place in (node, row) order inv[rank]), dim d: the quota
// sums. Each batch's places are loaded while the batch before adds, its
// values ahead of its adds.
__device__ __forceinline__ float quota_sum(const float* rq, const int* inv, const uint64_t* q,
                                           int D, int d, int e0, int e1) {
  float acc = 0.0f;
  int e = e0;
  if (e + kAhead <= e1) {
    int s[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) s[u] = inv[q[e + u] & kLow];
    for (; e + kAhead <= e1; e += kAhead) {
      float x[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) x[u] = rq[(size_t)s[u] * D + d];
      if (e + 2 * kAhead <= e1) {
#pragma unroll
        for (int u = 0; u < kAhead; ++u) s[u] = inv[q[e + kAhead + u] & kLow];
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) acc = acc + x[u];
    }
  }
  for (; e < e1; ++e) acc = acc + rq[(size_t)inv[q[e] & kLow] * D + d];
  return acc;
}

// The heads of the runs of equal keys (row >> 32) of k[0, n) in order:
// head[m] the first row of run m, head[runs] = n; returns the runs. A
// block scan over a span of rows a thread. The whole block calls it.
__device__ int run_heads(const uint64_t* k, int n, int* head, int* warp_sums) {
  const int c = (n + blockDim.x - 1) / blockDim.x;
  const int j0 = min(n, (int)threadIdx.x * c), j1 = min(n, j0 + c);
  int mine = 0;
  for (int j = j0; j < j1; ++j) mine += j == 0 || (k[j] >> 32) != (k[j - 1] >> 32);
  int runs;
  int at = koord_split::excl(mine, warp_sums, runs);
  for (int j = j0; j < j1; ++j)
    if (j == 0 || (k[j] >> 32) != (k[j - 1] >> 32)) head[at++] = j;
  if (threadIdx.x == 0) head[runs] = n;
  __syncthreads();
  return runs;
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
                     const koord_device::Refund dv, const GangLayout g,
                     char* __restrict__ scratch) {
  extern __shared__ uint64_t smem_u64[];
  __shared__ int warp_sums[32];
  // the working set (its layout from the host, gang_layout): shared
  // memory, or the device-memory scratch
  char* ws = scratch != nullptr ? scratch : (char*)smem_u64;
  const bool devs = dv.slots != nullptr, zones = zone_free != nullptr;
  const int L = chain != nullptr ? levels : 0;
  int* s_asg = (int*)(ws + g.asg);
  int* s_cnt = (int*)(ws + g.cnt);
  int* s_rows = (int*)(ws + g.rows);
  int* s_inv = (int*)(ws + g.inv);
  uint64_t* ka = (uint64_t*)(ws + g.ka);
  uint64_t* kb = (uint64_t*)(ws + g.kb);
  uint32_t* table = (uint32_t*)(ws + g.table);
  float* s_rq = (float*)(ws + g.rq);
  float* s_es = (float*)(ws + g.es);
  int* s_fl = (int*)(ws + g.fl);
  float* s_dv = (float*)(ws + g.dvv);
  int* s_pz = (int*)(ws + g.pz);
  float* s_zc = (float*)(ws + g.zc);
  int* s_seg = (int*)(ws + g.seg);
  int* s_qseg = (int*)(ws + g.qseg);
  const int tid = threadIdx.x, T = blockDim.x;

  // g1. Counts: placed members a gang (gid clipped to [0, P-1], as the
  // reference), integer adds in shared memory
  for (int i = tid; i < P; i += T) s_cnt[i] = 0;
  __syncthreads();
  for (int i = tid; i < P; i += T) {
    const int a = assignment[i];
    const int gi = gang_id[i];
    s_asg[i] = a;
    if (gi >= 0 && a >= 0) atomicAdd(&s_cnt[min(gi, P - 1)], 1);
  }
  __syncthreads();
  // g2. Decisions: a placed pod of a Strict gang below its minMember rolls
  // back, and keeps its node here; a batch where none does returns
  bool any = false;
  for (int i = tid; i < P; i += T) {
    const int a = s_asg[i];
    const int gi = gang_id[i];
    const int gid = min(max(gi, 0), P - 1);
    const bool gang_ok = s_cnt[gid] >= gang_min[gid] || gang_nonstrict[gid];
    const bool keep = a >= 0 && (gi < 0 || gang_ok);
    const bool back = a >= 0 && !keep;
    assignment[i] = keep ? a : -1;
    s_asg[i] = back ? min(max(a, 0), N - 1) : -1;
    any = any || back;
  }
  if (!__syncthreads_or(any)) return;

  // g3. The rolled-back rows in row order, by a block scan (a span of rows
  // a thread): each one's row, and its split row (node << 32 | rank)
  int R;
  {
    const int c = (P + T - 1) / T, j0 = min(P, tid * c), j1 = min(P, j0 + c);
    int mine = 0;
    for (int j = j0; j < j1; ++j) mine += s_asg[j] >= 0;
    int at = koord_split::excl(mine, warp_sums, R);
    for (int j = j0; j < j1; ++j) {
      const int node = s_asg[j];
      if (node < 0) continue;
      s_rows[at] = j;
      ka[at] = ((uint64_t)node << 32) | (uint64_t)at;
      ++at;
    }
    __syncthreads();
  }

  // g4. The node sort: the stable split on the node, (node, row) order
  uint64_t* by_node = koord_split::sort(ka, kb, R, 32, N - 1, table, warp_sums);
  uint64_t* other = by_node == ka ? kb : ka;

  // g5. Gather: each rolled-back row's values in (node, row) order; with
  // quotas each level's split row ((level, quota) << 32 | rank) in (level,
  // row) order; then the node segments' heads
  for (int s = tid; s < R; s += T) {
    const int rank = (int)(by_node[s] & kLow);
    const int row = s_rows[rank];
    s_inv[rank] = s;
    for (int d = 0; d < D; ++d) {
      s_rq[(size_t)s * D + d] = requests[(size_t)row * D + d];
      s_es[(size_t)s * D + d] = estimate[(size_t)row * D + d];
    }
    s_fl[s] = is_prod[row] ? 1 : 0;
    if (devs) {
      s_dv[(size_t)s * 3] = (float)dv.whole[row] * 100.0f + dv.share[row];
      s_dv[(size_t)s * 3 + 1] = (float)dv.rdma_req[row];
      s_dv[(size_t)s * 3 + 2] = (float)dv.fpga_req[row];
    }
    if (zones) {
      s_pz[s] = pod_zone[row];
      for (int d = 0; d < DN; ++d) s_zc[(size_t)s * DN + d] = zone_charge[(size_t)row * DN + d];
    }
    for (int l = 0; l < L; ++l) {
      const int q = chain[(size_t)row * levels + l];
      const long long key = (long long)l * (Q + 1) + (q >= 0 && q < Q ? q : Q);
      other[(size_t)l * R + rank] = ((uint64_t)key << 32) | (uint64_t)rank;
    }
  }
  __syncthreads();
  const int nseg = run_heads(by_node, R, s_seg, warp_sums);
  // the picks are cleared after the gather read them
  if (pod_zone != nullptr)
    for (int k = tid; k < R; k += T) pod_zone[s_rows[k]] = -1;

  // g6. Node refunds: a thread a chain, W of them a node segment: (table,
  // dim) sums subtracted, with devices the refund, RDMA and FPGA sums (the
  // refund water-filled), with zones a (zone, dim) fold of the rows that
  // hold the zone
  {
    const int W = 3 * D + (devs ? 3 : 0) + (zones ? Z * DN : 0);
    // chain c is chain w = c / nseg of segment c % nseg: the lanes of a
    // warp take one kind of chain (a table's, a device sum, a zone's) of
    // consecutive segments, so a water-fill or a zone fold runs in as few
    // warps as there are 32 segments
    for (int c = tid; c < nseg * W; c += T) {
      int w = c / nseg;
      const int k = c - w * nseg;
      const int s0 = s_seg[k], s1 = s_seg[k + 1];
      const int node = (int)(by_node[s0] >> 32);
      if (w < 3 * D) {
        const int t = w / D, d = w - t * D;
        float* tab = t == 0 ? requested : t == 1 ? est_used : prod_used;
        const float sum = chain_sum((t == 0 ? s_rq : s_es) + d, D, s_fl, t == 2, s0, s1);
        const size_t at = (size_t)node * D + d;
        tab[at] = tab[at] - sum;
        continue;
      }
      w -= 3 * D;
      if (devs && w < 3) {
        const float sum = chain_sum(s_dv + w, 3, s_fl, false, s0, s1);
        if (w == 0)
          koord_device::slot_refund_row(dv.slots + (size_t)node * dv.G, dv.G, sum,
                                        dv.cap != nullptr, dv.cap != nullptr ? dv.cap[node] : 0.0f);
        else if (w == 1 && dv.rdma != nullptr)
          dv.rdma[node] = dv.rdma[node] + sum;
        else if (w == 2 && dv.fpga != nullptr)
          dv.fpga[node] = dv.fpga[node] + sum;
        continue;
      }
      if (devs) w -= 3;
      // the zone fold: each rolled-back row that holds zone z (its pick
      // clipped to Z - 1, as the reference's one-hot clips it) adds its
      // charge, row by row; the others are selected away, not added
      const int z = w / DN, d = w - z * DN;
      float* cell = zone_free + ((size_t)node * Z + z) * DN + d;
      float acc = *cell;
      bool took = false;
      int s = s0;
      for (; s + kAhead <= s1; s += kAhead) {
        int pz[kAhead];
        float x[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          pz[u] = s_pz[s + u];
          x[u] = s_zc[(size_t)(s + u) * DN + d];
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const bool take = pz[u] >= 0 && min(pz[u], Z - 1) == z;
          acc = take ? acc + x[u] : acc;
          took = took || take;
        }
      }
      for (; s < s1; ++s) {
        const int pz = s_pz[s];
        const bool take = pz >= 0 && min(pz, Z - 1) == z;
        acc = take ? acc + s_zc[(size_t)s * DN + d] : acc;
        took = took || take;
      }
      if (took) *cell = acc;
    }
  }
  if (L == 0) return;

  // g7. Quota order: every level's rows split at once on (level, quota),
  // row order kept within each
  __syncthreads();  // the node refunds have read by_node
  const int E = L * R;
  uint64_t* by_quota = koord_split::sort(other, by_node, E, 32, (long long)L * (Q + 1) - 1, table,
                                         warp_sums);
  const int nq = run_heads(by_quota, E, s_qseg, warp_sums);
  // g8. Quota refunds, level by level: a thread a (quota, dim) chain, its
  // sum subtracted; the rows keyed Q (no quota at the level, or past the
  // table) dropped
  for (int l = 0; l < L; ++l) {
    for (int c = tid; c < nq * D; c += T) {
      const int k = c / D, d = c - k * D;
      const int e0 = s_qseg[k], e1 = s_qseg[k + 1];
      const long long key = (long long)(by_quota[e0] >> 32);
      const int lvl = (int)(key / (Q + 1)), q = (int)(key - (long long)lvl * (Q + 1));
      if (lvl != l || q >= Q) continue;
      const size_t at = (size_t)q * D + d;
      quota_used[at] = quota_used[at] - quota_sum(s_rq, s_inv, by_quota, D, d, e0, e1);
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
  // the split's keys: (level, quota) below 2^31, and every level's rows
  // counted in an int
  if (quota && (levels < 1 || (long long)levels * (Q + 1) >= (1ll << 31) ||
                (long long)levels * P >= (1ll << 31)))
    return (int)cudaErrorInvalidValue;
  const GangLayout g = gang_layout(P, D, quota ? levels : 0, dev_slots != nullptr,
                                   zone_free != nullptr ? DN : 0);
  // one block holds the whole batch, in shared memory or, where it does
  // not fit (koord_gangs_scratch), in the caller's scratch
  const size_t smem = scratch != nullptr ? 0 : g.total;
  if (scratch == nullptr && smem > (size_t)max_smem()) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024 - 256) {
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
      g, (char*)scratch);
  return (int)cudaGetLastError();
}

// The scratch a batch of P pods of D dims needs (with a quota refund over
// `levels` levels when `quota`, devices when `dev`, zones of DN dims when
// DN > 0): 0 while its working set fits in shared memory.
extern "C" int koord_gangs_scratch(int P, int D, int quota, int levels, int dev, int DN,
                                   long long* bytes) {
  if (P < 0 || D < 1) return (int)cudaErrorInvalidValue;
  const size_t need = gang_layout(P, D, quota ? levels : 0, dev != 0, DN).total;
  *bytes = need > (size_t)max_smem() ? (long long)need : 0;
  return (int)cudaSuccess;
}

extern "C" const char* koord_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
