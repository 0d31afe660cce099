// DeviceShare's per-node slot arithmetic, shared by the batch's stats table
// (device_prep.cu), the round tail's device phase (round.cuh) and the gang
// rollback's refund (gangs.cu).
//
// Port of koordinator_tpu/ops/device.py: slot_stats (:58-70), slot_commit
// (:164-207) and slot_refund (:209-241), each for one node's row of the
// [N, G] slot table (percent units, 100 = one whole free GPU). Every float
// operation is written in the reference's order and the sources are built
// with -fmad=false and IEEE division, so each gives the reference's bits:
// the total adds the slots in slot order up to 32 slots and in windows of
// 32 above (slot_total), and the refund's running headroom follows XLA's
// chunked cumsum (chunks of 16, the chunk totals added in order), the
// orders XLA's CPU backend gives the reference
// (tests/test_torch_device.py). G is a run-time size up to kMaxSlots; no
// per-slot array is kept: each pass reads the row again (it stays in L1).

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace koord_device {

constexpr float kFull = 100.0f;  // device.FULL
constexpr float kEps = 1e-3f;    // masks.EPS
constexpr int kMaxSlots = 256;   // chunked cumsum of at most 16 chunks
constexpr int kStats = 4;        // full count, best partial, largest, total
constexpr int kScanBase = 16;    // XLA's cumsum chunk
constexpr int kSumWindow = 32;   // XLA's tree reduction window

// jnp.sum of one row of G slots as XLA's CPU backend sums it: in order up
// to 32 slots; above, the row padded with zeros to a multiple of 32 (half
// the padding, rounded down, before it), each window summed in order,
// then the (at most 8) window sums in order. A padding zero is skipped:
// 0 + x is x, and no window is all padding.
__device__ __forceinline__ float slot_total(const float* s, int G) {
  if (G <= kSumWindow) {
    float total = s[0];
    for (int g = 1; g < G; ++g) total = total + s[g];
    return total;
  }
  const int windows = (G + kSumWindow - 1) / kSumWindow;
  const int lo = (windows * kSumWindow - G) / 2;
  float total = 0.0f;
  for (int w = 0; w < windows; ++w) {
    const int beg = max(w * kSumWindow - lo, 0), end = min((w + 1) * kSumWindow - lo, G);
    float sum = s[beg];
    for (int g = beg + 1; g < end; ++g) sum = sum + s[g];
    total = w == 0 ? sum : total + sum;
  }
  return total;
}

__device__ __forceinline__ bool is_full(float v) { return v >= kFull - kEps; }

// slot_stats of one row: the fully free slots (as a float count), the
// largest partly free slot (0 where none), the largest slot and the total
// (slot_total).
__device__ __forceinline__ void slot_stats_row(const float* s, int G, float* out) {
  int full = 0;
  float partial = 0.0f, smax = 0.0f;
  for (int g = 0; g < G; ++g) {
    const float v = s[g];
    const bool f = is_full(v);
    full += f ? 1 : 0;
    const float pv = f ? 0.0f : v;
    partial = g == 0 ? pv : fmaxf(partial, pv);
    smax = g == 0 ? v : fmaxf(smax, v);
  }
  out[0] = (float)full;
  out[1] = partial;
  out[2] = smax;
  out[3] = slot_total(s, G);
}

// slot_commit of one row: `w` whole slots taken (the fully free slots of
// rank < w, by index, zeroed); the node's one share winner `frac` opens the
// full slot of rank w (`opens`) or bites the tightest partly free slot
// that holds it, the first on ties (argmin of the candidates).
__device__ __forceinline__ void slot_commit_row(float* s, int G, float w, float frac,
                                                bool opens) {
  // the best-fit target, from the row as it was
  int tgt = 0;
  float best = CUDART_INF_F;
  for (int g = 0; g < G; ++g) {
    const float v = s[g];
    const float pf = is_full(v) ? CUDART_INF_F : v;
    const float cand = pf >= frac - kEps ? pf : CUDART_INF_F;
    if (cand < best) {
      best = cand;
      tgt = g;
    }
  }
  const bool take_partial = frac > kEps && !opens && best < CUDART_INF_F;
  int rank = -1;
  for (int g = 0; g < G; ++g) {
    const float v = s[g];
    const bool f = is_full(v);
    rank += f ? 1 : 0;
    const float rf = (float)rank;
    float out = f && rf < w - 0.5f ? 0.0f : v;
    if (f && fabsf(rf - w) < 0.5f && opens) out = kFull - frac;
    s[g] = out - (take_partial && g == tgt ? frac : 0.0f);
  }
}

// slot_refund of one row: `refund` percent water-filled back, the emptiest
// slot first (a stable sort: equal slots by index), each up to its
// headroom FULL - s, a padding slot (index >= cap / 100 when `has_cap`)
// none. The running headroom follows XLA's chunked cumsum. The sorted
// order is walked without an array: each step takes the least (value,
// index) among the slots not yet filled, whose values are still the row's
// own; `done` marks the filled ones.
__device__ __forceinline__ void slot_refund_row(float* s, int G, float refund, bool has_cap,
                                                float cap) {
  uint64_t done[kMaxSlots / 64] = {0, 0, 0, 0};
  float inner = 0.0f, chunks = 0.0f;  // the open chunk's sum; the closed chunks'
  for (int k = 0; k < G; ++k) {
    int at = -1;
    float v = 0.0f;
    for (int g = 0; g < G; ++g) {
      if ((done[g >> 6] >> (g & 63)) & 1ull) continue;
      const float x = s[g];
      if (at < 0 || x < v) {
        at = g;
        v = x;
      }
    }
    done[at >> 6] |= 1ull << (at & 63);
    const bool exists = !has_cap || (float)at < cap / 100.0f;
    const float head = exists ? kFull - v : 0.0f;
    // the cumsum at sorted position k
    const int c = k / kScanBase;
    if (k % kScanBase == 0 && c > 0) chunks = c == 1 ? inner : chunks + inner;
    inner = k % kScanBase == 0 ? head : inner + head;
    const float cum = c > 0 ? inner + chunks : inner;
    const float fill = fminf(fmaxf(refund - (cum - head), 0.0f), head);
    s[at] = v + fill;
  }
}

// The device tables and the pods' demand the gang rollback refunds
// (gangs.cu): the slot table [N, G] (nullptr: no devices), cap_total [N]
// (nullptr: every slot real), the free RDMA and FPGA counts [N] (nullptr:
// not tracked) and the pods' whole GPUs, share, RDMA and FPGA [P] in pod
// order.
struct Refund {
  float* slots;
  const float* cap;
  float *rdma, *fpga;
  const int* whole;
  const float* share;
  const int *rdma_req, *fpga_req;
  int G;
};

}  // namespace koord_device
