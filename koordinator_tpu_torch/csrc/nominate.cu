// Round nomination without the NUMA and device terms: nominate.cuh's
// kernel, LoadAware alone or with a node mask, every D in 1..16. The
// design and what bounds it are nominate.cuh's; the term instantiations
// are nominate_terms.cu's.

#include "nominate.cuh"

namespace {

struct LoadAwareFamily {
  static bool accepts(int mode, int, int, int) { return mode == kPlainMode || mode == kMaskedMode; }

  template <int D, int C>
  static auto kernel(int mode, int, int) {
    return mode == kMaskedMode ? nominate_kernel<D, C, true> : nominate_kernel<D, C, false>;
  }
};

}  // namespace

// koord_nominate_chunk: nodes each block walks for P pods and N nodes at
// width D and fan-out K on a card of `sms` SMs (mode: 0 LoadAware only, 1
// with a node mask, 2 with NUMA zones, 3 with devices, 4 with devices and
// NUMA zones; Z and DN the zone table's shape, 0 without zones).
// koord_nominate: one call (`order`: the term kernels' pod order, [P]
// int32 or null). The caller makes room for partial lists of
// [P, ceil(N / chunk), kMaxK] pairs when there is more than one chunk.
extern "C" int koord_nominate_chunk(int P, int N, int D, int K, int sms, int mode, int Z,
                                    int DN, int* chunk) {
  return nominate_chunk<LoadAwareFamily>(P, N, D, K, sms, mode, Z, DN, chunk);
}

extern "C" int koord_nominate(
    const void* req, const void* est, const void* is_prod, const void* cpu_bind,
    const void* gate, const void* alloc, const void* requested, const void* est_used,
    const void* prod_used, const void* fresh, const void* sched, const void* cpu_amp,
    const void* thr, const void* pthr, const void* weights, int P, int N, int D, int K,
    int chunk, float jitter_scale, int jitter_on, int approx, void* part_cost,
    void* part_idx, void* out_cost, void* out_idx, const void* state,
    const void* trigger, const void* mask, const void* mask_row, const void* zone_free,
    const void* zone_cap, const void* side, const void* required, int Z, int DN,
    int scoring, const void* dev_stats, const void* rdma_free, const void* fpga_free,
    const void* cap_total, const void* gpu_whole, const void* gpu_share,
    const void* rdma_req, const void* fpga_req, const void* units, int dev_scoring,
    int dev_clamp, const void* order, void* stream) {
  return nominate_entry<LoadAwareFamily>(
      req, est, is_prod, cpu_bind, gate, alloc, requested, est_used, prod_used, fresh, sched,
      cpu_amp, thr, pthr, weights, P, N, D, K, chunk, jitter_scale, jitter_on, approx,
      part_cost, part_idx, out_cost, out_idx, state, trigger, mask, mask_row, zone_free,
      zone_cap, side, required, Z, DN, scoring, dev_stats, rdma_free, fpga_free, cap_total,
      gpu_whole, gpu_share, rdma_req, fpga_req, units, dev_scoring, dev_clamp, order, stream);
}

extern "C" const char* koord_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
