// The round tail (round.cuh) of the rounds above 32,768 pods, up to
// 131,072 at any D <= 8, with or without ElasticQuota, NUMA zones and
// devices: round_big.cu's kernel at 128 rows a thread (kHugeRows; the
// loops with a barrier over the rows present), the working set in a
// device-memory scratch buffer. The JAX scheduler makes a gang larger
// than its batch bucket a chunk of its own, padded to a power of two
// (koordinator_tpu/scheduler/batch_solver.py:3319-3347,
// core/snapshot.py:38-42), so a gang of 32,769 members is a round of
// 65,536 pods. A file of its own, so that its instantiations build beside
// round_big.cu's, and a round of up to 32,768 pods keeps its 32 rows a
// thread and its local memory.
//
// What bounds it on an H100: as round_big.cu, a chain of dependent steps
// on one SM over a working set of a few tens of MB, which L2 half holds.

#include "round.cuh"

// koord_round_tail_big's arguments, for a round of 32,769 to 131,072 pods
// (koord_round_route's route 2, with its bytes of scratch).
extern "C" int koord_round_tail_huge(
    const void* top_cost, const void* top_idx, const void* req,
    const void* est, const void* is_prod, const void* cpu_bind,
    const void* cpu_amp, const void* alloc, const void* fresh,
    const void* thr, const void* pthr, void* requested, void* est_used,
    void* prod_used, void* assigned, void* active, void* state,
    float round_quantum, int P, int N, int D, int K, const void* chain,
    const void* runtime, void* qused, void* gate, int Q, int L, void* zone_free,
    const void* zone_cap, const void* side, const void* most, const void* required,
    void* pod_zone, int Z, int DN,
    void* dev_slots, void* dev_stats, void* rdma_free, void* fpga_free, const void* gpu_whole,
    const void* gpu_share, const void* rdma_req, const void* fpga_req, const void* dev_wide,
    int G, void* scratch, void* stream) {
  if (P <= 0) return (int)cudaSuccess;
  const Args a = make_args(top_cost, top_idx, req, est, is_prod, cpu_bind, cpu_amp, alloc, fresh,
                           thr, pthr, requested, est_used, prod_used, assigned, active, state,
                           round_quantum, P, N, D, K, chain, runtime, qused, gate, Q, L,
                           make_zones(zone_free, zone_cap, side, most, required, pod_zone, Z,
                                      DN),
                           make_devices(dev_slots, dev_stats, rdma_free, fpga_free, gpu_whole,
                                        gpu_share, rdma_req, fpga_req, dev_wide, G),
                           scratch, stream);
  return (int)launch_device_memory<kHugeRows>(a);
}

extern "C" const char* koord_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
