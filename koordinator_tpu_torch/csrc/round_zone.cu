// The round tail (round.cuh) with NUMA zones and without devices, in
// shared memory: the zone instantiations (kZone) of the rounds up to 4,096
// pods, with and without ElasticQuota. Larger rounds, and rounds whose
// working set does not fit, go to round_big.cu (round_route); with devices
// the same rounds take round_zone_dev.cu.

#include "round.cuh"

// koord_round_tail's arguments, then the zones: the carried table
// [N, Z, DN] float32 (charged in place), the capacities, the nodes' side
// table [N, 1 + DN + Z] int32 (zone_prep.cu), the MostAllocated flags [N]
// bool, the sorted pods' required flags [P] bool and zone picks [P] int32
// (written for each winner); then the devices as koord_round_tail takes
// them.
extern "C" int koord_round_tail_zone(
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
    int G, void* stream) {
  if (P <= 0) return (int)cudaSuccess;
  const Args a = make_args(top_cost, top_idx, req, est, is_prod, cpu_bind, cpu_amp, alloc, fresh,
                           thr, pthr, requested, est_used, prod_used, assigned, active, state,
                           round_quantum, P, N, D, K, chain, runtime, qused, gate, Q, L,
                           make_zones(zone_free, zone_cap, side, most, required, pod_zone, Z,
                                      DN),
                           make_devices(dev_slots, dev_stats, rdma_free, fpga_free, gpu_whole,
                                        gpu_share, rdma_req, fpga_req, dev_wide, G),
                           nullptr, stream);
  return (int)launch_shared_memory<true, false>(a);
}

extern "C" const char* koord_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
