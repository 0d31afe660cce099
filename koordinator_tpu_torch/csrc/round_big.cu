// The round tail (round.cuh) of the rounds shared memory cannot hold: up
// to 32,768 pods at any D <= 8, with or without ElasticQuota (any Q: the
// level keys are 64 bits), NUMA zones and devices, 32 rows a thread (the
// loops with a barrier over the rows present), the working set in a
// device-memory scratch buffer (kGlobal); the rounds above are
// round_huge.cu's. And the route: which of round.cu, round_zone.cu, this
// file and round_huge.cu takes a round.
//
// What bounds it on an H100: as the shared-memory round, a chain of
// dependent steps on one SM; its working set (a few MB at 32,768 pods)
// stays in L2, so each step's loads take L2's latency, not shared
// memory's.

#include "round.cuh"

// The route of a round of P pods at width D (quota: Q quotas, L levels;
// zone: DN zone dims; dev: with devices): *route 0 for the shared-memory
// kernels (round.cu, or round_zone.cu with zones), 1 for
// koord_round_tail_big and 2 for koord_round_tail_huge (round_huge.cu),
// each with *bytes of scratch, -1 for none.
extern "C" int koord_round_route(int P, int D, int quota, int Q, int L, int zone, int DN,
                                 int dev, int* route, long long* bytes) {
  if (P < 1 || D < 1 || D > kMaxDims) return (int)cudaErrorInvalidValue;
  size_t b = 0;
  *route = round_route(P, D, quota != 0, Q, L, zone != 0, DN, dev != 0, &b);
  *bytes = (long long)b;
  return (int)cudaSuccess;
}

// koord_round_tail_zone's arguments (zone_free null: no zones; dev_slots
// null: no devices), then the scratch buffer of koord_round_route's size.
extern "C" int koord_round_tail_big(
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
  return (int)launch_device_memory<kGlobalRows>(a);
}

extern "C" const char* koord_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
