// The round tail (round.cuh) for LoadAware rounds, with or without
// ElasticQuota, that fit in shared memory: up to 4,096 pods, and up to
// 16,384 at D <= 3 without quotas (round_route says which rounds; the
// others go to round_zone.cu and round_big.cu). The instantiations here
// are the main path's: the round without quotas keeps its registers. The
// device phase is a run-time branch of each (dev_slots null: none).

#include "round.cuh"

namespace {

template <int D, bool kQuota>
cudaError_t launch_rows(const Args& a) {
  const int R = smem_rows(a.P, D, kQuota, false);
  if (R == 1) return launch<D, 1, kQuota, false, false>(a, threads_of(a.P, 1));
  if (R == 4) return launch<D, 4, kQuota, false, false>(a, kThreads);
  if constexpr (D <= 3 && !kQuota) {
    if (R == kBigRows) return launch<D, kBigRows, kQuota, false, false>(a, kThreads);
  }
  return cudaErrorInvalidValue;
}

template <bool kQuota>
struct Launch {
  const Args& a;
  template <int D>
  cudaError_t run() const { return launch_rows<D, kQuota>(a); }
};

}  // namespace

extern "C" int koord_round_tail(
    const void* top_cost, const void* top_idx, const void* req,
    const void* est, const void* is_prod, const void* cpu_bind,
    const void* cpu_amp, const void* alloc, const void* fresh,
    const void* thr, const void* pthr, void* requested, void* est_used,
    void* prod_used, void* assigned, void* active, void* state,
    float round_quantum, int P, int N, int D, int K, const void* chain,
    const void* runtime, void* qused, void* gate, int Q, int L,
    void* dev_slots, void* dev_stats, void* rdma_free, void* fpga_free, const void* gpu_whole,
    const void* gpu_share, const void* rdma_req, const void* fpga_req, int G, void* stream) {
  if (P <= 0) return (int)cudaSuccess;
  const Args a = make_args(top_cost, top_idx, req, est, is_prod, cpu_bind, cpu_amp, alloc, fresh,
                           thr, pthr, requested, est_used, prod_used, assigned, active, state,
                           round_quantum, P, N, D, K, chain, runtime, qused, gate, Q, L,
                           make_zones(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0),
                           make_devices(dev_slots, dev_stats, rdma_free, fpga_free, gpu_whole,
                                        gpu_share, rdma_req, fpga_req, G),
                           nullptr, stream);
  cudaError_t err = check_args(a);
  if (err != cudaSuccess) return (int)err;
  // a level's sort key (quota << position bits | position) must fit 32 bits
  if (chain != nullptr && ((unsigned long long)Q + 1) << pos_bits(P) >= (1ull << 32))
    return (int)cudaErrorInvalidValue;
  return (int)(chain != nullptr ? with_d(D, Launch<true>{a}) : with_d(D, Launch<false>{a}));
}

extern "C" const char* koord_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
