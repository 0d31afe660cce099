"""The device sums at the edges of their domain: the port against the JAX
package on the CPU.

A round's device acceptance holds each node segment's running sums of the
whole GPUs asked (plus one for each share pod that opens a slot), the share
pods, RDMA and FPGA against the node's counts. The reference takes them as
float prefix sums (``koordinator_tpu/ops/solver.py:1246-1274``: a cumsum
over every sorted row of the round, less the cumsum before the segment);
the round tail's kernel sums integers, which is the same while the batch
is not wide (``csrc/device_prep.cu``), and takes the float walk itself
when it is. ``chip_smoke.device_domain_case`` gives the three cases where
the two could part: a negative whole, RDMA or FPGA ask inside a segment;
free RDMA and FPGA counts of 2^24 and more; a segment whose RDMA and FPGA
cumsums pass 2^24, ahead of every other node's rows. On
``chip_smoke.rich_fixture`` with ``device_tables``' devices over 16 nodes
(segments of dozens of rows a node), ``assign(devices=...)`` of both
packages must agree bit for bit; the kernel is held to the same plain
version on the card (``tests/test_torch_cuda.py``). Tolerance: none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from koordinator_tpu.ops import solver as J
from koordinator_tpu_torch.ops import commit as TC
from koordinator_tpu_torch.ops import device as TD
from koordinator_tpu_torch.ops import solver as T
from koordinator_tpu_torch.ops.convert import from_jax
from tools import make_torch_golden

torch.set_num_threads(1)
torch.use_deterministic_algorithms(True)

FIELDS = ("assignment", "node_requested", "node_estimated_used", "node_prod_used",
          "rounds_used", "node_dev_slots", "node_rdma_free", "node_fpga_free",
          "shortlist_fallbacks")


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def domain_fixture(case, seed=5, n=16, p=512):
    nodes, pods, params = chip_smoke.rich_fixture(seed, n, p, batch=p)
    pods, devices = chip_smoke.device_tables(seed, nodes, pods, batch=p)
    return (nodes, params) + chip_smoke.device_domain_case(case, pods, devices)


@pytest.mark.parametrize("scoring, k", [(None, None), ("LeastAllocated", 64),
                                        ("MostAllocated", None)])
@pytest.mark.parametrize("case", chip_smoke.DOMAIN_CASES)
def test_assign_at_the_device_sums_edges_matches_reference(case, scoring, k):
    nodes, params, pods, devices = domain_fixture(case)
    jp, jn = J.PodBatch.create(**pods), J.NodeState.create(**nodes)
    jpar = J.SolverParams(**{key: jnp.asarray(v) for key, v in params.items()})
    kw = dict(device_scoring=scoring, shortlist_k=k, max_rounds=12, approx_topk=True)
    want = J.assign(jp, jn, jpar, devices=make_torch_golden.jax_devices(devices), **kw)
    got = T.assign(from_jax(T.PodBatch, jp, device="cpu"), from_jax(T.NodeState, jn, device="cpu"),
                   from_jax(T.SolverParams, jpar, device="cpu"),
                   devices=TD.DeviceState.create(**devices, device="cpu"), **kw)
    for f in FIELDS:
        np.testing.assert_array_equal(bits(getattr(want, f)), bits(getattr(got, f).numpy()),
                                      err_msg=f)
    asg = got.assignment.numpy()
    gpu = (pods["gpu_whole"] != 0) | (pods["gpu_share"] > 0)
    assert (asg[gpu] >= 0).sum() > 16


def test_domain_cases_reach_the_edges():
    """Each case holds what it is named for, on pods placed by the round."""
    for case in chip_smoke.DOMAIN_CASES:
        _, _, pods, devices = domain_fixture(case)
        if case == "negative":
            assert min(pods[k].min() for k in ("gpu_whole", "rdma", "fpga")) < 0
            assert all((pods[k] < 0).any() for k in ("gpu_whole", "rdma", "fpga"))
        elif case == "free_2_24":
            assert devices["rdma_free"].max() >= 2 ** 24 and devices["fpga_free"].max() >= 2 ** 24
        else:
            assert pods["rdma"].astype(np.int64).sum() > 2 ** 24


@pytest.mark.parametrize("case", chip_smoke.DOMAIN_CASES)
def test_wide_flag_marks_the_batches_past_exact_integers(case):
    """``sums_wide_plain`` (``csrc/device_prep.cu``'s flag) raises the
    batch whose asks' absolute sums pass 2^24, and only that one; the
    boundary itself is not wide."""
    _, _, pods, _ = domain_fixture(case)
    asks = [torch.from_numpy(pods[k]) for k in ("gpu_whole", "rdma", "fpga")]
    assert int(TD.sums_wide_plain(*asks)[0]) == int(case == "sum_2_24")
    p = 16
    zeros = torch.zeros(p, dtype=torch.int32)
    edge = torch.zeros(p, dtype=torch.int32)
    edge[0] = TD.EXACT_INTS
    assert int(TD.sums_wide_plain(zeros, edge, zeros)[0]) == 0
    edge[1] = -1
    assert int(TD.sums_wide_plain(zeros, edge, zeros)[0]) == 1
    whole = torch.full((p,), TD.EXACT_INTS // p, dtype=torch.int32)
    assert int(TD.sums_wide_plain(whole, zeros, zeros)[0]) == 1


def test_wide_round_needs_the_float_walk():
    """In ``sum_2_24``'s crowded round the reference's float prefixes are
    not the exact integer sums: the round's acceptance taken with exact
    integers would place other pods than the plain round (the reference's
    float walk), which is why a wide batch's kernel walks floats."""
    args, terms, _, _ = chip_smoke.crowded_round_inputs(torch, torch.device("cpu"), 512,
                                                        domain="sum_2_24")
    assert int(terms.wide[0]) == 1
    host = [t.clone() for t in args]
    TC.round_tail_plain(*host, 0.35, dev=chip_smoke.device_terms_copy(terms))

    def exact(values, seg_starts):
        out, run = torch.empty_like(values, dtype=torch.float64), None
        for i in range(values.shape[0]):
            v = values[i].double()
            run = v if bool(seg_starts[i]) else run + v
            out[i] = run
        return out.float()

    exact_args = [t.clone() for t in args]
    accept = TC.device_accept_plain
    TC.device_accept_plain = lambda *a: _with_prefix(exact, accept, *a)
    try:
        TC.round_tail_plain(*exact_args, 0.35, dev=chip_smoke.device_terms_copy(terms))
    finally:
        TC.device_accept_plain = accept
    assert not torch.equal(host[14], exact_args[14])


def _with_prefix(prefix, fn, *args):
    keep = TC._segment_prefix_sums
    TC._segment_prefix_sums = prefix
    try:
        return fn(*args)
    finally:
        TC._segment_prefix_sums = keep
