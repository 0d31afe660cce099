"""DeviceShare through the solver: the port against the JAX package on the
CPU.

The same numpy inputs (``chip_smoke.rich_fixture`` with
``chip_smoke.device_tables``' slot tables, RDMA and FPGA counts and device
requests, 2-member gangs that roll back) go through ``assign(devices=...)``
under each device scoring, with and without the candidate shortlist, with
and without quotas, node masks and NUMA zones; ``shortlist_plan``;
``enforce_gangs`` refunding a rolled-back gang's devices; and
``solve_stream_full(devices=...)`` across chunks (the dev carry), in
``koordinator_tpu.ops.solver`` and ``koordinator_tpu_torch.ops.solver``.
MostAllocated turns the shortlist off, as the reference's gate does. The
committed device golden (``tests/data/torch_golden_device.npz``) holds the
reference's streams, and the port must reproduce its small part.
Tolerance: none — assignments, rounds, fallback counts and every table
are bitwise equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from koordinator_tpu.ops import device as JD
from koordinator_tpu.ops import numa as JN
from koordinator_tpu.ops import solver as J
from koordinator_tpu_torch.ops import device as TD
from koordinator_tpu_torch.ops import numa as TN
from koordinator_tpu_torch.ops import solver as T
from koordinator_tpu_torch.ops.convert import from_jax, from_numpy
from tools import make_torch_golden

torch.set_num_threads(1)
torch.use_deterministic_algorithms(True)

RESULT_FIELDS = ("assignment", "node_requested", "node_estimated_used", "node_prod_used",
                 "quota_used", "rounds_used", "node_dev_slots", "node_rdma_free",
                 "node_fpga_free", "node_zone_free", "pod_zone", "shortlist_fallbacks")
SCORINGS = [None, "LeastAllocated", "MostAllocated"]


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_bits_equal(want, got, what=""):
    np.testing.assert_array_equal(bits(want), bits(got), err_msg=what)


def device_case(seed, n=160, p=128, batch=None, rdma=True, quota=False, mask=False,
                zones=False, fleet=False):
    """A rich fixture with device tables (with ``fleet``, the device
    streams' recipe ``chip_smoke.gpu_fleet``; and, as asked, a quota tree
    with chains, a node mask and NUMA zones); pods stacked [C, batch] when
    ``batch`` is given. Returns the JAX and port inputs as dicts of
    (pods, nodes, params, devices, quotas, numa, node_mask)."""
    nodes, pods, params = chip_smoke.rich_fixture(seed, n, p, batch=batch or p)
    if fleet:
        pods, devices = chip_smoke.gpu_fleet(nodes, pods, batch=batch or p, rdma=rdma)
    else:
        pods, devices = chip_smoke.device_tables(seed, nodes, pods, rdma=rdma,
                                                 batch=batch or p)
    jax_in = {}
    node_mask = None
    if quota:
        runtime, used = chip_smoke.quota_tree(2, 2, pods["requests"])
        chain, constrained, zone = chip_smoke.quota_draws(2, 2, p)
        pods["quota_chain"] = chain
        jax_in["quotas"] = J.QuotaState(runtime=jnp.asarray(runtime), used=jnp.asarray(used))
    if mask:
        _, constrained, zone = chip_smoke.quota_draws(2, 2, p)
        node_mask = chip_smoke.node_mask_np(constrained, zone, n)
        if batch is not None:
            node_mask = node_mask.reshape(-1, batch, n)
        jax_in["node_mask"] = jnp.asarray(node_mask)
    if zones:
        nodes, numa, required = chip_smoke.zone_tables(seed, nodes, p)
        pods["numa_required"] = required
        jax_in["numa"] = JN.NumaState(**{k: jnp.asarray(v) for k, v in numa.items()})
    jp = J.PodBatch.create(**pods)
    if batch is not None:
        jp = jax.tree.map(lambda a: a.reshape((-1, batch) + a.shape[1:]), jp)
    jax_in.update(devices=make_torch_golden.jax_devices(devices))
    jn = J.NodeState.create(**nodes)
    jpar = J.SolverParams(**{k: jnp.asarray(v) for k, v in params.items()})
    port = dict(devices=TD.DeviceState.create(**devices, device="cpu"))
    if quota:
        port["quotas"] = from_jax(T.QuotaState, jax_in["quotas"], device="cpu")
    if mask:
        port["node_mask"] = torch.from_numpy(node_mask)
    if zones:
        port["numa"] = from_jax(TN.NumaState, jax_in["numa"], device="cpu")
    return ((jp, jn, jpar, jax_in),
            (from_jax(T.PodBatch, jp, device="cpu"), from_jax(T.NodeState, jn, device="cpu"),
             from_jax(T.SolverParams, jpar, device="cpu"), port))


def assert_results_equal(want, got):
    for f in RESULT_FIELDS:
        assert_bits_equal(getattr(want, f), getattr(got, f).numpy(), f)


@pytest.mark.parametrize("scoring", SCORINGS)
@pytest.mark.parametrize("k", [None, 64])
def test_assign_with_devices_matches_reference(scoring, k):
    (jp, jn, jpar, jin), (tp, tn, tpar, tin) = device_case(1)
    kw = dict(device_scoring=scoring, shortlist_k=k, max_rounds=12, approx_topk=True)
    want = J.assign(jp, jn, jpar, **jin, **kw)
    got = T.assign(tp, tn, tpar, **tin, **kw)
    assert_results_equal(want, got)
    slots = got.node_dev_slots.numpy()
    assert (slots != np.asarray(jin["devices"].slot_free)).sum() > 10
    gpu = (tp.gpu_whole.numpy() > 0) | (tp.gpu_share.numpy() > 0)
    assert (got.assignment.numpy()[gpu] >= 0).sum() > 10


@pytest.mark.parametrize("scoring", SCORINGS)
@pytest.mark.parametrize("k, rdma", [(None, True), (8, True), (None, False)])
def test_assign_with_devices_on_a_crowded_fleet_matches_reference(scoring, k, rdma):
    """512 pods over 16 nodes of the device streams' fleet
    (``chip_smoke.gpu_fleet``: 8 GPUs a node, two-member gangs of whole
    GPUs, shares of 50 and 30, RDMA on every other node, FPGA on every
    tenth): each round's segments run to dozens of rows a node, so the
    device acceptance refuses share pods after a segment's first and runs
    out of GPUs and RDMA partway, round after round — the semantics the
    round tail's segmented scans keep. Assignments, slot table, RDMA and
    FPGA bitwise equal to the reference's."""
    (jp, jn, jpar, jin), (tp, tn, tpar, tin) = device_case(5, n=16, p=512, rdma=rdma,
                                                           fleet=True)
    kw = dict(device_scoring=scoring, shortlist_k=k, max_rounds=12, approx_topk=True)
    want = J.assign(jp, jn, jpar, **jin, **kw)
    got = T.assign(tp, tn, tpar, **tin, **kw)
    assert_results_equal(want, got)
    gpu = (tp.gpu_whole.numpy() > 0) | (tp.gpu_share.numpy() > 0)
    placed = got.assignment.numpy() >= 0
    assert (placed & gpu).sum() > 16 and (~placed & gpu).sum() > 16
    assert int(got.rounds_used) > 2


@pytest.mark.parametrize("quota, mask, zones, scoring, k", [
    (True, False, False, "LeastAllocated", 64), (False, True, False, "MostAllocated", None),
    (False, False, True, "LeastAllocated", 64), (True, True, True, "MostAllocated", None)])
def test_assign_with_devices_quotas_masks_zones(quota, mask, zones, scoring, k):
    (jp, jn, jpar, jin), (tp, tn, tpar, tin) = device_case(2, quota=quota, mask=mask,
                                                           zones=zones)
    kw = dict(device_scoring=scoring, numa_scoring="LeastAllocated" if zones else None,
              shortlist_k=k, max_rounds=12, approx_topk=True)
    assert_results_equal(J.assign(jp, jn, jpar, **jin, **kw), T.assign(tp, tn, tpar, **tin, **kw))


def test_assign_dev_carry_matches_reference():
    """A carried dev table (a chunk's) replaces the state's: slots halved,
    one RDMA NIC fewer."""
    (jp, jn, jpar, jin), (tp, tn, tpar, tin) = device_case(3)
    dev = jin["devices"]
    carry = (np.asarray(dev.slot_free) * np.float32(0.5),
             np.maximum(np.asarray(dev.rdma_free) - 1, 0).astype(np.float32),
             np.asarray(dev.fpga_free))
    want = J.assign(jp, jn, jpar, devices=dev, dev_carry=tuple(jnp.asarray(c) for c in carry),
                    device_scoring="LeastAllocated")
    got = T.assign(tp, tn, tpar, devices=tin["devices"],
                   dev_carry=tuple(torch.from_numpy(c.copy()) for c in carry),
                   device_scoring="LeastAllocated")
    assert_results_equal(want, got)


@pytest.mark.parametrize("scoring", SCORINGS)
def test_shortlist_plan_with_devices_matches_reference(scoring):
    (jp, jn, jpar, jin), (tp, tn, tpar, tin) = device_case(4)
    want = J.shortlist_plan(jp, jn, jpar, devices=jin["devices"], device_scoring=scoring,
                            shortlist_k=16)
    got = T.shortlist_plan(tp, tn, tpar, devices=tin["devices"], device_scoring=scoring,
                           shortlist_k=16)
    assert_bits_equal(want[0], got[0].numpy(), "plan_cand")
    assert_bits_equal(want[1], got[1].numpy(), "plan_bound")


def test_most_allocated_turns_the_shortlist_off():
    """The reference's gate: with MostAllocated device scoring the solve is
    the full-axis one (no fallback counted), with or without devices."""
    (jp, jn, jpar, jin), (tp, tn, tpar, tin) = device_case(5)
    kw = dict(device_scoring="MostAllocated", max_rounds=12)
    on = T.assign(tp, tn, tpar, **tin, shortlist_k=8, **kw)
    off = T.assign(tp, tn, tpar, **tin, **kw)
    assert_results_equal(off, on)
    assert on.shortlist_fallbacks.tolist() == [0, 0]
    assert not T._shortlist_on(8, 4, 160, "MostAllocated")
    assert T._shortlist_on(8, 4, 160, "LeastAllocated")
    plain = T.assign(tp, tn, tpar, shortlist_k=8, device_scoring="MostAllocated")
    assert_bits_equal(J.assign(jp, jn, jpar, shortlist_k=8, device_scoring="MostAllocated")
                      .shortlist_fallbacks, plain.shortlist_fallbacks.numpy())


def test_enforce_gangs_refunds_devices_of_a_rolled_back_gang():
    """A Strict gang that falls short gives its members' GPUs (water-filled
    onto the real slots), RDMA and FPGA back."""
    (jp, jn, jpar, jin), (tp, tn, tpar, tin) = device_case(6)
    free = jp.replace(gang_id=jnp.full_like(jp.gang_id, -1))
    res = J.assign(free, jn, jpar, devices=jin["devices"])
    placed = np.asarray(res.assignment) >= 0
    gpu = (np.asarray(jp.gpu_whole) > 0) | (np.asarray(jp.gpu_share) > 0)
    pick = placed & gpu & (np.arange(placed.shape[0]) % 2 == 0)
    gang_min = np.asarray(jp.gang_min).copy()
    gang_min[0] = placed.shape[0] + 1
    gang_ns = np.asarray(jp.gang_nonstrict).copy()
    gang_ns[0] = False
    gangs = jp.replace(gang_id=jnp.asarray(np.where(pick, 0, -1).astype(np.int32)),
                       gang_min=jnp.asarray(gang_min), gang_nonstrict=jnp.asarray(gang_ns))
    cap = jin["devices"].cap_total
    exists = jnp.arange(res.node_dev_slots.shape[1])[None, :] < (cap / 100.0)[:, None]
    want = J.enforce_gangs(res, gangs, exists)
    got = T.enforce_gangs(from_jax(T.SolveResult, res, device="cpu"),
                          from_jax(T.PodBatch, gangs, device="cpu"),
                          TD.slot_exists_of(tin["devices"].cap_total, exists.shape[1]))
    for f in ("assignment", "node_requested", "node_dev_slots", "node_rdma_free",
              "node_fpga_free"):
        assert_bits_equal(getattr(want, f), getattr(got, f).numpy(), f)
    assert pick.sum() >= 5
    assert not np.array_equal(got.node_dev_slots.numpy(), np.asarray(res.node_dev_slots))


@pytest.mark.parametrize("scoring, k", [(None, 64), ("LeastAllocated", None),
                                        ("MostAllocated", 64)])
def test_solve_stream_full_with_devices_matches_reference(scoring, k):
    """The dev carry across chunks (the twin of the scheduler's
    ``test_chunked_device_carry_is_exact``): each chunk prices from the
    slot table, RDMA and FPGA the earlier ones charged."""
    (jp, jn, jpar, jin), (tp, tn, tpar, tin) = device_case(7, n=160, p=256, batch=64)
    kw = dict(device_scoring=scoring, shortlist_k=k, max_rounds=12, approx_topk=True)
    want = J.solve_stream_full(jp, jn, jpar, **jin, **kw)
    dev = tin["devices"]
    outs = (torch.empty_like(dev.slot_free), torch.empty_like(dev.rdma_free),
            torch.empty_like(dev.fpga_free))
    got = T.solve_stream_full(tp, tn, tpar, **tin, dev_out=outs, **kw)
    for name, w, g in zip(("assignments", "pod_zones", "rounds", "fallbacks"), want, got):
        assert_bits_equal(w, g.numpy(), name)
    ref = make_torch_golden.device_stream_full(jp, jn, jpar, jin["devices"], scoring, k)
    for name, w, g in zip(("slot_free", "rdma_free", "fpga_free"), ref[4:], outs):
        assert_bits_equal(w, g.numpy(), name)
    assert (got[0].numpy()[1:] >= 0).sum() > 0


def test_solve_stream_full_with_devices_quotas_masks_zones():
    (jp, jn, jpar, jin), (tp, tn, tpar, tin) = device_case(8, n=160, p=256, batch=64,
                                                           quota=True, mask=True, zones=True)
    kw = dict(device_scoring="LeastAllocated", numa_scoring="LeastAllocated", shortlist_k=64,
              max_rounds=12, approx_topk=True)
    want = J.solve_stream_full(jp, jn, jpar, **jin, **kw)
    got = T.solve_stream_full(tp, tn, tpar, **tin, **kw)
    for name, w, g in zip(("assignments", "pod_zones", "rounds", "fallbacks"), want, got):
        assert_bits_equal(w, g.numpy(), name)


def test_chunked_device_carry_is_exact():
    """Port twin of ``tests/test_device_slots.py::test_chunked_device_carry_is_exact``:
    eight 1-GPU pods in chunks of four on four 2-GPU nodes all place, and
    the carried slot table ends empty."""
    n, p = 4, 8
    pods = from_numpy(T.PodBatch, device="cpu", requests=np.full((p, 2), 1000.0, np.float32),
                      priority=np.full(p, 9000, np.int32), gpu_whole=np.ones(p, np.int32))
    nodes = from_numpy(T.NodeState, device="cpu",
                       allocatable=np.full((n, 2), 256_000.0, np.float32))
    params = T.SolverParams.create(np.zeros(2), np.zeros(2), np.ones(2), device="cpu")
    devices = TD.DeviceState.create(np.full((n, 2), 100.0, np.float32),
                                    cap_total=np.full(n, 200.0), device="cpu")
    slots = torch.empty_like(devices.slot_free)
    asg, _, _, _ = T.solve_stream_full(T.tree_map(lambda a: a.reshape((2, 4) + a.shape[1:]),
                                                  pods),
                                       nodes, params, devices=devices, dev_out=(slots,))
    assert (asg >= 0).all()
    assert slots.sum().item() == 0.0


def test_rdma_request_unschedulable_on_gpu_only_cluster():
    """Port twin of ``tests/test_device_slots.py::test_rdma_request_unschedulable_on_gpu_only_cluster``:
    with RDMA not tracked, a pod asking for it stays unassigned (and, as
    in the reference, an untracked FPGA request too)."""
    pods = from_numpy(T.PodBatch, device="cpu", requests=np.full((3, 2), 1000.0, np.float32),
                      priority=np.full(3, 9000, np.int32), rdma=np.asarray([1, 0, 0]),
                      fpga=np.asarray([0, 0, 1]))
    nodes = from_numpy(T.NodeState, device="cpu",
                       allocatable=np.full((2, 2), 256_000.0, np.float32))
    params = T.SolverParams.create(np.zeros(2), np.zeros(2), np.ones(2), device="cpu")
    devices = TD.DeviceState.create(np.full((2, 2), 100.0, np.float32), device="cpu")
    res = T.assign(pods, nodes, params, devices=devices)
    assert res.assignment.tolist()[0] == -1 and res.assignment.tolist()[2] == -1
    assert res.assignment.tolist()[1] >= 0
    assert res.node_rdma_free.tolist() == [0.0, 0.0]


# -------------------------------------------------------------- the golden

SMALL_KEYS = [chip_smoke.device_key(s, k) for s, k in make_torch_golden.DEVICE_SMALL_CELLS]


def test_device_golden_file_holds_the_reference():
    """The committed device golden's small part is what the JAX package
    gives now, for one cell (the full-size digests are checked on the
    card; the other cells by the plain path below and the card)."""
    gold = np.load(chip_smoke.GOLDEN_DEVICE)
    small = make_torch_golden.device_fixture_small()
    assert str(gold["fixture_sha256"]) == chip_smoke.fixture_digest(
        small[0], small[1], small[3], {k: v for k, v in small[2].items() if v is not None})
    full = make_torch_golden.device_fixture_full()
    assert str(gold["full_fixture_sha256"]) == chip_smoke.fixture_digest(
        full[0], full[1], full[3], {k: v for k, v in full[2].items() if v is not None})
    fresh = make_torch_golden.device_streams(*small, chip_smoke.BATCH,
                                             (("LeastAllocated", chip_smoke.SHORTLIST_K),))
    key = chip_smoke.device_key("LeastAllocated", chip_smoke.SHORTLIST_K)
    for i, f in enumerate(chip_smoke.DEVICE_OUTPUTS):
        if f != "pod_zones":
            assert_bits_equal(fresh[key][i], gold[f"{key}_{f}"], f"{key}_{f}")


@pytest.mark.parametrize("key", SMALL_KEYS + ["nordma_none_k64"])
def test_device_golden_small_streams_on_the_plain_path(key):
    """The port's plain path reproduces the golden's small streams:
    assignments, rounds, fallback counts and the final slot table, RDMA
    and FPGA counts."""
    gold = np.load(chip_smoke.GOLDEN_DEVICE)
    tracked = not key.startswith("nordma_")
    nodes, pods, devices, params = make_torch_golden.device_fixture_small(rdma=tracked)
    cell = key.removeprefix("nordma_")
    scoring, k = next((s, k) for s, k in make_torch_golden.DEVICE_SMALL_CELLS
                      if chip_smoke.device_key(s, k) == cell)
    tdev = TD.DeviceState.create(**devices, device="cpu")
    n = tdev.slot_free.shape[0]
    outs = (torch.empty_like(tdev.slot_free), torch.empty(n), torch.empty(n))
    got = T.solve_stream_full(
        from_numpy(T.PodBatch, device="cpu", **chip_smoke.stacked(pods)),
        from_numpy(T.NodeState, device="cpu", **nodes),
        from_numpy(T.SolverParams, device="cpu", **params), devices=tdev,
        device_scoring=scoring, shortlist_k=k, dev_out=outs, **chip_smoke.SOLVE,
    )
    for name, g in zip(("assignments", "pod_zones", "rounds", "fallbacks"), got):
        if name != "pod_zones":
            assert_bits_equal(gold[f"{key}_{name}"], g.numpy(), name)
    for name, g in zip(("slot_free", "rdma_free", "fpga_free"), outs):
        assert_bits_equal(gold[f"{key}_{name}"], g.numpy(), name)
    assert JD.FULL == TD.FULL
