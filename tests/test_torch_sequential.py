"""The port's exact sequential-commit solver against the JAX package on the CPU.

Same inputs into ``koordinator_tpu.ops.solver.assign_sequential`` and
``koordinator_tpu_torch.ops.solver.assign_sequential`` (whose CPU route is
``assign_sequential_plain``: the build and scan twins of
``csrc/shortlist_build.cu`` and ``csrc/sequential.cu``, then
``enforce_gangs_plain``). The assignment, the three node tables,
``quota_used``, ``shortlist_fallbacks`` and ``rounds_used`` must be
bitwise equal (tolerance: none — every pair is priced and every row
committed with the reference's float operations in its order). The cases
twin the reference's own: ``tests/test_solver.py``'s ``run_both``
fixtures, ``tests/test_shortlist.py``'s ``seq_fixture`` at seeds 0-3 with
K = 4 and 16, its contended K = 2 case (fallbacks on both) and K >= N, the
three ``tests/test_elasticquota.py`` admission cases,
``tests/test_amplification.py``'s cpuset case, and
``chip_smoke.rich_fixture`` at 512 pods (stale metrics, unschedulable
nodes, custom thresholds, invalid pods, gangs that roll back, zero
requests) without quotas and with each quota tree, against the JAX
package and the committed ``tests/data/torch_golden_sequential.npz``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import test_amplification as amp_cases
import test_elasticquota as quota_cases
import test_shortlist as shortlist_cases
import test_solver as solver_cases
from koordinator_tpu.ops import solver as J
from koordinator_tpu_torch.ops import sequential as TQ
from koordinator_tpu_torch.ops import solver as T
from koordinator_tpu_torch.ops.convert import from_jax, from_numpy
from tools import make_torch_golden

torch.set_num_threads(1)
torch.use_deterministic_algorithms(True)

FIELDS = chip_smoke.SEQ_OUTPUTS + ("rounds_used",)


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def port(pods, nodes, params, quotas=None):
    return (from_jax(T.PodBatch, pods, device="cpu"), from_jax(T.NodeState, nodes, device="cpu"),
            from_jax(T.SolverParams, params, device="cpu"),
            None if quotas is None else from_jax(T.QuotaState, quotas, device="cpu"))


def both(pods, nodes, params, quotas=None, shortlist_k=None):
    """(the JAX result, the port's) on the same inputs, after checking
    every compared field bitwise and the placeholders' shapes."""
    want = J.assign_sequential(pods, nodes, params, quotas, shortlist_k=shortlist_k)
    got = T.assign_sequential(*port(pods, nodes, params, quotas), shortlist_k=shortlist_k)
    for f in FIELDS:
        np.testing.assert_array_equal(bits(getattr(want, f)), bits(getattr(got, f).numpy()),
                                      err_msg=f)
    for f in ("node_dev_slots", "node_rdma_free", "node_fpga_free", "node_zone_free",
              "pod_zone", "pod_zone_charge"):
        assert tuple(getattr(got, f).shape) == tuple(np.shape(getattr(want, f))), f
    np.testing.assert_array_equal(got.pod_zone.numpy(), -1)
    return want, got


@pytest.mark.parametrize("kw", [
    dict(p=24, n=12, seed=1),
    dict(p=24, n=12, seed=2, base_util=0.5, thresholds=(65.0, 95.0)),
    dict(p=256, n=8, seed=3, pod_scale=4.0, thresholds=(80.0, 80.0), base_util=0.3),
    dict(p=64, n=8, seed=13, pod_scale=2.0, thresholds=(75.0, 90.0), base_util=0.4),
])
def test_run_both_fixtures_match_reference(kw):
    pods, nodes, params, np_fix = solver_cases.make_fixture(**kw)
    want, _ = both(pods, nodes, params)
    np.testing.assert_array_equal(
        np.asarray(want.assignment), solver_cases.golden.sequential_assign(**np_fix))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("k", [None, 4, 16])
def test_seq_fixture_with_and_without_shortlist_matches_reference(seed, k):
    both(*shortlist_cases.seq_fixture(seed=seed)[:3], shortlist_k=k)


def test_contended_shortlist_falls_back_on_both():
    """K=2 on the contended fixture: the bound cannot prove most picks
    safe, both packages fall back on the same steps, with and without a
    feasible candidate."""
    pods, nodes, params, _ = shortlist_cases.seq_fixture(
        seed=9, p=96, n=16, pod_scale=4.0, base_util=0.45)
    want, got = both(pods, nodes, params, shortlist_k=2)
    fb = got.shortlist_fallbacks.numpy()
    assert fb.sum() > 0 and np.asarray(want.shortlist_fallbacks).sum() > 0
    assert fb[0] > 0 and fb[1] > 0, fb


def test_shortlist_k_at_least_n_is_the_full_axis():
    pods, nodes, params, _ = shortlist_cases.seq_fixture(seed=6, n=12)
    _, got = both(pods, nodes, params, shortlist_k=128)
    np.testing.assert_array_equal(got.shortlist_fallbacks.numpy(), [0, 0])
    _, full = both(pods, nodes, params)
    np.testing.assert_array_equal(got.assignment.numpy(), full.assignment.numpy())


def quota_case(name):
    """The three ``tests/test_elasticquota.py`` admission cases' inputs."""
    d = 1
    if name == "admission cap":
        reqs, n, prios = np.full((4, d), 4.0, np.float32), 4, None
        chains = np.full((n, 4), -1, np.int32)
        chains[:, 0] = 0
        runtime, used = np.array([[10.0]], np.float32), np.zeros((1, d), np.float32)
    elif name == "priority order":
        reqs, prios = np.full((3, d), 4.0, np.float32), np.array([5000, 9500, 7000], np.int32)
        chains = np.full((3, 4), -1, np.int32)
        chains[:, 0] = 0
        runtime, used = np.array([[8.0]], np.float32), np.zeros((1, d), np.float32)
    else:
        reqs, prios = np.full((4, d), 4.0, np.float32), None
        chains = np.full((4, 4), -1, np.int32)
        chains[0:2, 0] = 0
        chains[2:4, 0] = 1
        chains[:, 1] = 2
        runtime = np.array([[16.0], [16.0], [8.0]], np.float32)
        used = np.zeros((3, d), np.float32)
    return quota_cases._quota_fixture(runtime, used, chains, reqs, prios)


@pytest.mark.parametrize("name", ["admission cap", "priority order", "parent cap"])
@pytest.mark.parametrize("k", [None, 2])
def test_quota_admission_cases_match_reference(name, k):
    _, got = both(*quota_case(name), shortlist_k=k)
    a = got.assignment.numpy()
    assert (a >= 0).sum() == 2
    if name == "priority order":
        assert a[0] == -1


def test_chain_naming_a_quota_twice_charges_it_once():
    """A chain that names one quota at two levels is charged once
    (``any`` over the chain), and an index past the table is clipped to
    its last row."""
    d = 2
    reqs = np.full((6, d), 3.0, np.float32)
    chains = np.full((6, 4), -1, np.int32)
    chains[:, 0] = 1
    chains[:, 1] = 1
    chains[:3, 2] = 7
    runtime = np.array([[100.0, 100.0], [10.0, 100.0], [100.0, 12.0]], np.float32)
    used = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 0.0]], np.float32)
    _, got = both(*quota_cases._quota_fixture(runtime, used, chains, reqs))
    assert (got.assignment.numpy() >= 0).sum() == 3


@pytest.mark.parametrize("k", [None, 1])
def test_amplified_cpuset_commit_matches_reference(k):
    """``tests/test_amplification.py:98``: two cpuset-bound pods of 8,000
    milli-CPU on one node of 24,000 amplified 2x; each charges 16,000, so
    one fits; a second, unamplified node takes the other."""
    nodes = J.NodeState.create(
        allocatable=np.array([[24000.0, 1 << 20], [24000.0, 1 << 20]], np.float32),
        cpu_amp=np.array([2.0, 1.0], np.float32),
    )
    pods = amp_cases.qos_pod_batch(8000.0, [3, 3, 3, 0])
    for node_rows in (slice(0, 1), slice(0, 2)):
        sub = dataclasses.replace(nodes, **{
            f.name: getattr(nodes, f.name)[node_rows] for f in dataclasses.fields(nodes)
            if getattr(nodes, f.name) is not None})
        _, got = both(pods, sub, amp_cases.params(),
                      shortlist_k=k if node_rows.stop > 1 else None)
        if node_rows.stop == 1:
            # the first bound pod charges 16,000; the plain pod fits beside it
            assert got.node_requested.numpy()[0, 0] == 24000.0
            assert (got.assignment.numpy() >= 0).sum() == 2


def rich_case(tree, zero_requests: bool):
    """``rich_fixture(SEQ_SEED, *SEQ_SMALL)`` through ``tree``'s quotas
    (None: none), as the JAX package's and the port's inputs; with
    ``zero_requests`` a tenth of the pods ask for nothing in one dim."""
    nodes, pods, params, quotas = chip_smoke.sequential_inputs(
        tree, *chip_smoke.rich_fixture(chip_smoke.SEQ_SEED, *chip_smoke.SEQ_SMALL))
    if zero_requests:
        req = pods["requests"].copy()
        req[::10, 1] = 0.0
        req[5::40, 0] = 0.0
        pods = dict(pods, requests=req, estimate=req * np.float32(0.8))
    return nodes, pods, params, quotas


@pytest.mark.parametrize("tree", [None, "onehot", "sorted"])
@pytest.mark.parametrize("k", [None, chip_smoke.SHORTLIST_K])
def test_rich_fixture_matches_reference_and_golden(tree, k):
    """Stale metrics, unschedulable nodes, custom (prod) thresholds,
    cpuset pods on amplified nodes, invalid pods and gangs, a Strict one
    rolling back: the port equals the JAX package, and both equal the
    committed golden's small case (so the file cannot drift)."""
    nodes, pods, params, quotas = rich_case(tree, False)
    want = make_torch_golden.jax_sequential(nodes, pods, params, quotas, k)
    nodes_t, pods_t, params_t = chip_smoke.port_inputs(torch, nodes, pods, params, "cpu")
    qt = None if quotas is None else T.QuotaState(*(torch.from_numpy(a) for a in quotas))
    got = T.assign_sequential(pods_t, nodes_t, params_t, qt, shortlist_k=k)
    key = chip_smoke.seq_key(tree, k)
    with np.load(chip_smoke.GOLDEN_SEQUENTIAL) as golden:
        assert str(golden["fixture_sha256"]) == chip_smoke.fixture_digest(
            *chip_smoke.rich_fixture(chip_smoke.SEQ_SEED, *chip_smoke.SEQ_SMALL))
        for f in chip_smoke.SEQ_OUTPUTS:
            np.testing.assert_array_equal(bits(want[f]), bits(getattr(got, f).numpy()), err_msg=f)
            np.testing.assert_array_equal(bits(golden[f"{key}_{f}"]), bits(want[f]), err_msg=f)
    asg = got.assignment.numpy()
    assert 0 < (asg >= 0).sum() < len(asg) or tree == "sorted"
    if k is not None and tree is None:
        assert got.shortlist_fallbacks.numpy()[0] > 0


def test_rich_fixture_rolls_back_a_strict_gang():
    """The rich case's gangs: some member placed by the scan is rolled back
    by ``enforce_gangs`` (a Strict gang short of its minimum), on both."""
    nodes, pods, params, _ = rich_case(None, False)
    nodes_t, pods_t, params_t = chip_smoke.port_inputs(torch, nodes, pods, params, "cpu")
    _, spods, bind, thr, pthr = T._round_setup(pods_t, nodes_t, params_t)
    n_args = (nodes_t.allocatable, nodes_t.requested.clone(), nodes_t.estimated_used.clone(),
              nodes_t.prod_used.clone(), nodes_t.metric_fresh, nodes_t.schedulable,
              nodes_t.cpu_amp, thr, pthr, params_t.score_weights)
    scanned, _ = TQ.sequential_scan_plain(spods.requests, spods.estimate, spods.is_prod,
                                          spods.valid, bind, *n_args)
    final = T.assign_sequential(pods_t, nodes_t, params_t)
    assert (scanned >= 0).sum() > (final.assignment >= 0).sum()


@pytest.mark.parametrize("tree, k", [(None, 8), ("onehot", None)])
def test_zero_requests_match_reference(tree, k):
    nodes, pods, params, quotas = rich_case(tree, True)
    jq = None if quotas is None else J.QuotaState(runtime=jnp.asarray(quotas[0]),
                                                  used=jnp.asarray(quotas[1]))
    both(J.PodBatch.create(**pods), J.NodeState.create(**nodes),
         J.SolverParams(**{a: jnp.asarray(v) for a, v in params.items()}), jq, shortlist_k=k)


def test_build_twin_ranks_ties_by_node_and_bounds_with_the_next_score():
    """The build's top-(K+1) by score with the lower node winning ties (as
    ``lax.top_k``), candidates ascending, the (K+1)-th score as the
    bound, -inf when fewer than K+1 nodes are feasible."""
    alloc = torch.full((6, 1), 100.0)
    used = torch.tensor([[50.0], [10.0], [50.0], [10.0], [90.0], [50.0]])
    sched = torch.tensor([True, True, True, True, True, False])
    zeros, ones = torch.zeros(6, 1), torch.ones(6)
    req = torch.tensor([[5.0], [500.0]])
    cand, bound = TQ.sequential_build_plain(
        req, req, torch.tensor([False, False]), torch.tensor([False, False]), alloc, zeros, used,
        zeros, torch.ones(6, dtype=torch.bool), sched, ones, zeros, zeros, torch.ones(1), 3)
    np.testing.assert_array_equal(cand.numpy(), [[0, 1, 3], [0, 1, 2]])
    assert bound[0].item() == 45.0 and bound[1].item() == -np.inf


def test_port_entry_needs_no_card_on_cpu_tensors():
    """On CPU tensors the entry runs the plain route and launches nothing."""
    from koordinator_tpu_torch import kernels

    kernels.reset_launches()
    pods, nodes, params, _ = shortlist_cases.seq_fixture(seed=0)
    T.assign_sequential(*port(pods, nodes, params), shortlist_k=4)
    assert not kernels.launches
    np_pods = dict(requests=np.ones((3, 2), np.float32), priority=np.zeros(3, np.int32))
    res = T.assign_sequential(
        from_numpy(T.PodBatch, device="cpu", **np_pods),
        from_numpy(T.NodeState, device="cpu", allocatable=np.full((2, 2), 10.0, np.float32)),
        from_numpy(T.SolverParams, device="cpu", usage_thresholds=np.zeros(2, np.float32),
                   prod_thresholds=np.zeros(2, np.float32),
                   score_weights=np.ones(2, np.float32)))
    assert res.rounds_used.item() == 3 and res.quota_used.shape == (1, 2)
