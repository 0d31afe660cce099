"""The port's round solver and stream against the JAX package on the CPU.

Same numpy inputs into ``koordinator_tpu.ops.solver`` and
``koordinator_tpu_torch.ops.solver`` (through ``convert.from_numpy``):
assignments, ``rounds_used`` and post-commit node tables must be bitwise
equal (tolerance: none — the port sums in the order XLA's CPU backend
sums, so the bits agree).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from koordinator_tpu.ops import solver as J
from koordinator_tpu_torch.ops import device as TD
from koordinator_tpu_torch.ops import numa as TN
from koordinator_tpu_torch.ops import solver as T
from koordinator_tpu_torch.ops.convert import from_jax, from_numpy, to_numpy
from tools import make_torch_golden

torch.set_num_threads(1)
torch.use_deterministic_algorithms(True)

TABLES = ("node_requested", "node_estimated_used", "node_prod_used")


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def both_inputs(nodes, pods, params):
    return (
        (
            J.PodBatch.create(**pods),
            J.NodeState.create(**nodes),
            J.SolverParams(**{k: jnp.asarray(v) for k, v in params.items()}),
        ),
        (
            from_numpy(T.PodBatch, device="cpu", **pods),
            from_numpy(T.NodeState, device="cpu", **nodes),
            from_numpy(T.SolverParams, device="cpu", **params),
        ),
    )


def contended(seed, p=128, n=32, gangs=True):
    """More demand than room: amplified nodes with cpuset-bound LSR pods,
    stale and unschedulable nodes, custom thresholds, prod pods, Strict
    and NonStrict gangs and padded invalid pods."""
    rng = np.random.default_rng(seed)
    alloc = (rng.choice([8000.0, 16_000.0, 32_000.0], (n, 1)) * np.array([1.0, 4.0]))
    alloc = alloc.astype(np.float32)
    est_used = (alloc * rng.uniform(0.05, 0.6, (n, 1))).astype(np.float32)
    nodes = dict(
        allocatable=alloc,
        requested=(alloc * rng.uniform(0.0, 0.3, (n, 1))).astype(np.float32),
        estimated_used=est_used,
        prod_used=(est_used * np.float32(0.6)).astype(np.float32),
        metric_fresh=rng.random(n) > 0.1,
        schedulable=rng.random(n) > 0.05,
        cpu_amp=np.where(rng.random(n) < 0.4, 1.5, 1.0).astype(np.float32),
        custom_thresholds=np.where(
            rng.random((n, 1)) < 0.2, np.array([[70.0, 0.0]]), 0.0
        ).astype(np.float32),
        custom_prod_thresholds=np.where(
            rng.random((n, 1)) < 0.1, np.array([[45.0, 90.0]]), 0.0
        ).astype(np.float32),
    )
    cpu = rng.choice([500.0, 1000.0, 2000.0, 4000.0], p, p=[0.3, 0.3, 0.2, 0.2])
    req = np.stack([cpu, cpu * rng.choice([2, 4, 8], p)], 1).astype(np.float32)
    prio = rng.integers(5000, 9999, p).astype(np.int32)
    pods = dict(
        requests=req,
        estimate=(req * np.array([0.85, 0.7], np.float32)).astype(np.float32),
        priority=prio,
        is_prod=prio >= 8500,
        qos=rng.choice([0, 3, 4], p, p=[0.6, 0.3, 0.1]).astype(np.int8),
        valid=rng.random(p) > 0.05,
    )
    if gangs:
        pods["gang_id"] = np.where(rng.random(p) < 0.4, rng.integers(0, 6, p), -1).astype(np.int32)
        gmin = np.zeros(p, np.int32)
        gmin[:6] = rng.integers(2, 16, 6)
        gns = np.zeros(p, bool)
        gns[:6] = rng.random(6) < 0.4
        pods["gang_min"], pods["gang_nonstrict"] = gmin, gns
    params = dict(
        usage_thresholds=np.array([65.0, 95.0], np.float32),
        prod_thresholds=np.array([55.0, 0.0], np.float32),
        score_weights=np.ones(2, np.float32),
    )
    return nodes, pods, params


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_assign_matches_reference(seed, approx):
    nodes, pods, params = contended(seed)
    (jp, jn, jpar), (tp, tn, tpar) = both_inputs(nodes, pods, params)
    jr = J.assign(jp, jn, jpar, max_rounds=12, approx_topk=approx)
    tr = to_numpy(T.assign(tp, tn, tpar, max_rounds=12, approx_topk=approx))
    for f in ("assignment", "rounds_used", "pod_zone") + TABLES:
        np.testing.assert_array_equal(bits(getattr(jr, f)), bits(tr[f]), err_msg=f)
    # the fixture exercises contention and gang rollback
    assert 0 < (tr["assignment"] >= 0).sum() < pods["valid"].sum()
    ungated = dataclasses.replace(tp, gang_id=torch.full_like(tp.gang_id, -1))
    free = to_numpy(T.assign(ungated, tn, tpar, max_rounds=12, approx_topk=approx))
    if seed == 0:
        assert (free["assignment"] >= 0).sum() > (tr["assignment"] >= 0).sum()
    assert np.all(tr["assignment"][~pods["valid"]] == -1)
    # the caller's tables are never written
    np.testing.assert_array_equal(tn.requested.numpy(), nodes["requested"])


def test_assign_single_round_cap_and_no_valid_pods():
    nodes, pods, params = contended(5, gangs=False)
    for max_rounds in (0, 2):
        (jp, jn, jpar), (tp, tn, tpar) = both_inputs(nodes, pods, params)
        jr = J.assign(jp, jn, jpar, max_rounds=max_rounds)
        tr = to_numpy(T.assign(tp, tn, tpar, max_rounds=max_rounds))
        for f in ("assignment", "rounds_used") + TABLES:
            np.testing.assert_array_equal(bits(getattr(jr, f)), bits(tr[f]), err_msg=f)
    pods["valid"] = np.zeros_like(pods["valid"])
    (jp, jn, jpar), (tp, tn, tpar) = both_inputs(nodes, pods, params)
    tr = to_numpy(T.assign(tp, tn, tpar, max_rounds=12))
    assert tr["rounds_used"] == int(J.assign(jp, jn, jpar, max_rounds=12).rounds_used) == 0


def bench_scaled(batches=3, n_nodes=1000):
    """``bench.build_fixture`` cut to 3 batches × 512 pods × 1,000 nodes,
    with bench's parameters."""
    nodes, pods, params = chip_smoke.headline_inputs(
        chip_smoke.build_fixture(0, n_nodes, batches * chip_smoke.BATCH)
    )
    return nodes, chip_smoke.stacked(pods), params


def jax_stream(nodes, stacked, params, **kw):
    pods = jax.tree.map(
        lambda a: a.reshape((-1, chip_smoke.BATCH) + a.shape[1:]),
        J.PodBatch.create(**{k: v.reshape((-1,) + v.shape[2:]) for k, v in stacked.items()}),
    )
    return J.solve_stream(
        pods, J.NodeState.create(**nodes),
        J.SolverParams(**{k: jnp.asarray(v) for k, v in params.items()}), **kw,
    )


@pytest.mark.parametrize("approx", [True, False])
def test_solve_stream_bench_scaled_matches_reference(approx):
    nodes, stacked, params = bench_scaled()
    j_asg, j_final, j_placed, _ = jax_stream(
        nodes, stacked, params, max_rounds=12, approx_topk=approx
    )
    t_asg, t_final, t_placed, t_quota = T.solve_stream(
        from_numpy(T.PodBatch, device="cpu", **stacked),
        from_numpy(T.NodeState, device="cpu", **nodes),
        from_numpy(T.SolverParams, device="cpu", **params),
        max_rounds=12, approx_topk=approx,
    )
    np.testing.assert_array_equal(np.asarray(j_asg), t_asg.numpy())
    np.testing.assert_array_equal(np.asarray(j_placed), t_placed.numpy())
    for f in ("requested", "estimated_used", "prod_used"):
        np.testing.assert_array_equal(bits(getattr(j_final, f)), bits(getattr(t_final, f).numpy()))
    assert t_placed.sum() > 0.9 * t_asg.numel()
    assert t_quota.runtime.shape == (1, 2) and torch.isinf(t_quota.runtime).all()


def test_golden_file_is_the_reference_result():
    """The committed golden equals what the JAX package computes now."""
    fresh = make_torch_golden.golden_arrays()
    committed = np.load(make_torch_golden.PATH)
    assert sorted(committed.files) == sorted(fresh)
    for k, v in fresh.items():
        np.testing.assert_array_equal(bits(committed[k]), bits(v), err_msg=k)


def test_port_reproduces_golden_on_cpu():
    """The check chip_smoke.py makes on the card, run here on the CPU."""
    gold = np.load(make_torch_golden.PATH)
    nodes, pods, params = chip_smoke.rich_fixture(
        chip_smoke.GOLDEN_SEED, chip_smoke.GOLDEN_NODES, chip_smoke.GOLDEN_PODS
    )
    assert str(gold["fixture_sha256"]) == chip_smoke.fixture_digest(nodes, pods, params)
    asg, final, _, _ = T.solve_stream(
        from_numpy(T.PodBatch, device="cpu", **chip_smoke.stacked(pods)),
        from_numpy(T.NodeState, device="cpu", **nodes),
        from_numpy(T.SolverParams, device="cpu", **params),
        **chip_smoke.SOLVE,
    )
    np.testing.assert_array_equal(asg.numpy(), gold["assignments"])
    for f in ("requested", "estimated_used", "prod_used"):
        np.testing.assert_array_equal(bits(getattr(final, f).numpy()), bits(gold[f]))


def test_create_defaults_match_reference():
    """``create()`` gives the JAX package's fields, shapes and dtypes."""
    alloc = np.ones((5, 2), np.float32)
    for jcls, tcls, args in (
        (J.NodeState, T.NodeState, dict(allocatable=alloc)),
        (J.PodBatch, T.PodBatch, dict(requests=alloc, priority=np.arange(5) * 3000)),
    ):
        j = jcls.create(**args)
        t = from_numpy(tcls, device="cpu", **args)
        assert [f.name for f in dataclasses.fields(tcls)] == [
            f.name for f in dataclasses.fields(jcls)
        ]
        for name, value in to_numpy(t).items():
            np.testing.assert_array_equal(np.asarray(getattr(j, name)), value, err_msg=name)
            assert np.asarray(getattr(j, name)).dtype == value.dtype, name
    q = T.QuotaState.disabled(2, device="cpu")
    jq = J.QuotaState.disabled(2)
    np.testing.assert_array_equal(np.asarray(jq.runtime), q.runtime.numpy())
    np.testing.assert_array_equal(np.asarray(jq.used), q.used.numpy())


def test_from_jax_and_helpers_match_reference():
    nodes, pods, params = contended(9, gangs=False)
    (jp, jn, _), (tp, _, _) = both_inputs(nodes, pods, params)
    tn = from_jax(T.NodeState, jn, device="cpu")
    for name, value in to_numpy(tn).items():
        np.testing.assert_array_equal(np.asarray(getattr(jn, name)), value)
    np.testing.assert_array_equal(np.asarray(J._priority_order(jp)), T._priority_order(tp).numpy())
    jpar = J.SolverParams(**{k: jnp.asarray(v) for k, v in params.items()})
    tpar = from_numpy(T.SolverParams, device="cpu", **params)
    np.testing.assert_array_equal(
        np.asarray(J._feasible(jp, jn, jpar, jp.valid)),
        T._feasible(tp, tn, tpar, tp.valid).numpy(),
    )
    np.testing.assert_array_equal(np.asarray(J._cpu_bind(jp)), T._cpu_bind(tp).numpy())
    pi, ni = np.arange(700)[:, None], np.arange(900)[None, :]
    np.testing.assert_array_equal(
        np.asarray(J._jitter_hash(jnp.asarray(pi, jnp.uint32), jnp.asarray(ni, jnp.uint32))),
        T._jitter_hash(torch.from_numpy(pi), torch.from_numpy(ni)).numpy(),
    )


@pytest.mark.parametrize(
    "option",
    ["numa", "devices", "cost_transform",
     "dev_carry", "numa_carry", "numa_scoring", "device_scoring"],
)
def test_unported_options_raise(option):
    nodes, pods, params = contended(0, p=8, n=4, gangs=False)
    _, (tp, tn, tpar) = both_inputs(nodes, pods, params)
    if option in ("numa", "numa_carry", "numa_scoring"):
        # ported with the NUMA slice: taken, and the zone table comes back
        zone = np.full((4, 2, 2), 4000.0, np.float32)
        numa = TN.NumaState.create(zone_free=zone, zone_cap=zone, policy=np.full(4, 3, np.int8),
                                   device="cpu")
        value = {"numa": numa, "numa_carry": numa.zone_free.clone(),
                 "numa_scoring": "LeastAllocated"}[option]
        res = T.assign(tp, tn, tpar, **{"numa": numa, option: value})
        assert tuple(res.node_zone_free.shape) == (4, 2, 2)
        return
    if option in ("devices", "dev_carry", "device_scoring"):
        # ported with the device slice: taken, and the dev tables come back
        devices = TD.DeviceState.create(np.full((4, 2), 100.0, np.float32),
                                        rdma_free=np.ones(4), cap_total=np.full(4, 200.0),
                                        device="cpu")
        value = {"devices": devices,
                 "dev_carry": (devices.slot_free * 0.5, devices.rdma_free, torch.zeros(4)),
                 "device_scoring": "MostAllocated"}[option]
        res = T.assign(tp, tn, tpar, **{"devices": devices, option: value})
        assert tuple(res.node_dev_slots.shape) == (4, 2)
        assert tuple(res.node_rdma_free.shape) == (4,)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item"):
        T.assign(tp, tn, tpar, **{option: object()})
