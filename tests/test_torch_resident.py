"""Resident node rows: the port's row refresh, window gather and
commit-delta chaining against the JAX package on the CPU.

``scatter_rows`` / ``gather_rows`` (``ops/solver.py:248-283``) and
``_chain_commit_deltas`` / ``_apply_commit_deltas_donated``
(``scheduler/batch_solver.py:162-194``) must give the reference's bits.
Where the reference donates its input, the port writes into the input
tensors: their ``data_ptr`` must not change, so a CUDA graph keyed by them
(``_StreamGraph``) replays with the new rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from koordinator_tpu.ops import solver as J
from koordinator_tpu.scheduler import batch_solver as JB
from koordinator_tpu_torch.ops import solver as T
from koordinator_tpu_torch.ops.convert import from_jax, from_numpy, to_numpy
from koordinator_tpu_torch.scheduler import batch_solver as TB

torch.set_num_threads(1)
torch.use_deterministic_algorithms(True)


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def node_arrays(seed, n):
    rng = np.random.default_rng(seed)
    alloc = rng.choice([8000.0, 16_000.0], (n, 1)) * np.array([1.0, 4.0])
    return dict(
        allocatable=alloc.astype(np.float32),
        requested=(alloc * rng.uniform(0, 0.5, (n, 2))).astype(np.float32),
        estimated_used=(alloc * rng.uniform(0, 0.6, (n, 2))).astype(np.float32),
        prod_used=(alloc * rng.uniform(0, 0.3, (n, 2))).astype(np.float32),
        metric_fresh=rng.random(n) > 0.2,
        schedulable=rng.random(n) > 0.1,
        cpu_amp=rng.choice([1.0, 1.5], n).astype(np.float32),
        custom_thresholds=np.where(rng.random((n, 1)) < 0.3, 70.0, 0.0).astype(np.float32)
        * np.ones((1, 2), np.float32),
        custom_prod_thresholds=np.zeros((n, 2), np.float32),
    )


def refresh(seed, n, rows):
    """Row ids (with repeats carrying identical rows) and the new rows."""
    rng = np.random.default_rng(seed + 100)
    idx = rng.choice(n, rows, replace=False).astype(np.int32)
    idx = np.concatenate([idx, idx[:3]])  # duplicates, as callers pad to a bucket
    new = node_arrays(seed + 200, rows)
    return idx, {k: np.concatenate([v, v[:3]]) for k, v in new.items()}


@pytest.mark.parametrize("seed, n, rows", [(0, 40, 5), (1, 200, 2), (2, 64, 64 - 3)])
def test_scatter_rows_matches_reference_in_place(seed, n, rows):
    full = node_arrays(seed, n)
    idx, new = refresh(seed, n, rows)
    want = J.scatter_rows(J.NodeState.create(**full), jnp.asarray(idx), J.NodeState.create(**new))
    port = from_numpy(T.NodeState, device="cpu", **full)
    ptrs = {k: v.data_ptr() for k, v in vars(port).items()}
    got = T.scatter_rows(port, torch.from_numpy(idx), from_numpy(T.NodeState, device="cpu", **new))
    assert got is port
    assert {k: v.data_ptr() for k, v in vars(port).items()} == ptrs
    for name, value in to_numpy(port).items():
        np.testing.assert_array_equal(bits(getattr(want, name)), bits(value), err_msg=name)


@pytest.mark.parametrize("seed, n, b", [(0, 40, 16), (1, 200, 7), (2, 8, 20)])
def test_gather_rows_matches_reference(seed, n, b):
    full = node_arrays(seed, n)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, b).astype(np.int32)
    valid = rng.random(b) > 0.3
    want = J.gather_rows(J.NodeState.create(**full), jnp.asarray(idx), jnp.asarray(valid))
    port = from_numpy(T.NodeState, device="cpu", **full)
    got = T.gather_rows(port, torch.from_numpy(idx), torch.from_numpy(valid))
    for name, value in to_numpy(got).items():
        np.testing.assert_array_equal(bits(getattr(want, name)), bits(value), err_msg=name)
        assert np.asarray(getattr(want, name)).dtype == value.dtype, name
    # the resident tables are not written
    np.testing.assert_array_equal(port.requested.numpy(), full["requested"])


def solved(seed, n=48, p=64):
    """A base state, the state a solve ran on, and the solve's result."""
    nodes, pods, params = chip_smoke.headline_inputs(chip_smoke.build_fixture(seed, n, p))
    base = node_arrays(seed + 7, n)
    nodes_t = J.NodeState.create(**nodes)
    res = J.assign(
        J.PodBatch.create(**pods), nodes_t,
        J.SolverParams(**{k: jnp.asarray(v) for k, v in params.items()}), max_rounds=4,
    )
    return J.NodeState.create(**base), nodes_t, res


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chain_commit_deltas_matches_reference(seed):
    cur, nodes_t, res = solved(seed)
    want = JB._chain_commit_deltas(cur, nodes_t, res)
    t_cur = from_jax(T.NodeState, cur, device="cpu")
    got = TB._chain_commit_deltas(
        t_cur, from_jax(T.NodeState, nodes_t, device="cpu"),
        from_jax(T.SolveResult, res, device="cpu"),
    )
    for name, value in to_numpy(got).items():
        np.testing.assert_array_equal(bits(getattr(want, name)), bits(value), err_msg=name)
    # functional: the base state is not written
    np.testing.assert_array_equal(bits(t_cur.requested.numpy()), bits(cur.requested))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_commit_deltas_in_place_matches_reference(seed):
    cur, nodes_t, res = solved(seed)
    names = ("requested", "estimated_used", "prod_used")
    args = (
        [np.asarray(getattr(cur, f)) for f in names]
        + [np.asarray(getattr(nodes_t, f)) for f in names]
        + [np.asarray(getattr(res, "node_" + f)) for f in names]
    )
    want = JB._apply_commit_deltas_donated(*[jnp.asarray(a.copy()) for a in args])
    tensors = [torch.from_numpy(a.copy()) for a in args]
    ptrs = [t.data_ptr() for t in tensors[:3]]
    got = TB._apply_commit_deltas_(*tensors)
    assert [t.data_ptr() for t in got] == ptrs
    assert all(g is t for g, t in zip(got, tensors[:3]))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(bits(w), bits(g.numpy()))
    # the chained form gives the same bits
    chained = TB._chain_commit_deltas(
        from_jax(T.NodeState, cur, device="cpu"), from_jax(T.NodeState, nodes_t, device="cpu"),
        from_jax(T.SolveResult, res, device="cpu"),
    )
    for f, g in zip(names, got):
        np.testing.assert_array_equal(bits(getattr(chained, f).numpy()), bits(g.numpy()))


def test_two_cycles_on_resident_rows_match_a_fresh_solve():
    """The scheduler's two cycles (``chip_smoke.two_cycles``) on the CPU: a
    shortlist stream, 1% of the rows refreshed in place, a second stream
    equal to the same solve on freshly built tables."""
    out = chip_smoke.two_cycles(torch, "cpu", 1000, 2)
    assert out["same_ptrs"] and out["refreshed"] == 10
    assert out["mismatches"] == []
    asg = out["second"][0]
    assert (asg >= 0).sum() > 0.5 * asg.numel()
