"""Round nomination: the port's ``nominate`` (plain path on the CPU)
against the JAX package's ``_full_nominate`` (``_feasible`` +
``load_aware_cost`` + jitter + ``top_k`` / pinned ``approx_max_k``).

Costs and node indices must be bitwise equal in every slot, finite or not:
both sides rank by (value, lower index), also among +inf entries.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.ops import costs as jcosts
from koordinator_tpu.ops import solver as J
from koordinator_tpu_torch import kernels
from koordinator_tpu_torch.ops import nominate as tnom
from koordinator_tpu_torch.ops import solver as T
from koordinator_tpu_torch.ops.convert import from_numpy
from koordinator_tpu_torch.ops.masks import effective_thresholds

torch.set_num_threads(1)
torch.use_deterministic_algorithms(True)


@functools.partial(jax.jit, static_argnames=("k", "jitter", "approx"))
def jax_nominate(pods, nodes, params, k, jitter, approx):
    """``_full_nominate`` of round 0 (``solver.py:864-947, 1121-1156``)."""
    order = J._priority_order(pods)
    spods = jax.tree.map(lambda a: a[order], pods)
    p, n = spods.requests.shape[0], nodes.allocatable.shape[0]
    feas = J._feasible(spods, nodes, params, spods.valid)
    cost = jcosts.load_aware_cost(
        spods.estimate, nodes.estimated_used, nodes.allocatable,
        params.score_weights, metric_fresh=nodes.metric_fresh,
    )
    if jitter > 0.0:
        pi = jnp.arange(p, dtype=jnp.uint32)[:, None]
        ni = jnp.arange(n, dtype=jnp.uint32)[None, :]
        cost = cost + J._jitter_hash(pi, ni).astype(jnp.float32) * (jitter / 65536.0)
    cost = jnp.where(feas, cost, jnp.inf)
    if approx:
        neg_ap, idx_ap = jax.lax.approx_max_k(-cost, k)
        bidx = jnp.argmin(cost, axis=1).astype(idx_ap.dtype)
        bval = -jnp.take_along_axis(cost, bidx[:, None], axis=1)
        neg_top = jnp.concatenate([bval, neg_ap[:, : k - 1]], axis=1)
        top_idx = jnp.concatenate([bidx[:, None], idx_ap[:, : k - 1]], axis=1)
    else:
        neg_top, top_idx = jax.lax.top_k(-cost, k)
    return -neg_top, top_idx.astype(jnp.int32)


def port_nominate(pods, nodes, params, k, jitter, approx):
    order = T._priority_order(pods)
    spods = T.tree_map(lambda a: a[order].contiguous(), pods)
    n, d = nodes.allocatable.shape
    thr = effective_thresholds(params.usage_thresholds, nodes.custom_thresholds)
    pthr = effective_thresholds(params.prod_thresholds, nodes.custom_prod_thresholds)
    return tnom.nominate(
        spods.requests, spods.estimate, spods.is_prod, T._cpu_bind(spods),
        spods.valid.contiguous(), nodes.allocatable, nodes.requested,
        nodes.estimated_used, nodes.prod_used, nodes.metric_fresh,
        nodes.schedulable, nodes.cpu_amp, thr.expand(n, d).contiguous(),
        pthr.expand(n, d).contiguous(), params.score_weights, k, jitter, approx,
    )


def build(nodes, pods, params):
    jn = J.NodeState.create(**nodes)
    jp = J.PodBatch.create(**pods)
    jpar = J.SolverParams(**{k: jnp.asarray(v) for k, v in params.items()})
    tn = from_numpy(T.NodeState, device="cpu", **nodes)
    tp = from_numpy(T.PodBatch, device="cpu", **pods)
    tpar = from_numpy(T.SolverParams, device="cpu", **params)
    return (jp, jn, jpar), (tp, tn, tpar)


def check(nodes, pods, params, k=4, jitter=4.0, approx=False):
    jargs, targs = build(nodes, pods, params)
    jc, ji = (np.asarray(a) for a in jax_nominate(*jargs, k=k, jitter=jitter, approx=approx))
    before = dict(kernels.launches)
    tc, ti = (a.numpy() for a in port_nominate(*targs, k, jitter, approx))
    assert dict(kernels.launches) == before  # CPU tensors: no kernel launch
    np.testing.assert_array_equal(jc.view(np.uint32), tc.view(np.uint32))
    np.testing.assert_array_equal(ji, ti)
    return tc, ti


def fixture(seed, p=64, n=48):
    rng = np.random.default_rng(seed)
    alloc = rng.choice([4000.0, 32_000.0, 64_000.0], (n, 1)) * np.array([1.0, 4.0])
    alloc = alloc.astype(np.float32)
    est_used = (alloc * rng.uniform(0.05, 0.7, (n, 1))).astype(np.float32)
    nodes = dict(
        allocatable=alloc,
        requested=(alloc * rng.uniform(0.0, 0.6, (n, 1))).astype(np.float32),
        estimated_used=est_used,
        prod_used=(est_used * np.float32(0.6)).astype(np.float32),
        metric_fresh=rng.random(n) > 0.15,
        schedulable=rng.random(n) > 0.1,
        cpu_amp=np.where(rng.random(n) < 0.3, 1.5, 1.0).astype(np.float32),
        custom_thresholds=np.where(
            rng.random((n, 1)) < 0.2, np.array([[70.0, 0.0]]), 0.0
        ).astype(np.float32),
        custom_prod_thresholds=np.where(
            rng.random((n, 1)) < 0.2, np.array([[50.0, 80.0]]), 0.0
        ).astype(np.float32),
    )
    cpu = rng.choice([500.0, 1000.0, 2000.0, 8000.0], p)
    req = np.stack([cpu, cpu * rng.choice([2, 4, 8], p)], 1).astype(np.float32)
    prio = rng.integers(5000, 9999, p).astype(np.int32)
    pods = dict(
        requests=req,
        estimate=(req * np.array([0.85, 0.7], np.float32)).astype(np.float32),
        priority=prio,
        is_prod=prio >= 8000,
        qos=np.where(rng.random(p) < 0.3, 3, 0).astype(np.int8),
        valid=rng.random(p) > 0.05,
    )
    params = dict(
        usage_thresholds=np.array([65.0, 95.0], np.float32),
        prod_thresholds=np.array([55.0, 0.0], np.float32),
        score_weights=np.ones(2, np.float32),
    )
    return nodes, pods, params


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_nominate_matches_reference(seed, approx):
    check(*fixture(seed), approx=approx)


@pytest.mark.parametrize("k, jitter", [(1, 4.0), (4, 0.0), (6, 2.5)])
def test_nominate_fanout_and_jitter(k, jitter):
    check(*fixture(7), k=k, jitter=jitter, approx=False)


def tie_fixture():
    """Exact ties in the jittered cost. With jitter 4.0 a score gap of 1
    equals a hash gap of 16384: node ``b`` scores one point more than node
    ``a`` and hashes 16384 higher for the top-priority pod, so both cost
    the same float32 bits (node ids 49152 apart hash 16384 apart, mod
    2**16). Identical stale nodes tie as well."""
    n, d = 49_200, 2
    h = (np.arange(n, dtype=np.int64) * 40503) & 0xFFFF  # pod position 0
    a = next(i for i in range(n - 49_152) if h[i + 49_152] == h[i] + 16384)
    b = a + 49_152
    alloc = np.full((n, d), 100.0, np.float32)
    est_used = np.full((n, d), 99.0, np.float32)  # score 1 on the other nodes
    est_used[a] = 50.0                            # score 50
    est_used[b] = 49.0                            # score 51
    fresh = np.ones(n, bool)
    fresh[-8:] = False                            # stale: score 0, tied
    nodes = dict(
        allocatable=alloc, estimated_used=est_used, metric_fresh=fresh,
    )
    pods = dict(
        requests=np.zeros((3, d), np.float32) + np.float32(1.0),
        estimate=np.zeros((3, d), np.float32),
        priority=np.array([9000, 5000, 100], np.int32),
    )
    params = dict(
        usage_thresholds=np.zeros(d, np.float32),
        prod_thresholds=np.zeros(d, np.float32),
        score_weights=np.ones(d, np.float32),
    )
    return nodes, pods, params, a, b


@pytest.mark.parametrize("approx", [False, True])
def test_nominate_breaks_exact_ties_by_lower_index(approx):
    nodes, pods, params, a, b = tie_fixture()
    cost, idx = check(nodes, pods, params, approx=approx)
    assert cost[0, 0] == cost[0, 2 if approx else 1]
    assert list(idx[0, :2]) == [a, a] if approx else [a, b]
    # without jitter b, then a, then the score-1 nodes, all tied: the
    # lowest ids win
    cost, idx = check(nodes, pods, params, jitter=0.0, approx=approx)
    rest = [i for i in range(3) if i != a][:2]
    assert list(idx[0]) == ([b, b, a, rest[0]] if approx else [b, a] + rest)


@pytest.mark.parametrize("approx", [False, True])
def test_nominate_rows_with_few_feasible_nodes(approx):
    """Rows with 0, 1 and 2 feasible nodes: +inf slots keep the lowest
    infeasible node indices, and the pinned vector is [best, best, ...]."""
    nodes, pods, params = fixture(11, p=6, n=24)
    nodes["schedulable"] = np.ones(24, bool)
    nodes["requested"] = np.zeros_like(nodes["allocatable"])
    nodes["metric_fresh"] = np.zeros(24, bool)
    nodes["allocatable"][:] = 1000.0
    nodes["allocatable"][5] = 50_000.0
    nodes["allocatable"][17] = 60_000.0
    big = np.float32(40_000.0)
    pods["requests"] = np.array(
        [[big * 2, 1], [55_000, 1], [big, 1], [1, 1], [big, 1], [1, 1]], np.float32
    )
    pods["estimate"] = pods["requests"].copy()
    pods["qos"] = np.zeros(6, np.int8)
    pods["valid"] = np.array([True, True, True, True, True, False])
    pods["priority"] = np.arange(6, dtype=np.int32)[::-1].copy()
    cost, idx = check(nodes, pods, params, approx=approx)
    n_finite = np.isfinite(cost).sum(axis=1)
    if approx:
        assert sorted(n_finite) == [0, 0, 2, 3, 3, 4]
        one = np.flatnonzero(n_finite == 2)[0]
        assert idx[one, 0] == idx[one, 1] == 17
    else:
        assert sorted(n_finite) == [0, 0, 1, 2, 2, 4]
