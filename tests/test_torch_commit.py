"""Round commit: the port's ``commit_plain`` (the commit step of the plain
round tail) and its ordered sums against the JAX package.

The reference's commit block lives inside ``assign``'s round body
(``solver.py:1204-1385``); :func:`jax_commit` restates its LoadAware branch
line for line under ``jax.jit``, as ``assign`` runs it, so XLA applies the
same rewrites (a cumsum in chunks of 16, ``table + segment_sum`` folded into
a scatter-add onto the table). Accepts and post-commit tables must be
bitwise equal; so must ``assign(max_rounds=1)``, which runs the real block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.ops import masks as jmasks
from koordinator_tpu.ops import solver as J
from koordinator_tpu_torch.ops import commit as tcommit
from koordinator_tpu_torch.ops import solver as T
from koordinator_tpu_torch.ops.convert import from_numpy, to_numpy

torch.set_num_threads(1)
torch.use_deterministic_algorithms(True)


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


@jax.jit
def jax_commit(snode, sreq, sest, sprod, alloc, fresh, thr, pthr,
               requested, est_used, prod_used, round_quantum):
    n = alloc.shape[0]
    gnode = jnp.minimum(snode, n - 1)
    is_start = jnp.concatenate([jnp.ones((1,), bool), snode[1:] != snode[:-1]])
    seg_req = J._segment_prefix_sums(sreq, is_start)
    seg_est = J._segment_prefix_sums(sest, is_start)
    seg_prod = J._segment_prefix_sums(jnp.where(sprod[:, None], sest, 0.0), is_start)
    alloc_g = alloc[gnode]
    fresh_g = fresh[gnode]
    accept = snode < n
    accept &= jnp.all(requested[gnode] + seg_req <= alloc_g + jmasks.EPS, axis=-1)
    over = (thr[gnode] > 0.0) & (
        jmasks.usage_percent(est_used[gnode] + seg_est, alloc_g) > thr[gnode]
    )
    accept &= ~(fresh_g & jnp.any(over, axis=-1))
    pover = (pthr[gnode] > 0.0) & (
        jmasks.usage_percent(prod_used[gnode] + seg_prod, alloc_g) > pthr[gnode]
    )
    accept &= ~(sprod & fresh_g & jnp.any(pover, axis=-1))
    prior_est = seg_est - sest
    accept &= jnp.all(
        (alloc_g <= 0) | (prior_est <= round_quantum * alloc_g + jmasks.EPS), axis=-1
    )
    seg_ids = jnp.where(accept, snode, n - 1)
    zero = jnp.zeros_like(sreq)
    dreq = jax.ops.segment_sum(jnp.where(accept[:, None], sreq, zero), seg_ids, num_segments=n)
    dest = jax.ops.segment_sum(jnp.where(accept[:, None], sest, zero), seg_ids, num_segments=n)
    dprod = jax.ops.segment_sum(
        jnp.where((accept & sprod)[:, None], sest, zero), seg_ids, num_segments=n
    )
    return accept, requested + dreq, est_used + dest, prod_used + dprod


def commit_case(seed, p=512, n=40, d=2):
    """A round's sorted commit inputs: many pods per node (long segments),
    unassigned pods (key n) at the end, near-threshold tables."""
    rng = np.random.default_rng(seed)
    alloc = rng.choice([0.0, 32_000.0, 96_000.0], (n, d), p=[0.05, 0.5, 0.45])
    alloc = alloc.astype(np.float32)
    used = (alloc * rng.uniform(0.0, 0.7, (n, d))).astype(np.float32)
    key = np.sort(np.where(rng.random(p) < 0.1, n, rng.integers(0, n, p))).astype(np.int32)
    req = (rng.choice([500.0, 1000.0, 4000.0], (p, d)) * rng.uniform(0.9, 1.6, (p, 1)))
    req = req.astype(np.float32)
    thr = np.where(rng.random((n, d)) < 0.7, rng.choice([60.0, 65.0, 95.0], (n, d)), 0.0)
    pthr = np.where(rng.random((n, d)) < 0.5, 55.0, 0.0)
    return dict(
        snode=key,
        sreq=req,
        sest=(req * np.float32(0.85)).astype(np.float32),
        sprod=rng.random(p) < 0.4,
        alloc=alloc,
        fresh=rng.random(n) > 0.1,
        thr=thr.astype(np.float32),
        pthr=pthr.astype(np.float32),
        requested=(alloc * rng.uniform(0.0, 0.5, (n, d))).astype(np.float32),
        est_used=used,
        prod_used=(used * np.float32(0.6)).astype(np.float32),
    )


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("quantum", [0.35, 0.05])
def test_commit_plain_matches_reference_block(seed, quantum):
    case = commit_case(seed)
    j_acc, *j_tables = jax_commit(*[jnp.asarray(v) for v in case.values()], quantum)
    t = {k: torch.from_numpy(v.copy()) for k, v in case.items()}
    t_acc = tcommit.commit_plain(*t.values(), quantum)
    np.testing.assert_array_equal(np.asarray(j_acc), t_acc.numpy())
    assert 0 < t_acc.sum() < len(t_acc)
    for jt, name in zip(j_tables, ("requested", "est_used", "prod_used")):
        np.testing.assert_array_equal(bits(jt), bits(t[name].numpy()))


@pytest.mark.parametrize("m", [1, 5, 16, 17, 33, 256, 512, 1000, 4100])
def test_ordered_cumsum_and_segment_prefix_match_jax(m):
    """``jnp.cumsum`` on the CPU sums in chunks of 16 — neither a sequential
    walk nor ``torch.cumsum`` (float32 accumulated in double) matches it."""
    rng = np.random.default_rng(m)
    vals = (rng.uniform(0, 5000, (m, 2)) * np.float32(0.85)).astype(np.float32)
    starts = rng.random(m) < 0.05
    starts[0] = True
    np.testing.assert_array_equal(
        bits(jnp.cumsum(jnp.asarray(vals), axis=0)),
        bits(tcommit._ordered_cumsum(torch.from_numpy(vals)).numpy()),
    )
    np.testing.assert_array_equal(
        bits(jax.jit(J._segment_prefix_sums)(jnp.asarray(vals), jnp.asarray(starts))),
        bits(tcommit._segment_prefix_sums(torch.from_numpy(vals), torch.from_numpy(starts)).numpy()),
    )


def test_segment_sum_plain_matches_jax():
    rng = np.random.default_rng(5)
    vals = (rng.uniform(0, 5000, (700, 6)) * np.float32(0.85)).astype(np.float32)
    ids = rng.integers(-2, 60, 700).astype(np.int32)
    want = jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(ids), num_segments=50)
    got = tcommit.segment_sum_plain(torch.from_numpy(vals), torch.from_numpy(ids), 50)
    np.testing.assert_array_equal(bits(want), bits(got.numpy()))


def one_round_fixture(seed, p=512, n=60):
    rng = np.random.default_rng(seed)
    alloc = (rng.choice([32_000.0, 64_000.0], (n, 1)) * np.array([1.0, 4.0])).astype(np.float32)
    est_used = (alloc * rng.uniform(0.1, 0.6, (n, 1))).astype(np.float32)
    nodes = dict(
        allocatable=alloc,
        estimated_used=est_used,
        prod_used=(est_used * np.float32(0.6)).astype(np.float32),
        metric_fresh=rng.random(n) > 0.1,
        cpu_amp=np.where(rng.random(n) < 0.3, 2.0, 1.0).astype(np.float32),
        custom_thresholds=np.where(
            rng.random((n, 1)) < 0.2, np.array([[70.0, 0.0]]), 0.0
        ).astype(np.float32),
    )
    cpu = rng.choice([500.0, 1000.0, 2000.0, 4000.0], p)
    req = np.stack([cpu, cpu * rng.choice([2, 4, 8], p)], 1).astype(np.float32)
    prio = rng.integers(5000, 9999, p).astype(np.int32)
    pods = dict(
        requests=req,
        estimate=(req * np.array([0.85, 0.7], np.float32)).astype(np.float32),
        priority=prio,
        is_prod=prio >= 8000,
        qos=np.where(rng.random(p) < 0.3, 4, 0).astype(np.int8),
    )
    params = dict(
        usage_thresholds=np.array([65.0, 95.0], np.float32),
        prod_thresholds=np.array([50.0, 0.0], np.float32),
        score_weights=np.ones(2, np.float32),
    )
    return nodes, pods, params


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assign_one_round_matches_reference(seed, approx):
    nodes, pods, params = one_round_fixture(seed)
    jr = J.assign(
        J.PodBatch.create(**pods), J.NodeState.create(**nodes),
        J.SolverParams(**{k: jnp.asarray(v) for k, v in params.items()}),
        max_rounds=1, approx_topk=approx,
    )
    tr = to_numpy(T.assign(
        from_numpy(T.PodBatch, device="cpu", **pods),
        from_numpy(T.NodeState, device="cpu", **nodes),
        from_numpy(T.SolverParams, device="cpu", **params),
        max_rounds=1, approx_topk=approx,
    ))
    assert tr["rounds_used"] == 1 and (tr["assignment"] >= 0).sum() > 20
    for f in ("assignment", "node_requested", "node_estimated_used", "node_prod_used"):
        np.testing.assert_array_equal(bits(getattr(jr, f)), bits(tr[f]))
