"""ElasticQuota admission: the port's plain quota programs against the JAX
package on the CPU.

The same numpy inputs go through ``koordinator_tpu.ops.solver``'s
``_quota_headroom``, ``_quota_commit`` (under ``jax.jit``, as ``assign``
runs them, so XLA applies the same rewrites) and ``enforce_gangs``, and
through ``koordinator_tpu_torch.ops.quota``; then ``assign`` and
``solve_stream`` with quotas end to end. Both of ``_quota_commit``'s
static branches are covered, with the pair Q·D = 1,024 (one-hot) and
1,026 (sorted). Tolerance: none — the port sums in XLA's order, so every
decision and every table must be bitwise equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from koordinator_tpu.ops import solver as J
from koordinator_tpu_torch.ops import commit as TC
from koordinator_tpu_torch.ops import quota as TQ
from koordinator_tpu_torch.ops import solver as T
from koordinator_tpu_torch.ops.convert import from_jax

torch.set_num_threads(1)
torch.use_deterministic_algorithms(True)


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_bits_equal(want, got, what=""):
    np.testing.assert_array_equal(bits(want), bits(got), err_msg=what)


@jax.jit
def jax_headroom(req, chain, runtime, used):
    return J._quota_headroom(req, chain, J.QuotaState(runtime=runtime, used=used))


@jax.jit
def jax_commit(accepted, req, chain, runtime, used):
    return J._quota_commit(accepted, req, chain, J.QuotaState(runtime=runtime, used=used))


def quota_case(seed, p, q, d, levels=4, fill=0.6, open_levels=0.15):
    """Random chains over a [Q, D] tree whose runtime binds: requests of
    varied magnitude (the sums' rounding matters), -1 levels, a used table
    partly filled, accepted flags."""
    rng = np.random.default_rng(seed)
    req = (rng.choice([250.0, 500.0, 1000.0, 4000.0], (p, d))
           * rng.uniform(0.5, 1.7, (p, d))).astype(np.float32)
    chain = rng.integers(0, q, (p, levels)).astype(np.int32)
    chain[rng.random((p, levels)) < open_levels] = -1
    runtime = (req.sum(0) / q * rng.uniform(0.5, 4.0, (q, d))).astype(np.float32)
    used = (runtime * rng.uniform(0.0, fill, (q, d))).astype(np.float32)
    accepted = rng.random(p) < 0.8
    return accepted, req, chain, runtime, used


def torch_of(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ------------------------------------------------------------------ the gate


@pytest.mark.parametrize("seed, p, q, d", [(0, 64, 21, 2), (1, 256, 1057, 2), (2, 40, 5, 3)])
def test_headroom_matches_reference(seed, p, q, d):
    _, req, chain, runtime, used = quota_case(seed, p, q, d, fill=0.97)
    want = jax_headroom(req, chain, runtime, used)
    got = TQ.quota_headroom(*torch_of(req, chain, runtime, used))
    assert_bits_equal(want, got.numpy())
    assert 0 < int(got.sum()) < p


def test_headroom_eps_boundary_inf_and_open_levels():
    """used + request lands exactly on runtime + EPS (in float32), a hair
    above it, on an infinite runtime, and behind open (-1) levels only."""
    eps = np.float32(1e-3)
    req = np.array([[1.0, 2.0]] * 5, np.float32)
    runtime = np.array([[1.0, 2.0], [1.0, 2.0], [np.inf, 2.0], [0.0, 0.0]], np.float32)
    used = np.array([[eps, 0.0], [np.float32(2e-3), 0.0], [1e30, 0.0], [5.0, 5.0]], np.float32)
    chain = np.array([[0, -1], [1, -1], [2, -1], [-1, -1], [3, 0]], np.int32)
    want = np.asarray(jax_headroom(req, chain, runtime, used))
    got = TQ.quota_headroom(*torch_of(req, chain, runtime, used)).numpy()
    assert_bits_equal(want, got)
    assert got.tolist() == [True, False, True, True, False]


def test_gate_is_active_and_headroom():
    accepted, req, chain, runtime, used = quota_case(3, 50, 9, 2, fill=0.95)
    gate = torch.empty(50, dtype=torch.bool)
    active = torch.from_numpy(accepted)
    TQ.quota_gate(active, *torch_of(req, chain, runtime, used), gate)
    want = np.asarray(jax_headroom(req, chain, runtime, used)) & accepted
    np.testing.assert_array_equal(gate.numpy(), want)


# ---------------------------------------------------------------- the commit


@pytest.mark.parametrize(
    "seed, p, q, d",
    [(0, 256, 21, 2), (1, 256, 512, 2), (2, 256, 513, 2), (3, 200, 1057, 2),
     (4, 17, 8, 3), (5, 100, 300, 1), (6, 256, 2, 8)],
)
def test_commit_matches_reference(seed, p, q, d):
    case = quota_case(seed, p, q, d)
    jf, ju = jax_commit(*case)
    tf, tu = TQ.quota_commit_plain(*torch_of(*case))
    assert_bits_equal(jf, tf.numpy(), "final")
    assert_bits_equal(ju, tu.numpy(), "new_used")
    # the case must bind: some accepted pods refused, some admitted
    assert 0 < int(tf.sum()) < int(case[0].sum())


def test_branches_split_at_qd_1024():
    """Q·D = 1,024 takes the one-hot branch and 1,026 the sorted one; each
    matches the reference on the same pods (their float order differs)."""
    assert TQ.onehot_branch(512, 2) and not TQ.onehot_branch(513, 2)
    rng = np.random.default_rng(9)
    p = 256
    req = (rng.uniform(1.0, 3.0, (p, 2)) * 10 ** rng.uniform(0, 4, (p, 1))).astype(np.float32)
    chain = np.stack([rng.integers(0, 4, p), np.full(p, 4), np.full(p, -1)], 1).astype(np.int32)
    for q in (512, 513):
        runtime = np.full((q, 2), np.inf, np.float32)
        runtime[:5] = (req.sum(0) * np.array([[0.3], [0.3], [0.3], [0.3], [0.7]])).astype(
            np.float32)
        case = (rng.random(p) < 0.9, req, chain, runtime, np.zeros((q, 2), np.float32))
        jf, ju = jax_commit(*case)
        tf, tu = TQ.quota_commit_plain(*torch_of(*case))
        assert_bits_equal(jf, tf.numpy(), f"final, Q={q}")
        assert_bits_equal(ju, tu.numpy(), f"new_used, Q={q}")


def test_onehot_cumsum_runs_in_xla_chunks():
    """The one-hot branch's cumsum over [P, Q, D] along P is XLA's chunked
    order column by column, zeros of non-members inside the chunks: not a
    sequential sum."""
    rng = np.random.default_rng(4)
    x = (rng.random((300, 7, 2)) * 10 ** rng.uniform(-3, 6, (300, 7, 2))).astype(np.float32)
    x *= rng.random((300, 7, 1)) < 0.3
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=0))(x))
    assert_bits_equal(want, TC._ordered_cumsum(torch.from_numpy(x)).numpy())
    assert not np.array_equal(bits(want), bits(np.cumsum(x, axis=0, dtype=np.float32)))


@pytest.mark.parametrize("q", [6, 700])
def test_deeper_refusal_still_counts_at_shallower_levels(q):
    """Pod 0 fits its team but not the org; pod 1 (same team, later in
    priority) fits the org alone but not after pod 0's request, which the
    reference counts at the team level in the same round even though pod 0
    is refused at the org: both are refused (the conservative prefix)."""
    req = np.array([[4.0, 1.0], [4.0, 1.0]], np.float32)
    chain = np.array([[1, 0], [1, 2]], np.int32)
    runtime = np.full((q, 2), 100.0, np.float32)
    runtime[0] = [3.0, 100.0]     # pod 0's org: too small for it
    runtime[1] = [6.0, 100.0]     # the team: room for one pod
    used = np.zeros((q, 2), np.float32)
    case = (np.array([True, True]), req, chain, runtime, used)
    jf, ju = jax_commit(*case)
    tf, tu = TQ.quota_commit_plain(*torch_of(*case))
    assert_bits_equal(jf, tf.numpy())
    assert_bits_equal(ju, tu.numpy())
    assert tf.tolist() == [False, False]


@pytest.mark.parametrize("q", [4, 600])
def test_commit_eps_boundary_and_inf(q):
    """Cumulative prefixes that land on runtime + EPS in float32, and an
    infinite runtime column."""
    p = 40
    req = np.full((p, 2), 0.25, np.float32)
    chain = np.stack([np.arange(p) % 3, np.full(p, 3)], 1).astype(np.int32)
    runtime = np.full((q, 2), np.inf, np.float32)
    runtime[:3, 0] = np.float32(2.0) - np.float32(1e-3)
    runtime[3] = [np.inf, 5.0]
    case = (np.ones(p, bool), req, chain, runtime, np.zeros((q, 2), np.float32))
    jf, ju = jax_commit(*case)
    tf, tu = TQ.quota_commit_plain(*torch_of(*case))
    assert_bits_equal(jf, tf.numpy())
    assert_bits_equal(ju, tu.numpy())
    assert 0 < int(tf.sum()) < p


# ------------------------------------------------- round tail, gangs, solve


def test_round_that_node_accepts_but_admits_none_ends_the_loop():
    """Nodes accept both pods, their quota refuses both: nothing is
    assigned or charged, progress is any(final) (solver.py:1446), so the
    round sets done; the gate closes."""
    p, n = 2, 4
    top_cost = torch.tensor([[0.0, 1.0], [0.0, 1.0]])
    top_idx = torch.tensor([[0, 1], [1, 0]], dtype=torch.int32)
    req = torch.tensor([[1.0, 1.0], [1.0, 1.0]])
    alloc = torch.full((n, 2), 100.0)
    tables = [torch.zeros(n, 2) for _ in range(3)]
    assigned = torch.full((p,), -1, dtype=torch.int32)
    active = torch.ones(p, dtype=torch.bool)
    state = torch.zeros(2, dtype=torch.int32)
    chain = torch.tensor([[0, -1], [0, -1]], dtype=torch.int32)
    runtime = torch.tensor([[0.5, 100.0]])
    used = torch.zeros(1, 2)
    gate = torch.ones(p, dtype=torch.bool)
    thr = torch.zeros(n, 2)
    TC.round_tail(top_cost, top_idx, req, req, torch.zeros(p, dtype=torch.bool),
                  torch.zeros(p, dtype=torch.bool), torch.ones(n), alloc,
                  torch.ones(n, dtype=torch.bool), thr, thr, *tables, assigned, active, state,
                  1.0, quota=(chain, runtime, used, gate))
    assert assigned.tolist() == [-1, -1] and active.tolist() == [True, True]
    assert state.tolist() == [1, 1]
    assert not gate.any() and not used.any() and not any(t.any() for t in tables)


def gang_result(seed, q, levels=4):
    rng = np.random.default_rng(seed)
    p, n, d = 96, 12, 2
    req = rng.uniform(100.0, 900.0, (p, d)).astype(np.float32)
    chain = rng.integers(-1, q, (p, levels)).astype(np.int32)
    gang = np.where(rng.random(p) < 0.6, rng.integers(0, 5, p), -1).astype(np.int32)
    gmin = np.zeros(p, np.int32)
    gmin[:5] = rng.integers(5, 40, 5)
    asg = np.where(rng.random(p) < 0.85, rng.integers(0, n, p), -1).astype(np.int32)
    pods = J.PodBatch.create(requests=req, priority=np.zeros(p, np.int32), quota_chain=chain,
                             gang_id=gang, gang_min=gmin)
    used = rng.uniform(1e4, 1e6, (q, d)).astype(np.float32)
    res = J.SolveResult(
        assignment=jnp.asarray(asg), node_requested=jnp.asarray(rng.uniform(1e4, 1e5, (n, d)),
                                                                  jnp.float32),
        node_estimated_used=jnp.zeros((n, d)), node_prod_used=jnp.zeros((n, d)),
        quota_used=jnp.asarray(used), rounds_used=jnp.int32(0),
    )
    return pods, res


@pytest.mark.parametrize("q", [1, 7, 600])
def test_enforce_gangs_refunds_quotas(q):
    pods, res = gang_result(q, q)
    want = J.enforce_gangs(res, pods)
    tp = from_jax(T.PodBatch, pods, device="cpu")
    got = T.enforce_gangs(from_jax(T.SolveResult, res, device="cpu"), tp)
    for f in ("assignment", "node_requested", "quota_used"):
        assert_bits_equal(getattr(want, f), getattr(got, f).numpy(), f)
    rolled = int(((np.asarray(res.assignment) >= 0) & (got.assignment.numpy() < 0)).sum())
    assert rolled > 0
    # Q == 1 is the disabled sentinel: nothing refunded
    changed = not np.array_equal(bits(res.quota_used), bits(got.quota_used.numpy()))
    assert changed == (q > 1)


def solver_inputs(seed, o, t, n_nodes=256, n_pods=2048, batch=256):
    """``chip_smoke``'s quota recipe on a small rich fixture of ``n_pods``
    pods in batches of ``batch``: numpy (nodes, pods, params) and both
    sides' quotas. At 2,048 pods the 32 x 32 tree's teams have room for
    about one pod and a half each, so both trees bind and admit."""
    fixture = chip_smoke.rich_fixture(seed, n_nodes, n_pods, batch=batch)
    tree = next(k for k, v in chip_smoke.QUOTA_TREES.items() if v == (o, t))
    nodes, pods, params, (runtime, used), _ = chip_smoke.quota_fixture(tree, *fixture)
    jq = J.QuotaState(runtime=jnp.asarray(runtime), used=jnp.asarray(used))
    tq = T.QuotaState(runtime=torch.from_numpy(runtime), used=torch.from_numpy(used))
    return nodes, pods, params, jq, tq


@pytest.mark.parametrize("shortlist_k", [None, 16])
@pytest.mark.parametrize("tree", [(4, 4), (32, 32)])
def test_assign_with_quotas_matches_reference(tree, shortlist_k):
    nodes, pods, params, jq, tq = solver_inputs(0, *tree)
    # the first batch of the fixture, whose quota tree all 2,048 pods made
    jp = J.PodBatch.create(**{k: v[:256] for k, v in pods.items()})
    jn = J.NodeState.create(**nodes)
    jpar = J.SolverParams(**{k: jnp.asarray(v) for k, v in params.items()})
    want = J.assign(jp, jn, jpar, quotas=jq, max_rounds=12, approx_topk=True,
                    shortlist_k=shortlist_k)
    got = T.assign(from_jax(T.PodBatch, jp, device="cpu"), from_jax(T.NodeState, jn, device="cpu"),
                   from_jax(T.SolverParams, jpar, device="cpu"), quotas=tq, max_rounds=12,
                   approx_topk=True, shortlist_k=shortlist_k)
    for f in ("assignment", "node_requested", "node_estimated_used", "node_prod_used",
              "quota_used", "rounds_used", "shortlist_fallbacks"):
        assert_bits_equal(getattr(want, f), getattr(got, f).numpy(), f)
    assert 0 < int((got.assignment >= 0).sum()) < 256
    assert not np.array_equal(bits(got.quota_used.numpy()), bits(tq.used.numpy()))


@pytest.mark.parametrize("tree", [(4, 4), (32, 32)])
def test_solve_stream_with_quotas_matches_reference(tree):
    nodes, pods, params, jq, tq = solver_inputs(1, *tree)
    jp = jax.tree.map(lambda a: a.reshape((-1, 256) + a.shape[1:]), J.PodBatch.create(**pods))
    jn = J.NodeState.create(**nodes)
    jpar = J.SolverParams(**{k: jnp.asarray(v) for k, v in params.items()})
    wa, wn, wp, wq = J.solve_stream(jp, jn, jpar, quotas=jq, **chip_smoke.SOLVE)
    ga, gn, gp, gq = T.solve_stream(
        from_jax(T.PodBatch, jp, device="cpu"), from_jax(T.NodeState, jn, device="cpu"),
        from_jax(T.SolverParams, jpar, device="cpu"), quotas=tq, **chip_smoke.SOLVE,
    )
    assert_bits_equal(wa, ga.numpy(), "assignments")
    assert_bits_equal(wp, gp.numpy(), "placed")
    for f in ("requested", "estimated_used", "prod_used"):
        assert_bits_equal(getattr(wn, f), getattr(gn, f).numpy(), f)
    assert_bits_equal(wq.used, gq.used.numpy(), "quota used")
    assert_bits_equal(wq.runtime, gq.runtime.numpy(), "quota runtime")
    # the caller's quota table is not written
    assert not tq.used.any()


@pytest.mark.parametrize(
    "q, p, levels, folds",
    [(21, 64, 4, "1010"), (512, 64, 4, "1111"), (512, 128, 4, "1110"), (512, 256, 4, "1010"),
     (513, 256, 4, "1101"), (1024, 512, 4, "1010"), (1057, 512, 4, "1101"),
     (1057, 256, 4, "1111"), (300, 100, 3, "110")],
)
def test_quota_table_sums_in_xla_merge_order(q, p, levels, folds):
    """The order the round's charges land on the quota table is XLA's:
    levels folded into scatter-adds onto the running table or summed apart
    and added, with scatters merged while their rows stay fewer than Q
    (``quota.charge_folds``) — checked on long segments over a large base,
    where any other order changes bits, through ``assign`` itself."""
    assert "".join("1" if f else "0" for f in TQ.charge_folds(p, q, levels)) == folds
    rng = np.random.default_rng(q + p)
    d, n = 2, 32
    req = (rng.choice([500.0, 1000.0, 2000.0, 4000.0], (p, d))
           * rng.uniform(0.5, 1.5, (p, d))).astype(np.float32)
    chain = rng.integers(0, min(q, 5), (p, levels)).astype(np.int32)
    runtime = np.full((q, d), 1e12, np.float32)
    used = rng.uniform(1e6, 1e8, (q, d)).astype(np.float32)
    pods = J.PodBatch.create(requests=req, priority=rng.integers(0, 100, p).astype(np.int32),
                             quota_chain=chain)
    nodes = J.NodeState.create(allocatable=np.full((n, d), 1e7, np.float32))
    params = J.SolverParams(usage_thresholds=jnp.zeros(d), prod_thresholds=jnp.zeros(d),
                            score_weights=jnp.ones(d))
    kw = dict(max_rounds=1, round_quantum=1.0, approx_topk=True)
    want = J.assign(pods, nodes, params, quotas=J.QuotaState(runtime=jnp.asarray(runtime),
                                                            used=jnp.asarray(used)), **kw)
    got = T.assign(from_jax(T.PodBatch, pods, device="cpu"),
                   from_jax(T.NodeState, nodes, device="cpu"),
                   from_jax(T.SolverParams, params, device="cpu"),
                   quotas=T.QuotaState(runtime=torch.from_numpy(runtime),
                                       used=torch.from_numpy(used)), **kw)
    assert_bits_equal(want.assignment, got.assignment.numpy(), "assignment")
    assert_bits_equal(want.quota_used, got.quota_used.numpy(), "quota_used")
    assert int((got.assignment >= 0).sum()) == p
