"""NUMA zones through the solver: the port against the JAX package on the
CPU.

The same numpy inputs (``chip_smoke.rich_fixture`` with
``chip_smoke.zone_tables``' zones and required pods) go through
``assign(numa=...)`` with and without an aligned score and the candidate
shortlist, ``shortlist_plan(numa=...)``, ``enforce_gangs`` on a result
whose Strict gang rolls back pods that hold zones, and
``solve_stream_full(numa=...)`` across chunks (the zone table carried),
in ``koordinator_tpu.ops.solver`` and ``koordinator_tpu_torch.ops.solver``.
The committed NUMA golden (``tests/data/torch_golden_numa.npz``) holds the
reference's streams, and the port must reproduce its small part.
Tolerance: none — assignments, zones, rounds, fallback counts and tables
are bitwise equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from koordinator_tpu.ops import numa as JN
from koordinator_tpu.ops import solver as J
from koordinator_tpu_torch.ops import numa as TN
from koordinator_tpu_torch.ops import solver as T
from koordinator_tpu_torch.ops.convert import from_jax, from_numpy
from tools import make_torch_golden

torch.set_num_threads(1)
torch.use_deterministic_algorithms(True)

RESULT_FIELDS = ("assignment", "node_requested", "node_estimated_used", "node_prod_used",
                 "rounds_used", "node_zone_free", "pod_zone", "pod_zone_charge",
                 "shortlist_fallbacks")


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_bits_equal(want, got, what=""):
    np.testing.assert_array_equal(bits(want), bits(got), err_msg=what)


def numa_case(seed, n=160, p=128, batch=None):
    """A rich fixture with zone tables and required pods; pods stacked
    [C, batch] when ``batch`` is given. Returns the JAX and port inputs
    ((pods, nodes, params, numa) each)."""
    nodes, pods, params = chip_smoke.rich_fixture(seed, n, p, batch=batch or p)
    nodes, numa, required = chip_smoke.zone_tables(seed, nodes, p)
    jp = J.PodBatch.create(**dict(pods, numa_required=required))
    if batch is not None:
        jp = jax.tree.map(lambda a: a.reshape((-1, batch) + a.shape[1:]), jp)
    jn = J.NodeState.create(**nodes)
    jpar = J.SolverParams(**{k: jnp.asarray(v) for k, v in params.items()})
    jnuma = JN.NumaState(**{k: jnp.asarray(v) for k, v in numa.items()})
    port = (from_jax(T.PodBatch, jp, device="cpu"), from_jax(T.NodeState, jn, device="cpu"),
            from_jax(T.SolverParams, jpar, device="cpu"), from_jax(TN.NumaState, jnuma,
                                                                   device="cpu"))
    return (jp, jn, jpar, jnuma), port


@pytest.mark.parametrize("scoring", [None, "LeastAllocated", "MostAllocated"])
@pytest.mark.parametrize("k", [None, 64])
def test_assign_with_numa_matches_reference(scoring, k):
    (jp, jn, jpar, jnuma), (tp, tn, tpar, tnuma) = numa_case(1)
    kw = dict(numa_scoring=scoring, shortlist_k=k, max_rounds=12, approx_topk=True)
    want = J.assign(jp, jn, jpar, numa=jnuma, **kw)
    got = T.assign(tp, tn, tpar, numa=tnuma, **kw)
    for f in RESULT_FIELDS:
        assert_bits_equal(getattr(want, f), getattr(got, f).numpy(), f)
    zones = got.pod_zone.numpy()
    assert (zones >= 0).sum() > 10 and (got.assignment.numpy() >= 0).sum() > (zones >= 0).sum()


def test_assign_numa_carry_matches_reference():
    """A zone table carried in from a previous batch replaces the state's."""
    (jp, jn, jpar, jnuma), (tp, tn, tpar, tnuma) = numa_case(2)
    carry = np.asarray(jnuma.zone_free) * np.float32(0.5)
    want = J.assign(jp, jn, jpar, numa=jnuma, numa_carry=jnp.asarray(carry))
    got = T.assign(tp, tn, tpar, numa=tnuma, numa_carry=torch.from_numpy(carry))
    for f in RESULT_FIELDS:
        assert_bits_equal(getattr(want, f), getattr(got, f).numpy(), f)


@pytest.mark.parametrize("scoring", [None, "LeastAllocated", "MostAllocated"])
def test_shortlist_plan_with_numa_matches_reference(scoring):
    (jp, jn, jpar, jnuma), (tp, tn, tpar, tnuma) = numa_case(3)
    want = J.shortlist_plan(jp, jn, jpar, numa=jnuma, numa_scoring=scoring, shortlist_k=16)
    got = T.shortlist_plan(tp, tn, tpar, numa=tnuma, numa_scoring=scoring, shortlist_k=16)
    assert_bits_equal(want[0], got[0].numpy(), "plan_cand")
    assert_bits_equal(want[1], got[1].numpy(), "plan_bound")


def test_enforce_gangs_refunds_zones_of_a_rolled_back_gang():
    """A Strict gang that falls short: its members' zone charges go back to
    their zones (row by row, the refund's order) and their picks clear."""
    (jp, jn, jpar, jnuma), (tp, tn, tpar, tnuma) = numa_case(4)
    free_j = jp.replace(gang_id=jnp.full_like(jp.gang_id, -1))
    res = J.assign(free_j, jn, jpar, numa=jnuma)
    zoned = np.asarray(res.pod_zone) >= 0
    pick = zoned & (np.arange(zoned.shape[0]) % 2 == 0)
    gang_id = np.where(pick, 0, np.asarray(jp.gang_id)).astype(np.int32)
    gang_min = np.asarray(jp.gang_min).copy()
    gang_min[0] = zoned.shape[0] + 1
    gang_ns = np.asarray(jp.gang_nonstrict).copy()
    gang_ns[0] = False
    gangs = jp.replace(gang_id=jnp.asarray(gang_id), gang_min=jnp.asarray(gang_min),
                       gang_nonstrict=jnp.asarray(gang_ns))
    want = J.enforce_gangs(res, gangs)
    got = T.enforce_gangs(from_jax(T.SolveResult, res, device="cpu"),
                          from_jax(T.PodBatch, gangs, device="cpu"))
    for f in ("assignment", "node_requested", "node_estimated_used", "node_prod_used",
              "node_zone_free", "pod_zone"):
        assert_bits_equal(getattr(want, f), getattr(got, f).numpy(), f)
    rolled = (np.asarray(res.assignment) >= 0) & (got.assignment.numpy() < 0)
    assert (rolled & zoned).sum() >= 5
    assert not np.array_equal(got.node_zone_free.numpy(), np.asarray(res.node_zone_free))


@pytest.mark.parametrize("scoring", [None, "LeastAllocated"])
@pytest.mark.parametrize("k", [None, 64])
def test_solve_stream_full_with_numa_matches_reference(scoring, k):
    (jp, jn, jpar, jnuma), (tp, tn, tpar, tnuma) = numa_case(5, n=160, p=256, batch=64)
    kw = dict(numa_scoring=scoring, shortlist_k=k, max_rounds=12, approx_topk=True)
    want = J.solve_stream_full(jp, jn, jpar, numa=jnuma, **kw)
    zone_free = torch.empty_like(tnuma.zone_free)
    got = T.solve_stream_full(tp, tn, tpar, numa=tnuma, zone_free_out=zone_free, **kw)
    for name, w, g in zip(("assignments", "pod_zones", "rounds", "fallbacks"), want, got):
        assert_bits_equal(w, g.numpy(), name)
    ref = make_torch_golden.numa_stream_full(jp, jn, jpar, jnuma, scoring, k)
    assert_bits_equal(ref[4], zone_free.numpy(), "zone carry")
    # later chunks price from the zone table the earlier ones charged
    assert (got[1].numpy()[1:] >= 0).sum() > 0


def crowded_zone_case(p=48, seed=9):
    """A scaled-down crowded zone round (``chip_smoke.crowded_zone_inputs``
    at a few dozen pods): six nodes of which four are schedulable,
    SINGLE_NUMA_NODE, with room for every pod (so every row of their
    segments is a zone candidate, about p / 4 a segment) and small zones,
    two with two zones and two with four, two MostAllocated; the fixture's
    cpuset-bound and required pods among the others; no gangs. Returns the
    JAX and port inputs as :func:`numa_case`."""
    nodes, pods, params = chip_smoke.rich_fixture(seed, 6, p, batch=p)
    rng = np.random.default_rng(seed)
    pods["gang_id"] = np.full(p, -1, np.int32)
    nodes["schedulable"] = np.array([True] * 4 + [False] * 2)
    nodes["allocatable"] = nodes["allocatable"].copy()
    nodes["allocatable"][:4] = 1e6
    cap = np.zeros((6, 4, 2), np.float32)
    cap[[0, 1, 4, 5], :2] = (8000.0, 32000.0)
    cap[2:4] = (4000.0, 16000.0)
    numa = dict(zone_free=(cap * rng.uniform(0.2, 0.7, (6, 4, 1))).astype(np.float32),
                zone_cap=cap, policy=np.array([3, 3, 3, 3, 0, 0], np.int8),
                zone_most=np.array([True, False, True, False, False, False]))
    required = rng.random(p) < 0.2
    jp = J.PodBatch.create(**dict(pods, numa_required=required))
    jn = J.NodeState.create(**nodes)
    jpar = J.SolverParams(**{k: jnp.asarray(v) for k, v in params.items()})
    jnuma = JN.NumaState(**{k: jnp.asarray(v) for k, v in numa.items()})
    port = (from_jax(T.PodBatch, jp, device="cpu"), from_jax(T.NodeState, jn, device="cpu"),
            from_jax(T.SolverParams, jpar, device="cpu"), from_jax(TN.NumaState, jnuma,
                                                                   device="cpu"))
    return (jp, jn, jpar, jnuma), port


@pytest.mark.parametrize("rounds", [1, 3])
@pytest.mark.parametrize("scoring", [None, "LeastAllocated"])
def test_crowded_zone_round_matches_reference(rounds, scoring):
    """Every pod on four SINGLE_NUMA_NODE nodes (:func:`crowded_zone_case`):
    the round tail's zone phase refuses each segment's candidates past the
    fourth, and those of the first four that find no zone; the port's
    rounds equal the reference's, tables and picks bitwise."""
    (jp, jn, jpar, jnuma), (tp, tn, tpar, tnuma) = crowded_zone_case()
    kw = dict(numa_scoring=scoring, max_rounds=rounds, approx_topk=True)
    want = J.assign(jp, jn, jpar, numa=jnuma, **kw)
    got = T.assign(tp, tn, tpar, numa=tnuma, **kw)
    for f in RESULT_FIELDS:
        assert_bits_equal(getattr(want, f), getattr(got, f).numpy(), f)
    if rounds == 1:
        per_node = np.bincount(got.assignment.numpy()[got.assignment.numpy() >= 0], minlength=4)
        # the rank cut (segments of ~12 candidates, 4 winners at most) and
        # a strict candidate of the first four refused for want of a zone
        assert per_node.max() == 4 and per_node[:4].min() < 4
        assert (got.pod_zone.numpy() >= 0).sum() == (got.assignment.numpy() >= 0).sum()


# -------------------------------------------------------------- the golden

NUMA_KEYS = [f"{(s or 'none').lower()}_k{k or 0}" for s in chip_smoke.NUMA_SCORINGS
             for k in (chip_smoke.SHORTLIST_K, None)]


def test_numa_golden_file_holds_the_reference():
    """The committed NUMA golden's small part is what the JAX package gives
    now (the full-size digests are checked on the card)."""
    gold = np.load(chip_smoke.GOLDEN_NUMA)
    small = make_torch_golden.numa_fixture_small()
    assert str(gold["fixture_sha256"]) == chip_smoke.fixture_digest(*small)
    assert str(gold["full_fixture_sha256"]) == chip_smoke.fixture_digest(
        *make_torch_golden.numa_fixture_full())
    fresh = make_torch_golden.numa_streams(*small, chip_smoke.BATCH)
    for key in NUMA_KEYS:
        for i, f in enumerate(("assignments", "pod_zones", "rounds", "fallbacks", "zone_free")):
            assert_bits_equal(fresh[key][i], gold[f"{key}_{f}"], f"{key}_{f}")


@pytest.mark.parametrize("key", NUMA_KEYS)
def test_numa_golden_small_streams_on_the_plain_path(key):
    """The port's plain path reproduces the golden's small streams:
    assignments, zone picks, rounds, fallback counts and the final zone
    table."""
    gold = np.load(chip_smoke.GOLDEN_NUMA)
    nodes, pods, numa, params = make_torch_golden.numa_fixture_small()
    scoring = next(s for s in chip_smoke.NUMA_SCORINGS if key.startswith((s or "none").lower()))
    k = chip_smoke.SHORTLIST_K if key.endswith(f"k{chip_smoke.SHORTLIST_K}") else None
    tnuma = TN.NumaState.create(**numa, device="cpu")
    zone_free = torch.empty_like(tnuma.zone_free)
    got = T.solve_stream_full(
        from_numpy(T.PodBatch, device="cpu", **chip_smoke.stacked(pods)),
        from_numpy(T.NodeState, device="cpu", **nodes),
        from_numpy(T.SolverParams, device="cpu", **params), numa=tnuma, numa_scoring=scoring,
        shortlist_k=k, zone_free_out=zone_free, **chip_smoke.SOLVE,
    )
    for name, g in zip(("assignments", "pod_zones", "rounds", "fallbacks"), got):
        assert_bits_equal(gold[f"{key}_{name}"], g.numpy(), name)
    assert_bits_equal(gold[f"{key}_zone_free"], zone_free.numpy(), "zone_free")
