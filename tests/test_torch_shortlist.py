"""The port's candidate shortlist against the JAX package on the CPU.

Same inputs into ``koordinator_tpu`` and ``koordinator_tpu_torch``: the
``_cols`` masks and cost, the shortlist build (``shortlist_plan``), the
shortlisted ``assign`` and ``solve_stream`` and the committed shortlist
golden must be bitwise equal, ``shortlist_fallbacks`` included (tolerance:
none — a pair is priced with the same float operations in the same order
on both sides). The ``assign`` cases are the LoadAware subset of
``tests/test_shortlist.py``: the "plain" combo, the gang identity case, the
contention case whose rounds fall back, and K >= N.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import test_shortlist as ref_cases
from koordinator_tpu.ops import costs as JC
from koordinator_tpu.ops import masks as JM
from koordinator_tpu.ops import solver as J
from koordinator_tpu_torch.ops import costs as TC
from koordinator_tpu_torch.ops import device as TD
from koordinator_tpu_torch.ops import masks as TM
from koordinator_tpu_torch.ops import nominate as TN
from koordinator_tpu_torch.ops import numa as TZ
from koordinator_tpu_torch.ops import shortlist as TS
from koordinator_tpu_torch.ops import solver as T
from koordinator_tpu_torch.ops.convert import from_jax, from_numpy
from tools import make_torch_golden

torch.set_num_threads(1)
torch.use_deterministic_algorithms(True)

#: the port's fields among ``tests/test_shortlist.py``'s DECISION_FIELDS
#: (all of them: the device and NUMA ones are the reference's
#: placeholders), plus the fallback counts
FIELDS = ref_cases.DECISION_FIELDS + ("shortlist_fallbacks",)


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_bits_equal(want, got, fields):
    for f in fields:
        a, b = getattr(want, f), got[f] if isinstance(got, dict) else getattr(got, f)
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=f)


def port_of(pods, nodes, params):
    return (
        from_jax(T.PodBatch, pods, device="cpu"),
        from_jax(T.NodeState, nodes, device="cpu"),
        from_jax(T.SolverParams, params, device="cpu"),
    )


def jax_params(params):
    return J.SolverParams(**{k: jnp.asarray(v) for k, v in params.items()})


# ------------------------------------------------------------ _cols forms


def cols_case(seed, p=24, n=40, k=8, custom=True):
    rng = np.random.default_rng(seed)
    alloc = rng.choice([0.0, 32.0, 64.0, 96.0], (n, 2), p=[0.05, 0.3, 0.3, 0.35])
    used = alloc * rng.uniform(0.0, 1.1, (n, 2))
    # x.5 percents: the rounding boundary (floor(x + 0.5))
    used[:4] = alloc[:4] * np.array([0.645, 0.705])[None, :]
    thr_custom = np.where(rng.random((n, 1)) < 0.4, rng.choice([0.0, 50.0, 70.0], (n, 2)), 0.0)
    cand = np.sort(np.stack([rng.choice(n, k, replace=False) for _ in range(p)]), axis=1)
    return dict(
        req=rng.choice([1.0, 2.0, 8.0, 40.0], (p, 2)).astype(np.float32),
        est=rng.uniform(0.0, 30.0, (p, 2)).astype(np.float32),
        is_prod=rng.random(p) < 0.5,
        alloc=alloc.astype(np.float32),
        requested=(alloc * rng.uniform(0.0, 1.0, (n, 2))).astype(np.float32),
        used=used.astype(np.float32),
        fresh=rng.random(n) > 0.2,
        thr=np.array([65.0, 0.0], np.float32),
        custom=thr_custom.astype(np.float32) if custom else None,
        weights=np.array([1.0, 2.0], np.float32),
        cand=cand.astype(np.int32),
    )


@pytest.mark.parametrize("custom", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cols_masks_and_cost_match_reference(seed, custom):
    c = cols_case(seed, custom=custom)
    cand = c["cand"]

    def cols(x):
        return x[cand]

    j = {k: (None if v is None else jnp.asarray(v)) for k, v in c.items()}
    t = {k: (None if v is None else torch.from_numpy(v)) for k, v in c.items()}
    jcols = {k: (None if c[k] is None else jnp.asarray(cols(c[k])))
             for k in ("alloc", "requested", "used", "fresh", "custom")}
    tcols = {k: (None if v is None else torch.from_numpy(np.array(v))) for k, v in jcols.items()}
    free_j, free_t = jcols["alloc"] - jcols["requested"], tcols["alloc"] - tcols["requested"]
    pairs = (
        (JM.fit_mask_cols(j["req"], free_j), TM.fit_mask_cols(t["req"], free_t)),
        (JM.effective_thresholds_cols(j["thr"], jcols["custom"]),
         TM.effective_thresholds_cols(t["thr"], tcols["custom"])),
        (JM.usage_threshold_mask_cols(j["est"], jcols["used"], jcols["alloc"], j["thr"],
                                      jcols["fresh"], node_custom=jcols["custom"]),
         TM.usage_threshold_mask_cols(t["est"], tcols["used"], tcols["alloc"], t["thr"],
                                      tcols["fresh"], node_custom=tcols["custom"])),
        (JM.prod_usage_threshold_mask_cols(j["is_prod"], j["est"], jcols["used"], jcols["alloc"],
                                           j["thr"], jcols["fresh"], node_custom=jcols["custom"]),
         TM.prod_usage_threshold_mask_cols(t["is_prod"], t["est"], tcols["used"], tcols["alloc"],
                                           t["thr"], tcols["fresh"], node_custom=tcols["custom"])),
        (JC.load_aware_cost_cols(j["est"], jcols["used"], jcols["alloc"], j["weights"],
                                 metric_fresh=jcols["fresh"]),
         TC.load_aware_cost_cols(t["est"], tcols["used"], tcols["alloc"], t["weights"],
                                 metric_fresh=tcols["fresh"])),
    )
    for i, (want, got) in enumerate(pairs):
        np.testing.assert_array_equal(bits(want), bits(got.numpy()), err_msg=str(i))
    # every (pod, candidate) pair gets the bits of the full-axis form
    full = (
        TM.fit_mask(t["req"], t["alloc"] - t["requested"]),
        TM.usage_threshold_mask(t["est"], t["used"], t["alloc"], t["thr"], t["fresh"],
                                node_custom=t["custom"]),
        TC.load_aware_cost(t["est"], t["used"], t["alloc"], t["weights"],
                           metric_fresh=t["fresh"]),
    )
    for f, got in zip(full, (pairs[0][1], pairs[2][1], pairs[4][1])):
        np.testing.assert_array_equal(
            bits(np.take_along_axis(f.numpy(), cand, axis=1)), bits(got.numpy())
        )


# ------------------------------------------------------------ build


def build_case(name):
    """JAX (pods, nodes, params) for a build case."""
    if name.startswith("rich"):
        return ref_cases.rich_fixture(seed=int(name[-1]))[:3]
    rng = np.random.default_rng(3)
    p, n = 40, 30
    alloc = np.full((n, 2), 64.0, np.float32)
    req = np.full((p, 2), 2.0, np.float32)
    if name == "few_feasible":
        # most nodes are small: the large pods' rows have fewer than K+1
        # feasible nodes
        req = rng.choice([2.0, 30.0], (p, 1)).astype(np.float32) * np.ones((1, 2), np.float32)
        alloc[: n - 5] = 20.0
    if name == "ties":
        # identical nodes: every feasible pair of a pod ties on cost
        used = np.full((n, 2), 16.0, np.float32)
    else:
        used = (alloc * rng.uniform(0.1, 0.6, (n, 2))).astype(np.float32)
    sched = np.ones(n, bool)
    fresh = np.ones(n, bool)
    if name == "stale_unschedulable":
        sched[rng.random(n) < 0.3] = False
        fresh[rng.random(n) < 0.3] = False
    pods = J.PodBatch.create(
        requests=req, priority=rng.integers(5000, 9999, p).astype(np.int32),
        estimate=req * np.float32(0.85), qos=rng.choice([0, 3], p).astype(np.int8),
        valid=rng.random(p) > 0.1,
    )
    nodes = J.NodeState.create(
        allocatable=alloc, estimated_used=used, prod_used=used * np.float32(0.5),
        metric_fresh=fresh, schedulable=sched,
        cpu_amp=np.where(rng.random(n) < 0.3, 1.5, 1.0).astype(np.float32),
    )
    params = jax_params(dict(
        usage_thresholds=np.array([70.0, 90.0], np.float32),
        prod_thresholds=np.array([60.0, 0.0], np.float32),
        score_weights=np.ones(2, np.float32),
    ))
    return pods, nodes, params


@pytest.mark.parametrize("jitter", [4.0, 0.0])
@pytest.mark.parametrize("case", ["rich0", "rich1", "rich2", "ties", "few_feasible",
                                  "stale_unschedulable"])
def test_build_plain_matches_shortlist_plan(case, jitter):
    pods, nodes, params = build_case(case)
    k = 8
    jc, jb = J.shortlist_plan(pods, nodes, params, shortlist_k=k, nomination_jitter=jitter)
    tp, tn, tpar = port_of(pods, nodes, params)
    tc, tb = T.shortlist_plan(tp, tn, tpar, shortlist_k=k, nomination_jitter=jitter)
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(bits(jb), bits(tb.numpy()))
    assert tc.dtype == torch.int32 and tb.dtype == torch.float32
    assert np.all(np.diff(tc.numpy(), axis=1) > 0)  # ascending, unique
    if case == "few_feasible":
        assert np.isinf(tb.numpy()).any() and np.isfinite(tb.numpy()).any()


# ------------------------------------------------------------ assign


def run_both(pods, nodes, params, k, **kw):
    jr = J.assign(pods, nodes, params, shortlist_k=k, **kw)
    tr = T.assign(*port_of(pods, nodes, params), shortlist_k=k, **kw)
    assert_bits_equal(jr, tr, FIELDS)
    return jr, tr


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assign_plain_combo_matches_reference(seed, approx):
    pods, nodes, params = ref_cases.rich_fixture(seed=seed)[:3]
    _, tr = run_both(pods, nodes, params, 8, approx_topk=approx)
    assert int((tr.assignment >= 0).sum()) > 0
    # decision identity inside the port: the shortlist changes nothing
    full = T.assign(*port_of(pods, nodes, params), approx_topk=approx)
    assert_bits_equal(full, tr, ref_cases.DECISION_FIELDS)


@pytest.mark.parametrize("seed", [3, 4])
def test_gang_rollback_identity(seed):
    pods, nodes, params = ref_cases.rich_fixture(
        seed=seed, gang=True, pod_scale=3.0, base_util=0.4
    )[:3]
    jr, tr = run_both(pods, nodes, params, 8)
    rolled = (np.asarray(pods.gang_id) >= 0) & (tr.assignment.numpy() < 0)
    assert rolled.any()


def contention():
    nodes, pods, params = chip_smoke.contention_fixture()
    return J.PodBatch.create(**pods), J.NodeState.create(**nodes), jax_params(params)


@pytest.mark.parametrize("approx", [False, True])
def test_contention_falls_back_and_matches_reference(approx):
    pods, nodes, params = contention()
    jr, tr = run_both(pods, nodes, params, chip_smoke.CONTENTION_K, approx_topk=approx)
    fb = tr.shortlist_fallbacks.numpy()
    assert fb.shape == (2,) and fb.dtype == np.int32 and (fb > 0).all(), fb
    full = T.assign(*port_of(pods, nodes, params), approx_topk=approx)
    assert_bits_equal(full, tr, ref_cases.DECISION_FIELDS)


def test_contention_fixture_is_the_reference_case():
    """``chip_smoke.contention_fixture`` is the fixture of
    ``test_shortlist.py``'s contention test: the same fallback counts."""
    pods, nodes, params = contention()
    res = J.assign(pods, nodes, params, shortlist_k=4)
    np.testing.assert_array_equal(np.asarray(res.shortlist_fallbacks), [3, 4])
    assert pods.requests.shape == (384, 2) and nodes.allocatable.shape == (32, 2)


@pytest.mark.parametrize("k", [16, 64])
def test_k_at_least_n_is_the_full_axis(k):
    pods, nodes, params = ref_cases.rich_fixture(seed=5, n=16)[:3]
    _, tr = run_both(pods, nodes, params, k)
    np.testing.assert_array_equal(tr.shortlist_fallbacks.numpy(), np.zeros(2, np.int32))


def test_shortlist_gate_and_unported_options():
    pods, nodes, params = port_of(*ref_cases.rich_fixture(seed=0, p=8, n=6)[:3])
    # below the fan-out the gate is off: the zeros sentinel
    res = T.assign(pods, nodes, params, shortlist_k=2)
    np.testing.assert_array_equal(res.shortlist_fallbacks.numpy(), [0, 0])
    # a cost transform (ported) turns the shortlist off, as in the reference
    res = T.assign(pods, nodes, params, shortlist_k=4, cost_transform=lambda c: c + 1.0)
    np.testing.assert_array_equal(res.shortlist_fallbacks.numpy(), [0, 0])
    assert not T._shortlist_on(4, 4, 6, cost_transform=lambda c: c)
    # devices, ported: a slot table and its score are taken; MostAllocated
    # turns the shortlist off (the reference's gate), a strategy the
    # reference does not know is refused
    devices = TD.DeviceState.create(np.full((6, 4), 100.0, np.float32),
                                    cap_total=np.full(6, 400.0), device="cpu")
    res = T.assign(pods, nodes, params, shortlist_k=4, devices=devices,
                   device_scoring="LeastAllocated")
    assert tuple(res.node_dev_slots.shape) == (6, 4)
    assert not T._shortlist_on(4, 4, 6, "MostAllocated")
    with pytest.raises(ValueError, match="device_scoring"):
        T.assign(pods, nodes, params, shortlist_k=4, device_scoring="Balanced")
    for scoring in (None, "LeastAllocated", "MostAllocated"):
        cand, _ = T.shortlist_plan(pods, nodes, params, shortlist_k=4, devices=devices,
                                   device_scoring=scoring)
        assert tuple(cand.shape) == (8, 4)
    # NUMA, ported: a zone table and its aligned score are taken
    zone = np.full((6, 2, 2), 4000.0, np.float32)
    numa = TZ.NumaState.create(zone_free=zone, zone_cap=zone, policy=np.full(6, 3, np.int8),
                               device="cpu")
    for scoring in (None, "LeastAllocated"):
        cand, _ = T.shortlist_plan(pods, nodes, params, shortlist_k=4, numa=numa,
                                   numa_scoring=scoring)
        assert tuple(cand.shape) == (8, 4)


# ------------------------------------------------------------ the round parts


def round_parts(k=4):
    """Round 0 of the contention case: sorted pods, tables, the plan."""
    pods, nodes, params = port_of(*contention())
    _, spods, bind, thr, pthr = T._round_setup(pods, nodes, params)
    pod_args = (spods.requests, spods.estimate, spods.is_prod, bind, spods.valid.clone())
    node_args = (nodes.allocatable, nodes.requested, nodes.estimated_used, nodes.prod_used,
                 nodes.metric_fresh, nodes.schedulable, nodes.cpu_amp, thr, pthr,
                 params.score_weights)
    plan = TS.shortlist_build(*pod_args[:4], *node_args, k, 4.0)
    return pod_args, node_args, plan


def test_round_after_done_changes_nothing():
    pod_args, node_args, plan = round_parts()
    word = torch.zeros(TS.WORD, dtype=torch.int32)
    counts = torch.tensor([5, 6], dtype=torch.int32)
    done = torch.tensor([1, 3], dtype=torch.int32)
    TS.shortlist_round(*pod_args, *node_args, *plan, 4, 4.0, True, word, counts, done)
    np.testing.assert_array_equal(word.numpy(), np.zeros(TS.WORD))
    np.testing.assert_array_equal(counts.numpy(), [5, 6])


def test_fallback_nomination_runs_only_when_triggered():
    pod_args, node_args, plan = round_parts()
    word = torch.zeros(TS.WORD, dtype=torch.int32)
    counts = torch.zeros(2, dtype=torch.int32)
    state = torch.zeros(2, dtype=torch.int32)
    # a bound below every cost: every active pod is unsafe
    low = torch.full_like(plan[1], -1000.0)
    top = TS.shortlist_round(*pod_args, *node_args, plan[0], low, 4, 4.0, False, word, counts,
                             state)
    np.testing.assert_array_equal(word[:3].numpy(), [1, 1, 0])
    np.testing.assert_array_equal(counts.numpy(), [1, 0])
    kept = tuple(t.clone() for t in top)
    clear = torch.zeros(TS.WORD, dtype=torch.int32)
    TN.nominate(*pod_args, *node_args, 4, 4.0, False, state=state, trigger=clear, out=top)
    for a, b in zip(kept, top):
        assert torch.equal(a, b)
    got = TN.nominate(*pod_args, *node_args, 4, 4.0, False, state=state, trigger=word, out=top)
    assert got is top
    want = TN.nominate_plain(*pod_args, *node_args, 4, 4.0, False)
    for a, b in zip(want, top):
        assert torch.equal(a, b)


# ------------------------------------------------------------ solve_stream


def jax_stream_full(nodes, stacked, params, **kw):
    pods = J.PodBatch.create(**{k: v.reshape((-1,) + v.shape[2:]) for k, v in stacked.items()})
    pods = jax.tree.map(lambda a: a.reshape((-1, chip_smoke.BATCH) + a.shape[1:]), pods)
    args = (pods, J.NodeState.create(**nodes), jax_params(params))
    asg, final, placed, _ = J.solve_stream(*args, **kw)
    full_asg, _, rounds, fallbacks = J.solve_stream_full(*args, **kw)
    np.testing.assert_array_equal(np.asarray(asg), np.asarray(full_asg))
    return asg, final, placed, rounds, fallbacks


@pytest.mark.parametrize("k", [64, 4])
def test_solve_stream_shortlist_matches_reference(k):
    nodes, pods, params = chip_smoke.headline_inputs(
        chip_smoke.build_fixture(0, 1000, 3 * chip_smoke.BATCH)
    )
    stacked = chip_smoke.stacked(pods)
    kw = dict(chip_smoke.SOLVE, shortlist_k=k)
    j_asg, j_final, j_placed, j_rounds, j_fb = jax_stream_full(nodes, stacked, params, **kw)
    t_args = (from_numpy(T.PodBatch, device="cpu", **stacked),
              from_numpy(T.NodeState, device="cpu", **nodes),
              from_numpy(T.SolverParams, device="cpu", **params))
    rounds = torch.zeros(3, dtype=torch.int32)
    fallbacks = torch.full((3, 2), -1, dtype=torch.int32)
    t_asg, t_final, t_placed, _ = T.solve_stream(*t_args, **kw, rounds_out=rounds,
                                                  fallbacks_out=fallbacks)
    np.testing.assert_array_equal(np.asarray(j_asg), t_asg.numpy())
    np.testing.assert_array_equal(np.asarray(j_placed), t_placed.numpy())
    np.testing.assert_array_equal(np.asarray(j_rounds), rounds.numpy())
    np.testing.assert_array_equal(np.asarray(j_fb), fallbacks.numpy())
    for f in ("requested", "estimated_used", "prod_used"):
        np.testing.assert_array_equal(bits(getattr(j_final, f)), bits(getattr(t_final, f).numpy()))
    # the stream without the shortlist decides the same, with zero counts
    off = torch.full((3, 2), -1, dtype=torch.int32)
    f_asg, f_final, _, _ = T.solve_stream(*t_args, **chip_smoke.SOLVE, fallbacks_out=off)
    assert torch.equal(f_asg, t_asg) and torch.equal(f_final.requested, t_final.requested)
    assert not off.any()


# ------------------------------------------------------------ golden


def test_shortlist_golden_file_is_the_reference_result():
    fresh = make_torch_golden.shortlist_golden_arrays()
    committed = np.load(make_torch_golden.SHORTLIST_PATH)
    assert sorted(committed.files) == sorted(fresh)
    for k, v in fresh.items():
        np.testing.assert_array_equal(bits(committed[k]), bits(v), err_msg=k)
    assert (committed["contention_fallbacks"] > 0).all()


def test_port_reproduces_shortlist_golden_on_cpu():
    """The check chip_smoke.py makes on the card, run here on the CPU."""
    assert chip_smoke.shortlist_golden_mismatches(torch, "cpu") == []

