"""The round tail and the device-side round loop against the JAX package.

``round_tail`` (its plain version on the CPU) does everything a round of
the reference's ``assign`` does after nomination: choice, stable node sort,
segmented commit, charges and the loop state. One round of it must equal
``J.assign(max_rounds=1)`` on the same inputs, and its ``done`` flag must
say whether the reference's loop goes on. ``assign`` and ``solve_stream``
must then equal the reference, ``rounds_used`` included, in the loop's
three endings: no valid pod (0 rounds), the ``max_rounds`` cap, and a
fixed point that leaves pods active. Tolerance: none, bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.ops import solver as J
from koordinator_tpu_torch.ops import commit as tcommit
from koordinator_tpu_torch.ops import nominate as tnom
from koordinator_tpu_torch.ops import solver as T
from koordinator_tpu_torch.ops.convert import from_numpy, to_numpy

torch.set_num_threads(1)

TABLES = ("node_requested", "node_estimated_used", "node_prod_used")


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def round_fixture(seed, p=96, n=6):
    """Few large nodes for many pods, so a node takes more than 16 pods in
    one round; amplified nodes with cpu-bind pods, stale nodes, custom and
    prod thresholds near the tables' usage, padded (inactive) pods and pods
    no node can hold (no finite slot)."""
    rng = np.random.default_rng(seed)
    alloc = (rng.choice([128_000.0, 256_000.0], (n, 1)) * np.array([1.0, 4.0])).astype(np.float32)
    est_used = (alloc * rng.uniform(0.3, 0.55, (n, 1))).astype(np.float32)
    nodes = dict(
        allocatable=alloc,
        requested=(alloc * rng.uniform(0.0, 0.4, (n, 1))).astype(np.float32),
        estimated_used=est_used,
        prod_used=(est_used * np.float32(0.8)).astype(np.float32),
        metric_fresh=np.arange(n) != 1,
        cpu_amp=np.where(np.arange(n) % 2 == 0, 1.5, 1.0).astype(np.float32),
        custom_thresholds=np.where(
            (np.arange(n) == 2)[:, None], np.array([[58.0, 0.0]]), 0.0
        ).astype(np.float32),
    )
    cpu = rng.choice([500.0, 1000.0, 2000.0, 4000.0], p)
    cpu[rng.random(p) < 0.06] = 1e9  # no node holds it
    req = np.stack([cpu, cpu * rng.choice([2, 4], p)], 1).astype(np.float32)
    prio = rng.integers(5000, 5004, p).astype(np.int32)  # many equal priorities
    pods = dict(
        requests=req,
        estimate=(req * np.array([0.85, 0.7], np.float32)).astype(np.float32),
        priority=prio,
        is_prod=rng.random(p) < 0.4,
        qos=np.where(rng.random(p) < 0.3, 3, 0).astype(np.int8),
        valid=rng.random(p) > 0.1,
    )
    params = dict(
        usage_thresholds=np.array([65.0, 95.0], np.float32),
        prod_thresholds=np.array([52.0, 0.0], np.float32),
        score_weights=np.ones(2, np.float32),
    )
    return nodes, pods, params


def jax_inputs(nodes, pods, params):
    return (
        J.PodBatch.create(**pods),
        J.NodeState.create(**nodes),
        J.SolverParams(**{k: jnp.asarray(v) for k, v in params.items()}),
    )


def port_inputs(nodes, pods, params):
    return (
        from_numpy(T.PodBatch, device="cpu", **pods),
        from_numpy(T.NodeState, device="cpu", **nodes),
        from_numpy(T.SolverParams, device="cpu", **params),
    )


def first_round(nodes, pods, params, jitter, approx):
    """Round 0 of the port's ``assign``, step by step: the round's inputs,
    its nomination and the loop state before the round tail."""
    tp, tn, tpar = port_inputs(nodes, pods, params)
    order, spods, bind, thr, pthr = T._round_setup(tp, tn, tpar)
    active = spods.valid.clone()
    state = torch.tensor([int(not active.any()), 0], dtype=torch.int32)
    top_cost, top_idx = tnom.nominate_plain(
        spods.requests, spods.estimate, spods.is_prod, bind, active,
        tn.allocatable, tn.requested, tn.estimated_used, tn.prod_used,
        tn.metric_fresh, tn.schedulable, tn.cpu_amp, thr, pthr,
        tpar.score_weights, min(4, tn.allocatable.shape[0]), jitter, approx,
    )
    args = [top_cost, top_idx, spods.requests, spods.estimate, spods.is_prod, bind,
            tn.cpu_amp, tn.allocatable, tn.metric_fresh, thr, pthr,
            tn.requested.clone(), tn.estimated_used.clone(), tn.prod_used.clone(),
            torch.full((len(active),), -1, dtype=torch.int32), active, state]
    return order, args


@pytest.mark.parametrize("jitter", [4.0, 0.0])  # 0.0: integer scores, ties
@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_round_tail_is_one_reference_round(seed, approx, jitter):
    nodes, pods, params = round_fixture(seed)
    order, args = first_round(nodes, pods, params, jitter, approx)
    n = nodes["allocatable"].shape[0]
    # the fixture's round: a node chosen by more than 16 pods (a segment
    # across a chunk of XLA's cumsum), pods with no finite slot
    _, node_key = tcommit._choose(args[0], args[1], args[15], n)
    assert np.bincount(node_key.numpy()[node_key.numpy() < n]).max() > 16
    assert (node_key.numpy() == n).sum() > (~args[15]).sum()
    tcommit.round_tail(*args, 0.35)
    requested, est_used, prod_used, assigned, active, state = args[11:]

    want = J.assign(*jax_inputs(nodes, pods, params), max_rounds=1,
                    approx_topk=approx, nomination_jitter=jitter)
    got = torch.empty_like(assigned).scatter_(0, order, assigned)
    np.testing.assert_array_equal(np.asarray(want.assignment), got.numpy())
    for f, t in zip(TABLES, (requested, est_used, prod_used)):
        np.testing.assert_array_equal(bits(getattr(want, f)), bits(t.numpy()), err_msg=f)
    placed = (got.numpy() >= 0).sum()
    assert 16 < placed < pods["valid"].sum()
    # the loop state: active &= assigned < 0, rounds + 1, and done exactly
    # when the reference's loop stops after this round
    valid_sorted = torch.from_numpy(pods["valid"])[order]
    np.testing.assert_array_equal(active.numpy(), (valid_sorted & (assigned < 0)).numpy())
    goes_on = int(J.assign(*jax_inputs(nodes, pods, params), max_rounds=2,
                           approx_topk=approx, nomination_jitter=jitter).rounds_used) == 2
    assert state.tolist() == [int(not goes_on), 1]


@pytest.mark.parametrize("p", [512, 4096])
def test_crowded_round_tail_is_one_reference_round(p):
    """A crowded round without zones: four nodes for every pod, so each
    node's segment is about P / 4 rows long and holds winners and pods its
    tests refuse (the charges' longest chains). Bitwise equal to one round
    of the reference."""
    nodes, pods, params = round_fixture(11, p=p, n=4)
    order, args = first_round(nodes, pods, params, 4.0, True)
    _, node_key = tcommit._choose(args[0], args[1], args[15], 4)
    assert np.bincount(node_key.numpy()[node_key.numpy() < 4]).max() > p // 8
    tcommit.round_tail(*args, 0.35)
    requested, est_used, prod_used, assigned = args[11:15]
    want = J.assign(*jax_inputs(nodes, pods, params), max_rounds=1, approx_topk=True)
    got = torch.empty_like(assigned).scatter_(0, order, assigned)
    np.testing.assert_array_equal(np.asarray(want.assignment), got.numpy())
    for f, t in zip(TABLES, (requested, est_used, prod_used)):
        np.testing.assert_array_equal(bits(getattr(want, f)), bits(t.numpy()), err_msg=f)
    # winners and refusals mixed in the segments
    placed = got.numpy()
    mixed = [0 < (placed == node).sum() < (node_key.numpy() == node).sum() for node in range(4)]
    assert sum(mixed) >= 2


def test_round_tail_after_done_changes_nothing():
    nodes, pods, params = round_fixture(3)
    _, args = first_round(nodes, pods, params, 4.0, True)
    args[16][:] = torch.tensor([1, 5], dtype=torch.int32)
    before = [a.clone() for a in args]
    tcommit.round_tail(*args, 0.35)
    for a, b in zip(args, before):
        assert torch.equal(a, b)


def loop_case(case):
    """(nodes, pods, params, max_rounds) ending the reference's loop one of
    three ways."""
    nodes, pods, params = round_fixture(4, p=128, n=5)
    if case == "no valid pod":
        pods["valid"] = np.zeros_like(pods["valid"])
        return nodes, pods, params, 12
    if case == "cap":
        return nodes, pods, params, 2
    # fixed point: the nodes fill up and the unplaceable pods stay active
    nodes["allocatable"] = (nodes["allocatable"] * np.float32(0.25)).astype(np.float32)
    return nodes, pods, params, 24


@pytest.mark.parametrize("case", ["no valid pod", "cap", "fixed point with active pods"])
def test_assign_rounds_match_reference(case):
    nodes, pods, params, max_rounds = loop_case(case)
    want = J.assign(*jax_inputs(nodes, pods, params), max_rounds=max_rounds, approx_topk=True)
    got = to_numpy(T.assign(*port_inputs(nodes, pods, params), max_rounds=max_rounds,
                            approx_topk=True))
    for f in ("assignment", "rounds_used") + TABLES:
        np.testing.assert_array_equal(bits(getattr(want, f)), bits(got[f]), err_msg=f)
    rounds, placed = int(got["rounds_used"]), (got["assignment"] >= 0).sum()
    if case == "no valid pod":
        assert rounds == 0 and placed == 0
    elif case == "cap":
        assert rounds == max_rounds and placed < pods["valid"].sum()
    else:
        assert 1 < rounds < max_rounds and 0 < placed < pods["valid"].sum()


@pytest.mark.parametrize("case", ["no valid pod", "cap", "fixed point with active pods"])
def test_solve_stream_rounds_match_reference(case):
    nodes, pods, params, max_rounds = loop_case(case)
    stacked = {k: v.reshape((4, -1) + v.shape[1:]) for k, v in pods.items()}
    j_pods = J.PodBatch.create(**pods)
    j_stacked = type(j_pods)(**{
        f: None if getattr(j_pods, f) is None
        else getattr(j_pods, f).reshape((4, -1) + getattr(j_pods, f).shape[1:])
        for f in j_pods.__dataclass_fields__
    })
    _, j_nodes, j_params = jax_inputs(nodes, pods, params)
    j_asg, j_final, j_placed, _ = J.solve_stream(
        j_stacked, j_nodes, j_params, max_rounds=max_rounds, approx_topk=True
    )
    # the reference's rounds a batch: assign batch by batch on the
    # threaded tables
    j_rounds, cur = [], j_nodes
    for b in range(4):
        res = J.assign(
            type(j_pods)(**{f: None if getattr(j_stacked, f) is None else getattr(j_stacked, f)[b]
                            for f in j_pods.__dataclass_fields__}),
            cur, j_params, max_rounds=max_rounds, approx_topk=True,
        )
        np.testing.assert_array_equal(np.asarray(res.assignment), np.asarray(j_asg[b]))
        j_rounds.append(int(res.rounds_used))
        cur = cur.replace(requested=res.node_requested, estimated_used=res.node_estimated_used,
                          prod_used=res.node_prod_used)

    tn = from_numpy(T.NodeState, device="cpu", **nodes)
    rounds = torch.full((4,), -7, dtype=torch.int32)
    t_asg, t_final, t_placed, _ = T.solve_stream(
        from_numpy(T.PodBatch, device="cpu", **stacked), tn,
        from_numpy(T.SolverParams, device="cpu", **params),
        max_rounds=max_rounds, approx_topk=True, rounds_out=rounds,
    )
    np.testing.assert_array_equal(np.asarray(j_asg), t_asg.numpy())
    np.testing.assert_array_equal(np.asarray(j_placed), t_placed.numpy())
    for f in ("requested", "estimated_used", "prod_used"):
        np.testing.assert_array_equal(bits(getattr(j_final, f)), bits(getattr(t_final, f).numpy()))
    assert rounds.tolist() == j_rounds
    if case == "no valid pod":
        assert j_rounds == [0] * 4
    elif case == "cap":
        assert max(j_rounds) == max_rounds
    else:
        assert any(1 < r < max_rounds for r in j_rounds)
    # the caller's tables are never written
    np.testing.assert_array_equal(tn.requested.numpy(), nodes["requested"])
