"""The scheduler's stream with quotas and hard node constraints: the port
against the JAX package on the CPU.

The same numpy inputs go through ``koordinator_tpu.ops.solver`` and
``koordinator_tpu_torch.ops.solver``: ``shortlist_plan`` and ``assign``
with a node mask (rows all false included), and ``solve_stream_full`` with
the quota recipe of ``chip_smoke.py`` (both trees: ``_quota_commit``'s
one-hot and sorted branches) and its node mask, with the candidate
shortlist at K=64, at a K small enough that rounds fall back, and off.
The committed quota golden (``tests/data/torch_golden_quota.npz``) holds
the reference, and the port must reproduce it. Tolerance: none —
assignments, rounds, fallback counts and tables must be bitwise equal.
"""

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
from koordinator_tpu_torch.ops.convert import from_jax
from tools import make_torch_golden

torch.set_num_threads(1)
torch.use_deterministic_algorithms(True)

BATCH = 256


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_bits_equal(want, got, what=""):
    np.testing.assert_array_equal(bits(want), bits(got), err_msg=what)


def both(nodes, pods, params, batch=None):
    """(jax pods, nodes, params) and the port's on the CPU; pods stacked
    [C, batch] when ``batch`` is given."""
    jp = J.PodBatch.create(**pods)
    if batch is not None:
        jp = jax.tree.map(lambda a: a.reshape((-1, batch) + a.shape[1:]), jp)
    jn = J.NodeState.create(**nodes)
    jpar = J.SolverParams(**{k: jnp.asarray(v) for k, v in params.items()})
    port = (from_jax(T.PodBatch, jp, device="cpu"), from_jax(T.NodeState, jn, device="cpu"),
            from_jax(T.SolverParams, jpar, device="cpu"))
    return (jp, jn, jpar), port


def masked_case(seed, n_nodes=200, n_pods=BATCH, empty_every=29):
    """A rich fixture with the recipe's node mask, every ``empty_every``-th
    pod's row all false (a pod no node may take)."""
    nodes, pods, params = chip_smoke.rich_fixture(seed, n_nodes, n_pods, batch=n_pods)
    _, constrained, zone = chip_smoke.quota_draws(4, 4, n_pods)
    mask = chip_smoke.node_mask_np(constrained, zone, n_nodes)
    mask[::empty_every] = False
    return nodes, pods, params, mask


# ------------------------------------------------------------ the node mask


@pytest.mark.parametrize("k", [8, 64])
def test_shortlist_plan_with_node_mask_matches_reference(k):
    nodes, pods, params, mask = masked_case(0)
    (jp, jn, jpar), (tp, tn, tpar) = both(nodes, pods, params)
    want = J.shortlist_plan(jp, jn, jpar, node_mask=jnp.asarray(mask), shortlist_k=k)
    got = T.shortlist_plan(tp, tn, tpar, node_mask=torch.from_numpy(mask), shortlist_k=k)
    assert_bits_equal(want[0], got[0].numpy(), "plan_cand")
    assert_bits_equal(want[1], got[1].numpy(), "plan_bound")
    # a pod with an all-false row: every node +inf, so its bound is +inf
    order = np.argsort(-pods["priority"], kind="stable")
    empty = ~mask[order].any(axis=1)
    assert empty.any() and np.isinf(got[1].numpy()[empty]).all()


FIELDS = ("assignment", "node_requested", "node_estimated_used", "node_prod_used",
          "rounds_used", "shortlist_fallbacks")


@pytest.mark.parametrize("shortlist_k", [None, 4, 64])
@pytest.mark.parametrize("approx", [False, True])
def test_assign_with_node_mask_matches_reference(shortlist_k, approx):
    nodes, pods, params, mask = masked_case(1)
    (jp, jn, jpar), (tp, tn, tpar) = both(nodes, pods, params)
    want = J.assign(jp, jn, jpar, node_mask=jnp.asarray(mask), max_rounds=12,
                    approx_topk=approx, shortlist_k=shortlist_k)
    got = T.assign(tp, tn, tpar, node_mask=torch.from_numpy(mask), max_rounds=12,
                   approx_topk=approx, shortlist_k=shortlist_k)
    for f in FIELDS:
        assert_bits_equal(getattr(want, f), getattr(got, f).numpy(), f)
    asg = got.assignment.numpy()
    # no pod lands on a node its mask forbids; the all-false rows stay out
    assert mask[np.flatnonzero(asg >= 0), asg[asg >= 0]].all()
    assert (asg[::29] < 0).all()
    if shortlist_k == 4:
        assert got.shortlist_fallbacks.numpy().sum() > 0


def test_all_false_rows_count_no_fallback():
    """Every pod's row all false: no pod is placed, every shortlist is
    complete (bound +inf), so no round falls back."""
    nodes, pods, params, mask = masked_case(2)
    mask[:] = False
    (jp, jn, jpar), (tp, tn, tpar) = both(nodes, pods, params)
    want = J.assign(jp, jn, jpar, node_mask=jnp.asarray(mask), shortlist_k=4)
    got = T.assign(tp, tn, tpar, node_mask=torch.from_numpy(mask), shortlist_k=4)
    for f in FIELDS:
        assert_bits_equal(getattr(want, f), getattr(got, f).numpy(), f)
    assert (got.assignment.numpy() < 0).all()
    assert got.shortlist_fallbacks.tolist() == [0, 0]


# -------------------------------------------------------- solve_stream_full


def stream_case(tree, seed=3, n_nodes=256, n_pods=2048):
    """The quota recipe on a small rich fixture: 8 chunks of 256 pods over
    256 nodes (about 1.5 pods a team in the 32 x 32 tree, so both trees
    bind and admit), the stacked [C, P, N] mask."""
    fixture = chip_smoke.rich_fixture(seed, n_nodes, n_pods, batch=BATCH)
    nodes, pods, params, (runtime, used), (constrained, zone) = chip_smoke.quota_fixture(
        tree, *fixture)
    mask = chip_smoke.node_mask_np(constrained, zone, n_nodes).reshape(-1, BATCH, n_nodes)
    return nodes, pods, params, runtime, used, mask


@pytest.mark.parametrize("shortlist_k", [None, 4, 64])
@pytest.mark.parametrize("tree", ["onehot", "sorted"])
def test_solve_stream_full_matches_reference(tree, shortlist_k):
    nodes, pods, params, runtime, used, mask = stream_case(tree)
    (jp, jn, jpar), (tp, tn, tpar) = both(nodes, pods, params, BATCH)
    want = J.solve_stream_full(
        jp, jn, jpar, quotas=J.QuotaState(runtime=jnp.asarray(runtime), used=jnp.asarray(used)),
        node_mask=jnp.asarray(mask), shortlist_k=shortlist_k, **chip_smoke.SOLVE)
    got = T.solve_stream_full(
        tp, tn, tpar, quotas=T.QuotaState(runtime=torch.from_numpy(runtime),
                                          used=torch.from_numpy(used)),
        node_mask=torch.from_numpy(mask), shortlist_k=shortlist_k, **chip_smoke.SOLVE)
    for name, w, g in zip(("assignments", "pod_zones", "rounds", "fallbacks"), want, got):
        assert_bits_equal(w, g.numpy(), name)
    placed = int((got[0] >= 0).sum())
    assert 0 < placed < pods["requests"].shape[0]
    if shortlist_k == 4:
        assert got[3].numpy().sum() > 0


def test_solve_stream_full_without_options_is_solve_stream():
    nodes, pods, params, _, _, _ = stream_case("onehot")
    _, (tp, tn, tpar) = both(nodes, pods, params, BATCH)
    rounds = torch.zeros(tp.requests.shape[0], dtype=torch.int32)
    asg, _, _, _ = T.solve_stream(tp, tn, tpar, rounds_out=rounds, **chip_smoke.SOLVE)
    got = T.solve_stream_full(tp, tn, tpar, **chip_smoke.SOLVE)
    assert_bits_equal(asg.numpy(), got[0].numpy())
    assert (got[1] == -1).all() and torch.equal(got[2], rounds)
    assert not got[3].any()


def test_solve_stream_full_checks_its_options():
    nodes, pods, params, _, _, mask = stream_case("onehot")
    _, (tp, tn, tpar) = both(nodes, pods, params, BATCH)
    with pytest.raises(ValueError, match="node_mask"):
        T.solve_stream_full(tp, tn, tpar, node_mask=torch.from_numpy(mask[0]))
    # devices, ported: the slot table is taken and its carry comes back, a
    # strategy the reference does not know is refused
    n = tn.allocatable.shape[0]
    devices = TD.DeviceState.create(np.full((n, 8), 100.0, np.float32),
                                    cap_total=np.full(n, 800.0), device="cpu")
    with pytest.raises(ValueError, match="device_scoring"):
        T.solve_stream_full(tp, tn, tpar, devices=devices, device_scoring="Balanced")
    slots = torch.empty_like(devices.slot_free)
    got = T.solve_stream_full(tp, tn, tpar, devices=devices, device_scoring="LeastAllocated",
                              dev_out=(slots, None, None))
    assert torch.equal(slots, devices.slot_free) and got[0].shape == tp.requests.shape[:2]
    # NUMA, ported: the zone table is taken, a strategy it does not know is
    # refused
    n = tn.allocatable.shape[0]
    zone = np.full((n, 2, 2), 4000.0, np.float32)
    numa = TN.NumaState.create(zone_free=zone, zone_cap=zone, policy=np.full(n, 3, np.int8),
                               device="cpu")
    with pytest.raises(ValueError, match="numa_scoring"):
        T.solve_stream_full(tp, tn, tpar, numa=numa, numa_scoring="Balanced")
    zones = T.solve_stream_full(tp, tn, tpar, numa=numa, numa_scoring="LeastAllocated")[1]
    assert tuple(zones.shape) == tuple(tp.requests.shape[:2])


# -------------------------------------------------------------- the golden

SMALL_KEYS = [
    f"{tree}_{part}" for tree in chip_smoke.QUOTA_TREES
    for part in [f"k{k}_{f}" for k in (chip_smoke.SHORTLIST_K, 0)
                 for f in ("assignments", "rounds", "fallbacks")]
    + [f"stream_{f}" for f in ("assignments", "requested", "estimated_used", "prod_used",
                               "quota_used")]
]


def test_quota_golden_file_holds_the_reference():
    """The committed quota golden is what the JAX package gives now (the
    small part; the full-size digests are checked on the card)."""
    gold = np.load(chip_smoke.GOLDEN_QUOTA)
    fresh = make_torch_golden.quota_small_arrays()
    assert str(gold["fixture_sha256"]) == str(fresh["fixture_sha256"])
    for key in SMALL_KEYS:
        assert_bits_equal(fresh[key], gold[key], key)
    for tree, (placed, rounds) in chip_smoke.QUOTA_EXPECTED.items():
        for k in (chip_smoke.SHORTLIST_K, 0):
            assert int(gold[f"full_{tree}_k{k}_placed"]) == placed
            assert int(gold[f"full_{tree}_k{k}_rounds"]) == rounds
            assert len(str(gold[f"full_{tree}_k{k}_sha256"])) == 64


@pytest.mark.parametrize("tree", list(chip_smoke.QUOTA_TREES))
def test_port_matches_quota_golden(tree):
    gold = np.load(chip_smoke.GOLDEN_QUOTA)
    fixture = chip_smoke.rich_fixture(chip_smoke.GOLDEN_SEED, chip_smoke.GOLDEN_NODES,
                                      chip_smoke.GOLDEN_PODS)
    nodes, pods, params, (runtime, used), (constrained, zone) = chip_smoke.quota_fixture(
        tree, *fixture)
    n = nodes["allocatable"].shape[0]
    mask = torch.from_numpy(chip_smoke.node_mask_np(constrained, zone, n)).reshape(
        -1, chip_smoke.BATCH, n)
    _, (tp, tn, tpar) = both(nodes, pods, params, chip_smoke.BATCH)

    def quotas():
        return T.QuotaState(runtime=torch.from_numpy(runtime), used=torch.from_numpy(used))

    for k in (chip_smoke.SHORTLIST_K, None):
        asg, _, rounds, fallbacks = T.solve_stream_full(
            tp, tn, tpar, quotas=quotas(), node_mask=mask, shortlist_k=k, **chip_smoke.SOLVE)
        key = f"{tree}_k{k or 0}"
        assert_bits_equal(gold[f"{key}_assignments"], asg.numpy(), key)
        assert_bits_equal(gold[f"{key}_rounds"], rounds.numpy(), key)
        assert_bits_equal(gold[f"{key}_fallbacks"], fallbacks.numpy(), key)
    asg, final, _, fq = T.solve_stream(tp, tn, tpar, quotas=quotas(), **chip_smoke.SOLVE)
    assert_bits_equal(gold[f"{tree}_stream_assignments"], asg.numpy())
    for f in ("requested", "estimated_used", "prod_used"):
        assert_bits_equal(gold[f"{tree}_stream_{f}"], getattr(final, f).numpy(), f)
    assert_bits_equal(gold[f"{tree}_stream_quota_used"], fq.used.numpy())
