"""NUMA zones, the parts: the port's twins of ``koordinator_tpu.ops.numa``
and ``costs.numa_aligned_cost`` against the JAX package on the CPU.

The same seeded numpy inputs go through ``numa_fit_mask``, ``zone_pick``
and ``numa_aligned_cost`` of both packages: zone tables of two and four
zones with padded (zero-capacity) zones, nodes without zones, memory left
unregistered, exhausted nodes, all four topology policies, required pods,
and CPU amplification ratios of 1.0, 1.3 and 1.5 (``1 + (1.3 - 1)`` is not
1.3 in float32, so the amplified request must be formed as the reference
forms it). Then the orders of summation the zones add in: the total over
the zones, the round's zone charges and the rollback's zone refunds, each
on shapes where the other order gives other bits. Then the port twins of
the identity cases of ``tests/test_zone_on_device.py``, on the solver.
Tolerance: none — masks, zones and costs are bitwise equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from koordinator_tpu.ops import costs as JC
from koordinator_tpu.ops import numa as JN
from koordinator_tpu.ops import solver as J
from koordinator_tpu_torch.ops import costs as TC
from koordinator_tpu_torch.ops import numa as TN
from koordinator_tpu_torch.ops import solver as T
from koordinator_tpu_torch.ops.convert import from_jax

torch.set_num_threads(1)
torch.use_deterministic_algorithms(True)

f32 = np.float32


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_bits_equal(want, got, what=""):
    np.testing.assert_array_equal(bits(want), bits(got), err_msg=what)


def zone_case(seed, n=64, p=48, zones=4, amp=1.3):
    """Seeded zone tables (``chip_smoke.zone_tables`` at ``zones`` zones a
    node at most, the node ratio ``amp`` on half the nodes) and pods: a
    tenth cpuset-bound, a fifth required."""
    rng = np.random.default_rng(seed)
    alloc = rng.choice([32_000.0, 64_000.0], (n, 1)) * np.array([1.0, 4.0])
    nodes = dict(allocatable=alloc.astype(f32),
                 estimated_used=(alloc * rng.uniform(0.1, 0.6, (n, 1))).astype(f32))
    _, numa, required = chip_smoke.zone_tables(seed, nodes, p)
    numa["zone_free"] = numa["zone_free"][:, :zones]
    numa["zone_cap"] = numa["zone_cap"][:, :zones]
    req = np.stack([rng.choice([1000.0, 2000.0, 4000.0, 6000.0, 12_000.0], p),
                    rng.choice([2048.0, 8192.0, 40_000.0], p)], 1).astype(f32)
    bind = rng.random(p) < 0.1
    cpu_amp = np.where(rng.random(n) < 0.5, amp, 1.0).astype(f32)
    return numa, req, bind, required, cpu_amp


def jax_numa(numa):
    return JN.NumaState(**{k: jnp.asarray(v) for k, v in numa.items()})


def torch_numa(numa):
    return TN.NumaState.create(**numa, device="cpu")


# ------------------------------------------------------------- numa_fit_mask


@pytest.mark.parametrize("zones", [2, 4])
@pytest.mark.parametrize("amp", [1.0, 1.3, 1.5])
def test_numa_fit_mask_matches_reference(zones, amp):
    numa, req, bind, required, cpu_amp = zone_case(zones * 10 + int(amp * 10), zones=zones,
                                                   amp=amp)
    wants = bind | required
    want = JN.numa_fit_mask(jnp.asarray(req), jnp.asarray(wants), jax_numa(numa),
                            cpu_amp=jnp.asarray(cpu_amp), pod_required=jnp.asarray(required))
    got = TN.numa_fit_mask(torch.from_numpy(req), torch.from_numpy(wants), torch_numa(numa),
                           cpu_amp=torch.from_numpy(cpu_amp),
                           pod_required=torch.from_numpy(required))
    assert_bits_equal(want, got.numpy())
    got = np.asarray(got)
    # the case reaches every branch: nodes without zones fit all, strict
    # and total fits both refuse somewhere, every policy is drawn
    no_zones = ~(numa["zone_cap"].sum(-1) > 0).any(-1)
    assert no_zones.any() and got[:, no_zones].all()
    assert (~got).any() and got.any()
    assert set(np.unique(numa["policy"])) == {0, 1, 2, 3}
    assert (numa["zone_cap"] == 0).all(-1).any() and required.any()


def test_numa_fit_mask_without_amplification_or_required():
    numa, req, bind, _, _ = zone_case(3)
    want = JN.numa_fit_mask(jnp.asarray(req), jnp.asarray(bind), jax_numa(numa))
    got = TN.numa_fit_mask(torch.from_numpy(req), torch.from_numpy(bind), torch_numa(numa))
    assert_bits_equal(want, got.numpy())


def test_zone_total_sums_in_zone_order():
    """``total_free`` adds the zones one after another (Z = 4): with values
    whose sums round differently by grouping, a request of exactly the
    sequential total fits on every node, which a pairwise sum would refuse
    on some."""
    rng = np.random.default_rng(0)
    n, z = 256, 4
    free = rng.uniform(1e6, 3e7, (n, z, 2)).astype(f32)
    seq = ((free[:, 0] + free[:, 1]) + free[:, 2]) + free[:, 3]
    pair = (free[:, 0] + free[:, 1]) + (free[:, 2] + free[:, 3])
    assert (seq != pair).any()
    numa = dict(zone_free=free, zone_cap=(free * f32(1.5)).astype(f32),
                policy=np.zeros(n, np.int8))
    want = np.diag(np.asarray(JN.numa_fit_mask(jnp.asarray(seq), jnp.ones(n, bool),
                                               jax_numa(numa))))
    got = np.diag(TN.numa_fit_mask(torch.from_numpy(seq), torch.ones(n, dtype=torch.bool),
                                   torch_numa(numa)).numpy())
    assert want.all() and got.all()
    np.testing.assert_array_equal(TN.zone_sum(torch.from_numpy(free)).numpy(), seq)


@pytest.mark.parametrize("zones", [2, 4])
def test_zone_side_table_holds_the_reference_node_terms(zones):
    """``zone_prep_plain`` (the plain version of ``csrc/zone_prep.cu``):
    the snapshot is the table; each node's side row holds the terms
    ``numa_fit_mask`` and ``numa_aligned_cost`` work out per node in the
    reference — dim_on, has_zones, the SINGLE_NUMA_NODE policy, each
    zone's "some capacity", the zones' free total and each zone's
    (cap0 - free0 + 1) / (cap0 + 1) — bit for bit with the JAX package's
    expressions (``numa.py:116, :126, :133, :62-65``, ``costs.py:240-246``)
    on padded zones, nodes without zones and unregistered memory."""
    numa = zone_case(zones + 40, n=96, zones=zones)[0]
    free, cap = jnp.asarray(numa["zone_free"]), jnp.asarray(numa["zone_cap"])
    snap, side = TN.zone_prep_plain(torch.from_numpy(numa["zone_free"]),
                                    torch.from_numpy(numa["zone_cap"]),
                                    torch.from_numpy(numa["policy"]))
    assert_bits_equal(numa["zone_free"], snap.numpy())
    side = side.numpy()
    dn = numa["zone_cap"].shape[-1]
    info = side[:, 0]
    dim_on = np.asarray(jnp.sum(cap, axis=1) > 0)
    has_zones = np.asarray(jnp.any(jnp.sum(cap, axis=-1) > 0, axis=-1))
    real = np.asarray(jnp.any(cap > 0, axis=-1))
    util = np.asarray((cap[:, :, 0] - free[:, :, 0] + 1.0) / (cap[:, :, 0] + 1.0))
    for d in range(dn):
        np.testing.assert_array_equal((info >> d) & 1 == 1, dim_on[:, d])
    np.testing.assert_array_equal((info & TN.SIDE_HAS_ZONES) != 0, has_zones)
    np.testing.assert_array_equal((info & TN.SIDE_SINGLE) != 0,
                                  numa["policy"] == TN.POLICY_SINGLE_NUMA_NODE)
    for q in range(zones):
        np.testing.assert_array_equal((info >> (TN.SIDE_REAL + q)) & 1 == 1, real[:, q])
    assert_bits_equal(np.asarray(jnp.sum(free, axis=1)), side[:, 1:1 + dn].view(np.float32))
    assert_bits_equal(util, side[:, 1 + dn:].view(np.float32))
    assert (~has_zones).any() and (~real).any() and (~dim_on).any()


# ----------------------------------------------------------------- zone_pick


@pytest.mark.parametrize("most", [False, True])
def test_zone_pick_matches_reference(most):
    numa, req, bind, _, cpu_amp = zone_case(5 + most)
    rng = np.random.default_rng(9)
    p = req.shape[0]
    nodes = rng.integers(0, numa["zone_free"].shape[0], p)
    args = (numa["zone_free"][nodes], numa["zone_cap"][nodes], req,
            np.full(p, most) | (rng.random(p) < 0.3))
    want = JN.zone_pick(*(jnp.asarray(a) for a in args))
    got = TN.zone_pick(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args))
    assert_bits_equal(want[1], got[1].numpy())
    fit = np.asarray(want[1])
    assert fit.any() and (~fit).any()
    assert_bits_equal(np.asarray(want[0])[fit], got[0].numpy()[fit])


def test_zone_pick_ties_take_the_first_zone():
    """Equal keys go to the lower zone; padded zones never win."""
    free = np.array([[[500.0, 10.0], [500.0, 10.0], [0.0, 0.0], [500.0, 10.0]]] * 2, f32)
    cap = np.array([[[1000.0, 20.0], [1000.0, 20.0], [0.0, 0.0], [1000.0, 20.0]]] * 2, f32)
    req = np.zeros((2, 2), f32)
    most = np.array([False, True])
    want = JN.zone_pick(jnp.asarray(free), jnp.asarray(cap), jnp.asarray(req),
                        jnp.asarray(most))
    got = TN.zone_pick(torch.from_numpy(free), torch.from_numpy(cap), torch.from_numpy(req),
                       torch.from_numpy(most))
    assert_bits_equal(want[0], got[0].numpy())
    assert got[0].tolist() == [0, 0] and got[1].all()


# ---------------------------------------------------------- numa_aligned_cost


@pytest.mark.parametrize("most", [False, True])
@pytest.mark.parametrize("zones", [2, 4])
def test_numa_aligned_cost_matches_reference(most, zones):
    numa, req, bind, required, _ = zone_case(11 + zones, zones=zones)
    wants = bind | required
    weights = np.array([1.0, 2.0], f32)
    want = JC.numa_aligned_cost(jnp.asarray(req), jnp.asarray(wants),
                                jnp.asarray(numa["zone_free"]), jnp.asarray(numa["zone_cap"]),
                                jnp.asarray(weights), most_allocated=most)
    got = TC.numa_aligned_cost(torch.from_numpy(req), torch.from_numpy(wants),
                               torch.from_numpy(numa["zone_free"]),
                               torch.from_numpy(numa["zone_cap"]), torch.from_numpy(weights),
                               most_allocated=most)
    assert_bits_equal(want, got.numpy())
    assert (np.asarray(got) < 0).any()


# ------------------------------------------------- the zone charges' orders


def charge_case(n_nodes, zones, per_node, seed):
    """``per_node`` cpuset-bound LSR pods on each of ``n_nodes`` SINGLE
    nodes of ``zones`` zones, CPU amplified by a ratio that makes the
    charges inexact, zone rows large enough that the order of their
    charges shows in the bits; pods of node i may use only node i."""
    rng = np.random.default_rng(seed)
    p = n_nodes * per_node
    amp = rng.uniform(1.01, 1.99, n_nodes).astype(f32)
    alloc = np.tile(np.array([[1e6, 1e7]], f32), (n_nodes, 1))
    nodes = dict(allocatable=alloc, estimated_used=alloc * f32(0.01), cpu_amp=amp)
    req = np.stack([rng.integers(1, 9, p) * 1000.0, np.full(p, 100.0)], 1).astype(f32)
    node_of = np.repeat(np.arange(n_nodes), per_node)
    pods = dict(requests=req, priority=np.arange(p, 0, -1).astype(np.int32),
                qos=np.full(p, 3, np.int8))
    free = np.empty((n_nodes, zones, 2), f32)
    free[..., 0] = rng.uniform(1e5, 2e5, (n_nodes, zones))
    free[..., 1] = 1e6
    cap = np.full((n_nodes, zones, 2), [2e5, 1e6], f32)
    numa = dict(zone_free=free, zone_cap=cap, policy=np.full(n_nodes, 3, np.int8))
    mask = node_of[:, None] == np.arange(n_nodes)[None, :]
    return nodes, pods, numa, mask


def solve_both(nodes, pods, numa, mask, **kw):
    jp, jn = J.PodBatch.create(**pods), J.NodeState.create(**nodes)
    jpar = J.SolverParams(usage_thresholds=jnp.zeros(2), prod_thresholds=jnp.zeros(2),
                          score_weights=jnp.ones(2))
    want = J.assign(jp, jn, jpar, numa=jax_numa(numa), node_mask=jnp.asarray(mask),
                    max_rounds=1, **kw)
    got = T.assign(from_jax(T.PodBatch, jp, device="cpu"), from_jax(T.NodeState, jn, device="cpu"),
                   from_jax(T.SolverParams, jpar, device="cpu"), numa=torch_numa(numa),
                   node_mask=torch.from_numpy(mask), max_rounds=1, **kw)
    return want, got


@pytest.mark.parametrize("n_nodes,zones,per_node", [(1, 1, 4), (3, 2, 4), (8, 4, 4), (16, 1, 3)])
def test_zone_charges_sum_first_and_refunds_fold(n_nodes, zones, per_node):
    """The round's ``zone_free - segment_sum(...)`` sums each zone's charges
    first, then subtracts; the rollback's ``node_zone_free +
    segment_sum(...)`` adds them one row at a time (XLA folds it into a
    scatter-add). Both are held on shapes where the other order gives
    other bits."""
    nodes, pods, numa, mask = charge_case(n_nodes, zones, per_node, seed=n_nodes * 7 + zones)
    want, got = solve_both(nodes, pods, numa, mask)
    for f in ("assignment", "pod_zone", "pod_zone_charge", "node_zone_free"):
        assert_bits_equal(getattr(want, f), getattr(got, f).numpy(), f)
    zones_of = got.pod_zone.numpy()
    assert (zones_of >= 0).all()
    charge = got.pod_zone_charge.numpy()[:, 0]
    node_of = np.repeat(np.arange(n_nodes), per_node)
    differs = False
    for n in range(n_nodes):
        for z in range(zones):
            rows = np.nonzero((node_of == n) & (zones_of == z))[0]
            if len(rows) < 2:
                continue
            seq = numa["zone_free"][n, z, 0]
            for r in rows:
                seq = f32(seq - charge[r])
            differs |= seq != got.node_zone_free.numpy()[n, z, 0]
    # the whole batch in one Strict gang that falls short: every charge
    # comes back
    gang = dict(pods, gang_id=np.zeros(len(charge), np.int32),
                gang_min=np.full(len(charge), len(charge) + 1, np.int32))
    want_rb, got_rb = solve_both(nodes, gang, numa, mask)
    assert_bits_equal(want_rb.node_zone_free, got_rb.node_zone_free.numpy(), "refund")
    assert (got_rb.pod_zone.numpy() == -1).all()
    summed = got.node_zone_free.numpy().copy()
    for n in range(n_nodes):
        for z in range(zones):
            rows = np.nonzero((node_of == n) & (zones_of == z))[0]
            if len(rows):
                summed[n, z, 0] = summed[n, z, 0] + np.sum(charge[rows], dtype=f32)
    differs |= (summed != got_rb.node_zone_free.numpy()).any()
    if n_nodes >= 8:
        assert differs, "the case does not tell the orders apart"


# ------------------------------- the identity cases of test_zone_on_device


def device_cluster(n_nodes=1, most=False):
    """``tests/test_zone_on_device.py``'s cluster on the solver: nodes of
    32,000m CPU and 65,536 MiB, two zones of 16,000m and 32,768 MiB,
    SINGLE_NUMA_NODE."""
    alloc = np.tile(np.array([[32_000.0, 65_536.0]], f32), (n_nodes, 1))
    zone = np.tile(np.array([[[16_000.0, 32_768.0]] * 2], f32), (n_nodes, 1, 1))
    numa = dict(zone_free=zone.copy(), zone_cap=zone, policy=np.full(n_nodes, 3, np.int8),
                zone_most=np.full(n_nodes, most))
    return dict(allocatable=alloc), numa


def lsr_pods(count, cpu=4000.0):
    return dict(requests=np.tile(np.array([[cpu, 4096.0]], f32), (count, 1)),
                priority=np.full(count, 9500, np.int32), qos=np.full(count, 3, np.int8))


def solve_cluster(nodes, pods, numa, max_rounds=24):
    jp, jn = J.PodBatch.create(**pods), J.NodeState.create(**nodes)
    jpar = J.SolverParams(usage_thresholds=jnp.zeros(2), prod_thresholds=jnp.zeros(2),
                          score_weights=jnp.ones(2))
    want = J.assign(jp, jn, jpar, numa=jax_numa(numa), max_rounds=max_rounds)
    got = T.assign(from_jax(T.PodBatch, jp, device="cpu"), from_jax(T.NodeState, jn, device="cpu"),
                   from_jax(T.SolverParams, jpar, device="cpu"), numa=torch_numa(numa),
                   max_rounds=max_rounds)
    for f in ("assignment", "pod_zone", "pod_zone_charge", "node_zone_free", "rounds_used"):
        assert_bits_equal(getattr(want, f), getattr(got, f).numpy(), f)
    return got


def test_device_zone_picks_spread_least_allocated():
    nodes, numa = device_cluster()
    got = solve_cluster(nodes, lsr_pods(4), numa)
    assert (got.assignment.numpy() == 0).all()
    assert sorted(got.pod_zone.tolist()) == [0, 0, 1, 1]
    np.testing.assert_array_equal(got.node_zone_free.numpy()[0, :, 0], [8000.0, 8000.0])


def test_device_zone_picks_pack_most_allocated():
    nodes, numa = device_cluster(most=True)
    got = solve_cluster(nodes, lsr_pods(3, cpu=6000.0), numa)
    assert sorted(got.pod_zone.tolist()) == [0, 0, 1]


def test_zone_hints_match_host_scan():
    """18 LSR pods over 6 nodes: every pod placed with a zone, and each
    node's zone usage equal to the picks it was charged for."""
    nodes, numa = device_cluster(n_nodes=6)
    got = solve_cluster(nodes, lsr_pods(18), numa)
    asg, zones = got.assignment.numpy(), got.pod_zone.numpy()
    assert (asg >= 0).all() and (zones >= 0).all()
    used = numa["zone_cap"][..., 0] - got.node_zone_free.numpy()[..., 0]
    for n in range(6):
        for z in range(2):
            assert used[n, z] == 4000.0 * ((asg == n) & (zones == z)).sum()


def test_zone_pick_never_selects_padded_zone():
    free = np.array([[[1000.0, 100.0], [0.0, 0.0], [0.0, 0.0], [0.0, 0.0]]], f32)
    cap = np.array([[[16_000.0, 32_768.0], [0.0, 0.0], [0.0, 0.0], [0.0, 0.0]]], f32)
    args = (free, cap, np.zeros((1, 2), f32), np.array([True]))
    want = JN.zone_pick(*(jnp.asarray(a) for a in args))
    zone, fit = TN.zone_pick(*(torch.from_numpy(a) for a in args))
    assert bool(fit[0]) and int(zone[0]) == 0 == int(want[0][0])


def test_strict_pod_rejected_when_no_zone_fits():
    nodes, numa = device_cluster()
    got = solve_cluster(nodes, lsr_pods(1, cpu=18_000.0), numa)
    assert got.assignment.tolist() == [-1] and got.pod_zone.tolist() == [-1]
