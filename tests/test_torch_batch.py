"""A batch's set-up and teardown: the port's plain versions against the JAX
package on the CPU.

``batch_setup_plain`` and ``batch_teardown_plain`` (with the stream's
``batch_outputs_plain``) are what ``csrc/batch.cu`` computes on the card.
The same numpy inputs, made from a seed, go through
``koordinator_tpu.ops.solver`` and the port: the priority order against
``jnp.argsort(-priority, stable=True)`` (heavy ties, INT32_MIN and
INT32_MAX, P from 1 to 8,193), the fields in that order against
``jax.tree.map(lambda a: a[order], pods)``, the cpu-bind flags, device
units and slot capacities, the un-sort against the reference's
``inv_order`` gather (``solver.py:1494-1496``), the zone charges against
its lines :1497-1509, with and without cpuset-bound pods, and a stream's
output rows against ``solve_stream`` / ``solve_stream_full``. Tolerance:
none — every value must be bitwise equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from koordinator_tpu.ops import device as JD
from koordinator_tpu.ops import solver as J
from koordinator_tpu_torch import kernels
from koordinator_tpu_torch.ops import shortlist as TS
from koordinator_tpu_torch.ops import solver as T
from koordinator_tpu_torch.ops.convert import from_jax, from_numpy

torch.set_num_threads(1)
torch.use_deterministic_algorithms(True)

I32_MIN = chip_smoke.I32_MIN


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_bits_equal(want, got, what=""):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape, (what, want.shape, got.shape)
    np.testing.assert_array_equal(bits(want), bits(got), err_msg=what)


def both_pods(pods: dict, batch=None):
    """The JAX package's PodBatch and the port's on the CPU, from the
    same arrays; stacked [B, batch] when ``batch`` is given."""
    levels = pods["quota_chain"].shape[1] if "quota_chain" in pods else 4
    jp = J.PodBatch.create(quota_levels=levels, **pods)
    if batch is not None:
        jp = jax.tree.map(lambda a: a.reshape((-1, batch) + a.shape[1:]), jp)
    return jp, from_jax(T.PodBatch, jp, device="cpu")


@pytest.mark.parametrize("prio", ["ties", "wide", "one"])
@pytest.mark.parametrize("p", [1, 7, 512, 4096, 8193])
def test_order_is_the_reference_stable_argsort(p, prio):
    jp, tp = both_pods(chip_smoke.batch_pods(p + len(prio), p, prio))
    want = np.asarray(jnp.argsort(-jp.priority, stable=True))
    assert_bits_equal(want, np.asarray(J._priority_order(jp)), "reference order")
    setup = T.batch_setup(tp)
    assert setup.order.dtype == torch.int64
    np.testing.assert_array_equal(want, setup.order.numpy())
    if prio != "one" and p > 2:
        # -INT32_MIN wraps to itself: those pods come first, in arrival order
        first = np.flatnonzero(np.asarray(jp.priority) == I32_MIN)
        np.testing.assert_array_equal(setup.order.numpy()[: first.size], first)


@pytest.mark.parametrize("flags", [(False, False, False), (True, False, False),
                                   (False, True, False), (False, False, True),
                                   (True, True, True)])
@pytest.mark.parametrize("p", [1, 7, 512])
def test_sorted_fields_bind_and_units_match_reference(p, flags):
    quota, numa, devices = flags
    jp, tp = both_pods(chip_smoke.batch_pods(3 * p, p))
    setup = T.batch_setup_plain(tp, None, quota, numa, devices)
    order = J._priority_order(jp)
    jsorted = jax.tree.map(lambda a: a[order], jp)
    fields = T._with_quota(T._ROUND_FIELDS, quota, numa, devices)
    for f in T.PodBatch.__dataclass_fields__:
        got = getattr(setup.spods, f)
        if f in fields:
            assert_bits_equal(np.asarray(getattr(jsorted, f)), got.numpy(), f)
        else:
            assert got is None, f
    assert_bits_equal(np.asarray(J._cpu_bind(jsorted)), setup.bind.numpy(), "bind")
    if devices:
        units = JD.device_consumption(jsorted.gpu_whole, jsorted.gpu_share)[1]
        assert_bits_equal(np.asarray(units), setup.units.numpy(), "units")
    else:
        assert setup.units is None
    # _round_setup hands the same three to its other callers
    nodes, _, params = chip_smoke.rich_fixture(1, 16, 64, batch=64)
    order_r, spods_r, bind_r, _, _ = T._round_setup(
        tp, from_numpy(T.NodeState, device="cpu", **nodes),
        from_numpy(T.SolverParams, device="cpu", **params), None, quota, numa, devices)
    np.testing.assert_array_equal(order_r.numpy(), setup.order.numpy())
    np.testing.assert_array_equal(bind_r.numpy(), setup.bind.numpy())
    for f in fields:
        assert_bits_equal(getattr(setup.spods, f).numpy(), getattr(spods_r, f).numpy(), f)


@pytest.mark.parametrize("words", [0, 12])
@pytest.mark.parametrize("b", [0, 2])
def test_stacked_setup_at_an_index_matches_reference(b, words):
    p, g = 128, 8
    pods = chip_smoke.batch_pods(11 + b, 3 * p)
    pods["valid"][2 * p:] = False  # batch 2: nothing valid, done before round 0
    jp, tp = both_pods(pods, batch=p)
    index = torch.tensor([b], dtype=torch.int64)
    cap_total = np.random.default_rng(b).choice(
        np.array([0.0, 250.0, 400.0, 800.0, 1e9, np.nan], np.float32), 40)
    setup = T.batch_setup(tp, index, True, True, True, mask=True, words=words,
                          cap_total=torch.from_numpy(cap_total), slots=g)
    jb = jax.tree.map(lambda a: a[b], jp)
    order = J._priority_order(jb)
    np.testing.assert_array_equal(np.asarray(order), setup.order.numpy())
    jsorted = jax.tree.map(lambda a: a[order], jb)
    for f in T._with_quota(T._ROUND_FIELDS, True, True, True):
        assert_bits_equal(np.asarray(getattr(jsorted, f)), getattr(setup.spods, f).numpy(), f)
    for f in T._rollback_fields(True, True):
        assert_bits_equal(np.asarray(getattr(jb, f)), getattr(setup.upods, f).numpy(), f)
    assert setup.upods.priority is None and setup.upods.numa_required is None
    np.testing.assert_array_equal(np.asarray(order) + b * p, setup.mask_rows.numpy())
    # the loop's initial state (solver.py:1454-1470)
    np.testing.assert_array_equal(setup.assigned.numpy(), np.full(p, -1, np.int32))
    np.testing.assert_array_equal(setup.azone.numpy(), np.full(p, -1, np.int32))
    assert setup.state.tolist() == [int(not np.asarray(jb.valid).any()), 0]
    assert setup.state.tolist()[0] == (b == 2)
    if words:
        assert setup.words.shape == (words, TS.WORD) and not setup.words.any()
        assert setup.fallbacks.tolist() == [0, 0]
    else:
        assert setup.words is None and setup.fallbacks is None
    # the rollback's real slots (solver.py:1525-1535), counted times 100
    exists = jnp.arange(g)[None, :] < (jnp.asarray(cap_total) / 100.0)[:, None]
    want = np.asarray(jnp.sum(exists, axis=1).astype(jnp.float32) * 100.0)
    assert_bits_equal(want, setup.slot_cap.numpy(), "slot_cap")


def reference_teardown(jp, assigned_s, azone_s, cpu_amp, dn):
    """``solver.py:1494-1509`` on the rounds' sorted outputs."""
    n = cpu_amp.shape[0]
    order = J._priority_order(jp)
    inv_order = jnp.argsort(order).astype(jnp.int32)
    assignment = assigned_s[inv_order]
    pod_zone = azone_s[inv_order]
    amp_assigned = jnp.maximum(cpu_amp, 1.0)[jnp.clip(assignment, 0, n - 1)]
    bind_o = J._cpu_bind(jp)
    zone_charge = jp.requests[:, :dn].at[:, 0].multiply(jnp.where(bind_o, amp_assigned, 1.0))
    zone_charge = jnp.where((pod_zone >= 0)[:, None], zone_charge, 0.0)
    return assignment, pod_zone, zone_charge


@pytest.mark.parametrize("bound", [True, False])
@pytest.mark.parametrize("dn", [None, 1, 2, 3])
@pytest.mark.parametrize("p", [1, 7, 512, 4096])
def test_teardown_matches_reference_unsort_and_zone_charges(p, dn, bound):
    n = 37
    rng = np.random.default_rng(p + (dn or 0))
    pods = chip_smoke.batch_pods(p, p, d=3)
    if not bound:
        pods["qos"][:] = 0
    jp, tp = both_pods(pods)
    setup = T.batch_setup_plain(tp, None, numa=dn is not None)
    assigned_s = np.where(rng.random(p) < 0.7, rng.integers(0, n, p), -1).astype(np.int32)
    azone_s = np.where((assigned_s >= 0) & (rng.random(p) < 0.6),
                       rng.integers(0, 4, p), -1).astype(np.int32)
    cpu_amp = rng.choice(np.array([0.5, 1.0, 1.5, 2.25], np.float32), n)
    setup.assigned.copy_(torch.from_numpy(assigned_s))
    if dn is not None:
        setup.azone.copy_(torch.from_numpy(azone_s))
    asg, pod_zone, charge = T.batch_teardown(setup, torch.from_numpy(cpu_amp), dn)
    want = reference_teardown(jp, jnp.asarray(assigned_s), jnp.asarray(azone_s),
                              jnp.asarray(cpu_amp), dn or 1)
    assert_bits_equal(np.asarray(want[0]), asg.numpy(), "assignment")
    if dn is None:
        assert pod_zone is None and charge is None
        return
    assert_bits_equal(np.asarray(want[1]), pod_zone.numpy(), "pod_zone")
    assert_bits_equal(np.asarray(want[2]), charge.numpy(), "zone_charge")
    amplified = (np.asarray(J._cpu_bind(jp)) & (np.asarray(want[1]) >= 0)
                 & (cpu_amp[np.clip(np.asarray(want[0]), 0, n - 1)] > 1.0))
    if not bound:
        assert not amplified.any()
    elif p >= 512:
        assert amplified.any()


def test_outputs_write_row_index_and_advance():
    b, p = 4, 9
    rng = np.random.default_rng(5)
    outs = (torch.full((b, p), 7, dtype=torch.int32), torch.zeros(b, dtype=torch.int32),
            torch.zeros(b, dtype=torch.int32), torch.zeros((b, 2), dtype=torch.int32),
            torch.full((b, p), 7, dtype=torch.int32))
    index = torch.tensor([2], dtype=torch.int64)
    asg = torch.from_numpy(rng.integers(-1, 5, p).astype(np.int32))
    zone = torch.from_numpy(rng.integers(-1, 2, p).astype(np.int32))
    state = torch.tensor([1, 6], dtype=torch.int32)
    T.batch_outputs(outs, index, asg, zone, state[1], torch.tensor([3, 1], dtype=torch.int32))
    assert index.tolist() == [3]
    np.testing.assert_array_equal(outs[0][2].numpy(), asg.numpy())
    np.testing.assert_array_equal(outs[4][2].numpy(), zone.numpy())
    assert outs[1].tolist() == [0, 0, int((asg >= 0).sum()), 0]
    assert outs[2].tolist() == [0, 0, 6, 0] and outs[3][2].tolist() == [3, 1]
    assert (outs[0][[0, 1, 3]] == 7).all() and (outs[4][[0, 1, 3]] == 7).all()


@pytest.mark.parametrize("shortlist_k", [None, 6])
def test_stream_output_rows_match_reference(shortlist_k):
    nodes, pods, params = chip_smoke.rich_fixture(3, 48, 3 * 64, batch=64)
    jp, tp = both_pods(pods, batch=64)
    jn = J.NodeState.create(**nodes)
    jpar = J.SolverParams(**{k: jnp.asarray(v) for k, v in params.items()})
    tn = from_jax(T.NodeState, jn, device="cpu")
    tpar = from_jax(T.SolverParams, jpar, device="cpu")
    kw = dict(max_rounds=6, approx_topk=True, shortlist_k=shortlist_k)
    want = J.solve_stream_full(jp, jn, jpar, **kw)
    asg, zones, rounds, fallbacks = T.solve_stream_full(tp, tn, tpar, **kw)
    for name, w, g in zip(("assignments", "pod_zones", "rounds", "fallbacks"), want,
                          (asg, zones, rounds, fallbacks)):
        assert_bits_equal(np.asarray(w), g.numpy(), name)
    want_placed = J.solve_stream(jp, jn, jpar, **kw)[2]
    rounds_out = torch.zeros(3, dtype=torch.int32)
    got = T.solve_stream(tp, tn, tpar, rounds_out=rounds_out, **kw)
    assert_bits_equal(np.asarray(want_placed), got[2].numpy(), "placed")
    assert_bits_equal(np.asarray(want[2]), rounds_out.numpy(), "rounds_out")
    assert (np.asarray(want[0]) >= 0).sum() > 0


def test_setup_counts_no_kernel_on_the_cpu():
    kernels.reset_launches()
    jp, tp = both_pods(chip_smoke.batch_pods(1, 64))
    setup = T.batch_setup(tp)
    T.batch_teardown(setup, torch.ones(4), None)
    assert not kernels.launches and setup.assigned.is_cpu
