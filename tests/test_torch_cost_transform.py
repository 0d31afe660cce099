"""The cost-transform route: ``assign(cost_transform=)`` and
``solve_stream(cost_transform=)`` of the port against the JAX package on
the CPU.

The same numpy inputs (``chip_smoke.rich_fixture`` with, as a case asks,
``chip_smoke.device_tables``' devices, quota chains, a node mask and
``chip_smoke.zone_tables``' zones) go through both packages with the same
BeforeScore transform, written once in ``jnp`` and once in torch. The
transforms are exact in float32 on both sides (additions of whole
numbers, scaling by powers of two, ``where`` vetoes), and they write
``+inf``, ``-inf``, ``NaN`` of both signs and whole rows of ``+inf`` (a
pod no node is left for). The port runs the plain versions of its two
kernels (``ops/cost_full.py``). The pre-transform cost each round hands
the transform is captured on both sides and compared bit for bit, so the
materialized cost is held directly, not only through the decisions. The
ranking rule the reference applies to what a transform writes
(``jax.lax.top_k``, ``approx_max_k`` and ``jnp.argmin`` on the CPU) is
held on crafted rows. Tolerance: none — assignments, rounds and every
table are bitwise equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.ops import solver as J
from koordinator_tpu_torch.ops import cost_full as TC
from koordinator_tpu_torch.ops import solver as T
from test_torch_device_solver import assert_bits_equal, assert_results_equal, device_case

torch.set_num_threads(1)
torch.use_deterministic_algorithms(True)

NEG_NAN = np.array([0xFFC00000], np.uint32).view(np.float32)[0]


def _grid(xp, cost):
    """(sorted pod position [P, 1], node index [1, N]) in ``xp``."""
    p, n = cost.shape
    if xp is jnp:
        return jnp.arange(p)[:, None], jnp.arange(n)[None, :]
    return (torch.arange(p, device=cost.device)[:, None],
            torch.arange(n, device=cost.device)[None, :])


def _transform(name, xp):
    """The named transform in ``xp`` (``jnp`` or ``torch``)."""
    inf = xp.inf

    def where(cond, a, b):
        return xp.where(cond, a, b)

    def fn(cost):
        pi, ni = _grid(xp, cost)
        if name == "bias":
            return cost * 2.0 - where(ni % 8 == 3, 4.0, 0.0)
        if name == "veto_inf":
            return where(ni % 5 == 0, inf, cost)
        if name == "neg_inf":
            return where((ni % 7 == 1) & (pi % 3 == 0), -inf, cost)
        if name == "nan":
            return where((ni % 11 == 2) & (pi % 4 == 1), float("nan"), cost)
        if name == "neg_nan":
            return where((ni % 13 == 4) & (pi % 5 == 2), float(NEG_NAN), cost)
        if name == "row_inf":
            return where(pi % 6 == 0, inf, cost + 1.0)
        raise ValueError(name)

    fn.__name__ = f"{name}_{xp.__name__}"
    return fn


def _case(context, seed=3, n=96, p=80):
    """The JAX and port inputs of ``context``: ``plain`` (LoadAware only),
    ``mask``, ``numa``, ``devices`` or ``all`` (devices, quotas, the node
    mask and zones)."""
    flags = dict(mask=context in ("mask", "all"), zones=context in ("numa", "all"),
                 quota=context == "all")
    (jp, jn, jpar, jin), (tp, tn, tpar, tin) = device_case(seed, n=n, p=p, **flags)
    if context not in ("devices", "all"):
        # no devices, and no pod asks for one
        jin.pop("devices")
        tin.pop("devices")
        fields = ("gpu_whole", "gpu_share", "rdma", "fpga")
        jp = jp.replace(**{f: jnp.zeros_like(getattr(jp, f)) for f in fields})
        for f in fields:
            getattr(tp, f).zero_()
    kw = dict(max_rounds=10, approx_topk=True)
    if context in ("numa", "all"):
        kw["numa_scoring"] = "LeastAllocated"
    if context in ("devices", "all"):
        kw["device_scoring"] = "MostAllocated" if context == "all" else "LeastAllocated"
    return (jp, jn, jpar, jin), (tp, tn, tpar, tin), kw


CASES = [("bias", "plain"), ("veto_inf", "mask"), ("neg_inf", "numa"), ("nan", "devices"),
         ("neg_nan", "plain"), ("row_inf", "all"), ("bias", "all"), ("nan", "all")]


@pytest.mark.parametrize("name, context", CASES)
def test_assign_with_a_transform_matches_reference(name, context):
    (jp, jn, jpar, jin), (tp, tn, tpar, tin), kw = _case(context)
    want = J.assign(jp, jn, jpar, **jin, **kw, cost_transform=_transform(name, jnp))
    got = T.assign(tp, tn, tpar, **tin, **kw, cost_transform=_transform(name, torch))
    assert_results_equal(want, got)
    assert (got.assignment.numpy() >= 0).sum() > 10


@pytest.mark.parametrize("approx_topk", [False, True])
def test_transform_without_approx_topk_and_jitter(approx_topk):
    """The exact top-k vector, and no jitter: ties of the transformed cost
    (with ``-0.0`` and ``+0.0`` among them) rank as the reference ranks
    them."""
    (jp, jn, jpar, jin), (tp, tn, tpar, tin), kw = _case("plain", seed=4)
    kw.update(approx_topk=approx_topk, nomination_jitter=0.0)
    want = J.assign(jp, jn, jpar, **jin, **kw, cost_transform=_transform("neg_inf", jnp))
    got = T.assign(tp, tn, tpar, **tin, **kw, cost_transform=_transform("neg_inf", torch))
    assert_results_equal(want, got)


@pytest.mark.parametrize("context", ["plain", "all"])
def test_the_transform_sees_the_reference_cost(context):
    """The [P, N] cost handed to the transform, round by round, is the
    reference's bit for bit (infeasible pairs included): the output of
    ``csrc/cost_full.cu``'s plain version."""
    (jp, jn, jpar, jin), (tp, tn, tpar, tin), kw = _case(context, seed=5, n=24, p=96)
    seen_jax, seen_port = [], []

    def capture_jax(cost):
        jax.debug.callback(lambda c: seen_jax.append(np.array(c)), cost, ordered=True)
        return cost

    def capture_port(cost):
        seen_port.append(cost.numpy().copy())
        return cost

    want = J.assign(jp, jn, jpar, **jin, **kw, cost_transform=capture_jax)
    jax.effects_barrier()
    got = T.assign(tp, tn, tpar, **tin, **kw, cost_transform=capture_port)
    assert_results_equal(want, got)
    assert len(seen_jax) == len(seen_port) >= 2
    for r, (a, b) in enumerate(zip(seen_jax, seen_port)):
        assert_bits_equal(a, b, f"round {r}")
    assert np.isfinite(seen_port[0]).all() and (seen_port[0] < 0).any()


def test_transform_turns_the_shortlist_off():
    (jp, jn, jpar, jin), (tp, tn, tpar, tin), kw = _case("devices", seed=6)
    kw["shortlist_k"] = 16
    fn = _transform("bias", torch)
    assert T._shortlist_on(16, 4, 96) and not T._shortlist_on(16, 4, 96, cost_transform=fn)
    want = J.assign(jp, jn, jpar, **jin, **kw, cost_transform=_transform("bias", jnp))
    got = T.assign(tp, tn, tpar, **tin, **kw, cost_transform=fn)
    assert_results_equal(want, got)
    np.testing.assert_array_equal(got.shortlist_fallbacks.numpy(), [0, 0])


def test_solve_stream_with_a_transform_matches_reference():
    (jp, jn, jpar, _), (tp, tn, tpar, _) = device_case(7, n=96, p=160, batch=80)
    kw = dict(max_rounds=10, approx_topk=True)
    asg, final, placed, _ = J.solve_stream(jp, jn, jpar, **kw,
                                           cost_transform=_transform("veto_inf", jnp))
    tasg, tfinal, tplaced, _ = T.solve_stream(tp, tn, tpar, **kw,
                                              cost_transform=_transform("veto_inf", torch))
    assert_bits_equal(asg, tasg.numpy(), "assignments")
    assert_bits_equal(placed, tplaced.numpy(), "placed")
    for f in ("requested", "estimated_used", "prod_used"):
        assert_bits_equal(getattr(final, f), getattr(tfinal, f).numpy(), f)


def test_the_ranking_rule_on_crafted_rows():
    """``nominate_cost_plain`` (jitter off, every pair feasible) gives the
    reference's ``[argmin, top_k...]`` and exact top-k on rows of ``+inf``,
    ``-inf``, ``-0.0``/``+0.0`` ties and NaNs, and an all-``+inf`` row. A
    NaN the reference hands its top-k ranks last whatever its sign (the
    ``neg_nan`` transform holds that inside the solve, where a fusion may
    flip it); the positive NaNs here rank last in the stand-alone
    ``jax.lax.top_k`` as well."""
    inf, nan = np.inf, np.nan
    rows = np.array([
        [3, 1, nan, 2, 1, 5, 0, 7],
        [nan, nan, 1, 0, inf, inf, 2, 3],
        [inf] * 8,
        [-inf, 2, -inf, nan, 0, inf, 1, 1],
        [nan] * 8,
        [0.0, -0.0, 1, 2, 3, 4, -0.0, 0.0],
        [1, nan, nan, 0, -inf, 5, 6, 7],
    ], np.float32)
    c = jnp.asarray(rows)
    k = 4
    _, top = jax.lax.top_k(-c, k)
    arg = np.asarray(jnp.argmin(c, axis=1))
    feas = torch.ones(rows.shape, dtype=torch.uint8)
    for approx in (False, True):
        want_idx = np.asarray(top)
        if approx:
            want_idx = np.concatenate([arg[:, None], want_idx[:, : k - 1]], axis=1)
        want_val = np.take_along_axis(rows, want_idx, axis=1)
        val, idx = TC.nominate_cost_plain(torch.from_numpy(rows), feas, k, 0.0, approx)
        np.testing.assert_array_equal(idx.numpy(), want_idx)
        assert_bits_equal(want_val, val.numpy(), f"approx={approx}")
    # a negative NaN ranks last too
    neg = rows.copy()
    neg[np.isnan(neg)] = NEG_NAN
    _, idx = TC.nominate_cost_plain(torch.from_numpy(neg), feas, k, 0.0, False)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(top))


def test_cost_transform_must_return_float32_of_its_shape():
    (_, _, _, _), (tp, tn, tpar, tin), kw = _case("plain")
    with pytest.raises(ValueError, match="cost_transform"):
        T.assign(tp, tn, tpar, **kw, cost_transform=lambda c: c.double())
    with pytest.raises(ValueError, match="cost_transform"):
        T.assign(tp, tn, tpar, **kw, cost_transform=lambda c: c[:, :3])
