"""DeviceShare, the parts: the port's twins of ``koordinator_tpu.ops.device``
and ``costs.device_cost`` against the JAX package on the CPU.

The same seeded numpy inputs go through ``slot_stats``, ``device_fit_mask``
(and ``_cols``), ``device_cost`` (and ``_cols``, under each strategy),
``slot_commit`` and ``slot_refund`` of both packages: slot tables of 1 to
40 slots with whole, zero and non-integer free values, padding slots,
equal slots (ties), RDMA and FPGA tracked and not. Then the orders of
summation: a node's slot total (slot order), the refund's running
headroom (XLA's chunked cumsum above 16 slots) and the rollback's refund
(pod order), each on inputs where another order gives other bits. Then
the port twins of ``tests/test_device_slots.py``'s unit cases. Tolerance:
none — masks, costs and tables are bitwise equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.ops import costs as JC
from koordinator_tpu.ops import device as JD
from koordinator_tpu.ops import solver as J
from koordinator_tpu_torch.ops import costs as TC
from koordinator_tpu_torch.ops import device as TD
from koordinator_tpu_torch.ops import solver as T
from koordinator_tpu_torch.ops.convert import from_jax

torch.set_num_threads(1)
torch.use_deterministic_algorithms(True)

f32 = np.float32
#: free values a slot takes: whole, empty and non-integer remainders
SLOT_VALUES = np.asarray([100.0, 100.0, 0.0, 70.0, 66.7, 33.3, 12.5, 50.0, 87.5, 0.1],
                         f32)


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_bits_equal(want, got, what=""):
    np.testing.assert_array_equal(bits(want), bits(got), err_msg=what)


def slot_table(seed, n, g, pad=True):
    """[N, G] slots drawn from ``SLOT_VALUES`` and the nodes' cap_total:
    with ``pad`` a node's real slots are its first 0, G/2 or G."""
    rng = np.random.default_rng(seed)
    slots = SLOT_VALUES[rng.integers(0, SLOT_VALUES.size, (n, g))]
    count = rng.choice([0, max(1, g // 2), g], n) if pad else np.full(n, g)
    slots = np.where(np.arange(g)[None, :] < count[:, None], slots, 0.0).astype(f32)
    return slots, (count * 100.0).astype(f32)


def pod_demand(seed, p):
    """Whole GPUs, shares (30, 50 and non-integer), whole+share, RDMA and
    FPGA requests of ``p`` pods."""
    rng = np.random.default_rng(seed)
    whole = rng.choice([0, 0, 1, 2, 4, 8], p).astype(np.int32)
    share = rng.choice(np.asarray([0.0, 0.0, 30.0, 50.0, 33.3, 12.5, 99.9995], f32), p)
    return whole, share.astype(f32), rng.integers(0, 3, p).astype(np.int32), \
        rng.integers(0, 2, p).astype(np.int32)


def tt(a):
    return None if a is None else torch.from_numpy(np.array(a))


def jj(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------- slot_stats


@pytest.mark.parametrize("g", [1, 3, 8, 16, 33])
def test_slot_stats_matches_reference(g):
    slots, _ = slot_table(g, 300, g)
    want = JD.slot_stats(jnp.asarray(slots))
    got = TD.slot_stats(torch.from_numpy(slots))
    for name, w, t in zip(("full", "partial", "smax", "total"), want, got):
        assert_bits_equal(w, t.numpy(), name)
    assert_bits_equal(np.stack([np.asarray(w) for w in want], 1),
                      TD.device_prep_plain(torch.from_numpy(slots)).numpy(), "device_prep")


def test_slot_total_sums_in_slot_order():
    """The node's free total adds its slots one after another: on these
    rows a pairwise sum gives other bits, and the reference agrees with
    the slot order."""
    rng = np.random.default_rng(3)
    slots = rng.choice(np.asarray([33.3, 66.7, 12.5, 0.1, 87.5, 70.0], f32), (2000, 8))
    want = np.asarray(JD.slot_stats(jnp.asarray(slots))[3])
    pairwise = ((slots[:, 0::2] + slots[:, 1::2]).astype(f32))
    pairwise = ((pairwise[:, 0::2] + pairwise[:, 1::2]).astype(f32))
    pairwise = (pairwise[:, 0] + pairwise[:, 1]).astype(f32)
    assert not np.array_equal(want, pairwise)
    assert_bits_equal(want, TD.slot_stats(torch.from_numpy(slots))[3].numpy())


# ------------------------------------------------------------ the fit masks


@pytest.mark.parametrize("tracked", [True, False])
@pytest.mark.parametrize("smax", [True, False])
@pytest.mark.parametrize("g", [4, 16])
def test_device_fit_mask_matches_reference(tracked, smax, g):
    slots, _ = slot_table(g + 7, 90, g)
    whole, share, rdma, fpga = pod_demand(g, 70)
    rng = np.random.default_rng(g)
    rfree = rng.integers(0, 4, 90).astype(f32) if tracked else None
    ffree = rng.integers(0, 2, 90).astype(f32) if tracked else None
    jstats = JD.slot_stats(jnp.asarray(slots))
    tstats = TD.slot_stats(torch.from_numpy(slots))
    want = JD.device_fit_mask(jj(whole), jj(share), jstats[0], jstats[1],
                              slot_max=jstats[2] if smax else None, rdma_req=jj(rdma),
                              rdma_free=jj(rfree), fpga_req=jj(fpga), fpga_free=jj(ffree))
    got = TD.device_fit_mask(tt(whole), tt(share), tstats[0], tstats[1],
                             slot_max=tstats[2] if smax else None, rdma_req=tt(rdma),
                             rdma_free=tt(rfree), fpga_req=tt(fpga), fpga_free=tt(ffree))
    assert_bits_equal(want, got.numpy())
    assert 0 < np.asarray(want).sum() < want.size
    # the gathered-column form: each pod's K columns
    cand = np.sort(rng.choice(90, (70, 12)), axis=1)
    jc = [None if a is None else jnp.asarray(np.asarray(a)[cand])
          for a in (*jstats[:3], rfree, ffree)]
    tc = [None if a is None else torch.from_numpy(np.asarray(a)[cand])
          for a in (*(s.numpy() for s in tstats[:3]), rfree, ffree)]
    want = JD.device_fit_mask_cols(jj(whole), jj(share), jc[0], jc[1],
                                   slot_max=jc[2] if smax else None, rdma_req=jj(rdma),
                                   rdma_free=jc[3], fpga_req=jj(fpga), fpga_free=jc[4])
    got = TD.device_fit_mask_cols(tt(whole), tt(share), tc[0], tc[1],
                                  slot_max=tc[2] if smax else None, rdma_req=tt(rdma),
                                  rdma_free=tc[3], fpga_req=tt(fpga), fpga_free=tc[4])
    assert_bits_equal(want, got.numpy(), "cols")


# ---------------------------------------------------------------- the score


@pytest.mark.parametrize("most", [False, True])
@pytest.mark.parametrize("g", [8, 16])
def test_device_cost_matches_reference(most, g):
    """Least- and MostAllocated over GPU capacity: nodes without GPUs,
    pods asking for none, demand past capacity, and free totals a hair
    over capacity (the 1e-6 window the build clamps)."""
    slots, cap = slot_table(g * 3, 120, g)
    total = np.array(JD.slot_stats(jnp.asarray(slots))[3])
    total[:5] = cap[:5] + np.float32(5e-7)
    whole, share, _, _ = pod_demand(g * 5, 80)
    units = np.asarray(JD.device_consumption(jj(whole), jj(share))[1])
    assert_bits_equal(units, TD.device_consumption(tt(whole), tt(share))[1].numpy(), "units")
    want = JC.device_cost(jnp.asarray(units), jnp.asarray(total), jnp.asarray(cap),
                          most_allocated=most)
    got = TC.device_cost(tt(units), tt(total), tt(cap), most_allocated=most)
    assert_bits_equal(want, got.numpy())
    assert np.unique(np.asarray(want)).size > 10
    cand = np.sort(np.random.default_rng(g).choice(120, (80, 9)), axis=1)
    want = JC.device_cost_cols(jnp.asarray(units), jnp.asarray(total[cand]),
                               jnp.asarray(cap[cand]), most_allocated=most)
    got = TC.device_cost_cols(tt(units), tt(total[cand]), tt(cap[cand]), most_allocated=most)
    assert_bits_equal(want, got.numpy(), "cols")


# ------------------------------------------------------- commit and refund


@pytest.mark.parametrize("g", [4, 8, 16])
def test_slot_commit_matches_reference(g):
    """Whole slots zeroed by full-slot rank, the opened slot, the best-fit
    bite (equal partial slots: the first index), no candidate at all."""
    slots, _ = slot_table(g * 11, 400, g, pad=False)
    slots[:40, : g // 2] = 33.3  # equal partial slots
    rng = np.random.default_rng(g)
    full = np.asarray(JD.slot_stats(jnp.asarray(slots))[0])
    whole = np.floor(rng.random(400) * (full + 1)).astype(f32)
    frac = rng.choice(np.asarray([0.0, 30.0, 33.3, 12.5, 50.0, 99.0], f32), 400)
    opens = rng.random(400) < 0.3
    want = JD.slot_commit(jnp.asarray(slots), jnp.asarray(whole), jnp.asarray(frac),
                          jnp.asarray(opens))
    got = TD.slot_commit(tt(slots), tt(whole), tt(frac), tt(opens))
    assert_bits_equal(want, got.numpy())
    assert (np.asarray(want) != slots).any(axis=1).sum() > 200


@pytest.mark.parametrize("g", [3, 8, 16, 24, 40])
@pytest.mark.parametrize("exists", [False, True])
def test_slot_refund_matches_reference(g, exists):
    """The water-fill: equal slots fill in index order, fractional refunds,
    refunds past the headroom, padding slots without headroom; above 16
    slots the running headroom follows XLA's chunked cumsum."""
    slots, cap = slot_table(g * 13 + exists, 300, g)
    rng = np.random.default_rng(g)
    refund = rng.choice(np.asarray([0.0, 33.3, 100.0, 112.5, 250.0, 433.3, 1e4], f32), 300)
    mask = np.arange(g)[None, :] < (cap / 100.0)[:, None] if exists else None
    want = JD.slot_refund(jnp.asarray(slots), jnp.asarray(refund),
                          None if mask is None else jnp.asarray(mask))
    got = TD.slot_refund(tt(slots), tt(refund), tt(mask))
    assert_bits_equal(want, got.numpy())
    if exists:
        assert_bits_equal(TD.slot_exists_of(tt(cap), g).numpy(), mask, "slot_exists_of")


def test_refund_headroom_cumsum_is_chunked():
    """At 32 slots the running headroom is XLA's chunked cumsum: a
    sequential sum gives other fills on these rows, and both packages give
    the chunked ones."""
    rng = np.random.default_rng(9)
    slots = rng.choice(np.asarray([66.7, 33.3, 87.5, 12.5, 0.1], f32), (500, 32))
    refund = np.full(500, 2000.0, f32) + rng.choice(np.asarray([0.3, 33.3, 1.7], f32), 500)
    want = np.asarray(JD.slot_refund(jnp.asarray(slots), jnp.asarray(refund)))
    s = np.sort(slots, axis=1, kind="stable")
    head = (100.0 - s).astype(f32)
    seq = head.copy()
    for i in range(1, 32):
        seq[:, i] = (seq[:, i - 1] + head[:, i]).astype(f32)
    fill = np.clip((refund[:, None] - (seq - head)).astype(f32), 0.0, head)
    order = np.argsort(slots, axis=1, kind="stable")
    sequential = np.zeros_like(slots)
    np.put_along_axis(sequential, order, (s + fill).astype(f32), axis=1)
    assert not np.array_equal(want, sequential)
    assert_bits_equal(want, TD.slot_refund(tt(slots), tt(refund)).numpy())


def test_rollback_refund_sums_in_pod_order():
    """A node's rolled-back shares are summed in pod order before the
    water-fill: on these members another order gives other bits."""
    p, n = 12, 3
    # node 0 holds rows 0, 1, 2, 3, 6, 7, 9, 10: their refund, summed
    # backwards, is 1129.0, forwards 1129.0001
    share = np.asarray([0.3, 87.5, 87.5, 50.0, 33.3, 87.5, 0.1, 70.0, 50.0, 0.3, 33.3, 70.0],
                       f32)
    whole = np.asarray([0, 2, 1, 0, 2, 0, 2, 1, 0, 2, 0, 0], np.int32)
    asg = np.asarray([0, 0, 0, 0, 1, 1, 0, 0, 2, 0, 0, 2], np.int32)
    vals = (whole.astype(f32) * f32(100) + share).astype(f32)
    on0 = vals[asg == 0]
    forward, backward = f32(0), f32(0)
    for v in on0:
        forward = f32(forward + v)
    for v in on0[::-1]:
        backward = f32(backward + v)
    assert forward != backward
    pods = J.PodBatch.create(
        requests=np.ones((p, 2), f32), priority=np.zeros(p, np.int32),
        gang_id=np.zeros(p, np.int32), gang_min=np.full(p, p + 1, np.int32),
        gpu_whole=whole, gpu_share=share, rdma=np.arange(p) % 2, fpga=np.arange(p) % 3 == 0,
    )
    slots = np.zeros((n, 8), f32)
    res = J.SolveResult(
        assignment=jnp.asarray(asg), node_requested=jnp.full((n, 2), 50.0),
        node_estimated_used=jnp.full((n, 2), 50.0), node_prod_used=jnp.zeros((n, 2)),
        quota_used=jnp.zeros((1, 2)), rounds_used=jnp.asarray(1),
        node_dev_slots=jnp.asarray(slots), node_rdma_free=jnp.zeros(n),
        node_fpga_free=jnp.ones(n),
    )
    exists = jnp.arange(8)[None, :] < jnp.asarray([8.0, 4.0, 2.0])[:, None]
    want = J.enforce_gangs(res, pods, exists)
    got = T.enforce_gangs(from_jax(T.SolveResult, res, device="cpu"),
                          from_jax(T.PodBatch, pods, device="cpu"), tt(np.asarray(exists)))
    for f in ("assignment", "node_dev_slots", "node_rdma_free", "node_fpga_free",
              "node_requested"):
        assert_bits_equal(getattr(want, f), getattr(got, f).numpy(), f)
    assert (np.asarray(want.node_dev_slots) > 0).sum() > 8
    assert np.asarray(want.node_dev_slots)[2, 2:].sum() == 0  # padding stays empty


# ---------------------------------------------- twins of test_device_slots.py


def test_slot_stats_unit_case():
    slots = torch.tensor([[100.0, 100.0, 40.0], [70.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    full, partial, smax, total = (a.tolist() for a in TD.slot_stats(slots))
    assert full == [2.0, 0.0, 0.0]
    assert partial == [40.0, 70.0, 0.0]
    assert smax == [100.0, 70.0, 0.0]
    assert total == [240.0, 70.0, 0.0]


def test_fit_mask_exact_combined_whole_plus_share():
    slots = torch.tensor([[100.0, 100.0, 40.0], [100.0, 100.0, 0.0]])
    full, partial, smax, _ = TD.slot_stats(slots)
    whole = torch.tensor([2, 2, 1], dtype=torch.int32)
    share = torch.tensor([30.0, 50.0, 50.0])
    mask = TD.device_fit_mask(whole, share, full, partial, smax)
    assert mask[0].tolist() == [True, False]
    assert mask[1].tolist() == [False, False]
    assert mask[2].tolist() == [True, True]


def test_slot_commit_whole_and_bestfit_partial():
    slots = torch.tensor([[100.0, 100.0, 60.0, 30.0], [100.0, 100.0, 0.0, 0.0],
                          [100.0, 50.0, 0.0, 0.0]])
    out = TD.slot_commit(slots, torch.tensor([1.0, 1.0, 0.0]), torch.tensor([25.0, 50.0, 0.0]),
                         torch.tensor([False, True, False]))
    assert out[0].tolist() == [0.0, 100.0, 60.0, 5.0]
    assert out[1].tolist() == [0.0, 50.0, 0.0, 0.0]
    assert out[2].tolist() == [100.0, 50.0, 0.0, 0.0]


def test_slot_refund_waterfill():
    out = TD.slot_refund(torch.tensor([[0.0, 0.0, 40.0], [70.0, 100.0, 0.0]]),
                         torch.tensor([200.0, 30.0]))
    assert out[0].tolist() == [100.0, 100.0, 40.0]
    assert out[1].tolist() == [70.0, 100.0, 30.0]
    assert (out <= 100.0 + 1e-6).all()


def test_slot_refund_skips_padding_slots():
    out = TD.slot_refund(torch.tensor([[60.0, 0.0, 0.0, 0.0]]), torch.tensor([40.0]),
                         torch.tensor([[True, False, False, False]]))
    assert out[0].tolist() == [100.0, 0.0, 0.0, 0.0]
    assert TD.slot_stats(out)[0][0] == 1.0


@pytest.mark.parametrize("tracked", [True, False])
def test_device_state_carries_across_numpy_and_jax(tracked):
    """``convert`` carries a DeviceState from numpy and from the JAX
    package's pytree and back, an untracked count staying None."""
    from koordinator_tpu_torch.ops.convert import from_numpy, to_numpy

    slots, cap = slot_table(5, 12, 8)
    arrays = dict(slot_free=slots, cap_total=cap,
                  rdma_free=np.arange(12, dtype=f32) if tracked else None,
                  fpga_free=np.ones(12, f32) if tracked else None)
    jstate = JD.DeviceState(**{k: jj(v) for k, v in arrays.items()})
    for state in (from_numpy(TD.DeviceState, device="cpu", **arrays),
                  from_jax(TD.DeviceState, jstate, device="cpu")):
        back = to_numpy(state)
        for k, v in arrays.items():
            if v is None:
                assert back[k] is None
            else:
                assert_bits_equal(v, back[k], k)


def test_device_state_create_keeps_untracked_counts_none():
    state = TD.DeviceState.create(np.full((3, 2), 100.0, f32), cap_total=[200.0] * 3,
                                  device="cpu")
    assert state.rdma_free is None and state.fpga_free is None
    assert state.slot_free.dtype == torch.float32 and state.cap_total.shape == (3,)
    with pytest.raises(ValueError, match="cap_total"):
        TD.DeviceTerms.batch_start(state.slot_free, None, None, None, T.PodBatch.create(
            requests=np.ones((2, 2), f32), priority=[1, 2], device="cpu"), scoring=1,
            units=torch.zeros(2))
