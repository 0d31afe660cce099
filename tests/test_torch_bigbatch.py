"""A round above 4,096 pods: the port's plain path against the JAX package's
big-batch golden on the CPU.

The JAX scheduler makes a gang larger than its batch bucket (4,096 pods at
D = 4) a chunk of its own, padded to the next power of two, so the round
solver must take such batches whole. ``tests/data/torch_golden_bigbatch.npz``
(``tools/make_torch_golden.py --bigbatch``) holds ``assign`` on one batch of
8,192 pods at D = 4 over 2,000 nodes (``chip_smoke.bigbatch_fixture``: a
Strict gang of 6,000 members that cannot be placed whole and rolls back, a
NonStrict gang that keeps its placed members), without quotas and with the
sorted-branch quota tree. The port must reproduce it; the card's kernels
are held to it in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
Tolerance: none — assignments, rounds and tables are bitwise equal.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from koordinator_tpu_torch.ops import solver as T
from koordinator_tpu_torch.ops.convert import to_numpy
from tools import make_torch_golden

torch.set_num_threads(1)
torch.use_deterministic_algorithms(True)

FIELDS = (("assignment", "assignment"), ("rounds_used", "rounds"),
          ("node_requested", "requested"), ("node_estimated_used", "estimated_used"),
          ("node_prod_used", "prod_used"))


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def test_bigbatch_golden_file_holds_the_reference():
    gold = np.load(chip_smoke.GOLDEN_BIGBATCH)
    fresh = make_torch_golden.bigbatch_arrays()
    assert sorted(fresh) == sorted(gold.files)
    for key, value in fresh.items():
        np.testing.assert_array_equal(bits(value), bits(gold[key]), err_msg=key)


@pytest.mark.parametrize("quota", [False, True])
def test_bigbatch_golden_on_the_plain_path(quota):
    gold = np.load(chip_smoke.GOLDEN_BIGBATCH)
    pods, nodes, params, quotas = chip_smoke.big_port_inputs(torch, chip_smoke.BIG_PODS, quota,
                                                             "cpu")
    res = to_numpy(T.assign(pods, nodes, params, quotas=quotas, **chip_smoke.SOLVE))
    key = "quota" if quota else "plain"
    for f, g in FIELDS + ((("quota_used", "quota_used"),) if quota else ()):
        np.testing.assert_array_equal(bits(res[f]), bits(gold[f"{key}_{g}"]), err_msg=f)
    asg = res["assignment"]
    # the Strict gang rolled back whole; the NonStrict one kept its members
    assert (asg[: chip_smoke.BIG_GANG] < 0).all()
    assert (asg[chip_smoke.BIG_GANG : chip_smoke.BIG_GANG + 500] >= 0).sum() > 300


def test_bigbatch_32768_golden_file_holds_the_reference():
    """The 32,768-pod golden (the round tail's largest batch, checked
    against the kernels on the card) is what the JAX package gives now."""
    gold = np.load(chip_smoke.GOLDEN_BIGBATCH_32K)
    fresh = make_torch_golden.bigbatch_32k_arrays()
    assert sorted(fresh) == sorted(gold.files)
    for key, value in fresh.items():
        np.testing.assert_array_equal(bits(value), bits(gold[key]), err_msg=key)
    asg = gold["plain_assignment"]
    assert asg.shape == (32_768,) and (asg[: chip_smoke.BIG_GANG] < 0).all()


@pytest.mark.parametrize("quota", [False, True])
def test_round_of_65536_pods_with_a_gang_of_32769_matches_reference(quota):
    """The batch of a Strict gang of 32,769 members, as the JAX scheduler
    pads it (65,536 pods; ``chip_smoke.bigbatch_fixture(HUGE_PODS,
    gang=HUGE_GANG)`` over 16 nodes): the port's ``assign`` on the plain
    path equals the JAX package's, without quotas and with the sorted
    tree. The gang rolls back; the card runs the same round in
    ``csrc/round_huge.cu``."""
    import jax.numpy as jnp

    from koordinator_tpu.ops import solver as J
    from koordinator_tpu_torch.ops.convert import from_jax

    nodes, pods, params = chip_smoke.bigbatch_fixture(chip_smoke.HUGE_PODS, n_nodes=16,
                                                      gang=chip_smoke.HUGE_GANG)
    jq = tq = None
    if quota:
        pods, (runtime, used) = chip_smoke.bigbatch_quotas(pods)
        jq = J.QuotaState(runtime=jnp.asarray(runtime), used=jnp.asarray(used))
        tq = from_jax(T.QuotaState, jq, device="cpu")
    jp, jn = J.PodBatch.create(**pods), J.NodeState.create(**nodes)
    jpar = J.SolverParams(**{k: jnp.asarray(v) for k, v in params.items()})
    want = J.assign(jp, jn, jpar, quotas=jq, **chip_smoke.SOLVE)
    got = T.assign(from_jax(T.PodBatch, jp, device="cpu"), from_jax(T.NodeState, jn, device="cpu"),
                   from_jax(T.SolverParams, jpar, device="cpu"), quotas=tq, **chip_smoke.SOLVE)
    fields = [f for f, _ in FIELDS] + (["quota_used"] if quota else [])
    for f in fields:
        np.testing.assert_array_equal(bits(getattr(want, f)), bits(getattr(got, f).numpy()),
                                      err_msg=f)
    asg = got.assignment.numpy()
    assert asg.shape == (chip_smoke.HUGE_PODS,) and (asg[: chip_smoke.HUGE_GANG] < 0).all()
    assert (asg >= 0).sum() > 100


def test_bigbatch_65536_golden_file_is_of_this_fixture():
    """The 65,536-pod golden (``make_torch_golden.bigbatch_64k_arrays``,
    the JAX package at 2,000 nodes: a minute and a few GB, too large to
    redo here) was made from the fixture ``chip_smoke`` builds now, and
    holds each output's digest."""
    gold = np.load(chip_smoke.GOLDEN_BIGBATCH_64K)
    nodes, pods, params = chip_smoke.bigbatch_fixture(chip_smoke.HUGE_PODS,
                                                      gang=chip_smoke.HUGE_GANG)
    q_pods, _ = chip_smoke.bigbatch_quotas(pods)
    assert str(gold["fixture_sha256"]) == chip_smoke.fixture_digest(nodes, q_pods, params)
    for key in ("plain", "quota"):
        for name in make_torch_golden.BIGBATCH_64K_OUTPUTS:
            assert len(str(gold[f"{key}_{name}_sha256"])) == 64
        assert int(gold[f"{key}_rounds"]) >= 1 and int(gold[f"{key}_placed"]) > 0
