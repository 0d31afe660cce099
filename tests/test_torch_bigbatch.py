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
