"""The port's five scoring programs against the JAX package on the CPU.

``koordinator_tpu.ops.costs``' ``least_allocated_cost``,
``most_allocated_cost``, ``scarce_resource_cost`` and ``fit_plus_cost``
and ``koordinator_tpu.ops.numa.numa_alignment_cost`` against their
counterparts in ``koordinator_tpu_torch`` (on CPU tensors each runs its
plain twin, the oracle of ``csrc/score_programs.cu``), on the same numpy
inputs (``chip_smoke.score_fixture``: zero allocatable, requested above
allocatable so the clip binds, pods asking for nothing in some dims) at
D = 1, 2 and 4, Z = 1, 2 and 4 and DN = 1 to 4 (3: the mean's reciprocal
is inexact). Tolerance: none — bitwise equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from koordinator_tpu.ops import costs as JC
from koordinator_tpu.ops import numa as JN
from koordinator_tpu_torch import kernels
from koordinator_tpu_torch.ops import costs as TC
from koordinator_tpu_torch.ops import numa as TN
from tools import make_torch_golden

torch.set_num_threads(1)


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_bits(want, got, what):
    assert np.asarray(want).dtype == got.dtype == np.float32, what
    np.testing.assert_array_equal(bits(want), bits(got), err_msg=what)


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("name", list(chip_smoke.SCORE_ARGS))
def test_request_programs_match_reference(d, name):
    fix = chip_smoke.score_fixture(5 + d, 48, 300, d, 2)
    args = chip_smoke.SCORE_ARGS[name]
    want = getattr(JC, name)(*(jnp.asarray(fix[a]) for a in args))
    got = getattr(TC, name)(*(torch.from_numpy(fix[a]) for a in args))
    assert_bits(want, got.numpy(), name)
    if name in ("fit_plus_cost", "least_allocated_cost"):
        # the clip and the zero-allocatable branches are reached
        after = fix["node_requested"][None] + fix["pod_req"][:, None]
        assert (after > fix["node_allocatable"][None]).any()
        assert (fix["node_allocatable"] == 0).any() and (fix["pod_req"] == 0).any()


@pytest.mark.parametrize("n_scarce", range(9))
def test_scarce_resource_cost_at_every_count_of_scarce_dims(n_scarce):
    """``100 / n_scarce`` is a float32 division (inexact at 3, 6 and 7
    scarce dims, where a reciprocal times 100 rounds otherwise)."""
    fix = chip_smoke.score_fixture(3, 24, 50, 8, 2)
    scarce = np.arange(8) < n_scarce
    args = (fix["pod_req"], fix["node_allocatable"], scarce)
    want = JC.scarce_resource_cost(*(jnp.asarray(a) for a in args))
    got = TC.scarce_resource_cost(*(torch.from_numpy(a) for a in args))
    assert_bits(want, got.numpy(), f"scarce {n_scarce}")
    if n_scarce:
        assert got.numpy().max() > 0


def test_scarce_resource_cost_without_scarce_dims_is_zero():
    """No scarce dim: ``n_scarce`` is clamped to 1 and every pair costs 0."""
    fix = chip_smoke.score_fixture(1, 16, 40, 2, 2)
    none = np.zeros(2, bool)
    want = JC.scarce_resource_cost(jnp.asarray(fix["pod_req"]),
                                   jnp.asarray(fix["node_allocatable"]), jnp.asarray(none))
    got = TC.scarce_resource_cost(torch.from_numpy(fix["pod_req"]),
                                  torch.from_numpy(fix["node_allocatable"]),
                                  torch.from_numpy(none))
    assert_bits(want, got.numpy(), "scarce")
    assert not got.any()


@pytest.mark.parametrize("z", [1, 2, 4])
@pytest.mark.parametrize("dn", [1, 2, 3, 4])
@pytest.mark.parametrize("most", [False, True])
def test_numa_alignment_cost_matches_reference(z, dn, most):
    fix = chip_smoke.score_fixture(11 + z, 48, 300, 4, z, dn=dn)
    zf = fix["zone_free"]
    n = zf.shape[0]
    want = JN.numa_alignment_cost(
        jnp.asarray(fix["pod_req"]),
        JN.NumaState(zone_free=jnp.asarray(zf), zone_cap=jnp.asarray(zf),
                     policy=jnp.zeros((n,), jnp.int8)), most)
    got = TN.numa_alignment_cost(
        torch.from_numpy(fix["pod_req"]),
        TN.NumaState.create(zf, zf, np.zeros(n, np.int8), device="cpu"), most)
    assert_bits(want, got.numpy(), f"numa z={z} dn={dn} most={most}")
    # some pairs fit no zone (-1, cost 1), some fit one
    assert (got.numpy() == 1.0).any() and (got.numpy() < 0).any()


def test_wrappers_run_the_plain_twins_on_the_cpu():
    """On CPU tensors no kernel is launched; each entry is its twin."""
    fix = chip_smoke.score_fixture(2, 8, 20, 2, 2)
    kernels.reset_launches()
    for name, args in chip_smoke.SCORE_ARGS.items():
        t = [torch.from_numpy(fix[a]) for a in args]
        np.testing.assert_array_equal(
            bits(getattr(TC, name)(*t).numpy()), bits(getattr(TC, f"{name}_plain")(*t).numpy()))
    assert not kernels.launches


@pytest.mark.parametrize("z", chip_smoke.SCORE_ZONES)
def test_golden_digests_are_the_reference(z):
    """The sequential golden's scoring digests, which the smoke's phase 17
    holds the kernels to at 512 × 10,000, are the JAX package's on that
    fixture (recomputed here), and the port's twins give the same bits."""
    fix = chip_smoke.score_fixture(chip_smoke.SCORE_SEED, chip_smoke.SCORE_PODS,
                                   chip_smoke.N_NODES, 2, z)
    want = make_torch_golden.jax_scores(fix, z)
    with np.load(chip_smoke.GOLDEN_SEQUENTIAL) as golden:
        for name, a in want.items():
            assert str(golden[f"score_z{z}_{name}_sha256"]) == chip_smoke.array_digest(a), name
    t = {k: torch.from_numpy(v) for k, v in fix.items()}
    for name, args in chip_smoke.SCORE_ARGS.items():
        got = getattr(TC, name)(*(t[a] for a in args))
        assert chip_smoke.array_digest(got.numpy()) == chip_smoke.array_digest(want[name]), name
    numa = TN.NumaState.create(fix["zone_free"], fix["zone_free"],
                               np.zeros(chip_smoke.N_NODES, np.int8), device="cpu")
    for most in (False, True):
        got = TN.numa_alignment_cost(t["pod_req"], numa, most)
        key = f"numa_alignment_cost_z{z}_{'most' if most else 'least'}"
        assert chip_smoke.array_digest(got.numpy()) == chip_smoke.array_digest(want[key]), key
