"""Gang rollback: the port's ``enforce_gangs`` (plain route on the CPU)
against ``koordinator_tpu.ops.solver.enforce_gangs``.

Same numpy inputs on both sides: a solved batch with Strict and NonStrict
gangs, several refunds landing on one node and a rollback on node N-1 (the
reference's sink row for rows with nothing to refund). Assignments and all
three node tables must be bitwise equal (tolerance: none — both sum each
node's refunds in row order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koordinator_tpu.ops import solver as J
from koordinator_tpu_torch import kernels
from koordinator_tpu_torch.ops import solver as T
from koordinator_tpu_torch.ops.convert import from_numpy

torch.set_num_threads(1)
torch.use_deterministic_algorithms(True)

TABLES = ("node_requested", "node_estimated_used", "node_prod_used")


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def gang_batch(seed, p=64, n=12, d=2):
    """A solved batch: numpy (result, pods). Gang 0 is Strict, short of
    its minMember and has three members on node N-1; gang 1 is NonStrict
    and short too; the others draw their minima."""
    rng = np.random.default_rng(seed)
    assignment = np.where(rng.random(p) < 0.85, rng.integers(0, n, p), -1)
    gang_id = np.where(rng.random(p) < 0.6, rng.integers(0, 6, p), -1)
    gang_id[:3], assignment[:3] = 0, n - 1
    gang_min = np.zeros(p, np.int32)
    gang_min[:6] = rng.integers(2, 12, 6)
    gang_min[0] = gang_min[1] = p + 1
    nonstrict = np.zeros(p, bool)
    nonstrict[1:6] = rng.random(5) < 0.5
    nonstrict[1] = True
    req = (rng.uniform(100, 5000, (p, d)) * np.float32(0.85)).astype(np.float32)
    pods = dict(
        requests=req,
        estimate=(req * np.float32(0.7)).astype(np.float32),
        priority=rng.integers(5000, 9999, p).astype(np.int32),
        is_prod=rng.random(p) < 0.4,
        gang_id=gang_id.astype(np.int32),
        gang_min=gang_min,
        gang_nonstrict=nonstrict,
    )
    tables = {
        name: rng.uniform(1e4, 1e5, (n, d)).astype(np.float32) for name in TABLES
    }
    result = dict(assignment=assignment.astype(np.int32), **tables)
    return result, pods


def port_result(result, p, d):
    t = {k: torch.from_numpy(v.copy()) for k, v in result.items()}
    return T.SolveResult(
        quota_used=torch.zeros((1, d)),
        rounds_used=torch.tensor(1, dtype=torch.int32),
        pod_zone=torch.full((p,), -1, dtype=torch.int32),
        **t,
    )


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_enforce_gangs_plain_matches_reference(seed, d):
    result, pods = gang_batch(seed, d=d)
    p, n = len(result["assignment"]), result["node_requested"].shape[0]
    want = J.enforce_gangs(
        J.SolveResult(
            quota_used=jnp.zeros((1, d)), rounds_used=jnp.int32(1),
            **{k: jnp.asarray(v) for k, v in result.items()},
        ),
        J.PodBatch.create(**pods),
    )
    before = dict(kernels.launches)
    got = T.enforce_gangs(port_result(result, p, d), from_numpy(T.PodBatch, device="cpu", **pods))
    assert dict(kernels.launches) == before  # CPU tensors: no kernel launch
    np.testing.assert_array_equal(np.asarray(want.assignment), got.assignment.numpy())
    for f in TABLES:
        np.testing.assert_array_equal(bits(getattr(want, f)), bits(getattr(got, f).numpy()), err_msg=f)
    # the fixture really rolls back, on node N-1 among others, and one node
    # gets several refunds; the NonStrict gang keeps its members
    rolled = (result["assignment"] >= 0) & (got.assignment.numpy() < 0)
    assert rolled[:3].all()
    assert np.bincount(result["assignment"][rolled], minlength=n).max() >= 2
    kept_ns = (pods["gang_id"] == 1) & (result["assignment"] >= 0)
    assert (got.assignment.numpy()[kept_ns] >= 0).all()
    assert (got.pod_zone.numpy() == -1).all()


def test_enforce_gangs_does_not_mutate_its_argument():
    result, pods = gang_batch(4)
    arg = port_result(result, len(result["assignment"]), 2)
    saved = {f.name: getattr(arg, f.name).clone() for f in dataclasses.fields(arg)
             if getattr(arg, f.name) is not None}
    out = T.enforce_gangs(arg, from_numpy(T.PodBatch, device="cpu", **pods))
    for name, value in saved.items():
        np.testing.assert_array_equal(getattr(arg, name).numpy(), value.numpy(), err_msg=name)
    assert not np.array_equal(out.node_requested.numpy(), saved["node_requested"].numpy())


def test_in_place_form_equals_the_functional_one():
    result, pods = gang_batch(5, p=100, n=9, d=3)
    tp = from_numpy(T.PodBatch, device="cpu", **pods)
    want = T.enforce_gangs_plain(port_result(result, 100, 3), tp)
    got = port_result(result, 100, 3)
    T._enforce_gangs_(got, tp)
    for f in ("assignment", "pod_zone") + TABLES:
        np.testing.assert_array_equal(bits(getattr(want, f).numpy()), bits(getattr(got, f).numpy()))


def long_rollback(seed, p=512, n=16, d=2, z=2, dn=2, g=8, q=9, levels=4):
    """A solved batch whose rollback has long runs, with zones, devices and
    a quota tree on: a quarter of the pods sit on node 3 and every one of
    them is in Strict gang 0, which is short of its minMember, as are
    half the others; every chain's last level is root quota 0 (so one
    quota holds every rolled-back row), the levels below draw their quotas,
    some -1 or past the table. Zone picks with some past Z (clipped),
    charges; whole GPUs, shares, RDMA and FPGA. Returns the JAX package's
    (result, pods, slot_exists)."""
    rng = np.random.default_rng(seed)
    assignment = rng.integers(0, n, p)
    assignment[rng.random(p) < 0.25] = 3
    assignment[rng.random(p) < 0.08] = -1
    gang_id = np.where((assignment == 3) | (rng.random(p) < 0.5), 0,
                       np.where(rng.random(p) < 0.5, rng.integers(1, 6, p), -1))
    gang_min = np.zeros(p, np.int32)
    gang_min[:6] = rng.integers(2, 40, 6)
    gang_min[0] = p + 1
    nonstrict = np.zeros(p, bool)
    nonstrict[2] = True
    chain = rng.integers(-1, q + 2, (p, levels)).astype(np.int32)
    chain[:, -1] = 0
    req = (rng.uniform(100, 5000, (p, d)) * np.float32(0.85)).astype(np.float32)
    pods = J.PodBatch.create(
        requests=req, estimate=(req * np.float32(0.7)).astype(np.float32),
        priority=rng.integers(5000, 9999, p).astype(np.int32), is_prod=rng.random(p) < 0.4,
        gang_id=gang_id.astype(np.int32), gang_min=gang_min, gang_nonstrict=nonstrict,
        quota_chain=chain, gpu_whole=rng.choice([0, 0, 1, 2], p).astype(np.int32),
        gpu_share=rng.choice([0.0, 0.0, 30.0, 50.0, 87.5], p).astype(np.float32),
        rdma=(rng.random(p) < 0.3).astype(np.int32), fpga=(rng.random(p) < 0.2).astype(np.int32),
    )
    pod_zone = np.where((assignment >= 0) & (rng.random(p) < 0.6), rng.integers(0, z + 2, p), -1)
    result = J.SolveResult(
        assignment=jnp.asarray(assignment.astype(np.int32)),
        **{name: jnp.asarray(rng.uniform(1e4, 1e5, (n, d)).astype(np.float32)) for name in TABLES},
        quota_used=jnp.asarray(rng.uniform(1e5, 1e6, (q, d)).astype(np.float32)),
        rounds_used=jnp.int32(1),
        node_dev_slots=jnp.asarray(rng.choice([0.0, 12.5, 50.0, 100.0], (n, g)).astype(np.float32)),
        node_rdma_free=jnp.asarray(rng.integers(0, 4, n).astype(np.float32)),
        node_fpga_free=jnp.asarray(rng.integers(0, 3, n).astype(np.float32)),
        node_zone_free=jnp.asarray(rng.uniform(1e3, 1e4, (n, z, dn)).astype(np.float32)),
        pod_zone=jnp.asarray(pod_zone.astype(np.int32)),
        pod_zone_charge=jnp.asarray(rng.uniform(10, 900, (p, dn)).astype(np.float32)),
    )
    exists = jnp.arange(g)[None, :] < jnp.asarray(rng.integers(2, g + 1, n))[:, None]
    return result, pods, exists


@pytest.mark.parametrize("seed", [0, 1])
def test_enforce_gangs_plain_long_runs_match_reference(seed):
    """The rollback the kernel's chains take longest on: one node with 64
    or more rolled-back rows, one root quota over all of them, with the
    zone, device and quota refunds on: bitwise equal to the reference."""
    from koordinator_tpu_torch.ops.convert import from_jax

    result, pods, exists = long_rollback(seed)
    want = J.enforce_gangs(result, pods, exists)
    got = T.enforce_gangs(from_jax(T.SolveResult, result, device="cpu"),
                          from_jax(T.PodBatch, pods, device="cpu"),
                          torch.from_numpy(np.array(exists)))
    for f in ("assignment", "pod_zone", "quota_used", "node_zone_free", "node_dev_slots",
              "node_rdma_free", "node_fpga_free") + TABLES:
        np.testing.assert_array_equal(bits(getattr(want, f)), bits(getattr(got, f).numpy()),
                                      err_msg=f)
    before = np.asarray(result.assignment)
    rolled = (before >= 0) & (got.assignment.numpy() < 0)
    assert (rolled & (before == 3)).sum() >= 64
    assert rolled.sum() > 200
    # the root quota took every rolled-back row's request off
    assert not np.array_equal(bits(result.quota_used)[0], bits(got.quota_used.numpy())[0])
    assert (rolled & (np.asarray(result.pod_zone) >= 2)).any()  # picks past Z, clipped
