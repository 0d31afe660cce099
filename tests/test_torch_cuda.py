"""The port's CUDA kernels against their plain versions, on the card.

Every test needs a CUDA device and skips without one. The file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Shapes cover the kernels' edges: one pod, fewer nodes than threads, node
counts off the block size, D = 1..3, k = 1..8, commit rounds of 1 to 4,100
pods (one to three scan levels). Tolerance: none — the kernels round as
the plain versions do, so results must be bitwise equal.
"""

import numpy as np
import pytest
import torch

from koordinator_tpu_torch import kernels
from koordinator_tpu_torch.ops import commit as tcommit
from koordinator_tpu_torch.ops import nominate as tnom
from koordinator_tpu_torch.ops import solver as T
from koordinator_tpu_torch.ops.convert import from_numpy, to_numpy

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def nominate_inputs(seed, p, n, d):
    rng = np.random.default_rng(seed)
    alloc = rng.choice([0.0, 4000.0, 32_000.0, 96_000.0], (n, d), p=[0.05, 0.3, 0.35, 0.3])
    alloc = alloc.astype(np.float32)
    used = (alloc * rng.uniform(0.0, 0.8, (n, d))).astype(np.float32)
    req = rng.choice([0.0, 500.0, 1000.0, 4000.0], (p, d)).astype(np.float32)
    thr = np.where(rng.random((n, d)) < 0.6, rng.choice([50.0, 65.0, 95.0], (n, d)), 0.0)
    return [
        req,
        (req * np.float32(0.85)).astype(np.float32),
        rng.random(p) < 0.4,                      # is_prod
        rng.random(p) < 0.3,                      # cpu_bind
        rng.random(p) > 0.05,                     # gate
        alloc,
        (alloc * rng.uniform(0.0, 0.5, (n, d))).astype(np.float32),
        used,
        (used * np.float32(0.6)).astype(np.float32),
        rng.random(n) > 0.1,                      # fresh
        rng.random(n) > 0.05,                     # schedulable
        np.where(rng.random(n) < 0.3, 1.5, 1.0).astype(np.float32),
        thr.astype(np.float32),
        np.where(rng.random((n, d)) < 0.3, 55.0, 0.0).astype(np.float32),
        rng.choice([1.0, 2.0], d).astype(np.float32),
    ]


@pytest.mark.parametrize(
    "p, n, d, k",
    [(1, 1, 1, 1), (3, 7, 2, 4), (37, 300, 3, 8), (512, 1000, 2, 4), (200, 5003, 2, 2)],
)
@pytest.mark.parametrize("jitter, approx", [(4.0, False), (4.0, True), (0.0, False)])
def test_nominate_kernel_matches_plain(cuda, p, n, d, k, jitter, approx):
    arrays = nominate_inputs(p * 7 + n, p, n, d)
    host = [torch.from_numpy(a) for a in arrays]
    dev = [t.to(cuda) for t in host]
    before = kernels.launches["nominate"]
    kc, ki = tnom.nominate(*dev, k, jitter, approx)
    torch.cuda.synchronize()
    assert kernels.launches["nominate"] == before + 1
    pc, pi = tnom.nominate_plain(*host, k, jitter, approx)
    np.testing.assert_array_equal(bits(kc.cpu().numpy()), bits(pc.numpy()))
    np.testing.assert_array_equal(ki.cpu().numpy(), pi.numpy())


def commit_inputs(seed, p, n, d):
    rng = np.random.default_rng(seed)
    alloc = rng.choice([0.0, 32_000.0, 96_000.0], (n, d), p=[0.05, 0.5, 0.45]).astype(np.float32)
    used = (alloc * rng.uniform(0.0, 0.7, (n, d))).astype(np.float32)
    key = np.sort(np.where(rng.random(p) < 0.1, n, rng.integers(0, n, p))).astype(np.int32)
    req = (rng.choice([500.0, 1000.0, 4000.0], (p, d)) * rng.uniform(0.9, 1.6, (p, 1)))
    return [
        key,
        req.astype(np.float32),
        (req * 0.85).astype(np.float32),
        rng.random(p) < 0.4,
        alloc,
        rng.random(n) > 0.1,
        np.where(rng.random((n, d)) < 0.7, 65.0, 0.0).astype(np.float32),
        np.where(rng.random((n, d)) < 0.5, 55.0, 0.0).astype(np.float32),
        (alloc * rng.uniform(0.0, 0.5, (n, d))).astype(np.float32),
        used,
        (used * np.float32(0.6)).astype(np.float32),
    ]


@pytest.mark.parametrize("p", [1, 5, 16, 17, 100, 512, 1000, 4100])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_commit_kernel_matches_plain(cuda, p, d):
    arrays = commit_inputs(p + d, p, max(3, p // 12), d)
    host = [torch.from_numpy(a.copy()) for a in arrays]
    dev = [torch.from_numpy(a.copy()).to(cuda) for a in arrays]
    acc_k = tcommit.commit(*dev, 0.35)
    acc_p = tcommit.commit_plain(*host, 0.35)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(acc_k.cpu().numpy(), acc_p.numpy())
    for tk, tp in zip(dev[8:], host[8:]):
        np.testing.assert_array_equal(bits(tk.cpu().numpy()), bits(tp.numpy()))


def test_commit_refuses_a_round_too_large_for_one_block(cuda):
    arrays = commit_inputs(1, 20_000, 100, 8)
    dev = [torch.from_numpy(a.copy()).to(cuda) for a in arrays]
    with pytest.raises(RuntimeError, match="commit: CUDA error"):
        tcommit.commit(*dev, 0.35)


@pytest.mark.parametrize("m, c, s", [(1, 1, 1), (700, 6, 50), (512, 6, 10_000)])
def test_segment_sum_kernel_matches_plain(cuda, m, c, s):
    rng = np.random.default_rng(m)
    vals = torch.from_numpy((rng.uniform(0, 5000, (m, c)) * 0.85).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-2, s + 3, m).astype(np.int32))
    got = tcommit.segment_sum(vals.to(cuda), ids.to(cuda), s)
    want = tcommit.segment_sum_plain(vals, ids, s)
    np.testing.assert_array_equal(bits(got.cpu().numpy()), bits(want.numpy()))


@pytest.mark.parametrize("approx", [False, True])
def test_assign_on_card_matches_cpu(cuda, approx):
    """The whole round solver through the kernels equals its CPU run,
    with gangs, cpuset-bound pods and padded pods."""
    rng = np.random.default_rng(11)
    p, n = 256, 40
    alloc = (rng.choice([8000.0, 32_000.0], (n, 1)) * np.array([1.0, 4.0])).astype(np.float32)
    used = (alloc * rng.uniform(0.05, 0.6, (n, 1))).astype(np.float32)
    nodes = dict(
        allocatable=alloc, estimated_used=used, prod_used=(used * np.float32(0.6)),
        metric_fresh=rng.random(n) > 0.1,
        cpu_amp=np.where(rng.random(n) < 0.4, 1.5, 1.0).astype(np.float32),
    )
    cpu = rng.choice([500.0, 1000.0, 2000.0, 4000.0], p)
    req = np.stack([cpu, cpu * 4], 1).astype(np.float32)
    gmin = np.zeros(p, np.int32)
    gmin[:6] = rng.integers(2, 16, 6)
    pods = dict(
        requests=req, estimate=(req * np.float32(0.85)),
        priority=rng.integers(5000, 9999, p).astype(np.int32),
        qos=rng.choice([0, 3], p).astype(np.int8), valid=rng.random(p) > 0.05,
        gang_id=np.where(rng.random(p) < 0.4, rng.integers(0, 6, p), -1).astype(np.int32),
        gang_min=gmin, gang_nonstrict=np.arange(p) == 1,
    )
    params = dict(
        usage_thresholds=np.array([65.0, 95.0], np.float32),
        prod_thresholds=np.array([55.0, 0.0], np.float32),
        score_weights=np.ones(2, np.float32),
    )

    def run(device):
        return to_numpy(T.assign(
            from_numpy(T.PodBatch, device=device, **pods),
            from_numpy(T.NodeState, device=device, **nodes),
            from_numpy(T.SolverParams, device=device, **params),
            max_rounds=12, approx_topk=approx,
        ))

    kernels.reset_launches()
    got = run(cuda)
    assert min(kernels.launches[k] for k in ("nominate", "commit", "segment_sum")) > 0
    want = run("cpu")
    for f in ("assignment", "rounds_used", "node_requested",
              "node_estimated_used", "node_prod_used"):
        np.testing.assert_array_equal(bits(got[f]), bits(want[f]), err_msg=f)
