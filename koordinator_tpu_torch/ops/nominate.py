"""Round nomination: masked, jittered LoadAware cost and per-pod top-k.

Port of ``koordinator_tpu/ops/solver.py:_full_nominate`` (:1121-1156) with
``full_feas_cost`` (:864-947). :func:`nominate` launches the hand-written
kernel ``csrc/nominate.cu`` on CUDA tensors and runs :func:`nominate_plain`
on CPU tensors; there is no fallback from one to the other.

Pods arrive in priority-sorted order: the jitter hash is keyed on a pod's
sorted position, as the reference's ``add_jitter`` keys it on ``arange(P)``
over ``spods``. Costs are ranked by (value, node index), the order
``jax.lax.top_k`` and ``jnp.argmin`` give ties; ``torch.topk`` gives no such
promise, so neither path uses it.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from .costs import load_aware_cost
from .masks import EPS, fit_mask, usage_ok


def _jitter_hash(pi: torch.Tensor, ni: torch.Tensor) -> torch.Tensor:
    """Knuth multiplicative nomination-jitter hash folded to 16 bits
    (``solver.py:587``). Computed in int64: the low 16 bits of the uint32
    product-sum do not depend on the wrap, and torch's uint32 support is
    partial."""
    return (pi.long() * 2654435761 + ni.long() * 40503) & 0xFFFF


def feasible_mask(
    req, est, is_prod, cpu_bind, gate,
    alloc, requested, est_used, prod_used, fresh, sched, cpu_amp, thr, pthr,
):
    """[P, N] feasibility (``solver.py:_feasible``, :625-657): fit,
    amplified-CPU fit for cpu-bind pods, usage and prod thresholds (``thr``
    and ``pthr`` effective, [N, D]), schedulable, pod gate."""
    free = alloc - requested
    feas = fit_mask(req, free)
    amp = torch.clamp(cpu_amp, min=1.0)
    eff_cpu = req[:, 0][:, None] * amp[None, :]
    feas &= ~cpu_bind[:, None] | (eff_cpu <= free[:, 0][None, :] + EPS)
    feas &= usage_ok(est, est_used, alloc, thr, fresh)
    feas &= usage_ok(est, prod_used, alloc, pthr, fresh) | ~is_prod[:, None]
    feas &= sched[None, :]
    feas &= gate[:, None]
    return feas


def nomination_vector(top_cost, top_idx, approx_topk: bool):
    """The round's nomination vector from the exact (value, index)-ordered
    top-k. With ``approx_topk`` the reference pins slot 0 to the exact
    argmin and fills the rest from ``approx_max_k``, which is exact on the
    CPU: ``[best, best, 2nd, ...]`` (``solver.py:1147-1153``)."""
    if not approx_topk:
        return top_cost, top_idx
    k = top_cost.shape[1]
    return (
        torch.cat([top_cost[:, :1], top_cost[:, : k - 1]], dim=1),
        torch.cat([top_idx[:, :1], top_idx[:, : k - 1]], dim=1),
    )


def nominate_plain(
    req, est, is_prod, cpu_bind, gate,
    alloc, requested, est_used, prod_used, fresh, sched, cpu_amp, thr, pthr,
    weights, k: int, nomination_jitter: float, approx_topk: bool,
):
    """Plain PyTorch nomination: the reference's formulas on [P, N]
    tensors. Pod tensors ([P, D] / [P]) are priority-sorted; node tables
    are [N, D] / [N]; ``thr``/``pthr`` are the effective [N, D] usage and
    prod thresholds. Returns (cost [P, k] float32, node [P, k] int32)."""
    p, n = req.shape[0], alloc.shape[0]
    feas = feasible_mask(
        req, est, is_prod, cpu_bind, gate,
        alloc, requested, est_used, prod_used, fresh, sched, cpu_amp, thr, pthr,
    )
    cost = load_aware_cost(est, est_used, alloc, weights, metric_fresh=fresh)
    if nomination_jitter > 0.0:
        pi = torch.arange(p, device=req.device)[:, None]
        ni = torch.arange(n, device=req.device)[None, :]
        h = _jitter_hash(pi, ni)
        cost = cost + h.to(torch.float32) * (nomination_jitter / 65536.0)
    cost = torch.where(feas, cost, torch.inf)
    vals, idx = torch.sort(cost, dim=1, stable=True)
    return nomination_vector(
        vals[:, :k].contiguous(), idx[:, :k].to(torch.int32), approx_topk
    )


def nominate(
    req, est, is_prod, cpu_bind, gate,
    alloc, requested, est_used, prod_used, fresh, sched, cpu_amp, thr, pthr,
    weights, k: int, nomination_jitter: float, approx_topk: bool,
):
    """Round nomination on the tensors' device: the CUDA kernel for CUDA
    tensors, :func:`nominate_plain` for CPU tensors. Same arguments and
    result as :func:`nominate_plain`."""
    args = (req, est, is_prod, cpu_bind, gate, alloc, requested, est_used,
            prod_used, fresh, sched, cpu_amp, thr, pthr, weights)
    if req.device.type == "cpu":
        return nominate_plain(*args, k, nomination_jitter, approx_topk)
    kernels.require_cuda("nominate", *args)
    p, d = req.shape
    n = alloc.shape[0]
    if not 1 <= k <= min(8, n):
        raise ValueError(f"nominate: k={k} must be in 1..min(8, N={n})")
    for t in (req, est, alloc, requested, est_used, prod_used, thr, pthr):
        if t.dtype != torch.float32 or t.shape[-1] != d:
            raise ValueError("nominate: [.., D] tables must be float32")
    for t in (is_prod, cpu_bind, gate, fresh, sched):
        if t.dtype != torch.bool:
            raise ValueError("nominate: masks must be bool")
    out_cost = torch.empty((p, k), dtype=torch.float32, device=req.device)
    out_idx = torch.empty((p, k), dtype=torch.int32, device=req.device)
    lib = kernels.library("nominate")
    code = lib.koord_nominate(
        *(t.data_ptr() for t in args),
        p, n, d, k,
        ctypes.c_float(nomination_jitter / 65536.0),
        int(nomination_jitter > 0.0),
        out_cost.data_ptr(), out_idx.data_ptr(),
        kernels.stream_of(req),
    )
    kernels.check(lib, code, "nominate")
    kernels.launches["nominate"] += 1
    return nomination_vector(out_cost, out_idx, approx_topk)
