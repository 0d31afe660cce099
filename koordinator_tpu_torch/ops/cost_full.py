"""The cost-transform route: the round's cost materialized over every
(pod, node) pair, rewritten by the BeforeScore transform, then nominated.

Port of ``koordinator_tpu/ops/solver.py:assign``'s ``cost_transform``
(:942-946) with ``full_feas_cost`` (:864-941), ``add_jitter`` (:732-742)
and ``_full_nominate`` (:1121-1156). The pricing kernels of the other
routes never build the [P, N] cost; a transform needs it, so this route
has two kernels of its own, each with its plain PyTorch version here:

- :func:`cost_full` (``csrc/cost_full.cu``): the pre-jitter cost of every
  pair, fp32 [P, N] — the LoadAware score, the NUMA aligned score and the
  device score, as the reference adds them before the transform — and
  the pair's feasibility, uint8 [P, N] (the fit, the thresholds, the node
  mask, the zone and device fit, the pod gate). The cost is written for
  infeasible pairs too: the transform sees the whole tensor, as in the
  reference.
- the transform, the caller's torch callable ``[P, N] fp32 -> [P, N]
  fp32``, on that buffer;
- :func:`nominate_cost` (``csrc/nominate_cost.cu``): the 16-bit jitter of
  each pair added to the transformed cost, infeasible pairs set to
  ``+inf``, and each pod's top-k by the order ``jax.lax.top_k`` gives on
  the CPU, written as the round's nomination vector (with
  ``approx_topk``, ``[argmin, 1st, 2nd, ...]``), so the round tail runs
  unchanged.

*How the reference ranks what a transform may give* (``approx_max_k``
of ``-cost`` and ``jnp.argmin`` of ``cost``, inside the solver's compiled
round on the CPU): the top-k takes ``-inf`` first, then the finite costs,
then ``+inf``, and every NaN last, whatever its sign (XLA's fusions do
not keep a NaN's sign: the same round hands ``jnp.argmin`` a negative
NaN where the transform wrote a positive one), ties by the lower node
index; ``jnp.argmin`` takes the first NaN of a row that holds one, else
the first of its least values. An all-infeasible row nominates nodes
0..k-1 at ``+inf``. The round tail keeps only finite nominations. Both
versions here rank by those rules (:func:`rank_key`,
:func:`first_argmin`), held by ``tests/test_torch_cost_transform.py``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from .costs import load_aware_cost
from .device import checked_devices
from .nominate import (MAX_K, add_jitter, checked, checked_mask, feasible_mask,
                       zone_terms)
from .numa import checked_zones


def cost_full_plain(
    req, est, is_prod, cpu_bind, gate,
    alloc, requested, est_used, prod_used, fresh, sched, cpu_amp, thr, pthr,
    weights, mask=None, zones=None, devices=None, state=None, out=None,
):
    """Plain PyTorch version of ``csrc/cost_full.cu``: ``(cost [P, N]
    float32, feasible [P, N] uint8)`` of the priority-sorted pods, the
    transcription of ``full_feas_cost`` (``solver.py:864-941``) up to the
    transform — the LoadAware cost (0 on a stale node) plus, with
    ``zones``' scoring, the NUMA aligned term plus, with ``devices``'
    scoring, the device term, for every pair; feasible where the pod gate,
    the fit, the thresholds, the node mask, the NUMA fit and the device
    fit hold. ``mask``, ``zones`` and ``devices`` are
    :func:`.nominate.nominate`'s. With ``out`` the result is written into
    it; with ``state`` (the round loop's word) nothing is written once its
    ``done`` is set."""
    if state is not None and bool(state[0]):
        return out
    feas = feasible_mask(
        req, est, is_prod, cpu_bind, gate,
        alloc, requested, est_used, prod_used, fresh, sched, cpu_amp, thr, pthr, mask,
    )
    cost = load_aware_cost(est, est_used, alloc, weights, metric_fresh=fresh)
    if zones is not None:
        fit, score = zone_terms(req, cpu_bind, cpu_amp, weights, zones)
        feas &= fit
        if score is not None:
            cost = cost + score
    if devices is not None:
        fit, term = devices.fit_and_cost()
        feas &= fit
        if term is not None:
            cost = cost + term
    top = (cost, feas.to(torch.uint8))
    if out is None:
        return top
    for buf, val in zip(out, top):
        buf.copy_(val)
    return out


def rank_key(cost: torch.Tensor) -> torch.Tensor:
    """int32 keys of float32 ``cost`` in the order the reference's top-k
    ranks them: ``-inf < ... < -0.0 < +0.0 < ... < +inf``, the IEEE
    total order (the sign bit flips the other 31 bits of a negative
    value), and every NaN last (``INT32_MAX``)."""
    bits = cost.contiguous().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return torch.where(torch.isnan(cost), torch.iinfo(torch.int32).max, key)


def first_argmin(cost: torch.Tensor) -> torch.Tensor:
    """``jnp.argmin(cost, axis=1)`` as the CPU gives it: the first NaN of
    a row that holds one, else the first of its least values (``-0.0``
    equals ``+0.0``). int64 [P]."""
    nan = torch.isnan(cost)
    low = torch.where(nan, torch.inf, cost)
    least = (low == low.min(dim=1, keepdim=True).values).to(torch.uint8).argmax(dim=1)
    return torch.where(nan.any(dim=1), nan.to(torch.uint8).argmax(dim=1), least)


def nominate_cost_plain(cost, feasible, k: int, nomination_jitter: float, approx_topk: bool,
                        state=None, out=None):
    """Plain PyTorch version of ``csrc/nominate_cost.cu``: ``(cost [P, k]
    float32, node [P, k] int32)``, the round's nomination vector from the
    transformed ``cost`` [P, N] of the priority-sorted pods — the jitter of
    each (sorted pod position, node) pair added (``add_jitter``), ``+inf``
    where ``feasible`` [P, N] is 0, then each pod's k first by
    (:func:`rank_key`, node index); with ``approx_topk`` slot 0 is
    :func:`first_argmin` and the rest the k-1 first
    (``solver.py:1138-1156``). ``state`` and ``out`` as in
    :func:`cost_full_plain`."""
    if state is not None and bool(state[0]):
        return out
    nodes = torch.arange(cost.shape[1], device=cost.device)[None, :]
    jittered = add_jitter(cost, nodes, nomination_jitter)
    ranked = torch.where(feasible.bool(), jittered, torch.inf)
    idx = torch.sort(rank_key(ranked), dim=1, stable=True).indices[:, :k]
    if approx_topk:
        idx = torch.cat([first_argmin(ranked)[:, None], idx[:, : k - 1]], dim=1)
    top = (torch.gather(ranked, 1, idx), idx.to(torch.int32))
    if out is None:
        return top
    for buf, val in zip(out, top):
        buf.copy_(val)
    return out


_F32, _U8, _I32 = torch.float32, torch.uint8, torch.int32


def cost_full(
    req, est, is_prod, cpu_bind, gate,
    alloc, requested, est_used, prod_used, fresh, sched, cpu_amp, thr, pthr,
    weights, mask=None, zones=None, devices=None, state=None, out=None,
):
    """The materialized cost and feasibility on the tensors' device: one
    launch of ``csrc/cost_full.cu`` for CUDA tensors (into ``out`` =
    (cost [P, N] float32, feasible [P, N] uint8), allocated when not
    given), :func:`cost_full_plain` for CPU tensors. With ``state`` the
    kernel returns at once once the round loop's ``done`` is set, leaving
    ``out`` as it was. Returns ``out``."""
    args = (req, est, is_prod, cpu_bind, gate, alloc, requested, est_used,
            prod_used, fresh, sched, cpu_amp, thr, pthr, weights)
    if req.is_cpu:
        return cost_full_plain(*args, mask=mask, zones=zones, devices=devices, state=state,
                               out=out)
    ptrs = checked(args, 1)
    p, d = req.shape
    n = alloc.shape[0]
    if (zones is not None or devices is not None) and d > 8:
        raise kernels.KernelArgumentError(
            f"cost_full: D={d} with NUMA zones or devices must be in 1..8"
        )
    if out is None:
        out = (torch.empty((p, n), dtype=_F32, device=req.device),
               torch.empty((p, n), dtype=_U8, device=req.device))
    extra = kernels.checked_ptrs("cost_full", (req, state) + tuple(out),
                                 (_F32, _I32, _F32, _U8), (p * d, 2, p * n, p * n))
    lib = kernels.library("cost_full")
    code = lib.koord_cost_full(
        *ptrs, p, n, d, extra[2], extra[3], extra[1],
        *checked_mask("cost_full", mask, p, n),
        *checked_zones("cost_full", zones, p, n, d),
        *checked_devices("cost_full", devices, p, n), kernels.stream_of(req),
    )
    kernels.check(lib, code, "cost_full")
    kernels.count("cost_full")
    return out


def nominate_cost(cost, feasible, k: int, nomination_jitter: float, approx_topk: bool,
                  state=None, out=None):
    """The nomination over a given cost on the tensors' device: one launch
    of ``csrc/nominate_cost.cu`` for CUDA tensors, writing ``out`` =
    (cost [P, k] float32, node [P, k] int32) (allocated when not given),
    :func:`nominate_cost_plain` for CPU tensors. ``cost`` [P, N] float32
    is the transformed cost, ``feasible`` [P, N] uint8 the flags of
    :func:`cost_full`; ``state`` as there. Returns ``out``."""
    if cost.is_cpu:
        return nominate_cost_plain(cost, feasible, k, nomination_jitter, approx_topk,
                                   state=state, out=out)
    if cost.dim() != 2 or feasible.shape != cost.shape:
        raise kernels.KernelArgumentError("nominate_cost: cost and feasible must both be [P, N]")
    p, n = cost.shape
    if not 1 <= k <= min(MAX_K, n):
        raise kernels.KernelArgumentError(f"nominate_cost: k={k} must be in 1..min({MAX_K}, N={n})")
    if out is None:
        out = (torch.empty((p, k), dtype=_F32, device=cost.device),
               torch.empty((p, k), dtype=_I32, device=cost.device))
    ptrs = kernels.checked_ptrs("nominate_cost", (cost, feasible, state) + tuple(out),
                                (_F32, _U8, _I32, _F32, _I32), (p * n, p * n, 2, p * k, p * k))
    lib = kernels.library("nominate_cost")
    code = lib.koord_nominate_cost(
        *ptrs[:2], p, n, k, ctypes.c_float(nomination_jitter / 65536.0),
        int(nomination_jitter > 0.0), int(approx_topk), *ptrs[3:], ptrs[2],
        kernels.stream_of(cost),
    )
    kernels.check(lib, code, "nominate_cost")
    kernels.count("nominate_cost")
    return out
