"""Candidate shortlist: each pod's top-(K+1) build over the node axis, and
the round over its K candidates with the exactness check.

Port of the candidate-shortlist solve of ``koordinator_tpu/ops/solver.py``:
the build block of ``assign`` (:949-1015) and ``shortlist_plan``
(:1547-1657), and the round's ``shortlist_feas_cost`` (:1017-1086) with
its shortlist branch (:1158-1201). :func:`shortlist_build` launches
``csrc/shortlist_build.cu`` and :func:`shortlist_round` launches
``csrc/shortlist_round.cu`` on CUDA tensors; on CPU tensors they run
:func:`shortlist_build_plain` and :func:`shortlist_round_plain`. There is
no fallback from one to the other.

Why the shortlist gives the full axis's decisions: node-wise feasibility
only falls and every cost only rises as a batch commits, so the (K+1)-th
best build cost (the bound) lower-bounds every excluded node in every
later round. A round whose k-th nomination beats the bound strictly, for
every active pod, nominates what the full axis would; any other round
falls back to the full-axis nomination (:func:`.nominate.nominate` with
the round's trigger word), decided on the device. Candidates are kept
ascending by node id, so ties broken by position are ties broken by id.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from .costs import load_aware_cost_cols
from .masks import EPS, fit_mask_cols, usage_ok_cols
from .nominate import (
    add_jitter, checked_mask, mask_rows, masked_cost, nomination_vector, zone_terms,
)
from .device import checked_devices
from .numa import checked_zones

#: the largest K the build kernel takes (``kMaxShortlist``)
MAX_SHORTLIST = 1024
#: the largest nomination fan-out k the round kernel takes
MAX_K = 8
#: int32 words a round's word holds: trigger, bound flag, exhausted flag
#: and a fourth the kernels do not use (``nominate`` takes the word as 16
#: bytes)
WORD = 4

_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool


def shortlist_build_plain(
    req, est, is_prod, cpu_bind,
    alloc, requested, est_used, prod_used, fresh, sched, cpu_amp, thr, pthr,
    weights, shortlist_k: int, nomination_jitter: float, mask=None, zones=None,
    devices=None,
):
    """Plain PyTorch shortlist build (``solver.py:949-981``): the masked,
    jittered round-0 cost of every (pod, node) pair with every pod gate
    open, its top-(K+1) by (cost, node id) — the order ``lax.top_k`` gives
    ties — then the first K ids ascending and the (K+1)-th cost. Pod
    tensors are priority-sorted; ``thr``/``pthr`` are the effective [N, D]
    thresholds; ``mask`` the pods' hard node constraints and ``zones`` the
    NUMA terms (:func:`.nominate.nominate` takes them so), ``devices`` the
    device terms, their score clamped at <= 0 (``clamp_device``, :939-940:
    the bound must lower-bound every later round's cost). Returns (plan_cand [P, K]
    int32, plan_bound [P] float32, +inf when fewer than K+1 nodes are
    feasible)."""
    gate = torch.ones(req.shape[0], dtype=_BOOL, device=req.device)
    cost = masked_cost(
        req, est, is_prod, cpu_bind, gate, alloc, requested, est_used,
        prod_used, fresh, sched, cpu_amp, thr, pthr, weights, nomination_jitter, mask, zones,
        devices, clamp_device=True,
    )
    vals, idx = torch.sort(cost, dim=1, stable=True)
    plan_cand = torch.sort(idx[:, :shortlist_k], dim=1).values.to(_I32)
    return plan_cand, vals[:, shortlist_k].contiguous()


#: dtypes of koord_shortlist_build's tensors, in its argument order
_BUILD_DTYPES = (_F32, _F32, _BOOL, _BOOL, _F32, _F32, _F32, _F32, _BOOL, _BOOL,
                 _F32, _F32, _F32, _F32)


def shortlist_build(
    req, est, is_prod, cpu_bind,
    alloc, requested, est_used, prod_used, fresh, sched, cpu_amp, thr, pthr,
    weights, shortlist_k: int, nomination_jitter: float, mask=None, zones=None,
    devices=None,
):
    """The shortlist build on the tensors' device: one launch of
    ``koord_shortlist_build`` (one block a pod, no [P, N] matrix) for CUDA
    tensors, :func:`shortlist_build_plain` for CPU tensors. Same arguments
    and result."""
    args = (req, est, is_prod, cpu_bind, alloc, requested, est_used, prod_used,
            fresh, sched, cpu_amp, thr, pthr, weights)
    if req.is_cpu:
        return shortlist_build_plain(*args, shortlist_k, nomination_jitter, mask, zones,
                                     devices)
    p, d = req.shape
    n = alloc.shape[0]
    if not 1 <= shortlist_k <= min(MAX_SHORTLIST, n - 1):
        raise kernels.KernelArgumentError(
            f"shortlist_build: K={shortlist_k} must be in 1..min({MAX_SHORTLIST}, N-1={n - 1})"
        )
    if not 1 <= d <= 8:
        raise kernels.KernelArgumentError(f"shortlist_build: D={d} must be in 1..8")
    pd, nd = p * d, n * d
    ptrs = kernels.checked_ptrs(
        "shortlist_build", args, _BUILD_DTYPES,
        (pd, pd, p, p, nd, nd, nd, nd, n, n, n, nd, nd, d),
    )
    plan_cand = torch.empty((p, shortlist_k), dtype=_I32, device=req.device)
    plan_bound = torch.empty((p,), dtype=_F32, device=req.device)
    lib = kernels.library("shortlist_build")
    code = lib.koord_shortlist_build(
        *ptrs, p, n, d, shortlist_k, ctypes.c_float(nomination_jitter / 65536.0),
        int(nomination_jitter > 0.0), plan_cand.data_ptr(), plan_bound.data_ptr(),
        *checked_mask("shortlist_build", mask, p, n),
        *checked_zones("shortlist_build", zones, p, n, d),
        *checked_devices("shortlist_build", devices, p, n), 1, kernels.stream_of(req),
    )
    kernels.check(lib, code, "shortlist_build")
    kernels.count("shortlist_build")
    return plan_cand, plan_bound


def shortlist_round_plain(
    req, est, is_prod, cpu_bind, gate,
    alloc, requested, est_used, prod_used, fresh, sched, cpu_amp, thr, pthr,
    weights, plan_cand, plan_bound, k: int, nomination_jitter: float,
    approx_topk: bool, word, counts, state, mask=None, zones=None, devices=None,
):
    """Plain PyTorch shortlist round (``shortlist_feas_cost`` :1017-1086
    and :1158-1201): the masked, jittered cost over each pod's gathered
    candidate columns (the ``_cols`` masks and cost), its exact top-k by
    (cost, position), the nomination vector, and the exactness check — a
    pod is safe when its bound is not finite, or when the k-th cost of its
    exact top-k is finite and below the bound, strictly.

    ``gate`` [P] is the round's gate (its active pods, with quotas those
    with headroom too); ``mask`` the pods' hard node constraints and
    ``zones`` the NUMA terms (the [P, N] fit and score of the batch-start
    table gathered at each pod's candidates, ``solver.py:1001-1008``);
    ``devices`` the device terms at each candidate, from the round-start
    stats (:1052-1081, the score LeastAllocated's: the shortlist is off
    under MostAllocated). ORs into ``word`` [4] int32 (the
    round's, zero before it) (any unsafe pod — the fallback trigger;
    any unsafe pod with a finite candidate; any without) and adds one to
    ``counts`` [2] for each of the last two it finds clear: once a round.
    Returns the nomination (cost [P, k], node
    [P, k]). While the round loop's ``state`` has ``done`` set it changes
    nothing and returns unwritten buffers, as the kernel does."""
    p = req.shape[0]
    if bool(state[0]):
        return (torch.empty((p, k), dtype=_F32, device=req.device),
                torch.empty((p, k), dtype=_I32, device=req.device))
    cand = plan_cand.long()
    alloc_c = alloc[cand]                                     # [P, K, D]
    free_c = alloc_c - requested[cand]
    feas = fit_mask_cols(req, free_c)
    eff_cpu = req[:, 0][:, None] * torch.clamp(cpu_amp, min=1.0)[cand]
    feas &= ~cpu_bind[:, None] | (eff_cpu <= free_c[..., 0] + EPS)
    fresh_c = fresh[cand]
    est_c = est_used[cand]
    feas &= usage_ok_cols(est, est_c, alloc_c, thr[cand], fresh_c)
    feas &= usage_ok_cols(est, prod_used[cand], alloc_c, pthr[cand], fresh_c) | ~is_prod[:, None]
    feas &= sched[cand]
    feas &= gate[:, None]
    if mask is not None:
        feas &= mask_rows(mask).gather(1, cand)
    cost = load_aware_cost_cols(est, est_c, alloc_c, weights, metric_fresh=fresh_c)
    if zones is not None:
        fit, score = zone_terms(req, cpu_bind, cpu_amp, weights, zones)
        feas &= fit.gather(1, cand)
        if score is not None:
            cost = cost + score.gather(1, cand)
    if devices is not None:
        fit, term = devices.fit_and_cost()
        feas &= fit.gather(1, cand)
        if term is not None:
            cost = cost + term.gather(1, cand)
    cost = torch.where(feas, add_jitter(cost, cand, nomination_jitter), torch.inf)
    vals, pos = torch.sort(cost, dim=1, stable=True)
    top_cost = vals[:, :k].contiguous()
    top_idx = plan_cand.gather(1, pos[:, :k])
    kth = top_cost[:, k - 1]
    safe = ~torch.isfinite(plan_bound) | (torch.isfinite(kth) & (kth < plan_bound))
    unsafe = gate & ~safe
    cand_any = torch.isfinite(cost).any(dim=1)
    flags = torch.stack(
        [unsafe.any(), (unsafe & cand_any).any(), (unsafe & ~cand_any).any()]
    ).to(_I32)
    counts += flags[1:] & (word[1:3] == 0).to(_I32)
    word[:3] |= flags
    return nomination_vector(top_cost, top_idx, approx_topk)


#: dtypes of koord_shortlist_round's tensors, in its argument order
_ROUND_DTYPES = (_F32, _F32, _BOOL, _BOOL, _BOOL, _F32, _F32, _F32, _F32, _BOOL,
                 _BOOL, _F32, _F32, _F32, _F32, _I32, _F32)


def shortlist_round(
    req, est, is_prod, cpu_bind, gate,
    alloc, requested, est_used, prod_used, fresh, sched, cpu_amp, thr, pthr,
    weights, plan_cand, plan_bound, k: int, nomination_jitter: float,
    approx_topk: bool, word, counts, state, mask=None, zones=None, devices=None,
):
    """One shortlist round on the tensors' device: one launch of
    ``koord_shortlist_round`` for CUDA tensors (the candidates' rows read
    from the full tables; the flags and counts set on the device, nothing
    read back to the host), :func:`shortlist_round_plain` for CPU tensors.
    Same arguments, in-place updates and result."""
    args = (req, est, is_prod, cpu_bind, gate, alloc, requested, est_used,
            prod_used, fresh, sched, cpu_amp, thr, pthr, weights, plan_cand, plan_bound)
    if req.is_cpu:
        return shortlist_round_plain(*args, k, nomination_jitter, approx_topk,
                                     word, counts, state, mask, zones, devices)
    p, d = req.shape
    n = alloc.shape[0]
    shortlist_k = plan_cand.shape[1]
    if not 1 <= k <= min(MAX_K, shortlist_k):
        raise kernels.KernelArgumentError(
            f"shortlist_round: k={k} must be in 1..min({MAX_K}, K={shortlist_k})"
        )
    if not 1 <= d <= 8:
        raise kernels.KernelArgumentError(f"shortlist_round: D={d} must be in 1..8")
    pd, nd = p * d, n * d
    ptrs = kernels.checked_ptrs(
        "shortlist_round", args + (word, counts, state), _ROUND_DTYPES + (_I32,) * 3,
        (pd, pd, p, p, p, nd, nd, nd, nd, n, n, n, nd, nd, d, p * shortlist_k, p,
         WORD, 2, 2),
    )
    out_cost = torch.empty((p, k), dtype=_F32, device=req.device)
    out_idx = torch.empty((p, k), dtype=_I32, device=req.device)
    lib = kernels.library("shortlist_round")
    code = lib.koord_shortlist_round(
        *ptrs[:17], p, n, d, shortlist_k, k, ctypes.c_float(nomination_jitter / 65536.0),
        int(nomination_jitter > 0.0), int(approx_topk), out_cost.data_ptr(),
        out_idx.data_ptr(), *ptrs[17:], *checked_mask("shortlist_round", mask, p, n),
        *checked_zones("shortlist_round", zones, p, n, d),
        *checked_devices("shortlist_round", devices, p, n), kernels.stream_of(req),
    )
    kernels.check(lib, code, "shortlist_round")
    kernels.count("shortlist_round")
    return out_cost, out_idx
