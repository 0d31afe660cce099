"""The exact sequential-commit solver's two kernels and their plain twins.

Port of ``koordinator_tpu/ops/solver.py:assign_sequential`` (:1990-2241)
below its set-up: the shortlist build (:2044-2085) and the ``lax.scan``
over the priority-sorted pods (:2087-2226). :func:`sequential_build`
launches ``csrc/shortlist_build.cu`` with the jitter off — its ranking by
(cost, node id) with cost = -score is the reference's ``top_k`` of the
score, and its feasibility is the build's — and :func:`sequential_scan`
launches ``csrc/sequential.cu``, one persistent block for every step. On
CPU tensors they run :func:`sequential_build_plain` and
:func:`sequential_scan_plain`, which follow the reference operation for
operation; there is no fallback from one to the other.

Why the shortlist gives the full axis's decisions (:2000-2010): usage only
grows as pods commit, so an excluded node's build score bounds its score
at every later step from above, and build infeasibility is permanent. A
step whose best candidate's score strictly beats the (K+1)-th build score
(``bound``; -inf when the shortlist holds every feasible node) picks what
the full axis would; any other step runs the full axis and counts a
fallback: (bound, exhausted), exhausted when no candidate was feasible.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from .costs import _utilization_free_score
from .masks import EPS, fit_mask, usage_percent
from .shortlist import MAX_SHORTLIST

_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool


def node_score(after, alloc, fresh, weights):
    """The step's floored LeastAllocated score over any node axis
    (``solver.py:2032-2042``): ``costs._utilization_free_score`` of
    ``after``, 0 where the node's metric is stale."""
    return torch.where(fresh, _utilization_free_score(after, alloc, weights), 0.0)


def _over(used, alloc, thr):
    """Any dim over its threshold: ``thr > 0`` and the rounded percent of
    ``used`` above it."""
    return torch.any((thr > 0.0) & (usage_percent(used, alloc) > thr), dim=-1)


def sequential_build_plain(req, est, is_prod, bind, alloc, requested, est_used, prod_used,
                           fresh, sched, cpu_amp, thr, pthr, weights, shortlist_k: int):
    """Plain PyTorch build (``solver.py:2044-2085``) over the priority-sorted
    pods at the initial tables, every pod gate open: the score of every
    (pod, node) pair, ``-inf`` where infeasible (fit, amplified CPU fit of
    cpuset-bound pods, usage and prod thresholds on fresh nodes,
    schedulable), then each pod's top-(K+1) by score with the lower node
    index winning ties, as ``lax.top_k`` ranks. Returns (cand [P, K] int32,
    the first K ascending by node id, bound [P] float32, the (K+1)-th
    score)."""
    amp = torch.clamp(cpu_amp, min=1.0)
    free0 = alloc - requested
    feas0 = fit_mask(req, free0)
    eff_cpu0 = req[:, 0][:, None] * amp[None, :]
    feas0 &= ~bind[:, None] | (eff_cpu0 <= free0[:, 0][None, :] + EPS)
    after0 = est_used[None, :, :] + est[:, None, :]
    feas0 &= ~(fresh[None, :] & _over(after0, alloc[None], thr[None]))
    pafter0 = prod_used[None, :, :] + est[:, None, :]
    feas0 &= ~(is_prod[:, None] & fresh[None, :] & _over(pafter0, alloc[None], pthr[None])) \
        | ~is_prod[:, None]
    feas0 &= sched[None, :]
    score0 = node_score(after0, alloc[None], fresh[None], weights)
    score0 = torch.where(feas0, score0, -torch.inf)
    vals, idx = torch.sort(score0, dim=1, descending=True, stable=True)
    cand = torch.sort(idx[:, :shortlist_k], dim=1).values.to(_I32)
    return cand, vals[:, shortlist_k].contiguous()


#: dtypes of koord_shortlist_build's first fourteen tensors
_BUILD_DTYPES = (_F32, _F32, _BOOL, _BOOL, _F32, _F32, _F32, _F32, _BOOL, _BOOL,
                 _F32, _F32, _F32, _F32)


def sequential_build(req, est, is_prod, bind, alloc, requested, est_used, prod_used,
                     fresh, sched, cpu_amp, thr, pthr, weights, shortlist_k: int):
    """The build on the tensors' device: one launch of
    ``koord_shortlist_build`` with the jitter off for CUDA tensors (one
    block a pod, no [P, N] matrix; its bound is the (K+1)-th cost, -score,
    negated here), :func:`sequential_build_plain` for CPU tensors. Same
    arguments and result."""
    args = (req, est, is_prod, bind, alloc, requested, est_used, prod_used, fresh, sched,
            cpu_amp, thr, pthr, weights)
    if req.is_cpu:
        return sequential_build_plain(*args, shortlist_k)
    p, d = req.shape
    n = alloc.shape[0]
    if not 1 <= shortlist_k <= min(MAX_SHORTLIST, n - 1):
        raise kernels.KernelArgumentError(
            f"sequential_build: K={shortlist_k} must be in 1..min({MAX_SHORTLIST}, N-1={n - 1})")
    if not 1 <= d <= 8:
        raise kernels.KernelArgumentError(f"sequential_build: D={d} must be in 1..8")
    pd, nd = p * d, n * d
    ptrs = kernels.checked_ptrs("sequential_build", args, _BUILD_DTYPES,
                                (pd, pd, p, p, nd, nd, nd, nd, n, n, n, nd, nd, d))
    cand = torch.empty((p, shortlist_k), dtype=_I32, device=req.device)
    bound = torch.empty((p,), dtype=_F32, device=req.device)
    lib = kernels.library("shortlist_build")
    code = lib.koord_shortlist_build(
        *ptrs, p, n, d, shortlist_k, ctypes.c_float(0.0), 0, cand.data_ptr(), bound.data_ptr(),
        None, None, None, None, None, None, 0, 0, 0,
        None, None, None, None, None, None, None, None, None, 0, 0, kernels.stream_of(req))
    kernels.check(lib, code, "sequential_build")
    kernels.count("sequential_build")
    return cand, bound.neg_()


def sequential_scan_plain(req, est, is_prod, valid, bind, alloc, requested, est_used,
                          prod_used, fresh, sched, cpu_amp, thr, pthr, weights,
                          quota=None, plan=None):
    """Plain PyTorch scan (``solver.py:2087-2226``) over the
    priority-sorted pods, one step a pod, following the reference
    operation for operation: the quota gate along the chain, the gathered
    step over the pod's candidates and its exactness test, the full-axis
    step where it is unsafe (or always without ``plan``), the commit.
    ``requested``, ``est_used`` and ``prod_used`` [N, D] are updated in
    place, and with ``quota`` = (chain [P, L], runtime [Q, D], used [Q, D])
    ``used`` too; ``plan`` = (cand [P, K], bound [P]) is the build's.
    Returns (assigned [P] int32 in sorted order, fallbacks [2] int32)."""
    p, d = req.shape
    n = alloc.shape[0]
    dev = req.device
    amp = torch.clamp(cpu_amp, min=1.0)
    nodes = torch.arange(n, device=dev)
    assigned = torch.full((p,), -1, dtype=_I32, device=dev)
    fb = torch.zeros((2,), dtype=_I32, device=dev)
    if quota is not None:
        chain, runtime, qused = quota
        q_cap = runtime.shape[0]
        q_rows = torch.arange(q_cap, device=dev)

    def full_nominate(j, gate):
        free = alloc - requested
        scale = torch.where(bind[j], amp, 1.0)
        req_eff = req[j][None, :].expand(n, d).clone()
        req_eff[:, 0] = req_eff[:, 0] * scale
        feas = torch.all(req_eff <= free + EPS, dim=-1)
        feas &= ~(fresh & _over(est_used + est[j][None, :], alloc, thr))
        feas &= ~(is_prod[j] & fresh & _over(prod_used + est[j][None, :], alloc, pthr)) \
            | ~is_prod[j]
        feas &= sched & gate
        score = node_score(est_used + est[j][None, :], alloc, fresh, weights)
        score = torch.where(feas, score, -torch.inf)
        best = int(torch.argmax(score))
        return best, bool(feas[best])

    for j in range(p):
        gate = valid[j]
        if quota is not None:
            qidx = torch.clamp(chain[j], 0, q_cap - 1).long()
            q_valid = chain[j] >= 0
            ok = torch.all(qused[qidx] + req[j][None, :] <= runtime[qidx] + EPS, dim=-1)
            gate = gate & torch.all(ok | ~q_valid)
        if plan is None:
            best, has = full_nominate(j, gate)
        else:
            cand = plan[0][j].long()
            bound = plan[1][j]
            alloc_c = alloc[cand]
            fresh_c = fresh[cand]
            free_c = alloc_c - requested[cand]
            feas_c = torch.all(req[j][None, :] <= free_c + EPS, dim=-1)
            feas_c &= ~bind[j] | (req[j, 0] * amp[cand] <= free_c[:, 0] + EPS)
            est_c = est_used[cand] + est[j][None, :]
            feas_c &= ~(fresh_c & _over(est_c, alloc_c, thr[cand]))
            feas_c &= ~(is_prod[j] & fresh_c
                        & _over(prod_used[cand] + est[j][None, :], alloc_c, pthr[cand])) \
                | ~is_prod[j]
            feas_c &= sched[cand] & gate
            score_c = torch.where(feas_c, node_score(est_c, alloc_c, fresh_c, weights),
                                  -torch.inf)
            bpos = int(torch.argmax(score_c))
            sc_best = score_c[bpos]
            cand_any = bool(torch.isfinite(sc_best))
            unsafe = not bool(torch.isneginf(bound) | (sc_best > bound) | ~gate)
            if unsafe:
                best, has = full_nominate(j, gate)
                fb[0 if cand_any else 1] += 1
            else:
                best, has = int(cand[bpos]), bool(feas_c[bpos])
        if not has:
            continue
        req_commit = req[j].clone()
        req_commit[0] = req_commit[0] * torch.where(bind[j], amp[best], 1.0)
        onehot = (nodes == best)[:, None]
        requested.copy_(requested + torch.where(onehot, req_commit[None, :], 0.0))
        est_used.copy_(est_used + torch.where(onehot, est[j][None, :], 0.0))
        prod_used.copy_(prod_used + torch.where(onehot & is_prod[j], est[j][None, :], 0.0))
        if quota is not None:
            charge = (q_rows[:, None] == qidx[None, :]) & q_valid[None, :]
            qused.copy_(qused + torch.any(charge, dim=1)[:, None].to(_F32) * req[j][None, :])
        assigned[j] = best
    return assigned, fb


#: dtypes of koord_sequential's first fifteen tensors
_SCAN_DTYPES = (_F32, _F32, _BOOL, _BOOL, _BOOL, _F32, _F32, _F32, _F32, _BOOL, _BOOL,
                _F32, _F32, _F32, _F32)


def sequential_scan(req, est, is_prod, valid, bind, alloc, requested, est_used, prod_used,
                    fresh, sched, cpu_amp, thr, pthr, weights, quota=None, plan=None):
    """The scan on the tensors' device: one launch of ``koord_sequential``
    (one block, every step) for CUDA tensors, :func:`sequential_scan_plain`
    for CPU tensors. Same arguments, in-place updates and result."""
    args = (req, est, is_prod, valid, bind, alloc, requested, est_used, prod_used, fresh,
            sched, cpu_amp, thr, pthr, weights)
    if req.is_cpu:
        return sequential_scan_plain(*args, quota=quota, plan=plan)
    p, d = req.shape
    n = alloc.shape[0]
    if not 1 <= d <= 8:
        raise kernels.KernelArgumentError(f"sequential: D={d} must be in 1..8")
    pd, nd = p * d, n * d
    ptrs = kernels.checked_ptrs("sequential", args, _SCAN_DTYPES,
                                (pd, pd, p, p, p, nd, nd, nd, nd, n, n, n, nd, nd, d))
    q_args = [None, 0, None, None, 0]
    if quota is not None:
        chain, runtime, qused = quota
        q_cap, levels = runtime.shape[0], chain.shape[1]
        chain_p, runtime_p, qused_p = kernels.checked_ptrs(
            "sequential", (req, chain, runtime, qused), (_F32, _I32, _F32, _F32),
            (pd, p * levels, q_cap * d, q_cap * d))[1:]
        q_args = [chain_p, levels, runtime_p, qused_p, q_cap]
    s_args = [None, None, 0]
    if plan is not None:
        k = plan[0].shape[1]
        s_args = kernels.checked_ptrs("sequential", (req,) + tuple(plan), (_F32, _I32, _F32),
                                      (pd, p * k, p))[1:] + [k]
    assigned = torch.empty((p,), dtype=_I32, device=req.device)
    fallbacks = torch.empty((2,), dtype=_I32, device=req.device)
    lib = kernels.library("sequential")
    code = lib.koord_sequential(*ptrs, p, n, d, *q_args, *s_args, assigned.data_ptr(),
                                fallbacks.data_ptr(), kernels.stream_of(req))
    kernels.check(lib, code, "sequential")
    kernels.count("sequential")
    return assigned, fallbacks
