"""Segmented commit of one solver round, and ordered segment sums.

Port of the LoadAware commit block of ``koordinator_tpu/ops/solver.py:
assign`` (:1204-1385) and of the ``jax.ops.segment_sum`` refunds of
``enforce_gangs`` (:1858-1987). :func:`commit` and :func:`segment_sum`
launch the hand-written kernels of ``csrc/commit.cu`` on CUDA tensors and
run :func:`commit_plain` / :func:`segment_sum_plain` on CPU tensors.

Order of summation is part of the contract, and it is the order XLA's CPU
backend gives the reference: ``jnp.cumsum`` sums in chunks of 16
(:func:`_ordered_cumsum`); ``segment_sum`` sums each segment in row order;
and ``table + segment_sum(...)`` becomes a scatter-add onto the table, one
row at a time (:func:`_scatter_add_`). The kernels sum in those orders.
The plain versions build the cumsum from elementwise adds, which round the
same on any device, and take row-ordered sums with ``index_add_`` on the
CPU, since on CUDA it sums in no fixed order; that keeps the plain path
bit-identical to the reference when it runs on the card.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from .masks import EPS, usage_percent


#: chunk length of XLA's CPU rewrite of a cumulative sum
_SCAN_BASE = 16


def _ordered_cumsum(values: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along dim 0 in the order ``jnp.cumsum`` sums on the
    CPU, where XLA rewrites a cumulative sum longer than 16 into chunks of
    16: a sequential sum inside each chunk, the chunk totals scanned the
    same way (recursively), each chunk then offset by the scanned total of
    the chunks before it. (Neither a sequential walk nor ``torch.cumsum``,
    which accumulates float32 in double on the CPU, gives its bits.)"""
    m = values.shape[0]
    if m <= _SCAN_BASE:
        out = values.clone()
        for i in range(1, m):
            out[i] = out[i - 1] + values[i]
        return out
    chunks = -(-m // _SCAN_BASE)
    pad = values.new_zeros((chunks * _SCAN_BASE - m,) + tuple(values.shape[1:]))
    inner = torch.cat([values, pad]).reshape(
        (chunks, _SCAN_BASE) + tuple(values.shape[1:])
    ).clone()
    for i in range(1, _SCAN_BASE):
        inner[:, i] = inner[:, i - 1] + inner[:, i]
    totals = _ordered_cumsum(inner[:, -1])
    inner[1:] = inner[1:] + totals[:-1, None]
    return inner.reshape((chunks * _SCAN_BASE,) + tuple(values.shape[1:]))[:m]


def _segment_prefix_sums(values: torch.Tensor, seg_starts: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of ``values`` [P, D] within runs delimited by
    ``seg_starts`` [P] bool, computed as the reference does
    (``solver.py:574-584``): the global cumsum minus the cumsum just
    before the run's start."""
    p = values.shape[0]
    cums = _ordered_cumsum(values)
    idx = torch.arange(p, dtype=torch.int32, device=values.device)
    start_idx = torch.cummax(torch.where(seg_starts, idx, 0), dim=0).values
    base = torch.where(
        (start_idx > 0)[:, None], cums[torch.clamp(start_idx - 1, min=0).long()], 0.0
    )
    return cums - base


def segment_sum_plain(values: torch.Tensor, seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: [num_segments, C] sums of ``values`` [M, C]
    by ``seg_ids`` [M], each sum taken in row order (``index_add_`` on the
    CPU); ids outside [0, num_segments) are dropped."""
    vals, ids = values.cpu(), seg_ids.cpu().long()
    keep = (ids >= 0) & (ids < num_segments)
    out = torch.zeros((num_segments,) + tuple(vals.shape[1:]), dtype=vals.dtype)
    out.index_add_(0, ids[keep], vals[keep])
    return out.to(values.device)


def _scatter_add_(tables, seg_ids, values) -> None:
    """``table[seg_ids[i]] += values[i]`` for each (table, values) pair,
    row by row in order (``index_add_`` on the CPU); ids outside the table
    are dropped."""
    ids = seg_ids.cpu().long()
    keep = (ids >= 0) & (ids < tables[0].shape[0])
    for table, vals in zip(tables, values):
        host = table.cpu()
        host.index_add_(0, ids[keep], vals.cpu()[keep])
        table.copy_(host)


def segment_sum(values: torch.Tensor, seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """:func:`segment_sum_plain` on the tensors' device. On CUDA the rows
    are stably sorted by segment and ``koord_segment_sum`` sums each
    segment sequentially, so the result has the CPU's bits."""
    if values.device.type == "cpu":
        return segment_sum_plain(values, seg_ids, num_segments)
    kernels.require_cuda("segment_sum", values, seg_ids)
    if values.dtype != torch.float32 or values.dim() != 2:
        raise ValueError("segment_sum: values must be [M, C] float32")
    m, c = values.shape
    skey, order = torch.sort(seg_ids.to(torch.int32), stable=True)
    svals = values[order].contiguous()
    out = torch.zeros((num_segments, c), dtype=torch.float32, device=values.device)
    lib = kernels.library("commit")
    code = lib.koord_segment_sum(
        skey.data_ptr(), svals.data_ptr(), m, c, num_segments,
        out.data_ptr(), kernels.stream_of(values),
    )
    kernels.check(lib, code, "segment_sum")
    kernels.launches["segment_sum"] += 1
    return out


def commit_plain(
    snode, sreq, sest, sprod, alloc, fresh, thr, pthr,
    requested, est_used, prod_used, round_quantum: float,
):
    """Plain PyTorch commit of one round. ``snode`` [P] int32 holds the
    nominated nodes stably sorted (N = none); ``sreq`` [P, D] the sorted
    requests with CPU already multiplied by the node's amplification for
    cpu-bind pods; ``sest`` [P, D] and ``sprod`` [P] the sorted estimates
    and prod flags; ``thr``/``pthr`` the effective [N, D] thresholds.
    Returns ``accept`` [P] bool in sorted order and adds the winners'
    charges to ``requested``, ``est_used`` and ``prod_used`` in place."""
    n = alloc.shape[0]
    gnode = torch.clamp(snode, max=n - 1).long()
    is_start = torch.ones_like(sprod)
    is_start[1:] = snode[1:] != snode[:-1]
    sprod_est = torch.where(sprod[:, None], sest, 0.0)
    seg_req = _segment_prefix_sums(sreq, is_start)
    seg_est = _segment_prefix_sums(sest, is_start)
    seg_prod = _segment_prefix_sums(sprod_est, is_start)

    alloc_g = alloc[gnode]
    fresh_g = fresh[gnode]
    accept = snode < n
    accept &= torch.all(requested[gnode] + seg_req <= alloc_g + EPS, dim=-1)
    thr_g = thr[gnode]
    over = (thr_g > 0.0) & (usage_percent(est_used[gnode] + seg_est, alloc_g) > thr_g)
    accept &= ~(fresh_g & torch.any(over, dim=-1))
    pthr_g = pthr[gnode]
    pover = (pthr_g > 0.0) & (
        usage_percent(prod_used[gnode] + seg_prod, alloc_g) > pthr_g
    )
    accept &= ~(sprod & fresh_g & torch.any(pover, dim=-1))
    prior_est = seg_est - sest
    accept &= torch.all(
        (alloc_g <= 0) | (prior_est <= round_quantum * alloc_g + EPS), dim=-1
    )

    # winners' charges land on the tables one row at a time, in sorted
    # order: XLA folds the reference's ``table + segment_sum(...)`` into a
    # scatter-add onto the table itself
    seg_ids = torch.where(accept, snode, n)
    _scatter_add_(
        (requested, est_used, prod_used), seg_ids, (sreq, sest, sprod_est)
    )
    return accept


def commit(
    snode, sreq, sest, sprod, alloc, fresh, thr, pthr,
    requested, est_used, prod_used, round_quantum: float,
):
    """One round's commit on the tensors' device: ``koord_commit`` for CUDA
    tensors, :func:`commit_plain` for CPU tensors. Same arguments, result
    and in-place updates as :func:`commit_plain`."""
    args = (snode, sreq, sest, sprod, alloc, fresh, thr, pthr,
            requested, est_used, prod_used)
    if snode.device.type == "cpu":
        return commit_plain(*args, round_quantum)
    kernels.require_cuda("commit", *args)
    p, d = sreq.shape
    n = alloc.shape[0]
    if snode.dtype != torch.int32:
        raise ValueError("commit: snode must be int32")
    for t in (sreq, sest, alloc, thr, pthr, requested, est_used, prod_used):
        if t.dtype != torch.float32 or t.shape[-1] != d:
            raise ValueError("commit: [.., D] tables must be float32")
    if not 1 <= d <= 8:
        raise ValueError(f"commit: D={d} must be in 1..8")
    lib = kernels.library("commit")
    accept = torch.empty((p,), dtype=torch.bool, device=snode.device)
    code = lib.koord_commit(
        *(t.data_ptr() for t in args),
        ctypes.c_float(round_quantum), p, n, d,
        accept.data_ptr(), kernels.stream_of(snode),
    )
    kernels.check(lib, code, "commit")
    kernels.launches["commit"] += 1
    return accept
