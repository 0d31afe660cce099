"""ElasticQuota admission on the round solver's path: the per-pod gate, the
in-round commit along each pod's quota chain, and the rollback refund.

Port of ``koordinator_tpu/ops/solver.py:_quota_headroom`` (:489-501),
``_quota_commit`` (:504-571, both static branches) and the quota refund of
``enforce_gangs`` (:1963-1973). On the card each is a phase of a
hand-written kernel: the gate of round 0 is ``csrc/quota.cu``
(:func:`quota_gate`, once a batch), the commit and the next round's gate
are phases of the round tail (``csrc/round.cu``, :func:`.commit.round_tail`
with ``quota=``) and the refund a phase of ``csrc/gangs.cu``. The functions
here are their plain versions, used on the CPU and in the card's checks.

A quota tree is ``runtime`` and ``used``, [Q, D] float32 each; a pod's
chain is [L] int32 quota rows from leaf to root, -1 where a level is open.
The admission rule is ``used + request <= runtime + EPS`` in every dim at
every level of the chain (reference ``plugin_helper.go:281-317``).

Order of summation is part of the contract (ROADMAP queue 3): the
one-hot branch's ``jnp.cumsum`` over [P, Q, D] runs along P in XLA's
chunks of 16, column by column (:func:`.commit._ordered_cumsum`, zeros of
non-members inside the chunks); the sorted branch takes
``_segment_prefix_sums`` of the key-sorted rows; of the chain of adds
``used + segment_sum(level 0) + segment_sum(level 1) + ...`` XLA folds
some levels into scatter-adds onto the running table (row by row in
priority order) and adds the others' sums whole, by a rule on the batch
and table sizes (:func:`charge_folds`); the refund's ``used -
segment_sum`` is not folded: each quota's refund is summed first, then
subtracted.
"""

from __future__ import annotations

import torch

from .. import kernels
from . import commit as commit_ops
from .masks import EPS

#: the one-hot branch is taken while Q·D is at most this (``solver.py:519``)
ONEHOT_MAX = 1024


def onehot_branch(q: int, d: int) -> bool:
    """Whether ``_quota_commit`` takes its one-hot branch for a [Q, D]
    tree: a static choice on the table's shape."""
    return q * d <= ONEHOT_MAX


def quota_headroom(requests, chain, runtime, used) -> torch.Tensor:
    """[P] bool: ``used + request <= runtime + EPS`` in every dim at every
    level of each pod's chain, -1 levels open (``solver.py:489-501``)."""
    q = torch.clamp(chain, 0, runtime.shape[0] - 1).long()       # [P, L]
    head = torch.all(used[q] + requests[:, None, :] <= runtime[q] + EPS, dim=-1)
    return torch.all(head | (chain < 0), dim=-1)


def quota_gate_plain(active, requests, chain, runtime, used, gate) -> None:
    """``gate = active & quota_headroom(...)``, written into ``gate`` [P]
    bool: the pods a round prices (``solver.py:1105-1112``)."""
    gate.copy_(active & quota_headroom(requests, chain, runtime, used))


def _level_admission(accepted, requests, key_raw, runtime, used) -> torch.Tensor:
    """One chain level of ``_quota_commit``'s admission: [P] bool, True
    where a node-accepted pod still fits its quota at this level counting
    the pods before it in priority order, or does not take part."""
    p = accepted.shape[0]
    q_cap, d = runtime.shape
    participating = accepted & (key_raw >= 0)
    if onehot_branch(q_cap, d):
        # [P, Q, D] one-hot contributions, cumsum along P in XLA's order;
        # each pod reads its own column
        qids = torch.arange(q_cap, dtype=key_raw.dtype, device=key_raw.device)
        onehot = participating[:, None] & (key_raw[:, None] == qids[None, :])
        contrib = onehot[:, :, None] * requests[:, None, :]
        prefix = commit_ops._ordered_cumsum(contrib)
        gq = torch.clamp(key_raw, 0, q_cap - 1).long()
        own = prefix[torch.arange(p, device=gq.device), gq]
        fits = torch.all(used[gq] + own <= runtime[gq] + EPS, dim=-1)
        return ~participating | fits
    key = torch.where(participating, key_raw, q_cap)
    skey, sidx = torch.sort(key, stable=True)
    sreq = torch.where(participating[sidx][:, None], requests[sidx], 0.0)
    is_start = torch.ones_like(participating)
    is_start[1:] = skey[1:] != skey[:-1]
    seg = commit_ops._segment_prefix_sums(sreq, is_start)
    gq = torch.clamp(skey, max=q_cap - 1).long()
    fits = torch.all(used[gq] + seg <= runtime[gq] + EPS, dim=-1)
    ok = torch.zeros_like(participating)
    ok[sidx] = (skey >= q_cap) | fits
    return ok


def charge_folds(p: int, q_cap: int, levels: int) -> list:
    """For each chain level, whether its charges land on the running quota
    table row by row (True) or are summed apart and added whole (False),
    as XLA's CPU backend compiles the reference's chain
    ``used + segment_sum(level 0) + segment_sum(level 1) + ...`` in
    ``assign`` (each segment sum a scatter-add of ``p`` rows onto zeros):
    an add whose other side is a plain table is folded into a scatter onto
    it; an add onto a scatter merges the next level's rows into that
    scatter (their rows after its rows, in one scatter) while the merged
    rows stay fewer than the table's ``q_cap`` rows, and is otherwise kept
    as an add of the level's sum. A merge is a fold too, so the result is
    a list of folds and adds: [True, False, True, False] where no merge
    fits (p >= q_cap / 2), [True] * levels for small batches."""
    folds, scatter, rows = [], False, 0
    for _ in range(levels):
        if scatter and rows + p < q_cap:
            folds.append(True)
            rows += p
        elif scatter:
            folds.append(False)
            scatter = False
        else:
            folds.append(True)
            scatter, rows = True, p
    return folds


def quota_commit_plain(accepted, requests, chain, runtime, used):
    """Cumulative in-round quota admission (``solver.py:504-571``), pods in
    priority order: a node-accepted pod must fit at every level of its
    chain, counting the node-accepted pods of its quota before it at that
    level (a pod refused at a deeper level still counts at the shallower
    ones in this round, as the reference's conservative prefix does).
    Returns (final [P] bool, new_used [Q, D]): ``used`` plus the final
    pods' requests, level after level, each level either added row by row
    in priority order onto the running table or summed first and added
    whole, as :func:`charge_folds` says XLA's CPU backend orders them."""
    p = accepted.shape[0]
    q_cap = runtime.shape[0]
    ok = torch.ones_like(accepted)
    for level in range(chain.shape[1]):
        ok &= _level_admission(accepted, requests, chain[:, level], runtime, used)
    final = accepted & ok
    new_used = used.clone()
    for level, fold in enumerate(charge_folds(p, q_cap, chain.shape[1])):
        key_raw = chain[:, level]
        charge = final & (key_raw >= 0)
        ids = torch.where(charge, key_raw, q_cap - 1)
        vals = torch.where(charge[:, None], requests, 0.0)
        if fold:
            commit_ops._scatter_add_((new_used,), ids, (vals,))
        else:
            new_used = new_used + commit_ops.segment_sum_plain(vals, ids, q_cap)
    return final, new_used


def quota_refund_plain(rollback, requests, chain, used) -> torch.Tensor:
    """``enforce_gangs``' quota refund (``solver.py:1963-1973``): for each
    level, the rolled-back pods' requests summed per quota in pod order,
    then subtracted from ``used``. Q == 1 is the disabled sentinel and
    refunds nothing. Returns the new [Q, D] table."""
    q_cap = used.shape[0]
    if q_cap == 1:
        return used.clone()
    out = used
    for level in range(chain.shape[1]):
        key_raw = chain[:, level]
        refund = rollback & (key_raw >= 0)
        out = out - commit_ops.segment_sum_plain(
            torch.where(refund[:, None], requests, 0.0),
            torch.where(refund, key_raw, q_cap - 1), q_cap,
        )
    return out


_I32, _F32, _BOOL = torch.int32, torch.float32, torch.bool


def quota_gate(active, requests, chain, runtime, used, gate) -> None:
    """Round 0's gate of a batch on the tensors' device: one
    ``koord_quota_gate`` launch (``csrc/quota.cu``) for CUDA tensors,
    :func:`quota_gate_plain` for CPU tensors. Writes ``gate`` [P] bool;
    pods are priority-sorted ([P], [P, D], chains [P, L])."""
    if active.is_cpu:
        return quota_gate_plain(active, requests, chain, runtime, used, gate)
    p, d = requests.shape
    q_cap, levels = runtime.shape[0], chain.shape[1]
    ptrs = kernels.checked_ptrs(
        "quota_gate", (active, requests, chain, runtime, used, gate),
        (_BOOL, _F32, _I32, _F32, _F32, _BOOL),
        (p, p * d, p * levels, q_cap * d, q_cap * d, p),
    )
    lib = kernels.library("quota")
    code = lib.koord_quota_gate(*ptrs, p, d, q_cap, levels, kernels.stream_of(active))
    kernels.check(lib, code, "quota_gate")
    kernels.count("quota_gate")
