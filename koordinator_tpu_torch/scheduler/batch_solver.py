"""The scheduler seam: what the JAX package's
``koordinator_tpu/scheduler/batch_solver.py`` runs on the device between
solves, in PyTorch.

So far the commit-delta chaining (:162-194): the scheduler keeps the node
tables resident between cycles and carries a solve's commit deltas onto
its untransformed base state. The rest of the scheduler follows
(ROADMAP queue 1 item 6).
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.solver import NodeState, SolveResult


def _chain_commit_deltas(cur: NodeState, nodes_t: NodeState, result: SolveResult) -> NodeState:
    """Carry only the solver's commit deltas onto the base state ``cur``:
    ``cur + (result - nodes_t)`` for each table, in that order, as the
    reference computes it (so the bits agree). Returns a new
    :class:`NodeState`; ``cur`` is not written."""
    return dataclasses.replace(
        cur,
        requested=cur.requested + (result.node_requested - nodes_t.requested),
        estimated_used=cur.estimated_used
        + (result.node_estimated_used - nodes_t.estimated_used),
        prod_used=cur.prod_used + (result.node_prod_used - nodes_t.prod_used),
    )


def _apply_commit_deltas_(
    cur_req: torch.Tensor,
    cur_est: torch.Tensor,
    cur_prod: torch.Tensor,
    t_req: torch.Tensor,
    t_est: torch.Tensor,
    t_prod: torch.Tensor,
    r_req: torch.Tensor,
    r_est: torch.Tensor,
    r_prod: torch.Tensor,
):
    """The in-place form of ``_apply_commit_deltas_donated`` (:177-194):
    ``cur += (r - t)`` for each table, the same additions in the same
    order as :func:`_chain_commit_deltas`, written into the ``cur``
    tensors where the reference donates them. Returns them."""
    for cur, t, r in ((cur_req, t_req, r_req), (cur_est, t_est, r_est),
                      (cur_prod, t_prod, r_prod)):
        cur.add_(r - t)
    return cur_req, cur_est, cur_prod
