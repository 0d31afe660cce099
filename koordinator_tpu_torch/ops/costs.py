"""LoadAware score as a vectorized cost term over (pods × nodes).

Port of ``koordinator_tpu/ops/costs.py:22-69``. Lower cost = better node.
Scores follow the reference's 0..100 integer-floor convention
(``load_aware.go:387-406``), then negate into costs. The plain form here is
also what the nomination kernel (``csrc/nominate.cu``) computes per pair.
"""

from __future__ import annotations

import torch

_SAFE = 1e-9


def _utilization_free_score(
    requested_like: torch.Tensor, allocatable: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """score = ⌊Σ_d w_d · ⌊(alloc - used) · 100 / alloc⌋ / Σ_d w_d⌋, ≥ 0.
    The per-dim sum runs in d order, as the reference's reduction does."""
    free = torch.clamp(allocatable - requested_like, min=0.0)
    per_dim = torch.floor(
        torch.where(allocatable > 0, free * 100.0 / (allocatable + _SAFE), 0.0)
    )
    wsum = torch.sum(weights) + _SAFE
    terms = per_dim * weights
    total = terms[..., 0]
    for d in range(1, terms.shape[-1]):
        total = total + terms[..., d]
    return torch.floor(total / wsum)


def load_aware_cost(
    pod_estimate: torch.Tensor,
    node_estimated_used: torch.Tensor,
    node_allocatable: torch.Tensor,
    weights: torch.Tensor,
    metric_fresh: "torch.Tensor | None" = None,
) -> torch.Tensor:
    """LoadAware least-used score → cost [P, N]. A node whose NodeMetric is
    expired scores 0 — still schedulable, ranked last."""
    after = node_estimated_used[None, :, :] + pod_estimate[:, None, :]  # [P,N,D]
    score = _utilization_free_score(after, node_allocatable[None, :, :], weights)
    if metric_fresh is not None:
        score = torch.where(metric_fresh[None, :], score, 0.0)
    return -score
