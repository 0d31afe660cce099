"""Filter predicates as boolean masks over (pods × nodes).

Port of ``koordinator_tpu/ops/masks.py:17-170``:
  * NodeResourcesFit            → :func:`fit_mask`
  * LoadAwareScheduling.Filter  → :func:`usage_threshold_mask`
    (reference ``pkg/scheduler/plugins/loadaware/load_aware.go:122-186,290-313``)
  * the gathered-column ``_cols`` forms of the candidate shortlist, whose
    node arguments are each pod's [P, K] candidate columns

Masks compose by logical AND; ``True`` means feasible. The arithmetic and
its order follow the JAX module operation for operation, so both give the
same float32 bits on the same inputs, and a ``_cols`` form gives the bits
of its full-axis form for every (pod, node) pair. These are the plain
forms: the round solver's hot path evaluates the same predicates inside
its kernels (``csrc/loadaware.cuh``).
"""

from __future__ import annotations

import torch

EPS = 1e-3  # float32 slack for large-magnitude resource dims (MiB, milli-cpu)


def usage_percent(used: torch.Tensor, allocatable: torch.Tensor) -> torch.Tensor:
    """Utilization as the reference computes it for threshold checks:
    ``int64(math.Round(used/total*100))`` — Go's half-away-from-zero
    rounding, reproduced as ``floor(x + 0.5)`` for non-negative values
    (``torch.round`` rounds half to even)."""
    pct = torch.where(allocatable > 0, used * 100.0 / allocatable, 0.0)
    return torch.floor(pct + 0.5)


def fit_mask(pod_req: torch.Tensor, node_free: torch.Tensor) -> torch.Tensor:
    """NodeResourcesFit: every requested dim fits in node free capacity.
    pod_req [P, D], node_free [N, D] → [P, N] bool."""
    return torch.all(pod_req[:, None, :] <= node_free[None, :, :] + EPS, dim=-1)


def effective_thresholds(
    thresholds: torch.Tensor, node_custom: "torch.Tensor | None"
) -> torch.Tensor:
    """[N, D] effective per-node thresholds: a node carrying a non-empty
    usage-thresholds annotation replaces the global map WHOLESALE — dims
    absent from the custom map (0 here) go unchecked on that node."""
    if node_custom is None:
        return thresholds[None, :]
    has_custom = torch.any(node_custom > 0.0, dim=-1, keepdim=True)  # [N, 1]
    return torch.where(has_custom, node_custom, thresholds[None, :])


def usage_threshold_mask(
    pod_estimate: torch.Tensor,
    node_estimated_used: torch.Tensor,
    node_allocatable: torch.Tensor,
    thresholds: torch.Tensor,
    metric_fresh: torch.Tensor,
    node_custom: "torch.Tensor | None" = None,
) -> torch.Tensor:
    """LoadAware Filter: for each dim with threshold > 0, reject when
    ``round((estimatedUsed + podEstimate)·100/allocatable) > threshold``.
    Nodes with an expired NodeMetric skip the check. Returns [P, N] bool."""
    return usage_ok(
        pod_estimate,
        node_estimated_used,
        node_allocatable,
        effective_thresholds(thresholds, node_custom),
        metric_fresh,
    )


def usage_ok(pod_estimate, node_used, node_allocatable, thr, metric_fresh):
    """:func:`usage_threshold_mask` on effective thresholds ``thr`` ([N, D]
    or [1, D], as :func:`effective_thresholds` returns them)."""
    after = node_used[None, :, :] + pod_estimate[:, None, :]
    pct = usage_percent(after, node_allocatable[None, :, :])
    over = (thr[None, :, :] > 0.0) & (pct > thr[None, :, :])
    ok = ~torch.any(over, dim=-1)
    return ok | ~metric_fresh[None, :]


def prod_usage_threshold_mask(
    pod_is_prod: torch.Tensor,
    pod_estimate: torch.Tensor,
    node_prod_used: torch.Tensor,
    node_allocatable: torch.Tensor,
    prod_thresholds: torch.Tensor,
    metric_fresh: torch.Tensor,
    node_custom: "torch.Tensor | None" = None,
) -> torch.Tensor:
    """LoadAware prod-usage thresholds: only prod-band pods are checked
    against prod-tier utilization. Returns [P, N] bool."""
    base = usage_threshold_mask(
        pod_estimate,
        node_prod_used,
        node_allocatable,
        prod_thresholds,
        metric_fresh,
        node_custom=node_custom,
    )
    return base | ~pod_is_prod[:, None]


def fit_mask_cols(pod_req: torch.Tensor, node_free: torch.Tensor) -> torch.Tensor:
    """Gathered-column :func:`fit_mask`: ``node_free`` is [P, K, D], each
    pod's K candidate columns. Returns [P, K] bool."""
    return torch.all(pod_req[:, None, :] <= node_free + EPS, dim=-1)


def effective_thresholds_cols(
    thresholds: torch.Tensor, node_custom: "torch.Tensor | None"
) -> torch.Tensor:
    """Gathered-column :func:`effective_thresholds`: ``node_custom`` is
    [P, K, D] (or None). Returns [P, K, D] ([1, 1, D] without a custom
    table)."""
    if node_custom is None:
        return thresholds[None, None, :]
    has_custom = torch.any(node_custom > 0.0, dim=-1, keepdim=True)  # [P, K, 1]
    return torch.where(has_custom, node_custom, thresholds[None, None, :])


def usage_ok_cols(pod_estimate, node_used, node_allocatable, thr, metric_fresh):
    """:func:`usage_threshold_mask_cols` on effective thresholds ``thr``
    ([P, K, D], or broadcastable to it)."""
    after = node_used + pod_estimate[:, None, :]
    pct = usage_percent(after, node_allocatable)
    over = (thr > 0.0) & (pct > thr)
    return ~torch.any(over, dim=-1) | ~metric_fresh


def usage_threshold_mask_cols(
    pod_estimate: torch.Tensor,
    node_estimated_used: torch.Tensor,
    node_allocatable: torch.Tensor,
    thresholds: torch.Tensor,
    metric_fresh: torch.Tensor,
    node_custom: "torch.Tensor | None" = None,
) -> torch.Tensor:
    """Gathered-column :func:`usage_threshold_mask`: node arguments are
    [P, K, D] / [P, K] candidate columns. Returns [P, K] bool."""
    return usage_ok_cols(
        pod_estimate,
        node_estimated_used,
        node_allocatable,
        effective_thresholds_cols(thresholds, node_custom),
        metric_fresh,
    )


def prod_usage_threshold_mask_cols(
    pod_is_prod: torch.Tensor,
    pod_estimate: torch.Tensor,
    node_prod_used: torch.Tensor,
    node_allocatable: torch.Tensor,
    prod_thresholds: torch.Tensor,
    metric_fresh: torch.Tensor,
    node_custom: "torch.Tensor | None" = None,
) -> torch.Tensor:
    """Gathered-column :func:`prod_usage_threshold_mask`. Returns [P, K]."""
    base = usage_threshold_mask_cols(
        pod_estimate,
        node_prod_used,
        node_allocatable,
        prod_thresholds,
        metric_fresh,
        node_custom=node_custom,
    )
    return base | ~pod_is_prod[:, None]
