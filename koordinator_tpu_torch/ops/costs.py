"""LoadAware score as a vectorized cost term over (pods × nodes).

Port of ``koordinator_tpu/ops/costs.py:22-87``. Lower cost = better node.
Scores follow the reference's 0..100 integer-floor convention
(``load_aware.go:387-406``), then negate into costs. The plain form here is
also what the kernels compute per pair (``csrc/loadaware.cuh``).
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


def load_aware_cost_cols(
    pod_estimate: torch.Tensor,
    node_estimated_used: torch.Tensor,
    node_allocatable: torch.Tensor,
    weights: torch.Tensor,
    metric_fresh: "torch.Tensor | None" = None,
) -> torch.Tensor:
    """Gathered-column :func:`load_aware_cost`: node arguments are
    [P, K, D] / [P, K] candidate columns, and each pair gets the bits the
    full axis gives it. Returns [P, K]."""
    after = node_estimated_used + pod_estimate[:, None, :]  # [P,K,D]
    score = _utilization_free_score(after, node_allocatable, weights)
    if metric_fresh is not None:
        score = torch.where(metric_fresh, score, 0.0)
    return -score


def numa_aligned_cost(
    pod_req: torch.Tensor,
    wants_numa: torch.Tensor,
    zone_free: torch.Tensor,
    zone_cap: torch.Tensor,
    weights: torch.Tensor,
    most_allocated: bool = False,
) -> torch.Tensor:
    """NUMA-aligned Least/MostAllocated score → cost [P, N]
    (``costs.py:212-263``): each pod's request goes into the zone the host
    allocator would pick — the fitting zone (request within 1e-6 of its
    free room in every dim, some capacity) of least ``(used0 + 1) /
    (cap0 + 1)``, the first on ties — and the node scores on that zone's
    requested/allocatable with the integer-floor per-dim score, 0 where a
    dim is over capacity or has none. Pods that do not want alignment, and
    pairs with no fitting zone, score 0. ``zone_free``/``zone_cap``
    [N, Z, DN]; the first DN of ``pod_req``'s dims and ``weights``' are
    used. The per-dim and per-zone sums run in index order."""
    dn = zone_cap.shape[-1]
    req = pod_req[:, :dn]                                          # [P, DN]
    real = torch.any(zone_cap > 0, dim=-1)                         # [N, Z]
    fits = torch.all(req[:, None, None, :] <= zone_free[None] + 1e-6, dim=-1) & real[None]
    used = zone_cap - zone_free                                    # [N, Z, DN]
    util = (used[..., 0] + 1.0) / (zone_cap[..., 0] + 1.0)         # [N, Z]
    key = torch.where(fits, util[None], torch.inf)                 # [P, N, Z]
    best = key.min(dim=-1).values
    zstar = (key == best[..., None]).to(torch.int8).argmax(dim=-1)  # first on ties
    has_zone = torch.any(fits, dim=-1)
    idx = zstar[..., None, None].expand(-1, -1, 1, dn)
    used_z = torch.gather(used[None].expand(req.shape[0], -1, -1, -1), 2, idx)[:, :, 0]
    cap_z = torch.gather(zone_cap[None].expand(req.shape[0], -1, -1, -1), 2, idx)[:, :, 0]
    after = used_z + req[:, None, :]
    if most_allocated:
        raw = torch.floor(after * 100.0 / (cap_z + _SAFE))
    else:
        raw = torch.floor((cap_z - after) * 100.0 / (cap_z + _SAFE))
    per_dim = torch.where((cap_z > 0) & (after <= cap_z + 1e-6), raw, 0.0)
    w = weights[:dn]
    wsum = w[0]
    for d in range(1, dn):
        wsum = wsum + w[d]
    wsum = wsum + _SAFE
    terms = per_dim * w
    total = terms[..., 0]
    for d in range(1, dn):
        total = total + terms[..., d]
    score = torch.floor(total / wsum)
    score = torch.where(wants_numa[:, None] & has_zone, score, 0.0)
    return -score


def device_cost(
    gpu_units: torch.Tensor,
    dev_free_total: torch.Tensor,
    dev_cap_total: torch.Tensor,
    most_allocated: bool = False,
) -> torch.Tensor:
    """DeviceShare Least/MostAllocated score over GPU capacity → cost
    [P, N] (``costs.py:162-190``): ``gpu_units`` [P] the pods' demand in
    percent units, ``dev_free_total`` / ``dev_cap_total`` [N] the nodes'
    free and total percent. The integer-floor score of the capacity used
    after the pod (MostAllocated) or left (LeastAllocated), 0 where the
    node has no GPU, the pod would overflow it, or the pod asks for none."""
    return _device_cost(gpu_units, dev_free_total[None, :], dev_cap_total[None, :],
                        most_allocated)


def device_cost_cols(
    gpu_units: torch.Tensor,
    dev_free_total: torch.Tensor,
    dev_cap_total: torch.Tensor,
    most_allocated: bool = False,
) -> torch.Tensor:
    """:func:`device_cost` over each pod's gathered [P, K] candidate
    columns (``costs.py:192-211``): the same elementwise arithmetic."""
    return _device_cost(gpu_units, dev_free_total, dev_cap_total, most_allocated)


def _device_cost(gpu_units, free, cap, most_allocated: bool):
    used_after = (cap - free) + gpu_units[:, None]
    if most_allocated:
        raw = torch.floor(used_after * 100.0 / (cap + _SAFE))
    else:
        raw = torch.floor((cap - used_after) * 100.0 / (cap + _SAFE))
    score = torch.where((cap > 0) & (used_after <= cap + 1e-6), raw, 0.0)
    score = torch.where(gpu_units[:, None] > 0, score, 0.0)
    return -score
