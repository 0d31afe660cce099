"""Score plugins as vectorized cost terms over (pods × nodes).

Port of ``koordinator_tpu/ops/costs.py``. Lower cost = better node.
Scores follow the reference's 0..100 integer-floor convention
(``load_aware.go:387-406``), then negate into costs. The LoadAware forms
here are also what the pricing kernels compute per pair
(``csrc/loadaware.cuh``).

The four request-based scoring programs (:90-160: :func:`least_allocated_cost`,
:func:`most_allocated_cost`, :func:`scarce_resource_cost`,
:func:`fit_plus_cost`) and ``numa.numa_alignment_cost`` have no caller on
a solve path. Each is one launch of ``csrc/score_programs.cu`` on CUDA
tensors (a thread a pair, the program's pair function inside) and its
``_plain`` twin on CPU tensors; there is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from .. import kernels

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


# ------------------------------------------------ the scoring programs


def least_allocated_cost_plain(pod_req, node_requested, node_allocatable, weights):
    """Request-based LeastAllocated (``costs.py:90-100``): the least-used
    score of ``requested + req`` → cost [P, N]."""
    after = node_requested[None, :, :] + pod_req[:, None, :]
    return -_utilization_free_score(after, node_allocatable[None, :, :], weights)


def most_allocated_cost_plain(pod_req, node_requested, node_allocatable, weights):
    """MostAllocated (``costs.py:102-113``): ``-(100 - free_score)``."""
    after = node_requested[None, :, :] + pod_req[:, None, :]
    free_score = _utilization_free_score(after, node_allocatable[None, :, :], weights)
    return -(100.0 - free_score)


def scarce_resource_cost_plain(pod_req, node_allocatable, scarce_dims):
    """ScarceResourceAvoidance (``costs.py:115-132``): the count of scarce
    dims the node has and the pod does not ask for, times ``100 /
    n_scarce`` (a float32 division of the count of scarce dims, at least
    1) → [P, N] in 0..100."""
    node_has = (node_allocatable > 0) & scarce_dims[None, :]
    pod_wants = pod_req > 0
    wasted = node_has[None, :, :] & ~pod_wants[:, None, :]
    n_scarce = torch.clamp(torch.sum(scarce_dims, dtype=torch.int32), min=1).to(torch.float32)
    # a tensor over a tensor: ``100.0 / t`` would be ``t.reciprocal() * 100``
    factor = torch.full_like(n_scarce, 100.0) / n_scarce
    return torch.sum(wasted, dim=-1, dtype=torch.int32) * factor


def fit_plus_cost_plain(pod_req, node_requested, node_allocatable, dim_weights,
                        most_allocated_dims):
    """NodeResourcesFitPlus (``costs.py:134-160``): each dim's clipped used
    fraction after the pod (MostAllocated dims) or its complement, × 100,
    weighted by the dims the pod asks for, over the sum of those weights +
    ``_SAFE`` → cost [P, N]. Both sums run in d order."""
    alloc = node_allocatable[None, :, :]
    after = node_requested[None, :, :] + pod_req[:, None, :]
    frac_used = torch.where(alloc > 0, torch.clamp(after / (alloc + _SAFE), 0.0, 1.0), 0.0)
    per_dim = torch.where(most_allocated_dims[None, None, :], frac_used, 1.0 - frac_used) * 100.0
    wants = (pod_req > 0).to(per_dim.dtype)
    w = dim_weights[None, None, :] * wants[:, None, :]
    terms = per_dim * w
    total, wsum = terms[..., 0], w[..., 0]
    for d in range(1, terms.shape[-1]):
        total = total + terms[..., d]
        wsum = wsum + w[..., d]
    return -(total / (wsum + _SAFE))


#: ``csrc/score_programs.cu``'s programs, by wrapper name
PROGRAMS = {"least_allocated_cost": 0, "most_allocated_cost": 1, "scarce_resource_cost": 2,
            "fit_plus_cost": 3, "numa_alignment_cost": 4}
#: the most resource dims the scoring programs take (``kMaxDims``)
MAX_DIMS = 8
_F32 = torch.float32


def score_program(name: str, pod_req, node_a, node_b, weights, flags, d_node: int,
                  zones: int = 0):
    """One launch of ``koord_score_program`` for program ``name``: pods
    ``pod_req`` [P, D]; the node tables ``node_a`` (requested, or for NUMA
    the zone table [N, Z, DN]) and ``node_b`` (allocatable), each [N,
    d_node] or None; ``weights`` [d_node] float32 and ``flags`` [d_node]
    bool or None; ``zones`` Z for NUMA. Returns the cost [P, N] float32.
    Raises :class:`..kernels.KernelArgumentError` on a tensor the kernel
    does not take and :class:`..kernels.KernelError` on a refused launch."""
    p, d = pod_req.shape
    ref = node_b if node_a is None else node_a
    n = ref.shape[0]
    if not 1 <= d_node <= MAX_DIMS or d_node > d:
        raise kernels.KernelArgumentError(
            f"{name}: dims {d_node} must be in 1..min({MAX_DIMS}, D={d})")
    per_node = d_node * max(zones, 1)
    tensors = (pod_req, node_a, node_b, weights, flags)
    ptrs = kernels.checked_ptrs(
        name, tensors, (_F32, _F32, _F32, _F32, torch.bool),
        (p * d, n * per_node, n * d_node, d_node, d_node))
    out = torch.empty((p, n), dtype=_F32, device=pod_req.device)
    lib = kernels.library("score_programs")
    code = lib.koord_score_program(PROGRAMS[name], *ptrs, out.data_ptr(), p, n, d, d_node,
                                   zones, kernels.stream_of(pod_req))
    kernels.check(lib, code, name)
    kernels.count(name)
    return out


def least_allocated_cost(pod_req, node_requested, node_allocatable, weights):
    """:func:`least_allocated_cost_plain` on the tensors' device (one
    launch of ``csrc/score_programs.cu`` on CUDA tensors)."""
    if pod_req.is_cpu:
        return least_allocated_cost_plain(pod_req, node_requested, node_allocatable, weights)
    return score_program("least_allocated_cost", pod_req, node_requested, node_allocatable,
                         weights, None, node_allocatable.shape[1])


def most_allocated_cost(pod_req, node_requested, node_allocatable, weights):
    """:func:`most_allocated_cost_plain` on the tensors' device."""
    if pod_req.is_cpu:
        return most_allocated_cost_plain(pod_req, node_requested, node_allocatable, weights)
    return score_program("most_allocated_cost", pod_req, node_requested, node_allocatable,
                         weights, None, node_allocatable.shape[1])


def scarce_resource_cost(pod_req, node_allocatable, scarce_dims):
    """:func:`scarce_resource_cost_plain` on the tensors' device."""
    if pod_req.is_cpu:
        return scarce_resource_cost_plain(pod_req, node_allocatable, scarce_dims)
    return score_program("scarce_resource_cost", pod_req, None, node_allocatable, None,
                         scarce_dims, node_allocatable.shape[1])


def fit_plus_cost(pod_req, node_requested, node_allocatable, dim_weights, most_allocated_dims):
    """:func:`fit_plus_cost_plain` on the tensors' device."""
    if pod_req.is_cpu:
        return fit_plus_cost_plain(pod_req, node_requested, node_allocatable, dim_weights,
                                   most_allocated_dims)
    return score_program("fit_plus_cost", pod_req, node_requested, node_allocatable,
                         dim_weights, most_allocated_dims, node_allocatable.shape[1])
