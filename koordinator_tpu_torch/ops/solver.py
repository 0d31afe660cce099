"""Batched assignment solver: masked argmin with capacity-consuming commit.

Port of ``koordinator_tpu/ops/solver.py``'s LoadAware round solver
(:func:`assign`, :679-1535) and its stream (:func:`solve_stream`,
:1671-1733), with :func:`enforce_gangs` (:1858-1987, the CUDA kernel
``csrc/gangs.cu`` on the card, one launch a batch). Each round:

1. nominate — every still-unassigned pod's masked, jittered LoadAware cost
   over all nodes and its top-k (:func:`.nominate.nominate`, the CUDA kernel
   ``csrc/nominate.cu`` on the card);
2. choose — the pod with the r-th highest priority among active pods takes
   its (r mod k)-th best finite node;
3. commit — pods stably sorted by node, segmented prefix sums, acceptance
   under capacity, thresholds and the spread quantum, per-node deltas
   (:func:`.commit.commit`, ``csrc/commit.cu`` on the card).

Rounds stop at a fixed point (no acceptance) or after ``max_rounds``. The
loop runs on the host and reads one flag per round, so a stream of B
batches costs ``Σ rounds + B`` host syncs.

Containers are ``@dataclass``es of tensors in place of ``flax.struct``;
node tables are updated in place inside a solve (the caller's tensors are
cloned first and never written).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from .. import kernels, resolve_device
from . import commit as commit_ops
from . import nominate as nominate_ops
from .commit import _segment_prefix_sums  # noqa: F401  (reference name)
from .masks import effective_thresholds
from .nominate import _jitter_hash  # noqa: F401  (reference name)


def _tensor(x, dtype, device):
    return torch.as_tensor(x, dtype=dtype, device=device)


def tree_map(fn, obj):
    """Apply ``fn`` to every tensor field of a dataclass (None stays None)."""
    return dataclasses.replace(
        obj,
        **{
            f.name: fn(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None
        },
    )


@dataclass
class NodeState:
    """Node block ([N, D] tables, [N] flags), ``solver.py:60-125``."""

    allocatable: torch.Tensor      # [N, D]
    requested: torch.Tensor        # [N, D]
    estimated_used: torch.Tensor   # [N, D] usage percentile + assigned-pending
    prod_used: torch.Tensor        # [N, D]
    metric_fresh: torch.Tensor     # [N] bool
    schedulable: torch.Tensor      # [N] bool
    #: CPU amplification ratio per node; cpuset-bound pods' CPU counts ×ratio
    cpu_amp: torch.Tensor = None   # [N]
    #: per-node LoadAware threshold overrides (0 = plugin-args global)
    custom_thresholds: torch.Tensor = None        # [N, D]
    custom_prod_thresholds: torch.Tensor = None   # [N, D]

    @classmethod
    def create(
        cls,
        allocatable,
        requested=None,
        estimated_used=None,
        prod_used=None,
        metric_fresh=None,
        schedulable=None,
        cpu_amp=None,
        custom_thresholds=None,
        custom_prod_thresholds=None,
        device=None,
    ) -> "NodeState":
        dev = resolve_device(device)
        f32 = torch.float32
        allocatable = _tensor(allocatable, f32, dev)
        n = allocatable.shape[0]
        z = torch.zeros_like(allocatable)

        def table(x):
            return z.clone() if x is None else _tensor(x, f32, dev)

        return cls(
            allocatable=allocatable,
            requested=table(requested),
            estimated_used=table(estimated_used),
            prod_used=table(prod_used),
            metric_fresh=(
                torch.ones(n, dtype=torch.bool, device=dev)
                if metric_fresh is None
                else _tensor(metric_fresh, torch.bool, dev)
            ),
            schedulable=(
                torch.ones(n, dtype=torch.bool, device=dev)
                if schedulable is None
                else _tensor(schedulable, torch.bool, dev)
            ),
            cpu_amp=(
                torch.ones(n, dtype=f32, device=dev)
                if cpu_amp is None
                else _tensor(cpu_amp, f32, dev)
            ),
            custom_thresholds=table(custom_thresholds),
            custom_prod_thresholds=table(custom_prod_thresholds),
        )


@dataclass
class PodBatch:
    """Pod block, ``solver.py:128-245``. Leading shape [P] (or [B, P] for a
    stacked stream)."""

    requests: torch.Tensor         # [P, D]
    estimate: torch.Tensor         # [P, D] estimator-scaled usage
    priority: torch.Tensor         # [P] int32
    is_prod: torch.Tensor          # [P] bool
    valid: torch.Tensor            # [P] bool
    gang_id: torch.Tensor          # [P] int32, -1 = no gang
    #: row g holds minMember of gang g; indexed by gang_id, sized [P]
    gang_min: torch.Tensor
    #: leaf-to-root quota index path per pod, [P, L] int32, -1 = none
    quota_chain: torch.Tensor
    #: koord QoS class, [P] int8
    qos: torch.Tensor
    #: whole GPUs requested, [P] int32
    gpu_whole: torch.Tensor
    #: fractional GPU requested in percent of one device, [P] float32
    gpu_share: torch.Tensor
    rdma: torch.Tensor = None            # [P] int32
    fpga: torch.Tensor = None            # [P] int32
    #: row g: True when gang g is NonStrict; indexed by gang_id, sized [P]
    gang_nonstrict: torch.Tensor = None
    numa_required: torch.Tensor = None   # [P] bool

    @classmethod
    def create(
        cls,
        requests,
        priority,
        estimate=None,
        is_prod=None,
        valid=None,
        gang_id=None,
        gang_min=None,
        quota_chain=None,
        qos=None,
        gpu_whole=None,
        gpu_share=None,
        rdma=None,
        fpga=None,
        gang_nonstrict=None,
        numa_required=None,
        quota_levels: int = 4,
        device=None,
    ) -> "PodBatch":
        dev = resolve_device(device)
        requests = _tensor(requests, torch.float32, dev)
        priority = _tensor(priority, torch.int32, dev)
        lead = tuple(requests.shape[:-1])

        def vec(x, dtype, fill, shape=lead):
            if x is None:
                return torch.full(shape, fill, dtype=dtype, device=dev)
            return _tensor(x, dtype, dev)

        return cls(
            requests=requests,
            estimate=(
                requests if estimate is None else _tensor(estimate, torch.float32, dev)
            ),
            priority=priority,
            is_prod=(priority >= 9000) if is_prod is None else _tensor(is_prod, torch.bool, dev),
            valid=vec(valid, torch.bool, True),
            gang_id=vec(gang_id, torch.int32, -1),
            gang_min=vec(gang_min, torch.int32, 0),
            quota_chain=vec(quota_chain, torch.int32, -1, lead + (quota_levels,)),
            qos=vec(qos, torch.int8, 0),
            gpu_whole=vec(gpu_whole, torch.int32, 0),
            gpu_share=vec(gpu_share, torch.float32, 0.0),
            rdma=vec(rdma, torch.int32, 0),
            fpga=vec(fpga, torch.int32, 0),
            gang_nonstrict=vec(gang_nonstrict, torch.bool, False),
            numa_required=vec(numa_required, torch.bool, False),
        )


@dataclass
class QuotaState:
    """ElasticQuota accounting ([Q, D] each), ``solver.py:403-422``."""

    runtime: torch.Tensor
    used: torch.Tensor

    @classmethod
    def disabled(cls, dims: int, device=None) -> "QuotaState":
        dev = resolve_device(device)
        return cls(
            runtime=torch.full((1, dims), torch.inf, dtype=torch.float32, device=dev),
            used=torch.zeros((1, dims), dtype=torch.float32, device=dev),
        )


@dataclass
class SolverParams:
    """LoadAware thresholds/weights on the dense resource axis ([D] each).
    A threshold of 0 disables that dim's usage check."""

    usage_thresholds: torch.Tensor
    prod_thresholds: torch.Tensor
    score_weights: torch.Tensor

    @classmethod
    def create(cls, usage_thresholds, prod_thresholds, score_weights, device=None):
        dev = resolve_device(device)
        return cls(
            usage_thresholds=_tensor(usage_thresholds, torch.float32, dev),
            prod_thresholds=_tensor(prod_thresholds, torch.float32, dev),
            score_weights=_tensor(score_weights, torch.float32, dev),
        )


@dataclass
class SolveResult:
    """One solve's assignments plus its POST-COMMIT capacity tables,
    ``solver.py:438-486``. The device, NUMA and shortlist fields carry the
    reference's placeholders: their slices are not ported yet."""

    assignment: torch.Tensor       # [P] int32 node index, -1 = unschedulable
    node_requested: torch.Tensor   # [N, D] post-commit
    node_estimated_used: torch.Tensor  # [N, D] post-commit
    node_prod_used: torch.Tensor   # [N, D] post-commit
    quota_used: torch.Tensor       # [Q, D]
    rounds_used: torch.Tensor      # [] int32
    node_dev_slots: torch.Tensor = None
    node_rdma_free: torch.Tensor = None
    node_fpga_free: torch.Tensor = None
    node_zone_free: torch.Tensor = None
    pod_zone: torch.Tensor = None
    pod_zone_charge: torch.Tensor = None
    shortlist_fallbacks: torch.Tensor = None


#: extension.QoSClass values used on device (LSR/LSE need exclusive CPUs)
QOS_LSR, QOS_LSE = 3, 4


def _cpu_bind(pods: PodBatch) -> torch.Tensor:
    """[P] bool — pod wants an exclusive cpuset: LSR/LSE QoS with a
    positive whole-core CPU request (``solver.py:612-622``)."""
    cpu_req = pods.requests[:, 0]
    return (
        ((pods.qos == QOS_LSR) | (pods.qos == QOS_LSE))
        & (cpu_req > 0)
        & (torch.remainder(cpu_req, 1000.0) == 0)
    )


def _feasible(
    pods: PodBatch, nodes: NodeState, params: SolverParams, active: torch.Tensor
) -> torch.Tensor:
    """[P, N] bool feasibility (``solver.py:625-657``) in the plain form;
    the round loop evaluates it inside the nomination kernel."""
    thr, pthr = _effective_thresholds(nodes, params)
    return nominate_ops.feasible_mask(
        pods.requests, pods.estimate, pods.is_prod, _cpu_bind(pods), active,
        nodes.allocatable, nodes.requested, nodes.estimated_used,
        nodes.prod_used, nodes.metric_fresh, nodes.schedulable, nodes.cpu_amp,
        thr, pthr,
    )


def _effective_thresholds(nodes: NodeState, params: SolverParams):
    """Contiguous [N, D] effective usage and prod thresholds."""
    n, d = nodes.allocatable.shape
    return tuple(
        effective_thresholds(glob, custom).expand(n, d).contiguous()
        for glob, custom in (
            (params.usage_thresholds, nodes.custom_thresholds),
            (params.prod_thresholds, nodes.custom_prod_thresholds),
        )
    )


def _round_setup(pods: PodBatch, nodes: NodeState, params: SolverParams):
    """What stays fixed over a batch's rounds: the priority order, the
    sorted pods, their cpu-bind flags and the effective thresholds."""
    order = _priority_order(pods)
    spods = tree_map(lambda a: a[order].contiguous(), pods)
    thr, pthr = _effective_thresholds(nodes, params)
    return order, spods, _cpu_bind(spods), thr, pthr


def _priority_order(pods: PodBatch) -> torch.Tensor:
    """Stable (-priority, arrival) order — the activeQ pop order."""
    return torch.sort(-pods.priority, stable=True).indices


def _inverse_permutation(order: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], dtype=order.dtype, device=order.device)
    return inv


def _choose(top_cost, top_idx, active, n: int):
    """Rank-modular choice (``solver.py:1204-1213``): the pod with the r-th
    highest priority among active pods takes slot ``r mod n_feas`` of its
    nomination vector. Returns (choice [P] int32, node_key [P] int32 with
    N where the pod has no finite slot)."""
    finite = torch.isfinite(top_cost)
    n_feas = finite.sum(dim=1, dtype=torch.int32)
    rank = torch.cumsum(active.to(torch.int32), dim=0, dtype=torch.int32) - 1
    slot = torch.where(
        n_feas > 0, torch.remainder(rank, torch.clamp(n_feas, min=1)), 0
    ).long()
    choice = top_idx.gather(1, slot[:, None])[:, 0]
    has = finite.gather(1, slot[:, None])[:, 0]
    return choice, torch.where(has, choice, n).to(torch.int32)


def _commit_inputs(node_key, spods: PodBatch, bind_mask, cpu_amp, n: int):
    """The commit's sorted inputs (``solver.py:1215-1229``): pods stably
    sorted by nominated node, CPU charged ×amp for cpu-bind pods. Returns
    (sortidx, snode, sreq, sest, sprod)."""
    snode, sortidx = torch.sort(node_key, stable=True)
    gnode = torch.clamp(snode, max=n - 1).long()
    sreq = spods.requests[sortidx]
    samp = torch.where(bind_mask[sortidx], torch.clamp(cpu_amp, min=1.0)[gnode], 1.0)
    sreq[:, 0] = sreq[:, 0] * samp
    return (
        sortidx,
        snode.contiguous(),
        sreq.contiguous(),
        spods.estimate[sortidx].contiguous(),
        spods.is_prod[sortidx].contiguous(),
    )


_NOT_PORTED = {
    "quotas": "queue 1 item 7 (quota)",
    "numa": "queue 1 item 9 (NUMA)",
    "devices": "queue 1 item 10 (devices)",
    "node_mask": "queue 1 item 11 (solve_stream_full)",
    "dev_carry": "queue 1 item 10 (devices)",
    "numa_carry": "queue 1 item 9 (NUMA)",
    "numa_scoring": "queue 1 item 9 (NUMA)",
    "device_scoring": "queue 1 item 10 (devices)",
    "shortlist_k": "queue 1 item 4 (shortlist)",
    "cost_transform": "queue 1 item 13 (score terms and transformers)",
}


def _reject_unported(**options) -> None:
    for name, value in options.items():
        if value is not None:
            raise NotImplementedError(
                f"{name} is not ported yet: ROADMAP.md {_NOT_PORTED[name]}"
            )


def assign(
    pods: PodBatch,
    nodes: NodeState,
    params: SolverParams,
    quotas: "QuotaState | None" = None,
    numa=None,
    devices=None,
    max_rounds: int = 24,
    round_quantum: float = 0.35,
    topk: int = 4,
    cost_transform=None,
    nomination_jitter: float = 4.0,
    approx_topk: bool = False,
    node_mask=None,
    dev_carry=None,
    numa_carry=None,
    numa_scoring=None,
    device_scoring=None,
    shortlist_k=None,
) -> SolveResult:
    """Round-based LoadAware solver over one [P] batch, on the device the
    tensors live on. ``round_quantum`` is the fraction of a node's
    allocatable (per dim, in estimated usage) it may accept per round;
    ``topk`` the nomination fan-out; ``nomination_jitter`` the per-(pod,
    node) tie-break band in score points; ``approx_topk`` pins slot 0 to
    the argmin as the reference's TPU path does. Options of other slices
    raise ``NotImplementedError``."""
    _reject_unported(
        quotas=quotas, numa=numa, devices=devices, node_mask=node_mask,
        dev_carry=dev_carry, numa_carry=numa_carry, numa_scoring=numa_scoring,
        device_scoring=device_scoring, shortlist_k=shortlist_k,
        cost_transform=cost_transform,
    )
    p, d = pods.requests.shape
    n = nodes.allocatable.shape[0]
    dev = nodes.allocatable.device
    quota_used = QuotaState.disabled(d, device=dev).used
    order, spods, bind_mask, thr, pthr = _round_setup(pods, nodes, params)
    k = min(topk, n)

    requested = nodes.requested.clone()
    est_used = nodes.estimated_used.clone()
    prod_used = nodes.prod_used.clone()
    assigned = torch.full((p,), -1, dtype=torch.int32, device=dev)
    active = pods.valid[order].clone()
    progress = torch.ones((), dtype=torch.bool, device=dev)
    rounds = 0
    while rounds < max_rounds and bool(progress & active.any()):
        top_cost, top_idx = nominate_ops.nominate(
            spods.requests, spods.estimate, spods.is_prod, bind_mask, active,
            nodes.allocatable, requested, est_used, prod_used,
            nodes.metric_fresh, nodes.schedulable, nodes.cpu_amp, thr, pthr,
            params.score_weights, k, nomination_jitter, approx_topk,
        )
        choice, node_key = _choose(top_cost, top_idx, active, n)
        sortidx, snode, sreq, sest, sprod = _commit_inputs(
            node_key, spods, bind_mask, nodes.cpu_amp, n
        )
        accept = commit_ops.commit(
            snode, sreq, sest, sprod, nodes.allocatable, nodes.metric_fresh,
            thr, pthr, requested, est_used, prod_used, round_quantum,
        )
        accepted = torch.zeros_like(accept)
        accepted[sortidx] = accept
        assigned = torch.where(accepted, choice, assigned)
        active = active & (assigned < 0)
        progress = accepted.any()
        rounds += 1

    # back to original pod order: gather by the inverse permutation
    assignment = assigned[_inverse_permutation(order)]
    result = SolveResult(
        assignment=assignment,
        node_requested=requested,
        node_estimated_used=est_used,
        node_prod_used=prod_used,
        quota_used=quota_used,
        rounds_used=torch.tensor(rounds, dtype=torch.int32, device=dev),
        node_dev_slots=torch.zeros((n, 1), dtype=torch.float32, device=dev),
        node_rdma_free=torch.zeros((n,), dtype=torch.float32, device=dev),
        node_fpga_free=torch.zeros((n,), dtype=torch.float32, device=dev),
        node_zone_free=torch.zeros((n, 1, 1), dtype=torch.float32, device=dev),
        pod_zone=torch.full((p,), -1, dtype=torch.int32, device=dev),
        pod_zone_charge=torch.zeros((p, 1), dtype=torch.float32, device=dev),
        shortlist_fallbacks=torch.zeros((2,), dtype=torch.int32, device=dev),
    )
    # the tables were cloned above and the assignment is fresh: roll back
    # in place
    _enforce_gangs_(result, pods)
    return result


def solve_stream(
    pods_stacked: PodBatch,
    nodes: NodeState,
    params: SolverParams,
    quotas: "QuotaState | None" = None,
    max_rounds: int = 24,
    round_quantum: float = 0.35,
    topk: int = 4,
    cost_transform=None,
    nomination_jitter: float = 4.0,
    approx_topk: bool = False,
    shortlist_k=None,
):
    """Multi-batch solve over a [B, P, ...] stacked :class:`PodBatch`,
    threading consumed node capacity from batch to batch on the device.

    Returns ``(assignments [B, P], final NodeState, placed-per-batch [B],
    final QuotaState)``, as ``solver.py:1671-1733`` does."""
    _reject_unported(
        quotas=quotas, shortlist_k=shortlist_k, cost_transform=cost_transform
    )
    dev = nodes.allocatable.device
    quotas = QuotaState.disabled(pods_stacked.requests.shape[-1], device=dev)
    cur = nodes
    assignments, placed = [], []
    for b in range(pods_stacked.requests.shape[0]):
        res = assign(
            tree_map(lambda a: a[b], pods_stacked),
            cur,
            params,
            max_rounds=max_rounds,
            round_quantum=round_quantum,
            topk=topk,
            nomination_jitter=nomination_jitter,
            approx_topk=approx_topk,
        )
        cur = dataclasses.replace(
            cur,
            requested=res.node_requested,
            estimated_used=res.node_estimated_used,
            prod_used=res.node_prod_used,
        )
        assignments.append(res.assignment)
        placed.append((res.assignment >= 0).sum(dtype=torch.int32))
    return torch.stack(assignments), cur, torch.stack(placed), quotas


def enforce_gangs_plain(result: SolveResult, pods: PodBatch) -> SolveResult:
    """All-or-nothing gang rollback (Coscheduling Permit semantics,
    ``solver.py:1858-1987``), node tables and gang counts only: gangs whose
    placed-member count is below ``minMember`` lose all their placements
    and their node charges, unless the gang is NonStrict. Refunds use the
    unamplified ``pods.requests`` in original pod order, as the reference
    does; the sums are ordered (:func:`.commit.segment_sum_plain`). The
    plain version of ``csrc/gangs.cu``; returns a new result."""
    p, d = pods.requests.shape
    n = result.node_requested.shape[0]
    assignment = result.assignment
    placed = assignment >= 0
    has_gang = pods.gang_id >= 0
    gid = torch.clamp(pods.gang_id, 0, p - 1).long()
    counts = torch.zeros(p, dtype=torch.int32, device=assignment.device)
    counts.index_add_(0, gid, (placed & has_gang).to(torch.int32))
    gang_ok = (counts >= pods.gang_min) | pods.gang_nonstrict
    keep = placed & (~has_gang | gang_ok[gid])
    rollback = placed & ~keep

    node_of = torch.clamp(assignment, 0, n - 1)
    refunds = torch.cat(
        [
            pods.requests,
            pods.estimate,
            torch.where(pods.is_prod[:, None], pods.estimate, 0.0),
        ],
        dim=1,
    )
    delta = commit_ops.segment_sum_plain(refunds, torch.where(rollback, node_of, n), n)
    return dataclasses.replace(
        result,
        assignment=torch.where(keep, assignment, -1),
        node_requested=result.node_requested - delta[:, :d],
        node_estimated_used=result.node_estimated_used - delta[:, d : 2 * d],
        node_prod_used=result.node_prod_used - delta[:, 2 * d :],
        pod_zone=(
            None
            if result.pod_zone is None
            else torch.where(rollback, -1, result.pod_zone)
        ),
    )


_GANG_FIELDS = (
    "assignment", "node_requested", "node_estimated_used", "node_prod_used",
    "pod_zone",
)
_I32, _F32, _BOOL = torch.int32, torch.float32, torch.bool
#: dtypes of koord_enforce_gangs' tensors, in its argument order
_GANG_DTYPES = (_I32, _I32, _I32, _BOOL, _F32, _F32, _BOOL, _F32, _F32, _F32, _I32)


def _enforce_gangs_(result: SolveResult, pods: PodBatch) -> None:
    """Gang rollback in place on ``result``'s assignment, node tables and
    ``pod_zone``: one ``koord_enforce_gangs`` launch (``csrc/gangs.cu``)
    for CUDA tensors, :func:`enforce_gangs_plain` written into ``result``'s
    tensors for CPU tensors."""
    asg = result.assignment
    if asg.is_cpu:
        out = enforce_gangs_plain(result, pods)
        for name in _GANG_FIELDS:
            if getattr(result, name) is not None:
                getattr(result, name).copy_(getattr(out, name))
        return
    p, d = pods.requests.shape
    n = result.node_requested.shape[0]
    pd, nd = p * d, n * d
    ptrs = kernels.checked_ptrs(
        "enforce_gangs",
        (asg, pods.gang_id, pods.gang_min, pods.gang_nonstrict, pods.requests,
         pods.estimate, pods.is_prod, result.node_requested,
         result.node_estimated_used, result.node_prod_used, result.pod_zone),
        _GANG_DTYPES, (p, p, p, p, pd, pd, p, nd, nd, nd, p),
    )
    lib = kernels.library("gangs")
    code = lib.koord_enforce_gangs(*ptrs, p, n, d, kernels.stream_of(asg))
    kernels.check(lib, code, "enforce_gangs")
    kernels.launches["enforce_gangs"] += 1


def enforce_gangs(result: SolveResult, pods: PodBatch) -> SolveResult:
    """All-or-nothing gang rollback (``solver.py:1858-1987``) on the
    tensors' device, functional as the reference is: the result's
    assignment, node tables and ``pod_zone`` are cloned, then rolled back
    in place (:func:`_enforce_gangs_`)."""
    out = dataclasses.replace(result, **{
        name: getattr(result, name).clone()
        for name in _GANG_FIELDS
        if getattr(result, name) is not None
    })
    _enforce_gangs_(out, pods)
    return out
