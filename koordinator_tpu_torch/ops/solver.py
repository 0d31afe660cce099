"""Batched assignment solver: masked argmin with capacity-consuming commit.

Port of ``koordinator_tpu/ops/solver.py``'s LoadAware round solver
(:func:`assign`, :679-1535) and its streams (:func:`solve_stream`,
:1671-1733, and the scheduler's :func:`solve_stream_full`, :1748-1855),
with ElasticQuota admission (``quotas``: :mod:`.quota`), the pods' hard
node constraints (``node_mask``), NUMA zones (``numa``: :mod:`.numa`,
the zone fit and aligned score in every pricing kernel, the zone pick in
the round tail, the zone refund in the rollback, the zone table carried
through a stream) and DeviceShare (``devices``: :mod:`.device`, the GPU,
RDMA and FPGA fit and score in every pricing kernel, the acceptance and
slot commit in the round tail, the refunds in the rollback, the dev carry
through a stream), :func:`enforce_gangs` (:1858-1987, the
CUDA kernel ``csrc/gangs.cu`` on the card, one launch a batch), the
candidate shortlist (:func:`shortlist_plan`, :1547-1657) and the
resident-row helpers :func:`scatter_rows` / :func:`gather_rows`
(:248-283), the BeforeScore ``cost_transform`` (:942-946), whose
route materializes the round's [P, N] cost (:mod:`.cost_full`), and the
exact sequential-commit solver :func:`assign_sequential` (:1990-2241,
:mod:`.sequential`: one persistent launch of ``csrc/sequential.cu`` walks
every pod). Each round of :func:`assign`:

1. nominate — every still-unassigned pod's masked, jittered LoadAware cost
   over all nodes (with quotas only the pods with headroom along their
   chains, the round's gate) and its top-k (:func:`.nominate.nominate`, the CUDA kernel
   ``csrc/nominate.cu`` on the card). With ``shortlist_k`` each batch first
   builds every pod's K candidates (:func:`.shortlist.shortlist_build`,
   ``csrc/shortlist_build.cu``), and a round nominates over them
   (:func:`.shortlist.shortlist_round`, ``csrc/shortlist_round.cu``),
   falling back to the full axis only when the exactness check fails —
   a branch taken on the device. With ``cost_transform`` the round
   instead writes every pair's pre-jitter cost and feasibility
   (:func:`.cost_full.cost_full`, ``csrc/cost_full.cu``), runs the
   transform on that buffer, and nominates over the result
   (:func:`.cost_full.nominate_cost`, ``csrc/nominate_cost.cu``); the
   shortlist is off, as in the reference;
2. the round tail — the pod with the r-th highest priority among active
   pods takes its (r mod k)-th best finite node; pods stably sorted by
   node, segmented prefix sums, acceptance under capacity, thresholds and
   the spread quantum, with quotas the admission along each pod's chain
   and the next round's gate, the winners' charges, and the loop state
   (:func:`.commit.round_tail`, one launch of ``csrc/round.cu`` on the
   card).

Around the rounds, a batch's set-up (the priority order, the fields
gathered in it, the cpu-bind flags, the loop state) and its teardown (the
un-sort, the zone charges and, in a stream, the batch's output row) are
one launch each of ``csrc/batch.cu`` on the card (:func:`batch_setup`,
:func:`batch_teardown`, :func:`batch_outputs`).

Rounds stop at a fixed point (no acceptance, or no active pod) or after
``max_rounds``. The loop state (assignments, active flags and a state word
``(done, rounds)``) lives on the tensors' device. On the card the loop runs
exactly ``max_rounds`` trips with no host read — a trip after the fixed
point changes nothing, its kernels return at once — and
:func:`solve_stream` replays one captured CUDA graph a batch, so a stream
reads nothing back to the host. On the CPU the loop stops when it reads
``done``.

Containers are ``@dataclass``es of tensors in place of ``flax.struct``;
node tables are updated in place inside a solve (the caller's tensors are
cloned first and never written).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from dataclasses import dataclass

import torch

from .. import kernels, resolve_device
from . import commit as commit_ops
from . import cost_full as cost_ops
from . import nominate as nominate_ops
from . import quota as quota_ops
from . import sequential as sequential_ops
from . import shortlist as shortlist_ops
from .device import (MAX_SLOTS, DeviceState, DeviceTerms, device_consumption, slot_cap_of,
                     slot_exists_of)
from .device import SCORING as DEVICE_SCORING
from .numa import SCORING, NumaState, ZoneTerms
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
    ``solver.py:438-486``. With NUMA, ``node_zone_free`` [N, Z, DN] is the
    zone table, ``pod_zone`` [P] each pod's zone (-1 none) and
    ``pod_zone_charge`` [P, DN] what it charged; without, the reference's
    placeholders ([N, 1, 1] zeros, -1, [P, 1] zeros). With devices,
    ``node_dev_slots`` [N, G] is the slot table and ``node_rdma_free`` /
    ``node_fpga_free`` [N] the free counts (zeros where not tracked);
    without, [N, 1] and [N] zeros.
    ``shortlist_fallbacks`` [2] int32 counts the shortlist rounds that fell
    back to the full axis (bound, exhausted); zeros with the shortlist
    off."""

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


#: the pod fields the LoadAware rounds read (and, with quotas, the chains)
_ROUND_FIELDS = ("requests", "estimate", "is_prod", "valid", "qos")


#: the pod fields of the devices
_DEVICE_FIELDS = ("gpu_whole", "gpu_share", "rdma", "fpga")


def _with_quota(fields, quota: bool, numa: bool = False, devices: bool = False):
    """``fields`` and, with quotas, the chains; with NUMA, the pods'
    ``numa_required`` flags; with devices, their device requests."""
    return (fields + (("quota_chain",) if quota else ()) + (("numa_required",) if numa else ())
            + (_DEVICE_FIELDS if devices else ()))


def _only(pods: PodBatch, fields, fn) -> PodBatch:
    """A :class:`PodBatch` of ``fn`` applied to ``fields``; every other
    field is None."""
    return PodBatch(**{
        f.name: fn(getattr(pods, f.name)) if f.name in fields else None
        for f in dataclasses.fields(PodBatch)
    })


def _round_setup(pods: PodBatch, nodes: NodeState, params: SolverParams, thresholds=None,
                 quota: bool = False, numa: bool = False, devices: bool = False):
    """What stays fixed over a batch's rounds: the priority order, the
    sorted pods (only the fields the rounds read, with ``quota`` the
    chains too, with ``numa`` the required flags, with ``devices`` the
    device requests; the others are None),
    their cpu-bind flags (the three from :func:`batch_setup`: one launch
    on the card) and the effective thresholds (``thresholds`` when the
    caller has them: they do not change within a stream)."""
    setup = batch_setup(pods, None, quota, numa, devices)
    thr, pthr = thresholds or _effective_thresholds(nodes, params)
    return setup.order, setup.spods, setup.bind, thr, pthr


def _priority_order(pods: PodBatch) -> torch.Tensor:
    """Stable (-priority, arrival) order — the activeQ pop order."""
    return torch.sort(-pods.priority, stable=True).indices


#: the pod fields the gang rollback reads, in pod order
_ROLLBACK_FIELDS = ("requests", "estimate", "is_prod", "gang_id", "gang_min", "gang_nonstrict")


def _rollback_fields(quota: bool, devices: bool):
    """:data:`_ROLLBACK_FIELDS` and, with quotas, the chains (the quota
    refund); with devices, the device requests (the device refunds)."""
    return (_ROLLBACK_FIELDS + (("quota_chain",) if quota else ())
            + (_DEVICE_FIELDS if devices else ()))


@dataclass
class BatchSetup:
    """What a batch's rounds and gang rollback start from
    (:func:`batch_setup`): ``order`` [P] int64, the stable (-priority,
    arrival) order; ``spods``, the pods in that order (the fields of
    :func:`_round_setup`; the others None); ``bind`` [P] bool, their
    cpu-bind flags; the loop state ``assigned`` [P] int32 (-1) and
    ``state`` [2] int32 ((done, rounds): done when no pod is valid); and,
    each None unless asked for, ``upods`` the rollback's fields in pod
    order (:func:`_rollback_fields`), ``mask_rows`` [P] int64 the node
    mask's rows, ``units`` [P] float32 the device units, ``azone`` [P]
    int32 (-1) the zone picks, the shortlist's ``words`` [R, WORD] and
    ``fallbacks`` [2] int32 (zeros), and ``slot_cap`` [N] float32, each
    node's real slots times 100 (the device refund's capacities)."""

    order: torch.Tensor
    spods: PodBatch
    bind: torch.Tensor
    assigned: torch.Tensor
    state: torch.Tensor
    upods: "PodBatch | None" = None
    mask_rows: "torch.Tensor | None" = None
    units: "torch.Tensor | None" = None
    azone: "torch.Tensor | None" = None
    words: "torch.Tensor | None" = None
    fallbacks: "torch.Tensor | None" = None
    slot_cap: "torch.Tensor | None" = None


def batch_setup_plain(pods: PodBatch, index=None, quota: bool = False, numa: bool = False,
                      devices: bool = False, *, mask: bool = False, words: int = 0,
                      cap_total=None, slots: int = 0) -> BatchSetup:
    """The plain version of :func:`batch_setup`: PyTorch ops, as
    ``solver.py:612-622, 660-663, 720-724, 756, 1454-1470`` do them (the
    fields gathered in the priority order, the cpu-bind flags, the loop's
    initial state), with the stream step's gather of batch ``index``
    (:1704, :1805)."""
    sorted_f = _with_quota(_ROUND_FIELDS, quota, numa, devices)
    unsorted_f = () if index is None else _rollback_fields(quota, devices)
    if index is not None:
        need = set(sorted_f) | set(unsorted_f) | {"priority", "valid"}
        pods = _only(pods, need, lambda a: a.index_select(0, index)[0])
    p = pods.priority.shape[0]
    dev = pods.priority.device
    order = _priority_order(pods)
    spods = _only(pods, sorted_f, lambda a: a[order])
    state = torch.zeros((2,), dtype=torch.int32, device=dev)
    state[0].copy_(~spods.valid.any())
    out = BatchSetup(order=order, spods=spods, bind=_cpu_bind(spods),
                     assigned=torch.full((p,), -1, dtype=torch.int32, device=dev), state=state)
    if index is not None:
        out.upods = _only(pods, unsorted_f, lambda a: a)
    if mask:
        out.mask_rows = order + index * p
    if devices:
        out.units = device_consumption(spods.gpu_whole, spods.gpu_share)[1]
    if numa:
        out.azone = torch.full((p,), -1, dtype=torch.int32, device=dev)
    if words:
        out.words = torch.zeros((words, shortlist_ops.WORD), dtype=torch.int32, device=dev)
        out.fallbacks = torch.zeros((2,), dtype=torch.int32, device=dev)
    if cap_total is not None:
        out.slot_cap = slot_cap_of(slot_exists_of(cap_total, slots))
    return out


@functools.lru_cache(maxsize=64)
def _setup_scratch_bytes(index: int, p: int) -> int:
    """Bytes of device memory a set-up of ``p`` pods needs on device
    ``index``: 0 while its sort fits in shared memory."""
    lib = kernels.library("batch")
    nbytes = ctypes.c_longlong(0)
    with torch.cuda.device(index):
        kernels.check(lib, lib.koord_batch_scratch(p, ctypes.byref(nbytes)), "batch_setup scratch")
    return nbytes.value


#: dtypes of the pod fields the set-up kernel reads besides the copies
_SETUP_SOURCES = (("priority", torch.int32), ("valid", torch.bool), ("qos", torch.int8),
                  ("requests", torch.float32))


def batch_setup(pods: PodBatch, index=None, quota: bool = False, numa: bool = False,
                devices: bool = False, *, mask: bool = False, words: int = 0, cap_total=None,
                slots: int = 0) -> BatchSetup:
    """A batch's set-up before its first round (:class:`BatchSetup`), on
    the tensors' device: one launch of ``koord_batch_setup``
    (``csrc/batch.cu``) for CUDA tensors, :func:`batch_setup_plain` for CPU
    tensors. ``pods`` is a [P] batch, or with ``index`` (a [1] int64
    tensor on its device) a stacked [B, P] batch read at batch ``index``,
    copied from in place, whose rollback's fields the set-up copies in pod
    order. ``quota``, ``numa`` and ``devices`` choose the sorted fields
    (:func:`_with_quota`), with ``numa`` the zone picks and with
    ``devices`` the units; ``mask`` (with ``index``) the node mask's rows
    ``order + index * P``; ``words`` (R > 0) the shortlist's R words and
    fallback counts; ``cap_total`` [N] with ``slots`` (G) the device
    refund's capacities.
    Raises :class:`..kernels.KernelError` when the kernel cannot be built
    or launched."""
    if pods.priority.is_cpu:
        return batch_setup_plain(pods, index, quota, numa, devices, mask=mask, words=words,
                                 cap_total=cap_total, slots=slots)
    if mask and index is None:
        raise ValueError("batch_setup: the mask's rows are a stacked batch's, at an index")
    lead = 1 if index is None else 2
    shape = tuple(pods.priority.shape)
    p, b = shape[-1], (1 if index is None else shape[0])
    if len(shape) != lead:
        raise kernels.KernelArgumentError(f"batch_setup: priority must be {lead}-D, got {shape}")
    if p > commit_ops.MAX_ROUND_PODS:
        raise kernels.KernelArgumentError(
            f"batch_setup: P={p} must be at most {commit_ops.MAX_ROUND_PODS}")
    dev = pods.priority.device
    d = pods.requests.shape[-1]
    sorted_f = _with_quota(_ROUND_FIELDS, quota, numa, devices)
    unsorted_f = () if index is None else _rollback_fields(quota, devices)
    names = sorted_f + tuple(f for f in unsorted_f if f not in sorted_f)
    srcs = [getattr(pods, name) for name in names]
    kernels.checked_ptrs("batch_setup", [pods.priority] + srcs, [pods.priority.dtype]
                         + [t.dtype for t in srcs], [b * p] + [t.numel() for t in srcs])
    spods, upods, table = {}, {}, []

    def empty(t):
        return torch.empty((p,) + tuple(t.shape[lead:]), dtype=t.dtype, device=dev)

    for name, src in zip(names, srcs):
        if tuple(src.shape[:lead]) != shape:
            raise kernels.KernelArgumentError(
                f"batch_setup: {name} must lead with {shape}, got {tuple(src.shape)}")
        if name in sorted_f:
            spods[name] = empty(src)
        if name in unsorted_f:
            upods[name] = empty(src)
        table += [src.data_ptr(), spods[name].data_ptr() if name in spods else 0,
                  upods[name].data_ptr() if name in upods else 0,
                  src.element_size() * (src.numel() // (b * p))]
    spods = PodBatch(**{f.name: spods.get(f.name) for f in dataclasses.fields(PodBatch)})
    i32, f32 = torch.int32, torch.float32
    out = BatchSetup(order=torch.empty((p,), dtype=torch.int64, device=dev), spods=spods,
                     bind=torch.empty((p,), dtype=torch.bool, device=dev),
                     assigned=torch.empty((p,), dtype=i32, device=dev),
                     state=torch.empty((2,), dtype=i32, device=dev))
    if index is not None:
        out.upods = PodBatch(**{f.name: upods.get(f.name) for f in dataclasses.fields(PodBatch)})
    if mask:
        out.mask_rows = torch.empty((p,), dtype=torch.int64, device=dev)
    if devices:
        out.units = torch.empty((p,), dtype=f32, device=dev)
    if numa:
        out.azone = torch.empty((p,), dtype=i32, device=dev)
    zeros = None
    if words:
        # one buffer the kernel zeroes: the words, then the counts
        zeros = torch.empty((words * shortlist_ops.WORD + 2,), dtype=i32, device=dev)
        out.words = zeros[:-2].view(words, shortlist_ops.WORD)
        out.fallbacks = zeros[-2:]
    n = 0
    if cap_total is not None:
        n = cap_total.shape[0]
        out.slot_cap = torch.empty((n,), dtype=f32, device=dev)
    sources = [getattr(pods, name) for name, _ in _SETUP_SOURCES]
    dev_src = [pods.gpu_whole, pods.gpu_share] if devices else [None, None]
    ptrs = kernels.checked_ptrs(
        "batch_setup",
        sources + dev_src + [index, out.mask_rows, out.units, out.assigned, out.azone, out.state,
                             cap_total],
        [t for _, t in _SETUP_SOURCES] + [i32, f32, torch.int64, torch.int64, f32, i32, i32, i32,
                                          f32],
        [b * p, b * p, b * p, b * p * d, b * p, b * p, 1, p, p, p, p, 2, n],
    )
    nbytes = _setup_scratch_bytes(dev.index or 0, p)
    # the sort's working set above 4,096 pods, as the round tail's (ops/commit.py)
    buf = torch.empty(nbytes, dtype=torch.uint8, device=dev) if nbytes else None
    fields = (ctypes.c_longlong * len(table))(*table)
    lib = kernels.library("batch")
    code = lib.koord_batch_setup(
        ctypes.addressof(fields), len(names), ptrs[6], p, *ptrs[:4], d, *ptrs[4:6],
        out.order.data_ptr(), ptrs[7], out.bind.data_ptr(), *ptrs[8:12],
        None if zeros is None else zeros.data_ptr(), 0 if zeros is None else zeros.numel(),
        ptrs[12], None if out.slot_cap is None else out.slot_cap.data_ptr(), n, slots,
        None if buf is None else buf.data_ptr(), kernels.stream_of(pods.priority))
    kernels.check(lib, code, "batch_setup")
    kernels.count("batch_setup")
    return out


def _zone_charges(requests, bind, cpu_amp, assigned, azone, dn: int) -> torch.Tensor:
    """[P, DN] the zone charge each zoned pod applied (``solver.py:1497-1509``),
    in the pods' order of ``requests`` [P, D], ``bind`` [P], ``assigned``
    and ``azone`` [P]: its zone-scoped request, CPU times ``max(cpu_amp,
    1)`` of its node for cpuset-bound pods, zero where it holds no zone."""
    n = cpu_amp.shape[0]
    amp = torch.clamp(cpu_amp, min=1.0)[torch.clamp(assigned, 0, n - 1).long()]
    charge = requests[:, :dn].clone()
    charge[:, 0] = charge[:, 0] * torch.where(bind, amp, 1.0)
    return torch.where((azone >= 0)[:, None], charge, 0.0)


def batch_teardown_plain(setup: BatchSetup, cpu_amp, dn=None):
    """The plain version of :func:`batch_teardown`: the rounds' assignment
    (and with ``dn`` the zone picks) back in pod order
    (``solver.py:1494-1496``), and with ``dn`` the zone charges
    (:1497-1509), worked out in priority order and moved with the rows."""
    order = setup.order
    assignment = torch.empty_like(setup.assigned).scatter_(0, order, setup.assigned)
    if dn is None:
        return assignment, None, None
    pod_zone = torch.empty_like(setup.azone).scatter_(0, order, setup.azone)
    charge = _zone_charges(setup.spods.requests, setup.bind, cpu_amp, setup.assigned,
                           setup.azone, dn)
    return assignment, pod_zone, torch.empty_like(charge).index_copy_(0, order, charge)


def batch_teardown(setup: BatchSetup, cpu_amp, dn=None):
    """A batch's teardown after its last round tail, on the tensors'
    device: (assignment [P] int32 in pod order, and with ``dn`` (the zone
    table's DN) the zone picks [P] int32 and charges [P, DN] float32 in pod
    order, else None and None). One launch of ``koord_batch_teardown``
    (``csrc/batch.cu``, mode 0) for CUDA tensors, counted as
    ``batch_teardown``; :func:`batch_teardown_plain` for CPU tensors."""
    if setup.assigned.is_cpu:
        return batch_teardown_plain(setup, cpu_amp, dn)
    p, d = setup.spods.requests.shape
    n = cpu_amp.shape[0]
    dev = setup.assigned.device
    assignment = torch.empty((p,), dtype=torch.int32, device=dev)
    pod_zone = zone_charge = None
    if dn is not None:
        pod_zone = torch.empty((p,), dtype=torch.int32, device=dev)
        zone_charge = torch.empty((p, dn), dtype=torch.float32, device=dev)
    i32, f32 = torch.int32, torch.float32
    ptrs = kernels.checked_ptrs(
        "batch_teardown",
        (setup.order, setup.assigned, setup.azone, setup.spods.requests, setup.bind, cpu_amp,
         assignment, pod_zone, zone_charge),
        (torch.int64, i32, i32, f32, torch.bool, f32, i32, i32, f32),
        (p, p, p, p * d, p, n, p, p, p * (dn or 0)),
    )
    lib = kernels.library("batch")
    code = lib.koord_batch_teardown(0, p, *ptrs[:5], d, ptrs[5], n, dn or 0, *ptrs[6:],
                                    *[None] * 8, kernels.stream_of(assignment))
    kernels.check(lib, code, "batch_teardown")
    kernels.count("batch_teardown")
    return assignment, pod_zone, zone_charge


def batch_outputs_plain(outs, index, assignment, pod_zone, rounds, fallbacks) -> None:
    """The plain version of :func:`batch_outputs`: ``index_copy_`` into
    row ``index`` of each output, then ``index + 1``."""
    asg, placed, rounds_out, fb, zsel = outs
    asg.index_copy_(0, index, assignment[None])
    placed.index_copy_(0, index, (assignment >= 0).sum(dtype=torch.int32)[None])
    rounds_out.index_copy_(0, index, rounds.reshape(1))
    if fb is not None:
        fb.index_copy_(0, index, fallbacks[None])
    if zsel is not None:
        zsel.index_copy_(0, index, pod_zone[None])
    index.add_(1)


def batch_outputs(outs, index, assignment, pod_zone, rounds, fallbacks) -> None:
    """Row ``index`` ([1] int64) of a stream's outputs ``outs`` =
    (assignments [B, P], placed [B], rounds [B], fallbacks [B, 2] or None,
    zone picks [B, P] or None) from a batch's rolled-back ``assignment`` and
    ``pod_zone`` [P] int32, its ``rounds`` [] and ``fallbacks`` [2] int32
    (``solver.py:1704-1733, 1805-1855``), then the index's advance to the
    next batch. One launch of ``koord_batch_teardown`` (mode 1: the placed
    count an integer block sum) for CUDA tensors, counted as
    ``batch_outputs``; :func:`batch_outputs_plain` for CPU tensors."""
    if assignment.is_cpu:
        return batch_outputs_plain(outs, index, assignment, pod_zone, rounds, fallbacks)
    asg, placed, rounds_out, fb, zsel = outs
    b, p = asg.shape
    i32 = torch.int32
    ptrs = kernels.checked_ptrs(
        "batch_outputs",
        (assignment, pod_zone, index, rounds, fallbacks, asg, placed, rounds_out, fb, zsel),
        (i32, i32, torch.int64, i32, i32, i32, i32, i32, i32, i32),
        (p, p, 1, 1, 2, b * p, b, b, 2 * b, b * p),
    )
    lib = kernels.library("batch")
    code = lib.koord_batch_teardown(1, p, *[None] * 5, 0, None, 0, 0, ptrs[0], ptrs[1], None,
                                    *ptrs[2:], kernels.stream_of(assignment))
    kernels.check(lib, code, "batch_outputs")
    kernels.count("batch_outputs")


def _zone_most(numa: "NumaState | None") -> "torch.Tensor | None":
    """The nodes' MostAllocated zone-pick flags: ``zone_most``, or False
    everywhere when it is None (``solver.py:785-789``); None without
    NUMA."""
    if numa is None:
        return None
    if numa.zone_most is not None:
        return numa.zone_most
    return torch.zeros(numa.policy.shape, dtype=torch.bool, device=numa.policy.device)


def _scoring(numa_scoring) -> int:
    """``ZoneTerms.scoring`` of a ``numa_scoring`` option; raises for one
    the reference does not know."""
    if numa_scoring not in SCORING:
        raise ValueError(f"numa_scoring={numa_scoring!r}: expected one of {list(SCORING)}")
    return SCORING[numa_scoring]


def _device_scoring(device_scoring) -> int:
    """``DeviceTerms.scoring`` of a ``device_scoring`` option; raises for
    one the reference does not know."""
    if device_scoring not in DEVICE_SCORING:
        raise ValueError(
            f"device_scoring={device_scoring!r}: expected one of {list(DEVICE_SCORING)}")
    return DEVICE_SCORING[device_scoring]


def _devices_of(devices, tables, device_scoring):
    """``_assign_``'s ``devs`` for a DeviceState whose carried tables are
    ``tables`` = (slots [N, G], rdma [N], fpga [N]; updated in place), or
    None without devices. A count the state does not track stays None."""
    if devices is None:
        return None
    slots, rdma, fpga = tables
    return (slots, None if devices.rdma_free is None else rdma,
            None if devices.fpga_free is None else fpga, devices.cap_total,
            _device_scoring(device_scoring))


def _zones_of(numa, zone_free, numa_scoring, zone_most):
    """``_assign_``'s ``zones`` for a NumaState whose carried table is
    ``zone_free`` (updated in place), or None without NUMA; ``zone_most``
    the state's :func:`_zone_most`."""
    if numa is None:
        return None
    return (zone_free, numa.zone_cap, numa.policy, zone_most, _scoring(numa_scoring))


def _shortlist_on(shortlist_k, topk: int, n: int, device_scoring=None,
                  cost_transform=None) -> bool:
    """The reference's static gate (``solver.py:856-862``): a shortlist of
    K nodes with k <= K < N, where k is the nomination fan-out, no cost
    transform (an arbitrary rewrite breaks the bound) and no MostAllocated
    device scoring (it rewards usage, so an excluded node's cost can fall
    below its bound)."""
    return (shortlist_k is not None and min(topk, n) <= shortlist_k < n
            and cost_transform is None and device_scoring != "MostAllocated")


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
    the argmin as the reference's TPU path does; ``shortlist_k`` prunes
    each round's node axis to each pod's K build-time candidates, with the
    same decisions (off unless k <= K < N). ``quotas`` turns on
    ElasticQuota admission along each pod's ``quota_chain``
    (``SolveResult.quota_used`` is the post-commit table); ``node_mask``
    [P, N] bool holds the pods' hard node constraints (nodeSelector,
    required nodeAffinity, ``spec.nodeName``). ``numa`` (a
    :class:`.numa.NumaState`) turns on the NUMA zones: the fit under each
    node's topology policy and, with ``numa_scoring`` ("LeastAllocated" or
    "MostAllocated"), the aligned score, both from the table as the batch
    began (``numa_carry`` [N, Z, DN] in place of ``numa.zone_free`` when
    given), and the zone pick of each winner in the round tail;
    ``SolveResult.node_zone_free``, ``pod_zone`` and ``pod_zone_charge``
    then hold the post-commit table, the picks and their charges.
    ``devices`` (a :class:`.device.DeviceState`) turns on DeviceShare: the
    GPU, RDMA and FPGA fit and, with ``device_scoring`` ("LeastAllocated" or
    "MostAllocated"), the device score, both from each round's start; the
    round tails' acceptance and charges on the slot table; the gang
    rollback's refunds. ``dev_carry`` = (slot_free [N, G], rdma_free [N],
    fpga_free [N]) replaces the state's tables (a chunk's carry);
    ``SolveResult.node_dev_slots``, ``node_rdma_free`` and
    ``node_fpga_free`` then hold the post-commit tables (zeros for a count
    the state does not track). ``cost_transform``, a torch callable
    ``[P, N] float32 -> [P, N] float32`` (the scheduler's BeforeScore
    chain), rewrites each round's cost of the priority-sorted pods over
    every node before the jitter, as ``solver.py:942-946`` does; it turns
    the shortlist off. Its route keeps a [P, N] cost and flag buffer for
    the batch (:mod:`.cost_full`)."""
    p, d = pods.requests.shape
    n = nodes.allocatable.shape[0]
    dev = nodes.allocatable.device
    tables = dataclasses.replace(
        nodes,
        requested=nodes.requested.clone(),
        estimated_used=nodes.estimated_used.clone(),
        prod_used=nodes.prod_used.clone(),
    )
    quota = None if quotas is None else (quotas.runtime, quotas.used.clone())
    zone_free = None
    if numa is not None:
        zone_free = (numa.zone_free if numa_carry is None else numa_carry).clone()
    dev_tables = None
    if devices is not None:
        zeros = torch.zeros((n,), dtype=torch.float32, device=dev)
        if dev_carry is None:
            dev_carry = (devices.slot_free,
                         zeros if devices.rdma_free is None else devices.rdma_free,
                         zeros if devices.fpga_free is None else devices.fpga_free)
        dev_tables = tuple(t.clone() for t in dev_carry)
    _device_scoring(device_scoring)
    assignment, rounds, fallbacks, pod_zone, zone_charge = _assign_(
        pods, tables, params, max_rounds=max_rounds, round_quantum=round_quantum,
        topk=topk, nomination_jitter=nomination_jitter, approx_topk=approx_topk,
        shortlist_k=shortlist_k, quota=quota, node_mask=node_mask,
        zones=_zones_of(numa, zone_free, numa_scoring, _zone_most(numa)),
        devs=_devices_of(devices, dev_tables, device_scoring), device_scoring=device_scoring,
        cost_transform=cost_transform,
    )
    if dev_tables is None:
        dev_tables = (torch.zeros((n, 1), dtype=torch.float32, device=dev),
                      torch.zeros((n,), dtype=torch.float32, device=dev),
                      torch.zeros((n,), dtype=torch.float32, device=dev))
    if numa is None:
        # no zone is picked without NUMA, so no rollback writes one
        zone_free = torch.zeros((n, 1, 1), dtype=torch.float32, device=dev)
        pod_zone = torch.full((p,), -1, dtype=torch.int32, device=dev)
        zone_charge = torch.zeros((p, 1), dtype=torch.float32, device=dev)
    return SolveResult(
        assignment=assignment,
        node_requested=tables.requested,
        node_estimated_used=tables.estimated_used,
        node_prod_used=tables.prod_used,
        quota_used=QuotaState.disabled(d, device=dev).used if quota is None else quota[1],
        rounds_used=rounds,
        node_dev_slots=dev_tables[0],
        node_rdma_free=dev_tables[1],
        node_fpga_free=dev_tables[2],
        node_zone_free=zone_free,
        pod_zone=pod_zone,
        pod_zone_charge=zone_charge,
        shortlist_fallbacks=(
            torch.zeros((2,), dtype=torch.int32, device=dev)
            if fallbacks is None else fallbacks
        ),
    )


def _assign_(
    pods: PodBatch,
    nodes: NodeState,
    params: SolverParams,
    max_rounds: int,
    round_quantum: float,
    topk: int,
    nomination_jitter: float,
    approx_topk: bool,
    shortlist_k=None,
    thresholds=None,
    quota=None,
    node_mask=None,
    index=None,
    zones=None,
    devs=None,
    device_scoring=None,
    cost_transform=None,
):
    """:func:`assign`'s rounds and gang rollback with ``nodes``' tables
    (``requested``, ``estimated_used``, ``prod_used``) updated in place.
    Returns (assignment [P] int32, rounds_used [] int32, the shortlist's
    fallback counts [2] int32 or None with the shortlist off, and with
    ``zones`` the pods' zone picks [P] int32 and zone charges [P, DN], else
    None and None). Reads nothing back to the host on the card, so a CUDA
    graph can capture it. ``pods`` is the batch, or with ``index`` (a [1]
    int64 tensor on the device: a stream's batch index) a stacked [B, P]
    batch, read at batch ``index`` by the set-up (:func:`batch_setup`, one
    launch on the card, as is the teardown, :func:`batch_teardown`).

    With the shortlist on, the build runs once, from the tables as they
    are before the first round; each trip then runs the shortlist round,
    the full-axis nomination (which returns at once unless the round's
    trigger word is set) and the round tail, all reading one nomination
    buffer.

    ``quota`` = (runtime, used) [Q, D] turns on the quota gate and commit;
    ``used`` is updated in place (commits, then the gang rollback's
    refund). The rounds price only gated pods — active, with headroom along
    their chains — written for round 0 by :func:`.quota.quota_gate` and
    for each next round by the round tail. ``node_mask`` [M, N] bool (or
    any [..., N]) holds the pods' node constraints: sorted pod j reads row
    ``order[j]``, plus ``index * P`` with ``index`` (a stream's stacked
    [C, P, N] mask). The mask is read in place, never copied.

    ``zones`` = (zone_free [N, Z, DN], zone_cap, policy, zone_most,
    scoring) turns on the NUMA zones: the pricing reads a copy of
    ``zone_free`` taken before the first round (the reference prices from
    the batch-start table, ``solver.py:771-818``), the round tails pick
    the winners' zones and charge ``zone_free`` in place, and the gang
    rollback refunds the rolled-back pods' zone charges.

    ``devs`` = (slots [N, G], rdma [N] or None, fpga [N] or None,
    cap_total [N] or None, scoring) turns on the devices: the batch's stats
    table is worked out once (:class:`.device.DeviceTerms`), the pricing
    reads it and the free counts, the round tails charge the tables in
    place and refresh the stats of the nodes they charge, and the gang
    rollback refunds. ``device_scoring`` is the option as given: the
    shortlist is off under "MostAllocated", with or without devices, as in
    the reference.

    ``cost_transform`` (a torch callable) takes the materialized-cost
    route: each trip writes the pairs' pre-jitter cost and flags into
    buffers kept for the batch (:func:`.cost_full.cost_full`), calls the
    transform on the cost, and nominates over its result
    (:func:`.cost_full.nominate_cost`); both kernels return at once after
    the fixed point, the transform then runs on the stale buffer and its
    result is not read. The shortlist is off."""
    p = pods.requests.shape[-2]
    n = nodes.allocatable.shape[0]
    dev = nodes.allocatable.device
    k = min(topk, n)
    shortlist = cost_transform is None and _shortlist_on(shortlist_k, topk, n, device_scoring)
    stacked = index is not None
    setup = batch_setup(
        pods, index, quota is not None, zones is not None, devs is not None,
        mask=stacked and node_mask is not None, words=max_rounds if shortlist else 0,
        cap_total=None if devs is None else devs[3], slots=0 if devs is None else devs[0].shape[1],
    )
    spods, bind_mask = setup.spods, setup.bind
    thr, pthr = thresholds or _effective_thresholds(nodes, params)
    mask = None
    if node_mask is not None:
        mask = (node_mask, setup.order if setup.mask_rows is None else setup.mask_rows)

    requested, est_used, prod_used = nodes.requested, nodes.estimated_used, nodes.prod_used
    assigned = setup.assigned
    active = spods.valid  # a fresh gather, the rounds' own
    # (done, rounds): done before the first round when no pod is active
    state = setup.state
    node_args = (nodes.allocatable, requested, est_used, prod_used,
                 nodes.metric_fresh, nodes.schedulable, nodes.cpu_amp, thr, pthr,
                 params.score_weights)
    gate, round_quota = active, None
    if quota is not None:
        runtime, used = quota
        gate = torch.empty_like(active)
        quota_ops.quota_gate(active, spods.requests, spods.quota_chain, runtime, used, gate)
        round_quota = (spods.quota_chain, runtime, used, gate)
    terms = round_zone = None
    if zones is not None:
        zone_free, zone_cap, policy, zone_most, scoring = zones
        terms = ZoneTerms.batch_start(zone_free, zone_cap, policy, spods.numa_required, scoring)
        round_zone = (zone_free, zone_cap, policy, zone_most, spods.numa_required, setup.azone,
                      terms.side)
    dterms = None
    if devs is not None:
        dterms = DeviceTerms.batch_start(*devs[:4], spods, devs[4], units=setup.units)
    fallbacks = None
    if cost_transform is not None:
        # the batch's buffers, never a round's: 5 bytes a pair
        cost_buf = (torch.empty((p, n), dtype=torch.float32, device=dev),
                    torch.empty((p, n), dtype=torch.uint8, device=dev))
        top_buf = (torch.empty((p, k), dtype=torch.float32, device=dev),
                   torch.empty((p, k), dtype=torch.int32, device=dev))
    elif shortlist:
        plan = shortlist_ops.shortlist_build(
            spods.requests, spods.estimate, spods.is_prod, bind_mask, *node_args,
            shortlist_k, nomination_jitter, mask, zones=terms, devices=dterms,
        )
        # one word a trip: trip t is round t while the loop runs
        words, fallbacks = setup.words, setup.fallbacks
    elif terms is not None or dterms is not None:
        # the full axis every round: the term kernels take the pods in
        # the batch's order (the shortlist's rare fallback takes them in
        # place)
        held = dterms if dterms is not None else terms
        held.order = nominate_ops.pod_order(bind_mask, terms, dterms)
    for t in range(max_rounds):
        if state.is_cpu and bool(state[0]):
            break
        # the pricing kernels take the gate; the round tail ranks the
        # active pods
        pod_args = (spods.requests, spods.estimate, spods.is_prod, bind_mask, gate)
        if cost_transform is not None:
            cost_ops.cost_full(*pod_args, *node_args, mask=mask, zones=terms, devices=dterms,
                               state=state, out=cost_buf)
            cost = _transformed(cost_transform, cost_buf[0])
            top_cost, top_idx = cost_ops.nominate_cost(
                cost, cost_buf[1], k, nomination_jitter, approx_topk, state=state, out=top_buf)
        elif fallbacks is None:
            top_cost, top_idx = nominate_ops.nominate(
                *pod_args, *node_args, k, nomination_jitter, approx_topk, state=state,
                mask=mask, zones=terms, devices=dterms,
            )
        else:
            top = shortlist_ops.shortlist_round(
                *pod_args, *node_args, *plan, k, nomination_jitter, approx_topk,
                words[t], fallbacks, state, mask, zones=terms, devices=dterms,
            )
            top_cost, top_idx = nominate_ops.nominate(
                *pod_args, *node_args, k, nomination_jitter, approx_topk, state=state,
                trigger=words[t], out=top, mask=mask, zones=terms, devices=dterms,
            )
        commit_ops.round_tail(
            top_cost, top_idx, spods.requests, spods.estimate, spods.is_prod,
            bind_mask, nodes.cpu_amp, nodes.allocatable, nodes.metric_fresh,
            thr, pthr, requested, est_used, prod_used, assigned, active, state,
            round_quantum, round_quota, round_zone, dterms,
        )

    # back to original pod order: assignment[order[j]] = assigned[j]
    assignment, pod_zone, zone_charge = batch_teardown(
        setup, nodes.cpu_amp, None if zones is None else zones[0].shape[-1])
    # the assignment is fresh and the tables are the caller's to update:
    # roll back in place, reading the pods in pod order
    _enforce_gangs_(
        SolveResult(
            assignment=assignment, node_requested=requested,
            node_estimated_used=est_used, node_prod_used=prod_used,
            quota_used=None if quota is None else quota[1], rounds_used=None,
            node_zone_free=None if zones is None else zones[0], pod_zone=pod_zone,
            pod_zone_charge=zone_charge,
            node_dev_slots=None if devs is None else devs[0],
            node_rdma_free=None if devs is None else devs[1],
            node_fpga_free=None if devs is None else devs[2],
        ),
        setup.upods if stacked else pods,
        setup.slot_cap,
    )
    return assignment, state[1], fallbacks, pod_zone, zone_charge


def _transformed(cost_transform, cost: torch.Tensor) -> torch.Tensor:
    """``cost_transform(cost)``, checked: a float32 tensor of ``cost``'s
    shape on its device, made contiguous."""
    out = cost_transform(cost)
    if (not isinstance(out, torch.Tensor) or out.dtype is not torch.float32
            or out.shape != cost.shape or out.device != cost.device):
        raise ValueError(
            f"cost_transform must return a float32 tensor of shape {tuple(cost.shape)} "
            f"on {cost.device}"
        )
    return out.contiguous()


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
    cuda_graph: bool = True,
    rounds_out: "torch.Tensor | None" = None,
    fallbacks_out: "torch.Tensor | None" = None,
):
    """Multi-batch solve over a [B, P, ...] stacked :class:`PodBatch`,
    threading consumed node capacity (and with ``quotas`` the quota table)
    from batch to batch on the device.

    Returns ``(assignments [B, P], final NodeState, placed-per-batch [B],
    final QuotaState)``, as ``solver.py:1671-1733`` does, in fresh tensors
    (the caller's are never written; without ``quotas`` the final
    QuotaState is the disabled sentinel). ``rounds_out``, a [B] int32
    tensor on the device, receives each batch's ``rounds_used``;
    ``fallbacks_out``, a [B, 2] int32 tensor, each batch's
    ``shortlist_fallbacks`` (zeros with the shortlist off), as
    ``solve_stream_full`` returns them (``solver.py:1748-1855``).
    ``cost_transform`` is :func:`assign`'s, applied in every batch.

    On CUDA tensors one batch's :func:`assign` — the priority sort, the
    gathers, ``max_rounds`` trips of nomination and round tail, the gang
    rollback — is captured once as a CUDA graph and replayed B times, each
    replay taking its batch's pods through a device index the graph
    advances (:class:`_StreamGraph`); nothing is read back to the host.
    ``cuda_graph=False`` runs the batches eagerly instead (the plain route
    on the card, whose plain versions read through the host). With a
    ``cost_transform`` the batches always run eagerly: the user's callable
    need not be capturable. They still read nothing back to the host."""
    kw = dict(max_rounds=max_rounds, round_quantum=round_quantum, topk=topk,
              nomination_jitter=nomination_jitter, approx_topk=approx_topk,
              shortlist_k=shortlist_k)
    if cost_transform is not None:
        kw["cost_transform"] = cost_transform
    tables, (asg, placed, rounds, fallbacks, _), qused, _, _ = _run_stream(
        pods_stacked, nodes, params, quotas, None, None, kw, cuda_graph
    )
    _copy_out(rounds, fallbacks, rounds_out, fallbacks_out)
    final = dataclasses.replace(
        nodes, requested=tables[0], estimated_used=tables[1], prod_used=tables[2]
    )
    if quotas is None:
        final_quotas = QuotaState.disabled(
            pods_stacked.requests.shape[-1], device=nodes.allocatable.device
        )
    else:
        final_quotas = QuotaState(runtime=quotas.runtime, used=qused)
    return asg, final, placed, final_quotas


def solve_stream_full(
    pods_stacked: PodBatch,
    nodes: NodeState,
    params: SolverParams,
    quotas: "QuotaState | None" = None,
    numa=None,
    devices=None,
    max_rounds: int = 24,
    round_quantum: float = 0.35,
    topk: int = 4,
    nomination_jitter: float = 4.0,
    approx_topk: bool = False,
    numa_scoring=None,
    device_scoring=None,
    node_mask=None,
    shortlist_k=None,
    cuda_graph: bool = True,
    zone_free_out: "torch.Tensor | None" = None,
    dev_out=None,
):
    """The scheduler's stream (``solver.py:1748-1855``): chunks of a
    [C, P, ...] stacked :class:`PodBatch` solved one after another,
    threading node capacity, the quota table, with ``numa`` (a
    :class:`.numa.NumaState`) the zone table and with ``devices`` (a
    :class:`.device.DeviceState`) the slot table and free RDMA and FPGA
    counts (the dev carry), with ``node_mask`` [C, P, N] bool the chunks'
    hard node constraints (None: none) and ``numa_scoring`` /
    ``device_scoring`` the scores (:func:`assign`'s).

    Returns ``(assignments [C, P], pod_zones [C, P], rounds [C],
    shortlist_fallbacks [C, 2])``, the fallback counts zeros with the
    shortlist off, ``pod_zones`` each pod's zone pick (-1 for none; all -1
    without NUMA). On CUDA tensors each chunk is one CUDA graph replay, as
    in :func:`solve_stream`; chunk c's pods read rows ``c * P + order`` of
    the stacked mask through the graph's device index, so the mask is
    never copied, and the zone table is one more static buffer of the
    graph, as are the device tables. ``zone_free_out``, an [N, Z, DN]
    float32 tensor, receives the zone table after the last chunk, and
    ``dev_out`` = (slot_free [N, G], rdma_free [N], fpga_free [N]) tensors
    (any may be None) the dev carry (the reference keeps both in the scan's
    carry)."""
    c, p = pods_stacked.requests.shape[:2]
    n = nodes.allocatable.shape[0]
    if node_mask is not None and tuple(node_mask.shape) != (c, p, n):
        raise ValueError(f"solve_stream_full: node_mask must be [C={c}, P={p}, N={n}] bool")
    kw = dict(max_rounds=max_rounds, round_quantum=round_quantum, topk=topk,
              nomination_jitter=nomination_jitter, approx_topk=approx_topk,
              shortlist_k=shortlist_k)
    if numa is not None:
        _scoring(numa_scoring)
        kw["numa_scoring"] = numa_scoring
    _device_scoring(device_scoring)
    kw["device_scoring"] = device_scoring
    _, (asg, _, rounds, fallbacks, zones), _, zone_free, dev_tables = _run_stream(
        pods_stacked, nodes, params, quotas, node_mask, numa, kw, cuda_graph, devices
    )
    if zone_free_out is not None:
        zone_free_out.copy_(zone_free)
    for out, table in zip(dev_out or (), dev_tables or ()):
        if out is not None:
            out.copy_(table)
    if fallbacks is None:
        fallbacks = torch.zeros((c, 2), dtype=torch.int32, device=asg.device)
    if zones is None:
        zones = torch.full_like(asg, -1)
    return asg, zones, rounds, fallbacks


def _copy_out(rounds, fallbacks, rounds_out, fallbacks_out) -> None:
    if rounds_out is not None:
        rounds_out.copy_(rounds)
    if fallbacks_out is not None:
        if fallbacks is None:
            fallbacks_out.zero_()
        else:
            fallbacks_out.copy_(fallbacks)


def _run_stream(pods_stacked, nodes, params, quotas, node_mask, numa, kw, cuda_graph,
                devices=None):
    """The batches of a stream on the tensors' device: one CUDA graph
    replay a batch on the card (:class:`_StreamGraph`), else eagerly.
    Returns fresh (tables, outputs, quota used table or None, zone table
    or None, device tables or None)."""
    dev = nodes.allocatable.device
    b, p = pods_stacked.requests.shape[:2]
    if dev.type == "cuda" and cuda_graph and kw.get("cost_transform") is None:
        return _StreamGraph.run(pods_stacked, nodes, params, quotas, node_mask, numa, kw,
                                devices)
    bufs = _StreamBuffers(nodes, quotas, numa, b, p, kw, devices)
    index = torch.zeros((1,), dtype=torch.int64, device=dev)  # each step advances it
    thresholds = _effective_thresholds(nodes, params)
    for _ in range(b):
        _stream_step(pods_stacked, nodes, params, quotas, node_mask, numa, thresholds, bufs,
                     index, kw, devices)
    return bufs.tables, bufs.outs, bufs.qused, bufs.zone_free, bufs.dev


class _StreamBuffers:
    """A stream's state: its node tables, with quotas its quota used table,
    with NUMA its zone table and with devices its dev carry (slot table,
    free RDMA and FPGA counts: zeros for a count the state does not track)
    — copies of the inputs', updated in place batch by batch — and its
    outputs: assignments [B, P], placed [B], rounds [B], with the shortlist
    on (``kw``, the solver's arguments) its fallback counts [B, 2] and with
    NUMA its zone picks [B, P] (each None without)."""

    def __init__(self, nodes: NodeState, quotas, numa, b: int, p: int, kw: dict,
                 devices=None):
        n = nodes.allocatable.shape[0]
        shortlist = _shortlist_on(kw["shortlist_k"], kw["topk"], n, kw.get("device_scoring"),
                                  kw.get("cost_transform"))
        dev = nodes.allocatable.device
        self.tables = [nodes.requested.clone(), nodes.estimated_used.clone(),
                       nodes.prod_used.clone()]
        self.qused = None if quotas is None else quotas.used.clone()
        self.zone_free = None if numa is None else numa.zone_free.clone()
        # made once a call, not in every batch
        self.zone_most = _zone_most(numa)
        self.dev = None
        if devices is not None:
            self.dev = tuple(t.clone() for t in _dev_carry0(devices, n))
        self.outs = (
            torch.empty((b, p), dtype=torch.int32, device=dev),
            torch.empty((b,), dtype=torch.int32, device=dev),
            torch.empty((b,), dtype=torch.int32, device=dev),
            torch.empty((b, 2), dtype=torch.int32, device=dev) if shortlist else None,
            None if numa is None else torch.empty((b, p), dtype=torch.int32, device=dev),
        )

    def reset(self, nodes: NodeState, quotas, numa, devices=None) -> None:
        """Back to the inputs' tables, in place."""
        for table, src in zip(self.tables, (nodes.requested, nodes.estimated_used,
                                            nodes.prod_used)):
            table.copy_(src)
        if self.qused is not None:
            self.qused.copy_(quotas.used)
        if self.zone_free is not None:
            self.zone_free.copy_(numa.zone_free)
        if self.dev is not None:
            n = nodes.allocatable.shape[0]
            for table, src in zip(self.dev, _dev_carry0(devices, n)):
                table.copy_(src)


def _dev_carry0(devices: DeviceState, n: int):
    """A stream's first dev carry (``solver.py:1789-1800``): the slot
    table and the free RDMA and FPGA counts, zeros for a count the state
    does not track."""
    zeros = torch.zeros((n,), dtype=torch.float32, device=devices.slot_free.device)
    return (devices.slot_free,
            zeros if devices.rdma_free is None else devices.rdma_free,
            zeros if devices.fpga_free is None else devices.fpga_free)


def _stream_step(pods_stacked, nodes, params, quotas, node_mask, numa, thresholds, bufs,
                 index, kw, devices=None) -> None:
    """Batch ``index`` ([1] int64 on the device) of a stream: its pods
    read from the stacked batch by the set-up, solved with the stream's
    tables (requested, estimated, prod; with quotas the used table; with
    NUMA the zone table) updated in place and its effective
    ``thresholds``, its assignment, placed count, rounds, fallback counts
    and zone picks written into row ``index`` of the outputs, and
    ``index`` advanced to the next batch (:func:`batch_outputs`). With
    devices the dev carry is updated in place too."""
    tables = bufs.tables
    cur = dataclasses.replace(
        nodes, requested=tables[0], estimated_used=tables[1], prod_used=tables[2]
    )
    kw = dict(kw)
    zones = _zones_of(numa, bufs.zone_free, kw.pop("numa_scoring", None), bufs.zone_most)
    devs = _devices_of(devices, bufs.dev, kw.get("device_scoring"))
    assignment, rounds_used, fallbacks, pod_zone, _ = _assign_(
        pods_stacked, cur, params, thresholds=thresholds,
        quota=None if quotas is None else (quotas.runtime, bufs.qused),
        node_mask=node_mask, index=index, zones=zones, devs=devs, **kw,
    )
    batch_outputs(bufs.outs, index, assignment, pod_zone, rounds_used, fallbacks)


class _StreamGraph:
    """One batch of a stream (:func:`solve_stream`, :func:`solve_stream_full`)
    captured as a CUDA graph.

    The graph reads and writes fixed addresses: the stacked pods (and the
    stacked node mask), static copies of the node tables and of the quota
    used table (updated in place by every replay), the effective
    thresholds (computed once a call, outside the graph), a device batch
    index that each replay advances, and static [B, P] / [B] / [B, 2]
    outputs. With the shortlist on, a batch's build, its words and counts
    are inside the graph; with quotas, the gate of its round 0; with NUMA,
    a static copy of the zone table (reset from the input's each call) and
    [B, P] zone picks.

    A graph is kept for the last input it ran, keyed by the shapes, the
    solver arguments and the input tensors' addresses: a replay reads the
    inputs' contents at run time, so a call with the same key reuses it
    and a call with another key captures anew. Node rows refreshed in
    place (:func:`scatter_rows`) keep their addresses: the next call
    replays the same graph and reads the new rows. The graph holds the input
    tensors themselves, so no other tensor can take their addresses while
    it is kept. The kernels are warmed up once a key, on a side stream,
    before the capture (library loads, ``cudaFuncSetAttribute``,
    ``chunk_of``). A graph that is replaced stays alive until an event
    recorded after its last replay has passed, so no host sync is needed
    to free it."""

    _last: "_StreamGraph | None" = None
    _retired: list = []

    def __init__(self, key, pods_stacked, nodes, params, quotas, node_mask, numa, kw,
                 devices=None):
        dev = nodes.allocatable.device
        b, p = pods_stacked.requests.shape[:2]
        self.key = key
        self.nodes = nodes
        self.quotas = quotas
        self.numa = numa
        self.devices = devices
        self.bufs = _StreamBuffers(nodes, quotas, numa, b, p, kw, devices)
        self.index = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.batches = b
        self.params = params
        self.thresholds = _effective_thresholds(nodes, params)

        def step():  # advances the index
            _stream_step(pods_stacked, nodes, params, quotas, node_mask, numa,
                         self.thresholds, self.bufs, self.index, kw, devices)

        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step()  # warm-up: every kernel and library is loaded and set
            self.graph = torch.cuda.CUDAGraph()
            before = kernels.captured.copy()
            self.graph.capture_begin()
            step()
            self.graph.capture_end()
            self.kernel_nodes = kernels.captured - before
        torch.cuda.current_stream(dev).wait_stream(side)
        self.done = torch.cuda.Event()

    def replay(self):
        """Every batch once, from the node (and quota) tables and the
        thresholds of the call's inputs, into the static tables and
        outputs."""
        self.bufs.reset(self.nodes, self.quotas, self.numa, self.devices)
        for thr, src in zip(self.thresholds, _effective_thresholds(self.nodes, self.params)):
            thr.copy_(src)
        self.index.zero_()
        kernels.replay(self.graph, "solve_stream", self.kernel_nodes, self.batches)
        self.done.record()

    @classmethod
    def run(cls, pods_stacked, nodes, params, quotas, node_mask, numa, kw, devices=None):
        tensors = [getattr(obj, f.name)
                   for obj in (pods_stacked, nodes, params, quotas, numa, devices)
                   if obj is not None
                   for f in dataclasses.fields(obj) if getattr(obj, f.name) is not None]
        if node_mask is not None:
            tensors.append(node_mask)
        key = (
            tuple(kw.items()), quotas is not None, node_mask is not None, numa is not None,
            devices is not None,
            tuple((t.data_ptr(), t.dtype, tuple(t.shape), t.stride()) for t in tensors),
        )
        last = cls._last
        if last is None or last.key != key:
            if last is not None:
                cls._retired.append(last)
            cls._retired = [g for g in cls._retired if not g.done.query()]
            last = cls._last = cls(key, pods_stacked, nodes, params, quotas, node_mask, numa,
                                   kw, devices)
        last.replay()
        bufs = last.bufs
        return ([t.clone() for t in bufs.tables],
                tuple(None if t is None else t.clone() for t in bufs.outs),
                None if bufs.qused is None else bufs.qused.clone(),
                None if bufs.zone_free is None else bufs.zone_free.clone(),
                None if bufs.dev is None else tuple(t.clone() for t in bufs.dev))


def enforce_gangs_plain(result: SolveResult, pods: PodBatch, slot_cap=None) -> SolveResult:
    """All-or-nothing gang rollback (Coscheduling Permit semantics,
    ``solver.py:1858-1987``), node tables, gang counts and quotas: gangs
    whose placed-member count is below ``minMember`` lose all their
    placements, their node charges and their quota charges
    (:func:`.quota.quota_refund_plain`; a [1, D] ``quota_used`` is the
    disabled sentinel and stays), unless the gang is NonStrict. Refunds
    use the unamplified ``pods.requests`` in original pod order, as the
    reference does; the sums are ordered
    (:func:`.commit.segment_sum_plain`). With a zone table whose DN matches
    ``pod_zone_charge``'s, the rolled-back pods that hold a zone give their
    charge back to it, ``node_zone_free + segment_sum(...)`` added row by
    row in pod order (:func:`.commit._scatter_add_`, the order XLA's CPU
    backend gives the reference, :1941-1960), and lose their
    ``pod_zone``. With a slot table (``node_dev_slots``), each node's
    rolled-back whole GPUs and shares, ``whole * 100 + share`` summed in pod
    order, are water-filled back onto it (:func:`.device.slot_refund`,
    the real slots a node's first ``slot_cap`` [N] / 100, :1913-1929), and
    their RDMA and FPGA added back to the free counts that are given
    (:1930-1940). The plain version of ``csrc/gangs.cu``; returns a new
    result."""
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
    quota_used = result.quota_used
    if quota_used is not None:
        quota_used = quota_ops.quota_refund_plain(
            rollback, pods.requests, pods.quota_chain, quota_used
        )
    zone_free = result.node_zone_free
    if _zone_refund_on(result):
        n_zones, dn = zone_free.shape[1:]
        zref = rollback & (result.pod_zone >= 0)
        onehot = (torch.arange(n_zones, device=zref.device)[None, :]
                  == torch.clamp(result.pod_zone, 0, n_zones - 1)[:, None]) & zref[:, None]
        delta_z = (onehot[:, :, None] * result.pod_zone_charge[:, None, :]).reshape(p, -1)
        flat = zone_free.reshape(n, -1).clone()
        commit_ops._scatter_add_((flat,), torch.where(zref, node_of, n - 1), (delta_z,))
        zone_free = flat.reshape(zone_free.shape)
    dev_tables = {}
    if result.node_dev_slots is not None:
        from .device import slot_refund

        seg = torch.where(rollback, node_of, n - 1)
        whole = pods.gpu_whole.to(torch.float32)
        refund = commit_ops.segment_sum_plain(
            torch.where(rollback, whole * 100.0 + pods.gpu_share, 0.0)[:, None], seg, n)[:, 0]
        exists = slot_exists_of(slot_cap, result.node_dev_slots.shape[1])
        dev_tables["node_dev_slots"] = slot_refund(result.node_dev_slots, refund, exists)
        for name, req in (("node_rdma_free", pods.rdma), ("node_fpga_free", pods.fpga)):
            free = getattr(result, name)
            if free is not None:
                dev_tables[name] = free + commit_ops.segment_sum_plain(
                    torch.where(rollback, req.to(torch.float32), 0.0)[:, None], seg, n)[:, 0]
    return dataclasses.replace(
        result,
        assignment=torch.where(keep, assignment, -1),
        node_requested=result.node_requested - delta[:, :d],
        node_estimated_used=result.node_estimated_used - delta[:, d : 2 * d],
        node_prod_used=result.node_prod_used - delta[:, 2 * d :],
        quota_used=quota_used,
        node_zone_free=zone_free,
        pod_zone=(
            None
            if result.pod_zone is None
            else torch.where(rollback, -1, result.pod_zone)
        ),
        **dev_tables,
    )


_GANG_FIELDS = (
    "assignment", "node_requested", "node_estimated_used", "node_prod_used",
    "pod_zone", "quota_used", "node_zone_free", "node_dev_slots", "node_rdma_free",
    "node_fpga_free",
)


def _zone_refund_on(result: SolveResult) -> bool:
    """Whether the rollback refunds zone charges: a zone table, the picks
    and charges of its DN (``solver.py:1941-1950``)."""
    zf, charge = result.node_zone_free, result.pod_zone_charge
    return (zf is not None and result.pod_zone is not None and charge is not None
            and charge.shape[1] == zf.shape[2])
_I32, _F32, _BOOL = torch.int32, torch.float32, torch.bool
#: dtypes of koord_enforce_gangs' tensors, in its argument order
_GANG_DTYPES = (_I32, _I32, _I32, _BOOL, _F32, _F32, _BOOL, _F32, _F32, _F32, _I32)


@functools.lru_cache(maxsize=64)
def _gangs_scratch_bytes(index: int, p: int, d: int, levels: int, dev: bool, dn: int) -> int:
    """Bytes of device memory the rollback of ``p`` pods of ``d`` dims
    needs on device ``index`` (a quota refund over ``levels`` levels, 0 for
    none; devices; zones of ``dn`` dims, 0 for none): 0 while it fits in
    shared memory."""
    lib = kernels.library("gangs")
    nbytes = ctypes.c_longlong(0)
    with torch.cuda.device(index):
        kernels.check(lib, lib.koord_gangs_scratch(p, d, int(levels > 0), levels, int(dev), dn,
                                                   ctypes.byref(nbytes)),
                      "enforce_gangs scratch")
    return nbytes.value


def _enforce_gangs_(result: SolveResult, pods: PodBatch, slot_cap=None) -> None:
    """Gang rollback in place on ``result``'s assignment, node tables,
    ``pod_zone``, ``quota_used``, ``node_zone_free`` and the device tables
    (``node_dev_slots``, ``node_rdma_free``, ``node_fpga_free``, with
    ``slot_cap`` [N] each node's real slots times 100,
    :attr:`BatchSetup.slot_cap`, :func:`.device.slot_cap_of`): one
    ``koord_enforce_gangs`` launch (``csrc/gangs.cu``) for CUDA tensors,
    :func:`enforce_gangs_plain` written into ``result``'s tensors for CPU
    tensors. The quota refund runs when ``quota_used`` has Q > 1 rows
    (counted also as ``quota_refund``), the zone refund when the result
    holds a zone table and charges of its DN (counted also as
    ``zone_refund``). A batch whose working set outgrows shared memory
    runs with it in a device buffer of the launch's own."""
    asg = result.assignment
    if asg.is_cpu:
        out = enforce_gangs_plain(result, pods, slot_cap)
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
    q_cap = levels = 0
    q_ptrs = [None, None]
    refund = result.quota_used is not None and result.quota_used.shape[0] > 1
    if refund:
        q_cap, levels = result.quota_used.shape[0], pods.quota_chain.shape[1]
        q_ptrs = kernels.checked_ptrs(
            "enforce_gangs", (asg, pods.quota_chain, result.quota_used),
            (_I32, _I32, _F32), (p, p * levels, q_cap * d),
        )[1:]
    z_args = [None, None, 0, 0]
    zones = _zone_refund_on(result)
    if zones:
        _, nz, dn = result.node_zone_free.shape
        z_args = kernels.checked_ptrs(
            "enforce_gangs", (asg, result.node_zone_free, result.pod_zone_charge),
            (_I32, _F32, _F32), (p, n * nz * dn, p * dn),
        )[1:] + [nz, dn]
    d_args = [None] * 8 + [0]
    slots = result.node_dev_slots
    if slots is not None:
        g = slots.shape[1]
        if not 1 <= g <= MAX_SLOTS:
            raise kernels.KernelArgumentError(f"enforce_gangs: G={g} must be in 1..{MAX_SLOTS}")
        d_args = kernels.checked_ptrs(
            "enforce_gangs",
            (asg, slots, slot_cap, result.node_rdma_free, result.node_fpga_free, pods.gpu_whole,
             pods.gpu_share, pods.rdma, pods.fpga),
            (_I32, _F32, _F32, _F32, _F32, _I32, _F32, _I32, _I32),
            (p, n * g, n, n, n, p, p, p, p),
        )[1:] + [g]
    lib = kernels.library("gangs")
    nbytes = _gangs_scratch_bytes(asg.get_device(), p, d, levels, slots is not None,
                                  z_args[3])
    # the launch's own working set, as the round tail's (ops/commit.py)
    buf = torch.empty(nbytes, dtype=torch.uint8, device=asg.device) if nbytes else None
    code = lib.koord_enforce_gangs(*ptrs, p, n, d, *q_ptrs, q_cap, levels, *z_args, *d_args,
                                   None if buf is None else buf.data_ptr(),
                                   kernels.stream_of(asg))
    kernels.check(lib, code, "enforce_gangs")
    kernels.count("enforce_gangs")
    if buf is not None:
        kernels.count("enforce_gangs_big")
    if refund:
        kernels.count("quota_refund")
    if zones:
        kernels.count("zone_refund")
    if slots is not None:
        kernels.count("device_refund")


def enforce_gangs(result: SolveResult, pods: PodBatch, slot_exists=None) -> SolveResult:
    """All-or-nothing gang rollback (``solver.py:1858-1987``) on the
    tensors' device, functional as the reference is: the result's
    assignment, node tables, ``pod_zone``, ``quota_used`` and device tables
    are cloned, then rolled back in place (:func:`_enforce_gangs_`;
    ``slot_exists`` [N, G] bool the slot table's real slots, a node's first
    ones, as :func:`.device.slot_exists_of` gives them)."""
    out = dataclasses.replace(result, **{
        name: getattr(result, name).clone()
        for name in _GANG_FIELDS
        if getattr(result, name) is not None
    })
    _enforce_gangs_(out, pods, slot_cap_of(slot_exists))
    return out


def assign_sequential_plain(
    pods: PodBatch,
    nodes: NodeState,
    params: SolverParams,
    quotas: "QuotaState | None" = None,
    shortlist_k: "int | None" = None,
) -> SolveResult:
    """Exact sequential-commit solver (``solver.py:1990-2241``) in plain
    PyTorch: the CPU path of :func:`assign_sequential` and its kernels'
    oracle. Every pod in priority order (stable) takes the best node at the
    tables as the pods before it left them: the quota gate along its chain,
    the fit with amplified CPU for cpuset-bound pods, the usage and prod
    thresholds, the floored LeastAllocated score, the first node winning
    ties; the commit charges the winner's row (CPU × ``max(cpu_amp, 1)``
    for cpuset-bound pods) and each distinct quota of the chain once.
    ``shortlist_k`` (on when 0 < K < N) prunes each step to the pod's K
    build-time candidates, with the same decisions
    (:mod:`.sequential`); ``shortlist_fallbacks`` counts the steps that
    ran the full axis. Then the gang rollback on the pods in their own
    order. ``rounds_used`` is P; the zone and device fields are the
    reference's zero placeholders."""
    return _assign_sequential(pods, nodes, params, quotas, shortlist_k, plain=True)


def assign_sequential(
    pods: PodBatch,
    nodes: NodeState,
    params: SolverParams,
    quotas: "QuotaState | None" = None,
    shortlist_k: "int | None" = None,
) -> SolveResult:
    """:func:`assign_sequential_plain` on the tensors' device. On the card:
    the priority sort, with the shortlist one launch of the build
    (:func:`.sequential.sequential_build`), one launch of the scan
    (``csrc/sequential.cu``: every step in one block), the scatter back to
    pod order and one launch of ``enforce_gangs`` (``csrc/gangs.cu``),
    with no host read between them. A build or launch fault raises
    :class:`..kernels.KernelError`. On CPU tensors it runs the plain
    version."""
    if pods.requests.is_cpu:
        return assign_sequential_plain(pods, nodes, params, quotas, shortlist_k)
    return _assign_sequential(pods, nodes, params, quotas, shortlist_k, plain=False)


def _assign_sequential(pods, nodes, params, quotas, shortlist_k, plain: bool) -> SolveResult:
    p, d = pods.requests.shape
    n = nodes.allocatable.shape[0]
    dev = nodes.allocatable.device
    if plain:
        build, scan = sequential_ops.sequential_build_plain, sequential_ops.sequential_scan_plain
    else:
        build, scan = sequential_ops.sequential_build, sequential_ops.sequential_scan
    order, spods, bind, thr, pthr = _round_setup(pods, nodes, params, quota=quotas is not None)
    requested, est_used, prod_used = (
        t.clone() for t in (nodes.requested, nodes.estimated_used, nodes.prod_used))
    node_args = (nodes.allocatable, requested, est_used, prod_used, nodes.metric_fresh,
                 nodes.schedulable, nodes.cpu_amp, thr, pthr, params.score_weights)
    plan = None
    if shortlist_k is not None and 0 < shortlist_k < n:
        # from the initial tables, before the scan writes them
        plan = build(spods.requests, spods.estimate, spods.is_prod, bind, *node_args,
                     shortlist_k)
    quota = None
    qused = QuotaState.disabled(d, device=dev).used
    if quotas is not None:
        qused = quotas.used.clone()
        quota = (spods.quota_chain, quotas.runtime, qused)
    assigned, fallbacks = scan(spods.requests, spods.estimate, spods.is_prod, spods.valid,
                               bind, *node_args, quota=quota, plan=plan)
    result = SolveResult(
        assignment=torch.empty_like(assigned).scatter_(0, order, assigned),
        node_requested=requested,
        node_estimated_used=est_used,
        node_prod_used=prod_used,
        quota_used=qused,
        rounds_used=torch.full((), p, dtype=torch.int32, device=dev),
        shortlist_fallbacks=fallbacks,
    )
    if plain:
        result = enforce_gangs_plain(result, pods)
    else:
        _enforce_gangs_(result, pods)
    return dataclasses.replace(
        result,
        node_dev_slots=torch.zeros((n, 1), dtype=torch.float32, device=dev),
        node_rdma_free=torch.zeros((n,), dtype=torch.float32, device=dev),
        node_fpga_free=torch.zeros((n,), dtype=torch.float32, device=dev),
        node_zone_free=torch.zeros((n, 1, 1), dtype=torch.float32, device=dev),
        pod_zone=torch.full((p,), -1, dtype=torch.int32, device=dev),
        pod_zone_charge=torch.zeros((p, 1), dtype=torch.float32, device=dev),
    )


def shortlist_plan(
    pods: PodBatch,
    nodes: NodeState,
    params: SolverParams,
    numa=None,
    devices=None,
    node_mask=None,
    shortlist_k: int = 64,
    nomination_jitter: float = 4.0,
    numa_scoring=None,
    device_scoring=None,
):
    """The shortlist build as its own entry (``solver.py:1547-1657``): the
    round-0 masked cost with every pod gate open and each pod's
    top-(K+1), ``node_mask`` [P, N] bool holding the pods' node
    constraints, ``numa`` (a :class:`.numa.NumaState`) the NUMA fit of its
    ``zone_free`` and, with ``numa_scoring``, the aligned score, ``devices``
    (a :class:`.device.DeviceState`) the device fit of its tables and, with
    ``device_scoring``, the device score clamped at <= 0 (:1606-1645).
    Returns ``(plan_cand [P, K] int32, candidates ascending
    by node id in the solver's priority-sorted pod order, plan_bound [P]
    float32, the (K+1)-th best build cost, +inf when the shortlist holds
    every feasible node)``. One launch of ``csrc/shortlist_build.cu`` on
    the card; :func:`assign` runs its own build inside the solve."""
    order, spods, bind, thr, pthr = _round_setup(pods, nodes, params, numa=numa is not None,
                                                 devices=devices is not None)
    terms = dterms = None
    if numa is not None:
        terms = ZoneTerms.batch_start(numa.zone_free, numa.zone_cap, numa.policy,
                                      spods.numa_required, _scoring(numa_scoring))
    scoring = _device_scoring(device_scoring)
    if devices is not None:
        dterms = DeviceTerms.batch_start(
            devices.slot_free, devices.rdma_free, devices.fpga_free, devices.cap_total, spods,
            scoring, units=device_consumption(spods.gpu_whole, spods.gpu_share)[1])
    return shortlist_ops.shortlist_build(
        spods.requests, spods.estimate, spods.is_prod, bind, nodes.allocatable,
        nodes.requested, nodes.estimated_used, nodes.prod_used, nodes.metric_fresh,
        nodes.schedulable, nodes.cpu_amp, thr, pthr, params.score_weights,
        shortlist_k, nomination_jitter, None if node_mask is None else (node_mask, order),
        zones=terms, devices=dterms,
    )


def scatter_rows(full, idx: torch.Tensor, rows):
    """Refresh rows of a resident node-axis dataclass in place
    (``solver.py:248-264``): every [N, ...] field of ``full`` (a
    :class:`NodeState`) takes ``rows``' matching [K, ...] field at the node
    rows ``idx`` [K]. ``idx`` may repeat a row as long as the repeats carry
    identical data. The reference donates ``full``; the port writes into
    its tensors with ``index_copy_``, so every ``data_ptr`` stays and a
    :class:`_StreamGraph` keyed by them replays with the new rows. Returns
    ``full``."""
    index = idx.long()
    for f in dataclasses.fields(full):
        table = getattr(full, f.name)
        if table is not None:
            table.index_copy_(0, index, getattr(rows, f.name))
    return full


def gather_rows(full, idx: torch.Tensor, valid: torch.Tensor):
    """Rows ``idx`` [B] of a resident node-axis dataclass, rows where
    ``valid`` [B] is False zeroed (``solver.py:267-283``): padding rows
    then read unschedulable and mask out. ``full`` is not written."""
    index = idx.long()

    def take(table):
        out = table.index_select(0, index)
        keep = valid.reshape((-1,) + (1,) * (out.dim() - 1))
        return torch.where(keep, out, torch.zeros_like(out))

    return tree_map(take, full)
