"""Round nomination: masked, jittered LoadAware cost and per-pod top-k.

Port of ``koordinator_tpu/ops/solver.py:_full_nominate`` (:1121-1156) with
``full_feas_cost`` (:864-947). :func:`nominate` launches the hand-written
kernel on CUDA tensors (``csrc/nominate.cu``, or ``csrc/nominate_terms.cu``
with NUMA zones or devices) and runs :func:`nominate_plain` on CPU
tensors; there is no fallback from one to the other. With the
candidate shortlist on it is the round's full-axis fallback, run only when
the shortlist round sets its trigger word (``trigger=``).

Pods arrive in priority-sorted order: the jitter hash is keyed on a pod's
sorted position, as the reference's ``add_jitter`` keys it on ``arange(P)``
over ``spods``. Costs are ranked by (value, node index), the order
``jax.lax.top_k`` and ``jnp.argmin`` give ties; ``torch.topk`` gives no such
promise, so neither path uses it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels
from .costs import load_aware_cost, numa_aligned_cost
from .masks import EPS, fit_mask, usage_ok
from .device import checked_devices
from .numa import checked_zones, numa_fit_mask


def _jitter_hash(pi: torch.Tensor, ni: torch.Tensor) -> torch.Tensor:
    """Knuth multiplicative nomination-jitter hash folded to 16 bits
    (``solver.py:587``). Computed in int64: the low 16 bits of the uint32
    product-sum do not depend on the wrap, and torch's uint32 support is
    partial."""
    return (pi.long() * 2654435761 + ni.long() * 40503) & 0xFFFF


def mask_rows(mask) -> "torch.Tensor | None":
    """The [P, N] bool node mask of the priority-sorted pods from ``mask``
    = (table [M, N] bool, rows [P] int64): pod j may use node n where
    ``table[rows[j], n]``. None for no mask."""
    if mask is None:
        return None
    table, rows = mask
    return table.reshape(-1, table.shape[-1])[rows]


def feasible_mask(
    req, est, is_prod, cpu_bind, gate,
    alloc, requested, est_used, prod_used, fresh, sched, cpu_amp, thr, pthr,
    mask=None,
):
    """[P, N] feasibility (``solver.py:_feasible``, :625-657): fit,
    amplified-CPU fit for cpu-bind pods, usage and prod thresholds (``thr``
    and ``pthr`` effective, [N, D]), schedulable, pod gate, and the pods'
    hard node constraints (:896-897; ``mask`` as :func:`mask_rows` takes
    it)."""
    free = alloc - requested
    feas = fit_mask(req, free)
    amp = torch.clamp(cpu_amp, min=1.0)
    eff_cpu = req[:, 0][:, None] * amp[None, :]
    feas &= ~cpu_bind[:, None] | (eff_cpu <= free[:, 0][None, :] + EPS)
    feas &= usage_ok(est, est_used, alloc, thr, fresh)
    feas &= usage_ok(est, prod_used, alloc, pthr, fresh) | ~is_prod[:, None]
    feas &= sched[None, :]
    feas &= gate[:, None]
    if mask is not None:
        feas &= mask_rows(mask)
    return feas


def nomination_vector(top_cost, top_idx, approx_topk: bool):
    """The round's nomination vector from the exact (value, index)-ordered
    top-k. With ``approx_topk`` the reference pins slot 0 to the exact
    argmin and fills the rest from ``approx_max_k``, which is exact on the
    CPU: ``[best, best, 2nd, ...]`` (``solver.py:1147-1153``)."""
    if not approx_topk:
        return top_cost, top_idx
    k = top_cost.shape[1]
    return (
        torch.cat([top_cost[:, :1], top_cost[:, : k - 1]], dim=1),
        torch.cat([top_idx[:, :1], top_idx[:, : k - 1]], dim=1),
    )


def add_jitter(cost, node_ids, nomination_jitter: float):
    """``cost`` [P, M] plus the 16-bit jitter of each (sorted pod position,
    original node id) pair, ``node_ids`` [P, M] or [1, M]
    (``solver.py:add_jitter`` :732-742 and ``add_jitter_cols`` :744-753):
    a pair gets the same jitter on the full axis and in the shortlist."""
    if nomination_jitter <= 0.0:
        return cost
    pi = torch.arange(cost.shape[0], device=cost.device)[:, None]
    h = _jitter_hash(pi, node_ids)
    return cost + h.to(torch.float32) * (nomination_jitter / 65536.0)


def zone_terms(req, cpu_bind, cpu_amp, weights, zones):
    """The NUMA terms of every (pod, node) pair from ``zones`` (a
    :class:`.numa.ZoneTerms`: the batch-start table): the [P, N] fit
    (``solver.py:793-801``) and, with ``zones.scoring``, the [P, N] aligned
    score term (``:802-815``), else None."""
    wants = cpu_bind | zones.required
    fit = numa_fit_mask(req, wants, zones.state(), cpu_amp=cpu_amp,
                        pod_required=zones.required)
    score = None
    if zones.scoring:
        score = numa_aligned_cost(req, wants, zones.free, zones.cap, weights,
                                  most_allocated=zones.scoring == 2)
    return fit, score


def masked_cost(
    req, est, is_prod, cpu_bind, gate,
    alloc, requested, est_used, prod_used, fresh, sched, cpu_amp, thr, pthr,
    weights, nomination_jitter: float, mask=None, zones=None, devices=None,
    clamp_device: bool = False,
):
    """[P, N] masked, jittered LoadAware cost (``full_feas_cost``
    :864-947), +inf where a pair is infeasible; with ``zones`` (a
    :class:`.numa.ZoneTerms`) the NUMA fit is one more feasibility term and
    the aligned score is added before the jitter; with ``devices`` (a
    :class:`.device.DeviceTerms`) the device fit another, and its score
    term is added after the NUMA one (``clamp_device``: the build's
    min(term, 0), :939-940)."""
    feas = feasible_mask(
        req, est, is_prod, cpu_bind, gate,
        alloc, requested, est_used, prod_used, fresh, sched, cpu_amp, thr, pthr, mask,
    )
    cost = load_aware_cost(est, est_used, alloc, weights, metric_fresh=fresh)
    if zones is not None:
        fit, score = zone_terms(req, cpu_bind, cpu_amp, weights, zones)
        feas &= fit
        if score is not None:
            cost = cost + score
    if devices is not None:
        fit, term = devices.fit_and_cost(clamp_device)
        feas &= fit
        if term is not None:
            cost = cost + term
    nodes = torch.arange(alloc.shape[0], device=req.device)[None, :]
    cost = add_jitter(cost, nodes, nomination_jitter)
    return torch.where(feas, cost, torch.inf)


def nominate_plain(
    req, est, is_prod, cpu_bind, gate,
    alloc, requested, est_used, prod_used, fresh, sched, cpu_amp, thr, pthr,
    weights, k: int, nomination_jitter: float, approx_topk: bool,
    trigger=None, out=None, mask=None, zones=None, devices=None,
):
    """Plain PyTorch nomination: the reference's formulas on [P, N]
    tensors. Pod tensors ([P, D] / [P]) are priority-sorted; node tables
    are [N, D] / [N]; ``thr``/``pthr`` are the effective [N, D] usage and
    prod thresholds. Returns (cost [P, k] float32, node [P, k] int32).
    ``trigger``, ``out``, ``mask``, ``zones`` and ``devices`` are
    :func:`nominate`'s: with
    ``trigger[0]`` clear nothing is computed and ``out`` is returned as it
    is; otherwise the result is written into ``out``."""
    if trigger is not None and not bool(trigger[0]):
        return out
    cost = masked_cost(
        req, est, is_prod, cpu_bind, gate, alloc, requested, est_used,
        prod_used, fresh, sched, cpu_amp, thr, pthr, weights, nomination_jitter, mask, zones,
        devices,
    )
    vals, idx = torch.sort(cost, dim=1, stable=True)
    top = nomination_vector(
        vals[:, :k].contiguous(), idx[:, :k].to(torch.int32), approx_topk
    )
    if out is None:
        return top
    for buf, val in zip(out, top):
        buf.copy_(val)
    return out


#: the largest k the kernel takes (``kMaxK`` in ``csrc/nominate.cu``)
MAX_K = 8
_F32, _BOOL = torch.float32, torch.bool
#: dtypes of koord_nominate's tensors, in its argument order
_DTYPES = (_F32, _F32, _BOOL, _BOOL, _BOOL, _F32, _F32, _F32, _F32, _BOOL, _BOOL,
           _F32, _F32, _F32, _F32)


def launch(lib, ptrs, p: int, n: int, d: int, k: int, nomination_jitter: float,
           approx_topk: bool, chunk: int, device, state_ptr=None, trigger_ptr=None,
           out=None, mask_ptrs=(None, None), zone_args=(None,) * 4 + (0, 0, 0),
           dev_args=(None,) * 9 + (0,), order_ptr=None):
    """One ``koord_nominate`` call of ``lib`` on checked pointers, each
    block walking ``chunk`` nodes; with ``state_ptr`` (a round loop's state
    word) the kernels return at once once its ``done`` is set, with
    ``trigger_ptr`` (a shortlist round's word) while its trigger is clear;
    ``mask_ptrs`` are the node mask's table and rows (:func:`checked_mask`),
    ``zone_args`` the NUMA terms' (:func:`.numa.checked_zones`), ``dev_args``
    the device terms' (:func:`.device.checked_devices`), ``order_ptr`` the
    term kernels' pod order (:func:`pod_order`; null: in place).
    Writes into ``out`` (cost, node) when given, checked buffers of
    [P, k]. Returns (cost [P, k], node [P, k], the C entry's error code)."""
    chunks = -(-n // chunk)
    # [P, chunks, C] partial lists, C <= MAX_K list slots
    parts = p * chunks * MAX_K if chunks > 1 else 1
    part_cost = torch.empty(parts, dtype=torch.float32, device=device)
    part_idx = torch.empty(parts, dtype=torch.int32, device=device)
    if out is None:
        out = (torch.empty((p, k), dtype=torch.float32, device=device),
               torch.empty((p, k), dtype=torch.int32, device=device))
    out_cost, out_idx = out
    code = lib.koord_nominate(
        *ptrs, p, n, d, k, chunk,
        ctypes.c_float(nomination_jitter / 65536.0),
        int(nomination_jitter > 0.0), int(approx_topk),
        part_cost.data_ptr(), part_idx.data_ptr(),
        out_cost.data_ptr(), out_idx.data_ptr(), state_ptr, trigger_ptr, *mask_ptrs,
        *zone_args, *dev_args, 0, order_ptr, kernels.stream_of(out_cost),
    )
    return out_cost, out_idx, code


def checked_mask(what: str, mask, p: int, n: int) -> tuple:
    """The pointers of a node mask (table [M, N] bool, rows [P] int64) for
    a kernel launch, after the checks; (None, None) without a mask. The
    kernels read row ``rows[j]`` of the table for sorted pod j, so a
    stream's stacked [C, P, N] mask is read in place, never copied."""
    if mask is None:
        return (None, None)
    table, rows = mask
    if table.dim() < 2 or table.shape[-1] != n or rows.shape != (p,):
        raise kernels.KernelArgumentError(
            f"{what}: the node mask must be [..., N={n}] with [P={p}] rows"
        )
    return tuple(kernels.checked_ptrs(
        what, (table, rows), (torch.bool, torch.int64), (table.numel(), p)
    ))


def checked(args, k: int) -> list:
    """The pointers of ``nominate``'s tensors after the launch checks."""
    req, alloc = args[0], args[5]
    p, d = req.shape
    n = alloc.shape[0]
    if not 1 <= k <= min(MAX_K, n):
        raise kernels.KernelArgumentError(f"nominate: k={k} must be in 1..min({MAX_K}, N={n})")
    if not 1 <= d <= 16:
        raise kernels.KernelArgumentError(f"nominate: D={d} must be in 1..16")
    pd, nd = p * d, n * d
    return kernels.checked_ptrs(
        "nominate", args, _DTYPES, (pd, pd, p, p, p, nd, nd, nd, nd, n, n, n, nd, nd, d)
    )


def pod_order_plain(cpu_bind, zones=None, devices=None) -> torch.Tensor:
    """The order in which ``csrc/nominate_terms.cu`` takes a batch's
    priority-sorted pods, [P] int32: a stable sort of a small key — with
    ``zones`` 3 times 0 for a pod that wants no alignment, 1 for a
    cpuset-bound one, 2 for a required one, and with ``devices`` plus 0
    for a pod that asks for no device, 1 for RDMA or FPGA alone, 2 for
    GPUs — so that whole blocks of 64 pods that need no term skip it.
    Each pod keeps its own row of the nomination, so the order changes no
    bit. The plain version of ``pod_order_kernel``."""
    key = torch.zeros(cpu_bind.shape, dtype=torch.int32, device=cpu_bind.device)
    if zones is not None:
        key = torch.where(zones.required, 2, torch.where(cpu_bind, 1, 0)).to(torch.int32) * 3
    if devices is not None:
        gpu = (devices.whole != 0) | (devices.share > EPS)
        other = (devices.rdma_req != 0) | (devices.fpga_req != 0)
        key = key + torch.where(gpu, 2, torch.where(other, 1, 0)).to(torch.int32)
    return torch.sort(key, stable=True).indices.to(torch.int32)


def pod_order(cpu_bind, zones=None, devices=None) -> torch.Tensor:
    """:func:`pod_order_plain` on the tensors' device: one launch of
    ``csrc/nominate_terms.cu``'s ``pod_order_kernel`` for CUDA tensors, the
    plain version for CPU tensors. The solver's full-axis route works it
    out once a batch and keeps it as the terms' ``order`` (the devices',
    else the zones'), which :func:`nominate` passes on."""
    if cpu_bind.is_cpu:
        order = pod_order_plain(cpu_bind, zones, devices)
    else:
        p = cpu_bind.shape[0]
        order = torch.empty(p, dtype=torch.int32, device=cpu_bind.device)
        i32 = torch.int32
        tensors = (order, cpu_bind, None if zones is None else zones.required)
        dtypes = (i32, torch.bool, torch.bool)
        if devices is not None:
            tensors += (devices.whole, devices.share, devices.rdma_req, devices.fpga_req)
            dtypes += (i32, torch.float32, i32, i32)
        ptrs = kernels.checked_ptrs("pod_order", tensors, dtypes, (p,) * len(tensors))
        dev = ptrs[3:] if devices is not None else [None] * 4
        lib = kernels.library("nominate_terms")
        kernels.check(lib, lib.koord_pod_order(ptrs[1], ptrs[2], *dev, p, ptrs[0],
                                               kernels.stream_of(order)), "pod_order")
        kernels.count("pod_order")
    return order


def library_of(mode: int):
    """The library of an instantiation ``mode`` (0 LoadAware only, 1 with a
    node mask: ``csrc/nominate.cu``; 2 with NUMA zones, 3 with devices, 4
    with both: ``csrc/nominate_terms.cu``)."""
    return kernels.library("nominate_terms" if mode >= 2 else "nominate")


@functools.lru_cache(maxsize=256)
def chunk_of(lib, p: int, n: int, d: int, k: int, index: int, mode: int = 0, z: int = 0,
             dn: int = 0) -> int:
    """Nodes each block of ``lib``'s kernel walks at this shape on device
    ``index`` (``koord_nominate_chunk``: one wave of resident blocks), for
    its instantiation ``mode`` (:func:`library_of`) and, with zones, the
    zone table's [Z, DN]."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    chunk = ctypes.c_int(0)
    kernels.check(lib, lib.koord_nominate_chunk(p, n, d, k, sms, int(mode), z, dn,
                                                ctypes.byref(chunk)),
                  "nominate chunk")
    return chunk.value


def nominate(
    req, est, is_prod, cpu_bind, gate,
    alloc, requested, est_used, prod_used, fresh, sched, cpu_amp, thr, pthr,
    weights, k: int, nomination_jitter: float, approx_topk: bool, state=None,
    trigger=None, out=None, mask=None, zones=None, devices=None,
):
    """Round nomination on the tensors' device: the CUDA kernel for CUDA
    tensors, :func:`nominate_plain` for CPU tensors. Same arguments and
    result as :func:`nominate_plain`; on the card the kernel writes the
    nomination vector itself. ``state`` is the round loop's int32 state
    word (:func:`.commit.round_tail`): while its ``done`` is set the kernel
    returns at once and the result is left unwritten, which the round tail
    then does not read. The plain version needs no such word: a round tail
    after the fixed point ignores its nomination.

    The shortlist's fallback: ``trigger`` is the round's int32 word of
    :func:`.shortlist.shortlist_round`, ``out`` the (cost, node) buffers it
    wrote. While ``trigger[0]`` is clear nothing runs and ``out`` keeps the
    shortlist's nomination; when it is set the full-axis nomination is
    written into ``out``. Returns ``out`` (a new pair without it).

    ``mask`` holds the pods' hard node constraints (nodeSelector, required
    nodeAffinity, ``spec.nodeName``): (table [M, N] bool, rows [P] int64),
    sorted pod j may use node n only where ``table[rows[j], n]``. ``zones``
    (a :class:`.numa.ZoneTerms`) adds the NUMA fit and, with its scoring,
    the aligned score (the kernel's NUMA instantiation, D <= 8); ``devices``
    (a :class:`.device.DeviceTerms`) the device fit and score (its device
    instantiations, D <= 8). The term instantiations take the pods in the
    terms' ``order`` (the devices', else the zones'; :func:`pod_order`)
    where it is set, else in place: the same result either way."""
    args = (req, est, is_prod, cpu_bind, gate, alloc, requested, est_used,
            prod_used, fresh, sched, cpu_amp, thr, pthr, weights)
    if req.is_cpu:
        return nominate_plain(*args, k, nomination_jitter, approx_topk,
                              trigger=trigger, out=out, mask=mask, zones=zones,
                              devices=devices)
    ptrs = checked(args, k)
    p, d = req.shape
    n = alloc.shape[0]
    extra = kernels.checked_ptrs(
        "nominate", (req, state, trigger) + (out or (None, None)),
        (_F32, torch.int32, torch.int32, _F32, torch.int32), (p * d, 2, 4, p * k, p * k),
    )
    if devices is not None:
        mode = 4 if zones is not None else 3
    else:
        mode = 2 if zones is not None else int(mask is not None)
    if mode >= 2 and d > 8:
        raise kernels.KernelArgumentError(
            f"nominate: D={d} with NUMA zones or devices must be in 1..8"
        )
    lib = library_of(mode)
    z, dn = zones.cap.shape[1:] if zones is not None else (0, 0)
    chunk = chunk_of(lib, p, n, d, k, req.get_device(), mode, z, dn)
    order = None
    held = (devices if devices is not None else zones) if mode >= 2 else None
    if held is not None and held.order is not None:
        order = kernels.checked_ptrs("nominate", (req, held.order), (_F32, torch.int32),
                                     (p * d, p))[1]
    out_cost, out_idx, code = launch(
        lib, ptrs, p, n, d, k, nomination_jitter, approx_topk, chunk, req.device,
        extra[1], extra[2], out, checked_mask("nominate", mask, p, n),
        checked_zones("nominate", zones, p, n, d), checked_devices("nominate", devices, p, n),
        order,
    )
    kernels.check(lib, code, "nominate")
    kernels.count("nominate")
    return out_cost, out_idx
