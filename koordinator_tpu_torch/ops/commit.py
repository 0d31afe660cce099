"""The tail of one solver round — choice, node sort, segmented commit and
the loop state — and ordered segment sums.

Port of what a round of ``koordinator_tpu/ops/solver.py:assign`` does
after nomination, LoadAware branch (:1204-1452) with the quota commit and
the NUMA zone selection (:1275-1332, :1417-1432). :func:`round_tail`
launches the hand-written kernel of ``csrc/round.cuh`` (entries
``round.cu``, ``round_zone.cu``, with devices ``round_dev.cu``,
``round_zone_dev.cu``, and ``round_big.cu``, ``round_huge.cu``) on CUDA tensors and
runs :func:`round_tail_plain` (:func:`_choose`, :func:`_commit_inputs`,
:func:`commit_plain`, :func:`zone_phase_plain`, :func:`zone_charge_plain`
and the carry update) on CPU tensors.
:func:`segment_sum_plain` is the ``jax.ops.segment_sum`` of the plain
``enforce_gangs`` (``ops/solver.py:enforce_gangs_plain``); its kernel
counterpart is part of ``csrc/gangs.cu``.

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
import functools

import torch

from .. import kernels
from . import quota as quota_ops
from .masks import EPS, usage_percent
from .numa import POLICY_SINGLE_NUMA_NODE, zone_pick

#: zone-needing winners resolved a node a round (``solver.py:603-609``)
ZONE_WINNERS_PER_ROUND = 4


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


def _commit_inputs(node_key, req, est, is_prod, cpu_bind, cpu_amp, n: int):
    """The commit's sorted inputs (``solver.py:1215-1229``): pods stably
    sorted by nominated node, CPU charged ×amp for cpu-bind pods. Returns
    (sortidx, snode, sreq, sest, sprod)."""
    snode, sortidx = torch.sort(node_key, stable=True)
    gnode = torch.clamp(snode, max=n - 1).long()
    sreq = req[sortidx]
    samp = torch.where(cpu_bind[sortidx], torch.clamp(cpu_amp, min=1.0)[gnode], 1.0)
    sreq[:, 0] = sreq[:, 0] * samp
    return (
        sortidx,
        snode.contiguous(),
        sreq.contiguous(),
        est[sortidx].contiguous(),
        is_prod[sortidx].contiguous(),
    )


def zone_phase_plain(snode, is_start, sreq, accept, zone):
    """The round's zone selection (``solver.py:1275-1332``) on the sorted
    rows: a row is a zone candidate on a node with zones when its node is
    SINGLE_NUMA_NODE, its pod cpuset-bound or required to align; the
    candidates of a node past the first ``ZONE_WINNERS_PER_ROUND`` are
    refused this round. Rank j = 0..3 then picks, one rank after another
    (rank j sees the charges of the ranks before it, on a copy of the
    table), the strategy-ordered zone of each rank-j candidate still
    accepted; a candidate that must align and finds no zone is refused.
    ``zone`` = (zone_free [N, Z, DN], zone_cap, policy [N] int8, zone_most
    [N] bool, sorted cpu-bind flags, sorted required flags); ``sreq`` holds
    the requests with CPU amplified for cpuset-bound pods, whose first DN
    dims are the zone charge. Returns (accept, zone pick [P] int32, -1 for
    none)."""
    zone_free, zone_cap, policy, zone_most, s_bind, s_required = zone[:6]
    n, _, dn = zone_cap.shape
    gnode = torch.clamp(snode, max=n - 1).long()
    node_single = policy == POLICY_SINGLE_NUMA_NODE
    node_has_zones = torch.any(zone_cap.sum(dim=-1) > 0, dim=-1)
    cand = (node_single[gnode] | s_bind | s_required) & node_has_zones[gnode]
    cand_f = cand.to(torch.float32)
    zrank = _segment_prefix_sums(cand_f[:, None], is_start)[:, 0] - cand_f
    accept = accept & (~cand | (zrank < ZONE_WINNERS_PER_ROUND - 0.5))
    req_eff = sreq[:, :dn]
    strict = node_single[gnode] | s_required
    zcap_g = zone_cap[gnode]
    zmost_g = zone_most[gnode]
    zf_t = zone_free.clone()
    zsel = torch.full_like(snode, -1)
    zone_ids = torch.arange(zone_cap.shape[1], device=snode.device)
    for j in range(ZONE_WINNERS_PER_ROUND):
        pick, fit = zone_pick(zf_t[gnode], zcap_g, req_eff, zmost_g)
        sel = cand & (torch.abs(zrank - j) < 0.5) & accept
        accept = accept & ~(sel & strict & ~fit)
        win = sel & fit
        zsel = torch.where(win, pick, zsel)
        onehot = (zone_ids[None, :] == pick[:, None]) & win[:, None]
        delta = onehot[:, :, None] * req_eff[:, None, :]
        # one winner a node a rank: each node's sum is its one charge
        zf_t = zf_t - segment_sum_plain(
            delta, torch.where(win, gnode, n - 1), n)
    return accept, zsel


def zone_charge_plain(zone_free, snode, accept, zsel, sreq) -> None:
    """The round's zone charges (``solver.py:1417-1432``): each final
    winner's zone request (``sreq``'s first DN dims) off its picked zone,
    ``zone_free - segment_sum(...)`` with each node's charges summed first
    in sorted row order, then subtracted — the order XLA's CPU backend
    gives the reference (``tests/test_torch_numa_solver.py``). In place on
    ``zone_free`` [N, Z, DN]."""
    n, nz, dn = zone_free.shape
    zwin = torch.where(accept, zsel, -1)
    onehot = (torch.arange(nz, device=zsel.device)[None, :]
              == torch.clamp(zwin, 0, nz - 1)[:, None]) & (zwin >= 0)[:, None]
    delta = onehot[:, :, None] * sreq[:, None, :dn]
    seg_ids = torch.where(accept, snode, n - 1)
    zone_free.copy_(zone_free - segment_sum_plain(delta, seg_ids, n))


def device_accept_plain(snode, is_start, accept, dev, n: int):
    """The round's device acceptance (``solver.py:1246-1274``) on the
    sorted rows: within each node's segment, the whole GPUs asked for so
    far plus one for each share pod that opens a full slot (its share above
    the node's best partial slot) must stay within the node's full slots,
    only the segment's first share pod may commit, and the RDMA and FPGA
    asked for so far within the free counts where tracked. ``dev`` =
    (stats [N, 4], rdma [N] or None, fpga [N] or None, and the sorted rows'
    whole [P] float32, share, RDMA and FPGA [P] float32). Returns (accept,
    opens_full [P] bool)."""
    stats, rdma, fpga, swhole, sshare, srdma, sfpga = dev
    gnode = torch.clamp(snode, max=n - 1).long()
    full, partial = stats[:, 0], stats[:, 1]
    is_frac = sshare > EPS
    opens = is_frac & (sshare > partial[gnode] + EPS)
    seg_full = _segment_prefix_sums((swhole + opens.to(torch.float32))[:, None], is_start)[:, 0]
    frac_f = is_frac.to(torch.float32)
    seg_frac = _segment_prefix_sums(frac_f[:, None], is_start)[:, 0]
    accept = accept & (seg_full <= full[gnode] + EPS)
    accept = accept & (~is_frac | (seg_frac - frac_f < 0.5))
    for free, sreq in ((rdma, srdma), (fpga, sfpga)):
        if free is not None:
            seg = _segment_prefix_sums(sreq[:, None], is_start)[:, 0]
            accept = accept & (seg <= free[gnode] + EPS)
    return accept, opens


def device_charge_plain(snode, accept, opens, dev, slots, n: int) -> None:
    """The round's device charges (``solver.py:1386-1416``): each node's
    final winners' whole GPUs and its one share winner onto its slot row
    (:func:`.device.slot_commit`), their RDMA and FPGA off the free counts
    (``free - segment_sum``), then the charged nodes' stats refreshed
    (every row recomputed: an untouched row's stats do not change). In
    place on ``slots`` [N, G] and ``dev``'s stats and counts."""
    from .device import device_prep_plain, slot_commit

    stats, rdma, fpga, swhole, sshare, srdma, sfpga = dev
    seg_ids = torch.where(accept, snode, n - 1)
    is_frac = sshare > EPS
    whole_taken = segment_sum_plain(torch.where(accept, swhole, 0.0)[:, None], seg_ids, n)[:, 0]
    frac_share = segment_sum_plain(
        torch.where(accept & is_frac, sshare, 0.0)[:, None], seg_ids, n)[:, 0]
    frac_opens = segment_sum_plain(
        torch.where(accept & opens, 1.0, 0.0)[:, None], seg_ids, n)[:, 0] > 0.5
    slots.copy_(slot_commit(slots, whole_taken, frac_share, frac_opens))
    for free, sreq in ((rdma, srdma), (fpga, sfpga)):
        if free is not None:
            free.copy_(free - segment_sum_plain(
                torch.where(accept, sreq, 0.0)[:, None], seg_ids, n)[:, 0])
    stats.copy_(device_prep_plain(slots))


def commit_plain(
    snode, sreq, sest, sprod, alloc, fresh, thr, pthr,
    requested, est_used, prod_used, round_quantum: float, admit=None, zone=None,
    dev=None, slots=None,
):
    """Plain PyTorch commit of one round. ``snode`` [P] int32 holds the
    nominated nodes stably sorted (N = none); ``sreq`` [P, D] the sorted
    requests with CPU already multiplied by the node's amplification for
    cpu-bind pods; ``sest`` [P, D] and ``sprod`` [P] the sorted estimates
    and prod flags; ``thr``/``pthr`` the effective [N, D] thresholds.
    ``admit``, when given, maps the node acceptance (sorted order) to the
    pods that also clear their quotas (``solver.py:1362-1370``). ``zone``,
    when given, is :func:`zone_phase_plain`'s plus an [P] int32 buffer:
    the zone selection runs on the fit acceptance, the winners' zone
    charges land on its table and each sorted row's final zone (-1 for
    none) is written into the buffer. ``dev``, when given, is
    :func:`device_accept_plain`'s, with ``slots`` [N, G] the carried slot
    table: the device acceptance runs after the fit, before the zone
    selection, and the winners' device charges land after the node
    charges (:func:`device_charge_plain`). Returns the final ``accept`` [P]
    bool in sorted order and adds the winners' charges to ``requested``,
    ``est_used`` and ``prod_used`` in place."""
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
    opens = None
    if dev is not None:
        accept, opens = device_accept_plain(snode, is_start, accept, dev, n)
    zsel = None
    if zone is not None:
        accept, zsel = zone_phase_plain(snode, is_start, sreq, accept, zone)
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
    if admit is not None:
        accept = admit(accept)

    # winners' charges land on the tables one row at a time, in sorted
    # order: XLA folds the reference's ``table + segment_sum(...)`` into a
    # scatter-add onto the table itself
    seg_ids = torch.where(accept, snode, n)
    _scatter_add_(
        (requested, est_used, prod_used), seg_ids, (sreq, sest, sprod_est)
    )
    if dev is not None:
        device_charge_plain(snode, accept, opens, dev, slots, n)
    if zone is not None:
        zone_charge_plain(zone[0], snode, accept, zsel, sreq)
        zone[6].copy_(torch.where(accept, zsel, -1))
    return accept


def round_tail_plain(
    top_cost, top_idx, req, est, is_prod, cpu_bind, cpu_amp,
    alloc, fresh, thr, pthr, requested, est_used, prod_used,
    assigned, active, state, round_quantum: float, quota=None, zone=None, dev=None,
) -> None:
    """Plain PyTorch round tail: everything a round of ``assign`` does
    after nomination (``solver.py:1204-1229``, the LoadAware commit
    :1230-1380, the carry update :1433-1447 and ``round_cond`` :1450-1452).

    ``top_cost``/``top_idx`` [P, K] are the round's nomination; the pod
    tensors ([P, D] / [P]) are priority-sorted; ``thr``/``pthr`` are the
    effective [N, D] thresholds. Updates in place the node tables
    ``requested``, ``est_used`` and ``prod_used``, and the loop state:
    ``assigned`` [P] int32 (-1 = none), ``active`` [P] bool and ``state``
    [2] int32 = (done, rounds). Changes nothing while ``done`` is set.

    ``quota`` = (chain [P, L] int32, runtime [Q, D], used [Q, D], gate
    [P] bool) turns on ElasticQuota admission: node-accepted pods must also
    clear their chains (:func:`.quota.quota_commit_plain`, ``used`` updated
    in place), only those are charged and assigned, the loop ends on a
    round that assigns nothing (``progress = any(final)``, :1446), and
    ``gate`` becomes the next round's: active pods with quota headroom.

    ``zone`` = (zone_free [N, Z, DN], zone_cap [N, Z, DN], policy [N]
    int8, zone_most [N] bool, required [P] bool, pod_zone [P] int32[,
    side]) turns on the zone selection (:func:`zone_phase_plain`): the
    winners' zone charges come off ``zone_free`` in place and each
    winner's pick is written into ``pod_zone`` (priority-sorted, -1 =
    none, :1432). ``side``, the nodes' side table of
    :func:`.numa.zone_prep`, is what the kernel reads of the capacities
    and policies; this version works them out from those.

    ``dev`` (a :class:`.device.DeviceTerms` of the batch) turns on the
    device acceptance and charges (:func:`device_accept_plain`,
    :func:`device_charge_plain`): its slot table, stats and RDMA / FPGA
    counts are updated in place."""
    if bool(state[0]):
        return
    n = alloc.shape[0]
    choice, node_key = _choose(top_cost, top_idx, active, n)
    sortidx, snode, sreq, sest, sprod = _commit_inputs(
        node_key, req, est, is_prod, cpu_bind, cpu_amp, n
    )
    admit = None
    zone_s = None
    if zone is not None:
        zwin = torch.empty_like(assigned)
        zone_s = zone[:4] + (cpu_bind[sortidx], zone[4][sortidx], zwin)
    if quota is not None:
        chain, runtime, used, gate = quota

        def admit(accept):
            accepted = torch.zeros_like(accept)
            accepted[sortidx] = accept
            final, new_used = quota_ops.quota_commit_plain(accepted, req, chain, runtime, used)
            used.copy_(new_used)
            return final[sortidx]

    dev_s = None
    if dev is not None:
        dev_s = (dev.stats, dev.rdma, dev.fpga, dev.whole[sortidx].to(torch.float32),
                 dev.share[sortidx], dev.rdma_req[sortidx].to(torch.float32),
                 dev.fpga_req[sortidx].to(torch.float32))
    accept = commit_plain(
        snode, sreq, sest, sprod, alloc, fresh, thr, pthr,
        requested, est_used, prod_used, round_quantum, admit, zone_s, dev_s,
        None if dev is None else dev.slots,
    )
    accepted = torch.zeros_like(accept)
    accepted[sortidx] = accept
    if zone is not None:
        upd = torch.empty_like(zwin)
        upd[sortidx] = zwin
        zone[5].copy_(torch.where(upd >= 0, upd, zone[5]))
    assigned.copy_(torch.where(accepted, choice, assigned))
    active &= assigned < 0
    state[1] += 1
    state[0] = ~accepted.any() | ~active.any()
    if quota is not None:
        quota_ops.quota_gate_plain(active, req, chain, runtime, used, gate)


_I32, _F32, _BOOL = torch.int32, torch.float32, torch.bool
#: dtypes of koord_round_tail's tensors, in its argument order
_ROUND_DTYPES = (_F32, _I32, _F32, _F32, _BOOL, _BOOL, _F32, _F32, _BOOL, _F32,
                 _F32, _F32, _F32, _F32, _I32, _BOOL, _I32)


#: the most pods a round takes (``kHugeRows * kThreads`` in ``csrc/round.cuh``)
MAX_ROUND_PODS = 131_072


@functools.lru_cache(maxsize=256)
def route(index: int, p: int, d: int, q_cap: int, levels: int, dn: int, dev: bool = False
          ) -> tuple:
    """Which kernel takes a round of ``p`` pods at width ``d`` on device
    ``index`` (``koord_round_route``; ``q_cap`` 0 without quotas, ``dn``
    0 without zones, ``dev`` with devices): ("round" or "round_zone", 0)
    for the shared-memory kernels (with devices "round_dev" or
    "round_zone_dev", their instantiations with the device phase),
    ("round_big", bytes of scratch) for the
    device-memory one up to 32,768 pods, ("round_huge", bytes of scratch)
    above, ("round_big", 0) for a round none takes (more than
    :data:`MAX_ROUND_PODS`), which that entry then refuses."""
    lib = kernels.library("round_big")
    where, nbytes = ctypes.c_int(0), ctypes.c_longlong(0)
    with torch.cuda.device(index):
        kernels.check(lib, lib.koord_round_route(p, d, int(q_cap > 0), q_cap, levels,
                                                 int(dn > 0), dn, int(dev),
                                                 ctypes.byref(where),
                                                 ctypes.byref(nbytes)), "round route")
    if where.value == 2:
        return "round_huge", nbytes.value
    if where.value != 0:
        return "round_big", nbytes.value
    return ("round_zone" if dn else "round") + ("_dev" if dev else ""), 0


def checked_round_devices(dev, like, p: int, n: int) -> list:
    """The round tail's device arguments after the checks: the slot
    table, the stats table, the free RDMA and FPGA counts (null: not
    tracked), the sorted pods' whole GPUs, share, RDMA and FPGA, the
    batch's wide flag, then G; null pointers and 0 without ``dev`` (a
    :class:`.device.DeviceTerms`)."""
    from .device import MAX_SLOTS, STATS

    if dev is None:
        return [None] * 9 + [0]
    g = dev.slots.shape[1]
    if not 1 <= g <= MAX_SLOTS or dev.slots.shape[0] != n:
        raise kernels.KernelArgumentError(
            f"round_tail: the slot table must be [N={n}, G] with G in 1..{MAX_SLOTS}"
        )
    if dev.wide is None:
        raise kernels.KernelArgumentError(
            "round_tail: the device terms need their batch's wide flag (DeviceTerms.batch_start)"
        )
    f32, i32 = torch.float32, torch.int32
    return kernels.checked_ptrs(
        "round_tail",
        (like, dev.slots, dev.stats, dev.rdma, dev.fpga, dev.whole, dev.share, dev.rdma_req,
         dev.fpga_req, dev.wide),
        (f32, f32, f32, f32, f32, i32, f32, i32, i32, i32),
        (like.numel(), n * g, n * STATS, n, n, p, p, p, p, 1),
    )[1:] + [g]


def round_tail(
    top_cost, top_idx, req, est, is_prod, cpu_bind, cpu_amp,
    alloc, fresh, thr, pthr, requested, est_used, prod_used,
    assigned, active, state, round_quantum: float, quota=None, zone=None, dev=None,
) -> None:
    """One round's tail on the tensors' device: one launch of the round
    tail kernel for CUDA tensors, :func:`round_tail_plain` for CPU
    tensors. Same arguments and in-place updates as
    :func:`round_tail_plain`; on the card nothing is read back to the
    host. With ``quota`` the quota commit (the branch ``_quota_commit``
    takes for the table's shape) and the next round's gate are phases of
    the same launch, counted also as ``quota_commit_onehot`` or
    ``quota_commit_sorted``; with ``zone`` (its side table, ``zone[6]``,
    required here) the zone selection and charges,
    counted also as ``zone_phase``; with ``dev`` the device acceptance and
    charges, counted also as ``device_phase``. The kernel is
    ``csrc/round.cu``'s (or with zones ``round_zone.cu``'s; with devices
    ``round_dev.cu``'s or ``round_zone_dev.cu``'s) while the round
    fits in shared memory, else ``round_big.cu``'s (up to 32,768 pods) or
    ``round_huge.cu``'s, its working set in a device buffer of this
    launch's own (:func:`route`; counted also as ``round_tail_big``); up to
    :data:`MAX_ROUND_PODS` pods."""
    args = (top_cost, top_idx, req, est, is_prod, cpu_bind, cpu_amp,
            alloc, fresh, thr, pthr, requested, est_used, prod_used,
            assigned, active, state)
    if top_cost.is_cpu:
        return round_tail_plain(*args, round_quantum, quota, zone, dev)
    p, k = top_cost.shape
    n, d = alloc.shape
    if not 1 <= d <= 8:
        raise kernels.KernelArgumentError(f"round_tail: D={d} must be in 1..8")
    pk, pd, nd = p * k, p * d, n * d
    ptrs = kernels.checked_ptrs(
        "round_tail", args, _ROUND_DTYPES,
        (pk, pk, pd, pd, p, p, n, nd, n, nd, nd, nd, nd, nd, p, p, 2),
    )
    q_cap = levels = 0
    q_ptrs = [None] * 4
    if quota is not None:
        chain, runtime, used, gate = quota
        q_cap, levels = runtime.shape[0], chain.shape[1]
        q_ptrs = kernels.checked_ptrs(
            "round_tail", (top_cost, chain, runtime, used, gate),
            (_F32, _I32, _F32, _F32, _BOOL),
            (pk, p * levels, q_cap * d, q_cap * d, p),
        )[1:]
    z_args = []
    dn = 0
    if zone is not None:
        if len(zone) != 7:
            raise kernels.KernelArgumentError(
                "round_tail: on the card the zones need the nodes' side table (zone[6], "
                "ops/numa.py:zone_prep)"
            )
        zone_free, zone_cap, _, zone_most, required, pod_zone, side = zone
        _, nz, dn = zone_cap.shape
        if not (1 <= nz <= 8 and 1 <= dn <= min(4, d)) or zone_free.shape != zone_cap.shape:
            raise kernels.KernelArgumentError(
                f"round_tail: zones [N, Z={nz}, DN={dn}] need Z <= 8, DN <= min(4, D)"
            )
        z_args = kernels.checked_ptrs(
            "round_tail", (top_cost, zone_free, zone_cap, side, zone_most, required, pod_zone),
            (_F32, _F32, _F32, _I32, _BOOL, _BOOL, _I32),
            (pk, n * nz * dn, n * nz * dn, n * (1 + dn + nz), n, p, p),
        )[1:] + [nz, dn]
    d_args = checked_round_devices(dev, top_cost, p, n)
    if p > MAX_ROUND_PODS:
        raise kernels.KernelArgumentError(f"round_tail: P={p} must be at most {MAX_ROUND_PODS}")
    name, nbytes = route(top_cost.get_device(), p, d, q_cap, levels, dn, dev is not None)
    lib = kernels.library(name)
    stream = kernels.stream_of(top_cost)
    common = (*ptrs, ctypes.c_float(round_quantum), p, n, d, k, *q_ptrs, q_cap, levels)
    if name in ("round", "round_dev"):
        code = lib.koord_round_tail(*common, *d_args, stream)
    elif name in ("round_zone", "round_zone_dev"):
        code = lib.koord_round_tail_zone(*common, *z_args, *d_args, stream)
    else:
        # the launch's own working set, from the caching allocator on its
        # stream: inside a capture it comes from that graph's pool, so no
        # two graphs or streams share one
        buf = torch.empty(nbytes, dtype=torch.uint8, device=top_cost.device) if nbytes else None
        entry = lib.koord_round_tail_huge if name == "round_huge" else lib.koord_round_tail_big
        code = entry(*common, *(z_args or [None] * 6 + [0, 0]), *d_args,
                     None if buf is None else buf.data_ptr(), stream)
    kernels.check(lib, code, "round_tail")
    kernels.count("round_tail")
    if name in ("round_big", "round_huge"):
        kernels.count("round_tail_big")
    if dev is not None:
        kernels.count("device_phase")
    if quota is not None:
        branch = "onehot" if quota_ops.onehot_branch(q_cap, d) else "sorted"
        kernels.count(f"quota_commit_{branch}")
    if zone is not None:
        kernels.count("zone_phase")
