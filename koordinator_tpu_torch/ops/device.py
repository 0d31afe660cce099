"""DeviceShare on the round solver's path: the GPU slot table, its
reductions, the per-pair fit, and the slot commit and refund.

Port of ``koordinator_tpu/ops/device.py:1-241``: :class:`DeviceState`
(:33-55), :func:`slot_stats` (:58-70), :func:`device_fit_mask` (:73-116),
:func:`device_fit_mask_cols` (:117-148), :func:`device_consumption`
(:151-162), :func:`slot_commit` (:164-207) and :func:`slot_refund`
(:209-241), as plain PyTorch functions. On the card they are parts of the
hand kernels: the node reductions are ``csrc/device_prep.cu`` once a batch
(:func:`device_prep`) and the round tail's refresh of the nodes it charges;
the fit and score are terms of the pair arithmetic every pricing kernel
shares (``csrc/loadaware.cuh``); the acceptance and commit a phase of the
round tail (``csrc/round.cuh``); the refund part of ``csrc/gangs.cu``.
These functions are those parts' plain versions: the CPU path and the
kernels' oracles.

Each node carries G slots in percent units (100 = one whole free GPU); a
pod asks for whole GPUs, a share of one, or both, and for whole RDMA NICs
and FPGAs. G is a run-time size (the scheduler grows it with the largest
inventory); the kernels take G <= :data:`MAX_SLOTS`.

Order of summation is part of the contract, and it is the order XLA's CPU
backend gives the reference: a node's slot total adds its slots one after
another in slot order up to 32 slots, and above that in windows of 32
(:func:`slot_total`); the refund's running headroom is ``jnp.cumsum`` in
chunks of 16 (:func:`.commit._ordered_cumsum`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import kernels, resolve_device
from .commit import _ordered_cumsum
from .costs import device_cost
from .masks import EPS

FULL = 100.0  # one whole GPU in percent units
#: the most slots a node the kernels take (``kMaxSlots`` in ``csrc/device.cuh``)
MAX_SLOTS = 256
#: XLA's CPU backend sums a row of more than this many slots as a tree
_SUM_WINDOW = 32
#: columns of a node's row of the stats table: full count, best partial,
#: largest slot, total (:func:`slot_stats`)
STATS = 4
#: ``device_scoring`` → the kernels' strategy word
SCORING = {None: 0, "LeastAllocated": 1, "MostAllocated": 2}


@dataclass
class DeviceState:
    """Per-node device inventory (``device.py:33-55``).

    slot_free — free percent of each GPU slot           [N, G] float32
    rdma_free — free RDMA NICs (None: not tracked)      [N] float32
    fpga_free — free FPGAs (None: not tracked)          [N] float32
    cap_total — 100 per installed GPU (the score's and  [N] float32
                the refund's capacity; None: unknown)
    """

    slot_free: torch.Tensor
    rdma_free: torch.Tensor = None
    fpga_free: torch.Tensor = None
    cap_total: torch.Tensor = None

    @classmethod
    def create(cls, slot_free, rdma_free=None, fpga_free=None, cap_total=None,
               device=None) -> "DeviceState":
        dev = resolve_device(device)

        def f32(x):
            return None if x is None else torch.as_tensor(x, dtype=torch.float32, device=dev)

        return cls(slot_free=f32(slot_free), rdma_free=f32(rdma_free),
                   fpga_free=f32(fpga_free), cap_total=f32(cap_total))


def slot_stats(slot_free: torch.Tensor):
    """Round-start reductions of the slot table (``device.py:58-70``):
    ``(full_count [N], partial_max [N], slot_max [N], total [N])`` — the
    fully free slots, the largest partly free slot, the largest slot, and
    the free percent (:func:`slot_total`)."""
    is_full = slot_free >= FULL - EPS
    full = is_full.sum(dim=1).to(torch.float32)
    partial = torch.where(is_full, 0.0, slot_free).max(dim=1).values
    smax = slot_free.max(dim=1).values
    return full, partial, smax, slot_total(slot_free)


def slot_total(values: torch.Tensor) -> torch.Tensor:
    """``jnp.sum(values, axis=1)`` of an [N, G] table in the order XLA's
    CPU backend gives it: up to 32 columns one after another; above, the
    row is padded with zeros to a multiple of 32 (half the padding, rounded
    down, before the row, the rest after), each window of 32 summed in
    order, and the windows' sums summed the same way."""
    g = values.shape[1]
    if g <= _SUM_WINDOW:
        total = values[:, 0]
        for j in range(1, g):
            total = total + values[:, j]
        return total
    windows = -(-g // _SUM_WINDOW)
    pad = windows * _SUM_WINDOW - g
    padded = torch.nn.functional.pad(values, (pad // 2, pad - pad // 2))
    sums = [slot_total(w) for w in padded.split(_SUM_WINDOW, dim=1)]
    return slot_total(torch.stack(sums, dim=1))


def device_fit_mask(gpu_whole, gpu_share, full_count, partial_max, slot_max=None,
                    rdma_req=None, rdma_free=None, fpga_req=None, fpga_free=None):
    """[P, N] GPU fit against the round-start reductions
    (``device.py:73-116``): whole-GPU pods need that many fully free slots;
    share-only pods a slot with that much room; whole+share pods one more
    full slot or a partial slot that holds the share; and RDMA / FPGA
    requests the free counts where those are given."""
    return _fit(gpu_whole, gpu_share, full_count[None, :], partial_max[None, :],
                None if slot_max is None else slot_max[None, :], rdma_req,
                None if rdma_free is None else rdma_free[None, :], fpga_req,
                None if fpga_free is None else fpga_free[None, :])


def device_fit_mask_cols(gpu_whole, gpu_share, full_count, partial_max, slot_max=None,
                         rdma_req=None, rdma_free=None, fpga_req=None, fpga_free=None):
    """:func:`device_fit_mask` over each pod's gathered [P, K] candidate
    columns (``device.py:117-148``): the same elementwise arithmetic."""
    return _fit(gpu_whole, gpu_share, full_count, partial_max, slot_max, rdma_req,
                rdma_free, fpga_req, fpga_free)


def _fit(gpu_whole, gpu_share, full, partial, smax, rdma_req, rdma_free, fpga_req,
         fpga_free):
    if smax is None:
        smax = torch.maximum(partial, torch.where(full >= 1.0 - EPS, FULL, 0.0))
    whole = gpu_whole[:, None].to(torch.float32)
    frac = gpu_share[:, None]
    whole_ok = whole <= full + EPS
    frac_ok = (frac <= smax + EPS) | (frac <= EPS)
    both = (gpu_whole[:, None] > 0) & (frac > EPS)
    both_ok = (whole + 1.0 <= full + EPS) | (frac <= partial + EPS)
    ok = whole_ok & torch.where(both, both_ok, frac_ok)
    if rdma_req is not None and rdma_free is not None:
        ok &= rdma_req[:, None].to(torch.float32) <= rdma_free + EPS
    if fpga_req is not None and fpga_free is not None:
        ok &= fpga_req[:, None].to(torch.float32) <= fpga_free + EPS
    return ok


def device_consumption(gpu_whole, gpu_share):
    """(full slots [P], total percent [P]) a pod asks for
    (``device.py:151-162``)."""
    full = gpu_whole.to(torch.float32)
    return full, full * FULL + gpu_share


def slot_commit(slot_free, whole_taken, frac_share, frac_opens_full):
    """One round's winners onto the slot table (``device.py:164-207``):
    ``whole_taken`` [N] fully free slots zeroed, by their rank among the
    node's full slots; the node's one fractional winner (``frac_share``
    [N]) opens the next full slot (``frac_opens_full`` [N] bool) or bites
    the tightest partly free slot that holds it (the first on ties)."""
    g = slot_free.shape[1]
    is_full = slot_free >= FULL - EPS
    full_rank = torch.cumsum(is_full.to(torch.int32), dim=1) - 1
    w = whole_taken[:, None]
    rank_f = full_rank.to(torch.float32)
    consumed = is_full & (rank_f < w - 0.5)
    opened = is_full & (torch.abs(rank_f - w) < 0.5) & frac_opens_full[:, None]
    partial_free = torch.where(is_full, torch.inf, slot_free)
    cand = torch.where(partial_free >= frac_share[:, None] - EPS, partial_free, torch.inf)
    best = cand.min(dim=1).values
    tgt = (cand == best[:, None]).to(torch.int8).argmax(dim=1)  # first on ties
    has_cand = torch.isfinite(best)
    take_partial = (frac_share > EPS) & ~frac_opens_full & has_cand
    hit = take_partial[:, None] & (torch.arange(g, device=slot_free.device)[None, :]
                                   == tgt[:, None])
    out = torch.where(consumed, 0.0, slot_free)
    out = torch.where(opened, FULL - frac_share[:, None], out)
    return out - torch.where(hit, frac_share[:, None], 0.0)


def slot_refund(slot_free, refund, slot_exists=None):
    """Water-fill ``refund`` [N] percent back onto the slot table, the
    emptiest slot first (a stable sort: equal slots in index order), each
    filled up to FULL; padding slots (``slot_exists`` [N, G] False) get no
    headroom (``device.py:209-241``). The running headroom is summed in
    XLA's chunked cumsum order."""
    s, order = torch.sort(slot_free, dim=1, stable=True)
    headroom = FULL - s
    if slot_exists is not None:
        headroom = torch.where(slot_exists.gather(1, order), headroom, 0.0)
    cum_prev = _ordered_cumsum(headroom.t().contiguous()).t() - headroom
    fill = torch.minimum(torch.clamp(refund[:, None] - cum_prev, min=0.0), headroom)
    return torch.zeros_like(slot_free).scatter_(1, order, s + fill)


def slot_exists_of(cap_total, g: int):
    """[N, G] bool: the real slots of each node, ``arange(G) < cap / 100``
    (``solver.py:1525-1535``); None without ``cap_total``."""
    if cap_total is None:
        return None
    return (torch.arange(g, device=cap_total.device)[None, :]
            < (cap_total / 100.0)[:, None])


def device_prep_plain(slot_free):
    """The plain version of ``csrc/device_prep.cu``: the stats table
    [N, 4] float32 of :func:`slot_stats` (full count, best partial,
    largest slot, total)."""
    return torch.stack(slot_stats(slot_free), dim=1).contiguous()


def device_prep(slot_free):
    """A batch's stats table (:func:`device_prep_plain`) on the tensors'
    device: one launch of ``csrc/device_prep.cu`` for CUDA tensors, the
    plain version for CPU tensors."""
    if slot_free.is_cpu:
        return device_prep_plain(slot_free)
    n, g = slot_free.shape
    if not 1 <= g <= MAX_SLOTS:
        raise ValueError(f"device_prep: G={g} must be in 1..{MAX_SLOTS}")
    stats = torch.empty((n, STATS), dtype=torch.float32, device=slot_free.device)
    ptrs = kernels.checked_ptrs("device_prep", (slot_free, stats),
                                (torch.float32, torch.float32), (n * g, n * STATS))
    lib = kernels.library("device_prep")
    kernels.check(lib, lib.koord_device_prep(*ptrs, n, g, kernels.stream_of(slot_free)),
                  "device_prep")
    kernels.count("device_prep")
    return stats


@dataclass
class DeviceTerms:
    """What a batch's pricing and round tails read and write of the
    devices: the carried slot table ``slots`` [N, G] and free RDMA / FPGA
    counts [N] (None: not tracked), which the round tails charge in place;
    the stats table ``stats`` [N, 4] of :func:`device_prep` (the round-start
    reductions: the batch's at first, each round tail refreshing the rows
    of the nodes it charges); ``cap`` [N] (the score's capacity, None
    without); the priority-sorted pods' ``whole`` [P] int32, ``share`` [P],
    ``rdma_req`` / ``fpga_req`` [P] int32 and ``units`` [P] (100 per whole
    GPU plus the share, the score's demand); and ``scoring`` (0 off, 1
    LeastAllocated, 2 MostAllocated)."""

    slots: torch.Tensor
    stats: torch.Tensor
    rdma: "torch.Tensor | None"
    fpga: "torch.Tensor | None"
    cap: "torch.Tensor | None"
    whole: torch.Tensor
    share: torch.Tensor
    rdma_req: torch.Tensor
    fpga_req: torch.Tensor
    units: torch.Tensor
    scoring: int = 0

    @classmethod
    def batch_start(cls, slots, rdma, fpga, cap, spods, scoring: int = 0) -> "DeviceTerms":
        """The terms of a batch that begins with ``slots`` (its stats table
        from :func:`device_prep`, one launch on the card), for the
        priority-sorted pods ``spods``."""
        if scoring and cap is None:
            raise ValueError("device_scoring needs DeviceState.cap_total")
        _, units = device_consumption(spods.gpu_whole, spods.gpu_share)
        return cls(slots=slots, stats=device_prep(slots), rdma=rdma, fpga=fpga, cap=cap,
                   whole=spods.gpu_whole, share=spods.gpu_share, rdma_req=spods.rdma,
                   fpga_req=spods.fpga, units=units, scoring=scoring)

    def fit_and_cost(self, clamp: bool = False):
        """The [P, N] device fit (``solver.py:900-919``: the fit against
        the stats, RDMA and FPGA against the free counts where tracked, a
        request of an untracked kind refused) and, with ``scoring``, the
        [P, N] score term (:929-940; ``clamp`` the build's min(term, 0)),
        else None."""
        full, partial, smax, total = self.stats.unbind(dim=1)
        fit = device_fit_mask(self.whole, self.share, full, partial, slot_max=smax,
                              rdma_req=self.rdma_req, rdma_free=self.rdma,
                              fpga_req=self.fpga_req, fpga_free=self.fpga)
        if self.rdma is None:
            fit &= (self.rdma_req == 0)[:, None]
        if self.fpga is None:
            fit &= (self.fpga_req == 0)[:, None]
        term = None
        if self.scoring:
            term = device_cost(self.units, total, self.cap, most_allocated=self.scoring == 2)
            if clamp:
                term = torch.minimum(term, torch.zeros_like(term))
        return fit, term


def checked_devices(what: str, dev: "DeviceTerms | None", p: int, n: int) -> list:
    """A pricing kernel's device arguments after the checks: the pointers
    of the stats table, the free RDMA and FPGA counts (null: not tracked),
    the capacities, the pods' whole, share, RDMA, FPGA and units, then the
    scoring strategy; null pointers and 0 without ``dev``."""
    if dev is None:
        return [None] * 9 + [0]
    f32, i32 = torch.float32, torch.int32
    tensors = (dev.stats, dev.rdma, dev.fpga, dev.cap, dev.whole, dev.share, dev.rdma_req,
               dev.fpga_req, dev.units)
    ptrs = kernels.checked_ptrs(
        what, (dev.stats,) + tensors,
        (f32, f32, f32, f32, f32, i32, f32, i32, i32, f32),
        (n * STATS, n * STATS, n, n, n, p, p, p, p, p),
    )[1:]
    return ptrs + [dev.scoring]
