"""NUMA zones on the round solver's path: the zone table, the per-pair fit
under each node's topology policy, and the strategy-ordered zone pick.

Port of ``koordinator_tpu/ops/numa.py``: the policy constants,
:class:`NumaState` (:29-45), :func:`zone_pick` (:48-75),
:func:`numa_fit_mask` (:77-145) and :func:`numa_alignment_cost`
(:146-172), as plain PyTorch functions. On the card
they are terms of the hand kernels: the fit is one more feasibility term
of the pair arithmetic every pricing kernel shares
(``csrc/loadaware.cuh``), the pick a phase of the round tail
(``csrc/round.cu``). These functions are those terms' plain versions: the
CPU path and the kernels' oracle.

Zone convention: a zone's resources are the *prefix* of the dense resource
axis (dims 0..DN-1, cpu and memory), so a pod's zone request is a slice of
its request row.

Order of summation is part of the contract: ``total_free`` sums the zones
one after another in zone order, the order XLA's CPU backend gives the
reference at Z = 4 (``tests/test_torch_numa.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels, resolve_device
from .costs import score_program
from .masks import EPS

#: NUMAPolicy enum values (``core.topology.NUMAPolicy``)
POLICY_NONE = 0
POLICY_BEST_EFFORT = 1
POLICY_RESTRICTED = 2
POLICY_SINGLE_NUMA_NODE = 3


@dataclass
class NumaState:
    """The NUMA zone block (``numa.py:29-45``).

    zone_free — remaining allocatable per zone        [N, Z, DN] float32
    zone_cap  — zone allocatable capacity             [N, Z, DN] float32
    policy    — node topology manager policy          [N] int8
    zone_most — per-node MostAllocated zone-pick flag [N] bool
                (None: LeastAllocated everywhere)
    """

    zone_free: torch.Tensor
    zone_cap: torch.Tensor
    policy: torch.Tensor
    zone_most: torch.Tensor = None

    @classmethod
    def create(cls, zone_free, zone_cap, policy, zone_most=None, device=None) -> "NumaState":
        dev = resolve_device(device)
        return cls(
            zone_free=torch.as_tensor(zone_free, dtype=torch.float32, device=dev),
            zone_cap=torch.as_tensor(zone_cap, dtype=torch.float32, device=dev),
            policy=torch.as_tensor(policy, dtype=torch.int8, device=dev),
            zone_most=(
                None if zone_most is None
                else torch.as_tensor(zone_most, dtype=torch.bool, device=dev)
            ),
        )


def zone_pick(zone_free_g, zone_cap_g, req_eff, most_allocated):
    """Strategy-ordered fitting-zone pick (``numa.py:48-75``): for each row,
    the zone of ``zone_free_g`` [P, Z, DN] (the carried table at the pod's
    node) where ``req_eff`` [P, DN] fits in every dim within 1e-3, among
    zones with some capacity, keyed by ``(cap0 - free0 + 1) / (cap0 + 1)``
    ascending (LeastAllocated) or its negation (``most_allocated`` [P]
    bool); the first zone on ties. Returns (zone [P] int32, has_fit [P]
    bool); zone is meaningful only where has_fit."""
    fits = torch.all(zone_free_g >= req_eff[:, None, :] - 1e-3, dim=-1)
    fits &= torch.any(zone_cap_g > 0, dim=-1)
    used0 = zone_cap_g[:, :, 0] - zone_free_g[:, :, 0]
    util = (used0 + 1.0) / (zone_cap_g[:, :, 0] + 1.0)
    key = torch.where(fits, torch.where(most_allocated[:, None], -util, util), torch.inf)
    best = key.min(dim=1).values
    # argmin with the first index on ties, as jnp.argmin gives them
    first = (key == best[:, None]).to(torch.int8).argmax(dim=1)
    return first.to(torch.int32), torch.isfinite(best)


def zone_sum(table: torch.Tensor) -> torch.Tensor:
    """``jnp.sum(table, axis=1)`` of an [N, Z, DN] table, the zones added
    one after another in zone order (XLA's CPU order)."""
    total = table[:, 0]
    for z in range(1, table.shape[1]):
        total = total + table[:, z]
    return total


def numa_fit_mask(pod_requests, pod_wants_numa, numa: NumaState, cpu_amp=None,
                  pod_required=None) -> torch.Tensor:
    """[P, N] feasibility under each node's topology policy
    (``numa.py:77-145``): on a SINGLE_NUMA_NODE node, or for a pod whose
    spec requires it (``pod_required``), the zone-scoped request must fit
    in one zone; elsewhere a pod that wants alignment must fit in the sum
    of the zones, and any other pod is feasible. A node that reports no
    zone capacity is feasible for every pod, and a dim no zone of the node
    reports is not checked. ``cpu_amp`` [N] scales the CPU request of the
    pods in ``pod_wants_numa`` by ``1 + (max(amp, 1) - 1)``, literally as
    the reference writes it."""
    dn = numa.zone_free.shape[-1]
    n = numa.zone_free.shape[0]
    dev = numa.zone_free.device
    req = pod_requests[:, :dn]                                           # [P, DN]
    amp = (torch.ones((n,), dtype=torch.float32, device=dev) if cpu_amp is None
           else torch.clamp(cpu_amp, min=1.0))
    scale = torch.ones((n, dn), dtype=torch.float32, device=dev)
    scale[:, 0] = amp
    req_scale = 1.0 + pod_wants_numa[:, None, None].to(torch.float32) * (scale[None] - 1.0)
    req_eff = req[:, None, :] * req_scale                                 # [P, N, DN]
    dim_on = zone_sum(numa.zone_cap) > 0                                  # [N, DN]
    zone_fit = torch.all(
        (req_eff[:, :, None, :] <= numa.zone_free[None] + EPS) | ~dim_on[None, :, None, :],
        dim=-1,
    )                                                                     # [P, N, Z]
    any_zone = torch.any(zone_fit, dim=-1)
    total_free = zone_sum(numa.zone_free)                                 # [N, DN]
    total_fit = torch.all((req_eff <= total_free[None] + EPS) | ~dim_on[None], dim=-1)
    has_zones = torch.any(numa.zone_cap.sum(dim=-1) > 0, dim=-1)          # [N]
    strict_pn = (numa.policy == POLICY_SINGLE_NUMA_NODE)[None, :]
    if pod_required is not None:
        strict_pn = strict_pn | pod_required[:, None]
    ok = torch.where(strict_pn, any_zone, total_fit | ~pod_wants_numa[:, None])
    return ok | ~has_zones[None, :]


def numa_alignment_cost_plain(pod_requests, numa: NumaState, most_allocated: bool = False):
    """[P, N] cost over each node's best zone (``numa.py:146-172``): a
    zone's score is the mean over its DN dims of its free fraction after
    the pod, ``clip((free - req) / max(max_z free, 1e-9), 0, 1)``, × 100
    (MostAllocated: 100 minus it), -1 where the pod does not fit in the
    zone within ``EPS``; the node's cost is minus the best zone's score.
    The mean adds the dims in order and multiplies by the float32
    reciprocal of DN: XLA rewrites ``jnp.mean``'s division by a constant
    so (at DN = 3 the two differ in the last bit)."""
    dn = numa.zone_free.shape[-1]
    req = pod_requests[:, :dn]
    after = numa.zone_free[None, :, :, :] - req[:, None, None, :]        # [P, N, Z, DN]
    fits = torch.all(after >= -EPS, dim=-1)                              # [P, N, Z]
    total = torch.clamp(numa.zone_free.max(dim=1).values, min=1e-9)     # [N, DN]
    frac_free = torch.clamp(after / total[None, :, None, :], 0.0, 1.0)
    mean = frac_free[..., 0]
    for d in range(1, dn):
        mean = mean + frac_free[..., d]
    zone_score = mean * _inverse(dn) * 100.0
    if most_allocated:
        zone_score = 100.0 - zone_score
    zone_score = torch.where(fits, zone_score, -1.0)
    return -zone_score.max(dim=-1).values


def _inverse(dn: int) -> float:
    """float32 ``1 / dn``, rounded once, as a Python float."""
    return float(np.float32(1.0) / np.float32(dn))


def numa_alignment_cost(pod_requests, numa: NumaState, most_allocated: bool = False):
    """:func:`numa_alignment_cost_plain` on the tensors' device: one launch
    of ``csrc/score_programs.cu``'s NUMA program for CUDA tensors (Z up to
    :data:`MAX_ZONES`, DN up to :data:`MAX_ZONE_DIMS`), the plain version
    for CPU tensors."""
    if pod_requests.is_cpu:
        return numa_alignment_cost_plain(pod_requests, numa, most_allocated)
    _, nz, dn = numa.zone_free.shape
    if not (1 <= nz <= MAX_ZONES and 1 <= dn <= MAX_ZONE_DIMS):
        raise kernels.KernelArgumentError(
            f"numa_alignment_cost: Z={nz} must be in 1..{MAX_ZONES} and DN={dn} in "
            f"1..{MAX_ZONE_DIMS}")
    flag = torch.full((dn,), bool(most_allocated), dtype=torch.bool, device=pod_requests.device)
    return score_program("numa_alignment_cost", pod_requests, numa.zone_free, None, None, flag,
                         dn, zones=nz)


@dataclass
class ZoneTerms:
    """What the pricing of a batch reads of the zones: the zone table as
    the batch began (``free``: a snapshot, never the table the rounds
    write, ``solver.py:771-818``), the capacities and policies, the
    priority-sorted pods' ``required`` flags [P] bool, the aligned score's
    strategy (``scoring``: 0 off, 1 LeastAllocated, 2 MostAllocated) and,
    for the kernels, the nodes' side table (``side`` [N, 1 + DN + Z]
    int32, :func:`zone_prep`) and, without devices, the order the
    nomination kernel takes the pods in (``order`` [P] int32,
    :func:`.nominate.pod_order`, set by the solver's full-axis route; None:
    in place). A pod wants alignment when it is cpuset-bound or required
    (``solver.py:755-770``)."""

    free: torch.Tensor        # [N, Z, DN]
    cap: torch.Tensor         # [N, Z, DN]
    policy: torch.Tensor      # [N] int8
    required: torch.Tensor    # [P] bool, sorted pods
    scoring: int = 0
    side: torch.Tensor = None
    order: "torch.Tensor | None" = None

    @classmethod
    def batch_start(cls, zone_free, zone_cap, policy, required, scoring: int = 0) -> "ZoneTerms":
        """The terms of a batch that begins with ``zone_free``: its
        snapshot and side table (:func:`zone_prep`, one launch on the
        card)."""
        free, side = zone_prep(zone_free, zone_cap, policy)
        return cls(free=free, cap=zone_cap, policy=policy, required=required, scoring=scoring,
                   side=side)

    def state(self) -> NumaState:
        return NumaState(zone_free=self.free, zone_cap=self.cap, policy=self.policy)


#: bits of a side row's first word (``csrc/loadaware.cuh``)
SIDE_DIM_ON, SIDE_HAS_ZONES, SIDE_SINGLE, SIDE_REAL = 1, 1 << 4, 1 << 5, 8


def zone_prep_plain(zone_free, zone_cap, policy):
    """The plain version of ``csrc/zone_prep.cu``: (a copy of
    ``zone_free``, the side table [N, 1 + DN + Z] int32). A node's row is
    its bits — dim d on (bit d: the zones' capacities of d, added in zone
    order, > 0), has zones (bit 4: a zone whose capacities, added in dim
    order, sum > 0), SINGLE_NUMA_NODE (bit 5), zone z with some capacity
    (bit 8 + z) — then the zones' free totals [DN] (:func:`zone_sum`) and
    each zone's (cap0 - free0 + 1) / (cap0 + 1) [Z], as float bits: the
    terms :func:`numa_fit_mask` and ``costs.numa_aligned_cost`` work out
    per node."""
    n, z, dn = zone_cap.shape
    info = torch.where(policy == POLICY_SINGLE_NUMA_NODE, SIDE_SINGLE, 0).to(torch.int32)
    dim_on = zone_sum(zone_cap) > 0                                        # [N, DN]
    for d in range(dn):
        info |= torch.where(dim_on[:, d], SIDE_DIM_ON << d, 0).to(torch.int32)
    csum = zone_cap[:, :, 0]
    for d in range(1, dn):
        csum = csum + zone_cap[:, :, d]
    info |= torch.where((csum > 0).any(dim=1), SIDE_HAS_ZONES, 0).to(torch.int32)
    real = (zone_cap > 0).any(dim=-1)                                      # [N, Z]
    for q in range(z):
        info |= torch.where(real[:, q], 1 << (SIDE_REAL + q), 0).to(torch.int32)
    used0 = zone_cap[:, :, 0] - zone_free[:, :, 0]
    util = (used0 + 1.0) / (zone_cap[:, :, 0] + 1.0)
    side = torch.cat([info[:, None], zone_sum(zone_free).view(torch.int32),
                      util.contiguous().view(torch.int32)], dim=1)
    return zone_free.clone(), side.contiguous()


def zone_prep(zone_free, zone_cap, policy):
    """A batch's zone snapshot and side table (:func:`zone_prep_plain`)
    on the tensors' device: one launch of ``csrc/zone_prep.cu`` for CUDA
    tensors, the plain version for CPU tensors."""
    if zone_free.is_cpu:
        return zone_prep_plain(zone_free, zone_cap, policy)
    n, z, dn = zone_cap.shape
    if not (1 <= z <= MAX_ZONES and 1 <= dn <= MAX_ZONE_DIMS):
        raise kernels.KernelArgumentError(
            f"zone_prep: Z={z} must be in 1..{MAX_ZONES} and DN={dn} in 1..{MAX_ZONE_DIMS}"
        )
    snapshot = torch.empty_like(zone_free)
    side = torch.empty((n, 1 + dn + z), dtype=torch.int32, device=zone_free.device)
    ptrs = kernels.checked_ptrs(
        "zone_prep", (zone_free, zone_cap, policy, snapshot, side),
        (torch.float32, torch.float32, torch.int8, torch.float32, torch.int32),
        (n * z * dn, n * z * dn, n, n * z * dn, n * (1 + dn + z)),
    )
    lib = kernels.library("zone_prep")
    kernels.check(lib, lib.koord_zone_prep(*ptrs, n, z, dn, kernels.stream_of(zone_free)),
                  "zone_prep")
    kernels.count("zone_prep")
    return snapshot, side


#: ``numa_scoring`` → ``ZoneTerms.scoring``
SCORING = {None: 0, "LeastAllocated": 1, "MostAllocated": 2}


#: the most zones a node and zone dims the kernels take (``kMaxZones`` and
#: ``kMaxZoneDims`` in ``csrc/loadaware.cuh``)
MAX_ZONES = 8
MAX_ZONE_DIMS = 4


def checked_zones(what: str, zones: "ZoneTerms | None", p: int, n: int, d: int) -> list:
    """A pricing kernel's NUMA arguments after the checks: the pointers of
    the snapshot, the capacities, the side table and the required flags,
    then Z, DN and the scoring strategy; null pointers and zeros without
    ``zones``. The terms must come from :meth:`ZoneTerms.batch_start`."""
    if zones is None:
        return [None] * 4 + [0, 0, 0]
    _, nz, dn = zones.cap.shape
    if zones.free.shape != (n, nz, dn) or zones.cap.shape != (n, nz, dn):
        raise kernels.KernelArgumentError(f"{what}: zone tables must be [N={n}, Z, DN]")
    if not (1 <= nz <= MAX_ZONES and 1 <= dn <= min(MAX_ZONE_DIMS, d)):
        raise kernels.KernelArgumentError(
            f"{what}: Z={nz} must be in 1..{MAX_ZONES} and DN={dn} in "
            f"1..min({MAX_ZONE_DIMS}, D={d})"
        )
    if zones.side is None:
        raise kernels.KernelArgumentError(
            f"{what}: the zone terms have no side table (ZoneTerms.batch_start)"
        )
    ptrs = kernels.checked_ptrs(
        what, (zones.free, zones.cap, zones.side, zones.required),
        (torch.float32, torch.float32, torch.int32, torch.bool),
        (n * nz * dn, n * nz * dn, n * (1 + dn + nz), p),
    )
    return ptrs + [nz, dn, zones.scoring]
