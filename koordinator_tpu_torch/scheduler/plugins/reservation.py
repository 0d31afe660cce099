"""Reservation plugin: capacity held by ghost pods, consumed by owners.

Rebuild of ``pkg/scheduler/plugins/reservation/`` + the frameworkext
reservation cache (``reservation_info.go:1-495``): a Reservation is
scheduled like a pod (the "reserve pod"), holds its capacity on the chosen
node, and later pods matching its owner selectors allocate *from* the
reservation instead of from node free capacity (the reference restores
reserved resources into NodeInfo via transformers before Filter;
here the ghost hold + pre-match commit achieves the same accounting).
AllocateOnce reservations are consumed whole; TTL expiry releases holds.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ...api import extension as ext

from ...api.types import (
    RESERVATION_ALLOCATE_POLICY_RESTRICTED,
    ObjectMeta,
    Pod,
    PodSpec,
    Reservation,
    ReservationOwner,
    ReservationPhase,
)

GHOST_PRIORITY = 9800  # reserve pods schedule in the prod band


def _ghost_uid(reservation: Reservation) -> str:
    return f"reservation-ghost/{reservation.meta.name}"


def reservation_from_operating_pod(pod: Pod) -> Reservation:
    """A Reservation view over a pod operating in Reservation mode
    (reference ``operating_pod.go`` + ``reservation_info.go``
    NewReservationInfoFromPod): requests are the pod's requests, owners
    come from the reservation-owners annotation."""
    owners = []
    for item in ext.parse_reservation_owners(pod.meta.annotations):
        if not isinstance(item, dict):
            continue
        selector = (item.get("labelSelector") or {}).get("matchLabels") or {}
        owners.append(
            ReservationOwner(
                label_selector=dict(selector),
                namespace=item.get("namespace"),
            )
        )
    return Reservation(
        meta=ObjectMeta(
            name=pod.meta.name,
            namespace=pod.meta.namespace,
            labels=dict(pod.meta.labels),
            annotations=dict(pod.meta.annotations),
        ),
        requests=dict(pod.spec.requests),
        owners=owners,
        allocate_once=True,
    )


def matches_owner(reservation: Reservation, pod: Pod) -> bool:
    """Owner matching (reference ``apis/scheduling/v1alpha1/reservation_types
    .go`` ReservationOwner: label selector and/or namespace)."""
    if not reservation.owners:
        return False
    for owner in reservation.owners:
        if not owner.label_selector and owner.namespace is None:
            continue  # an empty owner matches nothing, not everything
        if owner.namespace is not None and owner.namespace != pod.meta.namespace:
            continue
        if all(
            pod.meta.labels.get(k) == v
            for k, v in owner.label_selector.items()
        ):
            return True
    return False


class ResvView:
    """Pure overlay over the live reservation/snapshot state for the
    pipeline's dispatch-side fast-path PREVIEW (open the last speculation
    gates PR). Reads fall through to the live objects; predicted
    mutations accumulate in the overlay dicts only — the manager and the
    snapshot are never touched (the quota-preview purity discipline).
    A chained dispatch seeds its view from the upstream speculation's
    view (``clone``), so cycle N+1's preview runs against cycle N's
    PREDICTED post-fast-path state; the consuming cycle validates every
    prediction by value (``BatchScheduler._carry_consume_ok``) before a
    speculation built on this view may be kept."""

    __slots__ = (
        "mgr", "phase", "allocated", "owners", "ledger", "assumed",
        "node_req", "_cands", "_nom", "version",
    )

    def __init__(self, mgr: "ReservationManager"):
        self.mgr = mgr
        #: lazy per-PREVIEW candidate cache (see candidates()) — reset
        #: on clone so a carried view never serves a stale list
        self._cands: Optional[List[Reservation]] = None
        #: lazy vectorized nomination arrays over the overlay state
        #: (state-integrity PR satellite), invalidated by ``version``
        #: which bumps on every predicted mutation
        self._nom = None
        self.version = 0
        #: name -> predicted phase (terminal transitions)
        self.phase: Dict[str, ReservationPhase] = {}
        #: name -> predicted allocated dict (full copy once touched)
        self.allocated: Dict[str, Dict[str, float]] = {}
        #: name -> predicted current_owners list (full copy once touched)
        self.owners: Dict[str, List[str]] = {}
        #: name -> predicted owner ledger {uid: consumed} (copy on touch)
        self.ledger: Dict[str, Dict[str, Dict[str, float]]] = {}
        #: uid -> predicted assume entry (None = predicted forgotten);
        #: entries are (request_vec, estimate_vec, is_prod) host rows
        self.assumed: Dict[str, Optional[tuple]] = {}
        #: node idx -> predicted delta on snapshot.nodes.requested
        self.node_req: Dict[int, "np.ndarray"] = {}

    def clone(self) -> "ResvView":
        out = ResvView(self.mgr)
        out._nom = None
        out.version = 0
        out.phase = dict(self.phase)
        out.allocated = {k: dict(v) for k, v in self.allocated.items()}
        out.owners = {k: list(v) for k, v in self.owners.items()}
        out.ledger = {
            k: {u: dict(c) for u, c in v.items()}
            for k, v in self.ledger.items()
        }
        out.assumed = dict(self.assumed)
        out.node_req = {k: v.copy() for k, v in self.node_req.items()}
        out._cands = None
        return out

    # ---- overlay reads ----

    def phase_of(self, r: Reservation) -> ReservationPhase:
        return self.phase.get(r.meta.name, r.phase)

    def allocated_of(self, r: Reservation) -> Dict[str, float]:
        return self.allocated.get(r.meta.name, r.allocated)

    def owners_of(self, r: Reservation) -> List[str]:
        return self.owners.get(r.meta.name, r.current_owners)

    def assumed_entry(self, uid: str) -> Optional[tuple]:
        """Predicted (request, estimate, is_prod) for ``uid``'s snapshot
        assume, falling through to the live entry; None = no hold."""
        if uid in self.assumed:
            return self.assumed[uid]
        ap = self.mgr.scheduler.snapshot._assumed.get(uid)
        if ap is None or ap.absorbed:
            # absorbed pods carry no pending estimate; the fast path
            # never touches them — treat as no predictable hold
            return None if ap is None else (ap.request, None, ap.is_prod)
        return (ap.request, ap.estimate, ap.is_prod)

    def node_requested(self, idx: int) -> "np.ndarray":
        import numpy as np  # noqa: F811 — local like spill_fits_node

        row = self.mgr.scheduler.snapshot.nodes.requested[idx]
        delta = self.node_req.get(idx)
        return row if delta is None else row + delta

    # ---- overlay writes (predicted mutations) ----

    def _alloc_mut(self, r: Reservation) -> Dict[str, float]:
        return self.allocated.setdefault(r.meta.name, dict(r.allocated))

    def _owners_mut(self, r: Reservation) -> List[str]:
        return self.owners.setdefault(
            r.meta.name, list(r.current_owners)
        )

    def _ledger_mut(self, name: str) -> Dict[str, Dict[str, float]]:
        return self.ledger.setdefault(
            name,
            {
                u: dict(c)
                for u, c in self.mgr._owner_requests.get(name, {}).items()
            },
        )

    def add_node_delta(self, idx: int, delta: "np.ndarray") -> None:
        cur = self.node_req.get(idx)
        self.node_req[idx] = delta.copy() if cur is None else cur + delta

    def candidates(self) -> List[Reservation]:
        """The preview's candidate list, built ONCE per preview run (a
        clone resets the cache): rebuilding it inside every per-pod
        ``match`` call re-creates exactly the O(R)-per-pod re-validation
        hot spot ``begin_cycle``'s cycle cache exists to remove. Safe to
        cache for one preview: nothing under ``snapshot.lock`` adds
        reservations or removes nodes mid-preview, and predicted phase
        transitions are filtered per candidate by ``phase_of`` at use."""
        if self._cands is None:
            self._cands = self.mgr._preview_candidates(self)
        return self._cands


def _reservation_order(r: Reservation) -> Optional[int]:
    """Non-zero integer order label, or None (reference
    ``findMostPreferredReservationByOrder``: unparseable/zero = unordered)."""
    raw = r.meta.labels.get(ext.LABEL_RESERVATION_ORDER, "")
    if not raw:
        return None
    try:
        order = int(raw)
    except ValueError:
        return None
    return order if order != 0 else None


def _score_reservation(
    pod: Pod, r: Reservation, allocated: Optional[Dict[str, float]] = None
) -> float:
    """MostAllocated fit score over the reservation's own resource dims
    (reference ``scoring.go:196-209`` scoreReservation): mean of
    ``100·min(req+allocated ≤ cap)/cap``; dims the pod would overflow
    contribute 0. ``allocated`` substitutes the live ledger (the
    pipeline preview passes its overlay view's)."""
    if allocated is None:
        allocated = r.allocated
    resources = {k: v for k, v in r.requests.items() if v > 0}
    if not resources:
        return 0.0
    s = 0.0
    for k, cap in resources.items():
        req = pod.spec.requests.get(k, 0.0) + allocated.get(k, 0.0)
        # same epsilon as the match() capacity filter: float accumulation
        # noise must not zero the tightest dim of an exact-fit candidate
        if req <= cap + 1e-6:
            s += 100.0 * min(req, cap) / cap
    return s / len(resources)


class ReservationManager:
    """Schedules pending reservations as ghost pods and brokers matches."""

    def __init__(
        self,
        scheduler: "BatchScheduler",
        gc_duration_s: float = 24 * 3600.0,
        clock=None,
    ):
        import time as _t

        #: every reservation timestamp (available/terminal) and every
        #: default `now` comes from this one clock, so an injected
        #: simulated clock measures TTL/GC windows consistently
        self._clock = clock if clock is not None else _t.time
        self.scheduler = scheduler
        scheduler.reservations = self  # enable the pre-match commit path
        self._reservations: Dict[str, Reservation] = {}
        #: per-cycle Available candidate cache (see begin_cycle)
        self._cycle_candidates: Optional[List[Reservation]] = None
        self._cycle_epoch = -1
        #: bumped on ANY nomination-relevant mutation (phase, allocated,
        #: owners, requests, node assignment) — the vectorized match
        #: arrays (state-integrity PR satellite) key their cache on it
        self._ledger_version = 0
        #: (candidate list object, ledger version, arrays) — strong ref
        #: to the list keeps identity comparison sound
        self._nom_cache = None
        #: terminal reservations are deleted after this long (reference
        #: controller/garbage_collection.go, ReservationArgs.GCDuration)
        self.gc_duration_s = gc_duration_s
        #: reservation name -> {pod uid: requests at allocate time}, for
        #: owner-drift refunds (controller.go:221-260 syncStatus)
        self._owner_requests: Dict[str, Dict[str, Dict[str, float]]] = {}
        #: reservation name -> when it went FAILED/SUCCEEDED (GC base)
        self._terminal_time: Dict[str, float] = {}
        #: reservations backed by operating-mode pods: name -> the pod
        #: whose own assume IS the capacity hold (operating_pod.go)
        self._operating: Dict[str, Pod] = {}

    def _bump_ledger(self) -> None:
        """Invalidate the vectorized nomination arrays: call after ANY
        mutation of phase / allocated / owners / requests / node
        assignment (node CAPACITY rows are read live at match time and
        need no bump)."""
        self._ledger_version += 1
        self._nom_cache = None

    def add(self, reservation: Reservation) -> None:
        # a re-created name must not inherit the old incarnation's
        # terminal clock or owner ledger (premature GC / stale refunds)
        self._terminal_time.pop(reservation.meta.name, None)
        self._owner_requests.pop(reservation.meta.name, None)
        self._reservations[reservation.meta.name] = reservation
        self._cycle_candidates = None
        self._bump_ledger()

    def get(self, name: str) -> Optional[Reservation]:
        return self._reservations.get(name)

    def owner_ledger(self, name: str) -> Dict[str, Dict[str, float]]:
        """{pod uid: requests} recorded at allocate time for a
        reservation's live owners (read-only view for invariant checks)."""
        return dict(self._owner_requests.get(name, {}))

    def list(self) -> List[Reservation]:
        return list(self._reservations.values())

    def _hold_uid(self, r: Reservation) -> str:
        """Uid of the snapshot assume holding this reservation's capacity:
        the operating pod's own uid when the reservation IS a pod, the
        synthetic ghost uid otherwise."""
        op = self._operating.get(r.meta.name)
        return op.meta.uid if op is not None else _ghost_uid(r)

    def ingest_operating_pod(self, pod: Pod) -> Optional[Reservation]:
        """Register a Reservation-operating-mode pod as a reservation
        (reference ``pod_eventhandler.go``): a bound pod's existing assume
        becomes the capacity hold and the reservation is immediately
        Available; a pending pod registers Pending and becomes Available
        when its bind is ingested again."""
        if not ext.is_reservation_operating_mode(pod):
            return None
        r = self._reservations.get(pod.meta.name)
        if r is None:
            r = reservation_from_operating_pod(pod)
            # a pod already stamped with a current owner was consumed in a
            # previous incarnation (restart / resync after GC) — register
            # it Succeeded, never as fresh capacity (the annotation exists
            # precisely to make consumption durable, operating_pod.go:36)
            if pod.meta.annotations.get(
                ext.ANNOTATION_RESERVATION_CURRENT_OWNER
            ):
                r.allocated = dict(r.requests)
                self.add(r)
                self._operating[r.meta.name] = pod
                r.node_name = pod.spec.node_name
                self._set_terminal(r, ReservationPhase.SUCCEEDED)
                return r
            self.add(r)
        self._operating[r.meta.name] = pod
        if pod.spec.node_name and r.phase == ReservationPhase.PENDING:
            r.phase = ReservationPhase.AVAILABLE
            r.node_name = pod.spec.node_name
            r.available_time = self._clock()
            self._bump_ledger()
            # the pod's own charge is the hold — pin it against expiry
            if self.scheduler.snapshot.is_assumed(pod.meta.uid):
                self.scheduler.snapshot.confirm_pod(pod.meta.uid)
            self._cycle_candidates = None
        return r

    # ---- scheduling the reserve pods ----

    def _ghost_pod(self, r: Reservation) -> Pod:
        return Pod(
            meta=ObjectMeta(
                name=f"reserve-{r.meta.name}",
                namespace="koordinator-reservation",
                uid=_ghost_uid(r),
            ),
            spec=PodSpec(requests=dict(r.requests), priority=GHOST_PRIORITY),
        )

    def schedule_pending(self) -> int:
        """Run pending reservations through the solver; returns how many
        became Available (reference Bind updates Reservation status
        instead of pod binding, ``plugin.go:849-888``)."""
        pending = [
            r
            for r in self._reservations.values()
            if r.phase == ReservationPhase.PENDING
            # operating-pod reservations become Available through their
            # own pod's bind (ingest_operating_pod), never via a ghost —
            # a ghost here would double-charge and leak a confirmed hold
            and r.meta.name not in self._operating
        ]
        if not pending:
            return 0
        ghosts = {_ghost_uid(r): r for r in pending}
        outcome = self.scheduler.schedule([self._ghost_pod(r) for r in pending])

        self._cycle_candidates = None
        self._bump_ledger()
        for pod, node in outcome.bound:
            r = ghosts[pod.meta.uid]
            r.phase = ReservationPhase.AVAILABLE
            r.node_name = node
            r.available_time = self._clock()
            self._resize_to_allocation(r, pod)
            # the ghost hold's lifecycle is owned here, not by a
            # pod_assumed sync — without confirmation expire_assumed()
            # would silently drop an Available reservation's capacity
            self.scheduler.snapshot.confirm_pod(pod.meta.uid)
        return len(outcome.bound)

    def _resize_to_allocation(self, r: Reservation, ghost: Pod) -> None:
        """ResizePod extension point (reference
        ``frameworkext/framework_extender_factory.go:280-298`` +
        ``deviceshare/plugin.go:519-539``): after Reserve, a reserve pod
        that got a concrete device allocation has its allocatable resized
        to the allocated device resources
        (``UpdateReservePodWithAllocatable`` merge semantics — allocated
        names override, other requests stay). A reservation created with
        ``nvidia.com/gpu: 2`` thereby exposes
        ``koordinator.sh/gpu-memory-ratio: 200`` to owner matching. Gated
        on the ResizePod scheduler feature (``scheduler_features.go``)."""
        import json

        from ...utils.features import SCHEDULER_GATES

        if not SCHEDULER_GATES.enabled("ResizePod"):
            return
        raw = ghost.meta.annotations.get(ext.ANNOTATION_DEVICE_ALLOCATED)
        if not raw:
            return
        try:
            payload = json.loads(raw)
        except (ValueError, TypeError):
            return
        if not isinstance(payload, dict):
            return
        allocated: Dict[str, float] = {}
        for items in payload.values():
            if not isinstance(items, list):
                continue
            for item in items:
                if not isinstance(item, dict):
                    continue
                for name, qty in (item.get("resources") or {}).items():
                    try:
                        allocated[name] = allocated.get(name, 0.0) + float(qty)
                    except (TypeError, ValueError):
                        continue
        self._bump_ledger()  # requests (owner-matching capacity) mutate
        for name, qty in allocated.items():
            r.requests[name] = qty
        if ext.RES_GPU_MEMORY_RATIO in allocated:
            # the allocation IS the GPU capacity in normalized units —
            # keeping the raw nvidia.com/gpu dim too would double the
            # reservation's apparent GPU capacity for owner matching
            # (the reference normalizes GPU requests at PreFilter,
            # deviceshare/plugin.go preparePod)
            r.requests.pop(ext.RES_GPU, None)

    def expire(self, now: Optional[float] = None) -> List[str]:
        """Fail Available reservations past their TTL with no owners,
        releasing their holds. Returns the expired names."""
        now = now if now is not None else self._clock()
        expired: List[str] = []
        for r in list(self._reservations.values()):
            if (
                r.phase == ReservationPhase.AVAILABLE
                and r.ttl_s is not None
                and not r.current_owners
                and r.available_time is not None
                and now - r.available_time > r.ttl_s
            ):
                self.expire_reservation(r.meta.name)
                expired.append(r.meta.name)
        return expired

    # ---- owner matching / allocation ----

    def remaining(
        self, r: Reservation, view: Optional[ResvView] = None
    ) -> Dict[str, float]:
        alloc = r.allocated if view is None else view.allocated_of(r)
        return {
            k: v - alloc.get(k, 0.0) for k, v in r.requests.items()
        }

    def consumed_and_spill(
        self, r: Reservation, pod: Pod, view: Optional[ResvView] = None
    ) -> tuple[Dict[str, float], Dict[str, float]]:
        """Single source of truth for the allocate-policy arithmetic
        (reservation_types.go:78-97): per dim, ``consumed`` is what the
        owner takes FROM the reservation (min(request, remaining) of
        declared dims) and ``spill`` what must come from node free
        capacity (the Aligned overflow plus every undeclared dim). Used
        by candidate matching, the commit headroom check, and the
        allocation charge — they must never diverge."""
        remaining = self.remaining(r, view)
        consumed: Dict[str, float] = {}
        spill: Dict[str, float] = {}
        for k, v in pod.spec.requests.items():
            credit = (
                min(v, max(remaining.get(k, 0.0), 0.0))
                if k in r.requests
                else 0.0
            )
            if credit > 1e-9:
                consumed[k] = credit
            if v - credit > 1e-6:
                spill[k] = v - credit
        return consumed, spill

    def spill_fits_node(
        self,
        r: Reservation,
        spill: Dict[str, float],
        view: Optional[ResvView] = None,
    ) -> bool:
        """Whether the reservation's node has free capacity for the
        owner's spill (beyond every live hold, the ghost included).
        ``view`` substitutes the predicted requested row (the preview's
        node overlay — upstream speculative commits + predicted fast
        binds) for the live snapshot row."""
        if not spill:
            return True
        if r.node_name is None:
            return False
        snap = self.scheduler.snapshot
        idx = snap.node_id(r.node_name)
        if idx is None:
            return False
        import numpy as np

        na = snap.nodes
        requested = (
            na.requested[idx] if view is None else view.node_requested(idx)
        )
        return bool(
            na.schedulable[idx]
            and np.all(
                requested + snap.config.res_vector(spill)
                <= na.allocatable[idx] + 1e-3
            )
        )

    def match(
        self, pod: Pod, view: Optional[ResvView] = None
    ) -> Optional[Reservation]:
        """Nominate the best matching Available reservation for ``pod``
        (reference nominator, ``nominator.go:207-279`` + ``scoring.go``):
        collect every candidate whose owners match and whose remaining
        capacity covers the pod, then (1) a reservation carrying the
        smallest non-zero ``reservation-order`` label wins outright
        (``findMostPreferredReservationByOrder``), else (2) pick the
        highest MostAllocated fit score — mean over the reservation's
        resource dims of ``100·(pod request + already allocated)/
        allocatable`` (``scoreReservation``), i.e. the tightest fit, so
        small pods drain small reservations before fragmenting big ones.
        A pod carrying the reservation-affinity annotation additionally
        restricts the candidate set by name or reservation labels; a pod
        labeled reservation-ignored never matches (reservation.go:97-99).

        ``view`` (open the last gates PR) runs the SAME nomination
        against a pure overlay — predicted phases/allocations/owners and
        predicted node capacity — without touching the live per-cycle
        candidate cache; the pipeline's dispatch-side preview is exactly
        this call, so a preview and the consuming cycle's real match can
        only diverge when the state between them really changed (and the
        consume-time table comparison then discards the speculation).

        State-integrity PR satellite: the per-pod scan is VECTORIZED —
        numpy over the candidate axis for the capacity/spill/score
        arithmetic (the host hot spot at hundreds of live reservations,
        both on the serial drain and the fast-path preview), with the
        candidate matrices cached per (candidate list, ledger version)
        and owner selectors de-duplicated by signature.
        :meth:`_match_scalar` keeps the reference loop; the equivalence
        test holds them decision-identical over randomized populations.
        """
        return self._match_vector(pod, view)

    def _match_scalar(
        self, pod: Pod, view: Optional[ResvView] = None
    ) -> Optional[Reservation]:
        """Reference per-candidate loop (pre-vectorization semantics)."""
        if ext.is_reservation_ignored(pod):
            return None
        affinity = ext.parse_reservation_affinity(pod.meta.annotations)
        exact_names = ext.parse_exact_match_reservation_spec(
            pod.meta.annotations
        )
        best: Optional[Reservation] = None
        best_score = -1.0
        best_order: Optional[int] = None
        for r in (
            self._candidates() if view is None else view.candidates()
        ):
            phase = r.phase if view is None else view.phase_of(r)
            if phase != ReservationPhase.AVAILABLE:
                continue  # consumed earlier in this same cycle
            owners = (
                r.current_owners if view is None else view.owners_of(r)
            )
            if r.allocate_once and owners:
                continue
            if affinity is not None:
                name = affinity.get("name")
                if name:
                    if r.meta.name != name:
                        continue
                else:
                    selector = affinity.get("reservationSelector") or {}
                    if not all(
                        r.meta.labels.get(k) == v for k, v in selector.items()
                    ):
                        continue
            if not matches_owner(r, pod):
                continue
            # exact-match spec: the listed resource names must compare
            # exactly equal between the pod's requests and the
            # reservation's allocatable (transformer.go:122,138)
            if exact_names is not None and not ext.exact_match_reservation(
                pod.spec.requests, r.requests, exact_names
            ):
                continue
            # allocate-policy fit (reference plugin.go:405-415):
            # Restricted — dims the reservation DECLARES must fit within
            # its remaining capacity (fitsReservation, i.e. no spill on a
            # declared dim); Aligned/Default — the pod allocates from the
            # reservation first and may spill to node free capacity. A
            # candidate whose spill cannot fit its node is skipped HERE so
            # a drained-but-preferred reservation can never shadow a
            # feasible one (reviewer finding r3).
            consumed, spill = self.consumed_and_spill(r, pod, view)
            if r.allocate_policy == RESERVATION_ALLOCATE_POLICY_RESTRICTED:
                # restricted-options may narrow WHICH dims are binding
                # (reservation.go:89-96); default = every reserved dim
                restricted = ext.parse_reservation_restricted_resources(
                    r.meta.annotations
                )
                binding = (
                    set(restricted) & set(r.requests)
                    if restricted is not None
                    else set(r.requests)
                )
                if any(k in binding for k in spill):
                    continue
            if not self.spill_fits_node(r, spill, view):
                continue
            order = _reservation_order(r)
            if order is not None:
                if best_order is None or order < best_order:
                    best_order = order
                    best = r
                continue
            if best_order is not None:
                continue  # an ordered candidate always beats scored ones
            score = _score_reservation(
                pod, r, None if view is None else view.allocated_of(r)
            )
            if score > best_score or (
                score == best_score
                and best is not None
                and r.meta.name < best.meta.name
            ):
                best_score = score
                best = r
        return best

    # ---- vectorized nomination (state-integrity PR satellite) ----

    def _nom_arrays_for(self, cands: List[Reservation], view):
        """Candidate matrices for the vectorized scan, cached on
        (candidate list identity, ledger version[, view version]).
        Resource axis = sorted union of the candidates' declared keys;
        numeric dtype float64 end-to-end so every element op reproduces
        the scalar loop's python-float arithmetic bit-exactly."""
        import numpy as np

        if view is None:
            cache = self._nom_cache
            key = (cands, self._ledger_version)
            if cache is not None and cache[0] is key[0] and cache[1] == key[1]:
                return cache[2]
        else:
            cache = view._nom
            key = (cands, self._ledger_version, view.version)
            if (
                cache is not None
                and cache[0] is key[0]
                and cache[1:3] == key[1:3]
            ):
                return cache[3]
        snap = self.scheduler.snapshot
        keys = sorted({k for r in cands for k in r.requests})
        kpos = {k: i for i, k in enumerate(keys)}
        C, K = len(cands), len(keys)
        req = np.zeros((C, K))
        alloc = np.zeros((C, K))
        declared = np.zeros((C, K), bool)
        restricted = np.zeros((C, K), bool)
        node_idx = np.zeros((C,), np.int64)
        alloc_once = np.zeros((C,), bool)
        blocked = np.zeros((C,), bool)  # allocate_once & has owners
        order = np.full((C,), np.inf)
        has_order = np.zeros((C,), bool)
        names = [r.meta.name for r in cands]
        name_rank = np.empty((C,), np.int64)
        name_rank[sorted(range(C), key=lambda i: names[i])] = np.arange(C)
        #: distinct owner-selector signatures -> candidate rows (owner
        #: matching is string work; most fleets share a handful of
        #: selector shapes, so evaluate each ONCE per pod)
        sigs: Dict[tuple, List[int]] = {}
        for c, r in enumerate(cands):
            alloc_src = (
                r.allocated if view is None else view.allocated_of(r)
            )
            owners_src = (
                r.current_owners if view is None else view.owners_of(r)
            )
            for k, v in r.requests.items():
                req[c, kpos[k]] = float(v)
                declared[c, kpos[k]] = True
            for k, v in alloc_src.items():
                if k in kpos:
                    alloc[c, kpos[k]] = float(v)
            idx = (
                snap.node_id(r.node_name)
                if r.node_name is not None
                else None
            )
            node_idx[c] = -1 if idx is None else int(idx)
            alloc_once[c] = bool(r.allocate_once)
            blocked[c] = bool(r.allocate_once and owners_src)
            o = _reservation_order(r)
            if o is not None:
                order[c] = float(o)
                has_order[c] = True
            if r.allocate_policy == RESERVATION_ALLOCATE_POLICY_RESTRICTED:
                opts = ext.parse_reservation_restricted_resources(
                    r.meta.annotations
                )
                binding = (
                    set(opts) & set(r.requests)
                    if opts is not None
                    else set(r.requests)
                )
                for k in binding:
                    restricted[c, kpos[k]] = True
            sig = tuple(
                (
                    o.namespace,
                    tuple(sorted(o.label_selector.items())),
                )
                for o in r.owners
            )
            sigs.setdefault(sig, []).append(c)
        #: union key -> config-resource column (None = not a node dim)
        cfg_col = {
            k: (
                list(snap.config.resources).index(k)
                if k in snap.config.resources
                else None
            )
            for k in keys
        }
        arrays = {
            "cands": cands, "keys": keys, "kpos": kpos,
            "req": req, "alloc": alloc, "declared": declared,
            "restricted": restricted, "node_idx": node_idx,
            "alloc_once": alloc_once, "blocked": blocked,
            "order": order, "has_order": has_order,
            "names": names, "name_rank": name_rank, "sigs": sigs,
            "cfg_col": cfg_col,
        }
        if view is None:
            self._nom_cache = (cands, self._ledger_version, arrays)
        else:
            view._nom = (
                cands, self._ledger_version, view.version, arrays
            )
        return arrays

    @staticmethod
    def _sig_matches(sig: tuple, pod: Pod) -> bool:
        """`matches_owner` over one de-duplicated selector signature."""
        for ns, items in sig:
            if not items and ns is None:
                continue  # an empty owner matches nothing
            if ns is not None and ns != pod.meta.namespace:
                continue
            if all(pod.meta.labels.get(k) == v for k, v in items):
                return True
        return False

    def _match_vector(
        self, pod: Pod, view: Optional[ResvView] = None
    ) -> Optional[Reservation]:
        import numpy as np

        if ext.is_reservation_ignored(pod):
            return None
        cands = self._candidates() if view is None else view.candidates()
        if not cands:
            return None
        A = self._nom_arrays_for(cands, view)
        C = len(cands)
        snap = self.scheduler.snapshot
        # ---- eligibility over the candidate axis ----
        ok = ~A["blocked"]
        if view is not None:
            # predicted phase transitions (consumed earlier this chain)
            for c, r in enumerate(cands):
                if ok[c] and view.phase_of(r) != ReservationPhase.AVAILABLE:
                    ok[c] = False
        else:
            # a candidate consumed earlier in this same cycle flipped
            # terminal, which bumped the ledger version and rebuilt the
            # arrays — but guard against direct phase pokes too
            for c, r in enumerate(cands):
                if ok[c] and r.phase != ReservationPhase.AVAILABLE:
                    ok[c] = False
        affinity = ext.parse_reservation_affinity(pod.meta.annotations)
        if affinity is not None:
            name = affinity.get("name")
            if name:
                ok &= np.fromiter(
                    (n == name for n in A["names"]), bool, count=C
                )
            else:
                selector = affinity.get("reservationSelector") or {}
                for c, r in enumerate(cands):
                    if ok[c] and not all(
                        r.meta.labels.get(k) == v
                        for k, v in selector.items()
                    ):
                        ok[c] = False
        exact_names = ext.parse_exact_match_reservation_spec(
            pod.meta.annotations
        )
        if exact_names is not None:
            for c, r in enumerate(cands):
                if ok[c] and not ext.exact_match_reservation(
                    pod.spec.requests, r.requests, exact_names
                ):
                    ok[c] = False
        # owner matching, one evaluation per distinct selector signature
        owner_ok = np.zeros((C,), bool)
        for sig, rows in A["sigs"].items():
            if self._sig_matches(sig, pod):
                owner_ok[rows] = True
        ok &= owner_ok
        if not ok.any():
            return None
        # ---- allocate-policy arithmetic, vectorized ----
        # (same element ops as consumed_and_spill: float64 min/max/cmp,
        # so filter decisions are bit-identical to the scalar loop)
        keys, kpos = A["keys"], A["kpos"]
        pod_vec = np.zeros((len(keys),))
        extra_spill: Dict[str, float] = {}
        for k, v in pod.spec.requests.items():
            if k in kpos:
                pod_vec[kpos[k]] = float(v)
            elif float(v) > 1e-6:
                extra_spill[k] = float(v)  # undeclared everywhere
        remaining = A["req"] - A["alloc"]
        credit = np.minimum(
            pod_vec[None, :], np.maximum(remaining, 0.0)
        ) * A["declared"]
        spill = pod_vec[None, :] - credit
        spill[spill <= 1e-6] = 0.0
        # Restricted: no spill on a binding dim
        ok &= ~((spill > 0.0) & A["restricted"]).any(axis=1)
        # ---- node-fit for the spill (live node rows; view deltas) ----
        has_spill = spill.any(axis=1) | bool(extra_spill)
        need = ok & has_spill
        if need.any():
            na = snap.nodes
            idxs = A["node_idx"]
            valid = idxs >= 0
            ok &= valid | ~has_spill
            need &= valid
            if need.any():
                D = len(snap.config.resources)
                spill_cfg = np.zeros((C, D), np.float32)
                for k, col in A["cfg_col"].items():
                    if col is not None:
                        spill_cfg[:, col] += spill[:, kpos[k]].astype(
                            np.float32
                        )
                if extra_spill:
                    extra_vec = snap.config.res_vector(extra_spill)
                    spill_cfg += extra_vec[None, :]
                rows = idxs[need]
                fits = np.zeros((C,), bool)
                fits[need] = na.schedulable[rows] & np.all(
                    na.requested[rows] + spill_cfg[need]
                    <= na.allocatable[rows] + 1e-3,
                    axis=1,
                )
                if view is not None and view.node_req:
                    # patch the few overlaid rows with predicted deltas
                    for c in np.nonzero(need)[0]:
                        delta = view.node_req.get(int(idxs[c]))
                        if delta is None:
                            continue
                        fits[c] = bool(
                            na.schedulable[idxs[c]]
                            and np.all(
                                na.requested[idxs[c]]
                                + delta
                                + spill_cfg[c]
                                <= na.allocatable[idxs[c]] + 1e-3
                            )
                        )
                ok &= fits | ~has_spill
        if not ok.any():
            return None
        # ---- order label dominates; else MostAllocated score ----
        ordered = ok & A["has_order"]
        if ordered.any():
            vals = np.where(ordered, A["order"], np.inf)
            return cands[int(np.argmin(vals))]  # first index on ties
        cap = A["req"]
        pos = A["declared"] & (cap > 0.0)
        denom = pos.sum(axis=1)
        req_tot = pod_vec[None, :] + A["alloc"]
        with np.errstate(divide="ignore", invalid="ignore"):
            term = np.where(
                pos & (req_tot <= cap + 1e-6),
                100.0 * np.minimum(req_tot, cap) / np.where(
                    cap > 0.0, cap, 1.0
                ),
                0.0,
            )
        score = np.where(denom > 0, term.sum(axis=1), 0.0) / np.maximum(
            denom, 1
        )
        score = np.where(ok, score, -np.inf)
        best = score.max()
        tied = np.nonzero(score == best)[0]
        # exact-equality tie-break: lexicographically smallest name
        return cands[int(tied[np.argmin(A["name_rank"][tied])])]

    def begin_cycle(self) -> None:
        """Cache the Available candidate set for one scheduling cycle
        (r1 weak item: the per-pod ``match`` scan re-checked phase and
        node liveness for EVERY reservation on EVERY pod — with a large
        reservation population that was a host hot spot in exactly the
        regime the TPU rebuild wins). Dead-node reservations are failed
        here, once."""
        candidates: List[Reservation] = []
        for r in self._reservations.values():
            if r.phase != ReservationPhase.AVAILABLE or r.node_name is None:
                continue
            if self.scheduler.snapshot.node_id(r.node_name) is None:
                # node removed from the cluster: the ghost hold died with
                # it (remove_node purges assumed pods) — fail the
                # reservation instead of nominating a dead node
                self._set_terminal(r, ReservationPhase.FAILED)
                continue
            candidates.append(r)
        self._cycle_candidates = candidates
        self._cycle_epoch = self.scheduler.snapshot.node_epoch

    def _candidates(self) -> List[Reservation]:
        """The cycle cache, rebuilt whenever the snapshot's node topology
        changed since it was built (node_epoch): a direct ``match()``
        after a node-remove delta must never nominate a dead node, and
        the common path pays zero per-pod re-validation."""
        if (
            self._cycle_candidates is None
            or self._cycle_epoch != self.scheduler.snapshot.node_epoch
        ):
            self.begin_cycle()
        return self._cycle_candidates

    def _preview_candidates(self, view: ResvView) -> List[Reservation]:
        """Pure analog of :meth:`_candidates` for the pipeline preview:
        Available (per the view's predicted phases) reservations on live
        nodes. Dead-node reservations are SKIPPED, never failed — the
        terminal transition belongs to the consuming cycle's
        ``begin_cycle`` (and a removed node bumps ``node_epoch``, which
        discards the speculation before any prediction here matters)."""
        snap = self.scheduler.snapshot
        return [
            r
            for r in self._reservations.values()
            if view.phase_of(r) == ReservationPhase.AVAILABLE
            and r.node_name is not None
            and snap.node_id(r.node_name) is not None
        ]

    def has_available(self) -> bool:
        """Any Available reservation at all — the cheap speculation-gate
        input: with none, the fast path cannot bind and a preview is
        trivially empty (NUMA/device ghost-hold swaps unreachable)."""
        return any(
            r.phase == ReservationPhase.AVAILABLE
            for r in self._reservations.values()
        )

    def is_operating_backed(self, name: str) -> bool:
        return name in self._operating

    def table_view(self, view: Optional[ResvView] = None) -> tuple:
        """Canonical by-value lowering of the reservation ledger —
        phase, node, requests, allocated, owners and the owner-request
        ledger per reservation, name-sorted. This is what the pipeline's
        consume-time validation compares: the dispatch-time table, the
        predicted post-fast-path table (``view`` applies the preview's
        overlays) and the live table after the real fast path ran must
        all line up bit-exactly or the speculation is discarded —
        allocated values are produced by the same float arithmetic on
        both sides, so equality is exact, not approximate."""
        out = []
        for name in sorted(self._reservations):
            r = self._reservations[name]
            if view is None:
                phase, alloc, owners = r.phase, r.allocated, r.current_owners
                ledger = self._owner_requests.get(name, {})
            else:
                phase = view.phase_of(r)
                alloc = view.allocated_of(r)
                owners = view.owners_of(r)
                ledger = view.ledger.get(
                    name, self._owner_requests.get(name, {})
                )
            out.append((
                name,
                phase.value,
                r.node_name,
                bool(r.allocate_once),
                tuple(sorted((k, float(v)) for k, v in r.requests.items())),
                tuple(sorted((k, float(v)) for k, v in alloc.items())),
                tuple(owners),
                tuple(sorted(
                    (uid, tuple(sorted((k, float(v)) for k, v in c.items())))
                    for uid, c in ledger.items()
                )),
            ))
        return tuple(out)

    def preview_allocate(
        self, reservation: Reservation, pod: Pod, view: ResvView
    ) -> List[tuple]:
        """Pure mirror of :meth:`allocate` against the overlay view: the
        predicted ledger mutations land in ``view`` and the predicted
        SNAPSHOT effects (ghost forget, remainder-ghost assume) are
        returned as ``(node_idx, d_requested, d_estimated, d_prod)``
        delta rows for the dispatch to fold into the chained node table.
        Callers must have refused operating-pod-backed reservations and
        NUMA/device-bearing configs already (their ghost-hold swaps are
        host-allocator decisions a pure preview cannot reproduce).
        Divergence between this arithmetic and the real ``allocate`` is
        caught by the consume-time ``table_view`` comparison — the
        predicted post table is built HERE, the actual one by the real
        call, and a kept speculation requires them equal."""
        import numpy as np

        assert reservation.meta.name not in self._operating
        view.version += 1
        view._nom = None
        snap = self.scheduler.snapshot
        node = reservation.node_name
        idx = snap.node_id(node)
        assert idx is not None
        name = reservation.meta.name
        consumed, _spill = self.consumed_and_spill(reservation, pod, view)
        alloc = view._alloc_mut(reservation)
        for k, take in consumed.items():
            alloc[k] = alloc.get(k, 0.0) + take
        view._owners_mut(reservation).append(pod.meta.uid)
        view._ledger_mut(name)[pod.meta.uid] = dict(consumed)
        deltas: List[tuple] = []
        # the full ghost hold is forgotten (allocate's snap.forget_pod)
        hold_uid = _ghost_uid(reservation)
        entry = view.assumed_entry(hold_uid)
        if entry is not None:
            req, est, is_prod = entry
            d_est = np.zeros_like(req) if est is None else -est
            deltas.append((
                idx, -req, d_est, d_est if is_prod else np.zeros_like(req)
            ))
            view.add_node_delta(idx, -req)
        view.assumed[hold_uid] = None
        if reservation.allocate_once:
            view.allocated[name] = dict(reservation.requests)
            view.phase[name] = ReservationPhase.SUCCEEDED
        else:
            ghost = self._remainder_ghost(reservation, view)
            if ghost.spec.requests:
                # assume_pod(ghost, node): request = estimate = the
                # remainder vector, no CPU-bind amplification (ghosts
                # carry no bind annotation), prod band per GHOST_PRIORITY
                vec = snap.config.res_vector(ghost.spec.requests)
                is_prod = (
                    ghost.priority_class == ext.PriorityClass.PROD
                )
                deltas.append((
                    idx, vec, vec, vec if is_prod else np.zeros_like(vec)
                ))
                view.add_node_delta(idx, vec)
                view.assumed[hold_uid] = (vec, vec, is_prod)
        return deltas

    def release_ghost_holds(self, reservation: Reservation) -> None:
        """Release the ghost's per-winner NUMA/device allocations (the
        reservation's reserved cpuset + device minors). Called before an
        owner pod's own Reserve so it can take the freed minors — the
        reference restores reserved device resources into the node state
        for owners the same way (deviceshare Reservation hooks)."""
        node = reservation.node_name
        if node is None:
            return
        uid = self._hold_uid(reservation)
        if getattr(self.scheduler, "devices", None) is not None:
            self.scheduler.devices.release(uid, node)
        if getattr(self.scheduler, "numa", None) is not None:
            self.scheduler.numa.release(uid, node)

    def _remainder_ghost(
        self, reservation: Reservation, view: Optional[ResvView] = None
    ) -> Pod:
        """Ghost pod sized to the reservation's unconsumed remainder."""
        ghost = self._ghost_pod(reservation)
        ghost.spec.requests = {
            k: v
            for k, v in self.remaining(reservation, view).items()
            if v > 1e-6
        }
        return ghost

    def reacquire_ghost_holds(self, reservation: Reservation) -> None:
        """Strict inverse of ``release_ghost_holds`` after a failed owner
        commit: re-take the NUMA/device holds the ghost actually had. A
        partially-consumed reservation holds none (``allocate`` does not
        re-hold device/NUMA remainders — see its docstring), so this is a
        no-op once any owner has allocated. The scheduling cycle is
        single-threaded, so re-taking the just-released capacity (the
        owner's partial allocations were rolled back first) succeeds."""
        node = reservation.node_name
        if node is None or reservation.current_owners:
            return
        ghost = self._remainder_ghost(reservation)
        # re-take under the SAME uid release_ghost_holds released —
        # the operating pod's own uid when the reservation is a pod
        ghost.meta.uid = self._hold_uid(reservation)
        if getattr(self.scheduler, "numa", None) is not None:
            self.scheduler.numa.allocate(ghost, node)
        if getattr(self.scheduler, "devices", None) is not None:
            self.scheduler.devices.allocate(ghost, node)

    def allocate(self, reservation: Reservation, pod: Pod) -> str:
        """Commit a pod against a reservation.

        The full ghost hold is forgotten, the pod is assumed normally by
        the caller, and (unless AllocateOnce) a new ghost hold is assumed
        for the remainder — all through the snapshot's assume/forget API so
        node accounting stays consistent. Device/NUMA remainders are NOT
        re-held: a reservation carrying device minors is consumed whole
        (AllocateOnce semantics, the device-reservation mode the reference
        migration path uses). Returns the node name."""
        node = reservation.node_name
        assert node is not None
        snap = self.scheduler.snapshot
        self.release_ghost_holds(reservation)
        # The owner consumes min(request, remaining) of each dim the
        # reservation DECLARES (Aligned/Restricted alike — the Aligned
        # spill beyond remaining, and any undeclared dim, is the pod's
        # own node charge, headroom-checked by the commit path).
        consumed, _spill = self.consumed_and_spill(reservation, pod)
        self._bump_ledger()
        for k, take in consumed.items():
            reservation.allocated[k] = reservation.allocated.get(k, 0.0) + take
        reservation.current_owners.append(pod.meta.uid)
        # stamp WHICH reservation the pod allocated from (reference
        # SetReservationAllocated at PreBind, reservation.go:121-128)
        pod.meta.annotations[ext.ANNOTATION_RESERVATION_ALLOCATED] = (
            '{"name": "%s"}' % reservation.meta.name
        )
        # the ledger records what was taken FROM the reservation — the
        # drift refund restores exactly this much
        self._owner_requests.setdefault(reservation.meta.name, {})[
            pod.meta.uid
        ] = consumed
        op = self._operating.get(reservation.meta.name)
        if op is not None and snap.is_assumed(op.meta.uid):
            # The RUNNING placeholder's physical footprint does not shrink
            # because a (possibly smaller) owner consumed the reservation —
            # the reference keeps the reserve pod charged and discounts the
            # owner inside the reservation. Keep the node charged
            # max(placeholder, owner): swap the pod's full assume for the
            # remainder the owners do not cover; that remainder frees only
            # when the placeholder pod itself is forgotten/deleted.
            remainder = {
                k: v - reservation.allocated.get(k, 0.0)
                for k, v in reservation.requests.items()
                if v - reservation.allocated.get(k, 0.0) > 1e-6
            }
            snap.forget_pod(op.meta.uid)
            if remainder:
                vec = snap.config.res_vector(remainder)
                snap.assume_pod(op, node, vec, confirmed=True, request=vec)
        else:
            snap.forget_pod(self._hold_uid(reservation))
        if op is not None:
            # record the allocation on the operating pod
            # (AnnotationReservationCurrentOwner, operating_pod.go:36)
            import json as _json

            op.meta.annotations[ext.ANNOTATION_RESERVATION_CURRENT_OWNER] = (
                _json.dumps(
                    {"namespace": pod.meta.namespace, "name": pod.meta.name}
                )
            )
        if reservation.allocate_once:
            reservation.allocated = dict(reservation.requests)
            self._set_terminal(reservation, ReservationPhase.SUCCEEDED)
        else:
            ghost = self._remainder_ghost(reservation)
            if ghost.spec.requests:
                snap.assume_pod(ghost, node)
        return node

    def remove_operating_pod(self, pod_name: str) -> None:
        """Ingest the deletion of a Reservation-operating-mode pod: its
        physical footprint is gone, so its charge (full or remainder) and
        its NUMA/device holds are dropped, and a still-open reservation it
        backed is failed (the pod was the capacity). Live owners keep
        their own assumes — the node charge degrades from
        max(placeholder, owners) to sum(owners) exactly at pod death."""
        op = self._operating.pop(pod_name, None)
        if op is None:
            return
        snap = self.scheduler.snapshot
        r = self._reservations.get(pod_name)
        node = r.node_name if r is not None else op.spec.node_name
        snap.forget_pod(op.meta.uid)
        if node is not None:
            if getattr(self.scheduler, "devices", None) is not None:
                self.scheduler.devices.release(op.meta.uid, node)
            if getattr(self.scheduler, "numa", None) is not None:
                self.scheduler.numa.release(op.meta.uid, node)
        if r is not None and r.phase in (
            ReservationPhase.PENDING,
            ReservationPhase.AVAILABLE,
        ):
            self._set_terminal(r, ReservationPhase.FAILED)
            self._cycle_candidates = None

    def expire_reservation(self, name: str) -> bool:
        """Explicitly fail/expire a reservation, releasing its hold."""
        r = self._reservations.get(name)
        if r is None or r.phase not in (
            ReservationPhase.PENDING,
            ReservationPhase.AVAILABLE,
        ):
            return False
        if r.phase == ReservationPhase.AVAILABLE:
            if r.meta.name in self._operating:
                # pod-backed hold: the placeholder pod is still RUNNING on
                # the node — forgetting its charge (or freeing its cpuset/
                # minors) would advertise phantom capacity the kubelet is
                # still committing. Expiry only stops the reservation from
                # matching; the charge lives until the pod itself goes.
                pass
            else:
                self.release_ghost_holds(r)
                self.scheduler.snapshot.forget_pod(self._hold_uid(r))
        self._set_terminal(r, ReservationPhase.FAILED)
        return True

    def _set_terminal(self, r: Reservation, phase: ReservationPhase) -> None:
        # callers only transition from non-terminal phases, so overwrite —
        # setdefault would keep a GC'd-then-recreated name's old clock
        r.phase = phase
        self._terminal_time[r.meta.name] = self._clock()
        self._bump_ledger()

    def sync(self, now: Optional[float] = None) -> Dict[str, List[str]]:
        """The reservation controller's periodic sweep (reference
        ``plugins/reservation/controller/``): expire TTL'd reservations,
        reconcile owner drift, and garbage-collect terminal ones.

        Owner drift (``controller.go:221-260`` syncStatus): an owner pod
        that vanished (no longer assumed in the snapshot) refunds its
        allocation, and the freed remainder is re-held by the ghost so
        other pods can't steal reserved capacity.

        GC (``garbage_collection.go:38-55``): Failed/Succeeded
        reservations older than ``gc_duration_s`` are deleted.
        Returns {"expired": [...], "drifted": [...], "deleted": [...]}."""
        now = now if now is not None else self._clock()
        report: Dict[str, List[str]] = {
            "expired": self.expire(now),
            "drifted": [],
            "deleted": [],
        }
        snap = self.scheduler.snapshot
        for r in self._reservations.values():
            if r.phase != ReservationPhase.AVAILABLE or not r.current_owners:
                continue
            gone = [u for u in r.current_owners if not snap.is_assumed(u)]
            if not gone:
                continue
            ledger = self._owner_requests.get(r.meta.name, {})
            for uid in gone:
                refund = ledger.pop(uid, {})
                for k, v in refund.items():
                    r.allocated[k] = max(r.allocated.get(k, 0.0) - v, 0.0)
                r.current_owners.remove(uid)
                # the dead owner's exact device/NUMA holds must free too —
                # match() re-offers this capacity, and a stuck minor would
                # fail every future owner's Reserve (the eviction path
                # releases the same four holds)
                if getattr(self.scheduler, "devices", None) is not None:
                    self.scheduler.devices.release(uid, r.node_name)
                if getattr(self.scheduler, "numa", None) is not None:
                    self.scheduler.numa.release(uid, r.node_name)
            # re-hold the freed remainder so it stays reserved
            snap.forget_pod(_ghost_uid(r))  # ghost remainder, never the
            # operating pod itself (its consumption forgot it already)
            ghost = self._remainder_ghost(r)
            if ghost.spec.requests:
                snap.assume_pod(ghost, r.node_name)
            report["drifted"].append(r.meta.name)
            self._cycle_candidates = None
            self._bump_ledger()
        # pod-backed SUCCEEDED reservations: an owner that died before the
        # still-RUNNING placeholder must re-expand the placeholder's charge
        # — without this, owner death leaves the node charged only the
        # remainder while the kubelet still commits the full placeholder
        # (the max(placeholder, owners) invariant, reviewer finding r3)
        # (the placeholder is presumed RUNNING until its delete is
        # ingested via remove_operating_pod — after full consumption it
        # holds no assume, so is_assumed can't be the liveness signal)
        for name, op in list(self._operating.items()):
            r = self._reservations.get(name)
            if (
                r is None
                or r.phase != ReservationPhase.SUCCEEDED
                or r.node_name is None
            ):
                continue
            ledger = self._owner_requests.get(name, {})
            gone = [u for u in ledger if not snap.is_assumed(u)]
            if not gone:
                continue
            for uid in gone:
                ledger.pop(uid, None)
                if uid in r.current_owners:
                    r.current_owners.remove(uid)
            remainder = dict(r.requests)
            for owner_req in ledger.values():
                for k, v in owner_req.items():
                    remainder[k] = remainder.get(k, 0.0) - v
            remainder = {k: v for k, v in remainder.items() if v > 1e-6}
            snap.forget_pod(op.meta.uid)
            if remainder:
                vec = snap.config.res_vector(remainder)
                snap.assume_pod(
                    op, r.node_name, vec, confirmed=True, request=vec
                )
            report["drifted"].append(name)
        for name, t0 in list(self._terminal_time.items()):
            r = self._reservations.get(name)
            if r is None:
                del self._terminal_time[name]
                continue
            if r.phase in (
                ReservationPhase.FAILED,
                ReservationPhase.SUCCEEDED,
            ) and now - t0 > self.gc_duration_s:
                del self._reservations[name]
                del self._terminal_time[name]
                self._owner_requests.pop(name, None)
                self._operating.pop(name, None)
                self._cycle_candidates = None
                self._bump_ledger()
                report["deleted"].append(name)
        return report
