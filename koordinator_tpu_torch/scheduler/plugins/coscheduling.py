"""Coscheduling (gang) host-side manager.

Rebuild of the reference Coscheduling plugin's control-plane half
(``pkg/scheduler/plugins/coscheduling/``): the PodGroupManager tracks gangs
(PodGroup CRD or ``pod-group.scheduling.sigs.k8s.io`` labels), gates pods at
PreEnqueue until minMember members exist (``core/core.go:183-263``), keeps
gang members adjacent in the pending queue so they land in the same solver
batch (the NextPod semantics, ``core/core.go:135-176``), and enforces
all-or-nothing at Permit (``core/core.go:346-465``).

The data-plane half — rejecting under-filled gangs and rolling their
capacity back — runs inside the solver (``ops.solver.enforce_gangs``).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from ...api import extension as ext
from ...api.types import Pod, PodGroup


def gang_key_of(pod: Pod) -> Optional[str]:
    # memoized on the pod: gang membership is fixed at pod creation
    # (the reference parses it once at gang creation, gang.go:128-132)
    # and this accessor runs several times per pod per cycle on the hot
    # commit path
    try:
        return pod._gang_key
    except AttributeError:
        pass
    gang = pod.meta.annotations.get(
        ext.ANNOTATION_GANG_NAME
    ) or pod.meta.labels.get(ext.LABEL_GANG_NAME)
    key = None if not gang else f"{pod.meta.namespace}/{gang}"
    pod._gang_key = key
    return key


def gang_group_of(pod: Pod, own_key: str) -> frozenset:
    """The gang group this pod's gang belongs to: the gang-groups
    annotation lists gang keys ("ns/name") that Permit treats atomically
    (reference ``apis/extension/coscheduling.go`` AnnotationGangGroups).
    Always includes the pod's own gang."""
    raw = pod.meta.annotations.get(ext.ANNOTATION_GANG_GROUPS)
    keys = {own_key}
    if raw:
        try:
            for item in json.loads(raw):
                keys.add(str(item))
        except (ValueError, TypeError):
            pass
    return frozenset(keys)


def explicit_match_policy(annotations: Mapping[str, str]) -> Optional[str]:
    """The match-policy annotation value if present and valid, else None —
    an *absent* annotation must not reset a gang whose policy was already
    declared (by the PodGroup CRD or another member)."""
    policy = annotations.get(
        ext.ANNOTATION_GANG_MATCH_POLICY
    ) or annotations.get(ext.ANNOTATION_ALIAS_GANG_MATCH_POLICY)
    if policy in (
        ext.GANG_MATCH_ONLY_WAITING,
        ext.GANG_MATCH_WAITING_AND_RUNNING,
        ext.GANG_MATCH_ONCE_SATISFIED,
    ):
        return policy
    return None


def match_policy_of(pod: Pod) -> str:
    """Gang match policy from the pod annotation (or its sig-scheduling
    alias), default once-satisfied (reference
    ``apis/extension/coscheduling.go:86-93`` GetGangMatchPolicy)."""
    return (
        explicit_match_policy(pod.meta.annotations)
        or ext.GANG_MATCH_ONCE_SATISFIED
    )


@dataclasses.dataclass
class _GangState:
    #: None = minMember unknown (label-only gang without min-available):
    #: all-or-nothing over whichever members are present in the batch.
    min_member: Optional[int]
    create_time: float
    schedule_timeout_s: float
    #: uids of pending members currently known (rebuilt every cycle)
    pending: Dict[str, Pod] = dataclasses.field(default_factory=dict)
    #: uids of members already bound
    bound: int = 0
    #: which member states count toward satisfaction
    match_policy: str = ext.GANG_MATCH_ONCE_SATISFIED
    #: whether the policy was explicitly declared (CRD or first declaring
    #: member) — once declared, later member annotations cannot flip it
    policy_declared: bool = False
    #: failure handling (AnnotationGangMode): Strict rolls the gang group
    #: back on a member failure, NonStrict keeps placed members. Parsed
    #: once at gang creation (CRD or first member), like match_policy.
    mode: str = ext.GANG_MODE_STRICT
    mode_declared: bool = False
    #: declared total children (AnnotationGangTotalNum, ≥ minMember when
    #: both set; None = defaults to minMember per gang.go:114-125)
    total_num: Optional[int] = None
    #: sticky once-satisfied flag (reference ``gang.go:435-459``
    #: setResourceSatisfied, set by Permit allow and addBoundPod)
    satisfied: bool = False

    def effective_min(self, fallback: int) -> int:
        return self.min_member if self.min_member is not None else fallback

    @property
    def bound_credit(self) -> int:
        """Bound members counting toward satisfaction: the only-waiting
        policy counts waiting (this batch's placements) alone
        (``gang.go:492-494`` — satisfaction from WaitingForBindChildren
        only)."""
        return 0 if self.match_policy == ext.GANG_MATCH_ONLY_WAITING else self.bound

    @property
    def once_satisfied(self) -> bool:
        return (
            self.match_policy == ext.GANG_MATCH_ONCE_SATISFIED and self.satisfied
        )


class _MinMemberView:
    """Read-through ``Mapping``-shaped view over live gang state (only
    ``get``/``__getitem__``/``__contains__`` are needed by build_pods)."""

    __slots__ = ("_gangs",)

    def __init__(self, gangs: Dict[str, _GangState]):
        self._gangs = gangs

    def get(self, key, default=None):
        s = self._gangs.get(key)
        if s is None:
            return default
        if s.once_satisfied:
            return 0
        if s.min_member is None:
            return default
        return max(s.min_member - s.bound_credit, 0)

    def __getitem__(self, key):
        v = self.get(key)
        if v is None:
            raise KeyError(key)
        return v

    def __contains__(self, key):
        return self.get(key) is not None

    def __bool__(self):
        return True


class _NonStrictView:
    """Read-through view for declared gang modes (see _MinMemberView)."""

    __slots__ = ("_gangs",)

    def __init__(self, gangs: Dict[str, _GangState]):
        self._gangs = gangs

    def get(self, key, default=None):
        s = self._gangs.get(key)
        if s is None or not s.mode_declared:
            return default
        return s.mode == ext.GANG_MODE_NONSTRICT

    def __getitem__(self, key):
        v = self.get(key)
        if v is None:
            raise KeyError(key)
        return v

    def __contains__(self, key):
        return self.get(key) is not None

    def __bool__(self):
        return True


class PodGroupManager:
    """Tracks gangs and decides scheduling eligibility."""

    def __init__(self, default_timeout_s: float = 600.0):
        self._gangs: Dict[str, _GangState] = {}
        self.default_timeout_s = default_timeout_s

    def upsert_pod_group(self, pg: PodGroup) -> None:
        key = f"{pg.meta.namespace}/{pg.meta.name}"
        state = self._gangs.get(key)
        if state is None:
            state = _GangState(
                min_member=pg.min_member,
                create_time=time.time(),
                schedule_timeout_s=pg.schedule_timeout_s,
            )
            self._gangs[key] = state
        else:
            state.min_member = pg.min_member
            state.schedule_timeout_s = pg.schedule_timeout_s
        # the PodGroup CRD's own annotation declares the policy for the
        # whole gang with final authority (reference GangFromPodGroupCrd);
        # once declared, member annotations are ignored
        explicit = explicit_match_policy(pg.meta.annotations)
        if explicit is not None:
            state.match_policy = explicit
            state.policy_declared = True
        if ext.ANNOTATION_GANG_MODE in pg.meta.annotations:
            state.mode = ext.gang_mode_of(pg.meta.annotations)
            state.mode_declared = True

    def _gang_for_pod(self, key: str, pod: Pod) -> _GangState:
        state = self._gangs.get(key)
        if state is None:
            # native annotation protocol first (gang.go:100-175
            # tryInitByPodConfig): min-available, waiting-time (Go
            # duration; illegal → default), total-number (clamped to
            # ≥ minMember)
            min_member = ext.gang_min_available_of(pod)
            wait = ext.parse_duration_s(
                pod.meta.annotations.get(ext.ANNOTATION_GANG_WAIT_TIME)
            )
            total: Optional[int] = None
            raw_total = pod.meta.annotations.get(
                ext.ANNOTATION_GANG_TOTAL_NUM
            )
            if raw_total is not None:
                try:
                    total = int(raw_total)
                except ValueError:
                    total = None
            if total is not None and min_member is not None:
                total = max(total, min_member)
            state = _GangState(
                min_member=min_member,
                create_time=time.time(),
                schedule_timeout_s=(
                    wait if wait is not None else self.default_timeout_s
                ),
                total_num=total,
            )
            self._gangs[key] = state
        # the FIRST member to register pins the gang's policy (its explicit
        # annotation, else the once-satisfied default) — the reference
        # parses the policy once at gang creation (from the CRD or the
        # first pod), so a differently-annotated straggler can never flip
        # an established gang's policy mid-lifecycle (last-writer-wins was
        # an advisor finding); the CRD annotation retains authority via
        # upsert_pod_group.
        if not state.policy_declared:
            state.match_policy = match_policy_of(pod)
            state.policy_declared = True
        if not state.mode_declared:
            state.mode = ext.gang_mode_of(pod.meta.annotations)
            state.mode_declared = True
        return state

    def begin_cycle(self, pending: Sequence[Pod]) -> None:
        """Rebuild gang pending membership from the live pending set so
        deleted/ghost members don't count forever, then register the
        current pods."""
        for state in self._gangs.values():
            state.pending.clear()
        for pod in pending:
            self.add_pending_pod(pod)

    def add_pending_pod(self, pod: Pod) -> None:
        key = gang_key_of(pod)
        if key is None:
            return
        self._gang_for_pod(key, pod).pending[pod.meta.uid] = pod

    def remove_pod(self, pod: Pod, bound: bool) -> None:
        key = gang_key_of(pod)
        if key is None:
            return
        state = self._gangs.get(key)
        if state is None:
            return
        state.pending.pop(pod.meta.uid, None)
        if bound:
            # PostBind (core/core.go:429-441 addBoundPod): record the bound
            # member and mark the gang once-satisfied — any bind implies
            # Permit already allowed the whole gang (gang.go:456-459)
            state.bound += 1
            state.satisfied = True

    @property
    def has_gangs(self) -> bool:
        """Whether any gang state exists — callers combine this with their
        own batch-lowered gang signal to skip Permit entirely (see
        ``permit``'s internal bypass, which stays the source of truth for
        correctness when called)."""
        return bool(self._gangs)

    def pre_enqueue(self, pod: Pod, now: Optional[float] = None) -> Tuple[bool, str]:
        """Gate: a gang pod may enter scheduling only once the gang has at
        least minMember known members (pending + bound), reference
        ``core/core.go:183-263``. A gang stuck past its schedule timeout is
        gated for one cycle and its clock reset (the reference's Permit
        timeout rejects the gang group and re-queues it with backoff)."""
        key = gang_key_of(pod)
        if key is None:
            return True, ""
        state = self._gang_for_pod(key, pod)
        return self._gate(key, state, pod, now if now is not None else time.time())

    def _gate(
        self, key: str, state: _GangState, pod: Pod, now: float
    ) -> Tuple[bool, str]:
        """Per-member eligibility against already-resolved gang state."""
        # once-satisfied gangs pass directly (core/core.go:199-201):
        # stragglers and restarted members schedule individually
        if state.once_satisfied:
            return True, ""
        if (
            state.bound_credit < state.effective_min(len(state.pending))
            and now - state.create_time > state.schedule_timeout_s
        ):
            state.create_time = now
            # the scheduler stamps the timeout annotation on the member
            # (AnnotationGangTimeout, coscheduling.go:48-50) so operators
            # and controllers can see WHY the gang is cycling
            pod.meta.annotations[ext.ANNOTATION_GANG_TIMEOUT] = "true"
            return False, f"gang {key} timed out; backing off one cycle"
        total = len(state.pending) + state.bound_credit
        need = state.effective_min(total)
        if total < need:
            return False, f"gang {key} has {total}/{need} members"
        return True, ""

    def batch_gangs_warm(self, batch: Sequence[Pod]) -> bool:
        """Whether every gang-labeled pod in ``batch`` belongs to a WARM
        gang — the cross-cycle pipeline's ``batch_gangs`` gate (open the
        speculation gates PR). Warm means the gang's satisfaction verdict
        is derivable from the batch alone and a speculative prepare is
        harmless:

        * a known once-satisfied gang (stragglers schedule individually);
        * a gang — known or first-seen — whose minMember is met by this
          batch's members plus already-bound credit;
        * and, for known gangs, NOT currently past its schedule timeout
          (the timeout branch of ``_gate`` mutates state and stamps the
          member, which a discarded speculation must never double-run).

        Read-only: unlike ``begin_and_order`` this registers nothing, so
        the PUMP thread can evaluate it before deciding whether the
        prepare worker may touch the batch. Cold gangs (members missing)
        simply keep the gate closed — the serial cycle gates them like
        before."""
        members: Dict[str, int] = {}
        first: Dict[str, Pod] = {}
        for pod in batch:
            key = gang_key_of(pod)
            if key is None:
                continue
            members[key] = members.get(key, 0) + 1
            first.setdefault(key, pod)
        if not members:
            return True
        now = time.time()
        for key, count in members.items():
            state = self._gangs.get(key)
            if state is None:
                # first sight of the gang: warm iff the batch itself
                # carries min-available (else unknowable) and meets it
                mm = ext.gang_min_available_of(first[key])
                if mm is None or count < mm:
                    return False
                continue
            if state.once_satisfied:
                continue
            need = state.effective_min(count)
            if (
                state.bound_credit < need
                and now - state.create_time > state.schedule_timeout_s
            ):
                return False
            if count + state.bound_credit < need:
                return False
        return True

    def gang_view(self, batch: Sequence[Pod]) -> tuple:
        """Frozen per-gang lowering inputs for ``batch``, exactly as
        ``build_pods`` would read them through the live
        :meth:`min_member_map` / :meth:`nonstrict_map` views: one
        ``(key, outstanding_min, nonstrict)`` triple per distinct gang.
        The pipeline stamps this on a speculative solve at lowering time
        and re-derives it at consume — a mid-pipeline change (a member
        bound by the trailing commit shrinking the outstanding min, a
        mode declaration arriving) makes the views diverge and the
        speculation is discarded instead of consumed with stale gang
        rows."""
        mm = _MinMemberView(self._gangs)
        ns = _NonStrictView(self._gangs)
        seen = []
        done = set()
        for pod in batch:
            key = gang_key_of(pod)
            if key is None or key in done:
                continue
            done.add(key)
            seen.append((key, mm.get(key), ns.get(key)))
        return tuple(seen)

    def min_member_map(self) -> "Mapping[str, int]":
        """Per-gang minMember still outstanding for the solver: already
        bound members reduce the requirement, so stragglers joining a
        satisfied gang schedule individually. Gangs with unknown minMember
        are omitted (build_pods falls back to batch member count).

        Returns a LIVE read-through view — materializing a dict over
        every known gang per chunk was a measured slice of the
        device-gang commit wall, and the view keeps cross-chunk gangs
        seeing bound-credit updates mid-drain."""
        return _MinMemberView(self._gangs)

    def nonstrict_map(self) -> "Mapping[str, bool]":
        """Per-gang NonStrict flag for the solver lowering — only gangs
        whose mode has been declared (CRD / first member); others resolve
        from the batch's own pod annotations in build_pods. Live
        read-through view (see :meth:`min_member_map`)."""
        return _NonStrictView(self._gangs)

    def begin_and_order(self, pending: Sequence[Pod]) -> List[Pod]:
        """Fused :meth:`begin_cycle` + :meth:`order_pending`: one pass
        resolves each pod's gang key and state exactly once (the two
        separate passes re-ran ``_gang_for_pod`` per member and were a
        measured slice of the device-gang cycle's host wall)."""
        for state in self._gangs.values():
            state.pending.clear()
        keys: List[Optional[str]] = []
        states: Dict[str, _GangState] = {}
        first_arrival: Dict[str, int] = {}
        gang_prio: Dict[str, int] = {}
        floor = -(1 << 62)
        for i, pod in enumerate(pending):
            key = gang_key_of(pod)
            keys.append(key)
            if key is None:
                continue
            st = states.get(key)
            if st is None:
                st = self._gang_for_pod(key, pod)
                states[key] = st
                first_arrival[key] = i
            st.pending[pod.meta.uid] = pod
            prio = pod.spec.priority or 0
            if prio > gang_prio.get(key, floor):
                gang_prio[key] = prio
        now = time.time()
        decorated = []
        for i, pod in enumerate(pending):
            key = keys[i]
            prio = pod.spec.priority or 0
            if key is None:
                decorated.append((-prio, i, "", i, pod))
                continue
            ok, _ = self._gate(key, states[key], pod, now)
            if ok:
                decorated.append(
                    (-gang_prio.get(key, prio), first_arrival[key], key, i, pod)
                )
        decorated.sort(key=lambda t: t[:4])
        return [t[4] for t in decorated]

    def order_pending(self, pods: Sequence[Pod]) -> List[Pod]:
        """NextPod semantics: keep gang members adjacent, ordered by the
        gang's highest member priority, so whole gangs land in one solver
        batch (``core/core.go:135-176``). Re-registering the pending set
        is idempotent, so this simply delegates to the fused pass."""
        return self.begin_and_order(pods)

    def permit(
        self, results: Iterable[Tuple[Pod, Optional[str]]]
    ) -> Tuple[List[Tuple[Pod, str]], List[Pod]]:
        """All-or-nothing Permit over one batch's commit results: gangs with
        fewer than minMember surviving placements are rejected whole, and a
        gang linked into a gang *group* (the gang-groups annotation,
        reference ``core/core.go:346-465`` AllowGangGroup) passes only when
        every gang in its group passes — one failing gang rejects the
        whole group's placements."""
        results = list(results)
        if not self._gangs and not any(
            gang_key_of(p) is not None for p, _ in results
        ):
            # no gang state and no gang-labeled pod in the batch: the
            # per-pod gang bookkeeping is pure overhead (hot commit path)
            return (
                [(p, n) for p, n in results if n is not None],
                [p for p, n in results if n is None],
            )
        placed_per_gang: Dict[str, int] = {}
        members_per_gang: Dict[str, int] = {}
        groups_of_gang: Dict[str, frozenset] = {}
        mode_of_gang: Dict[str, str] = {}
        for pod, node in results:
            key = gang_key_of(pod)
            if key is None:
                continue
            members_per_gang[key] = members_per_gang.get(key, 0) + 1
            if node is not None:
                placed_per_gang[key] = placed_per_gang.get(key, 0) + 1
            if key not in groups_of_gang:
                groups_of_gang[key] = gang_group_of(pod, key)
            if key not in mode_of_gang:
                state = self._gangs.get(key)
                mode_of_gang[key] = (
                    state.mode
                    if state is not None and state.mode_declared
                    else ext.gang_mode_of(pod.meta.annotations)
                )

        def gang_passes(key: str) -> bool:
            state = self._gangs.get(key)
            if state is not None and state.once_satisfied:
                # core/core.go:393: a once-satisfied gang's members pass
                # Permit individually
                return True
            fallback = members_per_gang.get(key, 0)
            need = state.effective_min(fallback) if state else fallback
            have = placed_per_gang.get(key, 0) + (
                state.bound_credit if state else 0
            )
            return have >= need

        gang_ok = {key: gang_passes(key) for key in members_per_gang}
        # Only a *Strict* failing gang rejects — and it rejects its whole
        # gang group. A NonStrict gang's partial placement keeps its
        # placed members and never cascades to the group (the reference's
        # rejectGangGroupById runs only in Strict mode,
        # core/core.go:333,394).
        strict_fail = {
            key: not gang_ok[key]
            and mode_of_gang.get(key) != ext.GANG_MODE_NONSTRICT
            for key in members_per_gang
        }
        group_ok: Dict[str, bool] = {}
        for key in members_per_gang:
            # every linked gang that appears in this batch must be free of
            # Strict failures; linked gangs absent gate via PreEnqueue
            group_ok[key] = not any(
                strict_fail.get(linked, False)
                for linked in groups_of_gang.get(key, frozenset({key}))
            )

        allowed: List[Tuple[Pod, str]] = []
        rejected: List[Pod] = []
        for pod, node in results:
            key = gang_key_of(pod)
            if node is None:
                rejected.append(pod)
                continue
            if key is not None and not group_ok.get(key, True):
                rejected.append(pod)
                continue
            allowed.append((pod, node))
        return allowed, rejected
