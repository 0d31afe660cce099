"""Rejection-reason taxonomy and machine-readable rejection records.

Every pod a scheduling cycle fails to place gets one record naming the
*stage* that killed it (which phase of the decision path), the *plugin*
(which policy inside the stage) and a *reason* from a closed enum — the
per-decision attribution Gavel/Synergy-style tuning needs, and what the
reference only exposes as free-text ``FitError`` messages.

The log is a bounded ring (same retention shape as the error dispatcher's
failure log) plus a ``rejections_total`` Prometheus counter labeled
``stage, plugin, reason`` so rates survive ring eviction.
"""

from __future__ import annotations

import enum
import json
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional


class RejectStage(str, enum.Enum):
    """Where in the decision path the pod was rejected."""

    TRANSFORM = "transform"      # BeforePreFilter pod-transformer drop
    GATE = "gate"                # PreEnqueue / gang gating
    PREFILTER = "prefilter"      # reservation affinity pre-match
    FILTER = "filter"            # boolean-mask construction (solver masks)
    QUOTA = "quota"              # elastic-quota admission
    GANG = "gang"                # in-solver gang min-member enforcement
    SOLVE = "solve"              # feasible but lost the capacity rounds
    RESERVE = "reserve"          # host-side Reserve revalidation
    PERMIT = "permit"            # gang all-or-nothing permit rollback


class RejectReason(str, enum.Enum):
    POD_TRANSFORMER_DROPPED = "pod_transformer_dropped"
    GANG_NOT_READY = "gang_not_ready"
    RESERVATION_UNAVAILABLE = "reservation_unavailable"
    NO_MATCHING_NODE = "no_matching_node"
    INSUFFICIENT_RESOURCES = "insufficient_resources"
    USAGE_EXCEEDS_THRESHOLD = "usage_exceeds_threshold"
    QUOTA_EXHAUSTED = "quota_exhausted"
    GANG_INCOMPLETE = "gang_incomplete"
    NO_FEASIBLE_NODE = "no_feasible_node"
    NODE_CAPACITY_REVALIDATION = "node_capacity_revalidation_failed"
    NUMA_ALLOCATION_FAILED = "numa_allocation_failed"
    DEVICE_ALLOCATION_FAILED = "device_allocation_failed"
    NODE_VANISHED = "node_vanished"
    #: robustness hardening (fault-injection PR): non-finite request /
    #: estimate rows quarantined before they can poison the cost tensors
    NUMERIC_INVALID = "nan_inf_quarantined"
    #: the solver-result feeder queue stalled past its fetch deadline —
    #: the chunk's pods re-enter the next cycle instead of wedging it
    SOLVE_RESULT_STALLED = "solve_result_stalled"
    #: the per-cycle deadline expired with chunks left; the remainder is
    #: deferred and the batch degrades for the next cycle
    CYCLE_DEADLINE_EXCEEDED = "cycle_deadline_exceeded"
    #: a mid-commit failure rolled the chunk's Reserve journal back —
    #: every half-assumed pod was forgotten and retries next cycle
    COMMIT_ROLLED_BACK = "commit_rolled_back"
    #: HA fencing (failover PR): the committing scheduler's leadership
    #: epoch is no longer current — a deposed leader's in-flight commit
    #: (including pipelined speculative dispatches) is rejected instead
    #: of double-placing; the pods retry under the new leader
    STALE_LEADER_EPOCH = "stale_leader_epoch"
    #: the write-ahead bind journal could not append the chunk's intent/
    #: bind record — journal-before-mutate means the chunk is rejected
    #: un-mutated and retries once the journal recovers
    JOURNAL_WRITE_FAILED = "journal_write_failed"
    #: QoS-aware overload control (brownout PR): a BATCH/FREE pod shed at
    #: the admission boundary — its band's queue budget and age limit
    #: were both exceeded (or the brownout ladder reached its shed
    #: level). Terminal ``shed`` lifecycle event + resubmit ticket; the
    #: pod never reaches a solve
    OVERLOAD_SHED = "overload_shed"
    #: gray-failure containment PR: the pod is blamed on the poison
    #: quarantine ledger (its lowering deterministically crashed a cycle
    #: and bisection isolated it) — rejected at the cycle gate and shed
    #: with a REDEEMABLE ticket: a changed spec fingerprint lifts the
    #: blame and re-admits through the ordinary path
    POISON_QUARANTINED = "poison_quarantined"


@dataclass
class RejectionRecord:
    cycle_id: int
    pod: str
    uid: str
    stage: str
    plugin: str
    reason: str
    detail: str = ""
    ts: float = 0.0

    def to_dict(self) -> Dict[str, object]:
        return {
            "cycle": self.cycle_id,
            "pod": self.pod,
            "uid": self.uid,
            "stage": self.stage,
            "plugin": self.plugin,
            "reason": self.reason,
            "detail": self.detail,
            "ts": self.ts,
        }


class RejectionLog:
    """Bounded rejection-record ring + labeled counter.

    ``counter`` is an optional ``utils.metrics.Counter`` with label names
    ``(stage, plugin, reason)``; records always land in the ring, counts
    always land in the counter, so ``/debug/rejections`` gives the recent
    *who* and ``/metrics`` the long-run *how often*."""

    def __init__(self, counter=None, capacity: int = 4096):
        self.counter = counter
        self._ring: deque = deque(maxlen=capacity)  # guarded-by: self._lock
        self._lock = threading.Lock()

    def record(
        self,
        cycle_id: int,
        pod,
        stage: RejectStage,
        plugin: str,
        reason: RejectReason,
        detail: str = "",
    ) -> None:
        rec = RejectionRecord(
            cycle_id=cycle_id,
            pod=pod.meta.name,
            uid=pod.meta.uid,
            stage=str(stage.value),
            plugin=plugin,
            reason=str(reason.value),
            detail=detail,
            ts=time.time(),
        )
        with self._lock:
            self._ring.append(rec)
        if self.counter is not None:
            self.counter.labels(
                stage=rec.stage, plugin=rec.plugin, reason=rec.reason
            ).inc()

    def records(
        self, cycle_id: Optional[int] = None
    ) -> List[RejectionRecord]:
        with self._lock:
            recs = list(self._ring)
        if cycle_id is not None:
            recs = [r for r in recs if r.cycle_id == cycle_id]
        return recs

    def for_uid(self, uid: str) -> List[RejectionRecord]:
        return [r for r in self.records() if r.uid == uid]

    def stage_tally(self) -> Dict[str, int]:
        """stage → record count over the retained ring (feeds the debug
        filter dump's per-stage tally)."""
        tally: Dict[str, int] = {}
        for r in self.records():
            tally[r.stage] = tally.get(r.stage, 0) + 1
        return tally

    def render(self) -> str:
        recs = self.records()
        return json.dumps(
            {
                "tally": self.stage_tally(),
                "records": [r.to_dict() for r in recs],
            },
            indent=1,
        )
