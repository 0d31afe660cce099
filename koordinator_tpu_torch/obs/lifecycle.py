"""Fleet-wide pod-lifecycle tracing (distributed-observability tentpole).

PR 1's Span/Tracer answers "where did CYCLE time go" inside one process;
this module answers "where did THIS POD's time go" across the partitioned
control plane: a per-pod trace context threaded from
``StreamScheduler.submit`` through ``ShardRouter`` route/fan-out, the
single-winner claim, queue wait, solve dispatch, commit and bind-ack —
with shard handoffs, crash orphaning and journal-replay recovery recorded
as first-class events, so a pod that crossed three incarnations still has
ONE contiguous timeline.

Two consumers drive the design:

* the ``placement_latency_seconds{shard,stage}`` histogram — the per-pod
  placement-latency SLO signal (arrival→ack end to end, decomposed into
  route/queue/claim/solve/commit), which the SLO layer (:mod:`.slo`) and
  the learned-policy roadmap item both read;
* the gap-free-timeline invariant the multi-shard chaos soak asserts:
  every placed pod's events are time-ordered, start at ``submit``, end at
  ``ack``, and every shard/incarnation transition is bracketed by
  handoff/orphan/recover events (:func:`validate_timeline`).

Crash survival: the tracker itself is in-memory, but the scheduler embeds
each pod's compact context (:meth:`PodLifecycle.context`) into the bind
journal's record, so a takeover's replay can emit a ``recover`` event
carrying the ORIGINAL submit stamp — the timeline bridges the dead
incarnation instead of restarting at the new one.

``lifecycle=None`` stays the default everywhere it is threaded: the
disabled path is one attribute-is-None check, same contract as the
tracer's no-op singleton.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

#: terminal stages: the pod's placement story is over. ``shed`` is
#: terminal-but-redeemable (overload-control PR): the story ends there
#: unless a driver redeems the resubmit ticket, which re-opens it with
#: a ``resubmit``/``enqueue`` bridge
_TERMINAL = frozenset({"ack", "gone", "shed"})

#: event stages a timeline may contain (validator vocabulary)
STAGES = frozenset(
    {
        "submit",      # arrival at the control plane (the SLO clock start)
        "route",       # ShardRouter picked the pod's primary shard
        "fanout",      # backlog spill: also enqueued on a spill shard
        "enqueue",     # landed in a shard owner's stream queue
        "resubmit",    # re-enqueued from a handoff with original stamps
        "claim",       # won the cross-shard single-winner claim
        "claim_lost",  # lost the claim (another shard schedules it)
        "dispatch",    # fed into a scheduling cycle's batch
        "decide",      # cycle produced a verdict (node or None)
        "handoff",     # surfaced from a donor's queue at shard handoff
        "orphan",      # owner died with the pod queued/in flight
        "shard_split", # re-homed by a live shard split (elastic topology)
        "shard_merge", # re-homed by a live shard merge (elastic topology)
        "recover",     # journal replay restored the acknowledged bind
        "shed",        # overload admission shed the pod (terminal unless
                       # a resubmit ticket is redeemed)
        "ack",         # bind acknowledged / published (terminal)
        "gone",        # pod deleted before placement (terminal)
    }
)

#: stages that DISPLACE a pod from its owner: until a bridge event
#: (resubmit/recover/enqueue) lands, any placement-path progress is a
#: timeline gap — the validator's cross-incarnation/cross-topology arm.
#: ``shed`` rides the same machinery (overload-control PR): placement
#: progress after a shed without a ticket-redemption bridge is a gap
_DISPLACING = frozenset({"orphan", "shard_split", "shard_merge", "shed"})

#: default histogram buckets (seconds): sub-ms in-process pumps up to the
#: multi-cycle waits a leaderless gap produces
LATENCY_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)


@dataclass
class LifecycleEvent:
    """One step of a pod's placement journey."""

    stage: str
    t: float
    #: shard the event happened on (-1 = not shard-scoped, e.g. submit)
    shard: int = -1
    #: free detail: node name on decide/ack, incarnation on orphan, …
    detail: str = ""

    def to_dict(self) -> Dict[str, object]:
        return {
            "stage": self.stage,
            "t": self.t,
            "shard": self.shard,
            "detail": self.detail,
        }


class _ShardBuffer:
    """One shard's event buffer: its own lock, its own uid→events map.
    The hot ``event()`` path touches ONLY this lock — per-shard pump
    threads sharing one tracker no longer serialize on a fleet-wide
    mutex (PR 7 queued follow-on)."""

    __slots__ = ("lock", "events")

    def __init__(self):
        self.lock = threading.Lock()
        #: uid -> [(global seq, event), ...] in this shard's append order
        self.events: Dict[str, List[Tuple[int, LifecycleEvent]]] = {}  # guarded-by: self.lock


class PodLifecycle:
    """Thread-safe per-pod event timeline + placement-latency histogram.

    ``clock`` supplies timestamps when an event's caller has none (the
    sharded soak injects its sim clock so timelines are deterministic);
    callers that DO know the instant (StreamScheduler's arrival stamps)
    pass ``t=`` explicitly so the latency math matches the stream's own.

    ``registry`` (a ``utils.metrics.Registry``) receives
    ``placement_latency_seconds{shard,stage}``; pass the fleet registry
    to fold the histogram into the merged scrape.

    Storage is PER-SHARD buffers merged on read: each shard's events
    append under that shard's own lock, so concurrent per-shard pump
    threads contend only on their own buffer (plus a rare structure
    lock at first sight of a uid and at terminal events). A global
    atomic sequence number (``itertools.count`` — C-level, effectively
    atomic under the GIL) preserves the fleet-wide arrival order a
    single buffer used to give for free: a merged timeline sorts by
    sequence, never by possibly-tied timestamps, so causal order across
    shards (orphan before resubmit at the same sim-clock tick) survives
    the split. Reads (timeline/validate/render) take every buffer lock —
    they are the cold path by design."""

    def __init__(
        self,
        registry=None,
        clock=time.perf_counter,
        max_pods: int = 200_000,
    ):
        self.clock = clock
        #: shard id (-1 = shardless submit lane) -> its buffer
        self._bufs: Dict[int, _ShardBuffer] = {}  # guarded-by: self._lock
        #: every known uid in FIRST-SIGHT order (dict-as-ordered-set);
        #: the max_pods bound is over this registry
        self._uids: Dict[str, None] = {}  # guarded-by: self._lock
        #: completed uids in COMPLETION order (dict-as-ordered-set), so
        #: eviction under the max_pods bound drops the oldest finished
        #: timelines first, deterministically
        self._done: Dict[str, None] = {}  # guarded-by: self._lock
        #: STRUCTURE lock: buffer creation, uid registry, done set,
        #: eviction. Never held while a caller holds a buffer lock
        #: (lock order is always structure → buffer).
        self._lock = threading.Lock()
        self._next_seq = itertools.count(1).__next__
        self.max_pods = max_pods
        #: kept so the fleet scrape can fold this incarnation-level
        #: registry into /metrics verbatim (its samples already carry
        #: their own shard label — no fleet-side injection)
        self.registry = registry
        self.histogram = None
        if registry is not None:
            self.histogram = registry.histogram(
                "placement_latency_seconds",
                "per-pod placement latency, arrival to bind-ack, "
                "decomposed by lifecycle stage (stage=e2e is the whole "
                "journey)",
                labels=("shard", "stage"),
                buckets=LATENCY_BUCKETS,
            )

    # ---- recording ----

    def event(
        self,
        uid: str,
        stage: str,
        shard: int = -1,
        t: Optional[float] = None,
        detail: str = "",
    ) -> None:
        shard = int(shard)
        ev = LifecycleEvent(
            stage=stage,
            t=self.clock() if t is None else t,
            shard=shard,
            detail=detail,
        )
        # first sight of a uid registers it (and maybe evicts) under the
        # STRUCTURE lock — the membership pre-check is GIL-safe and keeps
        # steady-state appends off that lock entirely
        if uid not in self._uids:
            with self._lock:
                if uid not in self._uids:
                    if len(self._uids) >= self.max_pods:
                        self._evict_locked()
                    self._uids[uid] = None
        buf = self._bufs.get(shard)
        if buf is None:
            with self._lock:
                buf = self._bufs.setdefault(shard, _ShardBuffer())
        seq = self._next_seq()
        with buf.lock:
            buf.events.setdefault(uid, []).append((seq, ev))
        # close the register→append race: a concurrent eviction may have
        # purged this uid between the fast-path check and the append,
        # leaving the fresh entry orphaned (in no registry, so no future
        # eviction could ever reclaim it). The racy membership re-check
        # is one GIL-atomic dict read; the slow path re-registers.
        if uid not in self._uids:
            with self._lock:
                if uid not in self._uids:
                    self._uids[uid] = None
        if stage in _TERMINAL:
            with self._lock:
                self._done[uid] = None
        elif uid in self._done:
            # a redeemed shed ticket (or any re-opened story) makes the
            # pod live again: it must leave the completed set so the
            # retention eviction prefers genuinely finished timelines.
            # The membership pre-check keeps the steady path lock-free.
            with self._lock:
                self._done.pop(uid, None)

    def _evict_locked(self) -> None:
        """Bounded retention: drop the oldest COMPLETED timelines first
        (an unbounded tracker would leak for the fleet's lifetime); if
        none are left — a fleet whose churn is dominated by never-placed
        pods, which have no terminal event — fall back to the oldest
        OPEN timelines so the bound still holds. Caller holds the
        structure lock; buffer locks nest inside it (lock order)."""
        victims = list(self._done)[: max(1, self.max_pods // 10)]
        if not victims:
            victims = [
                u for u in self._uids if u not in self._done
            ][: max(1, self.max_pods // 10)]
        victim_set = set(victims)
        for buf in self._bufs.values():
            with buf.lock:
                for old_uid in victim_set:
                    buf.events.pop(old_uid, None)
        for old_uid in victims:
            self._uids.pop(old_uid, None)
            self._done.pop(old_uid, None)

    # stage-specific helpers keep call sites short and the stage names
    # in ONE vocabulary (typos would silently break the validator)

    def submitted(self, uid: str, t: Optional[float] = None) -> None:
        self.event(uid, "submit", t=t)

    def routed(
        self, uid: str, shard: int, t: Optional[float] = None,
        detail: str = "",
    ) -> None:
        self.event(uid, "route", shard=shard, t=t, detail=detail)

    def acked(
        self,
        uid: str,
        shard: int,
        node: str,
        t: Optional[float] = None,
    ) -> Optional[float]:
        """Terminal acknowledgement: record the event AND observe the
        per-stage latency decomposition into the histogram. Returns the
        end-to-end latency (first submit → this ack, on the tracker's
        clock domain) so the caller can feed its SLO sample without
        mixing time domains, or None if the submit was never seen."""
        t = self.clock() if t is None else t
        self.event(uid, "ack", shard=shard, t=t, detail=node)
        self._observe(uid, shard, t)
        evs = self.timeline(uid)
        t0 = next((e.t for e in evs if e.stage == "submit"), None)
        # a redeemed shed ticket re-anchors the SLO clock (overload-
        # control PR): the shed run was terminally accounted by
        # overload_shed_total, so the redeemed run's latency story
        # starts at its bridge (resubmit/enqueue after the last shed) —
        # otherwise every redemption wave re-burns the latency budget
        # for debt the shed metric already paid
        last_shed = None
        for i, e in enumerate(evs):
            if e.stage == "shed":
                last_shed = i
        if last_shed is not None:
            t0 = next(
                (
                    e.t
                    for e in evs[last_shed + 1:]
                    if e.stage in ("resubmit", "enqueue", "submit")
                ),
                t0,
            )
        return None if t0 is None else max(0.0, t - t0)

    def seen(self, uid: str) -> bool:
        with self._lock:
            return uid in self._uids

    # ---- the histogram decomposition ----

    def _observe(self, uid: str, shard: int, t_ack: float) -> None:
        if self.histogram is None:
            return
        evs = self.timeline(uid)
        last: Dict[str, float] = {}
        first_submit: Optional[float] = None
        for ev in evs:
            last[ev.stage] = ev.t
            if first_submit is None and ev.stage == "submit":
                first_submit = ev.t
        if first_submit is None:
            return
        sh = str(shard)
        obs = self.histogram.observe
        obs(max(0.0, t_ack - first_submit), shard=sh, stage="e2e")
        # stage spans from LAST occurrences (retries/handoffs re-enter
        # earlier stages; the final successful pass is what the SLO sees)
        enq = last.get("enqueue", last.get("resubmit"))
        if enq is not None:
            obs(max(0.0, enq - first_submit), shard=sh, stage="route")
        claim = last.get("claim")
        disp = last.get("dispatch")
        # unsharded streams have no claim gate: queue wait then runs
        # enqueue→dispatch instead of enqueue→claim
        qref = claim if claim is not None else disp
        if qref is not None and enq is not None:
            obs(max(0.0, qref - enq), shard=sh, stage="queue")
        if disp is not None and claim is not None:
            obs(max(0.0, disp - claim), shard=sh, stage="claim")
        dec = last.get("decide", last.get("recover"))
        if dec is not None and disp is not None:
            obs(max(0.0, dec - disp), shard=sh, stage="solve")
        if dec is not None:
            obs(max(0.0, t_ack - dec), shard=sh, stage="commit")

    # ---- journal context (crash survival) ----

    def context(self, uid: str) -> Optional[Dict[str, object]]:
        """Compact context the scheduler embeds in the pod's bind-journal
        record: the ORIGINAL submit stamp and the shard-hop count. A
        takeover's replay hands it back to :meth:`recovered` so the
        bridged timeline keeps the true arrival time."""
        evs = self.timeline(uid)
        if not evs:
            return None
        t0 = next((e.t for e in evs if e.stage == "submit"), evs[0].t)
        hops = len({e.shard for e in evs if e.shard >= 0})
        return {"t0": t0, "hops": hops}

    def recovered(
        self,
        uid: str,
        shard: int,
        node: str,
        ctx: Optional[Dict[str, object]] = None,
        t: Optional[float] = None,
    ) -> None:
        """Journal replay restored this pod's acknowledged bind on a new
        incarnation. If the tracker never saw the pod submit (a genuinely
        fresh process), the journaled context re-seeds the timeline."""
        with self._lock:
            fresh = uid not in self._uids
            done = uid in self._done
        if done:
            return  # already terminal: replay of an old bind, no gap
        if fresh and ctx and "t0" in ctx:
            self.event(uid, "submit", t=float(ctx["t0"]))
        self.event(uid, "recover", shard=shard, t=t, detail=node)

    def is_done(self, uid: str) -> bool:
        with self._lock:
            return uid in self._done

    # ---- inspection ----

    def timeline(self, uid: str) -> List[LifecycleEvent]:
        """The pod's merged timeline: per-shard buffers joined and
        ordered by the global arrival sequence (true fleet-wide append
        order, not possibly-tied timestamps)."""
        with self._lock:
            bufs = list(self._bufs.values())
        merged: List[Tuple[int, LifecycleEvent]] = []
        for buf in bufs:
            with buf.lock:
                merged.extend(buf.events.get(uid, ()))
        merged.sort(key=lambda pair: pair[0])
        return [ev for _seq, ev in merged]

    def uids(self) -> List[str]:
        with self._lock:
            return list(self._uids)

    def flows(self, max_pods: int = 256) -> Dict[str, List[dict]]:
        """Per-pod flow-arrow feed for the merged Chrome trace
        (``obs.fleet.merge_chrome_traces(pod_flows=...)``): the most
        recently COMPLETED ``max_pods`` pods' timelines as event dicts."""
        with self._lock:
            done = list(self._done)[-max_pods:]
        return {
            uid: [e.to_dict() for e in self.timeline(uid)]
            for uid in done
        }

    def render(self, uid: str) -> str:
        return json.dumps(
            [e.to_dict() for e in self.timeline(uid)], indent=1
        )


def validate_timeline(
    events: Sequence[LifecycleEvent], require_terminal: bool = True
) -> List[str]:
    """Gap-free-timeline check (the chaos-soak invariant). Returns a
    list of problems (empty = valid):

    * non-empty, first event is ``submit``, timestamps non-decreasing;
    * every stage is in the known vocabulary;
    * ``dispatch`` only after the pod entered a queue (enqueue/resubmit)
      — a dispatch with no enqueue means a shard fed a pod it never
      admitted;
    * ``ack`` only after a ``decide``/``recover`` produced a node — an
      ack out of nowhere means the driver observed a bind the control
      plane never decided (the lost-ack gap);
    * after a DISPLACING event — ``orphan`` (owner died) or a topology
      bracket (``shard_split``/``shard_merge``: the pod's range moved
      under it) — the next placement-path event must be
      ``resubmit``/``recover``/``enqueue``: the bridge across the dead
      incarnation or the retired cell. The multi-shard soak fails on a
      gap across a split exactly here;
    * ``shed`` (overload-control PR) is terminal-but-redeemable: it may
      END the timeline, or be bridged by ``resubmit``/``enqueue`` (a
      redeemed resubmit ticket) — placement progress straight after a
      shed is a gap, and a shed AFTER the bind was acknowledged means an
      admission path dropped a pod the cluster already placed;
    * terminal: ends at ``ack``/``gone``/``shed`` when
      ``require_terminal``.
    """
    problems: List[str] = []
    if not events:
        return ["empty timeline"]
    if events[0].stage != "submit":
        problems.append(f"starts at {events[0].stage!r}, not submit")
    t_prev = events[0].t
    queued = False
    decided = False
    acked = False
    displaced = ""   # the displacing stage name, "" when bridged
    for i, ev in enumerate(events):
        if ev.stage not in STAGES:
            problems.append(f"[{i}] unknown stage {ev.stage!r}")
            continue
        if ev.t < t_prev - 1e-9:
            problems.append(
                f"[{i}] time went backwards: {ev.t} < {t_prev} "
                f"at {ev.stage}"
            )
        t_prev = max(t_prev, ev.t)
        if ev.stage in ("enqueue", "resubmit"):
            queued = True
            if displaced and ev.stage == "enqueue":
                displaced = ""  # driver re-routed the displaced pod
        if ev.stage in ("decide", "recover"):
            decided = True
        if ev.stage == "dispatch" and not queued:
            problems.append(f"[{i}] dispatch before any enqueue")
        if ev.stage == "ack" and not decided:
            problems.append(f"[{i}] ack without a decide/recover")
        if ev.stage == "ack":
            acked = True
        if ev.stage == "shed" and acked:
            problems.append(
                f"[{i}] shed after the bind was acknowledged — an "
                "admission path dropped an already-placed pod"
            )
        if displaced and ev.stage in ("dispatch", "decide", "ack"):
            problems.append(
                f"[{i}] {ev.stage} after {displaced} without "
                "resubmit/recover/enqueue bridge"
            )
        if ev.stage in _DISPLACING:
            displaced = ev.stage
            queued = False
        if ev.stage in ("resubmit", "recover"):
            displaced = ""
    if require_terminal and events[-1].stage not in _TERMINAL:
        problems.append(f"ends at {events[-1].stage!r}, not terminal")
    return problems
