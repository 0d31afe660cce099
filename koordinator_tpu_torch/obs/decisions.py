"""Crash-surviving decision ledger: every controller decision, explainable.

The repo runs five hand-tuned feedback controllers over the same
SLO-burn inputs (pipeline depth, brownout ladder, admission verdicts,
solver circuit breaker, topology split/merge). Their decisions used to
be observable only as scattered side effects — a gauge here, a
flight-recorder stamp there. This module is the unified substrate the
learned-control-plane roadmap item needs: every decision is recorded as
a structured, seq-stamped record

    {controller, shard, tick, inputs, action, state}

where ``inputs`` is the COMPLETE evidence the controller read (burn
rates with window ages, discard-rate window, band occupancy, breaker
failure counts, hysteresis counters) and ``state`` is the controller's
post-decision internal state. Because every controller decides purely
FROM its snapshot (no clocks, no randomness), a recorded ledger can be
replayed offline (``tools/decision_replay.py``) and an alternate policy
(:mod:`obs.shadow`) can be diffed live against the acting decision —
fed the same snapshot, never allowed to act.

Persistence mirrors :class:`obs.flightrecorder.FlightRecorder` exactly:
records ride the journal-store API (sealed/screened by the store codec,
so ``store-integrity`` koordlint and ``journal_fsck`` cover them), a
takeover adopts the dead writer's tail, and the store is compacted to
the ring every ``2 * capacity`` appends. ``/debug/decisions`` serves
the ring per shard; ``controller_decisions_total{controller,action}``
counts the stream.
"""

from __future__ import annotations

import copy
import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .errors import report_exception
from .shadow import NO_PROPOSAL as _NO_PROPOSAL


def action_label(action) -> str:
    """Short metric-label projection of an action dict.

    Decision actions are dicts; the ``controller_decisions_total``
    counter needs a bounded label vocabulary. Ops and verdicts label as
    their value (``escalate``, ``SHED``); everything else labels as the
    first recognized ``key=value`` pair so depth choices stay bounded by
    the depth range.
    """
    if isinstance(action, dict):
        for key in ("op", "verdict"):
            if key in action:
                return str(action[key])
        for key in ("allow", "depth", "to", "state"):
            if key in action:
                return f"{key}={action[key]}"
        return "other"
    return str(action)


def decision_trace(records) -> List[dict]:
    """Canonical projection of ledger records for bit-exactness checks.

    Drops only the non-decision-bearing annotations: ``t`` (wall time —
    real clocks differ between same-seed runs), ``shadow`` (a shadow
    policy must NEVER perturb the acting trace, so the comparison that
    proves it has to ignore the shadow's own annotation), and ``crc``
    (the store codec's seal — it covers ``t`` and ``shadow``, so it
    inherits their run-to-run variance). Everything else — seq, cseq,
    controller, shard, tick, inputs, action, state, incarnation — must
    be bit-identical for same-seed runs.
    """
    return [
        {k: v for k, v in r.items() if k not in ("t", "shadow", "crc")}
        for r in records
    ]


def controller_gaps(records) -> Dict[str, List[int]]:
    """Per-controller ``cseq`` gaps in a record list; ``{}`` = gap-free.

    Retention only ever drops records at the HEAD of a controller's
    stream (ring eviction / store compaction), and a takeover adopts the
    dead writer's tail and continues its ``cseq`` — so the retained
    records of each controller must form one contiguous run. A hole in
    the middle means lost decisions.
    """
    by_controller: Dict[str, List[int]] = {}
    for rec in records:
        by_controller.setdefault(str(rec.get("controller")), []).append(
            int(rec.get("cseq", 0))
        )
    gaps: Dict[str, List[int]] = {}
    for controller, seqs in by_controller.items():
        unique = set(seqs)
        lo, hi = min(unique), max(unique)
        missing = [s for s in range(lo, hi + 1) if s not in unique]
        if missing or len(unique) != len(seqs):
            gaps[controller] = missing or sorted(seqs)
    return gaps


class DecisionLedger:
    """Bounded controller-decision ring over a journal-style store.

    ``incarnation`` stamps every record with the writing process's
    identity; records adopted from the store under a DIFFERENT
    incarnation are the dead writer's decision tail (flagged
    ``recovered`` on render), and each controller's ``cseq`` continues
    from the adopted maximum so per-controller sequences stay gap-free
    across a takeover.
    """

    def __init__(
        self,
        store=None,
        capacity: int = 512,
        shard: Optional[int] = None,
        incarnation: str = "",
        clock=time.time,
    ):
        from ..core.journal import MemoryJournalStore

        self.store = store if store is not None else MemoryJournalStore()
        self.capacity = int(capacity)
        self.shard = shard
        self.incarnation = incarnation
        self.clock = clock
        #: non-acting alternate policies (obs.shadow.ShadowRegistry);
        #: consulted per record with a deep COPY of the snapshot so a
        #: shadow can never reach the acting controller's evidence
        self.shadow = None
        self._ring: deque = deque(maxlen=capacity)  # guarded-by: self._lock
        self._lock = threading.Lock()
        self._seq = 0  # guarded-by: self._lock
        self._cseq: Dict[str, int] = {}  # guarded-by: self._lock
        self._since_rewrite = 0  # guarded-by: self._lock
        self._registry = None
        self._decisions_total = None
        self._divergence_total = None
        #: flight recorders mirrored by flight_record() — the ledger is
        #: the controllers' SINGLE attachment point, so takeover
        #: adoption of journaled controller evidence is one code path
        self._flights: List = []
        # adopt the predecessor's tail: this IS the crash-survival story
        tail = sorted(self.store.load(), key=lambda r: r.get("seq", 0))
        for rec in tail[-capacity:]:
            self._ring.append(dict(rec))
        self._seq = max((r.get("seq", 0) for r in tail), default=0)
        for rec in tail:
            c = str(rec.get("controller", ""))
            self._cseq[c] = max(
                self._cseq.get(c, 0), int(rec.get("cseq", 0))
            )

    # ---- wiring ----

    def bind_registry(self, registry) -> None:
        """First caller wins (mirrors BrownoutController.bind_registry):
        the ledger counts decisions into ONE metrics registry even when
        several engines share it."""
        if registry is None or self._registry is not None:
            return
        self._registry = registry
        self._decisions_total = registry.counter(
            "controller_decisions_total",
            "Control-plane decisions recorded on the decision ledger",
            labels=("controller", "action"),
        )
        self._divergence_total = registry.counter(
            "shadow_divergence_total",
            "Shadow-policy proposals that diverged from the acting "
            "controller's decision",
            labels=("controller",),
        )

    def attach_shadow(self, shadow) -> None:
        """Attach a ShadowRegistry. First caller wins."""
        if shadow is not None and self.shadow is None:
            self.shadow = shadow

    def attach_flight(self, recorder) -> None:
        """Attach a FlightRecorder mirrored by :meth:`flight_record`."""
        if recorder is not None and recorder not in self._flights:
            self._flights.append(recorder)

    def flight_record(self, **kw) -> None:
        """Mirror a byte-compatible journal entry to every attached
        flight recorder (the brownout transition stamps ride here so
        the pre-ledger ``/debug/flightrecorder`` fields stay stable)."""
        for fr in self._flights:
            fr.record(**kw)

    # ---- the write path ----

    def record(
        self,
        controller: str,
        tick: int,
        inputs: dict,
        action: dict,
        state: dict,
        shard: Optional[int] = None,
        outcome: Optional[dict] = None,
        **extra,
    ) -> dict:
        """Append one decision. Never raises into the control path: a
        storage failure degrades to in-memory-only retention and a
        shadow failure is reported and dropped (a shadow can NEVER
        perturb the acting controller)."""
        proposal = _NO_PROPOSAL
        sh = self.shadow
        if sh is not None:
            try:
                proposal = sh.propose(
                    controller, copy.deepcopy(inputs)
                )
            except Exception as exc:
                # broad on purpose: shadow policies are candidate code
                # under evaluation; their crash must not reach the
                # acting control path
                report_exception("decisions.shadow", exc)
                proposal = _NO_PROPOSAL
        with self._lock:
            self._seq += 1
            cseq = self._cseq.get(controller, 0) + 1
            self._cseq[controller] = cseq
            rec = {
                "seq": self._seq,
                "cseq": cseq,
                "t": self.clock(),
                "controller": str(controller),
                "tick": int(tick),
                "inputs": inputs,
                "action": action,
                "state": state,
                "incarnation": self.incarnation,
            }
            use_shard = shard if shard is not None else self.shard
            if use_shard is not None:
                rec["shard"] = int(use_shard)
            if outcome is not None:
                rec["outcome"] = outcome
            rec.update(extra)
            if proposal is not _NO_PROPOSAL:
                rec["shadow"] = {
                    "proposal": proposal,
                    "diverged": proposal != action,
                }
            self._ring.append(rec)
            try:
                self.store.append(rec)
                self._since_rewrite += 1
                if self._since_rewrite >= 2 * self.capacity:
                    self.store.rewrite(list(self._ring))
                    self._since_rewrite = 0
            except Exception as exc:
                # best-effort durability; the ring still has it (same
                # contract as the flight recorder)
                report_exception("decisions.store", exc)
        ct = self._decisions_total
        if ct is not None:
            ct.labels(
                controller=str(controller), action=action_label(action)
            ).inc()
        if proposal is not _NO_PROPOSAL and rec["shadow"]["diverged"]:
            dt = self._divergence_total
            if dt is not None:
                dt.labels(controller=str(controller)).inc()
        return rec

    # ---- inspection ----

    def last(self, n: Optional[int] = None) -> List[dict]:
        with self._lock:
            recs = list(self._ring)
        return recs if n is None else recs[-n:]

    def recovered_records(self) -> List[dict]:
        """Records written by a DIFFERENT incarnation (the dead writer's
        decision tail this ledger adopted from the shared store)."""
        return [
            r
            for r in self.last()
            if r.get("incarnation") != self.incarnation
        ]

    def render(self, n: Optional[int] = None) -> str:
        recs = self.last(n)
        return json.dumps(
            {
                "incarnation": self.incarnation,
                "shard": self.shard,
                "decisions": len(recs),
                "recovered": sum(
                    1
                    for r in recs
                    if r.get("incarnation") != self.incarnation
                ),
                "records": [
                    dict(
                        r,
                        recovered=(
                            r.get("incarnation") != self.incarnation
                        ),
                    )
                    for r in recs
                ],
            },
            indent=1,
        )
