"""Crash-surviving flight recorder: the last N cycles, readable post-mortem.

``/metrics`` answers "how often", ``/trace`` answers "where did time go
while sampling was on" — neither answers "what were the last 200 cycles
of the incarnation that just died DOING". This module is the black box:
an append-only ring of per-cycle summaries (stage_ms, pipeline gate
states, speculation outcome, the adaptive pipeline-depth decision and
its discard-rate input — ``depth``/``depth_max``/``discard_rate``, so
every depth choice is explainable post-hoc and a takeover inherits the
dead writer's churn evidence — fence rejections, queue depth, batch
sizes)
persisted **beside the bind journal** over the same pluggable store API
(``MemoryJournalStore`` in tests/sim, ``FileJournalStore`` for real
durability), so a new incarnation taking over a shard loads the dead
incarnation's tail and serves it at ``/debug/flightrecorder`` — the
post-mortem evidence a crash loop otherwise destroys.

Retention: every record is appended to the store; when the in-memory
ring wraps ``2 * capacity`` appends past the last rewrite, the store is
compacted to the ring's content (same tmp-file/atomic-rename discipline
the journal's checkpoint uses, via ``store.rewrite``). A reader never
sees more than ~2×capacity records, a crash never loses more than the
single in-flight append.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .errors import report_exception


class FlightRecorder:
    """Bounded per-cycle summary ring over a journal-style store.

    ``incarnation`` stamps every record with the writing process's
    identity; records loaded from the store that carry a DIFFERENT
    incarnation are the dead writer's — they stay in the ring (flagged
    ``recovered`` on render) so the takeover can serve them."""

    def __init__(
        self,
        store=None,
        capacity: int = 256,
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
        self._ring: deque = deque(maxlen=capacity)  # guarded-by: self._lock
        self._lock = threading.Lock()
        self._seq = 0  # guarded-by: self._lock
        self._since_rewrite = 0  # guarded-by: self._lock
        # adopt the predecessor's tail: this IS the crash-survival story
        tail = sorted(self.store.load(), key=lambda r: r.get("seq", 0))
        for rec in tail[-capacity:]:
            self._ring.append(dict(rec))
        self._seq = max((r.get("seq", 0) for r in tail), default=0)

    def record(
        self,
        cycle: int,
        stage_ms: Optional[Dict[str, float]] = None,
        gates: Optional[Dict[str, bool]] = None,
        speculation: str = "",
        fenced: bool = False,
        queue_depth: int = 0,
        bound: int = 0,
        unschedulable: int = 0,
        **extra,
    ) -> dict:
        """Append one cycle summary. Never raises into the scheduling
        path: a storage failure degrades to in-memory-only retention
        (the ring keeps recording; the black box is best-effort durable,
        the journal is the correctness-bearing log)."""
        with self._lock:
            self._seq += 1
            rec = {
                "seq": self._seq,
                "t": self.clock(),
                "cycle": int(cycle),
                "incarnation": self.incarnation,
                "stage_ms": {
                    k: round(float(v), 3)
                    for k, v in (stage_ms or {}).items()
                },
                "gates": dict(gates or {}),
                "speculation": speculation,
                "fenced": bool(fenced),
                "queue_depth": int(queue_depth),
                "bound": int(bound),
                "unschedulable": int(unschedulable),
            }
            if self.shard is not None:
                rec["shard"] = int(self.shard)
            rec.update(extra)
            self._ring.append(rec)
            try:
                self.store.append(rec)
                self._since_rewrite += 1
                if self._since_rewrite >= 2 * self.capacity:
                    self.store.rewrite(list(self._ring))
                    self._since_rewrite = 0
            except Exception as exc:
                # best-effort durability; the ring still has it. Broad
                # on purpose: the docstring promises NEVER to raise
                # into the scheduling path, and a store json-encodes
                # (TypeError on an odd `extra` value, not just OSError)
                report_exception("flightrecorder.store", exc)
            return rec

    # ---- inspection ----

    def last(self, n: Optional[int] = None) -> List[dict]:
        with self._lock:
            recs = list(self._ring)
        return recs if n is None else recs[-n:]

    def recovered_records(self) -> List[dict]:
        """Records written by a DIFFERENT incarnation (the dead writer's
        tail this recorder adopted from the shared store)."""
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
                "cycles": len(recs),
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
