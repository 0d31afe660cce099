"""Span/Tracer with ring-buffer retention and Chrome trace export.

The model is deliberately small: a :class:`Tracer` owns a bounded ring of
finished :class:`Span` records; ``tracer.span(name)`` is a context manager
that stamps monotonic start/duration and the per-thread nesting depth.
When the tracer is disabled, ``span()`` returns a shared no-op singleton —
no allocation, no lock, no ring write — so instrumentation can stay wired
in hot paths permanently (the disabled-mode guard is one attribute read).

Export is Chrome ``trace_event`` JSON ("X" complete events, microsecond
timestamps relative to the tracer's epoch), loadable in Perfetto or
chrome://tracing. Nesting renders from time containment per thread lane,
so no parent pointers are stored.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Span:
    """One finished span. ``t0``/``dur`` are seconds on the tracer's
    monotonic clock (``t0`` relative to the tracer epoch); ``depth`` is
    the per-thread nesting level at entry (0 = top-level)."""

    name: str
    t0: float
    dur: float
    cat: str = ""
    tid: int = 0
    depth: int = 0
    args: Dict[str, object] = field(default_factory=dict)


class _NullSpan:
    """Shared no-op span: context manager + arg sink. A single module
    instance serves every disabled-tracer call site."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **args) -> None:
        return None


_NULL_SPAN = _NullSpan()


class _LiveSpan:
    """In-flight span handle; appends a finished :class:`Span` to the
    tracer ring on exit."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0", "_depth", "_tid")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: Dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def set(self, **args) -> None:
        self.args.update(args)

    def __enter__(self) -> "_LiveSpan":
        tr = self._tracer
        local = tr._local
        self._depth = getattr(local, "depth", 0)
        local.depth = self._depth + 1
        self._tid = threading.get_ident()
        self._t0 = tr.clock()
        return self

    def __exit__(self, *exc) -> None:
        tr = self._tracer
        t1 = tr.clock()
        tr._local.depth = self._depth
        tr._append(
            Span(
                name=self.name,
                t0=self._t0 - tr.epoch,
                dur=t1 - self._t0,
                cat=self.cat,
                tid=self._tid,
                depth=self._depth,
                args=self.args,
            )
        )


class StageTimer:
    """Times one stage into BOTH a span and a metrics histogram.

    The histogram is observed unconditionally — metric continuity must
    not depend on whether tracing is sampled on — while the span follows
    the tracer's enabled state. Timing reads the tracer's injectable
    monotonic ``clock`` (the default is ``time.perf_counter``), so tests
    can pin stage durations with a fake clock instead of asserting
    against contention-sensitive wall time. ``last_dur`` holds the most
    recent stage duration for per-cycle consumers (flight recorder)."""

    __slots__ = ("_tracer", "_span", "_histogram", "_labels", "_t0",
                 "last_dur")

    def __init__(self, tracer: "Tracer", name: str, histogram=None,
                 cat: str = "", labels: Optional[Dict[str, str]] = None,
                 **args):
        self._tracer = tracer
        self._span = tracer.span(name, cat=cat, **args)
        self._histogram = histogram
        self._labels = labels or {}
        self.last_dur = 0.0

    def set(self, **args) -> None:
        self._span.set(**args)

    def __enter__(self) -> "StageTimer":
        self._t0 = self._tracer.clock()
        self._span.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._span.__exit__(*exc)
        self.last_dur = self._tracer.clock() - self._t0
        if self._histogram is not None:
            self._histogram.observe(self.last_dur, **self._labels)


class StageSequence:
    """Contiguous stage spans: ``enter(name)`` closes the previous stage
    and opens the next, so a cycle's stages tile its wall time (the
    ≥95%-coverage property the trace endpoint promises). Each stage also
    observes ``histogram`` with a ``stage`` label when one is given, and
    accumulates into ``totals`` (stage → seconds for THIS sequence) so a
    per-cycle consumer — the flight recorder — gets the cycle's own
    stage breakdown without scraping the cumulative histogram."""

    __slots__ = ("_tracer", "_histogram", "_cat", "_args", "_cur",
                 "_cur_name", "totals")

    def __init__(self, tracer: "Tracer", histogram=None, cat: str = "", **args):
        self._tracer = tracer
        self._histogram = histogram
        self._cat = cat
        self._args = args
        self._cur: Optional[StageTimer] = None
        self._cur_name: Optional[str] = None
        self.totals: Dict[str, float] = {}

    def enter(self, name: str) -> None:
        self.close()
        st = StageTimer(
            self._tracer,
            name,
            histogram=self._histogram,
            cat=self._cat,
            labels={"stage": name} if self._histogram is not None else None,
            **self._args,
        )
        st.__enter__()
        self._cur = st
        self._cur_name = name

    def set(self, **args) -> None:
        if self._cur is not None:
            self._cur.set(**args)

    def close(self) -> None:
        if self._cur is not None:
            self._cur.__exit__(None, None, None)
            self.totals[self._cur_name] = (
                self.totals.get(self._cur_name, 0.0) + self._cur.last_dur
            )
            self._cur = None
            self._cur_name = None


class Tracer:
    """Thread-safe span collector with bounded retention.

    ``enabled`` toggles sampling at runtime (the services engine's POST
    /trace flips it); the ring keeps the most recent ``capacity``
    finished spans. ``clock`` is the monotonic time source every span
    and :class:`StageTimer` reads (default ``time.perf_counter``;
    inject a fake for deterministic stage timing in tests). The epoch is
    the tracer's construction instant on that clock — every exported
    timestamp is relative to it.
    """

    def __init__(
        self,
        enabled: bool = False,
        capacity: int = 65536,
        clock=time.perf_counter,
    ):
        self.enabled = enabled
        self.clock = clock
        self.epoch = clock()
        self._ring: deque = deque(maxlen=capacity)  # guarded-by: self._lock
        self._lock = threading.Lock()
        self._local = threading.local()

    def set_clock(self, clock) -> None:
        """Swap the time source (tests): re-anchors the epoch so exported
        timestamps stay non-negative, and clears spans recorded on the
        old clock — mixed-domain durations are meaningless."""
        self.clock = clock
        self.epoch = clock()
        self.clear()

    # -- recording --

    def span(self, name: str, cat: str = "", **args):
        """Context manager for one span; the no-op singleton when
        sampling is off (zero allocation on the disabled path when no
        kwargs are passed)."""
        if not self.enabled:
            return _NULL_SPAN
        return _LiveSpan(self, name, cat, args)

    def stage(self, name: str, histogram=None, cat: str = "", **args) -> StageTimer:
        """A :class:`StageTimer` feeding both this tracer and
        ``histogram`` (any object with ``observe(seconds)``)."""
        return StageTimer(self, name, histogram=histogram, cat=cat, **args)

    def _append(self, span: Span) -> None:
        with self._lock:
            self._ring.append(span)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    # -- inspection / export --

    def records(self) -> List[Span]:
        with self._lock:
            return list(self._ring)

    def stage_totals(self, max_depth: Optional[int] = None) -> Dict[str, float]:
        """Total seconds per span name (optionally only spans at or above
        ``max_depth`` nesting). Nested same-name spans double-count by
        design — filter by depth for exclusive totals."""
        totals: Dict[str, float] = {}
        for s in self.records():
            if max_depth is not None and s.depth > max_depth:
                continue
            totals[s.name] = totals.get(s.name, 0.0) + s.dur
        return totals

    def to_chrome_trace(self) -> Dict[str, object]:
        """Chrome ``trace_event`` JSON object (Perfetto /
        chrome://tracing compatible): "X" complete events in µs, one
        lane per recording thread."""
        events: List[Dict[str, object]] = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": 1,
                "tid": 0,
                "args": {"name": "koordinator-tpu"},
            }
        ]
        tids: Dict[int, int] = {}
        for s in self.records():
            lane = tids.setdefault(s.tid, len(tids) + 1)
            events.append(
                {
                    "name": s.name,
                    "cat": s.cat or "default",
                    "ph": "X",
                    "ts": round(s.t0 * 1e6, 3),
                    "dur": round(s.dur * 1e6, 3),
                    "pid": 1,
                    "tid": lane,
                    "args": dict(s.args, depth=s.depth),
                }
            )
        for tid, lane in tids.items():
            events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": 1,
                    "tid": lane,
                    "args": {"name": f"thread-{tid}"},
                }
            )
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_json(self) -> str:
        return json.dumps(self.to_chrome_trace())


#: shared always-disabled tracer for call sites with no tracer wired
NULL_TRACER = Tracer(enabled=False, capacity=1)
