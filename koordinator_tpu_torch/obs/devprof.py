"""Solver observatory: device/compiler-level profiling for the solve path.

Five bench rounds of ``stage_ms`` tables end at the dispatch boundary —
"solve" is an opaque residual with no device-op, compile/retrace or
memory attribution. This module is the evidence layer underneath it:

* **Compile/retrace ledger** (:class:`CompileLedger`) — every jitted
  solver entry point (``assign``, ``solve_stream``, ``solve_stream_full``,
  ``scatter_rows``, ``gather_rows``, the ``parallel.sharded`` paths)
  carries a trace-time hook (:func:`tracing`): the hook body runs ONLY
  while JAX is tracing the function, so an installed ledger sees every
  (re)trace with zero steady-state cost — the compiled program contains
  no trace of the hook. Call sites additionally wrap dispatches in
  :meth:`DevProf.watch`, which records the call's host signature (shapes,
  flags, gate-relevant statics); a trace firing inside a watched window
  is attributed to that signature, its wall time is billed as compile
  time (``solver_compiles_total{fn}`` / ``solver_compile_seconds{fn}``),
  and the signature DIFF against the function's previous call names the
  retrace cause (which shape/flag delta triggered it). Served at
  ``/debug/compiles``; the longrun soak asserts steady state is
  retrace-free.

* **Device timeline** (:class:`DevProf` capture window) — an on-demand
  window (``/debug/profile?cycles=N``) during which every watched
  dispatch is FENCED (``jax.block_until_ready``) and recorded as a
  device-lane event stamped with ``cycle_id``/stage, wrapped in a
  ``jax.profiler.TraceAnnotation`` so an external XLA profile aligns by
  the same names. The events merge into the tracer's Chrome trace as a
  dedicated ``device`` lane, so device ops line up under their host
  stage spans. Fencing serializes the dispatch pipeline — that is the
  point of an explicit, bounded capture window (it is never on by
  default).

* **Device-memory census** (:class:`DeviceMemoryCensus`) — per-cycle
  live-buffer accounting for the resident tables
  (``solver_device_bytes{table}``), process live-array totals, and a
  donation-effectiveness check (a donated buffer that survives the
  scatter is a donation MISS: the in-place update silently became a
  copy). :class:`LeakSentinel` turns the totals into the chaos soak's
  leak-detector arm: monotone live-array growth across incarnations
  fails.

Disabled mode is the PR 1/PR 7 standing contract: the scheduler holds
``devprof=None`` and every hot-path site is one attribute-is-None check;
the trace-time hooks cost nothing once compiled.

Port of ``koordinator_tpu/obs/devprof.py``. The ledger, the capture
window and the census are the reference's host code; the functions that
read the device have torch bodies: a watched dispatch is fenced by
synchronizing its tensors' CUDA device (:func:`_fence`), annotated with
``torch.profiler.record_function``, the census sums the tensors' bytes
(:func:`_tree_nbytes`) and reads ``torch.cuda``'s allocator statistics
(:func:`live_summary`), and a resident refresh is checked for being in
place by ``data_ptr`` (:func:`donation_dead`: the port's scatter writes
into the resident tensors where the reference donates them). A
graph-capture ledger and a CUDA-event device lane are still to come
(ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from collections import deque
from typing import Dict, List, Mapping, Optional, Tuple

import torch

# ---------------------------------------------------------------------------
# trace-time hook registry
# ---------------------------------------------------------------------------

#: ledgers currently installed process-wide. Appended by
#: CompileLedger.install(); read by tracing() at JAX trace time. A plain
#: list: mutation is rare (install/uninstall), reads are trace-time only.
_LEDGERS: List["CompileLedger"] = []

_TLS = threading.local()


def tracing(fn_name: str) -> None:
    """Called from INSIDE jitted solver function bodies. Executes only
    while JAX traces the function (a cache miss — first compile or a
    retrace); the compiled program never runs it. No-op (one truthiness
    check on a module global) when no ledger is installed."""
    if not _LEDGERS:
        return
    for led in tuple(_LEDGERS):
        led._note_trace(fn_name)


def _watch_stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


class _NullWatch:
    """Shared no-op watch for sites whose scheduler has no observatory."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def result(self, _x) -> None:
        return None


NULL_WATCH = _NullWatch()


# ---------------------------------------------------------------------------
# compile/retrace ledger
# ---------------------------------------------------------------------------


class _FnStats:
    __slots__ = ("traces", "calls", "compile_s", "sigs", "last_sig")

    def __init__(self):
        self.traces = 0
        self.calls = 0
        self.compile_s = 0.0
        #: signature key -> call count (a host-side mirror of the jit
        #: cache's keyspace: shapes/dtypes/static flags)
        self.sigs: Dict[Tuple, int] = {}
        self.last_sig: Optional[Dict[str, object]] = None


def _sig_key(sig: Mapping[str, object]) -> Tuple:
    return tuple(sorted((k, repr(v)) for k, v in sig.items()))


def _sig_diff(
    old: Optional[Mapping[str, object]], new: Mapping[str, object]
) -> Dict[str, object]:
    if old is None:
        return {"first_call": True}
    out: Dict[str, object] = {}
    for k in sorted(set(old) | set(new)):
        a, b = old.get(k, "<absent>"), new.get(k, "<absent>")
        if repr(a) != repr(b):
            out[k] = [a, b]
    return out or {"identical_signature": True}


class _Watch:
    """One watched dispatch: signature + wall time + trace attribution.

    ``result()`` registers the dispatch's output; during an armed capture
    window the exit fences it (block_until_ready) and records a
    device-lane event."""

    __slots__ = (
        "dp", "fn", "sig", "cycle", "stage", "kind", "fired",
        "traced_fns", "_t0", "_out", "_ann",
    )

    def __init__(self, dp: "DevProf", fn: str, sig, cycle, stage, kind):
        self.dp = dp
        self.fn = fn
        self.sig = sig
        self.cycle = cycle
        self.stage = stage
        self.kind = kind
        self.fired = False
        self.traced_fns: List[str] = []
        self._out = None
        self._ann = None

    def result(self, x) -> None:
        self._out = x

    def __enter__(self) -> "_Watch":
        _watch_stack().append(self)
        if self.dp._capturing:
            self._ann = self.dp._annotation(self)
            if self._ann is not None:
                self._ann.__enter__()
        self._t0 = self.dp.clock()
        return self

    def __exit__(self, *exc) -> None:
        dp = self.dp
        fenced = False
        if dp._capturing and self._out is not None and exc[0] is None:
            try:
                _fence(self._out)
                fenced = True
            except Exception as fence_exc:  # noqa: BLE001 — capture is
                # best-effort: a fencing failure must not become a
                # scheduling failure, but it is never swallowed silently
                from .errors import report_exception

                report_exception("devprof.fence", fence_exc)
        t1 = dp.clock()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        st = _watch_stack()
        if st and st[-1] is self:
            st.pop()
        dp.ledger._observe_call(self, t1 - self._t0)
        if dp._capturing and fenced:
            dp._record_device_event(self, self._t0, t1)
        self._out = None


class CompileLedger:
    """Traces/compiles per jitted solver entry point, per signature.

    One trace == one compile on the solver path (every entry point is a
    top-level jit), so the two counters share a stream. ``install()``
    registers the trace-time hook; symmetric ``uninstall()`` for tests.
    """

    def __init__(self, registry=None, clock=time.perf_counter,
                 max_causes: int = 64):
        self.clock = clock
        self._lock = threading.Lock()
        self._fns: Dict[str, _FnStats] = {}  # guarded-by: self._lock
        #: recent retrace-cause records (which delta triggered each trace)
        self._causes: deque = deque(maxlen=max_causes)  # guarded-by: self._lock
        self._steady_mark: Optional[Dict[str, int]] = None  # guarded-by: self._lock
        self._compiles_counter = None
        self._compile_seconds = None
        if registry is not None:
            self._compiles_counter = registry.counter(
                "solver_compiles_total",
                "jitted solver entry-point (re)traces/compiles",
                labels=("fn",),
            )
            self._compile_seconds = registry.counter(
                "solver_compile_seconds",
                "wall seconds of calls that (re)traced, per entry point "
                "(trace+compile+first execute)",
                labels=("fn",),
            )

    def install(self) -> "CompileLedger":
        if self not in _LEDGERS:
            _LEDGERS.append(self)
        return self

    def uninstall(self) -> None:
        try:
            _LEDGERS.remove(self)
        except ValueError:
            pass

    # -- recording --

    def _note_trace(self, fn: str) -> None:
        """Runs at JAX trace time, on the tracing thread."""
        st = _watch_stack()
        watch = st[-1] if st else None
        with self._lock:
            stats = self._fns.setdefault(fn, _FnStats())
            stats.traces += 1
            cause: Dict[str, object] = {"fn": fn, "t": self.clock()}
            if watch is not None:
                watch.fired = True
                watch.traced_fns.append(fn)
                cause["watched_fn"] = watch.fn
                cause["cycle"] = watch.cycle
                cause["stage"] = watch.stage
                if fn == watch.fn:
                    cause["delta"] = _sig_diff(stats.last_sig, watch.sig)
            else:
                cause["delta"] = {"unwatched": True}
            if self._steady_mark is not None:
                cause["steady_state"] = True
            self._causes.append(cause)
        if self._compiles_counter is not None:
            self._compiles_counter.labels(fn=fn).inc()

    def _observe_call(self, watch: "_Watch", wall_s: float) -> None:
        with self._lock:
            stats = self._fns.setdefault(watch.fn, _FnStats())
            stats.calls += 1
            key = _sig_key(watch.sig)
            stats.sigs[key] = stats.sigs.get(key, 0) + 1
            stats.last_sig = dict(watch.sig)
            if watch.fired:
                stats.compile_s += wall_s
                # the cause record was appended at trace time; bill the
                # wall retroactively (tracing cannot know its own wall)
                for cause in reversed(self._causes):
                    if (
                        cause.get("watched_fn") == watch.fn
                        and "wall_s" not in cause
                    ):
                        cause["wall_s"] = round(wall_s, 6)
                        break
        if watch.fired and self._compile_seconds is not None:
            self._compile_seconds.labels(fn=watch.fn).inc(wall_s)

    # -- steady state --

    def mark_steady(self) -> None:
        """Declare warmup over: traces from here on are RETRACES the
        steady-state contract forbids (longrun assertion)."""
        with self._lock:
            self._steady_mark = {
                fn: s.traces for fn, s in self._fns.items()
            }

    def steady_retraces(self) -> int:
        with self._lock:
            if self._steady_mark is None:
                return 0
            return sum(
                s.traces - self._steady_mark.get(fn, 0)
                for fn, s in self._fns.items()
            )

    def steady_causes(self) -> List[dict]:
        with self._lock:
            return [
                dict(c) for c in self._causes if c.get("steady_state")
            ]

    def total_traces(self) -> int:
        with self._lock:
            return sum(s.traces for s in self._fns.values())

    # -- inspection --

    def report(self) -> Dict[str, object]:
        with self._lock:
            fns = {
                fn: {
                    "traces": s.traces,
                    "compiles": s.traces,
                    "calls": s.calls,
                    "signatures": len(s.sigs),
                    "compile_seconds": round(s.compile_s, 6),
                }
                for fn, s in sorted(self._fns.items())
            }
            causes = [dict(c) for c in self._causes]
            steady = self._steady_mark is not None
        return {
            "functions": fns,
            "recent_causes": causes,
            "steady_marked": steady,
            "steady_retraces": self.steady_retraces(),
        }

    def render(self) -> str:
        return json.dumps(self.report(), indent=1, sort_keys=True)


# ---------------------------------------------------------------------------
# device-memory census + leak sentinel
# ---------------------------------------------------------------------------


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of ``tree``: a tensor, a dataclass of tensors (None
    fields skipped), or a tuple, list or dict of those."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree) for t in _leaves(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _fence(tree) -> None:
    """Wait for the work that writes ``tree``'s CUDA tensors (the port's
    ``block_until_ready``); CPU tensors are ready when returned."""
    for dev in {t.device for t in _leaves(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


def _tree_nbytes(tree) -> int:
    """Total device bytes of a tree of tensors (None-tolerant)."""
    return sum(t.element_size() * t.numel() for t in _leaves(tree))


def live_summary() -> Tuple[int, int]:
    """(count, bytes) of the live blocks of ``torch.cuda``'s caching
    allocator on the current device; (0, 0) without a card."""
    if not torch.cuda.is_available():
        return 0, 0
    stats = torch.cuda.memory_stats()
    return (int(stats.get("active.all.current", 0)),
            int(stats.get("active_bytes.all.current", 0)))


def donation_dead(tree, result=None) -> bool:
    """True when the refresh that turned ``tree`` into ``result`` wrote
    in place: every tensor of ``result`` lies at its counterpart's
    ``data_ptr`` in ``tree`` (the port's form of the reference's donation
    check; a moved tensor means the refresh copied). Without ``result``
    there is nothing to compare, and the check passes."""
    if result is None:
        return True
    old, new = _leaves(tree), _leaves(result)
    return len(old) == len(new) and all(
        a.data_ptr() == b.data_ptr() for a, b in zip(old, new))


class DeviceMemoryCensus:
    """Per-cycle live-buffer accounting for the device-resident tables."""

    def __init__(self, registry=None):
        self.last: Dict[str, int] = {}
        self.last_live: Tuple[int, int] = (0, 0)
        self.donation_checks = 0
        self.donation_misses = 0
        self._bytes_gauge = None
        self._live_arrays_gauge = None
        self._live_bytes_gauge = None
        self._donation_missed = None
        if registry is not None:
            self._bytes_gauge = registry.gauge(
                "solver_device_bytes",
                "live device bytes held by each resident solver table",
                labels=("table",),
            )
            self._live_arrays_gauge = registry.gauge(
                "solver_live_arrays",
                "live CUDA allocator blocks at last census",
            )
            self._live_bytes_gauge = registry.gauge(
                "solver_live_bytes",
                "live CUDA allocator bytes at last census",
            )
            self._donation_missed = registry.counter(
                "solver_donation_missed_total",
                "donated resident buffers still alive after the scatter "
                "(the in-place update silently became a copy)",
            )

    def sample(self, tables: Mapping[str, object]) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for table, tree in tables.items():
            if tree is None:
                continue
            n = _tree_nbytes(tree)
            out[table] = n
            if self._bytes_gauge is not None:
                self._bytes_gauge.set(float(n), table=table)
        self.last = out
        count, total = live_summary()
        self.last_live = (count, total)
        if self._live_arrays_gauge is not None:
            self._live_arrays_gauge.set(float(count))
            self._live_bytes_gauge.set(float(total))
        return out

    def check_donation(self, donated_tree, result=None) -> bool:
        """Record one donation-effectiveness observation; returns
        effective (True = the refresh wrote ``donated_tree`` in place,
        ``result`` its output)."""
        ok = donation_dead(donated_tree, result)
        self.donation_checks += 1
        if not ok:
            self.donation_misses += 1
            if self._donation_missed is not None:
                self._donation_missed.inc()
        return ok


class LeakSentinel:
    """Monotone live-array growth detector for the chaos soak: one
    sample per incarnation boundary; strictly increasing totals across
    every boundary (beyond ``tolerance_bytes``) is a leak."""

    def __init__(self, tolerance_bytes: int = 1 << 20):
        self.tolerance_bytes = int(tolerance_bytes)
        self.samples: List[Tuple[str, int, int]] = []

    def sample(self, tag: str) -> Tuple[int, int]:
        import gc

        gc.collect()  # drop python-held garbage before counting device refs
        count, total = live_summary()
        self.samples.append((tag, count, total))
        return count, total

    def problems(self, min_samples: int = 3) -> List[str]:
        if len(self.samples) < min_samples:
            return []
        byts = [b for _t, _c, b in self.samples]
        growth = byts[-1] - byts[0]
        monotone = all(b2 > b1 for b1, b2 in zip(byts, byts[1:]))
        if monotone and growth > self.tolerance_bytes:
            return [
                "monotone live-array growth across incarnations: "
                + " -> ".join(
                    f"{t}={b}B" for t, _c, b in self.samples
                )
                + f" (+{growth}B > {self.tolerance_bytes}B tolerance)"
            ]
        return []


# ---------------------------------------------------------------------------
# the observatory handle a scheduler carries
# ---------------------------------------------------------------------------


class DevProf:
    """Per-scheduler solver observatory: ledger + capture window + census.

    Attach with ``BatchScheduler.attach_devprof``; multiple schedulers
    may share one instance (the bench's stage pass attaches the same
    observatory to warmup and measured instances so cold compiles land
    in one ledger)."""

    #: bound on retained device-lane events (a capture window over a
    #: long drain must not grow without bound)
    MAX_DEVICE_EVENTS = 16384

    def __init__(self, registry=None, clock=time.perf_counter):
        self.clock = clock
        self.ledger = CompileLedger(registry=registry, clock=clock)
        self.census = DeviceMemoryCensus(registry=registry)
        # NOT lock-guarded by design: a bounded deque with GIL-atomic
        # appends — the capture hot path must not serialize on the
        # capture-control lock
        self.device_events: deque = deque(maxlen=self.MAX_DEVICE_EVENTS)
        self._capture_remaining = 0  # guarded-by: self._lock
        self._capturing = False  # guarded-by: self._lock
        self._cycle_id = 0  # guarded-by: self._lock
        self._lock = threading.Lock()

    # -- install / watch --

    def install(self) -> "DevProf":
        self.ledger.install()
        return self

    def uninstall(self) -> None:
        self.ledger.uninstall()

    def watch(
        self,
        fn: str,
        cycle: Optional[int] = None,
        stage: str = "solve",
        kind: str = "device-compute",
        **sig,
    ) -> _Watch:
        """Context manager around one jitted dispatch. ``sig`` is the
        host-visible signature (shapes/flags) retraces are attributed
        to; ``kind`` buckets the op for the solve-residual breakdown
        (``device-compute`` vs ``transfer``)."""
        return _Watch(
            self, fn, sig,
            self._cycle_id if cycle is None else cycle,
            stage, kind,
        )

    # -- capture window --

    def capture(self, cycles: int) -> Dict[str, object]:
        """Arm an on-demand capture window: the next ``cycles``
        scheduling cycles run with fenced, device-lane-recorded
        dispatches (``/debug/profile?cycles=N``)."""
        with self._lock:
            self._capture_remaining = max(0, int(cycles))
            if self._capture_remaining == 0:
                self._capturing = False
        return self.status()

    def status(self) -> Dict[str, object]:
        return {
            "capturing": self._capturing,
            "cycles_remaining": self._capture_remaining,
            "device_events": len(self.device_events),
        }

    def cycle_begin(self, cycle_id: int) -> None:
        # the cycle stamp moves WITH the capture arm-check (koordlint
        # guarded-by finding GB001: the write raced a concurrently
        # armed /debug/profile capture outside the lock)
        with self._lock:
            self._cycle_id = int(cycle_id)
            if self._capture_remaining > 0:
                self._capturing = True

    def cycle_end(self, sched=None) -> None:
        with self._lock:
            if self._capturing:
                self._capture_remaining -= 1
                if self._capture_remaining <= 0:
                    self._capturing = False
        if sched is not None:
            self.census.sample(self._resident_tables(sched))

    @staticmethod
    def _resident_tables(sched) -> Dict[str, object]:
        def cached(attr):
            entry = getattr(sched, attr, None)
            return entry[1] if entry is not None else None

        return {
            "nodes": getattr(sched, "_resident_nodes", None),
            "nodes_window": cached("_window_cache"),
            "quota": cached("_quota_dev_cache"),
            "numa": cached("_numa_dev_cache"),
            "devices": cached("_device_dev_cache"),
        }

    def _annotation(self, watch: "_Watch"):
        """A ``torch.profiler.record_function`` range naming this dispatch
        in any concurrently-running profile (same vocabulary as the
        device-lane events)."""
        return torch.profiler.record_function(
            f"{watch.fn}:cycle={watch.cycle}:stage={watch.stage}"
        )

    def _record_device_event(
        self, watch: "_Watch", t0: float, t1: float
    ) -> None:
        self.device_events.append(
            {
                "fn": watch.fn,
                "cycle": watch.cycle,
                "stage": watch.stage,
                "kind": watch.kind,
                "t0": t0,
                "t1": t1,
                "compiled": watch.fired,
            }
        )

    # -- chrome-trace merge --

    def chrome_device_events(
        self, epoch: float, pid: int = 1, tid: int = 10_000
    ) -> List[dict]:
        """Device-lane Chrome events, re-based onto ``epoch`` (the
        owning tracer's epoch, same monotonic clock) so device ops line
        up under their host stage spans."""
        events: List[dict] = [
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {"name": "device"},
            }
        ]
        for ev in list(self.device_events):
            events.append(
                {
                    "name": ev["fn"],
                    "cat": "device",
                    "ph": "X",
                    "ts": round((ev["t0"] - epoch) * 1e6, 3),
                    "dur": round((ev["t1"] - ev["t0"]) * 1e6, 3),
                    "pid": pid,
                    "tid": tid,
                    "args": {
                        "cycle": ev["cycle"],
                        "stage": ev["stage"],
                        "kind": ev["kind"],
                        "compiled": ev["compiled"],
                    },
                }
            )
        return events

    def extend_chrome(self, doc: Dict[str, object], epoch: float) -> None:
        if self.device_events:
            doc["traceEvents"] = list(doc["traceEvents"]) + (
                self.chrome_device_events(epoch)
            )

    # -- the solve-residual breakdown --

    def breakdown_ms(self) -> Dict[str, object]:
        """Decompose the captured windows' solve residual: compile wall
        (from the ledger) vs fenced device-compute vs transfer, plus the
        device-compute total keyed by watch stage (``stage_ms``) so
        off-hot-path stages — e.g. the candidate-shortlist plan probe's
        ``shortlist`` stage — are visible separately from ``solve``."""
        compute = transfer = 0.0
        stages: Dict[str, float] = {}
        for ev in list(self.device_events):
            dur = (ev["t1"] - ev["t0"]) * 1e3
            if ev["kind"] == "transfer":
                transfer += dur
            else:
                compute += dur
                stages[ev["stage"]] = stages.get(ev["stage"], 0.0) + dur
        compile_s = sum(
            row["compile_seconds"]
            for row in self.ledger.report()["functions"].values()
        )
        return {
            "compile_ms": round(compile_s * 1e3, 3),
            "device_compute_ms": round(compute, 3),
            "transfer_ms": round(transfer, 3),
            "stage_ms": {
                k: round(v, 3) for k, v in sorted(stages.items())
            },
        }

    def render(self) -> str:
        return json.dumps(
            {
                "status": self.status(),
                "breakdown_ms": self.breakdown_ms(),
                "census": {
                    "tables_bytes": self.census.last,
                    "live_arrays": self.census.last_live[0],
                    "live_bytes": self.census.last_live[1],
                    "donation_checks": self.census.donation_checks,
                    "donation_misses": self.census.donation_misses,
                },
            },
            indent=1,
            sort_keys=True,
        )
