"""Framework extension machinery around the batch solver.

Rebuild of ``pkg/scheduler/frameworkext/`` — the reference's "framework of
the framework" that wraps every scheduling profile
(``frameworkext/interface.go:37-76``):

* **Transformer chain** (``interface.go:84-109``, impl
  ``framework_extender.go:222-315``): ``BeforePreFilter`` /
  ``BeforeFilter`` / ``BeforeScore`` hooks that may rewrite the pod or the
  cluster view before the built-in phases. Here the phases are tensor
  programs, so transformers rewrite host ``Pod`` objects before lowering
  (:meth:`FrameworkExtender.run_pre_batch_transformers`) or the lowered
  device batch/cost tensors (:meth:`run_batch_transformers`,
  :meth:`run_cost_transformers`).
* **SchedulerMonitor** (``scheduler_monitor.go:43-47,60+``): watchdog that
  records when each pod's scheduling attempt started; a sweep (default
  every 10 s) flags pods stuck longer than the 30 s timeout into the
  ``scheduling_timeout_total`` metric and the slow-pod log.
* **Error-handler dispatcher** (``errorhandler_dispatcher.go``, registered
  at ``app/server.go:439,450``): chained handlers intercept scheduling
  failures; the first handler returning True consumes the failure (the
  reference's reservation error handler works this way), otherwise the
  default handler records it.
* **Debug score/filter dump** (``frameworkext/debug.go:1-90``, flags at
  ``app/server.go:334-335``): per-batch top-N score tables and filter
  failure tallies, exposed over the services engine as
  ``/debug/flags/s``-style output.
* **Services engine** (``frameworkext/services/``): an HTTP server where
  plugins install handlers (``InstallAPIHandler``); serves ``/metrics``
  (Prometheus text), debug dumps, and per-plugin endpoints.
* **Scheduler metrics** (``pkg/scheduler/metrics/metrics.go:38-83``).

The NextPod hook (``interface.go:226-230``) lives in
``plugins.coscheduling.PodGroupManager.order_pending`` and the reservation
extension points in ``plugins.reservation`` — this module is the shared
spine they plug into.
"""

from __future__ import annotations

import http.server
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api.types import Pod
from ..obs import HealthRegistry, RejectionLog, Tracer, ensure_exceptions_counter
from ..utils.metrics import Registry

# ---------------------------------------------------------------------------
# Scheduler metrics (reference pkg/scheduler/metrics/metrics.go:38-83)
# ---------------------------------------------------------------------------


def scheduler_registry(reg: Optional[Registry] = None) -> Registry:
    """Create (or populate a caller-supplied) registry with the scheduler
    metric set — callers passing their own Registry still get every metric
    the batch cycle touches."""
    reg = reg or Registry(namespace="koord_scheduler")
    reg.counter(
        "scheduling_timeout_total",
        "pods whose scheduling attempt exceeded the monitor timeout",
    )
    reg.histogram(
        "elastic_quota_process_latency_seconds",
        "latency of elastic-quota admission passes",
    )
    reg.gauge(
        "waiting_gang_group_number",
        "gang groups currently gated before the solver",
    )
    reg.histogram(
        "solver_batch_latency_seconds",
        "device latency of one solver batch",
    )
    reg.counter("scheduled_pods_total", "pods bound by the batch scheduler")
    reg.counter("unschedulable_pods_total", "pods left unschedulable")
    reg.histogram(
        "cycle_latency_seconds",
        "wall time of one scheduling cycle",
    )
    reg.histogram(
        "stage_latency_seconds",
        "wall time per scheduling-cycle stage",
        labels=("stage",),
    )
    reg.counter(
        "rejections_total",
        "pods rejected, attributed to the killing stage/plugin/reason",
        labels=("stage", "plugin", "reason"),
    )
    reg.counter(
        "solver_h2d_rows_total",
        "node-axis rows uploaded to device for solver state (full "
        "re-lowers plus dirty-row scatters plus table uploads)",
    )
    reg.counter(
        "solver_state_cache_hits_total",
        "solver state lowerings served from the device-resident cache "
        "without a host re-lower/upload",
        labels=("table",),
    )
    # robustness PR: fault-injection + hardening visibility
    reg.counter(
        "fault_injected_total",
        "faults injected by the chaos layer, per named point",
        labels=("point",),
    )
    reg.counter(
        "solver_fallback_total",
        "solver dispatch failures, labeled by the ladder level fallen to "
        "(1 = per-chunk, 2 = host numpy reference)",
        labels=("level",),
    )
    reg.counter(
        "solver_shortlist_fallback_total",
        "solver rounds where the candidate-shortlist exactness bound could "
        "not prove the pruned node axis decision-identical and the round "
        "re-nominated over the full axis (cause: bound = a gathered best "
        "cost reached the plan-time bound; infeasible = a gated pod had no "
        "feasible shortlist candidate left)",
        labels=("cause",),
    )
    reg.counter(
        "cycle_deadline_exceeded_total",
        "scheduling cycles that hit the per-cycle deadline and deferred "
        "their remaining chunks to the next cycle",
    )
    reg.counter(
        "retry_attempts_total",
        "retries performed by shared RetryPolicy call sites",
        labels=("site",),
    )
    reg.counter(
        "commit_rollbacks_total",
        "chunk commits rolled back by the transactional Reserve journal",
    )
    # perf PR 4: cross-cycle solve pipelining + resident PodBatch interning
    reg.counter(
        "pod_intern_hits_total",
        "pod rows served from the interned (uid, spec-hash) lowering "
        "cache instead of a fresh per-pod parse",
    )
    reg.counter(
        "pipeline_speculation_total",
        "speculatively dispatched cross-cycle solves, by consume outcome",
        labels=("outcome",),
    )
    reg.counter(
        "pipeline_prepare_stalls_total",
        "prepare-worker stalls/deaths that degraded a pipelined cycle "
        "to the serial path",
    )
    # distributed-observability PR: gate introspection — which named
    # _gates_ok gate kept a cycle serial (the evidence base the "open
    # the speculation gates" roadmap item works from)
    reg.counter(
        "pipeline_gate_closed_total",
        "pipelined cycles forced serial, attributed to the specific "
        "closed speculation gate (one increment per closed gate per "
        "gated cycle)",
        labels=("gate",),
    )
    reg.gauge(
        "solver_pipeline_depth",
        "overlapped pipeline stages in flight at the last pump return "
        "(0 = idle; each in-flight batch counts 1 plus 1 more when its "
        "speculative solve is on device — depth>1 pipelining holds "
        "several)",
    )
    # open-the-gates PR: carried quota/NUMA/device/gang state validation
    reg.counter(
        "pipeline_carry_mismatch_total",
        "speculations discarded by consume-time carry validation, "
        "attributed to the diverging table (host/device divergence, a "
        "mid-pipeline subsystem arrival, or the pipeline.carry_mismatch "
        "chaos point)",
        labels=("table",),
    )
    reg.gauge(
        "claim_tombstones_live",
        "settled (tombstoned) uids currently retained by the cross-"
        "shard ClaimTable, sampled after each tombstone GC sweep",
    )
    # HA PR: fenced leader failover + write-ahead bind journal
    reg.counter(
        "leader_fenced_commits_total",
        "chunk commits rejected by the leadership fence (a deposed "
        "leader's in-flight commit, or an injected stale epoch)",
    )
    reg.counter(
        "leader_transitions_total",
        "leadership grants observed by this scheduler (takeovers and "
        "re-elections; renews do not count)",
    )
    reg.gauge(
        "leader_epoch",
        "fencing epoch of the current leadership grant "
        "(-1 = revoked/standby)",
    )
    reg.counter(
        "journal_writes_total",
        "write-ahead bind-journal records appended, by op",
        labels=("op",),
    )
    reg.counter(
        "journal_write_failures_total",
        "bind-journal appends refused (storage failure, injected "
        "journal.write_fail, or a stale-epoch write)",
    )
    reg.counter(
        "recovery_replayed_total",
        "assumed/bound charges re-installed from the bind journal on "
        "warm-standby takeover or crash restart",
    )
    reg.counter(
        "journal_compactions_total",
        "run-loop journal compactions (threshold-gated checkpoint "
        "rewrites; failed/crashed attempts are NOT counted — the live "
        "log is intact and the next threshold retries)",
    )
    # state-integrity PR: checksummed journals, verified checkpoints,
    # resident-state anti-entropy scrubbing
    reg.counter(
        "journal_corrupt_records_total",
        "journal-store records quarantined by load-time CRC/seq "
        "screening (media corruption or write holes; a torn final "
        "line is an unacknowledged append, not corruption), per store",
        labels=("store",),
    )
    reg.counter(
        "recovery_checkpoint_fallback_total",
        "recoveries that fell back to a full-history journal replay "
        "because a checkpoint recovery image failed its digest check "
        "(or the checkpoint.digest_mismatch chaos point forced it)",
    )
    reg.counter(
        "resident_scrub_rows_total",
        "device-resident rows audited by the anti-entropy scrubber's "
        "rotating window (re-lowered from host truth and compared "
        "bit-exact)",
    )
    reg.counter(
        "resident_scrub_divergence_total",
        "resident rows found diverged from host truth by the scrubber "
        "and self-healed through the dirty-row scatter, per table",
        labels=("table",),
    )
    # overload-control PR: QoS-aware admission + brownout ladder +
    # solver-channel circuit breaker
    reg.counter(
        "overload_shed_total",
        "queued/arriving pods shed by the QoS-aware admission "
        "controller (terminal: a shed pod leaves a resubmit ticket), "
        "per priority band",
        labels=("band",),
    )
    reg.counter(
        "overload_deferred_total",
        "pod arrivals parked by QoS-aware admission (band over its "
        "queue budget, or the brownout ladder defers the band)",
        labels=("band",),
    )
    reg.gauge(
        "brownout_level",
        "current brownout-ladder level (0 = normal … 4 = shed FREE)",
    )
    reg.counter(
        "brownout_transitions_total",
        "brownout-ladder level transitions, by direction",
        labels=("direction",),
    )
    reg.gauge(
        "solver_breaker_state",
        "snapshot-channel circuit-breaker state "
        "(0 = closed, 1 = open, 2 = half-open probe)",
    )
    reg.counter(
        "controller_decisions_total",
        "control-plane decisions recorded on the decision ledger, by "
        "controller and action",
        labels=("controller", "action"),
    )
    reg.counter(
        "shadow_divergence_total",
        "shadow-policy proposals that diverged from the acting "
        "controller's decision (shadows never act)",
        labels=("controller",),
    )
    reg.counter(
        "poison_quarantined_total",
        "pods blamed on the poison-quarantine ledger or rejected at the "
        "cycle gate because a live blame matched their spec fingerprint",
    )
    reg.counter(
        "poison_bisect_probes_total",
        "throwaway lowering probes run by the poison-batch bisection "
        "while isolating the minimal blame set",
    )
    reg.gauge(
        "snapshot_staleness_seconds",
        "age of the oldest undelivered informer event (0 when every "
        "watch is caught up; a connected-but-silent stall grows it)",
    )
    reg.counter(
        "stale_evidence_refusals_total",
        "evidence-hungry actions (preemption, descheduler eviction, "
        "topology split) refused because informer snapshots were stale",
        labels=("action",),
    )
    reg.counter(
        "crash_loop_backoffs_total",
        "boot backoffs imposed by the crash-loop governor after K rapid "
        "deaths within its horizon",
    )
    ensure_exceptions_counter(reg)
    return reg


# ---------------------------------------------------------------------------
# SchedulerMonitor (reference frameworkext/scheduler_monitor.go)
# ---------------------------------------------------------------------------


class SchedulerMonitor:
    """Watchdog over in-flight scheduling attempts.

    ``start_monitor(pod)`` when an attempt begins, ``complete(pod)`` when it
    ends (the reference wraps scheduleOne the same way); :meth:`sweep`
    (reference: every 10 s) counts attempts older than ``timeout_s``
    (reference: 30 s) into the timeout metric and returns them for logging.
    """

    def __init__(
        self,
        registry: Optional[Registry] = None,
        period_s: float = 10.0,
        timeout_s: float = 30.0,
    ):
        self.period_s = period_s
        self.timeout_s = timeout_s
        self.registry = scheduler_registry(registry)
        self._inflight: Dict[str, Tuple[str, float]] = {}
        self._lock = threading.Lock()
        self._last_sweep = 0.0
        self._sweeper: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def start_background(self) -> None:
        """Start the watchdog goroutine-analog: a daemon thread sweeping
        every ``period_s`` (the reference's 10 s wait.Until). The batch
        cycle is synchronous, so only a concurrent sweeper can flag a
        solver hang — in-flight pods whose attempt started > timeout ago."""
        if self._sweeper is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.period_s):
                for name in self.sweep():
                    print(f"koord-scheduler: pod {name} scheduling timeout")

        self._sweeper = threading.Thread(target=loop, daemon=True)
        self._sweeper.start()

    def stop_background(self) -> None:
        self._stop.set()
        self._sweeper = None

    def start_monitor(self, pod: Pod, now: Optional[float] = None) -> None:
        with self._lock:
            self._inflight[pod.meta.uid] = (
                pod.meta.name,
                time.monotonic() if now is None else now,
            )

    def complete(self, pod: Pod) -> None:
        with self._lock:
            self._inflight.pop(pod.meta.uid, None)

    def start_batch(self, pods: Sequence[Pod], now: Optional[float] = None) -> None:
        """One lock round for a whole cycle's admissions (the per-pod
        lock/dict pair was a visible slice of large batches)."""
        stamp = time.monotonic() if now is None else now
        with self._lock:
            inflight = self._inflight
            for pod in pods:
                inflight[pod.meta.uid] = (pod.meta.name, stamp)

    def complete_batch(self, pods: Sequence[Pod]) -> None:
        with self._lock:
            pop = self._inflight.pop
            for pod in pods:
                pop(pod.meta.uid, None)

    def sweep(self, now: Optional[float] = None) -> List[str]:
        """Returns names of timed-out pods; call at period_s cadence."""
        now = time.monotonic() if now is None else now
        if now - self._last_sweep < self.period_s:
            return []
        self._last_sweep = now
        timed_out = []
        with self._lock:
            for uid, (name, started) in list(self._inflight.items()):
                if now - started > self.timeout_s:
                    timed_out.append(name)
                    del self._inflight[uid]
        c = self.registry.get("scheduling_timeout_total")
        for _ in timed_out:
            c.inc()
        return timed_out


# ---------------------------------------------------------------------------
# Error-handler dispatcher (reference frameworkext/errorhandler_dispatcher.go)
# ---------------------------------------------------------------------------

ErrorHandler = Callable[[Pod, str], bool]


class ErrorHandlerDispatcher:
    """Chain of scheduling-failure interceptors.

    ``register_pre`` handlers run before the default handler; the first
    returning True consumes the failure (e.g. the reservation error handler
    re-queues the reserve pod instead of marking it failed). ``set_default``
    replaces the terminal handler.
    """

    def __init__(self, max_failures: int = 512):
        import collections

        self._pre: List[ErrorHandler] = []
        self._post: List[ErrorHandler] = []
        self._default: ErrorHandler = lambda pod, msg: False
        #: bounded recent-failure log (a standing set of unschedulable pods
        #: appends per cycle — same ring-buffer shape as the koordlet
        #: auditor)
        self.failures = collections.deque(maxlen=max_failures)

    def register_pre(self, handler: ErrorHandler) -> None:
        self._pre.append(handler)

    def register_post(self, handler: ErrorHandler) -> None:
        self._post.append(handler)

    def set_default(self, handler: ErrorHandler) -> None:
        self._default = handler

    def handle(self, pod: Pod, message: str) -> None:
        self.failures.append((pod.meta.name, message))
        for h in self._pre:
            if h(pod, message):
                return
        self._default(pod, message)
        for h in self._post:
            h(pod, message)


# ---------------------------------------------------------------------------
# Debug dumps (reference frameworkext/debug.go, /debug/flags/s|f)
# ---------------------------------------------------------------------------


@dataclass
class DebugScoresDumper:
    """Captures per-batch top-N nominations like the reference's score table
    (``debug.go:1-90``); enabled/size-controlled at runtime via the services
    engine (the reference's POST /debug/flags/s)."""

    top_n: int = 0  # 0 = disabled
    last_table: List[Dict[str, object]] = field(default_factory=list)

    def capture(
        self,
        pods: Sequence[Pod],
        node_names: Sequence[str],
        cost: np.ndarray,
        assignment: np.ndarray,
    ) -> None:
        if self.top_n <= 0 or cost.size == 0:
            return
        table: List[Dict[str, object]] = []
        k = min(self.top_n, cost.shape[1])
        for i, pod in enumerate(pods):
            row = cost[i]
            idx = np.argsort(row)[:k]
            table.append(
                {
                    "pod": pod.meta.name,
                    "assigned": (
                        node_names[assignment[i]] if assignment[i] >= 0 else ""
                    ),
                    "topScores": [
                        {"node": node_names[j], "cost": float(row[j])}
                        for j in idx
                        if np.isfinite(row[j])
                    ],
                }
            )
        self.last_table = table

    def render(self) -> str:
        return json.dumps(self.last_table, indent=1)


@dataclass
class DebugFiltersDumper:
    """Filter-failure tally per mask stage (reference logs which plugin
    filtered each node; the batched analog is a per-stage rejected-node
    count captured at solve time)."""

    enabled: bool = False
    last_tally: Dict[str, int] = field(default_factory=dict)

    def capture(self, stage_rejections: Dict[str, int]) -> None:
        if self.enabled:
            self.last_tally = dict(stage_rejections)

    def render(self) -> str:
        return json.dumps(self.last_tally, indent=1)


# ---------------------------------------------------------------------------
# Services engine (reference frameworkext/services/)
# ---------------------------------------------------------------------------


class ServicesEngine:
    """Plugin-installable HTTP API (reference gin engine,
    ``InstallAPIHandler`` at ``app/server.go:337``). Routes:
      /metrics               — Prometheus exposition
      /healthz               — per-subsystem degraded/ok aggregate (200/503)
      /trace                 — Chrome trace JSON (GET), sampling (POST)
      /slo                   — per-shard SLO state (targets, burn rates)
      /debug/scores          — last score table (GET), top-N (POST body int)
      /debug/filters         — filter tally
      /debug/rejections      — rejection records + per-stage tally
      /debug/pipeline        — speculation-gate introspection (which
                               named gate keeps this config serial)
      /debug/decisions       — controller decision ledger (inputs →
                               action → state per tick, crash-surviving)
      /debug/flightrecorder  — last-N per-cycle summaries (crash-
                               surviving black box)
      /debug/brownout        — brownout-ladder level, burn, transitions
      /debug/scrub           — anti-entropy scrubber state (cursor,
                               rows audited, divergences healed per
                               table, last window digests)
      /debug/compiles        — solver compile/retrace ledger (traces per
                               entry point, signature diffs, compile wall)
      /debug/profile         — solver observatory status; ?cycles=N arms
                               an on-demand device-timeline capture window
      /apis/v1/<plugin>/…    — handlers installed by plugins
    """

    def __init__(
        self,
        registry: Registry,
        scores: DebugScoresDumper,
        filters: DebugFiltersDumper,
        tracer: Optional[Tracer] = None,
        rejections: Optional[RejectionLog] = None,
        health: Optional[HealthRegistry] = None,
    ):
        self.registry = registry
        self.scores = scores
        self.filters = filters
        self.tracer = tracer or Tracer(enabled=False)
        self.rejections = rejections or RejectionLog()
        self.health = health
        #: wired post-construction by their owners: the SLO tracker
        #: (ShardedScheduler), the flight recorder (BatchScheduler.
        #: attach_flight_recorder) and the pipeline's gate-report
        #: callable (CyclePipeline) — None until then, and the routes
        #: answer accordingly
        self.slo = None
        self.flightrecorder = None
        self.decisions = None
        self.devprof = None
        #: brownout-ladder controller (overload-control PR) — wired by
        #: the stream/sharded scheduler when overload control is on
        self.brownout = None
        #: anti-entropy scrubber report callable (state-integrity PR) —
        #: wired by BatchScheduler when scrubbing is enabled
        self.scrub: Optional[Callable[[], Dict[str, object]]] = None
        self.gate_info: Optional[Callable[[], Dict[str, object]]] = None
        self._routes: Dict[str, Callable[[str], Tuple[int, str]]] = {}
        self._server: Optional[http.server.ThreadingHTTPServer] = None

    def install(
        self, plugin: str, path: str, handler: Callable[[str], Tuple[int, str]]
    ) -> None:
        self._routes[f"/apis/v1/{plugin}{path}"] = handler

    def dispatch(self, method: str, path: str, body: str = "") -> Tuple[int, str]:
        path, _, query = path.partition("?")
        if path == "/metrics":
            return 200, self.registry.expose()
        if path == "/healthz":
            if self.health is None:
                return 200, json.dumps({"ok": True, "subsystems": {}})
            return (200 if self.health.ok() else 503), self.health.render()
        if path == "/trace":
            if method == "POST":
                flag = body.strip()
                if flag not in ("0", "1", "true", "false"):
                    return 400, "bad sampling flag (want 0/1/true/false)"
                self.tracer.enabled = flag in ("1", "true")
                if not self.tracer.enabled:
                    self.tracer.clear()
                return 200, str(self.tracer.enabled)
            doc = self.tracer.to_chrome_trace()
            if self.devprof is not None:
                # device-lane events from the observatory's capture
                # window merge under their host stage spans (same
                # monotonic clock, re-based on the tracer's epoch)
                self.devprof.extend_chrome(doc, self.tracer.epoch)
            return 200, json.dumps(doc)
        if path == "/slo":
            if self.slo is None:
                return 404, "no SLO tracker wired"
            return 200, self.slo.render()
        if path == "/debug/pipeline":
            if self.gate_info is None:
                return 200, json.dumps({"pipelined": False})
            return 200, json.dumps(self.gate_info(), indent=1)
        if path == "/debug/flightrecorder":
            if self.flightrecorder is None:
                return 404, "no flight recorder wired"
            return 200, self.flightrecorder.render()
        if path == "/debug/decisions":
            if self.decisions is None:
                return 404, "no decision ledger wired"
            return 200, self.decisions.render()
        if path == "/debug/brownout":
            if self.brownout is None:
                return 404, "no brownout controller wired"
            return 200, self.brownout.render()
        if path == "/debug/scrub":
            if self.scrub is None:
                return 404, "no resident-state scrubber wired"
            return 200, json.dumps(self.scrub(), indent=1)
        if path == "/debug/compiles":
            if self.devprof is None:
                return 404, "no solver observatory wired"
            return 200, self.devprof.ledger.render()
        if path == "/debug/profile":
            if self.devprof is None:
                return 404, "no solver observatory wired"
            # /debug/profile?cycles=N (or POST body N) arms an on-demand
            # capture window: the next N cycles run with fenced,
            # device-lane-recorded solver dispatches
            params = dict(
                kv.split("=", 1) for kv in query.split("&") if "=" in kv
            )
            raw = params.get("cycles", body.strip() if method == "POST" else "")
            if raw:
                try:
                    cycles = int(raw)
                except ValueError:
                    return 400, "bad cycles (want an integer)"
                return 200, json.dumps(
                    self.devprof.capture(cycles), indent=1
                )
            return 200, self.devprof.render()
        if path == "/debug/rejections":
            if method == "POST":
                return 405, "rejection log is read-only"
            return 200, self.rejections.render()
        if path == "/debug/scores":
            if method == "POST":
                try:
                    self.scores.top_n = int(body.strip() or "0")
                except ValueError:
                    return 400, "bad top-n"
                return 200, str(self.scores.top_n)
            return 200, self.scores.render()
        if path == "/debug/filters":
            if method == "POST":
                self.filters.enabled = body.strip() in ("1", "true")
                return 200, str(self.filters.enabled)
            return 200, self.filters.render()
        handler = self._routes.get(path)
        if handler is None:
            return 404, "not found"
        return handler(body)

    def serve(self, host: str = "127.0.0.1", port: int = 0) -> int:
        engine = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def _run(self, method: str):
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length).decode() if length else ""
                code, text = engine.dispatch(method, self.path, body)
                data = text.encode()
                self.send_response(code)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                self._run("GET")

            def do_POST(self):
                self._run("POST")

            def log_message(self, *args):
                pass

        self._server = http.server.ThreadingHTTPServer((host, port), Handler)
        threading.Thread(target=self._server.serve_forever, daemon=True).start()
        return self._server.server_address[1]

    def shutdown(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server = None


# ---------------------------------------------------------------------------
# Scheduling queue + scheduler adapter
# (reference frameworkext/scheduler_adapter.go:85-190)
# ---------------------------------------------------------------------------


class SchedulingQueue:
    """Active / backoff / unschedulable pools with the queue operations the
    reference adapter exposes to plugins: ``activate`` pulls named pods
    back into the active pool (coscheduling uses this to co-activate a
    gang), ``move_all_to_active_or_backoff`` is the cluster-event flush
    (new node, reservation freed → every unschedulable pod retries)."""

    def __init__(self, backoff_s: float = 5.0):
        self.backoff_s = backoff_s
        self._active: Dict[str, Pod] = {}
        self._backoff: Dict[str, Tuple[Pod, float]] = {}
        self._unschedulable: Dict[str, Pod] = {}

    def remove(self, pod_uid: str) -> None:
        self._active.pop(pod_uid, None)
        self._backoff.pop(pod_uid, None)
        self._unschedulable.pop(pod_uid, None)

    def add(self, pod: Pod) -> None:
        # a pod lives in exactly one pool — re-adding (pod update,
        # forget_pod) must not leave a stale backoff/unschedulable entry
        # that would drain it a second time
        self.remove(pod.meta.uid)
        self._active[pod.meta.uid] = pod

    def mark_backoff(self, pod: Pod, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        self.remove(pod.meta.uid)
        self._backoff[pod.meta.uid] = (pod, now + self.backoff_s)

    def mark_unschedulable(self, pod: Pod) -> None:
        self.remove(pod.meta.uid)
        self._unschedulable[pod.meta.uid] = pod

    def activate(self, pod_uids: Sequence[str]) -> int:
        """Adapter ``Activate``: named pods skip backoff/unschedulable."""
        n = 0
        for uid in pod_uids:
            entry = self._backoff.pop(uid, (None, 0.0))[0]
            entry = entry or self._unschedulable.pop(uid, None)
            if entry is not None:
                self._active[uid] = entry
                n += 1
        return n

    def move_all_to_active_or_backoff(self) -> int:
        """Adapter ``MoveAllToActiveOrBackoffQueue`` on a cluster event."""
        n = len(self._unschedulable)
        self._active.update(self._unschedulable)
        self._unschedulable.clear()
        return n

    def drain_active(self, now: Optional[float] = None) -> List[Pod]:
        """Pods ready for the next batch: active + expired backoff."""
        now = time.monotonic() if now is None else now
        for uid, (pod, until) in list(self._backoff.items()):
            if now >= until:
                del self._backoff[uid]
                self._active[uid] = pod
        out = list(self._active.values())
        self._active.clear()
        return out

    @property
    def pending_counts(self) -> Dict[str, int]:
        return {
            "active": len(self._active),
            "backoff": len(self._backoff),
            "unschedulable": len(self._unschedulable),
        }


class SchedulerAdapter:
    """Plugin-facing facade over the snapshot (cache ops) and the queue
    (reference ``scheduler_adapter.go``: AddPod/AssumePod/ForgetPod/
    InvalidNodeInfo + queue Activate/MoveAll...). The snapshot's dense
    arrays double as the scheduler cache, so cache ops delegate there."""

    def __init__(self, snapshot, queue: Optional[SchedulingQueue] = None):
        self.snapshot = snapshot
        self.queue = queue or SchedulingQueue()

    def assume_pod(self, pod: Pod, node_name: str) -> bool:
        if not self.snapshot.assume_pod(pod, node_name):
            return False
        self.queue.remove(pod.meta.uid)
        return True

    def forget_pod(self, pod: Pod) -> None:
        self.snapshot.forget_pod(pod.meta.uid)
        self.queue.add(pod)

    def invalidate_node(self, node_name: str) -> None:
        """InvalidNodeInfo: metric-derived state for the node is stale —
        drop its freshness bit so masks degrade like an expired NodeMetric."""
        idx = self.snapshot.node_id(node_name)
        if idx is not None:
            self.snapshot.nodes.metric_fresh[idx] = False
            # direct array poke: the device-resident NodeState must see it
            self.snapshot.touch_rows([idx])


# ---------------------------------------------------------------------------
# FrameworkExtender
# ---------------------------------------------------------------------------

PodTransformer = Callable[[Pod], Optional[Pod]]


class FrameworkExtender:
    """The shared spine: transformer chains + monitor + error dispatch +
    debug + services, attached to a BatchScheduler.

    The reference builds one of these per scheduling profile and swaps it
    into ``sched.Profiles`` (``app/server.go:431-437``) so every framework
    call routes through it; here the BatchScheduler calls the hooks at the
    equivalent cycle points.
    """

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = scheduler_registry(registry)
        self.monitor = SchedulerMonitor(registry=self.registry)
        self.errors = ErrorHandlerDispatcher()
        self.scores = DebugScoresDumper()
        self.filters = DebugFiltersDumper()
        #: cycle tracer (sampling off by default; POST /trace flips it)
        self.tracer = Tracer(enabled=False)
        #: per-decision rejection attribution, counted into
        #: rejections_total{stage,plugin,reason}
        self.rejections = RejectionLog(
            counter=self.registry.get("rejections_total")
        )
        #: per-subsystem degraded/ok state served as /healthz — the
        #: fallback ladder, deadline degrade, commit journal and (when
        #: wired) the statehub informers all report here
        self.health = HealthRegistry()
        self.services = ServicesEngine(
            self.registry,
            self.scores,
            self.filters,
            tracer=self.tracer,
            rejections=self.rejections,
            health=self.health,
        )
        #: monotonically increasing scheduling-cycle id joining spans,
        #: metrics and rejection records for one cycle
        self._cycle_seq = 0
        self._pre_batch: List[PodTransformer] = []
        self._batch_transformers: List[Callable] = []
        self._cost_transformers: List[Callable] = []
        self._composed_cost: Optional[Callable] = None

    def begin_cycle(self) -> int:
        """Allocate the next cycle id (called once per external
        scheduling cycle; the preemption retry reuses its parent's)."""
        self._cycle_seq += 1
        return self._cycle_seq

    @property
    def current_cycle_id(self) -> int:
        return self._cycle_seq

    # -- registration (reference PluginFactoryProxy interception:
    # frameworkext/framework_extender_factory.go intercepts plugin
    # construction; plugins implementing transformer interfaces register)

    def register_pod_transformer(self, fn: PodTransformer) -> None:
        """BeforePreFilter analog: rewrite the host pod before lowering.
        Returning None drops the pod from the batch (unschedulable)."""
        self._pre_batch.append(fn)

    def register_batch_transformer(self, fn) -> None:
        """BeforeFilter analog: fn(PodBatch, NodeState) -> (PodBatch, NodeState)."""
        self._batch_transformers.append(fn)

    def register_cost_transformer(self, fn) -> None:
        """BeforeScore analog: fn(cost[P,N]) -> cost[P,N] (device-side)."""
        self._cost_transformers.append(fn)
        self._composed_cost = None

    @property
    def cost_transform(self):
        """Composed BeforeScore chain with a stable identity so the jitted
        solver (which hashes it as a static arg) does not retrace per call."""
        if not self._cost_transformers:
            return None
        if self._composed_cost is None:
            chain = tuple(self._cost_transformers)

            def composed(cost, _chain=chain):
                for fn in _chain:
                    cost = fn(cost)
                return cost

            self._composed_cost = composed
        return self._composed_cost

    # -- hook invocation from the batch cycle

    def run_pre_batch_transformers(
        self, pods: Sequence[Pod]
    ) -> Tuple[List[Pod], List[Pod]]:
        kept: List[Pod] = []
        dropped: List[Pod] = []
        for pod in pods:
            out: Optional[Pod] = pod
            for fn in self._pre_batch:
                out = fn(out)
                if out is None:
                    break
            if out is None:
                dropped.append(pod)
                self.errors.handle(pod, "rejected by pod transformer")
            else:
                kept.append(out)
        return kept, dropped

    def run_batch_transformers(self, pod_batch, node_state):
        for fn in self._batch_transformers:
            pod_batch, node_state = fn(pod_batch, node_state)
        return pod_batch, node_state

    def run_cost_transformers(self, cost):
        for fn in self._cost_transformers:
            cost = fn(cost)
        return cost
