"""Per-shard placement SLOs: targets, burn rate, and the ``/slo`` surface.

The ROADMAP's "serve millions of users" north star needs *objectives*,
not just timers: this module turns the lifecycle layer's per-pod signals
into per-shard SLO state a fleet operator (or the learned-policy reward
function) can read at a glance.

Three objectives per shard, mirroring what the partitioned control plane
can actually violate:

* ``p99_latency`` — p99 of per-pod placement latency (arrival→ack) over
  a rolling sample window must stay under the target;
* ``queue_age``   — the oldest queued pod's wait must stay under the
  target (backlog growth shows here before throughput numbers move);
* ``recovery``    — a takeover's time-to-recover (statehub resync +
  journal replay + re-lower) must stay under the target — the
  availability half of the failover story.

Accounting model: every ``observe_*`` call is one SLI sample, judged
against its target on arrival. Violations count into
``slo_violations_total{shard,slo}`` (long-run rate, survives window
eviction) and into the rolling window that yields the **burn rate** —
the fraction of recent samples violating divided by the objective's
error budget (burn > 1 means the budget is being spent faster than it
accrues; the standard multi-window alerting signal). ``/slo`` serves the
whole evaluation as JSON via the services engine.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Optional, Tuple


@dataclass
class SloTarget:
    """One objective: violate when the SLI exceeds ``threshold_s``.
    ``budget`` is the tolerated violation fraction (error budget):
    burn rate = violating fraction of the window / budget."""

    name: str
    threshold_s: float
    budget: float = 0.01
    #: rolling sample window size (samples, not seconds: the control
    #: plane's cadence is cycles, and a cycle count is deterministic
    #: under the sim clock where a wall window is not)
    window: int = 512
    #: optional TIME horizon (tracker-clock units) on top of the count
    #: window (overload-control PR): samples older than this are
    #: excluded from the burn/p99 evaluation. Without it, an objective
    #: that stops receiving samples (e.g. placement latency once a
    #: browning fleet defers everything) freezes at its WORST window
    #: forever — and a burn-driven controller can never observe
    #: recovery. None keeps the pure count-window semantics.
    max_age_s: Optional[float] = None
    #: burn evidence floor: fewer fresh samples than this evaluate to
    #: burn 0 (a couple of stragglers in an otherwise-empty horizon
    #: must not swing a burn-driven controller to its extremes)
    min_samples: int = 1


def default_targets() -> Tuple[SloTarget, ...]:
    """Defaults sized for the latency_stream operating point: one-cycle
    placement at a few ms/cycle, sub-second backlog waits, and the
    ~150 ms warm takeover the recovery bench measures (10x headroom)."""
    return (
        SloTarget("p99_latency", threshold_s=1.0, budget=0.01),
        SloTarget("queue_age", threshold_s=5.0, budget=0.05),
        SloTarget("recovery", threshold_s=2.0, budget=0.10),
    )


@dataclass
class _Series:
    #: (value, violated, observed-at) on the tracker's clock
    samples: Deque[Tuple[float, bool, float]] = field(default_factory=deque)
    violations: int = 0
    total: int = 0
    worst: float = 0.0
    last: float = 0.0


class SloTracker:
    """Thread-safe per-(shard, slo) SLI accounting.

    ``registry`` receives ``slo_violations_total{shard,slo}``; pass the
    fleet registry so violations land in the merged scrape. ``clock``
    defaults to ``time.perf_counter`` — the SAME domain as the stream's
    arrival stamps and the tracer, because queue-age samples are
    DIFFERENCES against those stamps (a wall-clock default would make
    every default-wired queue-age sample ``time() - perf_counter()``,
    i.e. garbage); inject the sim clock for deterministic soaks."""

    def __init__(
        self,
        registry=None,
        targets: Optional[Tuple[SloTarget, ...]] = None,
        clock=time.perf_counter,
    ):
        self.clock = clock
        self.targets: Dict[str, SloTarget] = {
            t.name: t for t in (targets or default_targets())
        }
        self._series: Dict[Tuple[int, str], _Series] = {}  # guarded-by: self._lock
        self._lock = threading.Lock()
        self.counter = None
        if registry is not None:
            self.counter = registry.counter(
                "slo_violations_total",
                "SLI samples that violated their per-shard objective",
                labels=("shard", "slo"),
            )

    # ---- sample ingestion ----

    def _observe(self, shard: int, slo: str, value_s: float) -> bool:
        tgt = self.targets.get(slo)
        if tgt is None:
            raise ValueError(f"unknown SLO {slo!r}")
        bad = value_s > tgt.threshold_s
        with self._lock:
            s = self._series.setdefault((int(shard), slo), _Series())
            s.samples.append((value_s, bad, self.clock()))
            while len(s.samples) > tgt.window:
                s.samples.popleft()
            s.total += 1
            s.last = value_s
            s.worst = max(s.worst, value_s)
            if bad:
                s.violations += 1
        if bad and self.counter is not None:
            self.counter.labels(shard=str(shard), slo=slo).inc()
        return bad

    def observe_latency(self, shard: int, seconds: float) -> bool:
        """One pod's placement latency (arrival→ack)."""
        return self._observe(shard, "p99_latency", seconds)

    def observe_queue_age(self, shard: int, seconds: float) -> bool:
        """Age of the OLDEST pod in the shard's queue at pump time."""
        return self._observe(shard, "queue_age", seconds)

    def observe_recovery(self, shard: int, seconds: float) -> bool:
        """One takeover's time-to-recover on the shard."""
        return self._observe(shard, "recovery", seconds)

    # ---- evaluation ----

    @staticmethod
    def _p99(values) -> float:
        if not values:
            return 0.0
        ordered = sorted(values)
        # nearest-rank p99: rank = ceil(0.99 * n), 1-based (no numpy
        # dependency in obs/). int(0.99*n) would be off by one whenever
        # n is a multiple of 100 — index n-1 IS the max, i.e. p100
        rank = -((-99 * len(ordered)) // 100)  # ceil without math
        return ordered[max(0, rank - 1)]

    def _fresh(self, samples, tgt: SloTarget, now: float):
        """The evaluable slice of a window: all of it, or — when the
        objective carries a time horizon — only samples young enough."""
        if tgt.max_age_s is None:
            return list(samples)
        horizon = now - tgt.max_age_s
        return [s for s in samples if s[2] >= horizon]

    def evaluate(self) -> Dict[str, Dict[str, dict]]:
        """Current state per shard per objective: target, window p99,
        last/worst sample, violation count, burn rate, ok flag."""
        now = self.clock()
        with self._lock:
            series = {
                k: (list(s.samples), s.violations, s.total, s.worst, s.last)
                for k, s in self._series.items()
            }
        out: Dict[str, Dict[str, dict]] = {}
        for (shard, slo), (samples, viol, total, worst, last) in sorted(
            series.items()
        ):
            tgt = self.targets[slo]
            samples = self._fresh(samples, tgt, now)
            window_bad = sum(1 for _v, bad, _t in samples if bad)
            frac = (
                window_bad / len(samples)
                if len(samples) >= tgt.min_samples
                else 0.0
            )
            burn = frac / tgt.budget if tgt.budget > 0 else 0.0
            out.setdefault(str(shard), {})[slo] = {
                "target_s": tgt.threshold_s,
                "budget": tgt.budget,
                "window_p99_s": round(
                    self._p99([v for v, _b, _t in samples]), 6
                ),
                "last_s": round(last, 6),
                "worst_s": round(worst, 6),
                "samples": total,
                "violations": viol,
                "burn_rate": round(burn, 4),
                "ok": burn <= 1.0,
            }
        return out

    def burn_rate(self, shard: int, slo: str) -> float:
        """One (shard, objective) burn rate without materializing the
        whole :meth:`evaluate` payload — the topology controller's
        per-tick read (elastic-topology PR): burn > 1 on a shard's
        placement objectives is the scale-out signal."""
        tgt = self.targets.get(slo)
        if tgt is None:
            raise ValueError(f"unknown SLO {slo!r}")
        now = self.clock()
        with self._lock:
            s = self._series.get((int(shard), slo))
            if s is None or not s.samples:
                return 0.0
            samples = self._fresh(s.samples, tgt, now)
            if len(samples) < tgt.min_samples or not samples:
                return 0.0
            frac = sum(1 for _v, bad, _t in samples if bad) / len(samples)
        return frac / tgt.budget if tgt.budget > 0 else 0.0

    def ok(self) -> bool:
        """True while every shard's every objective burns within budget."""
        return all(
            row["ok"]
            for shard in self.evaluate().values()
            for row in shard.values()
        )

    def render(self) -> str:
        ev = self.evaluate()
        return json.dumps(
            {
                "ok": all(
                    row["ok"] for sh in ev.values() for row in sh.values()
                ),
                "targets": {
                    n: {"threshold_s": t.threshold_s, "budget": t.budget}
                    for n, t in sorted(self.targets.items())
                },
                "shards": ev,
            },
            indent=1,
            sort_keys=True,
        )
