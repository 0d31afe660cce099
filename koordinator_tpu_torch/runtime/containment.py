"""Gray-failure containment: poison-batch quarantine, crash-loop
governor, informer staleness watchdog (gray-failure containment PR).

Every robustness layer so far defends against components that *die* —
crashes (PR 5/6), drops (PR 3), torn records (PR 14). A production
control plane is more often taken down by things that are *wrong but
alive*:

* a **poison pod** whose lowering deterministically raises crashes the
  leader, is faithfully resubmitted by journal replay, and crashes every
  successor — a fleet-wide crash-loop born from ONE bad spec;
* a **crash-looping incarnation** burns boot after boot at full speed,
  each takeover re-paying recovery before dying again;
* a **connected-but-silent informer** stops delivering events while its
  watch stays open — every controller keeps acting on stale evidence
  with ``/healthz`` green.

This module holds the three containment mechanisms; the wiring lives in
``scheduler.batch_solver`` (bisection + cycle gate + stale-evidence
preemption refusal), ``runtime.ha`` (blame adoption BEFORE replay, boot
backoff), ``runtime.statehub``/``utils.informer`` (freshness plumbing)
and ``sim.longrun`` (the soak arm).

Design rules carried over from earlier PRs:

* both ledgers ride the PR 14 journal-store codec (they WRAP a
  ``MemoryJournalStore``/``FileJournalStore`` — sealed records, screened
  loads, ``journal_fsck``-able) instead of inventing a second format;
* the crash-loop decision is snapshot-once → pure :meth:`decide` →
  ``DecisionLedger.record`` (PR 15 contract, controller ``crashloop``);
* the watchdog takes an injectable clock and is driven from the caller's
  thread — soak arms stay deterministic (ROADMAP chaos rule).
"""

from __future__ import annotations

import dataclasses
import threading
import time as _time
from typing import Dict, List, Optional

from ..core import integrity
from ..core.journal import MemoryJournalStore
from ..obs.errors import report_exception

#: pods carrying this label are the chaos layer's poison carriers: the
#: ``solver.poison_batch`` point only raises while lowering a batch that
#: contains one (a label-blind fire would poison EVERY probe and the
#: bisection could never terminate). Real poison needs no label — any
#: deterministic lowering exception takes the same containment path.
POISON_LABEL = "koordinator.sh/poison-batch"


class PoisonBatchError(RuntimeError):
    """A batch lowering failed deterministically (poison spec or the
    injected ``solver.poison_batch`` fault)."""


class BootCrashError(RuntimeError):
    """A takeover died mid-boot (the ``scheduler.boot_crash`` fault or a
    real recovery crash) — caught by the coordinator's tick so the
    incarnation steps back to standby instead of killing the process."""


def _kv(d) -> object:
    """Canonical JSON-shaped view of a possibly-None mapping."""
    if isinstance(d, dict):
        return sorted((str(k), v) for k, v in d.items())
    return d


def spec_fingerprint(pod) -> str:
    """Restart-stable content digest of everything that makes a pod's
    *spec* (the quarantine redemption key). ``core.snapshot.
    pod_fingerprint`` is NOT usable here: it folds Python ``hash()``
    (PYTHONHASHSEED-randomized) — fine for an in-process row cache,
    useless for a ledger a successor incarnation must honor."""
    spec, meta = pod.spec, pod.meta
    return integrity.payload_digest(
        {
            "priority": spec.priority,
            "requests": _kv(spec.requests),
            "limits": _kv(spec.limits),
            "estimated": _kv(getattr(spec, "estimated", None)),
            "labels": _kv(meta.labels),
            "annotations": _kv(meta.annotations),
        }
    )


class QuarantineLedger:
    """Sealed blame ledger for poison pods, beside the shard journal.

    Records ride the journal-store codec: ``blame`` records carry
    ``{uid, fp, evidence, incarnation, cseq, cycle}``; a ``redeem``
    record lifts the blame (written when the pod reappears with a
    CHANGED spec fingerprint — the redeemable-ticket contract: fixing
    the spec is what re-admits, resubmitting the same bytes is not).

    The ledger lives beside the shard journal precisely so a takeover
    adopts blame BEFORE replaying the queue (``runtime.ha``): the
    predecessor's killer is rejected at the successor's cycle gate
    instead of crashing the successor too.
    """

    def __init__(self, store=None, incarnation: str = "", registry=None):
        self.store = store if store is not None else MemoryJournalStore(
            name="quarantine"
        )
        self.incarnation = incarnation
        self.registry = registry
        self._lock = threading.Lock()
        #: uid -> active blame record (blame minus redeem, replay order)
        self._blamed: Dict[str, dict] = {}
        self._seq = 0
        self._cseq = 0
        self._adopt_locked()

    # ---- load/adopt ----

    def _adopt_locked(self) -> None:
        try:
            records = self.store.load()
        except Exception as exc:  # noqa: BLE001 — ledger is best-effort
            report_exception(
                "containment.quarantine.load", exc, registry=self.registry
            )
            records = []
        blamed: Dict[str, dict] = {}
        for r in records:
            op = r.get("op")
            if op == "blame":
                blamed[r.get("uid", "")] = dict(r)
            elif op == "redeem":
                blamed.pop(r.get("uid", ""), None)
            if isinstance(r.get("seq"), int):
                self._seq = max(self._seq, r["seq"])
            if isinstance(r.get("cseq"), int):
                self._cseq = max(self._cseq, r["cseq"])
        self._blamed = blamed

    def adopt(self, incarnation: Optional[str] = None) -> int:
        """Takeover path: reload blame from the store (the predecessor's
        appends) and stamp this incarnation onto future records. Returns
        the number of active blames adopted — the successor's cycle gate
        is armed from this moment, BEFORE any queue replay."""
        with self._lock:
            if incarnation is not None:
                self.incarnation = incarnation
            self._adopt_locked()
            return len(self._blamed)

    # ---- write side ----

    def _append_locked(self, record: dict) -> None:
        self._seq += 1
        self._cseq += 1
        record["seq"] = self._seq
        record["cseq"] = self._cseq
        record["incarnation"] = self.incarnation
        try:
            self.store.append(record)
        except Exception as exc:  # noqa: BLE001 — blame must not crash
            report_exception(
                "containment.quarantine.append",
                exc,
                registry=self.registry,
            )

    def blame(
        self, uid: str, fp: str, evidence: str, cycle: int = -1
    ) -> bool:
        """Record blame for ``uid`` at spec fingerprint ``fp``.
        Idempotent per (uid, fp): the bisection re-isolating an
        already-blamed pod (replayed queue on a successor that adopted
        late) appends nothing. Returns True when a NEW blame landed."""
        with self._lock:
            prev = self._blamed.get(uid)
            if prev is not None and prev.get("fp") == fp:
                return False
            rec = {
                "op": "blame",
                "uid": uid,
                "fp": fp,
                "evidence": str(evidence)[:512],
                "cycle": int(cycle),
            }
            self._append_locked(rec)
            self._blamed[uid] = dict(rec)
            return True

    def blamed(self, uid: str, fp: str) -> bool:
        """Cycle-gate check: is ``uid`` quarantined at THIS fingerprint?
        A changed fingerprint is the redeemable ticket — the blame is
        lifted (a ``redeem`` record journals the decision) and the pod
        re-admits through the ordinary path."""
        with self._lock:
            rec = self._blamed.get(uid)
            if rec is None:
                return False
            if rec.get("fp") == fp:
                return True
            self._append_locked(
                {"op": "redeem", "uid": uid, "fp": fp, "cycle": -1}
            )
            self._blamed.pop(uid, None)
            return False

    # ---- read side ----

    def active(self) -> bool:
        """Cheap gate arm: any blame outstanding?"""
        return bool(self._blamed)

    def entries(self) -> Dict[str, dict]:
        """uid -> active blame record (copies; soak asserts read this)."""
        with self._lock:
            return {u: dict(r) for u, r in self._blamed.items()}


@dataclasses.dataclass
class BootPlan:
    """What the crash-loop governor decided a boot should look like."""

    degraded: bool = False
    backoff_s: float = 0.0
    rapid_deaths: int = 0
    #: DEGRADED boot knobs (only meaningful when ``degraded``): the
    #: brownout ladder is pinned at least this high, the pipeline runs
    #: depth 1 (serial), and the solver boots at the host-reference
    #: ladder floor with bisection armed from cycle one — a poison
    #: replay is then contained on the FIRST cycle instead of after
    #: another death.
    brownout_cap: int = 0
    pipeline_depth: int = 0
    bisect_armed: bool = False


class CrashLoopGovernor:
    """Incarnation boot/death ledger + exponential boot backoff.

    ``note_boot``/``note_death`` append sealed records to the crash
    ledger (same codec as the quarantine ledger). Each death runs the
    PR 15 decision contract — :meth:`snapshot` once, pure static
    :meth:`decide`, ``DecisionLedger.record("crashloop", ...)`` — and
    the resulting :class:`BootPlan` gates re-contention
    (:meth:`may_boot`) and shapes the next takeover (DEGRADED boot).
    """

    def __init__(
        self,
        store=None,
        k: int = 3,
        horizon_s: float = 30.0,
        base_backoff_s: float = 0.5,
        max_backoff_s: float = 8.0,
        clock=None,
        decisions=None,
        registry=None,
        incarnation: str = "",
        degraded_brownout_cap: int = 2,
    ):
        self.store = store if store is not None else MemoryJournalStore(
            name="crashloop"
        )
        self.k = max(1, int(k))
        self.horizon_s = float(horizon_s)
        self.base_backoff_s = float(base_backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.clock = clock or _time.monotonic
        #: obs.decisions.DecisionLedger (None = decisions unrecorded);
        #: spelled ``decisions`` per the decision-ledger lint contract
        self.decisions = decisions
        self.registry = registry
        self.incarnation = incarnation
        self.degraded_brownout_cap = int(degraded_brownout_cap)
        self._lock = threading.Lock()
        self._seq = 0
        self._deaths: List[float] = []
        self._boots = 0
        self._blocked_until = -float("inf")
        self._plan = BootPlan()
        self._load_locked()

    def _load_locked(self) -> None:
        try:
            records = self.store.load()
        except Exception as exc:  # noqa: BLE001 — ledger is best-effort
            report_exception(
                "containment.crashloop.load", exc, registry=self.registry
            )
            records = []
        for r in records:
            if isinstance(r.get("seq"), int):
                self._seq = max(self._seq, r["seq"])
            if r.get("op") == "death":
                self._deaths.append(float(r.get("t", 0.0)))
            elif r.get("op") == "boot":
                self._boots += 1

    def _append_locked(self, record: dict) -> None:
        self._seq += 1
        record["seq"] = self._seq
        record["incarnation"] = self.incarnation
        try:
            self.store.append(record)
        except Exception as exc:  # noqa: BLE001
            report_exception(
                "containment.crashloop.append",
                exc,
                registry=self.registry,
            )

    # ---- decision contract (PR 15) ----

    def snapshot(self, now: Optional[float] = None) -> dict:
        """The COMPLETE evidence :meth:`decide` reads, as one pure
        JSON-shaped dict (decision-observatory contract)."""
        if now is None:
            now = self.clock()
        with self._lock:
            return {
                "now": float(now),
                "deaths": [float(t) for t in self._deaths[-64:]],
                "boots": self._boots,
                "k": self.k,
                "horizon_s": self.horizon_s,
                "base_backoff_s": self.base_backoff_s,
                "max_backoff_s": self.max_backoff_s,
                "brownout_cap": self.degraded_brownout_cap,
            }

    @staticmethod
    def decide(inputs: dict):
        """Pure boot-governor decision from a snapshot — ``(action,
        state)``. K rapid deaths within the horizon trigger exponential
        backoff (``base * 2**(rapid-k)``, capped) and a DEGRADED boot
        plan; fewer deaths decide nothing."""
        now = float(inputs["now"])
        horizon = float(inputs["horizon_s"])
        rapid = sum(
            1
            for t in inputs["deaths"]
            if now - float(t) <= horizon
        )
        k = int(inputs["k"])
        degraded = rapid >= k
        backoff = 0.0
        if degraded:
            backoff = min(
                float(inputs["base_backoff_s"]) * (2.0 ** (rapid - k)),
                float(inputs["max_backoff_s"]),
            )
        action = {
            "op": "backoff" if degraded else "none",
            "backoff_s": backoff,
            "degraded": degraded,
            "rapid_deaths": rapid,
        }
        state = {
            "blocked_until": now + backoff,
            "degraded": degraded,
        }
        return action, state

    # ---- ledger surface ----

    def note_boot(self, incarnation: Optional[str] = None) -> None:
        """A takeover completed recovery and holds the grant."""
        now = self.clock()
        with self._lock:
            if incarnation is not None:
                self.incarnation = incarnation
            self._boots += 1
            self._append_locked({"op": "boot", "t": float(now)})

    def note_death(
        self, incarnation: Optional[str] = None, reason: str = ""
    ) -> BootPlan:
        """An incarnation died (boot crash or mid-grant): journal it,
        snapshot once, decide purely, record on the decision ledger,
        arm the backoff gate. Returns the plan for the NEXT boot."""
        now = self.clock()
        with self._lock:
            if incarnation is not None:
                self.incarnation = incarnation
            self._deaths.append(float(now))
            self._append_locked(
                {"op": "death", "t": float(now), "reason": str(reason)[:256]}
            )
        inputs = self.snapshot(now)
        action, state = self.decide(inputs)
        plan = BootPlan(
            degraded=bool(action["degraded"]),
            backoff_s=float(action["backoff_s"]),
            rapid_deaths=int(action["rapid_deaths"]),
            brownout_cap=(
                self.degraded_brownout_cap if action["degraded"] else 0
            ),
            pipeline_depth=1 if action["degraded"] else 0,
            bisect_armed=bool(action["degraded"]),
        )
        with self._lock:
            self._blocked_until = float(state["blocked_until"])
            self._plan = plan
        dl = self.decisions
        if dl is not None:
            dl.record(
                "crashloop",
                len(inputs["deaths"]),
                inputs,
                action,
                state,
                outcome={"reason": str(reason)[:128]},
            )
        if plan.backoff_s > 0 and self.registry is not None:
            c = self.registry.get("crash_loop_backoffs_total")
            if c is not None:
                c.inc()
        return plan

    def may_boot(self, now: Optional[float] = None) -> bool:
        """Backoff gate for re-contention: False while inside the
        exponential boot backoff armed by the last death. Pure read —
        the DECISION was made (and recorded) at :meth:`note_death`."""
        if now is None:
            now = self.clock()
        with self._lock:
            return float(now) >= self._blocked_until

    def boot_plan(self) -> BootPlan:
        """The plan the next takeover should boot under (healthy default
        until K rapid deaths decide otherwise)."""
        with self._lock:
            return self._plan

    @property
    def boots(self) -> int:
        with self._lock:
            return self._boots

    @property
    def deaths(self) -> int:
        with self._lock:
            return len(self._deaths)


class StalenessWatchdog:
    """Detects connected-but-silent informer streams.

    Per check (driven from the caller's thread — the run loop or the
    soak's virtual clock; no background thread, so soak arms stay
    deterministic): every informer's observed rv is compared against its
    tracker's current rv. A stream that stays behind longer than
    ``horizon_s`` is STALE — the ``snapshot_freshness`` health row
    degrades, ``snapshot_staleness_seconds`` exports the oldest lag's
    age, and :meth:`stale` arms the controller snapshots (preemption,
    descheduler eviction, topology split refuse; plain placement
    continues — placing on slightly-old capacity self-corrects at
    commit revalidation, evicting a live workload on silence does not).

    The lag test is rv-based, not wall-clock-based: a QUIET stream (no
    events published) is fresh by definition — silence is only gray
    failure when the tracker moved and the informer did not.
    """

    def __init__(
        self,
        horizon_s: float = 5.0,
        clock=None,
        health=None,
        registry=None,
    ):
        self.horizon_s = float(horizon_s)
        self.clock = clock or _time.monotonic
        self.health = health
        self.registry = registry
        self._hub = None
        #: informer name -> time its lag was first observed
        self._behind: Dict[str, float] = {}
        self._stale = False
        self._max_age = 0.0
        #: informer name -> {"lag": rv delta, "age_s": seconds behind}
        self.last_report: Dict[str, dict] = {}

    def watch_hub(self, hub) -> "StalenessWatchdog":
        """Observe every informer the hub has wired (re-reads
        ``hub.informers`` each check, so informers wired later — or a
        takeover's fresh set — are picked up automatically)."""
        self._hub = hub
        return self

    def check(self, now: Optional[float] = None) -> float:
        """One freshness sweep. Returns the oldest stream's staleness
        age in seconds (0.0 = every stream fresh)."""
        if now is None:
            now = self.clock()
        now = float(now)
        informers = list(self._hub.informers) if self._hub is not None else []
        live = set()
        report: Dict[str, dict] = {}
        max_age = 0.0
        for inf in informers:
            name = inf.name
            live.add(name)
            lag = inf.tracker.version() - inf.observed_rv()
            if lag <= 0:
                self._behind.pop(name, None)
                continue
            since = self._behind.setdefault(name, now)
            age = now - since
            report[name] = {"lag": int(lag), "age_s": age}
            max_age = max(max_age, age)
        # informers detached since the last check must not pin staleness
        for name in list(self._behind):
            if name not in live:
                self._behind.pop(name, None)
        self._max_age = max_age
        self.last_report = report
        self._stale = max_age > self.horizon_s
        if self.registry is not None:
            g = self.registry.get("snapshot_staleness_seconds")
            if g is not None:
                g.set(max_age)
        if self.health is not None:
            if self._stale:
                worst = sorted(
                    report, key=lambda n: -report[n]["age_s"]
                )[:3]
                self.health.set(
                    "snapshot_freshness",
                    False,
                    f"{len(report)} informer stream(s) silent behind "
                    f"their tracker > {self.horizon_s}s: "
                    + ", ".join(worst),
                )
            else:
                self.health.set("snapshot_freshness", True)
        return max_age

    def stale(self) -> bool:
        """Verdict of the LAST check — the single snapshot-able bit the
        controller snapshots fold in (koordlint ``staleness-snapshot``:
        controllers read this through their snapshot, never ad hoc)."""
        return self._stale

    @property
    def staleness_seconds(self) -> float:
        return self._max_age
