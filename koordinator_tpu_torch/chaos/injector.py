"""Named fault points with deterministic per-point schedules.

Mechanism
---------

Components call ``injector.fire("domain.point")`` at each fault point.
With nothing armed the call is one attribute read and a ``return False``
— cheap enough to leave wired in hot paths permanently (the
``tests/test_chaos.py`` overhead guard enforces this, mirroring the
``test_obs_overhead`` zero-allocation contract for disabled tracing).

Arming a point attaches a :class:`FaultSpec` schedule:

* ``probability`` — chance the point fires per evaluation (seeded RNG);
* ``at_hits``     — fire exactly on these 1-based evaluations instead
  (the deterministic form: "crash on the 3rd commit");
* ``latency_s``   — injected delay when the point fires;
* ``error``       — exception (instance, class or zero-arg factory)
  raised when the point fires;
* ``times``       — cap on total fires (``times=1`` = fire once).

Determinism: one ``random.Random(seed)`` drives every probabilistic
decision in arm order, and each fired fault appends ``(seq, point,
kind)`` to :attr:`FaultInjector.trace` — so an identical call sequence
under the same seed yields an identical fault trace (the chaos soak
asserts this property end to end).
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


class ChaosError(RuntimeError):
    """Default exception type raised by error-mode fault points."""


@dataclass
class FaultSpec:
    """Schedule for one named fault point."""

    point: str
    probability: float = 1.0
    latency_s: float = 0.0
    error: Optional[object] = None      # exception | class | () -> exception
    times: Optional[int] = None         # remaining fires; None = unlimited
    at_hits: Optional[frozenset] = None  # fire exactly on these evaluations
    hits: int = 0                       # evaluations seen
    fired: int = 0                      # faults actually injected


def _make_error(error: object, point: str) -> BaseException:
    if isinstance(error, BaseException):
        return error
    if isinstance(error, type) and issubclass(error, BaseException):
        return error(f"injected fault at {point}")
    if callable(error):
        return error()
    return ChaosError(f"injected fault at {point}: {error!r}")


class FaultInjector:
    """Seedable fault-point evaluator with a reproducible trace.

    ``fire(point)`` returns True when the fault fired and the *caller*
    implements its effect (drop the RPC, corrupt the row); latency and
    error effects are applied by the injector itself. ``sleep`` is
    injectable so tests can fake injected latency.
    """

    def __init__(
        self,
        seed: int = 0,
        sleep: Callable[[float], None] = time.sleep,
        counter=None,
    ):
        self.seed = seed
        self._rng = random.Random(seed)
        self._sleep = sleep
        self._specs: Dict[str, FaultSpec] = {}
        self._lock = threading.Lock()
        #: fast-path guard: False ⇒ fire() is one attribute read + return
        self.enabled = False
        #: (seq, point, kind) per injected fault — the fault trace
        self.trace: List[Tuple[int, str, str]] = []
        self._seq = 0
        #: optional ``fault_injected_total{point}`` Counter
        self.counter = counter

    # ---- arming ----

    def arm(
        self,
        point: str,
        probability: float = 1.0,
        latency_s: float = 0.0,
        error: Optional[object] = None,
        times: Optional[int] = None,
        at_hits: Optional[object] = None,
    ) -> FaultSpec:
        spec = FaultSpec(
            point=point,
            probability=probability,
            latency_s=latency_s,
            error=error,
            times=times,
            at_hits=frozenset(at_hits) if at_hits is not None else None,
        )
        with self._lock:
            self._specs[point] = spec
            self.enabled = True
        return spec

    def disarm(self, point: Optional[str] = None) -> None:
        with self._lock:
            if point is None:
                self._specs.clear()
            else:
                self._specs.pop(point, None)
            self.enabled = bool(self._specs)

    def spec(self, point: str) -> Optional[FaultSpec]:
        return self._specs.get(point)

    def bind_counter(self, counter) -> None:
        """Attach a ``fault_injected_total{point}`` Counter."""
        self.counter = counter

    # ---- evaluation ----

    def fire(self, point: str) -> bool:
        """Evaluate ``point`` against its armed schedule.

        Sleeps ``latency_s`` / raises ``error`` per the spec; returns
        True when the fault fired and the caller owns the effect.
        """
        if not self.enabled:
            return False
        return self._fire(point)

    def _fire(self, point: str) -> bool:
        with self._lock:
            spec = self._specs.get(point)
            if spec is None:
                return False
            spec.hits += 1
            if spec.times is not None and spec.fired >= spec.times:
                return False
            if spec.at_hits is not None:
                hit = spec.hits in spec.at_hits
            elif spec.probability >= 1.0:
                hit = True
            else:
                hit = self._rng.random() < spec.probability
            if not hit:
                return False
            spec.fired += 1
            self._seq += 1
            kind = (
                "error"
                if spec.error is not None
                else ("latency" if spec.latency_s > 0 else "fault")
            )
            self.trace.append((self._seq, point, kind))
            latency = spec.latency_s
            error = spec.error
        if self.counter is not None:
            self.counter.labels(point=point).inc()
        if latency > 0:
            self._sleep(latency)
        if error is not None:
            raise _make_error(error, point)
        return True

    # ---- introspection ----

    def fired_counts(self) -> Dict[str, int]:
        with self._lock:
            return {p: s.fired for p, s in self._specs.items()}


#: shared always-disabled injector for components with no chaos wired —
#: the default value of every ``chaos=`` parameter in the package
NULL_INJECTOR = FaultInjector()
