"""Observability: scheduling-cycle tracing and rejection attribution.

A dependency-free tracing subsystem shared by the scheduler, koordlet,
descheduler and the simulators:

* :mod:`trace` — :class:`Span`/:class:`Tracer` (thread-safe, monotonic
  clock, nestable), ring-buffer retention, Chrome ``trace_event`` JSON
  export, and :class:`StageTimer` feeding a span and a
  ``utils.metrics.Histogram`` from one timing.
* :mod:`rejections` — first-class rejection-reason taxonomy
  (:class:`RejectStage`/:class:`RejectReason`) and the
  :class:`RejectionLog` ring buffer + ``rejections_total`` counter the
  scheduler threads from boolean-mask construction through commit
  revalidation.
* :mod:`devprof` — the solver observatory: compile/retrace ledger over
  the jitted solver entry points (``/debug/compiles``), on-demand
  device-timeline capture (``/debug/profile?cycles=N``) merged into the
  Chrome trace, and the device-memory census + leak sentinel.
"""

from .decisions import (
    DecisionLedger,
    action_label,
    controller_gaps,
    decision_trace,
)
from .devprof import (
    CompileLedger,
    DeviceMemoryCensus,
    DevProf,
    LeakSentinel,
)
from .errors import (
    default_error_registry,
    ensure_exceptions_counter,
    report_exception,
)
from .flightrecorder import FlightRecorder
from .health import HealthRegistry
from .lifecycle import LifecycleEvent, PodLifecycle, validate_timeline
from .rejections import (
    RejectionLog,
    RejectionRecord,
    RejectReason,
    RejectStage,
)
from .shadow import (
    NO_PROPOSAL,
    AlwaysDivergeShadow,
    MirrorShadow,
    ShadowPolicy,
    ShadowRegistry,
)
from .slo import SloTarget, SloTracker
from .trace import NULL_TRACER, Span, StageTimer, Tracer

__all__ = [
    "NO_PROPOSAL",
    "NULL_TRACER",
    "AlwaysDivergeShadow",
    "CompileLedger",
    "DecisionLedger",
    "DevProf",
    "DeviceMemoryCensus",
    "FlightRecorder",
    "MirrorShadow",
    "ShadowPolicy",
    "ShadowRegistry",
    "LeakSentinel",
    "HealthRegistry",
    "LifecycleEvent",
    "PodLifecycle",
    "RejectReason",
    "RejectStage",
    "RejectionLog",
    "RejectionRecord",
    "SloTarget",
    "SloTracker",
    "Span",
    "StageTimer",
    "Tracer",
    "action_label",
    "controller_gaps",
    "decision_trace",
    "default_error_registry",
    "ensure_exceptions_counter",
    "report_exception",
    "validate_timeline",
]
