"""Prometheus-style metrics registry shared by all components.

Rebuild of the reference's four metrics packages —
``pkg/scheduler/metrics/metrics.go:38-83`` (SchedulingTimeout,
ElasticQuotaProcessLatency, WaitingGangGroupNumber, …),
``pkg/koordlet/metrics/``, ``pkg/descheduler/metrics`` and
``pkg/util/metrics/koordmanager`` — as one small dependency-free registry
with Prometheus text exposition. Components create their own
:class:`Registry` (the reference registers against separate legacy/k8s
registries per binary) and the services engine serves ``/metrics``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple


def _escape_label(value: str) -> str:
    """Prometheus text-exposition label-value escaping."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _escape_help(text: str) -> str:
    """HELP-line escaping (backslash and newline only, per the spec)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(labels: Mapping[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _check_labels(label_names: Tuple[str, ...], labels: Mapping[str, str]) -> None:
    """Labels not declared at metric construction are a caller bug —
    silently dropping them used to record into the wrong series."""
    unknown = [k for k in labels if k not in label_names]
    if unknown:
        raise ValueError(
            f"unknown label(s) {unknown!r}; declared label names are "
            f"{list(label_names)!r}"
        )


@dataclass
class _Series:
    value: float = 0.0


class Counter:
    def __init__(self, name: str, help_: str, label_names: Sequence[str] = ()):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._series: Dict[Tuple[str, ...], _Series] = {}
        self._lock = threading.Lock()

    def labels(self, **labels: str) -> "_CounterChild":
        _check_labels(self.label_names, labels)
        key = tuple(str(labels.get(n, "")) for n in self.label_names)
        with self._lock:
            series = self._series.setdefault(key, _Series())
        return _CounterChild(series, self._lock)

    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def value(self, **labels: str) -> float:
        _check_labels(self.label_names, labels)
        key = tuple(str(labels.get(n, "")) for n in self.label_names)
        with self._lock:
            return self._series.get(key, _Series()).value

    def expose(self) -> List[str]:
        lines = [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} counter",
        ]
        with self._lock:
            for key, s in sorted(self._series.items()):
                labels = dict(zip(self.label_names, key))
                lines.append(f"{self.name}{_fmt_labels(labels)} {s.value}")
        return lines


class _CounterChild:
    def __init__(self, series: _Series, lock: threading.Lock):
        self._series = series
        self._lock = lock

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._series.value += amount


class Gauge(Counter):
    def labels(self, **labels: str) -> "_GaugeChild":
        _check_labels(self.label_names, labels)
        key = tuple(str(labels.get(n, "")) for n in self.label_names)
        with self._lock:
            series = self._series.setdefault(key, _Series())
        return _GaugeChild(series, self._lock)

    def set(self, value: float, **labels: str) -> None:
        self.labels(**labels).set(value)

    def expose(self) -> List[str]:
        lines = [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} gauge",
        ]
        with self._lock:
            for key, s in sorted(self._series.items()):
                labels = dict(zip(self.label_names, key))
                lines.append(f"{self.name}{_fmt_labels(labels)} {s.value}")
        return lines


class _GaugeChild(_CounterChild):
    def set(self, value: float) -> None:
        with self._lock:
            self._series.value = value


DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


@dataclass
class _HistSeries:
    counts: List[int] = field(default_factory=list)
    total: float = 0.0
    n: int = 0


class Histogram:
    def __init__(
        self,
        name: str,
        help_: str,
        label_names: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self.buckets = tuple(buckets)
        self._series: Dict[Tuple[str, ...], _HistSeries] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, **labels: str) -> None:
        _check_labels(self.label_names, labels)
        key = tuple(str(labels.get(n, "")) for n in self.label_names)
        with self._lock:
            s = self._series.setdefault(
                key, _HistSeries(counts=[0] * (len(self.buckets) + 1))
            )
            s.total += value
            s.n += 1
            for i, b in enumerate(self.buckets):
                if value <= b:
                    s.counts[i] += 1
                    break
            else:
                s.counts[-1] += 1

    def quantile(self, q: float, **labels: str) -> float:
        """Approximate quantile from bucket counts, linearly interpolated
        within the winning bucket (Prometheus ``histogram_quantile``
        semantics: the first bucket's lower edge is 0). A target landing
        in the ``+Inf`` overflow bucket stays ``+Inf`` — there is no
        upper edge to interpolate toward."""
        _check_labels(self.label_names, labels)
        key = tuple(str(labels.get(n, "")) for n in self.label_names)
        with self._lock:
            s = self._series.get(key)
            if s is None or s.n == 0:
                return 0.0
            target = q * s.n
            acc = 0
            for i, c in enumerate(s.counts[:-1]):
                if acc + c >= target and c > 0:
                    lower = self.buckets[i - 1] if i > 0 else 0.0
                    upper = self.buckets[i]
                    frac = (target - acc) / c
                    return lower + frac * (upper - lower)
                acc += c
            return float("inf")

    def expose(self) -> List[str]:
        lines = [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} histogram",
        ]
        with self._lock:
            for key, s in sorted(self._series.items()):
                labels = dict(zip(self.label_names, key))
                acc = 0
                for i, b in enumerate(self.buckets):
                    acc += s.counts[i]
                    le = dict(labels, le=repr(float(b)))
                    lines.append(f"{self.name}_bucket{_fmt_labels(le)} {acc}")
                le = dict(labels, le="+Inf")
                lines.append(f"{self.name}_bucket{_fmt_labels(le)} {s.n}")
                lines.append(f"{self.name}_sum{_fmt_labels(labels)} {s.total}")
                lines.append(f"{self.name}_count{_fmt_labels(labels)} {s.n}")
        return lines


class Registry:
    """Per-component metric registry with text exposition."""

    def __init__(self, namespace: str = ""):
        self.namespace = namespace
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _full(self, name: str) -> str:
        return f"{self.namespace}_{name}" if self.namespace else name

    def counter(self, name: str, help_: str = "", labels: Sequence[str] = ()) -> Counter:
        return self._get(name, Counter, lambda n: Counter(n, help_, labels))

    def gauge(self, name: str, help_: str = "", labels: Sequence[str] = ()) -> Gauge:
        return self._get(name, Gauge, lambda n: Gauge(n, help_, labels))

    def histogram(
        self,
        name: str,
        help_: str = "",
        labels: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get(
            name, Histogram, lambda n: Histogram(n, help_, labels, buckets)
        )

    def _get(self, name, kind, factory):
        full = self._full(name)
        with self._lock:
            m = self._metrics.get(full)
            if m is None:
                m = factory(full)
                self._metrics[full] = m
            elif type(m) is not kind:
                # exact-type check: Gauge subclasses Counter, so isinstance
                # would hand a Gauge to a counter() caller
                raise ValueError(
                    f"metric {full!r} already registered as "
                    f"{type(m).__name__}, requested {kind.__name__}"
                )
            return m

    def get(self, name: str) -> Optional[object]:
        return self._metrics.get(self._full(name))

    def expose(self) -> str:
        lines: List[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"
