"""Minimal Prometheus-style metrics library.

Reference: staging/src/k8s.io/component-base/metrics — Counter/Gauge/Histogram
vectors with stability levels, a shared registry, and text exposition. The
reference wraps prometheus/client_golang; this is a self-contained equivalent
with the same call-shape (WithLabelValues().Inc()/Observe()) flattened to
Python (inc(*labels) / observe(value, *labels)). A copy of the reference
package's module (kubernetes_tpu/utils/metrics.py).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

ALPHA = "ALPHA"
STABLE = "STABLE"

# scheduler histogram defaults mirror prometheus.ExponentialBuckets(0.001,2,15)
DEF_BUCKETS = tuple(0.001 * 2**i for i in range(15))


class _Metric:
    def __init__(self, name: str, help: str, label_names: tuple[str, ...] = (),
                 stability: str = ALPHA):
        self.name = name
        self.help = help
        self.label_names = label_names
        self.stability = stability
        self._lock = threading.Lock()

    def _key(self, labels: tuple[str, ...]) -> tuple[str, ...]:
        if len(labels) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, got {labels}"
            )
        return labels


class Counter(_Metric):
    type = "counter"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.values: dict[tuple[str, ...], float] = {}

    def inc(self, *labels: str, by: float = 1.0) -> None:
        key = self._key(labels)
        with self._lock:
            self.values[key] = self.values.get(key, 0.0) + by

    def get(self, *labels: str) -> float:
        return self.values.get(labels, 0.0)


class Gauge(_Metric):
    type = "gauge"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.values: dict[tuple[str, ...], float] = {}

    def set(self, value: float, *labels: str) -> None:
        with self._lock:
            self.values[self._key(labels)] = value

    def inc(self, *labels: str, by: float = 1.0) -> None:
        key = self._key(labels)
        with self._lock:
            self.values[key] = self.values.get(key, 0.0) + by

    def dec(self, *labels: str) -> None:
        self.inc(*labels, by=-1.0)

    def get(self, *labels: str) -> float:
        return self.values.get(labels, 0.0)


@dataclass
class _HistState:
    buckets: list[int]
    total: float = 0.0
    count: int = 0


class Histogram(_Metric):
    type = "histogram"

    def __init__(self, name, help, label_names=(), buckets=DEF_BUCKETS,
                 stability=ALPHA):
        super().__init__(name, help, label_names, stability)
        self.bounds = tuple(buckets)
        self.values: dict[tuple[str, ...], _HistState] = {}

    def observe(self, value: float, *labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            st = self.values.get(key)
            if st is None:
                st = self.values[key] = _HistState([0] * len(self.bounds))
            for i, b in enumerate(self.bounds):
                if value <= b:
                    st.buckets[i] += 1
            st.total += value
            st.count += 1

    def percentile(self, q: float, *labels: str) -> float:
        """Linear-interpolated estimate from bucket counts (for tests and the
        perf harness; the reference computes these in scheduler_perf/util.go)."""
        st = self.values.get(labels)
        if st is None or st.count == 0:
            return 0.0
        rank = q * st.count
        cum = 0
        for i, b in enumerate(self.bounds):
            prev_cum = cum
            cum = st.buckets[i]
            if cum >= rank:
                lo = self.bounds[i - 1] if i else 0.0
                span = cum - prev_cum
                frac = (rank - prev_cum) / span if span else 1.0
                return lo + (b - lo) * frac
        return self.bounds[-1]

    def average(self, *labels: str) -> float:
        st = self.values.get(labels)
        return st.total / st.count if st and st.count else 0.0

    def count(self, *labels: str) -> int:
        st = self.values.get(labels)
        return st.count if st else 0


class Registry:
    """component-base/metrics/legacyregistry equivalent."""

    def __init__(self) -> None:
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def register(self, metric: _Metric) -> _Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                return existing
            self._metrics[metric.name] = metric
            return metric

    def counter(self, name, help="", labels=(), stability=ALPHA) -> Counter:
        return self.register(Counter(name, help, tuple(labels), stability))  # type: ignore[return-value]

    def gauge(self, name, help="", labels=(), stability=ALPHA) -> Gauge:
        return self.register(Gauge(name, help, tuple(labels), stability))  # type: ignore[return-value]

    def histogram(self, name, help="", labels=(), buckets=DEF_BUCKETS,
                  stability=ALPHA) -> Histogram:
        return self.register(Histogram(name, help, tuple(labels), buckets, stability))  # type: ignore[return-value]

    def get(self, name: str) -> _Metric | None:
        return self._metrics.get(name)

    def expose(self) -> str:
        """Prometheus text exposition format (/metrics payload)."""
        lines: list[str] = []

        def fmt_labels(names, values, extra=()):
            pairs = [f'{n}="{v}"' for n, v in zip(names, values)] + list(extra)
            return "{" + ",".join(pairs) + "}" if pairs else ""

        for m in sorted(self._metrics.values(), key=lambda m: m.name):
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.type}")
            if isinstance(m, (Counter, Gauge)):
                for labels, v in sorted(m.values.items()):
                    lines.append(f"{m.name}{fmt_labels(m.label_names, labels)} {v}")
            elif isinstance(m, Histogram):
                for labels, st in sorted(m.values.items()):
                    for bound, n in zip(m.bounds, st.buckets):
                        le = 'le="%s"' % bound
                        lines.append(
                            f"{m.name}_bucket"
                            f"{fmt_labels(m.label_names, labels, [le])} {n}"
                        )
                    inf = 'le="+Inf"'
                    lines.append(
                        f"{m.name}_bucket"
                        f"{fmt_labels(m.label_names, labels, [inf])} {st.count}"
                    )
                    lines.append(f"{m.name}_sum{fmt_labels(m.label_names, labels)} {st.total}")
                    lines.append(f"{m.name}_count{fmt_labels(m.label_names, labels)} {st.count}")
        return "\n".join(lines) + "\n"
