"""Span tracing: the component-base/tracing (OpenTelemetry) role.

Reference: staging/src/k8s.io/component-base/tracing/tracing.go wraps OTel
spans; the apiserver emits a span per request (request-filter spans), the
kubelet around syncs. This module provides the same surface — start a
span, annotate attributes/events, nest children — with pluggable
exporters (the OTLP exporter's role): InMemoryExporter for tests and
introspection, or any callable consuming finished spans. Zero overhead
when no exporter is installed (the no-op tracer pattern).

A copy of the reference package's module (kubernetes_tpu/utils/tracing.py)
with one addition, `Tracer.add_span`: a finished span from two clock
readings the caller already took (the device backend's phase timers), so
a phase timed once lands in its stopwatch and its span alike.

    with tracer.span("HTTP GET /api/v1/Pod", verb="list") as sp:
        ...
        sp.event("cache hit")
"""

from __future__ import annotations

import logging
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class Span:
    name: str
    start: float
    end: float = 0.0
    attributes: dict = field(default_factory=dict)
    events: list = field(default_factory=list)  # (offset_s, message)
    children: list = field(default_factory=list)
    parent: "Span | None" = None

    @property
    def duration_s(self) -> float:
        return (self.end or time.perf_counter()) - self.start

    def event(self, message: str, **attrs) -> None:
        self.events.append((time.perf_counter() - self.start, message, attrs))

    def set(self, **attrs) -> None:
        self.attributes.update(attrs)


class Tracer:
    """Per-component tracer; spans nest through a thread-local stack (the
    context propagation OTel does via Context)."""

    def __init__(self, component: str, exporter=None):
        self.component = component
        self.exporter = exporter
        self._local = threading.local()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextmanager
    def span(self, name: str, **attrs):
        if self.exporter is None:
            # no-op fast path: tracing off costs one attribute lookup
            yield _NOOP_SPAN
            return
        sp = Span(name=name, start=time.perf_counter(), attributes=dict(attrs))
        stack = self._stack()
        if stack:
            sp.parent = stack[-1]
            stack[-1].children.append(sp)
        stack.append(sp)
        try:
            yield sp
        except Exception as e:
            sp.set(error=f"{type(e).__name__}: {e}")
            raise
        finally:
            sp.end = time.perf_counter()
            stack.pop()
            if sp.parent is None:
                self.exporter(sp)  # export ROOT spans (children ride along)


    def add_span(self, name: str, start: float, end: float, **attrs) -> None:
        """Record a finished span [start, end] (perf_counter seconds) as a
        child of the open span, or export it as a root when none is open.
        A no-op without an exporter."""
        if self.exporter is None:
            return
        sp = Span(name=name, start=start, end=end, attributes=dict(attrs))
        stack = self._stack()
        if stack:
            sp.parent = stack[-1]
            stack[-1].children.append(sp)
        else:
            self.exporter(sp)


class _NoopSpan:
    def event(self, message: str, **attrs) -> None:
        pass

    def set(self, **attrs) -> None:
        pass


_NOOP_SPAN = _NoopSpan()


def threshold_log_exporter(threshold: float, logger=None):
    """Exporter that logs a finished span's event timeline iff its total
    duration crossed `threshold` — the utiltrace LogIfLong contract
    (vendor/k8s.io/utils/trace/trace.go:208) expressed as a span exporter.
    The legacy utiltrace line format is preserved so existing log scrapers
    keep matching.

    Returns a callable(span) -> bool (whether it logged)."""
    log = logger or logging.getLogger("kubernetes_tpu_torch.trace")

    def export(sp: Span) -> bool:
        total = sp.duration_s
        if total < threshold:
            return False
        fields = ",".join(f"{k}={v}" for k, v in sp.attributes.items())
        lines = [f'Trace "{sp.name}" ({fields}): total {total * 1000:.1f}ms '
                 f'(threshold {threshold * 1000:.0f}ms):']
        prev = 0.0
        for off, msg, _attrs in sp.events:
            lines.append(f"  +{(off - prev) * 1000:.1f}ms {msg}")
            prev = off
        log.warning("\n".join(lines))
        return True

    return export


class InMemoryExporter:
    """Collects finished root spans (the testing exporter; also serves the
    /debug/traces introspection endpoint)."""

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._lock = threading.Lock()
        self.spans: list[Span] = []

    def __call__(self, span: Span) -> None:
        with self._lock:
            self.spans.append(span)
            if len(self.spans) > self.capacity:
                del self.spans[: self.capacity // 2]

    def find(self, name_prefix: str) -> list[Span]:
        with self._lock:
            return [s for s in self.spans if s.name.startswith(name_prefix)]

    def last(self, n: int | None = None) -> list[Span]:
        """The most recent n finished root spans (all when n is None)."""
        with self._lock:
            return list(self.spans[-n:] if n else self.spans)


# -- OTLP-shaped export --------------------------------------------------------


def spans_to_otlp(spans: list[Span], component: str = "kubernetes-tpu-torch") -> dict:
    """Serialize finished root spans (children included) into the OTLP/JSON
    trace shape (resourceSpans → scopeSpans → spans) so the /debug/traces
    payload drops straight into any OTLP-speaking viewer. Span/trace ids
    are synthesized by traversal order — this process never talked to a
    real collector, so there is no propagated context to preserve. Span
    times are exported as epoch nanos via one perf_counter→epoch offset
    captured per export call (spans record perf_counter internally)."""
    # perf_counter and time.time advance in lockstep; one offset converts
    epoch_offset = time.time() - time.perf_counter()

    def _attrs(d: dict) -> list[dict]:
        return [
            {"key": str(k), "value": {"stringValue": str(v)}}
            for k, v in d.items()
        ]

    out_spans: list[dict] = []
    counter = [0]

    def _walk(sp: Span, trace_id: str, parent_id: str) -> None:
        counter[0] += 1
        span_id = f"{counter[0]:016x}"
        start_ns = int((sp.start + epoch_offset) * 1e9)
        end_ns = int(((sp.end or time.perf_counter()) + epoch_offset) * 1e9)
        out_spans.append({
            "traceId": trace_id,
            "spanId": span_id,
            "parentSpanId": parent_id,
            "name": sp.name,
            "kind": 1,  # SPAN_KIND_INTERNAL
            "startTimeUnixNano": str(start_ns),
            "endTimeUnixNano": str(end_ns),
            "attributes": _attrs(sp.attributes),
            "events": [
                {
                    "timeUnixNano": str(int((sp.start + off + epoch_offset) * 1e9)),
                    "name": msg,
                    "attributes": _attrs(attrs),
                }
                for off, msg, attrs in sp.events
            ],
        })
        for child in sp.children:
            _walk(child, trace_id, span_id)

    for i, root in enumerate(spans, start=1):
        _walk(root, f"{i:032x}", "")

    return {
        "resourceSpans": [{
            "resource": {"attributes": _attrs({"service.name": component})},
            "scopeSpans": [{
                "scope": {"name": "kubernetes_tpu_torch.utils.tracing"},
                "spans": out_spans,
            }],
        }],
    }


# -- CLI: dump an exporter-shaped demo / inspect OTLP dumps --------------------


def main(argv: list[str] | None = None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(
        prog="python -m kubernetes_tpu_torch.utils.tracing",
        description="Span tracing introspection",
    )
    parser.add_argument("--dump", action="store_true",
                        help="run a short synthetic trace and print it as "
                             "OTLP JSON (the /debug/traces payload shape)")
    parser.add_argument("--last", type=int, default=None,
                        help="limit the dump to the last N root spans")
    args = parser.parse_args(argv)

    if not args.dump:
        parser.print_usage()
        return 2

    exporter = InMemoryExporter()
    tracer = Tracer("tracing-cli", exporter=exporter)
    with tracer.span("demo/schedule", pods="3") as sp:
        sp.event("queue popped", pods="3")
        with tracer.span("demo/kernel", tier="dedup"):
            pass
        with tracer.span("demo/bind"):
            sp.event("bind dispatched")
    print(json.dumps(spans_to_otlp(exporter.last(args.last),
                                   component="tracing-cli"), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
