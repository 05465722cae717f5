"""Scheduler metrics: the §2.6 metric set over the shared registry.

Reference: pkg/scheduler/metrics/metrics.go (scheduleAttempts:225,
SchedulingAlgorithmLatency:251, FrameworkExtensionPointDuration:340,
PluginExecutionDuration:351, pendingPods:276, PodSchedulingSLIDuration:312,
PodSchedulingAttempts:323, CacheSize:394, unschedulableReasons:402, batching
BatchAttemptStats:297/GetNodeHintDuration:496, gang
podGroupScheduleAttempts:519) and metric_recorder.go MetricsAsyncRecorder.
A copy of the reference package's module (kubernetes_tpu/scheduler/metrics.py):
the same series, names and labels. The device series count the port's
CUDA kernels: a "compile" is a kernel's first use at a new static
configuration (the build when its library is not built yet, the load and
the first launch), and the memory gauge's cross-check source is "torch"
(torch.cuda.memory_allocated) where the reference reads jax.
"""

from __future__ import annotations

import threading
import time

from ..utils.metrics import Registry

SCHEDULED = "scheduled"
UNSCHEDULABLE = "unschedulable"
ERROR = "error"


class SchedulerMetrics:
    """The facade the scheduler/framework call sites use; every observation
    lands in a Prometheus-style registry exposable at /metrics."""

    def __init__(self, registry: Registry | None = None, profile: str = "default-scheduler"):
        self.registry = registry or Registry()
        self.profile = profile
        r = self.registry
        self.schedule_attempts = r.counter(
            "scheduler_schedule_attempts_total",
            "Number of attempts to schedule pods, by result",
            labels=("result", "profile"), stability="STABLE",
        )
        self.scheduling_attempt_duration = r.histogram(
            "scheduler_scheduling_attempt_duration_seconds",
            "Scheduling attempt latency (algorithm + binding)",
            labels=("result", "profile"), stability="STABLE",
        )
        self.scheduling_algorithm_duration = r.histogram(
            "scheduler_scheduling_algorithm_duration_seconds",
            "Scheduling algorithm latency", stability="ALPHA",
        )
        self.extension_point_duration = r.histogram(
            "scheduler_framework_extension_point_duration_seconds",
            "Latency per extension point",
            labels=("extension_point", "status", "profile"), stability="STABLE",
        )
        self.plugin_execution_duration = r.histogram(
            "scheduler_plugin_execution_duration_seconds",
            "Plugin execution latency per extension point",
            labels=("plugin", "extension_point"), stability="ALPHA",
        )
        self.pending_pods = r.gauge(
            "scheduler_pending_pods",
            "Pending pods by queue (active|backoff|unschedulable|gated)",
            labels=("queue",), stability="STABLE",
        )
        self.pod_scheduling_sli_duration = r.histogram(
            "scheduler_pod_scheduling_sli_duration_seconds",
            "E2e pod scheduling latency from first attempt, by attempt count",
            labels=("attempts",), stability="BETA",
        )
        self.pod_scheduling_attempts = r.histogram(
            "scheduler_pod_scheduling_attempts",
            "Attempts to successfully schedule a pod",
            buckets=(1, 2, 4, 8, 16), stability="STABLE",
        )
        self.cache_size = r.gauge(
            "scheduler_scheduler_cache_size",
            "Nodes/pods/assumed-pods in the cache", labels=("type",),
        )
        self.unschedulable_reasons = r.gauge(
            "scheduler_unschedulable_pods",
            "Unschedulable pods by plugin", labels=("plugin", "profile"),
        )
        self.queue_incoming_pods = r.counter(
            "scheduler_queue_incoming_pods_total",
            "Pods added to queues by event", labels=("queue", "event"),
        )
        self.preemption_attempts = r.counter(
            "scheduler_preemption_attempts_total", "Preemption attempts",
        )
        self.preemption_victims = r.histogram(
            "scheduler_preemption_victims", "Victims per preemption",
            buckets=(1, 2, 4, 8, 16, 32, 64),
        )
        self.goroutines = r.gauge(
            "scheduler_goroutines", "Worker threads by operation", labels=("operation",),
        )
        # batching (fork: metrics.go:297-310,496-517)
        self.batch_attempts = r.counter(
            "scheduler_batch_attempts_total",
            "OpportunisticBatching outcomes", labels=("result",),
        )
        self.get_node_hint_duration = r.histogram(
            "scheduler_get_node_hint_duration_seconds", "GetNodeHint latency",
        )
        self.store_schedule_results_duration = r.histogram(
            "scheduler_store_schedule_results_duration_seconds",
            "StoreScheduleResults latency",
        )
        # gang (fork: metrics.go:519-534)
        self.pod_group_schedule_attempts = r.counter(
            "scheduler_pod_group_schedule_attempts_total",
            "Pod-group cycle outcomes", labels=("result",),
        )
        self.pod_group_algorithm_duration = r.histogram(
            "scheduler_pod_group_scheduling_algorithm_duration_seconds",
            "Pod-group algorithm latency",
        )
        # async API dispatcher (metrics.go:438-457)
        self.async_api_calls = r.counter(
            "scheduler_async_api_call_execution_total",
            "Executed async API calls", labels=("call_type", "result"),
        )
        self.async_api_pending = r.gauge(
            "scheduler_pending_async_api_calls", "Queued async API calls",
        )
        self.async_api_retries = r.histogram(
            "scheduler_async_api_call_attempts",
            "Attempts per async API call that needed retrying",
            labels=("call_type",), buckets=(1, 2, 3, 4, 6, 8),
        )
        self.async_api_backoff_seconds = r.histogram(
            "scheduler_async_api_call_backoff_seconds",
            "Total backoff slept per retried async API call",
            labels=("call_type",),
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0),
        )
        # device-path circuit breaker (degradation ladder)
        self.circuit_breaker_state = r.gauge(
            "scheduler_tpu_circuit_breaker_state",
            "TPU device-path breaker state (0=closed 1=half_open 2=open)",
        )
        self.circuit_breaker_transitions = r.counter(
            "scheduler_tpu_circuit_breaker_transitions_total",
            "TPU device-path breaker state transitions",
            labels=("from_state", "to_state"),
        )
        self.wave_injected_faults = r.counter(
            "scheduler_tpu_wave_injected_faults_total",
            "Chaos faults fired during completed waves' flight windows",
        )
        # watch-stream partition self-heal (degradation ladder)
        self.watch_partitions_detected = r.counter(
            "scheduler_watch_partitions_detected_total",
            "Watch-stream partitions the informers detected from revision "
            "continuity and repaired by resync, by kind",
            labels=("kind",),
        )
        self.watch_partition_repair_latency = r.histogram(
            "scheduler_watch_partition_repair_latency_seconds",
            "Time from the first lost event's emit to the repairing resync",
            labels=("kind",),
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0),
        )
        # crash-restart recovery (README "Restart & recovery"): what a fresh
        # scheduler's reconcile() resolved from the previous incarnation's
        # mid-flight state, by recovery kind
        self.restart_recoveries = r.counter(
            "scheduler_restart_recoveries_total",
            "Mid-flight crash state a startup reconcile resolved against "
            "store truth, by recovery kind (adopted/forgotten/requeued/"
            "gang_adopt/gang_release/permit_cleared)",
            labels=("kind",),
        )
        # active-active scheduler fleet (scheduler/fleet.py): shard
        # ownership and lease failover
        self.fleet_shards_owned = r.gauge(
            "scheduler_fleet_shards_owned",
            "Shards this fleet member currently holds the lease for",
        )
        self.fleet_size = r.gauge(
            "scheduler_fleet_size",
            "Configured fleet size (total shard count)",
        )
        self.fleet_shard_failovers = r.counter(
            "scheduler_fleet_shard_failovers_total",
            "Orphaned shard leases this member took over from a dead peer",
            labels=("shard",),
        )
        self.fleet_failover_latency = r.histogram(
            "scheduler_fleet_failover_latency_seconds",
            "Lease expiry to shard adoption by a survivor",
            buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0),
        )
        # TPU backend (new: kernel-vs-host path split)
        self.kernel_dispatches = r.counter(
            "scheduler_tpu_kernel_dispatches_total",
            "Pods scheduled by the device kernel vs host fallback",
            labels=("path",),
        )
        # gang waves (README "Gang waves"): fast-path coverage of PodGroup
        # members — "device" rode a gang wave, "host" the per-pod gang cycle
        self.gang_pods_total = r.counter(
            "scheduler_tpu_gang_pods_total",
            "Gang members placed by the device gang wave vs host gang cycle",
            labels=("path",),
        )
        # wave flight recorder (new: per-wave telemetry, README "Observability")
        self.wave_phase_duration = r.histogram(
            "scheduler_tpu_wave_phase_duration_seconds",
            "Batched-wave latency by pipeline phase",
            labels=("phase",),
        )
        self.wave_duration = r.histogram(
            "scheduler_tpu_wave_duration_seconds",
            "End-to-end batched-wave latency (launch to bind)",
        )
        self.wave_dedup_ratio = r.gauge(
            "scheduler_tpu_wave_dedup_ratio",
            "distinct_signature_ratio of the most recent deduped wave",
        )
        self.signature_cache_hits = r.counter(
            "scheduler_tpu_signature_cache_hits_total",
            "Pods that rode a duplicate signature instead of a full score pass",
        )
        self.cross_wave_signatures = r.counter(
            "scheduler_tpu_cross_wave_signatures_total",
            "Signatures reusing device-resident score rows across wave "
            "boundaries, by outcome (hit|miss|eviction)",
            labels=("outcome",),
        )
        self.wave_fallbacks = r.counter(
            "scheduler_tpu_wave_fallbacks_total",
            "Waves that fell back to per-pod host scheduling, by reason",
            labels=("reason",),
        )
        self.slow_wave_captures_total = r.counter(
            "scheduler_tpu_slow_wave_captures_total",
            "Watchdog profile captures of waves exceeding their deadline",
        )
        self.sli_quantiles = r.gauge(
            "scheduler_pod_scheduling_sli_quantile_seconds",
            "Recorded p50/p99 of pod scheduling SLI duration",
            labels=("quantile",), stability="BETA",
        )
        # pod latency ledger (per-pod e2e decomposition; emitted by
        # scheduler/tpu/podlatency.py, whose LEDGER_SERIES names it)
        self.pod_e2e_latency = r.histogram(
            "scheduler_pod_e2e_latency_seconds",
            "Per-pod end-to-end scheduling latency by ledger segment",
            labels=("segment",),
        )
        self.pod_e2e_latency_quantiles = r.gauge(
            "scheduler_pod_e2e_latency_quantile_seconds",
            "Recorded p50/p99 of per-pod latency by ledger segment",
            labels=("segment", "quantile"), stability="BETA",
        )
        # device telemetry (transfer ledger / compile tracker / memory
        # watermark; emitted by scheduler/tpu/devicetelemetry.py, whose
        # LEDGER_SERIES names them)
        self.tpu_transfer_bytes = r.counter(
            "scheduler_tpu_transfer_bytes_total",
            "Bytes crossing the host<->device boundary, by direction "
            "(upload|fetch) and transfer plane",
            labels=("direction", "plane"),
        )
        self.tpu_wave_transfer_bytes = r.histogram(
            "scheduler_tpu_wave_transfer_bytes",
            "Per-wave host<->device transfer bytes, by direction",
            labels=("direction",),
            buckets=tuple(float(4 ** i * 1024) for i in range(10)),
        )
        self.tpu_compiles = r.counter(
            "scheduler_tpu_compiles_total",
            "Kernel first uses at a new static configuration (build, load "
            "and first launch), by kernel entry point and shape label",
            labels=("kernel", "shape"),
        )
        self.tpu_compiled_shapes = r.gauge(
            "scheduler_tpu_compiled_shapes",
            "Distinct compiled shape signatures per kernel entry point",
            labels=("kernel",),
        )
        self.tpu_device_memory = r.gauge(
            "scheduler_tpu_device_memory_bytes",
            "Device-resident plane-buffer bytes (source=ledger from seam "
            "accounting, source=torch from torch.cuda.memory_allocated on a "
            "card)",
            labels=("source",),
        )
        # pipeline stall profiler (per-wave wall-clock decomposition into
        # overlap + named stall reasons; emitted by
        # scheduler/tpu/stallprofiler.py, whose STALL_SERIES names them)
        self.pipeline_stall_seconds = r.histogram(
            "scheduler_tpu_pipeline_stall_seconds",
            "Per-wave streaming-pipeline stall seconds, by reason "
            "(queue_empty|capacity_gate|prep_serialized|device_busy|"
            "flush|bind_backpressure)",
            labels=("reason",),
        )
        self.pipeline_stall_total = r.gauge(
            "scheduler_tpu_pipeline_stall_total_seconds",
            "Cumulative streaming-pipeline stall seconds, by reason",
            labels=("reason",),
        )
        # event recorder (satellite: spill/aggregation visibility)
        self.events_total = r.counter(
            "scheduler_events_total",
            "Events emitted, by disposition (recorded|aggregated)",
            labels=("disposition",),
        )
        self.events_gc_pruned = r.counter(
            "scheduler_events_gc_pruned_total",
            "Event correlation series pruned by TTL garbage collection",
        )
        self._first_attempt: dict[str, float] = {}
        # exact SLI samples for the recorded-quantile gauges (bounded window;
        # the histogram's bucket interpolation is too coarse for a p99 SLO)
        self._sli_samples: list[float] = []
        self._attempt_counts: dict[str, int] = {}
        # plugin -> currently-unschedulable pod keys (true gauge semantics)
        self._unsched_by_plugin: dict[str, set[str]] = {}

    # -- call sites used by the framework/loop -------------------------------

    def observe_plugin(self, extension_point: str, plugin: str, seconds: float) -> None:
        self.plugin_execution_duration.observe(seconds, plugin, extension_point)

    def observe_extension_point(self, point: str, success: bool, seconds: float) -> None:
        self.extension_point_duration.observe(
            seconds, point, "Success" if success else "Error", self.profile
        )

    def attempt_started(self, qpi) -> None:
        key = qpi.pod.meta.key
        self._first_attempt.setdefault(key, time.time())
        self._attempt_counts[key] = self._attempt_counts.get(key, 0) + 1

    def pod_scheduled(self, qpi) -> None:
        key = qpi.pod.meta.key
        self.attempt_started(qpi)
        attempts = self._attempt_counts.pop(key, 1)
        start = self._first_attempt.pop(key, None)
        self.schedule_attempts.inc(SCHEDULED, self.profile)
        self.pod_scheduling_attempts.observe(attempts)
        if start is not None:
            sli = time.time() - start
            self.pod_scheduling_sli_duration.observe(sli, str(min(attempts, 16)))
            self._sli_samples.append(sli)
            if len(self._sli_samples) > 4096:
                del self._sli_samples[:2048]
        self._clear_unschedulable(key)

    def pod_unschedulable(self, qpi) -> None:
        self.attempt_started(qpi)
        self.schedule_attempts.inc(UNSCHEDULABLE, self.profile)
        key = qpi.pod.meta.key
        for plugin in qpi.unschedulable_plugins:
            pods = self._unsched_by_plugin.setdefault(plugin, set())
            if key not in pods:
                pods.add(key)
                self.unschedulable_reasons.set(len(pods), plugin, self.profile)

    def pod_error(self, qpi) -> None:
        self.attempt_started(qpi)
        self.schedule_attempts.inc(ERROR, self.profile)

    def _clear_unschedulable(self, key: str) -> None:
        for plugin, pods in self._unsched_by_plugin.items():
            if key in pods:
                pods.discard(key)
                self.unschedulable_reasons.set(len(pods), plugin, self.profile)

    def forget_pod(self, key: str) -> None:
        """Pod left the system (deleted) — drop all per-pod tracking so
        churn of permanently-unschedulable pods doesn't leak state."""
        self._first_attempt.pop(key, None)
        self._attempt_counts.pop(key, None)
        self._clear_unschedulable(key)

    def update_queue_gauges(self, active: int, backoff: int, unschedulable: int,
                            gated: int = 0) -> None:
        self.pending_pods.set(active, "active")
        self.pending_pods.set(backoff, "backoff")
        self.pending_pods.set(unschedulable, "unschedulable")
        self.pending_pods.set(gated, "gated")

    def update_cache_gauges(self, nodes: int, pods: int, assumed: int) -> None:
        self.cache_size.set(nodes, "nodes")
        self.cache_size.set(pods, "pods")
        self.cache_size.set(assumed, "assumed_pods")

    # -- wave flight recorder call sites -------------------------------------

    def observe_wave_phase(self, phase: str, seconds: float) -> None:
        self.wave_phase_duration.observe(seconds, phase)

    def wave_completed(self, record) -> None:
        """Land a finished WaveRecord's series (flightrecorder.end_wave)."""
        self.wave_duration.observe(record.duration_s)
        for phase, seconds in record.phases.items():
            self.wave_phase_duration.observe(seconds, phase)
        if record.distinct_signature_ratio is not None:
            self.wave_dedup_ratio.set(record.distinct_signature_ratio)
        if record.clones:
            self.signature_cache_hits.inc(by=record.clones)
        if record.xwave_hits:
            self.cross_wave_signatures.inc("hit", by=record.xwave_hits)
        if record.xwave_misses:
            self.cross_wave_signatures.inc("miss", by=record.xwave_misses)
        if record.xwave_evictions:
            self.cross_wave_signatures.inc("eviction", by=record.xwave_evictions)
        if record.fallback_reason:
            # reason cardinality is bounded: strip per-wave detail after ':'
            self.wave_fallbacks.inc(record.fallback_reason.split(":")[0])
        if record.injected_faults:
            self.wave_injected_faults.inc(by=record.injected_faults)
        # device transfer ledger: per-wave byte histograms (getattr-guarded
        # for records predating the telemetry fields)
        upload = getattr(record, "upload_bytes", 0)
        fetch = getattr(record, "fetch_bytes", 0)
        if upload or fetch:
            self.tpu_wave_transfer_bytes.observe(float(upload), "upload")
            self.tpu_wave_transfer_bytes.observe(float(fetch), "fetch")

    def gang_pods(self, path: str, n: int) -> None:
        """Gang members routed down `path` (flightrecorder.count_gang_pods
        is the one caller — wave_completed never lands this counter, so a
        gang wave's record can't double-count its members)."""
        self.gang_pods_total.inc(path, by=float(n))

    def breaker_transition(self, old_state: str, new_state: str) -> None:
        """TPU circuit-breaker state change (flightrecorder fan-out). The
        value map mirrors circuitbreaker.STATE_VALUES — inlined so importing
        metrics never drags the tpu package."""
        self.circuit_breaker_state.set(
            {"closed": 0, "half_open": 1, "open": 2}.get(new_state, -1)
        )
        self.circuit_breaker_transitions.inc(old_state, new_state)

    def slow_wave_captured(self) -> None:
        self.slow_wave_captures_total.inc()

    def partition_detected(self, kind: str, latency_s: float) -> None:
        """A watch-stream partition was detected and repaired
        (flightrecorder fan-out from the informer's partition observer)."""
        self.watch_partitions_detected.inc(kind)
        self.watch_partition_repair_latency.observe(latency_s, kind)

    def restart_recovery(self, kind: str, n: int = 1) -> None:
        """Startup reconcile resolved n pieces of mid-flight crash state of
        the given kind (flightrecorder fan-out from Scheduler.reconcile)."""
        if n:
            self.restart_recoveries.inc(kind, by=float(n))

    def fleet_ownership(self, owned: int, fleet_size: int) -> None:
        """This member's current shard count (flightrecorder fan-out from
        the fleet's acquire/release callbacks)."""
        self.fleet_shards_owned.set(float(owned))
        self.fleet_size.set(float(fleet_size))

    def fleet_failover(self, shard: int, latency_s: float) -> None:
        """An orphaned shard adopted from a dead peer, with lease-expiry
        to adoption latency."""
        self.fleet_shard_failovers.inc(str(shard))
        self.fleet_failover_latency.observe(latency_s)

    def update_sli_quantiles(self) -> None:
        """Record exact p50/p99 over the recent-sample window (the SLO the
        bench gates on; cheap — called once per wave, not per pod)."""
        samples = sorted(self._sli_samples)
        if not samples:
            return
        n = len(samples)
        self.sli_quantiles.set(samples[min(n - 1, int(0.50 * n))], "p50")
        self.sli_quantiles.set(samples[min(n - 1, int(0.99 * n))], "p99")

    # -- event recorder call sites -------------------------------------------

    def event_recorded(self, aggregated: bool) -> None:
        self.events_total.inc("aggregated" if aggregated else "recorded")

    def events_pruned(self, n: int) -> None:
        if n:
            self.events_gc_pruned.inc(by=n)

    def expose(self) -> str:
        return self.registry.expose()


class MetricsAsyncRecorder:
    """metric_recorder.go MetricsAsyncRecorder — observations buffered on the
    hot path, flushed by a background thread once per interval."""

    def __init__(self, metrics: SchedulerMetrics, interval: float = 1.0):
        self.metrics = metrics
        self.interval = interval
        self._buf: list[tuple] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def observe_plugin_duration_async(
        self, extension_point: str, plugin: str, seconds: float
    ) -> None:
        with self._lock:
            self._buf.append((extension_point, plugin, seconds))

    def flush(self) -> None:
        with self._lock:
            buf, self._buf = self._buf, []
        for point, plugin, seconds in buf:
            self.metrics.observe_plugin(point, plugin, seconds)

    def run(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.flush()
        self.flush()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
