"""Scheduler CLI/server: config loading, leader election, health + metrics.

Reference: cmd/kube-scheduler/app/server.go (NewSchedulerCommand:93, Run:174,
leader election :301-345, healthz/metrics mux :367-390). argparse stands in
for cobra; the serving mux exposes /healthz, /readyz, /metrics and the
zpages (/configz, /statusz, /flagz, /debug/pprof/profile,
/debug/flightrecorder, /debug/podlatency, /debug/devicetelemetry,
/debug/stalls, /debug/traces).

    python -m kubernetes_tpu_torch.cmd.scheduler --config FILE --port 10259

A copy of the reference package's module (kubernetes_tpu/cmd/scheduler.py)
for the port's Scheduler, which runs on `device` ("cuda" unless a caller
passes "cpu", as the tests do; `main()` has no CPU switch). Departures:

- the reference's persistent XLA cache call has no counterpart: the
  port's kernel libraries are built once into a hash-keyed directory
  (ops/cuda.py), which a restart reuses;
- a failure is never swallowed: when `start()` (the informer sync, the
  reconcile and the warmup, which builds and launches every kernel) or the
  scheduling thread raises, the server records it, /readyz answers 503
  and /healthz 500 with the error, `run(block=True)` re-raises it and
  `wait_ready` raises it. /readyz answers 200 only after `start()` has
  returned (and, with leader election on, while this instance leads);
- the scheduling thread places waves when the profile asks for them
  (waveSize > 0: `schedule_wave`, as `Scheduler.schedule_pending` does);
  the reference's thread pops one pod per cycle whatever waveSize says;
- `clock` (optional) is the Scheduler's clock;
- `main()` stops cleanly on SIGTERM (shutdown, exit 0).
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..config.types import BACKENDS, SchedulerConfiguration, load_config_file
from ..scheduler.metrics import SchedulerMetrics
from ..scheduler.scheduler import Profile, Scheduler
from ..store.store import Store
from ..utils.featuregate import FeatureGate

_BAD = object()  # a query argument that was answered with 400


class SchedulerServer:
    """One running scheduler instance + its serving mux."""

    def __init__(self, store: Store, config: SchedulerConfiguration,
                 identity: str = "scheduler-0", fleet_size: int = 1,
                 shard_id: int | None = None, device="cuda", clock=None):
        self.config = config
        self.store = store
        self.identity = identity
        self.fleet_size = max(1, int(fleet_size))
        self.shard_id = shard_id
        self.metrics = SchedulerMetrics()
        gates = FeatureGate()
        gates.set_from_map(config.feature_gates)
        self.feature_gates = gates
        profiles = [
            Profile(
                name=p.scheduler_name,
                percentage_of_nodes_to_score=(
                    p.percentage_of_nodes_to_score
                    if p.percentage_of_nodes_to_score is not None
                    else config.percentage_of_nodes_to_score
                ),
                plugin_args=p.plugin_args,
                backend=p.backend,
                wave_size=p.wave_size,
                disabled_plugins=tuple(p.plugins.disabled),
                enabled_plugins=tuple(p.plugins.enabled),
            )
            for p in config.profiles
        ]
        # span export for /debug/traces: a bounded in-memory exporter takes
        # the OTLP exporter's role; the wave recorder's phase/wave spans
        # all land here because the scheduler shares this tracer
        from ..utils.tracing import InMemoryExporter, Tracer

        self.trace_exporter = InMemoryExporter(capacity=512)
        self.tracer = Tracer("tpu-scheduler", exporter=self.trace_exporter)
        # warm start (scheduler/tpu/warmup.py): every profile runs the
        # device backend, so start() builds and launches every kernel
        # before the first wave; KUBE_TPU_WARMUP=0 opts out
        from ..utils.envknob import int_env

        warm = int_env("KUBE_TPU_WARMUP", 1) != 0
        self.scheduler = Scheduler(
            store,
            profiles=profiles,
            feature_gates=gates.as_map(),
            metrics=self.metrics,
            async_api_calls=gates.enabled("SchedulerAsyncAPICalls"),
            parallelism=config.parallelism,
            extenders=config.extenders,
            tracer=self.tracer,
            device=device,
            warm_start=warm,
            clock=clock,
        )
        # SIGUSR2 → cache dump + cache/store comparison (the reference's
        # backend/cache/debugger wiring)
        from ..scheduler.cache.debugger import CacheDebugger

        backend = next(
            (b for algo in self.scheduler.algorithms.values()
             if (b := getattr(algo, "backend", None)) is not None),
            None,
        )
        self.backend = backend  # also serves /debug/flightrecorder
        self.debugger = CacheDebugger(
            self.scheduler.cache, self.scheduler.queue, store,
            backend=backend,
        )
        try:
            self.debugger.install()
        except ValueError:
            pass  # not the main thread (tests): on-demand calls still work
        self.elector = None
        self.fleet = None
        if self.fleet_size > 1:
            # active-active fleet (scheduler/fleet.py): shard ownership
            # replaces the single global lease — per-shard leases when
            # leader election is on, a pinned --shard-id otherwise
            from ..scheduler.fleet import FleetMember

            le = config.leader_election
            static = (
                {shard_id}
                if (shard_id is not None and not le.leader_elect)
                else None
            )
            self.fleet = FleetMember(
                self.scheduler,
                self.fleet_size,
                identity,
                preferred_shard=shard_id,
                static_shards=static,
                lease_name=le.resource_name,
                namespace=le.resource_namespace,
                lease_duration=le.lease_duration,
                renew_deadline=le.renew_deadline,
                retry_period=le.retry_period,
            )
        elif config.leader_election.leader_elect:
            from ..client.leaderelection import LeaderElector

            le = config.leader_election
            self.elector = LeaderElector(
                store=store,
                identity=identity,
                name=le.resource_name,
                namespace=le.resource_namespace,
                lease_duration=le.lease_duration,
                renew_deadline=le.renew_deadline,
                retry_period=le.retry_period,
            )
        self._stop = threading.Event()
        self._http: ThreadingHTTPServer | None = None
        self._threads: list[threading.Thread] = []
        self.started = False
        # the first exception of start() or of the scheduling thread
        self.error: BaseException | None = None
        self._ready = threading.Event()  # set when start() returned or raised
        self.start_time = time.time()
        self.start_mono = time.monotonic()
        self.flags: dict = {}  # effective flags, filled by main()

    # -- serving mux (server.go:367-390) -------------------------------------

    def ready(self) -> bool:
        return self.started and self.error is None and (
            self.elector is None or self.elector.is_leader())

    def _build_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code: int, body: str, ctype="text/plain"):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _int_arg(self, name, default):
                """?name=N as an int (default when absent); _BAD after a
                400 answer."""
                q = parse_qs(urlparse(self.path).query)
                try:
                    return int(q[name][0]) if name in q else default
                except ValueError:
                    self._send(400, f"{name} must be an integer")
                    return _BAD

            def do_GET(self):
                if self.path == "/healthz":
                    if server.error is not None:
                        self._send(500, f"scheduler failed: {server.error!r}")
                    else:
                        self._send(200, "ok")
                elif self.path == "/readyz":
                    # readyz includes informer sync + leadership watchdog
                    # (server.go:199-253): start() returned, nothing failed
                    ready = server.ready()
                    self._send(200 if ready else 503, "ok" if ready else "not ready")
                elif self.path == "/metrics":
                    self._send(200, server.metrics.expose(),
                               "text/plain; version=0.0.4")
                elif self.path == "/configz":
                    self._send(200, json.dumps({
                        "parallelism": server.config.parallelism,
                        "featureGates": server.feature_gates.as_map(),
                        "profiles": [p.scheduler_name for p in server.config.profiles],
                    }), "application/json")
                elif self.path == "/statusz":
                    # component-base/zpages/statusz: liveness + identity
                    self._send(200, json.dumps({
                        "component": "tpu-scheduler",
                        "startTime": server.start_time,
                        "uptimeSeconds": round(
                            time.monotonic() - server.start_mono, 1
                        ),
                        "leader": (server.elector is None
                                   or server.elector.is_leader()),
                    }), "application/json")
                elif self.path.startswith("/debug/pprof/profile"):
                    # sampling CPU profile (routes.Profiling, server.go:390)
                    from ..utils.pprof import take_profile

                    q = parse_qs(urlparse(self.path).query)
                    try:
                        secs = min(float(q.get("seconds", ["1"])[0]), 30.0)
                    except ValueError:
                        self._send(400, "seconds must be a number")
                        return
                    self._send(200, take_profile(seconds=secs))
                elif self.path.startswith("/debug/flightrecorder"):
                    # wave recorder post-mortem dump (zpages-style);
                    # ?last=N bounds the ring-buffer slice
                    rec = getattr(server.backend, "recorder", None)
                    if rec is None:
                        self._send(404, "no device backend / flight recorder")
                        return
                    last = self._int_arg("last", None)
                    if last is _BAD:
                        return
                    self._send(200, rec.dump(last), "application/json")
                elif self.path.startswith("/debug/podlatency"):
                    # pod latency ledger zpage: per-pod e2e decomposition;
                    # ?last=N (recent completions) &slowest=K (worst e2e)
                    ledger = server.scheduler.flight_recorder.pod_ledger
                    last = self._int_arg("last", 10)
                    slowest = _BAD if last is _BAD else self._int_arg("slowest", 5)
                    if slowest is _BAD:
                        return
                    self._send(200, json.dumps(
                        ledger.snapshot(last=last, slowest=slowest), indent=2
                    ), "application/json")
                elif self.path.startswith("/debug/devicetelemetry"):
                    # device telemetry zpage: transfer ledger per plane,
                    # compile tracker, device-memory watermark
                    telemetry = server.scheduler.flight_recorder.device_telemetry
                    self._send(200, json.dumps(
                        telemetry.snapshot(), indent=2
                    ), "application/json")
                elif self.path.startswith("/debug/stalls"):
                    # stall profiler zpage: per-wave wall-clock attribution
                    # (overlap + named stall reasons), the dominant reason,
                    # and the slowest wave's critical path; ?last=N bounds
                    # the per-wave rows
                    profiler = server.scheduler.flight_recorder.stall_profiler
                    last = self._int_arg("last", 10)
                    if last is _BAD:
                        return
                    self._send(200, json.dumps(
                        profiler.snapshot(last=last), indent=2
                    ), "application/json")
                elif self.path.startswith("/debug/traces"):
                    # OTLP-shaped span export (the /debug/traces zpage);
                    # ?last=N bounds to the most recent N root spans
                    from ..utils.tracing import spans_to_otlp

                    last = self._int_arg("last", None)
                    if last is _BAD:
                        return
                    spans = server.trace_exporter.last(last)
                    self._send(200, json.dumps(
                        spans_to_otlp(spans, component=server.tracer.component)
                    ), "application/json")
                elif self.path == "/flagz":
                    # component-base/zpages/flagz: effective flag values
                    self._send(200, json.dumps(server.flags),
                               "application/json")
                else:
                    self._send(404, "not found")

            def log_message(self, *a):
                pass

        return Handler

    def serve(self, port: int = 0) -> int:
        """Start the health/metrics mux; returns the bound port."""
        self._http = ThreadingHTTPServer(("127.0.0.1", port), self._build_handler())
        t = threading.Thread(target=self._http.serve_forever, daemon=True)
        t.start()
        self._threads.append(t)
        return self._http.server_port

    # -- run -----------------------------------------------------------------

    def run(self, block: bool = True) -> None:
        """server.go Run: serve health endpoints immediately, schedule only
        while holding leadership (if enabled). Without an elector start()
        runs on the caller's thread and raises there; with block=True a
        failure of start() or of the scheduling thread is re-raised after
        shutdown."""
        if self._http is None and self.config.health_bind_port:
            self.serve(self.config.health_bind_port)
        if self.elector is not None:
            self.elector.on_started_leading = self._start_scheduling_guarded
            self.elector.on_stopped_leading = self._stop_scheduling
            t = threading.Thread(target=self.elector.run, daemon=True)
            t.start()
            self._threads.append(t)
        else:
            self._start_scheduling_guarded()
        if block:
            try:
                while not self._stop.wait(0.2):
                    pass
            except KeyboardInterrupt:
                pass
            self.shutdown()
            if self.error is not None:
                raise self.error

    def wait_ready(self, timeout: float | None = None) -> bool:
        """Block until start() has returned or raised; re-raise its (or the
        scheduling thread's) error. True once ready."""
        self._ready.wait(timeout)
        if self.error is not None:
            raise self.error
        return self.ready()

    def _fail(self, exc: BaseException) -> None:
        if self.error is None:
            self.error = exc
        self._ready.set()
        self._stop.set()

    def _start_scheduling_guarded(self) -> None:
        try:
            self._start_scheduling()
        except BaseException as exc:
            self._fail(exc)
            if self.elector is None:
                raise

    def _start_scheduling(self) -> None:
        # per-leadership-term stop event: losing the lease MUST halt this
        # term's loop (split-brain double-binding otherwise), and a
        # re-acquired term starts a fresh loop
        if self.started:
            return
        self._sched_stop = threading.Event()
        if self.fleet is not None:
            # fleet start: informer sync + per-shard lease contention;
            # shard_adopt/acquire reconciles run inside the acquire
            # callbacks, scoped to each shard as it is won
            self.fleet.start()
        else:
            self.scheduler.start()
        self.started = True
        self._ready.set()

        def run_term(stop=self._sched_stop):
            retry = self.config.leader_election.retry_period
            last_elect = self.scheduler.clock.now()
            wave = self.scheduler.wave_size
            try:
                while not stop.is_set() and not self._stop.is_set():
                    if self.fleet is not None:
                        now = self.scheduler.clock.now()
                        if now - last_elect >= retry:
                            last_elect = now
                            # renew held shard leases / adopt orphans
                            # between scheduling rounds (single-threaded
                            # with the pops)
                            self.fleet.elect_once()
                    self.scheduler.pump()
                    if wave > 0:
                        self.scheduler.loop.schedule_wave(wave, timeout=0.05)
                    else:
                        self.scheduler.loop.schedule_one(timeout=0.05)
            except BaseException as exc:  # recorded, served, re-raised by run()
                self._fail(exc)

        t = threading.Thread(target=run_term, daemon=True)
        t.start()
        self._threads.append(t)

    def _stop_scheduling(self) -> None:
        self.started = False
        stop = getattr(self, "_sched_stop", None)
        if stop is not None:
            stop.set()

    def shutdown(self) -> None:
        self._stop.set()
        if self.fleet is not None:
            self.fleet.stop()  # release shard leases for instant adoption
        if self.elector is not None:
            self.elector.stop()
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=5.0)
        if self.scheduler.api_dispatcher is not None:
            self.scheduler.api_dispatcher.close()


def main(argv: list[str] | None = None) -> int:
    import signal

    parser = argparse.ArgumentParser(
        prog="python -m kubernetes_tpu_torch.cmd.scheduler",
        description="The scheduler on one CUDA card (cmd/kube-scheduler "
                    "equivalent)",
    )
    parser.add_argument("--config", help="KubeSchedulerConfiguration file "
                                         "(JSON; YAML where PyYAML is installed)")
    parser.add_argument("--backend", choices=list(BACKENDS), default=None,
                        help="override profile backend")
    parser.add_argument("--wave-size", type=int, default=None,
                        help="override profile waveSize (batched device "
                             "waves)")
    parser.add_argument("--port", type=int, default=10259,
                        help="health/metrics port (0: any free port, "
                             "printed once bound)")
    parser.add_argument("--leader-elect", action="store_true")
    parser.add_argument("--fleet-size", type=int, default=None,
                        help="active-active fleet: total shard count "
                             "(env KUBE_TPU_FLEET_SIZE; 1 = single "
                             "scheduler, the default)")
    parser.add_argument("--shard-id", type=int, default=None,
                        help="this member's preferred shard (env "
                             "KUBE_TPU_SHARD_ID; with --leader-elect it "
                             "seeds lease contention, without it the "
                             "shard is pinned statically)")
    parser.add_argument("--v", type=int, default=0,
                        help="log verbosity (klog levels)")
    parser.add_argument("--log-format", choices=["text", "json"],
                        default="text")
    args = parser.parse_args(argv)

    from ..utils.logging import configure as configure_logging

    configure_logging(fmt=args.log_format, verbosity_level=args.v)

    config = (
        load_config_file(args.config) if args.config else SchedulerConfiguration()
    )
    if args.backend:
        for p in config.profiles:
            p.backend = args.backend
    if args.wave_size is not None:
        for p in config.profiles:
            p.wave_size = args.wave_size
    if args.leader_elect:
        config.leader_election.leader_elect = True
    from ..utils.envknob import int_env

    fleet_size = (args.fleet_size if args.fleet_size is not None
                  else int_env("KUBE_TPU_FLEET_SIZE", 1))
    shard_id = (args.shard_id if args.shard_id is not None
                else int_env("KUBE_TPU_SHARD_ID", -1))
    if shard_id is not None and shard_id < 0:
        shard_id = None
    identity = (f"scheduler-{shard_id}" if shard_id is not None
                else "scheduler-0")
    server = SchedulerServer(Store(), config, identity=identity,
                             fleet_size=fleet_size, shard_id=shard_id)
    server.flags = {k: v for k, v in vars(args).items()}
    port = server.serve(args.port)
    print(f"serving on 127.0.0.1:{port}", flush=True)
    # SIGTERM (the process manager's stop) ends run() like ^C does
    signal.signal(signal.SIGTERM, lambda *_: server._stop.set())
    server.run(block=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
