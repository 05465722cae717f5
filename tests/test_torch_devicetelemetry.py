"""The port's device telemetry held to the reference's suite.

The reference's tests/test_devicetelemetry.py cases run against
kubernetes_tpu_torch's copy: the transfer ledger's arithmetic (a fetch is
a `.cpu()` here, so the cases hand it tensors), the compile tracker's
once-per-signature rule, the watermark, the wave path's attributed bytes
on the port's Scheduler (device="cpu": the kernels' plain versions), the
telemetry on/off golden, the wave-size controller against the compile
tracker, and the node ramp that must not recompile. TestDeviceTelemetryZpage
tests the scheduler server (ROADMAP A13). Beside them: the torch seams'
contract (no copy on an accounted put, the memory cross-check only on a
card) and the port's upload planes on its cold start, scatter and gang
paths.
"""

from __future__ import annotations

import json
import random
from types import SimpleNamespace

import numpy as np
import torch

from kubernetes_tpu_torch.api import meta as tmeta
from kubernetes_tpu_torch.api import types as ttypes
from kubernetes_tpu_torch.api.resource import ResourceNames
from kubernetes_tpu_torch.scheduler.cache import Cache, Snapshot
from kubernetes_tpu_torch.scheduler.metrics import SchedulerMetrics
from kubernetes_tpu_torch.scheduler.scheduler import Profile, Scheduler
from kubernetes_tpu_torch.scheduler.tpu.backend import TorchBackend
from kubernetes_tpu_torch.scheduler.tpu.devicetelemetry import (
    LEDGER_SERIES,
    RESIDENT_GROUPS,
    TRANSFER_PLANES,
    DeviceTelemetry,
    _shape_label,
    tree_nbytes,
)
from kubernetes_tpu_torch.scheduler.tpu.wavecontroller import _next_pow2
from kubernetes_tpu_torch.store import Store
from kubernetes_tpu_torch.testing.wrappers import make_node, make_pod


def _record():
    """Minimal stand-in exposing the WaveRecord fields telemetry writes."""
    return SimpleNamespace(upload_bytes=0, fetch_bytes=0,
                           upload_by_plane={}, fetch_by_plane={},
                           mem_watermark_bytes=0, phases={})


def synthetic_cluster(n_nodes, n_zones=8, names=None):
    """(cache, snapshot) of n_nodes 32-CPU nodes over n_zones zones (the
    reference's kubernetes_tpu.testing.synthetic_cluster, no init pods)."""
    cache = Cache(names or ResourceNames())
    for i in range(n_nodes):
        cache.add_node(make_node(f"node-{i}", cpu="32", mem="64Gi",
                                 zone=f"zone-{i % n_zones}"))
    return cache, cache.update_snapshot(Snapshot())


# ------------------------------------------------------------- unit: ledger


class TestTransferLedger:
    def test_accounted_put_is_bit_exact_and_accounted(self):
        tel = DeviceTelemetry()
        rec = _record()
        tree = {"cpu": np.arange(8, dtype=np.float32),
                "mem": np.arange(4, dtype=np.int32)}
        out = tel.accounted_put("node_planes", tree, put=lambda a, k=None: a,
                                record=rec)
        # per-leaf put: same structure, same values, same dtypes (and the
        # leaf key rides along so sharded contexts can pick a NamedSharding)
        assert set(out) == set(tree)
        for k in tree:
            assert out[k] is tree[k]
        want = sum(a.nbytes for a in tree.values())
        assert rec.upload_bytes == want
        assert rec.upload_by_plane == {"node_planes": want}
        assert tel.summary()["upload_bytes_total"] == want

    def test_accounted_fetch_returns_host_tensor(self):
        tel = DeviceTelemetry()
        rec = _record()
        value = torch.arange(6, dtype=torch.int64)
        host = tel.accounted_fetch("results", value, record=rec)
        assert isinstance(host, torch.Tensor) and host.device.type == "cpu"
        assert torch.equal(host, value)
        assert rec.fetch_bytes == host.nbytes == 48
        assert rec.fetch_by_plane == {"results": 48}

    def test_by_plane_sums_to_totals(self):
        tel = DeviceTelemetry()
        rec = _record()
        tel.account_upload("features", 100, rec)
        tel.account_upload("carry_scatter", 50, rec)
        tel.account_upload("features", 25, rec)
        tel.account_fetch("results", 40, rec)
        snap = tel.snapshot()
        up = snap["transfers"]["upload"]
        assert up["total_bytes"] == 175
        assert sum(up["by_plane"].values()) == up["total_bytes"]
        assert up["by_plane"] == {"features": 125, "carry_scatter": 50}
        assert sum(rec.upload_by_plane.values()) == rec.upload_bytes == 175
        assert sum(rec.fetch_by_plane.values()) == rec.fetch_bytes == 40

    def test_zero_and_negative_bytes_ignored(self):
        tel = DeviceTelemetry()
        tel.account_upload("features", 0)
        tel.account_upload("features", -5)
        assert tel.summary()["upload_bytes_total"] == 0

    def test_disabled_seam_still_transfers_but_accounts_nothing(self):
        tel = DeviceTelemetry()
        tel.enabled = False
        rec = _record()
        out = tel.accounted_put("features", np.ones(4), put=lambda a: a,
                                record=rec)
        host = tel.accounted_fetch("results", torch.ones(4), record=rec)
        assert out.shape == (4,) and host.shape == (4,)
        with tel.compile_span("k", ("sig",), record=rec):
            pass
        tel.note_resident("planes", 1 << 20, rec)
        assert rec.upload_bytes == rec.fetch_bytes == 0
        assert rec.mem_watermark_bytes == 0
        s = tel.summary()
        assert s["upload_bytes_total"] == 0 and s["compiles_total"] == 0

    def test_tree_nbytes(self):
        assert tree_nbytes(None) == 0
        assert tree_nbytes(np.zeros(3, dtype=np.float32)) == 12
        assert tree_nbytes({"a": np.zeros(2, dtype=np.int64),
                            "b": None}) == 16
        # tensors too, from their metadata
        assert tree_nbytes({"t": torch.zeros(5, dtype=torch.int32)}) == 20


# ----------------------------------------------------- unit: compile tracker


class TestCompileTracker:
    def test_first_seen_signature_counts_once(self):
        tel = DeviceTelemetry()
        rec = _record()
        for _ in range(3):
            with tel.compile_span("batched_assign", ("cfg", (64,), 16),
                                  label="pad16", record=rec):
                pass
        assert tel.compile_count("batched_assign") == 1
        assert tel.compiled_shapes("batched_assign") == ["pad16"]
        assert "compile/batched_assign" in rec.phases

    def test_distinct_signatures_count_separately(self):
        tel = DeviceTelemetry()
        for pad in (8, 16, 8, 32, 16):
            with tel.compile_span("batched_assign", ("cfg", (64,), pad),
                                  label=f"pad{pad}"):
                pass
        assert tel.compile_count("batched_assign") == 3
        assert tel.compiled_shapes("batched_assign") == \
            ["pad16", "pad32", "pad8"]
        assert tel.compile_count() == 3

    def test_shape_label_fallback_is_deterministic(self):
        sig = ("cfg", (64, 128), 16, True)
        assert _shape_label(sig) == _shape_label(sig)
        assert _shape_label(sig) != _shape_label(("other",))
        assert _shape_label(sig).startswith("sig-")


# ---------------------------------------------------- unit: memory watermark


class TestMemoryWatermark:
    def test_watermark_is_running_max_of_live_total(self):
        tel = DeviceTelemetry()
        rec = _record()
        tel.note_resident("planes", 1000, rec)
        tel.note_resident("tables", 500, rec)
        assert rec.mem_watermark_bytes == 1500
        tel.note_resident("planes", 200, rec)  # shrink: watermark holds
        snap = tel.snapshot()["memory"]
        assert snap["live_bytes"] == 700
        assert snap["watermark_bytes"] == 1500
        assert rec.mem_watermark_bytes == 1500

    def test_free_resets_live_not_watermark(self):
        tel = DeviceTelemetry()
        tel.note_resident("carry", 64)
        tel.note_resident("carry", 0)
        m = tel.snapshot()["memory"]
        assert m["live_bytes"] == 0 and m["watermark_bytes"] == 64

    def test_bench_columns(self):
        tel = DeviceTelemetry()
        tel.account_upload("features", 1000)
        with tel.compile_span("k", ("s",)):
            pass
        tel.note_resident("planes", 77)
        cols = tel.bench_columns(waves=4)
        assert cols == {"upload_bytes_per_wave": 250, "compile_count": 1,
                        "mem_watermark_bytes": 77}
        assert tel.bench_columns(waves=0)["upload_bytes_per_wave"] == 0


# ------------------------------------------------------------ declarations


class TestDeclarations:
    def test_series_and_planes_are_nonempty_string_tuples(self):
        for decl in (LEDGER_SERIES, TRANSFER_PLANES, RESIDENT_GROUPS):
            assert decl and all(isinstance(s, str) for s in decl)
            assert len(set(decl)) == len(decl)


# ------------------------------------------------------- wave-path telemetry


class TestWavePathTelemetry:
    def _sched(self, nodes=4, wave_size=8, seed=3):
        store = Store()
        for i in range(nodes):
            store.create(make_node(f"n{i}", cpu="8", mem="16Gi"))
        sched = Scheduler(
            store,
            profiles=[Profile(backend="tpu", wave_size=wave_size)],
            metrics=SchedulerMetrics(),
            seed=seed,
            device="cpu",
        )
        sched.start()
        return store, sched

    def test_wave_records_carry_attributed_bytes(self):
        store, sched = self._sched()
        for i in range(10):
            store.create(make_pod(f"w{i}", cpu="500m", mem="256Mi"))
        sched.pump()
        sched.schedule_pending()
        assert sum(1 for p in store.pods() if p.spec.node_name) == 10
        records = [r for r in sched.flight_recorder.records() if r.pods]
        assert records
        for rec in records:
            assert rec.upload_bytes > 0
            assert sum(rec.upload_by_plane.values()) == rec.upload_bytes
            assert sum(rec.fetch_by_plane.values()) == rec.fetch_bytes
            for plane in list(rec.upload_by_plane) + list(rec.fetch_by_plane):
                assert plane in TRANSFER_PLANES
            assert rec.mem_watermark_bytes > 0
        tel = sched.flight_recorder.device_telemetry
        snap = tel.snapshot()
        assert snap["transfers"]["upload"]["total_bytes"] > 0
        assert snap["compiles"]["total"] > 0
        # backend and recorder share one telemetry object
        assert sched.flight_recorder.device_telemetry is \
            sched.algorithms["default-scheduler"].backend.telemetry

    def test_compile_count_flat_across_repeated_same_shape_waves(self):
        """Same queue depth + same pod shapes wave after wave: after the
        warm-up waves (first wave has no carry overlay, the second
        introduces it) the compile tracker must go flat — a growing count
        here is exactly the recompile storm the gate exists to catch."""
        store, sched = self._sched(nodes=8, wave_size=16)
        tel = sched.flight_recorder.device_telemetry
        counts = []
        for round_no in range(5):
            for i in range(10):
                store.create(make_pod(f"r{round_no}-{i}", cpu="100m",
                                      mem="64Mi"))
            sched.pump()
            sched.schedule_pending()
            counts.append(tel.compile_count())
        assert counts[0] > 0
        assert counts[2] == counts[3] == counts[4]

    def test_dump_includes_device_telemetry_block(self):
        store, sched = self._sched()
        for i in range(6):
            store.create(make_pod(f"d{i}", cpu="100m", mem="64Mi"))
        sched.pump()
        sched.schedule_pending()
        dump = json.loads(sched.flight_recorder.dump())
        block = dump["device_telemetry"]
        assert set(block) >= {"transfers", "compiles", "memory"}
        assert block["transfers"]["upload"]["total_bytes"] > 0
        # per-wave attribution rides along in the dumped records too
        assert any(r.get("upload_bytes", 0) > 0 for r in dump["records"])


# ---------------------------------------------------------------- bit-compat


class TestTelemetryBitCompat:
    def test_placements_and_rng_identical_telemetry_on_vs_off(self):
        """The telemetry consumes no rng and influences no decision: the
        same seeded wave workload places identically — and leaves the
        tie-break rng stream at the same point — with it on (production
        default) and off."""

        def run(telemetry_on: bool):
            store = Store()
            for i in range(8):
                store.create(make_node(f"n{i}", cpu="4", mem="8Gi",
                                       zone=f"z{i % 2}"))
            sched = Scheduler(
                store,
                profiles=[Profile(backend="tpu", wave_size=16)],
                metrics=SchedulerMetrics(),
                seed=11,
                device="cpu",
            )
            sched.flight_recorder.device_telemetry.enabled = telemetry_on
            sched.start()
            for i in range(24):
                kind = i % 3
                cpu, mem = [("1", "1Gi"), ("900m", "900Mi"),
                            ("800m", "800Mi")][kind]
                store.create(make_pod(f"g{i:02d}", cpu=cpu, mem=mem,
                                      labels={"app": "abc"[kind]}))
            sched.pump()
            sched.schedule_pending()
            placements = {p.meta.key: p.spec.node_name
                          for p in store.pods()}
            rng_tail = [sched.algorithms["default-scheduler"].rng.random()
                        for _ in range(5)]
            return placements, rng_tail

        on, off = run(True), run(False)
        assert on[0] == off[0]  # identical bindings
        assert on[1] == off[1]  # identical seeded tie-break stream
        assert any(on[0].values())


class TestWaveSizeCompileInteraction:
    def test_churning_queue_depth_bounds_compiled_shapes(self):
        """The adaptive controller pow2-buckets wave sizes precisely so
        depth churn cannot fan out kernel configurations. Feed identical
        pods at churning depths and assert the batched-assign kernel
        compiled at most 2x the reachable pow2 pads (the x2 covers the
        cold/warm carry-overlay variants of each pad)."""
        cap = 64
        store = Store()
        for i in range(8):
            store.create(make_node(f"c{i}", cpu="16", mem="32Gi"))
        sched = Scheduler(
            store,
            profiles=[Profile(backend="tpu", wave_size=cap)],
            metrics=SchedulerMetrics(),
            seed=5,
            device="cpu",
        )
        sched.start()
        depths = [3, 9, 17, 40, 5, 33, 12, 60, 2, 25]
        n = 0
        for depth in depths:
            for _ in range(depth):
                store.create(make_pod(f"p{n}", cpu="100m", mem="64Mi"))
                n += 1
            sched.pump()
            sched.schedule_pending()
        assert sum(1 for p in store.pods() if p.spec.node_name) == n

        buckets = set()
        pad = _next_pow2(1, 8)
        while pad <= cap:
            buckets.add(pad)
            pad <<= 1
        shapes = sched.flight_recorder.device_telemetry.compiled_shapes(
            "batched_assign")
        assert shapes, "wave path never hit the compile tracker"
        assert len(shapes) <= 2 * len(buckets), shapes
        for label in shapes:  # every shape is a pow2-bucketed pad
            pad = int(label.split("/", 1)[0].removeprefix("pad"))
            assert pad in buckets, shapes


class TestCompileFlatNodeRamp:
    def test_pod_churn_scatter_and_node_ramp_compile_flat(self):
        """Two halves of the steady-state upload discipline.

        Pod churn (bind pods to existing nodes) is vocab-neutral: only
        the churned rows go dirty, so the repair must flow through the
        delta_rows/delta_idx scatter and the node_planes base must not
        be re-put.  Node appends are NOT vocab-neutral (each node's
        hostname grows a domain vocab, moving the canonical fingerprint
        and conservatively dirtying every row), so membership growth
        legitimately pays a full re-put — but as long as the ramp stays
        inside the pow2 node bucket (100 -> 108 -> 116, bucket 128) the
        compile tracker must report ZERO new compiles across it."""
        import random

        names = ResourceNames()
        cache, snap = synthetic_cluster(100, n_zones=4, names=names)
        backend = TorchBackend(names, device="cpu")

        def burst(tag, snap):
            pods = [make_pod(f"{tag}-{i}", cpu="100m", mem="64Mi",
                             labels={"app": "ramp"}) for i in range(8)]
            got, _ = backend.run_batched(pods, snap, rng=random.Random(0))
            assert any(got)

        burst("w0", snap)                      # cold: full upload + compile
        up_plane = backend.telemetry.snapshot()["transfers"]["upload"]
        full_bytes = up_plane["by_plane"]["node_planes"]
        assert "delta_rows" not in up_plane["by_plane"]

        # pod churn: dirty a handful of rows without touching any vocab
        for k in range(8):
            cache.add_pod(make_pod(f"churn-{k}", cpu="100m", mem="64Mi",
                                   node_name=f"node-{k}"))
        snap = cache.update_snapshot(snap)
        burst("w1", snap)
        up_plane = backend.telemetry.snapshot()["transfers"]["upload"]
        assert up_plane["by_plane"].get("delta_rows", 0) > 0
        assert up_plane["by_plane"].get("delta_idx", 0) > 0
        assert up_plane["by_plane"]["node_planes"] == full_bytes
        warm_compiles = backend.telemetry.compile_count()

        # the ramp: 8-node appends, same pow2 bucket -> nothing recompiles
        for k in range(1, 3):
            for j in range(8):
                cache.add_node(make_node(f"r{k}-{j}", cpu="32", mem="64Gi",
                                         zone=f"zone-{j % 4}"))
            snap = cache.update_snapshot(snap)
            burst(f"w{k + 1}", snap)
            assert backend.telemetry.compile_count() == warm_compiles, (
                backend.telemetry.snapshot()["compiles"])
        # membership growth paid full re-puts (fingerprint moved), but
        # the scatter total is untouched — pod churn is the only client
        up_plane = backend.telemetry.snapshot()["transfers"]["upload"]
        assert up_plane["by_plane"]["node_planes"] > full_bytes


# ----------------------------------------------------- the torch seams


class TestTorchSeams:
    def test_accounted_put_returns_what_put_returns(self):
        tel = DeviceTelemetry()
        rec = _record()
        tree = {"a": np.arange(4, dtype=np.int32), "b": np.ones(2, np.float32)}
        seen = []

        def put(v, name=None):
            seen.append(name)
            return torch.from_numpy(v)

        out = tel.accounted_put("node_planes", tree, put=put, record=rec)
        assert seen == ["a", "b"]
        assert torch.equal(out["a"], torch.arange(4, dtype=torch.int32))
        assert rec.upload_by_plane == {"node_planes": 24}

    def test_memory_cross_check_only_on_a_card(self):
        tel = DeviceTelemetry()
        tel.note_resident("planes", 64)
        assert tel._torch_memory_bytes() is None
        assert "torch_memory_allocated" not in tel.snapshot()["memory"]
        tel.device = torch.device("cpu")
        assert tel._torch_memory_bytes() is None
        m = SchedulerMetrics()
        tel.metrics = m
        tel.update_gauges()
        gauge = m.registry.get("scheduler_tpu_device_memory_bytes")
        assert gauge.get("ledger") == 64.0 and gauge.get("torch") == 0.0

    def test_cold_start_scatter_and_run_planes(self):
        """A cold start puts every node plane; pod churn then moves only
        its rows (the K3 scatter); a single-pod run counts its feature row
        and its score fetch; resident groups sum to the live bytes."""
        names = ResourceNames()
        cache, snap = synthetic_cluster(20, n_zones=2, names=names)
        backend = TorchBackend(names, device="cpu")
        tel = backend.telemetry
        pods = [make_pod(f"w{i}", cpu="100m", mem="64Mi") for i in range(4)]
        got, _ = backend.run_batched(pods, snap, rng=random.Random(0))
        assert all(got)
        up = tel.snapshot()["transfers"]["upload"]["by_plane"]
        assert set(up) >= {"node_planes", "features", "affinity_tables",
                           "ipa_term_key", "log_weights"}
        assert "delta_rows" not in up
        for k in range(3):
            cache.add_pod(make_pod(f"c{k}", cpu="1", mem="1Gi", node_name=f"node-{k}"))
        snap = cache.update_snapshot(snap)
        planes, out = backend.run(make_pod("one", cpu="1", mem="1Gi"), snap)
        snapshot = tel.snapshot()
        up = snapshot["transfers"]["upload"]["by_plane"]
        assert up["delta_rows"] > 0 and up["delta_idx"] == 3 * 4
        fetch = snapshot["transfers"]["fetch"]["by_plane"]
        assert fetch["results"] > 0 and fetch["scores"] > 0
        assert snapshot["compiles"]["by_kernel"] == {
            "batched_assign": 1, "fit_and_score": 1, "scatter_rows": 1}
        mem = snapshot["memory"]
        assert mem["live_bytes"] == sum(mem["resident_bytes"].values()) > 0
        assert set(mem["resident_bytes"]) <= set(RESIDENT_GROUPS)

    def test_gang_wave_records_masks_and_outcome(self):
        """A gang through the Scheduler: its wave record carries the gang
        fields, its masks count as gang_masks, K5's compile span lands on
        the record, and the recorder counts its members on the device."""
        from kubernetes_tpu_torch.testing import wrappers as w

        store = Store()
        for i in range(6):
            store.create(make_node(f"n{i}", cpu="4", mem="8Gi", zone=f"z{i % 2}"))
        s = Scheduler(store, profiles=[Profile(wave_size=8)], device="cpu",
                      metrics=SchedulerMetrics())
        s.start()
        store.create(ttypes.PodGroup(meta=tmeta.ObjectMeta(name="g"),
                                     spec=ttypes.PodGroupSpec(
                                         policy=ttypes.GangPolicy(min_count=3))))
        for i in range(3):
            store.create(w.with_gang(make_pod(f"g{i}", cpu="100m"), "g"))
        s.schedule_pending()
        assert sum(1 for p in store.pods() if p.spec.node_name) == 3
        fr = s.flight_recorder
        (rec,) = [r for r in fr.records() if r.gang_groups]
        assert rec.gang_pods == 3 and rec.gang_fallback_pods == 0
        assert rec.gang_outcome.startswith("device:")
        assert rec.upload_by_plane["gang_masks"] > 0
        assert rec.fetch_by_plane["results"] > 0
        assert "compile/gang_assign" in rec.phases
        assert fr.gang_pod_totals == {"device": 3}
        assert s.metrics.gang_pods_total.get("device") == 3.0
