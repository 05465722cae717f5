"""The port's host builders against the reference package's: the same nodes
and pods, built in each package's own API types, give byte-equal planes,
features, affinity tables and pack layouts — on the first sync and after
incremental (dirty-row) syncs. Also the device dtype mapping and the
zero-copy feature views."""

import numpy as np
import pytest
import torch

import kubernetes_tpu.api.meta as jmeta
import kubernetes_tpu.api.types as jtypes
import kubernetes_tpu_torch.api.meta as tmeta
import kubernetes_tpu_torch.api.types as ttypes
from kubernetes_tpu.api.resource import ResourceNames as JNames
from kubernetes_tpu.ops.planes import PlaneBuilder as JBuilder
from kubernetes_tpu.ops.planes import PodFeatureExtractor as JExtractor
from kubernetes_tpu.ops.planes import pack_features as j_pack
from kubernetes_tpu.ops.planes import pad_features as j_pad
from kubernetes_tpu.ops.planes import stack_features as j_stack
from kubernetes_tpu.scheduler.cache.cache import Cache as JCache
from kubernetes_tpu.scheduler.cache.snapshot import Snapshot as JSnapshot
from kubernetes_tpu_torch.api.resource import ResourceNames as TNames
from kubernetes_tpu_torch.ops.planes import PlaneBuilder as TBuilder
from kubernetes_tpu_torch.ops.planes import PodFeatureExtractor as TExtractor
from kubernetes_tpu_torch.ops.planes import (
    features_from_reference,
    pack_features,
    pad_features,
    planes_from_reference,
    stack_features,
    unpack_features,
)
from kubernetes_tpu_torch.scheduler.cache import Cache as TCache
from kubernetes_tpu_torch.scheduler.cache import Snapshot as TSnapshot
from kubernetes_tpu_torch.testing.mixed import build_nodes, build_pods, mixed_spec
from kubernetes_tpu_torch.testing.wrappers import scheduling_basic_node, scheduling_basic_pod

J = (JNames, JCache, JSnapshot, JBuilder, JExtractor, jtypes, jmeta)
T = (TNames, TCache, TSnapshot, TBuilder, TExtractor, ttypes, tmeta)


class _Side:
    """One package's cluster: cache, snapshot, builder, extractor."""

    def __init__(self, pkg, spec):
        names_cls, cache_cls, snap_cls, builder_cls, extractor_cls, types, meta = pkg
        self.types, self.meta = types, meta
        self.names = names_cls()
        self.cache = cache_cls(self.names)
        self.nodes = build_nodes(spec, types, meta)
        for n in self.nodes:
            self.cache.add_node(n)
        self.pods = build_pods(spec, types, meta)
        self.snap = snap_cls()
        self.cache.update_snapshot(self.snap)
        self.builder = builder_cls(self.names)
        self.extractor = extractor_cls(self.names, self.builder.vocabs)

    def wave(self, pods):
        for p in pods:
            self.extractor.register(p)
        planes = self.builder.sync(self.snap)
        feats = [self.extractor.features(p, planes) for p in pods]
        return planes, feats, self.extractor.affinity_tables(planes)


def _assert_same_arrays(a: dict, b: dict, what: str):
    assert sorted(a) == sorted(b), what
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, f"{what}.{k}"
        assert x.tobytes() == y.tobytes(), f"{what}.{k}"


@pytest.mark.parametrize("seed", [1, 2])
def test_planes_features_and_layout_byte_equal(seed):
    spec = mixed_spec(seed, 40, 48)
    j, t = _Side(J, spec), _Side(T, spec)
    for lo, hi in ((0, 16), (16, 40), (40, 48)):
        jp, jf, jt = j.wave(j.pods[lo:hi])
        tp, tf, tt = t.wave(t.pods[lo:hi])
        assert jp.node_names == tp.node_names
        assert jp.bucket_sizes == tp.bucket_sizes
        assert j.builder.topo_domains(jp) == t.builder.topo_domains(tp)
        assert j.builder.dirty_rows == t.builder.dirty_rows
        _assert_same_arrays(jp.as_dict(), tp.as_dict(), "planes")
        _assert_same_arrays(jt, tt, "affinity_tables")
        for a, b in zip(jf, tf):
            _assert_same_arrays(a, b, "features")
        js, ts = j_pad(j_stack(jf), 64), pad_features(stack_features(tf), 64)
        _assert_same_arrays(js, ts, "stacked")
        (jpk, jl), (tpk, tl) = j_pack(js), pack_features(ts)
        assert jl == tl
        assert jpk.tobytes() == tpk.tobytes()
        # place this wave's pods on both sides (dirty rows next sync)
        for i, (pj, pt) in enumerate(zip(j.pods[lo:hi], t.pods[lo:hi])):
            node = jp.node_names[(7 * i + lo) % jp.n]
            j.cache.assume_pod(pj, node)
            t.cache.assume_pod(pt, node)
        j.cache.update_snapshot(j.snap)
        t.cache.update_snapshot(t.snap)


def test_scheduling_basic_shapes_match_reference():
    """The SchedulingBasic fixtures build the reference's harness cluster
    (node_from_manifest, pod-default.yaml) byte for byte."""
    import os

    import yaml

    from kubernetes_tpu.perf.templates import node_from_manifest, pod_from_manifest

    base = os.path.join(os.path.dirname(__file__), "..", "kubernetes_tpu", "perf",
                        "templates", "pod-default.yaml")
    with open(base) as fh:
        tmpl = yaml.safe_load(fh)
    jn, tn = JNames(), TNames()
    jc, tc = JCache(jn), TCache(tn)
    for i in range(24):
        jc.add_node(node_from_manifest({}, f"node-{i}", zone=f"zone-{i % 8}"))
        tc.add_node(scheduling_basic_node(i))
    js, ts = JSnapshot(), TSnapshot()
    jc.update_snapshot(js)
    tc.update_snapshot(ts)
    jb, tb = JBuilder(jn), TBuilder(tn)
    je, te = JExtractor(jn, jb.vocabs), TExtractor(tn, tb.vocabs)
    jpod, tpod = pod_from_manifest(tmpl, "pod-0"), scheduling_basic_pod(0)
    je.register(jpod)
    te.register(tpod)
    jp, tp = jb.sync(js), tb.sync(ts)
    _assert_same_arrays(jp.as_dict(), tp.as_dict(), "planes")
    _assert_same_arrays(je.features(jpod, jp), te.features(tpod, tp), "features")
    assert jb.topo_domains(jp) == tb.topo_domains(tp) == (8, 0)
    assert jp.bucket_sizes == tp.bucket_sizes


def test_device_dtype_mapping():
    """int32 → int32, uint32 → int32 with the same bits, bool → bool; the
    CPU mirror is a copy, never a view of the host planes."""
    host = {
        "alloc": np.arange(8, dtype=np.int32).reshape(4, 2),
        "port_words": np.array([[0xFFFFFFFF], [1], [0x80000000], [0]], np.uint32),
        "valid": np.array([True, False, True, True]),
    }
    dev = planes_from_reference(host, "cpu")
    assert dev["alloc"].dtype == torch.int32
    assert dev["port_words"].dtype == torch.int32
    assert dev["valid"].dtype == torch.bool
    assert dev["port_words"].numpy().view(np.uint32).tolist() == host["port_words"].tolist()
    host["alloc"][0, 0] = 99
    assert int(dev["alloc"][0, 0]) == 0
    with pytest.raises(TypeError):
        planes_from_reference({"x": np.zeros(2, np.float64)}, "cpu")


def test_unpack_features_are_views_of_one_buffer():
    spec = mixed_spec(3, 16, 8)
    t = _Side(T, spec)
    _planes, feats, _tables = t.wave(t.pods)
    stacked = pad_features(stack_features(feats), 16)
    buf, layout = features_from_reference(stacked, "cpu")
    views = unpack_features(buf, layout)
    for name, v in views.items():
        assert v.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr(), name
        want = stacked[name]
        got = v.numpy()
        if want.dtype == np.uint32:
            got = got.view(np.uint32)
        assert np.array_equal(got.astype(want.dtype), want), name
