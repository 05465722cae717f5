"""The port's wire codecs held to the reference's.

For every kind the reference's scheme registers (`_register_all`): a
seeded instance, filled field by field from the type hints with numpy,
built in both packages gives equal `encode` dicts; each package decodes
the other's wire form back to an equal object; the CBOR bytes are equal on
both codec paths (the native transcoder built from native/cbor_core.cpp
and the pure codec) and decode back; and PodGroups convert to and from
scheduling.k8s.io/v1alpha2 the same way. The port's dataclasses (every one
reachable from a registered kind) have the reference's fields, in the
reference's order, with its defaults.
"""

from __future__ import annotations

import dataclasses
import types
import typing
from typing import get_args, get_origin, get_type_hints

import numpy as np
import pytest

from kubernetes_tpu.api import cbor as jcbor
from kubernetes_tpu.api import serialization as jser
from kubernetes_tpu.api import versioning as jver
from kubernetes_tpu_torch.api import cbor as tcbor
from kubernetes_tpu_torch.api import serialization as tser
from kubernetes_tpu_torch.api import versioning as tver

jser._register_all()
tser._register_all()
KINDS = sorted(jser._KINDS)


def _ser_of(cls):
    """The serialization module of the package that defines cls."""
    return tser if cls.__module__.startswith("kubernetes_tpu_torch.") else jser


def _strip_optional(tp):
    if get_origin(tp) in (typing.Union, types.UnionType):
        args = [a for a in get_args(tp) if a is not type(None)]
        return args[0] if len(args) == 1 else tp, True
    return tp, False


def _fill(cls, rng, depth: int = 0):
    """A seeded instance of dataclass `cls`: every field drawn from its
    type hint (strings, ints, floats, bools, lists, tuples, dicts, nested
    dataclasses; optionals None a third of the time)."""
    hints = get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        kwargs[f.name] = _value(hints.get(f.name), rng, depth, (cls, f.name))
    return cls(**kwargs)


def _value(tp, rng, depth, where):
    tp, optional = _strip_optional(tp)
    if optional and rng.random() < 0.33:
        return None
    origin = get_origin(tp)
    n = int(rng.integers(0, 3)) if depth < 3 else 0
    if origin in (list, tuple):
        args = get_args(tp)
        elem = args[0] if args and args[0] is not Ellipsis else str
        items = [_value(elem, rng, depth + 1, where) for _ in range(n)]
        return tuple(items) if origin is tuple else items
    if origin is dict or tp is dict:
        return {f"k{int(rng.integers(0, 100))}": f"v{int(rng.integers(0, 100))}"
                for _ in range(n)}
    if tp is tuple:
        elem = _ser_of(where[0])._elem_hint(*where)
        if elem is None:
            return tuple(f"s{int(rng.integers(0, 100))}" for _ in range(n))
        return tuple(_fill(elem, rng, depth + 1) for _ in range(n))
    if dataclasses.is_dataclass(tp):
        return _fill(tp, rng, depth + 1)
    if tp is bool:
        return bool(rng.integers(0, 2))
    if tp is int:
        return int(rng.integers(-5, 1 << 20))
    if tp is float:
        return float(rng.integers(0, 1 << 16)) / 8.0
    return f"s{int(rng.integers(0, 1000))}"


def _with_kind(obj, kind: str):
    """A kind that is a field (the custom object's) names the registered
    kind, as a decoded object's does."""
    if "kind" in {f.name for f in dataclasses.fields(obj)}:
        obj = dataclasses.replace(obj, kind=kind)
    return obj


def _fields(cls, seen=None) -> dict:
    """Every dataclass reachable from cls: name -> [(field, default)]."""
    seen = {} if seen is None else seen
    if cls.__name__ in seen:
        return seen
    hints = get_type_hints(cls)
    rows = []
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            default = repr(f.default)
        elif f.default_factory is not dataclasses.MISSING:
            default = repr(f.default_factory())
        else:
            default = "<required>"
        rows.append((f.name, default, f.kw_only))
    seen[cls.__name__] = rows
    stack = list(hints.values())
    while stack:
        tp, _ = _strip_optional(stack.pop())
        stack.extend(a for a in get_args(tp) if a is not Ellipsis)
        if dataclasses.is_dataclass(tp):
            _fields(tp, seen)
    for name in [f.name for f in dataclasses.fields(cls)]:
        elem = _ser_of(cls)._elem_hint(cls, name)
        if elem is not None:
            _fields(elem, seen)
    return seen


def test_registries_hold_the_same_kinds():
    assert sorted(tser._KINDS) == KINDS
    assert len(KINDS) > 40


@pytest.mark.parametrize("kind", KINDS)
def test_dataclasses_have_the_reference_fields(kind):
    want = _fields(jser._KINDS[kind])
    got = _fields(tser._KINDS[kind])
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


def _pure_dumps(mod, obj) -> bytes:
    out = bytearray()
    mod._encode(obj, out)
    return bytes(out)


def _pure_loads(mod, data: bytes):
    dec = mod._Decoder(data)
    obj = dec.decode()
    assert dec.pos == len(data)
    return obj


def test_both_native_transcoders_built():
    # the native path must exist, or "native vs pure" compares pure to pure
    assert jcbor._load_native() is not None
    assert tcbor._load_native() is not None


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kind_on_the_wire(kind, seed):
    jobj = _with_kind(_fill(jser._KINDS[kind], np.random.default_rng(seed)), kind)
    tobj = _with_kind(_fill(tser._KINDS[kind], np.random.default_rng(seed)), kind)
    wire = jser.encode(jobj)
    assert tser.encode(tobj) == wire
    # each package decodes the other's wire form
    assert tser.decode(wire) == tobj
    assert jser.encode(tser.decode(wire)) == wire
    assert tser.encode(jser.decode(tser.encode(tobj))) == wire
    # CBOR: the native transcoder and the pure codec, in both packages
    jbytes = jcbor.dumps(wire)
    assert tcbor.dumps(wire) == jbytes
    assert _pure_dumps(tcbor, wire) == _pure_dumps(jcbor, wire)
    assert tcbor.loads(jbytes) == jcbor.loads(jbytes)
    assert _pure_loads(tcbor, jbytes) == _pure_loads(jcbor, jbytes)
    assert tser.decode(tcbor.loads(jbytes)) == tobj


def test_cbor_values_outside_json():
    """Byte strings, wide ints and non-string keys take the pure codec in
    both packages, with the same bytes."""
    cases = [b"\x00\xff", {1: "a", None: [2 ** 64 - 1]}, [-(2 ** 64)],
             {"f": 1.5, "t": True, "n": None}, "ü" * 300, list(range(300))]
    for c in cases:
        assert tcbor.dumps(c) == jcbor.dumps(c)
        assert tcbor.loads(jcbor.dumps(c)) == jcbor.loads(jcbor.dumps(c))
    # past 64 bits neither codec has a form
    for mod in (jcbor, tcbor):
        with pytest.raises(OverflowError):
            mod.dumps([2 ** 70])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_versioned_conversions(seed):
    rng = np.random.default_rng(seed)
    jpg = _fill(jser._KINDS["PodGroup"], rng)
    tpg = tser.decode(jser.encode(jpg))
    js, ts = jver.default_scheme(), tver.default_scheme()
    assert ts.versions_for("PodGroup") == js.versions_for("PodGroup")
    for version in js.versions_for("PodGroup"):
        try:
            want = js.encode_versioned(jpg, version)
        except Exception as e:  # noqa: BLE001 - same refusal in both
            with pytest.raises(type(e)):
                ts.encode_versioned(tpg, version)
            continue
        got = ts.encode_versioned(tpg, version)
        assert got == want
        assert jser.encode(ts.decode_versioned(got)) == \
            jser.encode(js.decode_versioned(want))
