"""CBOR (RFC 8949) codec: the binary wire format.

Reference: apimachinery ships three serializers — JSON, protobuf, and CBOR
(staging/src/k8s.io/apimachinery/pkg/runtime/serializer/cbor, the KEP-4222
format Kubernetes is moving to for the protobuf role on CRDs). JSON is the
debuggable format; the binary format is what components negotiate for bulk
traffic (lists, watches) because it cuts encode time and bytes. This is a
self-contained RFC 8949 subset covering the JSON data model the object
codec (serialization.py) produces: None/bool/int/float/str/bytes/list/dict.

Deterministic encoding: definite lengths, shortest-form integers — the
"core deterministic encoding" RFC 8949 §4.2 requires, which makes encoded
objects byte-comparable.

A copy of the reference package's module (kubernetes_tpu/api/cbor.py). The
native transcoder is the port's own build of native/cbor_core.cpp
(utils/nativelib.py).
"""

from __future__ import annotations

import struct

_MAJOR_UINT = 0
_MAJOR_NEGINT = 1
_MAJOR_BYTES = 2
_MAJOR_TEXT = 3
_MAJOR_ARRAY = 4
_MAJOR_MAP = 5
_SIMPLE_FALSE = b"\xf4"
_SIMPLE_TRUE = b"\xf5"
_SIMPLE_NULL = b"\xf6"
_FLOAT64 = b"\xfb"


def _head(major: int, n: int) -> bytes:
    mb = major << 5
    if n < 24:
        return bytes([mb | n])
    if n < 0x100:
        return bytes([mb | 24, n])
    if n < 0x10000:
        return bytes([mb | 25]) + n.to_bytes(2, "big")
    if n < 0x100000000:
        return bytes([mb | 26]) + n.to_bytes(4, "big")
    return bytes([mb | 27]) + n.to_bytes(8, "big")


# -- native transcoder (JSON text ↔ CBOR in C++) -----------------------------
#
# The pure-Python encoder walks objects byte by byte; for the list-sized
# payloads the binary format exists for, that is slower than the
# C-accelerated json module. The native path (native/cbor_core.cpp) rides
# json.dumps/json.loads for the Python-object half and does the byte work
# in C++. Values outside the JSON data model (byte strings, >64-bit ints,
# non-string map keys) transparently fall back to the pure codec.

_native = None
_native_tried = False


def _load_native():
    global _native, _native_tried
    if _native_tried:
        return _native
    import ctypes

    from ..utils.nativelib import load_native

    lib = load_native("libcbor_core.so")  # locked build-and-load
    if lib is not None and not hasattr(lib, "_cj_prototyped"):
        lib.cj_json_to_cbor.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.cj_json_to_cbor.restype = ctypes.c_int64
        lib.cj_cbor_to_json.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.cj_cbor_to_json.restype = ctypes.c_int64
        lib.cj_free.argtypes = [ctypes.c_void_p]
        lib.cj_free.restype = None
        lib._cj_prototyped = True
    _native = lib
    _native_tried = True
    return _native


def _str_keys_only(obj) -> bool:
    """json.dumps STRINGIFIES int/bool/None dict keys instead of raising —
    the native path must not silently corrupt them; walk containers (not
    leaf values) and punt to the pure codec on any non-str key."""
    if isinstance(obj, dict):
        return all(
            isinstance(k, str) and _str_keys_only(v) for k, v in obj.items()
        )
    if isinstance(obj, (list, tuple)):
        return all(_str_keys_only(v) for v in obj)
    return True


def _native_dumps(obj) -> bytes | None:
    lib = _load_native()
    if lib is None:
        return None
    if not _str_keys_only(obj):
        return None  # non-str map keys: pure codec preserves them
    import ctypes
    import json as _json

    try:
        text = _json.dumps(obj, ensure_ascii=False, separators=(",", ":"))
    except (TypeError, ValueError):
        return None  # bytes or other non-JSON values: pure codec
    raw = text.encode("utf-8")
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_size_t()
    rc = lib.cj_json_to_cbor(raw, len(raw), ctypes.byref(out),
                             ctypes.byref(out_len))
    if rc != 0:
        return None
    try:
        return ctypes.string_at(out, out_len.value)
    finally:
        lib.cj_free(out)


def _native_loads(data: bytes):
    lib = _load_native()
    if lib is None:
        return None
    import ctypes
    import json as _json

    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data) if data else \
        (ctypes.c_uint8 * 1)()
    out = ctypes.c_char_p()
    out_len = ctypes.c_size_t()
    rc = lib.cj_cbor_to_json(buf, len(data), ctypes.byref(out),
                             ctypes.byref(out_len))
    if rc != 0:
        return None
    try:
        text = ctypes.string_at(out, out_len.value).decode("utf-8")
    finally:
        lib.cj_free(out)
    return (_json.loads(text),)


def dumps(obj) -> bytes:
    native = _native_dumps(obj)
    if native is not None:
        return native
    out = bytearray()
    _encode(obj, out)
    return bytes(out)


def _encode(obj, out: bytearray) -> None:
    if obj is None:
        out += _SIMPLE_NULL
    elif obj is True:
        out += _SIMPLE_TRUE
    elif obj is False:
        out += _SIMPLE_FALSE
    elif isinstance(obj, int):
        if obj >= 0:
            out += _head(_MAJOR_UINT, obj)
        else:
            out += _head(_MAJOR_NEGINT, -1 - obj)
    elif isinstance(obj, float):
        out += _FLOAT64 + struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out += _head(_MAJOR_TEXT, len(b))
        out += b
    elif isinstance(obj, (bytes, bytearray)):
        out += _head(_MAJOR_BYTES, len(obj))
        out += obj
    elif isinstance(obj, (list, tuple)):
        out += _head(_MAJOR_ARRAY, len(obj))
        for item in obj:
            _encode(item, out)
    elif isinstance(obj, dict):
        out += _head(_MAJOR_MAP, len(obj))
        for k, v in obj.items():
            _encode(k, out)
            _encode(v, out)
    else:
        raise TypeError(f"cbor: unsupported type {type(obj).__name__}")


class _Decoder:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("cbor: truncated input")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def _length(self, info: int) -> int:
        if info < 24:
            return info
        if info == 24:
            return self._take(1)[0]
        if info == 25:
            return int.from_bytes(self._take(2), "big")
        if info == 26:
            return int.from_bytes(self._take(4), "big")
        if info == 27:
            return int.from_bytes(self._take(8), "big")
        raise ValueError(f"cbor: indefinite/reserved length {info}")

    def decode(self):
        ib = self._take(1)[0]
        major, info = ib >> 5, ib & 0x1F
        if major == _MAJOR_UINT:
            return self._length(info)
        if major == _MAJOR_NEGINT:
            return -1 - self._length(info)
        if major == _MAJOR_BYTES:
            return bytes(self._take(self._length(info)))
        if major == _MAJOR_TEXT:
            return self._take(self._length(info)).decode("utf-8")
        if major == _MAJOR_ARRAY:
            return [self.decode() for _ in range(self._length(info))]
        if major == _MAJOR_MAP:
            return {self.decode(): self.decode()
                    for _ in range(self._length(info))}
        if major == 7:
            if ib == _SIMPLE_NULL[0]:
                return None
            if ib == _SIMPLE_TRUE[0]:
                return True
            if ib == _SIMPLE_FALSE[0]:
                return False
            if ib == _FLOAT64[0]:
                return struct.unpack(">d", self._take(8))[0]
        raise ValueError(f"cbor: unsupported item 0x{ib:02x}")


def loads(data: bytes):
    native = _native_loads(data)
    if native is not None:
        return native[0]
    dec = _Decoder(data)
    obj = dec.decode()
    if dec.pos != len(data):
        raise ValueError("cbor: trailing bytes")
    return obj
