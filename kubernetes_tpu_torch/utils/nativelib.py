"""Shared loader for the native/ C++ cores.

One locked build-and-load path for the native libraries the port uses (the
CBOR transcoder): compiles the repo's `native/<name>.cpp` source on first
use with the flags of `native/Makefile`, into a build directory of the
port's own, caches the CDLL, and returns None when the toolchain is
unavailable so callers fall back to their pure-Python implementations.
A failed build is not silent: it is logged once and kept in
`build_errors`.
"""

from __future__ import annotations

import ctypes
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_BUILD_DIR = Path(__file__).resolve().parent / "_native"
_CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")
_cache: dict[str, ctypes.CDLL | None] = {}
_lock = threading.Lock()
build_errors: dict[str, str] = {}
log = logging.getLogger(__name__)


def _build(lib_name: str, path: Path) -> None:
    """Compile native/<stem>.cpp (libcbor_core.so <- cbor_core.cpp) to
    `path`; a temporary name and a rename, so processes that build at once
    never load a half-written library."""
    src = _NATIVE_DIR / (lib_name.removeprefix("lib").removesuffix(".so") + ".cpp")
    cxx = shutil.which("g++")
    if cxx is None:
        raise OSError("no g++ on PATH")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *_CXXFLAGS, "-o", str(tmp), str(src)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def load_native(lib_name: str) -> ctypes.CDLL | None:
    """Load the port's build of native/<lib_name> (building it if missing);
    None = unavailable, with the reason in build_errors. Thread-safe:
    concurrent first calls serialize on the build."""
    with _lock:
        if lib_name in _cache:
            return _cache[lib_name]
        lib = None
        try:
            path = _BUILD_DIR / lib_name
            if not path.exists():
                _build(lib_name, path)
            lib = ctypes.CDLL(str(path))
        except subprocess.CalledProcessError as e:
            build_errors[lib_name] = f"{e}\n{e.stderr}"
        except OSError as e:
            build_errors[lib_name] = f"{type(e).__name__}: {e}"
        if lib is None:
            log.warning("native library %s unavailable, using the pure "
                        "Python path: %s", lib_name, build_errors[lib_name])
        _cache[lib_name] = lib
        return lib
