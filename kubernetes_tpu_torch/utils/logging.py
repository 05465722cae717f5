"""Structured, leveled logging: the klog v2 role.

Reference: the whole control plane logs through klog's structured calls —
logger.Info("Scheduled pod", "pod", klog.KObj(pod), "node", node) — with
verbosity gating V(0)-V(10) and a JSON backend
(component-base/logs/json). This module is that contract on stdlib
logging: key-value pairs always travel as structured fields (never
formatted into the message), V-levels gate cheaply before argument
formatting, and the backend renders text or JSON.

A copy of the reference package's module (kubernetes_tpu/utils/logging.py)
whose loggers live under the port's package name.

Usage:
    log = get_logger("scheduler")
    log.info("Scheduled pod", pod=pod.meta.key, node=node)
    if log.v(4):
        log.v4("score details", scores=long_list)
"""

from __future__ import annotations

import json
import logging
import sys
import threading
import time

_VERBOSITY = 0
_lock = threading.Lock()


def set_verbosity(v: int) -> None:
    """--v flag (klog verbosity); 0 is the production default."""
    global _VERBOSITY
    _VERBOSITY = v


def verbosity() -> int:
    return _VERBOSITY


class JSONFormatter(logging.Formatter):
    """component-base/logs/json: one object per line, fields flattened."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 6),
            "v": getattr(record, "v", 0),
            "logger": record.name,
            "level": record.levelname.lower(),
            "msg": record.getMessage(),
        }
        out.update(getattr(record, "kv", {}))
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


class TextFormatter(logging.Formatter):
    """klog text: msg followed by key=value pairs."""

    def format(self, record: logging.LogRecord) -> str:
        kv = getattr(record, "kv", {})
        pairs = "".join(f' {k}="{v}"' for k, v in kv.items())
        t = time.strftime("%H:%M:%S", time.localtime(record.created))
        return (f"{record.levelname[0]}{t} {record.name}] "
                f"{record.getMessage()}{pairs}")


def configure(fmt: str = "text", stream=None, verbosity_level: int = 0) -> None:
    """Install the backend on the package root logger (logs.Options.Apply)."""
    set_verbosity(verbosity_level)
    root = logging.getLogger("kubernetes_tpu_torch")
    with _lock:
        for h in list(root.handlers):
            root.removeHandler(h)
        handler = logging.StreamHandler(stream or sys.stderr)
        handler.setFormatter(
            JSONFormatter() if fmt == "json" else TextFormatter()
        )
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        # never double-emit through root-logger handlers (basicConfig,
        # pytest's capture handler, ...) — the backend owns the format
        root.propagate = False


class StructuredLogger:
    def __init__(self, name: str, values: dict | None = None):
        self._log = logging.getLogger(f"kubernetes_tpu_torch.{name}")
        self._values = dict(values or {})  # WithValues context

    def with_values(self, **kv) -> "StructuredLogger":
        """klog LoggerWithValues: context that rides on every line."""
        merged = dict(self._values)
        merged.update(kv)
        out = StructuredLogger.__new__(StructuredLogger)
        out._log = self._log
        out._values = merged
        return out

    def v(self, level: int) -> bool:
        """Cheap verbosity gate: `if log.v(4): ...expensive args...`."""
        return _VERBOSITY >= level

    def _emit(self, lvl: int, msg: str, v: int, kv: dict) -> None:
        if self._values:
            merged = dict(self._values)
            merged.update(kv)
            kv = merged
        self._log.log(lvl, msg, extra={"kv": kv, "v": v})

    def info(self, msg: str, **kv) -> None:
        self._emit(logging.INFO, msg, 0, kv)

    def error(self, msg: str, **kv) -> None:
        self._emit(logging.ERROR, msg, 0, kv)

    def v2(self, msg: str, **kv) -> None:
        if self.v(2):
            self._emit(logging.INFO, msg, 2, kv)

    def v4(self, msg: str, **kv) -> None:
        if self.v(4):
            self._emit(logging.INFO, msg, 4, kv)

    def v10(self, msg: str, **kv) -> None:
        if self.v(10):
            self._emit(logging.INFO, msg, 10, kv)


def get_logger(name: str) -> StructuredLogger:
    return StructuredLogger(name)
