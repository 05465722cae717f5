"""KUBE_TPU_* environment-knob parsing.

A copy of the reference package's helpers (kubernetes_tpu/utils/envknob.py).
A malformed value never kills the process: the helpers log one warning
naming the variable, the rejected value and the default they fall back
to, then return the default. An unset or empty variable yields the default.
"""

from __future__ import annotations

import logging
import os

_log = logging.getLogger("kubernetes_tpu_torch.envknob")


def int_env(name: str, default: int) -> int:
    """Parse env var `name` as int; warn and fall back on malformed input."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        _log.warning("ignoring malformed %s=%r; using default %r",
                     name, raw, default)
        return default


def float_env(name: str, default: float | None) -> float | None:
    """Parse env var `name` as float; warn and fall back on malformed input.
    `default` may be None: unset, empty and malformed all yield it."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        _log.warning("ignoring malformed %s=%r; using default %r",
                     name, raw, default)
        return default
