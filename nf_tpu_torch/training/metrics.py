"""Metrics/observability protocol.

Counterpart of ``nf_tpu.training.metrics``.  The reference logs through an
optional Sacred ``run`` object (``run.log_scalar(name, value, step)``,
reference manager.py:197-198,286-288,354-356); the port keeps the same
duck-typed protocol, so any backend (Sacred, wandb, CSV, stdout) plugs in.
``value`` may be a Python number or a 0-d tensor: the loggers store
``float(value)``.
"""

from __future__ import annotations

import json
import time
from typing import Protocol, runtime_checkable


@runtime_checkable
class MetricsLogger(Protocol):
    def log_scalar(self, name: str, value, step: int) -> None: ...


class NullLogger:
    def log_scalar(self, name, value, step):  # noqa: D401
        pass


class MemoryLogger:
    """Accumulates scalars in memory: {name: [(step, value), ...]}."""

    def __init__(self):
        self.scalars: dict[str, list] = {}

    def log_scalar(self, name, value, step):
        self.scalars.setdefault(name, []).append((step, float(value)))


class JSONLLogger:
    """Appends one JSON line per scalar to a file."""

    def __init__(self, path):
        self.path = path
        self._t0 = time.time()

    def log_scalar(self, name, value, step):
        with open(self.path, "a") as fh:
            fh.write(json.dumps({
                "name": name, "value": float(value), "step": int(step),
                "t": time.time() - self._t0,
            }) + "\n")
