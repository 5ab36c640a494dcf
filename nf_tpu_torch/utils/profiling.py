"""Tracing / profiling helpers.

Counterpart of ``nf_tpu.utils.profiling``.  The reference's observability is
tqdm bars and datetime deltas (SURVEY.md section 5).  Here: a
``torch.profiler`` trace capture for TensorBoard / Perfetto, and a
wall-clock timer that waits for the device work of its outputs, so timings
measure compute rather than launch.
"""

from __future__ import annotations

import contextlib
import time
from collections.abc import Mapping

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a host and (with a card) device trace into ``logdir``, one
    Chrome-trace JSON file, viewable in TensorBoard / Perfetto.  Yields the
    ``torch.profiler.profile`` object.

    >>> with profiling.trace("runs/trace"):
    ...     manager.integrate(f, 10, 1 << 20)
    """
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def _cuda_devices(tree, out):
    if isinstance(tree, Mapping):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _cuda_devices(v, out)
    elif isinstance(tree, torch.Tensor) and tree.is_cuda:
        out.add(tree.device)
    return out


def block_until_ready(tree):
    """Wait for the devices of the CUDA tensors in ``tree`` (nested dicts,
    tuples and lists); returns ``tree``."""
    for device in _cuda_devices(tree, set()):
        torch.cuda.synchronize(device)
    return tree


class Timer:
    """Wall-clock timer that waits for device work.

    >>> with Timer() as t:
    ...     out = step(x)
    ...     t.block_on(out)
    >>> t.seconds
    """

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def block_on(self, tree):
        return block_until_ready(tree)

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        return False


def benchmark(fn, *args, reps: int = 10, warmup: int = 2):
    """Best-of-``reps`` wall-clock seconds of ``fn(*args)``, each call
    waited for; ``warmup`` calls first (builds, caches)."""
    for _ in range(warmup):
        block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best
