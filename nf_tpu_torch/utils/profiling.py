"""Tracing / profiling helpers.

Counterpart of ``nf_tpu.utils.profiling``.  The reference's observability is
tqdm bars and datetime deltas (SURVEY.md section 5).  Here:

  * a ``torch.profiler`` trace capture for TensorBoard / Perfetto
    (:func:`device_profile`, :func:`trace`);
  * the program's spans (:func:`span`, :func:`spanned`): named host ranges at
    the phase boundaries of its calls, ``nf.integrate``, ``nf.fold``,
    ``nf.chunk.capture.epoch`` and the others PERF.md section 3 lists.  While
    a ``torch.profiler`` records they are ``record_function`` ranges in the
    same trace as the host's operations and the device's records, on the
    same clock, nested as they are called (~10-14 us a span under a CPU and
    CUDA profile on an NVIDIA H100 machine's host); otherwise a span is one
    check of the profiler's flag and a shared null context (~0.7 us there);
  * :data:`HOST_READS`, the count of blocking reads of device data into host
    memory on the program's call paths, each inside an ``nf.read.<site>``
    span;
  * :data:`FLOW_INVERSES`, the count of flow inverse evaluations
    (``flows.model.inverse``), kept on the host;
  * a wall-clock timer that waits for the device work of its outputs, so
    timings measure compute rather than launch.
"""

from __future__ import annotations

import contextlib
import functools
import time
from collections.abc import Mapping

import torch

# Blocking reads of device data into host memory since import (or since a
# caller reset it), one per tensor read: the BatchNorm fold's copies
# (interop.to_numpy), a kernel seed's draw, the unweighter's count and rows,
# its w_max, an integral's result, the trainer's first estimate, a chunk's
# rows (and their replay after a stop inside it), an epoch's statistics and
# the tail integration's.  A read from a CPU tensor counts the same.
HOST_READS = 0

# Calls of nf_tpu_torch.flows.model.inverse since import (or since a caller
# reset it): a host-side count, no synchronisation and no device work.  The
# learned multi-channel mixture makes C^2 of them a minibatch.
FLOW_INVERSES = 0

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks the block as the span ``name`` while a
    ``torch.profiler`` records: a ``record_function`` range, whose parent is
    the span around it.  Otherwise a shared null context.

    >>> with profiling.span("nf.fold"):
    ...     folded = fold_eval_params(flow, model)
    """
    if torch._C._autograd._profiler_enabled():
        return torch.autograd.profiler.record_function(name)
    return _NO_SPAN


def spanned(name: str):
    """Decorate a function to run inside :func:`span` ``(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


# The warm-up step of a profile on the card: tiny kernels, each waited for,
# spaced in time, whose device records the profile discards; then the lead,
# idle time at the start of the recording before the first traced launch.
WARMUP_LAUNCHES = 32
WARMUP_GAP_S = 1e-3
LEAD_S = 0.05


def _warm_up():
    x = torch.zeros(1, device="cuda")
    for _ in range(WARMUP_LAUNCHES):
        x.add_(1)
        torch.cuda.synchronize()
        time.sleep(WARMUP_GAP_S)


@contextlib.contextmanager
def device_profile(**kwargs):
    """A ``torch.profiler.profile`` of the host and, with a card, the device,
    that records what runs inside the ``with`` block.  On the card the
    device's timestamps, moved onto the host's clock, can read earlier than
    the launches that made them, and kineto drops a record that falls
    before the trace's window as out of range (an NVIDIA H100 with torch
    2.11 and CUDA 12.8; PERF.md section 6).  Right after CUPTI's
    activities are enabled the shift grows with the process's age, so a
    trace that records at once loses its first launches' records and a
    trace of a few kernels late in a long run comes back empty; later it is
    small.  So the recording starts after a warm-up step of tiny kernels
    (kineto's schedule: warm-up 1, active 1), and the block starts
    ``LEAD_S`` after the recording.  ``kwargs`` go to ``profile``.  Yields
    it; its results are there once the block ends.

    >>> with profiling.device_profile() as prof:
    ...     manager.integrate(f, 10, 1 << 20)
    >>> prof.key_averages()
    """
    from torch.profiler import ProfilerActivity, profile, schedule

    if not torch.cuda.is_available():
        with profile(activities=[ProfilerActivity.CPU], **kwargs) as prof:
            yield prof
        return
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1), **kwargs) as prof:
        _warm_up()
        prof.step()
        torch.cuda.synchronize()
        time.sleep(LEAD_S)
        yield prof


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a host and (with a card) device trace into ``logdir``, one
    Chrome-trace JSON file, viewable in TensorBoard / Perfetto: a
    :func:`device_profile`.  Yields the ``torch.profiler.profile`` object.

    >>> with profiling.trace("runs/trace"):
    ...     manager.integrate(f, 10, 1 << 20)
    """
    from torch.profiler import tensorboard_trace_handler

    with device_profile(on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
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
