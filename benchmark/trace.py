"""The traced calls: a device profile and what the metrics read from it.

:func:`profile` is a copy of the program's ``utils.profiling.device_profile``
rule: kineto drops a device record whose timestamp, moved onto the host's
clock, falls before the trace's window, and right after CUPTI's activities
are enabled that shift is largest; so the recording starts after a warm-up
step of tiny kernels and the traced calls start ``LEAD_S`` later.

:func:`reduce` turns the records into a :class:`Trace`: the device
operations by name, the union of device-busy time within the traced window
(the first traced call's start to the last one's end, on the host's clock),
the device time launched from inside the benchmark's ``bench.integrand``
spans, the longest idle gaps named by what the host was doing in their
middle (the innermost host operation or span), and the
launches that have no device record outside a CUDA-graph capture (a launch
made while a graph is captured runs nothing and has none; the benchmark
marks captures with ``bench.capture`` spans).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

WARMUP_LAUNCHES = 32
WARMUP_GAP_S = 1e-3
LEAD_S = 0.05
_LAUNCH = ("cudaLaunch", "cudaGraphLaunch", "cudaMemcpy", "cudaMemset")


def _warm_up():
    x = torch.zeros(1, device="cuda")
    for _ in range(WARMUP_LAUNCHES):
        x.add_(1)
        torch.cuda.synchronize()
        time.sleep(WARMUP_GAP_S)


@contextlib.contextmanager
def profile():
    """A host and device ``torch.profiler`` recording of the block."""
    from torch.profiler import ProfilerActivity, schedule
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        _warm_up()
        prof.step()
        torch.cuda.synchronize()
        time.sleep(LEAD_S)
        yield prof


@contextlib.contextmanager
def mark_captures():
    """``bench.capture`` spans around every CUDA-graph capture."""
    graph = torch.cuda.CUDAGraph
    begin, end = graph.capture_begin, graph.capture_end
    spans = {}

    def capture_begin(self, *args, **kwargs):
        span = torch.autograd.profiler.record_function("bench.capture")
        span.__enter__()
        spans[id(self)] = span
        return begin(self, *args, **kwargs)

    def capture_end(self, *args, **kwargs):
        try:
            return end(self, *args, **kwargs)
        finally:
            span = spans.pop(id(self), None)
            if span is not None:
                span.__exit__(None, None, None)

    graph.capture_begin, graph.capture_end = capture_begin, capture_end
    try:
        yield
    finally:
        graph.capture_begin, graph.capture_end = begin, end


@dataclasses.dataclass
class Trace:
    ops: dict            # device operation name -> (seconds, count)
    busy_s: float        # union of device-busy time within the window
    window_s: float
    integrand_s: float   # device time launched inside bench.integrand spans
    device_s: float      # device time of every operation in the window
    gaps: list           # [(host activity, seconds)], longest first
    lost: int            # launches without a device record, outside captures
    launches: int


def _inside(t, starts, ends):
    """Whether each time in ``t`` falls inside one of the sorted,
    non-overlapping intervals ``[starts, ends)``."""
    if len(starts) == 0:
        return np.zeros(len(t), dtype=bool)
    i = np.searchsorted(starts, t, side="right") - 1
    return (i >= 0) & (t < ends[np.maximum(i, 0)])


def _merge(starts, ends):
    order = np.argsort(starts, kind="stable")
    out_s, out_e = [], []
    for s, e in zip(starts[order], ends[order]):
        if out_e and s <= out_e[-1]:
            out_e[-1] = max(out_e[-1], e)
        else:
            out_s.append(s)
            out_e.append(e)
    return np.asarray(out_s, np.int64), np.asarray(out_e, np.int64)


def reduce(prof, top=10):
    from torch.autograd import DeviceType

    dev, cpu, launch, spans = [], [], {}, {"bench.call": [], "bench.integrand": [],
                                           "bench.capture": []}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((e.name(), e.start_ns(), e.end_ns(), e.correlation_id()))
            continue
        name = e.name()
        if name in spans:
            spans[name].append((e.start_ns(), e.end_ns()))
        elif name.startswith(_LAUNCH):
            launch[e.correlation_id()] = e.start_ns()
        cpu.append((name, e.start_ns(), e.end_ns()))
    calls = sorted(spans["bench.call"])
    if not calls or not dev:
        raise RuntimeError("the traced calls left no device record")
    w0, w1 = calls[0][0], calls[-1][1]
    d_s = np.asarray([d[1] for d in dev], np.int64)
    d_e = np.asarray([d[2] for d in dev], np.int64)
    keep = (d_e > w0) & (d_s < w1)
    ops = {}
    for (name, s, e, _), k in zip(dev, keep):
        if k:
            sec, n = ops.get(name, (0.0, 0))
            ops[name] = (sec + (e - s) * 1e-9, n + 1)
    m_s, m_e = _merge(np.clip(d_s[keep], w0, w1), np.clip(d_e[keep], w0, w1))
    busy = float(np.sum(m_e - m_s)) * 1e-9

    # device time launched from inside the integrand's spans
    integ = sorted(spans["bench.integrand"])
    i_s = np.asarray([s for s, _ in integ], np.int64)
    i_e = np.asarray([e for _, e in integ], np.int64)
    corr_t = np.asarray([launch.get(d[3], -1) for d in dev], np.int64)
    in_integ = _inside(corr_t, i_s, i_e) & keep & (corr_t >= 0)
    integrand_s = float(np.sum((d_e - d_s)[in_integ])) * 1e-9

    # launches with no device record, outside captures
    caps = sorted(spans["bench.capture"])
    recorded = {d[3] for d in dev}
    missing = np.asarray([t for c, t in launch.items() if c not in recorded and w0 <= t <= w1],
                         np.int64)
    lost = int(np.sum(~_inside(missing, np.asarray([s for s, _ in caps], np.int64),
                               np.asarray([e for _, e in caps], np.int64))))

    # the longest idle gaps, named by the innermost host activity at their middle
    g_s = np.concatenate([[w0], m_e])
    g_e = np.concatenate([m_s, [w1]])
    length = g_e - g_s
    c_name = [c[0] for c in cpu]
    c_s = np.asarray([c[1] for c in cpu], np.int64)
    c_e = np.asarray([c[2] for c in cpu], np.int64)
    is_span = np.asarray([n.startswith("bench.") for n in c_name], bool)
    gaps = []
    for j in np.argsort(-length)[:top]:
        if length[j] <= 0:
            break
        t = (g_s[j] + g_e[j]) // 2
        cover = np.nonzero((c_s <= t) & (c_e > t))[0]
        label = c_name[cover[np.argmax(c_s[cover])]] if len(cover) else "(no host activity)"
        if label.startswith("bench."):
            # no operation runs: name the host's last one before the middle
            done = np.nonzero((c_e <= t) & ~is_span)[0]
            if len(done):
                label += " after " + c_name[done[np.argmax(c_e[done])]]
        gaps.append((label, float(length[j]) * 1e-9))
    return Trace(ops=ops, busy_s=busy, window_s=(w1 - w0) * 1e-9, integrand_s=integrand_s,
                 device_s=float(np.sum((d_e - d_s)[keep])) * 1e-9, gaps=gaps, lost=lost,
                 launches=len([t for t in launch.values() if w0 <= t <= w1]))


def short(name, width=120):
    """A device operation's name without ``void`` and cut to ``width``."""
    return name.removeprefix("void ")[:width]


def kernel_time(trace, prefix):
    """``(seconds, launches)`` of the device operations whose name, with any
    ``void`` dropped, starts with ``prefix``."""
    sec = n = 0
    for name, (s, k) in trace.ops.items():
        if name.removeprefix("void ").startswith(prefix):
            sec, n = sec + s, n + k
    return sec, n
