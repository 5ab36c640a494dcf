"""The program's own spans in a cell's traced calls, and what the per-layer
metrics read from them.

``nf_tpu_torch.utils.profiling.span`` records the program's phases (``nf.*``,
PERF.md section 3) as ``record_function`` ranges in the same ``torch.profiler``
trace as the device's records, on the host's clock.  :func:`program_trace`
reduces that trace to the spans by name and the merged device-busy
intervals inside the traced window (the first ``bench.call``'s start to the
last one's end, as :func:`benchmark.trace.reduce` takes it), so device-idle
time can be put down to what the program was doing:

* :func:`idle_under`: the idle time while the host is inside any span of a
  set, and outside every span of another;
* :func:`idle_by_innermost`: the idle time split by the innermost ``nf.*``
  span around it (``(none)`` outside them all).

The harness hands a metric reader the trace's reduction, which holds no span
of the program; :func:`of_run` finds the traced calls' profile where the
harness keeps it, the local ``prof`` of a calling frame, and reads ``None``
where there is none.  A program without spans, such as a version older
than them, reads ``None`` too, and so does :func:`host_reads_per_call`
where the program has no ``HOST_READS`` counter.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from benchmark import trace as btrace

PROGRAM = "nf."
NONE = "(none)"
# call indices no window or traced call uses: host_reads_per_call's calls
EXTRA_CALLS = 1 << 40
# a CUDA graph's set-up in the trainer's chunk: its eager first run, its
# capture and its first replay
GRAPH_SETUP = ("nf.chunk.eager", "nf.chunk.capture", "nf.chunk.first_replay")


@dataclasses.dataclass
class ProgramTrace:
    spans: dict      # span name -> [(start_ns, end_ns)], the program's and the benchmark's
    busy: tuple      # (starts, ends): merged device-busy intervals, clipped to the window
    w0: int
    w1: int

    @property
    def window_s(self):
        return (self.w1 - self.w0) * 1e-9


def program_trace(prof):
    """The spans and the device-busy intervals of a traced run's profile;
    ``None`` where it holds no span of the program or no traced call."""
    from torch.autograd import DeviceType

    spans, d_s, d_e = {}, [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                d_s.append(e.start_ns())
                d_e.append(e.end_ns())
        elif e.name().startswith((PROGRAM, "bench.")):
            spans.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    calls = sorted(spans.get("bench.call", []))
    if not calls or not any(n.startswith(PROGRAM) for n in spans):
        return None
    w0, w1 = calls[0][0], calls[-1][1]
    d_s, d_e = np.asarray(d_s, np.int64), np.asarray(d_e, np.int64)
    keep = (d_e > w0) & (d_s < w1)
    busy = btrace._merge(np.clip(d_s[keep], w0, w1), np.clip(d_e[keep], w0, w1))
    return ProgramTrace(spans=spans, busy=busy, w0=w0, w1=w1)


def _profile_in_callers():
    """The traced calls' profile: the local ``prof`` of the nearest calling
    frame that holds a ``torch.profiler.profile`` there (``harness.main``)."""
    frame = sys._getframe(1)
    while frame is not None:
        prof = frame.f_locals.get("prof")
        if isinstance(prof, torch.profiler.profile):
            return prof
        frame = frame.f_back
    return None


def of_run(run):
    """:func:`program_trace` of a traced run, or ``None``."""
    if run.trace is None:
        return None
    prof = _profile_in_callers()
    return None if prof is None else program_trace(prof)


def _idle(pt):
    """The idle intervals ``(starts, ends)``: the window less the busy ones."""
    s, e = pt.busy
    g_s = np.concatenate([[pt.w0], e])
    g_e = np.concatenate([s, [pt.w1]])
    keep = g_e > g_s
    return g_s[keep], g_e[keep]


def _covered(starts, ends, t):
    """The length of the sorted, disjoint intervals ``[starts, ends)`` that
    lies before each time in ``t``."""
    lengths = ends - starts
    before = np.concatenate([[0], np.cumsum(lengths)])
    i = np.searchsorted(starts, t, side="right")
    last = np.maximum(i - 1, 0)
    return np.where(i > 0, before[last] + np.clip(t - starts[last], 0, lengths[last]), 0)


def _idle_in(idle, intervals):
    """Idle nanoseconds inside each of ``intervals`` (``[(start, end)]``)."""
    if not len(intervals) or not len(idle[0]):
        return np.zeros(len(intervals))
    a = np.asarray(intervals, np.int64)
    return _covered(*idle, a[:, 1]) - _covered(*idle, a[:, 0])


def _union(pt, names):
    """The merged intervals of every span named ``n`` or below ``n.``."""
    out = [iv for name, ivs in pt.spans.items() for iv in ivs
           if any(name == n or name.startswith(n + ".") for n in names)]
    if not out:
        return []
    s, e = btrace._merge(*np.asarray(out, np.int64).T)
    return list(zip(s.tolist(), e.tolist()))


def _intersect(a, b):
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle_under(pt, names, exclude=()):
    """Seconds of the window in which the device is idle and the host is
    inside a span of ``names`` (a name ``n`` takes every span named ``n`` or
    below ``n.``) and inside none of ``exclude``."""
    idle = _idle(pt)
    inside = _union(pt, names)
    total = float(np.sum(_idle_in(idle, inside)))
    if exclude:
        total -= float(np.sum(_idle_in(idle, _intersect(inside, _union(pt, exclude)))))
    return total * 1e-9


def idle_by_innermost(pt):
    """``{span name: seconds}``: the window's idle time by the innermost
    ``nf.*`` span around it, ``(none)`` outside every one (the spans of one
    thread nest)."""
    idle = _idle(pt)
    ivs = sorted(((s, e, n) for n, v in pt.spans.items() if n.startswith(PROGRAM)
                  for s, e in v), key=lambda x: (x[0], -x[1]))
    own = _idle_in(idle, [(s, e) for s, e, _ in ivs])
    out, stack = {}, []
    idle_total = float(np.sum(idle[1] - idle[0]))
    out[NONE] = idle_total
    for k, (s, e, name) in enumerate(ivs):
        while stack and ivs[stack[-1]][1] <= s:
            stack.pop()
        parent = ivs[stack[-1]][2] if stack else NONE
        out[name] = out.get(name, 0.0) + own[k]
        out[parent] = out.get(parent, 0.0) - own[k]
        stack.append(k)
    return {n: v * 1e-9 for n, v in sorted(out.items(), key=lambda kv: -kv[1])}


def idle_pct_under(run, names, exclude=()):
    """:func:`idle_under` as a share of the traced window, or ``None``."""
    pt = of_run(run)
    if pt is None or pt.window_s <= 0:
        return None
    return 100.0 * idle_under(pt, names, exclude) / pt.window_s


def host_reads_per_call(run, calls):
    """The program's ``HOST_READS`` advanced by one call of the cell's
    driver, averaged over ``calls`` more calls after the traced ones (not
    traced: the harness reads the metrics before it frees the driver);
    ``None`` where the program has no such counter."""
    from nf_tpu_torch.utils import profiling

    if getattr(profiling, "HOST_READS", None) is None or run.driver is None:
        return None
    reads = 0
    for k in range(calls):
        before = profiling.HOST_READS
        run.driver.call(EXTRA_CALLS + k)
        reads += profiling.HOST_READS - before
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return reads / calls
