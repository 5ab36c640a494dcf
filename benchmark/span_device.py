"""Device time launched from inside one of the program's spans, as a share
of the traced calls' device time.

:func:`benchmark.trace.reduce` keeps the device time launched inside the
benchmark's ``bench.integrand`` spans; this reads the same for any span of
the program, from the traced calls' profile (found as
:func:`benchmark.spans.of_run` finds it).  A kernel counts where the host
call that launched it (``cudaLaunchKernel`` and its kin, matched by
correlation id) starts inside a span of that name; its time counts where it
runs inside the traced window.  ``None`` where the run was not traced or the
program has no span of that name, as a version older than the span has
none.
"""

from __future__ import annotations

import numpy as np

from benchmark import spans, trace


def launched_under(prof, name):
    """``(seconds launched inside spans named name, seconds of every device
    operation)`` within the traced window, or ``None`` without such a
    span."""
    from torch.autograd import DeviceType

    dev, launch, inside, calls = [], {}, [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((e.start_ns(), e.end_ns(), e.correlation_id()))
        elif e.name() == name:
            inside.append((e.start_ns(), e.end_ns()))
        elif e.name() == "bench.call":
            calls.append((e.start_ns(), e.end_ns()))
        elif e.name().startswith(trace._LAUNCH):
            launch[e.correlation_id()] = e.start_ns()
    if not inside or not calls or not dev:
        return None
    w0, w1 = min(s for s, _ in calls), max(e for _, e in calls)
    d = np.asarray(dev, np.int64)
    keep = (d[:, 1] > w0) & (d[:, 0] < w1)
    length = (d[:, 1] - d[:, 0]) * 1e-9
    t = np.asarray([launch.get(c, -1) for c in d[:, 2]], np.int64)
    s, e = trace._merge(*np.asarray(inside, np.int64).T)
    under = trace._inside(t, s, e) & (t >= 0) & keep
    return float(np.sum(length[under])), float(np.sum(length[keep]))


def pct_under(run, name):
    """:func:`launched_under` as a percentage of the device time, or
    ``None``."""
    if run.trace is None:
        return None
    prof = spans._profile_in_callers()
    got = None if prof is None else launched_under(prof, name)
    return None if got is None or got[1] <= 0 else 100.0 * got[0] / got[1]
