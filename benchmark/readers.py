"""Arithmetic the metric readers share: window rates, percentiles, the
trace's shares, and rooflines against the frozen yardstick."""

from __future__ import annotations

import numpy as np

from benchmark import trace as btrace
from benchmark import yardstick


def p95_ms(run):
    if not run.calls:
        return None
    return float(np.percentile([(c["t1"] - c["t0"]) * 1e3 for c in run.calls], 95))


def kish_rate(run):
    t = run.elapsed()
    s1 = sum(c["sum_w"] for c in run.calls)
    s2 = sum(c["sum_w2"] for c in run.calls)
    return s1 * s1 / s2 / t if t and s2 > 0 else None


def idle_pct(run):
    tr = run.trace
    return None if tr is None or tr.window_s <= 0 else 100.0 * (1.0 - tr.busy_s / tr.window_s)


def mfu_pct(run, kernels, key):
    """The flow's FLOPs per sample (``kernels``' counts) times the window's
    rate of ``key``, as a share of the float32 peak."""
    rate = run.rate(key)
    if not rate:
        return None
    return 100.0 * yardstick.flops_per_sample(run.plan, kernels) * rate / yardstick.PEAK_F32_FLOPS


def roofline_pct(run, parts):
    """``parts``: ``[(kernel name prefix, yardstick kernel, samples a
    launch)]``.  The least time the traced launches could take over their
    device time; ``None`` where the trace holds none of them."""
    if run.trace is None:
        return None
    sec = bound = 0.0
    for prefix, kernel, n in parts:
        s, launches = btrace.kernel_time(run.trace, prefix)
        sec += s
        bound += launches * yardstick.bound_s(*yardstick.kernel_work(run.plan, kernel, n))
    return 100.0 * bound / sec if sec > 0 else None
