"""The metric arithmetic on synthetic records, and the frozen yardstick
against the counts the repository's chip checks use."""

from __future__ import annotations

import statistics

import numpy as np
import pytest
import torch

from benchmark import harness, readers, trace, yardstick
from benchmark.reference import flow
from benchmark.tests._drive import spec_of

PLANS = {"camel2d": (2, 2, 4, [3, 3, 3]), "zz4l": (10, 4, 32, [32, 32])}


def _run(cell, calls, tr=None, t_window=0.0):
    spec = spec_of(cell)
    ctx = harness.Ctx(spec, 1, torch.device("cpu"))
    return harness.Run(spec, ctx, None, 2.5, t_window, calls, tr)


def test_window_rates_and_tail():
    calls = [{"t0": i * 0.1, "t1": i * 0.1 + 0.1, "samples": 100,
              "sum_w": 2.0, "sum_w2": 3.0} for i in range(40)]
    run = _run("camel2d.integrate", calls)
    assert run.elapsed() == pytest.approx(4.0)
    assert run.rate("samples") == pytest.approx(40 * 100 / 4.0)
    # Kish over every event of every call: (40 * 2)^2 / (40 * 3) per 4 s
    assert readers.kish_rate(run) == pytest.approx(80.0 ** 2 / 120.0 / 4.0)
    calls = [{"t0": 0.0, "t1": d / 1e3} for d in range(1, 101)]
    assert readers.p95_ms(_run("camel2d.integrate", calls)) == pytest.approx(
        float(np.percentile(np.arange(1, 101), 95)))
    assert readers.p95_ms(_run("camel2d.integrate", [])) is None


class _Event:
    def __init__(self, name, start, end, cuda=False, corr=0, annotation=False):
        from torch.autograd import DeviceType
        self._v = (name, start, end, DeviceType.CUDA if cuda else DeviceType.CPU, corr, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {
            "events": staticmethod(lambda: events)})()})()


def test_trace_reduction():
    """Device busy time is the union of the operations' intervals inside the
    window; launches inside a capture need no record; the integrand's share
    counts device time launched inside its spans."""
    ev = [_Event("bench.call", 0, 1000, annotation=True),
          _Event("bench.integrand", 100, 200, annotation=True),
          _Event("cudaLaunchKernel", 110, 115, corr=1), _Event("cudaLaunchKernel", 300, 305, corr=2),
          _Event("cudaLaunchKernel", 310, 315, corr=3),
          _Event("bench.capture", 600, 700, annotation=True),
          _Event("cudaLaunchKernel", 650, 655, corr=4),     # captured: no record needed
          _Event("aten::sort", 700, 990),
          _Event("pwquad_sampler_kernel", 150, 450, cuda=True, corr=1),
          _Event("k2", 400, 500, cuda=True, corr=2),       # overlaps the first
          _Event("k3", 520, 560, cuda=True, corr=3)]
    tr = trace.reduce(_Prof(ev))
    assert tr.window_s == pytest.approx(1000e-9)
    assert tr.busy_s == pytest.approx((500 - 150 + 40) * 1e-9)
    assert tr.device_s == pytest.approx((300 + 100 + 40) * 1e-9)
    assert tr.integrand_s == pytest.approx(300e-9)
    assert tr.lost == 0 and tr.launches == 4
    assert tr.gaps[0] == ("aten::sort", pytest.approx(440e-9))
    assert trace.kernel_time(tr, "pwquad_sampler") == (pytest.approx(300e-9), 1)
    ev.append(_Event("cudaLaunchKernel", 800, 805, corr=9))   # no record, outside a capture
    assert trace.reduce(_Prof(ev)).lost == 1


def test_roofline_idle_and_mfu():
    tr = trace.Trace(ops={"void pwquad_sampler_kernel<true>(...)": (2e-3, 4)}, busy_s=0.6,
                     window_s=1.0, integrand_s=0.0, device_s=0.6, gaps=[], lost=0, launches=4)
    run = _run("camel2d.integrate", [{"t0": 0.0, "t1": 2.0, "samples": 10 ** 9}], tr)
    plan = run.plan
    n = run.wl["neval"]
    bound = 4 * max(yardstick.kernel_work(plan, "sampler", n)[0] / 67e12,
                    yardstick.kernel_work(plan, "sampler", n)[1] / 3.35e12)
    assert readers.roofline_pct(run, [("pwquad_sampler_kernel", "sampler", n)]) == \
        pytest.approx(100 * bound / 2e-3)
    assert readers.idle_pct(run) == pytest.approx(40.0)
    per = yardstick.kernel_work(plan, "sampler", 1)[0]
    assert readers.mfu_pct(run, ("sampler",), "samples") == pytest.approx(100 * per * 5e8 / 67e12)
    assert readers.roofline_pct(run, [("train_bwd", "bwd", n)]) is None


@pytest.mark.parametrize("name", sorted(PLANS))
@pytest.mark.parametrize("kernel", ["sampler", "fwd", "bwd"])
def test_frozen_counts_equal_the_chip_checks(name, kernel):
    import chip_smoke
    from nf_tpu_torch import PWQuadManager
    from nf_tpu_torch.ops import pwquad_train

    nf, nc, nb, hidden = PLANS[name]
    mgr = PWQuadManager(n_flow=nf, seed=0, device="cpu")
    mgr.create_model(nc, nb, hidden)
    plan = flow.pwquad_plan(nf, nc, nb, hidden)
    for n in (1, 1 << 18, (1 << 21) + 333):
        assert yardstick.kernel_work(plan, kernel, n) == \
            chip_smoke.kernel_work(pwquad_train, mgr._flow, kernel, n)
    assert yardstick.n_stat_rows(plan) == pwquad_train.TrainPlan(mgr._flow).n_stat_rows
    stats = yardstick.kernel_work(plan, "fwd_stats", 1 << 16)
    assert stats[0] == yardstick.kernel_work(plan, "fwd", 1 << 16)[0] \
        + 3 * (1 << 16) * yardstick.n_stat_rows(plan) // 2


def test_quartile_spread_convention():
    """The bounds' spreads use Python's quartiles (exclusive method)."""
    q1, _, q3 = statistics.quantiles([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], n=4)
    assert (q1, q3) == (1.75, 5.25)
