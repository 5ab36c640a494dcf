"""The readers of the program's spans and host-read counter
(``benchmark/spans.py``) on synthetic traces, on a real CPU trace of a
cell's call, and against a program without spans or counter."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness, readers, spans, trace
from benchmark.tests._drive import cpu_paths, driver_of, spec_of
from benchmark.tests.test_bench_counts import _Event

METRICS = ["host_reads_per_call.integrate", "host_reads_per_call.unweight",
           "idle_fold_pct.integrate", "idle_unweighter_pct.unweight",
           "idle_graph_setup_pct.job", "idle_graph_setup_pct.train"]
CELL = {"integrate": "camel2d.integrate", "unweight": "zz4l.unweight",
        "job": "camel2d.train", "train": "zz4l.train_stale"}


class _Prof(torch.profiler.profile):
    """A profile holding ``events``, as the harness's ``prof`` holds its
    traced calls."""

    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {
            "events": staticmethod(lambda: events)})()})()


def _dev(start, end):
    return _Event("k", start, end, cuda=True)


def _run(cell, calls=(), tr=None, driver=None):
    spec = spec_of(cell)
    ctx = harness.Ctx(spec, 1, torch.device("cpu"))
    return harness.Run(spec, ctx, driver, 2.5, 0.0, list(calls), tr)


TRACE = trace.Trace(ops={}, busy_s=0.6, window_s=1.0, integrand_s=0.0, device_s=0.6, gaps=[],
                    lost=0, launches=0)

# the window 100-1100 (the first traced call's start to the last one's end);
# the device busy 0-50, 130-200, 400-500 and 1050-1200, so the gaps 50-130
# and 500-1050 straddle the window's edges; the unweighter's call 150-1100,
# a batch 300-1000 inside it whose integrand runs 350-600 (excluded) and
# whose read 700-900 (nested twice)
EVENTS = [_Event("bench.call", 100, 1100, annotation=True),
          _Event("nf.unweight", 150, 1100), _Event("nf.unweight.batch", 300, 1000),
          _Event("bench.integrand", 350, 600), _Event("nf.read.rows", 700, 900),
          _dev(0, 50), _dev(130, 200), _dev(400, 500), _dev(1050, 1200)]


def test_idle_under_spans_on_synthetic_intervals():
    pt = spans.program_trace(_Prof(EVENTS))
    assert (pt.w0, pt.w1) == (100, 1100)
    # idle in the window: 100-130, 200-400, 500-1050
    assert spans.idle_under(pt, ("nf.unweight",)) == pytest.approx((200 + 550) * 1e-9)
    # less the integrand's idle 350-400 and 500-600
    assert spans.idle_under(pt, ("nf.unweight",), exclude=("bench.integrand",)) == \
        pytest.approx((200 + 550 - 150) * 1e-9)
    # a name takes the spans below it, not a name that only starts alike
    assert spans.idle_under(pt, ("nf.unweight.batch",)) == pytest.approx((100 + 500) * 1e-9)
    assert spans.idle_under(pt, ("nf.unweigh",)) == 0.0
    split = spans.idle_by_innermost(pt)
    assert split == pytest.approx({"nf.read.rows": 200e-9, "nf.unweight.batch": 400e-9,
                                   "nf.unweight": 150e-9, spans.NONE: 30e-9})
    assert list(split) == ["nf.unweight.batch", "nf.read.rows", "nf.unweight", spans.NONE]


def test_spans_readers_find_the_harness_profile():
    prof = _Prof(EVENTS)  # noqa: F841 (found in this frame, as in harness.main)
    run = _run("zz4l.unweight", tr=TRACE)
    got = spans.idle_pct_under(run, ("nf.unweight",), exclude=("bench.integrand",))
    assert got == pytest.approx(100 * 600 / 1000)
    assert run.spec.load("metrics", "idle_unweighter_pct.unweight").read(run) == \
        pytest.approx(got)


@pytest.mark.parametrize("name", METRICS)
def test_new_metrics_read_none_without_the_program_spans(name, monkeypatch):
    """A program without spans and without ``HOST_READS`` (the version before
    them): every new metric reads ``None``; the old ones read as before."""
    from nf_tpu_torch.utils import profiling

    prof = _Prof([e for e in EVENTS if not e.name().startswith("nf.")])  # noqa: F841
    monkeypatch.delattr(profiling, "HOST_READS")
    run = _run(CELL[name.split(".")[-1]], calls=[{"t0": 0.0, "t1": 1.0, "samples": 1}],
               tr=TRACE, driver=object())
    assert run.spec.load("metrics", name).read(run) is None
    assert readers.idle_pct(run) == pytest.approx(40.0)
    assert run.spec.load("metrics", "setup_s").read(run) == 2.5


def test_spans_metrics_read_none_untraced():
    run = _run("camel2d.integrate")
    assert run.spec.load("metrics", "idle_fold_pct.integrate").read(run) is None


def test_fold_idle_and_host_reads_on_a_cpu_call():
    """A real CPU trace of camel2d.integrate's call (no device records: the
    whole window is idle): the fold's share is the fold's spans over the
    window; the host reads per call are the fold's 42, the seed and the
    result."""
    spec, ctx, driver = driver_of("camel2d.integrate")
    with cpu_paths():
        driver.setup()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with torch.autograd.profiler.record_function("bench.call"):
                driver.call(0)
        run = harness.Run(spec, ctx, driver, 1.0, 0.0, [], TRACE)
        pct = spec.load("metrics", "idle_fold_pct.integrate").read(run)
        pt = spans.program_trace(prof)
        fold = sum(e - s for s, e in pt.spans["nf.fold"])
        assert pct == pytest.approx(100 * fold / (pt.w1 - pt.w0))
        assert 0 < pct < 100
        assert spec.load("metrics", "host_reads_per_call.integrate").read(run) == 42 + 1 + 1
