"""Drive the rest of a run on the CPU at a test's size: the harness's look
for a chip skipped, the program run on the CPU, where its kernels' plain
versions stand in (the sampler's plain version draws the same Philox
latents)."""

from __future__ import annotations

import contextlib
import os
import time

import torch

from benchmark import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED = 2_147_483_711    # above 2^31, as the driver's seeds are

# each cell at a size the CPU holds; the flows keep their widths
SMALL = {
    "camel2d.integrate": ({"neval": 4096, "check": {"calls": 2, "among_first": 3}}, {}),
    "zz4l.unweight": ({"batch": 2048, "bn_pass": 2048, "warm_batches": 2,
                       "check": {"calls": 2, "among_first": 3}}, {}),
    "zz4l.train_stale": ({"epochs": 3}, {"batch_size": 2048, "mini_batch_size": 512}),
    "camel2d.train": ({"epochs": 25}, {"batch_size": 2000, "mini_batch_size": 1000}),
}


@contextlib.contextmanager
def cpu_paths():
    """On the CPU the managers take the plain, stateful paths by default;
    the card's default is the fused sampler, whose plain version runs on
    the CPU when asked for.  Ask for it, as the card's default would."""
    import nf_tpu_torch.training.unweight as uw
    from nf_tpu_torch.training.manager import BasicManager

    resolve, generate = BasicManager._resolve_method, uw.generate_unweighted
    BasicManager._resolve_method = lambda self, method, train: "fused"
    uw.generate_unweighted = lambda *a, **k: generate(*a, **dict(k, method="fused"))
    try:
        yield
    finally:
        BasicManager._resolve_method, uw.generate_unweighted = resolve, generate


def spec_of(cell):
    spec = harness.Spec(ROOT, cell)
    wl, tr = SMALL[cell]
    spec.wl.update(wl)
    spec.cfg["training"].update(tr)
    return spec


def driver_of(cell, seed=SEED):
    spec = spec_of(cell)
    ctx = harness.Ctx(spec, seed, torch.device("cpu"))
    return spec, ctx, spec.load("drivers", spec.wl["driver"]).Driver(ctx)


def drive(cell, calls=2, seed=SEED):
    """``(correct, {number: value}, run)`` of a run of ``calls`` calls."""
    spec, ctx, driver = driver_of(cell, seed)
    with cpu_paths():
        driver.setup()
        recs, t_window = [], time.perf_counter()
        for i in range(calls):
            c0 = time.perf_counter()
            rec = driver.call(i)
            recs.append(dict(rec, t0=c0, t1=time.perf_counter()))
    run = harness.Run(spec, ctx, driver, 1.0, t_window, recs)
    driver.free()
    compared = driver.check()
    return all(v <= lim for _, v, lim in compared), {n: v for n, v, _ in compared}, run
