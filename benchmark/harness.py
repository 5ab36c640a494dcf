"""One run of one cell: set-up, the measured window, the traced calls, the
check against the reference, and the result's line.

Everything that belongs to one cell, configuration or metric is a file that
the harness finds by its name in ``BENCHMARK.json``:

* ``benchmark/workloads/<cell>.json``: the configuration, the driver (the
  entry point the window drives, ``benchmark/drivers/<driver>.py``), the
  traffic's parameters, the check's sample and its limits;
* the configuration's ``file``: the flow's sizes, its initialisation, the
  integrand and the published training settings;
* ``benchmark/metrics/<metric>.py``: ``read(run)``, the metric's value or
  ``None`` where the run holds nothing to read.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "nf_tpu")


class Spec:
    """A cell as ``BENCHMARK.json`` and its files describe it."""

    def __init__(self, root, cell):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        entry = {w["name"]: w for w in self.bench["workloads"]}.get(cell)
        if entry is None:
            raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")
        self.cell, self.entry = cell, entry
        self.wl = json.loads((self.root / "benchmark" / "workloads" / f"{cell}.json").read_text())
        conf = {c["name"]: c for c in self.bench["configs"]}[entry["config"]]
        self.cfg = json.loads((self.root / conf["file"]).read_text())

    def metrics(self, trace):
        """The metrics this cell reports: its end-to-end ones, or with
        ``trace`` its per-layer ones."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group if self.cell in m.get("workloads", [self.cell])]

    def load(self, kind, name):
        """The module ``benchmark/<kind>/<name>.py``."""
        path = self.root / "benchmark" / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


class Ctx:
    def __init__(self, spec, seed, device):
        from benchmark.reference import flow

        fl = spec.cfg["flow"]
        self.seed, self.device, self.cfg, self.wl = seed, device, spec.cfg, spec.wl
        self.plan = flow.pwquad_plan(fl["n_flow"], fl["n_cells"], fl["n_bins"], fl["hidden"])


class Run:
    """What the metric readers read."""

    def __init__(self, spec, ctx, driver, setup_s, t_window, calls, trace=None):
        self.spec, self.ctx, self.driver = spec, ctx, driver
        self.cfg, self.wl, self.plan = spec.cfg, spec.wl, ctx.plan
        self.setup_s, self.t_window, self.calls, self.trace = setup_s, t_window, calls, trace

    def elapsed(self):
        """From the window's start to the end of its last completed call."""
        return self.calls[-1]["t1"] - self.t_window if self.calls else None

    def rate(self, key):
        t = self.elapsed()
        return sum(c[key] for c in self.calls) / t if t else None


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg, code):
    print(msg, file=sys.stderr)
    return code


def main(argv, t0, root="."):
    args = parse(argv)
    spec = Spec(root, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.entry["chips"]:
        return fail(f"{args.workload} needs {spec.entry['chips']} CUDA device(s); "
                    f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", 2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    from benchmark import trace as btrace

    t_imported = time.perf_counter()
    ctx = Ctx(spec, args.seed, torch.device("cuda", 0))
    torch.zeros(1, device=ctx.device)
    t_context = time.perf_counter()
    driver = spec.load("drivers", spec.wl["driver"]).Driver(ctx)
    driver.setup()
    torch.cuda.synchronize()
    t_window = time.perf_counter()
    setup_s = t_window - t0
    parts = {"import": t_imported - t0, "cuda_context": t_context - t_imported,
             "driver": t_window - t_context, **getattr(driver, "setup_parts", {})}
    print("setup parts: " + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items()), file=sys.stderr)

    calls, end, i = [], t_window + args.seconds, 0
    while time.perf_counter() < end:
        c0 = time.perf_counter()
        rec = driver.call(i)
        torch.cuda.synchronize()
        c1 = time.perf_counter()
        if c1 <= end:
            calls.append(dict(rec, t0=c0, t1=c1))
        i += 1
    attempted = i
    if calls:
        d = sorted(c["t1"] - c["t0"] for c in calls)
        print(f"window: {len(calls)} calls completed of {attempted}, seconds min {d[0]:.4f} "
              f"median {d[len(d) // 2]:.4f} max {d[-1]:.4f}", file=sys.stderr)

    tr = None
    if args.trace:
        with btrace.mark_captures(), btrace.profile() as prof:
            for j in range(spec.wl["trace_calls"]):
                with torch.autograd.profiler.record_function("bench.call"):
                    driver.call(i + j)
                    torch.cuda.synchronize()
        tr = btrace.reduce(prof)
        if tr.lost:
            return fail(f"the trace lacks the device record of {tr.lost} of {tr.launches} "
                        "launches made outside a graph capture: no share is reported", 3)
    if forbidden_modules():
        return fail(f"loaded in this process: {forbidden_modules()}", 4)
    peak = torch.cuda.max_memory_allocated()

    run = Run(spec, ctx, driver, setup_s, t_window, calls, tr)
    metrics = {}
    for m in spec.metrics(args.trace):
        value = spec.load("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    driver.free()
    torch.cuda.empty_cache()
    compared = driver.check()
    correct = all(v <= lim for _, v, lim in compared)

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
              "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted, "failed": 0, "metrics": metrics,
              "device": device}
    if tr is not None:
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        ops = sorted(tr.ops.items(), key=lambda kv: -kv[1][0])[:10]
        result["breakdown"] = {"device_ops": [[btrace.short(n), s] for n, (s, _) in ops],
                               "idle_gaps": [[n, s] for n, s in tr.gaps[:10]]}
    result["checks"] = {n: {"value": v if math.isfinite(v) else str(v), "limit": lim}
                        for n, v, lim in compared}
    if forbidden_modules():
        return fail(f"loaded in this process: {forbidden_modules()}", 4)
    for n, v, lim in compared:
        print(f"check {n} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    for n, v in getattr(driver, "info", {}).items():
        print(f"info {n} {v!r} (not compared)", file=sys.stderr)
    print(json.dumps(result))
    return 0
