"""A cell's traced calls, with the device's idle time split by the innermost
span of the program around it:

    python3 benchmark/idle_split.py --workload <cell> --seed <n> [--warm <s>] [--repeat <k>]

Set-up as ``run.py``'s, ``--warm`` seconds of calls, then the cell's
traced calls as the harness traces them, ``--repeat`` times.  One JSON line
a trace: the window, the device's busy and idle seconds, the idle seconds by
innermost ``nf.*`` span (``spans.idle_by_innermost``; ``(none)`` outside
them) and the spans a call entered, where the program has spans, and each
traced call's seconds (compare two trees', with and without spans, for what
tracing costs).  Not part of a run's result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--warm", type=float, default=5.0)
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args(argv)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "benchmark", ".cache", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "benchmark", ".cache",
                                                      "torch_extensions")
    sys.path.insert(0, ROOT)
    import torch
    from torch.autograd import DeviceType

    from benchmark import harness, spans
    from benchmark import trace as btrace

    if not torch.cuda.is_available():
        print("idle_split.py needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    spec = harness.Spec(ROOT, args.workload)
    ctx = harness.Ctx(spec, args.seed, torch.device("cuda", 0))
    driver = spec.load("drivers", spec.wl["driver"]).Driver(ctx)
    driver.setup()
    i, end = 0, time.perf_counter() + args.warm
    while time.perf_counter() < end:
        driver.call(i)
        torch.cuda.synchronize()
        i += 1
    for _ in range(args.repeat):
        with btrace.mark_captures(), btrace.profile() as prof:
            for _ in range(spec.wl["trace_calls"]):
                with torch.autograd.profiler.record_function("bench.call"):
                    driver.call(i)
                    torch.cuda.synchronize()
                i += 1
        calls = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                       if e.name() == "bench.call" and e.device_type() != DeviceType.CUDA)
        out = {"cell": args.workload, "device": torch.cuda.get_device_name(0),
               "call_s": [(e - s) * 1e-9 for s, e in calls]}
        pt = spans.program_trace(prof)
        if pt is not None:   # a program with spans
            busy = float(sum(pt.busy[1] - pt.busy[0])) * 1e-9
            entered = sum(len(v) for n, v in pt.spans.items() if n.startswith(spans.PROGRAM))
            out.update(window_s=pt.window_s, busy_s=busy, idle_s=pt.window_s - busy,
                       idle_by_span_s=spans.idle_by_innermost(pt),
                       spans_per_call=entered / len(calls))
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
