#!/usr/bin/env python3
"""Count the device records that ``torch.profiler`` traces lose on the card.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 nf_tpu_torch/tools/trace_loss.py [--mode plain|warm] [--traces N] [--gap S]

The process keeps CUPTI set up between traces as the chunked trainer does
(a CUDA graph captured after ``chunk._keep_cupti``), then ``--traces``
times (6), each after ``--gap`` seconds idle (10), traces one
``ToyPDF().xfxQ2`` call on 2^20 floats, the six-kernel call of
chip_smoke.py phase 13: with a plain ``torch.profiler.profile``
(``plain``) or with ``profiling.device_profile``, which records after a
warm-up step and starts the call a lead after the recording (``warm``).
For each trace it prints the process's age and the positions of the
launches that have no device record; the last line is one JSON object
with the lost counts and the card's name and power limit from nvidia-smi.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def trace_once(call, mode):
    """Trace ``call()``; the positions, in launch order, of the launches
    without a device record, and the number of launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nf_tpu_torch.utils import profiling

    ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
           if mode == "plain" else profiling.device_profile())
    with ctx as prof:
        torch.cuda.synchronize()
        call()
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    launched = sorted(e.correlation_id() for e in events
                      if e.device_type() == DeviceType.CPU and e.name().startswith("cudaLaunch"))
    recorded = {e.correlation_id() for e in events if e.device_type() == DeviceType.CUDA}
    return [i for i, c in enumerate(launched) if c not in recorded], len(launched)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("plain", "warm"), default="plain")
    ap.add_argument("--traces", type=int, default=6)
    ap.add_argument("--gap", type=float, default=10.0, help="seconds idle before each trace")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("trace_loss: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from nf_tpu_torch.phasespace.pdf import ToyPDF
    from nf_tpu_torch.training import chunk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    x = torch.rand(1 << 20, device="cuda")

    def call():
        return ToyPDF().xfxQ2(2, x, 8315.0)

    chunk._keep_cupti()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        call()
    graph.replay()
    for _ in range(13):
        call()
    torch.cuda.synchronize()
    lost, ages = [], []
    for _ in range(args.traces):
        time.sleep(args.gap)
        positions, n = trace_once(call, args.mode)
        lost.append(len(positions))
        ages.append(round(time.perf_counter() - t0, 1))
        print(f"{args.mode} trace at {ages[-1]} s: {len(positions)} of {n} launches without a "
              f"device record {positions} [{smi}]", flush=True)
    print(json.dumps({"mode": args.mode, "gap_s": args.gap, "age_s": ages, "lost": lost,
                      "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
