"""The readings that place zzmc.train's limits: the program's, the control's
and the planted faults'.

    python3 benchmark/mixture_control.py --seed <n> [--seed <n> ...] [--program-only]

For each seed it runs the cell's set-up (the program's two check calls, as
a run of that seed makes them) and computes the float64 reference once;
then it compares with the reference, number by number: the program; the
control, the reference put in the program's place in the precision just
below the configuration's (float32 with TF32-rounded products, for float32
with TF32 off: ``benchmark/control.py``'s rule); and each fault planted in
the float64 reference put in the program's place
(:data:`benchmark.reference.mixture.FAULTS`).  The limits must lie between
the program's readings and these.  Prints one JSON line per seed and
reading.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.drivers import mixture  # noqa: E402
from benchmark.reference import flow  # noqa: E402
from benchmark.reference import mixture as ref  # noqa: E402


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="zzmc.train")
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--program-only", action="store_true")
    args = ap.parse_args(argv)
    spec = harness.Spec(ROOT, args.workload)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    for seed in args.seed:
        driver = mixture.Driver(harness.Ctx(spec, seed, torch.device(args.device)))
        driver.setup()
        driver.free()
        reference, p0 = driver.reference(), driver.flat_p0()
        readings = {"program": driver.program}
        if not args.program_only:
            readings["control"] = driver.reference(torch.float32, flow.tf32_matmul)
            for fault in ref.FAULTS:
                readings[f"fault_{fault}"] = driver.reference(fault=fault)
        for name, out in readings.items():
            print(json.dumps({"workload": args.workload, "seed": seed, "reading": name,
                              "numbers": mixture.numbers(out, reference, p0)}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
