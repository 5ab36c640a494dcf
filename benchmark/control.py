"""The control of a cell's check, and the planted faults.

    python3 benchmark/control.py --workload <cell> --seed <n> [--seed <n> ...]

For each seed, the reference is put in the program's place computed in the
precision just below the configuration's (float32 with TF32 products, for
float32 with TF32 off) and compared, number by number, with the float64
reference on the calls a run of that seed would check.  Faults are planted
in the reference put in the program's place: a training cell's "half of
each minibatch left out, the loss's mean taken over the rest";
integration's unweighted mean of the iterations; unweighting's second half
of each batch rejected, every second event dropped, and the integrand 2%
high.  It runs
no program; a cell's limits must lie between the program's readings and
these.  Prints one JSON line per seed and reading.
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
from benchmark.drivers.common import worst  # noqa: E402
from benchmark.reference import checks, flow  # noqa: E402
from benchmark.reference import integrands as plain  # noqa: E402
from benchmark.reference import train as rtrain  # noqa: E402
from benchmark.weights import derive  # noqa: E402


class HalfTrainer(rtrain.Trainer):
    @staticmethod
    def minibatch(w):
        return w[: w.shape[0] // 2]


def readings(driver, kind):
    """``{reading: {number: value}}`` of the control (and the fault)."""
    tf32 = (torch.float32, flow.tf32_matmul)
    wl, seed = driver.wl, driver.seed
    picks = [derive(seed, "call", i) for i in sorted(driver.picks())] if kind != "train" else []
    if kind == "integrate":
        ref = driver.reference(seeds=picks)
        ctrl = driver.reference(*tf32, seeds=picks)
        plain_mean = driver.reference(seeds=picks, combine="plain")
        return {"control": worst(checks.integrate_numbers(c, r) for c, r in zip(ctrl, ref)),
                "fault_plain_mean": worst(checks.integrate_numbers(c, r)
                                          for c, r in zip(plain_mean, ref))}
    if kind == "unweight":
        f = plain.INTEGRANDS[driver.cfg["integrand"]]
        dist = plain.CUT_DISTANCE.get(driver.cfg["integrand"])
        bn = driver.bn_latents()
        p64 = checks.eval_params(driver.p0, driver.plan, bn, torch.float64, flow.matmul)
        p32 = checks.eval_params(driver.p0, driver.plan, bn, *tf32)

        def both(call_seed, batches, w_max, pilot, p=p32, prec=tf32, fault=None):
            c = checks.unweight_outputs(p, driver.plan, f, call_seed, batches, wl["batch"],
                                        w_max, driver.device, *prec, pilot=pilot,
                                        quantile_q=wl["wmax_quantile"], fault=fault)
            r = checks.unweight_outputs(p64, driver.plan, f, call_seed, batches, wl["batch"],
                                        c["w_max_used"], driver.device, torch.float64,
                                        flow.matmul, pilot=pilot, quantile_q=wl["wmax_quantile"])
            return checks.unweight_numbers(c, r, f, dist), c["w_max_used"]

        warm, w_max = both(derive(seed, "call", -1), wl["warm_batches"], None, 100_000)
        out = {"control": worst([warm] + [both(s, wl["batches_per_call"], w_max, 0)[0]
                                          for s in picks])}
        # the faults, planted in the float64 reference put in the program's
        # place, on the first checked call at the control's w_max
        f64 = (torch.float64, flow.matmul)
        for fault in ("half_accept", "dropped_events", "integrand"):
            out[f"fault_{fault}"] = both(picks[0], wl["batches_per_call"], w_max, 0, p64, f64,
                                         fault)[0]
        return out
    ref = driver.reference()
    return {"control": checks.train_numbers(driver.reference(*tf32), ref, driver.p0),
            "fault_half_batch": checks.train_numbers(driver.reference(trainer=HalfTrainer), ref,
                                                     driver.p0)}


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = harness.Spec(ROOT, args.workload)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    for seed in args.seed:
        ctx = harness.Ctx(spec, seed, torch.device(args.device))
        driver = spec.load("drivers", spec.wl["driver"]).Driver(ctx)
        driver.p0 = driver.params()
        if spec.wl["driver"] == "train":
            driver.check_seeds = [derive(seed, "check", k) for k in range(2)]
        for name, nums in readings(driver, spec.wl["driver"]).items():
            print(json.dumps({"workload": args.workload, "seed": seed, "reading": name,
                              "numbers": nums}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
