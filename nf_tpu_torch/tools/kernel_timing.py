#!/usr/bin/env python3
"""Compile reports, checks and paired timings of the port's CUDA kernels.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 nf_tpu_torch/tools/kernel_timing.py ptxas [--tree DIR]
        nvcc -Xptxas -v on every csrc/*.cu of the tree: registers, stack, spills per kernel
    python3 nf_tpu_torch/tools/kernel_timing.py time [--tree DIR]
        kernel and trainer timings of the nf_tpu_torch found in DIR (default:
        this checkout) on camel-2D, the 10-D flagship and create_model(2, 4,
        [128, 128]) (the workspace backward), the training wrappers' host
        time per call, and a digest of the training kernels' outputs (equal
        digests: the same bits), one JSON line
    python3 nf_tpu_torch/tools/kernel_timing.py pair DIR_A DIR_B DIR_B DIR_A
        ``time`` for each tree in turn, each in its own process (each builds
        its own kernel library), on the same card; one JSON line per tree
    python3 nf_tpu_torch/tools/kernel_timing.py sweep [--tree DIR]
        the training backward, the forward with and without stats, and the
        sampler, at each of the tree's launch configurations for that kernel
        (block size, weights in shared memory or through L1; its default
        only, for a tree without them), one JSON line

Every timing is the median of CUDA-event times after warm-up, printed beside
the card's name and power limit from nvidia-smi.  Inputs are made from fixed
seeds, so two trees time the same work.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps=11, warmup=2, per=1):
    """Median milliseconds of ``fn()`` between CUDA events, after warm-up.
    With ``per`` > 1, ``per`` calls run back to back between the events and
    the time is divided by ``per``: the card then runs one launch while the
    host prepares the next, so the wrapper's host-side work is hidden
    wherever it is shorter than the kernel."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    return statistics.median(times)


def device_ms(fn, launches=20):
    """Mean device time per launch of the hand-written kernel that ``fn``
    launches (the ``DeviceType.CUDA`` rows of ``torch.profiler`` whose name
    holds ``_kernel``), over ``launches`` calls after a warm-up."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "_kernel" in e.key
            and not e.key.startswith("void at::")]
    return sum(e.self_device_time_total for e in rows) / 1e3 / launches


def host_us(fn, calls=200):
    """Median microseconds of host time per call of ``fn`` over five runs
    of ``calls`` calls each, the card synchronised before and after every
    run, not inside it."""
    import time

    import torch
    fn()
    runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(runs)


def digest(*tensors):
    """The first 16 hex digits of the SHA-256 of the tensors' bytes."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def ptxas(tree):
    sys.path.insert(0, tree)
    from nf_tpu_torch.ops import _build

    out = os.path.join(tree, "nf_tpu_torch", "ops", "build", "ptxas")
    os.makedirs(out, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    for src in sorted(_build.CSRC.glob("*.cu")):
        proc = subprocess.run([_build.nvcc_path(), *flags, "-Xptxas", "-v", "-c", str(src),
                               "-o", os.path.join(out, src.stem + ".o")],
                              capture_output=True, text=True)
        print(f"== {src.name} (nvcc rc {proc.returncode})")
        for line in (proc.stdout + proc.stderr).splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill", "stack", "error")):
                print(line.strip())
        if proc.returncode:
            return 1
    return 0


def _perturb(torch, model, gen, dev):
    """Move ``model``'s BatchNorm statistics and scales off their init
    values, so the fold is not trivial."""
    with torch.no_grad():
        for key, t in list(model.named_buffers()) + list(model.named_parameters()):
            if key.endswith("mean"):
                t.copy_(0.3 * torch.randn(t.shape, generator=gen, device=dev))
            elif key.endswith("var"):
                t.copy_(0.5 + 1.5 * torch.rand(t.shape, generator=gen, device=dev))
            elif key.endswith("scale"):
                t.copy_(1.0 + 0.3 * torch.randn(t.shape, generator=gen, device=dev))
    return model


def _models(torch, dev):
    """The camel-2D model and the 10-D rank-4 flagship, random, with their
    BatchNorm statistics and scales moved off their init values."""
    from nf_tpu_torch.flows import factory

    gen = torch.Generator(device=dev).manual_seed(1234)
    models = {"camel2d": factory.build_pwquad_flow(gen, 2, 2, 4, (3, 3, 3), device=dev),
              "flagship10d_rank4": factory.build_pwquad_flow(gen, 10, 8, 8, (16, 16), device=dev,
                                                             final_rank=4)}
    for model in models.values():
        _perturb(torch, model, gen, dev)
    return models, gen


def time_tree(tree):
    """Kernel and trainer timings of the nf_tpu_torch in ``tree``."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import nf_tpu_torch
    from nf_tpu_torch import PWQuadManager
    from nf_tpu_torch.ops import pwquad_sampler as ps
    from nf_tpu_torch.ops import pwquad_train as pt
    from nf_tpu_torch.training import optimizers

    from nf_tpu_torch.flows import factory

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    models, gen = _models(torch, dev)
    # the workspace backward's plan, create_model(2, 4, [128, 128]), from a
    # generator of its own: the other models' inputs stay as they were
    wide_gen = torch.Generator(device=dev).manual_seed(4321)
    models["wide128"] = _perturb(torch, factory.build_pwquad_flow(
        wide_gen, 2, 2, 4, (128, 128), device=dev), wide_gen, dev)
    out = {"tree": tree, "package": os.path.dirname(nf_tpu_torch.__file__), "card": card()}
    for name, n_train in (("camel2d", 1 << 20), ("flagship10d_rank4", 1 << 18),
                          ("wide128", 1 << 18)):
        model = models[name]
        flow = model.flow
        plan = pt.TrainPlan(flow)
        flat = pt.fold_flow(model).detach()
        w = torch.rand((n_train, flow.n_flow), generator=gen, device=dev)
        xbar = 0.3 * torch.randn((n_train, flow.n_flow), generator=gen, device=dev)
        jbar = torch.randn(n_train, generator=gen, device=dev)
        x, jac, stage = pt.train_forward(plan, flat, w)
        seeded = ps.build_sampler(flow, model, layout="dim_major")
        latents = ps.build_sampler(flow, model, take_latents=True)
        w_s = torch.rand((1 << 21, flow.n_flow), generator=gen, device=dev)
        # the kernels the trees share first, each tree from the same state
        calls = {
            "fwd": lambda: pt.train_forward(plan, flat, w),
            "fwd_stats": lambda: pt.train_forward(plan, flat, w, with_stats=True),
            "sampler_2e21": lambda: seeded(7, 1 << 21),
            "bwd": lambda: pt.train_backward(plan, flat, stage, jac, jbar, xbar),
        }
        # one launch between the events (as chip_smoke.py times), then 20;
        # then each kernel's own device time, from the profiler
        out[name] = {"n_train": n_train, "fwd_digest": digest(x, jac, stage),
                     "bwd_digest": digest(*calls["bwd"]()),
                     "sampler_digest": digest(*seeded(7, (1 << 21) + 333, offset=1 << 33),
                                              *latents(w_s))}
        for key, fn in calls.items():
            out[name][key + "_ms"] = time_ms(fn)
        for key, fn in calls.items():
            out[name][key + "_x20_ms"] = time_ms(fn, per=20)
        for key, fn in calls.items():
            out[name][key + "_device_ms"] = device_ms(fn)
        # the training wrappers' host time per call, at a size whose kernels
        # finish before the host issues the next (the host-bound trainers
        # pay it on every minibatch)
        w_small = w[:1024].contiguous()
        small = (lambda: pt.train_forward(plan, flat, w_small),
                 lambda: pt.train_backward(plan, flat, stage[:, :, :1024].contiguous(),
                                           jac[:1024], jbar[:1024], xbar[:1024]))
        for key, fn in zip(("fwd", "bwd"), small):
            out[name][key + "_host_us"] = host_us(fn)
    # bench.py's flagship stale stage (bench.py:371-379): batch 2^20 in four
    # minibatches of 2^18 on a flat integrand, one epoch, then timed
    NF = PWQuadManager(n_flow=10, seed=0, device="cuda")
    NF.create_model(8, 8, [16, 16], final_rank=4)
    NF._train_variance_forward_seq(
        lambda x: torch.ones(x.shape[0], dtype=x.dtype, device=x.device),
        optimizers.adamax(2e-3, 1e-4), log=False, batch_size=1 << 20, epochs=1,
        pretty_progressbar=False, mini_batch_size=1 << 18, integrate=False, preburn_time=0,
        bn_stats="stale")
    sec, sps = NF.benchmark_train_step(reps=5)
    out["flagship_stale_epoch_ms"] = sec * 1e3
    out["flagship_stale_samples_per_s"] = sps
    print(json.dumps(out), flush=True)
    return 0


def sweep(tree):
    """The backward and both forward variants per launch configuration,
    camel-2D at 2^20 and the flagship at 2^18, on the inputs ``time``
    uses; the seeded dim-major sampler per launch configuration at 2^21
    (one launch between the events, and its device time)."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from nf_tpu_torch.ops import pwquad_sampler as ps
    from nf_tpu_torch.ops import pwquad_train as pt

    dev = torch.device("cuda")
    models, gen = _models(torch, dev)
    out = {"tree": tree, "card": card()}
    for name, n in (("camel2d", 1 << 20), ("flagship10d_rank4", 1 << 18)):
        model = models[name]
        flow = model.flow
        plan = pt.TrainPlan(flow)
        flat = pt.fold_flow(model).detach()
        w = torch.rand((n, flow.n_flow), generator=gen, device=dev)
        xbar = 0.3 * torch.randn((n, flow.n_flow), generator=gen, device=dev)
        jbar = torch.randn(n, generator=gen, device=dev)
        _, jac, stage = pt.train_forward(plan, flat, w)
        row = {"default_ms": time_ms(lambda: pt.train_backward(plan, flat, stage, jac, jbar,
                                                               xbar))}
        if hasattr(pt, "train_bwd_config"):
            row["default_config"] = pt.train_bwd_config(plan)
            for block in pt.BWD_BLOCKS:
                for w_smem in (True, False):
                    smem = pt.train_bwd_smem_bytes(plan, block, w_smem)
                    if smem > pt.SMEM_LIMIT:
                        continue
                    key = f"block{block}_{'wsmem' if w_smem else 'wl1'}"
                    row[key + "_ms"] = time_ms(lambda: pt.train_backward(
                        plan, flat, stage, jac, jbar, xbar, config=(block, w_smem)))
                    row[key + "_per_sm"] = pt.blocks_per_sm(smem, block)
        for stats in (False, True):
            fwd = "fwd_stats" if stats else "fwd"
            row[fwd + "_default_ms"] = time_ms(lambda: pt.train_forward(plan, flat, w, stats))
            if not hasattr(pt, "train_fwd_config"):
                continue
            row[fwd + "_default_config"] = pt.train_fwd_config(plan, stats)
            for block in pt.FWD_BLOCKS:
                for w_smem in (True, False):
                    smem = pt.train_fwd_smem_bytes(plan, block, w_smem, stats)
                    if smem > pt.SMEM_LIMIT:
                        continue
                    key = f"{fwd}_block{block}_{'wsmem' if w_smem else 'wl1'}"
                    row[key + "_ms"] = time_ms(lambda: pt.train_forward(
                        plan, flat, w, stats, config=(block, w_smem)))
                    row[key + "_per_sm"] = pt.blocks_per_sm(smem, block)
        seeded = ps.build_sampler(flow, model, layout="dim_major")
        row["sampler_default_ms"] = time_ms(lambda: seeded(7, 1 << 21))
        row["sampler_default_device_ms"] = device_ms(lambda: seeded(7, 1 << 21))
        if hasattr(ps, "sampler_config"):
            splan = ps.SamplerPlan(flow)
            row["sampler_default_config"] = splan.config
            for block in ps.SAMPLER_BLOCKS + ps.SMALL_BLOCKS:
                for w_smem in (True, False):
                    smem = ps.sampler_smem_bytes(splan, block, w_smem)
                    if smem > ps.SMEM_LIMIT:
                        continue
                    run = ps.build_sampler(flow, model, layout="dim_major",
                                           config=(block, w_smem))
                    key = f"sampler_block{block}_{'wsmem' if w_smem else 'wl1'}"
                    row[key + "_ms"] = time_ms(lambda: run(7, 1 << 21))
                    row[key + "_device_ms"] = device_ms(lambda: run(7, 1 << 21))
                    row[key + "_per_sm"] = ps.blocks_per_sm(smem, block)
        out[name] = row
    print(json.dumps(out), flush=True)
    return 0


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("mode", choices=("ptxas", "time", "pair", "sweep"))
    parser.add_argument("trees", nargs="*")
    parser.add_argument("--tree", default=ROOT)
    args = parser.parse_args()
    if args.mode == "ptxas":
        return ptxas(args.tree)
    import torch

    if not torch.cuda.is_available():
        print("kernel_timing: no CUDA device", file=sys.stderr)
        return 1
    if args.mode == "time":
        return time_tree(args.tree)
    if args.mode == "sweep":
        return sweep(args.tree)
    rc = 0
    for tree in args.trees:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "time",
                              "--tree", tree]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
