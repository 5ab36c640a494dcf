#!/usr/bin/env python3
"""Smoke test of nf_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernel from ``nf_tpu_torch/ops/csrc``, holds it against its
plain PyTorch version on the card, runs the camel-2D main path (train, then
``sample`` and ``integrate``) through the manager, checks that ``sample`` and
``integrate`` went through the kernel and that the integral agrees with the
analytic value, holds the kernel against its plain version again on the
trained model at the main path's sizes and counter offsets, and times the
kernel against its plain version.  The last
line of standard output is ``{"ok": true, "device": {...}}``; any failed
check exits non-zero before it is printed.  Exits non-zero at once where
CUDA is not available.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def camel(x):
    import torch
    return (torch.exp(-((x[:, 0] - 0.75) ** 2 + (x[:, 1] - 0.75) ** 2) / 0.04)
            + torch.exp(-((x[:, 0] - 0.25) ** 2 + (x[:, 1] - 0.25) ** 2) / 0.04))


def camel_exact():
    g = 0.2 * (math.sqrt(math.pi) / 2) * (math.erf(0.25 / 0.2) + math.erf(0.75 / 0.2))
    return 2 * g * g


def time_ms(fn, reps=11, warmup=2):
    """Median milliseconds of ``fn()`` between CUDA events, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main():
    import torch

    # ---- phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from nf_tpu_torch import PWQuadManager
    from nf_tpu_torch.flows import factory
    from nf_tpu_torch.flows import sampling as fsampling
    from nf_tpu_torch.flows.fast_eval import make_folded_forward
    from nf_tpu_torch.ops import _build
    from nf_tpu_torch.ops import pwquad_sampler as ps
    from nf_tpu_torch.training import optimizers

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"device: {kind}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    # ---- phase 2: build
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s {card}")

    # ---- phase 3: kernel against plain, identical latents
    gen = torch.Generator(device=dev).manual_seed(1234)

    def perturb_bn(model):
        with torch.no_grad():
            for name, buf in model.named_buffers():
                if name.endswith("mean"):
                    buf.copy_(0.3 * torch.randn(buf.shape, generator=gen, device=dev))
                else:
                    buf.copy_(0.5 + 1.5 * torch.rand(buf.shape, generator=gen, device=dev))
            for name, p in model.named_parameters():
                if name.endswith("scale"):
                    p.copy_(1.0 + 0.3 * torch.randn(p.shape, generator=gen, device=dev))
        return model

    flows = {
        "camel2d_pwquad": factory.build_pwquad_flow(gen, 2, 2, 4, (3, 3, 3), device=dev),
        "flagship10d_rank4": factory.build_pwquad_flow(gen, 10, 8, 8, (16, 16), device=dev,
                                                       final_rank=4),
        "pwlin3d": factory.build_pwlin_flow(gen, 3, 1, 3, 8, (8, 8), 1, device=dev),
        "affine2d": factory.build_affine_flow(gen, 2, 1, 2, (6,), 1, device=dev),
    }
    max_abs_err = 0.0
    for name, model in flows.items():
        perturb_bn(model)
        flow = model.flow
        plain = make_folded_forward(flow, model)
        lat_kernel = ps.build_sampler(flow, model, take_latents=True)
        for n in (16384, 333):
            w = torch.rand((n, flow.n_flow), generator=gen, device=dev)
            x_k, jac_k = lat_kernel(w)
            x_p, jac_p = plain(w)
            torch.cuda.synchronize()
            err_x = float((x_k - x_p).abs().max())
            err_j = float(((jac_k - jac_p) / jac_p).abs().max())
            max_abs_err = max(max_abs_err, err_x)
            print(f"phase3 {name} n={n}: max|dx|={err_x:.3e} max|djac/jac|={err_j:.3e}")
            check(x_k.shape == (n, flow.n_flow) and jac_k.shape == (n,), f"{name} shapes")
            check(torch.allclose(x_k, x_p, rtol=1e-4, atol=2e-5), f"{name} x vs plain")
            check(torch.allclose(jac_k, jac_p, rtol=1e-3, atol=0.0), f"{name} jac vs plain")
        x_dm, jac_dm = ps.build_sampler(flow, model, take_latents=True, layout="dim_major")(w)
        check(torch.equal(x_dm.T, x_k) and torch.equal(jac_dm, jac_k), f"{name} dim_major")
        # the seeded variant against the plain version on its Philox stream
        x_s, jac_s = ps.build_sampler(flow, model)(99, 16384, offset=1 << 32)
        w_s = torch.from_numpy(ps.philox_uniform(99, 1 << 32, 16384, flow.n_flow)).to(dev)
        x_sp, jac_sp = plain(w_s)
        err_s = float((x_s - x_sp).abs().max())
        max_abs_err = max(max_abs_err, err_s)
        print(f"phase3 {name} seeded n=16384: max|dx|={err_s:.3e}")
        check(torch.allclose(x_s, x_sp, rtol=1e-4, atol=2e-5), f"{name} seeded x")
        check(torch.allclose(jac_s, jac_sp, rtol=1e-3, atol=0.0), f"{name} seeded jac")

    # ---- phase 4: seeded statistics
    camel_model = flows["camel2d_pwquad"]
    n = 1 << 20
    x, jac = ps.build_sampler(camel_model.flow, camel_model)(2024, n)
    w = torch.rand((n, 2), generator=gen, device=dev)
    x_ref, jac_ref = make_folded_forward(camel_model.flow, camel_model)(w)
    mean_jac = float(jac.mean())
    dmean = (x.mean(0) - x_ref.mean(0)).abs().max().item()
    print(f"phase4: n={n} x in [{float(x.min()):.3e}, {float(x.max()):.6f}] "
          f"mean(jac)={mean_jac:.5f} max|mean(x)-mean(x_plain)|={dmean:.2e}")
    check(bool(((x >= 0) & (x <= 1)).all()), "seeded x in [0, 1]")
    check(bool(torch.isfinite(jac).all() and (jac > 0).all()), "seeded jac finite, positive")
    check(abs(mean_jac - 1.0) < 0.02, "|mean(jac) - 1| < 0.02")
    check(dmean < 0.02, "mean(x) vs plain within 0.02")

    # ---- phase 5: the main path
    exact = camel_exact()
    NF = PWQuadManager(n_flow=2, seed=0, device="cuda")
    NF.create_model(2, 4, [3] * 3)
    ps.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    NF._train_variance_forward_seq(
        camel, optimizers.adamax(2e-3, 1e-4), log=False, batch_size=10000, epochs=150,
        mini_batch_size=10000, preburn_time=20, integrate=False, pretty_progressbar=False)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    n_epochs = NF._last_epoch + 1
    x, jac = NF.sample(1 << 24)
    check(x.shape == (1 << 24, 2) and bool(torch.isfinite(jac).all()), "sample() output")
    check(bool(((x >= 0) & (x <= 1)).all()), "sample() x in [0, 1]")
    mean_jac = float(jac.mean())
    check(abs(mean_jac - 1.0) < 0.02, "sample() |mean(jac) - 1| < 0.02")
    results = [NF.integrate(camel, 10, 100_000), NF.integrate(camel, 8, 1 << 21)]
    torch.cuda.synchronize()
    launches = ps.LAUNCHES
    print(f"phase5: trained {n_epochs} epochs in {train_s:.2f} s (best epoch "
          f"{NF.best_epoch}, loss {NF.best_loss:.4e}); sample mean(jac)={mean_jac:.5f}; "
          f"kernel launches {launches}")
    for (nitn, neval), (sig, err) in zip([(10, 100_000), (8, 1 << 21)], results):
        print(f"phase5: integrate({nitn}, {neval}) = {sig:.6f} +- {err:.2e} "
              f"(exact {exact:.6f}, rel err {abs(sig - exact) / exact:.2e})")
        check(math.isfinite(sig) and err > 0, "integrate finite")
        check(abs(sig - exact) <= 5 * err + 0.01 * exact, "|sig - exact| <= 5 err + 1%")
    check(launches >= 1 + 10 + 8, f"main path launched the kernel {launches} < 19 times")

    # ---- phase 5b: the kernel against its plain version at the main path's
    # sizes, on the trained model.  The grid holds at most 2^20 threads, so
    # here each thread takes several passes of its loop (2 at 2^21, 16 at
    # 2^24), and integrate's later iterations start at a counter offset.
    best = NF.best_model
    plain = make_folded_forward(NF._flow, best)

    def hold(what, x_k, jac_k, w):
        x_p, jac_p = plain(w)
        torch.cuda.synchronize()
        err_x = float((x_k - x_p).abs().max())
        err_j = float(((jac_k - jac_p) / jac_p).abs().max())
        print(f"phase5b {what}: max|dx|={err_x:.3e} max|djac/jac|={err_j:.3e}")
        check(x_k.shape == x_p.shape and jac_k.shape == jac_p.shape, f"{what} shapes")
        check(torch.allclose(x_k, x_p, rtol=1e-4, atol=2e-5), f"{what} x vs plain")
        check(torch.allclose(jac_k, jac_p, rtol=1e-3, atol=0.0), f"{what} jac vs plain")
        return err_x

    def philox_latents(seed, offset, n):
        return torch.from_numpy(ps.philox_uniform(seed, offset, n, 2)).to(dev)

    # sample(): the entry point itself, its seed drawn as the manager draws it
    x_k, jac_k = NF.sample(1 << 24, seed=5)
    seed = fsampling.seed_from(torch.Generator(device=dev).manual_seed(5))
    max_abs_err = max(max_abs_err, hold("sample(2^24, seed=5) batch-major", x_k, jac_k,
                                        philox_latents(seed, 0, 1 << 24)))
    # integrate(): its dim-major sampler, called as integrate(f, 8, 2^21) calls it
    seed0 = fsampling.seed_from(torch.Generator(device=dev).manual_seed(6))
    dm = ps.build_sampler(NF._flow, best, layout="dim_major")
    for i in (0, 7):
        x_k, jac_k = dm(seed0, 1 << 21, offset=i << 21)
        max_abs_err = max(max_abs_err, hold(
            f"integrate draw {i} (2^21, offset {i}*2^21) dim-major", x_k.T, jac_k,
            philox_latents(seed0, i << 21, 1 << 21)))
    # the latents operand through the same multi-pass loop
    w = torch.rand((1 << 24, 2), generator=gen, device=dev)
    x_k, jac_k = ps.build_sampler(NF._flow, best, take_latents=True)(w)
    max_abs_err = max(max_abs_err, hold("latents 2^24 batch-major", x_k, jac_k, w))
    del x_k, jac_k, w

    # ---- phase 6: timings (CUDA events, median of 11 after warm-up)
    timings = {}
    for name, model in (("camel2d_trained", NF.best_model),
                        ("flagship10d_rank4", flows["flagship10d_rank4"])):
        flow, n = model.flow, 1 << 21
        seeded = ps.build_sampler(flow, model, layout="dim_major")
        lat_kernel = ps.build_sampler(flow, model, take_latents=True)
        plain = make_folded_forward(flow, model)
        w = torch.rand((n, flow.n_flow), generator=gen, device=dev)
        timings[name] = {
            "kernel_seeded_ms": time_ms(lambda: seeded(7, n)),
            "kernel_latents_ms": time_ms(lambda: lat_kernel(w)),
            "plain_folded_ms": time_ms(lambda: plain(w)),
            "plain_rand_plus_folded_ms": time_ms(
                lambda: plain(torch.rand((n, flow.n_flow), generator=gen, device=dev))),
        }
        for key, ms in timings[name].items():
            print(f"phase6 {name} n=2^21 {key}: {ms:.4f} ms "
                  f"({n / ms * 1e3:.4e} samples/s) {card}")
    sample_ms = time_ms(lambda: NF.sample(1 << 24))
    print(f"phase6 sample(2^24): {sample_ms:.3f} ms = {(1 << 24) / sample_ms * 1e3:.4e} "
          f"samples/s {card}")
    for nitn, neval in ((10, 100_000), (8, 1 << 21)):
        ms = time_ms(lambda: NF.integrate(camel, nitn, neval))
        print(f"phase6 integrate({nitn}, {neval}): {ms:.3f} ms = "
              f"{nitn * neval / ms * 1e3:.4e} samples/s {card}")
    print(f"phase6 train: {train_s / n_epochs * 1e3:.3f} ms/epoch at batch 10000 "
          f"({n_epochs} epochs, host clock) {card}")

    camel_t = timings["camel2d_trained"]
    print(json.dumps({"kernels": [{
        "name": "pwquad_sampler",
        "route": "cuda",
        "source": "nf_tpu_torch/ops/csrc/pwquad_sampler.cu",
        "replaces": "nf_tpu/ops/pwquad_sampler.py:286",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": camel_t["kernel_seeded_ms"],
        "plain_ms": camel_t["plain_rand_plus_folded_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
