#!/usr/bin/env python3
"""Smoke test of nf_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``nf_tpu_torch/ops/csrc``.  Phases 3-6: holds
the fused sampler against its plain PyTorch version on the card, runs the
camel-2D main path (train, then ``sample`` and ``integrate``) through the
manager, checks that ``sample`` and ``integrate`` went through the kernel and
that the integral agrees with the analytic value, holds the kernel against
its plain version again on the trained model at the main path's sizes and
counter offsets, and times the kernel against its plain version.  Phases
7-10 do the same for the training kernels and the stale-statistics trainer
(``bn_stats="stale"``): forward, stats and backward against their plain
versions, whole batches up to the sizes the trainers launch at, the stale
camel-2D path with its launch counts, bench.py's stale stages (with theirs)
beside the batch-statistics trainer, a device profile, and kernel timings.  Prints one ``{"kernels": [...]}`` line; the last line of standard
output is ``{"ok": true, "device": {...}}``; any failed check exits non-zero
before it is printed.  Exits non-zero at once where CUDA is not available.
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
    from nf_tpu_torch.bijectors.permutations import mask_partition
    from nf_tpu_torch.flows import factory
    from nf_tpu_torch.flows.model import Flow, FlowModel, make_cell_cfg
    from nf_tpu_torch.flows import sampling as fsampling
    from nf_tpu_torch.flows.fast_eval import make_folded_forward
    from nf_tpu_torch.ops import _build
    from nf_tpu_torch.ops import pwquad_sampler as ps
    from nf_tpu_torch.ops import pwquad_train as pt
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

    # ---- phase 7: the training kernels against their plain versions, on
    # nf_tpu's five training-kernel configurations and the 10-D flagship
    def masked_mini():
        cells, ops = [], []
        for i in range(2):
            feeder, trafoer = mask_partition(4, i)
            perm = tuple(feeder.tolist() + trafoer.tolist())
            cells.append(make_cell_cfg("pwquad", 4, len(feeder), 3, (4,)))
            ops += [("gather", perm), ("cell", i), ("scatter", perm)]
        return FlowModel(Flow(4, tuple(cells), tuple(ops)), gen, torch.float32, dev)

    train_flows = {
        "camel": factory.build_pwquad_flow(gen, 2, 2, 4, (3, 3, 3), device=dev),
        "masked_mini": masked_mini(),
        "rank_sp": factory.build_pwquad_flow(gen, 3, 2, 3, (4,), device=dev, final_rank=2,
                                             activation="squareplus"),
        "pwlin": factory.build_pwlin_flow(gen, 3, 1, 2, 4, (5,), 1, device=dev),
        "affine": factory.build_affine_flow(gen, 3, 2, 2, (5,), 1, device=dev),
        "flagship10d_rank4": flows["flagship10d_rank4"],
    }

    # ~7x the forward's worst |dx| against its plain version on the flagship
    KINK = 1e-5

    def cotangents(n, n_flow):
        return (0.3 * torch.randn((n, n_flow), generator=gen, device=dev),
                torch.randn(n, generator=gen, device=dev))

    def backward_ref(flow, flat, w, xbar, jbar, dtype, chunk=1 << 17):
        """folded_backward_ref in ``dtype``, in chunks of samples (its graph
        at 2^18 flagship samples in float64 would take ~17 GB)."""
        dflat, wbar = 0.0, []
        for s in range(0, w.shape[0], chunk):
            d, wb = pt.folded_backward_ref(flow, flat.to(dtype), w[s:s + chunk].to(dtype),
                                           xbar[s:s + chunk].to(dtype),
                                           jbar[s:s + chunk].to(dtype))
            dflat = dflat + d.double()
            wbar.append(wb.double())
        return dflat, torch.cat(wbar)

    def backward_gate(plan, flat, w, stage_k, jac_k, xbar, jbar):
        """The backward kernel against the autograd plain version in float64,
        at nf_tpu's hand-VJP-vs-autodiff gate (tests/test_train_kernel.py:
        137-143): worst |d|/bound of the kernel and of the plain version in
        float32, max |d| of the kernel, and the kernel's outputs."""
        flow = plan.flow
        dflat_k, wbar_k = pt.train_backward(plan, flat, stage_k, jac_k, jbar, xbar)
        dflat_r, wbar_r = backward_ref(flow, flat, w, xbar, jbar, torch.float64)
        dflat_p, wbar_p = backward_ref(flow, flat, w, xbar, jbar, torch.float32)
        worst, worst32, err_b = 0.0, 0.0, 0.0
        pairs = list(zip(pt.unpack_flat(flow, dflat_k), pt.unpack_flat(flow, dflat_p),
                         pt.unpack_flat(flow, dflat_r))) + [(wbar_k, wbar_p, wbar_r)]
        for a, a32, b in pairs:
            bound = 2e-4 * max(float(b.abs().max()), 1e-3) + 2e-3 * b.abs()
            worst = max(worst, float(((a.double() - b).abs() / bound).max()))
            worst32 = max(worst32, float(((a32.double() - b).abs() / bound).max()))
            err_b = max(err_b, float((a.double() - b).abs().max()))
        return worst, worst32, err_b, dflat_k, wbar_k

    def hold_train(what, plan, flat, w):
        """Forward (with stats) and backward kernels against their plain
        versions on the same inputs, the whole batch in one launch; two more
        launches must repeat them bit for bit.  The backward's reference is
        the autograd plain version in float64.  A sample within KINK of a
        point where the map's gradient jumps (a bin edge, pwquad's clamp, a
        ReLU at 0) may sit on its other side in float32, the kernel's and the
        plain version's alike, and then takes another per-sample gradient:
        the gate zeroes those samples' cotangents, and the unmasked reading
        is printed beside it.  Returns the max abs errors (fwd, bwd)."""
        flow = plan.flow
        xbar, jbar = cotangents(*w.shape)
        x_k, jac_k, stage_k, stats_k = pt.train_forward(plan, flat, w, with_stats=True)
        x_p, jac_p, stage_p, stats_p = pt.forward_stats_ref(flow, flat, w)
        torch.cuda.synchronize()
        n = w.shape[0]
        err_x = max(float((x_k - x_p).abs().max()), float((stage_k - stage_p).abs().max()))
        err_j = float(((jac_k - jac_p) / jac_p).abs().max())
        # float64 sums of float32 values that differ by the forward's rounding
        err_s = float(((stats_k - stats_p).abs() / (n + stats_p.abs())).max())
        check(x_k.shape == x_p.shape and stage_k.shape == stage_p.shape
              and stats_k.shape == (plan.n_stat_rows,), f"{what} forward shapes")
        check(torch.allclose(x_k, x_p, rtol=1e-4, atol=2e-5), f"{what} x vs plain")
        check(torch.allclose(stage_k, stage_p, rtol=1e-4, atol=2e-5), f"{what} stage vs plain")
        check(torch.allclose(jac_k, jac_p, rtol=1e-3, atol=0.0), f"{what} jac vs plain")
        check(err_s <= 1e-5, f"{what} stats within 1e-5 of (n + |sum|)")
        raw, raw32 = backward_gate(plan, flat, w, stage_k, jac_k, xbar, jbar)[:2]
        keep = (pt.kink_distance(flow, flat.double(), w.double()) > KINK).to(torch.float32)
        xbar, jbar = xbar * keep[:, None], jbar * keep
        worst, worst32, err_b, dflat_k, wbar_k = backward_gate(plan, flat, w, stage_k, jac_k,
                                                               xbar, jbar)
        print(f"phase7 {what}: max|dx|={err_x:.3e} max|djac/jac|={err_j:.3e} "
              f"stats {err_s:.3e}; backward max|d|={err_b:.3e}, "
              f"worst |d|/bound {worst:.3e} (plain32 {worst32:.3e}) with the "
              f"{n - int(keep.sum())} samples within {KINK:g} of a kink masked; "
              f"unmasked {raw:.3e} (plain32 {raw32:.3e})")
        check(worst <= 1.0, f"{what} backward vs plain")
        again = pt.train_backward(plan, flat, stage_k, jac_k, jbar, xbar)
        check(torch.equal(again[0], dflat_k) and torch.equal(again[1], wbar_k),
              f"{what} two backward launches bit-identical")
        check(torch.equal(pt.train_forward(plan, flat, w, with_stats=True)[3], stats_k),
              f"{what} two stats launches bit-identical")
        return err_x, err_b

    # the sizes the main paths launch at: camel's 1M batch in one grid-stride
    # launch (2^21 + 333: several passes, a ragged tail), the flagship's
    # minibatch of 2^18
    real_n = {"camel": (1 << 21) + 333, "flagship10d_rank4": 1 << 18}
    for name, model in train_flows.items():
        perturb_bn(model)
        plan = pt.TrainPlan(model.flow)
        flat = pt.fold_flow(model).detach()
        for n in (16384, 333) + ((real_n[name],) if name in real_n else ()):
            hold_train(f"{name} n={n}", plan, flat,
                       torch.rand((n, model.flow.n_flow), generator=gen, device=dev))

    # ---- phase 8: the stale-statistics main path: train, then integrate
    NF_s = PWQuadManager(n_flow=2, seed=0, device="cuda")
    NF_s.create_model(2, 4, [3] * 3)
    bn_before = {k: v.clone() for k, v in NF_s._model.named_buffers()}
    pt.FWD_LAUNCHES = pt.BWD_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    NF_s._train_variance_forward_seq(
        camel, optimizers.adamax(2e-3, 1e-4), log=False, batch_size=10000, epochs=150,
        mini_batch_size=10000, preburn_time=20, integrate=False, pretty_progressbar=False,
        bn_stats="stale", stats_every=4)
    torch.cuda.synchronize()
    stale_s = time.perf_counter() - t0
    train_launches = (pt.FWD_LAUNCHES, pt.BWD_LAUNCHES)
    stale_epochs = NF_s._last_epoch + 1
    refreshes = (stale_epochs - 1) // 4 + 1
    sig, err = NF_s.integrate(camel, 8, 1 << 21)
    print(f"phase8: stale trainer {stale_epochs} epochs in {stale_s:.2f} s (best epoch "
          f"{NF_s.best_epoch}, loss {NF_s.best_loss:.4e}); training-kernel launches "
          f"fwd {train_launches[0]} bwd {train_launches[1]} ({refreshes} refreshes)")
    print(f"phase8: integrate(8, {1 << 21}) = {sig:.6f} +- {err:.2e} (exact {exact:.6f}, "
          f"rel err {abs(sig - exact) / exact:.2e})")
    check(math.isfinite(sig) and err > 0, "stale integrate finite")
    check(abs(sig - exact) <= 5 * err + 0.01 * exact, "stale |sig - exact| <= 5 err + 1%")
    # one forward and one backward per minibatch (one per epoch here), one
    # forward per refresh
    check(train_launches == (stale_epochs + refreshes, stale_epochs),
          f"stale path launched fwd/bwd {train_launches}")
    check(all(not torch.equal(bn_before[k], v) for k, v in NF_s._model.named_buffers()),
          "stale path moved every BatchNorm buffer")

    # ---- phase 8b: the training kernels against their plain versions on the
    # trained model at the main path's shape (minibatch and refresh: 10000)
    stale_plan = pt.TrainPlan(NF_s._flow)
    stale_flat = pt.fold_flow(NF_s._model).detach()
    train_err = hold_train("stale camel trained n=10000", stale_plan, stale_flat,
                           torch.rand((10000, 2), generator=gen, device=dev))

    # ---- phase 9: bench.py's stale-trainer stages (bench.py:327-379) beside
    # the batch-statistics trainer at the same configuration
    def flat_f(x):
        return torch.ones(x.shape[0], dtype=x.dtype, device=x.device)

    def bench_trainer(n_flow, args, kwargs, batch, mini, f, seed, bn_stats, epochs):
        """Train, check the training-kernel launches of that run (one
        forward and one backward per minibatch and one forward per refresh
        for the stale trainer, none for the batch one), then time it."""
        NF_b = PWQuadManager(n_flow=n_flow, seed=seed, device="cuda")
        NF_b.create_model(*args, **kwargs)
        pt.FWD_LAUNCHES = pt.BWD_LAUNCHES = 0
        NF_b._train_variance_forward_seq(
            f, optimizers.adamax(2e-3, 1e-4), log=False, batch_size=batch, epochs=epochs,
            pretty_progressbar=False, mini_batch_size=mini, integrate=False, preburn_time=0,
            bn_stats=bn_stats)
        torch.cuda.synchronize()
        launches = (pt.FWD_LAUNCHES, pt.BWD_LAUNCHES)
        check(math.isfinite(NF_b.best_loss), f"{bn_stats} trainer loss finite")
        ran = NF_b._last_epoch + 1
        minibatches = ran * (batch // mini)
        expected = (minibatches + (ran - 1) // 4 + 1, minibatches) if bn_stats == "stale" \
            else (0, 0)
        check(launches == expected,
              f"{bn_stats} trainer launched fwd/bwd {launches}, expected {expected}")
        return NF_b.benchmark_train_step(reps=3), launches

    for bn_stats, mgr in (("stale", NF_s), ("batch", NF)):
        sec, sps = mgr.benchmark_train_step(reps=11)
        print(f"phase9 camel2d batch 10000 bn_stats={bn_stats}: benchmark_train_step "
              f"{sec * 1e3:.3f} ms/epoch = {sps:.4e} samples/s {card}")
    for cfg, bench_args in (
            ("camel2d batch 1M", (2, (2, 4, [3] * 3), {}, 1_000_000, 1_000_000, camel, 3)),
            ("flagship10d_rank4 batch 2^20 / 2^18",
             (10, (8, 8, [16, 16]), {"final_rank": 4}, 1 << 20, 1 << 18, flat_f, 4))):
        for bn_stats, epochs in (("stale", 6 if cfg.startswith("camel") else 3),
                                 ("batch", 6 if cfg.startswith("camel") else 2)):
            (sec, sps), launches_b = bench_trainer(*bench_args, bn_stats, epochs)
            print(f"phase9 {cfg} bn_stats={bn_stats}: training-kernel launches fwd "
                  f"{launches_b[0]} bwd {launches_b[1]}; benchmark_train_step "
                  f"{sec * 1e3:.3f} ms/epoch = {sps:.4e} samples/s {card}")

    # ---- phase 9b: device profile of the trainers at batch 10000
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for bn_stats, mgr in (("stale", NF_s), ("batch", NF)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.benchmark_train_step(reps=1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # the device's own records (kernels, copies): an operator's device
        # time, and an annotated range's span on the device (the optimizer
        # step's), repeat those of the kernels inside them
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        dev_us = [e.self_device_time_total for e in events]
        total = sum(dev_us)
        check(total > 0, f"{bn_stats} trainer profile shows device time")
        epochs_run = 2 * (4 if bn_stats == "stale" else 1)
        print(f"phase9b {bn_stats} trainer, batch 10000, {epochs_run} epochs under the "
              f"profiler: device {total / 1e3:.3f} ms of {wall * 1e3:.3f} ms wall "
              f"(busy {total / 1e6 / wall:.1%}) {card}")
        for us, e in sorted(zip(dev_us, events), key=lambda t: -t[0])[:6]:
            print(f"phase9b   {us / 1e3:.3f} ms ({us / total:.1%}) x{e.count} {e.key[:90]}")

    # ---- phase 10: training-kernel timings (CUDA events, median of 11)
    train_t = {}
    for name, model, n in (("camel2d_trained", NF_s._model, 1 << 20),
                           ("flagship10d_rank4", flows["flagship10d_rank4"], 1 << 18)):
        flow = model.flow
        plan = pt.TrainPlan(flow)
        flat = pt.fold_flow(model).detach()
        w = torch.rand((n, flow.n_flow), generator=gen, device=dev)
        xbar, jbar = cotangents(n, flow.n_flow)
        _, jac, stage = pt.train_forward(plan, flat, w)
        flat_g, w_g = flat.clone().requires_grad_(True), w.clone().requires_grad_(True)
        outs = pt.folded_forward_ref(flow, flat_g, w_g)
        train_t[name] = {
            "fwd_kernel_ms": time_ms(lambda: pt.train_forward(plan, flat, w)),
            "fwd_stats_kernel_ms": time_ms(
                lambda: pt.train_forward(plan, flat, w, with_stats=True)),
            "fwd_plain_ms": time_ms(lambda: pt.folded_forward_ref(flow, flat, w)),
            "bwd_kernel_ms": time_ms(
                lambda: pt.train_backward(plan, flat, stage, jac, jbar, xbar)),
            # autograd's backward alone, on a graph kept from one forward
            "bwd_plain_ms": time_ms(lambda: torch.autograd.grad(
                outs, (flat_g, w_g), (xbar, jbar), retain_graph=True)),
        }
        del outs
        for key, ms in train_t[name].items():
            print(f"phase10 {name} n={n} {key}: {ms:.4f} ms "
                  f"({n / ms * 1e3:.4e} samples/s) {card}")

    camel_t = timings["camel2d_trained"]
    camel_tt = train_t["camel2d_trained"]
    src = "nf_tpu_torch/ops/csrc/pwquad_train.cu"
    print(json.dumps({"kernels": [{
        "name": "pwquad_sampler",
        "route": "cuda",
        "source": "nf_tpu_torch/ops/csrc/pwquad_sampler.cu",
        "replaces": "nf_tpu/ops/pwquad_sampler.py:286",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": camel_t["kernel_seeded_ms"],
        "plain_ms": camel_t["plain_rand_plus_folded_ms"],
    }, {
        "name": "pwquad_train_fwd",
        "route": "cuda",
        "source": src,
        "replaces": "nf_tpu/ops/pwquad_train.py:608",
        "launches": train_launches[0],
        "max_abs_err": train_err[0],
        "ms": camel_tt["fwd_kernel_ms"],
        "plain_ms": camel_tt["fwd_plain_ms"],
    }, {
        "name": "pwquad_train_bwd",
        "route": "cuda",
        "source": src,
        "replaces": "nf_tpu/ops/pwquad_train.py:681",
        "launches": train_launches[1],
        "max_abs_err": train_err[1],
        "ms": camel_tt["bwd_kernel_ms"],
        "plain_ms": camel_tt["bwd_plain_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
