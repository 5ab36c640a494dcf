#!/usr/bin/env python3
"""Smoke test of nf_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``nf_tpu_torch/ops/csrc``.  Phases 3-6: holds
the fused sampler against its plain PyTorch version on the card (on plans
beyond the kernels' old caps too), runs the
camel-2D main path (train, then ``sample`` and ``integrate``) through the
manager, checks that ``sample`` and ``integrate`` went through the kernel and
that the integral agrees with the analytic value, holds the kernel against
its plain version again on the trained model at the main path's sizes and
counter offsets, and times the kernel against its plain version.  Phases
7-10 do the same for the training kernels and the stale-statistics trainer
(``bn_stats="stale"``): forward, stats and backward against their plain
versions, whole batches up to the sizes the trainers launch at, the stale
camel-2D path with its launch counts, bench.py's stale stages (with theirs)
beside the batch-statistics trainer, a device profile, and kernel timings,
each beside the least time the card could take for its work (its bound) and
the share of that bound it reaches.  Phase 11 runs ``create_model(2, 4, [128,
128])``, a model the kernels once refused, through ``sample``, ``integrate``
and the stale trainer, each kernel against its plain version on that plan.
Phase 12 drives the event-generation side on the trained camel model
(bench.py's stage ``unweight_qmc``): the unweighting efficiency, partial and
plain ``generate_unweighted`` and ``integrate(method="qmc")``, all through
the sampler kernel; then the device Sobol on the card against the CPU, the
kernel on Sobol latents against its plain version, the round trip through
``make_folded_inverse`` (camel and the 10-D flagship), the QMC integrals
against the analytic value and the unweighted events' distribution.
Phase 13 drives the phase space on the card: the 2 -> 4 double resonance of
tools/run_2to4.py (decay-tree channel, Breit-Wigner and tau maps, ToyPDF,
cuts) through the batch trainer, ``sample``, ``integrate``,
``generate_unweighted`` and the stale trainer on an n_flow 10 / 32-bin /
[32, 32] model; then the flat volume, the card against the CPU, the
Drell-Yan cross section against its analytic value (importance-sampled MC
and the trained flow), the kernels against their plain versions on the new
plan, the 2 -> 4 flow integral against uniform MC, and timings.
Prints one ``{"kernels": [...]}`` line;
the last line of standard output is ``{"ok": true, "device": {...}}``; any
failed check exits non-zero before it is printed.  Exits non-zero at once
where CUDA is not available.
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


# An H100 SXM's peaks (NVIDIA's data sheet, at 700 W): float32 outside the
# tensor cores, and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def kernel_work(pt, flow, kernel, n):
    """``(FLOPs, bytes)`` one launch of ``kernel`` ("sampler", "fwd",
    "fwd_stats" or "bwd") needs for ``n`` samples of ``flow``: every input
    read once and every output written once; an FMA is 2 FLOPs; a
    transform's arithmetic per transformed dimension as counted from the
    kernels' code (pwquad with nb bins: ~12 nb + 12 forward, ~33 nb + 32
    recompute and VJP).  The backward recomputes the MLP, sends the
    cotangent back through it and forms dW: three products of the forward's
    size.  The forward with stats adds, per statistics value, an add, a
    multiply and an add, and writes its launch's [n_blocks, n_stat_rows]
    float64 partial sums."""
    if kernel == "fwd_stats":
        flops, nbytes = kernel_work(pt, flow, "fwd", n)
        plan = pt.TrainPlan(flow)
        n_blocks = pt.fwd_blocks(n, pt.train_fwd_config(plan, True)[0])
        return flops + 3 * n * plan.n_stat_rows // 2, nbytes + 8 * n_blocks * plan.n_stat_rows
    nf = flow.n_flow
    layers = [pt.layer_shapes(cfg) for cfg in flow.cells]
    flops = 0
    for cfg, shapes in zip(flow.cells, layers):
        t, nb = nf - cfg.pass_through, cfg.n_bins or 0
        mlp = sum(fi * fo for fi, fo, _ in shapes)
        if kernel == "bwd":
            tr = {"pwquad": 33 * nb + 32, "pwlin": 12 * nb + 16, "affine": 25}[cfg.kind]
            flops += 6 * mlp + sum(fo for _, fo, _ in shapes) + t * tr
        else:
            tr = {"pwquad": 12 * nb + 12, "pwlin": 4 * nb + 8, "affine": 10}[cfg.kind]
            flops += 2 * mlp + sum(fo for _, fo, relu in shapes if relu) + t * tr
    n_weights = sum(fi * fo + fo for shapes in layers for fi, fo, _ in shapes)
    staged = 4 * len(flow.cells) * nf
    per_sample = {"sampler": 4 * nf + 4,                    # x, jac
                  "fwd": 4 * nf + 4 * nf + 4 + staged,     # latents; x, jac, stage
                  "bwd": staged + 4 + 4 + 4 * nf + 4 * nf}[kernel]   # stage, jac, jbar, xbar; wbar
    return n * flops, n * per_sample + 4 * n_weights * (2 if kernel == "bwd" else 1)


def bound_ms(flops, nbytes):
    """The least time the card could take: ``(ms, "operations" | "bytes")``."""
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def device_profile(tag, what, fn, card):
    """Run ``fn()`` once under ``torch.profiler`` and print the device time
    of its kernel and copy rows against the wall time, and the six largest
    rows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the device's own records (kernels, copies): an operator's device time,
    # and an annotated range's span on the device (the optimizer step's),
    # repeat those of the kernels inside them
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    dev_us = [e.self_device_time_total for e in events]
    total = sum(dev_us)
    launches = sum(e.count for e in events)
    check(total > 0, f"{what} profile shows device time")
    print(f"{tag} {what} under the profiler: device {total / 1e3:.3f} ms of "
          f"{wall * 1e3:.3f} ms wall (busy {total / 1e6 / wall:.1%}), {launches} device "
          f"operations (kernels and copies) {card}")
    for us, e in sorted(zip(dev_us, events), key=lambda t: -t[0])[:6]:
        print(f"{tag}   {us / 1e3:.3f} ms ({us / total:.1%}) x{e.count} {e.key[:90]}")
    return total / 1e3, launches


# ---- phase 13: phase space on the card.  The 2 -> 4 double resonance of
# tools/run_2to4.py (qq -> ZZ -> 4l at 2000 GeV, BASELINE configs[3]) and the
# Drell-Yan 2 -> 2 of tests/test_physics_validation.py.
MZ, GZ = 91.188, 2.4952
MZ2, GAM2 = MZ ** 2, MZ ** 2 * GZ ** 2
GEV2_TO_PB = 2.56819e-9
E_ZZ = E_DY = 2000.0
ZZ_CUTS = dict(pT_mincut=20.0, delR_mincut=0.4, rap_maxcut=2.4, pdgs=(2, -2))
DY_SIGMA_PB = 3.6568        # the analytic sigma, tests/test_physics_validation.py:135-138
ZZ_RECORD_PB = (3.8170, 0.0016)   # nf_tpu's record, tools/run_2to4.py:14-15 (no gate)
PDF_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                           "toypdf_0000.dat")
# run_2to4.py's published configuration, cut only in its epoch counts
ZZ_BATCH, ZZ_MINI = 1 << 20, 1 << 18
ZZ_BATCH_EPOCHS, ZZ_STALE_EPOCHS = 5, 8
# phase 13's sizes: the path's and the timings' batch, the kernel checks'
# (sampler, training kernels), the uniform MC's, the Drell-Yan MC's chunk
# (four of them), the card-against-CPU batch
N_PS, N_SAMPLER, N_TRAIN, N_UNIFORM, N_DY, N_CPU = 1 << 20, 1 << 21, 1 << 18, 1 << 22, 1 << 19, 1 << 16


def zz_integrand():
    """``(channel, f)``: the decay-tree channel with both Z pairs
    Breit-Wigner mapped, ToyPDF in tau mode and the cuts, the tau latent
    power-mapped above the ZZ threshold (tools/run_2to4.py:93-109)."""
    from functools import partial

    from nf_tpu_torch.phasespace import lorentz
    from nf_tpu_torch.phasespace.mappings import remap_integrand, shifted_power_unit_map
    from nf_tpu_torch.phasespace.pdf import ToyPDF
    from nf_tpu_torch.phasespace.topology import BreitWignerSMap, ResonanceDecayPhasespace

    channel = ResonanceDecayPhasespace(
        [0.0, 0.0], [0.0] * 4, ((0, 1), (2, 3)),
        mass_maps={(0, 1): BreitWignerSMap(MZ, GZ), (2, 3): BreitWignerSMap(MZ, GZ)},
        pdf=ToyPDF(), pdf_active=True, tau=True)

    def base(w):
        momenta, wgt = channel.generateKinematics_batch(E_ZZ, w, **ZZ_CUTS)
        fin = momenta[:, 2:, :]
        s34 = lorentz.square(fin[:, 0] + fin[:, 1])
        s56 = lorentz.square(fin[:, 2] + fin[:, 3])
        return 1e4 / ((s34 - MZ2) ** 2 + GAM2) * 1e4 / ((s56 - MZ2) ** 2 + GAM2) * wgt

    tau_th = (2 * MZ / E_ZZ) ** 2
    return channel, remap_integrand(base, channel.nDimPhaseSpace(), partial(
        shifted_power_unit_map, exponent=-3.0, shift=3 * tau_th))


def dy_integrand():
    """The Drell-Yan integrand of tests/test_physics_validation.py:48-60."""
    from nf_tpu_torch import FlatInvertiblePhasespace
    from nf_tpu_torch.phasespace import lorentz
    from nf_tpu_torch.phasespace.pdf import ToyPDF

    gen = FlatInvertiblePhasespace([0.0, 0.0], [0.0, 0.0], pdf=ToyPDF(), pdf_active=True,
                                   tau=True)

    def integrand(w):
        momenta, wgt = gen.generateKinematics_batch(E_DY, w, pT_mincut=10.0, rap_maxcut=2.4,
                                                    pdgs=(2, -2))
        shat = lorentz.square(momenta[:, 0, :] + momenta[:, 1, :])
        return 1e4 / ((shat - MZ2) ** 2 + GAM2) * wgt

    return integrand


def phase13(dev, card, gen, hold_train, perturb_bn):
    """Phase space on the card: the 2 -> 4 path through the entry points,
    then checks 1-6.  Returns ``(launches, errors)``: the path's kernel
    launches (sampler, forward, backward) and the largest errors against
    the plain versions (sampler x, forward, backward)."""
    import torch

    from nf_tpu_torch import FlatInvertiblePhasespace, PWQuadManager
    from nf_tpu_torch.flows import factory
    from nf_tpu_torch.flows import sampling as fsampling
    from nf_tpu_torch.flows.fast_eval import make_folded_forward
    from nf_tpu_torch.ops import pwquad_sampler as ps
    from nf_tpu_torch.ops import pwquad_train as pt
    from nf_tpu_torch.phasespace.lhapdf_reader import LHAPDFGrid
    from nf_tpu_torch.phasespace.mappings import shifted_power_unit_map
    from nf_tpu_torch.phasespace.pdf import ToyPDF
    from nf_tpu_torch.phasespace.topology import BreitWignerSMap
    from nf_tpu_torch.training import optimizers
    from nf_tpu_torch.training.unweight import generate_unweighted

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def pb(v):
        return v / GEV2_TO_PB

    # ---- the 2 -> 4 path: the batch trainer, sample, integrate, unweighted
    # events, then the stale trainer on the same model
    channel, zz = zz_integrand()
    n_flow = channel.nDimPhaseSpace() + 2
    NF_z = PWQuadManager(n_flow=n_flow, seed=0, device=dev)
    NF_z.create_model(4, 32, [32] * 2, identity_init=True)
    train_kw = dict(log=False, batch_size=ZZ_BATCH, mini_batch_size=ZZ_MINI,
                    pretty_progressbar=False, integrate=False, preburn_time=0, kill_counter=50,
                    loss_mode="var", select_best_by="ess")
    ps.LAUNCHES = pt.FWD_LAUNCHES = pt.BWD_LAUNCHES = 0
    sync()
    t0 = time.perf_counter()
    NF_z._train_variance_forward_seq(zz, optimizers.adamax(5e-4, 1e-4), epochs=ZZ_BATCH_EPOCHS,
                                     **train_kw)
    sync()
    batch_s = time.perf_counter() - t0
    batch_ran = NF_z._last_epoch + 1
    batch_epoch = NF_z.benchmark_train_step(reps=3)
    x_s, jac_s = NF_z.sample(N_PS)
    sig, err = NF_z.integrate(zz, 8, N_PS, seed=11, combine="mean")
    unw_batch = 1 << 18
    ev, eff, n_over = generate_unweighted(NF_z._flow, NF_z.best_model, zz,
                                          torch.Generator(device=dev).manual_seed(31),
                                          n_events=4096, batch=unw_batch)
    eventgen = ps.LAUNCHES
    t0 = time.perf_counter()
    NF_z._train_variance_forward_seq(zz, optimizers.adamax(5e-4, 1e-4), epochs=ZZ_STALE_EPOCHS,
                                     bn_stats="stale", stats_every=4, **train_kw)
    sync()
    stale_s = time.perf_counter() - t0
    launches = (ps.LAUNCHES, pt.FWD_LAUNCHES, pt.BWD_LAUNCHES)
    stale_ran = NF_z._last_epoch + 1
    n_mb = ZZ_BATCH // ZZ_MINI
    print(f"phase13 zz: batch trainer {batch_ran} epochs in {batch_s:.2f} s (best epoch "
          f"{NF_z.best_epoch} of the stale run below), sample(2^20), integrate(8, 2^20), "
          f"{len(ev)} unweighted events (efficiency {eff:.5f}, overweight {n_over}), stale "
          f"trainer {stale_ran} epochs in {stale_s:.2f} s; launches sampler {launches[0]} "
          f"({eventgen} before the stale run) fwd {launches[1]} bwd {launches[2]}")
    # one launch for sample, one per replication of integrate, one for the
    # w_max estimate and one per proposal batch of the unweighting (its
    # efficiency is accepted / proposed, in whole batches)
    n_unw_batches = round(len(ev) / (eff * unw_batch))
    check(launches[0] == eventgen == 1 + 8 + 1 + n_unw_batches,
          f"zz sample/integrate/unweighting ({n_unw_batches} proposal batches) launched the "
          f"sampler {eventgen} times")
    check(launches[1:] == (stale_ran * n_mb + (stale_ran - 1) // 4 + 1, stale_ran * n_mb),
          f"zz stale trainer launched fwd/bwd {launches[1:]}")
    check(x_s.shape == (N_PS, n_flow) and bool(torch.isfinite(jac_s).all())
          and bool(((x_s >= 0) & (x_s <= 1)).all()), "zz sample() output")
    check(len(ev) >= 4096 and ev.shape[1] == n_flow and 0 < eff <= 1, "zz unweighted events")
    errors = [0.0, 0.0, 0.0]

    # check 1: the massless flat volume, every weight, in float32 and float64
    for n_final in (2, 3, 4, 5):
        gen_f = FlatInvertiblePhasespace([0.0, 0.0], [0.0] * n_final)
        vol = gen_f.get_flatWeights(1000.0, n_final) / (2 * 1000.0 ** 2)
        for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
            rv = torch.rand((N_PS, gen_f.nDimPhaseSpace()), generator=gen, device=dev,
                            dtype=dtype)
            mom, w = gen_f.generateKinematics_batch(1000.0, rv)
            # the generator zeroes events it cannot resolve (momenta and
            # weight, ~1e-6 of float32 events: a mass latent at the edge)
            sanitised = (mom == 0).flatten(1).all(1)
            rel = (w / vol - 1).abs()
            worst = float(rel[~sanitised].max())
            n_san = int(sanitised.sum())
            print(f"phase13 check 1 flat volume n_final={n_final} {str(dtype)[6:]} 2^20: "
                  f"max |w / vol - 1| = {worst:.3e} over the {N_PS - n_san} events kept, "
                  f"{n_san} sanitised")
            check(worst <= tol, f"flat volume n_final={n_final} {dtype}")
            check(n_san <= (16 if dtype == torch.float32 else 0),
                  f"flat volume n_final={n_final} {dtype}: {n_san} events sanitised")
            check(bool((w[sanitised] == 0).all()), "sanitised events weigh 0")

    # check 2: the card against the CPU, float64, the same port code
    n_c = N_CPU

    def against_cpu(what, fn, rv, scales):
        """``fn(rv)`` on the card and on the CPU: each output's largest
        |difference| / (|cpu value| + its scale), and the events whose
        weight (the last output) is zero on one side only."""
        out_d, out_c = fn(rv), fn(rv.cpu())
        worst = max(float(((a.cpu() - b).abs() / (b.abs() + scale)).max())
                    for a, b, scale in zip(out_d, out_c, scales))
        flips = int(((out_d[-1].cpu() == 0) != (out_c[-1] == 0)).sum())
        print(f"phase13 check 2 {what} 2^16 float64: cuda against cpu max rel {worst:.3e}, "
              f"cut decisions that differ {flips}")
        check(worst <= 1e-9 and flips == 0, f"{what} cuda vs cpu")

    flat_pdf = FlatInvertiblePhasespace([0.0, 0.0], [173.0, 4.7, 0.0, 80.4], pdf=ToyPDF(),
                                        pdf_active=True, tau=True)
    rv = torch.rand((n_c, 10), generator=gen, device=dev, dtype=torch.float64)
    # the momenta against the collider energy (components cancel), the
    # weights relative
    against_cpu("flat massive 2->4, ToyPDF tau, cuts",
                lambda r: flat_pdf.generateKinematics_batch(1000.0, r, **ZZ_CUTS), rv,
                (1000.0, 1e-300))
    against_cpu("zz channel, ToyPDF tau, cuts",
                lambda r: channel.generateKinematics_batch(E_ZZ, r, **ZZ_CUTS), rv,
                (E_ZZ, 1e-300))
    grid = LHAPDFGrid.from_dat(PDF_FIXTURE)
    xq = torch.stack([10 ** (6 * torch.rand(n_c, generator=gen, device=dev,
                                            dtype=torch.float64) - 6.1),
                      10 ** (10 * torch.rand(n_c, generator=gen, device=dev,
                                             dtype=torch.float64) - 1)], 1)
    for mode in ("continuation", "nearest"):
        against_cpu(f"LHAPDFGrid {mode}, all flavors, in and out of range", lambda r: [
            torch.stack([grid.xfxQ2(pdg, r[:, 0], r[:, 1], extrapolation=mode)
                         for pdg in grid.flavors])], xq, (1e-12,))

    # check 3: Drell-Yan against the analytic sigma
    dy = dy_integrand()
    s_dy = E_DY ** 2
    tau_min, tau_star, w_tau = (1.0 / E_DY) ** 2, MZ2 / s_dy, math.sqrt(GAM2) / s_dy
    lo, hi = math.atan((tau_min - tau_star) / w_tau), math.atan((1.0 - tau_star) / w_tau)
    tot, tot2, n_tot = 0.0, 0.0, 0
    for _ in range(4):
        u = torch.rand((N_DY, 4), generator=gen, device=dev, dtype=torch.float64)
        tau = tau_star + w_tau * torch.tan(lo + u[:, -2] * (hi - lo))
        q_tau = 1.0 / ((hi - lo) * w_tau * (1.0 + ((tau - tau_star) / w_tau) ** 2))
        w = u.clone()
        w[:, -2] = (tau - tau_min) / (1.0 - tau_min)
        iw = dy(w) / (q_tau * (1.0 - tau_min))
        tot += float(iw.sum())
        tot2 += float((iw ** 2).sum())
        n_tot += u.shape[0]
    est = tot / n_tot
    est_err = math.sqrt(max(tot2 / n_tot - est ** 2, 0.0) / n_tot)
    sigma = DY_SIGMA_PB * GEV2_TO_PB
    print(f"phase13 check 3 Drell-Yan importance-sampled MC, 4 x 2^19 float64: "
          f"{pb(est):.5f} +- {pb(est_err):.5f} pb (analytic {DY_SIGMA_PB} pb)")
    check(abs(est - sigma) < max(6 * est_err, 0.01 * sigma), "Drell-Yan MC vs analytic sigma")
    NF_d = PWQuadManager(n_flow=4, seed=0, device=dev)
    NF_d.create_model(4, 32, [32] * 2)
    t0 = time.perf_counter()
    NF_d._train_variance_forward_seq(
        dy, optimizers.adamax(2e-3, 1e-4), log=False, batch_size=16384, epochs=60,
        pretty_progressbar=False, mini_batch_size=16384, integrate=False, preburn_time=0,
        kill_counter=100, loss_mode="kl")
    dy_s = time.perf_counter() - t0
    ps.LAUNCHES = 0
    sig_d, err_d = NF_d.integrate(dy, 8, 1 << 17, seed=11, combine="mean")
    sync()
    dy_launches = ps.LAUNCHES
    print(f"phase13 check 3 Drell-Yan NIS: 60 kl epochs at batch 16384 in {dy_s:.2f} s, "
          f"integrate(8, 2^17) through the sampler ({dy_launches} launches): "
          f"{pb(sig_d):.5f} +- {pb(err_d):.5f} pb (analytic {DY_SIGMA_PB} pb)")
    check(dy_launches == 8, f"Drell-Yan integrate launched the sampler {dy_launches} times")
    check(err_d > 0 and abs(sig_d - sigma) < max(6 * err_d, 0.1 * sigma),
          "Drell-Yan NIS vs analytic sigma")

    # check 4: the kernels against their plain versions on the n_flow 10,
    # 32-bin, [32, 32] plan: a model with random weights and BatchNorm
    # statistics, then the trained one
    model_r = perturb_bn(factory.build_pwquad_flow(gen, n_flow, 4, 32, (32, 32), device=dev))
    flow = model_r.flow

    def hold_sampler(what, x_k, jac_k, x_p, jac_p):
        sync()
        err_x = float((x_k - x_p).abs().max())
        err_j = float(((jac_k - jac_p) / jac_p).abs().max())
        errors[0] = max(errors[0], err_x)
        print(f"phase13 check 4 {what}: max|dx|={err_x:.3e} max|djac/jac|={err_j:.3e}")
        check(x_k.shape == x_p.shape and jac_k.shape == jac_p.shape, f"{what} shapes")
        check(torch.allclose(x_k, x_p, rtol=1e-4, atol=2e-5), f"{what} x vs plain")
        check(torch.allclose(jac_k, jac_p, rtol=1e-3, atol=0.0), f"{what} jac vs plain")

    w = torch.rand((N_SAMPLER, n_flow), generator=gen, device=dev)
    hold_sampler("sampler, random weights, identical latents 2^21",
                 *ps.build_sampler(flow, model_r, take_latents=True)(w),
                 *make_folded_forward(flow, model_r)(w))
    x_k, jac_k = NF_z.sample(N_SAMPLER, seed=5)
    seed = fsampling.seed_from(torch.Generator(device=dev).manual_seed(5))
    w = torch.from_numpy(ps.philox_uniform(seed, 0, N_SAMPLER, n_flow)).to(dev)
    hold_sampler("sampler, trained model, sample(2^21, seed=5)", x_k, jac_k,
                 *make_folded_forward(NF_z._flow, NF_z.best_model)(w))
    del w, x_k, jac_k
    for what, model in (("random weights", model_r), ("trained stale", NF_z._model)):
        e_f, e_b = hold_train(f"zz {what} n=2^18", pt.TrainPlan(model.flow),
                              pt.fold_flow(model).detach(),
                              torch.rand((N_TRAIN, n_flow), generator=gen, device=dev),
                              tag="phase13 check 4")
        errors[1], errors[2] = max(errors[1], e_f), max(errors[2], e_b)

    # check 5: the flow's integral against uniform MC of the mapped channel
    wf = zz(x_s) * jac_s
    ess_flow = float(wf.mean() ** 2 / (wf ** 2).mean())
    tot, tot2 = 0.0, 0.0
    n_u = N_UNIFORM
    for _ in range(4):
        v = zz(torch.rand((n_u // 4, n_flow), generator=gen, device=dev, dtype=torch.float64))
        tot += float(v.sum())
        tot2 += float((v ** 2).sum())
    sig_u = tot / n_u
    err_u = math.sqrt(max(tot2 / n_u - sig_u ** 2, 0.0) / n_u)
    ess_u = sig_u ** 2 / (tot2 / n_u)
    print(f"phase13 check 5 zz: flow integrate(8, 2^20) = {pb(sig):.5f} +- {pb(err):.5f} pb, "
          f"uniform MC of the mapped channel 2^22 float64 = {pb(sig_u):.5f} +- {pb(err_u):.5f} "
          f"pb; ESS fraction flow {ess_flow:.5f}, uniform {ess_u:.5f} (nf_tpu's record "
          f"{ZZ_RECORD_PB[0]} +- {ZZ_RECORD_PB[1]} pb, not a gate)")
    check(math.isfinite(sig) and err > 0
          and abs(sig - sig_u) <= 5 * math.hypot(err, err_u) + 0.01 * abs(sig_u),
          "zz flow integral vs uniform MC of the mapped channel")

    # check 6: timings, CUDA events, median of 11
    bench_gen = FlatInvertiblePhasespace([0.0, 0.0], [173.0, 4.7, 0.0, 80.4])
    ms = time_ms(lambda: bench_gen.generateKinematics_batch(
        1000.0, torch.rand((N_PS, 8), generator=gen, device=dev), pT_mincut=20.0,
        delR_mincut=0.4, rap_maxcut=2.4))
    print(f"phase13 check 6 bench.py stage_phase_space (massive 2->4, 1000 GeV, cuts, 2^20 "
          f"float32 with the draw): {ms:.3f} ms = {N_PS / ms * 1e3:.4e} events/s {card}")
    w32 = torch.rand((N_PS, n_flow), generator=gen, device=dev)
    u32 = w32[:, 0].contiguous()
    s_lo = torch.zeros_like(u32)
    s_hi = torch.full_like(u32, E_ZZ ** 2)
    x32 = 10 ** (5 * u32 - 5)
    grid_pdf = LHAPDFGrid.from_dat(PDF_FIXTURE)
    layers = (
        ("zz integrand (channel map, generator, PDF, cuts, ME)", lambda: zz(w32)),
        ("zz channel generateKinematics_batch with cuts",
         lambda: channel.generateKinematics_batch(E_ZZ, w32, **ZZ_CUTS)),
        ("bench flat generator with cuts", lambda: bench_gen.generateKinematics_batch(
            1000.0, w32[:, :8], pT_mincut=20.0, delR_mincut=0.4, rap_maxcut=2.4)),
        ("ToyPDF xfxQ2", lambda: ToyPDF().xfxQ2(2, x32, MZ2)),
        ("LHAPDFGrid xfxQ2 continuation", lambda: grid_pdf.xfxQ2(2, x32, MZ2)),
        ("shifted_power_unit_map (tau)", lambda: shifted_power_unit_map(u32, -3.0, 0.025)),
        ("BreitWignerSMap.sample", lambda: BreitWignerSMap(MZ, GZ).sample(u32, s_lo, s_hi)),
    )
    for what, fn in layers:
        ms = time_ms(fn)
        dev_ms, n_ops = device_profile("phase13", f"{what}, 2^20 float32", fn, card)
        print(f"phase13 check 6 {what}: {ms:.4f} ms per 2^20 (CUDA events), {n_ops} device "
              f"operations, {dev_ms:.4f} ms of device time {card}")
    # the three kernels on this plan (random weights), beside their plain
    # versions and their bounds
    plan = pt.TrainPlan(flow)
    flat = pt.fold_flow(model_r).detach()
    plan.descriptor(dev)
    seeded = ps.build_sampler(flow, model_r, layout="dim_major")
    plain = make_folded_forward(flow, model_r)
    w = torch.rand((N_SAMPLER, n_flow), generator=gen, device=dev)
    w_t = torch.rand((N_TRAIN, n_flow), generator=gen, device=dev)
    xbar = 0.3 * torch.randn((N_TRAIN, n_flow), generator=gen, device=dev)
    jbar = torch.randn(N_TRAIN, generator=gen, device=dev)
    _, jac, stage = pt.train_forward(plan, flat, w_t)
    flat_g, w_g = flat.clone().requires_grad_(True), w_t.clone().requires_grad_(True)
    outs = pt.folded_forward_ref(flow, flat_g, w_g)
    kernel_t = {
        "sampler": (N_SAMPLER, time_ms(lambda: seeded(7, N_SAMPLER)), time_ms(lambda: plain(w))),
        "fwd": (N_TRAIN, time_ms(lambda: pt.train_forward(plan, flat, w_t)),
                time_ms(lambda: pt.folded_forward_ref(flow, flat, w_t))),
        "bwd": (N_TRAIN, time_ms(lambda: pt.train_backward(plan, flat, stage, jac, jbar, xbar,
                                                           latents=w_t)),
                time_ms(lambda: torch.autograd.grad(outs, (flat_g, w_g), (xbar, jbar),
                                                    retain_graph=True))),
    }
    del outs
    print(f"phase13 check 6 zz plan launches (block, weights in shared memory): sampler "
          f"{ps.SamplerPlan(flow).config}, forward {plan.fwd_config[False]}, backward "
          f"{plan.bwd_config}")
    for kernel, (n_k, ms, plain_ms) in kernel_t.items():
        flops, nbytes = kernel_work(pt, flow, kernel, n_k)
        b_ms, b_by = bound_ms(flops, nbytes)
        print(f"phase13 check 6 zz plan {kernel} n={n_k}: {ms:.4f} ms (plain {plain_ms:.4f} ms), "
              f"bound {b_ms:.5f} ms by {b_by} ({flops / n_k:.0f} FLOP and {nbytes / n_k:.1f} B "
              f"per sample), {b_ms / ms:.2%} of the bound {card}")
    stale_epoch = NF_z.benchmark_train_step(reps=3)
    for what, (sec, sps) in (("batch", batch_epoch), ("stale", stale_epoch)):
        print(f"phase13 check 6 zz {what} trainer, batch 2^20 in 4 x 2^18: "
              f"benchmark_train_step {sec * 1e3:.3f} ms/epoch = {sps:.4e} samples/s {card}")
    return launches, errors


def main():
    import numpy as np
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
        # beyond the kernels' old caps: 40 bins and hidden width 96, 36
        # latent dims, create_model(2, 4, [128, 128])'s 257 layer inputs
        "bins40_hidden96": factory.build_pwquad_flow(gen, 2, 2, 40, (96, 96), device=dev),
        "flow36_narrow": factory.build_pwquad_flow(gen, 36, 2, 2, (4,), device=dev),
        "wide128": factory.build_pwquad_flow(gen, 2, 2, 4, (128, 128), device=dev),
    }
    over_caps = ("bins40_hidden96", "flow36_narrow", "wide128")
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

    # sample(): the entry point itself, its seed drawn as the manager draws
    # it; a second call gives the same bits
    x_k, jac_k = NF.sample(1 << 24, seed=5)
    seed = fsampling.seed_from(torch.Generator(device=dev).manual_seed(5))
    max_abs_err = max(max_abs_err, hold("sample(2^24, seed=5) batch-major", x_k, jac_k,
                                        philox_latents(seed, 0, 1 << 24)))
    again = NF.sample(1 << 24, seed=5)
    check(torch.equal(again[0], x_k) and torch.equal(again[1], jac_k),
          "two sample(2^24, seed=5) calls bit-identical")
    del again
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
        # the backward's per-thread arrays in its workspace
        **{name: flows[name] for name in over_caps},
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

    def hold_train(what, plan, flat, w, tag="phase7"):
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
        print(f"{tag} {what}: max|dx|={err_x:.3e} max|djac/jac|={err_j:.3e} "
              f"stats {err_s:.3e}; backward max|d|={err_b:.3e}, "
              f"worst |d|/bound {worst:.3e} (plain32 {worst32:.3e}) with the "
              f"{n - int(keep.sum())} samples within {KINK:g} of a kink masked; "
              f"unmasked {raw:.3e} (plain32 {raw32:.3e})")
        check(worst <= 1.0, f"{what} backward vs plain")
        again = pt.train_backward(plan, flat, stage_k, jac_k, jbar, xbar)
        check(torch.equal(again[0], dflat_k) and torch.equal(again[1], wbar_k),
              f"{what} two backward launches bit-identical")
        again = pt.train_forward(plan, flat, w, with_stats=True)
        check(all(torch.equal(a, b) for a, b in zip(again, (x_k, jac_k, stage_k, stats_k))),
              f"{what} two forward launches bit-identical (x, jac, stage, stats)")
        # the variant without stats (the trainer's minibatch forward)
        check(all(torch.equal(a, b) for a, b in zip(pt.train_forward(plan, flat, w),
                                                     (x_k, jac_k, stage_k))),
              f"{what} forward without stats bit-identical to the stats variant's")
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
        return NF_b.benchmark_train_step(reps=3), launches, NF_b

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
            (sec, sps), launches_b, mgr_b = bench_trainer(*bench_args, bn_stats, epochs)
            if cfg.startswith("flagship") and bn_stats == "stale":
                flagship_stale = mgr_b
            print(f"phase9 {cfg} bn_stats={bn_stats}: training-kernel launches fwd "
                  f"{launches_b[0]} bwd {launches_b[1]}; benchmark_train_step "
                  f"{sec * 1e3:.3f} ms/epoch = {sps:.4e} samples/s {card}")

    # ---- phase 9b: device profile of the trainers at batch 10000, and of
    # bench.py's flagship stale stage
    for what, mgr in (("stale trainer, batch 10000", NF_s), ("batch trainer, batch 10000", NF),
                      ("flagship stale trainer, batch 2^20 / 2^18", flagship_stale)):
        epochs_run = 2 * (4 if "stale" in what else 1)
        device_profile("phase9b", f"{what}, {epochs_run} epochs",
                       lambda: mgr.benchmark_train_step(reps=1), card)

    # ---- phase 10: training-kernel timings (CUDA events, median of 11)
    train_t, bounds = {}, {}
    for name, model, n in (("camel2d_trained", NF_s._model, 1 << 20),
                           ("flagship10d_rank4", flows["flagship10d_rank4"], 1 << 18)):
        flow = model.flow
        plan = pt.TrainPlan(flow)
        flat = pt.fold_flow(model).detach()
        plan.descriptor(dev)
        print(f"phase10 {name} launches (block, weights in shared memory): forward "
              f"{plan.fwd_config[False]}, with stats {plan.fwd_config[True]}, backward "
              f"{plan.bwd_config}")
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
        # each kernel beside the least time the card could take for its work
        for kernel, ms, n_k in (("sampler", timings[name]["kernel_seeded_ms"], 1 << 21),
                                ("fwd", train_t[name]["fwd_kernel_ms"], n),
                                ("fwd_stats", train_t[name]["fwd_stats_kernel_ms"], n),
                                ("bwd", train_t[name]["bwd_kernel_ms"], n)):
            flops, nbytes = kernel_work(pt, flow, kernel, n_k)
            b_ms, b_by = bound_ms(flops, nbytes)
            bounds[name, kernel] = (b_ms, b_by)
            print(f"phase10 {name} {kernel} n={n_k}: {ms:.4f} ms, bound {b_ms:.5f} ms by "
                  f"{b_by} ({flops / n_k:.0f} FLOP and {nbytes / n_k:.1f} B per sample), "
                  f"{b_ms / ms:.2%} of the bound {card}")

    # ---- phase 11: a model beyond the kernels' old caps through the user's
    # entry points: create_model(2, 4, [128, 128]) (hidden width 128, 257
    # layer inputs a cell), a few stale epochs, then sample and integrate;
    # every kernel launched, then each against its plain version on the
    # trained model's plan
    NF_w = PWQuadManager(n_flow=2, seed=0, device="cuda")
    NF_w.create_model(2, 4, [128, 128])
    wide_plan = pt.TrainPlan(NF_w._flow)
    wide_plan.descriptor(dev)
    print(f"phase11 wide128 launches (block, weights in shared memory): sampler "
          f"{ps.SamplerPlan(NF_w._flow).config}, forward {wide_plan.fwd_config[False]}, with "
          f"stats {wide_plan.fwd_config[True]}, backward {wide_plan.bwd_config} with a "
          f"{wide_plan.bwd_ws}-float workspace per thread")
    ps.LAUNCHES = pt.FWD_LAUNCHES = pt.BWD_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    NF_w._train_variance_forward_seq(
        camel, optimizers.adamax(2e-3, 1e-4), log=False, batch_size=20000, epochs=8,
        mini_batch_size=10000, preburn_time=0, integrate=False, pretty_progressbar=False,
        bn_stats="stale", stats_every=4)
    x_w, jac_w = NF_w.sample(1 << 20)
    sig_w, err_w = NF_w.integrate(camel, 4, 1 << 20)
    torch.cuda.synchronize()
    wide_s = time.perf_counter() - t0
    wide_launches = (ps.LAUNCHES, pt.FWD_LAUNCHES, pt.BWD_LAUNCHES)
    ran = NF_w._last_epoch + 1
    print(f"phase11 wide128: {ran} stale epochs, sample(2^20), integrate(4, 2^20) in "
          f"{wide_s:.2f} s; launches sampler {wide_launches[0]} fwd {wide_launches[1]} "
          f"bwd {wide_launches[2]}; integral {sig_w:.6f} +- {err_w:.2e} (exact {exact:.6f})")
    check(wide_launches == (1 + 4, 2 * ran + (ran - 1) // 4 + 1, 2 * ran),
          f"wide128 path launched sampler/fwd/bwd {wide_launches}")
    check(x_w.shape == (1 << 20, 2) and bool(torch.isfinite(jac_w).all())
          and bool(((x_w >= 0) & (x_w <= 1)).all()), "wide128 sample() output")
    check(math.isfinite(sig_w) and err_w > 0 and abs(sig_w - exact) <= 5 * err_w + 0.01 * exact,
          "wide128 |sig - exact| <= 5 err + 1%")
    w = torch.from_numpy(ps.philox_uniform(11, 3 << 20, 1 << 20, 2)).to(dev)
    x_k, jac_k = ps.build_sampler(NF_w._flow, NF_w.best_model, layout="dim_major")(
        11, 1 << 20, offset=3 << 20)
    x_p, jac_p = make_folded_forward(NF_w._flow, NF_w.best_model)(w)
    err_w = float((x_k.T - x_p).abs().max())
    print(f"phase11 wide128 sampler 2^20 dim-major at an offset: max|dx|={err_w:.3e} "
          f"max|djac/jac|={float(((jac_k - jac_p) / jac_p).abs().max()):.3e}")
    check(torch.allclose(x_k.T, x_p, rtol=1e-4, atol=2e-5), "wide128 sampler x vs plain")
    check(torch.allclose(jac_k, jac_p, rtol=1e-3, atol=0.0), "wide128 sampler jac vs plain")
    hold_train("wide128 trained n=10000", wide_plan, pt.fold_flow(NF_w._model).detach(),
               torch.rand((10000, 2), generator=gen, device=dev))

    # ---- phase 12: the event-generation side (bench.py's stage unweight_qmc,
    # bench.py:423-453) on the phase 5 trained camel model: the unweighting
    # efficiency, unweighted events (partial, then plain) and randomized-QMC
    # integrals, all through the sampler kernel; then checks 1-6
    from nf_tpu_torch.flows.fast_eval import make_folded_inverse
    from nf_tpu_torch.training.unweight import generate_unweighted
    from nf_tpu_torch.utils import qmc

    flow, best = NF._flow, NF.best_model
    ps.LAUNCHES = 0
    torch.cuda.synchronize()
    x_u, jac_u = NF.sample(100_000)
    w_u = camel(x_u) * jac_u
    unw_eff = float(w_u.mean() / w_u.max())
    check(ps.LAUNCHES == 1, f"sample(100000) launched the kernel {ps.LAUNCHES} times")
    for rep in (21, 22):   # the second call is timed
        before = ps.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev, wts, info = generate_unweighted(
            flow, best, camel, torch.Generator(device=dev).manual_seed(rep), n_events=1 << 20,
            batch=1 << 22, wmax_quantile=0.999, partial_unweight=True)
        unw_s = time.perf_counter() - t0
        # the w_max pilot and at least one proposal batch
        check(ps.LAUNCHES - before >= 2, f"generate_unweighted launched the kernel "
              f"{ps.LAUNCHES - before} times")
    kish = float(wts.astype(np.float64).sum()) ** 2 / float((wts.astype(np.float64) ** 2).sum())
    before = ps.LAUNCHES
    ev_p, eff_p, over_p = generate_unweighted(
        flow, best, camel, torch.Generator(device=dev).manual_seed(23), n_events=1 << 20,
        batch=1 << 22, wmax_quantile=0.999)
    check(ps.LAUNCHES - before >= 2, "plain generate_unweighted launched the kernel")
    before = ps.LAUNCHES
    sig_q, err_q = NF.integrate(camel, 8, 65536, seed=11, method="qmc")
    t0 = time.perf_counter()
    sig_q2, err_q2 = NF.integrate(camel, 8, 1 << 21, seed=12, method="qmc")
    qmc_s = time.perf_counter() - t0
    check(ps.LAUNCHES - before == 16, f"integrate(method='qmc') x2 launched the kernel "
          f"{ps.LAUNCHES - before} times, not 8 + 8")
    torch.cuda.synchronize()
    eventgen_launches = ps.LAUNCHES
    print(f"phase12: unweighting efficiency mean(w)/max(w) over sample(100000) = {unw_eff:.5f}")
    print(f"phase12: generate_unweighted(2^20 events, batch 2^22, quantile 0.999, partial), "
          f"second call: {len(ev)} events in {unw_s * 1e3:.2f} ms = {len(ev) / unw_s:.4e} "
          f"events/s, Kish-effective {kish:.1f} = {kish / unw_s:.4e} events/s; eff "
          f"{info['eff']:.5f}, accept rate {info['accept_rate']:.5f}, overweight "
          f"{info['n_overweight']}, w_max {info['w_max']:.5f} (host clock) {card}")
    print(f"phase12: plain generate_unweighted: {len(ev_p)} events, efficiency {eff_p:.5f}, "
          f"overweight {over_p}")
    for neval, (sig, err) in ((65536, (sig_q, err_q)), (1 << 21, (sig_q2, err_q2))):
        print(f"phase12: integrate(8, {neval}, method='qmc') = {sig:.7f} +- {err:.2e} (exact "
              f"{exact:.7f}, rel err {abs(sig - exact) / exact:.2e})")
    print(f"phase12: integrate(8, 2^21, method='qmc') in {qmc_s * 1e3:.3f} ms = "
          f"{8 * (1 << 21) / qmc_s:.4e} samples/s (host clock) {card}")
    print(f"phase12: sampler kernel launches {eventgen_launches}")

    # check 1: the device Sobol's integer arithmetic on the card equals the CPU's
    for dim, n in ((2, 1 << 18), (8, 1 << 16)):
        gen_s = qmc.make_device_sobol(dim)
        for s in (11, (12 + 0x9E3779B9 * 7) & 0xFFFFFFFF):
            check(torch.equal(gen_s(n, s, dev).cpu(), gen_s(n, s, "cpu")),
                  f"device Sobol dim {dim} seed {s}: cuda != cpu")
    print("phase12 check 1: device Sobol on cuda equals cpu bit for bit (dims 2, 8; two seeds)")
    # check 2: the kernel in operand mode on Sobol latents against its plain version
    w_q = qmc.make_device_sobol(2)(1 << 21, 12, dev)
    x_k, jac_k = ps.build_sampler(flow, best, take_latents=True)(w_q)
    x_p, jac_p = make_folded_forward(flow, best)(w_q)
    err_x = float((x_k - x_p).abs().max())
    max_abs_err = max(max_abs_err, err_x)
    print(f"phase12 check 2: kernel on Sobol latents 2^21: max|dx|={err_x:.3e} "
          f"max|djac/jac|={float(((jac_k - jac_p) / jac_p).abs().max()):.3e}")
    check(torch.allclose(x_k, x_p, rtol=1e-4, atol=2e-5), "Sobol operand x vs plain")
    check(torch.allclose(jac_k, jac_p, rtol=1e-3, atol=0.0), "Sobol operand jac vs plain")
    del x_k, jac_k, x_p, jac_p
    # where a QMC replication's time goes: the device Sobol and the kernel
    gen_q = qmc.make_device_sobol(2)
    lat_kernel = ps.build_sampler(flow, best, take_latents=True)
    sobol_ms = time_ms(lambda: gen_q(1 << 21, 12, dev))
    operand_ms = time_ms(lambda: lat_kernel(w_q))
    print(f"phase12: one QMC replication of 2^21: device Sobol {sobol_ms:.4f} ms, kernel on "
          f"its points {operand_ms:.4f} ms (CUDA events) {card}")
    device_profile("phase12", "generate_unweighted(2^20 events, batch 2^22, partial)",
                   lambda: generate_unweighted(
                       flow, best, camel, torch.Generator(device=dev).manual_seed(24),
                       n_events=1 << 20, batch=1 << 22, wmax_quantile=0.999,
                       partial_unweight=True), card)
    device_profile("phase12", "integrate(8, 2^21, method='qmc')",
                   lambda: NF.integrate(camel, 8, 1 << 21, seed=13, method="qmc"), card)
    # check 3: the kernel's x through make_folded_inverse gives back the
    # latents; samples within KINK of a kink of the map are masked
    NF_f = PWQuadManager(n_flow=10, seed=4, device="cuda")
    NF_f.create_model(8, 8, [16, 16], final_rank=4)
    for name, m in (("camel2d_trained", best), ("flagship10d_rank4", NF_f.best_model)):
        w = torch.rand((1 << 18, m.flow.n_flow), generator=gen, device=dev)
        x_k, jac_k = ps.build_sampler(m.flow, m, take_latents=True)(w)
        w_back, jac_inv = make_folded_inverse(m.flow, m)(x_k)
        keep = pt.kink_distance(m.flow, pt.fold_flow(m).detach().double(), w.double()) > KINK
        err_w = (w_back - w).abs().amax(1)
        err_j = (jac_k * jac_inv - 1).abs()
        print(f"phase12 check 3 {name} 2^18: max|w_back - w|={float(err_w[keep].max()):.3e} "
              f"max|jac*jac_inv - 1|={float(err_j[keep].max()):.3e} with the "
              f"{int((~keep).sum())} samples within {KINK:g} of a kink masked; unmasked "
              f"{float(err_w.max()):.3e}, {float(err_j.max()):.3e}")
        check(float(err_w[keep].max()) <= 2e-4, f"{name} round trip latents")
        check(float(err_j[keep].max()) <= 1e-3, f"{name} round trip jac * jac_inv")
    # check 4: the QMC integrals
    for sig, err in ((sig_q, err_q), (sig_q2, err_q2)):
        check(math.isfinite(sig) and err > 0 and abs(sig - exact) <= 5 * err + 0.01 * exact,
              "QMC |sig - exact| <= 5 err + 1%")
    # check 5: the partially unweighted events are f-distributed: by the
    # camel's symmetry, half the weight lies at x0 > 0.5
    share = float(wts[ev[:, 0] > 0.5].astype(np.float64).sum() / wts.astype(np.float64).sum())
    sigma = math.sqrt(0.25 / kish)
    print(f"phase12 check 5: weighted share of events at x0 > 0.5 = {share:.5f} "
          f"(0.5 +- {sigma:.1e}); min weight {float(wts.min()):.5f}")
    check(abs(share - 0.5) <= 5 * sigma, "partial events' weighted share at x0 > 0.5")
    check(bool((wts >= 1).all()) and len(ev) >= 1 << 20 and ev.shape[1] == 2,
          "partial events: weights >= 1, at least 2^20 events")
    # check 6: plain mode: efficiency = accepted / proposals (whole batches)
    proposals = len(ev_p) / eff_p
    check(abs(proposals - round(proposals)) < 1e-6 and round(proposals) % (1 << 22) == 0,
          f"plain efficiency {eff_p} is not accepted / proposals")
    check(len(ev_p) >= 1 << 20 and bool(((ev_p >= 0) & (ev_p <= 1)).all()),
          "plain events in [0, 1]^2")

    # ---- phase 13: phase space on the card (the 2 -> 4 path, checks 1-6)
    zz_launches, zz_err = phase13(dev, card, gen, hold_train, perturb_bn)
    max_abs_err = max(max_abs_err, zz_err[0])

    camel_t = timings["camel2d_trained"]
    camel_tt = train_t["camel2d_trained"]
    src = "nf_tpu_torch/ops/csrc/pwquad_train.cu"
    print(json.dumps({"kernels": [{
        "name": "pwquad_sampler",
        "route": "cuda",
        "source": "nf_tpu_torch/ops/csrc/pwquad_sampler.cu",
        "replaces": "nf_tpu/ops/pwquad_sampler.py:286",
        "launches": launches + eventgen_launches + zz_launches[0],
        "max_abs_err": max_abs_err,
        "ms": camel_t["kernel_seeded_ms"],
        "plain_ms": camel_t["plain_rand_plus_folded_ms"],
        "bound_ms": bounds["camel2d_trained", "sampler"][0],
        "bound_by": bounds["camel2d_trained", "sampler"][1],
        "library_ms": None,
    }, {
        "name": "pwquad_train_fwd",
        "route": "cuda",
        "source": src,
        "replaces": "nf_tpu/ops/pwquad_train.py:608",
        "launches": train_launches[0] + zz_launches[1],
        "max_abs_err": max(train_err[0], zz_err[1]),
        "ms": camel_tt["fwd_kernel_ms"],
        "plain_ms": camel_tt["fwd_plain_ms"],
        "bound_ms": bounds["camel2d_trained", "fwd"][0],
        "bound_by": bounds["camel2d_trained", "fwd"][1],
        "library_ms": None,
    }, {
        "name": "pwquad_train_bwd",
        "route": "cuda",
        "source": src,
        "replaces": "nf_tpu/ops/pwquad_train.py:681",
        "launches": train_launches[1] + zz_launches[2],
        "max_abs_err": max(train_err[1], zz_err[2]),
        "ms": camel_tt["bwd_kernel_ms"],
        "plain_ms": camel_tt["bwd_plain_ms"],
        "bound_ms": bounds["camel2d_trained", "bwd"][0],
        "bound_by": bounds["camel2d_trained", "bwd"][1],
        "library_ms": None,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
