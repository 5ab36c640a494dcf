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
Phase 14 drives the ZZ/Z' multi-channel path of examples/zz_multichannel.py:
a shared n_flow 11 rank-4 flow on the fixed-alpha two-channel integrand
through both trainers, ``sample`` and ``integrate`` (the three kernels held
against their plain versions on that plan), then the learned mixture
(``training.multichannel``: per-channel flows, their trainer with
checkpoints and a resume, stratified sampling, unweighting with global and
per-channel maxima, partial unweighting written to an LHE file and read
back), both integrals against uniform MC of the fixed-alpha integrand.
Phase 15 drives the experiment side: stop and resume of both trainers
against the uninterrupted run (camel-2D and the flagship, bit for bit), the
run logger and checkpoints, ``run_sweep`` over ``pro`` (sequential, and in a
child process on the card) and ``prov`` (a thread), VEGAS on the card
(repeated bit for bit) against the CPU, the ensemble (8 seeds, its best flow
through the sampler, 64 runs, a group's epoch loop with host syncs made
errors, float64 against the CPU) and the profiling helpers.
Phase 16 drives data parallelism (``nf_tpu_torch.parallel``): on a world of
one over NCCL, ``sample``, ``integrate``, both trainers, unweighting and the
mixture under ``mesh=`` against their single-device runs (bit for bit where
the arithmetic is the same; the trainers at the default and at
``epochs_per_sync=1``), the sampler's per-rank counter offsets against one
launch, two ranks on the card over gloo against one process, and the paired
times of the mesh paths and the collectives a minibatch makes.
Every trainer call that passes no ``epochs_per_sync`` runs the default,
``"auto"``: chunks of epochs, each epoch and each statistics refresh a
replayed CUDA graph, the optimizer's step the update kernel
(``ops/csrc/optim_step.cu``).  Phase 17 holds that cadence against the
per-epoch run (``epochs_per_sync=1``, torch's own optimizer step) bit for
bit: the camel trainers (Adamax and Adam), bench.py's stale stages at
``epochs_per_sync=6`` (and the same chunk run eagerly), stops inside a
chunk; then paired epoch times and device profiles, and the update kernel
against torch's Adamax / Adam step and its plain version at the parameter
shapes of four plans, timed beside torch's steps.
Phase 18 is the per-op cost calibration (nf_tpu_torch/tools/calibrate_ops.py,
the counterpart of tools/calibrate_vpu_ops.py): the op-chain kernel
(``ops/csrc/op_chain.cu``) against its plain version for the ten ops, at
the checks' size and at the calibration's, two launches bit for bit; the
calibration at grid 1024 and K 64 / 320, each op's cost in FMA units and
SASS instructions per step (the fma, mul and add chains one FFMA, FMUL,
FADD a step); the flow kernels' op mix priced at those costs beside their
bounds; and the fma chain's time beside its plain version's and its bound.
Phase 19 holds the bin-axis scan (``ops/csrc/bin_scan.cu``) against its own
order of adds bit for bit and against its plain version at the camel2d,
zzmc and zz4l scan shapes, in float32 and float64, forward and reversed,
and times it beside its bound, its plain version and ``torch.cumsum``, with
the wrapper's host time a call.
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
import warnings


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


def op_mix(pt, flow, kernel):
    """Per sample of ``flow``, the transcendentals and divisions one launch
    of ``kernel`` runs, as written in csrc/flow_plan.cuh and
    csrc/pwquad_train.cu for exp-positivity pwquad cells with nb bins, per
    transformed dimension: the forward (sampler, training forward)
    ``2 nb + 1`` expf and ``2 nb + 2`` IEEE divisions; the backward's
    recompute and VJP ``5 nb + 3`` expf and ``3 nb + 5`` divisions.
    ``{"flops", "expf", "div"}``, with ``kernel_work``'s FLOPs (an expf or
    a division one FLOP there); None for a plan with other cells."""
    flops = kernel_work(pt, flow, kernel, 1)[0]
    n_exp = n_div = 0
    for cfg in flow.cells:
        if cfg.kind != "pwquad" or cfg.activation != "exp":
            return None
        t, nb = flow.n_flow - cfg.pass_through, cfg.n_bins
        e, d = (5 * nb + 3, 3 * nb + 5) if kernel == "bwd" else (2 * nb + 1, 2 * nb + 2)
        n_exp, n_div = n_exp + t * e, n_div + t * d
    return {"flops": flops, "expf": n_exp, "div": n_div}


def op_model_ms(mix, n, sec_per_op):
    """The time ``n`` samples of ``mix`` take at the measured per-op costs
    (``sec_per_op[op]``, seconds per op per element): expf and divisions
    at theirs, the rest of the FLOPs at one fma per two FLOPs.  An op model,
    not a bound: the FP32 pipe and the special-function unit overlap."""
    rest = (mix["flops"] - mix["expf"] - mix["div"]) / 2
    per = (rest * sec_per_op["fma"] + mix["expf"] * sec_per_op["exp"]
           + mix["div"] * sec_per_op["div"])
    return n * per * 1e3


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

    from nf_tpu_torch.utils import profiling

    for attempt in range(3):
        with profiling.device_profile() as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # the device's own records (kernels, copies, memsets), summed by
        # name from the tracer's raw events: key_averages() builds a Python
        # object per event (minutes on a training chunk) and has shown fewer
        # device operations than the trace holds.  An annotated range's span
        # on the device (the optimizer step's) is left out: it repeats the
        # kernels inside it
        rows, recorded, launched = {}, set(), set()
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
                us, n = rows.get(e.name(), (0.0, 0))
                rows[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
                recorded.add(e.correlation_id())
            elif e.device_type() == DeviceType.CPU and e.name().startswith(
                    ("cudaLaunch", "cudaGraphLaunch", "cudaMemcpy", "cudaMemset")):
                launched.add(e.correlation_id())
        # the launches (kernels, graphs, copies, memsets) whose device
        # record the trace lacks; a launch made while a CUDA graph is
        # captured runs nothing and has none
        lost = len(launched - recorded)
        if rows:
            break
        # kineto drops a device record whose timestamp, moved onto the
        # host's clock, falls before the trace's window: one ToyPDF call
        # late in this script came back with none.  The port's
        # device_profile records after a warm-up step and a lead, which
        # keep the records in (utils/profiling.py, PERF.md section 6)
        print(f"{tag} {what}: the tracer returned no device record (try {attempt + 1}); "
              "profiling the call again")
    total = sum(us for us, _ in rows.values())
    launches = sum(n for _, n in rows.values())
    check(total > 0, f"{what} profile shows device time")
    print(f"{tag} {what} under the profiler: device {total / 1e3:.3f} ms of "
          f"{wall * 1e3:.3f} ms wall (busy {total / 1e6 / wall:.1%}), {launches} device "
          f"operations (kernels and copies); {lost} of {len(launched)} launches without a "
          f"device record (captures included) {card}")
    for name, (us, n) in sorted(rows.items(), key=lambda r: -r[1][0])[:6]:
        print(f"{tag}   {us / 1e3:.3f} ms ({us / total:.1%}) x{n} {name[:90]}")
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
    ps.LAUNCHES = ps.SAMPLER_TILED_LAUNCHES = pt.FWD_LAUNCHES = pt.BWD_LAUNCHES = 0
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
    check(ps.SAMPLER_TILED_LAUNCHES == launches[0],
          f"zz: {ps.SAMPLER_TILED_LAUNCHES} of {launches[0]} sampler launches tiled")
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


# ---- phase 14: the ZZ/Z' multi-channel path of examples/zz_multichannel.py:
# same-flavour 4 leptons at 2000 GeV with a Z pair in (01)(23) and a Z' pair
# in (03)(12), two decay-tree channels with Breit-Wigner maps, ToyPDF, cuts
MZP, GZP = 250.0, 12.0
E_MC = 2000.0
# the shared flow: create_model(4, 16, [32, 32], identity_init=True,
# final_rank=4) on n_flow 11 at the example's production batch, one
# minibatch, epochs cut from 300
MC_BATCH, MC_BATCH_EPOCHS, MC_STALE_EPOCHS = 1 << 20, 5, 4
# the learned mixture at the example's production sizes, epochs cut from
# 300; the resume check at tools/tune_multichannel.py's 2^17 per channel
MC_PER_CHANNEL, MC_MB, MC_EPOCHS, MC_EPOCHS_PER_CALL = 1 << 19, 1 << 16, 12, 4
MC_RESUME_PER_CHANNEL, MC_RESUME_EPOCHS = 1 << 17, 4
# global-max unweighting (0.3% efficient) draws fewer events than the others
MC_EVENTS, MC_EVENTS_GLOBAL, MC_UNW_BATCH = 20_000, 5_000, 1 << 15
# phase 14's other sizes: the sampler check's, the training kernels', the
# uniform MC's (N_MC_UNIFORM x 8), the stratified sample's per channel
N_MC_SAMPLER, N_MC_TRAIN, N_MC_UNIFORM, N_MC_SAMPLE = 1 << 20, 1 << 18, 1 << 20, 1 << 19


def mc_physics():
    """``(channels, matrix_element)`` of examples/zz_multichannel.py:47-90."""
    from nf_tpu_torch.phasespace import lorentz
    from nf_tpu_torch.phasespace.pdf import ToyPDF
    from nf_tpu_torch.phasespace.topology import BreitWignerSMap, ResonanceDecayPhasespace

    def bw(s, m, g):
        return 1e4 / ((s - m * m) ** 2 + (m * g) ** 2)

    def matrix_element(momenta):
        f = momenta[:, 2:, :]

        def s(i, j):
            return lorentz.square(f[:, i] + f[:, j])

        return (bw(s(0, 1), MZ, GZ) * bw(s(2, 3), MZ, GZ)
                + 5e3 * bw(s(0, 3), MZP, GZP) * bw(s(1, 2), MZP, GZP))

    common = dict(pdf=ToyPDF(), pdf_active=True, tau=True)
    channels = [ResonanceDecayPhasespace([0.0, 0.0], [0.0] * 4, pairs,
                                         mass_maps={p: BreitWignerSMap(m, g) for p in pairs},
                                         **common)
                for pairs, m, g in ((((0, 1), (2, 3)), MZ, GZ), (((0, 3), (1, 2)), MZP, GZP))]
    return channels, matrix_element


def phase14(dev, card, gen, hold_train, perturb_bn):
    """The ZZ/Z' multi-channel path: the shared flow on the fixed-alpha
    integrand through the kernels, then the learned mixture (per-channel
    flows, their trainer, stratified sampling, multi-channel unweighting,
    checkpoints and LHE output).  Returns ``(launches, errors)`` as
    :func:`phase13` does, with the mixture's launches of the bin-axis scan
    after the three flow kernels' in ``launches``."""
    import tempfile

    import numpy as np
    import torch

    from nf_tpu_torch import PWQuadManager
    from nf_tpu_torch.flows import factory
    from nf_tpu_torch.flows.fast_eval import make_folded_forward
    from nf_tpu_torch.ops import pwquad_sampler as ps
    from nf_tpu_torch.ops import pwquad_train as pt
    from nf_tpu_torch.phasespace import lorentz
    from nf_tpu_torch.phasespace.topology import multichannel_integrand, optimize_alphas
    from nf_tpu_torch.training import multichannel as mc
    from nf_tpu_torch.training import optimizers
    from nf_tpu_torch.utils import profiling
    from nf_tpu_torch.utils.lhe import read_lhe, write_lhe

    def pb(v):
        return v / GEV2_TO_PB

    channels, me = mc_physics()
    cuts = ZZ_CUTS
    alphas, a_hist = optimize_alphas(me, channels, [0.5, 0.5], E_MC,
                                     torch.Generator(device=dev).manual_seed(1), n_iter=4,
                                     n_samples=1 << 15, **cuts)
    g = multichannel_integrand(me, channels, alphas, E_MC, **cuts)
    n_flow = 1 + channels[0].nDimPhaseSpace() + 2
    print(f"phase14 Kleiss-Pittau alphas {np.round(alphas, 4).tolist()} (variance "
          f"{a_hist[0]['variance']:.3e} -> {a_hist[-1]['variance']:.3e})")

    # ---- first half: the shared flow through the kernels
    NF = PWQuadManager(n_flow=n_flow, seed=0, device=dev)
    NF.create_model(4, 16, [32] * 2, identity_init=True, final_rank=4)
    train_kw = dict(log=False, batch_size=MC_BATCH, mini_batch_size=MC_BATCH,
                    pretty_progressbar=False, integrate=False, preburn_time=0, kill_counter=50,
                    loss_mode="kl", select_best_by="ess")
    ps.LAUNCHES = ps.SAMPLER_TILED_LAUNCHES = pt.FWD_LAUNCHES = pt.BWD_LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    NF._train_variance_forward_seq(g, optimizers.adamax(2e-3, 1e-4), epochs=MC_BATCH_EPOCHS,
                                   **train_kw)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    batch_ran = NF._last_epoch + 1
    t0 = time.perf_counter()
    NF._train_variance_forward_seq(g, optimizers.adamax(2e-3, 1e-4), epochs=MC_STALE_EPOCHS,
                                   bn_stats="stale", stats_every=4, **train_kw)
    torch.cuda.synchronize()
    stale_s = time.perf_counter() - t0
    stale_ran = NF._last_epoch + 1
    x_s, jac_s = NF.sample(1 << 17, seed=5)
    sig, err = NF.integrate(g, 8, 1 << 17, seed=11, combine="mean")
    torch.cuda.synchronize()
    launches = (ps.LAUNCHES, pt.FWD_LAUNCHES, pt.BWD_LAUNCHES)
    wf = g(x_s) * jac_s
    ess_flow = float(wf.mean() ** 2 / (wf ** 2).mean())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"phase14 shared flow (n_flow {n_flow}, {len(NF._flow.cells)} cells, rank 4): "
          f"{batch_ran} batch epochs in {batch_s:.2f} s ({batch_s / batch_ran * 1e3:.1f} "
          f"ms/epoch), "
          f"{stale_ran} stale epochs in {stale_s:.2f} s ({stale_s / stale_ran * 1e3:.1f} "
          f"ms/epoch), batch 2^20 in one minibatch, host clock; sample(2^17) ESS {ess_flow:.5f}; "
          f"integrate(8, 2^17) = {pb(sig):.5f} +- {pb(err):.5f} pb; launches sampler "
          f"{launches[0]} fwd {launches[1]} bwd {launches[2]}; peak memory {peak:.2f} GiB {card}")
    check(launches == (1 + 8, stale_ran + (stale_ran - 1) // 4 + 1, stale_ran),
          f"shared flow launched sampler/fwd/bwd {launches}")
    check(ps.SAMPLER_TILED_LAUNCHES == launches[0],
          f"shared flow: {ps.SAMPLER_TILED_LAUNCHES} of {launches[0]} sampler launches tiled")
    check(x_s.shape == (1 << 17, n_flow) and bool(torch.isfinite(jac_s).all())
          and bool(torch.isfinite(wf).all()), "shared flow sample() output")

    # the three kernels against their plain versions on this plan: random
    # weights and BatchNorm statistics, then the trained model
    errors = [0.0, 0.0, 0.0]
    model_r = perturb_bn(factory.build_pwquad_flow(gen, n_flow, 4, 16, (32, 32), device=dev,
                                                   final_rank=4))
    flow = model_r.flow
    for what, model in (("random weights", model_r), ("trained", NF.best_model)):
        w = torch.rand((N_MC_SAMPLER, n_flow), generator=gen, device=dev)
        x_k, jac_k = ps.build_sampler(flow, model, take_latents=True)(w)
        x_p, jac_p = make_folded_forward(flow, model)(w)
        torch.cuda.synchronize()
        err_x = float((x_k - x_p).abs().max())
        err_j = float(((jac_k - jac_p) / jac_p).abs().max())
        errors[0] = max(errors[0], err_x)
        print(f"phase14 sampler, {what}, operand latents 2^20: max|dx|={err_x:.3e} "
              f"max|djac/jac|={err_j:.3e}")
        check(torch.allclose(x_k, x_p, rtol=1e-4, atol=2e-5), f"{what} sampler x vs plain")
        check(torch.allclose(jac_k, jac_p, rtol=1e-3, atol=0.0), f"{what} sampler jac vs plain")
    for what, model in (("random weights", model_r), ("trained stale", NF._model)):
        e_f, e_b = hold_train(f"mc {what} n=2^18", pt.TrainPlan(model.flow),
                              pt.fold_flow(model).detach(),
                              torch.rand((N_MC_TRAIN, n_flow), generator=gen, device=dev),
                              tag="phase14")
        errors[1], errors[2] = max(errors[1], e_f), max(errors[2], e_b)
    # their times on this plan (random weights), beside the plain versions
    # and the bounds
    plan = pt.TrainPlan(flow)
    flat = pt.fold_flow(model_r).detach()
    plan.descriptor(dev)
    seeded = ps.build_sampler(flow, model_r, layout="dim_major")
    plain = make_folded_forward(flow, model_r)
    w = torch.rand((N_MC_SAMPLER, n_flow), generator=gen, device=dev)
    w_t = torch.rand((N_MC_TRAIN, n_flow), generator=gen, device=dev)
    xbar = 0.3 * torch.randn((N_MC_TRAIN, n_flow), generator=gen, device=dev)
    jbar = torch.randn(N_MC_TRAIN, generator=gen, device=dev)
    _, jac, stage = pt.train_forward(plan, flat, w_t)
    flat_g, w_g = flat.clone().requires_grad_(True), w_t.clone().requires_grad_(True)
    outs = pt.folded_forward_ref(flow, flat_g, w_g)
    kernel_t = {
        "sampler": (N_MC_SAMPLER, time_ms(lambda: seeded(7, N_MC_SAMPLER)),
                    time_ms(lambda: plain(w))),
        "fwd": (N_MC_TRAIN, time_ms(lambda: pt.train_forward(plan, flat, w_t)),
                time_ms(lambda: pt.folded_forward_ref(flow, flat, w_t))),
        "bwd": (N_MC_TRAIN, time_ms(lambda: pt.train_backward(plan, flat, stage, jac, jbar, xbar,
                                                              latents=w_t)),
                time_ms(lambda: torch.autograd.grad(outs, (flat_g, w_g), (xbar, jbar),
                                                    retain_graph=True))),
    }
    del outs
    print(f"phase14 plan launches (block, weights in shared memory): sampler "
          f"{ps.SamplerPlan(flow).config}, forward {plan.fwd_config[False]}, backward "
          f"{plan.bwd_config}")
    for kernel, (n_k, ms, plain_ms) in kernel_t.items():
        flops, nbytes = kernel_work(pt, flow, kernel, n_k)
        b_ms, b_by = bound_ms(flops, nbytes)
        print(f"phase14 plan {kernel} n={n_k}: {ms:.4f} ms (plain {plain_ms:.4f} ms), bound "
              f"{b_ms:.5f} ms by {b_by} ({flops / n_k:.0f} FLOP and {nbytes / n_k:.1f} B per "
              f"sample), {b_ms / ms:.2%} of the bound {card}")

    # the reference integral: uniform latents through the fixed-alpha
    # integrand, float64
    tot, tot2, n_u = 0.0, 0.0, 8 * N_MC_UNIFORM
    for _ in range(8):
        v = g(torch.rand((N_MC_UNIFORM, n_flow), generator=gen, device=dev,
                         dtype=torch.float64))
        tot += float(v.sum())
        tot2 += float((v ** 2).sum())
    sig_u = tot / n_u
    err_u = math.sqrt(max(tot2 / n_u - sig_u ** 2, 0.0) / n_u)
    print(f"phase14 uniform MC of the fixed-alpha integrand, 8 x 2^20 float64: "
          f"{pb(sig_u):.5f} +- {pb(err_u):.5f} pb, ESS {sig_u ** 2 / (tot2 / n_u):.5f}")

    def agrees(s, e):
        return math.isfinite(s) and e > 0 and \
            abs(s - sig_u) <= 5 * math.hypot(e, err_u) + 0.01 * abs(sig_u)

    check(agrees(sig, err), "shared-flow integrate vs uniform MC")

    # ---- second half: the learned mixture, plain torch and the bin-axis scan
    # (no flow kernel)
    ps.LAUNCHES = pt.FWD_LAUNCHES = pt.BWD_LAUNCHES = 0
    scans_before = profiling.BIN_SCAN_LAUNCHES
    models = mc.build_channel_flows(torch.Generator(device=dev).manual_seed(0), channels, 4, 16,
                                    [32] * 2, final_rank=4, device=dev)
    # the scans of one pass of a flow, forward or inverse: two a pwquad cell
    # (its bin edges and its trapezoid CDF), and as many reversed in a
    # pass's backward
    scans_a_pass = 2 * len(models[0].flow.cells)
    buffers = [{k: b.clone() for k, b in m.named_buffers()} for m in models]
    opt = optimizers.adamax(5e-3, 1e-4)
    kw = dict(alphas=list(alphas), loss_mode="kl", **cuts)

    def train(per_channel, epochs, epochs_per_call, seed=3, **extra):
        return mc.train_multichannel(channels, models, me, E_MC, opt,
                                     torch.Generator(device=dev).manual_seed(seed),
                                     batch_per_channel=per_channel,
                                     mini_batch_per_channel=min(per_channel, MC_MB),
                                     epochs=epochs, epochs_per_call=epochs_per_call,
                                     **kw, **extra)

    with tempfile.TemporaryDirectory() as tmp:
        # the first chunk (the pilot and 4 epochs) under the profiler, stopped
        # there; the other chunks resumed from its checkpoint, host clock
        path = os.path.join(tmp, "mc.pt")
        torch.cuda.reset_peak_memory_stats()
        prof_ms, prof_ops = device_profile(
            "phase14", f"train_multichannel's first chunk (pilot + {MC_EPOCHS_PER_CALL} epochs "
            "of 2 x 2^19 in 8 minibatches)",
            lambda: train(MC_PER_CHANNEL, MC_EPOCHS, MC_EPOCHS_PER_CALL, save_state=path,
                          stop_after_chunks=1), card)
        torch.cuda.synchronize()
        scans0 = profiling.BIN_SCAN_LAUNCHES
        t0 = time.perf_counter()
        out = train(MC_PER_CHANNEL, MC_EPOCHS, MC_EPOCHS_PER_CALL, save_state=path,
                    resume_from=path)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        # resumed, so no pilot: each minibatch draws C source channels
        # (forward, no gradient) and takes C^2 flow inverses with their
        # backward
        n_rest, C = MC_EPOCHS - MC_EPOCHS_PER_CALL, len(channels)
        scans = profiling.BIN_SCAN_LAUNCHES - scans0
        want = n_rest * (MC_PER_CHANNEL // MC_MB) * (C + 2 * C * C) * scans_a_pass
        print(f"phase14 train_multichannel's {n_rest} resumed epochs launched the bin-axis "
              f"scan {scans} times ({scans / n_rest:.0f} an epoch; derived {want}: "
              f"{scans_a_pass} scans a pass)")
        check(scans == want, f"the mixture's scans launch bin_scan: {scans} of {want}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        h = out["history"]
        print(f"phase14 train_multichannel: {MC_EPOCHS} epochs of 2 x 2^19 in minibatches of "
              f"2 x 2^16 (chunks of {MC_EPOCHS_PER_CALL}, checkpointed); the first chunk "
              f"profiled ({prof_ms / MC_EPOCHS_PER_CALL:.1f} ms of device time and "
              f"{prof_ops // MC_EPOCHS_PER_CALL} device operations per epoch, pilot included), "
              f"the other {n_rest} epochs resumed in {train_s:.2f} s = "
              f"{train_s / n_rest * 1e3:.1f} ms/epoch (host clock, synchronized; checkpoints "
              f"included); peak memory {peak:.2f} GiB {card}")
        print(f"phase14 train_multichannel ESS by epoch {np.round(h['ess'], 5).tolist()}; best "
              f"{out['best_ess']:.5f}; best alphas {np.round(out['best_alphas'], 4).tolist()}")
        check(len(h["ess"]) == MC_EPOCHS, "resumed history holds every epoch")
        for name in ("loss", "integral", "ess", "alphas"):
            check(bool(np.isfinite(h[name]).all()), f"train_multichannel history {name} finite")
        for m in out["params"] + out["best_params"]:
            check(all(bool(torch.isfinite(p).all()) for p in m.parameters()),
                  "trained flows' weights finite")
        for m, before in zip(out["params"] + out["best_params"], buffers + buffers):
            check(all(torch.equal(b, before[k]) for k, b in m.named_buffers()),
                  "BatchNorm buffers unchanged by training")
        check(out["best_ess"] > h["ess"][0],
              f"best ESS {out['best_ess']} above epoch 0's {h['ess'][0]}")
        a_all = np.concatenate([h["alphas"], out["best_alphas"][None]])
        check(bool(np.allclose(a_all.sum(1), 1.0, atol=1e-5)) and float(a_all.min()) >= 1e-2,
              f"alphas sum to 1, each >= alpha_floor (min {a_all.min()})")

        # the gradient at the best parameters: every channel's, finite
        best = out["best_params"]
        w_g, aux_g = mc.mixture_weights(channels, best, me, E_MC,
                                        torch.Generator(device=dev).manual_seed(13), MC_MB,
                                        out["best_alphas"], **cuts)
        mc._loss("kl", w_g, aux_g, w_g.detach().max(),
                 torch.as_tensor(out["best_alphas"], dtype=torch.float32, device=dev)).backward()
        grads = [p.grad for m in best for p in m.parameters()]
        check(all(gr is not None and bool(torch.isfinite(gr).all()) for gr in grads),
              "kl loss gradient at the best flows finite")
        print(f"phase14 kl gradient at the best flows, 2 x 2^16: {len(grads)} tensors finite, "
              f"max |g| {max(float(gr.abs().max()) for gr in grads):.3e}")
        for m in best:
            m.zero_grad(set_to_none=True)

        # resume: stopped after its first chunk and resumed, against the
        # uninterrupted run
        full = train(MC_RESUME_PER_CHANNEL, MC_RESUME_EPOCHS, 2)
        path = os.path.join(tmp, "resume.pt")
        train(MC_RESUME_PER_CHANNEL, MC_RESUME_EPOCHS, 2, save_state=path, stop_after_chunks=1)
        res = train(MC_RESUME_PER_CHANNEL, MC_RESUME_EPOCHS, 2, resume_from=path)
        same = all(np.array_equal(full["history"][k], res["history"][k]) for k in full["history"])
        worst = max(float(np.max(np.abs(res["history"][k] - full["history"][k])
                                 / np.maximum(np.abs(full["history"][k]), 1e-30)))
                    for k in full["history"])
        same_params = [state_digest(m) for m in full["params"]] == \
            [state_digest(m) for m in res["params"]]
        print(f"phase14 resume (2 x 2^17, 4 epochs in chunks of 2, stopped after 1): history "
              f"{'bit-identical' if same else 'not bit-identical'} to the uninterrupted run, "
              f"max rel diff {worst:.3e}; flows {'bit-identical' if same_params else 'differ'}")
        check(same and same_params, "resumed history and flows bit-identical to the "
              "uninterrupted run")

        # stratified sample at the best flows (the training batch): the
        # integral and ESS, and the cross section on and off the Z in (01)
        def on_z(momenta):
            s01 = lorentz.square(torch.as_tensor(momenta[..., 2, :] + momenta[..., 3, :]))
            return (torch.abs(torch.sqrt(torch.clamp_min(s01, 0.0)) - MZ) < 5 * GZ).double()

        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            w_s, aux_s = mc.multichannel_sample(channels, best, me, E_MC,
                                                torch.Generator(device=dev).manual_seed(5),
                                                N_MC_SAMPLE, out["best_alphas"],
                                                with_kinematics=True, **cuts)
        z_s = on_z(aux_s["momenta"])
        w_s = w_s.double()
        sig_mc, err_mc, ess_mc = (float(v) for v in mc.combine_stratified(w_s, out["best_alphas"]))
        strat_z = [tuple(float(v) for v in mc.combine_stratified(w_s * part,
                                                                 out["best_alphas"])[:2])
                   for part in (z_s, 1 - z_s)]
        del aux_s, z_s
        print(f"phase14 learned mixture: multichannel_sample(2 x 2^19) = {pb(sig_mc):.5f} +- "
              f"{pb(err_mc):.5f} pb, ESS {ess_mc:.5f} (shared flow {ess_flow:.5f}); on the Z in "
              f"(01) {pb(strat_z[0][0]):.5f} +- {pb(strat_z[0][1]):.5f} pb, off it "
              f"{pb(strat_z[1][0]):.5f} +- {pb(strat_z[1][1]):.5f} pb; uniform MC "
              f"{pb(sig_u):.5f} +- {pb(err_u):.5f} pb")
        check(bool(torch.isfinite(w_s).all()), "mixture weights finite")
        check(agrees(sig_mc, err_mc), "learned-mixture integral vs uniform MC")
        ms = time_ms(lambda: mc.multichannel_sample(channels, best, me, E_MC, gen, MC_MB,
                                                    out["best_alphas"], **cuts))
        print(f"phase14 mixture_weights 2 x 2^16 without gradients: {ms:.3f} ms (CUDA events, "
              f"median of 11) {card}")
        device_profile("phase14", "one multichannel_sample(2 x 2^16)",
                       lambda: mc.multichannel_sample(channels, best, me, E_MC, gen, MC_MB,
                                                      out["best_alphas"], **cuts), card)

        # unweighting: global and per-channel maxima, then partial to LHE;
        # a numpy RuntimeWarning (overflow, 0/0) in the unweighters fails
        unw = dict(batch_per_channel=MC_UNW_BATCH, **cuts)
        for tag, pc, n_ev in (("global-max", False, MC_EVENTS_GLOBAL),
                              ("per-channel-max", True, MC_EVENTS)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with warnings.catch_warnings():
                warnings.simplefilter("error", RuntimeWarning)
                events, xbs, eff, n_over = mc.multichannel_unweight(
                    channels, best, me, E_MC, torch.Generator(device=dev).manual_seed(7),
                    out["best_alphas"], n_events=n_ev, wmax_quantile=0.9999,
                    per_channel_max=pc, **unw)
            unw_s = time.perf_counter() - t0
            print(f"phase14 unweighted [{tag}]: {len(events)} events in {unw_s:.3f} s = "
                  f"{len(events) / unw_s:.4e} events/s, efficiency {eff:.5f}, overweight "
                  f"{n_over} {card}")
            check(len(events) >= n_ev and events.shape[1:] == (6, 4)
                  and xbs.shape == (len(events), 2) and 0 < eff <= 1
                  and bool(np.isfinite(events).all()), f"{tag} unweighted events")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            events, xbs, wts, info = mc.multichannel_unweight(
                channels, best, me, E_MC, torch.Generator(device=dev).manual_seed(9),
                out["best_alphas"], n_events=MC_EVENTS, wmax_quantile=0.9, per_channel_max=True,
                partial_unweight=True, **unw)
        unw_s = time.perf_counter() - t0
        rate = np.asarray(out["best_alphas"], np.float64) * info["w_max"]
        print(f"phase14 partial per-channel unweighting (quantile 0.9): {len(events)} events in "
              f"{unw_s:.3f} s = {len(events) / unw_s:.4e} events/s, Kish efficiency "
              f"{info['eff']:.5f}, accept rate {info['accept_rate']:.5f}, overweight "
              f"{info['n_overweight']}, w_max {info['w_max'].tolist()}, thinning "
              f"{(rate / rate.max()).tolist()} {card}")
        check(len(events) >= MC_EVENTS and bool((wts >= 1.0).all()) and 0 < info["eff"] <= 1,
              "partial unweighted events")
        # every channel present: each round proposes B per live channel, and
        # channel k's accepted weights sum to alpha_k E_k[w] / R per proposal
        # (R = max_k alpha_k w_max_k), so sigma = R L sum(weights) / n_proposals
        # on and off the Z against the stratified sample's
        n_prop = round(len(wts) / info["accept_rate"])
        scale = rate.max() * np.count_nonzero(rate) / n_prop
        z_p = on_z(torch.from_numpy(events).double()).numpy()
        for (s_ref, e_ref), part, where in zip(strat_z, (z_p, 1 - z_p), ("on", "off")):
            y = wts * part
            s_p = scale * float(y.sum())
            e_p = scale * math.sqrt(max(float((y ** 2).sum()) - float(y.sum()) ** 2 / n_prop, 0.0))
            print(f"phase14 partial sample {where} the Z in (01): {pb(s_p):.5f} +- "
                  f"{pb(e_p):.5f} pb against the stratified sample's {pb(s_ref):.5f} +- "
                  f"{pb(e_ref):.5f} pb")
            check(np.all(rate > 0) and abs(s_p - s_ref) <= 5 * math.hypot(e_p, e_ref)
                  + 0.01 * sig_mc, f"partial sample's cross section {where} the Z vs stratified")
        lhe_path = os.path.join(tmp, "zz_multichannel.lhe")
        write_lhe(lhe_path, events, pdgs=[2, -2, 11, -11, 13, -13],
                  weights=wts / max(float(wts.mean()), 1e-300), xb=xbs, E_beam=E_MC / 2,
                  sigma_pb=pb(sig_mc), sigma_err_pb=pb(err_mc))
        back = read_lhe(lhe_path)
        lab = lorentz.boost_to_lab_frame(torch.from_numpy(events).double(),
                                         torch.from_numpy(xbs[:, 0]).double(),
                                         torch.from_numpy(xbs[:, 1]).double()).numpy()
        dev_rel = float(np.max(np.abs(back["momenta"] - lab) / (np.abs(lab) + lab[..., :1])))
        print(f"phase14 LHE round trip: {len(back['momenta'])} events, max |dp| / (|p| + E) "
              f"{dev_rel:.3e}, {os.path.getsize(lhe_path)} bytes")
        check(len(back["momenta"]) == len(events) and dev_rel <= 1e-6, "LHE round trip")
    second = (ps.LAUNCHES, pt.FWD_LAUNCHES, pt.BWD_LAUNCHES)
    scans = profiling.BIN_SCAN_LAUNCHES - scans_before
    print(f"phase14 learned mixture launched sampler/fwd/bwd {second} (no flow kernel) and "
          f"the bin-axis scan {scans} times")
    check(second == (0, 0, 0), "the learned mixture's path launches no flow kernel")
    check(scans > 0, "the learned mixture's path launches the bin-axis scan")
    return (*launches, scans), errors


# ---- phase 15: experiments and sweeps (the resume, the logger and
# checkpoints, the pro/prov sweep, VEGAS, the ensemble, profiling)
P15_CAMEL_BATCH, P15_CAMEL_EPOCHS = 10000, 40       # README camel, 40 + 40 against 80
P15_FLAG_BATCH, P15_FLAG_MINI, P15_FLAG_EPOCHS = 1 << 20, 1 << 18, 4   # bench.py:327-379
P15_SWEEP_EPOCHS, P15_VAR_N = 150, 1 << 20          # EPOCH_LENGTH cut to phase 5's 150
P15_VEGAS_NEVAL, P15_VEGAS_CHECK_N = 100_000, 20_000   # examples/camel2d.py
P15_ENS = (8, 8000, 60)                              # examples/production_features.py
P15_STRESS = (64, 10000, 40)                         # tools/ensemble_stress.py
P15_F64 = (4, 2000, 1000, 10)                        # runs, batch, minibatch, epochs
P15_INTEG_N, P15_N_TRAIN = 1 << 21, 1 << 18


def gauss10(x):
    import torch
    return torch.exp(-torch.sum((x - 0.5) ** 2, dim=1) / 0.2)


def pro_on_card(para):
    """The process-mode sweep worker: writes the device the child process
    sees beside its log, then runs ``pro`` with phase 15's epoch count."""
    import torch
    from nf_tpu_torch.utils import experiment
    experiment.EPOCH_LENGTH = P15_SWEEP_EPOCHS
    d = os.path.join(para["logdir"], str(para["id"]))
    os.makedirs(d, exist_ok=True)
    cuda = torch.cuda.is_available()
    with open(os.path.join(d, "device.json"), "w") as fh:
        json.dump({"cuda": cuda, "pid": os.getpid(),
                   "name": torch.cuda.get_device_name(0) if cuda else "cpu"}, fh)
    experiment.pro(para)


def state_digest(model):
    import hashlib
    h = hashlib.sha256()
    for name, t in model.state_dict().items():
        h.update(name.encode())
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def phase15(dev, card, kind, hold_train):
    """Experiments and sweeps on the card: checks 1-6 (``phase15 check N``).
    Returns ``(launches, errors)`` as :func:`phase13` does."""
    import copy
    import tempfile

    import numpy as np
    import torch

    from nf_tpu_torch import PWQuadManager, interop
    from nf_tpu_torch.flows import factory
    from nf_tpu_torch.flows.fast_eval import make_folded_forward
    from nf_tpu_torch.ops import pwquad_sampler as ps
    from nf_tpu_torch.ops import pwquad_train as pt
    from nf_tpu_torch.training import ensemble, metrics, optimizers, vegas
    from nf_tpu_torch.utils import experiment, profiling
    from nf_tpu_torch.utils.sweep import RESULT_FIELDS, run_sweep

    exact = camel_exact()
    t_phase = time.perf_counter()
    tmp_dir = tempfile.TemporaryDirectory(prefix="phase15_")
    tmp = tmp_dir.name

    def gate(sig, err):
        return math.isfinite(sig) and err > 0 and abs(sig - exact) <= 5 * err + 0.01 * exact

    class Run(metrics.MemoryLogger):
        _id = 15

    def counts():
        return (ps.LAUNCHES, pt.FWD_LAUNCHES, pt.BWD_LAUNCHES)

    def delta(before):
        return tuple(a - b for a, b in zip(counts(), before))

    ps.LAUNCHES = pt.FWD_LAUNCHES = pt.BWD_LAUNCHES = 0
    torch.cuda.synchronize()

    # ---- check 1: stop and resume against the uninterrupted run
    def train(n_flow, model, f, bn_stats, epochs, batch, mini, epoch_start=0, resume_from=None,
              **extra):
        NF = PWQuadManager(n_flow=n_flow, seed=0, device=dev)
        NF.create_model(*model[0], **model[1])
        kw = dict(log=False, batch_size=batch, mini_batch_size=mini, pretty_progressbar=False,
                  integrate=n_flow == 2, preburn_time=10 if n_flow == 2 else 0,
                  kill_counter=1000, bn_stats=bn_stats, stats_every=4)
        kw.update(extra)
        t0 = time.perf_counter()
        NF._train_variance_forward_seq(f, optimizers.adamax(2e-3, 1e-4), epochs=epochs,
                                       epoch_start=epoch_start, resume_from=resume_from, **kw)
        torch.cuda.synchronize()
        return NF, time.perf_counter() - t0

    camel_model = ((2, 4, [3] * 3), {})
    flag_model = ((8, 8, [16, 16]), {"final_rank": 4})
    resumed, log_run = {}, Run()
    # each at the default cadence, and the camel stale run at
    # epochs_per_sync=1 too (the per-epoch path's save and resume_from)
    for tag, n_flow, model, f, bn_stats, epochs, batch, mini, cadence in (
            ("camel stale", 2, camel_model, camel, "stale", P15_CAMEL_EPOCHS, P15_CAMEL_BATCH,
             P15_CAMEL_BATCH, {}),
            ("camel stale per-epoch", 2, camel_model, camel, "stale", P15_CAMEL_EPOCHS,
             P15_CAMEL_BATCH, P15_CAMEL_BATCH, {"epochs_per_sync": 1}),
            ("camel batch", 2, camel_model, camel, "batch", P15_CAMEL_EPOCHS, P15_CAMEL_BATCH,
             P15_CAMEL_BATCH, {}),
            ("flagship stale", 10, flag_model, gauss10, "stale", P15_FLAG_EPOCHS,
             P15_FLAG_BATCH, P15_FLAG_MINI, {})):
        logged = {"log": True, "logdir": os.path.join(tmp, "logdir"), "run": log_run} \
            if tag == "camel stale" else {}
        before = counts()
        whole, whole_s = train(n_flow, model, f, bn_stats, 2 * epochs, batch, mini, **logged,
                               **cadence)
        first, first_s = train(n_flow, model, f, bn_stats, epochs, batch, mini, **cadence)
        state = os.path.join(tmp, tag.replace(" ", "_") + ".pt")
        first.save_training_state(state)
        NF, resumed_s = train(n_flow, model, f, bn_stats, epochs, batch, mini, epoch_start=epochs,
                              resume_from=state, **cadence)
        launched = delta(before)
        resumed[tag] = (whole, NF)
        hist_err = float(np.max(np.abs(np.asarray(NF.history) / np.asarray(whole.history) - 1)))
        integ_err = float(np.max(np.abs(NF._integ_hist - whole._integ_hist)
                                 / np.maximum(np.abs(whole._integ_hist), 1e-30)))
        param_err = max(float((a - b).abs().max()) for a, b in zip(
            NF._model.state_dict().values(), whole._model.state_dict().values()))
        digests = [state_digest(m) for m in (whole.best_model, NF.best_model, whole._model,
                                             NF._model)]
        print(f"phase15 resume {tag}: {2 * epochs} epochs in {whole_s:.3f} s against {epochs} + "
              f"{epochs} resumed in {first_s:.3f} + {resumed_s:.3f} s (host clock); history "
              f"max rel diff {hist_err:.3e}, integral history {integ_err:.3e}, parameters max "
              f"|d| {param_err:.3e}; best/live digests {digests}; launches sampler/fwd/bwd "
              f"{launched} {card}")
        check(len(NF.history) == len(whole.history) == 2 * epochs, f"{tag} resumed history length")
        check(NF.history == whole.history and np.array_equal(NF._integ_hist, whole._integ_hist)
              and np.array_equal(NF._err_hist, whole._err_hist)
              and digests[0] == digests[1] and digests[2] == digests[3],
              f"{tag}: the resume equals the uninterrupted run bit for bit")
        if bn_stats == "stale":
            n_mb = batch // mini
            refreshes = (2 * epochs - 1) // 4 + 1 + (epochs - 1) // 4 + 1 + (epochs - 1) // 4 + 1
            check(launched == (0, 4 * epochs * n_mb + refreshes, 4 * epochs * n_mb),
                  f"{tag} launched sampler/fwd/bwd {launched}")
    print("phase15 check 1: the resumes equal the uninterrupted runs bit for bit (camel stale "
          "at the default and at epochs_per_sync=1, camel batch, flagship stale)")
    for tag in ("camel stale", "camel batch"):
        NF = resumed[tag][1]
        before = counts()
        sig, err = NF.integrate(camel, 8, P15_INTEG_N)
        print(f"phase15 resumed {tag} integrate(8, 2^21) = {sig:.7f} +- {err:.2e} (exact "
              f"{exact:.7f}, rel err {abs(sig - exact) / exact:.2e}); sampler launches "
              f"{delta(before)[0]}")
        check(gate(sig, err), f"resumed {tag} integral within 5 err + 1%")
        check(delta(before)[0] == 8, f"resumed {tag} integrate launches")

    # ---- check 2: the logdir and the run logger of the uninterrupted stale camel run
    whole = resumed["camel stale"][0]
    ckdir = os.path.join(tmp, "logdir", str(Run._id))
    sc = log_run.scalars
    check(sorted(os.listdir(ckdir)) == ["torch", "torch_int"],
          f"checkpoint files {os.listdir(ckdir)}")
    check([s for s, _ in sc["training.loss"]] == list(range(2 * P15_CAMEL_EPOCHS))
          and len(sc["training.loss_rel"]) == 2 * P15_CAMEL_EPOCHS
          and [v for _, v in sc["training.loss"]] == whole.history
          and sc["training.int_loss"] == [(0, whole.int_loss)]
          and sc["training.integ"] == [(0, whole.integ_tot)]
          and sc["training.err"] == [(0, whole.err_tot)], "the run logger's scalars")
    fresh = PWQuadManager(n_flow=2, seed=7, device=dev)
    fresh.create_model(2, 4, [3] * 3)
    meta = fresh.load_checkpoint(os.path.join(ckdir, "torch"))
    before = counts()
    a = fresh.integrate(camel, 4, P15_INTEG_N, seed=5)
    b = whole.integrate(camel, 4, P15_INTEG_N, seed=5)
    check(delta(before)[0] == 8, "load_checkpoint integrals launch the sampler")
    print(f"phase15 check 2: {ckdir} holds torch_int and torch; logger "
          f"{ {k: len(v) for k, v in sc.items()} }; load_checkpoint meta {meta}; "
          f"integrate(4, 2^21, seed=5) {a} from the checkpoint, {b} from the trained manager")
    check(a == b and meta["best_epoch"] == whole.best_epoch, "load_checkpoint's model integrates "
          "as the trained manager's best model")

    # ---- check 3: the sweep (pro sequential x2, prov in a thread, pro in a process)
    sweep_dir = os.path.join(tmp, "sweep")
    base = {"n_flow": 2, "n_bins": 4, "NN_width": 3, "NN_length": 3, "dev": 0, "lr": 2e-3,
            "weight_decay": 1e-4, "var_n": P15_VAR_N, "batch_size": 10000, "pt": 50,
            "f": camel, "logdir": sweep_dir, "log": False, "device": str(dev)}
    old_len = experiment.EPOCH_LENGTH
    experiment.EPOCH_LENGTH = P15_SWEEP_EPOCHS
    try:
        before = counts()
        t0 = time.perf_counter()
        results = run_sweep([dict(base, id=0, seed=0), dict(base, id=1, seed=1)])
        seq_s = time.perf_counter() - t0
        sweep_launches = delta(before)
    finally:
        experiment.EPOCH_LENGTH = old_len
    t0 = time.perf_counter()
    results += run_sweep([dict(base, id=2, worker=experiment.prov)], mode="thread")
    thread_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    results += run_sweep([dict(base, id=3, seed=2, worker=pro_on_card)], mode="process")
    proc_s = time.perf_counter() - t0
    with open(os.path.join(sweep_dir, "3", "device.json")) as fh:
        child = json.load(fh)
    print(f"phase15 sweep (pro epochs cut to EPOCH_LENGTH = {P15_SWEEP_EPOCHS}, phase 5's count): "
          f"sequential 2 x pro {seq_s:.2f} s (sampler launches {sweep_launches[0]}), thread prov "
          f"{thread_s:.2f} s, process pro {proc_s:.2f} s (host clock; child pid {child['pid']} on "
          f"{child['name']}) {card}")
    for r in sorted(results, key=lambda r: r["id"]):
        sig, err = r["sigma_pb"] * GEV2_TO_PB, r["sigma_err_pb"] * GEV2_TO_PB
        print(f"phase15 sweep id {r['id']} {r['method']}: sigma {sig:.7f} +- {err:.2e} (exact "
              f"{exact:.7f}), {r['duration_s']:.2f} s, func_count {r['func_count']}, best epoch "
              f"{r['best_epoch']}, final variance {r['final_variance']:.4e}")
        check(set(r) == set(RESULT_FIELDS) and os.path.exists(
            os.path.join(sweep_dir, str(r["id"]), "log.txt")), f"sweep id {r['id']} decoded")
        check(gate(sig, err), f"sweep id {r['id']} sigma within 5 err + 1%")
    check(sorted((r["id"], r["method"]) for r in results)
          == [(0, "NIS"), (1, "NIS"), (2, "VEGAS"), (3, "NIS")], "the sweep's four results")
    check(child["cuda"] and child["name"] == kind and child["pid"] != os.getpid(),
          f"the process-mode child ran on the card: {child}")
    check(sweep_launches[0] == 2 * 11, f"sequential pro launched the sampler "
          f"{sweep_launches[0]} times, not 2 x (sample + 10 integrate)")
    print("phase15 check 3: every sweep result decoded into RESULT_FIELDS with its log.txt; "
          "NIS and VEGAS sigmas within their gates; the process-mode child reported the card")

    # ---- check 4: VEGAS, examples/camel2d.py's baseline
    integ = vegas.VegasIntegrator(2, n_bins=50, seed=0, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v_mean, v_sdev = integ.run(camel, nitn=10, neval=P15_VEGAS_NEVAL)
    vegas_s = time.perf_counter() - t0
    print(f"phase15 VEGAS(2, 50 bins).run(camel, 10 x {P15_VEGAS_NEVAL}) = {v_mean:.7f} +- "
          f"{v_sdev:.2e} (exact {exact:.7f}) in {vegas_s * 1e3:.2f} ms, "
          f"{vegas_s * 1e2:.3f} ms per iteration (host clock, one read at the end) {card}")
    check(gate(v_mean, v_sdev), "VEGAS within 5 sdev + 1%")
    again = vegas.VegasIntegrator(2, n_bins=50, seed=0, device=dev)
    check(again.run(camel, nitn=10, neval=P15_VEGAS_NEVAL) == (v_mean, v_sdev)
          and torch.equal(again.edges, integ.edges), "VEGAS repeated bit for bit on the card")
    cpu_gen = torch.Generator().manual_seed(21)
    draws = [torch.rand((P15_VEGAS_CHECK_N, 2), generator=cpu_gen, dtype=torch.float64)
             for _ in range(6)]
    sides = ([], [])
    hook = vegas._uniform
    try:
        for where, edges in zip((dev, torch.device("cpu")), sides):
            feed = iter(draws)
            vegas._uniform = lambda g, shape, dtype, device: next(feed).to(device)
            v = vegas.VegasIntegrator(2, n_bins=50, seed=0, dtype=torch.float64, device=where)
            for _ in range(len(draws)):
                v.run(camel, nitn=1, neval=P15_VEGAS_CHECK_N)
                edges.append(v.edges.cpu())
    finally:
        vegas._uniform = hook
    edge_err = max(float((a - b).abs().max()) for a, b in zip(*sides))
    print(f"phase15 check 4: VEGAS within its gate and repeated bit for bit; float64 edges on "
          f"the card against the CPU on the same draws, max |d| over 6 iterations "
          f"{edge_err:.3e}")
    check(edge_err <= 1e-10, "VEGAS float64 edges cuda vs cpu within 1e-10")

    # ---- check 5: the ensemble
    n_runs, batch, epochs = P15_ENS
    flow, P, B = ensemble.stack_ensemble(lambda g: factory.build_pwquad_flow(
        g, 2, 4, 4, (3, 3, 3), device=dev), torch.Generator(device=dev).manual_seed(3), n_runs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ensemble.train_ensemble(flow, P, B, camel, optimizers.adamax(2e-3, 1e-4),
                                  torch.Generator(device=dev).manual_seed(4), batch_size=batch,
                                  epochs=epochs, preburn_time=10, kill_counter=1000)
    ens_s = time.perf_counter() - t0
    print(f"phase15 ensemble {n_runs} seeds x {epochs} epochs at batch {batch}: {ens_s:.2f} s "
          f"(host clock), group {res['group_size']}; best losses "
          f"{np.round(np.sort(res['best_loss']), 5).tolist()}, phase-A losses "
          f"{np.round(res['int_loss'], 5).tolist()}, integrals "
          f"{np.round(res['integ_tot'], 5).tolist()} {card}")
    check(bool((res["best_loss"] < res["int_loss"]).all()), "every run's best_loss < int_loss")
    best = int(np.argmin(res["best_loss"]))
    NF = PWQuadManager(n_flow=2, seed=0, device=dev)
    NF.create_model(4, 4, [3, 3, 3])
    member = interop.ensemble_member(flow, (res["best_params"], res["best_bn"]), best)
    NF._model.load_state_dict(member.state_dict())
    NF.best_model = copy.deepcopy(NF._model)
    before = counts()
    sig, err = NF.integrate(camel, 8, P15_INTEG_N)
    ens_launches = delta(before)
    print(f"phase15 ensemble best run {best} in a PWQuadManager: integrate(8, 2^21) = "
          f"{sig:.7f} +- {err:.2e} (rel err {abs(sig - exact) / exact:.2e}); sampler launches "
          f"{ens_launches[0]}")
    check(gate(sig, err) and ens_launches == (8, 0, 0), "the ensemble's best flow integrates "
          "through the sampler kernel within the gate")

    n_runs, batch, epochs = P15_STRESS
    flow8, P, B = ensemble.stack_ensemble(lambda g: factory.build_pwquad_flow(
        g, 2, 4, 4, (8, 8), device=dev), torch.Generator(device=dev).manual_seed(0), n_runs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = ensemble.train_ensemble(flow8, P, B, camel, optimizers.adamax(3e-3),
                                  torch.Generator(device=dev).manual_seed(1), batch_size=batch,
                                  epochs=epochs, preburn_time=0, kill_counter=100,
                                  runs_per_call="auto", verbose=True)
    stress_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"phase15 ensemble stress: {n_runs} runs x {epochs} epochs at batch {batch} in "
          f"{stress_s:.2f} s = {n_runs / stress_s:.3f} runs/s, group size {res['group_size']}, "
          f"max_memory_allocated {peak:.3f} GiB (host clock); best losses median "
          f"{float(np.median(res['best_loss'])):.4e}, all finite "
          f"{bool(np.isfinite(res['best_loss']).all())} {card}")
    check(res["history"].shape == (n_runs, epochs) and bool(np.isfinite(res["history"]).all()),
          "the 64-run stress completes with finite histories")
    device_profile("phase15", f"train_ensemble({n_runs} runs x 5 epochs at batch {batch})",
                   lambda: ensemble.train_ensemble(
                       flow8, P, B, camel, optimizers.adamax(3e-3),
                       torch.Generator(device=dev).manual_seed(1), batch_size=batch, epochs=5,
                       preburn_time=0, kill_counter=100, runs_per_call=None), card)
    device_profile("phase15", f"VEGAS run(camel, 10 x {P15_VEGAS_NEVAL})",
                   lambda: vegas.VegasIntegrator(2, n_bins=50, seed=1, device=dev).run(
                       camel, nitn=10, neval=P15_VEGAS_NEVAL), card)

    # a group's epoch loop with every host sync an error
    gen_s = torch.Generator(device=dev).manual_seed(2)
    run = ensemble._group_runner(flow8, camel, optimizers.adamax(3e-3), gen_s, batch, 1, 5, 0,
                                 100, "var", False, False, torch.float32, dev)
    P8 = {k: v[:8].clone() for k, v in P.items()}
    B8 = {k: v[:8].clone() for k, v in B.items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = run(P8, B8)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(bool(torch.isfinite(out[2][3]).all()), "the sync-checked group's history")

    runs, batch, mb, epochs = P15_F64
    cpu = torch.device("cpu")
    flow64, P, B = ensemble.stack_ensemble(lambda g: factory.build_pwquad_flow(
        g, 2, 2, 4, (3, 3), torch.float64), torch.Generator().manual_seed(5), runs)
    lat_gen = torch.Generator().manual_seed(6)
    lats = [torch.rand((runs, 2, 2 * mb, 2), generator=lat_gen, dtype=torch.float64)] + [
        torch.rand((runs, batch // mb, mb, 2), generator=lat_gen, dtype=torch.float64)
        for _ in range(epochs)]
    hists = []
    hook = ensemble._uniform
    try:
        for where in (dev, cpu):
            feed = iter(lats)
            ensemble._uniform = lambda g, shape, dtype, device: next(feed).to(device)
            r = ensemble.train_ensemble(
                flow64, {k: v.to(where) for k, v in P.items()},
                {k: v.to(where) for k, v in B.items()}, camel, optimizers.adamax(3e-3, 1e-4),
                torch.Generator(device=where), batch_size=batch, mini_batch_size=mb,
                epochs=epochs, preburn_time=3, kill_counter=100)
            hists.append(r["history"])
    finally:
        ensemble._uniform = hook
    f64_err = float(np.max(np.abs(hists[0] / hists[1] - 1)))
    print(f"phase15 check 5: {P15_ENS[0]} seeds below their phase-A losses, the best flow "
          f"through the sampler within the gate, {P15_STRESS[0]} runs complete, a group's "
          f"epoch loop under set_sync_debug_mode('error'); float64 {runs} runs x {epochs} "
          f"epochs on the same latents, card against CPU: history max rel diff {f64_err:.3e}")
    check(f64_err <= 1e-8, "float64 ensemble history cuda vs cpu within 1e-8")

    # ---- check 6: profiling
    whole = resumed["camel stale"][0]
    trace_dir = os.path.join(tmp, "trace")
    with profiling.trace(trace_dir):
        whole.integrate(camel, 8, P15_INTEG_N)
    names = os.listdir(trace_dir)
    text = "".join(open(os.path.join(trace_dir, n)).read() for n in names)
    with profiling.Timer() as timer:
        timer.block_on(whole.sample(P15_INTEG_N))
    best_s = profiling.benchmark(lambda: whole.sample(P15_INTEG_N), reps=10, warmup=2)
    print(f"phase15 check 6: profiling.trace wrote {names} ({len(text)} bytes) naming "
          f"pwquad_sampler_kernel {text.count('pwquad_sampler_kernel')} times; sample(2^21): "
          f"Timer {timer.seconds * 1e3:.3f} ms, benchmark best of 10 {best_s * 1e3:.3f} ms "
          f"(host clock, synchronised) {card}")
    check(len(names) == 1 and "pwquad_sampler_kernel" in text, "the trace names the sampler")
    check(timer.seconds > 0 and best_s > 0, "Timer and benchmark")
    torch.cuda.synchronize()
    launches = counts()
    print(f"phase15 main path launches sampler/fwd/bwd {launches}")
    check(all(n > 0 for n in launches), "phase 15 launched every kernel")

    # the kernels against their plain versions on phase 15's plans: the
    # ensemble's 4-cell flow, the resumed flagship
    errors = [0.0, 0.0, 0.0]
    w = torch.rand((P15_INTEG_N, 2), generator=gen_s, device=dev)
    x_k, jac_k = ps.build_sampler(flow, member, take_latents=True)(w)
    x_p, jac_p = make_folded_forward(flow, member)(w)
    errors[0] = float((x_k - x_p).abs().max())
    print(f"phase15 sampler, the ensemble's best 4-cell flow, operand latents 2^21: max|dx|="
          f"{errors[0]:.3e} max|djac/jac|={float(((jac_k - jac_p) / jac_p).abs().max()):.3e}")
    check(torch.allclose(x_k, x_p, rtol=1e-4, atol=2e-5), "ensemble flow sampler x vs plain")
    check(torch.allclose(jac_k, jac_p, rtol=1e-3, atol=0.0), "ensemble flow sampler jac vs plain")
    flag = resumed["flagship stale"][1]._model
    errors[1], errors[2] = hold_train("resumed flagship n=2^18", pt.TrainPlan(flag.flow),
                                      pt.fold_flow(flag).detach(),
                                      torch.rand((P15_N_TRAIN, 10), generator=gen_s, device=dev),
                                      tag="phase15")
    tmp_dir.cleanup()
    print(f"phase15: {time.perf_counter() - t_phase:.1f} s {card}")
    return launches, errors


# ---- phase 16: data parallelism on the card (nf_tpu_torch.parallel and the
# entry points' mesh=): a world of one on NCCL against the single-device
# runs, the sampler's rank streams, and two ranks on the one card over gloo
P16_SAMPLE_N, P16_INTEG = 1 << 24, (8, 1 << 21)     # phase 5's sizes
P16_CAMEL = (10000, 20)                             # batch, epochs
P16_FLAG = (1 << 20, 1 << 18, 4)                    # batch, minibatch, epochs (phase 15)
P16_UNW = (1 << 20, 1 << 22, 0.999)                 # phase 12: events, batch, quantile
P16_MC = (1 << 17, 1 << 16, 4)                      # phase 14's resume: per channel, mb, epochs
P16_STREAM_N, P16_RANKS = 1 << 21, 4
P16_GLOO_N, P16_GLOO_BATCH, P16_GLOO_EPOCHS = 1 << 21, 10000, 2


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def train_camel(dev, bn_stats, epochs, batch, mesh=None, **extra):
    """Phase 16's camel run: ``create_model(2, 4, [3] * 3)`` from seed 0."""
    from nf_tpu_torch import PWQuadManager
    from nf_tpu_torch.training import optimizers
    NF = PWQuadManager(n_flow=2, seed=0, device=dev)
    NF.create_model(2, 4, [3] * 3)
    kw = dict(log=False, batch_size=batch, mini_batch_size=batch, preburn_time=5,
              kill_counter=1000, integrate=True, pretty_progressbar=False, bn_stats=bn_stats,
              stats_every=4)
    kw.update(extra)
    NF._train_variance_forward_seq(camel, optimizers.adamax(2e-3, 1e-4), epochs=epochs,
                                   mesh=mesh, **kw)
    return NF


def dp_gloo_rank(rank, port, device, state_path, out_path):
    """One of phase 16's two ranks on the one card (``device``): a gloo
    process group over its tensors, ``dp_sample``, ``dp_integrate`` and the
    stale trainer on the main-path model; rank 0 writes the results."""
    import datetime

    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from nf_tpu_torch import PWQuadManager
    from nf_tpu_torch.parallel import dp_integrate, dp_sample, make_mesh

    if device == "cuda":
        torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank, timeout=datetime.timedelta(seconds=60))
    mesh = make_mesh(device=device)
    NF = PWQuadManager(n_flow=2, seed=0, device=device)
    NF.create_model(2, 4, [3] * 3)
    NF.best_model.load_state_dict(torch.load(state_path, weights_only=True))
    x, jac = dp_sample(NF._flow, NF.best_model, mesh, P16_GLOO_N, seed=5)
    integ = dp_integrate(NF._flow, NF.best_model, camel, mesh, 8, P16_GLOO_N, seed=6)
    T = train_camel(device, "stale", P16_GLOO_EPOCHS, P16_GLOO_BATCH, mesh, preburn_time=0)
    if rank == 0:
        torch.save({"x": x.cpu(), "jac": jac.cpu(), "integ": integ, "history": T.history,
                    "integ_hist": T._integ_hist, "model": {k: v.cpu() for k, v in
                                                            T._model.state_dict().items()}},
                   out_path)
    dist.destroy_process_group()


def phase16(dev, card, NF):
    """Data parallelism on the card, checks 1-6 (``phase16 check N``).
    ``NF`` is phase 5's trained camel manager.  Returns the kernels'
    launches (sampler, forward, backward) over the entry points of checks
    1, 3 and 4."""
    import collections
    import multiprocessing
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from nf_tpu_torch import PWQuadManager
    from nf_tpu_torch.ops import pwquad_sampler as ps
    from nf_tpu_torch.ops import pwquad_train as pt
    from nf_tpu_torch.parallel import initialize_distributed
    from nf_tpu_torch.parallel import sampling as psampling
    from nf_tpu_torch.training import multichannel as mc
    from nf_tpu_torch.training import optimizers
    from nf_tpu_torch.training.unweight import generate_unweighted

    exact = camel_exact()
    t_phase = time.perf_counter()
    mesh = initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, device="cuda", timeout=300)
    check(dist.get_backend() == "nccl" and mesh.size() == 1 and mesh.mesh_dim_names == ("dp",),
          "phase 16's world of one is an NCCL dp mesh")
    print(f"phase16: world of one on {dist.get_backend()}, mesh {mesh}")

    def equal_models(a, b):
        return state_digest(a) == state_digest(b)

    ps.LAUNCHES = pt.FWD_LAUNCHES = pt.BWD_LAUNCHES = 0
    torch.cuda.synchronize()
    # ---- check 1: sample and integrate under mesh= against the single device
    flow, best = NF._flow, NF.best_model
    got, ref = NF.sample(P16_SAMPLE_N, seed=16, mesh=mesh), NF.sample(P16_SAMPLE_N, seed=16)
    check(all(torch.equal(a, b) for a, b in zip(got, ref)), "sample(2^24, mesh=) bit-identical")
    del got, ref
    nitn, neval = P16_INTEG
    integ = {}
    for method in (None, "qmc"):
        integ[method] = [NF.integrate(camel, nitn, neval, seed=17, method=method, mesh=m)
                         for m in (mesh, None)]
        (sig, err), (sig1, err1) = integ[method]
        print(f"phase16 integrate({nitn}, 2^21, method={method}, mesh=) = {sig:.7f} +- "
              f"{err:.3e}, single device {sig1:.7f} +- {err1:.3e} (rel diff "
              f"{abs(sig - sig1) / sig1:.2e}, {abs(err - err1) / err1:.2e}; exact {exact:.7f})")
        check(abs(sig - exact) <= 5 * err + 0.01 * exact, "mesh integral within 5 err + 1%")
    check(integ["qmc"][0] == integ["qmc"][1], "integrate(qmc, mesh=) equals the single device")
    # float64 sums of the iterations against float32 torch.mean / torch.var
    (sig, err), (sig1, err1) = integ[None]
    check(abs(sig - sig1) <= 1e-5 * sig1 and abs(err - err1) <= 1e-4 * err1,
          "integrate(mesh=) within roundoff of the single device")
    print("phase16 check 1: sample(2^24, mesh=) bit-identical to sample(2^24); integrate(8, "
          "2^21, mesh=) within roundoff (and qmc equal) on the same seeds, in the gate")

    # ---- check 3: both trainers under mesh= against mesh=None, bit for bit,
    # at the default cadence (under mesh= the chunk runs eagerly; without,
    # on graphs) and at epochs_per_sync=1 (the per-epoch loop, one
    # all-reduce and one host read an epoch); the two cadences equal too
    batch, epochs = P16_CAMEL
    runs = {}
    for bn_stats in ("batch", "stale"):
        for cadence in ("auto", 1):
            before = (pt.FWD_LAUNCHES, pt.BWD_LAUNCHES)
            runs[bn_stats, cadence] = [train_camel(dev, bn_stats, epochs, batch, m,
                                                   epochs_per_sync=cadence) for m in (mesh, None)]
            launched = (pt.FWD_LAUNCHES - before[0], pt.BWD_LAUNCHES - before[1])
            a, b = runs[bn_stats, cadence]
            check(a.history == b.history and np.array_equal(a._integ_hist, b._integ_hist)
                  and (a.integ_tot, a.err_tot) == (b.integ_tot, b.err_tot)
                  and equal_models(a.best_model, b.best_model)
                  and equal_models(a._model, b._model),
                  f"camel {bn_stats} trainer at epochs_per_sync={cadence} under mesh= "
                  "bit-identical to mesh=None")
            want = (0, 0) if bn_stats == "batch" else \
                (2 * (epochs + (epochs - 1) // 4 + 1), 2 * epochs)
            check(launched == want, f"camel {bn_stats} launched fwd/bwd {launched}, not {want}")
            print(f"phase16 camel {bn_stats} trainer, batch {batch}, {epochs} epochs at "
                  f"epochs_per_sync={cadence}: mesh= bit-identical to mesh=None (integral "
                  f"{a.integ_tot:.7f} +- {a.err_tot:.2e}); fwd/bwd launches {launched}")
        a, b = runs[bn_stats, "auto"][0], runs[bn_stats, 1][0]
        check(a.history == b.history and equal_models(a._model, b._model),
              f"camel {bn_stats} under mesh=: the default cadence equals epochs_per_sync=1")
    fb, fmb, fep = P16_FLAG
    n_mb = fb // fmb
    want = (2 * (fep * n_mb + (fep - 1) // 4 + 1), 2 * fep * n_mb)
    flag = {}
    for cadence in ("auto", 1):
        before = (pt.FWD_LAUNCHES, pt.BWD_LAUNCHES)
        flag[cadence] = []
        for m in (mesh, None):
            F = PWQuadManager(n_flow=10, seed=0, device=dev)
            F.create_model(8, 8, [16, 16], final_rank=4)
            F._train_variance_forward_seq(gauss10, optimizers.adamax(2e-3, 1e-4), log=False,
                                          batch_size=fb, mini_batch_size=fmb, epochs=fep,
                                          preburn_time=0, kill_counter=1000, integrate=False,
                                          pretty_progressbar=False, bn_stats="stale",
                                          stats_every=4, mesh=m, epochs_per_sync=cadence)
            flag[cadence].append(F)
        launched = (pt.FWD_LAUNCHES - before[0], pt.BWD_LAUNCHES - before[1])
        a, b = flag[cadence]
        check(a.history == b.history and equal_models(a._model, b._model),
              f"flagship stale trainer at epochs_per_sync={cadence} under mesh= bit-identical "
              "to mesh=None")
        check(launched == want, f"flagship stale launched fwd/bwd {launched}, not {want}")
        print(f"phase16 flagship stale trainer, 2^20 in 4 x 2^18, {fep} epochs at "
              f"epochs_per_sync={cadence}: mesh= bit-identical to mesh=None; fwd/bwd launches "
              f"{launched}")
    check(flag["auto"][0].history == flag[1][0].history
          and equal_models(flag["auto"][0]._model, flag[1][0]._model),
          "flagship stale under mesh=: the default cadence equals epochs_per_sync=1")
    print("phase16 check 3: both trainers under mesh= equal their mesh=None runs bit for bit "
          "(camel batch and stale, flagship stale), at the default cadence and at "
          "epochs_per_sync=1, which equal each other; launch counts exact")

    # ---- check 4: unweighting and the mixture under mesh=
    n_events, unw_batch, q = P16_UNW
    unw = [generate_unweighted(flow, best, camel, torch.Generator(device=dev).manual_seed(24),
                               n_events=n_events, batch=unw_batch, wmax_quantile=q,
                               partial_unweight=True, mesh=m, compact=False)
           for m in (mesh, None)]
    check(np.array_equal(unw[0][0], unw[1][0]) and np.array_equal(unw[0][1], unw[1][1])
          and unw[0][2] == unw[1][2], "generate_unweighted(mesh=) equals mesh=None")
    channels, me = mc_physics()
    per_channel, mc_mb, mc_epochs = P16_MC
    models = mc.build_channel_flows(torch.Generator(device=dev).manual_seed(0), channels, 4, 16,
                                    [32] * 2, final_rank=4, device=dev)
    mix = [mc.train_multichannel(channels, models, me, E_MC, optimizers.adamax(5e-3, 1e-4),
                                 torch.Generator(device=dev).manual_seed(3), alphas=[0.5, 0.5],
                                 batch_per_channel=per_channel, mini_batch_per_channel=mc_mb,
                                 epochs=mc_epochs, epochs_per_call=2, loss_mode="kl", mesh=m,
                                 **ZZ_CUTS)
           for m in (mesh, None)]
    check(all(np.array_equal(mix[0]["history"][k], mix[1]["history"][k])
              for k in mix[1]["history"])
          and all(equal_models(a, b) for a, b in zip(mix[0]["params"], mix[1]["params"])),
          "train_multichannel(mesh=) equals mesh=None")
    torch.cuda.synchronize()
    launches = (ps.LAUNCHES, pt.FWD_LAUNCHES, pt.BWD_LAUNCHES)
    print(f"phase16 check 4: generate_unweighted(2^20 events, batch 2^22, quantile 0.999, "
          f"partial, mesh=) equals mesh=None ({len(unw[0][0])} events, eff "
          f"{unw[0][2]['eff']:.5f}); train_multichannel(2 x 2^17, {mc_epochs} epochs, mesh=) "
          f"equals mesh=None (ess {mix[0]['history']['ess'][-1]:.5f})")
    print(f"phase16: launches over checks 1, 3 and 4, sampler/fwd/bwd {launches}")
    check(all(n > 0 for n in launches), "phase 16's main path launched every kernel")

    # ---- check 2: the rank streams on the kernel itself
    NF_f = PWQuadManager(n_flow=10, seed=4, device=dev)
    NF_f.create_model(8, 8, [16, 16], final_rank=4)
    for name, model in (("camel2d_trained", best), ("flagship10d_rank4", NF_f.best_model)):
        sampler = ps.build_sampler(model.flow, model)
        one = sampler(77, P16_STREAM_N)
        n_local = P16_STREAM_N // P16_RANKS
        parts = [sampler(77, n_local, offset=r * n_local) for r in range(P16_RANKS)]
        check(all(torch.equal(torch.cat(p), o) for p, o in zip(zip(*parts), one)),
              f"{name}: {P16_RANKS} rank launches at offsets r 2^19 equal one launch of 2^21")
    print(f"phase16 check 2: the sampler at offset r * 2^19, r = 0..{P16_RANKS - 1}, "
          f"concatenated equals one launch of 2^21 bit for bit (camel, flagship)")

    # ---- check 5: two ranks on the one card over gloo
    with tempfile.TemporaryDirectory(prefix="phase16_") as tmp:
        state_path, out_path = os.path.join(tmp, "best.pt"), os.path.join(tmp, "rank0.pt")
        torch.save(best.state_dict(), state_path)
        ctx = multiprocessing.get_context("spawn")
        port = free_port()
        t0 = time.perf_counter()
        procs = [ctx.Process(target=dp_gloo_rank, args=(r, port, dev.type, state_path, out_path))
                 for r in (0, 1)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=240)
        alive = [p.pid for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        check(not alive and all(p.exitcode == 0 for p in procs),
              f"gloo ranks exit codes {[p.exitcode for p in procs]}, alive {alive}")
        gloo_s = time.perf_counter() - t0
        two = torch.load(out_path, weights_only=False)
    x, jac = psampling.dp_sample(flow, best, None, P16_GLOO_N, seed=5)
    check(torch.equal(two["x"], x.cpu()) and torch.equal(two["jac"], jac.cpu()),
          "two gloo ranks' dp_sample bit-identical to one process")
    sig1 = psampling.dp_integrate(flow, best, camel, None, 8, P16_GLOO_N, seed=6)
    one = train_camel(dev, "stale", P16_GLOO_EPOCHS, P16_GLOO_BATCH, preburn_time=0)
    hist_err = float(np.max(np.abs(np.asarray(two["history"]) / np.asarray(one.history) - 1)))
    integ_err = max(abs(a / b - 1) for a, b in zip(two["integ"], sig1))
    param_err = max(float((two["model"][k] - v.cpu()).abs().max())
                    for k, v in one._model.state_dict().items())
    print(f"phase16 check 5: two gloo ranks on the card in {gloo_s:.1f} s (spawn included): "
          f"dp_sample(2^21) bit-identical to one process; dp_integrate(8, 2^21) rel diff "
          f"{integ_err:.2e}; stale trainer {P16_GLOO_EPOCHS} epochs at {P16_GLOO_BATCH}: "
          f"history rel diff {hist_err:.2e}, parameters max |d| {param_err:.2e}")
    check(integ_err <= 1e-6 and hist_err <= 1e-6, "gloo ranks within 1e-6 of one process")

    # ---- check 6: times, paired (CUDA events; the trainers' epochs from
    # benchmark_train_step), and the collectives a minibatch makes
    times = {}
    for what, fn in (
            ("sample(2^24)", lambda m: NF.sample(P16_SAMPLE_N, mesh=m)),
            ("integrate(8, 2^21)", lambda m: NF.integrate(camel, nitn, neval, mesh=m))):
        times[what] = [time_ms(lambda: fn(m)) for m in (None, mesh, mesh, None)]
        print(f"phase16 check 6 {what}: single device {times[what][0]:.3f} / "
              f"{times[what][3]:.3f} ms, mesh= (world of one) {times[what][1]:.3f} / "
              f"{times[what][2]:.3f} ms {card}")
    calls = collections.Counter()
    originals = {name: getattr(dist, name) for name in ("all_reduce", "all_gather", "broadcast")}

    def counting(name):
        def call(*args, **kwargs):
            calls[name] += 1
            return originals[name](*args, **kwargs)
        return call

    # at each cadence: a rep of the default is a chunk of the run's length;
    # of the per-epoch run one epoch, or stats_every = 4 for the stale
    # trainer (one refresh among them)
    for tag, pairs in (("camel batch", (runs["batch", "auto"], runs["batch", 1])),
                       ("camel stale", (runs["stale", "auto"], runs["stale", 1])),
                       ("flagship stale", (flag["auto"], flag[1]))):
        for cadence, (a, b) in zip(("auto", 1), pairs):
            ms = [b.benchmark_train_step()[0] * 1e3, a.benchmark_train_step()[0] * 1e3,
                  a.benchmark_train_step()[0] * 1e3, b.benchmark_train_step()[0] * 1e3]
            reps = 1
            k = a._bench[6]["k0"] if cadence == "auto" else 1 if tag == "camel batch" else 4
            n_mb = a._bench[2]
            calls.clear()
            for name in originals:
                setattr(dist, name, counting(name))
            try:
                a.benchmark_train_step(reps=reps)
            finally:
                for name, fn in originals.items():
                    setattr(dist, name, fn)
            per_mb = sum(calls.values()) / ((reps + 1) * k * n_mb)
            print(f"phase16 check 6 {tag} epoch at epochs_per_sync={cadence}: mesh=None "
                  f"{ms[0]:.3f} / {ms[3]:.3f} ms, mesh= {ms[1]:.3f} / {ms[2]:.3f} ms (CUDA "
                  f"events); {per_mb:.2f} collectives a minibatch of {a._bench[3]} "
                  f"({dict(calls)} over {(reps + 1) * k} epochs) {card}")
    dist.destroy_process_group()
    print(f"phase16: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---- phase 17: the chunked epoch cadence (epochs_per_sync > 1 or "auto",
# the default): each epoch and each statistics refresh a replayed CUDA graph,
# the state machine on the device, one read a chunk, the optimizer's step the
# update kernel; every run against the per-epoch run, bit for bit
P17_CAMEL = (10000, 2000, 150)          # the camel main path: batch, minibatch, epochs
P17_STAGES = (6, 6)                     # bench.py:335,388: epochs, epochs_per_sync
P17_KILL = (2000, 1000, 60)             # the forced stop: batch, minibatch, epochs


def same_run(a, b):
    """What two managers' runs left, bit for bit: ``(equal, what differs)``.
    The optimizer's state includes ``step``, which must lie on the CPU in
    both, as the per-epoch run keeps it."""
    import numpy as np
    import torch
    diffs = []
    if a.history != b.history:
        diffs.append("history")
    if (a.best_epoch, a._last_epoch) != (b.best_epoch, b._last_epoch):
        diffs.append("best/last epoch")
    if not (np.array_equal(a._integ_hist, b._integ_hist)
            and np.array_equal(a._err_hist, b._err_hist)):
        diffs.append("integral history")
    for name, x, y in (("model", a._model, b._model), ("best model", a.best_model, b.best_model)):
        if state_digest(x) != state_digest(y):
            diffs.append(name)
    da, db = a._optimizer.state_dict(), b._optimizer.state_dict()
    sa, sb = da["state"], db["state"]
    if da["param_groups"] != db["param_groups"] or sa.keys() != sb.keys() or any(
            list(sa[i]) != list(sb[i]) or sa[i]["step"].device.type != "cpu"
            or sb[i]["step"].device.type != "cpu"
            or not all(torch.equal(sa[i][n], sb[i][n]) for n in sa[i]) for i in sa):
        diffs.append("optimizer state")
    if not torch.equal(a._gen.get_state(), b._gen.get_state()):
        diffs.append("generator")
    return not diffs, diffs


# the update kernel's check: steps at each plan's parameter shapes, the
# models that give them (create_model's arguments), and the bytes a step
# moves per float32 element (read p, g and both moments; write p and both)
P17_UPDATE_STEPS = 200
P17_UPDATE_PLANS = (("camel2d", 2, (2, 4, [3] * 3), {}),
                    ("flagship10d_rank4", 10, (8, 8, [16, 16]), {"final_rank": 4}),
                    ("2to4 n_flow 10", 10, (4, 32, [32] * 2), {"identity_init": True}),
                    ("zz n_flow 11", 11, (4, 16, [32] * 2),
                     {"identity_init": True, "final_rank": 4}))
UPDATE_BYTES = 28


def update_check(dev, card):
    """The update kernel (``ops/optim_step``) against torch's per-epoch step
    (foreach, not capturable) and against its plain version, bit for bit
    over ``P17_UPDATE_STEPS`` steps, Adamax and Adam, with and without
    weight decay, on random tensors at the parameter shapes of each plan;
    then its time per call beside torch's steps.  Returns the kernels
    line's numbers at the camel plan (the main path's)."""
    import torch

    from nf_tpu_torch import PWQuadManager
    from nf_tpu_torch.ops import optim_step

    hyper = dict(beta1=0.9, beta2=0.999, eps=1e-8)
    out = {}
    for name, n_flow, args, kwargs in P17_UPDATE_PLANS:
        NF = PWQuadManager(n_flow=n_flow, seed=0, device=dev)
        NF.create_model(*args, **kwargs)
        shapes = [p.shape for p in NF._model.parameters()]
        numel = sum(p.numel() for p in NF._model.parameters())
        worst = 0.0
        for adam in (False, True):
            for wd in (0.0, 1e-4):
                differ, err, taken = optim_step.compare_with_torch(
                    shapes, adam=adam, weight_decay=wd, steps=P17_UPDATE_STEPS, device=dev)
                worst = max(worst, err)
                print(f"phase17 check 6 update kernel {name} ({len(shapes)} tensors, {numel} "
                      f"parameters) {'Adam' if adam else 'Adamax'} weight decay {wd:g}: "
                      f"{P17_UPDATE_STEPS} steps, elements that differ from torch's per-epoch "
                      f"step or the plain version {differ}")
                check(differ == 0 and taken == P17_UPDATE_STEPS,
                      f"update kernel {name} adam={adam} wd={wd}: bit for bit against torch's "
                      "step and the plain version")
        # times per call, float32, Adamax with weight decay (the trainer's),
        # and Adam beside torch's fused capturable Adam
        times = {}
        for adam in (False, True):
            params = [torch.randn(sh, device=dev) for sh in shapes]
            grads = [torch.randn(sh, device=dev) * 1e-3 for sh in shapes]
            m, u = [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params]
            step = torch.zeros(1, dtype=torch.int64, device=dev)
            tables = optim_step.step_tables(2e-3, (0.9, 0.999), 200, adam, dev)
            tag = "adam" if adam else "adamax"
            times[tag, "kernel"] = time_ms(lambda: optim_step.update(
                params, grads, m, u, step, tables, adam=adam, weight_decay=1e-4, **hyper))
            step.zero_()
            ref = optim_step.adam_update_ref if adam else optim_step.adamax_update_ref
            ref_tables = tables if adam else tables[:1]
            times[tag, "plain"] = time_ms(lambda: ref(params, grads, m, u, step, *ref_tables,
                                                      weight_decay=1e-4, **hyper))
            make = torch.optim.Adam if adam else torch.optim.Adamax
            variants = [("torch foreach", {}), ("torch foreach capturable",
                                                {"capturable": True})]
            if adam:
                variants.append(("torch fused capturable", {"fused": True, "capturable": True}))
            for label, flags in variants:
                ps_ = [p.clone() for p in params]
                for p, g in zip(ps_, grads):
                    p.grad = g
                opt = make(ps_, lr=2e-3, weight_decay=1e-4, **flags)
                with warnings.catch_warnings():
                    # the capturable step, run eagerly here, warns so
                    warnings.simplefilter("ignore")
                    times[tag, label] = time_ms(opt.step)
            # inside a CUDA graph, as the chunk runs them: one step's replay,
            # the kernel against torch's capturable step
            for label, step_fn in (("kernel in a graph", lambda: optim_step.update(
                    params, grads, m, u, step, tables, adam=adam, weight_decay=1e-4,
                    **hyper)), ("torch capturable in a graph", None)):
                if step_fn is None:
                    ps_ = [p.clone() for p in params]
                    for p, g in zip(ps_, grads):
                        p.grad = g
                    opt = make(ps_, lr=2e-3, weight_decay=1e-4, capturable=True)
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        opt.step()        # the state, before the capture
                    step_fn = opt.step
                step.zero_()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    step_fn()
                times[tag, label] = time_ms(graph.replay)
                variants.append((label, None))
            print(f"phase17 check 6 update {name} {tag} per call ({numel} parameters, "
                  f"{len(shapes)} tensors): kernel {times[tag, 'kernel']:.4f} ms, plain "
                  f"{times[tag, 'plain']:.4f} ms, " + ", ".join(
                      f"{label} {times[tag, label]:.4f} ms" for label, _ in variants)
                  + f"; bound {UPDATE_BYTES * numel / PEAK_BYTES_PER_S * 1e3:.6f} ms by bytes "
                  f"(CUDA events) {card}")
        out[name] = {"max_abs_err": worst, "ms": times["adamax", "kernel"],
                     "plain_ms": times["adamax", "plain"],
                     "bound_ms": UPDATE_BYTES * numel / PEAK_BYTES_PER_S * 1e3,
                     "library_ms": times["adamax", "torch foreach capturable"]}
    return out["camel2d"]


def phase17(dev, card, gen, hold_train):
    """The chunked cadence on the card, checks 1-6 (``phase17 check N``).
    Returns the kernels' launches on its main paths (training forward,
    backward, update): the graph chunks of checks 1 and 2, each counted from
    0 just before it; the training kernels' max abs errors against their
    plain versions (``hold_train``) at the shapes those paths launch; and
    the update kernel's numbers (:func:`update_check`)."""
    import torch

    from nf_tpu_torch import PWQuadManager
    from nf_tpu_torch.ops import optim_step
    from nf_tpu_torch.ops import pwquad_train as pt
    from nf_tpu_torch.training import optimizers

    exact = camel_exact()
    t_phase = time.perf_counter()
    launches, errors = [0, 0, 0], [0.0, 0.0]

    def flat_f(x):
        return torch.ones(x.shape[0], dtype=x.dtype, device=x.device)

    def trained(n_flow, seed, args, kwargs, f, graphs=None, lr=2e-3, opt=optimizers.adamax,
                **kw):
        NF = PWQuadManager(n_flow=n_flow, seed=seed, device=dev)
        NF.create_model(*args, **kwargs)
        run_kw = dict(log=False, integrate=False, pretty_progressbar=False, stats_every=4)
        run_kw.update(kw)
        pt.FWD_LAUNCHES = pt.BWD_LAUNCHES = optim_step.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        NF._train_variance_forward_seq(f, opt(lr, 1e-4), _graphs=graphs, **run_kw)
        torch.cuda.synchronize()
        return (NF, time.perf_counter() - t0,
                (pt.FWD_LAUNCHES, pt.BWD_LAUNCHES, optim_step.LAUNCHES))

    def count(n):
        for i in range(3):
            launches[i] += n[i]

    def hold(what, NF, sizes):
        """The training kernels against their plain versions on ``NF``'s
        trained, folded flow at the path's minibatch and refresh sizes."""
        plan, flat = pt.TrainPlan(NF._flow), pt.fold_flow(NF._model).detach()
        for n in sorted(set(sizes)):
            e = hold_train(f"{what} trained n={n}", plan, flat,
                           torch.rand((n, NF.n_flow), generator=gen, device=dev),
                           tag="phase17")
            errors[0], errors[1] = max(errors[0], e[0]), max(errors[1], e[1])

    camel_model = ((2, 4, [3] * 3), {})
    batch, mini, epochs = P17_CAMEL
    main_kw = dict(batch_size=batch, mini_batch_size=mini, epochs=epochs, preburn_time=20)

    # ---- check 1: the camel main path at the default ("auto"), each
    # trainer, and the batch trainer with Adam: the graph chunk against the
    # per-epoch run (torch's own step) bit for bit, the update kernel
    # launched once an epoch, and the integral against the analytic value
    runs = {}
    for bn, opt in (("batch", optimizers.adamax), ("stale", optimizers.adamax),
                    ("batch", optimizers.adam)):
        name = f"camel {bn}" + (" Adam" if opt is optimizers.adam else "")
        g, g_s, g_n = trained(2, 0, *camel_model, camel, bn_stats=bn, opt=opt, **main_kw)
        count(g_n)
        p, p_s, p_n = trained(2, 0, *camel_model, camel, epochs_per_sync=1, bn_stats=bn,
                              opt=opt, **main_kw)
        if opt is optimizers.adamax:
            runs[bn] = (g, p)
        equal, diffs = same_run(g, p)
        ran = g._last_epoch + 1
        sig, err = g.integrate(camel, 8, 1 << 21)
        print(f"phase17 check 1 {name} (batch {batch} in {mini}, {epochs} epochs, default "
              f"cadence: chunks of {g._bench[6]['k0']}): {ran} epochs, best {g.best_epoch}; "
              f"graph chunk vs per-epoch run {'bit for bit' if equal else diffs} (history, "
              f"best and stop, parameters, buffers, optimizer state with its step, "
              f"generator); launches fwd/bwd/update {g_n} / per-epoch {p_n}; integral "
              f"{sig:.6f} +- {err:.2e} (exact {exact:.6f}); train wall {g_s:.2f} / {p_s:.2f} s "
              f"(graph / per-epoch) = {g_s / ran * 1e3:.3f} / "
              f"{p_s / (p._last_epoch + 1) * 1e3:.3f} ms an epoch {card}")
        check(equal, f"{name}: the graph chunk equals the per-epoch run bit for bit")
        check(g_n[2] == ran and p_n[2] == 0,
              f"{name}: the update kernel launched {g_n[2]} times in {ran} chunked epochs")
        check(math.isfinite(sig) and err > 0 and abs(sig - exact) <= 5 * err + 0.01 * exact,
              f"{name} chunked: |sig - exact| <= 5 err + 1%")
        if bn == "stale":
            refreshes = sum(1 for i in range(ran) if i % 4 == 0)
            check(g_n[:2] == (ran * batch // mini + refreshes, ran * batch // mini),
                  f"camel stale graph chunk launched fwd/bwd {g_n[:2]}")
        if opt is optimizers.adamax:
            # the minibatch and the refresh batch (min(minibatch, 2^16)) alike
            hold(f"chunked {name}", g, (mini, min(mini, 1 << 16)))

    # ---- check 2: bench.py's stale stages at epochs_per_sync=6: launches;
    # the graph run and the eager chunk's run (_graphs=False, the same update
    # kernel) against the per-epoch run bit for bit; then on copies of their
    # trained states, a chunk of the graph runner (its epochs after the
    # first are replays) against the same epochs launched eagerly, with host
    # syncs made errors, bit for bit; and the kernels against their plain
    # versions at the stage's sizes
    n_ep, k_sync = P17_STAGES
    stages = {}
    for name, n_flow, args, kwargs, b, m, f, seed in (
            ("camel2d batch 1M", 2, (2, 4, [3] * 3), {}, 1_000_000, 1_000_000, camel, 3),
            ("flagship10d_rank4 batch 2^20 / 2^18", 10, (8, 8, [16, 16]), {"final_rank": 4},
             1 << 20, 1 << 18, flat_f, 4)):
        stage_kw = dict(batch_size=b, mini_batch_size=m, epochs=n_ep, preburn_time=0,
                        bn_stats="stale")
        torch.cuda.reset_peak_memory_stats()
        NF, _, n = trained(n_flow, seed, args, kwargs, f, epochs_per_sync=k_sync, **stage_kw)
        peak = torch.cuda.max_memory_allocated()
        count(n)
        mbs = n_ep * (b // m)
        expected = (mbs + sum(1 for i in range(n_ep) if i % 4 == 0), mbs, n_ep)
        check(n == expected, f"{name}: chunked stale stage launched fwd/bwd/update {n}, not "
              f"{expected}")
        NF_e, _, n_e = trained(n_flow, seed, args, kwargs, f, graphs=False,
                               epochs_per_sync=k_sync, **stage_kw)
        NF_p, _, _ = trained(n_flow, seed, args, kwargs, f, epochs_per_sync=1, **stage_kw)
        stages[name] = (NF, NF_p)
        equal, diffs = same_run(NF, NF_p)
        equal_e, diffs_e = same_run(NF_e, NF_p)
        check(equal and equal_e and n == n_e,
              f"{name}: graph and eager chunk runs equal the per-epoch run")
        out = []
        for mgr in (NF, NF_e):
            runner, k, init = mgr._bench_chunk(seed=77)
            pt.FWD_LAUNCHES = pt.BWD_LAUNCHES = optim_step.LAUNCHES = 0
            if runner.graphs:
                rows = runner.run(0, k, init)
            else:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    rows = runner.run(0, k, init)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            out.append((rows.cpu(), state_digest(runner.model),
                        [t.cpu() for t in runner._opt_tensors()],
                        (pt.FWD_LAUNCHES, pt.BWD_LAUNCHES, optim_step.LAUNCHES)))
        (rows_g, dig_g, opt_g, n_g), (rows_e, dig_e, opt_e, n_e) = out
        same = (torch.equal(rows_g, rows_e) and dig_g == dig_e and n_g == n_e
                and all(torch.equal(a, b) for a, b in zip(opt_g, opt_e)))
        print(f"phase17 check 2 {name}: stale stage at epochs_per_sync={k_sync} launched "
              f"fwd/bwd/update {n} (peak memory {peak / 2**30:.2f} GiB); graph chunk run vs "
              f"per-epoch run {'bit for bit' if equal else diffs}, eager chunk run vs per-epoch "
              f"run {'bit for bit' if equal_e else diffs_e}; a chunk of {k} epochs, {k - 1} of "
              f"them replays: rows, parameters, buffers and optimizer state "
              f"{'bit for bit' if same else 'DIFFER'} against eager launches (no host sync "
              f"there), launches {n_g} / {n_e} {card}")
        check(same, f"{name}: graph replays equal eager launches")
        hold(f"{name} stage", NF, (m, min(m, 1 << 16)))

    # ---- check 3: a stop by the kill counter inside a chunk.  The chunk
    # length is the per-epoch run's stop + 2, so the stop falls inside the
    # first chunk, which is replayed up to it: the run leaves the per-epoch
    # run's state bit for bit
    b, m, n_ep = P17_KILL
    for bn in ("stale", "batch"):
        kill_kw = dict(batch_size=b, mini_batch_size=m, epochs=n_ep, preburn_time=0,
                       kill_counter=1, bn_stats=bn, integrate=True)
        p, _, _ = trained(2, 6, *camel_model, camel, epochs_per_sync=1, **kill_kw)
        s = p._last_epoch
        g, _, _ = trained(2, 6, *camel_model, camel, epochs_per_sync=s + 2, **kill_kw)
        equal, diffs = same_run(g, p)
        print(f"phase17 check 3 camel {bn}: per-epoch stop at {s}, chunks of {s + 2}: "
              f"{'bit for bit' if equal else diffs}")
        check(s < n_ep - 1 and equal, f"{bn}: mid-chunk kill stop leaves the per-epoch state")

    # ---- check 4: times, paired P/C/C/P (benchmark_train_step, CUDA
    # events): per-epoch against chunked, camel at batch 10000 (check 1's
    # runs) and the flagship stale stage (check 2's); then the chunked stale
    # trainers' device profiles
    flag_g, flag_p = stages["flagship10d_rank4 batch 2^20 / 2^18"]
    pairs = ((f"camel batch {batch} in {mini} bn_stats=batch", *runs["batch"][::-1], 11),
             (f"camel batch {batch} in {mini} bn_stats=stale", *runs["stale"][::-1], 11),
             ("flagship10d_rank4 stale 2^20 / 2^18", flag_p, flag_g, 5))
    for what, per_epoch, chunked, reps in pairs:
        ms = [m.benchmark_train_step(reps=reps)[0] * 1e3
              for m in (per_epoch, chunked, chunked, per_epoch)]
        print(f"phase17 check 4 {what} epoch: per-epoch {ms[0]:.3f} / {ms[3]:.3f} ms, chunked "
              f"(chunks of {chunked._bench[6]['k0']}) {ms[1]:.3f} / {ms[2]:.3f} ms (CUDA events, "
              f"P/C/C/P) {card}")
    for what, mgr in ((f"camel stale trainer, batch {batch} in {mini}", runs["stale"][0]),
                      ("flagship stale trainer, batch 2^20 / 2^18", flag_g)):
        # tables for four chunks: this run and device_profile's up to three
        runner, k, init = mgr._bench_chunk(chunks=4)
        runner.run(0, k, init).tolist()       # the captures, outside the profile
        device_profile("phase17 check 4", f"chunked {what}, one chunk of {k} epochs",
                       lambda: runner.run(0, k, init).tolist(), card)

    # ---- check 5: memory and the phase's time so far
    print(f"phase17 check 5: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB since check 2's flagship stage; phase 17 checks 1-5 "
          f"{time.perf_counter() - t_phase:.1f} s {card}")

    # ---- check 6: the update kernel against torch's step and its plain version
    update = update_check(dev, card)
    print(f"phase17: {time.perf_counter() - t_phase:.1f} s {card}")
    return launches, errors, update


# ---- phase 18: the per-op cost calibration (nf_tpu_torch/tools/calibrate_ops.py,
# the counterpart of tools/calibrate_vpu_ops.py): the op-chain kernel against
# its plain version for the ten ops, then the calibration at the Pallas
# tool's sizes on the card
P18_CHECK = (64, 40)                    # the checks' K and grid (two partial rows)
P18_K = 320                             # the timed launch's K, at the calibration's grid
# the flow kernels' rows of PERF.md section 6: plan, n_flow, create_model's
# arguments, (kernel, samples) per row
P18_MODEL_ROWS = (
    ("camel2d", 2, (2, 4, [3] * 3), {},
     (("sampler", 1 << 21), ("fwd", 1 << 20), ("bwd", 1 << 20))),
    ("flagship10d_rank4", 10, (8, 8, [16, 16]), {"final_rank": 4},
     (("sampler", 1 << 21), ("fwd", 1 << 18), ("bwd", 1 << 18))),
    ("wide128", 2, (2, 4, [128, 128]), {}, (("bwd", 1 << 18),)),
    ("2to4 n_flow 10", 10, (4, 32, [32] * 2), {"identity_init": True},
     (("sampler", 1 << 21), ("fwd", 1 << 18), ("bwd", 1 << 18))),
    ("zz n_flow 11", 11, (4, 16, [32] * 2), {"identity_init": True, "final_rank": 4},
     (("sampler", 1 << 20), ("fwd", 1 << 18), ("bwd", 1 << 18))),
)


def phase18(dev, card):
    """The op-chain kernel (``ops/op_chain``) against ``chain_ref`` for the
    ten ops, at the checks' size and at the calibration's two, each within the
    tests' 1e-6 relative, two launches bit for bit, then
    ``calibrate_ops.calibrate`` at grid 1024 and K 64 / 320 and the SASS
    checks.  Returns the kernels-line numbers: launches of the calibration,
    the largest |kernel - plain|, the fma chain's time at K 320 and grid
    1024, its plain version's, its bound."""
    import torch

    from nf_tpu_torch.ops import op_chain
    from nf_tpu_torch.tools import calibrate_ops

    t_phase = time.perf_counter()
    worst = 0.0
    op_chain.LAUNCHES = 0
    # the checks' size, then both instantiations the calibration times at its grid
    sizes = (P18_CHECK, *((k, calibrate_ops.GRID) for k in (calibrate_ops.K1, calibrate_ops.K2)))
    for k, grid in sizes:
        for op in op_chain.OPS:
            a = op_chain.chain(op, k, grid, 7, dev)
            b = op_chain.chain(op, k, grid, 7, dev)
            ref = op_chain.chain_ref(op, k, grid, 7, dev)
            torch.cuda.synchronize()
            err = float((a - ref).abs().max())
            rel = float(((a - ref).abs() / ref.abs()).max())
            same = int((a.view(torch.int32) == ref.view(torch.int32)).sum())
            repeat = torch.equal(a.view(torch.int32), b.view(torch.int32))
            print(f"phase18 check 1 {op} K {k} grid {grid}: max|kernel - plain| {err:.3e} "
                  f"(rel {rel:.3e}), {same} of {a.numel()} bit for bit; second launch bit for "
                  f"bit: {repeat}")
            check(a.shape == (op_chain.SUB, op_chain.LANE) and bool(torch.isfinite(a).all()),
                  f"op_chain {op} output")
            check(torch.allclose(a, ref, rtol=1e-6, atol=0), f"op_chain {op} K {k} vs plain")
            check(repeat, f"op_chain {op} K {k}: two launches give the same bits")
            worst = max(worst, err)
    expected = 2 * len(sizes) * len(op_chain.OPS)
    check(op_chain.LAUNCHES == expected, f"op_chain counted {op_chain.LAUNCHES} launches of "
          f"{expected}")

    # the main path: the calibration, its launches counted from 0
    op_chain.LAUNCHES = 0
    t0 = time.perf_counter()
    result = calibrate_ops.calibrate(dev, log=lambda line: print(f"phase18 {line}"))
    launches = op_chain.LAUNCHES
    cal_s = time.perf_counter() - t0
    per_op = (calibrate_ops.REPS + 1) * 2 * sum(calibrate_ops.LAUNCHES)
    check(launches == per_op * len(op_chain.OPS),
          f"the calibration launched the op-chain kernel {launches} times")
    print(f"phase18 calibration, grid {calibrate_ops.GRID} ({result['elements_per_launch']} "
          f"elements), K {calibrate_ops.K1} and {calibrate_ops.K2}, {calibrate_ops.LAUNCHES} "
          f"launches between events, median of {calibrate_ops.REPS}: {cal_s:.1f} s, {launches} "
          f"launches {card}")
    for line in calibrate_ops.table(result).splitlines():
        print(f"phase18 {line}")
    print(f"phase18 calibration JSON {json.dumps(result)}")
    for op, sec in result["sec_per_op_per_element"].items():
        check(math.isfinite(sec) and sec > 0, f"calibration {op}: {sec} s per op")
    sass = result["sass_per_step"]
    check(set(sass) == set(op_chain.OPS), "SASS of the ten chains read")
    for op, code in (("fma", "FFMA"), ("mul", "FMUL"), ("add", "FADD")):
        check(sass[op]["by_opcode"] == {code: 1.0}, f"the {op} chain is one {code} a step: "
              f"{sass[op]['by_opcode']}")
    for op, s in sass.items():
        check(s["instructions"] >= 1 and all(n == int(n) for n in s["by_opcode"].values()),
              f"the {op} chain is unrolled, every step kept: {s['by_opcode']}")

    # the op model of the flow kernels' rows in PERF.md, at these costs
    from nf_tpu_torch import PWQuadManager
    from nf_tpu_torch.ops import pwquad_train as pt

    sec = result["sec_per_op_per_element"]
    for plan, n_flow, args, kw, rows in P18_MODEL_ROWS:
        NF = PWQuadManager(n_flow=n_flow, seed=0, device=dev)
        NF.create_model(*args, **kw)
        for kernel, n in rows:
            mix = op_mix(pt, NF._flow, kernel)
            b_ms, b_by = bound_ms(*kernel_work(pt, NF._flow, kernel, n))
            model = op_model_ms(mix, n, sec)
            print(f"phase18 op model {plan} {kernel} n={n}: per sample {mix['flops']} FLOP of "
                  f"which {mix['expf']} expf and {mix['div']} divisions; at the measured costs "
                  f"{model:.5f} ms against the bound {b_ms:.5f} ms by {b_by} "
                  f"({model / b_ms:.2f}x) {card}")

    # the kernels line: one launch of the fma chain at K 320, grid 1024
    out = torch.empty((op_chain.SUB, op_chain.LANE), device=dev)
    grid = calibrate_ops.GRID
    scratch = torch.empty(-(-grid // op_chain.CHUNK) * op_chain.TILE, device=dev)
    ms = time_ms(lambda: op_chain.chain("fma", P18_K, grid, 1, dev, out=out, scratch=scratch))
    plain_ms = time_ms(lambda: op_chain.chain_ref("fma", P18_K, grid, 1, dev))
    flops = 2 * P18_K * op_chain.TILE * grid
    b_ms, b_by = bound_ms(flops, 4 + 4 * op_chain.TILE)
    print(f"phase18 fma chain K {P18_K} grid {grid}: {ms:.4f} ms (plain {plain_ms:.3f} ms), "
          f"bound {b_ms:.5f} ms by {b_by}, {b_ms / ms:.2%} of the bound; phase 18 "
          f"{time.perf_counter() - t_phase:.1f} s {card}")
    return {"launches": launches, "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by}


# ---- phase 19: the bin-axis scan kernel (ops/bin_scan)
# the three plans' scans: camel2d (4 bins, 1 transformed dim, batch 10000),
# zzmc (16 bins, 5 dims, minibatch 2^16), zz4l's first estimate (32 bins,
# 5 dims, 2^18); the kernels line reports zzmc's float32 forward scan
P19_SHAPES = (("camel2d", (10000, 1, 4)), ("zzmc", (1 << 16, 5, 16)),
              ("zz4l", (1 << 18, 5, 32)))
P19_GRAPH_LAUNCHES = 20                 # launches a timed graph holds
P19_HOST_CALLS = 2000                   # calls the host time is taken over


def graph_ms(fn, launches=P19_GRAPH_LAUNCHES):
    """Device milliseconds a call of ``fn``: ``launches`` calls captured in
    one CUDA graph, its replay timed (``time_ms``) over ``launches``; no host
    time between the launches."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    ms = time_ms(graph.replay) / launches
    del graph
    return ms


def host_us(fn, calls=P19_HOST_CALLS):
    """Host microseconds a call of ``fn``, on a tensor small enough that the
    device keeps up with the launches."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def phase19(dev, card):
    """The bin-axis scan (``ops/bin_scan``) at the three plans' shapes, float32
    and float64, forward and reversed: against its own order of adds (each
    row column by column) bit for bit and against the plain version (torch's
    scan) within two summation orders' rounding; then each one's device time
    a launch (``graph_ms``) beside its bound (bytes), the plain version's and
    the library's ``torch.cumsum`` (``library_ms``, the forward's own plain
    version); the wrapper's host time a call beside ``torch.cumsum``'s; its
    own launches counted.  Returns the kernels-line numbers; their
    ``launches`` are the main path's, phase 14's mixture's."""
    import torch

    from nf_tpu_torch.ops import bin_scan
    from nf_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    launches0 = profiling.BIN_SCAN_LAUNCHES
    worst, row, calls = 0.0, None, 0
    gen = torch.Generator(device=dev).manual_seed(19)
    for plan, shape in P19_SHAPES:
        for dtype in (torch.float32, torch.float64):
            x = torch.rand(shape, generator=gen, device=dev, dtype=dtype).exp()
            for reverse in (False, True):
                got = bin_scan.bin_cumsum(x, reverse)
                want = bin_scan.bin_cumsum_ordered(x, reverse)
                plain = bin_scan.bin_cumsum_ref(x, reverse)
                calls += 1
                torch.cuda.synchronize()
                u = torch.finfo(dtype).eps / 2
                rel = float(((got - plain).abs() / plain).max())
                check(torch.equal(got, want), f"bin_scan {plan} {dtype} reverse={reverse}: "
                      "the kernel's own order of adds bit for bit")
                check(rel <= 2 * shape[-1] * u, f"bin_scan {plan} {dtype} reverse={reverse}: "
                      f"{rel:.3e} from the plain version")
                worst = max(worst, float((got - plain).abs().max()))
                out = torch.empty_like(x)
                ms = graph_ms(lambda: bin_scan._launch(x, reverse))
                plain_ms = graph_ms(lambda: bin_scan.bin_cumsum_ref(x, reverse))
                library_ms = graph_ms(lambda: torch.cumsum(x, -1, out=out))
                calls += 1 + P19_GRAPH_LAUNCHES
                b_ms, b_by = bound_ms(x.numel(), 2 * x.numel() * x.element_size())
                print(f"phase19 {plan} {list(shape)} {str(dtype)[6:]} "
                      f"{'reverse' if reverse else 'forward'}: kernel {ms * 1e3:.2f} us, "
                      f"bound {b_ms * 1e3:.2f} us by {b_by} ({b_ms / ms:.1%}), plain "
                      f"{plain_ms * 1e3:.2f} us, library torch.cumsum {library_ms * 1e3:.2f} us "
                      f"({library_ms / ms:.1f}x the kernel); max rel gap to plain {rel:.2e} "
                      f"{card}")
                if plan == "zzmc" and dtype == torch.float32 and not reverse:
                    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                           "bound_ms": b_ms, "bound_by": b_by}
    check(profiling.BIN_SCAN_LAUNCHES - launches0 == calls,
          f"bin_scan counted {profiling.BIN_SCAN_LAUNCHES - launches0} launches of {calls}")

    # the wrapper's host time a call, on 64 rows of 4 bins: the device keeps up
    x = torch.rand((64, 1, 4), device=dev).exp()
    xg = x.clone().requires_grad_()
    wrapper = host_us(lambda: bin_scan.bin_cumsum(x))
    launch = host_us(lambda: bin_scan._launch(x, False))
    with_grad = host_us(lambda: bin_scan.bin_cumsum(xg).sum().backward())
    library = host_us(lambda: torch.cumsum(x, -1))
    library_with_grad = host_us(lambda: torch.cumsum(xg, -1).sum().backward())
    launches = profiling.BIN_SCAN_LAUNCHES - launches0
    print(f"phase19 host time a call ([64, 1, 4], {P19_HOST_CALLS} calls): bin_cumsum "
          f"{wrapper:.1f} us ({launch:.1f} us of it the launch without autograd), torch.cumsum "
          f"{library:.1f} us; with autograd, a scan, sum and backward: {with_grad:.1f} us against "
          f"torch.cumsum's {library_with_grad:.1f} us; {launches} launches of its own counted; "
          f"phase 19 {time.perf_counter() - t_phase:.1f} s {card}")
    return {"max_abs_err": worst, "host_us": wrapper, **row}


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
    from nf_tpu_torch.ops import _build, optim_step
    from nf_tpu_torch.ops import pwquad_sampler as ps
    from nf_tpu_torch.ops import pwquad_train as pt
    from nf_tpu_torch.training import optimizers
    from nf_tpu_torch.utils import profiling

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

    # ---- phase 5: the main path (the trainer at its default cadence:
    # chunks of epochs replayed as CUDA graphs, the optimizer's step the
    # update kernel), then the same run at epochs_per_sync=1 beside it
    exact = camel_exact()
    main_kw = dict(log=False, batch_size=10000, epochs=150, mini_batch_size=10000,
                   preburn_time=20, integrate=False, pretty_progressbar=False)
    NF = PWQuadManager(n_flow=2, seed=0, device="cuda")
    NF.create_model(2, 4, [3] * 3)
    ps.LAUNCHES = ps.SAMPLER_TILED_LAUNCHES = optim_step.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    NF._train_variance_forward_seq(camel, optimizers.adamax(2e-3, 1e-4), **main_kw)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    update_launches = optim_step.LAUNCHES
    n_epochs = NF._last_epoch + 1
    k0 = NF._bench[6]["k0"]
    # the same run per epoch, then at the default again: the process's first
    # training pays its start-up (kernels loaded on first use, cuBLAS)
    walls = []
    for cadence in (1, "auto"):
        other = PWQuadManager(n_flow=2, seed=0, device="cuda")
        other.create_model(2, 4, [3] * 3)
        t0 = time.perf_counter()
        other._train_variance_forward_seq(camel, optimizers.adamax(2e-3, 1e-4),
                                          epochs_per_sync=cadence, **main_kw)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / n_epochs * 1e3)
        if cadence == 1:
            equal, diffs = same_run(NF, other)
    print(f"phase5: default cadence (chunks of {k0}, CUDA graphs) {train_s / n_epochs * 1e3:.3f} "
          f"ms an epoch as the process's first training, {walls[1]:.3f} ms run again, against "
          f"{walls[0]:.3f} ms at epochs_per_sync=1 (train wall, host clock, capture included); "
          f"the default and the per-epoch run {'bit for bit' if equal else diffs}; update "
          f"kernel launches {update_launches} {card}")
    check(NF._bench[6]["graphs"] and update_launches == n_epochs,
          f"main path: {update_launches} update kernel launches in {n_epochs} graph-chunked "
          "epochs")
    check(equal, "main path: the default cadence equals epochs_per_sync=1 bit for bit")
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
    check(ps.SAMPLER_TILED_LAUNCHES == 0,
          f"main path (camel) launched the tiled sampler {ps.SAMPLER_TILED_LAUNCHES} times")

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
        # a warm-up and a timed rep, each a chunk of the run's length
        epochs_run = 2 * mgr._bench[6]["k0"]
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
    # the workspace backward at 2^18 beside its plain version (autograd of
    # folded_forward_ref) and its bound
    n_k = 1 << 18
    flat = pt.fold_flow(NF_w._model).detach()
    w_t = torch.rand((n_k, 2), generator=gen, device=dev)
    xbar, jbar = cotangents(n_k, 2)
    _, jac, stage = pt.train_forward(wide_plan, flat, w_t)
    flat_g, w_g = flat.clone().requires_grad_(True), w_t.clone().requires_grad_(True)
    outs = pt.folded_forward_ref(NF_w._flow, flat_g, w_g)
    ms = time_ms(lambda: pt.train_backward(wide_plan, flat, stage, jac, jbar, xbar,
                                           latents=w_t))
    plain_ms = time_ms(lambda: torch.autograd.grad(outs, (flat_g, w_g), (xbar, jbar),
                                                   retain_graph=True))
    del outs
    flops, nbytes = kernel_work(pt, NF_w._flow, "bwd", n_k)
    b_ms, b_by = bound_ms(flops, nbytes)
    print(f"phase11 wide128 bwd (workspace kernel) n={n_k}: {ms:.4f} ms (plain {plain_ms:.4f} "
          f"ms), bound {b_ms:.5f} ms by {b_by} ({flops / n_k:.0f} FLOP and {nbytes / n_k:.1f} B "
          f"per sample), {b_ms / ms:.2%} of the bound {card}")

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

    # ---- phase 14: the ZZ/Z' multi-channel path of examples/zz_multichannel.py
    mc_launches, mc_err = phase14(dev, card, gen, hold_train, perturb_bn)
    max_abs_err = max(max_abs_err, mc_err[0])

    # ---- phase 15: experiments and sweeps
    ex_launches, ex_err = phase15(dev, card, kind, hold_train)
    max_abs_err = max(max_abs_err, ex_err[0])

    # ---- phase 16: data parallelism
    dp_launches = phase16(dev, card, NF)

    # ---- phase 17: the chunked epoch cadence
    chunk_launches, chunk_err, update = phase17(dev, card, gen, hold_train)

    # ---- phase 18: the per-op cost calibration on the op-chain kernel
    chain = phase18(dev, card)

    # ---- phase 19: the bin-axis scan; every launch before it, the plain
    # paths' and the trainers' of phases 5-17 among them
    print(f"phases 5-18 launched the bin-axis scan {profiling.BIN_SCAN_LAUNCHES} times, phase "
          f"14's mixture {mc_launches[3]} of them")
    scan = phase19(dev, card)

    camel_t = timings["camel2d_trained"]
    camel_tt = train_t["camel2d_trained"]
    src = "nf_tpu_torch/ops/csrc/pwquad_train.cu"
    print(json.dumps({"kernels": [{
        "name": "pwquad_sampler",
        "route": "cuda",
        "source": "nf_tpu_torch/ops/csrc/pwquad_sampler.cu",
        "replaces": "nf_tpu/ops/pwquad_sampler.py:286",
        "launches": launches + eventgen_launches + zz_launches[0] + mc_launches[0]
        + ex_launches[0] + dp_launches[0],
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
        "launches": train_launches[0] + zz_launches[1] + mc_launches[1] + ex_launches[1]
        + dp_launches[1] + chunk_launches[0],
        "max_abs_err": max(train_err[0], zz_err[1], mc_err[1], ex_err[1], chunk_err[0]),
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
        "launches": train_launches[1] + zz_launches[2] + mc_launches[2] + ex_launches[2]
        + dp_launches[2] + chunk_launches[1],
        "max_abs_err": max(train_err[1], zz_err[2], mc_err[2], ex_err[2], chunk_err[1]),
        "ms": camel_tt["bwd_kernel_ms"],
        "plain_ms": camel_tt["bwd_plain_ms"],
        "bound_ms": bounds["camel2d_trained", "bwd"][0],
        "bound_by": bounds["camel2d_trained", "bwd"][1],
        "library_ms": None,
    }, {
        "name": "optim_step",
        "route": "cuda",
        "source": "nf_tpu_torch/ops/csrc/optim_step.cu",
        "replaces": "torch.optim Adamax/Adam foreach step (nf_tpu: optax, no Pallas kernel)",
        "launches": update_launches + chunk_launches[2],
        "max_abs_err": update["max_abs_err"],
        "ms": update["ms"],
        "plain_ms": update["plain_ms"],
        "bound_ms": update["bound_ms"],
        "bound_by": "bytes",
        "library_ms": update["library_ms"],
    }, {
        "name": "op_chain",
        "route": "cuda",
        "source": "nf_tpu_torch/ops/csrc/op_chain.cu",
        "replaces": "tools/calibrate_vpu_ops.py:62",
        "launches": chain["launches"],
        "max_abs_err": chain["max_abs_err"],
        "ms": chain["ms"],
        "plain_ms": chain["plain_ms"],
        "bound_ms": chain["bound_ms"],
        "bound_by": chain["bound_by"],
        "library_ms": None,
    }, {
        "name": "bin_scan",
        "route": "cuda",
        "source": "nf_tpu_torch/ops/csrc/bin_scan.cu",
        "replaces": "none: nf_tpu leaves the bin-axis jnp.cumsum to XLA",
        "launches": mc_launches[3],
        "max_abs_err": scan["max_abs_err"],
        "ms": scan["ms"],
        "plain_ms": scan["plain_ms"],
        "bound_ms": scan["bound_ms"],
        "bound_by": scan["bound_by"],
        "library_ms": scan["library_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
