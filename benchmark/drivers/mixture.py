"""``train_multichannel``, the learned multi-channel trainer, back to back.

Set-up builds the configuration's channels, matrix element and per-channel
flows as ``examples/zz_multichannel.py`` builds them, loads the benchmark's
parameters into the flows (:func:`make_params`), and moves the alphas from
``[0.5, 0.5]`` by ``optimize_alphas``.  Then it runs the window's call with
1 epoch and then with 2, each from a check seed, continuing the flows and
the alphas; it keeps each epoch's loss and alphas, the first step's
gradient as the optimizer took it, the parameters' change and the first
epoch's source points (each source flow's forward output).  The window's
calls continue the flows and the alphas of the call before, each with a
fresh optimizer and a generator of its own seed.  The check holds the kept
numbers against :mod:`benchmark.reference.mixture` in float64.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import integrands
from benchmark.drivers.common import Base
from benchmark.reference import checks, flow
from benchmark.reference import mixture as ref
from benchmark.weights import derive

CHECK_EPOCHS = (1, 2)


def make_params(plan, rank, init, seed, device, proc_channel):
    """Channel ``proc_channel``'s flow from ``seed``: every parameter drawn
    as :func:`benchmark.weights.make_params` draws it, the factored final
    layer's ``u`` at its default ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` (the
    identity start keeps it), ``v`` and ``b`` at ``scale / sqrt(rank)``;
    then the running statistics from one seeded train-mode pass of
    ``bn_pass`` uniform latents through the plain flow, in float64.  Float32
    tensors keyed as the program's ``state_dict``."""
    shapes = ref.param_shapes(plan, rank)
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights", proc_channel))
    u = torch.rand(sum(torch.Size(s).numel() for s in shapes.values()), generator=gen,
                   dtype=torch.float32, device=device) * 2.0 - 1.0
    s = float(init["scale"])
    out, off = {}, 0
    for key, shape in shapes.items():
        n = torch.Size(shape).numel()
        r = u[off:off + n].reshape(shape)
        off += n
        leaf = key.rsplit(".", 1)[1]
        if leaf == "mean":
            out[key] = torch.zeros(shape, dtype=torch.float32, device=device)
        elif leaf == "var":
            out[key] = torch.ones(shape, dtype=torch.float32, device=device)
        elif ".bn" in key:
            out[key] = (1.0 if leaf == "scale" else 0.0) + s * r
        elif key.endswith(("final.v", "final.b")):
            out[key] = r * s / rank ** 0.5
        else:
            out[key] = r / shape[0] ** 0.5
    gen = torch.Generator(device=device).manual_seed(derive(seed, "bn", proc_channel))
    w = torch.rand((init["bn_pass"], plan.n_flow), generator=gen, dtype=torch.float32,
                   device=device)
    moved = ref.bn_pass({k: v.double() for k, v in out.items()}, plan, w.double())
    return {k: moved[k].float() if flow.is_buffer(k) else v for k, v in out.items()}


def numbers(out, ref_out, p0):
    """:func:`benchmark.reference.checks.train_numbers` of the mixture's
    calls, and ``alpha_gap``: the worst epoch's largest relative gap of
    the alphas.  Not compared (``info``): ``integral_gap`` and ``ess_gap``,
    the worst epoch's relative gaps of the history's integral and ESS."""
    nums = checks.train_numbers(out, ref_out, p0)
    if len(out["alphas"]) != len(ref_out["alphas"]):
        nums["alpha_gap"] = checks.INF
    else:
        nums["alpha_gap"] = max(float(torch.max(torch.abs(a.double().cpu() - b.double().cpu())
                                                / b.double().cpu()))
                                for a, b in zip(out["alphas"], ref_out["alphas"]))
    for key in ("integral", "ess"):
        nums[f"{key}_gap"] = checks.INF if len(out[key]) != len(ref_out[key]) else max(
            checks._rel(a, b) for a, b in zip(out[key], ref_out[key]))
    return nums


class Driver(Base):
    def __init__(self, ctx):
        # Base.__init__ builds a single-flow cell's integrand; this cell
        # builds its channels and matrix element in set-up
        self.ctx = ctx
        self.seed, self.device, self.cfg, self.wl = ctx.seed, ctx.device, ctx.cfg, ctx.wl
        fl = self.cfg["flow"]
        self.plan = flow.pwquad_plan(fl["n_flow"], fl["n_cells"], fl["n_bins"], fl["hidden"])
        self.rank, self.n_channels = fl["final_rank"], fl["channels"]
        self.proc = ref.process(self.cfg["integrand"])
        self.setup_parts, self._t = {}, time.perf_counter()
        self.epochs_run, self._record = [], None

    # -- the program, as the example builds it -------------------------------

    def _build(self):
        from nf_tpu_torch.phasespace import lorentz
        from nf_tpu_torch.phasespace.pdf import ToyPDF
        from nf_tpu_torch.phasespace.topology import BreitWignerSMap, ResonanceDecayPhasespace

        spec = self.cfg["integrand"]
        res = {"z": spec["z"], "zprime": spec["zprime"]}
        channels = []
        for ch in spec["channels"]:
            (i, j), (k, l) = ch["pairs"]
            m, g = res[ch["resonance"]]
            channels.append(ResonanceDecayPhasespace(
                [0.0, 0.0], [0.0] * 4, ((i, j), (k, l)),
                mass_maps={(min(i, j), max(i, j)): BreitWignerSMap(m, g),
                           (min(k, l), max(k, l)): BreitWignerSMap(m, g)},
                pdf=ToyPDF(), pdf_active=spec["pdf_active"], tau=spec["tau"]))
        (mz, gz), (mzp, gzp), coupling = spec["z"], spec["zprime"], spec["zprime_coupling"]

        def bw(s, m, g):
            return 1e4 / ((s - m * m) ** 2 + (m * g) ** 2)

        def matrix_element(momenta):
            f = momenta[:, 2:, :]
            s01 = lorentz.square(f[:, 0] + f[:, 1])
            s23 = lorentz.square(f[:, 2] + f[:, 3])
            s03 = lorentz.square(f[:, 0] + f[:, 3])
            s12 = lorentz.square(f[:, 1] + f[:, 2])
            return (bw(s01, mz, gz) * bw(s23, mz, gz)
                    + coupling * bw(s03, mzp, gzp) * bw(s12, mzp, gzp))

        self.channels = channels
        self.me = integrands.Spanned(matrix_element)
        self.cuts = dict(spec["cuts"], pdgs=tuple(spec["pdgs"]))

    def _optimizer(self, params):
        """The example's optimizer factory, which keeps the optimizer it
        makes: the check reads the first step's moment from it."""
        from nf_tpu_torch.training import optimizers

        tr = self.cfg["training"]
        self.opt = optimizers.adamax(tr["lr"], tr["weight_decay"])(params)
        return self.opt

    def _train(self, models, alphas, epochs, seed):
        from nf_tpu_torch.training.multichannel import train_multichannel

        tr = self.cfg["training"]
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return train_multichannel(
            self.channels, models, self.me, self.proc.e_cm, self._optimizer, gen,
            alphas=alphas, batch_per_channel=tr["batch_per_channel"], epochs=epochs,
            loss_mode=tr["loss_mode"], learn_alphas=tr["learn_alphas"],
            alpha_damping=tr["alpha_damping"], alpha_floor=tr["alpha_floor"],
            mini_batch_per_channel=tr["mini_batch_per_channel"], epochs_per_call=epochs,
            **self.cuts)

    def _hook(self, module, args, output):
        from nf_tpu_torch.flows.model import FlowModel

        if isinstance(module, FlowModel):
            self._record.append(output[0].detach().clone())

    def setup(self):
        from nf_tpu_torch.phasespace.topology import optimize_alphas
        from nf_tpu_torch.training.multichannel import build_channel_flows

        fl, al = self.cfg["flow"], self.cfg["alphas"]
        self._build()
        self.p0 = [make_params(self.plan, self.rank, self.cfg["init"], self.seed, self.device, k)
                   for k in range(self.n_channels)]
        gen = torch.Generator(device=self.device).manual_seed(derive(self.seed, "manager"))
        models = build_channel_flows(gen, self.channels, fl["n_cells"], fl["n_bins"],
                                     fl["hidden"], device=self.device, final_rank=self.rank)
        for m, p in zip(models, self.p0):
            missing = set(m.state_dict()) ^ set(p)
            if missing:
                raise RuntimeError(f"the benchmark's parameters and the flow's differ: "
                                   f"{sorted(missing)}")
            m.load_state_dict(p)
        self.mark("model")
        gen = torch.Generator(device=self.device).manual_seed(derive(self.seed, "alphas"))
        self.alphas0, _ = optimize_alphas(self.me, self.channels, al["start"], self.proc.e_cm,
                                          gen, n_iter=al["n_iter"], n_samples=al["n_samples"],
                                          **self.cuts)
        self.mark("alphas")

        # the check's calls: the forward hook keeps every source flow's
        # output (the pilot's first, then each minibatch's, source by source)
        self.check_seeds = [derive(self.seed, "check", k) for k in range(len(CHECK_EPOCHS))]
        self._record = []
        handle = torch.nn.modules.module.register_module_forward_hook(self._hook)
        try:
            out = self._train(models, self.alphas0, CHECK_EPOCHS[0], self.check_seeds[0])
        finally:
            handle.remove()
        tr = self.cfg["training"]
        n_mb = tr["batch_per_channel"] // tr["mini_batch_per_channel"]
        points = self._record[self.n_channels:self.n_channels * (1 + n_mb)]
        self._record = None
        b1 = self.opt.param_groups[0]["betas"][0]
        grad = {f"{c}.{n}": self.opt.state[p]["exp_avg"].detach().clone() / (1 - b1)
                for c, m in enumerate(out["params"]) for n, p in m.named_parameters()}
        hist = [out["history"]]
        out = self._train(out["params"], out["alphas"], CHECK_EPOCHS[1], self.check_seeds[1])
        hist.append(out["history"])
        self.program = {
            "loss": [float(v) for h in hist for v in h["loss"]],
            "integral": [float(v) for h in hist for v in h["integral"]],
            "ess": [float(v) for h in hist for v in h["ess"]],
            "alphas": [torch.as_tensor(a, dtype=torch.float64) for h in hist for a in h["alphas"]],
            "grad": grad, "x": points,
            "params": {f"{c}.{n}": p.detach().clone() for c, m in enumerate(out["params"])
                       for n, p in m.named_parameters()}}
        self.models, self.alphas = out["params"], out["alphas"]
        self.opt = None
        self.mark("check_calls")

    @staticmethod
    def _counts():
        """The program's counters: host reads, and flow inverses where it
        counts them (a program without that counter counts neither for the
        mixture)."""
        from nf_tpu_torch.utils import profiling

        inv = getattr(profiling, "FLOW_INVERSES", None)
        return (None, None) if inv is None else (profiling.HOST_READS, inv)

    def call(self, i):
        epochs = self.wl["epochs"]
        reads0, inv0 = self._counts()
        out = self._train(self.models, self.alphas, epochs, derive(self.seed, "call", i))
        reads1, inv1 = self._counts()
        self.opt = None
        ran = len(out["history"]["loss"])
        if ran != epochs:
            raise RuntimeError(f"call {i} ran {ran} of its {epochs} epochs")
        self.models, self.alphas = out["params"], out["alphas"]
        self.epochs_run.append(ran)
        samples = ran * self.n_channels * self.cfg["training"]["batch_per_channel"]
        return {"samples": samples, "epochs": ran,
                "host_reads": None if reads0 is None else reads1 - reads0,
                "flow_inverses": None if inv0 is None else inv1 - inv0}

    def free(self):
        del self.models

    def train_cfg(self):
        tr = self.cfg["training"]
        return {"batch_per_channel": tr["batch_per_channel"],
                "mini_batch_per_channel": tr["mini_batch_per_channel"], "lr": tr["lr"],
                "betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": tr["weight_decay"],
                "alpha_damping": tr["alpha_damping"], "alpha_floor": tr["alpha_floor"]}

    def reference(self, dtype=torch.float64, mm=flow.matmul, fault=None):
        return ref.train_outputs(self.p0, self.plan, self.proc, self.check_seeds, CHECK_EPOCHS,
                                 np.asarray(self.alphas0, np.float64), self.train_cfg(),
                                 self.device, dtype, mm, fault)

    def flat_p0(self):
        return {f"{c}.{k}": v for c, p in enumerate(self.p0) for k, v in p.items()
                if not flow.is_buffer(k)}

    def check(self):
        return self.limits(numbers(self.program, self.reference(), self.flat_p0()))
