"""``_train_variance_forward_seq``, the trainer, back to back.

Set-up builds the manager with the benchmark's parameters and drives it
through its first steps in the window's own call: a call of one epoch, then
one of two (each draws a fresh optimizer, as every call does).  The check
holds their losses, the first step's gradient as the optimizer took it, and
the parameters' change over the three steps against the reference.  The
window then continues the same model (``fresh_model: false``) or, per call,
trains a fresh model from the benchmark's parameters of that call's seed.
"""

from __future__ import annotations

import torch

from benchmark.drivers.common import Base, derive
from benchmark.reference import checks, flow
from benchmark.reference import integrands as plain
from benchmark.reference.train import Trainer

CHECK_EPOCHS = (1, 2)


class Driver(Base):
    def _train(self, epochs, seed):
        from nf_tpu_torch.training import optimizers

        tr, wl = self.cfg["training"], self.wl
        self.nf._train_variance_forward_seq(
            self.f, optimizers.adamax(tr["lr"], tr["weight_decay"]), log=False,
            batch_size=tr["batch_size"], epochs=epochs, pretty_progressbar=False,
            mini_batch_size=tr["mini_batch_size"], integrate=False,
            preburn_time=tr["preburn_time"], kill_counter=tr["kill_counter"],
            loss_mode=tr["loss_mode"], select_best_by=tr["select_best_by"], seed=seed,
            bn_stats=wl["bn_stats"], stats_every=wl.get("stats_every", 4))
        return len(self.nf.history)

    def setup(self):
        self.p0 = self.params()
        self.nf = self.manager(self.p0)
        self.mark("model")
        self.check_seeds = [derive(self.seed, "check", k) for k in range(len(CHECK_EPOCHS))]
        losses = []
        for k, (seed, epochs) in enumerate(zip(self.check_seeds, CHECK_EPOCHS)):
            self.f.record = [] if k == 0 else None
            self._train(epochs, seed)
            losses += list(self.nf.history)
            if k == 0:
                # the first epoch's minibatches, after the first estimate's
                # n_flow calls (the epoch's graph capture calls f again)
                n_mb = self.cfg["training"]["batch_size"] // self.cfg["training"]["mini_batch_size"]
                points = self.f.record[self.plan.n_flow:self.plan.n_flow + n_mb]
                self.f.record = None
                b1 = self.nf._optimizer.param_groups[0]["betas"][0]
                state = self.nf._optimizer.state
                grad = {n: (state[p]["exp_avg"] if "exp_avg" in state.get(p, {})
                            else torch.zeros_like(p)).detach().clone() / (1 - b1)
                        for n, p in self.nf._model.named_parameters()}
        self.program = {"loss": losses, "grad": grad, "x": points,
                        "params": {n: p.detach().clone() for n, p in self.nf._model.named_parameters()}}
        self.epochs_run = []
        self.mark("check_calls")

    def call(self, i):
        wl = self.wl
        if wl["fresh_model"]:
            self.nf = self.manager(self.params(derive(self.seed, "job", i)))
        epochs = self._train(wl["epochs"], derive(self.seed, "call", i))
        if wl["all_epochs"] and epochs != wl["epochs"]:
            raise RuntimeError(f"call {i} ran {epochs} of its {wl['epochs']} epochs")
        self.epochs_run.append(epochs)
        return {"samples": epochs * self.cfg["training"]["batch_size"], "epochs": epochs}

    def free(self):
        del self.nf

    def train_cfg(self):
        tr = self.cfg["training"]
        return {"batch_size": tr["batch_size"], "mini_batch_size": tr["mini_batch_size"],
                "preburn_time": tr["preburn_time"], "kill_counter": tr["kill_counter"],
                "bn_stats": self.wl["bn_stats"], "stats_every": self.wl.get("stats_every", 4),
                "lr": tr["lr"], "betas": (0.9, 0.999), "eps": 1e-8,
                "weight_decay": tr["weight_decay"]}

    def reference(self, dtype=torch.float64, mm=flow.matmul, trainer=Trainer):
        f = plain.INTEGRANDS[self.cfg["integrand"]]
        return checks.train_outputs(self.p0, self.plan, f, self.check_seeds, CHECK_EPOCHS,
                                    self.train_cfg(), self.device, dtype, mm, trainer)

    def check(self):
        return self.limits(checks.train_numbers(self.program, self.reference(), self.p0))
