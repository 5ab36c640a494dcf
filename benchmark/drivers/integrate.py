"""``BasicManager.integrate(f, nitn, neval, seed=...)``, back to back: the
integration path users call interactively."""

from __future__ import annotations

import torch

from benchmark.drivers.common import Base, derive, worst
from benchmark.reference import checks, flow
from benchmark.reference import integrands as plain


class Driver(Base):
    def setup(self):
        self.p0 = self.params()
        self.nf = self.manager(self.p0)
        with torch.no_grad():
            self.nf._model(self.bn_latents(), True)     # the one seeded statistics pass
        self.nf.best_model = self.nf._model
        self.pick, self.records = self.picks(), []
        self.mark("model")
        for i in range(self.wl.get("warm_calls", 2)):
            self.call(-1 - i)
        self.mark("warm_calls")

    def call(self, i):
        wl = self.wl
        if i in self.pick:
            self.f.record = []
        sig, err = self.nf.integrate(self.f, wl["nitn"], wl["neval"], seed=derive(self.seed, "call", i))
        if self.f.record is not None:
            self.records.append({"seed": derive(self.seed, "call", i), "x": self.f.record,
                                 "result": (sig, err)})
            self.f.record = None
        return {"samples": wl["nitn"] * wl["neval"]}

    def free(self):
        del self.nf

    def reference(self, dtype=torch.float64, mm=flow.matmul, seeds=None, combine="weighted"):
        """The reference's (or with ``dtype`` and ``mm`` the control's, with
        ``combine="plain"`` the planted fault's) outputs of each checked
        call."""
        wl = self.wl
        p = checks.eval_params(self.p0, self.plan, self.bn_latents(), dtype, mm)
        f = plain.INTEGRANDS[self.cfg["integrand"]]
        return [checks.integrate_outputs(p, self.plan, f, s, wl["nitn"], wl["neval"],
                                         self.device, dtype, mm, combine)
                for s in (seeds or [r["seed"] for r in self.records])]

    def check(self):
        nums = worst(checks.integrate_numbers(r, ref)
                     for r, ref in zip(self.records, self.reference()))
        return self.limits(nums)
