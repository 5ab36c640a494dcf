"""``training.unweight.generate_unweighted(..., partial_unweight=True)``,
back to back at a w_max fixed by a pilot in set-up: production event
generation."""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.drivers.common import Base, derive, worst
from benchmark.reference import checks, flow
from benchmark.reference import integrands as plain


class Driver(Base):
    def _generate(self, i, n_events, w_max, max_batches=1000):
        from nf_tpu_torch.training.unweight import generate_unweighted

        wl = self.wl
        gen = torch.Generator(device=self.device).manual_seed(derive(self.seed, "call", i))
        return generate_unweighted(self.nf._flow, self.nf._model, self.f, gen, n_events,
                                   w_max=w_max, batch=wl["batch"], max_batches=max_batches,
                                   wmax_quantile=wl["wmax_quantile"], partial_unweight=True)

    def setup(self):
        wl = self.wl
        self.p0 = self.params()
        self.nf = self.manager(self.p0)
        with torch.no_grad():
            self.nf._model(self.bn_latents(), True)     # the one seeded statistics pass
        self.pick, self.records = self.picks(), []
        self.mark("model")
        # the pilot fixes w_max, and the warm call's accept rate the events
        # a call asks for: a share of what its batches are expected to accept
        self.f.record = []
        events, wts, info = self._generate(-1, 1 << 62, None, wl["warm_batches"])
        self.w_max = info["w_max"]
        self.records.append({"seed": derive(self.seed, "call", -1), "pilot_x": self.f.record[0],
                             "w_max": self.w_max, "x": self.f.record[1:], "events": events,
                             "weights": wts})
        self.f.record = None
        self.n_events = max(1, math.floor(wl["events_share"] * wl["batches_per_call"] * wl["batch"]
                                          * info["accept_rate"]))
        self.mark("pilot_and_warm_call")
        self.call(-2)
        self.mark("second_warm_call")

    def call(self, i):
        if i in self.pick:
            self.f.record = []
        before = self.f.calls
        events, wts, info = self._generate(i, self.n_events, self.w_max)
        if self.f.record is not None:
            self.records.append({"seed": derive(self.seed, "call", i), "x": self.f.record,
                                 "events": events, "weights": wts})
            self.f.record = None
        w = np.asarray(wts, np.float64)
        return {"proposals": (self.f.calls - before) * self.wl["batch"], "events": len(events),
                "sum_w": float(w.sum()), "sum_w2": float((w * w).sum())}

    def free(self):
        del self.nf

    def check(self):
        """Each checked call against the reference's replay of it, at the
        w_max the call was given (the warm call's pilot judged apart)."""
        wl = self.wl
        p = checks.eval_params(self.p0, self.plan, self.bn_latents(), torch.float64, flow.matmul)
        f = plain.INTEGRANDS[self.cfg["integrand"]]
        dist = plain.CUT_DISTANCE.get(self.cfg["integrand"])
        numbers = []
        for r in self.records:
            ref = checks.unweight_outputs(
                p, self.plan, f, r["seed"], len(r["x"]), wl["batch"], r.get("w_max", self.w_max),
                self.device, torch.float64, flow.matmul,
                pilot=r["pilot_x"].shape[0] if "pilot_x" in r else 0,
                quantile_q=wl["wmax_quantile"])
            numbers.append(checks.unweight_numbers(r, ref, f, dist))
        return self.limits(worst(numbers))
