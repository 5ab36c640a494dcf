"""What every driver shares: the program's manager with the benchmark's
parameters, and the seeds of a run."""

from __future__ import annotations

import random
import time

import torch

from benchmark import integrands, weights
from benchmark.weights import derive


class Base:
    """``ctx``: the run's seed, device, configuration (``cfg``), traffic
    (``wl``) and the flow's plan.  ``call(i)`` is one user call; ``check()``
    returns ``[(name, value, limit)]`` once the window has closed."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.seed, self.device, self.cfg, self.wl, self.plan = \
            ctx.seed, ctx.device, ctx.cfg, ctx.wl, ctx.plan
        self.f = integrands.Spanned(integrands.BUILD[self.cfg["integrand"]]())
        self.setup_parts, self._t = {}, time.perf_counter()

    def mark(self, part):
        """Time the set-up's ``part``, which ends here, for the report."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.setup_parts[part] = now - self._t
        self._t = now

    def params(self, seed=None):
        """The benchmark's parameters from ``seed``: by default the cell's
        ``weights_seed`` where it fixes one (the same flow in every run),
        else the run's."""
        if seed is None:
            seed = self.wl.get("weights_seed", self.seed)
        return weights.make_params(self.plan, self.cfg["init"], seed, self.device)

    def manager(self, p0):
        """A manager whose model holds ``p0``, made as a user makes one."""
        from nf_tpu_torch import PWQuadManager

        fl = self.cfg["flow"]
        nf = PWQuadManager(n_flow=fl["n_flow"], seed=derive(self.seed, "manager"),
                           device=self.device)
        nf.create_model(fl["n_cells"], fl["n_bins"], fl["hidden"],
                        identity_init=self.cfg["init"]["kind"] == "identity_perturbed")
        self.load(nf, p0)
        return nf

    @staticmethod
    def load(nf, p0):
        missing = set(nf._model.state_dict()) ^ set(p0)
        if missing:
            raise RuntimeError(f"the benchmark's parameters and the model's differ: {sorted(missing)}")
        nf._model.load_state_dict(p0)

    def bn_latents(self):
        gen = torch.Generator(device=self.device).manual_seed(derive(self.seed, "bn"))
        return torch.rand((self.wl["bn_pass"], self.plan.n_flow), generator=gen,
                          dtype=torch.float32, device=self.device)

    def picks(self):
        """The window's calls the check compares, drawn from the seed."""
        chk = self.wl["check"]
        return set(random.Random(derive(self.seed, "pick")).sample(range(chk["among_first"]),
                                                                    chk["calls"]))

    def limits(self, numbers):
        """``[(name, value, limit)]`` of the compared numbers; the others are
        kept in ``info`` for the report."""
        lim = self.wl["limits"]
        self.info = {k: v for k, v in numbers.items() if k not in lim}
        return [(name, numbers.get(name, float("inf")), lim[name]) for name in lim]


def worst(dicts):
    """The largest value of each number over several checked calls."""
    out = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = max(out.get(k, 0.0), v)
    return out
