"""The plain trainer: the first epochs of one training call, step by step.

It follows the variance-loss trainer of the reference implementation as the
configuration states it (Muller et al., arXiv:1808.03856; the reference's
``_train_variance_forward_seq``):

* a first estimate on ``n_flow`` batches of ``2 mb`` raw latents gives
  ``maxf``, the largest f seen, and the initial loss; then one train-mode
  forward of the last of them moves the BatchNorm running statistics;
* an epoch draws ``batch / mb`` minibatches of latents and, on each, maps
  them (``"batch"``: train-mode BatchNorm; ``"stale"``: the running
  statistics held fixed), takes the loss ``var(f(x) J / maxf)`` -- during
  preburn with ``f`` on the latents themselves -- and adds its gradient,
  which flows through ``J`` only; the mean gradient then takes one Adamax
  step (the weight decay added to the gradient first);
* the stale trainer then, every ``stats_every`` epochs, moves the running
  statistics by one momentum step towards each BatchNorm input's moments
  over a fresh batch of ``min(mb, 2^16)`` latents under the running
  statistics;
* preburn ends once an epoch's loss falls below a quarter of the initial
  loss, or after ``preburn_time`` epochs, or by the kill counter.

The latents are drawn from a ``torch.Generator`` in the order the trainer
draws them, in float32, and mapped in ``dtype``.
"""

from __future__ import annotations

import torch

from benchmark.reference import flow


def _draw(gen, shape):
    return torch.rand(shape, generator=gen, dtype=torch.float32, device=gen.device)


def _mean_var(xs):
    n = xs.shape[-1]
    means = torch.sum(xs, -1) / n
    dev = xs - means[:, None]
    return means, torch.sum(dev * dev, -1) / (n - 1)


def adamax(params, grads, state, step, lr, betas, eps, weight_decay):
    """One Adamax step in place (torch's ``Adamax``): the decay added to the
    gradient, then the moments, then the bias-corrected update."""
    b1, b2 = betas
    for key, p in params.items():
        g = grads[key] + weight_decay * p
        m, u = state.setdefault(key, (torch.zeros_like(p), torch.zeros_like(p)))
        m = b1 * m + (1 - b1) * g
        u = torch.maximum(b2 * u, torch.abs(g) + eps)
        state[key] = (m, u)
        params[key] = p - lr / (1 - b1 ** step) * m / u


class Trainer:
    """One training run's state: the parameters (float ``dtype`` leaves)
    and BatchNorm buffers, both in ``self.p``, and the generator."""

    def __init__(self, plan, f, p0, gen, cfg, dtype=torch.float64, mm=flow.matmul,
                 block=1 << 16):
        self.plan, self.f, self.gen, self.cfg, self.mm = plan, f, gen, cfg, mm
        self.dtype, self.block = dtype, block
        self.p = {k: v.to(dtype) for k, v in p0.items()}

    @staticmethod
    def minibatch(w):
        """The rows of a minibatch the loss takes: all of them."""
        return w

    def _params(self):
        return {k: v for k, v in self.p.items() if not flow.is_buffer(k)}

    def _f(self, w):
        return torch.cat([self.f(w[i:i + self.block]) for i in range(0, w.shape[0], self.block)])

    def _stale_loss_grad(self, p, params, w, pre, maxf):
        """The loss, its gradient and the points ``f`` took on one minibatch
        under the running statistics, in row blocks: each sample maps
        alone, so the gradient of the unbiased variance of ``h`` is the sum
        over blocks of that of ``2 / (n - 1) (h - mean(h)) h``, the mean
        held fixed."""
        seen = []

        def head(wb):
            x, jac = flow.forward(p, self.plan, wb, "eval", self.mm)
            with torch.no_grad():
                pts = wb if pre else x.detach()
                seen.append(pts)
                g = self.f(pts)
            return g * jac / maxf
        blocks = [w[i:i + self.block] for i in range(0, w.shape[0], self.block)]
        with torch.no_grad():
            h = torch.cat([head(wb) for wb in blocks])
        points = torch.cat(seen)
        n, mean = h.shape[0], torch.mean(h)
        grads = [torch.zeros_like(v) for v in params.values()]
        for wb in blocks:
            hb = head(wb)
            part = torch.sum(2.0 / (n - 1) * (hb.detach() - mean) * hb)
            for acc, g in zip(grads, torch.autograd.grad(part, list(params.values()))):
                acc += g
        return torch.var(h), grads, points

    def call(self, epochs):
        """One trainer call of ``epochs`` epochs with a fresh optimizer:
        returns ``{"loss": [per epoch], "opt": {key: (m, u)}, "points":
        [the points f took on each minibatch of the first epoch]}`` and
        leaves the parameters and buffers in ``self.p``."""
        cfg, plan = self.cfg, self.plan
        mb, n_flow = cfg["mini_batch_size"], plan.n_flow
        n_mb = cfg["batch_size"] // mb
        # the first estimate: maxf and the initial loss
        maxf = torch.zeros((), dtype=self.dtype, device=self.gen.device)
        best_loss = 0.0
        for _ in range(n_flow):
            w = _draw(self.gen, (2 * mb, n_flow)).to(self.dtype)
            fres = self._f(w)
            maxf = torch.maximum(maxf, torch.max(fres))
            g = fres / maxf
            best_loss += float(_mean_var(torch.stack([fres, g]))[1][1]) / n_flow
        with torch.no_grad():
            new = {}
            flow.forward(self.p, plan, w, "train", self.mm, new_stats=new)
            self.p.update(new)

        state, losses, first_points = {}, [], []
        pre, counter, last_loss = cfg["preburn_time"] > 0, 0, 1000.0
        for i in range(epochs):
            ws = [_draw(self.gen, (mb, n_flow)).to(self.dtype) for _ in range(n_mb)]
            params = {k: v.clone().requires_grad_(True) for k, v in self._params().items()}
            grads = {k: torch.zeros_like(v) for k, v in params.items()}
            epoch_losses = []
            for w in ws:
                w = self.minibatch(w)
                p = dict(self.p, **params)
                if cfg["bn_stats"] == "batch":
                    new = {}
                    x, jac = flow.forward(p, plan, w, "train", self.mm, new_stats=new)
                    points = w if pre else x.detach()
                    with torch.no_grad():
                        g = self._f(points)
                    loss = torch.var(g * jac / maxf)
                    gr = torch.autograd.grad(loss, list(params.values()))
                    self.p.update({k: v.detach() for k, v in new.items()})
                else:
                    loss, gr, points = self._stale_loss_grad(p, params, w, pre, maxf)
                if i == 0:
                    first_points.append(points)
                for key, g in zip(params, gr):
                    grads[key] += g
                epoch_losses.append(float(loss.detach()))
            with torch.no_grad():
                plain = {k: v.detach() for k, v in params.items()}
                adamax(plain, {k: v / n_mb for k, v in grads.items()}, state, i + 1,
                       cfg["lr"], cfg["betas"], cfg["eps"], cfg["weight_decay"])
                self.p.update(plain)
            loss = sum(epoch_losses) / n_mb
            losses.append(loss)
            # the preburn and kill-counter state machine (no stop in these epochs)
            counter = 0 if loss < last_loss else counter + 1
            if counter > cfg["kill_counter"] and pre:
                counter, pre = 0, False
            last_loss = loss
            if pre and (loss < 0.25 * best_loss or i > cfg["preburn_time"]):
                pre = False
            if cfg["bn_stats"] == "stale" and i % cfg["stats_every"] == 0:
                w = _draw(self.gen, (min(mb, 1 << 16), n_flow)).to(self.dtype)
                stats = {}
                with torch.no_grad():
                    flow.forward(self.p, plan, w, "eval", self.mm, stats=stats)
                self.p.update(flow.stats_update(self.p, stats, w.shape[0]))
        return {"loss": losses, "opt": state, "points": first_points}
