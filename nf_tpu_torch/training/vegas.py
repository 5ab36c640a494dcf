"""Classic VEGAS (separable adaptive importance sampling) in torch.

Counterpart of ``nf_tpu.training.vegas``, the baseline the reference
benchmarks NIS against (reference utils/experiment_mgv.py:37-40): G.P.
Lepage's per-dimension adaptive grid, damped importance redistribution and
the inverse-variance combination of iterations, computed on the device of
the integrator.  The per-bin importance is one ``index_add_``; on a CUDA
device that sum uses atomics, so float64 edges may differ from run to run
in the last bits.

The latents come from the integrator's ``torch.Generator`` through the
module-level :func:`_uniform` (a hook: tests replay nf_tpu's draws through
it).  The draws are the port's own and do not match nf_tpu's.
"""

from __future__ import annotations

import numpy as np
import torch


def _uniform(generator, shape, dtype, device):
    return torch.rand(shape, generator=generator, dtype=dtype, device=device)


class VegasIntegrator:
    """``dtype=None`` is ``torch.float32``, nf_tpu's default without x64.
    ``device`` is the card unless the caller asks for the CPU; without a
    CUDA device the card raises."""

    def __init__(self, n_dim, n_bins=50, alpha=0.75, seed=0, dtype=None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"VegasIntegrator: no CUDA device for device={device!r}; "
                               "pass device='cpu' to run on the CPU")
        self.n_dim = n_dim
        self.n_bins = n_bins
        self.alpha = alpha
        self.dtype = torch.float32 if dtype is None else dtype
        # edges: [n_dim, n_bins + 1], uniformly initialized
        self.edges = torch.linspace(0.0, 1.0, n_bins + 1, dtype=self.dtype,
                                    device=self.device).repeat(n_dim, 1)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    def _map(self, edges, y):
        """Map uniform ``y [B, D]`` through the grid; returns
        ``(x, jac [B], iy [B, D])``."""
        nb = self.n_bins
        z = y * nb
        iy = torch.clamp(torch.floor(z).long(), 0, nb - 1)
        frac = z - iy
        e_lo = torch.gather(edges, 1, iy.T).T
        e_hi = torch.gather(edges, 1, iy.T + 1).T
        width = e_hi - e_lo
        x = e_lo + frac * width
        jac = torch.prod(nb * width, dim=1)
        return x, jac, iy

    def _refine(self, edges, d_acc):
        """Redistribute the edges from the per-bin importance ``d_acc [D, nb]``
        (nf_tpu vegas.py:53-82)."""
        nb = self.n_bins
        # smooth (Lepage's (d[i-1] + 6 d[i] + d[i+1]) / 8) and damp
        d = d_acc
        d = torch.cat([
            (7.0 * d[:, :1] + d[:, 1:2]) / 8.0,
            (d[:, :-2] + 6.0 * d[:, 1:-1] + d[:, 2:]) / 8.0,
            (d[:, -2:-1] + 7.0 * d[:, -1:]) / 8.0], dim=1)
        dsum = torch.sum(d, dim=1, keepdim=True)
        r = d / torch.where(dsum > 0, dsum, 1.0)
        r = torch.where(r > 0, ((r - 1.0) / torch.log(torch.clamp_min(r, 1e-30))) ** self.alpha,
                        0.0)
        rsum = torch.sum(r, dim=1, keepdim=True)
        r = r / torch.where(rsum > 0, rsum, 1.0)

        # new edges: invert the cumulative importance
        cum = torch.cat([torch.zeros_like(r[:, :1]), torch.cumsum(r, dim=1)], dim=1)
        targets = torch.linspace(0.0, 1.0, nb + 1, dtype=edges.dtype, device=edges.device)
        targets = targets.expand(self.n_dim, nb + 1).contiguous()
        idx = torch.clamp(torch.searchsorted(cum, targets, right=True) - 1, 0, nb - 1)
        c_lo = torch.gather(cum, 1, idx)
        c_w = torch.gather(cum, 1, idx + 1) - c_lo
        e_lo = torch.gather(edges, 1, idx)
        e_w = torch.gather(edges, 1, idx + 1) - e_lo
        frac = torch.where(c_w > 0, (targets - c_lo) / torch.where(c_w > 0, c_w, 1.0), 0.0)
        new = e_lo + frac * e_w
        new[:, 0] = 0.0
        new[:, -1] = 1.0
        return new

    def run(self, f, nitn=10, neval=10000):
        """Adaptive integration; returns ``(mean, sdev)`` combined over the
        iterations on the host.  ``f`` maps ``x [neval, D]`` to ``[neval]``."""
        nb, D = self.n_bins, self.n_dim
        offsets = torch.arange(D, device=self.device) * nb
        means, variances = [], []
        for _ in range(nitn):
            y = _uniform(self._gen, (neval, D), self.dtype, self.device)
            x, jac, iy = self._map(self.edges, y)
            fx = f(x) * jac
            means.append(torch.mean(fx))
            variances.append(torch.var(fx) / neval)
            # per-bin importance: the sum of (f jac)^2 per bin and dim
            w2 = (fx ** 2)[:, None].expand(neval, D)
            d_acc = torch.zeros(D * nb, dtype=self.dtype, device=self.device).index_add_(
                0, (iy + offsets).reshape(-1), w2.reshape(-1))
            self.edges = self._refine(self.edges, d_acc.reshape(D, nb))
        means = np.asarray(torch.stack(means).tolist())
        variances = np.clip(np.asarray(torch.stack(variances).tolist()), 1e-300, None)
        inv = 1.0 / variances
        mean = float(np.sum(means * inv) / np.sum(inv))
        sdev = float(np.sqrt(1.0 / np.sum(inv)))
        return mean, sdev

    def sample(self, n):
        """Draw ``n`` points through the adapted map; returns ``(x, jac)``."""
        y = _uniform(self._gen, (n, self.n_dim), self.dtype, self.device)
        x, jac, _ = self._map(self.edges, y)
        return x, jac
