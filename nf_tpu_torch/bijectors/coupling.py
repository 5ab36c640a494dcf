"""Coupling-cell transforms (Muller et al. 2019, sections 4.1/4.2), forward.

Counterpart of ``nf_tpu.bijectors.coupling``.  Each cell kind has

  * a ``*_transform(z, xB, ...) -> (yB, factor)`` on the conditioner's raw
    output ``z`` [B, out] and the transformed inputs ``xB`` [B, t], shared by
    the training forward and the BatchNorm-folded eval forward
    (:mod:`nf_tpu_torch.flows.fast_eval`);
  * :func:`cell_forward` ``(cfg, cond, x, jac, train) -> (y, jac')`` runs the
    conditioner on the pass-through dims and applies the cell's transform
    (nf_tpu's ``affine_forward`` / ``pwlin_forward`` / ``pwquad_forward``).

``jac`` is the running *multiplicative* Jacobian [B], as in nf_tpu and the
reference.  Bin lookups use ``torch.gather``; the bin index is clamped to the
last bin (see :func:`pwlin_transform`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def positivity(z: torch.Tensor, act: str) -> torch.Tensor:
    """Bin-logit -> positive height map: ``exp`` (the reference's) or
    ``squareplus`` ``(z + sqrt(z^2 + 4)) / 2``."""
    if act == "exp":
        return torch.exp(z)
    if act == "squareplus":
        return 0.5 * (z + torch.sqrt(z * z + 4.0))
    raise ValueError(f"unknown activation {act!r}")


def _take(arr, b):
    """``arr[..., b]`` per element: ``arr`` [B, t, k], ``b`` [B, t] int64."""
    return torch.gather(arr, -1, b.unsqueeze(-1)).squeeze(-1)


# ---------------------------------------------------------------------------
# Affine coupling (reference coupling_cells.py:6-70)
# ---------------------------------------------------------------------------

def affine_transform(z, xB):
    """y_B = atan(x_B * 20 e^s + relu(t)) / (pi/2).

    Quirk kept from the reference (coupling_cells.py:68): the 2/pi Jacobian
    factor is applied ONCE per cell, whatever the number of transformed dims.
    """
    t = xB.shape[1]
    z = z.reshape(z.shape[0], 2, t)
    s0 = torch.exp(z[:, 0])
    s1 = torch.relu(z[:, 1])
    u = xB * (20.0 * s0) + s1
    diff = 1.0 / (u * u + 1.0)
    yB = torch.atan(u) / (math.pi / 2.0)
    factor = torch.prod(20.0 * s0, dim=1) * (1.0 / (math.pi / 2.0)) \
        * torch.prod(diff, dim=1)
    return yB, factor


# ---------------------------------------------------------------------------
# Piecewise-linear coupling (reference coupling_cells.py:73-142)
# ---------------------------------------------------------------------------

def pwlin_transform(z, xB, n_bins: int, act: str = "exp"):
    t = xB.shape[1]
    q = positivity(z.reshape(z.shape[0], t, n_bins), act)
    qsum = torch.cumsum(q, dim=-1)
    qnorm = qsum[:, :, -1:]
    q = q / (qnorm / n_bins)                      # PDF heights, mean 1
    qsum = F.pad(qsum / qnorm, (1, 0))            # CDF at bin edges

    a = xB * n_bins
    # Clamp the bin BEFORE deriving alpha: xB == 1.0 exactly (an upstream
    # cell's f32 CDF can round up to it) would index bin n_bins.  With the
    # clamp, alpha = 1/n_bins and yB = the CDF's right edge = 1.0.
    bins = torch.clamp(torch.floor(a).long(), max=n_bins - 1)
    alphas = (a - bins) / n_bins
    cdf_flt = _take(q, bins)
    yB = cdf_flt * alphas + _take(qsum, bins)
    return yB, torch.prod(cdf_flt, dim=-1)


# ---------------------------------------------------------------------------
# Piecewise-quadratic coupling (reference coupling_cells.py:144-228)
# ---------------------------------------------------------------------------

def pwquad_compute(v_raw, w_raw, xB, act: str = "exp"):
    """Core PWQuad transform: ``v_raw`` [B, T, n_bins+1] vertex logits,
    ``w_raw`` [B, T, n_bins] width logits, ``xB`` [B, T] (already clamped).
    Returns ``(yB, factor)``, ``factor`` the product over T of the PDF."""
    n_bins = w_raw.shape[-1]

    w = positivity(w_raw, act)
    wsum = torch.cumsum(w, dim=-1)
    wnorm = wsum[:, :, -1:]
    w = w / wnorm
    wsum = wsum / wnorm

    v = positivity(v_raw, act)
    # total integral of the piecewise-linear PDF: sum of trapezoids
    vnorm = torch.sum((v[:, :, :-1] + v[:, :, 1:]) * 0.5 * w, dim=-1, keepdim=True)
    v = v / vnorm

    # bin index: number of right bin edges <= xB
    b = torch.sum((wsum <= xB.unsqueeze(-1)).long(), dim=-1)
    b = torch.clamp(b, max=n_bins - 1)

    w_b = _take(w, b)
    alphas = (xB - _take(F.pad(wsum, (1, 0)), b)) / w_b
    # CDF at the left edge of each bin (trapezoid cumsum of the normalized PDF)
    vw = F.pad(torch.cumsum((v[:, :, :-1] + v[:, :, 1:]) * 0.5 * w, dim=-1), (1, 0))
    shift = _take(vw, b)
    v_lo = _take(v, b)
    v_hi = _take(v, b + 1)

    yB = 0.5 * alphas ** 2 * (v_hi - v_lo) * w_b + alphas * v_lo * w_b + shift
    pdf = v_lo + (v_hi - v_lo) * alphas
    return yB, torch.prod(pdf, dim=-1)


def pwquad_transform(z, xB, n_bins: int, act: str = "exp"):
    xB = torch.clamp(xB, max=1.0 - 1e-6)  # stability clamp, reference :167
    z = z.reshape(z.shape[0], xB.shape[1], 2 * n_bins + 1)
    return pwquad_compute(z[:, :, : n_bins + 1], z[:, :, n_bins + 1:], xB, act)


def transform(cfg, z, xB):
    """Dispatch on ``cfg.kind`` (a :class:`nf_tpu_torch.flows.model.CellCfg`)."""
    if cfg.kind == "affine":
        return affine_transform(z, xB)
    if cfg.kind == "pwlin":
        return pwlin_transform(z, xB, cfg.n_bins, cfg.activation)
    return pwquad_transform(z, xB, cfg.n_bins, cfg.activation)


def cell_forward(cfg, cond, x, jac, train: bool):
    """One coupling cell: ``cond`` maps the pass-through dims to ``z``."""
    pt = cfg.pass_through
    xA, xB = x[:, :pt], x[:, pt:]
    yB, factor = transform(cfg, cond(xA, train), xB)
    return torch.cat([xA, yB], dim=1), jac * factor

