"""Coupling-cell transforms (Muller et al. 2019, sections 4.1/4.2).

Counterpart of ``nf_tpu.bijectors.coupling``.  Each cell kind has

  * a ``*_transform(z, xB, ...) -> (yB, factor)`` on the conditioner's raw
    output ``z`` [B, out] and the transformed inputs ``xB`` [B, t], shared by
    the training forward and the BatchNorm-folded eval forward
    (:mod:`nf_tpu_torch.flows.fast_eval`);
  * :func:`cell_forward` ``(cfg, cond, x, jac, train) -> (y, jac')`` runs the
    conditioner on the pass-through dims and applies the cell's transform
    (nf_tpu's ``affine_forward`` / ``pwlin_forward`` / ``pwquad_forward``);
  * an inverse ``*_inverse(z, yB, ...) -> (xB, factor)`` with ``factor``
    the forward transform's Jacobian at the recovered point (nf_tpu's
    ``affine_inverse`` / ``pwlin_inverse`` / ``pwquad_inverse``), applied
    per cell by :func:`nf_tpu_torch.flows.model.apply_cell_inverse`.  The
    pass-through dims condition both directions.

``jac`` is the running *multiplicative* Jacobian [B], as in nf_tpu and the
reference.  Bin lookups use ``torch.gather``; the bin index is clamped to the
last bin (see :func:`pwlin_transform`).  The forward transforms take that
factor's product with :func:`prod`, whose gradient reads nothing back from
the device, so a trainer's epoch can be captured as a CUDA graph.  Every
cumulative sum over the bins is :func:`nf_tpu_torch.ops.bin_scan.bin_cumsum`:
the plain ``torch.cumsum`` on the CPU, a hand-written kernel on the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from nf_tpu_torch.ops.bin_scan import bin_cumsum


def positivity(z: torch.Tensor, act: str) -> torch.Tensor:
    """Bin-logit -> positive height map: ``exp`` (the reference's) or
    ``squareplus`` ``(z + sqrt(z^2 + 4)) / 2``."""
    if act == "exp":
        return torch.exp(z)
    if act == "squareplus":
        return 0.5 * (z + torch.sqrt(z * z + 4.0))
    raise ValueError(f"unknown activation {act!r}")


class _Prod(torch.autograd.Function):
    """``torch.prod(x, dim=-1)`` with torch's own gradient (``prod_backward``
    in FunctionsManual.cpp), computed without a host read: torch asks the
    host whether ``x`` holds a zero (``.item()``), then takes ``grad *
    result / x``, or with a zero anywhere the exclusive products before and
    after each entry; here both are computed and the same test picks one on
    the device.  Under ``vmap`` (the ensemble) the test is per run."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return torch.prod(x, dim=-1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)

    @staticmethod
    def backward(ctx, grad):
        x, result = ctx.saved_tensors
        grad, result = grad.unsqueeze(-1), result.unsqueeze(-1)
        ones = torch.ones_like(x[..., :1])
        before = torch.cat([ones, x[..., :-1]], -1).cumprod(-1)
        after = torch.cat([ones, x[..., 1:].flip(-1)], -1).cumprod(-1).flip(-1)
        return torch.where((x == 0).any(), grad * (before * after), grad * (result / x))


def prod(x):
    """The product over the last axis: :class:`_Prod`, or for one factor the
    factor itself.  Its gradient, ``grad``, is torch's for every finite
    ``x`` (``grad * x / x``, or ``grad`` where a zero is present), and it
    costs the host a few microseconds where the Function costs ~100: the
    2-D flows' transforms take one factor, and their per-epoch trainer is
    bound by the host (PERF.md §6)."""
    return x[..., 0] if x.shape[-1] == 1 else _Prod.apply(x)


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
    factor = prod(20.0 * s0) * (1.0 / (math.pi / 2.0)) * prod(diff)
    return yB, factor


# ---------------------------------------------------------------------------
# Piecewise-linear coupling (reference coupling_cells.py:73-142)
# ---------------------------------------------------------------------------

def pwlin_transform(z, xB, n_bins: int, act: str = "exp"):
    t = xB.shape[1]
    q = positivity(z.reshape(z.shape[0], t, n_bins), act)
    qsum = bin_cumsum(q)
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
    return yB, prod(cdf_flt)


# ---------------------------------------------------------------------------
# Piecewise-quadratic coupling (reference coupling_cells.py:144-228)
# ---------------------------------------------------------------------------

def pwquad_compute(v_raw, w_raw, xB, act: str = "exp"):
    """Core PWQuad transform: ``v_raw`` [B, T, n_bins+1] vertex logits,
    ``w_raw`` [B, T, n_bins] width logits, ``xB`` [B, T] (already clamped).
    Returns ``(yB, factor)``, ``factor`` the product over T of the PDF."""
    n_bins = w_raw.shape[-1]

    w = positivity(w_raw, act)
    wsum = bin_cumsum(w)
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
    vw = F.pad(bin_cumsum((v[:, :, :-1] + v[:, :, 1:]) * 0.5 * w), (1, 0))
    shift = _take(vw, b)
    v_lo = _take(v, b)
    v_hi = _take(v, b + 1)

    yB = 0.5 * alphas ** 2 * (v_hi - v_lo) * w_b + alphas * v_lo * w_b + shift
    pdf = v_lo + (v_hi - v_lo) * alphas
    return yB, prod(pdf)


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


def cell_forward(cfg, cond, x, jac, train: bool, group=None):
    """One coupling cell: ``cond`` maps the pass-through dims to ``z``
    (``group``: see :meth:`Conditioner.forward`)."""
    pt = cfg.pass_through
    xA, xB = x[:, :pt], x[:, pt:]
    yB, factor = transform(cfg, cond(xA, train, group), xB)
    return torch.cat([xA, yB], dim=1), jac * factor



# ---------------------------------------------------------------------------
# Inverse transforms (x -> w; nf_tpu coupling.py:304-422)
# ---------------------------------------------------------------------------

def affine_inverse(z, yB):
    """Invert y_B = atan(x_B * 20 e^s + relu(t)) / (pi/2); ``factor`` is the
    forward factor of :func:`affine_transform`, the single 2/pi included."""
    t = yB.shape[1]
    z = z.reshape(z.shape[0], 2, t)
    s0 = torch.exp(z[:, 0])
    s1 = torch.relu(z[:, 1])
    u = torch.tan(yB * (math.pi / 2.0))
    xB = (u - s1) / (20.0 * s0)
    diff = 1.0 / (u * u + 1.0)
    factor = torch.prod(20.0 * s0, dim=1) * (1.0 / (math.pi / 2.0)) \
        * torch.prod(diff, dim=1)
    return xB, factor


def pwlin_inverse(z, yB, n_bins: int, act: str = "exp"):
    """Invert the piecewise-linear CDF: the bin by CDF edge (clamped to the
    last bin, so yB == 1 stays in it), then a linear solve."""
    t = yB.shape[1]
    q = positivity(z.reshape(z.shape[0], t, n_bins), act)
    qsum = bin_cumsum(q)
    qnorm = qsum[:, :, -1:]
    q = q / (qnorm / n_bins)
    qsum = qsum / qnorm
    b = torch.sum((qsum <= yB.unsqueeze(-1)).long(), dim=-1)
    b = torch.clamp(b, max=n_bins - 1)
    cdf_lo = _take(F.pad(qsum, (1, 0)), b)
    q_b = _take(q, b)
    alphas = (yB - cdf_lo) / q_b                  # in [0, 1/n_bins)
    xB = (b.to(yB.dtype) + alphas * n_bins) / n_bins
    return xB, torch.prod(q_b, dim=-1)


def pwquad_invert(v_raw, w_raw, yB, act: str = "exp"):
    """Invert :func:`pwquad_compute`: the bin by the CDF at its edges, then
    the bin's quadratic solved for alpha by the root that does not cancel,
    ``alpha = 2c / (v_lo + sqrt(v_lo^2 + 2 dv c))``.  Returns ``(xB,
    factor)``, ``factor`` the forward PDF product at the recovered point."""
    n_bins = w_raw.shape[-1]

    w = positivity(w_raw, act)
    wsum = bin_cumsum(w)
    wnorm = wsum[:, :, -1:]
    w = w / wnorm
    wsum = wsum / wnorm

    v = positivity(v_raw, act)
    vnorm = torch.sum((v[:, :, :-1] + v[:, :, 1:]) * 0.5 * w, dim=-1, keepdim=True)
    v = v / vnorm

    vw_body = bin_cumsum((v[:, :, :-1] + v[:, :, 1:]) * 0.5 * w)
    b = torch.sum((vw_body <= yB.unsqueeze(-1)).long(), dim=-1)
    b = torch.clamp(b, max=n_bins - 1)

    w_b = _take(w, b)
    edge_b = _take(F.pad(wsum, (1, 0)), b)
    vw_b = _take(F.pad(vw_body, (1, 0)), b)
    v_lo = _take(v, b)
    v_hi = _take(v, b + 1)

    # 0.5 dv w alpha^2 + v_lo w alpha + vw_b = yB
    c = (yB - vw_b) / w_b
    dv = v_hi - v_lo
    disc = torch.sqrt(torch.clamp_min(v_lo * v_lo + 2.0 * dv * c, 0.0))
    linear = c / torch.where(v_lo == 0, 1.0, v_lo)
    alphas = torch.where(torch.abs(dv) > 1e-12 * (v_lo + v_hi),
                         2.0 * c / torch.where(disc + v_lo == 0, 1.0, disc + v_lo),
                         linear)
    xB = edge_b + alphas * w_b
    pdf = v_lo + dv * alphas
    return xB, torch.prod(pdf, dim=-1)


def pwquad_inverse(z, yB, n_bins: int, act: str = "exp"):
    z = z.reshape(z.shape[0], yB.shape[1], 2 * n_bins + 1)
    return pwquad_invert(z[:, :, : n_bins + 1], z[:, :, n_bins + 1:], yB, act)


def inverse_transform(cfg, z, yB):
    """The inverse of :func:`transform`: ``(xB, forward factor)``."""
    if cfg.kind == "affine":
        return affine_inverse(z, yB)
    if cfg.kind == "pwlin":
        return pwlin_inverse(z, yB, cfg.n_bins, cfg.activation)
    return pwquad_inverse(z, yB, cfg.n_bins, cfg.activation)

