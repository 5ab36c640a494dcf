"""The two integrands, as plain functions of the unit cube, any dtype.

``camel``: the two-Gaussian camel of Muller et al. (arXiv:1808.03856,
section 5.1), with its analytic integral.

``zz4l``: q qbar -> Z Z -> 4 leptons at 2 TeV, a frozen copy of the maths
the program's phase space runs for it: a decay-tree channel ``((0, 1),
(2, 3))`` with both pairs' masses Breit-Wigner mapped, the ToyPDF
convolution in (tau, y) with the tau latent power-mapped above the ZZ
threshold, cuts pT > 20 GeV, Delta R > 0.4 and |eta| < 2.4 in the lab frame,
and the double Breit-Wigner |M|^2.  Written for this one topology; each
step follows the general generator's order of operations.
"""

from __future__ import annotations

import math

import torch

# ---------------------------------------------------------------------------
# camel
# ---------------------------------------------------------------------------


def camel(x):
    return (torch.exp(-((x[:, 0] - 0.75) ** 2 + (x[:, 1] - 0.75) ** 2) / 0.04)
            + torch.exp(-((x[:, 0] - 0.25) ** 2 + (x[:, 1] - 0.25) ** 2) / 0.04))


def camel_exact():
    g = 0.2 * (math.sqrt(math.pi) / 2) * (math.erf(0.25 / 0.2) + math.erf(0.75 / 0.2))
    return 2 * g * g


# ---------------------------------------------------------------------------
# zz4l
# ---------------------------------------------------------------------------

MZ, GZ = 91.188, 2.4952
MZ2, GAM2 = MZ ** 2, MZ ** 2 * GZ ** 2
E_CM = 2000.0
PT_MIN, DR_MIN, RAP_MAX = 20.0, 0.4, 2.4
TWO_PI = 2.0 * math.pi
_EPS = 2.220446049250313e-16 ** 0.5
# ToyPDF x f(x) = N x^a (1 - x)^b for the u quark and the anti-u quark
TOY_U, TOY_UBAR = (1.4, 0.5, 3.0), (0.15, -0.2, 6.0)


def _rho2(p):
    return torch.sum(p[..., 1:] * p[..., 1:], dim=-1)


def _square(p):
    return p[..., 0] * p[..., 0] - p[..., 1] * p[..., 1] - p[..., 2] * p[..., 2] \
        - p[..., 3] * p[..., 3]


def _set_square(p, square):
    e = torch.sqrt(torch.clamp(_rho2(p) + square, min=0.0))
    return torch.cat([e[..., None], p[..., 1:]], dim=-1)


def _boost_vector(p):
    e = p[..., 0:1]
    nonzero = e != 0
    return torch.where(nonzero, p[..., 1:] / torch.where(nonzero, e, 1.0), 0.0)


def _boost(p, beta):
    b2 = torch.clamp(torch.sum(beta * beta, dim=-1), max=1.0 - 1e-11)
    gamma = torch.rsqrt(1.0 - b2)
    bp = torch.sum(p[..., 1:] * beta, dim=-1)
    moving = b2 > 0
    gamma2 = torch.where(moving, (gamma - 1.0) / torch.where(moving, b2, 1.0), 0.0)
    factor = gamma2 * bp + gamma * p[..., 0]
    space = p[..., 1:] + factor[..., None] * beta
    e = gamma * (p[..., 0] + bp)
    return torch.cat([e[..., None], space], dim=-1)


def _eta(p):
    pt = torch.sqrt(torch.sum(p[..., 1:3] ** 2, dim=-1))
    th = torch.atan2(pt, p[..., 3])
    degenerate = (pt < _EPS) & (torch.abs(p[..., 3]) < _EPS)
    return torch.where(degenerate, torch.finfo(p.dtype).max, -torch.log(torch.tan(th / 2.0)))


def _dphi(p1, p2):
    huge = torch.finfo(p1.dtype).max
    pt1 = torch.sqrt(torch.sum(p1[..., 1:3] ** 2, dim=-1))
    pt2 = torch.sqrt(torch.sum(p2[..., 1:3] ** 2, dim=-1))
    denom = pt1 * pt2
    tmp = (p1[..., 1] * p2[..., 1] + p1[..., 2] * p2[..., 2]) / torch.where(denom == 0, 1.0, denom)
    clipped = torch.where(torch.abs(tmp) > 1.0, torch.sign(tmp), tmp)
    return torch.where((pt1 == 0.0) | (pt2 == 0.0), huge, torch.arccos(clipped))


def _delta_r(p1, p2):
    return torch.sqrt((_eta(p1) - _eta(p2)) ** 2 + _dphi(p1, p2) ** 2)


def _bw_sample(u, s_min, s_max):
    mg = MZ * GZ
    t_min, t_max = torch.atan((s_min - MZ2) / mg), torch.atan((s_max - MZ2) / mg)
    t = t_min + u * (t_max - t_min)
    s = torch.minimum(torch.maximum(MZ2 + mg * torch.tan(t), s_min), s_max)
    return s, (t_max - t_min) * mg / torch.cos(t) ** 2


def _rho(M, N, m):
    msq = M ** 2
    return torch.clamp((msq - (N + m) ** 2) * (msq - (N - m) ** 2), min=0.0) ** 0.5 / (8.0 * msq)


def _two_body(M, M_a, M_b, Q, cos_col, phi_col, weight):
    """``Q`` (mass ``M``) into two momenta of masses ``M_a``, ``M_b`` at the
    angles of two latent columns; the two-body weight folded in."""
    rho = _rho(M, M_a, M_b)
    weight = weight * rho / math.pi
    q = 4.0 * M * rho
    cos_t = 2.0 * cos_col - 1.0
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t ** 2, min=0.0))
    phi = TWO_PI * phi_col
    e_a = (M ** 2 + M_a ** 2 - M_b ** 2) / (2.0 * torch.clamp(M, min=1e-300))
    qvec = torch.stack([q * sin_t * torch.cos(phi), q * sin_t * torch.sin(phi), q * cos_t], -1)
    beta = _boost_vector(Q)
    p_a = _set_square(_boost(torch.cat([e_a[:, None], qvec], -1), beta), M_a ** 2)
    p_b = _set_square(_boost(torch.cat([(M - e_a)[:, None], -qvec], -1), beta), M_b ** 2)
    return p_a, p_b, weight


def _toy(params, x):
    n, a, b = params
    x = torch.clamp(x, 1e-10, 1.0)
    return n * x ** a * (1.0 - x) ** b


def zz_channel(rv_full, distance=False):
    """``(momenta [B, 6, 4] in the partonic rest frame, weight [B])`` of the
    channel, for latents ``[B, 10]``: columns 0-1 the two pairs' masses,
    2-7 (cos theta, phi) of the root, the first and the second pair, 8-9
    (tau, y).  With ``distance``, the third value is each point's distance
    from the nearest cut: the smallest ``|v / v_cut - 1|`` over its cut
    variables."""
    B, dtype, device = rv_full.shape[0], rv_full.dtype, rv_full.device
    full = torch.full((B,), 1.0, dtype=dtype, device=device)
    tau_min = (1.0 / E_CM) ** 2        # threshold max(sum of masses, 1 GeV)
    tau = full * tau_min + (full - full * tau_min) * rv_full[:, -2]
    j1 = full - full * tau_min
    ycm_min = 0.5 * torch.log(tau)
    ycm = ycm_min + (-ycm_min - ycm_min) * rv_full[:, -1]
    j2 = -ycm_min - ycm_min
    sqrt_tau = torch.sqrt(tau)
    xb_1, xb_2 = sqrt_tau * torch.exp(ycm), sqrt_tau * torch.exp(-ycm)
    e_eff = sqrt_tau * E_CM
    weight = j1 * j2 * (e_eff >= 1.0).to(dtype)
    e_eff = torch.clamp(e_eff, min=1.0)
    x_cut = (~((xb_1 < 1e-4) | (xb_2 < 1e-4))).to(dtype)
    weight = weight * (_toy(TOY_U, xb_1) / xb_1) * (_toy(TOY_UBAR, xb_2) / xb_2) * x_cut

    rv = rv_full[:, :-2]
    zero = torch.zeros_like(e_eff)
    # the root's children: first pair in [0, M], second in [0, M - M_a]
    s_a, ds_a = _bw_sample(rv[:, 0], zero, torch.maximum(e_eff ** 2, zero))
    weight = weight * ds_a / TWO_PI
    m_a = torch.sqrt(torch.clamp(s_a, min=0.0))
    s_b, ds_b = _bw_sample(rv[:, 1], zero, torch.maximum((e_eff - m_a) ** 2, zero))
    weight = weight * ds_b / TWO_PI
    m_b = torch.sqrt(torch.clamp(s_b, min=0.0))
    q_root = torch.stack([e_eff, zero, zero, zero], -1)
    p_a, p_b, weight = _two_body(e_eff, m_a, m_b, q_root, rv[:, 2], rv[:, 3], weight)
    l0, l1, weight = _two_body(m_a, zero, zero, p_a, rv[:, 4], rv[:, 5], weight)
    l2, l3, weight = _two_body(m_b, zero, zero, p_b, rv[:, 6], rv[:, 7], weight)
    half = e_eff / 2
    initial = [torch.stack([half, zero, zero, half], -1), torch.stack([half, zero, zero, -half], -1)]
    momenta = torch.stack(initial + [l0, l1, l2, l3], 1)

    # cuts in the lab frame
    ref_lab = momenta[:, 0, :] * xb_1[:, None] + momenta[:, 1, :] * xb_2[:, None]
    r2 = _rho2(ref_lab)
    beta = torch.where(r2[:, None] > 0, _boost_vector(ref_lab), 0.0)
    need = ((xb_1 != 1.0) | (xb_2 != 1.0)) & (r2 > 0)
    lab = torch.where(need[:, None, None], _boost(momenta, beta[:, None, :]), momenta)
    fin = lab[:, 2:, :]
    cut = torch.ones_like(xb_1)
    pt_min = torch.amin(torch.sqrt(fin[:, :, 1] ** 2 + fin[:, :, 2] ** 2), dim=1)
    cut = torch.where(pt_min < PT_MIN, 0.0, cut)
    dr = _delta_r(fin[:, :, None, :], fin[:, None, :, :])
    pairs = torch.ones((4, 4), dtype=torch.bool, device=device).tril(-1)
    cut = torch.where(((torch.abs(dr) < DR_MIN) & pairs).flatten(1).any(dim=1), 0.0, cut)
    # the absolute value of the largest pseudorapidity, as the generator has it
    cut = torch.where(RAP_MAX < torch.abs(torch.amax(_eta(fin), dim=1)), 0.0, cut)
    weight = weight * cut / (2.0 * (xb_1 * xb_2 * E_CM ** 2))
    if distance:
        far = torch.full_like(xb_1, math.inf)
        dist = torch.stack([
            torch.abs(sqrt_tau * E_CM - 1.0), torch.abs(xb_1 / 1e-4 - 1.0),
            torch.abs(xb_2 / 1e-4 - 1.0), torch.abs(pt_min / PT_MIN - 1.0),
            torch.where(pairs, torch.abs(dr / DR_MIN - 1.0), far[:, None, None]).flatten(1)
            .amin(dim=1),
            torch.abs(torch.abs(torch.amax(_eta(fin), dim=1)) / RAP_MAX - 1.0)], 1).amin(dim=1)

    bad = ~torch.isfinite(momenta).flatten(1).all(dim=1) | ~torch.isfinite(weight)
    weight = torch.where(bad, 0.0, weight)
    momenta = torch.where(bad[:, None, None], 0.0,
                          torch.nan_to_num(momenta, nan=0.0, posinf=0.0, neginf=0.0))
    if distance:
        return momenta, weight, torch.nan_to_num(dist, nan=0.0)
    return momenta, weight


def zz4l(w, distance=False):
    """The integrand over the unit cube ``[B, 10]``: the tau latent (column
    8) mapped by density ~ (v + 3 tau_th)^-3, then the channel's weight
    times the double Breit-Wigner; with ``distance``, each point's distance
    from the nearest cut instead (see :func:`zz_channel`)."""
    shift = 3 * (2 * MZ / E_CM) ** 2
    a = -2.0
    xa_lo, xa_hi = shift ** a, (1.0 + shift) ** a
    x = (xa_lo + w[:, 8] * (xa_hi - xa_lo)) ** (1.0 / a)
    dv_du = (xa_hi - xa_lo) / (a * x ** (a - 1.0))
    w2 = w.clone()
    w2[:, 8] = (x - shift).to(w.dtype)
    if distance:
        return zz_channel(w2, distance=True)[2]
    momenta, wgt = zz_channel(w2)
    fin = momenta[:, 2:, :]
    s34 = _square(fin[:, 0] + fin[:, 1])
    s56 = _square(fin[:, 2] + fin[:, 3])
    return 1e4 / ((s34 - MZ2) ** 2 + GAM2) * 1e4 / ((s56 - MZ2) ** 2 + GAM2) * wgt \
        * dv_du.to(w.dtype)


INTEGRANDS = {"camel": camel, "zz4l": zz4l}
# each point's distance from the nearest cut, for the integrands that have cuts
CUT_DISTANCE = {"zz4l": lambda w: zz4l(w, distance=True)}
