"""Lorentz-vector / collider-kinematics kit, in PyTorch.

Counterpart of ``nf_tpu.phasespace.lorentz``.  4-vectors are ``[..., 4]``
tensors with components (E, px, py, pz); metric (+,-,-,-).  Every function
computes on its input's device and in its input's dtype, and broadcasts over
leading batch dimensions.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = float(np.finfo(np.float64).eps ** 0.5)


def rho2(p):
    """Spatial radius squared |p|^2."""
    return torch.sum(p[..., 1:] * p[..., 1:], dim=-1)


def set_square(p, square):
    """Reset the time component so p.p == square.  The argument of the sqrt
    is clamped at zero: in float32 ultra-relativistic kinematics can round
    rho2 + square fractionally negative."""
    e = torch.sqrt(torch.clamp(rho2(p) + square, min=0.0))
    return torch.cat([e[..., None], p[..., 1:]], dim=-1)


def minkowski_dot(a, b):
    return (a[..., 0] * b[..., 0] - a[..., 1] * b[..., 1]
            - a[..., 2] * b[..., 2] - a[..., 3] * b[..., 3])


def square(p):
    return minkowski_dot(p, p)


def boost_vector(p):
    """beta = p_space / E; zero-energy vectors get beta = 0."""
    e = p[..., 0:1]
    nonzero = e != 0
    return torch.where(nonzero, p[..., 1:] / torch.where(nonzero, e, 1.0), 0.0)


def boost(p, beta):
    """Boost ``[..., 4]`` vectors by velocity ``beta [..., 3]`` (a single
    beta per event against several particles: beta shaped ``[..., 1, 3]``).

    ``b2`` is clamped at ``1 - 1e-11``, as nf_tpu clamps it.  In float32 the
    constant rounds to 1.0, so there the clamp does nothing, in both
    packages."""
    b2 = torch.clamp(torch.sum(beta * beta, dim=-1), max=1.0 - 1e-11)
    # rsqrt: on the CPU it is 1 / (IEEE sqrt), nf_tpu's bits; torch.sqrt
    # there is not correctly rounded in float64
    gamma = torch.rsqrt(1.0 - b2)
    bp = torch.sum(p[..., 1:] * beta, dim=-1)
    moving = b2 > 0
    gamma2 = torch.where(moving, (gamma - 1.0) / torch.where(moving, b2, 1.0), 0.0)
    factor = gamma2 * bp + gamma * p[..., 0]
    space = p[..., 1:] + factor[..., None] * beta
    e = gamma * (p[..., 0] + bp)
    return torch.cat([e[..., None], space], dim=-1)


def uniform_distr(r, minv, maxv):
    """Map r in [0, 1] uniformly into (minv, maxv): ``(value, jacobian)``."""
    dvar = maxv - minv
    return minv + dvar * r, dvar


def boost_to_lab_frame(momenta, xb_1, xb_2):
    """Boost COM-frame momenta ``[B, P, 4]`` to the lab frame given the
    Bjorken x's; a no-op for events with xb_1 == xb_2 == 1."""
    ref_lab = momenta[:, 0, :] * xb_1[:, None] + momenta[:, 1, :] * xb_2[:, None]
    r2 = rho2(ref_lab)
    # nf_tpu boosts by boost_vector of (1, 0, 0, 0) where r2 == 0: beta 0
    beta = torch.where(r2[:, None] > 0, boost_vector(ref_lab), 0.0)
    boosted = boost(momenta, beta[:, None, :])
    need = ((xb_1 != 1.0) | (xb_2 != 1.0)) & (r2 > 0)
    return torch.where(need[:, None, None], boosted, momenta)


def pseudo_rapidity(p, eps=_EPS, huge=None):
    """Pseudorapidity; ``huge`` (the dtype's largest value by default) where
    the vector is degenerate (pT and |pz| below ``eps``)."""
    if huge is None:
        huge = torch.finfo(p.dtype).max
    pt = torch.sqrt(torch.sum(p[..., 1:3] ** 2, dim=-1))
    th = torch.atan2(pt, p[..., 3])
    degenerate = (pt < eps) & (torch.abs(p[..., 3]) < eps)
    return torch.where(degenerate, huge, -torch.log(torch.tan(th / 2.0)))


def delta_phi(p1, p2, eps=_EPS, huge=None):
    """phi-angle separation; ``huge`` where either pT is zero."""
    if huge is None:
        huge = torch.finfo(p1.dtype).max
    pt1 = torch.sqrt(torch.sum(p1[..., 1:3] ** 2, dim=-1))
    pt2 = torch.sqrt(torch.sum(p2[..., 1:3] ** 2, dim=-1))
    denom = pt1 * pt2
    tmp = (p1[..., 1] * p2[..., 1] + p1[..., 2] * p2[..., 2]) \
        / torch.where(denom == 0, 1.0, denom)
    clipped = torch.where(torch.abs(tmp) > 1.0, torch.sign(tmp), tmp)
    return torch.where((pt1 == 0.0) | (pt2 == 0.0), huge, torch.arccos(clipped))


def delta_r(p1, p2):
    deta = pseudo_rapidity(p1) - pseudo_rapidity(p2)
    dphi = delta_phi(p1, p2)
    return torch.sqrt(deta ** 2 + dphi ** 2)


def cos_theta(p):
    """Polar-angle cosine pz/|p|."""
    return p[..., 3] / torch.sqrt(torch.sum(p[..., 1:] ** 2, dim=-1))


def phi(p):
    """Azimuthal angle atan2(py, px)."""
    return torch.atan2(p[..., 2], p[..., 1])


def spatial_dot(a, b):
    return torch.sum(a[..., 1:4] * b[..., 1:4], dim=-1)
