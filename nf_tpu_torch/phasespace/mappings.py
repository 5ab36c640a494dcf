"""Analytic latent-space channel mappings (importance maps).

Counterpart of ``nf_tpu.phasespace.mappings``.  A physical-width Z covers
~1e-4 of its latent interval, so a flow trained from scratch barely sees it.
These maps flatten a known shape in one latent dimension before the
phase-space map, exactly, and the flow learns only the smooth remainder.
Each map is a fixed bijection ``u -> (v, dv/du)`` of the unit interval;
:func:`remap_integrand` folds its Jacobian into the integrand, so the
trainers, integrators and unweighters take the wrapped integrand unchanged.
The maps compute on the device and in the dtype of their latents.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _atan(v):
    return torch.atan(v) if torch.is_tensor(v) else math.atan(v)


def breit_wigner_unit_map(u, mass, width, s_min, s_max):
    """Map ``u ~ U[0,1]`` to ``v in [0,1]`` such that ``s = s_min +
    v*(s_max - s_min)`` is Breit-Wigner distributed around ``mass``:
    ``(v, dv/du)``, by the tan substitution s = m^2 + m Gamma tan(t) with t
    uniform between the endpoint angles."""
    m2 = mass * mass
    mg = mass * width
    t_min = _atan((s_min - m2) / mg)
    t_max = _atan((s_max - m2) / mg)
    t = t_min + u * (t_max - t_min)
    s = m2 + mg * torch.tan(t)
    ds_du = (t_max - t_min) * mg / torch.cos(t) ** 2
    v = (s - s_min) / (s_max - s_min)
    return v, ds_du / (s_max - s_min)


def power_law_unit_map(u, exponent, x_min, x_max):
    """Map ``u ~ U[0,1]`` to ``v in [0,1]`` with ``x = x_min +
    v*(x_max-x_min)`` distributed ~ x^exponent (exponent != -1)."""
    a = exponent + 1.0
    xa_min = x_min ** a
    xa_max = x_max ** a
    x = (xa_min + u * (xa_max - xa_min)) ** (1.0 / a)
    dx_du = (xa_max - xa_min) / (a * x ** (a - 1.0))
    v = (x - x_min) / (x_max - x_min)
    return v, dx_du / (x_max - x_min)


def shifted_power_unit_map(u, exponent, shift):
    """Map ``u ~ U[0,1]`` to ``v in [0,1]`` with density ~ (v+shift)^exponent
    (exponent != -1).  The shift keeps the concentration point inside the
    interval: for a spectrum that turns on above a threshold v_th and falls
    like a power above it (the tau latent of heavy-pair production),
    ``shift ~ v_th`` piles samples just above the threshold."""
    a = exponent + 1.0
    lo = shift
    hi = 1.0 + shift
    xa_lo = lo ** a
    xa_hi = hi ** a
    x = (xa_lo + u * (xa_hi - xa_lo)) ** (1.0 / a)
    dv_du = (xa_hi - xa_lo) / (a * x ** (a - 1.0))
    return x - shift, dv_du


def remap_integrand(f, dim, unit_map):
    """Wrap ``f([B, n]) -> [B]`` so latent dim ``dim`` passes through
    ``unit_map(u) -> (v, dv/du)`` first, with the Jacobian folded in.  The
    caller's ``w`` is never written: the trainers reuse their latents."""
    def g(w):
        v, jac = unit_map(w[:, dim])
        w2 = w.clone()
        w2[:, dim] = v.to(w.dtype)
        return f(w2) * jac.to(w.dtype)
    return g


def _bisect(v, exps, n_iter=62):
    """Fixed-count bisection of v = massless_map(u, e) per column."""
    left, right = torch.zeros_like(v), torch.ones_like(v)
    for _ in range(n_iter):
        mid = 0.5 * (left + right)
        go = (mid ** exps) * ((exps + 1.0) - exps * mid) < v
        left, right = torch.where(go, mid, left), torch.where(go, right, mid)
    return 0.5 * (left + right)


def chain_mass_map(gen, E_collider, s_map, mass_index=None):
    """Conditional latent map: make the flat generator's chain mass
    ``M_{mass_index}`` (the invariant mass of final particles
    ``mass_index..n_final-1``) follow ``s_map``, a Breit-Wigner composed
    through the bisection.

    Given the earlier latents (which fix ``K_{j-1}`` and, with
    ``pdf_active``, the partonic E_cm), it draws ``s = M_j^2`` from
    ``s_map`` over the exact kinematic range ``[(m_j+..)^2,
    (K_{j-1}+m_j+..)^2]``, converts back to the latent coordinate the
    generator expects, and folds in the chain's Jacobian dv/du du/ds ds/dr.
    ``s_map`` has ``sample(u, s_min, s_max) -> (s, ds/du)``;
    ``mass_index`` defaults to ``n_final - 2``, the last pair's mass.
    Returns ``wrap(f) -> g``, to compose like :func:`remap_integrand`.
    """
    nf = gen.n_final
    if nf < 3:
        raise ValueError("chain_mass_map needs n_final >= 3 (for n_final=2 "
                         "the resonance sits in s_hat: use drell_yan_tau_map)")
    j = nf - 2 if mass_index is None else int(mass_index)
    if not 1 <= j <= nf - 2:
        raise ValueError(f"mass_index must be in [1, {nf - 2}], got {j}")
    d = j - 1                       # the latent column re-mapped
    e = float(nf - 1 - j)           # massless_map exponent of that column
    masses = np.asarray(gen.final_masses, dtype=np.float64)
    tot_mass = float(masses.sum())
    ms_j = float(masses[j:].sum())  # suffix mass below the target node

    def wrap(f):
        def g(w):
            B = w.shape[0]
            # partonic E_cm from the PDF latents (the generator's
            # _convolve_pdf, threshold clamp included)
            thresh = max(tot_mass, gen.absolute_Ecm_min)
            if not gen.pdf_active:
                E_eff = torch.full((B,), E_collider, dtype=w.dtype, device=w.device)
            elif gen.tau:
                tau_min = (thresh / E_collider) ** 2
                tau = tau_min + w[:, -2] * (1.0 - tau_min)
                E_eff = torch.sqrt(tau) * E_collider
            else:
                E_eff = torch.sqrt(w[:, -1] * w[:, -2]) * E_collider
            E_eff = torch.clamp(E_eff, min=thresh)

            K_prev = E_eff - tot_mass            # K_0
            if d > 0:
                # the exponents of the earlier chain columns
                exps = torch.arange(nf - 2, nf - 2 - d, -1, dtype=w.dtype,
                                    device=w.device)[None, :]
                K_prev = K_prev * torch.prod(torch.sqrt(_bisect(w[:, :d], exps)), dim=1)

            s_lo = torch.full((B,), ms_j ** 2, dtype=w.dtype, device=w.device)
            s_hi = torch.maximum((K_prev + ms_j) ** 2, s_lo)
            s, ds_dr = s_map.sample(w[:, d], s_lo, s_hi)
            M_j = torch.sqrt(torch.clamp(s, min=0.0))
            K_j = torch.clamp(M_j - ms_j, min=0.0)
            ok = K_prev > 0
            K_safe = torch.where(ok, K_prev, 1.0)
            u = torch.clamp((K_j / K_safe) ** 2, 0.0, 1.0)
            v = (u ** e) * ((e + 1.0) - e * u)   # massless_map(u, e)

            dv_du = e * (e + 1.0) * u ** (e - 1.0) * (1.0 - u)
            du_ds = K_j / (torch.clamp(M_j, min=1e-300) * K_safe ** 2)
            jac = torch.where(ok, dv_du * du_ds * ds_dr, 0.0)

            w2 = w.clone()
            w2[:, d] = v.to(w.dtype)
            return f(w2) * jac.to(w.dtype)
        return g

    return wrap


def drell_yan_tau_map(mass, width, E_collider, tau_min=None, threshold=1.0):
    """A ready-made map for the tau-mode PDF convolution that flattens the
    s-channel resonance in ``s_hat = tau E^2``.  Use with
    :func:`remap_integrand` on the tau latent (dim = nDimPhaseSpace(): the
    generator reads tau from ``rv[:, -2]``)."""
    if tau_min is None:
        tau_min = (threshold / E_collider) ** 2
    S = E_collider ** 2
    s_min = tau_min * S
    s_max = S

    def unit_map(u):
        return breit_wigner_unit_map(u, mass, width, s_min, s_max)

    return unit_map
