"""Tree-topology resonance decay channels and multi-channel combination.

Counterpart of ``nf_tpu.phasespace.topology``.  The flat RAMBO chain
(:mod:`~nf_tpu_torch.phasespace.generator`) exposes only the invariant mass
of the last final-state pair as a chain variable, so a narrow resonance in
another pairing (the first Z in qq -> ZZ -> 4l) cannot be importance-mapped
through it.  This module provides:

  * :class:`ResonanceDecayPhasespace`: an exact phase-space
    parametrization over an arbitrary binary decay tree of the final state,
    each internal node's invariant mass drawn through an analytic map
    (:class:`UniformSMap`, :class:`BreitWignerSMap`, :class:`PowerSMap`).
    The recursive decomposition

        dPhi_n(P) = dPhi_2(P; Q_A, Q_B) (ds_A/2pi) (ds_B/2pi)
                    dPhi(Q_A) dPhi(Q_B)

    gives a closed-form weight with no bisection.  The volume convention is
    the flat generator's, so the two generators' weights are
    interchangeable, and the PDF convolution, cuts and flux are shared
    through the common base class.

  * :func:`multichannel_integrand`: the alpha-weighted multi-channel
    combination; a sample drawn from channel i (selected by the first latent
    dimension) carries the weight f(x) C(x) / sum_j alpha_j / w_j^PS(x),
    with C the channel-independent factor (PDF * cuts / (2 s_hat)) and
    w_j^PS from :meth:`ResonanceDecayPhasespace.channel_weight_ps`.

  * :func:`optimize_alphas`: the Kleiss-Pittau update of the alphas.

Every function computes on the device and in the dtype of its input.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nf_tpu_torch.phasespace import lorentz
from nf_tpu_torch.phasespace.generator import (
    FlatInvertiblePhasespace,
    PhaseSpaceGeneratorError,
    VirtualPhaseSpaceGenerator,
)

_TWO_PI = 2.0 * math.pi


# ---------------------------------------------------------------------------
# Invariant-mass-squared maps: u in [0,1] -> s in [s_min, s_max].  The
# bounds are tensors broadcastable against u.
# ---------------------------------------------------------------------------

class UniformSMap:
    """Flat in s: s = s_min + u (s_max - s_min)."""

    def sample(self, u, s_min, s_max):
        span = s_max - s_min
        return s_min + u * span, span

    def ds_du_at(self, s, s_min, s_max):
        del s
        return s_max - s_min

    def invert(self, s, s_min, s_max):
        return torch.clamp((s - s_min) / torch.clamp(s_max - s_min, min=1e-300), 0.0, 1.0)


class BreitWignerSMap:
    """Breit-Wigner importance map: s = m^2 + m Gamma tan(t), t uniform
    between the endpoint angles.  Its density ds/du = (t_max - t_min)
    ((s - m^2)^2 + m^2 Gamma^2) / (m Gamma) is closed-form in s, which makes
    multi-channel weights cheap."""

    def __init__(self, mass, width):
        self.mass = float(mass)
        self.width = float(width)

    def _angles(self, s_min, s_max):
        m2 = self.mass * self.mass
        mg = self.mass * self.width
        return torch.atan((s_min - m2) / mg), torch.atan((s_max - m2) / mg)

    def sample(self, u, s_min, s_max):
        m2 = self.mass * self.mass
        mg = self.mass * self.width
        t_min, t_max = self._angles(s_min, s_max)
        t = t_min + u * (t_max - t_min)
        s = m2 + mg * torch.tan(t)
        # clamp: tan at the endpoint angles can overshoot by a rounding ulp
        s = torch.minimum(torch.maximum(s, s_min), s_max)
        ds_du = (t_max - t_min) * mg / torch.cos(t) ** 2
        return s, ds_du

    def ds_du_at(self, s, s_min, s_max):
        m2 = self.mass * self.mass
        mg = self.mass * self.width
        t_min, t_max = self._angles(s_min, s_max)
        return (t_max - t_min) * ((s - m2) ** 2 + mg * mg) / mg

    def invert(self, s, s_min, s_max):
        m2 = self.mass * self.mass
        mg = self.mass * self.width
        t_min, t_max = self._angles(s_min, s_max)
        t = torch.atan((s - m2) / mg)
        return torch.clamp((t - t_min) / torch.clamp(t_max - t_min, min=1e-300), 0.0, 1.0)


class PowerSMap:
    """Power-law importance map ~ s^exponent (exponent != -1) for
    propagator tails and steeply falling spectra.  ``s_floor`` keeps the
    endpoint finite for negative exponents when s_min can reach 0."""

    def __init__(self, exponent, s_floor=0.0):
        if exponent == -1.0:
            raise ValueError("exponent -1 needs a log map; use -0.999...")
        self.exponent = float(exponent)
        self.s_floor = float(s_floor)

    def sample(self, u, s_min, s_max):
        a = self.exponent + 1.0
        lo = torch.clamp(s_min, min=self.s_floor)
        sa_min = lo ** a
        sa_max = s_max ** a
        s = (sa_min + u * (sa_max - sa_min)) ** (1.0 / a)
        ds_du = (sa_max - sa_min) / (a * s ** (a - 1.0))
        return s, ds_du

    def ds_du_at(self, s, s_min, s_max):
        a = self.exponent + 1.0
        lo = torch.clamp(s_min, min=self.s_floor)
        # below the floor the map cannot reach: the channel density is zero
        # there, and the multi-channel denominator drops this channel
        return torch.where(s >= lo,
                           (s_max ** a - lo ** a) / (a * torch.clamp(s, min=1e-300) ** (a - 1.0)),
                           0.0)

    def invert(self, s, s_min, s_max):
        a = self.exponent + 1.0
        lo = torch.clamp(s_min, min=self.s_floor)
        sa_min = lo ** a
        sa_max = s_max ** a
        return torch.clamp((s ** a - sa_min) / torch.where(sa_max != sa_min, sa_max - sa_min, 1.0),
                           0.0, 1.0)


# ---------------------------------------------------------------------------
# Decay-tree structure
# ---------------------------------------------------------------------------

class _Node:
    __slots__ = ("index", "left", "right", "leaves", "s_map")

    def __init__(self, index=None, left=None, right=None):
        self.index = index
        self.left = left
        self.right = right
        if index is not None:
            self.leaves = (index,)
        else:
            self.leaves = tuple(sorted(left.leaves + right.leaves))
        self.s_map = None

    @property
    def is_leaf(self):
        return self.index is not None


def _build_tree(spec):
    if isinstance(spec, (int, np.integer)):
        return _Node(index=int(spec))
    if isinstance(spec, (tuple, list)) and len(spec) == 2:
        return _Node(left=_build_tree(spec[0]), right=_build_tree(spec[1]))
    raise PhaseSpaceGeneratorError(
        f"topology spec must be nested 2-tuples of final-state indices, got {spec!r}")


class ResonanceDecayPhasespace(VirtualPhaseSpaceGenerator):
    """Exact 2 -> n phase-space channel over a binary decay tree.

    ``topology``: nested 2-tuples of final-state indices covering
    0..n_final-1 exactly once, e.g. ``((0, 1), (2, 3))`` (pairs) or
    ``(0, (1, (2, 3)))`` (a chain).  ``mass_maps``: a dict from the sorted
    tuple of leaf indices under an internal node to an s-map; unmapped nodes
    take :class:`UniformSMap`.

    Latent layout (``nDimPhaseSpace()`` = 3 n_final - 4 columns, + 2
    trailing PDF columns with ``pdf_active``, as the flat generator):

      * columns ``[0, n_final-2)``: the invariant masses of the non-root
        internal nodes, in preorder (parent before children, left before
        right);
      * then 2 columns (cos theta, phi) per internal node, root included,
        in preorder;
      * then the PDF convolution's columns (tau/ycm or x1/x2).

    ``generateKinematics_batch`` has the flat generator's signature and
    return convention, so every trainer, integrator and unweighter takes
    this channel unchanged.
    """

    def __init__(self, initial_masses, final_masses, topology,
                 mass_maps=None, pdf=None, pdf_active=False, tau=True):
        super().__init__(initial_masses, final_masses, pdf=pdf,
                         pdf_active=pdf_active, tau=tau)
        if self.n_initial != 2:
            raise PhaseSpaceGeneratorError(
                "ResonanceDecayPhasespace supports exactly 2 initial "
                "particles (decay topologies: use a root node directly).")
        self.root = _build_tree(topology)
        if self.root.leaves != tuple(range(self.n_final)):
            raise PhaseSpaceGeneratorError(
                f"topology leaves {self.root.leaves} must cover "
                f"0..{self.n_final - 1} exactly once")
        # preorder traversal (fixes the latent layout)
        self._internal = []

        def visit(node):
            if node.is_leaf:
                return
            self._internal.append(node)
            visit(node.left)
            visit(node.right)

        visit(self.root)
        self._nonroot = [n for n in self._internal if n is not self.root]
        mass_maps = dict(mass_maps or {})
        for node in self._nonroot:
            node.s_map = mass_maps.pop(tuple(node.leaves), None) or UniformSMap()
        if mass_maps:
            raise PhaseSpaceGeneratorError(
                f"mass_maps keys {sorted(mass_maps)} do not match any "
                f"internal node of the topology "
                f"(valid: {[tuple(n.leaves) for n in self._nonroot]})")
        self._mass_col = {id(n): i for i, n in enumerate(self._nonroot)}
        self._ang_col = {id(n): self.n_final - 2 + 2 * i
                         for i, n in enumerate(self._internal)}

    # -- helpers -------------------------------------------------------------

    def _min_mass(self, node):
        return sum(self.final_masses[i] for i in node.leaves)

    def _node_mass(self, node, M_like, node_P):
        """The invariant mass of ``node``: a leaf's own mass, else from its
        momentum ``node_P(node)``."""
        if node.is_leaf:
            return torch.full_like(M_like, self.final_masses[node.index])
        return torch.sqrt(torch.clamp(lorentz.square(node_P(node)), min=0.0))

    def _child_masses(self, node, M_node, mass_rv, weight):
        """Draw (or fix) the two children's masses of ``node``: ``(M_A, M_B,
        weight)`` with the (ds/du)/(2 pi) factors folded into ``weight``.
        Left first in [min_A, M - min_B], then right in [min_B, M - M_A]."""
        A, Bn = node.left, node.right
        min_a = torch.full_like(M_node, self._min_mass(A))
        min_b = torch.full_like(M_node, self._min_mass(Bn))
        if not A.is_leaf:
            s_lo = min_a ** 2
            s_hi = torch.maximum((M_node - min_b) ** 2, s_lo)
            s_a, ds_du = A.s_map.sample(mass_rv[:, self._mass_col[id(A)]], s_lo, s_hi)
            weight = weight * ds_du / _TWO_PI
            M_A = torch.sqrt(torch.clamp(s_a, min=0.0))
        else:
            M_A = torch.full_like(M_node, self.final_masses[A.index])
        if not Bn.is_leaf:
            s_lo = min_b ** 2
            s_hi = torch.maximum((M_node - M_A) ** 2, s_lo)
            s_b, ds_du = Bn.s_map.sample(mass_rv[:, self._mass_col[id(Bn)]], s_lo, s_hi)
            weight = weight * ds_du / _TWO_PI
            M_B = torch.sqrt(torch.clamp(s_b, min=0.0))
        else:
            M_B = torch.full_like(M_node, self.final_masses[Bn.index])
        return M_A, M_B, weight

    # -- generation ----------------------------------------------------------

    def generateKinematics_batch(self, E_cm, random_variables_full,
                                 pT_mincut=-1, delR_mincut=-1, rap_maxcut=-1,
                                 pdgs=(0, 0)):
        """Map latents to 2 -> n_final kinematics through the decay tree: the
        flat generator's contract, ``(momenta [B, n_initial+n_final, 4] in
        the COM frame, weight [B])`` with weight = dPhi/dlatent * PDF * cuts
        / (2 s_hat)."""
        rv_full = random_variables_full
        B = rv_full.shape[0]
        collider_energy = E_cm

        rv, E_cm_eff, xb_1, xb_2, wgt_jac = self._convolve_pdf(E_cm, rv_full, pdgs)
        if rv.shape[1] != self.nDimPhaseSpace():
            raise PhaseSpaceGeneratorError(
                f"expected {self.nDimPhaseSpace()} phase-space latents, got {rv.shape[1]}")
        mass_rv = rv[:, : self.n_final - 2]

        M_root = E_cm_eff if self.pdf_active else \
            torch.full((B,), E_cm_eff, dtype=rv.dtype, device=rv.device)
        zero = torch.zeros_like(M_root)
        Q_root = torch.stack([M_root, zero, zero, zero], dim=-1)
        finals = [None] * self.n_final

        def decay(node, M_node, Q_node, weight):
            if node.is_leaf:
                finals[node.index] = Q_node
                return weight
            M_A, M_B, weight = self._child_masses(node, M_node, mass_rv, weight)
            # two-body decay weight per unit latent square:
            # (1/8pi) 2|q|/M = rho/pi, |q| = 4 M rho
            rho = FlatInvertiblePhasespace.rho(M_node, M_A, M_B)
            weight = weight * rho / math.pi
            q = 4.0 * M_node * rho
            c0 = self._ang_col[id(node)]
            cos_t = 2.0 * rv[:, c0] - 1.0
            sin_t = torch.sqrt(torch.clamp(1.0 - cos_t ** 2, min=0.0))
            phi = _TWO_PI * rv[:, c0 + 1]
            E_A = (M_node ** 2 + M_A ** 2 - M_B ** 2) / (2.0 * torch.clamp(M_node, min=1e-300))
            qvec = torch.stack([q * sin_t * torch.cos(phi), q * sin_t * torch.sin(phi),
                                q * cos_t], dim=-1)
            p_a = torch.cat([E_A[:, None], qvec], dim=-1)
            p_b = torch.cat([(M_node - E_A)[:, None], -qvec], dim=-1)
            beta = lorentz.boost_vector(Q_node)
            p_a = lorentz.set_square(lorentz.boost(p_a, beta), M_A ** 2)
            p_b = lorentz.set_square(lorentz.boost(p_b, beta), M_B ** 2)
            weight = decay(node.left, M_A, p_a, weight)
            return decay(node.right, M_B, p_b, weight)

        weight = decay(self.root, M_root, Q_root, wgt_jac)

        initial = self.setInitialStateMomenta_batch(E_cm_eff, B, rv_full)
        momenta_com = torch.cat([initial, torch.stack(finals, dim=1)], dim=1)

        weight = weight * self._cut_factor(momenta_com, xb_1, xb_2,
                                           pT_mincut, delR_mincut, rap_maxcut)
        shat = xb_1 * xb_2 * collider_energy ** 2
        weight = weight / (2.0 * shat)
        return self._sanitize(momenta_com, weight)

    # -- the channel's density at a point ------------------------------------

    def channel_weight_ps(self, momenta):
        """The pure phase-space channel weight dPhi/du at COM-frame momenta
        ``[B, n_initial+n_final, 4]``: the product of the two-body rho/pi
        factors and the mass maps' densities (ds/du)/(2 pi) at the momenta's
        own invariant masses.  It excludes the channel-independent PDF, cut
        and flux factor, so the multi-channel denominator sum_j alpha_j /
        w_j^PS uses exactly this.  Closed-form: no inversion needed."""
        fin = momenta[:, self.n_initial:, :]

        def node_P(node):
            return sum(fin[:, i, :] for i in node.leaves)

        weight = torch.ones_like(fin[:, 0, 0])
        for node in self._internal:
            M_node = self._node_mass(node, weight, node_P)
            M_A = self._node_mass(node.left, weight, node_P)
            M_B = self._node_mass(node.right, weight, node_P)
            rho = FlatInvertiblePhasespace.rho(M_node, M_A, M_B)
            weight = weight * rho / math.pi
            # the mass maps' densities, bounds re-derived in draw order
            min_a = torch.full_like(M_node, self._min_mass(node.left))
            min_b = torch.full_like(M_node, self._min_mass(node.right))
            if not node.left.is_leaf:
                s_lo = min_a ** 2
                s_hi = torch.maximum((M_node - min_b) ** 2, s_lo)
                weight = weight * node.left.s_map.ds_du_at(M_A ** 2, s_lo, s_hi) / _TWO_PI
            if not node.right.is_leaf:
                s_lo = min_b ** 2
                s_hi = torch.maximum((M_node - M_A) ** 2, s_lo)
                weight = weight * node.right.s_map.ds_du_at(M_B ** 2, s_lo, s_hi) / _TWO_PI
        return weight

    # -- inversion (latents from kinematics) ----------------------------------

    def invertKinematics_batch(self, E_cm, momenta, xb_1=None, xb_2=None):
        """Recover the latents from COM-frame kinematics: the inverse of
        :meth:`generateKinematics_batch`.  Node invariant masses come from
        the momenta and invert through each node's ``s_map.invert``; decay
        angles from boosting each left child into its parent's rest frame.
        With ``pdf_active`` the Bjorken fractions must be given."""
        fin = momenta[:, self.n_initial:, :]

        def node_P(node):
            if node.is_leaf:
                return fin[:, node.index, :]
            return node_P(node.left) + node_P(node.right)

        like = fin[:, 0, 0]
        rv = [None] * self.nDimPhaseSpace()
        for node in self._internal:
            M_node = self._node_mass(node, like, node_P)
            M_A = self._node_mass(node.left, like, node_P)
            M_B = self._node_mass(node.right, like, node_P)
            min_a = torch.full_like(M_node, self._min_mass(node.left))
            min_b = torch.full_like(M_node, self._min_mass(node.right))
            # mass columns: the generation's draw-order bounds
            if not node.left.is_leaf:
                s_lo = min_a ** 2
                s_hi = torch.maximum((M_node - min_b) ** 2, s_lo)
                rv[self._mass_col[id(node.left)]] = node.left.s_map.invert(M_A ** 2, s_lo, s_hi)
            if not node.right.is_leaf:
                s_lo = min_b ** 2
                s_hi = torch.maximum((M_node - M_A) ** 2, s_lo)
                rv[self._mass_col[id(node.right)]] = node.right.s_map.invert(M_B ** 2, s_lo,
                                                                             s_hi)
            # angle columns: the left child in the node's rest frame
            beta = lorentz.boost_vector(node_P(node))
            p_star = lorentz.boost(node_P(node.left), -beta)
            p_mag = torch.sqrt(torch.clamp(torch.sum(p_star[:, 1:] ** 2, dim=-1), min=1e-300))
            cos_t = torch.clamp(p_star[:, 3] / p_mag, -1.0, 1.0)
            phia = torch.atan2(p_star[:, 2], p_star[:, 1])
            phia = torch.where(phia < 0, phia + _TWO_PI, phia)
            c0 = self._ang_col[id(node)]
            rv[c0] = (cos_t + 1.0) / 2.0
            rv[c0 + 1] = phia / _TWO_PI
        rv = torch.stack(rv, dim=1)

        if not self.pdf_active:
            return rv
        if xb_1 is None or xb_2 is None:
            raise PhaseSpaceGeneratorError(
                "invertKinematics_batch with pdf_active requires xb_1 and xb_2")
        return torch.cat([rv, self._invert_pdf_columns(E_cm, xb_1, xb_2)], dim=1)


# ---------------------------------------------------------------------------
# Multi-channel combination
# ---------------------------------------------------------------------------

def multichannel_integrand(matrix_element, channels, alphas, E_cm,
                           pT_mincut=-1, delR_mincut=-1, rap_maxcut=-1,
                           pdgs=(0, 0), aux=False):
    """The alpha-weighted multi-channel integrand over the unit cube.

    ``matrix_element(momenta [B, n_i+n_f, 4]) -> [B]``; ``channels``:
    :class:`ResonanceDecayPhasespace` instances sharing final state and PDF
    configuration; ``alphas``: positive channel weights (normalized here,
    fixed).

    The returned ``g(w) -> [B]`` takes ``w`` of width ``1 +
    nDimPhaseSpace() [+ 2 with a PDF]``: column 0 selects the channel by the
    alpha partition of [0, 1] (a flow can warp it and so learn the channel
    weights); the rest is the selected channel's latent layout.  Each sample
    carries the weight f(x) C(x) / sum_j alpha_j / w_j^PS(x), unbiased for
    any fixed alpha.  Every channel's kinematics are computed for the whole
    batch and selected per sample.  With ``aux`` it returns ``(val, {"r",
    "sel"})``, ``r [C, B]`` each channel's density relative to the
    mixture's, as :func:`optimize_alphas` consumes it.
    """
    alphas = np.asarray(alphas, dtype=np.float64)
    if alphas.ndim != 1 or len(alphas) != len(channels) or np.any(alphas <= 0):
        raise ValueError("alphas must be positive, one per channel")
    alphas = alphas / alphas.sum()
    cum = np.cumsum(alphas)[:-1]  # the selector's bin edges

    n0 = channels[0].nDimPhaseSpace() + (2 if channels[0].pdf_active else 0)
    for c in channels[1:]:
        if c.nDimPhaseSpace() + (2 if c.pdf_active else 0) != n0:
            raise ValueError("all channels must share the latent width")

    def g(w):
        u_sel = w[:, 0]
        rest = w[:, 1:]
        sel = torch.zeros(w.shape[:1], dtype=torch.int32, device=w.device)
        for edge in cum:
            sel = sel + (u_sel >= float(edge)).to(torch.int32)

        moms, wgts = [], []
        for ch in channels:
            m, wt = ch.generateKinematics_batch(
                E_cm, rest, pT_mincut=pT_mincut, delR_mincut=delR_mincut,
                rap_maxcut=rap_maxcut, pdgs=pdgs)
            moms.append(m)
            wgts.append(wt)
        mom_stack = torch.stack(moms, dim=0)      # [C, B, P, 4]
        wgt_stack = torch.stack(wgts, dim=0)      # [C, B]
        onehot = torch.arange(len(channels), device=w.device)[:, None] == sel[None, :]
        momenta = torch.sum(torch.where(onehot[:, :, None, None], mom_stack, 0.0), dim=0)
        w_full = torch.sum(torch.where(onehot, wgt_stack, 0.0), dim=0)

        # the channel densities at the selected point (closed-form)
        ps = torch.stack([ch.channel_weight_ps(momenta) for ch in channels], dim=0)  # [C, B]
        ps_sel = torch.sum(torch.where(onehot, ps, 0.0), dim=0)
        # common factor C(x) = w_full / ps_sel (PDF * cuts / flux); the
        # multi-channel weight is f * C / sum_j alpha_j / ps_j
        inv = torch.where(ps > 0, 1.0 / torch.where(ps > 0, ps, 1.0), 0.0)
        denom = sum(float(a) * inv[j] for j, a in enumerate(alphas))
        ok = (ps_sel > 0) & (denom > 0) & (w_full != 0)
        mc_w = torch.where(ok, w_full / torch.where(ok, ps_sel * denom, 1.0), 0.0)
        val = matrix_element(momenta) * mc_w
        if aux:
            # r_j = p_j / q = (1/ps_j) / sum_m alpha_m / ps_m: what the
            # Kleiss-Pittau update consumes
            r = torch.where((ps > 0) & ok[None, :],
                            inv / torch.where(denom > 0, denom, 1.0), 0.0)
            return val, {"r": r, "sel": sel}
        return val

    return g


def _uniform(generator, n, dim):
    """The latents of one :func:`optimize_alphas` iteration, in the default
    dtype on the generator's device."""
    return torch.rand((n, dim), generator=generator, device=generator.device)


def optimize_alphas(matrix_element, channels, alphas, E_cm, generator,
                    n_iter=5, n_samples=1 << 16, damping=1.0,
                    alpha_floor=1e-3, pT_mincut=-1, delR_mincut=-1,
                    rap_maxcut=-1, pdgs=(0, 0)):
    """Kleiss-Pittau multi-channel weight optimization.

    Iterates the classic update (Kleiss & Pittau 1994): sampling the alpha
    mixture, estimate per-channel second moments ``W_i = E_q[(f/q)^2 p_i]``
    (per sample ``val^2 r_i``, ``r_i`` from the ``aux`` output of
    :func:`multichannel_integrand`) and set ``alpha_i' ~ alpha_i
    W_i^(damping/2)``, toward the variance-minimizing mixture.
    ``alpha_floor`` keeps every channel alive.  ``generator`` is a
    ``torch.Generator``; the latents are drawn on its device, in the default
    dtype.

    Returns ``(alphas, history)``: the optimized weights and one dict per
    iteration (alphas, variance, integral estimate, W_i).  Each iteration
    reduces its batch on the device, in float64, and reads back only the
    ``C + 2`` numbers W_i, the mean and the variance.
    """
    alphas = np.asarray(alphas, dtype=np.float64)
    alphas = alphas / alphas.sum()
    n0 = 1 + channels[0].nDimPhaseSpace() + (2 if channels[0].pdf_active else 0)
    history = []
    for _ in range(int(n_iter)):
        g = multichannel_integrand(
            matrix_element, channels, alphas, E_cm, pT_mincut=pT_mincut,
            delR_mincut=delR_mincut, rap_maxcut=rap_maxcut, pdgs=pdgs, aux=True)
        with torch.no_grad():
            val, ax = g(_uniform(generator, int(n_samples), n0))
            val = val.double()
            moments = torch.cat([(val[None, :] ** 2 * ax["r"].double()).mean(1),
                                 torch.stack([val.mean(), val.var()])]).cpu().numpy()
        W_i = moments[:-2]
        history.append({"alphas": alphas.copy(),
                        "variance": float(moments[-1]),
                        "integral": float(moments[-2]),
                        "W_i": W_i.copy()})
        if np.all(W_i <= 0):
            break
        new = alphas * np.power(np.maximum(W_i, 1e-300), damping / 2.0)
        if new.sum() <= 0:
            break
        new = new / new.sum()
        new = np.maximum(new, alpha_floor)
        alphas = new / new.sum()
    return alphas, history
