"""RAMBO-on-diet flat phase-space generator (S. Platzer, arXiv:1308.2922).

Counterpart of ``nf_tpu.phasespace.generator``, the same maths in PyTorch:

  * the intermediate masses come from a bisection of a fixed 62 steps (the
    bracket halves each step, below 2^-62), with no data-dependent exit;
  * the deltaR cut is a broadcast pairwise matrix;
  * cuts are evaluated in the LAB frame while the returned momenta are the
    COM-frame copy, a behaviour of the reference generator kept on purpose.

Every method computes on the device and in the dtype of its latents.  The
final masses live on each device once, per (device, dtype).
"""

from __future__ import annotations

import math

import torch

from nf_tpu_torch.phasespace import lorentz


class PhaseSpaceGeneratorError(Exception):
    pass


def _batch(v, n, like):
    """``v`` (a number, or a tensor of ``n`` values) as ``[n]`` in ``like``'s
    dtype and device."""
    if torch.is_tensor(v):
        return v.to(like.dtype).expand(n)
    return torch.full((n,), v, dtype=like.dtype, device=like.device)


class VirtualPhaseSpaceGenerator:
    """Configuration shared by the flat generator and the decay-tree
    channels: masses, PDF, and the PDF convolution, cut and sanitation
    machinery."""

    def __init__(self, initial_masses, final_masses, pdf=None, pdf_active=False, tau=True):
        self.initial_masses = list(initial_masses)
        self.final_masses = [float(m) for m in final_masses]
        self.masses = torch.tensor(self.final_masses, dtype=torch.float64)
        self.n_initial = len(initial_masses)
        self.n_final = len(final_masses)
        self.pdf = pdf
        self.pdf_active = pdf_active
        self.tau = tau
        self._masses_on = {}

    def _masses_like(self, like):
        """:attr:`masses` in ``like``'s dtype and device, copied there once."""
        key = (like.device, like.dtype)
        if key not in self._masses_on:
            self._masses_on[key] = self.masses.to(dtype=like.dtype, device=like.device)
        return self._masses_on[key]

    def generateKinematics(self, E_cm, random_variables):
        raise NotImplementedError

    def nDimPhaseSpace(self):
        """Random numbers the final-state multiplicity needs; the PDF
        convolution, when active, takes 2 more."""
        if self.n_final == 1:
            return 0
        return 3 * self.n_final - 4

    absolute_Ecm_min = 1.0      # GeV floor for the partonic E_cm

    def get_pdfQ2(self, pdf, pdg, x, scale2):
        """PDF density f(x) = xfx / x; non-partonic pdgs give 1."""
        if pdf is None:
            return torch.ones_like(x)
        if pdg not in [21] and abs(pdg) not in range(1, 7):
            return torch.ones_like(x)
        return pdf.xfxQ2(pdg, x, scale2) / x

    def _convolve_pdf(self, E_cm, rv_full, pdgs):
        """Strip the trailing PDF latents and return ``(random_variables,
        E_cm_eff, xb_1, xb_2, wgt_jac)``: tau or direct-x mode, the weight
        zeroed for x < 1e-4, the scale frozen at M_Z^2, and a guard below
        threshold."""
        B = rv_full.shape[0]
        if not self.pdf_active:
            one = torch.ones((B,), dtype=rv_full.dtype, device=rv_full.device)
            return rv_full, E_cm, one, one, one

        random_variables = rv_full[:, :-2]
        thresh = max(sum(self.final_masses), self.absolute_Ecm_min)
        if self.tau:
            # tau = x1 x2 and the rapidity of the pair
            tau_min = (thresh / E_cm) ** 2
            tau, j1 = lorentz.uniform_distr(
                rv_full[:, -2], _batch(tau_min, B, rv_full), _batch(1.0, B, rv_full))
            ycm_min = 0.5 * torch.log(tau)
            ycm, j2 = lorentz.uniform_distr(rv_full[:, -1], ycm_min, -ycm_min)
            sqrt_tau = torch.sqrt(tau)
            xb_1 = sqrt_tau * torch.exp(ycm)
            xb_2 = sqrt_tau * torch.exp(-ycm)
            E_cm_eff = sqrt_tau * E_cm
            wgt_jac = j1 * j2
        else:
            # the Bjorken x's directly
            xb_1 = rv_full[:, -1]
            xb_2 = rv_full[:, -2]
            E_cm_eff = torch.sqrt(xb_1 * xb_2) * E_cm
            wgt_jac = torch.ones_like(xb_1)
        # below threshold (reachable in direct-x mode) the reference gives
        # NaN weights: zero the weight and clamp the kinematics instead
        ok = (E_cm_eff >= thresh).to(rv_full.dtype)
        E_cm_eff = torch.clamp(E_cm_eff, min=thresh)
        wgt_jac = wgt_jac * ok
        scale2 = torch.full((B,), 91.188 ** 2, dtype=rv_full.dtype,
                            device=rv_full.device)       # frozen M_Z^2
        x_cut = (~((xb_1 < 1e-4) | (xb_2 < 1e-4))).to(rv_full.dtype)
        wgt_jac = wgt_jac * self.get_pdfQ2(self.pdf, pdgs[0], xb_1, scale2) \
            * self.get_pdfQ2(self.pdf, pdgs[1], xb_2, scale2) * x_cut
        return random_variables, E_cm_eff, xb_1, xb_2, wgt_jac

    def _invert_pdf_columns(self, E_cm, xb_1, xb_2):
        """The trailing two PDF latent columns from the Bjorken x's: the
        inverse of :meth:`_convolve_pdf`'s stripping."""
        if self.tau:
            tau_min = (max(sum(self.final_masses), self.absolute_Ecm_min) / E_cm) ** 2
            tau = xb_1 * xb_2
            r_tau = (tau - tau_min) / (1.0 - tau_min)
            ycm = 0.5 * torch.log(xb_1 / xb_2)
            ycm_min = 0.5 * torch.log(tau)
            r_ycm = (ycm - ycm_min) / (-2.0 * ycm_min)
            return torch.stack([r_tau, r_ycm], dim=1)
        return torch.stack([xb_2, xb_1], dim=1)

    def _cut_factor(self, momenta_com, xb_1, xb_2, pT_mincut, delR_mincut, rap_maxcut):
        """0/1 cut factor per event, evaluated in the LAB frame."""
        momenta_lab = lorentz.boost_to_lab_frame(momenta_com, xb_1, xb_2)
        fin = momenta_lab[:, self.n_initial:, :]

        factor = torch.ones_like(xb_1)
        pt_min = torch.amin(torch.sqrt(fin[:, :, 1] ** 2 + fin[:, :, 2] ** 2), dim=1)
        factor = torch.where(pt_min < pT_mincut, 0.0, factor)

        if self.n_final > 1 and delR_mincut > 0:
            dr = lorentz.delta_r(fin[:, :, None, :], fin[:, None, :, :])
            pairs = torch.ones((self.n_final, self.n_final), dtype=torch.bool,
                               device=fin.device).tril(-1)
            bad = ((torch.abs(dr) < delR_mincut) & pairs).flatten(1).any(dim=1)
            factor = torch.where(bad, 0.0, factor)

        if rap_maxcut > 0:
            # abs of the largest pseudorapidity, as the reference has it
            max_rap = torch.abs(torch.amax(lorentz.pseudo_rapidity(fin), dim=1))
            factor = torch.where(rap_maxcut < max_rap, 0.0, factor)
        return factor

    @staticmethod
    def _sanitize(momenta_com, weight):
        """Zero numerically unresolvable events instead of letting NaN or inf
        poison the batch (see the flat generator's final sanitation)."""
        bad = ~torch.isfinite(momenta_com).flatten(1).all(dim=1) | ~torch.isfinite(weight)
        weight = torch.where(bad, 0.0, weight)
        momenta_com = torch.where(bad[:, None, None], 0.0,
                                  torch.nan_to_num(momenta_com, nan=0.0, posinf=0.0,
                                                   neginf=0.0))
        return momenta_com, weight

    def setInitialStateMomenta_batch(self, E_cm, batch, like):
        """Beam momenta ``[B, 2, 4]`` along z, in ``like``'s dtype and
        device."""
        if self.n_initial != 2:
            raise PhaseSpaceGeneratorError(
                "This PS generator only supports 2 initial states")
        E = _batch(E_cm, batch, like)
        zeros = torch.zeros_like(E)
        m1, m2 = self.initial_masses
        if m1 == 0.0 or m2 == 0.0:
            p1 = torch.stack([E / 2, zeros, zeros, E / 2], dim=-1)
            p2 = torch.stack([E / 2, zeros, zeros, -E / 2], dim=-1)
        else:
            M1sq, M2sq = m1 ** 2, m2 ** 2
            E1 = (E ** 2 + M1sq - M2sq) / E
            E2 = (E ** 2 - M1sq + M2sq) / E
            Z = torch.sqrt(E ** 4 - 2 * E ** 2 * M1sq - 2 * E ** 2 * M2sq
                           + M1sq ** 2 - 2 * M1sq * M2sq + M2sq ** 2) / E
            p1 = torch.stack([E1 / 2, zeros, zeros, Z / 2], dim=-1)
            p2 = torch.stack([E2 / 2, zeros, zeros, -Z / 2], dim=-1)
        return torch.stack([p1, p2], dim=1)


class FlatInvertiblePhasespace(VirtualPhaseSpaceGenerator):
    """Flat (uniform-weight) invertible 2 -> N phase-space map."""

    epsilon_border = 1e-10      # kept for API parity (unused)

    def __init__(self, *args, **opts):
        super().__init__(*args, **opts)
        if self.n_initial == 1:
            raise PhaseSpaceGeneratorError(
                "This basic generator does not support decay topologies.")
        if self.n_initial > 2:
            raise PhaseSpaceGeneratorError(
                "This basic generator does not support more than 2 incoming particles.")

    # -- closed forms -------------------------------------------------------

    @staticmethod
    def get_flatWeights(E_cm, n):
        """Massless n-body phase-space volume
        Vol(E_cm, n) = (2pi)^(4-3n) (pi/2)^(n-1) (E_cm^2)^(n-2) / ((n-1)!(n-2)!)."""
        if n == 1:
            return 1.0
        norm = math.pow(2 * math.pi, 4 - 3 * n) * math.pow(math.pi / 2.0, n - 1) \
            / (math.factorial(n - 1) * math.factorial(n - 2))
        return norm * (E_cm ** 2) ** (n - 2)

    @staticmethod
    def massless_map(x, exp):
        """v(u) = u^exp ((exp+1) - exp u): the flat intermediate-mass CDF."""
        return (x ** exp) * ((exp + 1) - exp * x)

    @staticmethod
    def rho(M, N, m):
        """sqrt((M^2-(N+m)^2)(M^2-(N-m)^2)) / (8 M^2), the product clamped at
        zero (rounding can push it fractionally negative as N+m nears M)."""
        Msqr = M ** 2
        prod = (Msqr - (N + m) ** 2) * (Msqr - (N - m) ** 2)
        return torch.clamp(prod, min=0.0) ** 0.5 / (8.0 * Msqr)

    # -- intermediate masses -------------------------------------------------

    def bisect_vec_batch(self, v, n_iter: int = 62):
        """Solve v = u^exp((exp+1) - exp u) for u in [0, 1], exp descending
        from n_final-2: a bisection of exactly ``n_iter`` steps, which reach
        full float64 precision; no data-dependent exit."""
        if v.shape[1] == 0:
            return v
        exp = torch.arange(self.n_final - 2, 0, -1, dtype=v.dtype, device=v.device)[None, :]
        left, right = torch.zeros_like(v), torch.ones_like(v)
        for _ in range(n_iter):
            mid = 0.5 * (left + right)
            go_right = self.massless_map(mid, exp) < v
            left, right = torch.where(go_right, mid, left), torch.where(go_right, right, mid)
        return 0.5 * (left + right)

    def generateIntermediatesMassless_batch(self, M0, random_variables):
        """Intermediate masses for massless finals: ``M0 [B]`` the total
        available mass; returns ``M [B, n_final-1]``."""
        u = self.bisect_vec_batch(random_variables[:, : self.n_final - 2])
        cols = [M0]
        for i in range(2, self.n_final):
            cols.append(torch.sqrt(u[:, i - 2] * cols[i - 2] ** 2))
        return torch.stack(cols, dim=1)

    def generateIntermediatesMassive_batch(self, E_cm, random_variables):
        """Intermediate masses and weight for massive finals: ``(M [B,
        n_final-1] with the final masses added back, weight [B])``."""
        masses = self._masses_like(random_variables)
        B = random_variables.shape[0]
        M0 = _batch(E_cm, B, random_variables) - torch.sum(masses)
        K = self.generateIntermediatesMassless_batch(M0, random_variables)
        weight = _batch(self.get_flatWeights(E_cm, self.n_final), B, random_variables)

        # suffix sums of the final masses: m_i + ... + m_{n-1}
        masses_sum = torch.flip(torch.cumsum(torch.flip(masses, (0,)), 0), (0,))
        M = K + masses_sum[: self.n_final - 1][None, :]

        nf = self.n_final
        weight = weight * 8.0 * self.rho(M[:, nf - 2], masses[nf - 1], masses[nf - 2])
        if nf > 2:
            # rho_K == 0 marks a degenerate (measure-zero) intermediate-mass
            # point; the reference gives 0/0 = NaN there: weight it zero
            rho_m = self.rho(M[:, : nf - 2], M[:, 1:], masses[: nf - 2][None, :])
            rho_k = self.rho(K[:, : nf - 2], K[:, 1:], 0.0)
            ratio = torch.where(rho_k > 0, rho_m / torch.where(rho_k > 0, rho_k, 1.0), 0.0)
            weight = weight * torch.prod(ratio * (M[:, 1: nf - 1] / K[:, 1: nf - 1]), dim=-1)
        weight = weight * (K[:, 0] / M[:, 0]) ** (2 * nf - 4)
        return M, weight

    # -- the main map --------------------------------------------------------

    def generateKinematics_batch(self, E_cm, random_variables_full,
                                 pT_mincut=-1, delR_mincut=-1, rap_maxcut=-1,
                                 pdgs=(0, 0)):
        """Map latent points to 2 -> n_final kinematics with cuts and PDFs.

        Returns ``(momenta [B, n_initial+n_final, 4] in the COM frame,
        weight [B])`` with weight = PS weight * PDF * cuts / (2 s_hat).
        """
        rv_full = random_variables_full
        B = rv_full.shape[0]
        masses = self._masses_like(rv_full)
        collider_energy = E_cm

        random_variables, E_cm_eff, xb_1, xb_2, wgt_jac = \
            self._convolve_pdf(E_cm, rv_full, pdgs)
        if random_variables.shape[1] != self.nDimPhaseSpace():
            raise PhaseSpaceGeneratorError(
                f"expected {self.nDimPhaseSpace()} phase-space latents, got "
                f"{random_variables.shape[1]}")

        # intermediate masses and the flat weight
        M, weight = self.generateIntermediatesMassive_batch(E_cm_eff, random_variables)
        weight = weight * wgt_jac

        # the last final mass appended: (M_0 .. M_{n-2}, m_{n-1})
        M_full = torch.cat([M, masses[-1].expand(B, 1)], dim=-1)

        # the two-body decay chain
        q = 4.0 * M_full[:, :-1] * self.rho(M_full[:, :-1], M_full[:, 1:], masses[:-1][None, :])
        rnd = random_variables[:, self.n_final - 2: 3 * self.n_final - 4]
        cos_theta = 2.0 * rnd[:, 0::2] - 1.0
        # clamped sqrt arguments: in float32 cos can round outside [-1, 1]
        sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta ** 2, min=0.0))
        phia = 2.0 * math.pi * rnd[:, 1::2]
        cos_phi = torch.cos(phia)
        sin_phi = torch.sqrt(torch.clamp(1.0 - cos_phi ** 2, min=0.0))
        sin_phi = torch.where(phia > math.pi, -sin_phi, sin_phi)

        a = q * sin_theta * cos_phi
        b = q * sin_theta * sin_phi
        c = q * cos_theta

        zero = torch.zeros((B,), dtype=rv_full.dtype, device=rv_full.device)
        Q = torch.stack([M_full[:, 0], zero, zero, zero], dim=-1)
        finals = []
        for i in range(self.n_final - 1):
            p2 = torch.stack([zero, a[:, i], b[:, i], c[:, i]], dim=-1)
            p2 = lorentz.set_square(p2, masses[i] ** 2)
            p2 = lorentz.boost(p2, lorentz.boost_vector(Q))
            p2 = lorentz.set_square(p2, masses[i] ** 2)
            finals.append(p2)
            Q = lorentz.set_square(Q - p2, M_full[:, i + 1] ** 2)
        finals.append(Q)  # the last particle takes the remaining momentum

        initial = self.setInitialStateMomenta_batch(E_cm_eff, B, rv_full)
        momenta_com = torch.cat([initial, torch.stack(finals, dim=1)], dim=1)

        # cuts in the LAB frame
        weight = weight * self._cut_factor(momenta_com, xb_1, xb_2,
                                           pT_mincut, delR_mincut, rap_maxcut)
        shat = xb_1 * xb_2 * collider_energy ** 2
        weight = weight / (2.0 * shat)

        # Final sanitation: ~1e-6 of float32 events hit numerically
        # unresolvable kinematics (intermediate masses below float precision
        # make the decay chain's boosts reach beta -> 1 and overflow).  One
        # NaN gradient would destroy the optimizer state, so those events are
        # zeroed (a measure-zero bias far below the MC error).
        return self._sanitize(momenta_com, weight)

    # -- the inverse map ------------------------------------------------------

    def invertKinematics_batch(self, E_cm, momenta, xb_1=None, xb_2=None):
        """Recover the latents from COM-frame kinematics ``[B,
        n_initial+n_final, 4]``: the inverse of
        :meth:`generateKinematics_batch`.  With ``pdf_active`` the Bjorken
        fractions must be given, and the trailing two columns are
        reconstructed from them."""
        fin = momenta[:, self.n_initial:, :]
        masses = self._masses_like(momenta)
        nf = self.n_final

        # intermediate masses from the decay chain's remainders
        Qs = [torch.sum(fin[:, i:, :], dim=1) for i in range(nf - 1)]
        M = torch.stack([torch.sqrt(torch.clamp(lorentz.square(Q), min=0.0)) for Q in Qs],
                        dim=1)                               # [B, nf-1]

        # mass variables: invert K_i = sqrt(u_{i-1}) K_{i-1}
        masses_sum = torch.flip(torch.cumsum(torch.flip(masses, (0,)), 0), (0,))
        K = M - masses_sum[: nf - 1][None, :]
        rv_mass = [self.massless_map((K[:, i + 1] / K[:, i]) ** 2, float(nf - 2 - i))
                   for i in range(nf - 2)]

        # angles: each final boosted into its parent's rest frame
        rv_ang = []
        for i in range(nf - 1):
            p_star = lorentz.boost(fin[:, i, :], -lorentz.boost_vector(Qs[i]))
            p_mag = torch.sqrt(torch.sum(p_star[:, 1:] ** 2, dim=-1))
            cos_t = torch.clamp(p_star[:, 3] / p_mag, -1.0, 1.0)
            phia = torch.atan2(p_star[:, 2], p_star[:, 1])
            phia = torch.where(phia < 0, phia + 2.0 * math.pi, phia)
            rv_ang.append((cos_t + 1.0) / 2.0)
            rv_ang.append(phia / (2.0 * math.pi))

        rv = torch.stack(rv_mass + rv_ang, dim=1) if (rv_mass or rv_ang) \
            else momenta.new_zeros((momenta.shape[0], 0))

        if not self.pdf_active:
            return rv
        if xb_1 is None or xb_2 is None:
            raise PhaseSpaceGeneratorError(
                "invertKinematics_batch with pdf_active requires xb_1 and xb_2")
        return torch.cat([rv, self._invert_pdf_columns(E_cm, xb_1, xb_2)], dim=1)
