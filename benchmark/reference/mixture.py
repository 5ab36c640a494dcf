"""The plain learned multi-channel mixture the benchmark holds the program
against: one piecewise-quadratic flow per phase-space channel, combined
through the full mixture density, trained on the reweighted forward KL with
the Kleiss-Pittau update of the channel weights (MadNIS-style: Heimel et al.,
arXiv:2212.06172 and arXiv:2311.01548), at the sizes of the repository's
example job ``examples/zz_multichannel.py``.  Plain torch, any dtype; it
imports nothing of the program.

What it holds, each written out again from the maths:

* the flow with a rank-r final layer, ``(h u) v + b`` (:func:`forward`),
  and its inverse (:func:`inverse`): the piecewise-quadratic CDF solved
  for its bin and the bin's quadratic by the root that does not cancel,
  with the inverse's Jacobian;
* the two channels of the 2 -> 4 process, decay trees ``((a, b), (c, d))``
  with both pairs' masses Breit-Wigner mapped (:class:`Channel`):
  the kinematics of a latent point with ToyPDF in (tau, y) and the cuts
  (:func:`generate`), the channel's pure phase-space density at any
  momenta (:func:`channel_ps`) and the latents of any momenta
  (:func:`invert`);
* the toy matrix element, Z in (01)(23) plus a coupled Z' in (03)(12)
  (:func:`matrix_element`);
* the mixture (:func:`mixture`): for each source channel k its flow's
  forward of the drawn latents, the kinematics, and for every channel m
  the density ``rho_m(u_m(x)) / w_m^PS(x)``; ``q = sum_m alpha_m rho_m /
  w_m^PS``, the weights ``w = f C / q`` (``C = w_k / w_k^PS``, the PDF,
  cuts and flux) and ``r_m = (rho_m / w_m^PS) / q``;
* the trainer's call (:class:`Trainer`): the pilot's ``w_scale`` (the
  largest weight of one detached minibatch), per epoch the KL loss
  ``-sum_k alpha_k mean_b (w / w_scale)_detached log q`` on every
  minibatch, its gradient averaged, one Adamax step, the ESS and the
  Kleiss-Pittau update ``alpha_m <- alpha_m (W_m / max W)^(damping / 2)``,
  normalised and floored, ``W_m`` the stratified ``E[w^2 r_m]``.

Departures from ``nf_tpu_torch/training/multichannel.py``'s docstring, none
of which changes a number the check compares: no ``mesh`` (one device);
no checkpoint, resume or chunking (a call's history is kept whole); no
best-model snapshot (the window continues the trained flows, never the
best ones, and the check compares none of it); only ``loss_mode="kl"``
and equal per-channel batches of ``ResonanceDecayPhasespace`` pair
channels with ToyPDF in tau mode; the gradient is taken in row blocks of
each minibatch (the loss is a sum over rows with the weights detached and
eval-mode BatchNorm, so the sum is the same); the BatchNorm
running statistics are never moved, as the program's eval-mode flows
never move them.

``fault`` plants one fault in this stand-in for the program, for the
check's calibration: ``"own_density"`` (the mixture density without the
other channels' terms), ``"detached"`` (the other channels' densities
detached, so the gradient flows through the source channel's flow only),
``"no_kleiss_pittau"`` (the alphas' update skipped) and
``"half_minibatch"`` (the second half of each minibatch left out).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from benchmark.reference import flow
from benchmark.reference import integrands as zz
from benchmark.reference.train import adamax

EPS_U = 1e-9        # the latents' clamp into the open cube
FAULTS = ("own_density", "detached", "no_kleiss_pittau", "half_minibatch")


# ---------------------------------------------------------------------------
# The process
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Channel:
    pairs: tuple        # ((a, b), (c, d)): the root's children, each a pair of leptons
    mass: float         # both pairs' Breit-Wigner map
    width: float


@dataclasses.dataclass(frozen=True)
class Process:
    channels: tuple
    e_cm: float
    z: tuple            # (mass, width) of the (01)(23) resonances
    zprime: tuple       # (mass, width) of the (03)(12) resonances
    coupling: float     # the Z' term's factor
    pt_min: float
    dr_min: float
    rap_max: float


def process(spec):
    """The :class:`Process` of a configuration's ``integrand`` entry."""
    res = {"z": tuple(spec["z"]), "zprime": tuple(spec["zprime"])}
    cuts = spec["cuts"]
    channels = tuple(Channel(tuple(tuple(p) for p in ch["pairs"]), *res[ch["resonance"]])
                     for ch in spec["channels"])
    return Process(channels, float(spec["e_cm"]), res["z"], res["zprime"],
                   float(spec["zprime_coupling"]), float(cuts["pT_mincut"]),
                   float(cuts["delR_mincut"]), float(cuts["rap_maxcut"]))


def _bw_angles(ch, s_lo, s_hi):
    m2, mg = ch.mass ** 2, ch.mass * ch.width
    return torch.atan((s_lo - m2) / mg), torch.atan((s_hi - m2) / mg)


def _bw_sample(ch, u, s_lo, s_hi):
    """``(s, ds/du)``: s = m^2 + m Gamma tan(t), t uniform between the
    bounds' angles."""
    m2, mg = ch.mass ** 2, ch.mass * ch.width
    t_lo, t_hi = _bw_angles(ch, s_lo, s_hi)
    t = t_lo + u * (t_hi - t_lo)
    s = torch.minimum(torch.maximum(m2 + mg * torch.tan(t), s_lo), s_hi)
    return s, (t_hi - t_lo) * mg / torch.cos(t) ** 2


def _bw_density(ch, s, s_lo, s_hi):
    """ds/du of the map at ``s``."""
    m2, mg = ch.mass ** 2, ch.mass * ch.width
    t_lo, t_hi = _bw_angles(ch, s_lo, s_hi)
    return (t_hi - t_lo) * ((s - m2) ** 2 + mg * mg) / mg


def _bw_invert(ch, s, s_lo, s_hi):
    m2, mg = ch.mass ** 2, ch.mass * ch.width
    t_lo, t_hi = _bw_angles(ch, s_lo, s_hi)
    t = torch.atan((s - m2) / mg)
    return torch.clamp((t - t_lo) / torch.clamp(t_hi - t_lo, min=1e-300), 0.0, 1.0)


def _mass(p):
    return torch.sqrt(torch.clamp(zz._square(p), min=0.0))


def _tau_min(proc):
    # the partonic threshold: max(sum of the final masses, 1 GeV)
    return (1.0 / proc.e_cm) ** 2


def generate(ch, proc, u):
    """``(momenta [B, 6, 4] in the partonic rest frame, weight [B], xb_1,
    xb_2)`` of latents ``u [B, 10]``: columns 0-1 the two pairs' masses,
    2-7 (cos theta, phi) of the root, the first and the second pair, 8-9
    (tau, y); the weight dPhi/du x PDF x cuts / (2 s_hat)."""
    B, dtype, device = u.shape[0], u.dtype, u.device
    one = torch.ones((B,), dtype=dtype, device=device)
    tau_min = _tau_min(proc)
    tau = one * tau_min + (one - one * tau_min) * u[:, 8]
    y_min = 0.5 * torch.log(tau)
    y = y_min + (-y_min - y_min) * u[:, 9]
    sqrt_tau = torch.sqrt(tau)
    xb_1, xb_2 = sqrt_tau * torch.exp(y), sqrt_tau * torch.exp(-y)
    e_eff = sqrt_tau * proc.e_cm
    weight = (one - one * tau_min) * (-y_min - y_min) * (e_eff >= 1.0).to(dtype)
    e_eff = torch.clamp(e_eff, min=1.0)
    x_cut = (~((xb_1 < 1e-4) | (xb_2 < 1e-4))).to(dtype)
    weight = weight * (zz._toy(zz.TOY_U, xb_1) / xb_1) * (zz._toy(zz.TOY_UBAR, xb_2) / xb_2) \
        * x_cut

    zero = torch.zeros_like(e_eff)
    s_a, ds_a = _bw_sample(ch, u[:, 0], zero, torch.maximum(e_eff ** 2, zero))
    weight = weight * ds_a / zz.TWO_PI
    m_a = torch.sqrt(torch.clamp(s_a, min=0.0))
    s_b, ds_b = _bw_sample(ch, u[:, 1], zero, torch.maximum((e_eff - m_a) ** 2, zero))
    weight = weight * ds_b / zz.TWO_PI
    m_b = torch.sqrt(torch.clamp(s_b, min=0.0))
    q_root = torch.stack([e_eff, zero, zero, zero], -1)
    p_a, p_b, weight = zz._two_body(e_eff, m_a, m_b, q_root, u[:, 2], u[:, 3], weight)
    finals = [None] * 4
    (i, j), (k, l) = ch.pairs
    finals[i], finals[j], weight = zz._two_body(m_a, zero, zero, p_a, u[:, 4], u[:, 5], weight)
    finals[k], finals[l], weight = zz._two_body(m_b, zero, zero, p_b, u[:, 6], u[:, 7], weight)
    half = e_eff / 2
    initial = [torch.stack([half, zero, zero, half], -1),
               torch.stack([half, zero, zero, -half], -1)]
    momenta = torch.stack(initial + finals, 1)

    # cuts in the lab frame
    ref_lab = momenta[:, 0, :] * xb_1[:, None] + momenta[:, 1, :] * xb_2[:, None]
    r2 = zz._rho2(ref_lab)
    beta = torch.where(r2[:, None] > 0, zz._boost_vector(ref_lab), 0.0)
    need = ((xb_1 != 1.0) | (xb_2 != 1.0)) & (r2 > 0)
    lab = torch.where(need[:, None, None], zz._boost(momenta, beta[:, None, :]), momenta)
    fin = lab[:, 2:, :]
    cut = torch.ones_like(xb_1)
    pt_min = torch.amin(torch.sqrt(fin[:, :, 1] ** 2 + fin[:, :, 2] ** 2), dim=1)
    cut = torch.where(pt_min < proc.pt_min, 0.0, cut)
    dr = zz._delta_r(fin[:, :, None, :], fin[:, None, :, :])
    pairs = torch.ones((4, 4), dtype=torch.bool, device=device).tril(-1)
    cut = torch.where(((torch.abs(dr) < proc.dr_min) & pairs).flatten(1).any(dim=1), 0.0, cut)
    cut = torch.where(proc.rap_max < torch.abs(torch.amax(zz._eta(fin), dim=1)), 0.0, cut)
    weight = weight * cut / (2.0 * (xb_1 * xb_2 * proc.e_cm ** 2))

    bad = ~torch.isfinite(momenta).flatten(1).all(dim=1) | ~torch.isfinite(weight)
    weight = torch.where(bad, 0.0, weight)
    momenta = torch.where(bad[:, None, None], 0.0,
                          torch.nan_to_num(momenta, nan=0.0, posinf=0.0, neginf=0.0))
    return momenta, weight, xb_1, xb_2


def _nodes(ch, momenta):
    """``(M_root, M_a, M_b, P_root, P_a, P_b, finals)`` at partonic-frame
    momenta: the pairs' masses and momenta read from the leptons."""
    fin = momenta[:, 2:, :]
    (i, j), (k, l) = ch.pairs
    p_a, p_b = fin[:, i] + fin[:, j], fin[:, k] + fin[:, l]
    p_root = fin[:, 0] + fin[:, 1] + fin[:, 2] + fin[:, 3]
    return _mass(p_root), _mass(p_a), _mass(p_b), p_root, p_a, p_b, fin


def channel_ps(ch, momenta):
    """The channel's pure phase-space density dPhi/du at ``momenta``: the
    three two-body factors rho / pi and the two pairs' (ds/du) / (2 pi),
    without the PDF, cuts and flux."""
    m_root, m_a, m_b, *_ = _nodes(ch, momenta)
    zero = torch.zeros_like(m_root)
    w = zz._rho(m_root, m_a, m_b) / math.pi
    w = w * zz._rho(m_a, zero, zero) / math.pi * zz._rho(m_b, zero, zero) / math.pi
    w = w * _bw_density(ch, m_a ** 2, zero, torch.maximum(m_root ** 2, zero)) / zz.TWO_PI
    return w * _bw_density(ch, m_b ** 2, zero, torch.maximum((m_root - m_a) ** 2, zero)) \
        / zz.TWO_PI


def _angles(parent, child):
    """(cos theta + 1) / 2 and phi / (2 pi) of ``child`` in ``parent``'s rest
    frame."""
    p = zz._boost(child, -zz._boost_vector(parent))
    mag = torch.sqrt(torch.clamp(torch.sum(p[:, 1:] ** 2, dim=-1), min=1e-300))
    cos_t = torch.clamp(p[:, 3] / mag, -1.0, 1.0)
    phi = torch.atan2(p[:, 2], p[:, 1])
    phi = torch.where(phi < 0, phi + zz.TWO_PI, phi)
    return (cos_t + 1.0) / 2.0, phi / zz.TWO_PI


def invert(ch, proc, momenta, xb_1, xb_2):
    """The channel's latents ``[B, 10]`` of partonic-frame ``momenta`` and
    Bjorken fractions: the inverse of :func:`generate`."""
    m_root, m_a, m_b, p_root, p_a, p_b, fin = _nodes(ch, momenta)
    zero = torch.zeros_like(m_root)
    (i, _), (k, _) = ch.pairs
    cols = [_bw_invert(ch, m_a ** 2, zero, torch.maximum(m_root ** 2, zero)),
            _bw_invert(ch, m_b ** 2, zero, torch.maximum((m_root - m_a) ** 2, zero))]
    cols += [*_angles(p_root, p_a), *_angles(p_a, fin[:, i]), *_angles(p_b, fin[:, k])]
    tau_min = _tau_min(proc)
    tau = xb_1 * xb_2
    y_min = 0.5 * torch.log(tau)
    cols += [(tau - tau_min) / (1.0 - tau_min),
             (0.5 * torch.log(xb_1 / xb_2) - y_min) / (-2.0 * y_min)]
    return torch.stack(cols, dim=1)


def matrix_element(proc, momenta):
    """The toy |M|^2: Z resonances in (01)(23) plus ``coupling`` times Z'
    resonances in (03)(12)."""
    f = momenta[:, 2:, :]

    def bw(i, j, res):
        m, g = res
        return 1e4 / ((zz._square(f[:, i] + f[:, j]) - m * m) ** 2 + (m * g) ** 2)

    return bw(0, 1, proc.z) * bw(2, 3, proc.z) \
        + proc.coupling * bw(0, 3, proc.zprime) * bw(1, 2, proc.zprime)


# ---------------------------------------------------------------------------
# The flow with a rank-r final layer
# ---------------------------------------------------------------------------

def param_shapes(plan, rank):
    """``{key: shape}`` of every parameter and BatchNorm buffer of one
    channel's flow: :func:`benchmark.reference.flow.param_shapes` with each
    final ``w [prev, out]`` factored as ``u [prev, rank]`` and ``v [rank,
    out]``."""
    out = {}
    for key, shape in flow.param_shapes(plan).items():
        if key.endswith(".final.w"):
            out[key[:-1] + "u"] = (shape[0], rank)
            out[key[:-1] + "v"] = (rank, shape[1])
        else:
            out[key] = shape
    return out


def conditioner(p, c, plan, xA, mode, mm=flow.matmul, new_stats=None):
    pre = f"cells.{c}."
    h = flow._batchnorm(xA, p, pre + "bn_in", mode, new_stats, None)
    for i in range(len(plan.hidden)):
        h = mm(h, p[pre + f"linears.{i}.w"])
        h = torch.relu(flow._batchnorm(h, p, pre + f"bns.{i}", mode, new_stats, None))
    return mm(mm(h, p[pre + "final.u"]), p[pre + "final.v"]) + p[pre + "final.b"]


def forward(p, plan, w, mode="eval", mm=flow.matmul, new_stats=None):
    """Latents ``w [B, n_flow]`` to ``(x, jac)``, as
    :func:`benchmark.reference.flow.forward` with the rank-r final layer."""
    x = w
    jac = torch.ones(w.shape[0], dtype=w.dtype, device=w.device)
    for op in plan.ops:
        if op[0] == "perm":
            x = x[:, list(op[1])]
            continue
        c = op[1]
        pt = plan.pass_through[c]
        yB, pdf = flow.pwquad(conditioner(p, c, plan, x[:, :pt], mode, mm, new_stats),
                              x[:, pt:], plan.n_bins)
        x = torch.cat([x[:, :pt], yB], 1)
        jac = jac * pdf
    return x, jac


def pwquad_inverse(z, yB, n_bins):
    """The inverse of :func:`benchmark.reference.flow.pwquad`: ``(xB, pdf
    [B])``, the pdf the forward's product at the recovered point.  The bin
    is the number of bins whose right CDF edge lies at or below ``yB``
    (the last bin at most), and alpha the root of ``dv w alpha^2 / 2 + v_lo
    w alpha = yB - cdf_lo`` that does not cancel."""
    z = z.reshape(z.shape[0], yB.shape[1], 2 * n_bins + 1)
    v, w = torch.exp(z[..., :n_bins + 1]), torch.exp(z[..., n_bins + 1:])
    wsum = torch.cumsum(w, -1)
    w = w / wsum[..., -1:]
    wsum = wsum / wsum[..., -1:]
    v = v / torch.sum((v[..., :-1] + v[..., 1:]) * 0.5 * w, -1, keepdim=True)
    cdf = torch.cumsum((v[..., :-1] + v[..., 1:]) * 0.5 * w, -1)
    b = torch.clamp(torch.sum((cdf <= yB.unsqueeze(-1)).long(), -1), max=n_bins - 1)
    w_b = flow._take(w, b)
    v_lo, v_hi = flow._take(v, b), flow._take(v, b + 1)
    c = (yB - flow._take(torch.nn.functional.pad(cdf, (1, 0)), b)) / w_b
    dv = v_hi - v_lo
    root = torch.sqrt(torch.clamp_min(v_lo * v_lo + 2.0 * dv * c, 0.0))
    alpha = torch.where(torch.abs(dv) > 1e-12 * (v_lo + v_hi),
                        2.0 * c / torch.where(root + v_lo == 0, 1.0, root + v_lo),
                        c / torch.where(v_lo == 0, 1.0, v_lo))
    xB = flow._take(torch.nn.functional.pad(wsum, (1, 0)), b) + alpha * w_b
    return xB, torch.prod(v_lo + dv * alpha, -1)


def inverse(p, plan, y, mm=flow.matmul):
    """Points ``y [B, n_flow]`` back to latents: ``(w, jac_inv)``, the
    inverse map's Jacobian (the reciprocal of the forward's); the
    conditioners in eval mode."""
    n = plan.n_flow
    jac = torch.ones(y.shape[0], dtype=y.dtype, device=y.device)
    for op in reversed(plan.ops):
        if op[0] == "perm":
            y = y[:, [op[1].index(d) for d in range(n)]]
            continue
        c = op[1]
        pt = plan.pass_through[c]
        xB, pdf = pwquad_inverse(conditioner(p, c, plan, y[:, :pt], "eval", mm), y[:, pt:],
                                 plan.n_bins)
        y = torch.cat([y[:, :pt], xB], 1)
        jac = jac / pdf
    return y, jac


def bn_pass(p, plan, w):
    """``p`` with its running statistics moved by one train-mode pass over
    the latents ``w``."""
    new = {}
    with torch.no_grad():
        forward(p, plan, w, "train", new_stats=new)
    return dict(p, **new)


# ---------------------------------------------------------------------------
# The mixture and the trainer
# ---------------------------------------------------------------------------

def tiny(dtype):
    return max(1e-300, torch.finfo(dtype).tiny)


def mixture(params, plan, proc, alphas, zs, mm=flow.matmul, fault=None):
    """The mixture of one minibatch: ``zs[k]`` the latents drawn for source
    channel ``k``, ``params[m]`` channel m's flow, ``alphas [C]``.  Returns
    ``(w [C, B], q [C, B], r [C, C, B] (density channel, source, row),
    u)``, ``u[k]`` the source flow's forward output before the clamp.  The
    gradient reaches the flows through ``q`` (and so ``w`` and ``r``)
    alone."""
    ws, qs, rs, us = [], [], [], []
    for k, ch in enumerate(proc.channels):
        with torch.no_grad():
            u_raw, _ = forward(params[k], plan, zs[k], "eval", mm)
            u_k = torch.clamp(u_raw, EPS_U, 1.0 - EPS_U)
            x, w_full, xb_1, xb_2 = generate(ch, proc, u_k)
        dens = []
        for m, chm in enumerate(proc.channels):
            with torch.no_grad():
                ps_m = channel_ps(chm, x)
                if m == k:
                    ps_k, u_m, ok_m = ps_m, u_k, ps_m > 0
                else:
                    u_m = invert(chm, proc, x, xb_1, xb_2)
                    ok_m = (ps_m > 0) & torch.all((u_m > 0.0) & (u_m < 1.0), dim=1)
                u_m = torch.clamp(torch.where(ok_m[:, None], u_m, 0.5), EPS_U, 1.0 - EPS_U)
            _, rho_m = inverse(params[m], plan, u_m, mm)
            d = torch.where(ok_m, rho_m / torch.where(ok_m, ps_m, 1.0), 0.0)
            dens.append(d.detach() if fault == "detached" and m != k else d)
        dens = torch.stack(dens, 0)
        if fault == "own_density":
            q = alphas[k] * dens[k]
        else:
            q = torch.sum(alphas[:, None] * dens, 0)
        with torch.no_grad():
            ok = (ps_k > 0) & (q > 0) & (w_full != 0)
            cfac = torch.where(ok, w_full / torch.where(ps_k > 0, ps_k, 1.0), 0.0)
            f = matrix_element(proc, x)
        ws.append(torch.where(ok, f * cfac / torch.where(ok, q, 1.0), 0.0))
        qs.append(q)
        live = q[None, :] > 0
        rs.append(torch.where(live, dens / torch.where(live, q[None, :], 1.0), 0.0))
        us.append(u_raw)
    return torch.stack(ws), torch.stack(qs), torch.stack(rs, 1), us


def kl_loss(w, q, w_scale, alphas, n):
    """``-sum_k alpha_k sum_b (w / w_scale)_detached log q / n``."""
    logq = torch.log(torch.clamp_min(q, tiny(q.dtype)))
    return -torch.sum(alphas * torch.sum((w / w_scale).detach() * logq, 1) / n)


class Trainer:
    """One run of the trainer: ``params[k]`` channel k's flow (float
    ``dtype`` leaves and buffers), the generator whose draws the program's
    made, the training settings ``cfg`` (``batch_per_channel``,
    ``mini_batch_per_channel``, ``lr``, ``weight_decay``, ``betas``,
    ``eps``, ``alpha_damping``, ``alpha_floor``)."""

    def __init__(self, plan, proc, p0, gen, cfg, dtype=torch.float64, mm=flow.matmul,
                 fault=None, block=1 << 15):
        self.plan, self.proc, self.gen, self.cfg, self.mm = plan, proc, gen, cfg, mm
        self.dtype, self.fault, self.block = dtype, fault, block
        self.p = [{k: v.to(dtype) for k, v in p.items()} for p in p0]

    def _draw(self, n):
        return torch.rand((n, self.plan.n_flow), generator=self.gen, dtype=torch.float32,
                          device=self.gen.device).to(self.dtype)

    def _leaves(self):
        return [(c, k) for c, p in enumerate(self.p) for k in p if not flow.is_buffer(k)]

    def call(self, epochs, alphas):
        """One call of ``epochs`` epochs from ``alphas`` with a fresh
        optimizer: ``{"loss", "integral", "ess", "alphas": [per epoch],
        "opt": {(channel, key): (m, u)}, "first": {(channel, key): the
        first step's m}, "u": [each minibatch's source points of the first
        epoch, source by source]}``; the flows are
        left in ``self.p`` and the last alphas in ``self.alphas``."""
        cfg, C = self.cfg, len(self.proc.channels)
        mb, n_tot = cfg["mini_batch_per_channel"], cfg["batch_per_channel"]
        n_mb, eps = n_tot // mb, tiny(self.dtype)
        a = torch.as_tensor(alphas, dtype=torch.float64, device=self.gen.device)
        alphas = (a / torch.sum(a)).to(self.dtype)
        with torch.no_grad():
            w0 = mixture(self.p, self.plan, self.proc, alphas,
                         [self._draw(mb) for _ in range(C)], self.mm)[0]
        w_scale = torch.clamp_min(torch.max(w0), eps)
        out = {"loss": [], "integral": [], "ess": [], "alphas": [], "opt": {}, "u": []}
        for e in range(epochs):
            leaves = self._leaves()
            grads = {(c, key): torch.zeros_like(self.p[c][key]) for c, key in leaves}
            zero = torch.zeros((C,), dtype=self.dtype, device=self.gen.device)
            loss_sum, s1, s2, sW = 0.0, zero, zero, zero
            for _ in range(n_mb):
                zs = [self._draw(mb) for _ in range(C)]
                if self.fault == "half_minibatch":
                    zs = [z[: mb // 2] for z in zs]
                n, points = zs[0].shape[0], [[] for _ in range(C)]
                for lo in range(0, n, self.block):
                    params = [{k: v.clone().requires_grad_(not flow.is_buffer(k))
                               for k, v in p.items()} for p in self.p]
                    w, q, r, us = mixture(params, self.plan, self.proc, alphas,
                                          [z[lo:lo + self.block] for z in zs], self.mm,
                                          self.fault)
                    loss = kl_loss(w, q, w_scale, alphas, n)
                    got = torch.autograd.grad(loss, [params[c][key] for c, key in leaves],
                                              allow_unused=True)
                    for (c, key), g in zip(leaves, got):
                        if g is not None:
                            grads[(c, key)] += g
                    w = w.detach()
                    loss_sum += float(loss.detach())
                    s1 = s1 + torch.sum(w, 1)
                    s2 = s2 + torch.sum(w ** 2, 1)
                    sW = sW + torch.sum(alphas[None, :, None] * w[None] ** 2 * r.detach(),
                                        dim=(1, 2))
                    for k, u in enumerate(us):
                        points[k].append(u.detach())
                if e == 0:
                    out["u"] += [torch.cat(blocks) for blocks in points]
            flat = {(c, k): self.p[c][k] for c, k in leaves}
            adamax(flat, {key: g / n_mb for key, g in grads.items()}, out["opt"], e + 1,
                   cfg["lr"], cfg["betas"], cfg["eps"], cfg["weight_decay"])
            for (c, k), v in flat.items():
                self.p[c][k] = v
            if e == 0:
                out["first"] = {key: m.clone() for key, (m, _) in out["opt"].items()}
            m1 = torch.sum(alphas * s1) / n_tot
            m2 = torch.sum(alphas * s2) / n_tot
            ess = m1 ** 2 / torch.clamp_min(m2, eps)
            if self.fault != "no_kleiss_pittau":
                W = sW / n_tot
                new = alphas * torch.pow(torch.clamp_min(W / torch.clamp_min(torch.max(W), eps),
                                                         1e-12), cfg["alpha_damping"] / 2.0)
                new = torch.clamp_min(new / torch.sum(new), cfg["alpha_floor"])
                alphas = new / torch.sum(new)
            out["loss"].append(loss_sum / n_mb)
            out["integral"].append(float(m1))
            out["ess"].append(float(ess))
            out["alphas"].append(alphas.detach().clone())
        self.alphas = alphas
        return out


def train_outputs(p0, plan, proc, seeds, epochs, alphas0, cfg, device, dtype=torch.float64,
                  mm=flow.matmul, fault=None):
    """The calls of the check, each from a generator seeded with
    ``seeds[i]`` running ``epochs[i]`` epochs, continuing the flows and the
    alphas: every epoch's loss, integral, ESS and alphas, the first step's
    gradient (the first moment after one step over ``1 - beta1``), the
    first call's first-epoch source points, and the flows' parameters after
    the last call, keyed ``"<channel>.<key>"``."""
    gen = torch.Generator(device=device)
    tr = Trainer(plan, proc, p0, gen, cfg, dtype, mm, fault)
    out, alphas = {"loss": [], "integral": [], "ess": [], "alphas": []}, alphas0
    for i, (seed, n) in enumerate(zip(seeds, epochs)):
        gen.manual_seed(seed)
        res = tr.call(n, alphas)
        alphas = tr.alphas
        for key in out:
            out[key] += res[key]
        if i == 0:
            grad = {f"{c}.{k}": m / (1 - cfg["betas"][0]) for (c, k), m in res["first"].items()}
            points = res["u"]
    return dict(out, grad=grad, x=points,
                params={f"{c}.{k}": v for c, p in enumerate(tr.p) for k, v in p.items()
                        if not flow.is_buffer(k)})
