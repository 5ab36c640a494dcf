"""LHAPDF6 member-file (``.dat``, lhagrid1) reader and log-bicubic
interpolation in PyTorch.

Counterpart of ``nf_tpu.phasespace.lhapdf_reader``: the grid is parsed with
plain numpy (no lhapdf package needed) and evaluated with log-bicubic
interpolation, LHAPDF6's default ``LogBicubic`` family, on the query's
device, so the latent -> phase-space -> PDF -> matrix-element pipeline never
leaves it.

File format (lhagrid1): a YAML-like header terminated by ``---``, then one
block per subgrid, each terminated by ``---``:

    line 1: x knots (ascending)
    line 2: Q knots in GeV (ascending; subgrids partition the Q range)
    line 3: flavor PDG ids
    then len(x)*len(Q) rows of len(flavors) values of x*f(x, Q),
    row-major with the x index outermost.

Values may be negative (interpolation is cubic in the value with log
coordinates); stencils never cross a subgrid edge.  Out-of-range queries
follow the ``extrapolation`` policy:

  * ``"continuation"`` (default, the structure of LHAPDF6's
    ContinuationExtrapolator): below ``x_min``, linear in log x of log(xf)
    from the anchors (x_min, 1.01 x_min) when both anchor values exceed
    1e-3, else linear in log x of the value itself; above ``q2_max`` the
    same recipe in log Q2 from (0.99 q2_max, q2_max); below ``q2_min`` from
    (q2_min, 1.01 q2_min).  Corners extrapolate in x at the two Q2 anchors
    first, then in Q2.
  * ``"nearest"``: clamp to the grid edge.

The tables are copied to a device once, per (device, dtype), and reused.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def read_lhapdf_dat(path):
    """Parse an LHAPDF6 member file.

    Returns ``(meta, subgrids)`` where ``meta`` is the header dict and
    ``subgrids`` is a list of ``(xs, qs, flavors, values)`` with ``values``
    shaped ``[n_x, n_q, n_flavors]`` (x*f at the knots).
    """
    with open(path) as fh:
        lines = [ln.strip() for ln in fh]

    i = 0
    meta = {}
    while i < len(lines) and lines[i] != "---":
        if ":" in lines[i]:
            k, v = lines[i].split(":", 1)
            meta[k.strip()] = v.strip()
        i += 1
    if i >= len(lines):
        raise ValueError(f"{path}: missing '---' header terminator")
    i += 1

    subgrids = []
    while i < len(lines):
        while i < len(lines) and not lines[i]:
            i += 1
        if i >= len(lines) or lines[i] == "---":
            break
        xs = np.asarray(lines[i].split(), dtype=np.float64)
        qs = np.asarray(lines[i + 1].split(), dtype=np.float64)
        flavors = np.asarray(lines[i + 2].split(), dtype=np.int64)
        i += 3
        n_rows = len(xs) * len(qs)
        vals = np.empty((n_rows, len(flavors)), dtype=np.float64)
        for r in range(n_rows):
            row = np.asarray(lines[i + r].split(), dtype=np.float64)
            if row.shape[0] != len(flavors):
                raise ValueError(
                    f"{path}: subgrid {len(subgrids)} row {r} has "
                    f"{row.shape[0]} values, expected {len(flavors)}")
            vals[r] = row
        i += n_rows
        while i < len(lines) and lines[i] != "---":
            if lines[i]:
                raise ValueError(
                    f"{path}: unexpected content after subgrid "
                    f"{len(subgrids)}: {lines[i]!r}")
            i += 1
        i += 1
        subgrids.append((xs, qs, flavors,
                         vals.reshape(len(xs), len(qs), len(flavors))))
    if not subgrids:
        raise ValueError(f"{path}: no subgrids found")
    return meta, subgrids


def _pad_ghost(knots, vals, axis):
    """Add linearly-extrapolated ghost knots/values at both ends of ``axis``
    so every interior cell has a full 4-point Hermite stencil."""
    k = np.concatenate([[2 * knots[0] - knots[1]], knots,
                        [2 * knots[-1] - knots[-2]]])
    lo = 2 * np.take(vals, 0, axis) - np.take(vals, 1, axis)
    hi = 2 * np.take(vals, -1, axis) - np.take(vals, -2, axis)
    v = np.concatenate([np.expand_dims(lo, axis), vals,
                        np.expand_dims(hi, axis)], axis=axis)
    return k, v


def _hermite(k4, v4, t):
    """Nonuniform cubic Hermite on the middle cell of a 4-point stencil:
    ``k4``, ``v4`` are ``[..., 4]`` knots and values, ``t [...]`` lies in
    ``[k4[1], k4[2]]``.  Tangents are LogBicubic's centred differences."""
    h0 = k4[..., 1] - k4[..., 0]
    h1 = k4[..., 2] - k4[..., 1]
    h2 = k4[..., 3] - k4[..., 2]
    d0 = (v4[..., 1] - v4[..., 0]) / h0
    d1 = (v4[..., 2] - v4[..., 1]) / h1
    d2 = (v4[..., 3] - v4[..., 2]) / h2
    m1 = 0.5 * (d0 + d1)
    m2 = 0.5 * (d1 + d2)
    u = (t - k4[..., 1]) / h1
    u2 = u * u
    u3 = u2 * u
    return ((2 * u3 - 3 * u2 + 1) * v4[..., 1]
            + (u3 - 2 * u2 + u) * h1 * m1
            + (-2 * u3 + 3 * u2) * v4[..., 2]
            + (u3 - u2) * h1 * m2)


class _Subgrid:
    def __init__(self, xs, qs, flavors, values):
        self.q2_min = float(qs[0] ** 2)
        self.q2_max = float(qs[-1] ** 2)
        lx, v = _pad_ghost(np.log(xs), values, 0)
        lq, v = _pad_ghost(np.log(qs ** 2), v, 1)
        self.log_xs = lx                      # float64 host copies
        self.log_q2s = lq
        self.values = v                       # [n_x+2, n_q+2, n_f]
        self.flavor_index = {int(f): i for i, f in enumerate(flavors)}
        self._on = {}

    def tables(self, device, dtype):
        """``(log_xs, log_q2s, values)`` on ``device`` in ``dtype``, copied
        there once."""
        key = (torch.device(device), dtype)
        if key not in self._on:
            self._on[key] = tuple(torch.as_tensor(a, dtype=dtype, device=device)
                                  for a in (self.log_xs, self.log_q2s, self.values))
        return self._on[key]

    def eval(self, fidx, lx, lq):
        """Bicubic at the ``(lx, lq)`` batches for flavor column ``fidx``."""
        log_xs, log_q2s, values = self.tables(lx.device, lx.dtype)
        grid = values[:, :, fidx]
        nx, nq = len(self.log_xs), len(self.log_q2s)
        lx = torch.clamp(lx, float(self.log_xs[1]), float(self.log_xs[nx - 2]))
        lq = torch.clamp(lq, float(self.log_q2s[1]), float(self.log_q2s[nq - 2]))
        ix = torch.clamp(torch.searchsorted(log_xs, lx, right=True) - 1, 1, nx - 3)
        iq = torch.clamp(torch.searchsorted(log_q2s, lq, right=True) - 1, 1, nq - 3)
        d = torch.arange(-1, 3, device=lx.device)
        # 4x4 stencils: [B, 4 (x), 4 (q)]
        v44 = grid[ix[:, None, None] + d[None, :, None], iq[:, None, None] + d[None, None, :]]
        kq4 = log_q2s[iq[:, None] + d[None, :]]             # [B, 4]
        kx4 = log_xs[ix[:, None] + d[None, :]]              # [B, 4]
        # along q for each of the 4 x rows, then along x
        vq = _hermite(kq4[:, None, :], v44, lq[:, None])    # [B, 4]
        return _hermite(kx4, vq, lx)                        # [B]


def _extrapolate_linear(u, ua, ub, ya, yb):
    """ContinuationExtrapolator's anchor rule: linear in ``u`` (a log
    coordinate) of log y when both anchors exceed 1e-3, else of y itself."""
    frac = (u - ua) / (ub - ua)
    log_ok = (ya > 1e-3) & (yb > 1e-3)
    log_a = torch.log(torch.clamp(ya, min=1e-300))
    log_b = torch.log(torch.clamp(yb, min=1e-300))
    y_log = torch.exp(log_a + frac * (log_b - log_a))
    y_lin = ya + frac * (yb - ya)
    return torch.where(log_ok, y_log, y_lin)


class LHAPDFGrid:
    """A parsed LHAPDF6 member, evaluated on the query's device.

    ``xfxQ2(pdg, x, q2)`` returns x*f(x, Q2) by log-bicubic interpolation
    per subgrid (subgrids partition the Q range).  Out-of-range queries
    follow the ``extrapolation`` policy, ``"continuation"`` or
    ``"nearest"`` (module docstring).
    """

    def __init__(self, subgrids, meta=None, extrapolation="continuation"):
        self.meta = dict(meta or {})
        self._subgrids = [_Subgrid(*sg) for sg in subgrids]
        if extrapolation not in ("continuation", "nearest"):
            raise ValueError(f"unknown extrapolation policy {extrapolation!r}")
        self.extrapolation = extrapolation
        sg0 = self._subgrids[0]
        self.x_min = float(np.exp(sg0.log_xs[1]))
        self.q2_min = sg0.q2_min
        self.q2_max = self._subgrids[-1].q2_max

    @classmethod
    def from_dat(cls, path, extrapolation="continuation"):
        meta, subgrids = read_lhapdf_dat(path)
        return cls(subgrids, meta, extrapolation)

    @classmethod
    def from_tabulated(cls, xs, q2s, grids, extrapolation="continuation"):
        """A single-subgrid member from tabulated arrays: ``grids`` maps
        pdg -> ``[len(xs), len(q2s)]`` arrays of x*f values.  The way to put
        any host PDF on the device: tabulate once, evaluate there."""
        flavors = np.asarray(sorted(grids), dtype=np.int64)
        values = np.stack([np.asarray(grids[int(f)], dtype=np.float64)
                           for f in flavors], axis=-1)
        xs = np.asarray(xs, dtype=np.float64)
        qs = np.sqrt(np.asarray(q2s, dtype=np.float64))
        if len(xs) < 2 or len(qs) < 2:
            raise ValueError("from_tabulated needs >= 2 knots per axis")
        return cls([(xs, qs, flavors, values)], extrapolation=extrapolation)

    @property
    def flavors(self):
        return sorted(self._subgrids[0].flavor_index)

    def _interp(self, pdg, x, q2):
        """Interior log-bicubic evaluation; out-of-range clamps to the edge.
        The clip at 1e-300 flushes to 0 in float32 (log gives -inf there),
        as in nf_tpu."""
        lx = torch.log(torch.clamp(x, min=1e-300))
        lq = torch.log(torch.clamp(q2, min=1e-300))
        out = torch.zeros_like(x)
        chosen = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
        for si, sg in enumerate(self._subgrids):
            fidx = sg.flavor_index.get(pdg)
            if fidx is None:
                raise KeyError(f"flavor {pdg} not in grid")
            if si == len(self._subgrids) - 1:
                take = ~chosen
            else:
                take = (q2 < sg.q2_max) & ~chosen
            out = torch.where(take, sg.eval(fidx, lx, lq).to(x.dtype), out)
            chosen = chosen | take
        return out

    def xfxQ2(self, pdg, x, q2, extrapolation=None):
        pdg = int(pdg)
        x = torch.atleast_1d(x)
        q2 = q2.to(x.dtype).expand(x.shape) if torch.is_tensor(q2) \
            else torch.full_like(x, float(q2))
        mode = extrapolation or self.extrapolation
        if mode == "nearest":
            return self._interp(pdg, x, q2)
        if mode != "continuation":
            raise ValueError(f"unknown extrapolation policy {mode!r}")

        x_min, q2_min, q2_max = self.x_min, self.q2_min, self.q2_max
        x_lo = x < x_min
        q_lo = q2 < q2_min
        q_hi = q2 > q2_max
        lx = torch.log(torch.clamp(x, min=1e-300))
        lx_a = math.log(x_min)
        lx_b = math.log(1.01 * x_min)

        def with_x_continuation(q2v):
            fi = self._interp(pdg, x, q2v)
            fa = self._interp(pdg, torch.full_like(x, x_min), q2v)
            fb = self._interp(pdg, torch.full_like(x, 1.01 * x_min), q2v)
            fe = _extrapolate_linear(lx, lx_a, lx_b, fa, fb)
            return torch.where(x_lo, fe, fi)

        f_mid = with_x_continuation(torch.clamp(q2, q2_min, q2_max))
        # Q2 anchors: below the range from (q2_min, 1.01 q2_min), above it
        # from (0.99 q2_max, q2_max)
        q2a = torch.full_like(q2, 0.99 * q2_max).masked_fill(q_lo, q2_min)
        q2b = torch.full_like(q2, q2_max).masked_fill(q_lo, 1.01 * q2_min)
        ga = with_x_continuation(q2a)
        gb = with_x_continuation(q2b)
        lq = torch.log(torch.clamp(q2, min=1e-300))
        f_ext_q = _extrapolate_linear(lq, torch.log(q2a), torch.log(q2b), ga, gb)
        return torch.where(q_lo | q_hi, f_ext_q, f_mid)
