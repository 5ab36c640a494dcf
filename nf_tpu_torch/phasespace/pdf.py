"""Parton distribution functions for the phase-space generator.

Counterpart of ``nf_tpu.phasespace.pdf``.  The PDFs evaluate on the device
of their query, so the whole latent -> phase-space -> matrix-element
pipeline stays there:

  * :class:`ToyPDF`: a CTEQ-like analytic parametrization, for tests and
    benchmarks;
  * :class:`~nf_tpu_torch.phasespace.lhapdf_reader.LHAPDFGrid`: the
    tabulated PDF (log-bicubic), from a real ``.dat`` member
    (``LHAPDFGrid.from_dat``) or any host PDF (``from_tabulated``);
  * :class:`GridPDF`: a constructor adapter over ``LHAPDFGrid`` for raw
    arrays;
  * :class:`CallbackPDF`: a host PDF called per batch.

All return x*f(x) from ``xfxQ2``, like LHAPDF; the generator divides by x.
"""

from __future__ import annotations

import numpy as np
import torch

from nf_tpu_torch.phasespace.lhapdf_reader import LHAPDFGrid


class ToyPDF:
    """Analytic valence+sea toy PDF: x f(x) = N * x^a * (1-x)^b.

    Not a fit to data: a smooth, strictly positive stand-in with realistic
    small-x growth and large-x falloff.
    """

    _params = {  # pdg -> (N, a, b)
        0: (1.0, 0.0, 0.0),
        21: (3.0, -0.2, 5.0),
        1: (0.7, 0.5, 4.0), 2: (1.4, 0.5, 3.0),
        -1: (0.2, -0.2, 6.0), -2: (0.15, -0.2, 6.0),
        3: (0.15, -0.2, 6.0), -3: (0.15, -0.2, 6.0),
        4: (0.08, -0.2, 6.0), -4: (0.08, -0.2, 6.0),
        5: (0.03, -0.2, 6.0), -5: (0.03, -0.2, 6.0),
        6: (0.0, 0.0, 0.0), -6: (0.0, 0.0, 0.0),
    }

    def xfxQ2(self, pdg, x, q2):
        n, a, b = self._params.get(int(pdg), (1.0, 0.0, 0.0))
        x = torch.clamp(x, 1e-10, 1.0)
        return n * x ** a * (1.0 - x) ** b


class GridPDF(LHAPDFGrid):
    """Tabulated PDF from raw ``(xs, q2s, {pdg: [n_x, n_q2]})`` arrays: a
    constructor adapter over :class:`LHAPDFGrid`."""

    def __init__(self, xs, q2s, grids: dict, extrapolation="continuation"):
        flavors = np.asarray(sorted(int(k) for k in grids), dtype=np.int64)
        values = np.stack(
            [np.asarray(grids[int(f)], dtype=np.float64) for f in flavors],
            axis=-1)
        qs = np.sqrt(np.asarray(q2s, dtype=np.float64))
        super().__init__(
            [(np.asarray(xs, dtype=np.float64), qs, flavors, values)],
            extrapolation=extrapolation)

    @classmethod
    def from_lhapdf(cls, pdf, pdgs, n_x=128, n_q2=32,
                    x_range=(1e-6, 1.0 - 1e-9), q2_range=(1.0, 1e8)):
        """Tabulate a host LHAPDF member once."""
        xs = np.geomspace(x_range[0], x_range[1], n_x)
        q2s = np.geomspace(q2_range[0], q2_range[1], n_q2)
        grids = {}
        for pdg in pdgs:
            g = np.empty((n_x, n_q2))
            for i, x in enumerate(xs):
                for j, q2 in enumerate(q2s):
                    g[i, j] = pdf.xfxQ2(int(pdg), float(x), float(q2))
            grids[int(pdg)] = g
        return cls(xs, q2s, grids)


class CallbackPDF:
    """A host PDF (e.g. a real lhapdf member) called once per batch.

    This is the one place where a batch leaves the device: ``x`` and ``q2``
    are copied to the host (``.cpu().numpy()``), the host PDF is called per
    event, and the result is copied back to ``x``'s device and dtype.  It
    stands in for nf_tpu's ``jax.pure_callback``; like it, it costs a round
    trip per batch, so prefer ``LHAPDFGrid.from_tabulated`` on a hot path.
    """

    def __init__(self, host_pdf):
        self._pdf = host_pdf

    def xfxQ2(self, pdg, x, q2):
        pdg = int(pdg)
        xv = x.detach().cpu().numpy().astype(np.float64)
        q2v = q2.detach().cpu().numpy() if torch.is_tensor(q2) else q2
        q2v = np.broadcast_to(np.asarray(q2v, dtype=np.float64), xv.shape)
        out = np.asarray([self._pdf.xfxQ2(pdg, float(a), float(b))
                          for a, b in zip(xv.ravel(), q2v.ravel())],
                         dtype=np.float64).reshape(xv.shape)
        return torch.as_tensor(out, dtype=x.dtype, device=x.device)
