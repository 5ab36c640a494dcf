"""The integrands the benchmark hands the program: the user's code.

``camel`` is the plain function.  ``zz4l`` is built, as a user builds it
(the example job's script), from the program's phase space: its decay-tree
channel, ToyPDF, cuts and mappings are the program's integrand layer.  The
reference (``benchmark/reference/integrands.py``) computes both again
without the program.

:class:`Spanned` wraps one: every evaluation runs inside a ``bench.integrand``
span (the traced run reads the device time launched there) and, while
``record`` is a list, keeps the points it was handed, which are the
program's output, for the check.
"""

from __future__ import annotations

from functools import partial

import torch

from benchmark.reference import integrands as plain


def zz4l():
    from nf_tpu_torch.phasespace import lorentz
    from nf_tpu_torch.phasespace.mappings import remap_integrand, shifted_power_unit_map
    from nf_tpu_torch.phasespace.pdf import ToyPDF
    from nf_tpu_torch.phasespace.topology import BreitWignerSMap, ResonanceDecayPhasespace

    channel = ResonanceDecayPhasespace(
        [0.0, 0.0], [0.0] * 4, ((0, 1), (2, 3)),
        mass_maps={(0, 1): BreitWignerSMap(plain.MZ, plain.GZ),
                   (2, 3): BreitWignerSMap(plain.MZ, plain.GZ)},
        pdf=ToyPDF(), pdf_active=True, tau=True)
    cuts = dict(pT_mincut=plain.PT_MIN, delR_mincut=plain.DR_MIN, rap_maxcut=plain.RAP_MAX,
                pdgs=(2, -2))

    def base(w):
        momenta, wgt = channel.generateKinematics_batch(plain.E_CM, w, **cuts)
        fin = momenta[:, 2:, :]
        s34 = lorentz.square(fin[:, 0] + fin[:, 1])
        s56 = lorentz.square(fin[:, 2] + fin[:, 3])
        return 1e4 / ((s34 - plain.MZ2) ** 2 + plain.GAM2) * 1e4 \
            / ((s56 - plain.MZ2) ** 2 + plain.GAM2) * wgt

    tau_th = (2 * plain.MZ / plain.E_CM) ** 2
    return remap_integrand(base, channel.nDimPhaseSpace(), partial(
        shifted_power_unit_map, exponent=-3.0, shift=3 * tau_th))


BUILD = {"camel": lambda: plain.camel, "zz4l": zz4l}


class Spanned:
    def __init__(self, f):
        self.f = f
        self.record = None
        self.calls = 0

    def __call__(self, x):
        self.calls += 1
        with torch.autograd.profiler.record_function("bench.integrand"):
            if self.record is not None:
                self.record.append(x)
            return self.f(x)
