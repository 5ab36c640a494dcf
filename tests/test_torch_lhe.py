"""The port's LHE writer and reader against nf_tpu's.

The same COM-frame events (the port's flat generator on numpy-seeded
latents, rows 0 and 1 the incoming partons) go through both writers: the
text must be the same byte for byte, with and without Bjorken fractions
(the lab-frame boost) and carried weights; the readers must agree on it,
and the events must come back.
"""

import io

import numpy as np
import pytest
import torch

from nf_tpu.utils import lhe as jlhe
from nf_tpu_torch.phasespace import FlatInvertiblePhasespace
from nf_tpu_torch.utils import lhe

torch.set_num_threads(1)
E_CM, E_BEAM = 500.0, 6500.0
PDGS = [2, -2, 11, -11, 13, -13]


def _events(n=64, seed=0):
    gen = FlatInvertiblePhasespace([0.0, 0.0], [0.0] * 4)
    rv = np.random.default_rng(seed).uniform(size=(n, gen.nDimPhaseSpace()))
    mom, _ = gen.generateKinematics_batch(E_CM, torch.from_numpy(rv))
    rng = np.random.default_rng(seed + 1)
    r = rng.uniform(0.5, 2.0, n)
    base = E_CM / (2 * E_BEAM)
    xb = np.stack([base * r, base / r], axis=1)
    return mom.numpy(), xb, 1.0 + rng.exponential(0.3, n)


@pytest.mark.parametrize("with_xb", [False, True])
@pytest.mark.parametrize("with_weights", [False, True])
def test_lhe_text_matches_nf_tpu(with_xb, with_weights):
    mom, xb, wts = _events()
    kw = dict(E_beam=E_BEAM, sigma_pb=3.2, sigma_err_pb=0.05, generator="nf_tpu")
    if with_xb:
        kw["xb"] = xb
    if with_weights:
        kw.update(weights=wts, unit_weight_pb=3.2 / 64)
    text = lhe.lhe_string(mom, PDGS, **kw)
    assert text == jlhe.lhe_string(mom, PDGS, **kw)
    got, ref = lhe.read_lhe(io.StringIO(text)), jlhe.read_lhe(io.StringIO(text))
    assert got["init"] == ref["init"]
    for name in ("pdgs", "status", "colors", "momenta", "masses", "weights", "scales"):
        np.testing.assert_array_equal(got[name], ref[name])
    assert got["init"]["idwtup"] == (4 if with_weights else 3)
    np.testing.assert_allclose(got["weights"], wts * 3.2 / 64 if with_weights else 1.0,
                               rtol=1e-9)
    if with_xb:
        p = got["momenta"]
        np.testing.assert_array_equal(got["status"], [-1, -1, 1, 1, 1, 1])
        np.testing.assert_allclose(p[:, :2].sum(1), p[:, 2:].sum(1), atol=1e-6 * E_CM)
        np.testing.assert_allclose(p[:, 0, 0], xb[:, 0] * E_BEAM, rtol=1e-9)
        np.testing.assert_allclose(got["scales"], E_CM, rtol=1e-9)
    else:
        np.testing.assert_allclose(got["momenta"], mom, rtol=1e-9, atol=1e-9 * E_CM)


def test_lhe_file_round_trip_and_options(tmp_path):
    """A file path, the default generator name, colors and scales given."""
    mom, xb, _ = _events(n=16, seed=3)
    path = tmp_path / "events.lhe"
    colors = [(0, 501), (501, 0)] + [(0, 0)] * 4
    lhe.write_lhe(path, mom, [-1, 1, 11, -11, 13, -13], xb=xb, E_beam=E_BEAM,
                  colors=colors, scale=91.188, sigma_pb=1.5)
    text = path.read_text()
    assert "File generated by nf_tpu_torch" in text
    assert text.replace("nf_tpu_torch", "nf_tpu") == jlhe.lhe_string(
        mom, [-1, 1, 11, -11, 13, -13], xb=xb, E_beam=E_BEAM, colors=colors, scale=91.188,
        sigma_pb=1.5)
    out = lhe.read_lhe(path)
    assert len(out["momenta"]) == 16 and out["init"]["sigma_pb"] == 1.5
    np.testing.assert_array_equal(out["colors"], colors)
    np.testing.assert_array_equal(out["scales"], 91.188)
    # the lab-frame events boost back to the COM frame's invariant mass
    tot = out["momenta"][:, 2:].sum(1)
    np.testing.assert_allclose(np.sqrt(tot[:, 0] ** 2 - (tot[:, 1:] ** 2).sum(1)), E_CM,
                               rtol=1e-9)
