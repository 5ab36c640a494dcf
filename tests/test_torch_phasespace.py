"""The port's flat phase-space generator against nf_tpu's.

The same numpy-seeded latents go through ``nf_tpu.phasespace`` and
``nf_tpu_torch.phasespace`` on the CPU.  In float64 the weights agree to
rtol 1e-12 and the momenta to 1e-12 of the collider energy (components
cancel); the cut decisions, each cut alone and all together, are the same
on the same events; both PDF modes agree, with the x < 1e-4 zeroing and the
sub-threshold guard; the inverse agrees and round-trips; the massless
weight is the exact flat volume.

In float32 the weights agree to 1e-5 relative and the sanitised events
(momenta zeroed) are the same ones.  The momenta there agree only to ~1e-4
relative where |cos phi| nears 1: sin phi = sqrt(1 - cos^2 phi) is
ill-conditioned, and XLA's and PyTorch's float32 cos differ in the last
bits.  On degenerate 2 -> 4 latents that difference decides whether a
boost reaches beta = 1, so one such event is sanitised by one package only
(its weight is zero in both); the 2 -> 5 case below has no such event.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf_tpu.phasespace import FlatInvertiblePhasespace as JFlat
from nf_tpu.phasespace.pdf import ToyPDF as JToyPDF
from nf_tpu_torch import FlatInvertiblePhasespace, PhaseSpaceGeneratorError
from nf_tpu_torch.phasespace.pdf import ToyPDF

torch.set_num_threads(1)
E_CM = 1000.0
CUTS = {"pt": dict(pT_mincut=20.0), "delr": dict(delR_mincut=0.4),
        "rap": dict(rap_maxcut=2.4),
        "all": dict(pT_mincut=20.0, delR_mincut=0.4, rap_maxcut=2.4)}


def _latents(seed, n, dim, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, size=(n, dim))


def _generate(masses, rv, pdf=False, tau=True, dtype=np.float64, jit=True, **kw):
    """``(momenta, weight)`` of nf_tpu and of the port on the same latents.
    nf_tpu's side runs as one compiled program (eager nf_tpu compiles every
    op anew per shape and dtype), or with ``jit=False`` op by op: XLA's
    fused ``pow`` and ``cos`` round otherwise than the op-by-op ones (the
    ToyPDF's weights move by ~1e-11 relative), and the port computes op by
    op."""
    opts = dict(pdf_active=pdf, tau=tau)
    jg = JFlat([0.0, 0.0], masses, pdf=JToyPDF() if pdf else None, **opts)
    tg = FlatInvertiblePhasespace([0.0, 0.0], masses, pdf=ToyPDF() if pdf else None, **opts)
    fn = lambda w: jg.generateKinematics_batch(E_CM, w, **kw)  # noqa: E731
    mj, wj = (jax.jit(fn) if jit else fn)(jnp.asarray(rv, dtype))
    mt, wt = tg.generateKinematics_batch(E_CM, torch.from_numpy(rv.astype(dtype)), **kw)
    assert mt.dtype == wt.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
    return (np.asarray(mj), np.asarray(wj)), (mt.numpy(), wt.numpy())


def _close_f64(j, t):
    np.testing.assert_allclose(t[1], j[1], rtol=1e-12, atol=0.0)
    np.testing.assert_allclose(t[0], j[0], rtol=1e-12, atol=1e-12 * E_CM)


def test_generator_guards():
    with pytest.raises(PhaseSpaceGeneratorError):
        FlatInvertiblePhasespace([100.0], [50.0, 50.0])
    with pytest.raises(PhaseSpaceGeneratorError):
        FlatInvertiblePhasespace([1.0] * 3, [50.0, 50.0])
    gen = FlatInvertiblePhasespace([0.0, 0.0], [0.0] * 4)
    assert gen.nDimPhaseSpace() == 8
    with pytest.raises(PhaseSpaceGeneratorError):
        gen.generateKinematics_batch(E_CM, torch.rand(4, 7, dtype=torch.float64))


@pytest.mark.parametrize("masses", [[0.0, 0.0], [0.0] * 3, [0.0] * 4, [100.0, 200.0],
                                    [50.0, 50.0, 50.0], [173.0, 4.7, 0.0, 80.4]])
def test_generate_matches_nf_tpu(masses):
    rv = _latents(0, 512, 3 * len(masses) - 4)
    j, t = _generate(masses, rv)
    _close_f64(j, t)
    assert np.all(t[1] > 0)
    # momentum conservation and the on-shell conditions hold in the port
    np.testing.assert_allclose(t[0][:, :2].sum(1), t[0][:, 2:].sum(1), atol=1e-9 * E_CM)
    m2 = t[0][..., 0] ** 2 - np.sum(t[0][..., 1:] ** 2, axis=-1)
    np.testing.assert_allclose(m2[:, 2:], np.square(masses)[None, :] + 0 * m2[:, 2:],
                               atol=1e-8 * E_CM ** 2)


@pytest.mark.parametrize("n_final", [2, 3, 4])
def test_massless_weight_is_exact_flat_volume(n_final):
    gen = FlatInvertiblePhasespace([0.0, 0.0], [0.0] * n_final)
    rv = torch.from_numpy(_latents(1, 256, gen.nDimPhaseSpace()))
    _, wgt = gen.generateKinematics_batch(E_CM, rv)
    vol = gen.get_flatWeights(E_CM, n_final)
    np.testing.assert_allclose(wgt.numpy(), vol / (2 * E_CM ** 2), rtol=1e-10)
    assert vol == JFlat.get_flatWeights(E_CM, n_final)


@pytest.mark.parametrize("cut", list(CUTS))
@pytest.mark.parametrize("masses", [[0.0] * 4, [173.0, 4.7, 0.0, 80.4]])
def test_each_cut_matches_nf_tpu(cut, masses):
    """The same events pass: the cut's 0/1 factor is equal event by event,
    and it removes some events but not all."""
    rv = _latents(2, 2048, 3 * len(masses) - 4)
    j, t = _generate(masses, rv, **CUTS[cut])
    _close_f64(j, t)
    np.testing.assert_array_equal(t[1] == 0, j[1] == 0)
    assert 0 < np.count_nonzero(t[1] == 0) < len(rv)


@pytest.mark.parametrize("tau", [True, False])
def test_pdf_modes_match_nf_tpu(tau):
    """ToyPDF convolution in tau and in direct-x mode with pdgs (2, -2), all
    cuts on.  The direct-x latents reach x < 1e-4 (weight zeroed) and the
    partonic energy below the final masses (the guard's zero weight)."""
    masses = [100.0, 200.0]
    rv = _latents(3, 2048, 3 * len(masses) - 4 + 2)
    if not tau:
        rv[:64, -2:] *= 1e-3                                 # x below 1e-4
        rv[64:128, -2:] = 0.05 + 0.03 * rv[64:128, -2:]     # sqrt(x1 x2) E < 300
    j, t = _generate(masses, rv, pdf=True, tau=tau, jit=False, pdgs=(2, -2), **CUTS["all"])
    _close_f64(j, t)
    np.testing.assert_array_equal(t[1] == 0, j[1] == 0)
    assert np.all(np.isfinite(t[0])) and np.count_nonzero(t[1] > 0) > len(rv) // 4
    if not tau:
        assert np.all(t[1][:128] == 0)


@pytest.mark.parametrize("masses", [[0.0, 0.0], [100.0, 200.0], [0.0] * 3, [50.0, 50.0, 50.0],
                                    [173.0, 4.7, 0.0, 80.4]])
def test_inverse_matches_nf_tpu_and_round_trips(masses):
    rv = _latents(4, 256, 3 * len(masses) - 4, 1e-6, 1 - 1e-6)
    jg = JFlat([0.0, 0.0], masses)
    tg = FlatInvertiblePhasespace([0.0, 0.0], masses)
    mom, _ = tg.generateKinematics_batch(E_CM, torch.from_numpy(rv))
    back = tg.invertKinematics_batch(E_CM, mom).numpy()
    back_j = np.asarray(jg.invertKinematics_batch(E_CM, jnp.asarray(mom.numpy())))
    np.testing.assert_allclose(back, back_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(back, rv, atol=1e-7)


@pytest.mark.parametrize("tau", [True, False])
def test_inverse_with_pdf_columns(tau):
    masses = [10.0, 10.0, 10.0]
    jg = JFlat([0.0, 0.0], masses, pdf_active=True, tau=tau)
    tg = FlatInvertiblePhasespace([0.0, 0.0], masses, pdf_active=True, tau=tau)
    rv = _latents(5, 128, tg.nDimPhaseSpace() + 2, 1e-3, 1 - 1e-3)
    rv[:, -2:] = 0.3 + 0.6 * rv[:, -2:]
    if tau:
        tau_min = (30.0 / E_CM) ** 2
        tau_v = tau_min + (1 - tau_min) * rv[:, -2]
        ycm = 0.5 * np.log(tau_v) * (1 - 2 * rv[:, -1])
        xb_1, xb_2 = np.sqrt(tau_v) * np.exp(ycm), np.sqrt(tau_v) * np.exp(-ycm)
    else:
        xb_1, xb_2 = rv[:, -1], rv[:, -2]
    mom, _ = tg.generateKinematics_batch(E_CM, torch.from_numpy(rv))
    back = tg.invertKinematics_batch(E_CM, mom, torch.from_numpy(xb_1),
                                     torch.from_numpy(xb_2)).numpy()
    back_j = np.asarray(jg.invertKinematics_batch(E_CM, jnp.asarray(mom.numpy()),
                                                  jnp.asarray(xb_1), jnp.asarray(xb_2)))
    np.testing.assert_allclose(back, back_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(back, rv, atol=1e-7)
    with pytest.raises(PhaseSpaceGeneratorError):
        tg.invertKinematics_batch(E_CM, mom)


def test_float32_weights_and_sanitised_events_match_nf_tpu():
    """bench.py's massive 2 -> 4 stage with its cuts: weights to 1e-5
    relative, the same events cut.  Massless 2 -> 5 with degenerate latents
    (intermediate masses at 0, at 1e-30 and 1e-7): the same events
    sanitised, and the same weights."""
    rv = _latents(6, 4096, 8)
    j, t = _generate([173.0, 4.7, 0.0, 80.4], rv, dtype=np.float32, **CUTS["all"])
    assert t[1].dtype == np.float32
    np.testing.assert_array_equal(t[1] == 0, j[1] == 0)
    np.testing.assert_allclose(t[1], j[1], rtol=1e-5, atol=0.0)

    rv = _latents(7, 4096, 11)
    rv[:8, :3] = 0.0
    rv[8:16, :3] = 1.0
    rv[16:24, 3:] = 0.0
    rv[24:32] = 1e-30
    rv[32:40, :3] = 1e-7
    j, t = _generate([0.0] * 5, rv, dtype=np.float32, jit=False)
    sanitised_t = np.all(t[0] == 0, axis=(1, 2))
    sanitised_j = np.all(j[0] == 0, axis=(1, 2))
    assert np.count_nonzero(sanitised_t) >= 16
    np.testing.assert_array_equal(sanitised_t, sanitised_j)
    assert np.all(t[1][sanitised_t] == 0) and np.all(np.isfinite(t[0]))
    np.testing.assert_allclose(t[1], j[1], rtol=1e-5, atol=0.0)
    ok = ~sanitised_t
    np.testing.assert_allclose(t[1][ok], FlatInvertiblePhasespace.get_flatWeights(E_CM, 5)
                               / (2 * E_CM ** 2) * np.ones(ok.sum()), rtol=1e-5)


def test_phase_space_integrand_is_finite_and_on_the_latents_device():
    """Every constant follows the latents: a meta-device batch goes through
    the whole generator, PDF and cuts without a host tensor being mixed
    in."""
    gen = FlatInvertiblePhasespace([0.0, 0.0], [173.0, 4.7, 0.0, 80.4], pdf=ToyPDF(),
                                   pdf_active=True, tau=True)
    rv = torch.empty((16, gen.nDimPhaseSpace() + 2), device="meta")
    mom, wgt = gen.generateKinematics_batch(E_CM, rv, pdgs=(2, -2), **CUTS["all"])
    assert mom.device.type == wgt.device.type == "meta"
    assert mom.shape == (16, 6, 4) and wgt.shape == (16,)
    back = gen.invertKinematics_batch(E_CM, mom, wgt, wgt)
    assert back.device.type == "meta" and back.shape == (16, 10)
    assert math.isfinite(gen.get_flatWeights(E_CM, 4))
