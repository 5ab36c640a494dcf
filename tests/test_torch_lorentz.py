"""The port's Lorentz kit against nf_tpu's.

In float64 on the CPU, the same numpy-seeded 4-vectors go through each
function of ``nf_tpu.phasespace.lorentz`` and of
``nf_tpu_torch.phasespace.lorentz``; they agree to rtol 1e-12, with an
absolute floor of 1e-12 of the momentum scale where a result cancels
(Minkowski products of near-massless vectors).  The degenerate points are
held too: beta = 0 for E = 0, the ``1 - 1e-11`` clamp (which in float32
does nothing, in both packages), the largest value at degenerate
pseudorapidities and azimuths, and the lab boost's no-op at x1 = x2 = 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf_tpu.phasespace import lorentz as jl
from nf_tpu_torch.phasespace import lorentz as tl

torch.set_num_threads(1)
RTOL = 1e-12


def _vectors(seed, shape, massive=True):
    """4-vectors with |p| up to ~500 and masses up to 100 (or massless)."""
    rng = np.random.default_rng(seed)
    p = rng.normal(scale=200.0, size=shape + (3,))
    m2 = rng.uniform(0.0, 100.0, size=shape) ** 2 if massive else 0.0
    e = np.sqrt(np.sum(p * p, axis=-1) + m2)
    return np.concatenate([e[..., None], p], axis=-1)


def _both(fn_name, *arrays, **kw):
    j = getattr(jl, fn_name)(*[jnp.asarray(a) for a in arrays], **kw)
    t = getattr(tl, fn_name)(*[torch.from_numpy(a) for a in arrays], **kw)
    return j, t


def _close(t, j, rtol=RTOL, atol=0.0):
    if isinstance(j, tuple):
        for a, b in zip(t, j):
            _close(a, b, rtol, atol)
        return
    t = t.numpy() if torch.is_tensor(t) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["rho2", "square", "cos_theta", "phi", "boost_vector",
                                  "pseudo_rapidity"])
def test_unary_functions_match_nf_tpu(name):
    p = _vectors(0, (256, 3))
    j, t = _both(name, p)
    # the Minkowski square of a vector with mass m < 100 and |p| ~ 500
    # cancels: compare it at 1e-12 of E^2
    atol = 1e-12 * float(np.max(p[..., 0])) ** 2 if name == "square" else 0.0
    _close(t, j, atol=atol)


@pytest.mark.parametrize("name", ["minkowski_dot", "spatial_dot", "delta_phi", "delta_r"])
def test_binary_functions_match_nf_tpu(name):
    a, b = _vectors(1, (256,)), _vectors(2, (256,))
    j, t = _both(name, a, b)
    atol = 1e-12 * float(np.max(a[..., 0]) * np.max(b[..., 0])) if name.endswith("dot") else 0.0
    _close(t, j, atol=atol)


def test_set_square_and_uniform_distr_match_nf_tpu():
    p = _vectors(3, (128, 2))
    sq = np.random.default_rng(4).uniform(-10.0, 1e4, size=(128, 2))
    j, t = _both("set_square", p, sq)
    _close(t, j)
    # a square below -rho2 clamps the energy at 0
    j, t = _both("set_square", p, -np.sum(p[..., 1:] ** 2, axis=-1) - 1.0)
    assert np.all(t.numpy()[..., 0] == 0.0)
    _close(t, j)
    r, lo, hi = (np.random.default_rng(5).uniform(size=64) for _ in range(3))
    j, t = _both("uniform_distr", r, lo, hi + 1.0)
    _close(t, j)


def test_boost_matches_nf_tpu():
    p = _vectors(6, (256, 3))
    rng = np.random.default_rng(7)
    beta = rng.normal(size=(256, 1, 3))
    beta *= rng.uniform(0.0, 0.999, size=(256, 1, 1)) / np.linalg.norm(beta, axis=-1,
                                                                      keepdims=True)
    beta[:4] = 0.0                                       # at rest: gamma2 = 0
    j, t = _both("boost", p, beta)
    # gamma reaches ~22: components that cancel get an absolute floor
    _close(t, j, atol=1e-12 * 25 * float(np.max(p[..., 0])))
    # boosting to the rest frame gives (M, 0, 0, 0)
    rest = tl.boost(torch.from_numpy(p), -tl.boost_vector(torch.from_numpy(p)))
    m = np.sqrt(np.maximum(p[..., 0] ** 2 - np.sum(p[..., 1:] ** 2, axis=-1), 0.0))
    np.testing.assert_allclose(rest[..., 0].numpy(), m, rtol=1e-9)
    np.testing.assert_allclose(rest[..., 1:].numpy(), 0.0, atol=1e-9 * float(np.max(p[..., 0])))


def test_boost_clamp_at_beta_one():
    """|beta| = 1 clamps b2 at 1 - 1e-11 in float64 (gamma ~ 3e5, finite);
    in float32 the constant rounds to 1.0, gamma is inf and the boost gives
    non-finite values, in both packages alike."""
    p = _vectors(8, (16,))
    beta = np.zeros((16, 3))
    beta[:, 2] = 1.0
    j, t = _both("boost", p, beta)
    assert np.all(np.isfinite(t.numpy()))
    _close(t, j)
    j32 = np.asarray(jl.boost(jnp.asarray(p, jnp.float32), jnp.asarray(beta, jnp.float32)))
    t32 = tl.boost(torch.from_numpy(p).float(), torch.from_numpy(beta).float()).numpy()
    assert t32.dtype == np.float32 and not np.all(np.isfinite(t32))
    np.testing.assert_array_equal(np.isfinite(t32), np.isfinite(j32))
    np.testing.assert_array_equal(np.isnan(t32), np.isnan(j32))


def test_degenerate_points_match_nf_tpu():
    """beta = 0 at E = 0; the dtype's largest value for pseudorapidity at
    pT = pz = 0 and for delta_phi at pT = 0."""
    p = _vectors(9, (8,))
    p[0] = 0.0                                    # E = 0: beta 0
    p[1, 1:] = 0.0                                # at rest: degenerate eta
    p[2, 1:3] = 0.0                               # pT = 0: delta_phi huge
    for name in ("boost_vector", "pseudo_rapidity"):
        j, t = _both(name, p)
        _close(t, j)
    assert np.all(tl.boost_vector(torch.from_numpy(p))[0].numpy() == 0.0)
    assert tl.pseudo_rapidity(torch.from_numpy(p))[1] == np.finfo(np.float64).max
    j, t = _both("delta_phi", p, p[::-1].copy())
    _close(t, j)
    assert t[2] == np.finfo(np.float64).max
    eta32 = tl.pseudo_rapidity(torch.from_numpy(p).float())
    assert eta32[1] == np.finfo(np.float32).max


def test_boost_to_lab_frame_matches_nf_tpu():
    rng = np.random.default_rng(10)
    mom = _vectors(11, (64, 5))
    mom[:, 0] = [100.0, 0.0, 0.0, 100.0]
    mom[:, 1] = [100.0, 0.0, 0.0, -100.0]
    xb_1, xb_2 = rng.uniform(0.01, 1.0, 64), rng.uniform(0.01, 1.0, 64)
    xb_1[:5] = xb_2[:5] = 1.0                     # no-op events
    j, t = _both("boost_to_lab_frame", mom, xb_1, xb_2)
    _close(t, j, atol=1e-12 * float(np.max(mom[..., 0])))
    np.testing.assert_array_equal(t[:5].numpy(), mom[:5])
    assert not np.allclose(t[5:].numpy(), mom[5:])
