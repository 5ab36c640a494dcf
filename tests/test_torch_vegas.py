"""The port's VEGAS baseline against nf_tpu's, on nf_tpu's draws.

nf_tpu's uniform draws (its key chain, vegas.py:31-33) are replayed through
the port's ``vegas._uniform`` hook, in float64 on the CPU: the grid edges
after every iteration and the combined ``(mean, sdev)`` agree at rtol 1e-10.
Then nf_tpu's two property tests (tests/test_vegas_experiment.py:27-48) on
the port's own draws.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf_tpu.training.vegas import VegasIntegrator as JVegas
from nf_tpu_torch.training import vegas
from nf_tpu_torch.training.vegas import VegasIntegrator

torch.set_num_threads(1)


def gauss2_j(x):
    return jnp.exp(-jnp.sum((x - 0.5) ** 2, axis=-1) / 0.02)


def gauss2(x):
    return torch.exp(-torch.sum((x - 0.5) ** 2, dim=-1) / 0.02)


def gauss2_exact():
    a = 0.02
    per_dim = math.sqrt(a * math.pi) * math.erf(0.5 / math.sqrt(a))
    return per_dim ** 2


def _replay(monkeypatch, seed, n, shape):
    """Serve nf_tpu's first ``n`` draws of ``shape`` for ``seed``."""
    key, draws = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        draws.append(np.array(jax.random.uniform(sub, shape, jnp.float64)))
    it = iter(draws)

    def uniform(generator, shape_, dtype, device):
        w = next(it)
        assert w.shape == tuple(shape_) and dtype == torch.float64
        return torch.from_numpy(w)
    monkeypatch.setattr(vegas, "_uniform", uniform)


@pytest.mark.parametrize("n_dim,n_bins", [(2, 20), (3, 7)])
def test_edges_match_nf_tpu_after_every_iteration(monkeypatch, n_dim, n_bins):
    _replay(monkeypatch, 3, 6, (3000, n_dim))
    mine = VegasIntegrator(n_dim, n_bins=n_bins, seed=3, dtype=torch.float64, device="cpu")
    ref = JVegas(n_dim, n_bins=n_bins, seed=3, dtype=jnp.float64)
    np.testing.assert_allclose(mine.edges.numpy(), np.asarray(ref.edges), rtol=1e-10)
    for _ in range(6):
        got = mine.run(gauss2, nitn=1, neval=3000)
        want = ref.run(gauss2_j, nitn=1, neval=3000)
        np.testing.assert_allclose(mine.edges.numpy(), np.asarray(ref.edges), rtol=1e-10)
        np.testing.assert_allclose(got, want, rtol=1e-10)


def test_run_matches_nf_tpu(monkeypatch):
    _replay(monkeypatch, 5, 9, (4000, 2))
    mine = VegasIntegrator(2, n_bins=30, seed=5, dtype=torch.float64, device="cpu")
    got = mine.run(gauss2, nitn=8, neval=4000)
    want = JVegas(2, n_bins=30, seed=5, dtype=jnp.float64).run(gauss2_j, nitn=8, neval=4000)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    # the adapted map on other points
    x, jac = mine.sample(4000)
    ref = JVegas(2, n_bins=30, seed=5, dtype=jnp.float64)
    ref.edges = jnp.asarray(mine.edges.numpy())
    y = torch.from_numpy(np.random.RandomState(0).uniform(size=(64, 2)))
    x_j, jac_j, _ = ref._map(ref.edges, jnp.asarray(y.numpy()))
    x_t, jac_t, _ = mine._map(mine.edges, y)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-12)
    np.testing.assert_allclose(jac_t.numpy(), np.asarray(jac_j), rtol=1e-12)
    assert x.shape == (4000, 2) and jac.shape == (4000,)


def test_vegas_converges_on_gaussian():
    integ = VegasIntegrator(2, n_bins=40, seed=0, device="cpu")
    mean, sdev = integ.run(gauss2, nitn=12, neval=8000)
    exact = gauss2_exact()
    assert abs(mean - exact) < max(5 * sdev, 0.02 * exact)
    # the adapted map concentrates samples: the importance-weighted variance
    # beats uniform sampling's
    x, jac = integ.sample(20000)
    fw = (gauss2(x) * jac).numpy()
    u = torch.rand((20000, 2), generator=torch.Generator().manual_seed(1))
    assert fw.var() < gauss2(u).numpy().var()


def test_vegas_map_jacobian_is_unit_mean():
    integ = VegasIntegrator(3, n_bins=20, seed=1, device="cpu")
    integ.run(lambda x: torch.ones(x.shape[0]), nitn=3, neval=2000)
    x, jac = integ.sample(50000)
    assert bool(((x >= 0) & (x <= 1)).all())
    np.testing.assert_allclose(float(jac.mean()), 1.0, rtol=0.05)


def test_defaults():
    integ = VegasIntegrator(2, device="cpu")
    assert integ.dtype == torch.float32 and integ.edges.shape == (2, 51)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            VegasIntegrator(2)
