"""The port's QMC latents and ``integrate(method="qmc")`` against nf_tpu's.

On the CPU: ``make_device_sobol`` equals nf_tpu's (run by JAX on the CPU) bit
for bit, scrambled and not; the host generators and both RQMC integrators
agree with nf_tpu's on the same points; and ``integrate(method="qmc")`` of a
float64 CPU manager equals nf_tpu's CPU branch (scipy points, folded
forward) on the same weights and seed.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf_tpu import PWQuadManager as JPWQuadManager
from nf_tpu.utils import qmc as jqmc
from nf_tpu_torch import PWQuadManager, interop
from nf_tpu_torch.utils import qmc

torch.set_num_threads(1)


def camel_t(x):
    return (torch.exp(-((x[:, 0] - 0.75) ** 2 + (x[:, 1] - 0.75) ** 2) / 0.04)
            + torch.exp(-((x[:, 0] - 0.25) ** 2 + (x[:, 1] - 0.25) ** 2) / 0.04))


def camel_j(x):
    return (jnp.exp(-((x[:, 0] - 0.75) ** 2 + (x[:, 1] - 0.75) ** 2) / 0.04)
            + jnp.exp(-((x[:, 0] - 0.25) ** 2 + (x[:, 1] - 0.25) ** 2) / 0.04))


def camel_exact():
    g = 0.2 * (math.sqrt(math.pi) / 2) * (math.erf(0.25 / 0.2) + math.erf(0.75 / 0.2))
    return 2 * g * g


SEEDS = [0, 11, 2 ** 31 - 2, (7 + 0x9E3779B9 * 5) & 0xFFFFFFFF]


@pytest.mark.parametrize("scramble", [True, False])
@pytest.mark.parametrize("dim", [1, 2, 8, 36])
def test_device_sobol_bit_identical_to_nf_tpu(dim, scramble):
    gen_j = jqmc.make_device_sobol(dim, scramble=scramble)
    gen_t = qmc.make_device_sobol(dim, scramble=scramble)
    for seed in SEEDS:
        for n in (1, 1000, 2048):
            a = np.asarray(gen_j(n, np.uint32(seed)))
            b = gen_t(n, seed, "cpu")
            assert b.dtype == torch.float32 and b.shape == (n, dim)
            np.testing.assert_array_equal(b.numpy(), a)
            assert float(b.min()) > 0.0 and float(b.max()) < 1.0


def test_mul32_is_the_low_word_of_the_product():
    """_mul32 against numpy's uint32 product, at the extremes and on random
    words, for every constant the generator multiplies by."""
    rng = np.random.RandomState(0)
    x = np.concatenate([[0, 1, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF],
                        rng.randint(0, 1 << 32, size=4096, dtype=np.uint64)]).astype(np.uint32)
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6, 0x7FEB352D, 0x846CA68B,
              0xFFFFFFFF):
        got = qmc._mul32(torch.from_numpy(x.astype(np.int64)), c).numpy()
        np.testing.assert_array_equal(got, (x * np.uint32(c)).astype(np.int64))


def test_host_generators_match_nf_tpu():
    np.testing.assert_array_equal(qmc._direction_numbers(36), jqmc._direction_numbers(36))
    for dt in (np.float32, np.float64):
        a, b = qmc.sobol_latents(1000, 3, seed=5, dtype=dt), jqmc.sobol_latents(1000, 3, 5, dt)
        assert a.dtype == np.dtype(dt) and a.shape == (1024, 3)
        np.testing.assert_array_equal(a, b)
        assert a.max() < dt(1.0) and a.min() > 0.0


def _smooth_t(w):
    return torch.mean(torch.prod(1.0 + 0.5 * (2.0 * w.double() - 1.0), dim=1))


def _smooth_j(w):
    return jnp.mean(jnp.prod(1.0 + 0.5 * (2.0 * w.astype(jnp.float64) - 1.0), axis=1))


@pytest.mark.parametrize("nitn", [1, 5])
def test_rqmc_integrators_match_nf_tpu(nitn):
    """Both integrators on a smooth integrand (exact integral 1) against
    nf_tpu's, the device one on the CPU; one replication has an infinite
    error."""
    sig, err, n = qmc.rqmc_integrate_device(_smooth_t, 3, nitn, 1000, 7, "cpu")
    sig_j, err_j, n_j = jqmc.rqmc_integrate_device(_smooth_j, 3, nitn, 1000, 7)
    assert n == n_j == 1024
    np.testing.assert_allclose([sig, err], [sig_j, err_j], rtol=1e-12)
    sig, err, n = qmc.rqmc_integrate(lambda w: _smooth_t(torch.from_numpy(w)), 3, nitn, 1000, 7)
    sig_j, err_j, _ = jqmc.rqmc_integrate(_smooth_j, 3, nitn, 1000, 7)
    np.testing.assert_allclose([sig, err], [sig_j, err_j], rtol=1e-12)
    assert abs(sig - 1.0) < 1e-3 and (math.isinf(err) if nitn == 1 else err < 1e-4)


@pytest.fixture(scope="module")
def managers():
    """A float64 CPU manager of the port after a few training epochs, and
    nf_tpu's manager holding the port's best model."""
    from nf_tpu_torch.training import optimizers
    NF = PWQuadManager(n_flow=2, seed=0, dtype=torch.float64, device="cpu")
    NF.create_model(2, 4, [4] * 2)
    NF._train_variance_forward_seq(camel_t, optimizers.adamax(5e-3, 1e-4), log=False,
                                   batch_size=1000, epochs=6, preburn_time=0,
                                   mini_batch_size=1000, pretty_progressbar=False)
    NFj = JPWQuadManager(n_flow=2, seed=0, dtype=jnp.float64)
    NFj.create_model(2, 4, [4] * 2)
    NFj.best_params = jax.tree.map(jnp.asarray, interop.to_numpy(NF.best_model))
    return NF, NFj


def test_integrate_qmc_matches_nf_tpu_cpu_branch(managers):
    NF, NFj = managers
    sig, err = NF.integrate(camel_t, 4, 1000, seed=11, method="qmc")
    sig_j, err_j = NFj.integrate(camel_j, 4, 1000, seed=11, method="qmc")
    np.testing.assert_allclose([sig, err], [sig_j, err_j], rtol=1e-10)
    assert abs(sig - camel_exact()) < 8 * err + 0.01 * camel_exact()


def test_integrate_qmc_eval_mode_and_base_seed(managers):
    """QMC maps through the eval-mode map even while integrate's default
    keeps train-mode BatchNorm; without a seed, the base seed is the
    manager's next draw in [0, 2^31 - 1)."""
    NF, NFj = managers
    assert not NF.best_eval_mode
    gen = torch.Generator().manual_seed(0)
    gen.set_state(NF._gen.get_state())
    base = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen))
    sig, err = NF.integrate(camel_t, 3, 512, method="qmc")
    sig_j, err_j = NFj.integrate(camel_j, 3, 512, seed=base, method="qmc")
    np.testing.assert_allclose([sig, err], [sig_j, err_j], rtol=1e-10)
    assert torch.equal(NF._gen.get_state(), gen.get_state())
