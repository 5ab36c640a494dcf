"""The collider slice as a whole: flow -> phase space -> matrix element.

In float64 on the CPU.  nf_tpu's n_flow 10 model of the 2 -> 4 double
resonance (``create_model(4, 32, [32, 32])``, tools/run_2to4.py) is carried
into the port with ``interop``; on the same latents nf_tpu's flow forward
and the port's plain (folded) forward agree, the 2 -> 4 integrand (qq ->
ZZ -> 4l at 2000 GeV: the decay-tree channel with both pairs Breit-Wigner
mapped, the tau latent power-mapped, ToyPDF, pT / deltaR / |eta| cuts)
agrees on each side, and integrand x jac agrees to 1e-10 relative.  One
trainer epoch on the Drell-Yan integrand (tests/test_physics_validation.py),
with nf_tpu's latents replayed into the port's ``_uniform``, gives nf_tpu's
loss and parameters at the tolerances of tests/test_torch_manager.py.
"""

import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf_tpu import PWQuadManager as JPWQuadManager
from nf_tpu.flows import model as jmodel
from nf_tpu.phasespace import generator as jgen
from nf_tpu.phasespace import lorentz as jl
from nf_tpu.phasespace import mappings as jmap
from nf_tpu.phasespace import pdf as jpdf
from nf_tpu.phasespace import topology as jtopo
from nf_tpu.training import optimizers as joptim
from nf_tpu_torch import PWQuadManager, interop
from nf_tpu_torch.flows.fast_eval import make_folded_forward
from nf_tpu_torch.phasespace import generator as tgen
from nf_tpu_torch.phasespace import lorentz as tl
from nf_tpu_torch.phasespace import mappings as tmap
from nf_tpu_torch.phasespace import pdf as tpdf
from nf_tpu_torch.phasespace import topology as ttopo
from nf_tpu_torch.training import optimizers as toptim

torch.set_num_threads(1)
MZ, GZ = 91.188, 2.4952
MZ2, GAM2 = MZ ** 2, MZ ** 2 * GZ ** 2


def _zz_me(lz, momenta):
    fin = momenta[:, 2:, :]
    s34 = lz.square(fin[:, 0] + fin[:, 1])
    s56 = lz.square(fin[:, 2] + fin[:, 3])
    return 1e4 / ((s34 - MZ2) ** 2 + GAM2) * 1e4 / ((s56 - MZ2) ** 2 + GAM2)


def zz_integrand(topo, gen, lz, pdf, mapping):
    """tools/run_2to4.py's mapped 2 -> 4 channel, from either package."""
    E = 2000.0
    channel = topo.ResonanceDecayPhasespace(
        [0.0, 0.0], [0.0] * 4, ((0, 1), (2, 3)),
        mass_maps={(0, 1): topo.BreitWignerSMap(MZ, GZ), (2, 3): topo.BreitWignerSMap(MZ, GZ)},
        pdf=pdf.ToyPDF(), pdf_active=True, tau=True)

    def base(w):
        momenta, wgt = channel.generateKinematics_batch(
            E, w, pT_mincut=20.0, delR_mincut=0.4, rap_maxcut=2.4, pdgs=(2, -2))
        return _zz_me(lz, momenta) * wgt

    tau_th = (2 * MZ / E) ** 2
    return mapping.remap_integrand(base, channel.nDimPhaseSpace(), functools.partial(
        mapping.shifted_power_unit_map, exponent=-3.0, shift=3 * tau_th))


def dy_integrand(gen, lz, pdf):
    """tests/test_physics_validation.py's Drell-Yan integrand."""
    E = 2000.0
    g = gen.FlatInvertiblePhasespace([0.0, 0.0], [0.0, 0.0], pdf=pdf.ToyPDF(),
                                     pdf_active=True, tau=True)

    def integrand(w):
        momenta, wgt = g.generateKinematics_batch(E, w, pT_mincut=10.0, rap_maxcut=2.4,
                                                  pdgs=(2, -2))
        shat = lz.square(momenta[:, 0, :] + momenta[:, 1, :])
        return 1e4 / ((shat - MZ2) ** 2 + GAM2) * wgt

    return integrand


_jit_forward = jax.jit(jmodel.forward, static_argnums=(0, 4))


def _carried(n_flow, seed, identity_init):
    """nf_tpu's manager after ``create_model(4, 32, [32, 32])`` and a port
    manager holding its weights."""
    NFj = JPWQuadManager(n_flow=n_flow, seed=seed, dtype=jnp.float64)
    # create_model's warm-up forward, compiled once instead of op by op
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmodel, "forward", _jit_forward)
        NFj.create_model(4, 32, [32] * 2, identity_init=identity_init)
    NF = PWQuadManager(n_flow=n_flow, seed=seed, dtype=torch.float64, device="cpu")
    NF.create_model(4, 32, [32] * 2, identity_init=identity_init)
    NF._model = interop.from_numpy(NF._flow, *jax.tree.map(np.asarray,
                                                           (NFj._params, NFj._bn_state)))
    NF.best_model = NF._model
    return NFj, NF


@pytest.mark.parametrize("identity_init", [False, True])
def test_zz_integrand_times_jac_matches_nf_tpu(identity_init):
    NFj, NF = _carried(10, 0, identity_init)
    w = np.random.default_rng(0).uniform(size=(1024, 10))
    x_j, jac_j, _ = _jit_forward(NFj._flow, NFj._params, NFj._bn_state, jnp.asarray(w), False)
    x_t, jac_t = make_folded_forward(NF._flow, NF._model, torch.float64)(torch.from_numpy(w))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(jac_t.numpy(), np.asarray(jac_j), rtol=1e-10)
    if identity_init:
        np.testing.assert_allclose(x_t.numpy(), w, atol=1e-12)

    f_j = jax.jit(zz_integrand(jtopo, jgen, jl, jpdf, jmap))
    f_t = zz_integrand(ttopo, tgen, tl, tpdf, tmap)
    # each side's integrand on the port's x: the phase space alone
    val_t = f_t(x_t)
    val_j = np.asarray(f_j(jnp.asarray(x_t.numpy())))
    np.testing.assert_allclose(val_t.numpy(), val_j, rtol=1e-10, atol=0.0)
    # the whole slice: each package's flow, then its phase space
    wf_t = (f_t(x_t) * jac_t).numpy()
    wf_j = np.asarray(f_j(x_j) * jac_j)
    np.testing.assert_allclose(wf_t, wf_j, rtol=1e-10, atol=0.0)
    assert np.count_nonzero(wf_t > 0) > 100 and np.all(np.isfinite(wf_t))


def _nf_tpu_latents(key, n_flow, mb, n_mb, epochs):
    """The latents nf_tpu's trainer draws from ``key``, in the order the
    port draws them (as tests/test_torch_manager.py replays them)."""
    out = []
    key, sub = jax.random.split(key)
    for k in jax.random.split(sub, n_flow):
        out.append(jax.random.uniform(k, (2 * mb, n_flow), jnp.float64))
    for _ in range(epochs):
        key, sub = jax.random.split(key)
        out += [jax.random.uniform(k, (mb, n_flow), jnp.float64)
                for k in jax.random.split(sub, n_mb)]
    return collections.deque(np.array(a) for a in out)


def test_drell_yan_epoch_matches_nf_tpu():
    """``_train_variance_forward_seq`` for one epoch of two minibatches with
    ``loss_mode="kl"`` (the Drell-Yan NIS configuration) from nf_tpu's
    weights and on nf_tpu's latents."""
    NFj, NF = _carried(4, 2, False)
    kw = dict(log=False, batch_size=512, epochs=1, mini_batch_size=256, preburn_time=0,
              kill_counter=100, pretty_progressbar=False, loss_mode="kl", integrate=False)
    latents = _nf_tpu_latents(NFj._key, 4, 256, 2, 1)
    NFj._train_variance_forward_seq(dy_integrand(jgen, jl, jpdf), joptim.adamax(2e-3, 1e-4),
                                    epochs_per_sync=1, **kw)

    def uniform(shape):
        w = latents.popleft()
        assert w.shape == tuple(shape)
        return torch.from_numpy(w)

    NF._uniform = uniform
    NF._train_variance_forward_seq(dy_integrand(tgen, tl, tpdf), toptim.adamax(2e-3, 1e-4),
                                   epochs_per_sync=1, **kw)
    assert not latents
    np.testing.assert_allclose(NF.history, NFj.history, rtol=1e-9)
    np.testing.assert_allclose(NF.best_loss, NFj.best_loss, rtol=1e-9)
    p_t, s_t = interop.to_numpy(NF._model)
    # atol as tests/test_torch_manager.py: a BatchNorm shift feeding a
    # batch-statistics BatchNorm has a gradient of zero up to rounding
    for a, b in zip(jax.tree.leaves((p_t, s_t)), jax.tree.leaves((NFj._params, NFj._bn_state))):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-9, atol=1e-11)
