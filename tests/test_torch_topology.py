"""The port's decay-tree channels, latent maps and multi-channel
combination against nf_tpu's.

In float64 on the CPU, on the same numpy-seeded latents: the three s-maps
(sample, density, inverse); ``ResonanceDecayPhasespace`` on the pair and
the chain topologies, with PDF and cuts (generate, ``channel_weight_ps``,
invert); ``remap_integrand``, ``chain_mass_map`` and ``drell_yan_tau_map``;
``multichannel_integrand`` with and without ``aux``; all to rtol 1e-12.
``optimize_alphas`` takes nf_tpu's draws on both sides (the port's
``_uniform`` hook replays nf_tpu's key schedule) and gives nf_tpu's alphas
and history to 1e-10.
"""

import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf_tpu.phasespace import generator as jgen
from nf_tpu.phasespace import lorentz as jl
from nf_tpu.phasespace import mappings as jmap
from nf_tpu.phasespace import pdf as jpdf
from nf_tpu.phasespace import topology as jtopo
from nf_tpu_torch.phasespace import generator as tgen
from nf_tpu_torch.phasespace import lorentz as tl
from nf_tpu_torch.phasespace import mappings as tmap
from nf_tpu_torch.phasespace import pdf as tpdf
from nf_tpu_torch.phasespace import topology as ttopo

torch.set_num_threads(1)
E = 400.0
MZ, GZ = 91.188, 2.4952
MZ2, GAM2 = MZ ** 2, MZ ** 2 * GZ ** 2
CUTS = dict(pT_mincut=5.0, delR_mincut=0.2, rap_maxcut=3.0)


def double_bw(lz, m):
    fin = m[:, 2:, :]
    s01 = lz.square(fin[:, 0] + fin[:, 1])
    s23 = lz.square(fin[:, 2] + fin[:, 3])
    return 1e4 / ((s01 - MZ2) ** 2 + GAM2) * 1e4 / ((s23 - MZ2) ** 2 + GAM2)


def _latents(seed, n, dim, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, size=(n, dim))


def _close(t, j, rtol=1e-12, atol=0.0):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _smaps(mod):
    return (mod.UniformSMap(), mod.BreitWignerSMap(MZ, GZ), mod.PowerSMap(-1.5, s_floor=1.0))


def test_s_maps_match_nf_tpu():
    u = _latents(0, 256, 1)[:, 0]
    lo = np.where(np.arange(256) % 2 == 0, 100.0, 0.25)
    hi = 9e4 * (1.0 + u[::-1])
    for mt, mj in zip(_smaps(ttopo), _smaps(jtopo)):
        args_t = [torch.from_numpy(a) for a in (u, lo, hi)]
        args_j = [jnp.asarray(a) for a in (u, lo, hi)]
        s_t, d_t = mt.sample(*args_t)
        s_j, d_j = mj.sample(*args_j)
        _close(s_t, s_j)
        _close(d_t, d_j)
        _close(mt.ds_du_at(s_t, *args_t[1:]), mj.ds_du_at(s_j, *args_j[1:]))
        back = mt.invert(s_t, *args_t[1:])
        _close(back, mj.invert(s_j, *args_j[1:]), atol=1e-13)
        np.testing.assert_allclose(back.numpy(), u, atol=1e-9, err_msg=type(mt).__name__)
    # below the power map's floor the density is zero, as in nf_tpu
    s = torch.tensor([0.5, 2.0], dtype=torch.float64)
    lo0, hi0 = torch.zeros(2, dtype=torch.float64), torch.full((2,), 10.0, dtype=torch.float64)
    assert ttopo.PowerSMap(-1.5, s_floor=1.0).ds_du_at(s, lo0, hi0)[0] == 0.0
    with pytest.raises(ValueError):
        ttopo.PowerSMap(-1.0)


TOPOLOGIES = {
    "pair_bw": (((0, 1), (2, 3)), lambda m: {(0, 1): m.BreitWignerSMap(MZ, GZ),
                                             (2, 3): m.BreitWignerSMap(MZ, GZ)}),
    "chain_power": ((0, (1, (2, 3))), lambda m: {(2, 3): m.PowerSMap(-1.5, s_floor=1.0),
                                                 (1, 2, 3): m.BreitWignerSMap(150.0, 20.0)}),
    "pair_uniform": (((0, 2), (1, 3)), lambda m: None),
}


def _channels(name, masses, pdf=False, tau=True):
    topo, maps = TOPOLOGIES[name]
    kw = dict(pdf_active=pdf, tau=tau)
    return (ttopo.ResonanceDecayPhasespace([0.0, 0.0], masses, topo, maps(ttopo),
                                           pdf=tpdf.ToyPDF() if pdf else None, **kw),
            jtopo.ResonanceDecayPhasespace([0.0, 0.0], masses, topo, maps(jtopo),
                                           pdf=jpdf.ToyPDF() if pdf else None, **kw))


@pytest.mark.parametrize("name", list(TOPOLOGIES))
@pytest.mark.parametrize("masses,pdf", [([0.0] * 4, False), ([5.0, 0.0, 10.0, 1.0], True)])
def test_tree_channel_matches_nf_tpu(name, masses, pdf):
    """generate (cuts on), channel_weight_ps at the generated point, and the
    inverse with its round trip."""
    tg, jg = _channels(name, masses, pdf)
    rv = _latents(1, 512, tg.nDimPhaseSpace() + (2 if pdf else 0), 1e-6, 1 - 1e-6)
    kw = dict(CUTS, pdgs=(2, -2))
    mom_t, w_t = tg.generateKinematics_batch(E, torch.from_numpy(rv), **kw)
    mom_j, w_j = jg.generateKinematics_batch(E, jnp.asarray(rv), **kw)
    # the ToyPDF's (1 - x)^b turns an ulp of x near 1 (from exp(ycm)) into
    # b x / (1 - x) ulps of the weight: ~1e-12 at x = 0.9994
    _close(w_t, w_j, rtol=1e-10 if pdf else 1e-12)
    _close(mom_t, mom_j, atol=1e-12 * E)
    assert 0 < int((w_t == 0).sum()) < len(rv)
    # the uncut momenta: the channel density and the inverse
    mom_t, _ = tg.generateKinematics_batch(E, torch.from_numpy(rv))
    _close(tg.channel_weight_ps(mom_t), jg.channel_weight_ps(jnp.asarray(mom_t.numpy())))
    if pdf:
        tau_min = (max(sum(masses), 1.0) / E) ** 2
        tau = tau_min + (1 - tau_min) * rv[:, -2]
        ycm = 0.5 * np.log(tau) * (1 - 2 * rv[:, -1])
        xb = [torch.from_numpy(np.sqrt(tau) * np.exp(s * ycm)) for s in (1, -1)]
    else:
        xb = [None, None]
    back = tg.invertKinematics_batch(E, mom_t, *xb)
    back_j = jg.invertKinematics_batch(E, jnp.asarray(mom_t.numpy()),
                                       *[None if x is None else jnp.asarray(x.numpy())
                                         for x in xb])
    _close(back, back_j, atol=1e-12)
    np.testing.assert_allclose(back.numpy(), rv, atol=1e-6)


def test_flat_volume_of_the_tree_channel():
    tg, _ = _channels("pair_uniform", [0.0] * 4)
    rv = torch.from_numpy(_latents(2, 256, tg.nDimPhaseSpace()))
    _, w = tg.generateKinematics_batch(E, rv)
    vol = tgen.FlatInvertiblePhasespace.get_flatWeights(E, 4)
    # uniform pair masses: the weight varies, its mean is the volume
    assert abs(float(w.mean()) * 2 * E ** 2 / vol - 1.0) < 0.2


def test_topology_validation():
    with pytest.raises(tgen.PhaseSpaceGeneratorError):
        ttopo.ResonanceDecayPhasespace([0.0, 0.0], [0.0] * 4, ((0, 1), (2, 2)))
    with pytest.raises(tgen.PhaseSpaceGeneratorError):
        ttopo.ResonanceDecayPhasespace([0.0], [0.0] * 4, ((0, 1), (2, 3)))
    with pytest.raises(tgen.PhaseSpaceGeneratorError):
        ttopo.ResonanceDecayPhasespace([0.0, 0.0], [0.0] * 4, ((0, 1), (2, 3)),
                                       mass_maps={(1, 2): ttopo.UniformSMap()})
    with pytest.raises(tgen.PhaseSpaceGeneratorError):
        ttopo.ResonanceDecayPhasespace([0.0, 0.0], [0.0] * 3, (0, 1, 2))
    with pytest.raises(ValueError):
        tmap.chain_mass_map(tgen.FlatInvertiblePhasespace([0.0, 0.0], [0.0] * 2), E,
                            ttopo.BreitWignerSMap(MZ, GZ))
    with pytest.raises(ValueError):
        tmap.chain_mass_map(tgen.FlatInvertiblePhasespace([0.0, 0.0], [0.0] * 4), E,
                            ttopo.BreitWignerSMap(MZ, GZ), mass_index=3)


def test_unit_maps_match_nf_tpu():
    u = _latents(3, 256, 1)[:, 0]
    for name, args in (("breit_wigner_unit_map", (MZ, GZ, 100.0, E ** 2)),
                       ("power_law_unit_map", (-2.5, 10.0, 1e4)),
                       ("shifted_power_unit_map", (-3.0, 0.02))):
        v_t, d_t = getattr(tmap, name)(torch.from_numpy(u), *args)
        v_j, d_j = getattr(jmap, name)(jnp.asarray(u), *args)
        _close(v_t, v_j, atol=1e-15)
        _close(d_t, d_j)
    v_t, d_t = tmap.drell_yan_tau_map(MZ, GZ, E)(torch.from_numpy(u))
    v_j, d_j = jmap.drell_yan_tau_map(MZ, GZ, E)(jnp.asarray(u))
    _close(v_t, v_j, atol=1e-15)
    _close(d_t, d_j)


def _flat_integrand(lz, gen, me):
    def f(w):
        mom, wgt = gen.generateKinematics_batch(E, w, pdgs=(2, -2))
        return me(lz, mom) * wgt
    return f


def _two_pair_me(lz, mom):
    fin = mom[:, 2:, :]
    s = lz.square(fin[:, -1] + fin[:, -2])
    return 1e4 / ((s - MZ2) ** 2 + GAM2)


def test_remap_integrand_matches_nf_tpu_and_leaves_w_alone():
    gens = [m.FlatInvertiblePhasespace([0.0, 0.0], [0.0] * 2, pdf=p.ToyPDF(), pdf_active=True)
            for m, p in ((tgen, tpdf), (jgen, jpdf))]
    unit = [functools.partial(m.shifted_power_unit_map, exponent=-3.0, shift=0.01)
            for m in (tmap, jmap)]
    g_t = tmap.remap_integrand(_flat_integrand(tl, gens[0], _two_pair_me), 2, unit[0])
    g_j = jmap.remap_integrand(_flat_integrand(jl, gens[1], _two_pair_me), 2, unit[1])
    w = torch.from_numpy(_latents(4, 512, 4))
    w_before = w.clone()
    _close(g_t(w), g_j(jnp.asarray(w.numpy())))
    assert torch.equal(w, w_before)


@pytest.mark.parametrize("mass_index,pdf,tau", [(2, False, True), (1, True, True),
                                                (2, True, False)])
def test_chain_mass_map_matches_nf_tpu(mass_index, pdf, tau):
    masses = [0.0, 5.0, 0.0, 0.0]
    gens = [m.FlatInvertiblePhasespace([0.0, 0.0], masses, pdf=p.ToyPDF() if pdf else None,
                                       pdf_active=pdf, tau=tau)
            for m, p in ((tgen, tpdf), (jgen, jpdf))]
    g_t = tmap.chain_mass_map(gens[0], E, ttopo.BreitWignerSMap(MZ, GZ), mass_index)(
        _flat_integrand(tl, gens[0], _two_pair_me))
    g_j = jmap.chain_mass_map(gens[1], E, jtopo.BreitWignerSMap(MZ, GZ), mass_index)(
        _flat_integrand(jl, gens[1], _two_pair_me))
    w = torch.from_numpy(_latents(5, 512, 8 + (2 if pdf else 0), 1e-4, 1 - 1e-4))
    w_before = w.clone()
    got = g_t(w)
    _close(got, g_j(jnp.asarray(w.numpy())))
    assert torch.equal(w, w_before) and bool((got > 0).any())


def _mc_channels(mod):
    return [mod.ResonanceDecayPhasespace(
                [0.0, 0.0], [0.0] * 4, ((0, 1), (2, 3)),
                mass_maps={(0, 1): mod.BreitWignerSMap(MZ, GZ),
                           (2, 3): mod.BreitWignerSMap(MZ, GZ)}),
            mod.ResonanceDecayPhasespace(
                [0.0, 0.0], [0.0] * 4, ((0, 2), (1, 3)),
                mass_maps={(0, 2): mod.BreitWignerSMap(MZ, GZ),
                           (1, 3): mod.BreitWignerSMap(MZ, GZ)})]


@pytest.mark.parametrize("aux", [False, True])
def test_multichannel_integrand_matches_nf_tpu(aux):
    g_t = ttopo.multichannel_integrand(functools.partial(double_bw, tl), _mc_channels(ttopo),
                                       [0.3, 0.7], E, aux=aux, **CUTS)
    g_j = jtopo.multichannel_integrand(functools.partial(double_bw, jl), _mc_channels(jtopo),
                                       [0.3, 0.7], E, aux=aux, **CUTS)
    w = _latents(6, 1024, 9)
    # nf_tpu op by op, as the port computes: compiled, XLA's fusions round
    # otherwise in the last ~1e-12
    out_t, out_j = g_t(torch.from_numpy(w)), g_j(jnp.asarray(w))
    if aux:
        (out_t, ax_t), (out_j, ax_j) = out_t, out_j
        assert ax_t["sel"].dtype == torch.int32
        np.testing.assert_array_equal(ax_t["sel"].numpy(), np.asarray(ax_j["sel"]))
        _close(ax_t["r"], ax_j["r"])
        assert set(np.unique(ax_t["sel"].numpy())) == {0, 1}
    _close(out_t, out_j)
    assert 0 < int((out_t == 0).sum()) < len(w)
    with pytest.raises(ValueError):
        ttopo.multichannel_integrand(double_bw, _mc_channels(ttopo), [1.0, -1.0], E)


def test_optimize_alphas_matches_nf_tpu_on_its_draws(monkeypatch):
    """nf_tpu's draws from key 3 (split per iteration, float64 uniforms) are
    replayed through the port's ``_uniform``; alphas and history agree."""
    key = jax.random.PRNGKey(3)
    n_iter, n = 3, 1 << 12
    draws, k = collections.deque(), key
    for _ in range(n_iter):
        k, sub = jax.random.split(k)
        draws.append(np.array(jax.random.uniform(sub, (n, 9))))
    assert draws[0].dtype == np.float64

    def replay(generator, n_samples, dim):
        w = draws.popleft()
        assert w.shape == (n_samples, dim) and generator.device.type == "cpu"
        return torch.from_numpy(w)

    monkeypatch.setattr(ttopo, "_uniform", replay)
    a_t, h_t = ttopo.optimize_alphas(functools.partial(double_bw, tl), _mc_channels(ttopo),
                                     [0.15, 0.85], E, torch.Generator().manual_seed(0),
                                     n_iter=n_iter, n_samples=n)
    a_j, h_j = jtopo.optimize_alphas(functools.partial(double_bw, jl), _mc_channels(jtopo),
                                     [0.15, 0.85], E, key, n_iter=n_iter, n_samples=n)
    assert not draws and len(h_t) == len(h_j) == n_iter
    np.testing.assert_allclose(a_t, a_j, rtol=1e-10)
    for ht, hj in zip(h_t, h_j):
        for name in ("alphas", "variance", "integral", "W_i"):
            np.testing.assert_allclose(ht[name], hj[name], rtol=1e-10, err_msg=name)
    assert a_t[0] > 0.5 > 0.15


def test_optimize_alphas_draws_on_the_generator():
    """Without the hook replaced, the draws come from the generator: two
    runs from one seed agree, another seed differs."""
    def run(seed):
        return ttopo.optimize_alphas(functools.partial(double_bw, tl), _mc_channels(ttopo),
                                     [0.5, 0.5], E, torch.Generator().manual_seed(seed),
                                     n_iter=1, n_samples=256)[1][0]["integral"]
    assert run(1) == run(1) != run(2)
