"""The port's learned multi-channel mixture against nf_tpu's.

In float64 on the CPU, with nf_tpu's per-channel flows (random final
layers and BatchNorm statistics) carried into the port by
``interop.channel_models_from_numpy``, on the two competing-pairing channels
of tests/test_multichannel.py at 400 GeV.  nf_tpu's draws are replayed
through the port's ``multichannel._uniform`` and ``_seed`` hooks in nf_tpu's
key schedule:

  * ``mixture_weights`` (``w``, ``r``, ``q``, ``f``, momenta, xb; with and
    without ``only_channel``) to rtol 1e-10;
  * the gradients of the var, secmom and kl losses with respect to every
    channel's parameters against ``jax.grad``, rtol 1e-8, all finite;
  * three epochs of ``train_multichannel`` (learned alphas and two
    minibatches; fixed alphas): parameters, alphas, best snapshot and
    history to rtol 1e-7;
  * ``combine_stratified`` on the same weights;
  * ``multichannel_unweight`` with ``compact=False``, global, per-channel
    and partial: the same accepted rows, maxima, efficiency and overweight
    count; then ``compact=True`` (accepted and ignored) against
    ``compact=False``;
  * the per-channel knapsack's share floor on pilots spanning 40 decades,
    and partial per-channel samples against the stratified cross section
    on and off the Z.
"""

import collections
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf_tpu.phasespace import lorentz as jl
from nf_tpu.phasespace import topology as jtopo
from nf_tpu.training import multichannel as jmc
from nf_tpu.training import optimizers as jopt
from nf_tpu_torch import interop
from nf_tpu_torch.phasespace import lorentz as tl
from nf_tpu_torch.phasespace import topology as ttopo
from nf_tpu_torch.training import multichannel as mc
from nf_tpu_torch.training import optimizers
from test_torch_parallel import world_of_one  # noqa: F401 (fixture)

torch.set_num_threads(1)
E = 400.0
MZ, GZ = 91.188, 2.4952
MZP, GZP = 180.0, 8.0
ALPHAS = np.array([0.4, 0.6])
B = 64
N_LAT = 8
CUTS = dict(pT_mincut=5.0, delR_mincut=0.2, rap_maxcut=3.0)


def me(lz, m):
    """Resonant in the (01)(23) Z pairing and the (02)(13) Z' pairing."""
    f = m[:, 2:, :]

    def bw(i, j, mass, width):
        s = lz.square(f[:, i] + f[:, j])
        return 1e4 / ((s - mass ** 2) ** 2 + (mass * width) ** 2)

    return (bw(0, 1, MZ, GZ) * bw(2, 3, MZ, GZ)
            + 300.0 * bw(0, 2, MZP, GZP) * bw(1, 3, MZP, GZP))


me_t, me_j = functools.partial(me, tl), functools.partial(me, jl)


def _channels(mod):
    return [mod.ResonanceDecayPhasespace(
                [0.0, 0.0], [0.0] * 4, ((0, 1), (2, 3)),
                mass_maps={(0, 1): mod.BreitWignerSMap(MZ, GZ),
                           (2, 3): mod.BreitWignerSMap(MZ, GZ)}),
            mod.ResonanceDecayPhasespace(
                [0.0, 0.0], [0.0] * 4, ((0, 2), (1, 3)),
                mass_maps={(0, 2): mod.BreitWignerSMap(MZP, GZP),
                           (1, 3): mod.BreitWignerSMap(MZP, GZP)})]


CH_T, CH_J = _channels(ttopo), _channels(jtopo)


@pytest.fixture(scope="module")
def flows():
    """nf_tpu's channel flows with every leaf moved off its initial value
    (the final layers off zero, BatchNorm statistics off (0, 1)), as numpy
    trees, and the port's models holding them."""
    fl, ps, ss = jmc.build_channel_flows(jax.random.PRNGKey(0), CH_J, 2, 4, [8])
    rng = np.random.default_rng(0)
    ps = jax.tree.map(lambda a: np.asarray(a) + 0.2 * rng.standard_normal(a.shape), ps)

    def perturb(path, a):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, a.shape)
        return np.asarray(a) + 0.1 * rng.standard_normal(a.shape)

    ss = jax.tree_util.tree_map_with_path(perturb, ss)
    return fl, ps, ss


def _models(flows):
    return interop.channel_models_from_numpy(*flows)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _uniform_j(key, shape):
    return np.asarray(jax.random.uniform(key, shape, jnp.float64))


class Replay:
    """nf_tpu's draws, in its key schedule, for the port's hooks."""

    def __init__(self, monkeypatch, draws=(), key=None):
        self.draws = collections.deque(draws)
        self.key = key
        monkeypatch.setattr(mc, "_uniform", self.uniform)

    def uniform(self, generator, shape, dtype, device):
        a = self.draws.popleft()
        assert tuple(shape) == a.shape and dtype == torch.float64, (shape, a.shape)
        return torch.from_numpy(np.array(a))


def _mixture_draws(key, n, sources):
    return [_uniform_j(jax.random.fold_in(key, k), (n, N_LAT)) for k in sources]


def _close(t, j, rtol=1e-10, atol=0.0):
    np.testing.assert_allclose(np.asarray(t.detach() if torch.is_tensor(t) else t),
                               np.asarray(j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("only_channel", [None, 0, 1])
def test_mixture_weights_match_nf_tpu(flows, monkeypatch, only_channel):
    key = jax.random.PRNGKey(11)
    sources = [0, 1] if only_channel is None else [only_channel]
    replay = Replay(monkeypatch, _mixture_draws(key, B, sources))
    w_t, aux_t = mc.mixture_weights(CH_T, _models(flows), me_t, E, torch.Generator(), B,
                                    ALPHAS, with_kinematics=True, only_channel=only_channel,
                                    **CUTS)
    assert not replay.draws
    w_j, aux_j = jmc.mixture_weights(CH_J, flows[0], _j(flows[1]), _j(flows[2]), me_j, E, key,
                                     B, jnp.asarray(ALPHAS), with_kinematics=True,
                                     only_channel=only_channel, **CUTS)
    _close(w_t, w_j)
    for name in ("r", "q", "f", "xb"):
        _close(aux_t[name], aux_j[name])
    _close(aux_t["momenta"], aux_j["momenta"], atol=1e-12 * E)
    assert w_t.shape == (len(sources), B) and bool((w_t > 0).any())
    if only_channel is None:     # the cuts
        assert 0 < int((w_t == 0).sum()) < w_t.numel()


def _nf_loss(mode, w, aux, w_scale, alphas):
    """nf_tpu's loss (nf_tpu/training/multichannel.py:388-405)."""
    wn = w / w_scale
    m1 = jnp.mean(wn, axis=1)
    m2 = jnp.mean(wn ** 2, axis=1)
    if mode == "var":
        return jnp.sum(alphas * (m2 - m1 ** 2))
    if mode == "kl":
        logq = jnp.log(jnp.maximum(aux["q"], 1e-300))
        return -jnp.sum(alphas * jnp.mean(jax.lax.stop_gradient(wn) * logq, axis=1))
    return jnp.sum(alphas * m2)


MODES = ("var", "secmom", "kl")


@pytest.fixture(scope="module")
def jflows(flows):
    """``flows`` with jax leaves, one tree for the module: nf_tpu's
    unweighter caches its compiled batches by the leaves' identity."""
    return flows[0], _j(flows[1]), _j(flows[2])


@pytest.fixture(scope="module")
def nf_grads(jflows):
    """nf_tpu's three losses at one draw and their Jacobian (one compile)."""
    key = jax.random.PRNGKey(21)
    fl, ps, ss = jflows
    alphas = jnp.asarray(ALPHAS)
    w0, _ = jmc.mixture_weights(CH_J, fl, ps, ss, me_j, E, key, B, alphas, **CUTS)
    w_scale = float(jnp.max(w0))

    def losses(p):
        w, aux = jmc.mixture_weights(CH_J, fl, p, ss, me_j, E, key, B, alphas, **CUTS)
        vals = jnp.stack([_nf_loss(m, w, aux, w_scale, alphas) for m in MODES])
        return vals, vals

    jac, vals = jax.jit(jax.jacrev(losses, has_aux=True))(ps)
    return key, w_scale, {m: (vals[i], jax.tree.map(lambda a, i=i: a[i], jac))
                          for i, m in enumerate(MODES)}


def _grad_tree(model):
    """The gradients of ``model`` in nf_tpu's params layout."""
    def g(t):
        return t.grad.numpy()

    return tuple({"bn_in": {"scale": g(c.bn_in.scale), "bias": g(c.bn_in.bias)},
                  "linears": [{k: g(v) for k, v in lin.items()} for lin in c.linears],
                  "bns": [{"scale": g(bn.scale), "bias": g(bn.bias)} for bn in c.bns],
                  "final": {k: g(v) for k, v in c.final.items()}} for c in model.cells)


@pytest.mark.parametrize("mode", MODES)
def test_loss_gradients_match_jax_grad(flows, nf_grads, monkeypatch, mode):
    """The gradients through every channel's inverse density rho_m."""
    key, w_scale, ref = nf_grads
    Replay(monkeypatch, _mixture_draws(key, B, [0, 1]))
    models = _models(flows)
    w, aux = mc.mixture_weights(CH_T, models, me_t, E, torch.Generator(), B, ALPHAS, **CUTS)
    loss = mc._loss(mode, w, aux, torch.tensor(w_scale, dtype=torch.float64),
                    torch.from_numpy(ALPHAS))
    loss.backward()
    loss_j, grads_j = ref[mode]
    _close(loss, loss_j, rtol=1e-10)
    flat_t = jax.tree.leaves(tuple(_grad_tree(m) for m in models))
    flat_j = jax.tree.leaves(grads_j)
    assert len(flat_t) == len(flat_j) > 0
    for a, b in zip(flat_t, flat_j):
        assert np.all(np.isfinite(a))
        scale = max(float(np.abs(b).max()), 1e-300)
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-8, atol=1e-12 * scale)
    assert any(float(np.abs(a).max()) > 0 for a in flat_t)


def _train_draws(key, epochs, n_mb, mb):
    draws = _mixture_draws(jax.random.fold_in(key, 0xA11CE), mb, [0, 1])
    for ek in jax.random.split(key, epochs):
        for mkey in jax.random.split(ek, n_mb):
            draws += _mixture_draws(mkey, mb, [0, 1])
    return draws


@pytest.mark.parametrize("learn_alphas,n_mb,loss_mode", [(True, 2, "kl"), (False, 1, "var")])
def test_train_multichannel_matches_nf_tpu(flows, monkeypatch, learn_alphas, n_mb, loss_mode):
    key = jax.random.PRNGKey(3)
    kw = dict(alphas=list(ALPHAS), batch_per_channel=B, mini_batch_per_channel=B // n_mb,
              epochs=3, loss_mode=loss_mode, learn_alphas=learn_alphas, alpha_damping=1.0,
              **CUTS)
    replay = Replay(monkeypatch, _train_draws(key, 3, n_mb, B // n_mb))
    models = _models(flows)
    before = [{k: v.clone() for k, v in m.state_dict().items()} for m in models]
    out_t = mc.train_multichannel(CH_T, models, me_t, E, optimizers.adamax(5e-3, 1e-4),
                                  torch.Generator(), **kw)
    assert not replay.draws
    out_j = jmc.train_multichannel(CH_J, flows[0], _j(flows[1]), _j(flows[2]), me_j, E,
                                   jopt.adamax(5e-3, 1e-4), key, **kw)
    # the caller's models are left as they were
    for m, sd in zip(models, before):
        assert all(torch.equal(v, sd[k]) for k, v in m.state_dict().items())
    for name in ("params", "best_params"):
        got = [interop.to_numpy(m) for m in out_t[name]]
        for a, b in zip(jax.tree.leaves([g[0] for g in got]), jax.tree.leaves(out_j[name])):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-7, atol=1e-12)
        # BatchNorm statistics never move
        for g, s in zip(got, flows[2]):
            for a, b in zip(jax.tree.leaves(g[1]), jax.tree.leaves(s)):
                np.testing.assert_array_equal(a, b)
    for name in ("alphas", "best_alphas"):
        np.testing.assert_allclose(out_t[name], out_j[name], rtol=1e-7)
    assert out_t["best_ess"] == pytest.approx(out_j["best_ess"], rel=1e-7)
    for name in ("loss", "integral", "ess", "alphas"):
        np.testing.assert_allclose(out_t["history"][name], out_j["history"][name], rtol=1e-7,
                                   err_msg=name)
    assert np.all(np.isfinite(out_t["history"]["loss"]))
    if learn_alphas:
        assert not np.allclose(out_t["alphas"], ALPHAS)
    else:
        np.testing.assert_allclose(out_t["history"]["alphas"], np.tile(ALPHAS, (3, 1)))


def test_combine_stratified_matches_nf_tpu():
    w = np.random.default_rng(2).exponential(size=(2, 1000)) * [[1.0], [3.0]]
    got = mc.combine_stratified(torch.from_numpy(w), ALPHAS)
    ref = jmc.combine_stratified(jnp.asarray(w), jnp.asarray(ALPHAS))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-15)


class UnweightReplay(Replay):
    """nf_tpu's unweighting key schedule, drawn on demand: ``mode`` is
    "global" (per batch: latents of every channel, then [C, B] uniforms),
    "iid" (per-channel pilots, the host seed, then one channel a batch) or
    "rounds" (pilots, seed, then every channel a round)."""

    def __init__(self, monkeypatch, key, mode):
        super().__init__(monkeypatch, key=key)
        self.mode, self.k, self.pending = mode, None, collections.deque()
        self.n_pilots = 0 if mode == "global" else 2
        self.subs = None
        monkeypatch.setattr(mc, "_seed", self.seed)
        real = mc.mixture_weights

        def record(*args, only_channel=None, **kw):
            self.k = only_channel
            return real(*args, only_channel=only_channel, **kw)

        monkeypatch.setattr(mc, "mixture_weights", record)

    def _split(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def seed(self, generator):
        return int(jax.random.randint(self._split(), (), 0, np.iinfo(np.int32).max))

    def uniform(self, generator, shape, dtype, device):
        if not self.pending:
            if self.mode == "global":
                k_w, k_u = jax.random.split(self._split())
                self.pending += _mixture_draws(k_w, B, [0, 1])
                self.pending.append(_uniform_j(k_u, (2, B)))
            else:
                if self.mode == "iid" or self.n_pilots:
                    sub = self._split()
                    self.n_pilots = max(self.n_pilots - 1, 0)
                else:
                    if self.k == 0:
                        self.subs = jax.random.split(self._split(), 2)
                    sub = self.subs[self.k]
                k_w, k_u = jax.random.split(sub)
                self.pending += _mixture_draws(k_w, B, [self.k])
                self.pending.append(_uniform_j(k_u, (B,)))
        self.draws.append(self.pending.popleft())
        return super().uniform(generator, shape, dtype, device)


def _rows(events, xb, wts=None):
    ev = np.asarray(events).reshape(len(events), -1)
    order = np.lexsort(ev.T[::-1])
    return [ev[order], np.asarray(xb)[order]] + ([] if wts is None else [np.asarray(wts)[order]])


UNWEIGHT = {"global": dict(), "per_channel": dict(per_channel_max=True),
            "global_partial": dict(partial_unweight=True),
            "per_channel_partial": dict(per_channel_max=True, partial_unweight=True)}


@pytest.mark.parametrize("case", list(UNWEIGHT))
def test_multichannel_unweight_matches_nf_tpu(flows, jflows, monkeypatch, case):
    opts = dict(UNWEIGHT[case], n_events=150, batch_per_channel=B, wmax_quantile=0.99,
                compact=False, **CUTS)
    key = jax.random.PRNGKey(5)
    mode = ("rounds" if "partial" in case else "iid") if "per_channel" in case else "global"
    UnweightReplay(monkeypatch, key, mode)
    got = mc.multichannel_unweight(CH_T, _models(flows), me_t, E, torch.Generator(), ALPHAS,
                                   **opts)
    ref = jmc.multichannel_unweight(CH_J, *jflows, me_j, E, key, jnp.asarray(ALPHAS), **opts)
    assert len(got[0]) == len(ref[0]) >= 150
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-10, atol=1e-12 * E)
    np.testing.assert_allclose(got[1], np.asarray(ref[1]), rtol=1e-10)
    if "partial" in case:
        np.testing.assert_allclose(got[2], ref[2], rtol=1e-10)
        assert set(got[3]) == set(ref[3])
        np.testing.assert_allclose(got[3]["w_max"], ref[3]["w_max"], rtol=1e-10)
        np.testing.assert_allclose(got[3]["eff"], ref[3]["eff"], rtol=1e-10)
        assert got[3]["accept_rate"] == ref[3]["accept_rate"]
        assert got[3]["n_overweight"] == ref[3]["n_overweight"] > 0
    else:
        np.testing.assert_allclose(got[2], ref[2], rtol=1e-10)
        assert got[3] == ref[3]


@pytest.mark.parametrize("case", list(UNWEIGHT))
def test_compact_matches_host_loop(flows, case):
    """``compact`` and ``batches_per_call`` are nf_tpu's arguments, accepted
    and ignored: compact=True and compact=False from one seed give the same
    accepted set and bookkeeping."""
    opts = dict(UNWEIGHT[case], n_events=10 ** 9, max_batches=4, batch_per_channel=B,
                wmax_quantile=0.99)
    runs = [mc.multichannel_unweight(CH_T, _models(flows), me_t, E,
                                     torch.Generator().manual_seed(8), ALPHAS, compact=c,
                                     batches_per_call=2, **opts) for c in (False, True)]
    partial = "partial" in case
    for a, b in zip(_rows(*runs[0][:2 + partial]), _rows(*runs[1][:2 + partial])):
        np.testing.assert_array_equal(a, b)
    assert len(runs[0][0]) > 0
    if partial:
        for name in ("eff", "accept_rate", "n_overweight"):
            assert runs[0][3][name] == pytest.approx(runs[1][3][name], rel=1e-12)
    else:
        assert runs[0][2] == pytest.approx(runs[1][2], rel=1e-12)
        assert runs[0][3] == runs[1][3]


def _on_z(momenta):
    """1 where the (01) pair of the final state sits on the Z, else 0."""
    s01 = tl.square(torch.as_tensor(momenta[..., 2, :] + momenta[..., 3, :]))
    return (torch.abs(torch.sqrt(torch.clamp_min(s01, 0.0)) - MZ) < 5 * GZ).double()


def _partial_sigma(wts, info, alphas, part):
    """sigma and its error from a partial per-channel sample: each round
    proposes B per live channel, and channel k's accepted weights sum to
    alpha_k E_k[w] / R per proposal in expectation (R = max_k alpha_k
    w_max_k), so sigma = R L sum(weights) / n_proposals."""
    rate = np.asarray(alphas) * info["w_max"]
    n_prop = round(len(wts) / info["accept_rate"])
    y = wts * part
    scale = rate.max() * np.count_nonzero(rate) / n_prop
    return scale * y.sum(), scale * np.sqrt(max((y ** 2).sum() - y.sum() ** 2 / n_prop, 0.0))


@pytest.fixture(scope="module")
def stratified(flows):
    """sigma on and off the Z from a stratified sample of 2^14 per channel."""
    w, aux = mc.multichannel_sample(CH_T, _models(flows), me_t, E,
                                    torch.Generator().manual_seed(1), 1 << 14, ALPHAS,
                                    with_kinematics=True, **CUTS)
    z = _on_z(aux["momenta"])
    return [tuple(float(v) for v in mc.combine_stratified(w * part, ALPHAS)[:2])
            for part in (z, 1 - z)]


@pytest.mark.parametrize("quantile", [0.9, 0.5])
def test_partial_sample_carries_every_channel(flows, stratified, monkeypatch, quantile):
    """Partial per-channel unweighting at loose quantiles: the weighted
    sample's cross section on and off the Z holds against the stratified
    sample's within 5 combined sigma.  At quantile 0.5 without the
    knapsack's share floor (nf_tpu's greedy) channel 1 is cut out of the
    schedule and the sample misses most of the cross section."""
    def run():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            warnings.simplefilter("error", RuntimeWarning)
            ev, _, wts, info = mc.multichannel_unweight(
                CH_T, _models(flows), me_t, E, torch.Generator().manual_seed(4), ALPHAS,
                n_events=10 ** 9, max_batches=16, batch_per_channel=512,
                wmax_quantile=quantile, per_channel_max=True, partial_unweight=True, **CUTS)
        z = _on_z(ev).numpy()
        return [_partial_sigma(wts, info, ALPHAS, part) for part in (z, 1 - z)], info

    got, info = run()
    assert np.all(info["w_max"] > 0)
    for (s, e), (s_ref, e_ref) in zip(got, stratified):
        assert abs(s - s_ref) <= 5 * np.hypot(e, e_ref)
    if quantile == 0.5:
        monkeypatch.setattr(mc, "_MIN_SHARE", 0.0)
        got, info = run()
        assert info["w_max"][1] == 0
        assert sum(s for s, _ in got) < 0.5 * sum(s for s, _ in stratified)


def test_entry_points(world_of_one):
    """``mesh`` is ported: on a world of one the mixture and two training
    epochs are the single-device run's, bit for bit (the two-process run is
    in tests/test_torch_dp.py)."""
    models = mc.build_channel_flows(torch.Generator().manual_seed(1), CH_T, 2, 4, [8],
                                    dtype=torch.float64, device="cpu")
    got = mc.mixture_weights(CH_T, models, me_t, E, torch.Generator().manual_seed(2), 8, ALPHAS,
                             mesh=world_of_one, with_kinematics=True, **CUTS)
    ref = mc.mixture_weights(CH_T, models, me_t, E, torch.Generator().manual_seed(2), 8, ALPHAS,
                             with_kinematics=True, **CUTS)
    assert torch.equal(got[0], ref[0]) and got[1].keys() == ref[1].keys()
    assert all(torch.equal(got[1][k], ref[1][k]) for k in ref[1])
    kw = dict(alphas=list(ALPHAS), batch_per_channel=16, mini_batch_per_channel=8, epochs=2,
              loss_mode="var", **CUTS)
    out = [mc.train_multichannel(CH_T, models, me_t, E, optimizers.adamax(5e-3, 1e-4),
                                 torch.Generator().manual_seed(3), mesh=mesh, **kw)
           for mesh in (world_of_one, None)]
    for name in out[1]["history"]:
        assert np.array_equal(out[0]["history"][name], out[1]["history"][name])
    for a, b in zip(out[0]["params"], out[1]["params"]):
        assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                      b.state_dict().values()))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mc.build_channel_flows(torch.Generator(), CH_T, 2, 4, [8])
    models = mc.build_channel_flows(torch.Generator().manual_seed(1), CH_T, 2, 4, [8],
                                    dtype=torch.float64, device="cpu")
    # identity at init: the forward maps the latents to themselves
    z = torch.rand((16, N_LAT), generator=torch.Generator().manual_seed(2), dtype=torch.float64)
    for m in models:
        x, jac = m(z, False)
        torch.testing.assert_close(x, z, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(jac, torch.ones(16, dtype=torch.float64))
    assert not torch.equal(models[0].cells[0].linears[0]["w"], models[1].cells[0].linears[0]["w"])


def _thinning(t, a):
    """Each channel's schedule share and its partial-mode thinning a_k."""
    rate = np.asarray(a, np.float64) * t
    return rate / rate.sum(), rate / rate.max()


def test_knapsack_keeps_every_live_channel():
    """Pilots whose weights are mostly 0 (cut events): at a loose quantile
    the thresholds drop, but never to 0, which would take a channel with
    events out of the schedule.  Channel 1 has 40 nonzero pilot weights of
    64, so the 50% overweight budget would otherwise reach its zeros; the
    share floor stops it above its smallest positive weight."""
    rng = np.random.default_rng(3)
    pilots = [np.sort(np.concatenate([rng.exponential(size=n), np.zeros(64 - n)]))[::-1]
              for n in (64, 40)]
    a = np.array([0.95, 0.05])
    t = mc._knapsack(pilots, a, 64, 0.5)
    t0 = np.array([p[0] for p in pilots])
    assert np.all(t > 0) and np.all(t < 1.05 * t0)
    assert t[1] > 1.05 * pilots[1][39]
    share, _ = _thinning(t, a)
    assert np.all(share >= mc._MIN_SHARE * _thinning(t0, a)[0])


@pytest.mark.parametrize("quantile", [0.9, 0.5])
def test_knapsack_share_floor_on_wide_pilots(monkeypatch, quantile):
    """Float32 pilots spanning 40 decades, denormals and zeros included,
    beside a narrow channel: every channel keeps its schedule share (and so
    its partial-mode thinning a_k) at or above _MIN_SHARE of its share at
    the pilot maxima.  Without the floor the greedy descends the wide
    channel to its smallest pilot weights and thins it to ~1e-37."""
    rng = np.random.default_rng(0)
    n = 4096
    wide = (10.0 ** rng.uniform(-44, -4, n)).astype(np.float32)
    wide[rng.random(n) < 0.3] = 0.0
    assert np.any((wide > 0) & (wide < np.finfo(np.float32).tiny))
    narrow = (rng.lognormal(0.0, 1.0, n) * 1e-6).astype(np.float32)
    pilots = [np.sort(p)[::-1] for p in (wide, narrow)]
    t0 = np.array([p[0] for p in pilots], np.float64)
    for a in ([0.5, 0.5], [0.95, 0.05], [0.05, 0.95]):
        t = mc._knapsack(pilots, np.array(a), n, quantile)
        share, thin = _thinning(t, a)
        share0 = _thinning(t0, a)[0]
        assert np.all(t > np.finfo(np.float32).tiny)
        assert np.all(share >= mc._MIN_SHARE * share0 * (1 - 1e-12))
        assert np.all(thin >= mc._MIN_SHARE * share0 * (1 - 1e-12))
        assert np.all(t < t0)        # the knapsack still cuts both channels
    monkeypatch.setattr(mc, "_MIN_SHARE", 0.0)
    t = mc._knapsack(pilots, np.array([0.5, 0.5]), n, quantile)
    assert _thinning(t, [0.5, 0.5])[1].min() < 1e-30
