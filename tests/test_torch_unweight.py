"""The port's unweighting against nf_tpu's, with injected draws.

Both sides take the same proposals ``x``, Jacobians and acceptance uniforms:
nf_tpu's ``_make_draw`` is replaced by a draw of ``x`` from its key (with
``jac = 0.5 + x0``), the port's ``_make_draw`` and ``_uniform`` by replays
of the very arrays nf_tpu's key schedule gives (``generate_unweighted``:
one split for ``w_max``, then per batch a split into the proposal and the
uniform keys).  Masks, events, efficiency and overweight counts must then
be equal, the compaction loop's overflow and doubling included; float64,
on the CPU.
"""

import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf_tpu.training import unweight as junweight
from nf_tpu_torch import PWQuadManager
from nf_tpu_torch.training import unweight
from test_torch_parallel import world_of_one  # noqa: F401 (fixture)

torch.set_num_threads(1)
N_FLOW = 2


def camel_t(x):
    return (torch.exp(-((x[:, 0] - 0.75) ** 2 + (x[:, 1] - 0.75) ** 2) / 0.04)
            + torch.exp(-((x[:, 0] - 0.25) ** 2 + (x[:, 1] - 0.25) ** 2) / 0.04))


def camel_j(x):
    return (jnp.exp(-((x[:, 0] - 0.75) ** 2 + (x[:, 1] - 0.75) ** 2) / 0.04)
            + jnp.exp(-((x[:, 0] - 0.25) ** 2 + (x[:, 1] - 0.25) ** 2) / 0.04))


def _draw_j(key, n):
    x = jax.random.uniform(key, (n, N_FLOW), jnp.float64)
    return x, 0.5 + x[:, 0]


def _fake_make_draw_j(flow, params, state, n, train, method):
    return functools.partial(_draw_j, n=n)


def _stream(seed, batch, n_batches, estimate):
    """The draws nf_tpu's generate_unweighted makes from PRNGKey(seed): the
    w_max pilot (``estimate_wmax``'s default n) if ``estimate``, then per
    batch ``(x, jac)`` and the uniforms, as numpy arrays."""
    key = jax.random.PRNGKey(seed)
    draws, uniforms = [], []
    if estimate:
        key, sub = jax.random.split(key)
        draws.append(_draw_j(sub, 100_000))
    for _ in range(n_batches):
        key, sub = jax.random.split(key)
        k_w, k_u = jax.random.split(sub)
        draws.append(_draw_j(k_w, batch))
        uniforms.append(jax.random.uniform(k_u, (batch,), jnp.float64))
    return ([tuple(np.array(a) for a in d) for d in draws],
            [np.array(u) for u in uniforms])


def _replay(monkeypatch, draws, uniforms):
    """Make the port draw ``draws`` and ``uniforms`` in order."""
    draws, uniforms = collections.deque(draws), collections.deque(uniforms)

    def make_draw(flow, model, n, train, method):
        def draw(generator):
            x, jac = draws.popleft()
            assert x.shape == (n, N_FLOW)
            return torch.from_numpy(x), torch.from_numpy(jac)
        return draw

    def uniform(generator, n, dtype, device):
        assert dtype == torch.float64
        return torch.from_numpy(uniforms.popleft())

    monkeypatch.setattr(unweight, "_make_draw", make_draw)
    monkeypatch.setattr(unweight, "_uniform", uniform)
    return draws, uniforms


def test_unweighted_batch_matches_nf_tpu(monkeypatch):
    n, w_max = 4096, 0.9
    key = jax.random.PRNGKey(3)
    x_j, acc_j, over_j, wt_j = junweight.unweighted_batch(
        None, None, None, camel_j, key, n, w_max, draw=functools.partial(_draw_j, n=n),
        return_weights=True)
    k_w, k_u = jax.random.split(key)
    x, jac = (np.array(a) for a in _draw_j(k_w, n))
    _replay(monkeypatch, [], [np.array(jax.random.uniform(k_u, (n,), jnp.float64))])
    x_t, acc_t, over_t, wt_t = unweight.unweighted_batch(
        None, None, camel_t, None, n, w_max,
        draw=lambda g: (torch.from_numpy(x), torch.from_numpy(jac)), return_weights=True)
    np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    assert 0 < int(over_t) == int(over_j) and 0 < int(acc_t.sum()) < n
    np.testing.assert_allclose(wt_t.numpy(), np.asarray(wt_j), rtol=1e-14)


@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("compact", [False, "auto", 64])
def test_generate_unweighted_matches_nf_tpu(monkeypatch, compact, partial):
    """The whole loop, w_max estimated at quantile 0.9: ``False`` keeps
    every accepted row, ``"auto"`` sizes the capacity from the first batch,
    and a forced capacity of 64 overflows on the first batches (about 600
    accepts in 2048 proposals), keeps their first 64 accepted rows and
    doubles until the batches fit."""
    kw = dict(n_events=1500, batch=2048, wmax_quantile=0.9, compact=compact,
              partial_unweight=partial, method=None)
    monkeypatch.setattr(junweight, "_make_draw", _fake_make_draw_j)
    res_j = junweight.generate_unweighted(None, None, None, camel_j, jax.random.PRNGKey(5),
                                          **kw)
    draws, uniforms = _stream(5, 2048, 40, estimate=True)
    first_x, first_jac = draws[1]
    left = _replay(monkeypatch, draws, uniforms)
    res_t = unweight.generate_unweighted(None, None, camel_t, None, **kw)
    n_batches = 40 - len(left[1])
    assert n_batches >= 3

    np.testing.assert_array_equal(res_t[0], res_j[0])
    if partial:
        np.testing.assert_allclose(res_t[1], res_j[1], rtol=1e-14)
        info_t, info_j = res_t[2], res_j[2]
        assert info_t["accept_rate"] == info_j["accept_rate"]
        assert info_t["n_overweight"] == info_j["n_overweight"] > 0
        np.testing.assert_allclose([info_t["eff"], info_t["w_max"]],
                                   [info_j["eff"], info_j["w_max"]], rtol=1e-14)
    else:
        assert res_t[1] == res_j[1] and res_t[2] == res_j[2] > 0
    # the first batch's accepted rows, from nf_tpu's pilot and uniforms
    pilot_x, pilot_jac = draws[0]
    w_max = float(jnp.quantile(camel_j(pilot_x) * pilot_jac, 0.9)) * 1.05
    accepted = np.asarray(camel_j(first_x) * first_jac > uniforms[0] * w_max)
    if partial:
        assert res_j[2]["w_max"] == w_max
    if compact == 64:
        # the first batch overflowed: exactly its first 64 accepted rows
        assert accepted.sum() > 64
        np.testing.assert_array_equal(res_t[0][:64], first_x[accepted][:64])
    else:
        np.testing.assert_array_equal(res_t[0][:accepted.sum()], first_x[accepted])


def test_quantile_matches_jnp():
    """``_quantile`` against ``jnp.quantile`` with 64-bit types on, in
    float32 and float64, where ``q (n - 1)`` is and is not an integer:
    within one unit in the last place (the two round the interpolation's
    products and sum differently)."""
    rng = np.random.RandomState(0)
    for dt in (np.float32, np.float64):
        for n in (1, 2, 3, 1000, 4097):
            for q in (0.0, 0.5, 0.9, 0.95, 0.999, 1.0):
                a = rng.lognormal(size=n).astype(dt)
                got = unweight._quantile(torch.from_numpy(a), q)
                want = np.asarray(jnp.quantile(jnp.asarray(a), q))
                assert got.dtype == torch.from_numpy(a).dtype
                assert abs(got.item() - float(want)) <= np.spacing(want), (dt, n, q)


def test_quantile_beyond_torch_quantile_limit():
    """2^24 + 1 weights, more than ``torch.quantile`` takes."""
    a = torch.rand((1 << 24) + 1, generator=torch.Generator().manual_seed(1))
    got = unweight._quantile(a, 0.999)
    s = torch.sort(a).values
    lo = int(0.999 * (1 << 24))
    assert float(s[lo]) <= float(got) <= float(s[lo + 1])


@pytest.mark.parametrize("quantile", [1.0, 0.95])
def test_estimate_wmax_matches_nf_tpu(monkeypatch, quantile):
    monkeypatch.setattr(junweight, "_make_draw", _fake_make_draw_j)
    key = jax.random.PRNGKey(8)
    wm_j = junweight.estimate_wmax(None, None, None, camel_j, key, n=30000, safety=1.05,
                                   quantile=quantile)
    _replay(monkeypatch, [tuple(np.array(a) for a in _draw_j(key, 30000))], [])
    wm_t = unweight.estimate_wmax(None, None, camel_t, None, n=30000, safety=1.05,
                                  quantile=quantile)
    np.testing.assert_allclose(wm_t, wm_j, rtol=1e-14)


@pytest.fixture(scope="module")
def manager():
    NF = PWQuadManager(n_flow=2, seed=2, dtype=torch.float64, device="cpu")
    NF.create_model(2, 4, [4] * 2)
    return NF


@pytest.mark.parametrize("method", ["auto", "fused", "folded"])
def test_generate_unweighted_on_a_model(manager, world_of_one, method):
    """The real draws on a CPU model: ``"auto"`` is the stateful forward
    there, ``"fused"`` the kernel's plain version with a fresh Philox seed a
    batch, so no proposal repeats across batches; events lie in [0, 1]^2 and
    carry the model's dtype (float32 through the fused and folded maps)."""
    gen = torch.Generator().manual_seed(4)
    events, eff, n_over = unweight.generate_unweighted(
        manager._flow, manager.best_model, camel_t, gen, n_events=3000, batch=2048,
        wmax_quantile=0.95, method=method)
    assert events.shape[0] >= 3000 and events.shape[1] == 2
    assert events.dtype == (np.float64 if method == "auto" else np.float32)
    assert ((events >= 0) & (events <= 1)).all()
    assert 0 < eff <= 1 and n_over >= 0
    assert np.unique(events, axis=0).shape[0] == events.shape[0]
    # under a mesh (a world of one) the same draws give the same events;
    # "auto" is the folded forward there and compaction is off
    kw = dict(n_events=500, batch=512, wmax_quantile=0.95)
    ref = unweight.generate_unweighted(
        manager._flow, manager.best_model, camel_t, torch.Generator().manual_seed(5),
        method="folded" if method == "auto" else method, compact=False, **kw)
    got = unweight.generate_unweighted(
        manager._flow, manager.best_model, camel_t, torch.Generator().manual_seed(5),
        method=method, mesh=world_of_one, **kw)
    assert np.array_equal(got[0], ref[0]) and got[1:] == ref[1:]
    with pytest.raises(ValueError, match="eval-mode only"):
        unweight.generate_unweighted(manager._flow, manager.best_model, camel_t, gen, 10,
                                     train=True, mesh=world_of_one)
