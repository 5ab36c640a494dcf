"""The port's bijectors against nf_tpu's, in float64 on identical parameters.

nf_tpu runs in x64 here (tests/conftest.py), so each layer is compared at
rtol 1e-10: the two differ only in the order of floating-point reductions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf_tpu.bijectors import batchnorm as jbn
from nf_tpu.bijectors import conditioner as jcond
from nf_tpu.bijectors import coupling as jcoupling
from nf_tpu.bijectors import permutations as jperm
from nf_tpu.flows import model as jmodel
from nf_tpu_torch.bijectors import batchnorm as tbn
from nf_tpu_torch.bijectors import conditioner as tcond
from nf_tpu_torch.bijectors import coupling as tcoupling
from nf_tpu_torch.bijectors import permutations as tperm
from nf_tpu_torch.flows import model as tmodel

torch.set_num_threads(1)
RTOL = 1e-10


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.tensor(np.asarray(a))


def _bn_module(p, s):
    bn = tbn.BatchNorm(p["scale"].shape[0], torch.float64)
    with torch.no_grad():
        for name, src in (("scale", p), ("bias", p), ("mean", s), ("var", s)):
            getattr(bn, name).copy_(_t(src[name]))
    return bn


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_matches_nf_tpu(train):
    rng = np.random.RandomState(0)
    p = {"scale": rng.uniform(0.5, 2, 5), "bias": rng.standard_normal(5)}
    s = {"mean": rng.standard_normal(5), "var": rng.uniform(0.5, 2, 5)}
    x = rng.standard_normal((64, 5)) * 3 + 1
    y_j, s_j = jax.jit(jbn.apply, static_argnums=3)(p, s, jnp.asarray(x), train)
    bn = _bn_module(p, s)
    y_t = bn(_t(x), train)
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(s_j["mean"]), rtol=RTOL)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(s_j["var"]), rtol=RTOL)


def _cond_pair(in_size, sizes, hidden_bias, final_rank, seed):
    """An nf_tpu conditioner with perturbed BN, and the port's copy of it."""
    params, state = _np(jcond.init(jax.random.PRNGKey(seed), in_size, sizes,
                                   hidden_bias, jnp.float64, final_rank=final_rank))
    rng = np.random.RandomState(seed)
    for bp, bs in [(params["bn_in"], state["bn_in"])] + list(zip(params["bns"], state["bns"])):
        n = bp["scale"].shape[0]
        bp["scale"] = rng.uniform(0.5, 2, n)
        bp["bias"] = rng.standard_normal(n) * 0.3
        bs["mean"] = rng.standard_normal(n) * 0.3
        bs["var"] = rng.uniform(0.5, 2, n)
    cond = tcond.Conditioner(in_size, sizes, hidden_bias, torch.Generator(),
                             torch.float64, final_rank=final_rank)
    with torch.no_grad():
        for bn, bp, bs in [(cond.bn_in, params["bn_in"], state["bn_in"])] + list(
                zip(cond.bns, params["bns"], state["bns"])):
            bn.load_state_dict({"scale": _t(bp["scale"]), "bias": _t(bp["bias"]),
                                "mean": _t(bs["mean"]), "var": _t(bs["var"])})
        for lin, lp in zip(cond.linears, params["linears"]):
            for k in lp:
                lin[k].copy_(_t(lp[k]))
        for k in params["final"]:
            cond.final[k].copy_(_t(params["final"][k]))
    return params, state, cond


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("sizes,hidden_bias,final_rank", [
    ((3, 3, 9), False, None),      # pwquad-style, bias-free hidden layers
    ((6, 4), True, None),          # affine-style, biased hidden layers
    ((5, 12), False, 3),           # factored final layer
    ((7,), False, None),           # no hidden layer
])
def test_conditioner_matches_nf_tpu(sizes, hidden_bias, final_rank, train):
    params, state, cond = _cond_pair(2, sizes, hidden_bias, final_rank, seed=len(sizes))
    x = np.random.RandomState(1).uniform(size=(50, 2))
    z_j, s_j = jax.jit(jcond.apply, static_argnums=3)(params, state, jnp.asarray(x), train)
    z_t = cond(_t(x), train)
    np.testing.assert_allclose(z_t.detach().numpy(), np.asarray(z_j), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(cond.bn_in.mean.numpy(), np.asarray(s_j["bn_in"]["mean"]), rtol=RTOL)
    for bn, sj in zip(cond.bns, s_j["bns"]):
        np.testing.assert_allclose(bn.var.numpy(), np.asarray(sj["var"]), rtol=RTOL)


def test_conditioner_init_bounds_and_rank_check():
    cond = tcond.Conditioner(4, (8, 10), False, torch.Generator().manual_seed(0),
                             torch.float64)
    w = cond.linears[0]["w"]
    assert w.shape == (4, 8) and "b" not in cond.linears[0]
    assert float(w.detach().abs().max()) <= 0.5
    assert float(cond.final["w"].detach().abs().max()) <= 8 ** -0.5
    with pytest.raises(ValueError):
        tcond.Conditioner(4, (3, 10), False, torch.Generator(), final_rank=4)


CELLS = [
    ("pwquad", 3, 1, 4, (5, 5), "exp"),
    ("pwquad", 4, 2, 3, (6,), "squareplus"),
    ("pwlin", 3, 1, 5, (6, 6), "exp"),
    ("pwlin", 3, 2, 3, (4,), "squareplus"),
    ("affine", 3, 1, None, (6,), "exp"),
    ("affine", 4, 2, None, (5, 5), "exp"),   # 2 transformed dims: the 2/pi quirk
]


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("kind,n_flow,pt,n_bins,nn,act", CELLS)
def test_cell_forward_matches_nf_tpu(kind, n_flow, pt, n_bins, nn, act, train):
    cfg = jmodel.make_cell_cfg(kind, n_flow, pt, n_bins, nn, activation=act)
    tcfg = tmodel.make_cell_cfg(kind, n_flow, pt, n_bins, nn, activation=act)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    params, state, cond = _cond_pair(pt, cfg.nn_sizes, cfg.hidden_bias, None, seed=n_flow)
    rng = np.random.RandomState(2)
    x = rng.uniform(size=(80, n_flow))
    x[0, pt:] = 1.0                      # the bin clamp at xB == 1
    jac = rng.uniform(0.5, 2, 80)
    y_j, jac_j, _ = jax.jit(jmodel.apply_cell, static_argnums=(0, 5))(
        cfg, params, state, jnp.asarray(x), jnp.asarray(jac), train)
    y_t, jac_t = tcoupling.cell_forward(tcfg, cond, _t(x), _t(jac), train)
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(jac_t.detach().numpy(), np.asarray(jac_j), rtol=RTOL)


def test_pwquad_compute_matches_nf_tpu_and_is_a_cdf():
    rng = np.random.RandomState(3)
    v_raw, w_raw = rng.standard_normal((40, 2, 6)), rng.standard_normal((40, 2, 5))
    xB = np.sort(rng.uniform(size=(40, 2)), axis=0)
    xB[-1] = 1.0 - 1e-6
    y_j, f_j = jax.jit(jcoupling.pwquad_compute)(jnp.asarray(v_raw), jnp.asarray(w_raw), jnp.asarray(xB))
    y_t, f_t = tcoupling.pwquad_compute(_t(v_raw), _t(w_raw), _t(xB))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=RTOL)
    assert np.all(y_t.numpy() >= 0) and np.all(y_t.numpy() <= 1 + 1e-12)


def test_transforms_take_gradients():
    """d yB / d xB equals the per-dim pdf the transform reports."""
    xB = torch.rand(16, 1, dtype=torch.float64, generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    z = torch.randn(16, 9, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    yB, factor = tcoupling.pwquad_transform(z, xB, 4)
    (g,) = torch.autograd.grad(yB.sum(), xB)
    torch.testing.assert_close(g[:, 0], factor.detach(), rtol=1e-9, atol=1e-12)


def test_positivity():
    z = torch.linspace(-5, 5, 11, dtype=torch.float64)
    torch.testing.assert_close(tcoupling.positivity(z, "exp"), torch.exp(z))
    sp = tcoupling.positivity(z, "squareplus")
    np.testing.assert_allclose(sp.numpy(), np.asarray(jcoupling.positivity(jnp.asarray(z.numpy()), "squareplus")),
                               rtol=RTOL)
    with pytest.raises(ValueError):
        tcoupling.positivity(z, "softplus")


@pytest.mark.parametrize("n_flow", [2, 5, 8, 10, 16])
def test_permutations_match_nf_tpu(n_flow):
    assert tperm.get_bin(n_flow, 6) == jperm.get_bin(n_flow, 6)
    n = len(tperm.get_bin(n_flow - 1))
    for pos in range(2 * n):
        for a, b in zip(tperm.mask_partition(n_flow, pos), jperm.mask_partition(n_flow, pos)):
            np.testing.assert_array_equal(a, b)
    perm = np.random.RandomState(n_flow).permutation(n_flow)
    np.testing.assert_array_equal(tperm.inverse_permutation(perm),
                                  jperm.inverse_permutation(perm))
