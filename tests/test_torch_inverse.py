"""The port's inverses and model density against nf_tpu's.

In float64 on the CPU, on nf_tpu's own parameters moved into the port with
``interop.from_numpy``: the coupling inverses of each cell kind, the flow's
``inverse`` (eval and train-mode BatchNorm), ``make_folded_inverse`` and
``make_density``, on the same points, for an affine, a pwlin, a pwquad roll
chain and a masked 4-D pwquad flow, and the inverse's gradient with respect
to the parameters against ``jax.grad``, at points beside bin edges too.
The round trip through the folded forward recovers the latents away from
the kinks of the map.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf_tpu.bijectors import coupling as jcoupling
from nf_tpu.bijectors.permutations import mask_partition
from nf_tpu.flows import factory as jfactory
from nf_tpu.flows import fast_eval as jfast
from nf_tpu.flows import model as jmodel
from nf_tpu_torch import interop
from nf_tpu_torch.bijectors import coupling
from nf_tpu_torch.bijectors.permutations import inverse_permutation
from nf_tpu_torch.flows import inverse
from nf_tpu_torch.flows.model import permutation_source
from nf_tpu_torch.flows.fast_eval import make_density, make_folded_forward, make_folded_inverse
from nf_tpu_torch.ops import pwquad_train

torch.set_num_threads(1)
F64 = jnp.float64


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _masked4(key):
    """A masked 4-D pwquad flow: gather / scatter around each cell."""
    cells, ops = [], []
    for i in range(2):
        feeder, trafoer = mask_partition(4, i)
        perm = tuple(feeder.tolist() + trafoer.tolist())
        cells.append(jmodel.make_cell_cfg("pwquad", 4, len(feeder), 5, (6,)))
        ops += [("gather", perm), ("cell", i), ("scatter", perm)]
    flow = jmodel.Flow(4, tuple(cells), tuple(ops))
    ps, ss = zip(*[jmodel.init_cell(k, c, F64) for k, c in zip(jax.random.split(key, 2), cells)])
    return flow, list(ps), list(ss)


FLOWS = {
    "affine": lambda k: jfactory.build_affine_flow(k, 3, 1, 3, (5,), 1, F64),
    "pwlin": lambda k: jfactory.build_pwlin_flow(k, 3, 1, 3, 6, (5, 5), 1, F64),
    "pwquad": lambda k: jfactory.build_pwquad_flow(k, 3, 3, 5, (6, 6), F64, final_rank=2,
                                                   activation="squareplus"),
    "masked4": _masked4,
}


def _setup(name):
    """nf_tpu's flow, its numpy (params, state) with the BatchNorm state
    moved by one train-mode forward, and the port's model holding them."""
    flow, params, state = FLOWS[name](jax.random.PRNGKey(3))
    w0 = np.random.RandomState(1).uniform(size=(256, flow.n_flow))
    _, _, state = jmodel.forward(flow, params, state, jnp.asarray(w0), True)
    params, state = jax.tree.map(np.asarray, (params, state))
    return flow, params, state, interop.from_numpy(flow, params, state)


def _points(n, n_flow, seed=4):
    return np.random.RandomState(seed).uniform(0.01, 0.99, size=(n, n_flow))


def _close(a, b, rtol=1e-10):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=1e-13)


@pytest.mark.parametrize("kind", ["affine", "pwlin", "pwquad"])
def test_cell_inverse_matches_nf_tpu(kind):
    """Each kind's inverse on the conditioner output of nf_tpu's first
    cell: the recovered xB and the forward factor."""
    flow, params, state, model = _setup(kind)
    cfg = flow.cells[0]
    y = _points(500, flow.n_flow)
    jinv = {"affine": lambda: jcoupling.affine_inverse(
                params[0], state[0], jnp.asarray(y), jnp.ones(500), cfg.pass_through),
            "pwlin": lambda: jcoupling.pwlin_inverse(
                params[0], state[0], jnp.asarray(y), jnp.ones(500), cfg.pass_through,
                cfg.n_bins, act=cfg.activation),
            "pwquad": lambda: jcoupling.pwquad_inverse(
                params[0], state[0], jnp.asarray(y), jnp.ones(500), cfg.pass_through,
                cfg.n_bins, act=cfg.activation)}[kind]
    x_j, jac_j, _ = jinv()
    yt = torch.from_numpy(y)
    z = model.cells[0](yt[:, :cfg.pass_through], False)
    xB, factor = coupling.inverse_transform(cfg, z, yt[:, cfg.pass_through:])
    _close(xB.numpy(), np.asarray(x_j)[:, cfg.pass_through:])
    _close(1.0 / factor.numpy(), jac_j)


def test_pwquad_invert_near_bin_edges():
    """pwquad_invert on points at and beside its CDF's bin edges, and at 0
    and 1, against nf_tpu's: the stable root does not cancel there."""
    rng = np.random.RandomState(5)
    v_raw, w_raw = rng.normal(size=(64, 2, 7)), rng.normal(size=(64, 2, 6))
    v = np.exp(v_raw)
    w = np.exp(w_raw) / np.exp(w_raw).sum(-1, keepdims=True)
    v = v / np.sum((v[..., :-1] + v[..., 1:]) * 0.5 * w, -1, keepdims=True)
    edges = np.cumsum((v[..., :-1] + v[..., 1:]) * 0.5 * w, -1)
    pick = edges[np.arange(64), :, rng.randint(0, 6, size=64)]
    y = np.concatenate([pick, pick * (1 - 1e-12), np.minimum(pick * (1 + 1e-12), 1.0),
                        np.zeros((1, 2)), np.ones((1, 2))])
    tile = lambda a: np.concatenate([a, a, a, a[:1], a[:1]])  # noqa: E731
    x_j, f_j = jcoupling.pwquad_invert(jnp.asarray(tile(v_raw)), jnp.asarray(tile(w_raw)),
                                       jnp.asarray(y))
    x_t, f_t = coupling.pwquad_invert(torch.from_numpy(tile(v_raw)),
                                      torch.from_numpy(tile(w_raw)), torch.from_numpy(y))
    _close(x_t.numpy(), x_j)
    _close(f_t.numpy(), f_j)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", sorted(FLOWS))
def test_flow_inverse_matches_nf_tpu(name, train):
    flow, params, state, model = _setup(name)
    x = _points(400, flow.n_flow)
    w_j, jac_j, state_j = jmodel.inverse(flow, params, state, jnp.asarray(x), train)
    w_t, jac_t = inverse(model.flow, model, torch.from_numpy(x), train)
    _close(w_t.numpy(), w_j)
    _close(jac_t.numpy(), jac_j)
    for a, b in zip(jax.tree.leaves(interop.to_numpy(model)[1]), jax.tree.leaves(state_j)):
        _close(a, b)


@pytest.mark.parametrize("name", sorted(FLOWS))
def test_folded_inverse_and_density_match_nf_tpu(name):
    flow, params, state, model = _setup(name)
    x = _points(400, flow.n_flow)
    w_j, jac_j = jfast.make_folded_inverse(flow, params, state, F64)(jnp.asarray(x))
    q_j = jfast.make_density(flow, params, state, F64)(jnp.asarray(x))
    w_t, jac_t = make_folded_inverse(flow, model, torch.float64)(torch.from_numpy(x))
    q_t = make_density(flow, model, torch.float64)(torch.from_numpy(x))
    assert w_t.dtype == jac_t.dtype == q_t.dtype == torch.float64
    _close(w_t.numpy(), w_j)
    _close(jac_t.numpy(), jac_j)
    _close(q_t.numpy(), q_j)
    # the folded inverse is the eval-mode inverse with BatchNorm folded in
    w_e, jac_e = inverse(flow, model, torch.from_numpy(x))
    _close(w_t.numpy(), w_e.numpy())
    _close(jac_t.numpy(), jac_e.numpy())


@pytest.mark.parametrize("name", sorted(FLOWS))
def test_round_trip_recovers_latents(name):
    """make_folded_inverse undoes make_folded_forward: the latents to 1e-9
    and jac * jac_inv = 1, on every sample at least 1e-6 from a kink of the
    map (``pwquad_train.kink_distance``; affine cells have none)."""
    flow, _, _, model = _setup(name)
    w = torch.from_numpy(np.random.RandomState(6).uniform(size=(2000, flow.n_flow)))
    x, jac = make_folded_forward(flow, model, torch.float64)(w)
    w_back, jac_inv = make_folded_inverse(flow, model, torch.float64)(x)
    keep = pwquad_train.kink_distance(flow, pwquad_train.fold_flow(model).double(), w,
                                      relu=False) > 1e-6
    assert int(keep.sum()) > 1900
    np.testing.assert_allclose(w_back[keep].numpy(), w[keep].numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose((jac * jac_inv)[keep].numpy(), 1.0, rtol=1e-9)


def _param_grads(model):
    """The gradients of ``model`` in nf_tpu's params layout."""
    def g(t):
        return t.grad.numpy()

    return tuple({"bn_in": {"scale": g(c.bn_in.scale), "bias": g(c.bn_in.bias)},
                  "linears": [{k: g(v) for k, v in lin.items()} for lin in c.linears],
                  "bns": [{"scale": g(bn.scale), "bias": g(bn.bias)} for bn in c.bns],
                  "final": {k: g(v) for k, v in c.final.items()}} for c in model.cells)


@torch.no_grad()
def _near_edges(flow, model, x, rng):
    """``x`` with the first transformed coordinate of the first cell the
    inverse meets moved to within 1e-6 of one of its bin edges (the CDF at
    a bin boundary), on either side, for every other row."""
    ops = list(reversed(flow.ops))
    first = next(i for i, op in enumerate(ops) if op[0] == "cell")
    y = torch.from_numpy(x)
    for op in ops[:first]:
        y = y[:, inverse_permutation(permutation_source(op, flow.n_flow))]
    cfg = flow.cells[ops[first][1]]
    pt, nb = cfg.pass_through, cfg.n_bins
    z = model.cells[ops[first][1]](y[:, :pt], False)
    if cfg.kind == "pwlin":
        q = coupling.positivity(z.reshape(len(x), -1, nb), cfg.activation)
        edges = torch.cumsum(q, -1) / q.sum(-1, keepdim=True)
    else:
        z = z.reshape(len(x), -1, 2 * nb + 1)
        v = coupling.positivity(z[..., :nb + 1], cfg.activation)
        w = coupling.positivity(z[..., nb + 1:], cfg.activation)
        w = w / w.sum(-1, keepdim=True)
        v = v / torch.sum((v[..., :-1] + v[..., 1:]) * 0.5 * w, -1, keepdim=True)
        edges = torch.cumsum((v[..., :-1] + v[..., 1:]) * 0.5 * w, -1)
    rows = np.arange(0, len(x), 2)
    pick = edges[rows, 0, rng.randint(0, nb - 1, size=len(rows))]
    y = y.clone()
    y[rows, pt] = pick + torch.from_numpy(rng.choice([-5e-7, -1e-7, 1e-7, 5e-7], len(rows)))
    for op in reversed(ops[:first]):
        y = y[:, permutation_source(op, flow.n_flow)]
    return y.numpy()


@pytest.mark.parametrize("name", ["affine", "pwlin", "pwquad", "masked4"])
def test_flow_inverse_gradient_matches_jax_grad(name):
    """The gradient of a loss on ``inverse``'s latents and Jacobian with
    respect to every parameter, against ``jax.grad`` of nf_tpu's inverse;
    half the points within 1e-6 of a bin edge of the first cell inverted.
    The multi-channel loss differentiates through this inverse."""
    flow, params, state, model = _setup(name)
    rng = np.random.RandomState(7)
    x = _points(300, flow.n_flow)
    if name != "affine":
        x = _near_edges(flow, model, x, rng)
    c_w, c_j = rng.normal(size=(300, flow.n_flow)), rng.normal(size=300)

    def loss_j(p):
        w, jac, _ = jmodel.inverse(flow, p, state, jnp.asarray(x))
        return jnp.sum(c_w * w) + jnp.sum(c_j * jnp.log(jac))

    grads_j = jax.jit(jax.grad(loss_j))(jax.tree.map(jnp.asarray, params))
    with torch.enable_grad():
        w, jac = inverse(model.flow, model, torch.from_numpy(x))
        (torch.sum(torch.from_numpy(c_w) * w) + torch.sum(torch.from_numpy(c_j) * torch.log(jac))
         ).backward()
    flat_t, flat_j = jax.tree.leaves(_param_grads(model)), jax.tree.leaves(grads_j)
    assert len(flat_t) == len(flat_j) > 0
    for a, b in zip(flat_t, flat_j):
        assert np.all(np.isfinite(a))
        scale = max(float(np.abs(b).max()), 1e-300)
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-8, atol=1e-12 * scale)
