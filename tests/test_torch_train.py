"""The port's stale-statistics trainer against nf_tpu (ops/pwquad_train.py).

nf_tpu's five training-kernel configurations (tests/test_train_kernel.py),
with the BatchNorm statistics moved off their init values, are carried into
the port with ``interop.from_numpy``; nf_tpu's folded arrays go the other way
with ``pack_flat``.  Checked on the CPU, where the port runs its kernels'
plain versions: the fold, the frozen-statistics forward, the gradients of
``FusedTrain`` with respect to the folded arrays, the latents and the raw
parameters, the forward's statistics and the refresh, one epoch of the
trainer, and a short training run.  nf_tpu's kernels run in Pallas interpret
mode only where its own fast tests run them (the statistics).

The port follows nf_tpu's kernel-path refresh (``_force_train_kernel=True``),
not its CPU fallback, which refreshes with a train-mode forward.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf_tpu.bijectors.permutations import mask_partition
from nf_tpu.flows import factory as jfactory
from nf_tpu.flows import model as jmodel
from nf_tpu.ops import pwquad_train as jtrain
from nf_tpu.training import optimizers as joptim
from nf_tpu_torch import PWQuadManager, interop
from nf_tpu_torch.ops import pwquad_train as ttrain
from nf_tpu_torch.training import manager as tmanager
from nf_tpu_torch.training import optimizers as toptim

torch.set_num_threads(1)
F64 = jnp.float64


def _masked_mini(key):
    """nf_tpu's two-cell masked flow (tests/test_train_kernel.py): gather /
    scatter around each cell, from nf_tpu's own plan."""
    n_flow, cells, ops = 4, [], []
    for i in range(2):
        feeder, trafoer = mask_partition(n_flow, i)
        perm = tuple(feeder.tolist() + trafoer.tolist())
        cells.append(jmodel.make_cell_cfg("pwquad", n_flow, len(feeder), 3, (4,)))
        ops += [("gather", perm), ("cell", i), ("scatter", perm)]
    flow = jmodel.Flow(n_flow, tuple(cells), tuple(ops))
    ps, ss = zip(*[jmodel.init_cell(k, c, F64) for k, c in zip(jax.random.split(key, 2), cells)])
    return flow, list(ps), list(ss)


CONFIGS = {
    "camel": lambda k: jfactory.build_pwquad_flow(k, 2, 2, 4, (3, 3, 3), F64),
    "masked_mini": _masked_mini,
    "rank_sp": lambda k: jfactory.build_pwquad_flow(k, 3, 2, 3, (4,), F64, final_rank=2,
                                                    activation="squareplus"),
    "pwlin": lambda k: jfactory.build_pwlin_flow(k, 3, 1, 2, 4, (5,), 1, F64),
    "affine": lambda k: jfactory.build_affine_flow(k, 3, 2, 2, (5,), 1, F64),
}
NAMES = sorted(CONFIGS)


@functools.lru_cache(maxsize=None)
def _nf_tpu_setup(name):
    """nf_tpu's (flow, params, state) in float64 with the BatchNorm state
    moved by one train-mode forward, as numpy, and its fold."""
    flow, params, state = CONFIGS[name](jax.random.PRNGKey(0))
    w0 = np.random.RandomState(1).uniform(size=(256, flow.n_flow))
    _, _, state = jax.jit(jmodel.forward, static_argnums=(0, 4))(
        flow, params, state, jnp.asarray(w0), True)
    params, state = jax.tree.map(np.asarray, (params, state))
    return flow, params, state, _fold_j(flow, params, state)


def _setup(name):
    """:func:`_nf_tpu_setup` and the port's model holding the same weights."""
    flow, params, state, _ = _nf_tpu_setup(name)
    return flow, params, state, interop.from_numpy(flow, params, state)


def _latents(n, n_flow, seed=2):
    return np.random.RandomState(seed).uniform(size=(n, n_flow)).astype(np.float32)


def _fold_j(flow, params, state):
    flat, meta = jtrain.fold_flow_jnp(flow, params, state)
    return [np.asarray(a) for a in flat], meta


def _fold(name):
    return _nf_tpu_setup(name)[3]


def camel_t(x):
    return (torch.exp(-((x[:, 0] - 0.75) ** 2 + (x[:, 1] - 0.75) ** 2) / 0.04)
            + torch.exp(-((x[:, 0] - 0.25) ** 2 + (x[:, 1] - 0.25) ** 2) / 0.04))


def camel_j(x):
    return (jnp.exp(-((x[:, 0] - 0.75) ** 2 + (x[:, 1] - 0.75) ** 2) / 0.04)
            + jnp.exp(-((x[:, 0] - 0.25) ** 2 + (x[:, 1] - 0.25) ** 2) / 0.04))


@pytest.mark.parametrize("name", NAMES)
def test_fold_flow_matches_nf_tpu(name):
    """Both fold in float64 and round to float32 once: the arrays agree to
    one float32 rounding (2^-23 relative), whatever the float64 order."""
    flow, params, state, model = _setup(name)
    flat_j, meta = _fold(name)
    plan = ttrain.TrainPlan(flow)
    assert plan.meta == meta
    flat_t = ttrain.fold_flow(model)
    assert flat_t.dtype == torch.float32 and flat_t.shape == (plan.n_weights,)
    parts = ttrain.unpack_flat(flow, flat_t)
    assert len(parts) == len(flat_j)
    for a, b in zip(parts, flat_j):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=2.4e-7, atol=0)
    for a, b in zip(ttrain.unpack_flat(flow, ttrain.pack_flat(flat_j)), flat_j):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("name", NAMES)
def test_folded_forward_ref_matches_nf_tpu(name):
    """Same float32 arrays and latents into both float32 forwards; they
    differ only in summation order (matmul, cumsum): 1e-5 relative."""
    flow = _nf_tpu_setup(name)[0]
    flat_j, meta = _fold(name)
    w = _latents(384, flow.n_flow)
    x_j, jac_j = jax.jit(jtrain.folded_forward_ref, static_argnums=(0, 1))(
        flow, meta, [jnp.asarray(a) for a in flat_j], jnp.asarray(w))
    x_t, jac_t = ttrain.folded_forward_ref(flow, ttrain.pack_flat(flat_j), torch.from_numpy(w))
    assert x_t.dtype == torch.float32
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(jac_t.numpy(), np.asarray(jac_j), rtol=1e-5)


def _kernel_loss_j(kx, kj):
    def loss(x, jac):
        return jnp.sum(x * kx) + jnp.sum(jac * kj) + jnp.mean((jac - jnp.mean(jac)) ** 2)
    return loss


@pytest.mark.parametrize("name", NAMES)
def test_fused_train_grads_match_jax_grad(name):
    """FusedTrain's gradients (its CPU backward) against jax.grad of nf_tpu's
    folded_forward_ref, for every folded array and the latents, with nf_tpu's
    own loss (tests/test_train_kernel.py:125-133).  Both are float32
    autodiff of the same map in another summation order; the bound is
    nf_tpu's kernel-vs-autodiff gate tightened tenfold."""
    flow = _nf_tpu_setup(name)[0]
    flat_j, meta = _fold(name)
    n = 384
    w = _latents(n, flow.n_flow)
    rng = np.random.RandomState(7)
    kx = (rng.standard_normal((n, flow.n_flow)) * 0.3).astype(np.float32)
    kj = rng.standard_normal(n).astype(np.float32)
    loss_j = _kernel_loss_j(jnp.asarray(kx), jnp.asarray(kj))
    gr_f, gr_w = jax.jit(jax.grad(
        lambda fl, wl: loss_j(*jtrain.folded_forward_ref(flow, meta, fl, wl)), argnums=(0, 1)))(
        [jnp.asarray(a) for a in flat_j], jnp.asarray(w))

    plan = ttrain.TrainPlan(flow)
    flat = ttrain.pack_flat(flat_j).requires_grad_(True)
    lat = torch.from_numpy(w).requires_grad_(True)
    x, jac = ttrain.fused_train(plan, flat, lat)
    loss = torch.sum(x * torch.from_numpy(kx)) + torch.sum(jac * torch.from_numpy(kj)) \
        + torch.mean((jac - torch.mean(jac)) ** 2)
    loss.backward()
    for a, b in zip(ttrain.unpack_flat(flow, flat.grad), gr_f):
        scale = max(float(jnp.max(jnp.abs(b))), 1e-3)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5 * scale, rtol=2e-4)
    scale = max(float(jnp.max(jnp.abs(gr_w))), 1e-3)
    np.testing.assert_allclose(lat.grad.numpy(), np.asarray(gr_w), atol=2e-5 * scale, rtol=2e-4)


def test_raw_param_grads_match_jax_grad():
    """Through the differentiable fold to the raw W, b, scale and bias (the
    statistics carry none), against jax.grad through fold_flow_jnp, on
    camel (tests/test_train_kernel.py:146-168).  float64 parameters, float32
    map on both sides; nf_tpu's bound tightened tenfold."""
    flow, params, state, model = _setup("camel")
    meta = _fold("camel")[1]
    w = _latents(256, flow.n_flow, seed=3)

    def loss_j(p):
        fl, _ = jtrain.fold_flow_jnp(flow, p, state)
        x, jac = jtrain.folded_forward_ref(flow, meta, fl, jnp.asarray(w))
        return jnp.mean((jac - jnp.mean(jac)) ** 2) + jnp.sum(x) * 1e-3

    gr = jax.jit(jax.grad(loss_j))(jax.tree.map(jnp.asarray, params))
    x, jac = ttrain.fused_train(ttrain.TrainPlan(flow), ttrain.fold_flow(model),
                                torch.from_numpy(w))
    (torch.mean((jac - torch.mean(jac)) ** 2) + torch.sum(x) * 1e-3).backward()
    grads = interop.from_numpy(flow, params, state)
    with torch.no_grad():
        for g, p in zip(grads.parameters(), model.parameters()):
            g.copy_(p.grad)
    for a, b in zip(jax.tree.leaves(interop.to_numpy(grads)[0]), jax.tree.leaves(gr)):
        scale = max(float(np.max(np.abs(b))), 1e-3)
        np.testing.assert_allclose(a, np.asarray(b), atol=3e-5 * scale, rtol=3e-4)
    assert all(b.grad is None for b in model.buffers())


@pytest.fixture(scope="module")
def camel_stats_kernel():
    """nf_tpu's forward kernel with statistics, in interpret mode, for the
    camel plan (jitted once: the trace dominates)."""
    flow = _nf_tpu_setup("camel")[0]
    meta = _fold("camel")[1]
    return jax.jit(jtrain.build_train_kernels(flow, meta, interpret=True, with_stats=True)[0])


def test_stats_and_refresh_match_nf_tpu_kernel(camel_stats_kernel):
    """forward_stats_ref's stage and statistics against nf_tpu's forward
    kernel with ``with_stats`` on n = 300 (not a tile multiple, so nf_tpu's
    padding mask is load-bearing), then stats_to_bn_state on nf_tpu's very
    statistics.  nf_tpu sums in float32 and the port in float64: 3e-5
    relative, nf_tpu's own bound for its sums.  The refresh takes the same
    array on both sides; nf_tpu divides the input columns' sums in float32:
    1e-5 relative."""
    flow, params, state, model = _setup("camel")
    flat_j, meta = _fold("camel")
    n = 300
    w = _latents(n, flow.n_flow, seed=9)
    _, _, stage_j, stats_j = camel_stats_kernel([jnp.asarray(a) for a in flat_j], jnp.asarray(w))
    x_t, jac_t, stage_t, stats_t = ttrain.forward_stats_ref(
        flow, ttrain.pack_flat(flat_j), torch.from_numpy(w))
    stage_j = np.asarray(stage_j).reshape(len(flow.cells), flow.n_flow, -1)[:, :, :n]
    np.testing.assert_allclose(stage_t.numpy(), stage_j, rtol=1e-5, atol=1e-6)
    assert stats_t.dtype == torch.float64 and stats_t.shape == stats_j.shape
    assert stats_t.shape[0] == ttrain.TrainPlan(flow).n_stat_rows
    np.testing.assert_allclose(stats_t.numpy(), np.asarray(stats_j), rtol=3e-5)

    new_j = jtrain.stats_to_bn_state(flow, meta,
                                     jax.tree.map(jnp.asarray, params),
                                     jax.tree.map(jnp.asarray, state), stats_j, n)
    ttrain.stats_to_bn_state(model, torch.from_numpy(np.array(stats_j)), n)
    state_t = interop.to_numpy(model)[1]
    for a, b in zip(jax.tree.leaves(state_t), jax.tree.leaves(new_j)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5)


def _jax_stale_epoch(flow, params, state, ws, refresh_w, preburn, maxf, loss_mode,
                     pathwise, stats_fwd):
    """One stale-statistics epoch from nf_tpu's parts (manager.py:466-560 on
    its kernel path): fold with the fixed statistics, folded_forward_ref in
    float32, the loss, Adamax, then the refresh from the forward kernel's
    statistics with the post-update parameters.  Returns the new parameters
    and state, the mean loss and the gradient averaged over the
    minibatches."""
    meta = _fold("camel")[1]
    optimizer = joptim.adamax(2e-3, 1e-4)

    def loss_fn(p, w):
        flat, _ = jtrain.fold_flow_jnp(flow, p, state)
        x, jacv = jtrain.folded_forward_ref(flow, meta, flat, w.astype(jnp.float32))
        x, jacv = x.astype(F64), jacv.astype(F64)
        if preburn:
            fres = camel_j(w)
            fXJ = fres * jacv / maxf
        else:
            fres = camel_j(x if pathwise else jax.lax.stop_gradient(x)) * jacv
            fXJ = fres / maxf
        if loss_mode == "var" or (loss_mode == "kl" and preburn):
            return jnp.var(fXJ, ddof=1)
        return jnp.mean(jax.lax.stop_gradient(fXJ) * jnp.log(jnp.maximum(jacv, 1e-30)))

    step = jax.jit(jax.value_and_grad(loss_fn))
    p = jax.tree.map(jnp.asarray, params)
    losses, grads = zip(*[step(p, jnp.asarray(w)) for w in ws])
    grad = jax.tree.map(lambda *g: jnp.mean(jnp.stack(g), axis=0), *grads)
    updates, _ = optimizer.update(grad, optimizer.init(p), p)
    p = jax.tree.map(lambda a, u: a + u, p, updates)
    flat2, _ = jax.jit(jtrain.fold_flow_jnp, static_argnums=0)(flow, p, state)
    stats = stats_fwd(flat2, jnp.asarray(refresh_w, jnp.float32))[3]
    new_state = jax.jit(jtrain.stats_to_bn_state, static_argnums=(0, 1, 5))(
        flow, meta, p, jax.tree.map(jnp.asarray, state), stats, refresh_w.shape[0])
    return p, new_state, float(np.mean(losses)), grad


class _GradTap:
    """An optimizer that keeps a copy of the gradients it steps on."""

    def __init__(self, optimizer, params):
        self.optimizer, self.params, self.grads = optimizer, list(params), None

    def zero_grad(self, set_to_none=True):
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def step(self):
        self.grads = [p.grad.detach().clone() for p in self.params]
        self.optimizer.step()


@pytest.mark.parametrize("loss_mode,preburn,pathwise", [
    ("var", True, False), ("var", False, False), ("kl", True, False), ("kl", False, False),
    ("var", False, True),
])
def test_stale_epoch_matches_nf_tpu(camel_stats_kernel, loss_mode, preburn, pathwise):
    """The manager's stale epoch (two minibatches of numpy latents, the
    refresh due) against the same epoch composed from nf_tpu's parts, in a
    float64 model whose map runs in float32 on both sides.  Loss and
    refreshed statistics carry the maps' float32 difference (1e-5
    relative).  The gradients the optimizer steps on, averaged over the
    minibatches, are held array by array at the raw-parameter bound of
    test_raw_param_grads_match_jax_grad: Adamax's first step is about
    lr * sign(g + wd * p), so the parameters alone would not show a wrong
    magnitude."""
    flow, params, state, model = _setup("camel")
    rng = np.random.RandomState(2)
    ws = [rng.uniform(size=(256, 2)) for _ in range(2)]
    refresh_w = rng.uniform(size=(300, 2))
    maxf = 1.7
    p_j, s_j, loss_j, g_j = _jax_stale_epoch(flow, params, state, ws, refresh_w, preburn, maxf,
                                             loss_mode, pathwise, camel_stats_kernel)

    opt = _GradTap(toptim.adamax(2e-3, 1e-4)(model.parameters()), model.parameters())
    plan = ttrain.TrainPlan(flow)
    stats = tmanager.epoch_step(
        model, opt, camel_t, [torch.tensor(w) for w in ws], preburn,
        torch.tensor(maxf, dtype=torch.float64), loss_mode, pathwise,
        tmanager.stale_forward(plan, model))
    tmanager.refresh_bn_stats(plan, model, torch.tensor(refresh_w))
    np.testing.assert_allclose(float(stats[0]), loss_j, rtol=1e-5)
    grads = interop.from_numpy(flow, params, state)
    with torch.no_grad():
        for g, tapped in zip(grads.parameters(), opt.grads):
            g.copy_(tapped)
    for a, b in zip(jax.tree.leaves(interop.to_numpy(grads)[0]), jax.tree.leaves(g_j)):
        scale = max(float(np.max(np.abs(b))), 1e-3)
        np.testing.assert_allclose(a, np.asarray(b), atol=3e-5 * scale, rtol=3e-4)
    p_t, s_t = interop.to_numpy(model)
    for a, b in zip(jax.tree.leaves(p_t), jax.tree.leaves(p_j)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-7, atol=1e-7)
    for a, b in zip(jax.tree.leaves(s_t), jax.tree.leaves(s_j)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5)


def camel_exact():
    g = 0.2 * (math.sqrt(math.pi) / 2) * (math.erf(0.25 / 0.2) + math.erf(0.75 / 0.2))
    return 2 * g * g


def test_stale_trainer_converges():
    """Counterpart of nf_tpu's test_manager_stale_mode_converges: a short
    camel-2D run with bn_stats="stale" beats uniform sampling, reaches the
    batch trainer's loss within 2x, moves the BatchNorm buffers through its
    refreshes, and integrates within 6 err + 5%."""
    results = {}
    for mode in ("batch", "stale"):
        NF = PWQuadManager(n_flow=2, seed=0, device="cpu")
        NF.create_model(2, 4, [3] * 3)
        before = {k: v.clone() for k, v in NF._model.named_buffers()}
        NF._train_variance_forward_seq(
            camel_t, toptim.adamax(2e-3, 1e-4), log=False, batch_size=2000, epochs=60,
            preburn_time=5, kill_counter=1000, mini_batch_size=2000,
            pretty_progressbar=False, integrate=True, bn_stats=mode)
        results[mode] = NF.best_loss
        assert NF.best_loss < NF.int_loss
        assert any(not torch.equal(before[k], v) for k, v in NF._model.named_buffers())
    assert results["stale"] < 2.0 * results["batch"]
    sig, err = NF.integrate(camel_t, 4, 20000, seed=1)
    assert abs(sig - camel_exact()) <= 6 * err + 0.05 * camel_exact()
    sec, rate = NF.benchmark_train_step(reps=2)
    assert sec > 0 and rate == pytest.approx(2000 / sec)
