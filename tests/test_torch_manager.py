"""The port's optimizer, training step, integrator and manager against nf_tpu.

In float64 on the CPU: one training epoch (two minibatches of numpy latents)
is compared with the same epoch written from nf_tpu's own forward, optimizer
and loss (training/manager.py:466-539); ``integrate`` is compared with
nf_tpu's forward on the latents the port drew.  A short camel-2D run checks
the trainer end to end.
"""

import collections
import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf_tpu.flows import factory as jfactory
from nf_tpu.flows import model as jmodel
from nf_tpu.training import optimizers as joptim
from nf_tpu_torch import PWQuadManager, interop
from nf_tpu_torch.flows.sampling import seed_from
from nf_tpu_torch.ops.pwquad_sampler import philox_uniform
from nf_tpu_torch.training import manager as tmanager
from nf_tpu_torch.training import optimizers as toptim

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


def _like(model, tensors):
    """``to_numpy`` of a copy of ``model`` whose parameters are ``tensors``."""
    other = copy.deepcopy(model)
    with torch.no_grad():
        for p, t in zip(other.parameters(), tensors):
            p.copy_(t)
    return interop.to_numpy(other)[0]


def test_adamax_matches_nf_tpu():
    """torch.optim.Adamax with L2 weight decay == nf_tpu's optax chain, over
    three updates in float64."""
    rng = np.random.RandomState(0)
    p0 = {"a": rng.standard_normal(5), "b": rng.standard_normal((2, 3))}
    grads = [{k: rng.standard_normal(v.shape) * 10.0 ** -i for k, v in p0.items()}
             for i in range(3)]
    opt_j = joptim.adamax(2e-3, 1e-4)
    pj = jax.tree.map(jnp.asarray, p0)
    state = opt_j.init(pj)
    pt = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    opt_t = toptim.adamax(2e-3, 1e-4)(list(pt.values()))
    for g in grads:
        upd, state = opt_j.update(jax.tree.map(jnp.asarray, g), state, pj)
        pj = jax.tree.map(lambda a, u: a + u, pj, upd)
        for k in pt:
            pt[k].grad = torch.tensor(g[k])
        opt_t.step()
    for k in p0:
        np.testing.assert_allclose(pt[k].detach().numpy(), np.asarray(pj[k]), rtol=1e-10)


def _jax_epoch(flow, params, state, ws, preburn, maxf, loss_mode):
    """One epoch written from nf_tpu's parts (manager.py:466-539)."""
    optimizer = joptim.adamax(2e-3, 1e-4)

    def loss_fn(p, bn, w):
        x, jacv, new_bn = jmodel.forward(flow, p, bn, w, True)
        if preburn:
            fres = camel_j(w)
            fXJ = fres * jacv / maxf
        else:
            fres = camel_j(jax.lax.stop_gradient(x)) * jacv
            fXJ = fres / maxf
        if loss_mode == "var" or (loss_mode == "kl" and preburn):
            loss = jnp.var(fXJ, ddof=1)
        elif loss_mode == "kl":
            loss = jnp.mean(jax.lax.stop_gradient(fXJ) * jnp.log(jnp.maximum(jacv, 1e-30)))
        else:
            loss = jnp.mean((fXJ * maxf) ** 2)
        return loss, new_bn

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    losses, grads = [], []
    for w in ws:
        (loss, state), g = step(params, state, jnp.asarray(w))
        losses.append(loss)
        grads.append(g)
    grad = jax.tree.map(lambda *g: jnp.mean(jnp.stack(g), axis=0), *grads)
    updates, _ = optimizer.update(grad, optimizer.init(params), params)
    params = jax.tree.map(lambda p, u: p + u, params, updates)
    return params, state, float(np.mean(losses)), grad


@pytest.mark.parametrize("preburn", [True, False])
@pytest.mark.parametrize("loss_mode", ["var", "est", "kl"])
def test_epoch_step_matches_nf_tpu(loss_mode, preburn):
    flow, params, state = jfactory.build_pwquad_flow(
        jax.random.PRNGKey(1), 2, 2, 4, (4, 4), jnp.float64)
    params, state = jax.tree.map(np.asarray, (params, state))
    rng = np.random.RandomState(2)
    ws = [rng.uniform(size=(256, 2)) for _ in range(2)]
    maxf = 1.7
    p_j, s_j, loss_j, grad_j = _jax_epoch(flow, params, state, ws, preburn, maxf, loss_mode)

    model = interop.from_numpy(flow, params, state)
    p_old = [p.detach().clone() for p in model.parameters()]
    opt = toptim.adamax(2e-3, 1e-4)(model.parameters())
    stats = tmanager.epoch_step(model, opt, camel_t, [torch.tensor(w) for w in ws],
                                preburn, torch.tensor(maxf, dtype=torch.float64), loss_mode)
    np.testing.assert_allclose(float(stats[0]), loss_j, rtol=1e-9)
    p_t, s_t = interop.to_numpy(model)
    # atol: a BatchNorm shift feeding a batch-statistics BatchNorm has a zero
    # gradient up to rounding (~1e-17), which Adamax turns into a step of
    # lr * g / eps ~ 1e-12 of either sign
    for a, b in zip(jax.tree.leaves((p_t, s_t)), jax.tree.leaves((p_j, s_j))):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-9, atol=1e-11)
    # the averaged gradient, read back from Adamax's first moment:
    # exp_avg = (1 - b1) (g + wd p) after one step
    g_t = _like(model, [opt.state[p]["exp_avg"] / 0.1 - 1e-4 * p0
                        for p, p0 in zip(model.parameters(), p_old)])
    for a, b in zip(jax.tree.leaves(g_t), jax.tree.leaves(grad_j)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-7, atol=1e-12)


@pytest.fixture(scope="module")
def manager():
    NF = PWQuadManager(n_flow=2, seed=0, dtype=torch.float64, device="cpu")
    NF.create_model(2, 4, [4] * 2)
    return NF


@pytest.mark.parametrize("combine", ["iw", "mean"])
@pytest.mark.parametrize("method", ["fused", "folded", "reference"])
def test_integrate_matches_nf_tpu_on_the_same_latents(manager, method, combine):
    nitn, neval, seed = 3, 400, 7
    sig, err = manager.integrate(camel_t, nitn, neval, seed=seed, method=method,
                                 combine=combine)
    flow, _, _ = jfactory.build_pwquad_flow(jax.random.PRNGKey(0), 2, 2, 4, (4, 4),
                                            jnp.float64)
    params, state = interop.to_numpy(manager.best_model)
    gen = torch.Generator().manual_seed(seed)
    if method == "fused":
        seed0 = seed_from(gen)
        ws = [philox_uniform(seed0, i * neval, neval, 2) for i in range(nitn)]
    else:
        ws = [torch.rand((neval, 2), generator=gen, dtype=torch.float64).numpy()
              for _ in range(nitn)]
    train = method == "reference" and not manager.best_eval_mode
    fwd = jax.jit(jmodel.forward, static_argnums=(0, 4))
    means, variances = [], []
    for w in ws:
        x, jac, _ = fwd(flow, params, state, jnp.asarray(w, jnp.float64), train)
        fres = np.asarray(camel_j(x) * jac)
        means.append(fres.mean())
        variances.append(fres.var(ddof=1))
    means, variances = np.array(means), np.array(variances)
    if combine == "mean":
        sig_j, err_j = means.mean(), np.sqrt(variances.mean() / (neval * nitn))
    else:
        sig_j = np.sum(means / variances) / np.sum(1.0 / variances)
        err_j = np.sqrt(1.0 / np.sum(1.0 / variances)) / math.sqrt(neval * nitn)
    # the fused path computes in float32 (as the kernel does)
    rtol = 2e-5 if method == "fused" else 1e-9
    np.testing.assert_allclose([sig, err], [sig_j, err_j], rtol=rtol)


def test_sample_paths(manager):
    x, jac = manager.sample(300, seed=3)                    # reference path here
    assert x.shape == (300, 2) and jac.shape == (300,) and x.dtype == torch.float64
    x_f, jac_f = manager.sample(300, seed=3, method="fused")
    assert x_f.dtype == torch.float32 and bool(torch.isfinite(jac_f).all())
    x_e, jac_e = manager.sample(300, seed=3, method="folded")
    x_r, jac_r = manager.sample(300, seed=3, method="reference", train=False)
    torch.testing.assert_close(x_e, x_r, rtol=1e-9, atol=1e-12)
    with pytest.raises(ValueError):
        manager.sample(10, method="qmc")
    assert manager._resolve_method(None, None) == "reference"


def test_camel_trains_and_integrates():
    NF = PWQuadManager(n_flow=2, seed=0, dtype=torch.float64, device="cpu")
    NF.create_model(2, 4, [4] * 2)
    seen = []
    sig, err = NF._train_variance_forward_seq(
        camel_t, toptim.adamax(2e-3, 1e-4), log=False, batch_size=2000, epochs=30,
        preburn_time=10, integrate=True, mini_batch_size=1000, pretty_progressbar=False,
        progress_callback=seen.append)
    exact = camel_exact()
    assert np.isfinite(sig) and err > 0
    assert abs(sig - exact) <= 6 * err + 0.05 * exact
    assert len(seen) == NF._last_epoch + 1 == len(NF.history) and NF.best_epoch > 0
    sig2, err2 = NF.integrate(camel_t, 4, 20000, seed=1)
    assert abs(sig2 - exact) <= 6 * err2 + 0.05 * exact


def test_early_stop_runs_the_tail_integration():
    """kill_counter=0 stops at the first epoch whose loss does not fall;
    the remaining epochs are integrated with the best model in eval mode."""
    NF = PWQuadManager(n_flow=2, seed=1, dtype=torch.float64, device="cpu")
    NF.create_model(2, 4, [4] * 2)
    sig, err = NF._train_variance_forward_seq(
        camel_t, toptim.adamax(2e-3, 1e-4), log=False, batch_size=1000, epochs=20,
        preburn_time=0, kill_counter=0, integrate=True, mini_batch_size=500,
        pretty_progressbar=False)
    assert NF._last_epoch < 18 and NF.best_eval_mode
    assert np.all(NF._err_hist > 0) and np.isfinite(sig) and err > 0


@pytest.mark.parametrize("kwargs", [
    {"mesh": object()}, {"epochs_per_sync": 4}, {"epochs_per_sync": "auto"},
])
def test_unported_arguments_raise(manager, kwargs):
    with pytest.raises(NotImplementedError, match=next(iter(kwargs))):
        manager._train_variance_forward_seq(camel_t, toptim.adamax(1e-3), epochs=1,
                                            batch_size=100, mini_batch_size=100, **kwargs)


@pytest.mark.parametrize("arg", ["resume_from", "logdir", "run"])
def test_logging_and_resume_arguments_work(tmp_path, arg):
    """The arguments the trainer once refused: each is accepted and does
    its work (tests/test_torch_resume.py holds them against nf_tpu)."""
    from nf_tpu_torch.training.metrics import MemoryLogger
    NF = PWQuadManager(n_flow=2, seed=0, dtype=torch.float64, device="cpu")
    NF.create_model(2, 4, [4] * 2)
    kw = dict(epochs=1, batch_size=100, mini_batch_size=100, pretty_progressbar=False)
    run = MemoryLogger()
    NF._train_variance_forward_seq(camel_t, toptim.adamax(1e-3), log=True, run=run,
                                   logdir=str(tmp_path), **kw)
    if arg == "resume_from":
        NF.save_training_state(tmp_path / "state.pt")
        NF._train_variance_forward_seq(camel_t, toptim.adamax(1e-3), epoch_start=1,
                                       resume_from=tmp_path / "state.pt", **kw)
        assert len(NF.history) == 2 and len(NF._integ_hist) == 3
    elif arg == "logdir":
        assert sorted(p.name for p in tmp_path.iterdir()) == ["torch", "torch_int"]
    else:
        assert [s for s, _ in run.scalars["training.loss"]] == [0]
        assert run.scalars["training.int_loss"] == [(0, NF.int_loss)]


def test_unported_endpoint_options_raise(manager):
    with pytest.raises(NotImplementedError, match="mesh"):
        manager.integrate(camel_t, 2, 100, mesh=object())
    with pytest.raises(NotImplementedError, match="mesh"):
        manager.sample(10, mesh=object())


def _nf_tpu_latents(key, n_flow, mb, n_mb, epochs, stats_every=None):
    """The latents nf_tpu's per-epoch trainer draws from the manager key
    ``key`` (manager.py:352-371, 469, 547), in the order the port draws
    them: the initial estimate's ``n_flow`` batches of ``2 mb``, then per
    epoch its minibatches and, when the stale trainer refreshes, the
    refresh batch of ``mb``."""
    out = []
    key, sub = jax.random.split(key)
    for k in jax.random.split(sub, n_flow):
        out.append(jax.random.uniform(k, (2 * mb, n_flow), jnp.float64))
    for i in range(epochs):
        key, sub = jax.random.split(key)
        out += [jax.random.uniform(k, (mb, n_flow), jnp.float64)
                for k in jax.random.split(sub, n_mb)]
        if stats_every and i % stats_every == 0:
            out.append(jax.random.uniform(jax.random.fold_in(sub, 777), (mb, n_flow),
                                          jnp.float64))
    return collections.deque(np.array(a) for a in out)


@pytest.mark.parametrize("bn_stats,seed", [("batch", 1), ("stale", 3)])
def test_select_best_by_ess_matches_nf_tpu(bn_stats, seed):
    """Both trainers with ``select_best_by="ess"`` on a short camel run,
    from nf_tpu's initial weights and on nf_tpu's latents, snapshot the
    epoch nf_tpu snapshots, with its ESS; the least loss falls on another
    epoch, so the rule decides it.  nf_tpu's stale trainer runs its kernel
    path (interpret mode), which the port follows; the stale maps run in
    float32 on both sides."""
    from nf_tpu import PWQuadManager as JPWQuadManager
    kw = dict(log=False, batch_size=512, epochs=12, mini_batch_size=256, preburn_time=0,
              kill_counter=100, pretty_progressbar=False, select_best_by="ess",
              bn_stats=bn_stats, stats_every=3)
    NFj = JPWQuadManager(n_flow=2, seed=seed, dtype=jnp.float64)
    NFj.create_model(2, 4, [3] * 3)
    NF = PWQuadManager(n_flow=2, seed=seed, dtype=torch.float64, device="cpu")
    NF.create_model(2, 4, [3] * 3)
    NF._model = interop.from_numpy(NF._flow, *jax.tree.map(np.asarray,
                                                           (NFj._params, NFj._bn_state)))
    NF.best_model = copy.deepcopy(NF._model)
    latents = _nf_tpu_latents(NFj._key, 2, 256, 2, 12, 3 if bn_stats == "stale" else None)
    NFj._train_variance_forward_seq(camel_j, joptim.adamax(1e-2, 1e-4), epochs_per_sync=1,
                                    _force_train_kernel=bn_stats == "stale", **kw)

    def uniform(shape):
        w = latents.popleft()
        assert w.shape == tuple(shape)
        return torch.from_numpy(w)

    NF._uniform = uniform
    NF._train_variance_forward_seq(camel_t, toptim.adamax(1e-2, 1e-4), **kw)
    assert not latents
    rtol = 1e-9 if bn_stats == "batch" else 1e-5
    np.testing.assert_allclose(NF.history, NFj.history, rtol=rtol)
    assert NF.best_epoch == NFj.best_epoch
    np.testing.assert_allclose(NF.best_ess, NFj.best_ess, rtol=rtol)
    assert int(np.argmin(NF.history)) != NF.best_epoch
    # the snapshot is the model after that epoch's step, compared by its
    # train-mode map: Adamax moves the input BatchNorm's shift, which the
    # batch statistics downstream cancel, by steps of either sign on a
    # gradient that is zero up to rounding
    w = np.random.RandomState(0).uniform(size=(512, 2))
    x_j, jac_j, _ = jmodel.forward(NFj._flow, *NFj.best_params, jnp.asarray(w), True)
    with torch.no_grad():
        x_t, jac_t = NF.best_model.frozen_forward(torch.from_numpy(w), True)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=100 * rtol, atol=1e-12)
    np.testing.assert_allclose(jac_t.numpy(), np.asarray(jac_j), rtol=100 * rtol)
