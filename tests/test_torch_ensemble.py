"""The port's ensemble trainer against nf_tpu's vmapped ensemble.

In float64 on the CPU: nf_tpu's stacked initial weights, carried over by
``interop.ensemble_from_numpy``, and nf_tpu's per-run latents (its key
schedule, ensemble.py:180-320), replayed through the port's
``ensemble._uniform`` hook in the port's draw order, give nf_tpu's
histories, best metrics, integrals, best epochs, kills and best weights.
Then the port alone: grouped calls and the halving retry equal one call, a
plan mismatch raises, the functional BatchNorm step equals the module's bit
for bit, and a run's best flow goes into a manager.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf_tpu.flows import factory as jfactory
from nf_tpu.training import ensemble as jensemble
from nf_tpu.training import optimizers as joptim
from nf_tpu_torch import PWQuadManager, interop
from nf_tpu_torch.bijectors.batchnorm import BatchNorm, batchnorm_train, collect_running_stats
from nf_tpu_torch.flows import factory
from nf_tpu_torch.training import ensemble
from nf_tpu_torch.training import optimizers as toptim
from test_torch_manager import camel_exact, camel_j, camel_t

torch.set_num_threads(1)

R, MB, N_MB, EPOCHS = 4, 128, 2, 8


def _nf_tpu_stack(n_runs=R, n_flow=2):
    flow, ps, ss = jensemble.stack_ensemble(
        lambda k: jfactory.build_pwquad_flow(k, n_flow, 2, 4, (3, 3), jnp.float64),
        jax.random.PRNGKey(0), n_runs)
    return flow, jax.tree.map(np.asarray, ps), jax.tree.map(np.asarray, ss)


def _nf_tpu_latents(key, n_runs, epochs, groups, n_flow=2):
    """nf_tpu's per-run draws for ``key``, in the order the port draws them
    for runs grouped as ``groups`` (slices): per group, phase A
    ``[R, n_flow, 2 mb, n_flow]``, then each epoch ``[R, n_mb, mb, n_flow]``."""
    phase_a, epoch_ws = [], []
    for rk in jax.random.split(key, n_runs):
        k_a, k_t = jax.random.split(rk)
        phase_a.append(np.stack([np.asarray(jax.random.uniform(k, (2 * MB, n_flow),
                                                               jnp.float64))
                                 for k in jax.random.split(k_a, n_flow)]))
        epoch_ws.append([np.stack([np.asarray(jax.random.uniform(k, (MB, n_flow), jnp.float64))
                                   for k in jax.random.split(ek, N_MB)])
                         for ek in jax.random.split(k_t, epochs)])
    out = collections.deque()
    for sl in groups:
        out.append(np.stack(phase_a[sl]))
        out.extend(np.stack([w[e] for w in epoch_ws[sl]]) for e in range(epochs))
    return out


def _replay(monkeypatch, latents):
    def uniform(generator, shape, dtype, device):
        w = latents.popleft()
        assert w.shape == tuple(shape) and dtype == torch.float64
        return torch.from_numpy(w)
    monkeypatch.setattr(ensemble, "_uniform", uniform)


def _port_run(monkeypatch, flow, ps, ss, latents, lr, **kw):
    _replay(monkeypatch, latents)
    P, B = interop.ensemble_from_numpy(flow, ps, ss)
    res = ensemble.train_ensemble(flow, P, B, camel_t, toptim.adamax(lr, 1e-4),
                                  torch.Generator(), **kw)
    assert not latents
    return res


# the two leaves of each conditioner on which the train-mode map does not
# depend: the input BatchNorm's shift is removed by the next layer's batch
# statistics, so its gradient is zero up to rounding (~1e-13 here), which
# Adamax turns into steps of either sign; the next BatchNorm's running mean
# follows it
GAUGE = ("bn_in.bias", "bns.0.mean")


@pytest.mark.parametrize("loss_mode,select_best_by,lr,kill_counter", [
    ("var", "loss", 3e-3, 7), ("var", "ess", 3e-3, 7), ("kl", "loss", 3e-3, 7),
    ("var", "loss", 0.0, 0)])
def test_matches_nf_tpu(monkeypatch, loss_mode, select_best_by, lr, kill_counter):
    """The last case (lr 0: the loss is a random walk) hits the kill
    counter, which freezes the best snapshot and the integrals."""
    flow, ps, ss = _nf_tpu_stack()
    key = jax.random.PRNGKey(1)
    kw = dict(batch_size=MB * N_MB, mini_batch_size=MB, epochs=EPOCHS, preburn_time=3,
              kill_counter=kill_counter, loss_mode=loss_mode, select_best_by=select_best_by)
    want = jensemble.train_ensemble(flow, ps, ss, camel_j, joptim.adamax(lr, 1e-4), key, **kw)
    got = _port_run(monkeypatch, flow, ps, ss, _nf_tpu_latents(key, R, EPOCHS, [slice(0, R)]),
                    lr, **kw)
    metric = "best_ess" if select_best_by == "ess" else "best_loss"
    for name in ("history", metric, "integ_tot", "err_tot", "int_loss"):
        np.testing.assert_allclose(got[name], np.asarray(want[name]), rtol=1e-9, err_msg=name)
    np.testing.assert_array_equal(got["best_epoch"], want["best_epoch"])
    np.testing.assert_array_equal(got["killed"], want["killed"])
    if lr == 0.0:
        assert got["killed"].sum() >= 2
    ref = interop.ensemble_from_numpy(flow, jax.tree.map(np.asarray, want["best_params"]),
                                      jax.tree.map(np.asarray, want["best_bn"]))
    for mine, theirs in zip((got["best_params"], got["best_bn"]), ref):
        assert set(mine) == set(theirs)
        for name in mine:
            if not name.endswith(GAUGE):
                np.testing.assert_allclose(mine[name].numpy(), theirs[name].numpy(),
                                           rtol=1e-8, atol=1e-12, err_msg=name)
    # the gauge leaves through the map they do not move
    w = torch.from_numpy(np.random.RandomState(0).uniform(size=(512, 2)))
    for i in range(R):
        with torch.no_grad():
            x_t, jac_t = interop.ensemble_member(
                flow, (got["best_params"], got["best_bn"]), i).frozen_forward(w, True)
            x_j, jac_j = interop.ensemble_member(flow, ref, i).frozen_forward(w, True)
        np.testing.assert_allclose(x_t.numpy(), x_j.numpy(), rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(jac_t.numpy(), jac_j.numpy(), rtol=1e-8)


def test_products_of_several_factors_match_nf_tpu(monkeypatch):
    """A 4-D flow, whose coupling transforms take products of two factors
    (``coupling.prod`` under ``vmap`` of ``grad``): the histories and the
    integrals as nf_tpu's."""
    flow, ps, ss = _nf_tpu_stack(n_flow=4)
    key = jax.random.PRNGKey(2)
    kw = dict(batch_size=MB * N_MB, mini_batch_size=MB, epochs=EPOCHS, preburn_time=3,
              kill_counter=7)
    want = jensemble.train_ensemble(flow, ps, ss, camel_j, joptim.adamax(3e-3, 1e-4), key, **kw)
    got = _port_run(monkeypatch, flow, ps, ss,
                    _nf_tpu_latents(key, R, EPOCHS, [slice(0, R)], n_flow=4), 3e-3, **kw)
    for name in ("history", "best_loss", "integ_tot", "err_tot", "int_loss"):
        np.testing.assert_allclose(got[name], np.asarray(want[name]), rtol=1e-9, err_msg=name)
    np.testing.assert_array_equal(got["best_epoch"], want["best_epoch"])


def _grouped(monkeypatch, runs_per_call, groups, n_runs=5):
    flow, ps, ss = _nf_tpu_stack(n_runs)
    latents = _nf_tpu_latents(jax.random.PRNGKey(6), n_runs, 4, groups)
    return _port_run(monkeypatch, flow, ps, ss, latents, 3e-3, batch_size=MB * N_MB,
                     mini_batch_size=MB, epochs=4, kill_counter=100,
                     runs_per_call=runs_per_call)


def test_grouped_calls_equal_one_call(monkeypatch):
    one = _grouped(monkeypatch, None, [slice(0, 5)])
    grouped = _grouped(monkeypatch, 2, [slice(0, 2), slice(2, 4), slice(4, 5)])
    assert one["group_size"] == 5 and grouped["group_size"] == 2
    for name in ("history", "best_loss", "integ_tot", "err_tot", "int_loss"):
        np.testing.assert_allclose(grouped[name], one[name], rtol=1e-12, err_msg=name)
    for name, t in one["best_params"].items():
        torch.testing.assert_close(grouped["best_params"][name], t, rtol=1e-12, atol=1e-15)


def test_out_of_memory_halves_the_group(monkeypatch):
    """The test hook fails groups wider than 2: 5 runs go as 2 + 2 + 1."""
    one = _grouped(monkeypatch, None, [slice(0, 5)])
    monkeypatch.setattr(ensemble, "_TEST_FAULT_WIDTH", 2)
    retried = _grouped(monkeypatch, "auto", [slice(0, 2), slice(2, 4), slice(4, 5)])
    assert retried["group_size"] == 2
    np.testing.assert_allclose(retried["history"], one["history"], rtol=1e-12)
    monkeypatch.setattr(ensemble, "_TEST_FAULT_WIDTH", 0)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        _grouped(monkeypatch, 1, [slice(0, 1)])


def test_stack_ensemble_refuses_unequal_plans():
    sizes = iter([2, 3])
    with pytest.raises(ValueError, match="plan"):
        ensemble.stack_ensemble(lambda g: factory.build_pwquad_flow(
            g, 2, next(sizes), 4, (4,), torch.float64), torch.Generator().manual_seed(0), 2)
    flow, P, B = ensemble.stack_ensemble(lambda g: factory.build_pwquad_flow(
        g, 2, 2, 4, (4,), torch.float64), torch.Generator().manual_seed(0), 3)
    assert all(t.shape[0] == 3 for t in (*P.values(), *B.values()))
    assert not torch.equal(P["cells.0.final.w"][0], P["cells.0.final.w"][1])


def test_functional_batchnorm_equals_the_module():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((300, 5), generator=gen, dtype=torch.float64) * 3 + 1
    bn = BatchNorm(5, torch.float64)
    with torch.no_grad():
        bn.scale.copy_(torch.rand(5, generator=gen, dtype=torch.float64) + 0.5)
        bn.mean.copy_(torch.randn(5, generator=gen, dtype=torch.float64))
    before = {k: v.clone() for k, v in bn.named_buffers()}
    y, new_mean, new_var = batchnorm_train(x, bn.scale, bn.bias, bn.mean, bn.var)
    with collect_running_stats() as stats:
        y_c = bn(x, True)
    assert all(torch.equal(v, before[k]) for k, v in bn.named_buffers())
    y_m = bn(x, True)
    for a, b in ((y, y_m), (y_c, y_m), (new_mean, bn.mean), (new_var, bn.var),
                 (stats[bn][0], bn.mean), (stats[bn][1], bn.var)):
        assert torch.equal(a, b)
    # a whole flow: the collected statistics are the buffers a forward writes
    model = factory.build_pwquad_flow(gen, 2, 2, 4, (3, 3), torch.float64)
    w = torch.rand((200, 2), generator=gen, dtype=torch.float64)
    names = {m: n for n, m in model.named_modules() if isinstance(m, BatchNorm)}
    with collect_running_stats() as stats:
        x_c, jac_c = model(w, True)
    x_m, jac_m = model(w, True)
    assert torch.equal(x_c, x_m) and torch.equal(jac_c, jac_m)
    buffers = dict(model.named_buffers())
    for m, (mean, var) in stats.items():
        assert torch.equal(mean, buffers[names[m] + ".mean"])
        assert torch.equal(var, buffers[names[m] + ".var"])


def test_best_flow_goes_into_a_manager():
    gen = torch.Generator().manual_seed(3)
    flow, P, B = ensemble.stack_ensemble(lambda g: factory.build_pwquad_flow(
        g, 2, 4, 4, (3, 3, 3), torch.float64), gen, 3)
    res = ensemble.train_ensemble(flow, P, B, camel_t, toptim.adamax(1e-2, 1e-4),
                                  torch.Generator().manual_seed(4), batch_size=1000,
                                  epochs=20, preburn_time=3, kill_counter=1000)
    assert (res["best_loss"] < res["int_loss"]).all() and res["history"].shape == (3, 20)
    best = int(np.argmin(res["best_loss"]))
    NF = PWQuadManager(n_flow=2, seed=0, dtype=torch.float64, device="cpu")
    NF.create_model(4, 4, [3, 3, 3])
    NF._model.load_state_dict(
        interop.ensemble_member(flow, (res["best_params"], res["best_bn"]), best).state_dict())
    NF.best_model = NF._model
    sig, err = NF.integrate(camel_t, 4, 20000, seed=1, method="folded")
    assert abs(sig - camel_exact()) < 5 * err + 0.01 * camel_exact()


def test_group_size_from_the_memory_estimate():
    flow, P, B = ensemble.stack_ensemble(lambda g: factory.build_pwquad_flow(
        g, 2, 4, 4, (8, 8), torch.float32), torch.Generator().manual_seed(0), 2)
    p0, b0 = ensemble.run_index(P, 0), ensemble.run_index(B, 0)
    per_run = ensemble.estimate_run_bytes(flow, p0, b0, 10000, 1, 40)
    assert per_run > 3 * 10000 * 4 * sum(sum(c.nn_sizes) for c in flow.cells)
    assert ensemble.auto_runs_per_call(flow, p0, b0, 10000, 1, 40, 64,
                                       budget_bytes=10 * per_run) == 10
    assert ensemble.auto_runs_per_call(flow, p0, b0, 10000, 1, 40, 8,
                                       budget_bytes=100 * per_run) == 8
    assert ensemble.auto_runs_per_call(flow, p0, b0, 10000, 1, 40, 8, budget_bytes=1) == 1
    assert ensemble.auto_runs_per_call(flow, p0, b0, 10000, 1, 40, 8, device="cpu") == 8
