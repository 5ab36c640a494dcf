"""The chunked epoch cadence (``epochs_per_sync`` > 1 or ``"auto"``) of the
port's trainers on the CPU.

A chunk draws its latents in the per-epoch order, so a chunked run must equal
the per-epoch run bit for bit: histories, best epoch and best model,
accumulators, model, optimizer and generator state, across chunk lengths,
both trainers, both best-model rules, the variance and KL losses, and stops
that fall inside a chunk (kill counter, the host's stale check, the preburn
exit).  Against nf_tpu's chunked run, on nf_tpu's own latents replayed
through ``NF._uniform`` in its chunk key schedule, at the tolerances of
tests/test_torch_manager.py.  Plus the counterparts of
tests/test_chunked_training.py, a chunked save and resume, and ``mesh=`` at a
world of one.  Float64 throughout; the stale maps run in float32.
"""

import collections
import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from nf_tpu import PWQuadManager as JPWQuadManager
from nf_tpu.flows import model as jmodel
from nf_tpu.training import optimizers as joptim
from nf_tpu_torch import PWQuadManager, interop
from nf_tpu_torch.bijectors import coupling
from nf_tpu_torch.training import optimizers as toptim

from test_torch_parallel import world_of_one  # noqa: F401 (fixture)

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


BASE = dict(log=False, batch_size=512, mini_batch_size=256, integrate=True,
            pretty_progressbar=False, stats_every=3)


def train(k, bn_stats, seed=3, lr=1e-2, mesh=None, **kw):
    """A camel run of ``create_model(2, 4, [4, 4])`` at ``epochs_per_sync=k``."""
    NF = PWQuadManager(n_flow=2, seed=seed, dtype=torch.float64, device="cpu")
    NF.create_model(2, 4, [4] * 2)
    args = dict(BASE, bn_stats=bn_stats)
    args.update(kw)
    out = NF._train_variance_forward_seq(camel_t, toptim.adamax(lr, 1e-4), epochs_per_sync=k,
                                         mesh=mesh, **args)
    return NF, out


def states_equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[n], b[n]) for n in a)


def assert_same_run(a, b):
    """Everything a run leaves, bit for bit."""
    assert a.history == b.history
    assert (a.best_epoch, a._last_epoch, a.best_loss, a.best_ess) == \
        (b.best_epoch, b._last_epoch, b.best_loss, b.best_ess)
    assert a._sm_state == b._sm_state
    assert np.array_equal(a._integ_hist, b._integ_hist)
    assert np.array_equal(a._err_hist, b._err_hist)
    assert (a.integ_tot, a.err_tot) == (b.integ_tot, b.err_tot)
    assert states_equal(a._model.state_dict(), b._model.state_dict())
    assert states_equal(a.best_model.state_dict(), b.best_model.state_dict())
    sa, sb = a._optimizer.state_dict(), b._optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"] and sa["state"].keys() == sb["state"].keys()
    for i in sa["state"]:
        assert states_equal(sa["state"][i], sb["state"][i])
    assert torch.equal(a._gen.get_state(), b._gen.get_state())


@pytest.mark.parametrize("bn_stats", ["batch", "stale"])
@pytest.mark.parametrize("k", [1, 3, 5, "auto"])
def test_chunked_equals_per_epoch(k, bn_stats):
    """Preburn ends inside the first chunks (i > 6 at epoch 7), the stale
    refresh falls every third epoch, the last chunk is cut at the end."""
    ref, out_ref = train(1, bn_stats, epochs=14, preburn_time=6)
    NF, out = train(k, bn_stats, epochs=14, preburn_time=6)
    assert out == out_ref and ref._last_epoch == 13 and ref.best_epoch > 7
    assert_same_run(NF, ref)


@pytest.mark.parametrize("bn_stats", ["batch", "stale"])
@pytest.mark.parametrize("loss_mode", ["var", "kl"])
@pytest.mark.parametrize("select_best_by", ["loss", "ess"])
def test_chunked_equals_per_epoch_rules(select_best_by, loss_mode, bn_stats):
    """The best-model rules and the KL loss (whose preburn keeps the
    variance loss: the device picks the head and the loss per epoch)."""
    kw = dict(epochs=12, preburn_time=4, select_best_by=select_best_by, loss_mode=loss_mode)
    ref, _ = train(1, bn_stats, **kw)
    NF, _ = train(3, bn_stats, **kw)
    assert ref.best_epoch > 4
    assert_same_run(NF, ref)


# Stops that fall inside a chunk: (arguments, seed, chunk length, stop epoch).
# lr 0 makes the loss a random walk, so the kill counter stops the run; with
# impr_ratio 0.9 the stale check (period 11) stops at epoch 33, its second
# check after preburn; with kill_counter 1 preburn ends early on the device
# (two epochs without a fall, or a loss below a quarter of the initial one),
# then the kill counter stops the run.
STOPS = {
    "kill": {"batch": (dict(lr=0.0, kill_counter=2, epochs=40, preburn_time=0), 1, 4, 21),
             "stale": (dict(lr=0.0, kill_counter=2, epochs=40, preburn_time=0), 3, 3, 7)},
    "stale_check": {bn: (dict(lr=1e-3, kill_counter=100, epochs=40, preburn_time=11,
                              impr_ratio=0.9), 3, k, 33) for bn, k in (("batch", 5), ("stale", 4))},
    "kill_after_preburn": {
        "batch": (dict(kill_counter=1, epochs=30, preburn_time=20), 3, 4, 26),
        "stale": (dict(kill_counter=1, epochs=30, preburn_time=20), 4, 4, 13)},
}


@pytest.mark.parametrize("bn_stats", ["batch", "stale"])
@pytest.mark.parametrize("scenario", list(STOPS))
def test_mid_chunk_stop(scenario, bn_stats):
    """A stop inside a chunk leaves what the per-epoch run leaves at that
    epoch (the chunk is run again from its start up to the stop), and the
    tail integration of the epochs left runs from there."""
    kw, seed, k, stop = STOPS[scenario][bn_stats]
    ref, _ = train(1, bn_stats, seed=seed, **kw)
    NF, _ = train(k, bn_stats, seed=seed, **kw)
    assert ref._last_epoch == stop and stop % k != k - 1, "the stop must fall inside a chunk"
    assert NF.best_eval_mode and np.all(NF._err_hist > 0)
    assert_same_run(NF, ref)


def test_chunked_training_converges_and_fills_accumulators():
    """tests/test_chunked_training.py's first test."""
    NF = PWQuadManager(n_flow=2, seed=0, dtype=torch.float64, device="cpu")
    NF.create_model(2, 4, [4] * 2)
    sig, err = NF._train_variance_forward_seq(
        camel_t, toptim.adamax(2e-3), log=False, batch_size=2000, epochs=40,
        pretty_progressbar=False, mini_batch_size=1000, integrate=True, preburn_time=5,
        kill_counter=100, epochs_per_sync=8)
    assert len(NF.history) == 40 and np.all(NF._err_hist > 0)
    assert NF.best_loss < NF.int_loss
    assert abs(sig - camel_exact()) < 6 * err + 0.05 * camel_exact()
    x, jac = NF.sample(256)
    assert bool(torch.isfinite(jac).all())


def test_chunked_and_per_epoch_bookkeeping():
    """tests/test_chunked_training.py's second test: no preburn, no stop, the
    same epochs and function count (here also the same bits)."""
    results = {}
    for k in (1, 5):
        NF = PWQuadManager(n_flow=2, seed=3, dtype=torch.float64, device="cpu")
        NF.create_model(2, 4, [4] * 2)
        NF._train_variance_forward_seq(
            camel_t, toptim.adamax(2e-3), log=False, batch_size=1000, epochs=20,
            pretty_progressbar=False, mini_batch_size=1000, integrate=False, preburn_time=0,
            kill_counter=100, epochs_per_sync=k)
        results[k] = (len(NF.history), NF.best_func_count, NF.history)
    assert results[1] == results[5]


def test_chunked_respects_kill_counter():
    """tests/test_chunked_training.py's third test: with lr=0 the loss is a
    random walk, and the chunked run stops early."""
    NF = PWQuadManager(n_flow=2, seed=4, dtype=torch.float64, device="cpu")
    NF.create_model(2, 4, [4] * 2)
    NF._train_variance_forward_seq(
        camel_t, toptim.adamax(0.0), log=False, batch_size=500, epochs=100,
        pretty_progressbar=False, mini_batch_size=500, integrate=False, preburn_time=0,
        kill_counter=2, epochs_per_sync=10)
    assert len(NF.history) < 100


def test_progress_at_chunk_cadence():
    """``progress_callback`` sees every epoch once, in order; the device
    replica of the state machine is checked epoch by epoch."""
    seen = []
    NF, _ = train("auto", "stale", epochs=14, preburn_time=6, progress_callback=seen.append)
    assert [s["epoch"] for s in seen] == list(range(14))
    assert [s["loss"] for s in seen] == NF.history


@pytest.mark.parametrize("bn_stats", ["batch", "stale"])
def test_chunked_resume_equals_uninterrupted(tmp_path, bn_stats):
    """7 chunked epochs, saved, then 9 more resumed (chunks of 3, so both
    parts end inside a chunk) equal 16 uninterrupted chunked epochs."""
    kw = dict(integrate=False, preburn_time=2, kill_counter=100)
    full, _ = train(3, bn_stats, epochs=16, **kw)
    part, _ = train(3, bn_stats, epochs=7, **kw)
    part.save_training_state(tmp_path / "state.pt")
    NF = PWQuadManager(n_flow=2, seed=3, dtype=torch.float64, device="cpu")
    NF.create_model(2, 4, [4] * 2)
    NF._train_variance_forward_seq(camel_t, toptim.adamax(1e-2, 1e-4), epochs_per_sync=3,
                                   epochs=9, epoch_start=7, resume_from=tmp_path / "state.pt",
                                   **dict(BASE, bn_stats=bn_stats, **kw))
    assert_same_run(NF, full)


@pytest.mark.parametrize("bn_stats", ["batch", "stale"])
def test_mesh_world_of_one_chunked(world_of_one, bn_stats):
    """Under ``mesh=`` the chunk runs eagerly with the collectives inside; at
    a world of one it is the single-device chunked run."""
    kw = dict(epochs=10, preburn_time=3)
    ref, out_ref = train(4, bn_stats, **kw)
    NF, out = train(4, bn_stats, mesh=world_of_one, **kw)
    assert out == out_ref
    assert_same_run(NF, ref)


class HostReads(TorchDispatchMode):
    """Records the operations that read a tensor back to the host."""
    READS = ("aten::_local_scalar_dense", "aten::nonzero", "aten::is_nonzero", "aten::equal")

    def __init__(self):
        super().__init__()
        self.reads = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.name in self.READS:
            self.reads.append(args[0])
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("bn_stats", ["batch", "stale"])
def test_chunk_reads_nothing_back(bn_stats):
    """Two epochs of a chunk, a refresh among them, read no tensor back to
    the host but the CPU optimizer's step counts (on the card the update
    kernel keeps its step count there), so the epoch can be captured as a
    CUDA graph."""
    NF, _ = train(3, bn_stats, epochs=3, preburn_time=1, stats_every=1)
    runner, k, init = NF._bench_chunk()
    with HostReads() as mode:
        runner.run(0, 2, init)
    steps = [state["step"] for state in runner.optimizer.state.values()]
    assert len(mode.reads) == 2 * len(steps)
    assert all(any(r is s for s in steps) for r in mode.reads)


@pytest.mark.parametrize("zeros", [0, 1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_prod_gradient_is_torchs(dtype, zeros):
    """The transforms' product over the last axis, whose gradient makes no
    host read, against ``torch.prod``'s bit for bit, with zeros too."""
    gen = torch.Generator().manual_seed(zeros)
    for shape in ((7, 3, 5), (9, 4), (6, 1)):
        x = torch.randn(shape, dtype=dtype, generator=gen)
        x.view(-1)[:zeros] = 0
        g = torch.randn(shape[:-1], dtype=dtype, generator=gen)
        a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
        ya, yb = torch.prod(a, dim=-1), coupling.prod(b)
        assert torch.equal(ya, yb)
        assert torch.equal(torch.autograd.grad(ya, a, g)[0], torch.autograd.grad(yb, b, g)[0])


def test_graphs_need_a_card():
    with pytest.raises(ValueError, match="CUDA graphs"):
        train(3, "stale", epochs=3, _graphs=True)


def _nf_tpu_chunked_latents(key, n_flow, mb, n_mb, epochs, k0, stats_every=None):
    """The latents nf_tpu's chunked trainer draws from the manager key
    ``key``, in the order the port draws them: the initial estimate's
    ``n_flow`` batches of ``2 mb`` (manager.py:352-371), then per chunk a key
    from ``_next_key`` split into ``k0`` epoch keys (manager.py:604-605,
    796), per epoch its minibatches from ``split(ek, n_mb)`` (:469) and, when
    the stale trainer refreshes, the refresh batch from ``fold_in(ek, 777)``
    (:547).  The last chunk uses the first of its ``k0`` keys only."""
    out = []
    key, sub = jax.random.split(key)
    for k in jax.random.split(sub, n_flow):
        out.append(jax.random.uniform(k, (2 * mb, n_flow), jnp.float64))
    i = 0
    while i < epochs:
        key, sub = jax.random.split(key)
        for ek in jax.random.split(sub, k0)[:min(k0, epochs - i)]:
            out += [jax.random.uniform(k, (mb, n_flow), jnp.float64)
                    for k in jax.random.split(ek, n_mb)]
            if stats_every and i % stats_every == 0:
                out.append(jax.random.uniform(jax.random.fold_in(ek, 777), (mb, n_flow),
                                              jnp.float64))
            i += 1
    return collections.deque(np.array(a) for a in out)


@pytest.mark.parametrize("bn_stats,seed", [("batch", 1), ("stale", 1)])
def test_chunked_matches_nf_tpu_chunked(bn_stats, seed):
    """Both trainers chunked (4 epochs a chunk, the last cut to 2), from
    nf_tpu's initial weights and on the latents nf_tpu's chunked run draws,
    against that run: histories, the best epoch, the accumulators and the
    best model's map.  Preburn ends inside the first chunk; no stop.
    nf_tpu's stale trainer runs its kernel path (interpret mode), which the
    port follows; the stale maps run in float32 on both sides."""
    kw = dict(log=False, batch_size=512, epochs=10, mini_batch_size=256, preburn_time=2,
              kill_counter=100, pretty_progressbar=False, bn_stats=bn_stats, stats_every=3,
              integrate=True, epochs_per_sync=4)
    NFj = JPWQuadManager(n_flow=2, seed=seed, dtype=jnp.float64)
    NFj.create_model(2, 4, [3] * 3)
    NF = PWQuadManager(n_flow=2, seed=seed, dtype=torch.float64, device="cpu")
    NF.create_model(2, 4, [3] * 3)
    NF._model = interop.from_numpy(NF._flow, *jax.tree.map(np.asarray,
                                                           (NFj._params, NFj._bn_state)))
    NF.best_model = copy.deepcopy(NF._model)
    latents = _nf_tpu_chunked_latents(NFj._key, 2, 256, 2, 10, 4,
                                      3 if bn_stats == "stale" else None)
    sig_j, err_j = NFj._train_variance_forward_seq(
        camel_j, joptim.adamax(1e-2, 1e-4), _force_train_kernel=bn_stats == "stale", **kw)

    def uniform(shape):
        w = latents.popleft()
        assert w.shape == tuple(shape)
        return torch.from_numpy(w)

    NF._uniform = uniform
    sig, err = NF._train_variance_forward_seq(camel_t, toptim.adamax(1e-2, 1e-4), **kw)
    assert not latents
    rtol = 1e-9 if bn_stats == "batch" else 1e-5
    np.testing.assert_allclose(NF.history, NFj.history, rtol=rtol)
    assert NF.best_epoch == NFj.best_epoch > 2 and NF._last_epoch == 9
    np.testing.assert_allclose(NF._integ_hist, NFj._integ_hist, rtol=rtol)
    np.testing.assert_allclose([sig, err], [sig_j, err_j], rtol=rtol)
    w = np.random.RandomState(0).uniform(size=(512, 2))
    x_j, jac_j, _ = jmodel.forward(NFj._flow, *NFj.best_params, jnp.asarray(w), True)
    with torch.no_grad():
        x_t, jac_t = NF.best_model.frozen_forward(torch.from_numpy(w), True)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=100 * rtol, atol=1e-12)
    np.testing.assert_allclose(jac_t.numpy(), np.asarray(jac_j), rtol=100 * rtol)
