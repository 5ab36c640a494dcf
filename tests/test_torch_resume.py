"""The port's run logging, checkpoints and exact resume against nf_tpu.

In float64 on the CPU.  Within the port, on both trainers: a run stopped
after 8 epochs by ``save_training_state`` and resumed for 8 more (from a
path or a dict) repeats the uninterrupted 16-epoch run bit for bit.  Against
nf_tpu: from nf_tpu's initial weights and on its latents (replayed through
the manager's ``_uniform``), the port's resumed batch-statistics run and its
``MemoryLogger`` scalars equal nf_tpu's resumed run at
``epochs_per_sync=1``.  Then the checkpoint files, ``load_checkpoint``'s
metadata, and a resume into a manager built otherwise.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf_tpu_torch import PWQuadManager, interop
from nf_tpu_torch.training import metrics
from nf_tpu_torch.training import optimizers as toptim
from test_torch_manager import _nf_tpu_latents, camel_j, camel_t

torch.set_num_threads(1)

KW = dict(batch_size=512, mini_batch_size=256, preburn_time=3, kill_counter=100,
          pretty_progressbar=False, integrate=True, stats_every=3)


def _manager(seed=0, n_bins=4, dtype=torch.float64):
    NF = PWQuadManager(n_flow=2, seed=seed, dtype=dtype, device="cpu")
    NF.create_model(2, n_bins, [3] * 3)
    return NF


def _state(NF):
    return [t.clone() for m in (NF._model, NF.best_model) for t in m.state_dict().values()]


@pytest.mark.parametrize("how", ["path", "dict"])
@pytest.mark.parametrize("bn_stats", ["batch", "stale"])
def test_resume_equals_the_uninterrupted_run(tmp_path, bn_stats, how):
    kw = dict(KW, log=False, bn_stats=bn_stats)
    opt = toptim.adamax(2e-3, 1e-4)
    whole = _manager()
    r_whole = whole._train_variance_forward_seq(camel_t, opt, epochs=16, **kw)
    first = _manager()
    first._train_variance_forward_seq(camel_t, opt, epochs=8, **kw)
    path = tmp_path / "state.pt"
    first.save_training_state(path)
    resumed = _manager(seed=9)       # other initial weights and generator
    state = str(path) if how == "path" else resumed.load_training_state(path)
    r_resumed = resumed._train_variance_forward_seq(camel_t, opt, epochs=8, epoch_start=8,
                                                    resume_from=state, **kw)
    assert r_resumed == r_whole
    np.testing.assert_array_equal(resumed.history, whole.history)
    np.testing.assert_array_equal(resumed._integ_hist, whole._integ_hist)
    np.testing.assert_array_equal(resumed._err_hist, whole._err_hist)
    assert len(resumed.history) == 16 and len(resumed._integ_hist) == 17
    assert resumed.best_epoch == whole.best_epoch and resumed.best_ess == whole.best_ess
    for a, b in zip(_state(resumed), _state(whole)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


class Run(metrics.MemoryLogger):
    """A Sacred-style run: ``log_scalar`` and an ``_id``."""
    _id = 7


@pytest.fixture(scope="module")
def resumed_pair(tmp_path_factory):
    """nf_tpu's and the port's batch-statistics runs of 8 + 8 resumed
    epochs on the same initial weights and latents, each with a run logger
    and a logdir."""
    from nf_tpu import PWQuadManager as JPWQuadManager
    from nf_tpu.training import metrics as jmetrics
    from nf_tpu.training import optimizers as joptim

    tmp = tmp_path_factory.mktemp("resume")
    kw = dict(KW, log=True)
    NFj = JPWQuadManager(n_flow=2, seed=1, dtype=jnp.float64)
    NFj.create_model(2, 4, [3] * 3)
    params = jax.tree.map(np.asarray, (NFj._params, NFj._bn_state))
    latents = _nf_tpu_latents(NFj._key, 2, 256, 2, 16)
    run_j = jmetrics.MemoryLogger()
    opt_j = joptim.adamax(1e-2, 1e-4)
    NFj._train_variance_forward_seq(camel_j, opt_j, epochs=8, epochs_per_sync=1, run=run_j,
                                    logdir=str(tmp / "j"), **kw)
    NFj.save_training_state(str(tmp / "j.msgpack"))
    NFj._train_variance_forward_seq(camel_j, opt_j, epochs=8, epoch_start=8, epochs_per_sync=1,
                                    resume_from=str(tmp / "j.msgpack"), run=run_j,
                                    logdir=str(tmp / "j"), **kw)

    def uniform(shape):
        w = latents.popleft()
        assert w.shape == tuple(shape)
        return torch.from_numpy(w)

    run_t = Run()
    opt_t = toptim.adamax(1e-2, 1e-4)
    NF = _manager(seed=1)
    NF._model = interop.from_numpy(NF._flow, *params)
    NF.best_model = copy.deepcopy(NF._model)
    NF._uniform = uniform
    NF._train_variance_forward_seq(camel_t, opt_t, epochs=8, run=run_t, logdir=str(tmp / "t"),
                                   **kw)
    NF.save_training_state(tmp / "t.pt")
    NF2 = _manager(seed=4)
    NF2._uniform = uniform
    NF2._train_variance_forward_seq(camel_t, opt_t, epochs=8, epoch_start=8,
                                    resume_from=tmp / "t.pt", run=run_t,
                                    logdir=str(tmp / "t"), **kw)
    assert not latents
    return NFj, run_j, NF2, run_t, tmp


def test_resumed_run_matches_nf_tpu(resumed_pair):
    NFj, _, NF, _, _ = resumed_pair
    rtol = 1e-10
    np.testing.assert_allclose(NF.history, NFj.history, rtol=rtol)
    np.testing.assert_allclose(NF._integ_hist, NFj._integ_hist, rtol=rtol)
    np.testing.assert_allclose(NF._err_hist, NFj._err_hist, rtol=rtol)
    np.testing.assert_allclose([NF.integ_tot, NF.err_tot, NF.best_loss, NF.int_loss],
                               [NFj.integ_tot, NFj.err_tot, NFj.best_loss, NFj.int_loss],
                               rtol=rtol)
    assert NF.best_epoch == NFj.best_epoch and NF.best_func_count == NFj.best_func_count
    assert len(NF.history) == 16


def test_logger_scalars_match_nf_tpu(resumed_pair):
    _, run_j, _, run_t, _ = resumed_pair
    assert sorted(run_t.scalars) == sorted(run_j.scalars) == [
        "training.err", "training.int_loss", "training.integ", "training.loss",
        "training.loss_rel"]
    for name, entries in run_j.scalars.items():
        mine = run_t.scalars[name]
        assert [s for s, _ in mine] == [s for s, _ in entries], name
        np.testing.assert_allclose([v for _, v in mine], [v for _, v in entries], rtol=1e-10)
    # one int_loss (the resume skips phase A), one loss per epoch, one
    # integ / err per call
    assert [s for s, _ in run_t.scalars["training.loss"]] == list(range(16))
    assert len(run_t.scalars["training.int_loss"]) == 1
    assert len(run_t.scalars["training.integ"]) == 2


def test_checkpoint_files(resumed_pair):
    _, _, NF, run_t, tmp = resumed_pair
    assert sorted(os.listdir(tmp / "t")) == ["7"]
    assert sorted(os.listdir(tmp / "t" / "7")) == ["torch", "torch_int"]
    # without a run id, the files go into logdir itself
    NF3 = _manager()
    NF3._train_variance_forward_seq(camel_t, toptim.adamax(1e-3), epochs=2, log=True,
                                    logdir=str(tmp / "plain"), run=metrics.MemoryLogger(),
                                    batch_size=256, mini_batch_size=256,
                                    pretty_progressbar=False)
    assert sorted(os.listdir(tmp / "plain")) == ["torch", "torch_int"]
    # log=False writes nothing
    NF3._train_variance_forward_seq(camel_t, toptim.adamax(1e-3), epochs=1, log=False,
                                    logdir=str(tmp / "none"), batch_size=256,
                                    mini_batch_size=256, pretty_progressbar=False)
    assert not os.path.exists(tmp / "none")


def test_load_checkpoint_returns_meta_and_the_best_model(resumed_pair):
    _, _, NF, _, tmp = resumed_pair
    fresh = _manager(seed=11)
    meta = fresh.load_checkpoint(tmp / "t" / "7" / "torch")
    assert meta == {"best_epoch": NF.best_epoch, "best_loss": NF.best_loss,
                    "int_loss": NF.int_loss, "best_loss_rel": NF.best_loss_rel,
                    "best_func_count": float(NF.best_func_count), "integ": NF.integ_tot,
                    "err": NF.err_tot}
    for a, b in zip(fresh.best_model.state_dict().values(), NF.best_model.state_dict().values()):
        assert torch.equal(a, b)
    for method in ("folded", "fused"):
        assert fresh.integrate(camel_t, 2, 500, seed=3, method=method) == \
            NF.integrate(camel_t, 2, 500, seed=3, method=method)
    assert fresh.load_checkpoint(tmp / "t" / "7" / "torch_int") == {}


@pytest.mark.parametrize("other", [{"n_bins": 5}, {"dtype": torch.float32}])
def test_resume_into_another_manager_raises(tmp_path, other):
    NF = _manager()
    NF._train_variance_forward_seq(camel_t, toptim.adamax(1e-3), epochs=2, log=False,
                                   batch_size=256, mini_batch_size=256,
                                   pretty_progressbar=False)
    NF.save_training_state(tmp_path / "s.pt")
    with pytest.raises(ValueError, match="plan" if "n_bins" in other else "dtype"):
        _manager(**other)._train_variance_forward_seq(
            camel_t, toptim.adamax(1e-3), epochs=2, epoch_start=2, log=False,
            batch_size=256, mini_batch_size=256, pretty_progressbar=False,
            resume_from=tmp_path / "s.pt")
