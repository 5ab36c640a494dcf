"""Managers: model factory + variance-loss trainer + MC integrator.

Counterpart of ``nf_tpu.training.manager`` (reference
normalizing_flows/manager.py).  The model is a :class:`FlowModel` trained by
torch autograd; the best-model snapshot is a deep copy of it, taken after the
optimizer step (reference quirk, manager.py:280,297).  Loss-mode semantics,
preburn, ``maxf`` normalization, the early-stop state machine, the tail
integration and the inverse-variance combination replicate nf_tpu, which
replicates the reference.  Variances are *unbiased* throughout (torch.var).

The trainer runs at nf_tpu's two cadences.  ``epochs_per_sync="auto"``
(the default, as nf_tpu's) or an int ``k > 1`` runs chunks of ``k`` epochs
to one host read (``"auto"``: ``k`` = the stale check's period,
``preburn_time`` if above 10, else 50), with the state machine on the device
(:mod:`nf_tpu_torch.training.chunk`).  On the card without a mesh each epoch
and each statistics refresh is a replayed CUDA graph, so the integrand ``f``
must be capturable there, as nf_tpu's must be jittable: no host read, no
host-to-device copy.  The optimizer's step there is the update kernel
(:func:`~nf_tpu_torch.training.optimizers.device_step`), which gives torch's
per-epoch step's bits; an optimizer it does not cover is made capturable.
On the CPU and under ``mesh`` the chunk runs eagerly (NCCL is not
captured), every decision read from all-reduced values.  The host replays
its state machine over each chunk's rows (bookkeeping, logging,
``progress_callback`` and the progress bar per epoch, at chunk cadence) and
raises ``RuntimeError`` where the two disagree.  A stop inside a chunk, by
the kill counter or the host's stale check, replays the chunk from its start
up to the stop epoch, so the model, the optimizer, the best snapshot and the
generator are those of the stop.  A chunk draws its latents in the per-epoch
order, so chunking changes no number: a chunked run equals the per-epoch run
bit for bit, on the CPU and on the card (nf_tpu's chunk draws other latents,
through its key split).  ``epochs_per_sync=1`` is the per-epoch cadence: one
host sync per epoch, for the scalars the host state machine needs, and no
graph.

``bn_stats="stale"`` is nf_tpu's stale-statistics trainer: within an epoch
BatchNorm is folded into the weights with the running statistics held fixed
(:mod:`nf_tpu_torch.ops.pwquad_train`), so the forward and backward of every
minibatch are one launch each of the training kernels on a CUDA device; every
``stats_every`` epochs the running statistics are refreshed from the forward
kernel's batch sums.  nf_tpu refreshes them in two ways: from those sums on
its kernel path (``_force_train_kernel=True`` or a TPU), and from a train-mode
forward on its CPU fallback, whose hidden layers then see batch-normalised
activations upstream.  The input BatchNorm statistics agree; the hidden
layers' differ.  The port follows the kernel path on every device: its CPU
trainer runs the kernels' plain versions, and is held against nf_tpu's
kernel-path semantics.

``select_best_by="ess"`` snapshots the best model by the epoch's
effective-sample fraction E[w]^2 / E[w^2] instead of the least loss.
``integrate(method="qmc")`` is randomized quasi-Monte-Carlo
(:mod:`nf_tpu_torch.utils.qmc`).

Run logging and checkpoints follow nf_tpu: a ``run`` object receives
``run.log_scalar(name, value, step)`` calls (:mod:`nf_tpu_torch.training
.metrics`); with ``log`` and ``logdir`` the trainer writes ``torch_int`` at
the start and ``torch`` (the best model and its metadata) at the end into
``logdir/<run._id>``.  :meth:`BasicManager.save_training_state` and
``resume_from`` stop and continue a run exactly.  All files are
``torch.save`` files written by :mod:`nf_tpu_torch.utils.checkpoint`; nf_tpu
cannot read them, nor the port nf_tpu's.

``mesh`` (a 1-D ``"dp"`` mesh, :mod:`nf_tpu_torch.parallel`) makes the
trainer, ``sample`` and ``integrate`` data-parallel: every rank draws each
global batch from its generator (seeded alike), maps its own rows, and the
losses, statistics and BatchNorm moments are all-reduced; the gradients are
averaged across ranks, so the parameters stay replicated.  The reductions
are the same sums with or without a mesh, so a world of one gives the bits
of the single-device run.  The stale trainer refreshes its statistics from
the forward kernel's all-reduced batch sums on every world size (nf_tpu
refreshes from a train-mode forward under a mesh).  Only the first rank
writes files.

Spans (:mod:`nf_tpu_torch.utils.profiling`): ``nf.create_model`` builds
the model; ``nf.sample`` and
``nf.integrate`` are the calls (with ``nf.fold``, ``nf.read.seed``,
``nf.integrate.iterations`` and ``nf.read.result`` inside); ``nf.train`` is
the trainer's, with ``nf.train.first_estimate`` (phase A),
``nf.train.setup`` (the optimizer, the update's tables, the epoch runner
and the chunk runner), per epoch ``nf.train.epoch`` or per chunk
``nf.chunk.run`` (:mod:`~nf_tpu_torch.training.chunk`), the rows' read
``nf.read.epoch`` / ``nf.read.chunk``, the host state machine
``nf.train.host`` (a stop inside a chunk's ``nf.chunk.rerun`` in it) and
the tail integration ``nf.train.tail``.
"""

from __future__ import annotations

import copy
import math
import os
import time

import numpy as np
import torch

from nf_tpu_torch.flows import factory
from nf_tpu_torch.flows import sampling as fsampling
from nf_tpu_torch.ops import pwquad_train
from nf_tpu_torch.parallel import sampling as psampling
from nf_tpu_torch.parallel.dp import (all_reduce_max, all_reduce_sum, average_gradients,
                                      broadcast_replicas, global_mean, global_mean_var)
from nf_tpu_torch.parallel.mesh import group_of, rank_and_size, shard_rows
from nf_tpu_torch.training import chunk as tchunk
from nf_tpu_torch.training.optimizers import device_step, set_capturable
from nf_tpu_torch.utils import checkpoint, profiling


def _pick(pre, a, b):
    """``a`` where ``pre`` else ``b``: ``torch.where`` for a 0-dim bool
    tensor, the branch itself for a bool."""
    if torch.is_tensor(pre):
        return torch.where(pre, a, b)
    return a if pre else b


def epoch_step(model, optimizer, f, ws, preburn, maxf, loss_mode: str,
               pathwise: bool = False, forward=None, group=None):
    """One training epoch on the minibatches of latents ``ws``: the loss
    gradients of all minibatches, averaged, then one optimizer step.
    ``forward(w) -> (x, jac)`` maps a minibatch; the default is the model's
    train-mode forward, which moves the BatchNorm buffers.

    Under data parallelism ``ws`` are this rank's rows of the minibatches
    and ``group`` the process group: every mean and variance is the global
    batch's, from all-reduced sums (:func:`~nf_tpu_torch.parallel.dp
    .global_mean_var`, two all-reduces a minibatch and their two in the
    backward), and the gradients are averaged across ranks.

    ``preburn`` is a bool or a 0-dim bool tensor on the latents' device:
    the preburn and the normal loss are one expression whose branches
    :func:`_pick` chooses, for a tensor with ``torch.where`` on the device,
    so a chunk of epochs runs with no host branch
    (:mod:`nf_tpu_torch.training.chunk`), for a bool on the host with no
    launch (the per-epoch trainer).  ``f`` runs once, on the points picked;
    a branch not taken adds nothing but zeros.

    Returns a tensor ``[loss, var, integ, err, ess]`` (still on the device),
    ``ess = mean(fres)^2 / mean(fres^2)`` over the minibatches.  Counterpart
    of the epoch body of nf_tpu's trainer (training/manager.py:466-564).
    """
    if forward is None:
        def forward(w):
            return model(w, True, group)
    mb = ws[0].shape[0] * rank_and_size(group)[1]
    optimizer.zero_grad(set_to_none=True)
    ls, iis, eis, vis, qis = [], [], [], [], []
    for w in ws:
        x, jacv = forward(w)
        # preburn: the loss on LATENT points, f(w) J, flattens J against f
        # before the map moves (reference manager.py:237-242); else f(x) J,
        # the sample detached as the reference does, so the gradient flows
        # through J only; pathwise also differentiates f(x)
        g = f(_pick(preburn, w, x if pathwise else x.detach()))
        gj = g * jacv
        fXJ = gj / maxf
        fres = _pick(preburn, g, gj)
        if loss_mode == "var":
            head = fXJ
        elif loss_mode == "kl":
            # reweighted forward KL: -E_w[w_tilde log q(x)], log q = -log J;
            # kl mode keeps the variance loss during preburn: KL losses are
            # negative, which would confuse the ratio-based preburn exit
            head = _pick(preburn, fXJ, fXJ.detach() * torch.log(torch.clamp_min(jacv, 1e-30)))
        else:
            head = (fXJ * maxf) ** 2
        fres, fXJ = fres.detach(), fXJ.detach()
        means, var = global_mean_var(torch.stack([head, fres, fXJ ** 2, fres ** 2]), group)
        loss = var[0] if loss_mode == "var" else \
            _pick(preburn, var[0], means[0]) if loss_mode == "kl" else means[0]
        loss.backward()
        ls.append(loss.detach())
        iis.append(means[1].detach())
        eis.append(var[1].detach())
        vis.append(var[2].detach() / mb)
        qis.append(means[3].detach())
    average_gradients(model.parameters(), group, len(ws))
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    mean_w = torch.mean(torch.stack(iis))
    ess = mean_w ** 2 / torch.clamp_min(torch.mean(torch.stack(qis)), 1e-300)
    return torch.stack([torch.mean(torch.stack(ls)), torch.sum(torch.stack(vis)),
                        mean_w, torch.mean(torch.stack(eis)), ess])


def stale_forward(plan, model):
    """``forward(w) -> (x, jac)`` of the stale-statistics trainer: the model
    folded with its running statistics, mapped by :class:`FusedTrain` in
    float32 and cast back to the latents' dtype (nf_tpu manager.py:472-481)."""
    def forward(w):
        flat = pwquad_train.fold_flow(model)
        x, jac = pwquad_train.fused_train(plan, flat, w.to(torch.float32))
        return x.to(w.dtype), jac.to(w.dtype)
    return forward


def refresh_bn_stats(plan, model, w, group=None):
    """Move ``model``'s running statistics by one EMA step from the forward
    kernel's batch sums over the latents ``w``, with the model folded as it
    now is (nf_tpu manager.py:544-555, its kernel path).  Under data
    parallelism ``w`` is this rank's rows: the sums are all-reduced and
    divided by the global count."""
    with torch.no_grad():
        stats = pwquad_train.train_forward(plan, pwquad_train.fold_flow(model),
                                           w.to(torch.float32), with_stats=True)[3]
        pwquad_train.stats_to_bn_state(model, all_reduce_sum(stats, group),
                                       w.shape[0] * rank_and_size(group)[1])


class BasicManager:
    """Training and integration engine (reference manager.py:52-405).

    ``device`` is where the model, the latents and the generator live: the
    card (``"cuda"``, the default) unless the caller asks for ``"cpu"``.
    Without a CUDA device, a manager on the card raises instead of falling
    back to the CPU.  ``dtype`` is the model's float type.
    """

    def __init__(self, n_flow=2, seed=0, dtype=torch.float32, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{type(self).__name__}: no CUDA device for device="
                               f"{device!r}; pass device='cpu' to run on the CPU")
        self.n_flow = n_flow
        self.dtype = dtype
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._flow = None
        self._model = None
        self.best_model = None
        self.best_loss = None
        self.best_eval_mode = False      # see the tail integration below
        self._group = None               # the last run's process group (mesh)

    @property
    def model(self):
        if self._flow is not None:
            return self._flow
        raise AttributeError("No model was instantiated")

    def _uniform(self, shape):
        return torch.rand(shape, generator=self._gen, dtype=self.dtype,
                          device=self.device)

    def _generator(self, seed):
        if seed is None:
            return self._gen
        return torch.Generator(device=self.device).manual_seed(seed)

    def _resolve_method(self, method, train):
        """The draw of ``sample`` and ``integrate``:
        :func:`~nf_tpu_torch.flows.sampling.resolve_method` on the manager's
        device, train-mode BatchNorm asked for by ``train=True``."""
        return fsampling.resolve_method(self._flow, self.device, method, train is True)

    @profiling.spanned("nf.sample")
    def sample(self, n, seed=None, model=None, train=None, method=None,
               mesh=None):
        """Draw ``n`` latent points and map them: returns ``(x, jac)``.

        ``train=None`` follows the reference best-model mode: batch-stats
        BatchNorm unless a tail-integration phase flipped the best model to
        eval.  ``model`` defaults to the best model; ``seed`` to the
        manager's generator.

        ``mesh`` shards the draw over the mesh's ``"dp"`` axis
        (:func:`~nf_tpu_torch.parallel.sampling.make_dp_sampler`: the fused
        kernel per rank on the card, each rank at its own Philox counter
        offset) and returns the global arrays on every rank, the bits of the
        single-device draw on the fused path.  It is eval-mode only:
        ``train=True`` and ``method="reference"`` raise ``ValueError``.
        """
        model = self.best_model if model is None else model
        if mesh is not None:
            if train:
                raise ValueError("mesh= sharded sampling is eval-mode only; train=True needs "
                                 "a single replica's batch statistics")
            fn = psampling.make_dp_sampler(self._flow, model, mesh, n, method,
                                           dtype=self.dtype)
            return fn(self._generator(seed))
        method = self._resolve_method(method, train)
        train = (not self.best_eval_mode) if train is None else train
        start = fsampling.make_draw(self._flow, model, method, n, train=bool(train),
                                    dtype=self.dtype)
        return start(self._generator(seed))(0)

    # -- the trainer (reference manager.py:66-378) --------------------------

    @staticmethod
    def _epoch_runner(model, optimizer, uniform, f, maxf, loss_mode, pathwise, plan,
                      stats_batch, group):
        """``(train, refresh)``: ``train(preburn, ws) -> [loss, var, integ, err,
        ess]`` is one epoch's step on the global minibatches ``ws``, the
        batch-statistics one or with a :class:`TrainPlan` the stale one;
        ``refresh()`` moves the stale trainer's running statistics on latents
        drawn by ``uniform(shape)`` (nf_tpu manager.py:540-560), ``None`` for
        the batch trainer.  Under a process ``group`` each rank takes its rows
        of every batch."""
        forward = None if plan is None else stale_forward(plan, model)

        def train(preburn, ws):
            ws = [shard_rows(w, group) for w in ws]
            return epoch_step(model, optimizer, f, ws, preburn, maxf, loss_mode, pathwise,
                              forward, group)

        if plan is None:
            return train, None

        def refresh():
            w = uniform((stats_batch, model.flow.n_flow))
            refresh_bn_stats(plan, model, shard_rows(w, group), group)
        return train, refresh

    @staticmethod
    def _epoch(train, refresh, stats_every, i, preburn, ws):
        """Epoch ``i`` at the per-epoch cadence: the step, then the refresh
        when ``i % stats_every == 0``."""
        stats = train(preburn, ws)
        if refresh is not None and i % stats_every == 0:
            refresh()
        return stats

    @profiling.spanned("nf.train")
    def _train_variance_forward_seq(self, f, optimizer_object, log=True,
                                    logdir=None, batch_size=10000, epochs=10,
                                    epoch_start=0, pretty_progressbar=True,
                                    save_best=True, run=None, dev=0,
                                    mini_batch_size=2000, integrate=False,
                                    preburn_time=75, kill_counter=7,
                                    impr_ratio=1e-2, loss_mode="var",
                                    seed=None, mesh=None, pathwise=False,
                                    epochs_per_sync="auto", select_best_by="loss",
                                    resume_from=None, progress_callback=None,
                                    bn_stats="batch", stats_every=4, _graphs=None):
        """Train with the integrand variance as loss; the Jacobian comes from
        the forward pass and the gradient flows through it only, unless
        ``pathwise``, which also differentiates ``f(x)``.

        ``f(x: [B, n_flow]) -> [B]`` takes and returns tensors.
        ``optimizer_object`` is a factory ``make(params)`` such as
        :func:`nf_tpu_torch.training.optimizers.adamax`.  ``dev`` (the
        reference's device index, between ``run`` and ``mini_batch_size``) is
        accepted and ignored: the device is the constructor's.  ``bn_stats="stale"``
        trains with the running statistics fixed within each epoch and
        refreshed every ``stats_every`` epochs (module docstring).
        ``select_best_by="ess"`` snapshots the epoch of the largest
        effective-sample fraction instead of the least loss.  ``mesh``
        trains data-parallel (module docstring): the minibatch and the
        statistics batch must divide by the mesh size (else ``ValueError``),
        and the first rank's parameters, buffers and generator state are
        broadcast to the others at the start.  ``epochs_per_sync``:
        ``"auto"`` (the default, nf_tpu's), an int ``k > 1`` or 1, the
        per-epoch cadence (module docstring); an int below 1 counts as 1.  On
        the card without a mesh a chunk replays CUDA graphs, so ``f`` must be
        capturable; a capture that fails raises, and ``epochs_per_sync=1``
        trains without graphs.  ``_graphs`` (tests) overrides where the chunk
        replays CUDA graphs: ``False`` runs it eagerly on the card, with the
        same update kernel.  Returns ``(integral, error)``
        when ``integrate`` else ``(0, 0)``.
        """
        if bn_stats not in ("batch", "stale"):
            raise ValueError(f"unknown bn_stats {bn_stats!r}")
        if select_best_by not in ("loss", "ess"):
            raise ValueError(f"unknown select_best_by {select_best_by!r}")
        if loss_mode not in ("var", "est", "kl"):
            print("Unknown loss function")
            return
        if seed is not None:
            self._gen.manual_seed(seed)
        model = self._model
        n_flow = self.n_flow
        self._group = group = group_of(mesh)
        broadcast_replicas([model], group, self._gen)
        if log and logdir is not None and rank_and_size(group)[0] == 0:
            # reference manager.py:101-109: the stub checkpoint at the start
            self._save_checkpoint_stub(logdir, run)

        check_time = preburn_time if preburn_time > 10 else 50
        mini_batch_size = min(mini_batch_size, batch_size)
        n_minibatches = int(batch_size / mini_batch_size)
        batch_size = batch_size - (batch_size % mini_batch_size)

        rs = None
        epoch_offset = epoch_start
        if resume_from is not None:
            rs = resume_from if isinstance(resume_from, dict) \
                else self.load_training_state(resume_from)
            epoch_offset = int(rs["meta"]["epoch_offset"])
        # the histories span every epoch since the first run's start
        # (nf_tpu manager.py:332-344)
        need = epoch_start + epochs - epoch_offset + 1
        integ = np.zeros(need)
        err = np.zeros(need)
        if rs is None:
            maxf = self._phase_a(f, mini_batch_size, batch_size, loss_mode,
                                 save_best or log, integ, err)
            if run is not None and log:
                run.log_scalar("training.int_loss", self.best_loss, 0)
            self.int_loss = self.best_loss
        else:
            # exact resume: skip phase A, restore everything
            maxf = self._restore(rs)
            n_old = min(len(rs["integ"]), need)
            integ[:n_old] = np.asarray(rs["integ"])[:n_old]
            err[:n_old] = np.asarray(rs["err"])[:n_old]

        auto = epochs_per_sync == "auto"
        chunked = auto or int(epochs_per_sync) > 1
        on_card = self.device.type == "cuda" and group is None
        graphs = chunked and (on_card if _graphs is None else _graphs)
        if graphs and not on_card:
            raise ValueError("the chunk replays CUDA graphs on a CUDA device without a mesh only")
        with profiling.span("nf.train.setup"):
            optimizer = optimizer_object(model.parameters())
            if rs is not None:
                optimizer.load_state_dict(rs["opt"])
            # a chunk on the card steps through the update kernel (device_step
            # takes parameters on a CUDA device only); an optimizer it does not
            # cover is made capturable
            stepper = device_step(optimizer, epochs) if chunked and group is None else None
            set_capturable(optimizer, chunked and on_card and stepper is None)
            epoch_cfg = {"f": f, "maxf": maxf, "loss_mode": loss_mode, "pathwise": pathwise,
                         "plan": pwquad_train.TrainPlan(self._flow) if bn_stats == "stale"
                         else None,
                         # the refresh's bounded batch (nf_tpu manager.py:464)
                         "stats_batch": min(mini_batch_size, 1 << 16), "group": group}
            train, refresh = self._epoch_runner(model, stepper or optimizer, self._uniform,
                                                **epoch_cfg)
            by_ess = select_best_by == "ess"
            chunk_cfg = None
            if chunked:
                chunk_cfg = {"n_minibatches": n_minibatches, "mini_batch_size": mini_batch_size,
                             "stats_every": stats_every, "preburn_time": preburn_time,
                             "kill_counter": kill_counter, "by_ess": by_ess, "graphs": graphs}
                k0 = max(min(check_time if auto else int(epochs_per_sync), epochs), 1)
                runner = tchunk.EpochChunk(model, optimizer, train, refresh, self._uniform,
                                           self._gen, stepper=stepper, **chunk_cfg)

        # ---- host-side epoch loop with the early-stop state machine
        # (reference manager.py:212-327)
        sm = {"stale_save": 1000.0, "preburner": preburn_time > 0,
              "counter": 0, "last_loss": 1000.0}
        self.best_ess = -math.inf
        if rs is not None:
            sm = dict(rs["meta"]["sm"])
            self.best_ess = rs["meta"]["best_ess"]
        t_start = time.time()
        epochs_end = epoch_start + epochs

        pbar = None
        if pretty_progressbar:
            try:
                from tqdm.auto import tqdm
                pbar = tqdm(total=epochs, leave=False,
                            desc="Loss: {0:.3e} | Epoch".format(0.0))
            except ImportError:
                pass

        def process_epoch(i, loss, var_val, integ_e, err_e, ess, snapshot):
            """Host state machine for one finished epoch (reference
            manager.py:282-327); ``snapshot()`` gives the best model to keep
            on an improvement.  Returns True to stop training."""
            integ[i - epoch_offset + 1] += integ_e
            err[i - epoch_offset + 1] += err_e
            if save_best or log:
                self.history.append(loss)
                self.best_func_count += batch_size
            if pbar is not None:
                pbar.set_description("Loss: {0:.3e} | Epoch".format(loss))
                pbar.update(1)
            if progress_callback is not None:
                done = i - epoch_start + 1
                elapsed = time.time() - t_start
                progress_callback({
                    "epoch": i, "epochs": epochs, "loss": loss,
                    "elapsed_s": elapsed,
                    "eta_s": elapsed / max(done, 1) * (epochs - done),
                })
            if run is not None and log:
                run.log_scalar("training.loss", loss, i)
                run.log_scalar("training.loss_rel", loss / self.int_loss, i)

            improved = ess > self.best_ess if by_ess else loss < self.best_loss
            if (save_best or log) and improved and not sm["preburner"]:
                self.best_ess = ess
                self.best_loss = loss
                self.best_var = var_val
                self.best_loss_rel = loss / self.int_loss
                # post-update snapshot (reference manager.py:280,297)
                self.best_model = snapshot()
                self.best_epoch = i
                self.best_time = time.time() - t_start

            if loss < sm["last_loss"]:
                sm["counter"] = 0
            else:
                sm["counter"] += 1
                if sm["counter"] > kill_counter and sm["preburner"]:
                    sm["counter"] = 0
                    sm["preburner"] = False
                elif sm["counter"] > kill_counter:
                    return True
            sm["last_loss"] = loss
            if (i % check_time == 0) and i > (preburn_time + 1) and \
                    loss_mode != "kl" and \
                    float(self.best_loss) / sm["stale_save"] > (1 - impr_ratio) \
                    and not sm["preburner"]:
                # (ratio-based staleness is meaningless for the negative KL
                # loss; kl mode stops via kill_counter/epochs instead)
                return True
            elif i % check_time == 0 and not sm["preburner"] and \
                    (self.best_loss < self.int_loss or i > 300):
                sm["stale_save"] = float(self.best_loss)
            if sm["preburner"] and ((loss < 0.25 * self.best_loss) or i > preburn_time):
                sm["preburner"] = False
            return False

        i = epoch_start - 1
        if not chunked:
            for i in range(epoch_start, epochs_end):
                with profiling.span("nf.train.epoch"):
                    ws = [self._uniform((mini_batch_size, n_flow)) for _ in range(n_minibatches)]
                    stats = self._epoch(train, refresh, stats_every, i, sm["preburner"], ws)
                with profiling.span("nf.read.epoch"):   # the epoch's sync
                    profiling.HOST_READS += 1
                    stats = stats.tolist()
                with profiling.span("nf.train.host"):
                    if process_epoch(i, *stats, lambda: copy.deepcopy(model)):
                        break
        else:
            next_i, stop = epoch_start, False
            while next_i < epochs_end and not stop:
                k = min(k0, epochs_end - next_i)
                init = (sm["preburner"], sm["counter"], sm["last_loss"],
                        self.best_ess if by_ess else self.best_loss, self.best_loss,
                        self.best_model)
                runner.save()
                rows = runner.run(next_i, k, init)
                with profiling.span("nf.read.chunk"):   # the chunk's one sync
                    profiling.HOST_READS += 1
                    rows = rows.tolist()
                with profiling.span("nf.train.host"):
                    snapshots = []
                    for j, row in enumerate(rows):
                        i = next_i + j
                        # the device ran the host's machine: any drift is a bug
                        # (nf_tpu manager.py:806-828)
                        if bool(row[5]) != sm["preburner"]:
                            raise RuntimeError(f"device/host preburn state diverged at epoch {i}")
                        stop = process_epoch(i, *row[:5], lambda: snapshots.append(i))
                        if stop:
                            break
                        if int(row[6]) != sm["counter"]:
                            raise RuntimeError(f"device/host kill counter diverged at epoch {i}: "
                                               f"device {int(row[6])} != host {sm['counter']}")
                    if stop and j < k - 1:
                        # a stop inside the chunk: run it again from its start
                        # up to the stop, so the state is the stop epoch's
                        with profiling.span("nf.chunk.rerun"):
                            runner.restore()
                            again = runner.run(next_i, j + 1, init)
                            with profiling.span("nf.read.rerun"):
                                profiling.HOST_READS += 1
                                again = again.tolist()
                        if not np.array_equal(again, rows[:j + 1], equal_nan=True):
                            raise RuntimeError(f"the replay of epochs {next_i}-{i} differs from "
                                               "their first run")
                    if snapshots:   # the last, after the replay: the runner's best
                        self.best_model = runner.best_model()
                    if stepper is not None:
                        stepper.write_steps()
                next_i += k

        if pbar is not None:
            pbar.close()
        # the resumable state (save_training_state)
        self._optimizer = optimizer
        self._maxf = maxf
        self._sm_state = dict(sm)
        self._epoch_offset = epoch_offset
        self._last_epoch = i
        self._bench = (optimizer, epoch_cfg, n_minibatches, mini_batch_size, batch_size,
                       stats_every, chunk_cfg and dict(chunk_cfg, k0=k0), stepper is not None)

        # ---- PHASE C: tail integration with the best model in eval mode
        # (reference manager.py:332-346; note the reference's asymmetric
        # integ/sqrt(mini_batch) + std scaling, replicated exactly)
        endpoint = i - epoch_offset + 1   # epochs actually run
        total = epochs_end - epoch_offset
        if integrate and endpoint < total - 1:
            best = self.best_model
            self.best_eval_mode = True    # reference flips best_model to eval
            with torch.no_grad(), profiling.span("nf.train.tail"):
                for s in range(endpoint, total):
                    means, stds = [], []
                    for _ in range(n_minibatches):
                        x, jacv = best(shard_rows(self._uniform((mini_batch_size, n_flow)),
                                                  group), False)
                        mean, var = global_mean_var((f(x) * jacv)[None], group)
                        means.append(mean[0])
                        stds.append(torch.sqrt(var[0]))
                    ie = torch.mean(torch.stack(means)) / math.sqrt(mini_batch_size)
                    ee = torch.mean(torch.stack(stds))
                    tail = torch.stack([ie, ee])
                    with profiling.span("nf.read.tail"):
                        profiling.HOST_READS += 1
                        ie, ee = tail.tolist()
                    integ[s + 1] += ie
                    err[s + 1] += ee
                    self.best_func_count += batch_size

        # ---- inverse-variance-weighted combination (reference
        # manager.py:349-350).  Entries with err == 0 (epochs that never
        # ran) are excluded: the reference would produce NaN there.
        mask = err > 0
        self.integ_tot = float(np.sum(integ[mask] / err[mask]) / np.sum(1.0 / err[mask]))
        self.err_tot = float(np.sqrt(1.0 / np.sum(1.0 / err[mask])))
        self._integ_hist = integ
        self._err_hist = err

        if run is not None and integrate:
            run.log_scalar("training.integ", self.integ_tot, 0)
            run.log_scalar("training.err", self.err_tot, 0)
        if log and logdir is not None and rank_and_size(group)[0] == 0:
            self._save_checkpoint(logdir, run)

        if integrate:
            return (self.integ_tot, self.err_tot)
        return (0, 0)

    @profiling.spanned("nf.train.first_estimate")
    def _phase_a(self, f, mini_batch_size, batch_size, loss_mode, snapshot, integ, err):
        """The initial estimate on raw uniform points (reference
        manager.py:139-167) into ``integ[0]``, ``err[0]`` and the manager's
        ``best_loss`` / ``best_var``; with ``snapshot``, the diagnostics and
        the initial best-model snapshot (reference manager.py:170-196),
        which move the BN buffers.  Returns ``maxf`` (a device scalar)."""
        n_flow, model, group = self.n_flow, self._model, self._group
        size = rank_and_size(group)[1]
        with torch.no_grad():
            zero = torch.zeros((), dtype=self.dtype, device=self.device)
            maxf, best_loss, best_var, integ0, err0 = zero, zero, zero, zero, zero
            for _ in range(n_flow):
                w = shard_rows(self._uniform((2 * mini_batch_size, n_flow)), group)
                fres = f(w)
                maxf = torch.maximum(maxf, all_reduce_max(torch.max(fres), group))
                g = fres / maxf
                means, var = global_mean_var(torch.stack([fres, g, g ** 2, fres ** 2]), group)
                integ0 = integ0 + means[0] / n_flow
                err0 = err0 + var[0] / n_flow
                if loss_mode == "var":
                    best_loss = best_loss + var[1] / n_flow
                else:
                    best_loss = best_loss + means[3] / n_flow
                best_var = best_var + var[2] / 2 * mini_batch_size
            first = torch.stack([integ0, err0, best_loss, best_var])
            with profiling.span("nf.read.first_estimate"):
                profiling.HOST_READS += 1
                integ[0], err[0], self.best_loss, self.best_var = first.tolist()
            if snapshot:
                x, jacv = model(w, True, group)
                varJ = global_mean(jacv ** 2, group)
                # torch KLDivLoss default 'mean' divides by numel = B * n_flow
                DKL = all_reduce_sum(torch.sum(w * (torch.log(w) - torch.log(x + 1e-45))),
                                     group) / (w.numel() * size)
                with profiling.span("nf.read.first_estimate"):
                    profiling.HOST_READS += 2
                    self.varJ, self.DKL = float(varJ), float(DKL)
                self.best_model = copy.deepcopy(model)
                self.best_epoch = 0
                self.best_time = 0
                self.best_loss_rel = 1.0
                self.best_func_count = 2 * batch_size * n_flow
                self.history = []
        return maxf

    def benchmark_train_step(self, reps=5):
        """Time the last training run's epoch, warm: ``(seconds_per_epoch,
        train_samples_per_sec)``, the median of ``reps`` after one warm-up.

        It runs on deep copies of the model and the optimizer, and draws its
        latents from a generator of its own, so the trained state and the
        manager's stream are untouched; it keeps the run's batch sizes, loss
        and BatchNorm mode, outside preburn.  After a per-epoch run one timed
        rep is ``stats_every`` epochs for the stale trainer, so it holds one
        statistics refresh, and one epoch otherwise.  After a chunked run it
        is one chunk of the run's length, as nf_tpu times its chunk: on the
        card ``k`` replays of the epoch graph (the refreshes among them) and
        the chunk's one read; the warm-up captures the graphs.  On a CUDA
        device the time is between CUDA events; on the CPU it is the host
        clock.  Counterpart of nf_tpu's ``benchmark_train_step``
        (manager.py:902-965), without its dispatch-latency differencing.
        """
        _, _, n_mb, mb, batch_size, stats_every, chunk_cfg, _ = self._bench
        if chunk_cfg is None:
            _, _, _, train, refresh, uniform, _ = self._bench_copy()
            k = 1 if refresh is None else stats_every

            def rep():
                for i in range(k):
                    ws = [uniform((mb, self.n_flow)) for _ in range(n_mb)]
                    self._epoch(train, refresh, stats_every, i, False, ws).tolist()
        else:
            runner, k, init = self._bench_chunk(chunks=reps + 1)

            def rep():
                runner.run(0, k, init).tolist()

        cuda = self.device.type == "cuda"
        rep()
        times = []
        for _ in range(reps):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                rep()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3 / k)
            else:
                t0 = time.perf_counter()
                rep()
                times.append((time.perf_counter() - t0) / k)
        sec = float(np.median(times))
        return sec, batch_size / sec

    def _bench_copy(self, seed=1234, steps=None):
        """The last run's epoch on deep copies of its model and optimizer,
        drawing from a generator of its own seeded with ``seed``: ``(model,
        optimizer, stepper, train, refresh, uniform, generator)``
        (:meth:`_epoch_runner`).  Where the run stepped through the update
        kernel, so does the copy, through ``stepper``, a
        :class:`~nf_tpu_torch.training.optimizers.DeviceStep` of its own for
        ``steps`` more steps; else ``stepper`` is ``None``."""
        optimizer, cfg = self._bench[:2]
        # one deepcopy of both keeps the optimizer bound to the copied model
        model, optimizer = copy.deepcopy((self._model, optimizer))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        stepper = device_step(optimizer, steps) if self._bench[7] else None

        def uniform(shape):
            return torch.rand(shape, generator=gen, dtype=self.dtype, device=self.device)

        return (model, optimizer, stepper,
                *self._epoch_runner(model, stepper or optimizer, uniform, **cfg), uniform, gen)

    def _bench_chunk(self, seed=1234, chunks=2):
        """A chunked run's chunk on :meth:`_bench_copy`'s copies: ``(runner,
        k, init)``, the :class:`~nf_tpu_torch.training.chunk.EpochChunk` (on
        graphs where the run replayed them) for ``chunks`` runs, the run's
        chunk length and a state machine outside preburn."""
        cfg = dict(self._bench[6])
        k = cfg.pop("k0")
        model, optimizer, stepper, train, refresh, uniform, gen = self._bench_copy(seed,
                                                                                   k * chunks)
        runner = tchunk.EpochChunk(model, optimizer, train, refresh, uniform, gen,
                                   stepper=stepper, **cfg)
        best = self.best_ess if cfg["by_ess"] else self.best_loss
        return runner, k, (False, 0, 1000.0, best, self.best_loss, model)

    # -- post-training integrator (reference manager.py:380-405) ------------

    @profiling.spanned("nf.integrate")
    def integrate(self, f, nitn, neval, dev=None, seed=None, combine="iw", method=None,
                  mesh=None):
        """Post-training MC estimate: ``nitn`` iterations of ``neval``
        samples from the best model, combined by ``combine`` ("iw": the
        reference's inverse-variance weighting; "mean": plain mean with the
        pooled standard error).  ``dev`` (the reference's device index) is
        accepted and ignored: the device is the constructor's.

        On a CUDA device the default method is the fused kernel: one launch
        per iteration, each with its own range of the Philox counter, the
        integrand reading the kernel's dim-major output.  The per-iteration
        means and variances stay on the device; the result is read once.

        ``method="qmc"`` is randomized quasi-Monte-Carlo: ``nitn``
        Owen-scrambled Sobol replications of ``neval`` points (rounded up to
        a power of two) through the eval-mode map, whatever
        ``best_eval_mode`` says; the error is the standard error across
        replications and ``combine`` is ignored (:meth:`_integrate_qmc`).

        ``mesh`` shards the estimate over the mesh's ``"dp"`` axis
        (:func:`~nf_tpu_torch.parallel.sampling.make_dp_integrator`: each
        rank maps its rows of every iteration, the kernel on the card, and
        the iterations' sums are all-reduced).  It is eval-mode only
        (``method="reference"`` raises); for ``method="qmc"`` each rank runs
        its own replications (``nitn`` rounded up to a multiple of the mesh
        size, :func:`~nf_tpu_torch.parallel.sampling.make_dp_rqmc`).
        """
        if self.best_model is None:
            print("No model has been trained")
            return (0, 0)
        neval, nitn = int(neval), int(nitn)
        if method == "qmc":
            return self._integrate_qmc(f, nitn, neval, seed, mesh)
        if mesh is not None:
            fn = psampling.make_dp_integrator(self._flow, self.best_model, f, mesh, nitn, neval,
                                              method, self.dtype)
            means, variances = fn(self._generator(seed))
            return psampling.combine_iterations(means, variances, neval * nitn, combine)
        method = self._resolve_method(method, None)
        gen = self._generator(seed)
        model = self.best_model
        means, variances = [], []
        with torch.no_grad():
            # train: the reference never calls .eval()
            draw = fsampling.make_draw(self._flow, model, method, neval, layout="dim_major",
                                       train=not self.best_eval_mode, dtype=self.dtype)(gen)
            with profiling.span("nf.integrate.iterations"):
                for i in range(nitn):
                    x, jacv = draw(i)
                    fres = f(x) * jacv
                    means.append(torch.mean(fres))
                    variances.append(torch.var(fres))
            sig, sig_err = psampling.combine_iterations(torch.stack(means),
                                                        torch.stack(variances), neval * nitn,
                                                        combine)
        return (sig, sig_err)

    def _integrate_qmc(self, f, nitn, neval, seed, mesh=None):
        """RQMC through the best model's eval-mode map (nf_tpu
        manager.py:1011-1026, 1108-1137).  The base seed is ``seed``, else a
        draw from the manager's generator in [0, 2^31 - 1).  On a CUDA device
        the points come from :func:`~nf_tpu_torch.utils.qmc.make_device_sobol`
        and the map is the sampler kernel in operand mode, all replications
        without a host sync; elsewhere scipy's points go through the folded
        forward in the manager's dtype.  With ``mesh`` every rank maps its
        own replications of the device Sobol (nf_tpu manager.py:1139-1161),
        and the error is the standard error across all of them."""
        from nf_tpu_torch.utils import qmc

        base = seed if seed is not None else int(torch.randint(
            0, 2 ** 31 - 1, (1,), generator=self._gen, device=self.device))
        model = self.best_model
        with torch.no_grad():
            if fsampling.resolve_method(self._flow, self.device, None, eval_only=True) == "fused":
                from nf_tpu_torch.ops.pwquad_sampler import build_sampler
                forward = build_sampler(self._flow, model, take_latents=True)
            else:
                from nf_tpu_torch.flows.fast_eval import make_folded_forward
                fold = make_folded_forward(self._flow, model, self.dtype)

                def forward(w):
                    return fold(torch.as_tensor(w, device=self.device).to(self.dtype))

            def eval_mean(w):
                x, jacv = forward(w)
                return torch.mean(f(x) * jacv)

            if mesh is not None:
                fn = psampling.make_dp_rqmc(eval_mean, self.n_flow, nitn, neval, mesh,
                                            self.device)[0]
                sig, sig_err = qmc.rqmc_result(fn(base))
            elif self.device.type == "cuda":
                sig, sig_err, _ = qmc.rqmc_integrate_device(eval_mean, self.n_flow, nitn,
                                                            neval, base, self.device)
            else:
                sig, sig_err, _ = qmc.rqmc_integrate(
                    eval_mean, self.n_flow, nitn, neval, base,
                    dtype=np.float64 if self.dtype == torch.float64 else np.float32)
        return (sig, sig_err)

    # -- checkpoints (nf_tpu manager.py:1186-1311; the reference only saves,
    #    manager.py:358-369) --------------------------------------------------

    @staticmethod
    def _ckpt_dir(logdir, run=None):
        """The reference's layout (manager.py:88-98): ``logdir/<run._id>``
        when a Sacred-style run object with an id is attached, else
        ``logdir``."""
        if run is not None and getattr(run, "_id", None) is not None:
            return os.path.join(logdir, str(run._id))
        return logdir

    def _save_checkpoint_stub(self, logdir, run=None):
        """Write ``torch_int``, the initial model saved before any epoch runs
        (reference manager.py:101-109), so sweep tooling aimed at the
        reference layout finds the same files at the same times."""
        try:
            d = self._ckpt_dir(logdir, run)
            os.makedirs(d, exist_ok=True)
            model = self.best_model if self.best_model is not None else self._model
            checkpoint.save(os.path.join(d, "torch_int"),
                            {"model": model.state_dict(), "meta": {}})
        except Exception as e:  # the reference's guard
            print(f"Checkpoint save not possible: {e}")

    def _save_checkpoint(self, logdir, run=None):
        """Write ``torch``: the best model and nf_tpu's metadata.  nf_tpu
        also writes the same payload as ``checkpoint.msgpack``, the name of
        its flax file; the port writes no file under that name."""
        try:
            d = self._ckpt_dir(logdir, run)
            os.makedirs(d, exist_ok=True)
            checkpoint.save(os.path.join(d, "torch"), {
                "model": self.best_model.state_dict(),
                "meta": {
                    "best_epoch": self.best_epoch,
                    "best_loss": float(self.best_loss),
                    "int_loss": float(self.int_loss),
                    "best_loss_rel": float(self.best_loss_rel),
                    "best_func_count": float(self.best_func_count),
                    "integ": float(self.integ_tot),
                    "err": float(self.err_tot),
                },
            })
        except Exception as e:  # the reference's guard
            print(f"Checkpoint save not possible: {e}")

    def save_training_state(self, path):
        """Write the whole training state of the last run for an exact
        resume (``resume_from=path`` with ``epoch_start`` = the epochs run):
        the model and the best model (parameters and BN buffers), Adamax's
        state, the generator's state, ``maxf``, the integral and error
        histories and nf_tpu's metadata, the state machine included.  The
        plan and dtype are stored, and a resume into a manager built
        otherwise raises.  After a data-parallel run only the first rank
        writes."""
        if rank_and_size(self._group)[0] != 0:
            return
        checkpoint.save(path, {
            "plan": repr(self._flow),
            "dtype": str(self.dtype),
            "model": self._model.state_dict(),
            "best_model": self.best_model.state_dict(),
            "opt": self._optimizer.state_dict(),
            "generator": self._gen.get_state(),
            "maxf": self._maxf,
            "integ": self._integ_hist,
            "err": self._err_hist,
            "meta": {
                "best_loss": float(self.best_loss),
                "best_var": float(self.best_var),
                "best_ess": float(self.best_ess),
                "int_loss": float(self.int_loss),
                "best_loss_rel": float(self.best_loss_rel),
                "best_epoch": int(self.best_epoch),
                "best_time": float(getattr(self, "best_time", 0.0)),
                "best_func_count": float(self.best_func_count),
                "history": [float(h) for h in self.history],
                "varJ": getattr(self, "varJ", None),
                "DKL": getattr(self, "DKL", None),
                "sm": dict(self._sm_state),
                "last_epoch": int(self._last_epoch),
                "epoch_offset": int(self._epoch_offset),
            },
        })

    @staticmethod
    def load_training_state(path):
        """Read a :meth:`save_training_state` file (to pass as
        ``resume_from``)."""
        return checkpoint.load(path, None)

    def _restore(self, rs):
        """Load a training state into this manager, built as the one that
        saved it (else ``ValueError``); returns ``maxf``."""
        for key, mine in (("plan", repr(self._flow)), ("dtype", str(self.dtype))):
            if rs[key] != mine:
                raise ValueError(f"resume_from was saved with another {key}: "
                                 f"{rs[key]} != {mine}")
        meta = rs["meta"]
        self._model.load_state_dict(rs["model"])
        self.best_model = copy.deepcopy(self._model)
        self.best_model.load_state_dict(rs["best_model"])
        self._gen.set_state(rs["generator"])
        for name in ("best_loss", "best_var", "int_loss", "varJ", "DKL", "best_epoch",
                     "best_time", "best_loss_rel", "best_func_count"):
            setattr(self, name, meta[name])
        self.history = list(meta["history"])
        return torch.as_tensor(rs["maxf"], dtype=self.dtype, device=self.device)

    def load_checkpoint(self, path):
        """Load a ``torch`` / ``torch_int`` checkpoint into the model and the
        best model; returns its metadata (the reference has no restore)."""
        data = checkpoint.load(path, {"model": None, "meta": None})
        self._model.load_state_dict(data["model"])
        self.best_model = copy.deepcopy(self._model)
        return data["meta"]

    # -- warm-up forward (reference manager.py:592-598) ----------------------

    def _warmup(self, n=5):
        with torch.no_grad():
            self._model(self._uniform((n, self.n_flow)), True)

    def _set_model(self, model, identity_init, n_warmup):
        self._model = model
        self._flow = model.flow
        if identity_init:
            factory.identity_init(model)
        # the snapshot predates the warm-up's BN update, as in nf_tpu
        self.best_model = copy.deepcopy(model)
        self._warmup(n_warmup)


class AffineManager(BasicManager):
    """Affine coupling cells + roll layers (reference manager.py:411-453)."""

    @profiling.spanned("nf.create_model")
    def create_model(self, n_pass_through, n_cells, NN, roll_step, dev=None,
                     identity_init=False):
        """``dev``, the reference's device index, is ignored: the device is
        the constructor's."""
        self._set_model(factory.build_affine_flow(
            self._gen, self.n_flow, n_pass_through, n_cells, tuple(NN),
            roll_step, self.dtype, self.device), identity_init, 10)


class PWLinManager(BasicManager):
    """Piecewise-linear coupling cells + roll layers (reference manager.py:456-499)."""

    @profiling.spanned("nf.create_model")
    def create_model(self, n_pass_through, n_cells, n_bins, NN, roll_step,
                     dev=None, identity_init=False, final_rank=None, activation="exp"):
        """``dev``, the reference's device index, is ignored: the device is
        the constructor's."""
        self._set_model(factory.build_pwlin_flow(
            self._gen, self.n_flow, n_pass_through, n_cells, n_bins, tuple(NN),
            roll_step, self.dtype, self.device, final_rank=final_rank,
            activation=activation), identity_init, 5)


class PWQuadManager(BasicManager):
    """Piecewise-quadratic cells; masked partition for n_flow > 7
    (reference manager.py:502-600)."""

    @profiling.spanned("nf.create_model")
    def create_model(self, n_cells, n_bins, NN, dev=None, identity_init=False,
                     final_rank=None, activation="exp"):
        """``dev``, the reference's device index, is ignored: the device is
        the constructor's."""
        self._set_model(factory.build_pwquad_flow(
            self._gen, self.n_flow, n_cells, n_bins, tuple(NN), self.dtype,
            self.device, final_rank=final_rank, activation=activation),
            identity_init, 5)
