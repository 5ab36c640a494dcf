"""Managers: model factory + variance-loss trainer + MC integrator.

Counterpart of ``nf_tpu.training.manager`` (reference
normalizing_flows/manager.py).  The model is a :class:`FlowModel` trained by
torch autograd; the best-model snapshot is a deep copy of it, taken after the
optimizer step (reference quirk, manager.py:280,297).  Loss-mode semantics,
preburn, ``maxf`` normalization, the early-stop state machine, the tail
integration and the inverse-variance combination replicate nf_tpu, which
replicates the reference.  Variances are *unbiased* throughout (torch.var).

The trainer runs at the per-epoch cadence (nf_tpu's ``epochs_per_sync=1``):
one host sync per epoch, for the scalars the state machine needs.

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

Not ported yet, and refused with ``NotImplementedError``: ``mesh``,
``resume_from``, ``epochs_per_sync`` other than 1, and ``logdir`` / ``run``
logging and checkpoints.
"""

from __future__ import annotations

import copy
import math
import time

import numpy as np
import torch

from nf_tpu_torch.flows import factory
from nf_tpu_torch.flows import sampling as fsampling
from nf_tpu_torch.ops import pwquad_train


def _not_ported(name, value):
    raise NotImplementedError(f"{name}={value!r} is not ported to nf_tpu_torch yet")


def epoch_step(model, optimizer, f, ws, preburn: bool, maxf, loss_mode: str,
               pathwise: bool = False, forward=None):
    """One training epoch on the minibatches of latents ``ws``: the loss
    gradients of all minibatches, averaged, then one optimizer step.
    ``forward(w) -> (x, jac)`` maps a minibatch; the default is the model's
    train-mode forward, which moves the BatchNorm buffers.

    Returns a tensor ``[loss, var, integ, err, ess]`` (still on the device),
    ``ess = mean(fres)^2 / mean(fres^2)`` over the minibatches.  Counterpart
    of the epoch body of nf_tpu's trainer (training/manager.py:466-564).
    """
    if forward is None:
        def forward(w):
            return model(w, True)
    mb = ws[0].shape[0]
    optimizer.zero_grad(set_to_none=True)
    ls, iis, eis, vis, qis = [], [], [], [], []
    for w in ws:
        x, jacv = forward(w)
        if preburn:
            # loss on LATENT points: flattens J against f before the map
            # moves (reference manager.py:237-242)
            fres = f(w)
            fXJ = fres * jacv / maxf
        else:
            # the reference detaches the sample, so the gradient flows
            # through J only; pathwise also differentiates f(x)
            fres = f(x if pathwise else x.detach()) * jacv
            fXJ = fres / maxf
        if loss_mode == "var" or (loss_mode == "kl" and preburn):
            # kl mode keeps the variance loss during preburn: KL losses are
            # negative, which would confuse the ratio-based preburn exit
            loss = torch.var(fXJ)
        elif loss_mode == "kl":
            # reweighted forward KL: -E_w[w_tilde log q(x)], log q = -log J
            loss = torch.mean(fXJ.detach() * torch.log(torch.clamp_min(jacv, 1e-30)))
        else:
            loss = torch.mean((fXJ * maxf) ** 2)
        loss.backward()
        fres, fXJ = fres.detach(), fXJ.detach()
        ls.append(loss.detach())
        iis.append(torch.mean(fres))
        eis.append(torch.var(fres))
        vis.append(torch.var(fXJ ** 2) / mb)
        qis.append(torch.mean(fres ** 2))
    with torch.no_grad():
        for p in model.parameters():
            if p.grad is not None:
                p.grad.div_(len(ws))
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


def refresh_bn_stats(plan, model, w):
    """Move ``model``'s running statistics by one EMA step from the forward
    kernel's batch sums over the latents ``w``, with the model folded as it
    now is (nf_tpu manager.py:544-555, its kernel path)."""
    with torch.no_grad():
        stats = pwquad_train.train_forward(plan, pwquad_train.fold_flow(model),
                                           w.to(torch.float32), with_stats=True)[3]
        pwquad_train.stats_to_bn_state(model, stats, w.shape[0])


def stale_epoch_step(model, plan, optimizer, f, ws, preburn, maxf, loss_mode,
                     pathwise=False, refresh_w=None):
    """One epoch of the stale-statistics trainer: :func:`epoch_step` through
    :func:`stale_forward`, the BatchNorm statistics fixed, then, with
    ``refresh_w``, one :func:`refresh_bn_stats` after the optimizer step."""
    stats = epoch_step(model, optimizer, f, ws, preburn, maxf, loss_mode, pathwise,
                       stale_forward(plan, model))
    if refresh_w is not None:
        refresh_bn_stats(plan, model, refresh_w)
    return stats


def combine_iterations(means, variances, neval: int, nitn: int, combine: str):
    """Combine per-iteration means/variances (tensors ``[nitn]``) into
    ``(sig, sig_err)`` tensors.  ``"iw"``: the reference's inverse-variance
    weighting; ``"mean"``: the plain mean with the pooled standard error."""
    if combine == "mean":
        return torch.mean(means), torch.sqrt(torch.mean(variances) / (neval * nitn))
    if combine == "iw":
        sig = torch.sum(means / variances) / torch.sum(1.0 / variances)
        return sig, torch.sqrt(1.0 / torch.sum(1.0 / variances)) / math.sqrt(neval * nitn)
    raise ValueError(f"unknown combine {combine!r}; expected 'iw' or 'mean'")


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
        """``None`` / ``'auto'``: the fused kernel wherever
        :func:`~nf_tpu_torch.flows.sampling.default_method` picks it (a CUDA
        device, train mode not asked for); elsewhere the reference-parity
        stateful forward.  ``'stateful'`` is an alias of ``'reference'``."""
        if method in (None, "auto"):
            if fsampling.default_method(self._flow, self.device, train is True) == "fused":
                return "fused"
            return "reference"
        if method == "stateful":
            return "reference"
        if method not in ("fused", "folded", "reference"):
            raise ValueError(
                f"unknown sampling method {method!r}; expected one of "
                "None/'auto', 'fused', 'folded', 'reference'/'stateful'")
        return method

    def sample(self, n, seed=None, model=None, train=None, method=None,
               mesh=None):
        """Draw ``n`` latent points and map them: returns ``(x, jac)``.

        ``train=None`` follows the reference best-model mode: batch-stats
        BatchNorm unless a tail-integration phase flipped the best model to
        eval.  ``model`` defaults to the best model; ``seed`` to the
        manager's generator.
        """
        if mesh is not None:
            _not_ported("mesh", mesh)
        model = self.best_model if model is None else model
        method = self._resolve_method(method, train)
        if method == "reference":
            method = "stateful"
            train = (not self.best_eval_mode) if train is None else train
        fn = fsampling.make_sampler(self._flow, model, n, method,
                                    train=bool(train), dtype=self.dtype)
        return fn(self._generator(seed))

    # -- the trainer (reference manager.py:66-378) --------------------------

    @staticmethod
    def _epoch_runner(model, optimizer, uniform, f, maxf, loss_mode, pathwise, plan,
                      stats_every, stats_batch):
        """``run_epoch(i, preburn, ws) -> [loss, var, integ, err, ess]`` for global
        epoch ``i``: the batch-statistics step, or with a :class:`TrainPlan`
        the stale one, refreshing the statistics on latents drawn by
        ``uniform(shape)`` when ``i % stats_every == 0`` (nf_tpu
        manager.py:540-560)."""
        def run_epoch(i, preburn, ws):
            if plan is None:
                return epoch_step(model, optimizer, f, ws, preburn, maxf, loss_mode, pathwise)
            refresh_w = uniform((stats_batch, ws[0].shape[1])) if i % stats_every == 0 \
                else None
            return stale_epoch_step(model, plan, optimizer, f, ws, preburn, maxf, loss_mode,
                                    pathwise, refresh_w)
        return run_epoch

    def _train_variance_forward_seq(self, f, optimizer_object, log=True,
                                    logdir=None, batch_size=10000, epochs=10,
                                    epoch_start=0, pretty_progressbar=True,
                                    save_best=True, run=None, dev=0,
                                    mini_batch_size=2000, integrate=False,
                                    preburn_time=75, kill_counter=7,
                                    impr_ratio=1e-2, loss_mode="var",
                                    seed=None, mesh=None, pathwise=False,
                                    epochs_per_sync=1, select_best_by="loss",
                                    resume_from=None, progress_callback=None,
                                    bn_stats="batch", stats_every=4):
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
        effective-sample fraction instead of the least loss.  Returns
        ``(integral, error)`` when ``integrate`` else ``(0, 0)``.
        """
        for name, value, ported in (
                ("mesh", mesh, mesh is None),
                ("resume_from", resume_from, resume_from is None),
                ("epochs_per_sync", epochs_per_sync, epochs_per_sync == 1),
                ("logdir", logdir, logdir is None),
                ("run", run, run is None)):
            if not ported:
                _not_ported(name, value)
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

        check_time = preburn_time if preburn_time > 10 else 50
        mini_batch_size = min(mini_batch_size, batch_size)
        n_minibatches = int(batch_size / mini_batch_size)
        batch_size = batch_size - (batch_size % mini_batch_size)

        epoch_offset = epoch_start
        integ = np.zeros(epochs + 1)
        err = np.zeros(epochs + 1)

        # ---- PHASE A: initial estimate on raw uniform points
        # (reference manager.py:139-167)
        with torch.no_grad():
            zero = torch.zeros((), dtype=self.dtype, device=self.device)
            maxf, best_loss, best_var, integ0, err0 = zero, zero, zero, zero, zero
            for _ in range(n_flow):
                w = self._uniform((2 * mini_batch_size, n_flow))
                fres = f(w)
                integ0 = integ0 + torch.sum(fres) / (n_flow * 2 * mini_batch_size)
                err0 = err0 + torch.var(fres) / n_flow
                maxf = torch.maximum(maxf, torch.max(fres))
                if loss_mode == "var":
                    best_loss = best_loss + torch.var(fres / maxf) / n_flow
                else:
                    best_loss = best_loss + torch.mean(fres ** 2) / n_flow
                best_var = best_var + torch.var((fres / maxf) ** 2) / 2 * mini_batch_size
            integ[0], err[0], self.best_loss, self.best_var = \
                torch.stack([integ0, err0, best_loss, best_var]).tolist()

            # ---- diagnostics + initial best-model snapshot
            # (reference manager.py:170-196); moves the BN buffers
            if save_best or log:
                x, jacv = model(w, True)
                self.varJ = float(torch.mean(jacv ** 2))
                # torch KLDivLoss default 'mean' divides by numel = B * n_flow
                self.DKL = float(torch.sum(w * (torch.log(w) - torch.log(x + 1e-45)))
                                 / w.numel())
                self.best_model = copy.deepcopy(model)
                self.best_epoch = 0
                self.best_time = 0
                self.best_loss_rel = 1.0
                self.best_func_count = 2 * batch_size * n_flow
                self.history = []
        self.int_loss = self.best_loss

        optimizer = optimizer_object(model.parameters())
        epoch_cfg = {"f": f, "maxf": maxf, "loss_mode": loss_mode, "pathwise": pathwise,
                     "plan": pwquad_train.TrainPlan(self._flow) if bn_stats == "stale" else None,
                     # the refresh's bounded batch (nf_tpu manager.py:464)
                     "stats_every": stats_every, "stats_batch": min(mini_batch_size, 1 << 16)}
        run_epoch = self._epoch_runner(model, optimizer, self._uniform, **epoch_cfg)

        # ---- host-side epoch loop with the early-stop state machine
        # (reference manager.py:212-327)
        sm = {"stale_save": 1000.0, "preburner": preburn_time > 0,
              "counter": 0, "last_loss": 1000.0}
        t_start = time.time()
        epochs_end = epoch_start + epochs
        self.best_ess = -math.inf

        pbar = None
        if pretty_progressbar:
            try:
                from tqdm.auto import tqdm
                pbar = tqdm(total=epochs, leave=False,
                            desc="Loss: {0:.3e} | Epoch".format(0.0))
            except ImportError:
                pass

        def process_epoch(i, loss, var_val, integ_e, err_e, ess):
            """Host state machine for one finished epoch (reference
            manager.py:282-327).  Returns True to stop training."""
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

            improved = ess > self.best_ess if select_best_by == "ess" else loss < self.best_loss
            if (save_best or log) and improved and not sm["preburner"]:
                self.best_ess = ess
                self.best_loss = loss
                self.best_var = var_val
                self.best_loss_rel = loss / self.int_loss
                # post-update snapshot (reference manager.py:280,297)
                self.best_model = copy.deepcopy(model)
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
        for i in range(epoch_start, epochs_end):
            ws = [self._uniform((mini_batch_size, n_flow)) for _ in range(n_minibatches)]
            stats = run_epoch(i, sm["preburner"], ws)
            if process_epoch(i, *stats.tolist()):  # the epoch's sync
                break

        if pbar is not None:
            pbar.close()
        self._last_epoch = i
        self._bench = (optimizer, epoch_cfg, n_minibatches, mini_batch_size, batch_size)

        # ---- PHASE C: tail integration with the best model in eval mode
        # (reference manager.py:332-346; note the reference's asymmetric
        # integ/sqrt(mini_batch) + std scaling, replicated exactly)
        endpoint = i - epoch_offset + 1   # epochs actually run
        total = epochs_end - epoch_offset
        if integrate and endpoint < total - 1:
            best = self.best_model
            self.best_eval_mode = True    # reference flips best_model to eval
            with torch.no_grad():
                for s in range(endpoint, total):
                    means, stds = [], []
                    for _ in range(n_minibatches):
                        x, jacv = best(self._uniform((mini_batch_size, n_flow)), False)
                        fres = f(x) * jacv
                        means.append(torch.mean(fres))
                        stds.append(torch.std(fres))
                    ie = torch.mean(torch.stack(means)) / math.sqrt(mini_batch_size)
                    ee = torch.mean(torch.stack(stds))
                    ie, ee = torch.stack([ie, ee]).tolist()
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

        if integrate:
            return (self.integ_tot, self.err_tot)
        return (0, 0)

    def benchmark_train_step(self, reps=5):
        """Time the last training run's epoch, warm: ``(seconds_per_epoch,
        train_samples_per_sec)``, the median of ``reps`` after one warm-up.

        It runs on deep copies of the model and the optimizer, and draws its
        latents from a generator of its own, so the trained state and the
        manager's stream are untouched; it keeps the run's batch sizes, loss
        and BatchNorm mode, outside preburn.  One timed rep is ``stats_every`` epochs for
        the stale trainer, so it holds one statistics refresh, and one epoch
        otherwise.  On a CUDA device the time is between CUDA events; on the
        CPU it is the host clock.  Counterpart of nf_tpu's
        ``benchmark_train_step`` (manager.py:902-965), without its
        dispatch-latency differencing.
        """
        optimizer, cfg, n_mb, mb, batch_size = self._bench
        # one deepcopy of both keeps the optimizer bound to the copied model
        model, optimizer = copy.deepcopy((self._model, optimizer))
        gen = torch.Generator(device=self.device).manual_seed(1234)

        def uniform(shape):
            return torch.rand(shape, generator=gen, dtype=self.dtype, device=self.device)

        run_epoch = self._epoch_runner(model, optimizer, uniform, **cfg)
        k = 1 if cfg["plan"] is None else cfg["stats_every"]
        cuda = self.device.type == "cuda"

        def rep():
            for i in range(k):
                run_epoch(i, False, [uniform((mb, self.n_flow)) for _ in range(n_mb)]).tolist()

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

    # -- post-training integrator (reference manager.py:380-405) ------------

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
        """
        if self.best_model is None:
            print("No model has been trained")
            return (0, 0)
        if mesh is not None:
            _not_ported("mesh", mesh)
        neval, nitn = int(neval), int(nitn)
        if method == "qmc":
            return self._integrate_qmc(f, nitn, neval, seed)
        method = self._resolve_method(method, None)
        gen = self._generator(seed)
        model = self.best_model
        means, variances = [], []
        with torch.no_grad():
            if method == "fused":
                from nf_tpu_torch.ops.pwquad_sampler import build_sampler
                sampler = build_sampler(self._flow, model, layout="dim_major")
                seed0 = fsampling.seed_from(gen)

                def draw(i):
                    x_dm, jacv = sampler(seed0, neval, offset=i * neval)
                    return x_dm.T, jacv
            else:
                sampler = fsampling.make_sampler(
                    self._flow, model, neval,
                    "folded" if method == "folded" else "stateful",
                    train=not self.best_eval_mode,   # reference never calls .eval()
                    dtype=self.dtype)

                def draw(i):
                    return sampler(gen)
            for i in range(nitn):
                x, jacv = draw(i)
                fres = f(x) * jacv
                means.append(torch.mean(fres))
                variances.append(torch.var(fres))
            sig, sig_err = combine_iterations(torch.stack(means), torch.stack(variances),
                                              neval, nitn, combine)
            sig, sig_err = torch.stack([sig, sig_err]).tolist()
        return (sig, sig_err)

    def _integrate_qmc(self, f, nitn, neval, seed):
        """RQMC through the best model's eval-mode map (nf_tpu
        manager.py:1011-1026, 1108-1137).  The base seed is ``seed``, else a
        draw from the manager's generator in [0, 2^31 - 1).  On a CUDA device
        the points come from :func:`~nf_tpu_torch.utils.qmc.make_device_sobol`
        and the map is the sampler kernel in operand mode, all replications
        without a host sync; elsewhere scipy's points go through the folded
        forward in the manager's dtype."""
        from nf_tpu_torch.utils import qmc

        base = seed if seed is not None else int(torch.randint(
            0, 2 ** 31 - 1, (1,), generator=self._gen, device=self.device))
        model = self.best_model
        with torch.no_grad():
            if self.device.type == "cuda":
                from nf_tpu_torch.ops.pwquad_sampler import build_sampler
                sampler = build_sampler(self._flow, model, take_latents=True)

                def eval_mean(w):
                    x, jacv = sampler(w)
                    return torch.mean(f(x) * jacv)

                sig, sig_err, _ = qmc.rqmc_integrate_device(eval_mean, self.n_flow, nitn,
                                                            neval, base, self.device)
            else:
                from nf_tpu_torch.flows.fast_eval import make_folded_forward
                forward = make_folded_forward(self._flow, model, self.dtype)

                def eval_mean(w):
                    x, jacv = forward(torch.as_tensor(w, device=self.device))
                    return torch.mean(f(x) * jacv)

                sig, sig_err, _ = qmc.rqmc_integrate(
                    eval_mean, self.n_flow, nitn, neval, base,
                    dtype=np.float64 if self.dtype == torch.float64 else np.float32)
        return (sig, sig_err)

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

    def create_model(self, n_pass_through, n_cells, NN, roll_step, dev=None,
                     identity_init=False):
        """``dev``, the reference's device index, is ignored: the device is
        the constructor's."""
        self._set_model(factory.build_affine_flow(
            self._gen, self.n_flow, n_pass_through, n_cells, tuple(NN),
            roll_step, self.dtype, self.device), identity_init, 10)


class PWLinManager(BasicManager):
    """Piecewise-linear coupling cells + roll layers (reference manager.py:456-499)."""

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

    def create_model(self, n_cells, n_bins, NN, dev=None, identity_init=False,
                     final_rank=None, activation="exp"):
        """``dev``, the reference's device index, is ignored: the device is
        the constructor's."""
        self._set_model(factory.build_pwquad_flow(
            self._gen, self.n_flow, n_cells, n_bins, tuple(NN), self.dtype,
            self.device, final_rank=final_rank, activation=activation),
            identity_init, 5)
