"""Ensemble training: many flows of one plan trained as one program.

Counterpart of ``nf_tpu.training.ensemble``.  The reference sweeps seeds by
forking OS processes, one eager torch run each (reference
experiment_mg.py:85-87).  Here the runs' parameters and BatchNorm buffers are
stacked along a leading run axis and every epoch of every run is one
``torch.func.vmap`` over ``torch.func.grad_and_value`` of a
``torch.func.functional_call`` of one template model: the phase-A estimate,
preburn, the loss epochs, the kill-counter / preburn-exit state machine and
the best-model tracking run for all runs at once, with no host sync inside a
group's epoch loop.  The results are read back once per group.

Semantics are nf_tpu's (its ``machine_epoch``, ensemble.py:253-276): runs
that hit the kill counter keep updating (the program is fixed-shape), but
their best snapshot and their integral accumulators freeze at the kill,
which is observationally equivalent to stopping.  The host-side stale check
of the manager (manager.py:317-321) is not applied.

Differences in idiom:

  * one ``torch.optim`` optimizer (a factory of
    :mod:`nf_tpu_torch.training.optimizers`) holds the stacked tensors;
    Adamax is elementwise, so this equals one Adamax per run with a shared
    step count;
  * the state machine is tensors ``[R]`` under ``torch.where``; the preburn
    and normal losses are one expression, ``f(w)`` or ``f(x)`` selected
    before it multiplies the Jacobian, so a NaN in the branch not taken
    stays out of the gradient;
  * BatchNorm's running statistics come out of the forward as values
    (:func:`nf_tpu_torch.bijectors.batchnorm.collect_running_stats`);
  * each epoch's latents for a group, ``[R, n_mb, mb, n_flow]`` (phase A:
    ``[R, n_flow, 2 mb, n_flow]`` first), are drawn outside ``vmap`` from
    one generator through the module-level :func:`_uniform` hook, so
    grouped calls draw other numbers than one call does;
  * the group size comes from the card's free memory
    (``torch.cuda.mem_get_info``); a group is halved and retried only on
    ``torch.cuda.OutOfMemoryError``.  nf_tpu's measured v5e ceilings
    (``MAX_RUNS_PER_CALL``, ``MAX_SAMPLE_ROWS_PER_CALL``) and its retry on
    any runtime error are TPU runtime facts, not ported.

``f`` maps ``x [B, n_flow]`` to ``[B]`` row by row and must work under
``vmap`` (plain tensor arithmetic does).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call, grad_and_value, vmap

from nf_tpu_torch import interop
from nf_tpu_torch.bijectors.batchnorm import BatchNorm, collect_running_stats
from nf_tpu_torch.flows.model import FlowModel
from nf_tpu_torch.training.chunk import advance

# Test hook: a group wider than this raises torch.cuda.OutOfMemoryError
# before it runs, so the tests reach the halving retry without a real fault.
_TEST_FAULT_WIDTH = None


def _uniform(generator, shape, dtype, device):
    return torch.rand(shape, generator=generator, dtype=dtype, device=device)


def _tree_bytes(tree):
    return sum(t.numel() * t.element_size() for t in tree.values())


def estimate_run_bytes(flow, params, buffers, mini_batch_size, n_minibatches, epochs,
                       dtype=torch.float32):
    """Rough live-memory estimate (bytes) for ONE ensemble run (nf_tpu
    ensemble.py:78-97): parameters (live + best snapshot + 2 Adamax slots +
    the per-minibatch gradients), buffers (live + snapshot), the per-epoch
    scalars and the forward activations kept for the backward."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    act_per_sample = sum(sum(cfg.nn_sizes) + 6 * flow.n_flow for cfg in flow.cells)
    act_bytes = 3 * mini_batch_size * act_per_sample * itemsize
    return (_tree_bytes(params) * (2 + 2 + n_minibatches) + 2 * _tree_bytes(buffers)
            + 5 * epochs * itemsize + act_bytes)


def auto_runs_per_call(flow, params, buffers, mini_batch_size, n_minibatches, epochs,
                       n_runs, dtype=torch.float32, budget_bytes=None, device="cuda"):
    """The group size that fits ``budget_bytes`` (default: 40% of the
    device's free memory, ``torch.cuda.mem_get_info``; 16 GiB off the card)
    at :func:`estimate_run_bytes` per run, at most ``n_runs``."""
    if budget_bytes is None:
        device = torch.device(device)
        free = torch.cuda.mem_get_info(device)[0] if device.type == "cuda" else 16 << 30
        budget_bytes = int(0.4 * free)
    per_run = estimate_run_bytes(flow, params, buffers, mini_batch_size, n_minibatches,
                                 epochs, dtype)
    return max(min(int(budget_bytes // max(per_run, 1)), n_runs), 1)


def stack_ensemble(init_fn, generator, n_runs):
    """``n_runs`` models from ``init_fn(generator) -> FlowModel``, stacked:
    ``(flow, params, buffers)`` with a leading run axis
    (:func:`nf_tpu_torch.interop.stack_models`).  The runs must share one
    ``Flow`` plan."""
    models = [init_fn(generator) for _ in range(n_runs)]
    if any(m.flow != models[0].flow for m in models[1:]):
        raise ValueError("ensemble runs must share one static Flow plan")
    return (models[0].flow, *interop.stack_models(models))


def run_index(tree, i):
    """Run ``i``'s entries of a stacked dict."""
    return {k: v[i] for k, v in tree.items()}


def _where(cond, new, old):
    """``torch.where`` of ``[R]`` ``cond`` over stacked ``[R, ...]`` tensors."""
    return torch.where(cond.reshape(cond.shape + (1,) * (new.dim() - 1)), new, old)


def _group_runner(flow, f, optimizer, generator, mb, n_mb, epochs, preburn_time,
                  kill_counter, loss_mode, by_ess, pathwise, dtype, device):
    """``run(params, buffers) -> (best params, best buffers, outputs)`` for
    one group of stacked runs, all on the device: no host sync from the
    first draw to the return."""
    n_flow = flow.n_flow
    template = FlowModel(flow, torch.Generator(device=device).manual_seed(0), dtype, device)
    bn_names = [(name, m) for name, m in template.named_modules() if isinstance(m, BatchNorm)]

    def loss_fn(p, b, w, pre, maxf):
        """One run's minibatch (nf_tpu ensemble.py:210-236)."""
        with collect_running_stats() as stats:
            x, jacv = functional_call(template, (p, b), (w, True))
        new_b = {}
        for name, m in bn_names:
            new_b[f"{name}.mean"], new_b[f"{name}.var"] = stats[m]
        # preburn: the loss on the latents (f(w) J); else f(x) J with x
        # detached unless pathwise
        g = torch.where(pre, f(w), f(x if pathwise else x.detach()))
        fXJ = g * jacv / maxf
        fres = torch.where(pre, g, g * jacv).detach()
        if loss_mode == "var":
            loss = torch.var(fXJ)
        elif loss_mode == "kl":
            loss = torch.where(pre, torch.var(fXJ), torch.mean(
                fXJ.detach() * torch.log(torch.clamp_min(jacv, 1e-30))))
        else:
            loss = torch.mean((fXJ * maxf) ** 2)
        return loss, (new_b, torch.mean(fres), torch.var(fres), torch.mean(fres ** 2))

    step = vmap(grad_and_value(loss_fn, has_aux=True))

    def run(P, B):
        R = next(iter(P.values())).shape[0]
        zeros = torch.zeros((R,), dtype=dtype, device=device)

        # ---- phase A (reference manager.py:139-167), every run at once
        wa = _uniform(generator, (R, n_flow, 2 * mb, n_flow), dtype, device)
        fa = f(wa.reshape(-1, n_flow)).reshape(R, n_flow, 2 * mb)
        maxf, int_loss, integ0, err0 = zeros, zeros, zeros, zeros
        for k in range(n_flow):
            fres = fa[:, k]
            integ0 = integ0 + torch.sum(fres, dim=1) / (n_flow * 2 * mb)
            err0 = err0 + torch.var(fres, dim=1) / n_flow
            maxf = torch.maximum(maxf, torch.max(fres, dim=1).values)
            if loss_mode == "var":
                int_loss = int_loss + torch.var(fres / maxf[:, None], dim=1) / n_flow
            else:
                int_loss = int_loss + torch.mean(fres ** 2, dim=1) / n_flow

        opt = optimizer(list(P.values()))
        b_metric = torch.full((R,), -1.0, dtype=dtype, device=device) if by_ess \
            else int_loss.clone()
        bP = {k: v.clone() for k, v in P.items()}
        bB = {k: v.clone() for k, v in B.items()}
        pre = torch.full((R,), preburn_time > 0, device=device)
        counter = torch.zeros((R,), dtype=torch.int64, device=device)
        last_loss = torch.full((R,), 1000.0, dtype=dtype, device=device)
        killed = torch.zeros((R,), dtype=torch.bool, device=device)
        series = {k: [] for k in ("loss", "integ", "err", "killed", "improved")}

        for i in range(epochs):
            ws = _uniform(generator, (R, n_mb, mb, n_flow), dtype, device)
            gs, ls, iis, eis, qis = [], [], [], [], []
            for k in range(n_mb):
                g, (loss, (B, ii, ei, qi)) = step(P, B, ws[:, k], pre, maxf)
                gs.append(g)
                ls.append(loss)
                iis.append(ii)
                eis.append(ei)
                qis.append(qi)
            for name, p in P.items():
                p.grad = torch.mean(torch.stack([g[name] for g in gs]), dim=0)
            opt.step()
            loss = torch.mean(torch.stack(ls), dim=0)
            integ_e = torch.mean(torch.stack(iis), dim=0)
            err_e = torch.mean(torch.stack(eis), dim=0)
            ess = integ_e ** 2 / torch.clamp_min(torch.mean(torch.stack(qis), dim=0), 1e-300)

            # the state machine (nf_tpu ensemble.py:253-276)
            improved, b_metric, counter, killed, pre = advance(
                pre, killed, counter, last_loss, b_metric, loss, ess, i, int_loss,
                by_ess=by_ess, kill_counter=kill_counter, preburn_time=preburn_time)
            last_loss = loss
            with torch.no_grad():
                bP = {k: _where(improved, P[k], v) for k, v in bP.items()}
                bB = {k: _where(improved, B[k], v) for k, v in bB.items()}
            for name, v in zip(series, (loss, integ_e, err_e, killed, improved)):
                series[name].append(v)

        s = {k: torch.stack(v, dim=1) for k, v in series.items()}
        # the accumulators with the phase-A entry; epochs after a kill are
        # out (the killing epoch itself counts, so the mask shifts by one)
        alive = ~torch.cat([torch.zeros((R, 1), dtype=torch.bool, device=device),
                            s["killed"][:, :-1]], dim=1)
        integ = torch.cat([integ0[:, None], torch.where(alive, s["integ"], 0.0)], dim=1)
        err = torch.cat([err0[:, None], torch.where(alive, s["err"], 0.0)], dim=1)
        mask = err > 0
        iw = torch.where(mask, 1.0 / torch.where(mask, err, 1.0), 0.0)
        integ_tot = torch.sum(integ * iw, dim=1) / torch.sum(iw, dim=1)
        err_tot = torch.sqrt(1.0 / torch.sum(iw, dim=1))
        i_gs = torch.arange(epochs, device=device)
        best_epoch = torch.max(torch.where(s["improved"], i_gs, -1), dim=1).values
        return bP, bB, (b_metric, best_epoch, killed, s["loss"], integ_tot, err_tot, int_loss)

    return run


def train_ensemble(flow, params_stack, bn_stack, f, optimizer, generator,
                   batch_size=1000, epochs=50, mini_batch_size=None,
                   preburn_time=0, kill_counter=7, loss_mode="var",
                   select_best_by="loss", pathwise=False, dtype=None,
                   runs_per_call="auto", verbose=False):
    """Train the stacked runs at once; returns a result dict.

    ``params_stack`` / ``bn_stack``: the stacked dicts of
    :func:`stack_ensemble` (or :func:`nf_tpu_torch.interop
    .ensemble_from_numpy`), on the device to train on.  ``optimizer`` is a
    factory ``make(params)`` such as
    :func:`nf_tpu_torch.training.optimizers.adamax`; ``generator`` a
    ``torch.Generator`` on that device.  ``dtype`` defaults to the stacks'.

    Returns (leading axis ``n_runs`` unless noted): ``best_params`` /
    ``best_bn`` (stacked dicts on the device, see
    :func:`nf_tpu_torch.interop.ensemble_member`); ``best_loss`` (or
    ``best_ess`` with ``select_best_by="ess"``), ``best_epoch``, ``killed``,
    ``history [n_runs, epochs]``, ``integ_tot`` / ``err_tot`` (the per-run
    inverse-variance combinations, reference manager.py:349-350) and
    ``int_loss`` (the phase-A losses) as numpy arrays; ``group_size`` (an
    int), the group size finally used.

    ``runs_per_call`` bounds the runs of one group (groups run one after
    another and their results are concatenated): ``"auto"`` sizes it by
    :func:`auto_runs_per_call`, an int forces it, ``None`` runs all at
    once.  A group that runs out of device memory is retried at half the
    width, and the remaining groups keep the smaller size.
    """
    if select_best_by not in ("loss", "ess"):
        raise ValueError(f"unknown select_best_by {select_best_by!r}")
    if loss_mode not in ("var", "est", "kl"):
        raise ValueError(f"unknown loss_mode {loss_mode!r}")
    leaf = next(iter(params_stack.values()))
    device = leaf.device
    dtype = leaf.dtype if dtype is None else dtype
    if mini_batch_size is None:
        mini_batch_size = batch_size
    mini_batch_size = min(mini_batch_size, batch_size)
    n_minibatches = batch_size // mini_batch_size
    n_runs = leaf.shape[0]
    by_ess = select_best_by == "ess"

    run = _group_runner(flow, f, optimizer, generator, mini_batch_size, n_minibatches, epochs,
                        preburn_time, kill_counter, loss_mode, by_ess, pathwise, dtype, device)
    if runs_per_call == "auto":
        runs_per_call = auto_runs_per_call(
            flow, run_index(params_stack, 0), run_index(bn_stack, 0), mini_batch_size,
            n_minibatches, epochs, n_runs, dtype, device=device)
        if verbose:
            print(f"train_ensemble: auto group size {runs_per_call} "
                  f"({n_runs} runs, mini_batch {mini_batch_size})")
    cur = n_runs if runs_per_call is None else min(runs_per_call, n_runs)

    groups = []
    s0 = 0
    while s0 < n_runs:
        sl = slice(s0, min(s0 + cur, n_runs))
        try:
            if _TEST_FAULT_WIDTH is not None and sl.stop - sl.start > _TEST_FAULT_WIDTH:
                raise torch.cuda.OutOfMemoryError("injected ensemble fault (test hook)")
            bP, bB, outs = run({k: v[sl].clone() for k, v in params_stack.items()},
                               {k: v[sl].clone() for k, v in bn_stack.items()})
            groups.append((bP, bB, [t.cpu().numpy() for t in outs]))  # the group's read
        except torch.cuda.OutOfMemoryError as e:
            if cur <= 1:
                raise
            cur = max(cur // 2, 1)
            if device.type == "cuda":
                torch.cuda.empty_cache()
            if verbose:
                print(f"train_ensemble: group of {sl.stop - sl.start} runs failed "
                      f"({type(e).__name__}); retrying at group size {cur}")
            continue
        s0 = sl.stop

    best_p = {k: torch.cat([g[0][k] for g in groups]) for k in params_stack}
    best_b = {k: torch.cat([g[1][k] for g in groups]) for k in bn_stack}
    (best_metric, best_epoch, killed, history, integ_tot, err_tot,
     int_loss) = (np.concatenate(a) for a in zip(*(g[2] for g in groups)))
    return {
        "best_params": best_p,
        "best_bn": best_b,
        ("best_ess" if by_ess else "best_loss"): best_metric,
        "best_epoch": best_epoch,
        "killed": killed,
        "history": history,
        "integ_tot": integ_tot,
        "err_tot": err_tot,
        "int_loss": int_loss,
        "group_size": cur,
    }
