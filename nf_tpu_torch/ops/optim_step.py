"""The optimizer update of the chunked trainer: torch.optim's Adamax / Adam
step as one CUDA kernel (``csrc/optim_step.cu``).

The per-epoch trainer steps ``torch.optim.Adamax`` / ``Adam``; on the card
that is their non-capturable foreach step, which takes the bias correction
from the host as float64 scalars.  A CUDA graph replays the scalars it was
captured with, so the chunked trainer needs the step with its scalars on the
device.  torch's capturable step computes them there in the parameters'
dtype, which rounds otherwise.  The kernel reads them from float64 tables
instead, indexed by a step count on the device that it advances, and rounds
every operation as torch's foreach kernels do, so a graph of it gives the
per-epoch step's bits.  This module holds

  * :func:`step_tables`: ``(lr / (1 - b1**t)) * -1`` and, for Adam,
    ``(1 - b2**t)**0.5`` for every step ``t``, computed by the expressions
    torch's step evaluates;
  * the plain versions :func:`adamax_update_ref` / :func:`adam_update_ref`:
    torch's foreach operations in torch's order, driven by the same tables
    and step count (the tests and the card's checks use them; no training
    path does);
  * the wrapper :func:`update` with its launch count ``LAUNCHES``;
  * :func:`compare_with_torch`, the check that holds the wrapper against
    torch's step and the plain version, step after step.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises.  Float32 and float64 parameters.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

# Launches of the update kernel since import (or since a caller reset it).
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.float64: 1}


def step_tables(lr, betas, t_max, adam, device):
    """``(step_size, bc2_sqrt)``: float64 tensors of length ``t_max + 1`` on
    ``device``, entry ``t`` the scalars of step ``t`` (entry 0 is NaN; no
    step reads it); ``bc2_sqrt`` is ``None`` for Adamax.  The expressions are
    torch's (torch/optim/adamax.py and adam.py, ``_multi_tensor_*``, the
    branch without ``capturable``), with the step as the float its state
    tensor holds."""
    b1, b2 = betas
    steps = [float(t) for t in range(1, t_max + 1)]
    step_size = [math.nan] + [(lr / (1 - b1 ** t)) * -1 for t in steps]
    bc2_sqrt = [math.nan] + [(1 - b2 ** t) ** 0.5 for t in steps] if adam else None

    def table(values):
        return torch.tensor(values, dtype=torch.float64, device=device)

    return table(step_size), None if bc2_sqrt is None else table(bc2_sqrt)


def _scalar(table, step):
    return float(table[int(step) + 1])


def adamax_update_ref(params, grads, exp_avgs, exp_infs, step, step_size, *, beta1, beta2,
                      eps, weight_decay):
    """The plain version of the Adamax update: torch's foreach step
    (``_multi_tensor_adamax``), its step size taken from ``step_size`` at
    ``step + 1``; ``step`` (a one-element int64 tensor, the steps taken)
    advances by one."""
    with torch.no_grad():
        s = _scalar(step_size, step)
        if weight_decay != 0:
            grads = torch._foreach_add(grads, params, alpha=weight_decay)
        torch._foreach_lerp_(exp_avgs, grads, 1 - beta1)
        torch._foreach_mul_(exp_infs, beta2)
        norm = torch._foreach_abs(grads)
        torch._foreach_add_(norm, eps)
        torch._foreach_maximum_(exp_infs, norm)
        torch._foreach_addcdiv_(params, exp_avgs, exp_infs, [s] * len(params))
        step.add_(1)


def adam_update_ref(params, grads, exp_avgs, exp_avg_sqs, step, step_size, bc2_sqrt, *, beta1,
                    beta2, eps, weight_decay):
    """The plain version of the Adam update: torch's foreach step
    (``_multi_tensor_adam`` without amsgrad), its scalars from the tables."""
    with torch.no_grad():
        s, c = _scalar(step_size, step), _scalar(bc2_sqrt, step)
        if weight_decay != 0:
            grads = torch._foreach_add(grads, params, alpha=weight_decay)
        torch._foreach_lerp_(exp_avgs, grads, 1 - beta1)
        torch._foreach_mul_(exp_avg_sqs, beta2)
        torch._foreach_addcmul_(exp_avg_sqs, grads, grads, 1 - beta2)
        den = torch._foreach_sqrt(exp_avg_sqs)
        torch._foreach_div_(den, [c] * len(params))
        torch._foreach_add_(den, eps)
        torch._foreach_addcdiv_(params, exp_avgs, den, [s] * len(params))
        step.add_(1)


def _check(params, grads, exp_avgs, second, step, tables):
    device, dtype = params[0].device, params[0].dtype
    if dtype not in _DTYPES:
        raise ValueError(f"the update kernel takes float32 or float64 parameters, not {dtype}")
    for name, ts in (("parameter", params), ("gradient", grads), ("first moment", exp_avgs),
                     ("second moment", second)):
        if len(ts) != len(params):
            raise ValueError(f"{len(ts)} {name}s for {len(params)} parameters")
        for t, p in zip(ts, params):
            if t.device != device or t.dtype != dtype or not t.is_contiguous() \
                    or t.numel() != p.numel() or t.numel() == 0:
                raise ValueError(f"every {name} must be a non-empty contiguous {dtype} tensor on "
                                 f"{device} of its parameter's size")
    if step.device != device or step.dtype != torch.int64 or step.numel() != 1:
        raise ValueError("step must be a one-element int64 tensor on the parameters' device")
    for t in tables:
        if t is not None and (t.device != device or t.dtype != torch.float64
                              or not t.is_contiguous() or t.numel() != tables[0].numel()):
            raise ValueError("the step tables must be contiguous float64 tensors of one length "
                             "on the parameters' device")


def update(params, grads, exp_avgs, second, step, tables, *, adam, beta1, beta2, eps,
           weight_decay):
    """One Adamax (``adam=False``, ``second`` the infinity moments) or Adam
    (``second`` the squared moments) step of ``params`` in place, the
    moments too, at step ``step + 1``; ``step`` advances by one.  ``tables``
    is :func:`step_tables`' pair and must hold entry ``step + 1``.  On CUDA
    tensors the kernel, launched on the current stream with no host sync (a
    CUDA graph captures it); it is given the tables' length and traps on a
    step past them, so the next synchronisation raises.  On CPU tensors the
    plain version, whose table lookup raises there."""
    global LAUNCHES
    step_size, bc2_sqrt = tables
    if params[0].device.type == "cpu":
        if adam:
            return adam_update_ref(params, grads, exp_avgs, second, step, step_size, bc2_sqrt,
                                   beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay)
        return adamax_update_ref(params, grads, exp_avgs, second, step, step_size, beta1=beta1,
                                 beta2=beta2, eps=eps, weight_decay=weight_decay)
    if adam and bc2_sqrt is None:
        raise ValueError("Adam needs the bc2_sqrt table")
    _check(params, grads, exp_avgs, second, step, tables if adam else (step_size,))
    from nf_tpu_torch.ops import _build

    n = len(params)

    def pointers(ts):
        return (ctypes.c_void_p * n)(*[t.data_ptr() for t in ts])

    device = params[0].device
    err = _build.library().nf_optim_step(
        _DTYPES[params[0].dtype], int(adam), n, pointers(params), pointers(grads),
        pointers(exp_avgs), pointers(second), (ctypes.c_longlong * n)(*[p.numel() for p in params]),
        step.data_ptr(), step_size.data_ptr(), bc2_sqrt.data_ptr() if adam else None,
        step_size.numel(), 1 - beta1, beta2, 1 - beta2, eps, weight_decay, int(weight_decay != 0),
        torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"optim_step kernel launch failed: {_build.error_string(err)}")
    LAUNCHES += 1


def compare_with_torch(shapes, *, adam, weight_decay, steps=200, dtype=torch.float32,
                       device="cuda", seed=5, lr=2e-3, betas=(0.9, 0.999), eps=1e-8):
    """Hold :func:`update` against ``torch.optim.Adamax`` / ``Adam`` (its
    default step: foreach, not capturable, on a CUDA device) and against the
    plain version over ``steps`` steps of parameters of ``shapes``, from
    ``seed``.  The gradients span 30 decades, one draw a tensor, with 5%
    zeros; every 40th step they are subnormal.  No update writes its
    gradients, so the three share them.  Returns ``(differ, max_abs_err,
    taken)``: the parameter and moment elements, summed over every step,
    whose bits differ between the wrapper and either of the others; the
    largest difference; the wrapper's step count at the end."""
    rng = np.random.default_rng(seed)
    sizes = [math.prod(sh) for sh in shapes]
    numel = sum(sizes)

    def split(values):
        t = torch.tensor(values, dtype=dtype, device=device)
        return [v.view(sh) for v, sh in zip(torch.split(t, sizes), shapes)]

    def flat(ts):
        return torch.cat([t.reshape(-1) for t in ts])

    def bits(t):
        return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)

    params = [p.clone() for p in split(rng.standard_normal(numel) * 0.3)]
    kernel, plain = [p.clone() for p in params], [p.clone() for p in params]
    make = torch.optim.Adam if adam else torch.optim.Adamax
    opt = make(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay)
    mom = [[torch.zeros_like(p) for p in params] for _ in range(4)]
    counts = [torch.zeros(1, dtype=torch.int64, device=device) for _ in range(2)]
    tables = step_tables(lr, betas, steps, adam, device)
    hyper = dict(beta1=betas[0], beta2=betas[1], eps=eps, weight_decay=weight_decay)
    second = "exp_avg_sq" if adam else "exp_inf"
    differ = torch.zeros((), dtype=torch.int64, device=device)
    worst = torch.zeros((), dtype=dtype, device=device)
    for t in range(1, steps + 1):
        g = rng.standard_normal(numel) * np.repeat(
            10.0 ** rng.uniform(-44 if t % 40 == 0 else -8, 1, len(sizes)), sizes)
        g[rng.random(numel) < 0.05] = 0
        grads = split(g)
        for p, gp in zip(params, grads):
            p.grad = gp
        opt.step()
        update(kernel, grads, mom[0], mom[1], counts[0], tables, adam=adam, **hyper)
        if adam:
            adam_update_ref(plain, grads, mom[2], mom[3], counts[1], *tables, **hyper)
        else:
            adamax_update_ref(plain, grads, mom[2], mom[3], counts[1], tables[0], **hyper)
        mine = flat(kernel + mom[0] + mom[1])
        for other in (flat(params + [opt.state[p]["exp_avg"] for p in params]
                           + [opt.state[p][second] for p in params]),
                      flat(plain + mom[2] + mom[3])):
            differ += (bits(other) != bits(mine)).sum()
            worst = torch.maximum(worst, (other - mine).abs().max())
    return int(differ), float(worst), int(counts[0])
