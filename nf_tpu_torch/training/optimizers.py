"""Optimizers matching the torch configurations used by the reference harness.

The reference trains with ``torch.optim.Adamax(params, lr, weight_decay)``
(reference experiment_mg.py:50).  nf_tpu reproduces it as
``add_decayed_weights`` (L2 added to the gradient before the moments)
chained in front of ``optax.adamax``, whose infinity moment is
``max(b2 * u, |g| + eps)`` like torch's.  So the port uses
``torch.optim.Adamax`` itself, and :func:`adam` ``torch.optim.Adam`` for
nf_tpu's ``add_decayed_weights`` + ``optax.adam`` (optax's defaults:
``b1=0.9, b2=0.999, eps=1e-8``).  ``tests/test_torch_manager.py`` holds three
updates of each against nf_tpu's in float64.

Each factory returns ``make(params) -> torch.optim.Optimizer``: the manager
binds it to the model's parameters when training starts, and
:func:`set_capturable` makes it capturable where the chunked trainer replays
its epochs as CUDA graphs.
"""

from __future__ import annotations

import functools

import torch


def adamax(learning_rate: float, weight_decay: float = 0.0,
           b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    return functools.partial(torch.optim.Adamax, lr=learning_rate,
                             betas=(b1, b2), eps=eps, weight_decay=weight_decay)


def adam(learning_rate: float, weight_decay: float = 0.0):
    return functools.partial(torch.optim.Adam, lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


def set_capturable(optimizer, capturable: bool):
    """Set every parameter group's ``capturable`` flag (a group without one
    is left alone) and put each parameter's ``step`` where that flag wants
    it: on the parameter's device for a CUDA graph, on the CPU otherwise.
    ``load_state_dict`` takes the flag from the file, so the manager calls
    this after it.  The capturable step computes its bias correction on the
    device in the parameters' dtype where the other computes it on the host
    in float64: the two round differently (PERF.md §6)."""
    for group in optimizer.param_groups:
        if "capturable" in group:
            group["capturable"] = capturable
        for p in group["params"]:
            state = optimizer.state.get(p, {})
            if torch.is_tensor(state.get("step")):
                state["step"] = state["step"].to(p.device if capturable else "cpu")
