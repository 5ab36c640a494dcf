"""Optimizers matching the torch configurations used by the reference harness.

The reference trains with ``torch.optim.Adamax(params, lr, weight_decay)``
(reference experiment_mg.py:50).  nf_tpu reproduces it as
``add_decayed_weights`` (L2 added to the gradient before the moments)
chained in front of ``optax.adamax``, whose infinity moment is
``max(b2 * u, |g| + eps)`` like torch's.  So the port uses
``torch.optim.Adamax`` itself; ``tests/test_torch_manager.py`` holds one
update against nf_tpu's in float64.

Each factory returns ``make(params) -> torch.optim.Optimizer``: the manager
binds it to the model's parameters when training starts.
"""

from __future__ import annotations

import functools

import torch


def adamax(learning_rate: float, weight_decay: float = 0.0,
           b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    return functools.partial(torch.optim.Adamax, lr=learning_rate,
                             betas=(b1, b2), eps=eps, weight_decay=weight_decay)
