"""BatchNorm over ``[B, n]`` with the reference's torch semantics, by hand.

Counterpart of ``nf_tpu.bijectors.batchnorm``.  Written out rather than
``nn.BatchNorm1d`` so that the arithmetic is the one nf_tpu uses:

  * train mode normalizes with the batch mean and the *biased* variance
    ``E[x^2] - E[x]^2``, and moves the running statistics with momentum 0.1,
    where ``var`` tracks the *unbiased* batch variance;
  * eval mode normalizes with the running statistics;
  * eps = 1e-5.

Parameter and buffer names (``scale``, ``bias``, ``mean``, ``var``) are
nf_tpu's pytree keys, so :mod:`nf_tpu_torch.interop` maps them one to one.
"""

from __future__ import annotations

import torch
from torch import nn

EPS = 1e-5
MOMENTUM = 0.1


class BatchNorm(nn.Module):
    def __init__(self, n: int, dtype=torch.float32, device="cpu"):
        super().__init__()
        kw = {"dtype": dtype, "device": device}
        self.scale = nn.Parameter(torch.ones(n, **kw))
        self.bias = nn.Parameter(torch.zeros(n, **kw))
        self.register_buffer("mean", torch.zeros(n, **kw))
        self.register_buffer("var", torch.ones(n, **kw))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if train:
            mean = torch.mean(x, dim=0)
            var = torch.mean(x * x, dim=0) - mean * mean  # biased
            n = x.shape[0]
            with torch.no_grad():
                unbiased = var * (n / max(n - 1, 1))
                self.mean.copy_((1.0 - MOMENTUM) * self.mean + MOMENTUM * mean)
                self.var.copy_((1.0 - MOMENTUM) * self.var + MOMENTUM * unbiased)
        else:
            mean, var = self.mean, self.var
        inv = torch.reciprocal(torch.sqrt(var + EPS))
        return (x - mean) * inv * self.scale + self.bias
