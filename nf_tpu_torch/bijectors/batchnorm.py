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

The train-mode step is the function :func:`batchnorm_train`, which returns
the new running statistics instead of writing them.  The module writes them
into its buffers; inside :func:`collect_running_stats` it hands them to the
caller instead, so a ``torch.func`` transform of the model (the ensemble's
``vmap`` of ``grad``, :mod:`nf_tpu_torch.training.ensemble`) mutates nothing.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch import nn

EPS = 1e-5
MOMENTUM = 0.1

_sink = threading.local()


def batchnorm_train(x, scale, bias, mean, var, group=None):
    """Train-mode BatchNorm of ``x [B, n]``: ``(y, new_mean, new_var)``.
    ``y`` is normalised with the batch mean and biased variance; the new
    running statistics (detached) move ``mean`` and ``var`` by one momentum
    step towards the batch mean and unbiased variance.

    With a process ``group`` (data parallelism) the statistics are those of
    the global batch, as nf_tpu's ``axis_name``: the batch mean and mean
    square are averaged over the ranks (one all-reduce, differentiable) and
    ``n`` is the local count times the world size."""
    bmean = torch.mean(x, dim=0)
    sq = torch.mean(x * x, dim=0)
    n = x.shape[0]
    if group is not None:
        from nf_tpu_torch.parallel.dp import all_reduce_sum
        from nf_tpu_torch.parallel.mesh import rank_and_size

        size = rank_and_size(group)[1]
        bmean, sq = (all_reduce_sum(torch.stack([bmean, sq]), group) / size).unbind(0)
        n = n * size
    bvar = sq - bmean * bmean  # biased
    unbiased = bvar.detach() * (n / max(n - 1, 1))
    new_mean = (1.0 - MOMENTUM) * mean + MOMENTUM * bmean.detach()
    new_var = (1.0 - MOMENTUM) * var + MOMENTUM * unbiased
    inv = torch.reciprocal(torch.sqrt(bvar + EPS))
    return (x - bmean) * inv * scale + bias, new_mean, new_var


@contextlib.contextmanager
def collect_running_stats():
    """Within this context (in this thread), a train-mode :class:`BatchNorm`
    leaves its buffers as they are and records its new statistics in the
    yielded dict, ``{module: (new_mean, new_var)}``."""
    prev = getattr(_sink, "stats", None)
    _sink.stats = stats = {}
    try:
        yield stats
    finally:
        _sink.stats = prev


class BatchNorm(nn.Module):
    def __init__(self, n: int, dtype=torch.float32, device="cpu"):
        super().__init__()
        kw = {"dtype": dtype, "device": device}
        self.scale = nn.Parameter(torch.ones(n, **kw))
        self.bias = nn.Parameter(torch.zeros(n, **kw))
        self.register_buffer("mean", torch.zeros(n, **kw))
        self.register_buffer("var", torch.ones(n, **kw))

    def forward(self, x: torch.Tensor, train: bool, group=None) -> torch.Tensor:
        if not train:
            inv = torch.reciprocal(torch.sqrt(self.var + EPS))
            return (x - self.mean) * inv * self.scale + self.bias
        y, new_mean, new_var = batchnorm_train(x, self.scale, self.bias, self.mean, self.var,
                                                  group)
        stats = getattr(_sink, "stats", None)
        if stats is not None:
            stats[self] = (new_mean, new_var)
        else:
            with torch.no_grad():
                self.mean.copy_(new_mean)
                self.var.copy_(new_var)
        return y
