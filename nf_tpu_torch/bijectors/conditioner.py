"""Coupling-cell conditioner MLPs (the "RectNN" of the reference).

Counterpart of ``nf_tpu.bijectors.conditioner``:

    BatchNorm(in) -> [Linear(h_i) -> BatchNorm -> ReLU]* -> final Linear

Hidden linears carry a bias only for affine cells (``hidden_bias``).  The
final layer always has a bias; with ``final_rank=r`` it is factored as
``(h @ u) @ v + b`` with ``u [prev, r]`` and ``v [r, out]``.

Weights keep nf_tpu's ``[fan_in, fan_out]`` layout (``h @ w``), not
``nn.Linear``'s ``[out, in]``, so nf_tpu parameters transplant without a
transpose and the BatchNorm fold is the same formula on both sides.  Each
linear is an ``nn.ParameterDict`` keyed like nf_tpu's pytree (``w``, ``b``;
``u``, ``v``, ``b`` for a factored final layer).

Initialization follows torch.nn.Linear's defaults: ``U(-1/sqrt(fan_in),
1/sqrt(fan_in))`` for weights and biases, drawn from the caller's generator.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from nf_tpu_torch.bijectors.batchnorm import BatchNorm


def _uniform(shape, fan_in, generator, dtype, device):
    bound = 1.0 / math.sqrt(fan_in)
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return nn.Parameter(u * (2.0 * bound) - bound)


def _linear(fan_in, fan_out, bias, generator, dtype, device):
    layer = {"w": _uniform((fan_in, fan_out), fan_in, generator, dtype, device)}
    if bias:
        layer["b"] = _uniform((fan_out,), fan_in, generator, dtype, device)
    return nn.ParameterDict(layer)


class Conditioner(nn.Module):
    """``sizes`` = hidden widths + (output width,)."""

    def __init__(self, in_size: int, sizes: tuple, hidden_bias: bool,
                 generator: torch.Generator, dtype=torch.float32,
                 device="cpu", final_rank=None):
        super().__init__()
        self.bn_in = BatchNorm(in_size, dtype, device)
        self.linears = nn.ModuleList()
        self.bns = nn.ModuleList()
        prev = in_size
        for width in sizes[:-1]:
            self.linears.append(_linear(prev, width, hidden_bias, generator,
                                        dtype, device))
            self.bns.append(BatchNorm(width, dtype, device))
            prev = width
        out = sizes[-1]
        if final_rank is None:
            self.final = _linear(prev, out, True, generator, dtype, device)
        else:
            r = int(final_rank)
            if not 0 < r <= min(prev, out):
                raise ValueError(
                    f"final_rank {r} outside (0, min(prev={prev}, out={out})]")
            u = _linear(prev, r, False, generator, dtype, device)
            v = _linear(r, out, True, generator, dtype, device)
            self.final = nn.ParameterDict({"u": u["w"], "v": v["w"], "b": v["b"]})

    def forward(self, x: torch.Tensor, train: bool, group=None) -> torch.Tensor:
        """``group``: the process group of train-mode BatchNorm's global
        statistics (:func:`~nf_tpu_torch.bijectors.batchnorm.batchnorm_train`)."""
        h = self.bn_in(x, train, group)
        for lin, bn in zip(self.linears, self.bns):
            h = h @ lin["w"]
            if "b" in lin:
                h = h + lin["b"]
            h = torch.relu(bn(h, train, group))
        fin = self.final
        if "u" in fin:
            return (h @ fin["u"]) @ fin["v"] + fin["b"]
        return h @ fin["w"] + fin["b"]
