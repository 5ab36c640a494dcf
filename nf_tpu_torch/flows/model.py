"""Flow model: a static plan of ops over ``(x, jac)`` plus an ``nn.Module``.

Counterpart of ``nf_tpu.flows.model``.  ``CellCfg`` and ``Flow`` are the same
static plan as nf_tpu's (the ``ops`` tuple compares equal for equal
arguments); :class:`FlowModel` holds one conditioner per cell, with the
BatchNorm running statistics as buffers.  :func:`inverse` maps points back
to latents.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from nf_tpu_torch.bijectors import coupling
from nf_tpu_torch.bijectors.conditioner import Conditioner
from nf_tpu_torch.bijectors.permutations import inverse_permutation


@dataclasses.dataclass(frozen=True)
class CellCfg:
    kind: str                      # 'affine' | 'pwlin' | 'pwquad'
    flow_size: int
    pass_through: int
    n_bins: Optional[int]          # None for affine
    nn_sizes: tuple                # hidden widths + output width
    hidden_bias: bool              # affine cells: True; PW cells: False
    final_rank: Optional[int] = None   # low-rank factored final layer
    activation: str = "exp"            # bin-logit positivity map


@dataclasses.dataclass(frozen=True)
class Flow:
    """Static flow description.

    ``ops`` is a tuple of
      ('cell', cell_index)        -- apply coupling cell
      ('roll', shift)             -- cyclic shift of dims (reference RollLayer)
      ('gather', perm_tuple)      -- reorder dims to (pass_through || transform)
      ('scatter', perm_tuple)     -- inverse reorder (reference DeMaskLayer)
    """
    n_flow: int
    cells: tuple  # tuple[CellCfg]
    ops: tuple


def make_cell_cfg(kind, flow_size, pass_through, n_bins, nn_layers,
                  final_rank=None, activation="exp") -> CellCfg:
    transform = flow_size - pass_through
    if kind == "affine":
        out = 2 * transform
        hidden_bias = True
        n_bins = None
        if activation != "exp":
            raise ValueError("affine cells use exp scales; activation applies "
                             "to pwlin/pwquad bin logits only")
    elif kind == "pwlin":
        out = transform * n_bins
        hidden_bias = False
    elif kind == "pwquad":
        out = transform * (2 * n_bins + 1)
        hidden_bias = False
    else:
        raise ValueError(f"unknown cell kind {kind!r}")
    if activation not in ("exp", "squareplus"):
        raise ValueError(f"unknown activation {activation!r}")
    return CellCfg(kind, flow_size, pass_through, n_bins,
                   tuple(nn_layers) + (out,), hidden_bias,
                   final_rank=final_rank, activation=activation)


def permutation_source(op, n_flow: int):
    """For a 'roll' / 'gather' / 'scatter' op, the index array ``src`` with
    ``x_new = x[:, src]``."""
    tag, arg = op
    if tag == "roll":
        return (np.arange(n_flow) - arg) % n_flow     # == np.roll(x, arg)
    if tag == "gather":
        return np.asarray(arg)
    if tag == "scatter":
        return inverse_permutation(np.asarray(arg))
    raise ValueError(f"unknown op {tag!r}")


class FlowModel(nn.Module):
    """``forward(w, train) -> (x, jac)``; train mode uses batch statistics
    and moves the BatchNorm buffers (torch semantics, momentum 0.1)."""

    def __init__(self, flow: Flow, generator: torch.Generator,
                 dtype=torch.float32, device="cpu"):
        super().__init__()
        self.flow = flow
        self.cells = nn.ModuleList(
            Conditioner(c.pass_through, c.nn_sizes, c.hidden_bias, generator,
                        dtype, device, final_rank=c.final_rank)
            for c in flow.cells)
        # the permutations' index tensors per device, made once: a forward
        # then copies nothing from the host
        self._perm = {}
        self._perm_index(next(self.parameters()).device)

    def _perm_index(self, device):
        idx = self._perm.get(device)
        if idx is None:
            idx = self._perm[device] = {
                op: torch.as_tensor(permutation_source(op, self.flow.n_flow), device=device)
                for op in self.flow.ops if op[0] != "cell"}
        return idx

    def forward(self, w: torch.Tensor, train: bool):
        x = w
        jac = torch.ones(w.shape[0], dtype=w.dtype, device=w.device)
        perm = self._perm_index(w.device)
        for op in self.flow.ops:
            if op[0] == "cell":
                x, jac = coupling.cell_forward(self.flow.cells[op[1]],
                                               self.cells[op[1]], x, jac, train)
            else:
                x = x[:, perm[op]]
        return x, jac

    def frozen_forward(self, w: torch.Tensor, train: bool):
        """:meth:`forward` that leaves the BatchNorm buffers as they are (in
        train mode it still normalizes with this batch's statistics), like
        nf_tpu's forward whose returned state is dropped."""
        buffers = {k: b.clone() for k, b in self.named_buffers()}
        return torch.func.functional_call(self, buffers, (w, train))


def apply_cell_inverse(cfg: CellCfg, cond, y, jac, train: bool = False):
    """Undo one coupling cell; ``jac`` gains the inverse map's Jacobian, the
    reciprocal of the forward factor at the recovered point."""
    pt = cfg.pass_through
    yA, yB = y[:, :pt], y[:, pt:]
    xB, factor = coupling.inverse_transform(cfg, cond(yA, train), yB)
    return torch.cat([yA, xB], dim=1), jac / factor


def inverse(flow: Flow, model: FlowModel, x: torch.Tensor, train: bool = False):
    """Map points ``x [B, n_flow]`` back to latents: ``(w, jac_inv)``.

    The inverse of :meth:`FlowModel.forward`: the ops run in reverse, each
    permutation undone (a roll by its negative, a gather by a scatter and a
    scatter by a gather).  ``jac_inv`` is the inverse map's Jacobian, the
    reciprocal of the forward Jacobian at the recovered point.  The
    conditioners run in eval mode unless ``train``, in which case their
    BatchNorm layers normalize with this batch and move their buffers, as
    the forward's train mode does.  Counterpart of nf_tpu's
    ``flows.model.inverse``.
    """
    y = x
    jac = torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    for op in reversed(flow.ops):
        if op[0] == "cell":
            y, jac = apply_cell_inverse(flow.cells[op[1]], model.cells[op[1]], y, jac, train)
        else:
            y = y[:, inverse_permutation(permutation_source(op, flow.n_flow))]
    return y, jac
