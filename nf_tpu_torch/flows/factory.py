"""Flow factories replicating the reference managers' model-building heuristics.

Counterpart of ``nf_tpu.flows.factory``; the plans (``Flow.ops``) are
identical to nf_tpu's:

  * affine chain:  reference manager.py:429-453
  * pwlin chain:   reference manager.py:474-499
  * pwquad chain:  reference manager.py:518-598 (cell-count auto-adjust at
    :526-534; roll-based chain for n_flow <= 7 at :539-557; masked binary-
    partition chain for n_flow > 7 at :559-585)

Every factory returns a :class:`FlowModel` whose weights are drawn from
``generator``.  The draws are the port's own and do not match nf_tpu's.
"""

from __future__ import annotations

import math

import torch

from nf_tpu_torch.bijectors.permutations import get_bin, mask_partition
from nf_tpu_torch.flows.model import Flow, FlowModel, make_cell_cfg


def identity_init(model: FlowModel) -> FlowModel:
    """Zero every conditioner's FINAL layer (in place) so the flow starts as
    the identity map with Jacobian 1 (pwquad/pwlin; affine cells become
    y = atan(20 x)/(pi/2)).  A factored final layer zeroes ``v`` and ``b``
    only, so gradients w.r.t. ``v`` stay nonzero."""
    with torch.no_grad():
        for cond in model.cells:
            fin = cond.final
            fin["v" if "u" in fin else "w"].zero_()
            fin["b"].zero_()
    return model


def build_affine_flow(generator, n_flow, n_pass_through, n_cells, nn_layers,
                      roll_step, dtype=torch.float32, device="cpu"):
    """[AffineCoupling, Roll(roll_step)] * n_cells.  Every roll is kept
    (DESIGN.md fixed bug 1: the reference registers them all under one name,
    so only one survives there)."""
    cells, ops = [], []
    for i in range(n_cells):
        cells.append(make_cell_cfg("affine", n_flow, n_pass_through, None, nn_layers))
        ops += [("cell", i), ("roll", roll_step)]
    return FlowModel(Flow(n_flow, tuple(cells), tuple(ops)), generator, dtype, device)


def build_pwlin_flow(generator, n_flow, n_pass_through, n_cells, n_bins,
                     nn_layers, roll_step, dtype=torch.float32, device="cpu",
                     final_rank=None, activation="exp"):
    """[PWLin, Roll(roll_step)] * n_cells (rolls kept, as above)."""
    cells, ops = [], []
    for i in range(n_cells):
        cells.append(make_cell_cfg("pwlin", n_flow, n_pass_through, n_bins, nn_layers,
                                   final_rank=final_rank, activation=activation))
        ops += [("cell", i), ("roll", roll_step)]
    return FlowModel(Flow(n_flow, tuple(cells), tuple(ops)), generator, dtype, device)


def adjust_pwquad_cells(n_flow: int, n_cells: int) -> int:
    """Reference manager.py:526-534 cell-count auto-adjustment."""
    if n_cells < 2 * math.ceil(math.log2(n_flow)) and n_cells < n_flow:
        if n_flow <= 6:
            n_cells = n_flow
        elif n_flow == 7:
            n_cells = 6
        else:
            n_cells = int(2 * math.ceil(math.log2(n_flow)))
    return n_cells


def build_pwquad_flow(generator, n_flow, n_cells, n_bins, nn_layers,
                      dtype=torch.float32, device="cpu", final_rank=None,
                      activation="exp"):
    """PWQuad chain with the reference's architecture switch at n_flow <= 7."""
    n_cells = adjust_pwquad_cells(n_flow, n_cells)
    cells, ops = [], []

    def cell(pass_through):
        return make_cell_cfg("pwquad", n_flow, pass_through, n_bins, nn_layers,
                             final_rank=final_rank, activation=activation)

    if n_flow <= 7:
        # roll-based chain; the last roll restores the original dim order
        n_pass_through = 1 if n_flow <= 6 else 2
        for i in range(n_cells):
            cells.append(cell(n_pass_through))
            ops.append(("cell", i))
            ops.append(("roll", 1 if i < n_cells - 1
                        else n_flow - ((n_cells - 1) % n_flow)))
    else:
        # masked binary-partition chain
        n = len(get_bin(n_flow - 1, 0))
        for i in range(2 * n):
            feeder, trafoer = mask_partition(n_flow, i)
            perm = tuple(feeder.tolist() + trafoer.tolist())
            cells.append(cell(len(feeder)))
            ops += [("gather", perm), ("cell", i), ("scatter", perm)]
        # extra rolled cells if n_cells > 2n (reference manager.py:577-585)
        extra = n_cells - 2 * n
        for j in range(extra):
            cells.append(cell(n_flow // 2))
            ops.append(("cell", 2 * n + j))
            ops.append(("roll", 1 if j < extra - 1
                        else n_flow - ((extra - 1) % n_flow)))

    return FlowModel(Flow(n_flow, tuple(cells), tuple(ops)), generator, dtype, device)
