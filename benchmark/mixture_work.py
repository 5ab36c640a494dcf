"""The learned multi-channel mixture's work per trained sample, counted
from the configuration's shapes alone, never from the program.

Only the conditioners' matrix products are counted, an FMA as 2 FLOPs:
each cell's hidden layers and its final layer, factored at rank r as
``(h u) v``.  A trained sample (one row of one source channel) takes one
forward of its source flow, without autograd, and C inverses, one through
each channel's flow, with autograd, then their backward: two products of
each forward's size (the cotangent's and the weights').  The pilot's pass
is left out, as are the phase space, the matrix element, the bin searches
and every elementwise operation, so the count is a lower bound.
"""

from __future__ import annotations

from benchmark.reference import flow


def matmul_macs(cfg):
    """Multiply-adds of one flow evaluation (forward or inverse), one row."""
    fl = cfg["flow"]
    plan = flow.pwquad_plan(fl["n_flow"], fl["n_cells"], fl["n_bins"], fl["hidden"])
    rank = fl.get("final_rank")
    macs = 0
    for c in range(len(plan.pass_through)):
        shapes = plan.layer_shapes(c)
        macs += sum(fi * fo for fi, fo, _ in shapes[:-1])
        fi, fo, _ = shapes[-1]
        macs += fi * fo if rank is None else rank * (fi + fo)
    return macs


def flops_per_sample(cfg):
    """FLOPs of one trained sample: 2 MACs x (1 forward + C inverses x 3)."""
    return 2 * matmul_macs(cfg) * (1 + 3 * cfg["flow"]["channels"])
