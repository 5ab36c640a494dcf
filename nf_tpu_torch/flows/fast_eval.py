"""Folded eval-mode forward: the BatchNorm-free plain PyTorch sampling path.

Eval-mode BatchNorm is affine, so every conditioner collapses to a bare
dense+bias+ReLU MLP (:func:`nf_tpu_torch.ops.pwquad_sampler.fold_eval_params`).
:func:`make_folded_forward` is the plain PyTorch version of the fused
sampler kernel (``ops/csrc/pwquad_sampler.cu``): the kernel's wrapper runs it
for CPU tensors, and the tests and ``chip_smoke.py`` hold the kernel against
it.  It is also the ``"folded"`` sampling method on any device.
:func:`apply_folded` is the map itself, shared with the training kernels'
plain versions (:mod:`nf_tpu_torch.ops.pwquad_train`).

Counterpart of ``nf_tpu.flows.fast_eval.make_folded_forward``.
"""

from __future__ import annotations

import numpy as np
import torch

from nf_tpu_torch.bijectors import coupling
from nf_tpu_torch.flows.model import permutation_source
from nf_tpu_torch.ops.pwquad_sampler import fold_eval_params, model_device


def permutation_index(flow, device):
    """``{op index: src}`` for the permutation ops of ``flow``, on ``device``."""
    return {i: torch.as_tensor(permutation_source(op, flow.n_flow), device=device)
            for i, op in enumerate(flow.ops) if op[0] != "cell"}


def apply_folded(flow, folded, perms, x, on_cell=None):
    """Map ``x [B, n_flow]`` through ``flow`` with its conditioners given as
    folded ``(W, b, relu)`` layers per cell and its permutations as
    :func:`permutation_index`; returns ``(x, jac)`` in ``x``'s dtype.
    ``on_cell(index, x_in, pre_relus)``, if given, sees each cell's input and
    its hidden layers' pre-ReLU activations."""
    jac = torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    for i, op in enumerate(flow.ops):
        if op[0] != "cell":
            x = x[:, perms[i]]
            continue
        cfg = flow.cells[op[1]]
        pt = cfg.pass_through
        h = x[:, :pt]
        pres = []
        for wm, bv, relu in folded[op[1]]:
            h = h @ wm + bv
            if relu:
                pres.append(h)
                h = torch.relu(h)
        if on_cell is not None:
            on_cell(op[1], x, pres)
        yB, factor = coupling.transform(cfg, h, x[:, pt:])
        x = torch.cat([x[:, :pt], yB], dim=1)
        jac = jac * factor
    return x, jac


def make_folded_forward(flow, model, dtype=torch.float32):
    """Build ``f(w [B, n_flow]) -> (x [B, n_flow], jac [B])``, the eval-mode
    map of ``model`` with the BatchNorm layers folded into the weights.

    Matmuls run in full ``dtype`` precision: keep
    ``torch.backends.cuda.matmul.allow_tf32`` False on the card, since TF32's
    ~1e-3 error is amplified through trained sharp CDFs."""
    device = model_device(model)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    folded = [[(torch.as_tensor(wm, device=device), torch.as_tensor(bv, device=device), relu)
               for wm, bv, relu in layers]
              for layers in fold_eval_params(flow, model, dtype=np_dtype)]
    perms = permutation_index(flow, device)

    def forward(w):
        return apply_folded(flow, folded, perms, w.to(dtype))

    return forward
