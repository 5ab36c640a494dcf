"""Folded eval-mode forward: the BatchNorm-free plain PyTorch sampling path.

Eval-mode BatchNorm is affine, so every conditioner collapses to a bare
dense+bias+ReLU MLP (:func:`nf_tpu_torch.ops.pwquad_sampler.fold_eval_params`).
:func:`make_folded_forward` is the plain PyTorch version of the fused
sampler kernel (``ops/csrc/pwquad_sampler.cu``): the kernel's wrapper runs it
for CPU tensors, and the tests and ``chip_smoke.py`` hold the kernel against
it.  It is also the ``"folded"`` sampling method on any device.
:func:`apply_folded` is the map itself, shared with the training kernels'
plain versions (:mod:`nf_tpu_torch.ops.pwquad_train`).
:func:`make_folded_inverse` undoes the same folded map, and
:func:`make_density` reads the model density q(x) from it.

Counterpart of ``nf_tpu.flows.fast_eval``'s ``make_folded_forward``,
``make_folded_inverse`` and ``make_density``.
"""

from __future__ import annotations

import numpy as np
import torch

from nf_tpu_torch.bijectors import coupling
from nf_tpu_torch.bijectors.permutations import inverse_permutation
from nf_tpu_torch.flows.model import permutation_source
from nf_tpu_torch.ops.pwquad_sampler import fold_eval_params, model_device
from nf_tpu_torch.utils import profiling


def permutation_index(flow, device, inverse=False):
    """``{op index: src}`` for the permutation ops of ``flow``, on ``device``:
    ``x[:, src]`` applies the op, or with ``inverse`` undoes it."""
    def src(op):
        s = permutation_source(op, flow.n_flow)
        return inverse_permutation(s) if inverse else s
    return {i: torch.as_tensor(src(op), device=device)
            for i, op in enumerate(flow.ops) if op[0] != "cell"}


def _mlp(layers, h, pres=None):
    """The folded conditioner ``layers`` on ``h``; each hidden layer's
    pre-ReLU activation is appended to ``pres`` if given."""
    for wm, bv, relu in layers:
        h = h @ wm + bv
        if relu:
            if pres is not None:
                pres.append(h)
            h = torch.relu(h)
    return h


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
        pres = []
        h = _mlp(folded[op[1]], x[:, :pt], pres)
        if on_cell is not None:
            on_cell(op[1], x, pres)
        yB, factor = coupling.transform(cfg, h, x[:, pt:])
        x = torch.cat([x[:, :pt], yB], dim=1)
        jac = jac * factor
    return x, jac


def apply_folded_inverse(flow, folded, perms, y):
    """Undo :func:`apply_folded`: map ``y [B, n_flow]`` back to the latents;
    ``perms`` from :func:`permutation_index` with ``inverse=True``.  Returns
    ``(w, jac_inv)``, ``jac_inv`` the inverse map's Jacobian."""
    jac = torch.ones(y.shape[0], dtype=y.dtype, device=y.device)
    for i in reversed(range(len(flow.ops))):
        op = flow.ops[i]
        if op[0] != "cell":
            y = y[:, perms[i]]
            continue
        cfg = flow.cells[op[1]]
        pt = cfg.pass_through
        xB, factor = coupling.inverse_transform(cfg, _mlp(folded[op[1]], y[:, :pt]), y[:, pt:])
        y = torch.cat([y[:, :pt], xB], dim=1)
        jac = jac / factor
    return y, jac


def _fold(flow, model, dtype):
    """:func:`fold_eval_params` of ``model`` as ``dtype`` tensors on its
    device (the span ``nf.fold``)."""
    device = model_device(model)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    with profiling.span("nf.fold"):
        return [[(torch.as_tensor(wm, device=device), torch.as_tensor(bv, device=device), relu)
                 for wm, bv, relu in layers]
                for layers in fold_eval_params(flow, model, dtype=np_dtype)]


def make_folded_forward(flow, model, dtype=torch.float32):
    """Build ``f(w [B, n_flow]) -> (x [B, n_flow], jac [B])``, the eval-mode
    map of ``model`` with the BatchNorm layers folded into the weights.

    Matmuls run in full ``dtype`` precision: keep
    ``torch.backends.cuda.matmul.allow_tf32`` False on the card, since TF32's
    ~1e-3 error is amplified through trained sharp CDFs."""
    folded = _fold(flow, model, dtype)
    perms = permutation_index(flow, model_device(model))

    def forward(w):
        return apply_folded(flow, folded, perms, w.to(dtype))

    return forward


def make_folded_inverse(flow, model, dtype=torch.float32):
    """Build ``g(x [B, n_flow]) -> (w [B, n_flow], jac_inv [B])``, the
    inverse of :func:`make_folded_forward`'s map (the one the sampler kernel
    computes) on the same fold of ``model``.

    The latents are uniform on the unit cube, so ``jac_inv`` is also the
    model density q(x) of the flow's distribution: the path for
    reweighting, MCMC proposals and diagnostics."""
    folded = _fold(flow, model, dtype)
    perms = permutation_index(flow, model_device(model), inverse=True)

    def inverse(x):
        return apply_folded_inverse(flow, folded, perms, x.to(dtype))

    return inverse


def make_density(flow, model, dtype=torch.float32):
    """``q(x [B, n_flow]) -> [B]``: the model density at points ``x``, the
    Jacobian of :func:`make_folded_inverse`."""
    inverse = make_folded_inverse(flow, model, dtype)

    def density(x):
        return inverse(x)[1]

    return density
