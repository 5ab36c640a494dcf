"""Sampler selection: fused CUDA kernel / folded PyTorch / stateful forward.

Counterpart of ``nf_tpu.flows.sampling``:

  * ``fused``    -- the CUDA kernel (:mod:`nf_tpu_torch.ops.pwquad_sampler`):
    in-kernel Philox latents, folded eval-mode conditioners, one write of
    ``x`` and the Jacobian.  On a CPU model it runs the kernel's plain version.
  * ``folded``   -- the plain PyTorch eval-mode forward with BatchNorm folded
    into the weights (:mod:`nf_tpu_torch.flows.fast_eval`).
  * ``stateful`` -- the FlowModel forward, honouring train-mode BatchNorm
    (batch statistics; the running statistics are left as they are).

``default_method`` is the one selection policy; ``make_sampler`` takes a
method already chosen and returns ``fn(generator) -> (x, jac)`` for every
method.
"""

from __future__ import annotations

import torch

from nf_tpu_torch.ops.pwquad_sampler import model_device
from nf_tpu_torch.utils import profiling


def supported_by_kernel(flow) -> bool:
    return all(c.kind in ("pwquad", "pwlin", "affine") for c in flow.cells)


def default_method(flow, device, train=None) -> str:
    """``"stateful"`` when train mode is asked for, else ``"fused"`` on a
    CUDA device and ``"folded"`` elsewhere."""
    if train:
        return "stateful"
    if torch.device(device).type == "cuda" and supported_by_kernel(flow):
        return "fused"
    return "folded"


def seed_from(generator: torch.Generator) -> int:
    """A 62-bit kernel seed drawn from ``generator``: one host read."""
    seed = torch.randint(0, 1 << 62, (1,), generator=generator, device=generator.device)
    with profiling.span("nf.read.seed"):
        profiling.HOST_READS += 1
        return int(seed)


def make_sampler(flow, model, n, method, train=False, dtype=torch.float32):
    """Build ``fn(generator) -> (x [n, n_flow], jac [n])`` drawing ``n``
    samples by ``method`` ('fused', 'folded' or 'stateful').  ``train`` only
    affects the stateful path (BatchNorm mode)."""
    device = model_device(model)
    if method == "fused":
        from nf_tpu_torch.ops.pwquad_sampler import build_sampler
        sampler = build_sampler(flow, model)

        def fn(generator):
            return sampler(seed_from(generator), n)
    elif method == "folded":
        from nf_tpu_torch.flows.fast_eval import make_folded_forward
        fwd = make_folded_forward(flow, model, dtype)

        def fn(generator):
            w = torch.rand((n, flow.n_flow), generator=generator, dtype=dtype,
                           device=device)
            return fwd(w)
    elif method == "stateful":
        def fn(generator):
            w = torch.rand((n, flow.n_flow), generator=generator, dtype=dtype,
                           device=device)
            with torch.no_grad():
                return model.frozen_forward(w, train)
    else:
        raise ValueError(f"unknown sampling method {method!r}")
    return fn
