"""The eval-mode draw: one choice of method, one builder.

Counterpart of ``nf_tpu.flows.sampling``.  Every entry point that draws
samples from a flow (``sample``, ``integrate``, the sharded draws of
:mod:`nf_tpu_torch.parallel.sampling`, the unweighter's proposals) asks
:func:`resolve_method` which draw to run and :func:`make_draw` to build
it.  The methods:

  * ``fused``    -- the CUDA kernel (:mod:`nf_tpu_torch.ops.pwquad_sampler`):
    in-kernel Philox latents, folded eval-mode conditioners, one write of
    ``x`` and the Jacobian.  On a CPU model it runs the kernel's plain version.
  * ``folded``   -- the plain PyTorch eval-mode forward with BatchNorm folded
    into the weights (:mod:`nf_tpu_torch.flows.fast_eval`).
  * ``stateful`` -- the FlowModel forward, honouring train-mode BatchNorm
    (batch statistics; the running statistics are left as they are).
"""

from __future__ import annotations

import torch

from nf_tpu_torch.ops.pwquad_sampler import model_device
from nf_tpu_torch.utils import profiling


def _supported_by_kernel(flow) -> bool:
    return all(c.kind in ("pwquad", "pwlin", "affine") for c in flow.cells)


def resolve_method(flow, device, method, train=False, eval_only=False) -> str:
    """The draw's method: ``"fused"``, ``"folded"`` or ``"stateful"``.

    ``None`` / ``"auto"``: the fused kernel on a CUDA ``device`` whose flow
    the kernel covers, unless train-mode BatchNorm is asked for (``train``);
    elsewhere ``"folded"`` on an ``eval_only`` path (the sharded draws, the
    QMC map) and ``"stateful"`` on the others.  ``"fused"`` and ``"folded"``
    as given; ``"reference"`` is ``"stateful"``, which an ``eval_only`` path
    refuses, as it refuses any other name.  Anything else raises
    ``ValueError``."""
    if method in (None, "auto"):
        if not train and torch.device(device).type == "cuda" and _supported_by_kernel(flow):
            return "fused"
        return "folded" if eval_only else "stateful"
    if eval_only and method not in ("fused", "folded"):
        raise ValueError(f"mesh= sharded sampling is eval-mode only ('auto'/'fused'/"
                         f"'folded'), not {method!r}: the stateful train-mode forward needs "
                         "a single replica's batch statistics")
    if method == "reference":
        return "stateful"
    if method not in ("fused", "folded", "stateful"):
        raise ValueError(
            f"unknown sampling method {method!r}; expected one of "
            "None/'auto', 'fused', 'folded', 'reference'/'stateful'")
    return method


def seed_from(generator: torch.Generator) -> int:
    """A 62-bit kernel seed drawn from ``generator``: one host read."""
    seed = torch.randint(0, 1 << 62, (1,), generator=generator, device=generator.device)
    with profiling.span("nf.read.seed"):
        profiling.HOST_READS += 1
        return int(seed)


def _uniform(generator, shape, dtype, device):
    """The global latents of one plain draw (every rank alike)."""
    return torch.rand(shape, generator=generator, dtype=dtype, device=device)


def make_draw(flow, model, method, n, rows=None, layout="batch_major", train=False,
              dtype=torch.float32):
    """Build ``start(generator) -> draw``: ``start`` fixes the call's
    randomness and ``draw(i) -> (x [hi - lo, n_flow], jac [hi - lo])`` maps
    the rows ``rows = (lo, hi)`` (default all) of the ``i``-th batch of
    ``n`` by ``method``, one :func:`resolve_method` returned:

      * ``fused``: one kernel seed per ``start``; batch ``i`` sits at the
        Philox counter ``i n``, so the rows are one launch at ``i n + lo``.
        With ``layout="dim_major"`` the kernel writes ``x``
        dimension-major and ``x`` is its transposed view.
      * ``folded``: every ``draw`` takes the batch's global latents from the
        generator (:func:`_uniform`, in ``dtype``) and maps its rows.
      * ``stateful``: those latents through ``model.frozen_forward`` under
        ``no_grad``, BatchNorm in train mode if ``train``.

    Any other method raises ``ValueError``."""
    n = int(n)
    lo, hi = (0, n) if rows is None else rows
    if method == "fused":
        from nf_tpu_torch.ops.pwquad_sampler import build_sampler
        sampler = build_sampler(flow, model, layout=layout)

        def start(generator):
            seed = seed_from(generator)

            def draw(i):
                x, jac = sampler(seed, hi - lo, offset=i * n + lo)
                return (x.T if layout == "dim_major" else x), jac
            return draw
        return start
    if method == "folded":
        from nf_tpu_torch.flows.fast_eval import make_folded_forward
        forward = make_folded_forward(flow, model, dtype)
    elif method == "stateful":
        def forward(w):
            with torch.no_grad():
                return model.frozen_forward(w, train)
    else:
        raise ValueError(f"unknown sampling method {method!r}")
    device = model_device(model)

    def start(generator):
        def draw(i):
            return forward(_uniform(generator, (n, flow.n_flow), dtype, device)[lo:hi])
        return draw
    return start
