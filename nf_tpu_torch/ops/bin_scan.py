"""The bin-axis scan (``csrc/bin_scan.cu``): the inclusive prefix sum along
the last axis that the piecewise-linear and piecewise-quadratic coupling
cells take over their bins (:mod:`nf_tpu_torch.bijectors.coupling`).

Replaces no TPU kernel: nf_tpu leaves its bin-axis ``jnp.cumsum`` to XLA.
It was added because torch's own kernel for a cumsum over a short last axis
ran ~150x slower than its bytes allow on an H100 (~1.9 ms for a
[2^16 x 5, 16] float32 tensor against a 12.5 us bound at 3.35 TB/s), 75% of
the learned multi-channel trainer's device time (PERF.md).  This module holds

  * :func:`bin_cumsum_ref`, the plain version: ``torch.cumsum(x, -1)``, and
    for ``reverse`` the sum from the right, as torch takes a cumsum's
    gradient; :func:`bin_cumsum_ordered`, the same sums added in the
    kernel's order;
  * :func:`bin_cumsum`, the autograd Function ``_BinScan``: the plain
    version on the CPU, the kernel on a CUDA device; its gradient is the
    same scan in the other direction, and its ``vmap`` rule moves the
    vmapped axis to the front, so ``torch.func.vmap`` over ``grad`` (the
    ensemble) takes the kernel too.

Each launch adds one to ``profiling.BIN_SCAN_LAUNCHES``.
"""

from __future__ import annotations

import torch


def bin_cumsum_ref(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """The plain version: the inclusive prefix sum along the last axis, from
    the right for ``reverse`` (``flip``, ``cumsum``, ``flip``)."""
    if reverse:
        return x.flip(-1).cumsum(-1).flip(-1)
    return torch.cumsum(x, dim=-1)


def bin_cumsum_ordered(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """The kernel's order of adds in plain torch: each row summed one column
    after another from the left (from the right for ``reverse``), one
    rounding an add, in ``x``'s type; the card's checks hold the kernel to it
    bit for bit."""
    cols = list(x.unbind(-1))
    out, acc = [None] * len(cols), None
    for j in (range(len(cols) - 1, -1, -1) if reverse else range(len(cols))):
        acc = cols[j] if acc is None else acc + cols[j]
        out[j] = acc
    return torch.stack(out, -1)


def _launch(x: torch.Tensor, reverse: bool) -> torch.Tensor:
    """The kernel on ``x``'s device (made current for the launch) and its
    current stream, into a new contiguous tensor; a non-contiguous ``x`` is
    made contiguous first.  A failed build or launch raises."""
    from nf_tpu_torch.ops import _build
    from nf_tpu_torch.utils import profiling

    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"bin_cumsum takes float32 or float64 on the card, not {x.dtype}")
    x = x.contiguous()
    y = torch.empty_like(x)
    n = x.shape[-1]
    if y.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        err = _build.library().nf_bin_scan(
            x.data_ptr(), y.data_ptr(), x.numel() // n, n, int(x.dtype == torch.float64),
            int(reverse), torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"bin_scan kernel launch failed: {_build.error_string(err)}")
    profiling.BIN_SCAN_LAUNCHES += 1
    return y


class _BinScan(torch.autograd.Function):
    """The scan of :func:`bin_cumsum`; ``reverse`` scans from the right.
    Linear in ``x``: its gradient is the scan from the other side."""

    @staticmethod
    def forward(x, reverse):
        if x.dim() == 0:
            raise ValueError("bin_cumsum needs a tensor with a last axis")
        return _launch(x, reverse) if x.is_cuda else bin_cumsum_ref(x, reverse)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.reverse = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return bin_cumsum(grad, not ctx.reverse), None

    @staticmethod
    def vmap(info, in_dims, x, reverse):
        if in_dims[0] is None:
            return bin_cumsum(x, reverse), None
        return bin_cumsum(x.movedim(in_dims[0], 0), reverse), 0


def bin_cumsum(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """``torch.cumsum(x, -1)`` (from the right for ``reverse``): on the CPU
    the plain version, on a CUDA device the kernel (float32 or float64), with
    their gradient; anything else the kernel refuses raises."""
    return _BinScan.apply(x, reverse)
