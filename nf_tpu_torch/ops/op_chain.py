"""The op-chain kernel of the per-op cost calibration (``csrc/op_chain.cu``).

Counterpart of ``tools/calibrate_vpu_ops.py``'s ``build_chain_kernel``: for
each grid step ``i`` a ``[32, 128]`` float32 tile ``y = lane / 128 + 0.5 +
1e-6 * i + 1e-6 * seed``, one of ten elementwise ops applied ``k`` times,
and the ``[32, 128]`` sum over the grid steps.  Timed at two ``k``
(``nf_tpu_torch/tools/calibrate_ops.py``), the difference is what ``k``
more steps of the op cost.  This module holds

  * ``OPS`` and ``CHAINS``: the ten steps as torch expressions, each
    rounded as the kernel rounds it (``fma`` as one fused multiply-add,
    every other add and multiply on its own);
  * :func:`chain_ref`, the plain version, which sums in the kernel's order;
  * the wrapper :func:`chain` with its launch count ``LAUNCHES``.

The wrapper runs the plain version for the CPU and launches the kernel for
a CUDA device, or raises.  The kernel is unrolled at compile time for each
``k`` in ``KS``.
"""

from __future__ import annotations

import numpy as np
import torch

# Launches of the kernel since import (or since a caller reset it).
LAUNCHES = 0

LANE, SUB = 128, 32
TILE = LANE * SUB
# grid steps a warp of the kernel adds into one partial row
CHUNK = 32
# the chain lengths the kernel is unrolled for
KS = (64, 320)


def _f32(v):
    return float(np.float32(v))


def _fma(y):
    # one rounding: the product of two float32 and the float32 addend are
    # exact in float64 here (y in (0.5, 2), the constant 1 - 2^-10)
    return (y.double() * _f32(0.9990234375) + _f32(0.001)).float()


def _select(y):
    return torch.where(y > 1.0, y * _f32(0.9), y * _f32(1.05) + _f32(0.01))


# op -> one chain step (the order is the kernel's op index)
CHAINS = {
    "fma": _fma,
    "mul": lambda y: y * _f32(0.9999),
    "add": lambda y: y + _f32(0.001),
    "exp": lambda y: torch.exp(y * 0.0009765625),
    "sqrt": lambda y: torch.sqrt(y + 1.0),
    "rsqrt": lambda y: torch.rsqrt(y + 1.0),
    # a tensor numerator: torch computes ``2.0 / t`` as reciprocal(t) * 2
    "div": lambda y: torch.full_like(y, 2.0) / (y + 1.0),
    "log": lambda y: torch.log(y + 2.0),
    "tanh": lambda y: torch.tanh(y) + 0.5,
    "select": _select,
}
OPS = tuple(CHAINS)


def _check(op, k, grid):
    if op not in CHAINS:
        raise ValueError(f"unknown op {op!r}: one of {', '.join(OPS)}")
    if int(k) != k or k < 0 or int(grid) != grid or not 1 <= grid <= 1 << 24:
        raise ValueError(f"k must be an integer >= 0 and grid in [1, 2^24], not {k}, {grid}")


def chain_ref(op, k, grid, seed, device):
    """The plain version: the ``[32, 128]`` float32 sum over ``grid`` steps
    of ``k`` steps of ``op`` from each grid step's start.  Every grid step
    at once, the ``k`` steps one after another; the sum adds each run of 32
    grid steps in order into a partial row and the partial rows in order,
    as the kernel does (for up to 32 grid steps the Pallas kernel's own
    order)."""
    _check(op, k, grid)
    step = CHAINS[op]
    lane = torch.arange(LANE, dtype=torch.float32, device=device) / LANE
    i = torch.arange(grid, dtype=torch.float32, device=device)
    start = (lane + 0.5)[None, :] + (_f32(1e-6) * i)[:, None]
    start = start + torch.tensor(float(seed), dtype=torch.float32) * _f32(1e-6)
    y = start[:, None, :].expand(grid, SUB, LANE).contiguous()
    for _ in range(k):
        y = step(y)
    out = torch.zeros((SUB, LANE), dtype=torch.float32, device=device)
    for c in range(0, grid, CHUNK):
        part = torch.zeros_like(out)
        for j in range(c, min(c + CHUNK, grid)):
            part = part + y[j]
        out = out + part
    return out


def chain(op, k, grid, seed, device="cuda", *, repeats=1, out=None, scratch=None):
    """The chain's ``[32, 128]`` sum, as :func:`chain_ref`.  On the CPU the
    plain version.  On a CUDA device the kernel, launched ``repeats`` times
    back to back on the current stream (each launch writes the same sum;
    ``LAUNCHES`` counts each), into ``out`` if given, with ``scratch``
    (``ceil(grid / 32) * 4096`` float32) if given; ``k`` must be one of
    ``KS``.  A failed build or launch raises."""
    global LAUNCHES
    device = torch.device(device)
    if device.type == "cpu":
        return chain_ref(op, k, grid, seed, device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    _check(op, k, grid)
    if k not in KS:
        raise ValueError(f"the kernel is unrolled for k in {KS}, not {k}")
    if repeats < 1:
        raise ValueError(f"repeats must be >= 1, not {repeats}")
    rows = -(-grid // CHUNK)
    if out is None:
        out = torch.empty((SUB, LANE), dtype=torch.float32, device=device)
    if scratch is None:
        scratch = torch.empty(rows * TILE, dtype=torch.float32, device=device)
    for t, size in ((out, TILE), (scratch, rows * TILE)):
        if t.device != device or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.numel() < size:
            raise ValueError(f"out and scratch must be contiguous float32 on {device}, "
                             f"at least {TILE} and {rows * TILE} elements")
    from nf_tpu_torch.ops import _build

    err = _build.library().nf_op_chain(
        OPS.index(op), int(k), int(grid), int(seed), int(repeats), scratch.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"op_chain kernel launch failed: {_build.error_string(err)}")
    LAUNCHES += repeats
    return out
