"""Fused eval-mode sampler: host BN fold, plan encoding and the kernel wrapper.

The kernel, ``csrc/pwquad_sampler.cu``, maps latent points through every
coupling cell of a flow in eval mode in one pass and writes ``x`` and the
Jacobian once.  It replaces nf_tpu's Pallas TPU kernel
(``nf_tpu/ops/pwquad_sampler.py::build_sampler``).  This module holds

  * :func:`fold_eval_params`: eval BatchNorm folded into the adjacent linear
    layers on the host, in float64, so each conditioner is a bare
    dense+bias+ReLU MLP;
  * :func:`plan_descriptor` / :func:`encode_plan`: the flow plan as an int32
    descriptor plus one flat float32 weight buffer, the two operands the
    kernel reads (the training kernels read the same two);
  * :func:`philox_uniform`: the kernel's Philox4x32-10 latent stream in
    numpy, so the seeded variant has an exact plain version;
  * :func:`build_sampler`: checks, allocation, launch and the launch count.
    A model on the CPU takes the plain version
    (:func:`nf_tpu_torch.flows.fast_eval.make_folded_forward`); a model on a
    CUDA device launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from nf_tpu_torch.flows.model import permutation_source
from nf_tpu_torch.interop import to_numpy

# Launches of the CUDA kernel since import (or since a caller reset it).
LAUNCHES = 0

# Per-thread array caps compiled into the kernel (csrc/pwquad_sampler.cu).
MAX_FLOW = 32      # latent dims
MAX_HIDDEN = 64    # width of any conditioner layer but the last
MAX_BINS = 32      # bins of a pwquad / pwlin cell
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90

OP_PERM, OP_CELL = 0, 1
KIND = {"pwquad": 0, "pwlin": 1, "affine": 2}
ACT = {"exp": 0, "squareplus": 1}


def model_device(model) -> torch.device:
    return next(model.buffers()).device


# ---------------------------------------------------------------------------
# Host-side parameter folding
# ---------------------------------------------------------------------------

def _fold_conditioner(params, state, eps=1e-5, dtype=np.float32):
    """Collapse eval-mode [BN] Linear [BN] chains into ``(W, b, relu)``
    triples, computed in float64 and cast to ``dtype``.

    Eval BatchNorm is affine: y = (x - m) / sqrt(v + eps) * g + b.  Hidden
    layers carry ``relu=True``; a factored final layer (``final_rank``) gives
    TWO ReLU-free triples (u then v), kept factored so the kernel's FMA count
    follows the factor shapes.
    """
    f64 = lambda a: np.asarray(a, dtype=np.float64)  # noqa: E731

    def bn_affine(p, s):
        scale = f64(p["scale"]) / np.sqrt(f64(s["var"]) + eps)
        return scale, f64(p["bias"]) - f64(s["mean"]) * scale

    layers = []
    s_in, t_in = bn_affine(params["bn_in"], state["bn_in"])
    for i, lin in enumerate(params["linears"]):
        w = f64(lin["w"])
        b = f64(lin["b"]) if "b" in lin else np.zeros(w.shape[1])
        if i == 0:
            w, b = s_in[:, None] * w, t_in @ w + b
        s_o, t_o = bn_affine(params["bns"][i], state["bns"][i])
        layers.append((w * s_o[None, :], b * s_o + t_o, True))
    fin = params["final"]
    first = f64(fin["u"] if "u" in fin else fin["w"])
    bias = np.zeros(first.shape[1]) if "u" in fin else f64(fin["b"])
    if not params["linears"]:
        # no hidden layers: fold the input BN into the first final factor
        first, bias = s_in[:, None] * first, t_in @ first + bias
    layers.append((first, bias, False))
    if "u" in fin:
        layers.append((f64(fin["v"]), f64(fin["b"]), False))
    return [(w.astype(dtype), b.astype(dtype), relu) for w, b, relu in layers]


def fold_eval_params(flow, model, dtype=np.float32):
    """Fold every cell of ``model``: one list of ``(W, b, relu)`` per cell,
    ``W`` in ``[fan_in, fan_out]`` layout."""
    params, state = to_numpy(model)
    return [_fold_conditioner(p, s, dtype=dtype) for p, s in zip(params, state)]


# ---------------------------------------------------------------------------
# Plan encoding (the kernel's two operands)
# ---------------------------------------------------------------------------

def plan_descriptor(flow, shapes):
    """Return ``(desc int32[...], n_weights)`` for a flow whose cell ``c`` has
    folded layers of ``shapes[c] = [(fan_in, fan_out, relu), ...]``.

    ``desc = [n_flow, n_ops, op...]`` where each op is either
      ``[OP_PERM, src_0 .. src_{n_flow-1}]`` (x_new[d] = x[src_d]) or
      ``[OP_CELL, kind, pass_through, n_bins, act, n_layers,
        (fan_in, fan_out, relu, w_offset, b_offset) * n_layers]``
    with offsets in floats into one flat weight buffer, filled in ops order;
    ``W`` is row-major ``[fan_in, fan_out]``.  Raises if the plan exceeds the
    kernels' caps.  The training kernels share this layout.
    """
    n_flow = flow.n_flow
    if n_flow > MAX_FLOW:
        raise ValueError(f"fused kernel: n_flow {n_flow} > MAX_FLOW {MAX_FLOW}")
    desc = [n_flow, len(flow.ops)]
    n_weights = 0
    for op in flow.ops:
        if op[0] != "cell":
            desc += [OP_PERM] + permutation_source(op, n_flow).tolist()
            continue
        cfg = flow.cells[op[1]]
        if cfg.kind not in KIND:
            raise ValueError(f"fused kernel: unsupported cell kind {cfg.kind!r}")
        n_bins = cfg.n_bins or 0
        if n_bins > MAX_BINS:
            raise ValueError(f"fused kernel: n_bins {n_bins} > MAX_BINS {MAX_BINS}")
        layers = shapes[op[1]]
        desc += [OP_CELL, KIND[cfg.kind], cfg.pass_through, n_bins,
                 ACT[cfg.activation], len(layers)]
        for li, (fan_in, fan_out, relu) in enumerate(layers):
            # every layer's input, and every output but the streamed last
            # layer's, lives in a per-thread array of MAX_HIDDEN floats
            if fan_in > MAX_HIDDEN or (li < len(layers) - 1 and fan_out > MAX_HIDDEN):
                raise ValueError(f"fused kernel: layer {fan_in}x{fan_out} "
                                 f"exceeds MAX_HIDDEN {MAX_HIDDEN}")
            desc += [fan_in, fan_out, int(relu), n_weights, n_weights + fan_in * fan_out]
            n_weights += fan_in * fan_out + fan_out
    return np.asarray(desc, dtype=np.int32), n_weights


def encode_plan(flow, folded):
    """Return ``(desc int32[...], weights float32[...])``: the descriptor of
    :func:`plan_descriptor` and the folded weights laid out as it says."""
    desc, _ = plan_descriptor(
        flow, [[(*wm.shape, relu) for wm, _, relu in layers] for layers in folded])
    weights = [a.reshape(-1) for op in flow.ops if op[0] == "cell"
               for wm, bv, _ in folded[op[1]] for a in (wm, bv)]
    weights = np.concatenate(weights).astype(np.float32) if weights \
        else np.zeros(0, np.float32)
    smem = 4 * (desc.size + weights.size)
    if smem > SMEM_LIMIT:
        raise ValueError(f"fused sampler: plan needs {smem} B of shared memory "
                         f"> {SMEM_LIMIT}")
    return desc, weights


# ---------------------------------------------------------------------------
# The kernel's latent stream
# ---------------------------------------------------------------------------

_M0, _M1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
_W0, _W1 = np.uint64(0x9E3779B9), np.uint64(0xBB67AE85)
_MASK = np.uint64(0xFFFFFFFF)


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 (Salmon et al. 2011) on uint64 arrays holding 32-bit
    words; returns the four output words."""
    c0, c1, c2, c3 = (np.asarray(c, np.uint64) for c in (c0, c1, c2, c3))
    k0, k1 = np.uint64(k0), np.uint64(k1)
    s32 = np.uint64(32)
    for _ in range(10):
        p0, p1 = _M0 * c0, _M1 * c2
        c0, c1, c2, c3 = ((p1 >> s32) ^ c1 ^ k0, p1 & _MASK,
                          (p0 >> s32) ^ c3 ^ k1, p0 & _MASK)
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def philox_uniform(seed: int, offset: int, n: int, n_flow: int) -> np.ndarray:
    """The seeded kernel's latents: float32 ``[n, n_flow]`` in [0, 1).

    Sample ``i``, dim ``d`` takes word ``d % 4`` of Philox4x32-10 with
    counter ``(lo(i+offset), hi(i+offset), d // 4, 0)`` and key
    ``(lo(seed), hi(seed))``; its top 24 bits times 2^-24 is the uniform, so
    1.0 never occurs.
    """
    seed &= (1 << 64) - 1
    idx = np.arange(n, dtype=np.uint64) + np.uint64(offset)
    out = np.empty((n, n_flow), np.float32)
    for blk in range(-(-n_flow // 4)):
        words = philox4x32_10(idx & _MASK, idx >> np.uint64(32),
                              np.full(n, blk, np.uint64), np.zeros(n, np.uint64),
                              seed & 0xFFFFFFFF, seed >> 32)
        for j, word in enumerate(words[: n_flow - 4 * blk]):
            out[:, 4 * blk + j] = (word >> np.uint64(8)).astype(np.float32) \
                * np.float32(1.0 / (1 << 24))
    return out


# ---------------------------------------------------------------------------
# Sampler construction
# ---------------------------------------------------------------------------

def _launch(desc, weights, latents, seed, offset, n, n_flow, dim_major):
    """One kernel launch on the current stream; returns ``(x, jac)``."""
    global LAUNCHES
    from nf_tpu_torch.ops import _build

    lib = _build.library()
    device = desc.device
    x = torch.empty((n_flow, n) if dim_major else (n, n_flow),
                    dtype=torch.float32, device=device)
    jac = torch.empty(n, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.nf_pwquad_sampler(
            desc.data_ptr(), desc.numel(), weights.data_ptr(), weights.numel(),
            latents.data_ptr() if latents is not None else None,
            seed & ((1 << 64) - 1), offset, x.data_ptr(), jac.data_ptr(), n,
            int(dim_major), stream)
    if err != 0:
        raise RuntimeError(f"pwquad_sampler kernel launch failed: {_build.error_string(err)}")
    LAUNCHES += 1
    return x, jac


def build_sampler(flow, model, take_latents: bool = False,
                  layout: str = "batch_major"):
    """Fused eval-mode sampler for ``model`` (a FlowModel of ``flow``).

    Returns ``sample(seed, n, offset=0) -> (x, jac)``, or with
    ``take_latents=True`` ``sample(latents [n, n_flow] f32) -> (x, jac)``.
    ``x`` is ``[n, n_flow]`` (``layout="batch_major"``) or ``[n_flow, n]``
    (``"dim_major"``), float32; ``jac`` is ``[n]``.  The seeded variant draws
    latents with Philox (:func:`philox_uniform`); disjoint ``offset`` ranges
    give disjoint streams for one seed.

    The weights are folded and encoded once, here.  On a CUDA device every
    call launches the kernel; on the CPU it runs the plain version.
    """
    from nf_tpu_torch.flows.fast_eval import make_folded_forward

    if layout not in ("batch_major", "dim_major"):
        raise ValueError(f"unknown layout {layout!r}")
    dim_major = layout == "dim_major"
    n_flow = flow.n_flow
    device = model_device(model)
    if device.type == "cuda":
        desc, weights = (torch.as_tensor(a, device=device)
                         for a in encode_plan(flow, fold_eval_params(flow, model)))
    elif device.type == "cpu":
        plain = make_folded_forward(flow, model, torch.float32)
    else:
        raise ValueError(f"fused sampler: unsupported device {device}")

    def run(latents, seed, offset, n):
        if device.type == "cuda":
            return _launch(desc, weights, latents, seed, offset, n, n_flow, dim_major)
        if latents is None:
            latents = torch.from_numpy(philox_uniform(seed, offset, n, n_flow))
        x, jac = plain(latents)
        return (x.T.contiguous() if dim_major else x), jac

    if take_latents:
        def sample(latents):
            if latents.device != device:
                raise ValueError(f"latents on {latents.device}, model on {device}")
            if latents.dtype != torch.float32:
                raise TypeError(f"latents must be float32, got {latents.dtype}")
            if latents.dim() != 2 or latents.shape[1] != n_flow:
                raise ValueError(f"latents must be [n, {n_flow}], got {tuple(latents.shape)}")
            if not latents.is_contiguous():
                raise ValueError("latents must be contiguous")
            return run(latents, 0, 0, latents.shape[0])
    else:
        def sample(seed, n, offset=0):
            if n < 0 or offset < 0:
                raise ValueError("n and offset must be non-negative")
            return run(None, int(seed), int(offset), int(n))
    return sample
