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
  * the launch layout the sampler and the training forward share, counted
    here and checked by the C entry points: :func:`op_table` (the row table
    that stands in for the permutations), :func:`tile_rows` and
    :func:`padded_weights`; and the launch rule, :func:`best_launch` over
    block sizes and the weights' place by :func:`blocks_per_sm`;
  * :class:`SamplerPlan`, with its kernel chosen by the plan's widths
    (:func:`sampler_kernel_for`: the per-thread kernel, or the tiled one
    for wide plans) and that kernel's launch (:func:`sampler_smem_bytes` and
    :func:`sampler_config`; :func:`sampler_tiled_smem_bytes` and
    :func:`sampler_tiled_config`);
  * :func:`philox_uniform`: the kernel's Philox4x32-10 latent stream in
    numpy, so the seeded variant has an exact plain version;
  * :func:`build_sampler`: checks, allocation, launch and the launch counts
    (``LAUNCHES``; ``SAMPLER_TILED_LAUNCHES`` the tiled kernel's alone).
    A model on the CPU takes the plain version
    (:func:`nf_tpu_torch.flows.fast_eval.make_folded_forward`); a model on a
    CUDA device launches the kernel or raises.

The only plan a kernel refuses is one whose tiles do not fit one block's
shared memory at its smallest block size (:data:`SMALL_BLOCKS`); it raises
``ValueError``, and nothing falls back to the plain version on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from nf_tpu_torch import interop
from nf_tpu_torch.flows.model import permutation_source
from nf_tpu_torch.utils import profiling

# Launches of the CUDA kernels since import (or since a caller reset them):
# either kernel, and the tiled kernel alone.
LAUNCHES = 0
SAMPLER_TILED_LAUNCHES = 0

# The launch shape compiled into csrc/pwquad_sampler.cu, the block sizes
# sampler_config picks from, and the most threads of its grid (each block
# loops over several tiles above it).
SAMPLER_MAX_BLOCK = 512
SAMPLER_BLOCKS = (128, 256, 512)
SAMPLER_MAX_THREADS = 1 << 20
# The tiled kernel's largest block (compiled in), the block sizes
# sampler_tiled_config picks from, and the blocks of SAMPLER_TILED_BLOCK an
# SM holds by its registers: the minimum its __launch_bounds__ asks of
# ptxas, which then caps a thread at 128 registers (checked against the CUDA
# occupancy calculator by a card test).
SAMPLER_TILED_BLOCK = 128
SAMPLER_TILED_BLOCKS = (128, 64)
SAMPLER_TILED_MIN_BLOCKS = 4
# A plan with a layer (a hidden layer's outputs or a last layer's inputs)
# at least this wide runs the tiled kernel where a launch of it fits: its
# products in register tiles pay for the barriers they add.  Narrower
# plans (camel, the 10-D flagship) keep the per-thread kernel.
SAMPLER_TILED_MIN_WIDTH = 32
# Block sizes every kernel's launch rule falls back to where none of its own
# fits shared memory.
SMALL_BLOCKS = (64, 32)

# An H100's shared memory per block and per SM, what the runtime reserves
# per block, an SM's threads and blocks (CUDA C++ Programming Guide,
# compute capability 9.0), and the SMs of an H100 SXM.
SMEM_LIMIT = 232448
SM_SMEM = 233472
SMEM_PER_BLOCK_RESERVED = 1024
SM_THREADS = 2048
SM_BLOCKS = 32
SM_COUNT = 132

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
    with profiling.span("nf.read.fold"):
        params, state = interop.to_numpy(model)
    return [_fold_conditioner(p, s, dtype=dtype) for p, s in zip(params, state)]


# ---------------------------------------------------------------------------
# Plan encoding (the kernel's two operands)
# ---------------------------------------------------------------------------

def layer_shapes(cfg):
    """``((fan_in, fan_out, relu), ...)`` of a cell's folded conditioner: the
    hidden layers, then the final layer, or its two factors with
    ``final_rank``."""
    shapes, prev = [], cfg.pass_through
    for width in cfg.nn_sizes[:-1]:
        shapes.append((prev, width, True))
        prev = width
    out = cfg.nn_sizes[-1]
    if cfg.final_rank is None:
        return tuple(shapes) + ((prev, out, False),)
    return tuple(shapes) + ((prev, cfg.final_rank, False), (cfg.final_rank, out, False))


def plan_descriptor(flow, shapes):
    """Return ``(desc int32[...], n_weights)`` for a flow whose cell ``c`` has
    folded layers of ``shapes[c] = [(fan_in, fan_out, relu), ...]``.

    ``desc = [n_flow, n_ops, op...]`` where each op is either
      ``[OP_PERM, src_0 .. src_{n_flow-1}]`` (x_new[d] = x[src_d]) or
      ``[OP_CELL, kind, pass_through, n_bins, act, n_layers,
        (fan_in, fan_out, relu, w_offset, b_offset) * n_layers]``
    with offsets in floats into one flat weight buffer, filled in ops order;
    ``W`` is row-major ``[fan_in, fan_out]``.  Raises only for a cell kind
    the kernels do not know.  The training kernels share this layout.
    """
    n_flow = flow.n_flow
    desc = [n_flow, len(flow.ops)]
    n_weights = 0
    for op in flow.ops:
        if op[0] != "cell":
            desc += [OP_PERM] + permutation_source(op, n_flow).tolist()
            continue
        cfg = flow.cells[op[1]]
        if cfg.kind not in KIND:
            raise ValueError(f"fused kernel: unsupported cell kind {cfg.kind!r}")
        layers = shapes[op[1]]
        desc += [OP_CELL, KIND[cfg.kind], cfg.pass_through, cfg.n_bins or 0,
                 ACT[cfg.activation], len(layers)]
        for fan_in, fan_out, relu in layers:
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
    return desc, weights


# ---------------------------------------------------------------------------
# The launch layout of the tiled kernels (csrc/flow_plan.cuh)
# ---------------------------------------------------------------------------

def logit_width(cfg):
    """The last layer's logits per transformed dimension of a cell:
    ``2 n_bins + 1`` for pwquad, ``n_bins`` for pwlin, 2 for affine."""
    return {"pwquad": 2 * (cfg.n_bins or 0) + 1, "pwlin": cfg.n_bins or 0,
            "affine": 2}[cfg.kind]


def round4(v):
    return -(-v // 4) * 4


def _cell_ops(flow, shapes):
    """``(cfg, layers)`` of every cell op of ``flow``, in op order."""
    return [(flow.cells[op[1]], shapes[op[1]]) for op in flow.ops if op[0] == "cell"]


def op_table(flow, shapes):
    """The tiled kernels' int32 row table: ``[n_cell_ops``, each cell op's
    position in the descriptor, then, for each cell op and once more for the
    end of the flow, the row of the kernel's state tile that holds each of
    the ``n_flow`` logical dimensions``]``.  The kernels' permutations move
    no data: each one only changes which row holds which dimension.  Cell
    ops may come in any order, and a cell may be applied more than once."""
    n_flow = flow.n_flow
    rows = np.arange(n_flow)
    pos, maps, p = [], [], 2
    for op in flow.ops:
        if op[0] == "cell":
            pos.append(p)
            maps.append(rows)
            p += 6 + 5 * len(shapes[op[1]])
        else:   # x_new[d] = x[src[d]]
            rows = rows[permutation_source(op, n_flow)]
            p += 1 + n_flow
    return np.concatenate([[len(pos)], pos, *maps, rows]).astype(np.int32)


def tile_rows(flow, shapes):
    """``(rows_a, rows_b)``: the rows of the conditioner tiles A and B.  Of a
    cell's hidden layers (all but the last), the last writes A, the one
    before it B, and so on back; B also holds the last layer's logits of one
    transformed dimension at a time (:func:`logit_width`)."""
    rows = [0, 0]
    for cfg, layers in _cell_ops(flow, shapes):
        hidden = layers[:-1]
        for li, (_, fan_out, _) in enumerate(hidden):
            tile = (len(hidden) - 1 - li) % 2
            rows[tile] = max(rows[tile], fan_out)
        rows[1] = max(rows[1], logit_width(cfg))
    return tuple(rows)


def padded_weights(flow, shapes):
    """Floats of the copy of the weights in shared memory, where every row of
    a layer (its bias too) is padded to a multiple of four: a hidden layer's
    outputs, or the last layer's logits of each transformed dimension."""
    total = 0
    for cfg, layers in _cell_ops(flow, shapes):
        for li, (fan_in, fan_out, _) in enumerate(layers):
            ld = (round4(fan_out) if li < len(layers) - 1
                  else (flow.n_flow - cfg.pass_through) * round4(logit_width(cfg)))
            total += (fan_in + 1) * ld
    return total


def blocks_per_sm(smem, block, sm_threads=SM_THREADS):
    """Blocks of ``block`` threads and ``smem`` bytes of shared memory that
    one H100 SM holds at once, by shared memory, threads and its block limit.
    ``sm_threads`` is the most threads the kernel's registers leave
    resident; by default the SM's thread limit, which counts no registers
    (ptxas reports them on the card)."""
    return min(SM_SMEM // (smem + SMEM_PER_BLOCK_RESERVED), sm_threads // block, SM_BLOCKS)


def best_launch(blocks, smem_bytes, smem_first=False, what="kernel", sm_threads=SM_THREADS,
                min_blocks=2):
    """Of the block sizes ``blocks``, with the weights in shared memory or
    read through L1, the launch ``(block, w_smem)`` that keeps the most
    threads resident on an SM while at least ``min_blocks`` (two) blocks
    share it (so that one block's barrier leaves the SM another's work); on
    a tie, the weights in shared memory, then the largest block (fewer
    barriers per sample).  With ``smem_first``, the weights in shared memory
    come before the resident threads.  ``smem_bytes(block, w_smem)`` is a
    block's shared memory; only launches that fit it are candidates.  Where
    none of ``blocks`` fits, :data:`SMALL_BLOCKS` are
    tried by the same rule; where none of those fits either, raises
    ``ValueError``.  ``sm_threads``: as for :func:`blocks_per_sm`."""
    def rank(config):
        block, w_smem = config
        k = blocks_per_sm(smem_bytes(block, w_smem), block, sm_threads)
        return (k >= min_blocks, w_smem, k * block, block) if smem_first else \
            (k >= min_blocks, k * block, w_smem, block)

    for sizes in (blocks, SMALL_BLOCKS):
        configs = [(b, w) for b in sizes for w in (True, False)
                   if blocks_per_sm(smem_bytes(b, w), b, sm_threads) >= 1]
        if configs:
            return max(configs, key=rank)
    raise ValueError(f"{what}: no launch fits the plan; at {SMALL_BLOCKS[-1]} threads a "
                     f"block needs {smem_bytes(SMALL_BLOCKS[-1], False)} B of shared "
                     f"memory > {SMEM_LIMIT}")


class SamplerPlan:
    """A flow's descriptor, row table, tile rows and padded weights as the
    sampler kernels read them, the kernel that runs it
    (:func:`sampler_kernel_for`) and that kernel's launch; raises
    ``ValueError`` where no launch fits."""

    def __init__(self, flow):
        self.flow = flow
        self.shapes = [layer_shapes(cfg) for cfg in flow.cells]
        self.desc, self.n_weights = plan_descriptor(flow, self.shapes)
        self.table = op_table(flow, self.shapes)
        self.tiles = tile_rows(flow, self.shapes)
        self.n_wpad = padded_weights(flow, self.shapes)
        self.copies = tiled_copies(flow, self.shapes)
        self.kernel = sampler_kernel_for(self)
        self.config = launch_config(self, self.kernel)


def sampler_smem_bytes(plan, block, w_smem=True):
    """Shared memory of one sampler block of ``block`` threads: the
    descriptor and the row table (padded to four int32s); with ``w_smem``
    the padded weights (:func:`padded_weights`); and the X, A and B tiles (a
    row of ``block + 1`` floats per feature).  ``nf_pwquad_sampler`` refuses
    a launch whose count differs from its own."""
    rows_a, rows_b = plan.tiles
    return 4 * (round4(plan.desc.size + plan.table.size) + (plan.n_wpad if w_smem else 0)
                + (plan.flow.n_flow + rows_a + rows_b) * (block + 1))


def sampler_config(plan):
    """``(block, w_smem)`` of the sampler for ``plan``, by :func:`best_launch`
    over :data:`SAMPLER_BLOCKS`, the weights in shared memory first: each
    activation load feeds four FMAs whose weights are one float4 from shared
    memory, against four loads through L1 (the training forward's rule,
    which reads the same layers the same way)."""
    return best_launch(SAMPLER_BLOCKS, lambda b, w: sampler_smem_bytes(plan, b, w),
                       smem_first=True, what="fused sampler")


def tiled_copies(flow, shapes):
    """``(wh, wl)``: the tiled sampler's copies of the weights in shared
    memory, in floats: the largest of a cell's hidden layers, and of one
    transformed dimension's columns of a last layer, each row padded to a
    multiple of four floats and the bias a last row."""
    wh = wl = 0
    for cfg, layers in _cell_ops(flow, shapes):
        wh = max(wh, sum((fi + 1) * round4(fo) for fi, fo, _ in layers[:-1]))
        wl = max(wl, (layers[-1][0] + 1) * round4(logit_width(cfg)))
    return wh, wl


def sampler_tiled_smem_bytes(plan, block, w_smem=True):
    """Shared memory of one tiled sampler block of ``block`` threads (a tile
    of ``block`` samples): the descriptor and the row table (padded to four
    int32s); with ``w_smem`` the weights' copies (:func:`tiled_copies`); and
    the X, A and B tiles of :func:`tile_rows`, a row of ``block + 4`` floats
    per feature.  ``nf_pwquad_sampler_tiled`` refuses a launch whose count
    differs from its own."""
    rows_a, rows_b = plan.tiles
    return 4 * (round4(plan.desc.size + plan.table.size) + (sum(plan.copies) if w_smem else 0)
                + (plan.flow.n_flow + rows_a + rows_b) * (block + 4))


def sampler_tiled_config(plan):
    """``(block, w_smem)`` of the tiled sampler for ``plan``, by
    :func:`best_launch` over :data:`SAMPLER_TILED_BLOCKS` with the blocks its
    registers leave resident (:data:`SAMPLER_TILED_MIN_BLOCKS`): the
    weights' copies in shared memory wherever a launch of them fits, even
    at one block an SM, then the most threads resident.  One float4 of a
    copy feeds 16 FMAs, against four loads through L1: on the 2 -> 4 plan
    128 threads with the copies ran 1.19x faster than through L1, and on
    create_model(2, 4, [128, 128]) one block of 128 with them 1.23x faster
    than three blocks of 64 without (PERF.md section 6)."""
    return best_launch(SAMPLER_TILED_BLOCKS, lambda b, w: sampler_tiled_smem_bytes(plan, b, w),
                       smem_first=True, what="tiled sampler",
                       sm_threads=SAMPLER_TILED_MIN_BLOCKS * SAMPLER_TILED_BLOCK, min_blocks=1)


def sampler_kernel_for(plan):
    """The kernel that runs ``plan``, by its widths: ``"tiled"`` where a
    layer (a hidden layer's outputs or a last layer's inputs) is at least
    :data:`SAMPLER_TILED_MIN_WIDTH` wide and a tiled launch fits
    (:func:`sampler_tiled_config`); else ``"thread"``, the per-thread
    kernel."""
    widths = [fo if li < len(layers) - 1 else fi
              for _, layers in _cell_ops(plan.flow, plan.shapes)
              for li, (fi, fo, _) in enumerate(layers)]
    if widths and max(widths) >= SAMPLER_TILED_MIN_WIDTH:
        try:
            sampler_tiled_config(plan)
            return "tiled"
        except ValueError:
            pass
    return "thread"


def launch_config(plan, kernel):
    """``(block, w_smem)`` of ``kernel`` (``"thread"`` or ``"tiled"``) on
    ``plan``, by its launch rule; raises ``ValueError`` where none fits."""
    return sampler_tiled_config(plan) if kernel == "tiled" else sampler_config(plan)


def sampler_blocks(n, block):
    """The sampler's grid for ``n`` samples in blocks of ``block``: a tile
    of ``block`` samples per block, at most :data:`SAMPLER_MAX_THREADS`
    threads (each block then loops over several tiles)."""
    return min(-(-n // block), SAMPLER_MAX_THREADS // block)


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

def _launch(plan, ops, latents, seed, offset, n, dim_major, kernel, config, smem):
    """One launch of ``kernel`` on the current stream; returns ``(x, jac)``.
    ``ops`` holds the descriptor, the row table and the flat weights on the
    device; ``config = (block, w_smem)`` and ``smem`` its count of shared
    memory (:func:`sampler_smem_bytes`, :func:`sampler_tiled_smem_bytes`)."""
    global LAUNCHES, SAMPLER_TILED_LAUNCHES
    from nf_tpu_torch.ops import _build

    lib = _build.library()
    desc, tab, weights = ops
    device = desc.device
    n_flow = plan.flow.n_flow
    block, w_smem = config
    x = torch.empty((n_flow, n) if dim_major else (n, n_flow),
                    dtype=torch.float32, device=device)
    jac = torch.empty(n, dtype=torch.float32, device=device)
    lat = latents.data_ptr() if latents is not None else None
    n_blocks = max(sampler_blocks(n, block), 1)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if kernel == "tiled":
            err = lib.nf_pwquad_sampler_tiled(
                desc.data_ptr(), desc.numel(), tab.data_ptr(), tab.numel(), weights.data_ptr(),
                lat, seed & ((1 << 64) - 1), offset, x.data_ptr(), jac.data_ptr(), n, n_flow,
                n_blocks, block, int(w_smem), *plan.tiles, *plan.copies, smem, int(dim_major),
                stream)
        else:
            err = lib.nf_pwquad_sampler(
                desc.data_ptr(), desc.numel(), tab.data_ptr(), tab.numel(), weights.data_ptr(),
                plan.n_wpad, lat, seed & ((1 << 64) - 1), offset, x.data_ptr(), jac.data_ptr(),
                n, n_flow, n_blocks, block, int(w_smem), *plan.tiles, smem, int(dim_major),
                stream)
    if err != 0:
        raise RuntimeError(f"pwquad_sampler kernel launch failed: {_build.error_string(err)}")
    if n > 0:
        LAUNCHES += 1
        if kernel == "tiled":
            SAMPLER_TILED_LAUNCHES += 1
    return x, jac


def build_sampler(flow, model, take_latents: bool = False,
                  layout: str = "batch_major", config=None, kernel=None):
    """Fused eval-mode sampler for ``model`` (a FlowModel of ``flow``).

    Returns ``sample(seed, n, offset=0) -> (x, jac)``, or with
    ``take_latents=True`` ``sample(latents [n, n_flow] f32) -> (x, jac)``.
    ``x`` is ``[n, n_flow]`` (``layout="batch_major"``) or ``[n_flow, n]``
    (``"dim_major"``), float32; ``jac`` is ``[n]``.  The seeded variant draws
    latents with Philox (:func:`philox_uniform`); disjoint ``offset`` ranges
    give disjoint streams for one seed.

    The launch is planned and the weights folded, encoded and uploaded
    once, here (the span ``nf.fold``).  On a CUDA device every call launches
    ``kernel`` (``"thread"`` or ``"tiled"``; default the plan's,
    :func:`sampler_kernel_for`) with ``config = (block, w_smem)`` (default
    its launch rule's); a plan no launch fits raises ``ValueError`` here.
    Both kernels give the same bits.  On the CPU it runs the plain version.
    """
    from nf_tpu_torch.flows.fast_eval import make_folded_forward

    if layout not in ("batch_major", "dim_major"):
        raise ValueError(f"unknown layout {layout!r}")
    dim_major = layout == "dim_major"
    n_flow = flow.n_flow
    device = model_device(model)
    if device.type == "cuda":
        with profiling.span("nf.fold"):
            plan = SamplerPlan(flow)
            kernel = kernel or plan.kernel
            if kernel not in ("thread", "tiled"):
                raise ValueError(f"unknown sampler kernel {kernel!r}")
            tiled = kernel == "tiled"
            config = config or (plan.config if kernel == plan.kernel
                                else launch_config(plan, kernel))
            blocks = (SAMPLER_TILED_BLOCKS if tiled else SAMPLER_BLOCKS) + SMALL_BLOCKS
            if config[0] not in blocks:
                raise ValueError(f"{kernel} sampler block {config[0]} not in {blocks}")
            smem = (sampler_tiled_smem_bytes if tiled else sampler_smem_bytes)(plan, *config)
            desc, weights = encode_plan(flow, fold_eval_params(flow, model))
            ops = tuple(torch.as_tensor(a, device=device) for a in (desc, plan.table, weights))
    elif device.type == "cpu":
        plain = make_folded_forward(flow, model, torch.float32)
    else:
        raise ValueError(f"fused sampler: unsupported device {device}")

    def run(latents, seed, offset, n):
        if device.type == "cuda":
            return _launch(plan, ops, latents, seed, offset, n, dim_major, kernel, config, smem)
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
