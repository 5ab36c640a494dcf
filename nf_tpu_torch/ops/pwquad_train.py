"""Fused frozen-statistics training: differentiable fold, plain versions, kernels.

Counterpart of ``nf_tpu.ops.pwquad_train``.  The stale-statistics trainer
(``bn_stats="stale"``) folds every BatchNorm, with its running statistics
held fixed, into the adjacent linear layers, so each conditioner is a bare
dense+bias+ReLU MLP and no sample depends on another.  The flow's forward and
its hand-derived backward then run as two CUDA kernels
(``csrc/pwquad_train.cu``), which replace nf_tpu's Pallas ``fwd_kernel`` and
``bwd_kernel``.  This module holds

  * :func:`fold_cell` / :func:`fold_flow`: the fold in torch, differentiable
    in the parameters; the statistics are buffers, so they carry no gradient
    (nf_tpu's ``stop_gradient``).  :func:`fold_flow` returns one flat float32
    tensor laid out as :func:`~nf_tpu_torch.ops.pwquad_sampler.plan_descriptor`
    says, the layout both kernels read and the backward's weight gradient
    has; :func:`pack_flat` / :func:`unpack_flat` convert it from and to
    nf_tpu's list ``[W0, b0, W1, b1, ...]``;
  * the plain versions: :func:`folded_forward_ref`,
    :func:`forward_stats_ref` and :func:`folded_backward_ref` (autograd of the
    first, the definition nf_tpu pins its VJP against), and
    :func:`kink_distance`, which finds the samples where float32 and float64
    may take different gradients, for the checks that compare them;
  * :class:`TrainPlan` (the descriptor and the forward's row table, built
    once per flow), each kernel's launch layout, counted here and checked
    by its C entry point (:func:`train_fwd_smem_bytes`,
    :func:`train_bwd_smem_bytes`, :func:`train_bwd_thread_smem_bytes`), and
    its kernel and launch chosen per plan (:func:`train_fwd_config`,
    :func:`bwd_kernel_for`, :func:`train_bwd_config`,
    :func:`train_bwd_thread_config`); the wrappers
    :func:`train_forward` / :func:`train_backward` with their launch counts
    ``FWD_LAUNCHES`` / ``BWD_LAUNCHES`` (``BWD_TILED_LAUNCHES`` the tiled
    backward's alone), and :class:`FusedTrain`, the
    ``torch.autograd.Function`` that joins them;
  * :func:`stats_to_bn_state`: the running-statistics refresh from the
    forward's batch sums.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises.  The kernels compute in float32.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from nf_tpu_torch.bijectors import coupling
from nf_tpu_torch.bijectors.batchnorm import EPS, MOMENTUM
from nf_tpu_torch.flows.fast_eval import apply_folded, permutation_index
from nf_tpu_torch.flows.model import permutation_source
from nf_tpu_torch.ops.pwquad_sampler import (SM_COUNT, SMALL_BLOCKS, SMEM_LIMIT,  # noqa: F401
                                             best_launch, blocks_per_sm, layer_shapes,
                                             logit_width,
                                             op_table, padded_weights as _padded_weights,
                                             plan_descriptor, round4, tile_rows)

# Launches of the CUDA kernels since import (or since a caller reset them):
# the forward, the backward (either kernel), and the tiled backward alone.
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
BWD_TILED_LAUNCHES = 0

# Launch shape compiled into csrc/pwquad_train.cu.
FWD_MAX_BLOCK = 512    # threads (samples) per block of the forward
BWD_MAX_BLOCK = 512    # threads (samples) per block of the per-thread backward
BWD_TILED_MAX_BLOCK = 128  # threads (samples) per block of the tiled backward
# The launches' block sizes (train_fwd_config, train_bwd_config and
# train_bwd_thread_config pick from them, then from SMALL_BLOCKS where none
# fits) and the most threads of the forward's and the per-thread backward's
# grids.
FWD_BLOCKS = (128, 256, 512)
BWD_TILED_BLOCKS = (128, 64)
BWD_BLOCKS = (128, 256, 512)
FWD_MAX_THREADS = 1 << 20
BWD_MAX_THREADS = 1 << 17
# The per-thread backward's arrays are local arrays of these sizes (latent
# dims, a layer's fan_in, bins, a cell's layer inputs in all); beyond any of
# them they are slices of a device workspace.
BWD_LOCAL_FLOW, BWD_LOCAL_HIDDEN, BWD_LOCAL_BINS, BWD_LOCAL_ACTS = 32, 64, 32, 256
# The tiled backward keeps the cotangent of each last layer's input in
# registers, 16 rows a register tile (train_bwd_microtile): a plan whose
# last layer takes more inputs runs the workspace kernel.
BWD_TILED_MAX_FIN = 64
# Blocks of BWD_TILED_MAX_BLOCK threads an SM holds by the tiled backward's
# registers, by its register tiles of R (1, 2 or 4): the minimum its
# __launch_bounds__ asks of ptxas, which then caps a thread at 168
# registers for three blocks and 255 for two.  ptxas gives 146-168 and
# 208-210 (PERF.md section 6), more than a fourth or a third block leaves
# (128 and 170), so the count is exact; a card test checks it against the
# CUDA occupancy calculator.
BWD_TILED_MIN_BLOCKS = {1: 3, 2: 3, 4: 2}
# A plan whose layers (hidden outputs and last-layer inputs) are all
# narrower than this runs the per-thread backward on its local arrays where
# they hold it: its products are too small to pay for the tiled kernel's
# barriers (on launches that count its registers, camel and the 10-D
# flagship ran 2.3x and 1.18x slower tiled, the ZZ/Z' plan, 32 wide, 1.65x
# faster; PERF.md section 6).
BWD_TILED_MIN_WIDTH = 32


# ---------------------------------------------------------------------------
# The differentiable fold
# ---------------------------------------------------------------------------

def _check_cell_order(flow):
    if [op[1] for op in flow.ops if op[0] == "cell"] != list(range(len(flow.cells))):
        raise ValueError("the training kernels need every cell applied once, "
                         "in index order")


def _bn_affine(bn, eps=EPS):
    scale = bn.scale / torch.sqrt(bn.var + eps)
    return scale, bn.bias - bn.mean * scale


def fold_cell(cond, eps=EPS):
    """A :class:`~nf_tpu_torch.bijectors.conditioner.Conditioner` with eval
    BatchNorm as ``[(W, b, relu), ...]`` in the model's dtype, differentiable
    in its parameters (counterpart of ``fold_cell_jnp``)."""
    s_in, t_in = _bn_affine(cond.bn_in, eps)
    layers = []
    for i, (lin, bn) in enumerate(zip(cond.linears, cond.bns)):
        w = lin["w"]
        b = lin["b"] if "b" in lin else torch.zeros(w.shape[1], dtype=w.dtype, device=w.device)
        if i == 0:
            w, b = s_in[:, None] * w, t_in @ w + b
        s_o, t_o = _bn_affine(bn, eps)
        layers.append((w * s_o[None, :], b * s_o + t_o, True))
    fin = cond.final
    first = fin["u"] if "u" in fin else fin["w"]
    bias = torch.zeros(first.shape[1], dtype=first.dtype, device=first.device) \
        if "u" in fin else fin["b"]
    if not len(cond.linears):
        # no hidden layers: fold the input BN into the first final factor
        first, bias = s_in[:, None] * first, t_in @ first + bias
    layers.append((first, bias, False))
    if "u" in fin:
        layers.append((fin["v"], fin["b"], False))
    return layers


def fold_flow(model):
    """Every cell of ``model`` folded, as one flat float32 tensor on the
    model's device: cell after cell, per layer ``W`` row-major then ``b``."""
    _check_cell_order(model.flow)
    return torch.cat([t.reshape(-1) for cond in model.cells
                      for w, b, _ in fold_cell(cond) for t in (w, b)]).to(torch.float32)


def unpack_flat(flow, flat):
    """The flat tensor as nf_tpu's list ``[W0, b0, W1, b1, ...]`` (views)."""
    out, off = [], 0
    for cfg in flow.cells:
        for fan_in, fan_out, _ in layer_shapes(cfg):
            out.append(flat[off:off + fan_in * fan_out].reshape(fan_in, fan_out))
            out.append(flat[off + fan_in * fan_out:off + fan_in * fan_out + fan_out])
            off += fan_in * fan_out + fan_out
    if off != flat.numel():
        raise ValueError(f"flat weights hold {flat.numel()} floats, the plan {off}")
    return out


def pack_flat(arrays, device="cpu"):
    """nf_tpu's list ``[W0, b0, W1, b1, ...]`` (arrays) as one flat float32
    tensor."""
    return torch.cat([torch.from_numpy(np.array(a, np.float32)).reshape(-1)
                      for a in arrays]).to(device)


def _folded_layers(flow, flat):
    parts = iter(unpack_flat(flow, flat))
    return [[(next(parts), next(parts), relu) for _, _, relu in layer_shapes(cfg)]
            for cfg in flow.cells]


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def folded_forward_ref(flow, flat, latents):
    """``(x, jac)`` of the frozen-statistics map, from the flat folded
    weights, in the dtype it is given (counterpart of nf_tpu's
    ``folded_forward_ref``)."""
    return apply_folded(flow, _folded_layers(flow, flat),
                        permutation_index(flow, latents.device), latents)


def forward_stats_ref(flow, flat, latents):
    """``(x, jac, stage, stats)`` as the forward kernel gives them: ``stage``
    ``[n_cells, n_flow, n]`` holds each cell's input; ``stats`` (float64) the
    sums ``(sum y, sum y^2)`` of every xA column, then of every pre-ReLU
    hidden unit, cell after cell."""
    n = latents.shape[0]
    stage = torch.empty((len(flow.cells), flow.n_flow, n), dtype=latents.dtype,
                        device=latents.device)
    rows = []

    def on_cell(c, x_in, pres):
        stage[c] = x_in.T
        for cols in [x_in[:, :flow.cells[c].pass_through]] + pres:
            rows.append(torch.stack([cols.to(torch.float64).sum(0),
                                     (cols * cols).to(torch.float64).sum(0)], 1).reshape(-1))

    x, jac = apply_folded(flow, _folded_layers(flow, flat),
                          permutation_index(flow, latents.device), latents, on_cell)
    return x, jac, stage, torch.cat(rows)


def folded_backward_ref(flow, flat, latents, xbar, jbar):
    """``(dflat, wbar)``: the gradient of :func:`folded_forward_ref` with
    cotangents ``(xbar, jbar)``, by autograd."""
    with torch.enable_grad():
        flat_ = flat.detach().requires_grad_(True)
        lat_ = latents.detach().requires_grad_(True)
        x, jac = folded_forward_ref(flow, flat_, lat_)
        dflat, wbar = torch.autograd.grad((x, jac), (flat_, lat_), (xbar, jbar))
    return dflat, wbar


def kink_distance(flow, flat, latents, relu=True):
    """Per sample, the least distance to a point where the map's gradient
    jumps: of a transformed coordinate, in any cell, to an interior bin edge
    of a pwquad or pwlin cell or to pwquad's clamp at 1 - 1e-6, and (with
    ``relu``) of a pre-ReLU activation to 0.  A sample within rounding of one
    may take the other side in float32 than in float64, and with it another
    gradient."""
    layers = _folded_layers(flow, flat)
    dist = torch.full((latents.shape[0],), float("inf"), dtype=latents.dtype,
                      device=latents.device)

    def on_cell(c, x_in, pres):
        nonlocal dist
        cfg = flow.cells[c]
        if relu:
            for pre in pres:
                dist = torch.minimum(dist, pre.abs().amin(1))
        if cfg.kind == "affine":
            return
        h = x_in[:, :cfg.pass_through]
        for wm, bv, has_relu in layers[c]:
            h = h @ wm + bv
            h = torch.relu(h) if has_relu else h
        xB, nb = x_in[:, cfg.pass_through:], cfg.n_bins
        if cfg.kind == "pwquad":
            clamp = 1.0 - 1e-6
            w = coupling.positivity(h.reshape(h.shape[0], xB.shape[1], 2 * nb + 1)[:, :, nb + 1:],
                                    cfg.activation)
            edges = torch.cumsum(w, -1)[:, :, :-1] / w.sum(-1, keepdim=True)
            d = torch.minimum((torch.clamp(xB, max=clamp)[:, :, None] - edges).abs().amin(-1),
                              (xB - clamp).abs())
        else:
            a = xB * nb
            d = (a - torch.round(a).clamp(1, nb - 1)).abs() / nb
        dist = torch.minimum(dist, d.amin(1))

    with torch.no_grad():
        apply_folded(flow, layers, permutation_index(flow, latents.device), latents, on_cell)
    return dist


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

class TrainPlan:
    """A flow's folded layer shapes and sizes, and the kernels' descriptor,
    built once per device at first launch."""

    def __init__(self, flow):
        _check_cell_order(flow)
        self.flow = flow
        self.meta = tuple(layer_shapes(cfg) for cfg in flow.cells)
        self.n_weights = sum(fi * fo + fo for m in self.meta for fi, fo, _ in m)
        self.n_stat_rows = sum(2 * cfg.pass_through + sum(2 * fo for _, fo, relu in m if relu)
                               for cfg, m in zip(flow.cells, self.meta))
        self._desc, self._tab = {}, {}
        # the descriptor's length in int32s (pwquad_sampler.plan_descriptor)
        self.desc_len = 2 + sum(1 + flow.n_flow if op[0] != "cell"
                                else 6 + 5 * len(self.meta[op[1]]) for op in flow.ops)
        self.fwd_tab = fwd_table(self)
        self.fwd_tiles = train_fwd_tiles(self)
        self.n_wpad = padded_weights(self)
        self.bwd_tiles = train_bwd_tiles(self)
        self.bwd_sizes = bwd_array_sizes(self)
        self.bwd_kernel = bwd_kernel_for(self)
        self.bwd_ws = bwd_workspace_floats(self) if self.bwd_kernel == "workspace" else 0
        # {with_stats: train_fwd_config} and the backward's launch (the tiled
        # kernel's train_bwd_config, or train_bwd_thread_config), set with
        # the descriptor
        self.fwd_config = None
        self.bwd_config = None

    def descriptor(self, device):
        """The int32 descriptor on ``device`` (and the forward's table,
        :meth:`table`); raises ``ValueError`` where no launch of a kernel
        fits the plan."""
        if device not in self._desc:
            desc, _ = plan_descriptor(self.flow, self.meta)
            self.fwd_config = {stats: train_fwd_config(self, stats) for stats in (False, True)}
            self.bwd_config = train_bwd_config(self) if self.bwd_kernel == "tiled" else \
                train_bwd_thread_config(self)
            self._desc[device] = torch.as_tensor(desc, device=device)
            self._tab[device] = torch.as_tensor(self.fwd_tab, device=device)
        return self._desc[device]

    def table(self, device):
        """:func:`fwd_table` on ``device``."""
        self.descriptor(device)
        return self._tab[device]


def fwd_table(plan):
    """The forward kernel's row table (:func:`~nf_tpu_torch.ops.
    pwquad_sampler.op_table`): each cell's position in the descriptor and,
    per cell and for the end of the flow, the X row of each logical
    dimension."""
    return op_table(plan.flow, plan.meta)


def train_fwd_tiles(plan):
    """``(rows_a, rows_b)`` of the forward's conditioner tiles
    (:func:`~nf_tpu_torch.ops.pwquad_sampler.tile_rows`)."""
    return tile_rows(plan.flow, plan.meta)


def padded_weights(plan):
    """Floats of the forward's padded copy of the weights in shared memory
    (:func:`~nf_tpu_torch.ops.pwquad_sampler.padded_weights`)."""
    return _padded_weights(plan.flow, plan.meta)


def stats_part_rows(plan, block):
    """The rows of the stats forward's partial sums in a block of ``block``
    threads: the most rows one block sum takes (a cell's xA columns, or one
    ReLU layer's units), or ``block`` if more."""
    return max([block] + [cfg.pass_through for cfg in plan.flow.cells]
               + [fo for m in plan.meta for _, fo, relu in m if relu])


def train_fwd_smem_bytes(plan, block, w_smem=True, stats=False):
    """Shared memory of one forward block of ``block`` threads: with
    ``stats``, the block's double accumulator (``n_stat_rows``) and the block
    sums' partial pairs (2 per :func:`stats_part_rows`); the descriptor and :func:`fwd_table`
    (padded to four int32s); with ``w_smem``, the padded weights
    (:func:`padded_weights`); and the X, A and B tiles (a row of
    ``block + 1`` floats per feature).  ``nf_pwquad_train_fwd`` refuses a
    launch whose count differs from its own."""
    rows_a, rows_b = plan.fwd_tiles
    return (8 * (plan.n_stat_rows + 2 * stats_part_rows(plan, block) if stats else 0)
            + 4 * (round4(plan.desc_len + plan.fwd_tab.size)
                   + (plan.n_wpad if w_smem else 0)
                   + (plan.flow.n_flow + rows_a + rows_b) * (block + 1)))


def train_bwd_tiles(plan):
    """``(h_rows, z_rows, v_rows, wh_floats, wl_floats)``: the tiled
    backward's tiles beside X and XB (``n_flow`` rows each) and its weights'
    copies in shared memory.  H holds a last hidden layer's output; Z one
    transformed dimension's logits (``2 n_bins + 1`` for pwquad, ``n_bins``
    for pwlin, 2 for affine), then the hidden layers' output cotangents, two
    at a time where a cell has two hidden layers or more; V the VJP's
    scratch column (pwquad's logits, pwlin's bins), then the hidden outputs
    before the last.  Wh holds a cell's hidden layers, Wl the last layer's
    columns of one transformed dimension, each row padded to a multiple of
    four floats and the bias a last row."""
    h_rows = v_rows = wh = wl = 0
    z_rows = 1
    for cfg, shapes in zip(plan.flow.cells, plan.meta):
        width = logit_width(cfg)
        hidden, (fin, _, _) = shapes[:-1], shapes[-1]
        z_rows = max(z_rows, width)
        v_rows = max(v_rows, {"pwquad": width, "pwlin": cfg.n_bins, "affine": 0}[cfg.kind])
        wl = max(wl, (fin + 1) * round4(width))
        if hidden:
            h_rows = max(h_rows, fin)
            half = max(fo for _, fo, _ in hidden)
            z_rows = max(z_rows, (2 if len(hidden) > 1 else 1) * half)
            v_rows = max(v_rows, sum(fo for _, fo, _ in hidden[:-1]))
            wh = max(wh, sum((fi + 1) * round4(fo) for fi, fo, _ in hidden))
    return h_rows, z_rows, v_rows, wh, wl


def train_bwd_smem_bytes(plan, block, w_smem=True):
    """Shared memory of one tiled backward block of ``block`` threads (a
    tile of ``block`` samples): the descriptor and :func:`fwd_table`
    (padded to four int32s); with ``w_smem`` the weights' copies (Wh and
    Wl, :func:`train_bwd_tiles`); and the X, XB, H, Z and V tiles, a row of
    ``block + 4`` floats per feature.  The weight-gradient accumulator is
    the block's own row of the partial-gradient scratch in device memory.
    ``nf_pwquad_train_bwd_tiled`` refuses a launch whose count differs from
    its own."""
    h_rows, z_rows, v_rows, wh, wl = plan.bwd_tiles
    return 4 * (round4(plan.desc_len + plan.fwd_tab.size) + (wh + wl if w_smem else 0)
                + (2 * plan.flow.n_flow + h_rows + z_rows + v_rows) * (block + 4))


def train_fwd_config(plan, stats=False):
    """``(block, w_smem)`` of the forward for ``plan``, with or without the
    statistics, by :func:`~nf_tpu_torch.ops.pwquad_sampler.best_launch` over
    :data:`FWD_BLOCKS`, the weights in shared memory first: the forward reads
    four outputs' weights per activation, one float4 from shared memory
    against four loads through L1, and the L1 launches ran ~30% slower at
    every block size on the 10-D flagship (PERF.md §6)."""
    return best_launch(FWD_BLOCKS, lambda b, w: train_fwd_smem_bytes(plan, b, w, stats),
                       smem_first=True, what="training forward")


def train_bwd_microtile(plan):
    """The tiled backward's register tiles of the cotangent of a last
    layer's input a thread keeps across the transformed dimensions (every
    product's tile is four rows by four samples): 1, 2 or 4, the fewest
    whose 16 rows each hold the widest last layer's fan_in, a function of
    the plan's widths alone; ``None`` where that fan_in exceeds
    :data:`BWD_TILED_MAX_FIN`."""
    fin = max(m[-1][0] for m in plan.meta)
    return next((r for r in (1, 2, 4) if fin <= 16 * r), None)


def bwd_tiled_sm_threads(plan):
    """Threads of the tiled backward an SM holds by its registers on
    ``plan`` (:data:`BWD_TILED_MIN_BLOCKS`)."""
    return BWD_TILED_MIN_BLOCKS[train_bwd_microtile(plan)] * BWD_TILED_MAX_BLOCK


def train_bwd_config(plan):
    """``(block, w_smem)`` of the tiled backward for ``plan``, by
    :func:`~nf_tpu_torch.ops.pwquad_sampler.best_launch` over
    :data:`BWD_TILED_BLOCKS`, with the blocks its registers leave resident
    (:func:`bwd_tiled_sm_threads`): the most threads resident with at least
    two blocks an SM, then the weights' copies in shared memory (one float4
    of a copy feeds four FMAs of a logit product, against four loads through
    L1).  Raises ``ValueError`` where a last layer's fan_in exceeds
    :data:`BWD_TILED_MAX_FIN` or no tiled launch fits."""
    if train_bwd_microtile(plan) is None:
        raise ValueError(f"tiled training backward: a last layer's fan_in exceeds "
                         f"{BWD_TILED_MAX_FIN}")
    return best_launch(BWD_TILED_BLOCKS, lambda b, w: train_bwd_smem_bytes(plan, b, w),
                       what="tiled training backward", sm_threads=bwd_tiled_sm_threads(plan))


def bwd_blocks(plan, n, block, w_smem):
    """The tiled backward's grid for ``n`` samples of ``plan`` in blocks of
    ``block``, the weights' copies in shared memory if ``w_smem``: a block
    per tile, at most one per resident slot of the card (:func:`blocks_per_sm`
    by shared memory and registers, x :data:`SM_COUNT`), each block then
    walking several tiles."""
    smem = train_bwd_smem_bytes(plan, block, w_smem)
    return min(-(-n // block), blocks_per_sm(smem, block, bwd_tiled_sm_threads(plan)) * SM_COUNT)


def train_bwd_thread_tiles(plan):
    """``(h_rows, g_rows)``: the rows of the per-thread backward's two shared
    tiles (its arrays local or in the workspace alike).  H holds a layer's
    input and a row of ones (the bias); G the cotangent of a hidden layer's
    output, or of one transformed dimension's logits of the last layer
    (``2 n_bins + 1`` for pwquad, ``n_bins`` for pwlin, 2 for affine), which
    is streamed one dimension at a time."""
    h_rows = g_rows = 1
    for cfg, shapes in zip(plan.flow.cells, plan.meta):
        width = logit_width(cfg)
        for li, (fan_in, fan_out, _) in enumerate(shapes):
            h_rows = max(h_rows, fan_in + 1)
            g_rows = max(g_rows, fan_out if li < len(shapes) - 1 else width)
    return h_rows, g_rows


def train_bwd_thread_smem_bytes(plan, block, w_smem=True):
    """Shared memory of one per-thread backward block of ``block`` threads:
    with ``w_smem`` the weights (``n_weights`` floats), the descriptor with
    each op's position and the cell count, the H and G tiles (a row of
    ``block + 1`` floats per feature) and the block product's partial sums
    (4 per thread).  The weight-gradient accumulator is the block's own row
    of the partial-gradient scratch in device memory, so the plan's width
    takes no shared memory beyond the weights.  ``nf_pwquad_train_bwd``
    refuses a launch whose count differs from its own."""
    h_rows, g_rows = train_bwd_thread_tiles(plan)
    return 4 * ((plan.n_weights if w_smem else 0) + plan.desc_len
                + len(plan.flow.ops) + 1 + (h_rows + g_rows) * (block + 1) + 4 * block)


def train_bwd_thread_config(plan):
    """``(block, w_smem)`` of the per-thread backward for ``plan``, by
    :func:`~nf_tpu_torch.ops.pwquad_sampler.best_launch` over
    :data:`BWD_BLOCKS` (with the weights in shared memory, L1 is left to the
    per-thread arrays)."""
    return best_launch(BWD_BLOCKS, lambda b, w: train_bwd_thread_smem_bytes(plan, b, w),
                       what="training backward")


def bwd_array_sizes(plan):
    """``(acts, hidden, width, bins)``: the per-thread backward's arrays for
    ``plan``: a cell's layer inputs in all, a layer's fan_in, one
    transformed dimension's logits, a pwquad or pwlin cell's bins."""
    return (max(sum(fi for fi, _, _ in m) for m in plan.meta),
            max(fi for m in plan.meta for fi, _, _ in m),
            max(logit_width(cfg) for cfg in plan.flow.cells),
            max([cfg.n_bins or 0 for cfg in plan.flow.cells if cfg.kind != "affine"] + [0]))


def bwd_workspace_floats(plan):
    """Floats per thread of the backward's workspace for ``plan``: xbar, xin
    and the permutation's scratch (n_flow each), the layer inputs, two
    hidden cotangents, one dimension's logits and their cotangent, and the
    VJPs' arrays (5 bins + 3), as ``bwd_layout`` in csrc/pwquad_train.cu
    lays them out."""
    acts, hidden, width, bins = plan.bwd_sizes
    return 3 * plan.flow.n_flow + acts + 2 * hidden + 2 * width + 5 * bins + 3


def bwd_kernel_for(plan):
    """The backward kernel that runs ``plan``, by the plan's widths:
    ``"local"`` (the per-thread kernel on local arrays) where every layer is
    narrower than :data:`BWD_TILED_MIN_WIDTH` and the local arrays hold the
    plan (:data:`BWD_LOCAL_FLOW` and the rest); else ``"tiled"`` where the
    tiled kernel takes it (:func:`train_bwd_config`); else ``"local"`` where
    the local arrays hold it; else ``"workspace"``."""
    acts, hidden, _, bins = plan.bwd_sizes
    local = (plan.flow.n_flow <= BWD_LOCAL_FLOW and acts <= BWD_LOCAL_ACTS
             and hidden <= BWD_LOCAL_HIDDEN and bins <= BWD_LOCAL_BINS)
    widest = max(fo if li < len(m) - 1 else fi
                 for m in plan.meta for li, (fi, fo, _) in enumerate(m))
    if local and widest < BWD_TILED_MIN_WIDTH:
        return "local"
    try:
        train_bwd_config(plan)
        return "tiled"
    except ValueError:
        return "local" if local else "workspace"


def _check(plan, flat, tensors):
    """Device, dtype, shape and contiguity of ``flat`` and of each
    ``(name, tensor, shape)``."""
    for name, t, shape in [("flat", flat, (plan.n_weights,))] + tensors:
        if t.device != flat.device:
            raise ValueError(f"{name} on {t.device}, flat weights on {flat.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {list(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if flat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"training kernels: unsupported device {flat.device}")


def fwd_blocks(n, block):
    """The forward's grid for ``n`` samples in blocks of ``block``: a tile
    of ``block`` samples per block, at most :data:`FWD_MAX_THREADS` threads
    (each block then loops over several tiles)."""
    return min(-(-n // block), FWD_MAX_THREADS // block)


def train_forward(plan, flat, latents, with_stats=False, config=None):
    """``(x [n, n_flow], jac [n], stage [n_cells, n_flow, n])``, with
    ``with_stats`` also the float64 ``stats [n_stat_rows]``, of the
    frozen-statistics map.  One launch of the forward kernel on CUDA
    tensors, with ``config = (block, w_smem)`` (default
    :func:`train_fwd_config`); :func:`forward_stats_ref` on CPU tensors."""
    n_flow = plan.flow.n_flow
    n = latents.shape[0]
    _check(plan, flat, [("latents", latents, (n, n_flow))])
    if flat.device.type == "cpu":
        out = forward_stats_ref(plan.flow, flat, latents)
        return out if with_stats else out[:3]
    return _launch_fwd(plan, flat, latents, with_stats, config)


def _launch_fwd(plan, flat, latents, with_stats, config):
    """One launch of the forward kernel on the current stream."""
    global FWD_LAUNCHES
    from nf_tpu_torch.ops import _build

    lib = _build.library()
    n_flow = plan.flow.n_flow
    n = latents.shape[0]
    device = flat.device
    desc = plan.descriptor(device)
    tab = plan.table(device)
    block, w_smem = config or plan.fwd_config[with_stats]
    if block not in FWD_BLOCKS + SMALL_BLOCKS:
        raise ValueError(f"forward block {block} not in {FWD_BLOCKS + SMALL_BLOCKS}")
    smem = train_fwd_smem_bytes(plan, block, w_smem, with_stats)
    x = torch.empty((n, n_flow), dtype=torch.float32, device=device)
    jac = torch.empty(n, dtype=torch.float32, device=device)
    stage = torch.empty((len(plan.flow.cells), n_flow, n), dtype=torch.float32, device=device)
    n_blocks = fwd_blocks(n, block)
    partial = torch.empty((n_blocks, plan.n_stat_rows), dtype=torch.float64,
                          device=device) if with_stats else None
    with torch.cuda.device(device):
        err = lib.nf_pwquad_train_fwd(
            desc.data_ptr(), desc.numel(), tab.data_ptr(), tab.numel(), flat.data_ptr(),
            plan.n_wpad, latents.data_ptr(), x.data_ptr(), jac.data_ptr(), stage.data_ptr(),
            partial.data_ptr() if with_stats else None, plan.n_stat_rows,
            stats_part_rows(plan, block), n, n_flow,
            n_blocks, block, int(w_smem), *plan.fwd_tiles, smem,
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pwquad_train forward kernel launch failed: "
                           f"{_build.error_string(err)}")
    if n > 0:
        FWD_LAUNCHES += 1
    if with_stats:
        return x, jac, stage, partial.sum(0)
    return x, jac, stage


def train_backward(plan, flat, stage, jac, jbar, xbar, latents=None, config=None,
                   workspace=None):
    """``(dflat [n_weights], wbar [n, n_flow])``: the gradient of
    :func:`train_forward`'s ``(x, jac)`` for the cotangents ``(xbar, jbar)``
    with respect to the flat folded weights and the latents.  One launch of
    a backward kernel on CUDA tensors, which reads ``stage`` and ``jac``:
    the plan's (:func:`bwd_kernel_for`: tiled, or per thread on local
    arrays or in a workspace), or the per-thread kernel on a workspace where
    ``workspace``, with ``config = (block, w_smem)`` (default
    :func:`train_bwd_config` for the tiled kernel,
    :func:`train_bwd_thread_config` for the per-thread one);
    :func:`folded_backward_ref` on CPU tensors, which recomputes from
    ``latents``."""
    n_flow = plan.flow.n_flow
    n = jac.shape[0]
    _check(plan, flat, [("jac", jac, (n,)), ("jbar", jbar, (n,)),
                        ("xbar", xbar, (n, n_flow))])
    if flat.device.type == "cpu":
        if latents is None:
            raise ValueError("the plain backward recomputes the map: pass latents")
        _check(plan, flat, [("latents", latents, (n, n_flow))])
        return folded_backward_ref(plan.flow, flat, latents, xbar, jbar)
    _check(plan, flat, [("stage", stage, (len(plan.flow.cells), n_flow, n))])
    if workspace is not None and not workspace and plan.bwd_ws:
        raise ValueError("training backward: the plan is beyond the local arrays and the "
                         "tiled kernel (bwd_kernel_for); it needs the workspace")
    if workspace or plan.bwd_kernel != "tiled":
        return _launch_bwd_thread(plan, flat, stage, jac, jbar, xbar, config,
                                  workspace or plan.bwd_kernel == "workspace")
    return _launch_bwd_tiled(plan, flat, stage, jac, jbar, xbar, config)


def _launch_bwd_tiled(plan, flat, stage, jac, jbar, xbar, config):
    """One launch of the tiled backward kernel on the current stream."""
    global BWD_LAUNCHES, BWD_TILED_LAUNCHES
    from nf_tpu_torch.ops import _build

    lib = _build.library()
    n_flow = plan.flow.n_flow
    n = jac.shape[0]
    device = flat.device
    desc = plan.descriptor(device)
    tab = plan.table(device)
    block, w_smem = config or plan.bwd_config
    if block not in BWD_TILED_BLOCKS + SMALL_BLOCKS:
        raise ValueError(f"tiled backward block {block} not in "
                         f"{BWD_TILED_BLOCKS + SMALL_BLOCKS}")
    smem = train_bwd_smem_bytes(plan, block, w_smem)
    n_blocks = bwd_blocks(plan, n, block, w_smem)
    partial = torch.empty((n_blocks, plan.n_weights), dtype=torch.float32, device=device)
    wbar = torch.empty((n, n_flow), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.nf_pwquad_train_bwd_tiled(
            desc.data_ptr(), desc.numel(), tab.data_ptr(), tab.numel(), flat.data_ptr(),
            flat.numel(), stage.data_ptr(), jac.data_ptr(), jbar.data_ptr(), xbar.data_ptr(),
            partial.data_ptr(), wbar.data_ptr(), n, n_flow, n_blocks, block, int(w_smem),
            train_bwd_microtile(plan), (ctypes.c_int * 5)(*plan.bwd_tiles), smem,
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pwquad_train backward kernel launch failed: "
                           f"{_build.error_string(err)}")
    if n > 0:
        BWD_LAUNCHES += 1
        BWD_TILED_LAUNCHES += 1
    # the blocks' partial sums, reduced in a fixed order
    return partial.sum(0, dtype=torch.float64).to(torch.float32), wbar


def _launch_bwd_thread(plan, flat, stage, jac, jbar, xbar, config, workspace):
    """One launch of the per-thread backward kernel on the current stream,
    its arrays in a device workspace where ``workspace``."""
    global BWD_LAUNCHES
    from nf_tpu_torch.ops import _build

    lib = _build.library()
    n_flow = plan.flow.n_flow
    n = jac.shape[0]
    device = flat.device
    desc = plan.descriptor(device)
    block, w_smem = config or (train_bwd_thread_config(plan) if plan.bwd_kernel == "tiled"
                               else plan.bwd_config)
    if block not in BWD_BLOCKS + SMALL_BLOCKS:
        raise ValueError(f"backward block {block} not in {BWD_BLOCKS + SMALL_BLOCKS}")
    smem = train_bwd_thread_smem_bytes(plan, block, w_smem)
    n_blocks = min(-(-n // block), BWD_MAX_THREADS // block)
    partial = torch.empty((n_blocks, plan.n_weights), dtype=torch.float32, device=device)
    wbar = torch.empty((n, n_flow), dtype=torch.float32, device=device)
    per_thread = bwd_workspace_floats(plan) if workspace else 0
    ws = torch.empty(per_thread * n_blocks * block, dtype=torch.float32, device=device) \
        if per_thread else None
    with torch.cuda.device(device):
        err = lib.nf_pwquad_train_bwd(
            desc.data_ptr(), desc.numel(), flat.data_ptr(), flat.numel(),
            stage.data_ptr(), jac.data_ptr(), jbar.data_ptr(), xbar.data_ptr(),
            partial.data_ptr(), wbar.data_ptr(), n, n_blocks, block, int(w_smem),
            len(plan.flow.ops), *train_bwd_thread_tiles(plan), smem,
            ws.data_ptr() if per_thread else None, ws.numel() if per_thread else 0, n_flow,
            (ctypes.c_int * 4)(*plan.bwd_sizes), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pwquad_train backward kernel launch failed: "
                           f"{_build.error_string(err)}")
    if n > 0:
        BWD_LAUNCHES += 1
    # the blocks' partial sums, reduced in a fixed order
    return partial.sum(0, dtype=torch.float64).to(torch.float32), wbar


class FusedTrain(torch.autograd.Function):
    """``(flat, latents) -> (x, jac)`` with the backward kernel as its
    gradient (counterpart of ``make_fused_train_fn``).  On CUDA the forward
    kernel stages each cell's input for the backward; on the CPU the plain
    versions run, and the backward recomputes from the saved latents."""

    @staticmethod
    def forward(ctx, flat, latents, plan):
        ctx.plan = plan
        if flat.device.type == "cuda":
            x, jac, stage = train_forward(plan, flat, latents)
            ctx.save_for_backward(flat, stage, jac)
        else:
            _check(plan, flat, [("latents", latents, (latents.shape[0], plan.flow.n_flow))])
            x, jac = folded_forward_ref(plan.flow, flat, latents)
            ctx.save_for_backward(flat, latents, jac)
        return x, jac

    @staticmethod
    def backward(ctx, xbar, jbar):
        flat, saved, jac = ctx.saved_tensors
        xbar, jbar = xbar.contiguous(), jbar.contiguous()
        if flat.device.type == "cuda":
            dflat, wbar = train_backward(ctx.plan, flat, saved, jac, jbar, xbar)
        else:
            dflat, wbar = train_backward(ctx.plan, flat, None, jac, jbar, xbar, latents=saved)
        return dflat, wbar, None


def fused_train(plan, flat, latents):
    """``(x, jac)`` of the frozen-statistics map, differentiable in ``flat``
    and ``latents`` through :class:`FusedTrain`."""
    return FusedTrain.apply(flat, latents, plan)


# ---------------------------------------------------------------------------
# The statistics refresh
# ---------------------------------------------------------------------------

def fold_cell_affines(cond, eps=EPS):
    """Each hidden BatchNorm's fold affine ``(s_o, t_o)``: the forward's
    pre-ReLU column is ``y = s_o * h + t_o``, ``h`` that BatchNorm's input."""
    with torch.no_grad():
        return [_bn_affine(bn, eps) for bn in cond.bns]


def unfold_layer_stats(sums, sumsqs, count, s_o, t_o):
    """``(sum y, sum y^2)`` over ``count`` samples of ``y = s_o h + t_o`` ->
    ``(mean h, biased var h)``."""
    mean_y = sums / count
    ey2 = sumsqs / count
    mean_h = (mean_y - t_o) / s_o
    var_h = (ey2 - 2.0 * t_o * mean_y + t_o * t_o) / (s_o * s_o) - mean_h * mean_h
    return mean_h, var_h


def stats_to_bn_state(model, stats, count, momentum=MOMENTUM):
    """Move every BatchNorm's running statistics of ``model`` by the
    momentum EMA from the forward kernel's ``stats`` over ``count`` samples,
    **in place** (nf_tpu returns a new state instead).  The running variance
    takes the unbiased batch variance, as in train-mode BatchNorm.  The new
    statistics are computed in float64 from the buffers as they were, then
    written."""
    rows = sum(2 * bn.mean.numel() for cond in model.cells for bn in [cond.bn_in, *cond.bns])
    if stats.shape != (rows,):
        raise ValueError(f"stats must be [{rows}] for this model, got {list(stats.shape)}")
    stats = stats.to(torch.float64)
    count = float(count)
    unbiased = count / max(count - 1.0, 1.0)
    updates, row = [], 0
    with torch.no_grad():
        for cond, cfg in zip(model.cells, model.flow.cells):
            seg = stats[row:row + 2 * cfg.pass_through]
            row += 2 * cfg.pass_through
            mean = seg[0::2] / count
            updates.append((cond.bn_in, mean, seg[1::2] / count - mean * mean))
            for bn, (s_o, t_o) in zip(cond.bns, fold_cell_affines(cond)):
                seg = stats[row:row + 2 * bn.mean.numel()]
                row += 2 * bn.mean.numel()
                updates.append((bn, *unfold_layer_stats(seg[0::2], seg[1::2], count,
                                                        s_o.double(), t_o.double())))
        for bn, mean, var in updates:
            bn.mean.copy_((1.0 - momentum) * bn.mean.double() + momentum * mean)
            bn.var.copy_((1.0 - momentum) * bn.var.double() + momentum * var * unbiased)
