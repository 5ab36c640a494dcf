"""The training backward's launch layout, computed in Python for the CUDA
kernels (tile rows, shared-memory bytes, block size, weight placement, the
register tiles), and the managers' device default.  Runs on the CPU: it
checks the counts that ``nf_pwquad_train_bwd_tiled`` and
``nf_pwquad_train_bwd`` hold their launches to and which kernel each plan
takes, not the kernels.  Imports neither JAX nor nf_tpu."""

import numpy as np
import pytest
import torch

from nf_tpu_torch import AffineManager, BasicManager, PWLinManager, PWQuadManager
from nf_tpu_torch.bijectors.permutations import mask_partition
from nf_tpu_torch.flows import factory
from nf_tpu_torch.flows.model import Flow, FlowModel, make_cell_cfg
from nf_tpu_torch.ops import pwquad_sampler as ps
from nf_tpu_torch.ops import pwquad_train as pt

torch.set_num_threads(1)


def _masked_mini(gen):
    cells, ops = [], []
    for i in range(2):
        feeder, trafoer = mask_partition(4, i)
        perm = tuple(feeder.tolist() + trafoer.tolist())
        cells.append(make_cell_cfg("pwquad", 4, len(feeder), 3, (4,)))
        ops += [("gather", perm), ("cell", i), ("scatter", perm)]
    return FlowModel(Flow(4, tuple(cells), tuple(ops)), gen, torch.float32, "cpu")


def _zz4l(gen):
    """The zz4l configuration's flow: n_flow 10, 32 bins, hidden [32, 32],
    8 cells."""
    NF = PWQuadManager(n_flow=10, seed=0, device="cpu")
    NF.create_model(4, 32, [32, 32], identity_init=True)
    return NF._model


# The plans the port's tests and chip_smoke.py run the training kernels on
# (nf_tpu's five training configurations, the 10-D flagship, the zz4l
# benchmark configuration, and the other flows of tests/test_torch_kernel.py),
# one with hidden layers at the tiled backward's widest last-layer input and
# a factored final layer among them.
PLANS = {
    "camel": lambda g: factory.build_pwquad_flow(g, 2, 2, 4, (3, 3, 3)),
    "masked_mini": _masked_mini,
    "rank_sp": lambda g: factory.build_pwquad_flow(g, 3, 2, 3, (4,), final_rank=2,
                                                   activation="squareplus"),
    "pwlin": lambda g: factory.build_pwlin_flow(g, 3, 1, 2, 4, (5,), 1),
    "affine": lambda g: factory.build_affine_flow(g, 3, 2, 2, (5,), 1),
    "squareplus_nohidden": lambda g: factory.build_pwquad_flow(g, 3, 3, 5, (),
                                                               activation="squareplus"),
    "flagship10d_rank4": lambda g: factory.build_pwquad_flow(g, 10, 8, 8, (16, 16),
                                                             final_rank=4),
    "max_hidden_rank": lambda g: factory.build_pwquad_flow(
        g, 2, 2, 4, (pt.BWD_TILED_MAX_FIN, pt.BWD_TILED_MAX_FIN), final_rank=3),
    "pwlin_8bins": lambda g: factory.build_pwlin_flow(g, 3, 1, 3, 8, (8, 8), 1),
    "affine_6": lambda g: factory.build_affine_flow(g, 3, 1, 2, (6,), 1),
    "zz4l": _zz4l,
}


def _plan(name):
    return pt.TrainPlan(PLANS[name](torch.Generator().manual_seed(0)).flow)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_bwd_launch_fits_shared_memory(name):
    """The tiled kernel's launch fits one block's 232,448 B and at least one
    block per SM, and so does the per-thread kernel's; the descriptor
    accepts the plan; the lengths the smem counts use are the descriptor's
    and the table's."""
    plan = _plan(name)
    block, w_smem = pt.train_bwd_config(plan)
    smem = pt.train_bwd_smem_bytes(plan, block, w_smem)
    assert plan.bwd_ws == 0
    assert block in pt.BWD_TILED_BLOCKS and block % 32 == 0 and block <= pt.BWD_TILED_MAX_BLOCK
    assert smem <= ps.SMEM_LIMIT == 232448
    assert pt.blocks_per_sm(smem, block) >= 1
    block, w_smem = pt.train_bwd_thread_config(plan)
    assert block in pt.BWD_BLOCKS and block <= pt.BWD_MAX_BLOCK
    assert pt.blocks_per_sm(pt.train_bwd_thread_smem_bytes(plan, block, w_smem), block) >= 1
    desc = plan.descriptor("cpu")
    assert plan.desc_len == desc.numel() == ps.plan_descriptor(plan.flow, plan.meta)[0].size
    assert plan.table("cpu").numel() == plan.fwd_tab.size


@pytest.mark.parametrize("name", sorted(PLANS))
def test_bwd_kernel_by_the_widths(name):
    """Plans whose layers are all narrower than 32 run the per-thread
    kernel on its local arrays (camel, the flagship, the small test flows),
    plans with a layer of 32 or more the tiled kernel (zz4l, hidden layers
    of 64); each with its own launch."""
    plan = _plan(name)
    widest = max(fo if li < len(m) - 1 else fi
                 for m in plan.meta for li, (fi, fo, _) in enumerate(m))
    tiled = name in ("zz4l", "max_hidden_rank")
    assert (widest >= pt.BWD_TILED_MIN_WIDTH) == tiled
    assert plan.bwd_kernel == pt.bwd_kernel_for(plan) == ("tiled" if tiled else "local")
    plan.descriptor("cpu")
    assert plan.bwd_config == (pt.train_bwd_config(plan) if tiled
                               else pt.train_bwd_thread_config(plan))


@pytest.mark.parametrize("name", sorted(PLANS))
def test_bwd_tiles_hold_every_layer(name):
    """H holds every last hidden layer's output; Z one transformed
    dimension's logits of the last layer and two hidden layers' output
    cotangents (one where a cell has one hidden layer); V the VJP's scratch
    (pwquad's logits, pwlin's bins) and the hidden outputs before the last;
    Wh a cell's hidden layers and Wl one dimension's columns of its last
    layer, rows padded to four floats; each the largest the plan needs.  The
    per-thread kernel's H every layer's input and the bias row, its G every
    hidden layer's output and one transformed dimension's logits."""
    plan = _plan(name)
    need = [0, 1, 0, 0, 0]
    need_h = need_g = 0
    for cfg, shapes in zip(plan.flow.cells, plan.meta):
        width = {"pwquad": 2 * (cfg.n_bins or 0) + 1, "pwlin": cfg.n_bins,
                 "affine": 2}[cfg.kind]
        # the last layer's logits, a run of `width` per transformed dimension
        assert shapes[-1][1] == (plan.flow.n_flow - cfg.pass_through) * width
        for li, (fan_in, fan_out, _) in enumerate(shapes):
            need_h = max(need_h, fan_in + 1)
            need_g = max(need_g, fan_out if li < len(shapes) - 1 else width)
        hidden, fin = shapes[:-1], shapes[-1][0]
        scratch = {"pwquad": width, "pwlin": cfg.n_bins, "affine": 0}[cfg.kind]
        need[1] = max(need[1], width)
        need[2] = max(need[2], scratch)
        need[4] = max(need[4], (fin + 1) * -(-width // 4) * 4)
        if hidden:
            need[0] = max(need[0], fin)
            need[1] = max(need[1], min(len(hidden), 2) * max(fo for _, fo, _ in hidden))
            need[2] = max(need[2], sum(fo for _, fo, _ in hidden[:-1]))
            need[3] = max(need[3], sum((fi + 1) * -(-fo // 4) * 4 for fi, fo, _ in hidden))
    assert pt.train_bwd_tiles(plan) == plan.bwd_tiles == tuple(need)
    assert pt.train_bwd_thread_tiles(plan) == (need_h, need_g)


def test_bwd_smem_count_flagship():
    """The flagship's count spelled out: 6,888 folded weights, a 386-int
    descriptor, a 99-int row table, 24 ops; tiles H 4 (the rank-4 factor),
    Z 32 (two hidden cotangents of 16), V 32 (17 logits, then the 16 and 4
    hidden outputs before the last), Wh 484 and Wl 5 x 20 floats; rows of
    block + 4 floats, the dW accumulator in device memory.  Four blocks of
    128 per SM by shared memory with the weights' copies in it, three by
    the tiled kernel's registers: its launch.  The per-thread kernel, which
    runs the flagship (16 wide): 17-row tiles, four blocks of 128 with the
    weights in shared memory (per-warp dW slices of all weights would take
    139,304 B: one block); its launch keeps at least two blocks per SM."""
    plan = _plan("flagship10d_rank4")
    assert (plan.n_weights, plan.desc_len, plan.fwd_tab.size, len(plan.flow.ops)) == \
        (6888, 386, 99, 24)
    assert pt.train_bwd_tiles(plan) == (4, 32, 32, 484, 100)
    assert pt.train_bwd_smem_bytes(plan, 128) == \
        4 * (488 + 484 + 100 + (20 + 4 + 32 + 32) * 132)
    assert pt.train_bwd_smem_bytes(plan, 64, False) == 4 * (488 + (20 + 4 + 32 + 32) * 68)
    assert pt.blocks_per_sm(pt.train_bwd_smem_bytes(plan, 128), 128) == 4
    assert pt.bwd_tiled_sm_threads(plan) == 384
    assert pt.blocks_per_sm(pt.train_bwd_smem_bytes(plan, 128), 128, 384) == 3
    block, w_smem = pt.train_bwd_config(plan)
    assert (block, w_smem) == (128, True)
    assert pt.blocks_per_sm(pt.train_bwd_smem_bytes(plan, block, w_smem), block) >= 2
    assert plan.bwd_kernel == "local"
    assert pt.train_bwd_thread_tiles(plan) == (17, 17)
    assert pt.train_bwd_thread_smem_bytes(plan, 128) == \
        4 * (6888 + 386 + 25 + 34 * 129 + 4 * 128)
    assert pt.train_bwd_thread_smem_bytes(plan, 512, False) == \
        4 * (386 + 25 + 34 * 513 + 4 * 512)
    assert pt.blocks_per_sm(pt.train_bwd_thread_smem_bytes(plan, 128), 128) == 4
    assert pt.blocks_per_sm(4 * (5 * 6888 + 386), 128) == 1
    block, w_smem = pt.train_bwd_thread_config(plan)
    assert pt.blocks_per_sm(pt.train_bwd_thread_smem_bytes(plan, block, w_smem), block) >= 2


@pytest.mark.parametrize("smem,block,expected", [
    (10052, 128, 16),        # by threads
    (36164, 512, 4),         # by threads
    (76240, 128, 3),         # by shared memory
    (232448, 128, 1),
    (232449, 128, 0),
])
def test_blocks_per_sm(smem, block, expected):
    assert pt.blocks_per_sm(smem, block) == expected


@pytest.mark.parametrize("name,rt,config,per_sm", [
    ("camel", 1, (128, True), 3),        # by registers (15 by shared memory)
    ("flagship10d_rank4", 1, (128, True), 3),  # by registers (4)
    ("zz4l", 2, (128, True), 2),         # by shared memory (3 by registers)
    ("hidden40", 4, (128, True), 2),     # by registers (4)
    ("hidden64x2", 4, (64, False), 3),   # by shared memory (4)
])
def test_tiled_backward_residency_counts_registers(name, rt, config, per_sm):
    """The tiled backward's blocks an SM are capped by its registers as its
    launch bound sets them, three blocks of 128 with one or two register
    tiles of R and two with four, and by shared memory; its launch and its
    grid at 2^20 samples (one block a resident slot) follow."""
    nn = {"hidden40": (40,), "hidden64x2": (64, 64)}.get(name)
    plan = pt.TrainPlan(factory.build_pwquad_flow(torch.Generator().manual_seed(0), 2, 2, 4,
                                                  nn).flow) if nn else _plan(name)
    assert pt.train_bwd_microtile(plan) == rt
    threads = pt.bwd_tiled_sm_threads(plan)
    assert threads == {1: 384, 2: 384, 4: 256}[rt]
    assert pt.train_bwd_config(plan) == config
    block, w_smem = config
    assert pt.blocks_per_sm(pt.train_bwd_smem_bytes(plan, block, w_smem), block, threads) == \
        per_sm
    assert pt.bwd_blocks(plan, 1 << 20, block, w_smem) == per_sm * ps.SM_COUNT


def test_bwd_config_prefers_two_blocks_then_residents():
    """The tiled kernel, whose registers hold three blocks of 128 or six of
    64 on these plans: camel's and the flagship's 384 threads at both sizes
    with the weights' copies in shared memory or read through L1, so the
    copies and the larger block; hidden layers of 64 take blocks of 64
    (three an SM by shared memory).  The per-thread kernel, which runs camel and the flagship: camel
    keeps 2048 threads resident at every block size with the weights in
    shared memory, so the largest block; the flagship 256 threads with the
    weights through L1, 1280 resident in five blocks (by shared memory and
    threads; its 64 registers a thread hold four)."""
    assert pt.train_bwd_thread_config(_plan("camel")) == (512, True)
    assert pt.train_bwd_thread_config(_plan("flagship10d_rank4")) == (256, False)
    assert pt.train_bwd_config(_plan("camel")) == (128, True)
    assert pt.train_bwd_config(_plan("flagship10d_rank4")) == (128, True)
    block, w_smem = pt.train_bwd_config(_plan("max_hidden_rank"))
    assert (block, w_smem) == (64, False)
    smem = pt.train_bwd_smem_bytes(_plan("max_hidden_rank"), block, w_smem)
    assert pt.blocks_per_sm(smem, block) >= 2


def test_zz4l_backward_takes_the_tiled_kernel_two_blocks_an_sm():
    """The zz4l plan (8 cells, pass-through widths 8/2/6/4/6/4/5/5, 65
    logits a transformed dimension, last-layer fan_in 32): the tiled kernel
    in blocks of 128 with the weights' copies in shared memory, two blocks
    an SM (its 95,784 folded weights, 383 KB, fit no block), R in two
    register tiles a thread, and a grid of one block per resident slot."""
    plan = _plan("zz4l")
    assert [cfg.pass_through for cfg in plan.flow.cells] == [8, 2, 6, 4, 6, 4, 5, 5]
    assert plan.n_weights == 95784 and 4 * plan.n_weights > ps.SMEM_LIMIT
    assert plan.bwd_ws == 0 and pt.train_bwd_microtile(plan) == 2
    assert plan.bwd_tiles == (32, 65, 65, 1344, 33 * 68)
    block, w_smem = pt.train_bwd_config(plan)
    smem = pt.train_bwd_smem_bytes(plan, block, w_smem)
    assert (block, w_smem) == (128, True) and pt.blocks_per_sm(smem, block) == 2
    assert pt.bwd_blocks(plan, 1 << 18, block, w_smem) == 2 * ps.SM_COUNT == 264
    assert pt.bwd_blocks(plan, 1000, block, w_smem) == 8


@pytest.mark.parametrize("name", sorted(PLANS))
def test_bwd_microtile_is_a_function_of_the_widths(name):
    """The register tiles follow from the widest last layer's fan_in alone:
    the fewest tiles of 16 rows that hold it, and the same plan under
    another seed gives the same choice."""
    plan = _plan(name)
    fin = max(m[-1][0] for m in plan.meta)
    assert pt.train_bwd_microtile(plan) == next(r for r in (1, 2, 4) if fin <= 16 * r)
    again = pt.TrainPlan(PLANS[name](torch.Generator().manual_seed(7)).flow)
    assert pt.train_bwd_microtile(again) == pt.train_bwd_microtile(plan)


def test_bwd_microtile_beyond_the_register_tiles():
    """A last layer of more than 64 inputs has no register tiles: the plan
    runs the per-thread kernel on its workspace, with that kernel's
    launch."""
    plan = pt.TrainPlan(factory.build_pwquad_flow(torch.Generator().manual_seed(0), 2, 2, 4,
                                                  (65,)).flow)
    assert pt.train_bwd_microtile(plan) is None
    with pytest.raises(ValueError, match="fan_in exceeds 64"):
        pt.train_bwd_config(plan)
    assert plan.bwd_ws == pt.bwd_workspace_floats(plan) > 0
    plan.descriptor("cpu")
    assert plan.bwd_kernel == "workspace"
    assert plan.bwd_config == pt.train_bwd_thread_config(plan)
    assert plan.bwd_config[0] in pt.BWD_BLOCKS


def test_train_backward_on_cpu_ignores_launch_config():
    """A CPU call runs the plain version whatever launch it is given."""
    model = PLANS["camel"](torch.Generator().manual_seed(1))
    plan = pt.TrainPlan(model.flow)
    flat = pt.fold_flow(model).detach()
    w = torch.from_numpy(np.random.RandomState(0).uniform(size=(50, 2)).astype(np.float32))
    xbar = torch.ones((50, 2))
    jbar = torch.ones(50)
    _, jac, stage = pt.train_forward(plan, flat, w)
    a = pt.train_backward(plan, flat, stage, jac, jbar, xbar, latents=w)
    b = pt.train_backward(plan, flat, stage, jac, jbar, xbar, latents=w, config=(128, False))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ---------------------------------------------------------------------------
# The managers run on the card unless asked for the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cls", [BasicManager, AffineManager, PWLinManager, PWQuadManager])
def test_manager_defaults_to_the_card(cls):
    """With a card, a manager built without ``device`` lives on it; without
    one it raises and names ``device='cpu'`` rather than running on the
    CPU."""
    if torch.cuda.is_available():
        assert cls(n_flow=2, seed=0).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(n_flow=2, seed=0)
        with pytest.raises(RuntimeError):
            cls(n_flow=2, seed=0, device="cuda:0")


def test_manager_on_cpu_runs():
    NF = PWQuadManager(n_flow=2, seed=0, device="cpu")
    assert NF.device.type == "cpu"
    NF.create_model(2, 4, [3] * 3)
    x, jac = NF.sample(200)
    assert x.device.type == "cpu" and x.shape == (200, 2)
    assert bool(torch.isfinite(jac).all() and ((x >= 0) & (x <= 1)).all())
