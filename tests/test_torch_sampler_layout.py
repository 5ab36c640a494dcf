"""The sampler's launch layout, computed in Python for the CUDA kernels (the
row table, tile rows, padded weights, the tiled kernel's copies,
shared-memory bytes, block size and weight placement), which kernel each
plan takes, the launch rule's fallback to small blocks, and the training
backward's workspace for plans beyond its local arrays.  Runs on the CPU:
it checks the counts that ``nf_pwquad_sampler``, ``nf_pwquad_sampler_tiled``
and ``nf_pwquad_train_bwd`` hold their launches to, and the table's meaning
against the plain version, not the kernels.  Imports neither JAX nor
nf_tpu."""

import dataclasses

import numpy as np
import pytest
import torch

from nf_tpu_torch import PWQuadManager
from nf_tpu_torch.bijectors import coupling
from nf_tpu_torch.flows import factory
from nf_tpu_torch.flows.fast_eval import apply_folded, permutation_index
from nf_tpu_torch.flows.model import FlowModel
from nf_tpu_torch.ops import pwquad_sampler as ps
from nf_tpu_torch.ops import pwquad_train as pt
from test_torch_bwd_layout import PLANS

torch.set_num_threads(1)


def _reordered(gen):
    """Cell ops out of index order, one cell applied twice, rolls between:
    a descriptor the sampler takes and the training kernels refuse."""
    model = factory.build_pwquad_flow(gen, 3, 3, 4, (5,))
    cells = [op for op in model.flow.ops if op[0] == "cell"]
    rolls = [op for op in model.flow.ops if op[0] != "cell"]
    ops = (cells[2], rolls[0], cells[0], cells[2], rolls[-1], cells[1])
    return FlowModel(dataclasses.replace(model.flow, ops=ops), gen, torch.float32, "cpu")


def _zz_zprime(gen):
    """The ZZ/Z' plan of examples/zz_multichannel.py: n_flow 11, 16 bins,
    hidden [32, 32], a rank-4 final layer."""
    NF = PWQuadManager(n_flow=11, seed=0, device="cpu")
    NF.create_model(4, 16, [32, 32], identity_init=True, final_rank=4)
    return NF._model


# The training plans, a reordered plan, plans beyond the kernels' old caps
# (40 bins with hidden layers of 96, 36 latent dims with a narrow MLP, and
# create_model(2, 4, [128, 128]), 257 layer inputs a cell), the ZZ/Z' plan
# and wide pwlin and affine plans.
SAMPLER_PLANS = dict(PLANS, **{
    "reordered": _reordered,
    "bins40_hidden96": lambda g: factory.build_pwquad_flow(g, 2, 2, 40, (96, 96)),
    "flow36_narrow": lambda g: factory.build_pwquad_flow(g, 36, 2, 2, (4,)),
    "wide128": lambda g: factory.build_pwquad_flow(g, 2, 2, 4, (128, 128)),
    "zz_zprime": _zz_zprime,
    "pwlin_wide": lambda g: factory.build_pwlin_flow(g, 3, 1, 3, 8, (32, 32), 1),
    "affine_wide": lambda g: factory.build_affine_flow(g, 3, 1, 2, (32, 32), 1),
})
OVER_CAPS = ("bins40_hidden96", "flow36_narrow", "wide128")
# The plans with a layer SAMPLER_TILED_MIN_WIDTH wide or more: the tiled
# sampler runs them.
TILED = ("zz4l", "max_hidden_rank", "bins40_hidden96", "wide128", "zz_zprime", "pwlin_wide",
         "affine_wide")

# Every combination sampler_config chooses from, as (block, w_smem).
CONFIGS = [(b, w) for b in ps.SAMPLER_BLOCKS for w in (True, False)]


def _plan(name):
    return ps.SamplerPlan(SAMPLER_PLANS[name](torch.Generator().manual_seed(0)).flow)


def test_sampler_smem_count_camel():
    """camel: a 60-int descriptor (2 cells of 6 + 4 x 5, 2 rolls of 3, the
    header), the table (cell count, 2 positions, 3 maps of 2 rows: 9 ints),
    69 padded to 72; 176 padded weights; X 2 rows, A 3, B the 9 logits: the
    training forward's count without the statistics."""
    plan = _plan("camel")
    assert plan.desc.size == 60 and plan.table.size == 9
    assert plan.n_wpad == 176 and plan.tiles == (3, 9)
    assert ps.sampler_smem_bytes(plan, 512, True) == 4 * (72 + 176 + 14 * 513) == 29720
    assert ps.sampler_smem_bytes(plan, 128, False) == 4 * (72 + 14 * 129)
    assert plan.config == (512, True)


def test_sampler_smem_count_flagship():
    """The flagship: the training forward's descriptor (386 ints), table
    (99) and padded weights (7,488 floats) without the statistics; 43 tile
    rows.  Three blocks of 256 with the weights in shared memory fit an SM
    (four of 128, one of 512): 256, the forward's choice."""
    plan = _plan("flagship10d_rank4")
    tplan = pt.TrainPlan(plan.flow)
    assert plan.desc.size == tplan.desc_len == 386
    np.testing.assert_array_equal(plan.table, tplan.fwd_tab)
    assert plan.n_wpad == tplan.n_wpad == 7488 and plan.tiles == tplan.fwd_tiles == (16, 17)
    for block in ps.SAMPLER_BLOCKS:
        for w_smem in (True, False):
            assert ps.sampler_smem_bytes(plan, block, w_smem) == \
                pt.train_fwd_smem_bytes(tplan, block, w_smem)
    assert ps.sampler_smem_bytes(plan, 256, True) == 4 * (488 + 7488 + 43 * 257) == 76108
    assert ps.blocks_per_sm(76108, 256) == 3
    assert plan.config == (256, True)


@pytest.mark.parametrize("name", sorted(SAMPLER_PLANS))
def test_sampler_table_walk_matches_plain_version(name):
    """The kernel's walk, written in torch: the state stays in rows that
    the permutations never move; cell op c reads logical dimension d from
    row m[d] of its table entry, runs its layers from the descriptor's
    offsets into the flat weights, and writes its transformed dimensions
    back there; x is read out through the last entry.  It equals the plain
    version, whatever the op order."""
    model = SAMPLER_PLANS[name](torch.Generator().manual_seed(3))
    flow = model.flow
    folded = [[(torch.from_numpy(w).double(), torch.from_numpy(b).double(), relu)
               for w, b, relu in layers]
              for layers in ps.fold_eval_params(flow, model, dtype=np.float64)]
    plan = ps.SamplerPlan(flow)
    desc = plan.desc
    # the flat buffer as encode_plan lays it out, kept in float64
    weights = torch.cat([t.reshape(-1) for op in flow.ops if op[0] == "cell"
                         for wm, bv, _ in folded[op[1]] for t in (wm, bv)])
    w = torch.from_numpy(np.random.RandomState(4).uniform(size=(64, flow.n_flow)))
    x_p, jac_p = apply_folded(flow, folded, permutation_index(flow, "cpu"), w)
    n_flow, n_cells = flow.n_flow, int(plan.table[0])
    assert n_cells == sum(op[0] == "cell" for op in flow.ops)
    maps = torch.as_tensor(plan.table[1 + n_cells:]).long().reshape(n_cells + 1, n_flow)
    cells = [op[1] for op in flow.ops if op[0] == "cell"]
    rows, jac = w.T.clone(), torch.ones(64, dtype=torch.float64)
    for c, p in enumerate(plan.table[1:1 + n_cells]):
        cfg = flow.cells[cells[c]]
        assert desc[p] == ps.OP_CELL and desc[p + 2] == cfg.pass_through
        xin = rows[maps[c]].T
        h = xin[:, :cfg.pass_through]
        for li in range(desc[p + 5]):
            fan_in, fan_out, relu, w_off, b_off = desc[p + 6 + 5 * li:p + 11 + 5 * li]
            h = h @ weights[w_off:w_off + fan_in * fan_out].reshape(fan_in, fan_out) \
                + weights[b_off:b_off + fan_out]
            h = torch.relu(h) if relu else h
        y, factor = coupling.transform(cfg, h, xin[:, cfg.pass_through:])
        rows[maps[c][cfg.pass_through:]] = y.T
        jac = jac * factor
    torch.testing.assert_close(rows[maps[n_cells]].T, x_p, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(jac, jac_p, rtol=1e-12, atol=0)


@pytest.mark.parametrize("name", sorted(SAMPLER_PLANS))
def test_sampler_config_rule(name):
    """The per-thread kernel's launch fits one block's 232,448 B; at least
    two blocks per SM where any launch has them; then the weights in shared
    memory where any such launch has them; then no launch keeps more
    threads resident; on a tie the largest block.  The plan's launch is
    its kernel's."""
    plan = _plan(name)

    def key(config):
        k = ps.blocks_per_sm(ps.sampler_smem_bytes(plan, *config), config[0])
        return k >= 2, config[1], k * config[0]

    assert plan.config == ps.launch_config(plan, plan.kernel)
    chosen = ps.sampler_config(plan)
    assert chosen in CONFIGS
    assert ps.sampler_smem_bytes(plan, *chosen) <= ps.SMEM_LIMIT
    fitting = [c for c in CONFIGS if ps.sampler_smem_bytes(plan, *c) <= ps.SMEM_LIMIT]
    assert all(key(c) <= key(chosen) for c in fitting)
    ties = [c for c in fitting if key(c) == key(chosen)]
    assert chosen == max(ties, key=lambda c: c[0])


def test_sampler_tiles_over_the_old_caps():
    """wide128's hidden layers fill A and B (128 rows each); at 128 threads
    with the weights through L1 it takes 133,368 B, one block an SM,
    and its 36,632 padded weights leave no room beside them.  The 40-bin
    plan's logits take 81 rows of B."""
    plan = _plan("wide128")
    assert plan.tiles == (128, 128) and plan.n_wpad == 2 * (2 * 128 + 129 * 128 + 129 * 12)
    assert ps.sampler_config(plan) == (128, False)
    assert ps.sampler_smem_bytes(plan, 128, False) == 4 * (60 + 258 * 129) == 133368
    assert ps.sampler_smem_bytes(plan, 128, True) > ps.SMEM_LIMIT
    assert _plan("bins40_hidden96").tiles == (96, 96)
    assert _plan("flow36_narrow").tiles[0] == 4


def test_launch_falls_back_to_small_blocks_then_raises():
    """A plan whose tiles fit no block of 128 (460 latent dims: X alone takes
    237,360 B at 128 threads) takes 64 or 32 threads in the sampler, the
    training forward and the tiled backward (whose X and XB hold the state
    as the forward's X does).  A plan that fits not even 32 threads raises
    ValueError for the sampler and the training kernels alike; nothing
    falls back to the plain version."""
    gen = torch.Generator().manual_seed(0)
    many = factory.build_pwlin_flow(gen, 460, 230, 1, 2, (2,), 1)
    plan = ps.SamplerPlan(many.flow)
    assert plan.config[0] in ps.SMALL_BLOCKS
    assert ps.sampler_smem_bytes(plan, 128, False) > ps.SMEM_LIMIT
    tplan = pt.TrainPlan(many.flow)
    tplan.descriptor("cpu")
    assert all(config[0] in ps.SMALL_BLOCKS for config in tplan.fwd_config.values())
    assert tplan.bwd_ws == 0 and tplan.bwd_config[0] in ps.SMALL_BLOCKS
    assert pt.train_bwd_smem_bytes(tplan, 64, False) > ps.SMEM_LIMIT
    huge = factory.build_pwquad_flow(gen, 2, 2, 4, (900, 900))
    with pytest.raises(ValueError, match="no launch fits"):
        ps.SamplerPlan(huge.flow)
    with pytest.raises(ValueError, match="no launch fits"):
        pt.TrainPlan(huge.flow).descriptor("cpu")


@pytest.mark.parametrize("smem,block,expected", [
    (0, 32, 32),             # by the SM's 32 blocks, not its 64 warps
    (0, 64, 32),
    (1000, 128, 16),
])
def test_blocks_per_sm_counts_the_block_limit(smem, block, expected):
    assert ps.blocks_per_sm(smem, block) == expected


def test_backward_workspace_sizes():
    """wide128: its last layer takes 128 inputs, more than the tiled
    backward's register tiles hold (64), so it runs the workspace backward,
    whose arrays per thread are 3 x 2 (xbar, xin, the permutation's
    scratch) + 257 + 2 x 128 + 2 x 9 (logits and their cotangent) + 5 x 4 +
    3.  The flagship takes the tiled kernel; of the plans beyond the old
    local arrays' caps, those whose last layer takes more than 64 inputs
    run the workspace kernel, the rest the tiled one."""
    plan = pt.TrainPlan(SAMPLER_PLANS["wide128"](torch.Generator().manual_seed(0)).flow)
    assert plan.bwd_sizes == (257, 128, 9, 4)
    assert plan.bwd_ws == pt.bwd_workspace_floats(plan) == 6 + 257 + 256 + 18 + 23
    flagship = pt.TrainPlan(PLANS["flagship10d_rank4"](torch.Generator().manual_seed(0)).flow)
    assert flagship.bwd_ws == 0 and flagship.bwd_sizes == (8 + 16 + 16 + 4, 16, 17, 8)
    for name in OVER_CAPS:
        plan = pt.TrainPlan(SAMPLER_PLANS[name](torch.Generator().manual_seed(0)).flow)
        wide = max(m[-1][0] for m in plan.meta) > pt.BWD_TILED_MAX_FIN
        assert plan.bwd_ws == (pt.bwd_workspace_floats(plan) if wide else 0)


def test_stats_partial_rows_cover_a_block_sum():
    """The stats forward's partial sums take the block's threads, or the
    rows of the widest block sum where that is more: wide128 sums 128 ReLU
    units at once, so a block of 64 keeps 128 rows of pairs."""
    plan = pt.TrainPlan(SAMPLER_PLANS["wide128"](torch.Generator().manual_seed(0)).flow)
    assert pt.stats_part_rows(plan, 64) == 128 and pt.stats_part_rows(plan, 256) == 256
    assert pt.train_fwd_smem_bytes(plan, 64, False, True) == \
        8 * (plan.n_stat_rows + 2 * 128) + 4 * (pt.round4(plan.desc_len + plan.fwd_tab.size)
                                                + 258 * 65)


@pytest.mark.parametrize("name", sorted(SAMPLER_PLANS))
def test_sampler_kernel_by_the_widths(name):
    """Plans with a layer (a hidden layer's outputs or a last layer's
    inputs) 32 wide or more run the tiled kernel (zz4l, the ZZ/Z' plan,
    create_model(2, 4, [128, 128]), wide pwlin and affine plans); plans
    whose layers are all narrower keep the per-thread kernel (camel, the
    10-D flagship, the small test flows)."""
    plan = _plan(name)
    widest = max(fo if li < len(m) - 1 else fi
                 for m in plan.shapes for li, (fi, fo, _) in enumerate(m))
    tiled = name in TILED
    assert (widest >= ps.SAMPLER_TILED_MIN_WIDTH) == tiled
    assert plan.kernel == ps.sampler_kernel_for(plan) == ("tiled" if tiled else "thread")
    assert plan.config == (ps.sampler_tiled_config(plan) if tiled else ps.sampler_config(plan))


def test_narrow_plans_keep_their_launch():
    """camel and the 10-D flagship keep the per-thread kernel at the launch
    they had before the tiled kernel: camel 512 threads, the flagship 256,
    both with the weights in shared memory."""
    for name, config in (("camel", (512, True)), ("flagship10d_rank4", (256, True))):
        plan = _plan(name)
        assert (plan.kernel, plan.config) == ("thread", config)
        assert ps.sampler_smem_bytes(plan, *config) <= ps.SMEM_LIMIT


def test_sampler_tiled_smem_count_zz4l():
    """The zz4l plan (n_flow 10, 8 cells, 32 bins, hidden [32, 32]): a
    346-int descriptor and a 99-int table, 445 padded to 448; copies of the
    widest cell's hidden layers ((8 + 1) x 32 + 33 x 32 = 1,344 floats) and
    of one transformed dimension's 65 logits padded to 68 (33 x 68 =
    2,244); X 10 rows, A 32, B the 65 logits, rows of 132 floats at 128
    threads.  Three blocks of 128 fit an SM by shared memory (four by
    registers): 128 threads with the copies in shared memory.  The
    per-thread kernel's launch is what it was, 256 threads through L1."""
    plan = _plan("zz4l")
    assert plan.desc.size == 346 and plan.table.size == 99
    assert plan.copies == (1344, 2244) and plan.tiles == (32, 65)
    assert ps.sampler_tiled_smem_bytes(plan, 128, True) == \
        4 * (448 + 1344 + 2244 + 107 * 132) == 72640
    assert ps.sampler_tiled_smem_bytes(plan, 64, False) == 4 * (448 + 107 * 68)
    assert ps.blocks_per_sm(72640, 128, ps.SAMPLER_TILED_MIN_BLOCKS * 128) == 3
    assert (plan.kernel, plan.config) == ("tiled", (128, True))
    assert ps.sampler_config(plan) == (256, False)


def test_sampler_tiled_smem_count_zz_zprime():
    """The ZZ/Z' plan (n_flow 11, 16 bins, hidden [32, 32], rank 4): the
    hidden copy holds the final layer's first factor too (32 x 4 and its
    bias) and the last layer's copy 4 inputs and the bias by 33 logits
    padded to 36; four blocks of 128 an SM."""
    plan = _plan("zz_zprime")
    wh, wl = plan.copies
    assert wl == 5 * 36 and plan.tiles == (32, 33)
    smem = ps.sampler_tiled_smem_bytes(plan, 128, True)
    assert smem == 4 * (ps.round4(plan.desc.size + plan.table.size) + wh + wl + 76 * 132)
    assert ps.blocks_per_sm(smem, 128, ps.SAMPLER_TILED_MIN_BLOCKS * 128) == 4
    assert (plan.kernel, plan.config) == ("tiled", (128, True))


@pytest.mark.parametrize("name", TILED)
def test_sampler_tiled_config_rule(name):
    """The tiled launch fits one block's 232,448 B; the copies in shared
    memory where any launch of them fits, even at one block an SM; then the
    most threads resident (by shared memory and by the registers
    SAMPLER_TILED_MIN_BLOCKS leaves); on a tie the larger block."""
    plan = _plan(name)
    threads = ps.SAMPLER_TILED_MIN_BLOCKS * ps.SAMPLER_TILED_BLOCK

    def key(config):
        k = ps.blocks_per_sm(ps.sampler_tiled_smem_bytes(plan, *config), config[0], threads)
        return config[1], k * config[0]

    chosen = ps.sampler_tiled_config(plan)
    configs = [(b, w) for b in ps.SAMPLER_TILED_BLOCKS for w in (True, False)]
    fitting = [c for c in configs if ps.sampler_tiled_smem_bytes(plan, *c) <= ps.SMEM_LIMIT]
    assert chosen in fitting
    assert all(key(c) <= key(chosen) for c in fitting)
    assert chosen == max((c for c in fitting if key(c) == key(chosen)), key=lambda c: c[0])


def test_tiled_copies_are_the_widest_cells():
    """The copies hold the widest cell's hidden layers and the widest last
    layer's columns of one transformed dimension, rows padded to four
    floats and the bias a last row: what the kernel's own count
    (tiled_copies in csrc/pwquad_sampler.cu) gives from the descriptor."""
    for name in TILED:
        plan = _plan(name)
        desc = plan.desc
        wh = wl = 0
        for p in plan.table[1:1 + plan.table[0]]:
            n_layers = desc[p + 5]
            layers = [desc[p + 6 + 5 * li:p + 11 + 5 * li] for li in range(n_layers)]
            wh = max(wh, sum((fi + 1) * ps.round4(fo) for fi, fo, *_ in layers[:-1]))
            kind, nb = desc[p + 1], desc[p + 3]
            width = 2 * nb + 1 if kind == ps.KIND["pwquad"] else (nb if kind == ps.KIND["pwlin"]
                                                                   else 2)
            wl = max(wl, (layers[-1][0] + 1) * ps.round4(width))
        assert plan.copies == (wh, wl) and wh % 4 == 0 and wl % 4 == 0


def test_wide128_tiled_keeps_its_copies_at_one_block_an_sm():
    """create_model(2, 4, [128, 128]): with the copies in shared memory one
    block of 128 fits an SM (209,728 B), without them three blocks of 64;
    the tiled launch keeps the copies (1.23x faster on the card, PERF.md
    section 6)."""
    plan = _plan("wide128")
    assert plan.copies == (2 * 128 + 129 * 128, 129 * 12)
    assert ps.sampler_tiled_smem_bytes(plan, 128, True) == \
        4 * (ps.round4(plan.desc.size + plan.table.size) + sum(plan.copies) + 258 * 132) == 209728
    assert ps.blocks_per_sm(209728, 128) == 1
    assert ps.blocks_per_sm(ps.sampler_tiled_smem_bytes(plan, 64, False), 64) == 3
    assert (plan.kernel, plan.config) == ("tiled", (128, True))
