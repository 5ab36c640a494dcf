"""The training forward's launch layout, computed in Python for the CUDA
kernel (the row table, tile rows, padded weights, shared-memory bytes, block
size, weight placement), and the backward's grid.  Runs on the CPU: it
checks the counts that ``nf_pwquad_train_fwd`` holds its launches to, and
the table's meaning against the plain version, not the kernel.  Imports
neither JAX nor nf_tpu."""

import numpy as np
import pytest
import torch

from nf_tpu_torch.bijectors import coupling
from nf_tpu_torch.ops import pwquad_sampler as ps
from nf_tpu_torch.ops import pwquad_train as pt
from test_torch_bwd_layout import PLANS, _plan

torch.set_num_threads(1)

# Every combination train_fwd_config chooses from, as (block, w_smem).
CONFIGS = [(b, w) for b in pt.FWD_BLOCKS for w in (True, False)]


def test_setup_ships_every_kernel_source():
    """setup.py's package_data for nf_tpu_torch.ops covers every file the
    kernels' build reads (the sources and the header they include)."""
    import ast
    import fnmatch
    import pathlib

    tree = ast.parse((pathlib.Path(__file__).resolve().parents[1] / "setup.py").read_text())
    call = next(node for node in ast.walk(tree)
                if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "setup")
    package_data = ast.literal_eval(next(k.value for k in call.keywords
                                         if k.arg == "package_data"))
    patterns = package_data["nf_tpu_torch.ops"]
    files = sorted(p.name for p in (pathlib.Path(pt.__file__).parent / "csrc").iterdir())
    assert "flow_plan.cuh" in files and "pwquad_train.cu" in files
    for name in files:
        assert any(fnmatch.fnmatch("csrc/" + name, pat) for pat in patterns), name


def test_fwd_smem_count_flagship():
    """The flagship's count spelled out.  Cells pass 8, 2, 6, 4, 6, 4, 5, 5
    dimensions through (40 in all, 40 transformed); each has layers (pt, 16)
    and (16, 16) with ReLU, the rank factor (16, 4) and (4, 17 t).  Padded:
    16 and 4 stay, each dimension's 17 logits take 20.  The table holds the
    cell count, 8 positions and 9 rows of 10; A takes the first and third
    hidden layers, B the second and the logits."""
    plan = _plan("flagship10d_rank4")
    assert [c.pass_through for c in plan.flow.cells] == [8, 2, 6, 4, 6, 4, 5, 5]
    wpad = (40 + 8) * 16 + 8 * 17 * 16 + 8 * 17 * 4 + 5 * 20 * 40
    assert plan.n_wpad == wpad == 7488
    assert plan.fwd_tab.size == 1 + 8 + 9 * 10
    assert plan.fwd_tiles == (16, 17)
    assert plan.n_stat_rows == 2 * (40 + 8 * 32)
    ints = 388 + 100  # 386 + 99, padded to four
    rows = 10 + 16 + 17
    assert pt.train_fwd_smem_bytes(plan, 128, True) == 4 * (ints + wpad + rows * 129) == 54092
    assert pt.train_fwd_smem_bytes(plan, 512, False, True) == \
        8 * (592 + 2 * 512) + 4 * (ints + rows * 513)
    assert pt.blocks_per_sm(pt.train_fwd_smem_bytes(plan, 128, True), 128) == 4
    assert pt.blocks_per_sm(pt.train_fwd_smem_bytes(plan, 128, False), 128) == 9


def test_fwd_smem_count_camel():
    """camel: two cells of layers (1, 3), (3, 3), (3, 3) with ReLU and
    (3, 9); padded (2 + 4 + 4) x 4 + 4 x 12 = 88 floats a cell; A takes the
    first and third hidden layers (3 rows), B the second and the 9 logits."""
    plan = _plan("camel")
    assert plan.n_wpad == 2 * ((2 + 4 + 4) * 4 + 4 * 12) == 176
    assert plan.fwd_tiles == (3, 9)
    assert plan.fwd_tab.tolist()[:3] == [2, 2, 31]
    assert plan.n_stat_rows == 2 * (2 + 2 * 3 * 3)
    assert pt.train_fwd_smem_bytes(plan, 512, True) == 4 * (72 + 176 + 14 * 513) == 29720
    assert pt.train_fwd_smem_bytes(plan, 128, False, True) == \
        8 * (40 + 256) + 4 * (72 + 14 * 129)


def test_fwd_table_masked_mini():
    """gather(p0), cell 0, scatter(p0), gather(p1), cell 1, scatter(p1):
    cell 0 reads logical dimension d from row p0[d], the scatter restores
    the identity, cell 1 reads from p1[d], and x ends in rows 0..3."""
    plan = _plan("masked_mini")
    p0 = ps.permutation_source(plan.flow.ops[0], 4)
    p1 = ps.permutation_source(plan.flow.ops[3], 4)
    tab = plan.fwd_tab
    assert tab[0] == 2
    desc = plan.descriptor("cpu").numpy()
    assert [desc[p] for p in tab[1:3]] == [ps.OP_CELL, ps.OP_CELL]
    maps = tab[3:].reshape(3, 4)
    np.testing.assert_array_equal(maps, [p0, p1, np.arange(4)])


@pytest.mark.parametrize("name", sorted(PLANS))
def test_fwd_table_walk_matches_plain_version(name):
    """The kernel's walk, written in torch: the state stays in rows that
    the permutations never move, each cell reads logical dimension d from
    row m[d] of its table entry and writes its transformed dimensions back
    there, and x is read out through the last entry.  Every cell's input is
    the plain version's stage, and x its x."""
    model = PLANS[name](torch.Generator().manual_seed(3))
    plan = pt.TrainPlan(model.flow)
    flat = pt.fold_flow(model).detach().double()
    n_flow, n_cells = plan.flow.n_flow, len(plan.flow.cells)
    w = torch.from_numpy(np.random.RandomState(4).uniform(size=(64, n_flow)))
    x_p, _, stage_p, _ = pt.forward_stats_ref(plan.flow, flat, w)
    maps = torch.as_tensor(plan.fwd_tab[1 + n_cells:]).long().reshape(n_cells + 1, n_flow)
    layers = pt._folded_layers(plan.flow, flat)
    rows = w.T.clone()
    for c, cfg in enumerate(plan.flow.cells):
        xin = rows[maps[c]].T
        torch.testing.assert_close(xin, stage_p[c].T, rtol=0, atol=0)
        h = xin[:, :cfg.pass_through]
        for wm, bv, relu in layers[c]:
            h = h @ wm + bv
            h = torch.relu(h) if relu else h
        y, _ = coupling.transform(cfg, h, xin[:, cfg.pass_through:])
        rows[maps[c][cfg.pass_through:]] = y.T
    torch.testing.assert_close(rows[maps[n_cells]].T, x_p, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_fwd_launch_fits_shared_memory(name):
    """Both variants' chosen launches fit one block's 232,448 B with at
    least one block per SM, and the descriptor accepts the plan; the A and
    B tiles hold every hidden layer's output and the logits."""
    plan = _plan(name)
    plan.descriptor("cpu")
    for stats in (False, True):
        block, w_smem = plan.fwd_config[stats]
        assert (block, w_smem) == pt.train_fwd_config(plan, stats)
        smem = pt.train_fwd_smem_bytes(plan, block, w_smem, stats)
        assert block in pt.FWD_BLOCKS and block <= pt.FWD_MAX_BLOCK
        assert smem <= ps.SMEM_LIMIT == 232448
        assert pt.blocks_per_sm(smem, block) >= 1
    rows_a, rows_b = plan.fwd_tiles
    for cfg, shapes in zip(plan.flow.cells, plan.meta):
        assert rows_b >= pt.logit_width(cfg)
        assert all(fo <= max(rows_a, rows_b) for _, fo, _ in shapes[:-1])
        if len(shapes) > 1:
            assert shapes[-2][1] <= rows_a   # the last hidden layer writes A


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_fwd_config_rule(name, stats):
    """At least two blocks per SM where any launch has them; then the
    weights in shared memory where any such launch has them; then no
    launch keeps more threads resident; on a tie the largest block."""
    plan = _plan(name)

    def key(config):
        k = pt.blocks_per_sm(pt.train_fwd_smem_bytes(plan, *config, stats), config[0])
        return k >= 2, config[1], k * config[0]

    chosen = pt.train_fwd_config(plan, stats)
    assert all(key(c) <= key(chosen) for c in CONFIGS)
    ties = [c for c in CONFIGS if key(c) == key(chosen)]
    assert chosen == max(ties, key=lambda c: c[0])


def test_fwd_config_choices():
    """camel keeps 2048 threads resident at every block size with the
    weights in shared memory: the largest block.  The flagship's padded
    weights (30 KB) beside its tiles leave three blocks of 256 per SM (four
    of 128), two with stats; through L1 more would fit, but the rule puts
    the weights in shared memory first."""
    assert pt.train_fwd_config(_plan("camel")) == (512, True)
    assert pt.train_fwd_config(_plan("camel"), True) == (512, True)
    assert pt.train_fwd_config(_plan("flagship10d_rank4")) == (256, True)
    assert pt.train_fwd_config(_plan("flagship10d_rank4"), True) == (256, True)
    # the backward keeps its own order: the most resident threads first
    assert pt.train_bwd_config(_plan("flagship10d_rank4")) == (256, False)


@pytest.mark.parametrize("n,block,expected", [
    (1, 128, 1), (128, 128, 1), (129, 128, 2), (1 << 18, 128, 2048),
    ((1 << 21) + 333, 512, 2048), (1 << 22, 256, 4096),
])
def test_fwd_grid(n, block, expected):
    """A block per tile, up to 2^20 threads; above, each block loops over
    several tiles."""
    assert pt.fwd_blocks(n, block) == expected


def test_bwd_grid_constant_unchanged():
    """The backward's grid keeps its own cap of 2^17 threads, whatever the
    forward's block is."""
    assert pt.BWD_MAX_THREADS == 1 << 17
    assert pt.FWD_MAX_THREADS == 1 << 20
    assert {b: pt.BWD_MAX_THREADS // b for b in pt.BWD_BLOCKS} == {128: 1024, 256: 512, 512: 256}


def test_train_forward_on_cpu_ignores_launch_config():
    """A CPU call runs the plain version whatever launch it is given, even
    one the kernel would refuse."""
    model = PLANS["flagship10d_rank4"](torch.Generator().manual_seed(1))
    plan = pt.TrainPlan(model.flow)
    flat = pt.fold_flow(model).detach()
    w = torch.from_numpy(np.random.RandomState(0).uniform(size=(50, 10)).astype(np.float32))
    launches = pt.FWD_LAUNCHES
    a = pt.train_forward(plan, flat, w, with_stats=True)
    for config in [(96, True), (512, False)]:
        b = pt.train_forward(plan, flat, w, with_stats=True, config=config)
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert pt.FWD_LAUNCHES == launches
