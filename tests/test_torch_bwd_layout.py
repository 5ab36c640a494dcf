"""The training backward's launch layout, computed in Python for the CUDA
kernel (tile rows, shared-memory bytes, block size, weight placement), and
the managers' device default.  Runs on the CPU: it checks the counts that
``nf_pwquad_train_bwd`` holds its launches to, not the kernel.  Imports
neither JAX nor nf_tpu."""

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


# The plans the port's tests and chip_smoke.py run the training kernels on
# (nf_tpu's five training configurations, the 10-D flagship, and the other
# flows of tests/test_torch_kernel.py), one with hidden layers at the
# backward's local-array width and a factored final layer among them.
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
        g, 2, 2, 4, (pt.BWD_LOCAL_HIDDEN, pt.BWD_LOCAL_HIDDEN), final_rank=3),
    "pwlin_8bins": lambda g: factory.build_pwlin_flow(g, 3, 1, 3, 8, (8, 8), 1),
    "affine_6": lambda g: factory.build_affine_flow(g, 3, 1, 2, (6,), 1),
}


def _plan(name):
    return pt.TrainPlan(PLANS[name](torch.Generator().manual_seed(0)).flow)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_bwd_launch_fits_shared_memory(name):
    """The chosen launch fits one block's 232,448 B and at least one block
    per SM; the descriptor accepts the plan; the length the smem count uses
    is the descriptor's."""
    plan = _plan(name)
    block, w_smem = pt.train_bwd_config(plan)
    smem = pt.train_bwd_smem_bytes(plan, block, w_smem)
    assert block in pt.BWD_BLOCKS and block % 32 == 0 and block <= pt.BWD_MAX_BLOCK
    assert smem <= ps.SMEM_LIMIT == 232448
    assert pt.blocks_per_sm(smem, block) >= 1
    desc = plan.descriptor("cpu")
    assert plan.desc_len == desc.numel() == ps.plan_descriptor(plan.flow, plan.meta)[0].size


@pytest.mark.parametrize("name", sorted(PLANS))
def test_bwd_tiles_hold_every_layer(name):
    """H holds every layer's input and the bias row; G every hidden layer's
    output and one transformed dimension's logits of the last layer; the
    rows are the largest the plan needs."""
    plan = _plan(name)
    h_rows, g_rows = pt.train_bwd_tiles(plan)
    need_h = need_g = 0
    for cfg, shapes in zip(plan.flow.cells, plan.meta):
        width = {"pwquad": 2 * (cfg.n_bins or 0) + 1, "pwlin": cfg.n_bins,
                 "affine": 2}[cfg.kind]
        # the last layer's logits, a run of `width` per transformed dimension
        assert shapes[-1][1] == (plan.flow.n_flow - cfg.pass_through) * width
        for li, (fan_in, fan_out, _) in enumerate(shapes):
            need_h = max(need_h, fan_in + 1)
            need_g = max(need_g, fan_out if li < len(shapes) - 1 else width)
    assert (h_rows, g_rows) == (need_h, need_g)


def test_bwd_smem_count_flagship():
    """The flagship's count spelled out: 6,888 folded weights, a 386-int
    descriptor, 24 ops, 17-row tiles; three blocks of 128 per SM with the
    weights in shared memory (per-warp dW slices of all weights would take
    139,304 B: one block), and the chosen launch keeps at least two blocks
    per SM."""
    plan = _plan("flagship10d_rank4")
    assert (plan.n_weights, plan.desc_len, len(plan.flow.ops)) == (6888, 386, 24)
    assert pt.train_bwd_tiles(plan) == (17, 17)
    assert pt.train_bwd_smem_bytes(plan, 128) == 4 * (2 * 6888 + 386 + 25 + 34 * 129 + 4 * 128)
    assert pt.train_bwd_smem_bytes(plan, 512, False) == \
        4 * (6888 + 386 + 25 + 34 * 513 + 4 * 512)
    assert pt.blocks_per_sm(pt.train_bwd_smem_bytes(plan, 128), 128) == 3
    assert pt.blocks_per_sm(4 * (5 * 6888 + 386), 128) == 1
    block, w_smem = pt.train_bwd_config(plan)
    assert pt.blocks_per_sm(pt.train_bwd_smem_bytes(plan, block, w_smem), block) >= 2


@pytest.mark.parametrize("smem,block,expected", [
    (10052, 128, 16),        # by threads
    (36164, 512, 4),         # by threads
    (76240, 128, 3),         # by shared memory
    (232448, 128, 1),
    (232449, 128, 0),
])
def test_blocks_per_sm(smem, block, expected):
    assert pt.blocks_per_sm(smem, block) == expected


def test_bwd_config_prefers_two_blocks_then_residents():
    """camel: every block size keeps 2048 threads resident with the weights
    in shared memory, so the largest block; the flagship: 512 threads with
    the weights through L1 keep 1024 resident in two blocks."""
    assert pt.train_bwd_config(_plan("camel")) == (512, True)
    assert pt.train_bwd_config(_plan("flagship10d_rank4")) == (512, False)
    block, w_smem = pt.train_bwd_config(_plan("max_hidden_rank"))
    smem = pt.train_bwd_smem_bytes(_plan("max_hidden_rank"), block, w_smem)
    assert pt.blocks_per_sm(smem, block) >= 2


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
