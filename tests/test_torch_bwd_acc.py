"""Where the training backward keeps its weight-gradient accumulator.

The backward sums each block's dW over its samples into an accumulator of
one float per weight.  In shared memory that capped its plans at about 56k
weights, and the 2 -> 4 collider model of tools/run_2to4.py
(``PWQuadManager(n_flow=10).create_model(4, 32, [32, 32])``: 8 cells,
95,784 folded weights) was refused: ``train_bwd_config`` raised
``ValueError`` and ``bn_stats="stale"`` could not train it on the card.  Now
every block accumulates in its own row of the partial-gradient scratch in
device memory, whatever the plan and whichever kernel (the tiled backward
or the per-thread one).  The CPU checks here are the counts that
``nf_pwquad_train_bwd_tiled`` and ``nf_pwquad_train_bwd`` hold their
launches to, not the kernels (``chip_smoke.py`` phase 13 runs the kernel on
this plan against its plain version).  Imports neither JAX nor nf_tpu."""

import pytest
import torch

from nf_tpu_torch import PWQuadManager
from nf_tpu_torch.flows import factory
from nf_tpu_torch.ops import pwquad_sampler as ps
from nf_tpu_torch.ops import pwquad_train as pt

torch.set_num_threads(1)


def _zz_plan():
    NF = PWQuadManager(n_flow=10, seed=0, device="cpu")
    NF.create_model(4, 32, [32] * 2, identity_init=True)
    return pt.TrainPlan(NF._flow)


def test_zz_plan_needs_more_than_shared_memory_for_the_accumulator():
    """The fault: with the accumulator in shared memory beside the tiles,
    not even a block of 32 threads fits the 2 -> 4 plan, in either kernel,
    so a shared accumulator would leave it no launch."""
    plan = _zz_plan()
    assert plan.n_weights == 95784 and len(plan.flow.cells) == 8
    block = ps.SMALL_BLOCKS[-1]
    assert pt.train_bwd_thread_smem_bytes(plan, block, False) + 4 * plan.n_weights > ps.SMEM_LIMIT
    assert pt.train_bwd_smem_bytes(plan, block, False) + 4 * plan.n_weights > ps.SMEM_LIMIT
    with pytest.raises(ValueError, match="no launch fits"):
        pt.best_launch(pt.BWD_BLOCKS,
                       lambda b, w: pt.train_bwd_thread_smem_bytes(plan, b, w) + 4 * plan.n_weights,
                       what="training backward")
    with pytest.raises(ValueError, match="no launch fits"):
        pt.best_launch(pt.BWD_TILED_BLOCKS,
                       lambda b, w: pt.train_bwd_smem_bytes(plan, b, w) + 4 * plan.n_weights,
                       what="tiled training backward")


def test_zz_plan_backward_launch_with_the_accumulator_in_device_memory():
    """The tiled backward in blocks of 128, two an SM, with one cell's hidden
    layers and one transformed dimension's last-layer columns copied into
    shared memory beside the tiles; the accumulator outside."""
    plan = _zz_plan()
    block, w_smem = pt.train_bwd_config(plan)
    smem = pt.train_bwd_smem_bytes(plan, block, w_smem)
    assert (block, w_smem) == (128, True)
    assert smem <= ps.SMEM_LIMIT and pt.blocks_per_sm(smem, block) >= 2
    # the tiles and the weights' copies: the weights and the accumulator
    # both outside
    h_rows, z_rows, v_rows, wh, wl = pt.train_bwd_tiles(plan)
    assert smem == 4 * (pt.round4(plan.desc_len + plan.fwd_tab.size) + wh + wl
                        + (2 * plan.flow.n_flow + h_rows + z_rows + v_rows) * (block + 4))
    assert wh + wl < plan.n_weights // 25
    plan.descriptor("cpu")
    assert plan.bwd_config == (128, True) and plan.bwd_kernel == "tiled" and plan.bwd_ws == 0
    # the forward and the per-thread sampler fit this plan as they are; the
    # sampler runs its tiled kernel here
    assert plan.fwd_config[False] == (256, False)
    splan = ps.SamplerPlan(plan.flow)
    assert ps.sampler_config(splan) == (256, False)
    assert (splan.kernel, splan.config) == ("tiled", (128, True))


@pytest.mark.parametrize("args,kw,config", [
    ((2, 2, 4, (3, 3, 3)), {}, (512, True)),
    ((10, 8, 8, (16, 16)), {"final_rank": 4}, (256, False)),
    ((2, 2, 4, (128, 128)), {}, (128, False)),
])
def test_accumulator_takes_no_shared_memory(args, kw, config):
    """Camel, the 10-D flagship (the per-thread backward on its local
    arrays) and create_model(2, 4, [128, 128]) (on its workspace): a
    block's shared memory holds the weights (where the launch puts them
    there) and the tiles, and no accumulator; each launch keeps at least as
    many threads resident as it did with the accumulator in shared memory.
    (The tiled kernel's count is held on the zz4l plan above.)"""
    plan = pt.TrainPlan(factory.build_pwquad_flow(torch.Generator().manual_seed(0), *args,
                                                  **kw).flow)
    plan.descriptor("cpu")
    block, w_smem = plan.bwd_config
    assert (block, w_smem) == config
    assert plan.bwd_kernel == ("workspace" if plan.bwd_ws else "local")
    h_rows, g_rows = pt.train_bwd_thread_tiles(plan)
    tiles = 4 * (plan.desc_len + len(plan.flow.ops) + 1 + (h_rows + g_rows) * (block + 1)
                 + 4 * block)
    assert pt.train_bwd_thread_smem_bytes(plan, block, False) == tiles
    assert pt.train_bwd_thread_smem_bytes(plan, block, True) == tiles + 4 * plan.n_weights

    def shared_acc(b, w):
        return pt.train_bwd_thread_smem_bytes(plan, b, w) + 4 * plan.n_weights

    before = pt.best_launch(pt.BWD_BLOCKS, shared_acc)
    assert pt.blocks_per_sm(pt.train_bwd_thread_smem_bytes(plan, block, w_smem), block) * \
        block >= pt.blocks_per_sm(shared_acc(*before), before[0]) * before[0]


def test_zz_plan_stale_trainer_runs_on_the_cpu():
    """The stale trainer on the 2 -> 4 plan (the plain versions on the CPU):
    finite losses and moved weights, at a small batch."""
    NF = PWQuadManager(n_flow=10, seed=0, device="cpu")
    NF.create_model(4, 32, [32] * 2)
    before = [p.detach().clone() for p in NF._model.parameters()]

    def f(x):
        return torch.exp(-((x - 0.3) ** 2).sum(1) / 0.5)

    NF._train_variance_forward_seq(f, lambda p: torch.optim.Adamax(p, 5e-4), log=False,
                                   batch_size=512, epochs=2, mini_batch_size=256,
                                   preburn_time=0, pretty_progressbar=False, bn_stats="stale",
                                   select_best_by="ess")
    assert all(torch.isfinite(torch.tensor(NF.history)))
    assert any(not torch.equal(a, b) for a, b in zip(before, NF._model.parameters()))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the training backward is CUDA-only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _backward_inputs(model, n, device):
    gen = torch.Generator(device=device).manual_seed(7)
    plan, flat = pt.TrainPlan(model.flow), pt.fold_flow(model).detach()
    w = torch.rand((n, model.flow.n_flow), generator=gen, device=device)
    xbar = 0.3 * torch.randn((n, model.flow.n_flow), generator=gen, device=device)
    jbar = torch.randn(n, generator=gen, device=device)
    _, jac, stage = pt.train_forward(plan, flat, w)
    return plan, flat, w, stage, jac, jbar, xbar


@pytest.mark.cuda
def test_zz_plan_backward_matches_autograd(cuda):
    """The 2 -> 4 plan's backward, its accumulator in device memory, against
    autograd of the plain forward in float64 (samples within 1e-5 of a kink
    of the map masked, as chip_smoke.py does)."""
    NF = PWQuadManager(n_flow=10, seed=0, device=cuda)
    NF.create_model(4, 32, [32] * 2)
    plan, flat, w, stage, jac, jbar, xbar = _backward_inputs(NF._model, 4099, cuda)
    keep = (pt.kink_distance(plan.flow, flat.double(), w.double()) > 1e-5).float()
    xbar, jbar = xbar * keep[:, None], jbar * keep
    dflat, wbar = pt.train_backward(plan, flat, stage, jac, jbar, xbar)
    ref = pt.folded_backward_ref(plan.flow, flat.double(), w.double(), xbar.double(),
                                 jbar.double())
    for a, b in zip((dflat, wbar), ref):
        bound = 2e-4 * max(float(b.abs().max()), 1e-3) + 2e-3 * b.abs()
        assert float(((a.double() - b).abs() / bound).max()) <= 1.0
