"""The CUDA kernels' wrappers, plan encoding, Philox stream and kernels: the
fused sampler, and the training forward and backward.

Imports neither JAX nor nf_tpu, so that the tests marked ``cuda`` also run on
a machine with a GPU and no JAX (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel.py

Without a card the ``cuda`` tests skip; the rest run anywhere.
"""

import dataclasses

import numpy as np
import pytest
import torch

from nf_tpu_torch.flows import factory
from nf_tpu_torch.flows.fast_eval import make_folded_forward
from nf_tpu_torch.ops import pwquad_sampler as ps
from nf_tpu_torch.ops import pwquad_train as pt

torch.set_num_threads(1)

FLOWS = {
    "pwquad_camel": lambda g, d: factory.build_pwquad_flow(g, 2, 2, 4, (3, 3, 3), device=d),
    "pwquad_masked_rank": lambda g, d: factory.build_pwquad_flow(
        g, 10, 8, 8, (16, 16), device=d, final_rank=4),
    "pwquad_squareplus_nohidden": lambda g, d: factory.build_pwquad_flow(
        g, 3, 3, 5, (), device=d, activation="squareplus"),
    "pwlin": lambda g, d: factory.build_pwlin_flow(g, 3, 1, 3, 8, (8, 8), 1, device=d),
    "affine": lambda g, d: factory.build_affine_flow(g, 3, 1, 2, (6,), 1, device=d),
}


def _model(name, device="cpu"):
    """A flow of ``name`` with BatchNorm statistics and scales moved off
    their init values, so the fold is not trivial."""
    gen = torch.Generator(device=device).manual_seed(len(name))
    model = FLOWS[name](gen, device)
    with torch.no_grad():
        for key, t in list(model.named_buffers()) + list(model.named_parameters()):
            if key.endswith("mean"):
                t.copy_(0.3 * torch.randn(t.shape, generator=gen, device=device))
            elif key.endswith("var"):
                t.copy_(0.5 + 1.5 * torch.rand(t.shape, generator=gen, device=device))
            elif key.endswith("scale"):
                t.copy_(1.0 + 0.3 * torch.randn(t.shape, generator=gen, device=device))
    return model


def _latents(n, n_flow, device="cpu", seed=11):
    return torch.from_numpy(
        np.random.RandomState(seed).uniform(size=(n, n_flow)).astype(np.float32)).to(device)


def test_cpu_wrapper_takes_plain_version():
    """On a CPU model both variants run the plain version: the latents
    variant on its input, the seeded one on philox_uniform's stream; the
    dim-major layout is the transpose.  No kernel is launched."""
    model = _model("pwquad_masked_rank")
    flow = model.flow
    plain = make_folded_forward(flow, model)
    launches = ps.LAUNCHES
    w = _latents(200, flow.n_flow)
    x, jac = ps.build_sampler(flow, model, take_latents=True)(w)
    x_p, jac_p = plain(w)
    assert torch.equal(x, x_p) and torch.equal(jac, jac_p)

    x_dm, jac_dm = ps.build_sampler(flow, model, layout="dim_major")(7, 200, offset=50)
    x_s, jac_s = plain(torch.from_numpy(ps.philox_uniform(7, 50, 200, flow.n_flow)))
    assert x_dm.shape == (flow.n_flow, 200)
    assert torch.equal(x_dm.T, x_s) and torch.equal(jac_dm, jac_s)
    assert ps.LAUNCHES == launches


def test_wrapper_rejects_bad_input():
    model = _model("pwquad_camel")
    sample = ps.build_sampler(model.flow, model, take_latents=True)
    with pytest.raises(TypeError):
        sample(torch.rand(10, 2, dtype=torch.float64))
    with pytest.raises(ValueError):
        sample(torch.rand(10, 3))
    with pytest.raises(ValueError):
        sample(torch.rand(2, 10).T)
    with pytest.raises(ValueError):
        ps.build_sampler(model.flow, model, layout="lane_major")
    with pytest.raises(ValueError):
        ps.build_sampler(model.flow, model)(1, -5)


@pytest.mark.parametrize("n_flow,n_bins,nn", [
    (2, ps.MAX_BINS + 1, (3,)),
    (2, 4, (ps.MAX_HIDDEN + 1,)),
    (ps.MAX_FLOW + 1, 2, (2,)),
])
def test_encode_plan_refuses_plans_over_the_caps(n_flow, n_bins, nn):
    model = factory.build_pwquad_flow(torch.Generator().manual_seed(0), n_flow, 2, n_bins, nn)
    with pytest.raises(ValueError):
        ps.encode_plan(model.flow, ps.fold_eval_params(model.flow, model))


def test_encode_plan_layout():
    """The descriptor the kernel walks, spelled out for the camel plan."""
    model = _model("pwquad_camel")
    flow = model.flow
    folded = ps.fold_eval_params(flow, model)
    desc, weights = ps.encode_plan(flow, folded)
    assert desc.dtype == np.int32 and weights.dtype == np.float32
    assert desc[:2].tolist() == [2, len(flow.ops)]
    p, off = 2, 0
    for op in flow.ops:
        if op[0] == "roll":
            assert desc[p:p + 3].tolist() == [ps.OP_PERM, *np.roll(np.arange(2), op[1])]
            p += 3
            continue
        layers = folded[op[1]]
        assert desc[p:p + 6].tolist() == [ps.OP_CELL, ps.KIND["pwquad"], 1, 4,
                                          ps.ACT["exp"], len(layers)]
        p += 6
        for wm, bv, relu in layers:
            assert desc[p:p + 5].tolist() == [*wm.shape, int(relu), off, off + wm.size]
            np.testing.assert_array_equal(weights[off:off + wm.size], wm.ravel())
            np.testing.assert_array_equal(weights[off + wm.size:off + wm.size + bv.size], bv)
            off += wm.size + bv.size
            p += 5
    assert p == desc.size and off == weights.size


def test_philox_known_answers():
    """Random123's Philox4x32-10 known-answer vectors."""
    def run(ctr, key):
        return [int(a[0]) for a in ps.philox4x32_10(
            *(np.array([c], np.uint64) for c in ctr), *key)]
    assert run([0, 0, 0, 0], [0, 0]) == [0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8]
    m = 0xFFFFFFFF
    assert run([m] * 4, [m, m]) == [0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd]
    assert run([0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344],
               [0xa4093822, 0x299f31d0]) == [0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1]


def test_philox_uniform_stream():
    u = ps.philox_uniform(3, 0, 1 << 14, 6)
    assert u.dtype == np.float32 and u.min() >= 0.0 and u.max() < 1.0
    np.testing.assert_allclose(u.mean(0), 0.5, atol=0.01)
    # offsets address one counter stream; other seeds give other streams
    np.testing.assert_array_equal(ps.philox_uniform(3, 100, 50, 6), u[100:150])
    assert not np.array_equal(ps.philox_uniform(4, 0, 50, 6), u[:50])


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sampler kernel is CUDA-only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FLOWS))
def test_kernel_matches_plain_version(cuda, name):
    model = _model(name, cuda)
    flow = model.flow
    plain = make_folded_forward(flow, model)
    w = _latents(4099, flow.n_flow, cuda)          # a ragged last block
    launches = ps.LAUNCHES
    x_k, jac_k = ps.build_sampler(flow, model, take_latents=True)(w)
    x_p, jac_p = plain(w)
    # compiled f32 maths against torch's: nf_tpu's compiled-kernel gate
    torch.testing.assert_close(x_k, x_p, rtol=1e-4, atol=2e-5)
    torch.testing.assert_close(jac_k, jac_p, rtol=1e-3, atol=0)

    x_s, jac_s = ps.build_sampler(flow, model, layout="dim_major")(5, 4099, offset=1 << 33)
    w_s = torch.from_numpy(ps.philox_uniform(5, 1 << 33, 4099, flow.n_flow)).to(cuda)
    x_sp, jac_sp = plain(w_s)
    torch.testing.assert_close(x_s.T, x_sp, rtol=1e-4, atol=2e-5)
    torch.testing.assert_close(jac_s, jac_sp, rtol=1e-3, atol=0)
    torch.cuda.synchronize()
    assert ps.LAUNCHES == launches + 2


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pwquad_camel", "pwquad_masked_rank"])
def test_kernel_grid_stride_passes_match_plain_version(cuda, name):
    """Above the grid's 2^20 threads each thread loops: n = 2^21 + 333 gives
    every thread two or three passes, the last one ragged.  Both layouts,
    both variants, a counter offset as integrate's later iterations use."""
    model = _model(name, cuda)
    flow = model.flow
    plain = make_folded_forward(flow, model)
    n, offset = (1 << 21) + 333, 7 << 21
    w = torch.from_numpy(ps.philox_uniform(3, offset, n, flow.n_flow)).to(cuda)
    x_p, jac_p = plain(w)
    x_s, jac_s = ps.build_sampler(flow, model, layout="dim_major")(3, n, offset=offset)
    torch.testing.assert_close(x_s.T, x_p, rtol=1e-4, atol=2e-5)
    torch.testing.assert_close(jac_s, jac_p, rtol=1e-3, atol=0)
    x_l, jac_l = ps.build_sampler(flow, model, take_latents=True)(w)
    torch.testing.assert_close(x_l, x_p, rtol=1e-4, atol=2e-5)
    torch.testing.assert_close(jac_l, jac_p, rtol=1e-3, atol=0)


@pytest.mark.cuda
def test_kernel_layouts_and_empty_launch(cuda):
    model = _model("pwquad_camel", cuda)
    w = _latents(1000, 2, cuda)
    x_bm, jac_bm = ps.build_sampler(model.flow, model, take_latents=True)(w)
    x_dm, jac_dm = ps.build_sampler(model.flow, model, take_latents=True,
                                    layout="dim_major")(w)
    assert torch.equal(x_dm.T, x_bm) and torch.equal(jac_dm, jac_bm)
    x0, jac0 = ps.build_sampler(model.flow, model)(1, 0)
    assert x0.shape == (0, 2) and jac0.shape == (0,)


@pytest.mark.cuda
def test_kernel_rejects_cpu_latents(cuda):
    model = _model("pwquad_camel", cuda)
    with pytest.raises(ValueError):
        ps.build_sampler(model.flow, model, take_latents=True)(torch.rand(10, 2))


# ---------------------------------------------------------------------------
# The training kernels' wrappers (ops/pwquad_train.py)
# ---------------------------------------------------------------------------

def _cotangents(n, n_flow, device="cpu", seed=5):
    rng = np.random.RandomState(seed)
    xbar = torch.from_numpy((0.3 * rng.standard_normal((n, n_flow))).astype(np.float32))
    jbar = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    return xbar.to(device), jbar.to(device)


@pytest.mark.parametrize("name", sorted(FLOWS))
def test_fold_flow_is_laid_out_as_encode_plan(name):
    """The differentiable fold (model dtype, then float32) fills the flat
    buffer exactly where the host fold (float64) puts each weight."""
    model = _model(name)
    _, weights = ps.encode_plan(model.flow, ps.fold_eval_params(model.flow, model))
    flat = pt.fold_flow(model)
    assert flat.shape == (pt.TrainPlan(model.flow).n_weights,) == weights.shape
    np.testing.assert_allclose(flat.detach().numpy(), weights, rtol=1e-5, atol=1e-6)


def test_train_cpu_wrappers_take_plain_versions():
    """CPU tensors: train_forward is forward_stats_ref, train_backward and
    FusedTrain's gradient are folded_backward_ref; no kernel is launched."""
    model = _model("pwquad_masked_rank")
    flow = model.flow
    plan = pt.TrainPlan(flow)
    flat = pt.fold_flow(model).detach()
    w = _latents(300, flow.n_flow)
    xbar, jbar = _cotangents(300, flow.n_flow)
    launches = (pt.FWD_LAUNCHES, pt.BWD_LAUNCHES)
    x, jac, stage, stats = pt.train_forward(plan, flat, w, with_stats=True)
    x_p, jac_p, stage_p, stats_p = pt.forward_stats_ref(flow, flat, w)
    assert torch.equal(x, x_p) and torch.equal(jac, jac_p) and torch.equal(stats, stats_p)
    assert stage.shape == (len(flow.cells), flow.n_flow, 300) and stats.shape == (plan.n_stat_rows,)
    x_f, jac_f = pt.folded_forward_ref(flow, flat, w)
    assert torch.equal(x, x_f) and torch.equal(jac, jac_f)
    # cell 0 follows a gather: its staged input is the permuted latents
    src = torch.as_tensor(ps.permutation_source(flow.ops[0], flow.n_flow))
    assert torch.equal(stage[0], w[:, src].T)

    dflat, wbar = pt.train_backward(plan, flat, stage, jac, jbar, xbar, latents=w)
    dflat_p, wbar_p = pt.folded_backward_ref(flow, flat, w, xbar, jbar)
    assert torch.equal(dflat, dflat_p) and torch.equal(wbar, wbar_p)
    flat_g, w_g = flat.clone().requires_grad_(True), w.clone().requires_grad_(True)
    x_t, jac_t = pt.fused_train(plan, flat_g, w_g)
    torch.autograd.backward((x_t, jac_t), (xbar, jbar))
    assert torch.equal(flat_g.grad, dflat_p) and torch.equal(w_g.grad, wbar_p)
    assert (pt.FWD_LAUNCHES, pt.BWD_LAUNCHES) == launches


def test_train_wrappers_reject_bad_input():
    model = _model("pwquad_camel")
    plan = pt.TrainPlan(model.flow)
    flat = pt.fold_flow(model).detach()
    w = _latents(10, 2)
    with pytest.raises(TypeError):
        pt.train_forward(plan, flat, w.double())
    with pytest.raises(TypeError):
        pt.train_forward(plan, flat.double(), w)
    with pytest.raises(ValueError):
        pt.train_forward(plan, flat[:-1], w)
    with pytest.raises(ValueError):
        pt.train_forward(plan, flat, _latents(10, 3))
    with pytest.raises(ValueError):
        pt.train_forward(plan, flat, torch.rand(2, 10).T)
    x, jac, stage = pt.train_forward(plan, flat, w)
    xbar, jbar = _cotangents(10, 2)
    with pytest.raises(ValueError):
        pt.train_backward(plan, flat, stage, jac, jbar, xbar)      # the plain one needs w
    with pytest.raises(ValueError):
        pt.train_backward(plan, flat, stage, jac, jbar[:5], xbar, latents=w)
    # the kernels walk the cells in index order
    shuffled = dataclasses.replace(model.flow, ops=tuple(reversed(model.flow.ops)))
    with pytest.raises(ValueError):
        pt.TrainPlan(shuffled)


def test_kink_distance_finds_bin_edges_and_relu_kinks():
    """The first pwlin cell transforms latents 1-2 directly, with bin edges
    at k/8: a latent on an edge is at distance 0, one 1e-4 off it at most
    1e-4.  Pre-ReLU activations only add kinks; affine cells have no bins."""
    model = _model("pwlin")
    flat = pt.fold_flow(model).detach().double()
    w = torch.tensor([[0.3, 0.5, 0.7], [0.3, 0.5 + 1e-4, 0.7]], dtype=torch.float64)
    w = torch.cat([w, torch.from_numpy(np.random.RandomState(2).uniform(size=(500, 3)))])
    edges = pt.kink_distance(model.flow, flat, w, relu=False)
    assert float(edges[0]) == 0.0 and float(edges[1]) <= 1e-4 + 1e-12
    assert bool((edges[2:] > 0).all())
    kinks = pt.kink_distance(model.flow, flat, w)
    assert bool((kinks <= edges).all()) and bool((kinks < edges).any())
    affine = _model("affine")
    flat_a = pt.fold_flow(affine).detach().double()
    assert bool(torch.isinf(pt.kink_distance(affine.flow, flat_a, w, relu=False)).all())
    assert bool(torch.isfinite(pt.kink_distance(affine.flow, flat_a, w)).all())


def test_stats_to_bn_state_moves_the_input_batchnorm_as_train_mode_does():
    """The first cell's input BatchNorm sees the latents themselves, so the
    refresh moves it exactly as a train-mode forward does; every other
    buffer moves too."""
    model = _model("pwquad_camel")
    model.double()
    w = torch.from_numpy(np.random.RandomState(3).uniform(size=(500, 2)))
    before = {k: v.clone() for k, v in model.named_buffers()}
    plan = pt.TrainPlan(model.flow)
    stats = pt.train_forward(plan, pt.fold_flow(model).detach(), w.float(), with_stats=True)[3]
    pt.stats_to_bn_state(model, stats, 500)
    refreshed = {k: v.clone() for k, v in model.named_buffers()}
    assert all(not torch.equal(before[k], v) for k, v in refreshed.items())
    with torch.no_grad():
        for k, v in model.named_buffers():
            v.copy_(before[k])
        model.cells[0].bn_in(w.float().double()[:, :1], True)   # pass-through dim 0
    torch.testing.assert_close(refreshed["cells.0.bn_in.mean"], model.cells[0].bn_in.mean,
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(refreshed["cells.0.bn_in.var"], model.cells[0].bn_in.var,
                               rtol=1e-6, atol=0)
    with pytest.raises(ValueError):
        pt.stats_to_bn_state(model, stats[:-2], 500)


# ---------------------------------------------------------------------------
# On the card: the training kernels against their plain versions
# ---------------------------------------------------------------------------

def _backward_ref64(flow, flat, w, xbar, jbar, chunk=1 << 17):
    """folded_backward_ref in float64, in chunks of samples (the graph of
    2^21 flagship samples would not fit the card)."""
    dflat, wbar = 0.0, []
    for s in range(0, w.shape[0], chunk):
        d, wb = pt.folded_backward_ref(flow, flat.double(), w[s:s + chunk].double(),
                                       xbar[s:s + chunk].double(), jbar[s:s + chunk].double())
        dflat, wbar = dflat + d, wbar + [wb]
    return dflat, torch.cat(wbar)


# A sample within this distance of a kink of the map (a bin edge, pwquad's
# clamp, a ReLU at 0) may sit on its other side in float32 than in float64,
# the kernel's and the plain version's alike, and then takes another
# per-sample gradient; ~7x the forward's worst |dx| on the flagship.
KINK = 1e-5


def _hold_train(plan, flat, w, xbar, jbar):
    """Forward, stats and backward kernels against their plain versions on
    the same inputs, the whole batch in one launch."""
    x_k, jac_k, stage_k, stats_k = pt.train_forward(plan, flat, w, with_stats=True)
    x_p, jac_p, stage_p, stats_p = pt.forward_stats_ref(plan.flow, flat, w)
    # compiled f32 maths against torch's: the sampler's gate
    torch.testing.assert_close(x_k, x_p, rtol=1e-4, atol=2e-5)
    torch.testing.assert_close(jac_k, jac_p, rtol=1e-3, atol=0)
    torch.testing.assert_close(stage_k, stage_p, rtol=1e-4, atol=2e-5)
    # float64 sums of float32 values that differ by the forward's rounding
    torch.testing.assert_close(stats_k, stats_p, rtol=1e-5, atol=1e-5 * w.shape[0])
    # the samples at a kink take no part in the backward's check
    keep = (pt.kink_distance(plan.flow, flat.double(), w.double()) > KINK).to(torch.float32)
    xbar, jbar = xbar * keep[:, None], jbar * keep
    dflat_k, wbar_k = pt.train_backward(plan, flat, stage_k, jac_k, jbar, xbar)
    # the plain backward in float64 on the same inputs: in float32, torch's
    # autograd of the plain version loses up to 5e-2 relative on squareplus
    # cells, where the hand VJP keeps 1e-6; nf_tpu's hand-VJP-vs-autodiff
    # gate (tests/test_train_kernel.py:137-143)
    dflat_r, wbar_r = _backward_ref64(plan.flow, flat, w, xbar, jbar)
    for a, b in zip(pt.unpack_flat(plan.flow, dflat_k), pt.unpack_flat(plan.flow, dflat_r)):
        scale = max(float(b.abs().max()), 1e-3)
        torch.testing.assert_close(a.double(), b, atol=2e-4 * scale, rtol=2e-3)
    scale = max(float(wbar_r.abs().max()), 1e-3)
    torch.testing.assert_close(wbar_k.double(), wbar_r, atol=2e-4 * scale, rtol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16384, 333])
@pytest.mark.parametrize("name", sorted(FLOWS))
def test_train_kernels_match_plain_versions(cuda, name, n):
    model = _model(name, cuda)
    plan = pt.TrainPlan(model.flow)
    flat = pt.fold_flow(model).detach()
    w = _latents(n, model.flow.n_flow, cuda)
    xbar, jbar = _cotangents(n, model.flow.n_flow, cuda)
    launches = (pt.FWD_LAUNCHES, pt.BWD_LAUNCHES)
    _hold_train(plan, flat, w, xbar, jbar)
    torch.cuda.synchronize()
    assert (pt.FWD_LAUNCHES, pt.BWD_LAUNCHES) == (launches[0] + 1, launches[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pwquad_camel", "pwquad_masked_rank"])
def test_train_kernels_grid_stride_and_determinism(cuda, name):
    """n = 2^21 + 333 gives every thread of the bounded grid several passes,
    the last one ragged; the whole batch is held against the plain version.
    A sample's results do not depend on the launch, so one launch over n
    equals launches over chunks of 2^14 (one pass each): per-sample outputs
    bit for bit, the sums up to float32 rounding of the per-warp running
    sums.  Two launches on the same inputs give bit-identical results."""
    model = _model(name, cuda)
    plan = pt.TrainPlan(model.flow)
    flat = pt.fold_flow(model).detach()
    n, chunk = (1 << 21) + 333, 1 << 14
    w = _latents(n, model.flow.n_flow, cuda)
    xbar, jbar = _cotangents(n, model.flow.n_flow, cuda)
    x, jac, stage, stats = pt.train_forward(plan, flat, w, with_stats=True)
    dflat, wbar = pt.train_backward(plan, flat, stage, jac, jbar, xbar)
    parts = [pt.train_forward(plan, flat, w[s:s + chunk], with_stats=True)
             for s in range(0, n, chunk)]
    assert torch.equal(x, torch.cat([c[0] for c in parts]))
    assert torch.equal(jac, torch.cat([c[1] for c in parts]))
    assert torch.equal(stage, torch.cat([c[2] for c in parts], 2))
    torch.testing.assert_close(stats, sum(c[3] for c in parts), rtol=1e-12, atol=0)
    backs = [pt.train_backward(plan, flat, c[2], c[1], jbar[s:s + chunk], xbar[s:s + chunk])
             for s, c in zip(range(0, n, chunk), parts)]
    assert torch.equal(wbar, torch.cat([b[1] for b in backs]))
    total = sum(b[0].double() for b in backs)
    bound = 1e-5 * sum(b[0].double().abs() for b in backs)
    assert bool(((dflat.double() - total).abs() <= bound).all())
    _hold_train(plan, flat, w, xbar, jbar)
    assert torch.equal(pt.train_backward(plan, flat, stage, jac, jbar, xbar)[0], dflat)
    assert torch.equal(pt.train_forward(plan, flat, w, with_stats=True)[3], stats)


@pytest.mark.cuda
def test_fused_train_launches_both_kernels(cuda):
    model = _model("pwquad_camel", cuda)
    plan = pt.TrainPlan(model.flow)
    w = _latents(1000, 2, cuda)
    launches = (pt.FWD_LAUNCHES, pt.BWD_LAUNCHES)
    x, jac = pt.fused_train(plan, pt.fold_flow(model), w)
    torch.var(jac).backward()
    assert (pt.FWD_LAUNCHES, pt.BWD_LAUNCHES) == (launches[0] + 1, launches[1] + 1)
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in model.parameters())
    with pytest.raises(ValueError):
        pt.train_forward(plan, pt.fold_flow(model).detach(), w.cpu())
