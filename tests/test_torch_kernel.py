"""The CUDA kernels' wrappers, plan encoding, Philox stream and kernels: the
fused sampler, and the training forward and backward.

Imports neither JAX nor nf_tpu, so that the tests marked ``cuda`` also run on
a machine with a GPU and no JAX (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel.py

Without a card the ``cuda`` tests skip; the rest run anywhere.
"""

import ctypes
import dataclasses
import math

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
    # hidden layers at the tiled backward's widest last-layer input and a
    # factored final layer
    "pwquad_max_hidden_rank": lambda g, d: factory.build_pwquad_flow(
        g, 2, 2, 4, (pt.BWD_TILED_MAX_FIN, pt.BWD_TILED_MAX_FIN), device=d, final_rank=3),
    "pwlin": lambda g, d: factory.build_pwlin_flow(g, 3, 1, 3, 8, (8, 8), 1, device=d),
    "affine": lambda g, d: factory.build_affine_flow(g, 3, 1, 2, (6,), 1, device=d),
    # beyond the kernels' old caps (32 bins, a hidden width of 64, 32
    # latent dims, 256 layer inputs a cell): create_model(2, 4, [128, 128])
    # among them
    "pwquad_bins40_hidden96": lambda g, d: factory.build_pwquad_flow(
        g, 2, 2, 40, (96, 96), device=d),
    "pwquad_flow36_narrow": lambda g, d: factory.build_pwquad_flow(
        g, 36, 2, 2, (4,), device=d),
    "pwquad_wide128": lambda g, d: factory.build_pwquad_flow(g, 2, 2, 4, (128, 128), device=d),
}
OVER_CAPS = ["pwquad_bins40_hidden96", "pwquad_flow36_narrow", "pwquad_wide128"]
# the plans whose last layer takes more inputs than the tiled backward's
# register tiles hold: they run the workspace backward
WORKSPACE = ["pwquad_bins40_hidden96", "pwquad_wide128"]
# Plans for the tiled sampler, beside the wide plans above: the zz4l
# configuration's 2 -> 4 plan (n_flow 10, 32 bins, hidden [32, 32]), the
# ZZ/Z' plan of examples/zz_multichannel.py (n_flow 11, 16 bins, [32, 32],
# rank 4) and wide pwlin and affine plans.
TILED_FLOWS = {
    "pwquad_zz4l": lambda g, d: factory.build_pwquad_flow(g, 10, 4, 32, (32, 32), device=d),
    "pwquad_zz_zprime": lambda g, d: factory.build_pwquad_flow(g, 11, 4, 16, (32, 32), device=d,
                                                               final_rank=4),
    "pwlin_wide": lambda g, d: factory.build_pwlin_flow(g, 3, 1, 3, 8, (32, 32), 1, device=d),
    "affine_wide": lambda g, d: factory.build_affine_flow(g, 3, 1, 2, (32, 32), 1, device=d),
}
# every plan the tiled sampler runs here
TILED = sorted(TILED_FLOWS) + ["pwquad_bins40_hidden96", "pwquad_max_hidden_rank",
                               "pwquad_wide128"]


def _model(name, device="cpu"):
    """A flow of ``name`` with BatchNorm statistics and scales moved off
    their init values, so the fold is not trivial."""
    gen = torch.Generator(device=device).manual_seed(len(name))
    model = {**FLOWS, **TILED_FLOWS}[name](gen, device)
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
    (2, 33, (3,)),           # bins beyond the old cap of 32
    (2, 4, (65,)),           # a hidden width beyond the old cap of 64
    (33, 2, (2,)),           # latent dims beyond the old cap of 32
    (2, 4, (128, 128)),      # create_model(2, 4, [128, 128]): 257 layer inputs a cell
])
def test_plans_over_the_old_caps_get_a_launch(n_flow, n_bins, nn):
    """Plans nf_tpu's kernels take, which the port's kernels once refused,
    are encoded and given a launch by the sampler (its tiled kernel where a
    layer is 32 wide or more) and by both training kernels; the backward
    runs the tiled kernel, or the per-thread kernel on its workspace where a
    last layer takes more inputs than the tiled kernel's register tiles
    hold."""
    model = factory.build_pwquad_flow(torch.Generator().manual_seed(0), n_flow, 2, n_bins, nn)
    desc, weights = ps.encode_plan(model.flow, ps.fold_eval_params(model.flow, model))
    plan = ps.SamplerPlan(model.flow)
    assert np.array_equal(plan.desc, desc) and plan.n_weights == weights.size
    block, w_smem = plan.config
    count = ps.sampler_tiled_smem_bytes if plan.kernel == "tiled" else ps.sampler_smem_bytes
    assert plan.kernel == ("tiled" if max(nn) >= ps.SAMPLER_TILED_MIN_WIDTH else "thread")
    assert count(plan, block, w_smem) <= ps.SMEM_LIMIT
    tplan = pt.TrainPlan(model.flow)
    assert torch.equal(tplan.descriptor("cpu"), torch.as_tensor(desc))
    for stats, (block, w_smem) in tplan.fwd_config.items():
        assert pt.train_fwd_smem_bytes(tplan, block, w_smem, stats) <= ps.SMEM_LIMIT
    wide = max(m[-1][0] for m in tplan.meta) > pt.BWD_TILED_MAX_FIN
    count = pt.train_bwd_smem_bytes if tplan.bwd_kernel == "tiled" else \
        pt.train_bwd_thread_smem_bytes
    assert tplan.bwd_kernel == ("workspace" if wide else "tiled")
    assert count(tplan, *tplan.bwd_config) <= ps.SMEM_LIMIT
    assert tplan.bwd_ws == (pt.bwd_workspace_floats(tplan) if wide else 0)


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


def _sampler_config(plan, w_smem):
    """The sampler's launch for ``plan`` with the weights in shared memory or
    through L1: the largest block that fits, or None."""
    blocks = [b for b in ps.SAMPLER_BLOCKS + ps.SMALL_BLOCKS
              if ps.sampler_smem_bytes(plan, b, w_smem) <= ps.SMEM_LIMIT]
    return (max(blocks), w_smem) if blocks else None


@pytest.mark.cuda
@pytest.mark.parametrize("w_smem", [True, False])
@pytest.mark.parametrize("name", ["pwquad_camel", "pwquad_masked_rank"] + OVER_CAPS)
def test_sampler_at_scale_both_layouts_and_placements(cuda, name, w_smem):
    """The per-thread kernel at n = 2^21 + 333 with a counter offset: each
    thread of the grid takes two or three tiles, the last one ragged.  Both
    variants in both layouts against the plain version, with the weights in
    shared memory and through L1; two launches bit-identical."""
    model = _model(name, cuda)
    flow = model.flow
    config = _sampler_config(ps.SamplerPlan(flow), w_smem)
    if config is None:
        pytest.skip(f"{name}: no launch keeps the weights in shared memory")
    plain = make_folded_forward(flow, model)
    n, offset = (1 << 21) + 333, 7 << 21
    w = torch.from_numpy(ps.philox_uniform(3, offset, n, flow.n_flow)).to(cuda)
    x_p, jac_p = plain(w)
    for layout in ("batch_major", "dim_major"):
        seeded = ps.build_sampler(flow, model, layout=layout, config=config, kernel="thread")
        latents = ps.build_sampler(flow, model, take_latents=True, layout=layout, config=config,
                                   kernel="thread")
        for run in (lambda: seeded(3, n, offset=offset), lambda: latents(w)):
            x, jac = run()
            again = run()
            assert torch.equal(again[0], x) and torch.equal(again[1], jac)
            x = x.T if layout == "dim_major" else x
            torch.testing.assert_close(x, x_p, rtol=1e-4, atol=2e-5)
            torch.testing.assert_close(jac, jac_p, rtol=1e-3, atol=0)


@pytest.mark.cuda
def test_sampler_refuses_a_wrong_smem_count(cuda, monkeypatch):
    """The C entry point refuses a launch whose shared-memory count differs
    from its own; the wrapper raises, and nothing falls back."""
    model = _model("pwquad_camel", cuda)
    count = ps.sampler_smem_bytes
    monkeypatch.setattr(ps, "sampler_smem_bytes", lambda *a: count(*a) + 4)
    launches = ps.LAUNCHES
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        ps.build_sampler(model.flow, model)(1, 100)
    assert ps.LAUNCHES == launches


def _tiled_configs(plan):
    """Every launch of the tiled sampler that fits ``plan``."""
    return [(b, w) for b in ps.SAMPLER_TILED_BLOCKS for w in (True, False)
            if ps.sampler_tiled_smem_bytes(plan, b, w) <= ps.SMEM_LIMIT]


def _both_kernels(flow, model, layout, w, n, seed, offset, config=None):
    """The tiled and the per-thread kernels' outputs, both variants:
    ``{kernel: (x_seeded, jac_seeded, x_latents, jac_latents)}``."""
    out = {}
    for kernel, cfg in (("tiled", config), ("thread", None)):
        seeded = ps.build_sampler(flow, model, layout=layout, config=cfg, kernel=kernel)
        latents = ps.build_sampler(flow, model, take_latents=True, layout=layout, config=cfg,
                                   kernel=kernel)
        out[kernel] = (*seeded(seed, n, offset=offset), *latents(w))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 129, 4099])
@pytest.mark.parametrize("name", TILED)
def test_tiled_sampler_equals_the_per_thread_kernel(cuda, name, n):
    """On the plans the tiled kernel runs, its x and jac equal the
    per-thread kernel's bit for bit: the Philox variant and the latents
    operand, dim-major and batch-major, at every tiled launch that fits
    (blocks of 128 and 64, the copies in shared memory or the weights
    through L1), n at and around a block's edge."""
    model = _model(name, cuda)
    flow = model.flow
    plan = ps.SamplerPlan(flow)
    assert plan.kernel == "tiled"
    w = _latents(n, flow.n_flow, cuda)
    for config in _tiled_configs(plan):
        for layout in ("batch_major", "dim_major"):
            out = _both_kernels(flow, model, layout, w, n, 5, 1 << 33, config)
            for a, b in zip(out["tiled"], out["thread"]):
                assert torch.equal(a, b), (config, layout)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pwquad_zz4l", "pwquad_zz_zprime"])
def test_tiled_sampler_grid_stride_passes(cuda, name):
    """n = 2^21 + 333 with a counter offset: each block of the grid takes
    two or three tiles, the last one ragged.  The tiled kernel equals the
    per-thread one bit for bit in both variants and layouts, and holds the
    gate against the plain version; two launches bit-identical."""
    model = _model(name, cuda)
    flow = model.flow
    plain = make_folded_forward(flow, model)
    n, offset = (1 << 21) + 333, 7 << 21
    w = torch.from_numpy(ps.philox_uniform(3, offset, n, flow.n_flow)).to(cuda)
    x_p, jac_p = plain(w)
    for layout in ("batch_major", "dim_major"):
        out = _both_kernels(flow, model, layout, w, n, 3, offset)
        for a, b in zip(out["tiled"], out["thread"]):
            assert torch.equal(a, b), layout
        again = _both_kernels(flow, model, layout, w, n, 3, offset)["tiled"]
        assert all(torch.equal(a, b) for a, b in zip(again, out["tiled"]))
        for x, jac in (out["tiled"][:2], out["tiled"][2:]):
            x = x.T if layout == "dim_major" else x
            torch.testing.assert_close(x, x_p, rtol=1e-4, atol=2e-5)
            torch.testing.assert_close(jac, jac_p, rtol=1e-3, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TILED_FLOWS))
def test_tiled_sampler_matches_plain_version(cuda, name):
    """The tiled kernel against the plain version at the gate the
    per-thread kernel holds (test_kernel_matches_plain_version)."""
    model = _model(name, cuda)
    flow = model.flow
    plain = make_folded_forward(flow, model)
    w = _latents(4099, flow.n_flow, cuda)
    x_k, jac_k = ps.build_sampler(flow, model, take_latents=True)(w)
    x_p, jac_p = plain(w)
    torch.testing.assert_close(x_k, x_p, rtol=1e-4, atol=2e-5)
    torch.testing.assert_close(jac_k, jac_p, rtol=1e-3, atol=0)


@pytest.mark.cuda
def test_sampler_counts_tiled_launches(cuda):
    """Every launch counts in LAUNCHES, and the tiled kernel's also in
    SAMPLER_TILED_LAUNCHES: the zz4l and ZZ/Z' plans launch it, camel and
    the 10-D flagship (pwquad_masked_rank) the per-thread kernel; an empty
    launch counts nothing."""
    for name, tiled in (("pwquad_zz4l", 1), ("pwquad_zz_zprime", 1), ("pwquad_camel", 0),
                        ("pwquad_masked_rank", 0)):
        model = _model(name, cuda)
        w = _latents(1000, model.flow.n_flow, cuda)
        before = (ps.LAUNCHES, ps.SAMPLER_TILED_LAUNCHES)
        ps.build_sampler(model.flow, model)(1, 1000)
        ps.build_sampler(model.flow, model, take_latents=True, layout="dim_major")(w)
        ps.build_sampler(model.flow, model)(1, 0)
        assert (ps.LAUNCHES, ps.SAMPLER_TILED_LAUNCHES) == (before[0] + 2,
                                                            before[1] + 2 * tiled), name


@pytest.mark.cuda
def test_tiled_sampler_refuses_a_wrong_smem_count(cuda, monkeypatch):
    """nf_pwquad_sampler_tiled refuses a launch whose shared-memory count
    differs from its own; the wrapper raises, and nothing falls back."""
    model = _model("pwquad_zz_zprime", cuda)
    count = ps.sampler_tiled_smem_bytes
    monkeypatch.setattr(ps, "sampler_tiled_smem_bytes", lambda *a: count(*a) + 4)
    launches = (ps.LAUNCHES, ps.SAMPLER_TILED_LAUNCHES)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        ps.build_sampler(model.flow, model)(1, 100)
    assert (ps.LAUNCHES, ps.SAMPLER_TILED_LAUNCHES) == launches


@pytest.mark.cuda
def test_tiled_sampler_residency_is_the_occupancy_calculators(cuda):
    """The blocks an SM the launch rule counts for the tiled sampler (by
    shared memory, and by the registers its launch bound leaves) are the
    CUDA occupancy calculator's for the compiled kernel where shared memory
    sets them, and never more, at every block size and place of the
    weights."""
    from nf_tpu_torch.ops import _build
    lib = _build.library()
    threads = ps.SAMPLER_TILED_MIN_BLOCKS * ps.SAMPLER_TILED_BLOCK
    for name in TILED:
        plan = ps.SamplerPlan(_model(name, cuda).flow)
        for block, w_smem in _tiled_configs(plan):
            smem = ps.sampler_tiled_smem_bytes(plan, block, w_smem)
            got = ctypes.c_int(-1)
            with torch.cuda.device(cuda):
                err = lib.nf_pwquad_sampler_tiled_occupancy(int(w_smem), block, smem,
                                                            ctypes.byref(got))
            assert err == 0, _build.error_string(err)
            counted = ps.blocks_per_sm(smem, block, threads)
            assert counted <= got.value, (name, block, w_smem)
            if ps.blocks_per_sm(smem, block) <= threads // block:
                assert counted == got.value, (name, block, w_smem)


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


def _hold_forward(plan, flat, w, with_stats, config=None):
    """The forward kernel (with or without stats) against its plain version
    on the same inputs, the whole batch in one launch.  Returns the
    kernel's outputs."""
    out = pt.train_forward(plan, flat, w, with_stats=with_stats, config=config)
    x_p, jac_p, stage_p, stats_p = pt.forward_stats_ref(plan.flow, flat, w)
    # compiled f32 maths against torch's: the sampler's gate
    torch.testing.assert_close(out[0], x_p, rtol=1e-4, atol=2e-5)
    torch.testing.assert_close(out[1], jac_p, rtol=1e-3, atol=0)
    torch.testing.assert_close(out[2], stage_p, rtol=1e-4, atol=2e-5)
    if with_stats:
        # float64 sums of float32 values that differ by the forward's rounding
        torch.testing.assert_close(out[3], stats_p, rtol=1e-5, atol=1e-5 * w.shape[0])
    return out


def _hold_train(plan, flat, w, xbar, jbar, workspace=None):
    """Forward, stats and backward kernels against their plain versions on
    the same inputs, the whole batch in one launch (the backward on its
    workspace where ``workspace``)."""
    _, jac_k, stage_k, _ = _hold_forward(plan, flat, w, with_stats=True)
    # the samples at a kink take no part in the backward's check
    keep = (pt.kink_distance(plan.flow, flat.double(), w.double()) > KINK).to(torch.float32)
    xbar, jbar = xbar * keep[:, None], jbar * keep
    dflat_k, wbar_k = pt.train_backward(plan, flat, stage_k, jac_k, jbar, xbar,
                                        workspace=workspace)
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
    bit for bit, the sums up to float32 rounding of the per-block running
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
    again = pt.train_backward(plan, flat, stage, jac, jbar, xbar)
    assert torch.equal(again[0], dflat) and torch.equal(again[1], wbar)
    assert torch.equal(pt.train_forward(plan, flat, w, with_stats=True)[3], stats)


@pytest.mark.cuda
@pytest.mark.parametrize("size", ["one", "block_minus_one", "block_multiple"])
@pytest.mark.parametrize("name", ["pwquad_camel", "pwquad_masked_rank",
                                  "pwquad_max_hidden_rank"])
def test_train_backward_at_block_edges(cuda, name, size):
    """The backward's block products at the edges of a block: one sample
    (every other lane past n), one sample short of the chosen block, and
    three full blocks; against the plain version in float64, and two
    launches bit-identical."""
    model = _model(name, cuda)
    plan = pt.TrainPlan(model.flow)
    flat = pt.fold_flow(model).detach()
    block = pt.train_bwd_config(plan)[0]
    n = {"one": 1, "block_minus_one": block - 1, "block_multiple": 3 * block}[size]
    w = _latents(n, model.flow.n_flow, cuda)
    xbar, jbar = _cotangents(n, model.flow.n_flow, cuda)
    _hold_train(plan, flat, w, xbar, jbar)
    _, jac, stage = pt.train_forward(plan, flat, w)
    first = pt.train_backward(plan, flat, stage, jac, jbar, xbar)
    again = pt.train_backward(plan, flat, stage, jac, jbar, xbar)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pwquad_camel", "pwquad_masked_rank",
                                  "pwquad_max_hidden_rank"])
def test_train_backward_every_launch_config(cuda, name):
    """Every block size of the plan's backward (the per-thread kernel on
    camel and the flagship, the tiled kernel on hidden layers of 64), with
    the weights or their copies in shared memory or read through L1, gives
    each sample the same latent cotangents bit for bit, and a weight
    gradient (summed per block in another order) within nf_tpu's hand-VJP
    gate of the plain version in float64."""
    model = _model(name, cuda)
    plan = pt.TrainPlan(model.flow)
    flat = pt.fold_flow(model).detach()
    n = 5000
    w = _latents(n, model.flow.n_flow, cuda)
    xbar, jbar = _cotangents(n, model.flow.n_flow, cuda)
    keep = (pt.kink_distance(plan.flow, flat.double(), w.double()) > KINK).to(torch.float32)
    xbar, jbar = xbar * keep[:, None], jbar * keep
    _, jac, stage = pt.train_forward(plan, flat, w)
    dflat_r, _ = _backward_ref64(plan.flow, flat, w, xbar, jbar)
    wbar_ref = pt.train_backward(plan, flat, stage, jac, jbar, xbar, config=(128, True))[1]
    assert plan.bwd_kernel == ("tiled" if name == "pwquad_max_hidden_rank" else "local")
    for block in pt.BWD_TILED_BLOCKS if plan.bwd_kernel == "tiled" else pt.BWD_BLOCKS:
        for w_smem in (True, False):
            dflat, wbar = pt.train_backward(plan, flat, stage, jac, jbar, xbar,
                                            config=(block, w_smem))
            assert torch.equal(wbar, wbar_ref), (block, w_smem)
            for a, b in zip(pt.unpack_flat(plan.flow, dflat), pt.unpack_flat(plan.flow, dflat_r)):
                scale = max(float(b.abs().max()), 1e-3)
                torch.testing.assert_close(a.double(), b, atol=2e-4 * scale, rtol=2e-3)
    with pytest.raises(ValueError):
        pt.train_backward(plan, flat, stage, jac, jbar, xbar, config=(96, True))


@pytest.mark.cuda
@pytest.mark.parametrize("size", ["block_minus_one", "block", "block_plus_one", "two_blocks_333"])
@pytest.mark.parametrize("name", sorted(FLOWS))
def test_train_forward_at_block_edges(cuda, name, size):
    """The forward's tiles at the edges of a block, with and without stats,
    each at its chosen block size S: S - 1 samples (the last lane past n),
    S, S + 1 (a second tile of one sample), 2 S + 333; against the plain
    version.  Both variants give the same x, jac and stage bit for bit."""
    model = _model(name, cuda)
    plan = pt.TrainPlan(model.flow)
    flat = pt.fold_flow(model).detach()
    plan.descriptor(cuda)
    for with_stats in (False, True):
        block = plan.fwd_config[with_stats][0]
        n = {"block_minus_one": block - 1, "block": block, "block_plus_one": block + 1,
             "two_blocks_333": 2 * block + 333}[size]
        w = _latents(n, model.flow.n_flow, cuda)
        out = _hold_forward(plan, flat, w, with_stats)
        other = pt.train_forward(plan, flat, w, with_stats=not with_stats)
        assert all(torch.equal(a, b) for a, b in zip(out[:3], other[:3]))


@pytest.mark.cuda
@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("name", ["pwquad_camel", "pwquad_masked_rank", "pwlin", "affine"])
def test_train_forward_every_launch_config(cuda, name, with_stats):
    """Every block size, with the weights in shared memory or through L1,
    gives each sample the same x, jac and stage bit for bit, and statistics
    (summed per block in another order) within the plain version's gate."""
    model = _model(name, cuda)
    plan = pt.TrainPlan(model.flow)
    flat = pt.fold_flow(model).detach()
    w = _latents(5000, model.flow.n_flow, cuda)
    first = None
    for block in pt.FWD_BLOCKS:
        for w_smem in (True, False):
            out = _hold_forward(plan, flat, w, with_stats, config=(block, w_smem))
            first = first or out
            assert all(torch.equal(a, b) for a, b in zip(out[:3], first[:3])), (block, w_smem)
    with pytest.raises(ValueError):
        pt.train_forward(plan, flat, w, with_stats=with_stats, config=(96, True))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FLOWS))
def test_train_forward_launches_bit_identical(cuda, name):
    """Two launches on the same inputs give the same x, jac, stage and
    stats bit for bit: no atomics, one owner and one order per sum."""
    model = _model(name, cuda)
    plan = pt.TrainPlan(model.flow)
    flat = pt.fold_flow(model).detach()
    w = _latents(20000, model.flow.n_flow, cuda)
    first = pt.train_forward(plan, flat, w, with_stats=True)
    again = pt.train_forward(plan, flat, w, with_stats=True)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("name", OVER_CAPS)
def test_train_backward_workspace_matches_plain_version(cuda, name):
    """Beyond the local arrays the per-thread backward's arrays live in a
    device workspace (the plan's backward where a last layer takes more
    inputs than the tiled backward's register tiles; asked for on the
    36-dim flow, which the tiled backward runs by default): forward, stats
    and the workspace backward against their plain versions (the backward
    against float64, kinks masked) at two sizes, the larger several grid
    passes; repeats bit-identical."""
    model = _model(name, cuda)
    plan = pt.TrainPlan(model.flow)
    assert plan.bwd_kernel == ("workspace" if name in WORKSPACE else "tiled")
    assert pt.bwd_workspace_floats(plan) > 0
    flat = pt.fold_flow(model).detach()
    for n in (333, 40000):
        w = _latents(n, model.flow.n_flow, cuda)
        xbar, jbar = _cotangents(n, model.flow.n_flow, cuda)
        _hold_train(plan, flat, w, xbar, jbar, workspace=True)
        _, jac, stage = pt.train_forward(plan, flat, w)
        first = pt.train_backward(plan, flat, stage, jac, jbar, xbar, workspace=True)
        again = pt.train_backward(plan, flat, stage, jac, jbar, xbar, workspace=True)
        assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pwquad_camel", "pwquad_masked_rank", "pwlin", "affine"])
def test_train_backward_workspace_equals_local_arrays(cuda, name):
    """Within the local arrays' sizes the workspace kernel gives the
    local-array kernel's results bit for bit: the same arithmetic in the same order,
    only the arrays' place differs."""
    model = _model(name, cuda)
    plan = pt.TrainPlan(model.flow)
    flat = pt.fold_flow(model).detach()
    w = _latents(20000, model.flow.n_flow, cuda)
    xbar, jbar = _cotangents(20000, model.flow.n_flow, cuda)
    _, jac, stage = pt.train_forward(plan, flat, w)
    local = pt.train_backward(plan, flat, stage, jac, jbar, xbar)
    ws = pt.train_backward(plan, flat, stage, jac, jbar, xbar, workspace=True)
    assert torch.equal(local[0], ws[0]) and torch.equal(local[1], ws[1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", WORKSPACE)
def test_train_backward_refuses_local_arrays_beyond_their_sizes(cuda, name):
    """A plan beyond the local arrays' sizes and the tiled backward's
    register tiles with the workspace turned off raises before any launch;
    nothing overruns the arrays."""
    model = _model(name, cuda)
    plan = pt.TrainPlan(model.flow)
    flat = pt.fold_flow(model).detach()
    n_flow = model.flow.n_flow
    w = _latents(100, n_flow, cuda)
    xbar, jbar = _cotangents(100, n_flow, cuda)
    _, jac, stage = pt.train_forward(plan, flat, w)
    launches = pt.BWD_LAUNCHES
    with pytest.raises(ValueError, match="needs the workspace"):
        pt.train_backward(plan, flat, stage, jac, jbar, xbar, workspace=False)
    assert pt.BWD_LAUNCHES == launches


@pytest.mark.cuda
def test_wide_model_samples_integrates_and_trains_stale(cuda):
    """create_model(2, 4, [128, 128]), which the kernels once refused:
    sample, integrate and the stale trainer run on the card through the
    three kernels."""
    from nf_tpu_torch import PWQuadManager
    from nf_tpu_torch.training import optimizers

    def camel(x):
        return (torch.exp(-((x[:, 0] - 0.75) ** 2 + (x[:, 1] - 0.75) ** 2) / 0.04)
                + torch.exp(-((x[:, 0] - 0.25) ** 2 + (x[:, 1] - 0.25) ** 2) / 0.04))

    NF = PWQuadManager(n_flow=2, seed=0, device="cuda")
    NF.create_model(2, 4, [128, 128])
    ps.LAUNCHES = pt.FWD_LAUNCHES = pt.BWD_LAUNCHES = 0
    NF._train_variance_forward_seq(camel, optimizers.adamax(2e-3, 1e-4), log=False,
                                   batch_size=4000, epochs=4, mini_batch_size=2000,
                                   preburn_time=0, pretty_progressbar=False, bn_stats="stale")
    x, jac = NF.sample(5000)
    sig, err = NF.integrate(camel, 2, 20000)
    torch.cuda.synchronize()
    assert (pt.FWD_LAUNCHES, pt.BWD_LAUNCHES) == (8 + 1, 8)
    assert ps.LAUNCHES == 1 + 2
    assert x.shape == (5000, 2) and bool(torch.isfinite(jac).all())
    assert bool(((x >= 0) & (x <= 1)).all())
    assert sig > 0 and err > 0


@pytest.mark.cuda
def test_train_forward_refuses_a_wrong_smem_count(cuda, monkeypatch):
    """The C entry point refuses a launch whose shared-memory count differs
    from its own; the wrapper raises, and nothing falls back."""
    model = _model("pwquad_camel", cuda)
    plan = pt.TrainPlan(model.flow)
    flat = pt.fold_flow(model).detach()
    w = _latents(100, 2, cuda)
    count = pt.train_fwd_smem_bytes
    monkeypatch.setattr(pt, "train_fwd_smem_bytes", lambda *a: count(*a) + 4)
    launches = pt.FWD_LAUNCHES
    with pytest.raises(RuntimeError, match="forward kernel launch failed"):
        pt.train_forward(plan, flat, w)
    assert pt.FWD_LAUNCHES == launches


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


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pwquad_max_hidden_rank", "pwquad_flow36_narrow"])
def test_tiled_backward_matches_the_per_thread_kernel(cuda, name):
    """On plans the tiled kernel runs, the per-thread kernel on its
    workspace gives the same per-sample arithmetic: the latent cotangents
    and the weight gradient within nf_tpu's hand-VJP gate of each other
    (nvcc fuses a few of the VJPs' multiplies and adds differently in the
    two, and the weight gradient is summed in another order)."""
    model = _model(name, cuda)
    plan = pt.TrainPlan(model.flow)
    assert plan.bwd_kernel == "tiled"
    flat = pt.fold_flow(model).detach()
    w = _latents(20000, model.flow.n_flow, cuda)
    xbar, jbar = _cotangents(20000, model.flow.n_flow, cuda)
    _, jac, stage = pt.train_forward(plan, flat, w)
    tiled = pt.train_backward(plan, flat, stage, jac, jbar, xbar)
    ws = pt.train_backward(plan, flat, stage, jac, jbar, xbar, workspace=True)
    for a, b in list(zip(pt.unpack_flat(plan.flow, tiled[0]),
                         pt.unpack_flat(plan.flow, ws[0]))) + [(tiled[1], ws[1])]:
        torch.testing.assert_close(a, b, atol=2e-4 * max(float(b.abs().max()), 1e-3),
                                   rtol=2e-3)


@pytest.mark.cuda
def test_tiled_backward_residency_is_the_occupancy_calculators(cuda):
    """The blocks an SM the launch rule counts for the tiled backward (by
    shared memory, and by registers as its launch bound sets them) are the
    CUDA occupancy calculator's for the compiled kernel, at every block
    size and place of the weights' copies, with one, two and four register
    tiles of R."""
    from nf_tpu_torch.ops import _build
    lib = _build.library()
    plans = {"camel": FLOWS["pwquad_camel"], "zz4l": lambda g, d: _zz4l_model(d),
             "hidden40": lambda g, d: factory.build_pwquad_flow(g, 2, 2, 4, (40,), device=d)}
    seen = set()
    for name, make in plans.items():
        plan = pt.TrainPlan(make(torch.Generator(device=cuda).manual_seed(0), cuda).flow)
        rt = pt.train_bwd_microtile(plan)
        seen.add(rt)
        for block in pt.BWD_TILED_BLOCKS:
            for w_smem in (True, False):
                smem = pt.train_bwd_smem_bytes(plan, block, w_smem)
                got = ctypes.c_int(-1)
                with torch.cuda.device(cuda):
                    err = lib.nf_pwquad_train_bwd_tiled_occupancy(rt, int(w_smem), block, smem,
                                                                  ctypes.byref(got))
                assert err == 0, _build.error_string(err)
                assert got.value == pt.blocks_per_sm(smem, block, pt.bwd_tiled_sm_threads(plan)), \
                    (name, block, w_smem)
    assert seen == {1, 2, 4}


def _zz4l_model(device):
    """The 2 -> 4 plan of the zz4l configuration: n_flow 10, 32 bins,
    hidden layers [32, 32], its 8 cells, BatchNorms moved off their init."""
    from nf_tpu_torch import PWQuadManager
    NF = PWQuadManager(n_flow=10, seed=0, device=device)
    NF.create_model(4, 32, [32, 32])
    gen = torch.Generator(device=device).manual_seed(18)
    with torch.no_grad():
        for key, t in list(NF._model.named_buffers()) + list(NF._model.named_parameters()):
            if key.endswith("mean"):
                t.copy_(0.3 * torch.randn(t.shape, generator=gen, device=device))
            elif key.endswith("var"):
                t.copy_(0.5 + 1.5 * torch.rand(t.shape, generator=gen, device=device))
            elif key.endswith("scale"):
                t.copy_(1.0 + 0.3 * torch.randn(t.shape, generator=gen, device=device))
    return NF._model


@pytest.mark.cuda
def test_tiled_backward_on_the_zz4l_plan(cuda):
    """The tiled backward on the zz4l plan at 2^18 + 333 (several tiles a
    block, the last ragged) against the plain version in float64, with the
    samples within 1e-5 of a kink masked; two launches bit-identical; each
    backward is one launch, counted by BWD_TILED_LAUNCHES as by
    BWD_LAUNCHES."""
    model = _zz4l_model(cuda)
    plan = pt.TrainPlan(model.flow)
    flat = pt.fold_flow(model).detach()
    assert plan.bwd_ws == 0 and plan.bwd_kernel == "tiled"
    n = (1 << 18) + 333
    w = _latents(n, model.flow.n_flow, cuda)
    xbar, jbar = _cotangents(n, model.flow.n_flow, cuda)
    launches = (pt.BWD_LAUNCHES, pt.BWD_TILED_LAUNCHES)
    _hold_train(plan, flat, w, xbar, jbar)
    _, jac, stage = pt.train_forward(plan, flat, w)
    first = pt.train_backward(plan, flat, stage, jac, jbar, xbar)
    again = pt.train_backward(plan, flat, stage, jac, jbar, xbar)
    torch.cuda.synchronize()
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    assert (pt.BWD_LAUNCHES, pt.BWD_TILED_LAUNCHES) == (launches[0] + 3, launches[1] + 3)


@pytest.mark.cuda
def test_tiled_backward_counts_its_launches(cuda):
    """FusedTrain's backward is one launch: of the tiled kernel on a plan
    with hidden layers of 64, of the per-thread kernel on camel (local
    arrays) and on create_model(2, 4, [128, 128]) (the workspace), which
    BWD_TILED_LAUNCHES does not count."""
    for name, tiled in (("pwquad_max_hidden_rank", 1), ("pwquad_camel", 0),
                        ("pwquad_wide128", 0)):
        model = _model(name, cuda)
        plan = pt.TrainPlan(model.flow)
        w = _latents(1000, model.flow.n_flow, cuda)
        launches = (pt.BWD_LAUNCHES, pt.BWD_TILED_LAUNCHES)
        x, jac = pt.fused_train(plan, pt.fold_flow(model), w)
        torch.var(jac).backward()
        assert (pt.BWD_LAUNCHES, pt.BWD_TILED_LAUNCHES) == (launches[0] + 1,
                                                             launches[1] + tiled)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [1, 2, 8, 36])
def test_device_sobol_on_the_card_equals_the_cpu(cuda, dim):
    """The Sobol ladder's int64 arithmetic, masks and split products give
    the same bits on the card as on the CPU."""
    from nf_tpu_torch.utils import qmc
    gen = qmc.make_device_sobol(dim)
    for seed in (0, 11, (3 + 0x9E3779B9 * 5) & 0xFFFFFFFF):
        assert torch.equal(gen(1 << 14, seed, cuda).cpu(), gen(1 << 14, seed, "cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("name,tol", [("pwquad_camel", 2e-4), ("pwquad_masked_rank", 2e-4),
                                      ("pwlin", 2e-4), ("affine", 2e-3)])
def test_folded_inverse_undoes_the_kernel(cuda, name, tol):
    """The kernel's x through make_folded_inverse gives back its latents to
    ``tol``, and jac * jac_inv = 1 to ``5 tol``, on the samples away from a
    kink of the map.  The affine cells' atan saturates near 1, where one
    float32 unit of x moves the recovered latent by up to 1.6e-4 (the plain
    version with x one unit lower, on the CPU): hence its looser bound."""
    from nf_tpu_torch.flows.fast_eval import make_folded_inverse
    model = _model(name, cuda)
    flow = model.flow
    w = _latents(1 << 16, flow.n_flow, cuda)
    x, jac = ps.build_sampler(flow, model, take_latents=True)(w)
    w_back, jac_inv = make_folded_inverse(flow, model)(x)
    keep = pt.kink_distance(flow, pt.fold_flow(model).detach().double(), w.double()) > 1e-5
    assert float((w_back - w).abs().amax(1)[keep].max()) <= tol
    assert float((jac * jac_inv - 1).abs()[keep].max()) <= 5 * tol


@pytest.mark.cuda
def test_event_generation_launches_the_sampler(cuda):
    """integrate(method="qmc") launches the kernel once per replication and
    generate_unweighted(method="auto") once per batch and once for the w_max
    pilot, on a model on the card; nothing falls back to the plain version."""
    from nf_tpu_torch import PWQuadManager
    from nf_tpu_torch.training.unweight import generate_unweighted

    def camel(x):
        return (torch.exp(-((x[:, 0] - 0.75) ** 2 + (x[:, 1] - 0.75) ** 2) / 0.04)
                + torch.exp(-((x[:, 0] - 0.25) ** 2 + (x[:, 1] - 0.25) ** 2) / 0.04))

    NF = PWQuadManager(n_flow=2, seed=0, device=cuda)
    NF.create_model(2, 4, [3] * 3)
    launches = ps.LAUNCHES
    sig, err = NF.integrate(camel, 4, 1 << 14, seed=3, method="qmc")
    assert ps.LAUNCHES == launches + 4 and math.isfinite(sig) and err > 0
    launches = ps.LAUNCHES
    events, eff, _ = generate_unweighted(NF._flow, NF.best_model, camel,
                                         torch.Generator(device=cuda).manual_seed(1),
                                         n_events=2000, batch=1 << 14)
    n_batches = round(events.shape[0] / eff) // (1 << 14)
    assert ps.LAUNCHES == launches + 1 + n_batches
    assert events.dtype == np.float32 and ((events >= 0) & (events <= 1)).all()
