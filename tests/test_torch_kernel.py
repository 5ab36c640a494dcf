"""The fused sampler's wrapper, plan encoding, Philox stream and CUDA kernel.

Imports neither JAX nor nf_tpu, so that the tests marked ``cuda`` also run on
a machine with a GPU and no JAX (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel.py

Without a card the ``cuda`` tests skip; the rest run anywhere.
"""

import numpy as np
import pytest
import torch

from nf_tpu_torch.flows import factory
from nf_tpu_torch.flows.fast_eval import make_folded_forward
from nf_tpu_torch.ops import pwquad_sampler as ps

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
