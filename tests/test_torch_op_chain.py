"""The op-chain kernel of the per-op cost calibration
(``nf_tpu_torch.ops.op_chain``) and its entry point
(``nf_tpu_torch/tools/calibrate_ops.py``), against
``tools/calibrate_vpu_ops.py``'s Pallas kernel.

On the CPU the wrapper runs its plain version, ``chain_ref``, which must
compute what ``build_chain_kernel`` computes; the tool's arithmetic is
tested on synthetic times.  The kernel itself runs on the card only
(``test_kernel_equals_plain_on_card``), where JAX is not installed: this
module imports JAX and the Pallas tool inside the test that needs them, so
its card cases run there with ``--noconftest -m cuda``.
"""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

from nf_tpu_torch.ops import op_chain
from nf_tpu_torch.tools import calibrate_ops

torch.set_num_threads(1)

F = np.float32
# XLA's CPU simplifier reassociates the constant chains of these ops (it
# logs "Algebraic simplifier is likely stuck"), so the Pallas kernel's
# interpret-mode output is not the step-by-step float32 chain there: a
# numpy float32 chain computed one step at a time differs from it by as
# much as the plain version does (test_chain_ref_is_the_stepwise_chain
# holds the plain version to that chain bit for bit).
REASSOCIATED = {"rsqrt": 1e-7, "fma": 1e-5, "mul": 1e-5, "add": 1e-5, "select": 1e-5}

# the numpy twins of the reassociated steps, one float32 rounding per
# operation; fma's one rounding is the float64 sum's, which is exact here
STEPWISE = {
    "fma": lambda y: (y.astype(np.float64) * F(0.9990234375) + F(0.001)).astype(F),
    "mul": lambda y: y * F(0.9999),
    "add": lambda y: y + F(0.001),
    "rsqrt": lambda y: F(1) / np.sqrt(y + F(1)),
    "select": lambda y: np.where(y > F(1), y * F(0.9), y * F(1.05) + F(0.01)),
}


def stepwise_chain(step, k, grid, seed):
    """The chain in numpy float32, one step at a time, summed in the
    kernel's order (runs of 32 grid steps into partial rows)."""
    lane = np.arange(op_chain.LANE, dtype=F) / F(op_chain.LANE)
    i = np.arange(grid, dtype=F)
    y = (lane + F(0.5))[None, :] + (F(1e-6) * i)[:, None]
    y = np.repeat((y + F(seed) * F(1e-6))[:, None, :], op_chain.SUB, axis=1)
    for _ in range(k):
        y = step(y)
    assert y.dtype == F
    out = np.zeros((op_chain.SUB, op_chain.LANE), F)
    for c in range(0, grid, op_chain.CHUNK):
        part = np.zeros_like(out)
        for j in range(c, min(c + op_chain.CHUNK, grid)):
            part = part + y[j]
        out = out + part
    return out


def bits(a):
    return np.asarray(a, dtype=F).view(np.int32)


CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def pallas_tool():
    """``tools/calibrate_vpu_ops.py``, imported anew.  Importing it puts an
    absolute checkout path at the head of ``sys.path`` and sets
    ``JAX_COMPILATION_CACHE_DIR``; both are put back as they were, so the
    tests after this one import this checkout's modules and the processes
    they start cache where they did."""
    path, cache = list(sys.path), os.environ.get(CACHE_ENV)
    sys.modules.pop("tools.calibrate_vpu_ops", None)
    try:
        return importlib.import_module("tools.calibrate_vpu_ops")
    finally:
        sys.path[:] = path
        if cache is None:
            os.environ.pop(CACHE_ENV, None)
        else:
            os.environ[CACHE_ENV] = cache


def test_pallas_tool_import_leaves_the_process_as_it_was():
    path, cache = list(sys.path), os.environ.get(CACHE_ENV)
    assert callable(pallas_tool().build_chain_kernel)
    assert sys.path == path
    assert os.environ.get(CACHE_ENV) == cache


@pytest.mark.parametrize("op", op_chain.OPS)
def test_chain_matches_nf_tpu(op):
    """K 16, grid 4, seed 7: the plain version against the Pallas kernel in
    interpret mode.  exp, sqrt, div, log and tanh bit for bit; the
    reassociated ops within REASSOCIATED's relative tolerance."""
    import jax.numpy as jnp

    build_chain_kernel = pallas_tool().build_chain_kernel
    want = np.asarray(build_chain_kernel(op, 16, grid=4, interpret=True)(
        jnp.asarray([7], jnp.int32)))
    got = op_chain.chain_ref(op, 16, 4, 7, "cpu").numpy()
    assert got.shape == want.shape == (32, 128) and got.dtype == want.dtype == F
    assert np.isfinite(got).all()
    if op in REASSOCIATED:
        np.testing.assert_allclose(got, want, rtol=REASSOCIATED[op], atol=0)
    else:
        np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("op", sorted(REASSOCIATED))
@pytest.mark.parametrize("grid", [4, 70])
def test_chain_ref_is_the_stepwise_chain(op, grid):
    """The reassociated ops against the numpy float32 chain, one step at a
    time, bit for bit (70 grid steps: three partial rows)."""
    got = op_chain.chain_ref(op, 16, grid, 7, "cpu").numpy()
    np.testing.assert_array_equal(bits(got), bits(stepwise_chain(STEPWISE[op], 16, grid, 7)))


def test_fma_step_is_fused():
    """fma is one rounding: a step differs from numpy's y * c + d (two
    roundings) by at most 1 ulp, and somewhere by one."""
    y = np.random.default_rng(3).uniform(0.5, 1.6, 1 << 16).astype(F)
    fused = op_chain.CHAINS["fma"](torch.from_numpy(y)).numpy()
    unfused = y * F(0.9990234375) + F(0.001)
    ulp = np.abs(bits(fused).astype(np.int64) - bits(unfused))
    assert ulp.max() == 1


def test_chain_on_cpu_is_the_plain_version():
    before = op_chain.LAUNCHES
    got = op_chain.chain("exp", 16, 3, 2, "cpu")
    assert op_chain.LAUNCHES == before
    np.testing.assert_array_equal(bits(got), bits(op_chain.chain_ref("exp", 16, 3, 2, "cpu")))


@pytest.mark.parametrize("op, k, grid", [("pow", 16, 4), ("exp", -1, 4), ("exp", 16, 0),
                                         ("exp", 2.5, 4)])
def test_chain_refuses_bad_arguments(op, k, grid):
    with pytest.raises(ValueError):
        op_chain.chain(op, k, grid, 7, "cpu")


def test_slope_recovers_the_per_op_time():
    """Synthetic times: m launches of a kernel whose launch costs a fixed
    edge plus K ops per element, between events with their own cost.  The
    two differences leave the per-op time alone."""
    sec, elements = 3.1e-14, 4096 * 1024

    def t(k, m):
        return 7e-6 + m * (4e-6 + k * elements * sec)

    times = {(k, m): t(k, m) for k in (64, 320) for m in (2, 10)}
    assert calibrate_ops.slope(times, elements) == pytest.approx(sec, rel=1e-9)
    costs = calibrate_ops.cost_in_fma_units({"fma": sec, "exp": 8.5 * sec})
    assert costs == pytest.approx({"fma": 1.0, "exp": 8.5})


SASS = """
\tcode for sm_90a
\t\tFunction : _Z15op_chain_kernelILi3ELi64EEvPfii
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   FMUL R0, R0, 0.0009765625 ;
        /*0020*/                   MUFU.EX2 R0, R0 ;
        /*0030*/              @!P0 FFMA R2, R0, R3, R4 ;
        /*0040*/                   NOP;
\t\tFunction : _Z15op_chain_kernelILi3ELi320EEvPfii
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   FMUL R0, R0, 0.0009765625 ;
        /*0020*/                   MUFU.EX2 R0, R0 ;
        /*0030*/              @!P0 FFMA R2, R0, R3, R4 ;
        /*0040*/                   FMUL R0, R0, 0.0009765625 ;
        /*0050*/                   MUFU.EX2 R0, R0 ;
        /*0060*/                   FFMA R2, R0, R3, R4 ;
        /*0070*/                   FFMA R2, R0, R3, R4 ;
\t\tFunction : _Z12op_chain_sumPKfiPf
        /*0000*/                   FADD R1, R1, R2 ;
"""


def test_sass_per_step_counts_the_k_difference():
    counts = calibrate_ops.sass_counts(SASS)
    assert counts == {(3, 64): {"LDC": 1, "FMUL": 1, "MUFU.EX2": 1, "FFMA": 1},
                      (3, 320): {"LDC": 1, "FMUL": 2, "MUFU.EX2": 2, "FFMA": 3}}
    per = calibrate_ops.sass_per_step(counts, op_chain.OPS)
    assert list(per) == ["exp"]
    assert per["exp"]["by_opcode"] == {"FFMA": 2 / 256, "FMUL": 1 / 256, "MUFU.EX2": 1 / 256}
    assert per["exp"]["instructions"] == pytest.approx(4 / 256)


def test_tool_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert calibrate_ops.main([]) != 0
    assert "needs an NVIDIA GPU" in capsys.readouterr().err


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the op-chain kernel is CUDA C++")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("op", op_chain.OPS)
def test_kernel_equals_plain_on_card(cuda, op):
    """K 64, grid 40 (two partial rows), seed 7: the kernel against the plain
    version on the card within 1e-6 relative (the card's expf, logf, tanhf
    and rsqrtf in torch's build and in the kernel's may round apart by an
    ulp), two launches bit for bit, each counted once."""
    before = op_chain.LAUNCHES
    got = op_chain.chain(op, 64, 40, 7, cuda)
    again = op_chain.chain(op, 64, 40, 7, cuda)
    torch.cuda.synchronize()
    assert op_chain.LAUNCHES == before + 2
    want = op_chain.chain_ref(op, 64, 40, 7, cuda)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
