"""The port's LHAPDF6 reader and PDFs against nf_tpu's.

On the bundled fixture ``tests/data/toypdf_0000.dat`` (two subgrids meeting
at Q = 10 GeV, forced knots at the charm and bottom thresholds, a negative
small-x flavor), in float64 on the CPU: the parse is equal array for array;
``xfxQ2`` agrees to rtol 1e-12 at the knots, off them, on both sides of the
subgrid boundary and in every extrapolation region (x below x_min, Q2 below
and above the grid, the corners), under both policies, for every flavor;
``GridPDF`` and ``from_tabulated`` agree with nf_tpu's and with each other;
``ToyPDF`` and ``CallbackPDF`` agree with nf_tpu's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf_tpu.phasespace import lhapdf_reader as jreader
from nf_tpu.phasespace import pdf as jpdf
from nf_tpu_torch.phasespace import lhapdf_reader as treader
from nf_tpu_torch.phasespace import pdf as tpdf

torch.set_num_threads(1)
FIXTURE = os.path.join(os.path.dirname(__file__), "data", "toypdf_0000.dat")


@pytest.fixture(scope="module")
def grids():
    return jreader.LHAPDFGrid.from_dat(FIXTURE), treader.LHAPDFGrid.from_dat(FIXTURE)


def _queries(grid):
    """(x, q2) points: every knot pair of the first subgrid's x and both
    subgrids' Q, the cell midpoints, the subgrid boundary's neighbourhood,
    and out-of-range points on every side and corner."""
    _, subgrids = treader.read_lhapdf_dat(FIXTURE)
    xs = subgrids[0][0]
    q2s = np.concatenate([sg[1] for sg in subgrids]) ** 2
    rng = np.random.default_rng(0)
    xk = rng.choice(xs, 96)
    qk = rng.choice(q2s, 96)
    xm = np.sqrt(xs[1:] * xs[:-1])
    qm = np.sqrt(q2s[1:] * q2s[:-1])
    x_off, q_off = rng.choice(xm, 96), rng.choice(qm[qm > q2s[0]], 96)
    xb = 10 ** rng.uniform(-4, -0.1, 32)
    qb = 100.0 * (1.0 + np.asarray([-1e-9, 1e-9, -1e-3, 1e-3, 0.0] * 6 + [0.0, 0.0]))
    x_out = np.concatenate([grid.x_min * 10 ** -rng.uniform(0.01, 3, 32),
                            10 ** rng.uniform(-4, -0.1, 64), grid.x_min * 0.1 * np.ones(32)])
    q_out = np.concatenate([10 ** rng.uniform(0.5, 4, 32),
                            grid.q2_min * rng.uniform(0.01, 0.99, 32),
                            grid.q2_max * rng.uniform(1.01, 100.0, 32),
                            np.repeat([grid.q2_min * 0.5, grid.q2_max * 3.0], 16)])
    x = np.concatenate([xk, x_off, xb, x_out])
    q2 = np.concatenate([qk, q_off, qb, q_out])
    return x, q2


def test_parse_matches_nf_tpu():
    meta_j, sg_j = jreader.read_lhapdf_dat(FIXTURE)
    meta_t, sg_t = treader.read_lhapdf_dat(FIXTURE)
    assert meta_t == meta_j and len(sg_t) == len(sg_j) == 2
    for a, b in zip(sg_t, sg_j):
        for u, v in zip(a, b):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)
    k_t, v_t = treader._pad_ghost(np.log(sg_t[0][0]), sg_t[0][3], 0)
    k_j, v_j = jreader._pad_ghost(np.log(sg_j[0][0]), sg_j[0][3], 0)
    np.testing.assert_array_equal(k_t, k_j)
    np.testing.assert_array_equal(v_t, v_j)


@pytest.mark.parametrize("mode", ["continuation", "nearest"])
def test_xfxq2_matches_nf_tpu(grids, mode):
    jg, tg = grids
    assert (tg.x_min, tg.q2_min, tg.q2_max) == (jg.x_min, jg.q2_min, jg.q2_max)
    assert tg.flavors == jg.flavors
    x, q2 = _queries(tg)
    for pdg in tg.flavors:
        want = np.asarray(jg.xfxQ2(pdg, jnp.asarray(x), jnp.asarray(q2), extrapolation=mode))
        got = tg.xfxQ2(pdg, torch.from_numpy(x), torch.from_numpy(q2), extrapolation=mode)
        assert got.dtype == torch.float64 and got.shape == x.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14, err_msg=str(pdg))
    # a number for q2 broadcasts like nf_tpu's
    np.testing.assert_allclose(
        tg.xfxQ2(2, torch.from_numpy(x), 91.188 ** 2, extrapolation=mode).numpy(),
        np.asarray(jg.xfxQ2(2, jnp.asarray(x), 91.188 ** 2, extrapolation=mode)),
        rtol=1e-12, atol=1e-14)


def test_unknown_flavor_and_policy_raise(grids):
    _, tg = grids
    x = torch.full((4,), 0.1, dtype=torch.float64)
    with pytest.raises(KeyError):
        tg.xfxQ2(6, x, 100.0)
    with pytest.raises(ValueError):
        tg.xfxQ2(2, x, 100.0, extrapolation="linear")
    with pytest.raises(ValueError):
        treader.LHAPDFGrid.from_dat(FIXTURE, extrapolation="linear")


def test_tables_copied_once_per_device_and_dtype(grids):
    _, tg = grids
    x = torch.full((8,), 0.1, dtype=torch.float64)
    tg.xfxQ2(21, x, 100.0)
    sg = tg._subgrids[0]
    tables = sg.tables(x.device, torch.float64)
    tg.xfxQ2(21, x, 100.0)
    assert sg.tables(x.device, torch.float64) is tables
    out32 = tg.xfxQ2(21, x.float(), 100.0)
    assert out32.dtype == torch.float32 and len(sg._on) == 2
    np.testing.assert_allclose(out32.numpy(), tg.xfxQ2(21, x, 100.0).numpy(), rtol=1e-5)


def _tabulated():
    xs = np.geomspace(1e-5, 0.9, 24)
    q2s = np.geomspace(2.0, 1e6, 12)
    grids = {pdg: np.outer(1.3 * xs ** (-0.1 * k) * (1 - xs) ** (3 + k), 1 + 0.05 * np.log(q2s))
             for k, pdg in enumerate((-2, 21, 2))}
    return xs, q2s, grids


def test_grid_pdf_and_from_tabulated_match_nf_tpu():
    xs, q2s, grids = _tabulated()
    x = 10 ** np.random.default_rng(1).uniform(-6, -0.02, 256)
    q2 = 10 ** np.random.default_rng(2).uniform(-0.5, 7, 256)
    for cls_t, cls_j in ((tpdf.GridPDF, jpdf.GridPDF),
                         (treader.LHAPDFGrid.from_tabulated, jreader.LHAPDFGrid.from_tabulated)):
        tg, jg = cls_t(xs, q2s, grids), cls_j(xs, q2s, grids)
        for pdg in (-2, 21, 2):
            np.testing.assert_allclose(
                tg.xfxQ2(pdg, torch.from_numpy(x), torch.from_numpy(q2)).numpy(),
                np.asarray(jg.xfxQ2(pdg, jnp.asarray(x), jnp.asarray(q2))), rtol=1e-12,
                atol=1e-14)
    a = tpdf.GridPDF(xs, q2s, grids)
    b = treader.LHAPDFGrid.from_tabulated(xs, q2s, grids)
    for pdg in (-2, 21, 2):
        assert torch.equal(a.xfxQ2(pdg, torch.from_numpy(x), torch.from_numpy(q2)),
                           b.xfxQ2(pdg, torch.from_numpy(x), torch.from_numpy(q2)))
    with pytest.raises(ValueError):
        treader.LHAPDFGrid.from_tabulated(xs[:1], q2s, {2: grids[2][:1]})


class _HostToy:
    """A host PDF with LHAPDF's scalar call, from the ToyPDF formula."""

    def xfxQ2(self, pdg, x, q2):
        n, a, b = tpdf.ToyPDF._params[pdg]
        return n * max(x, 1e-10) ** a * (1 - x) ** b * (1 + 0.01 * np.log(q2))


def test_toy_and_callback_pdfs_match_nf_tpu():
    x = np.random.default_rng(3).uniform(0.0, 1.0, 128)
    x[:3] = [0.0, 1e-12, 1.0]
    q2 = np.full(128, 91.188 ** 2)
    for pdg in (21, 2, -2, 1, 6, 0):
        np.testing.assert_allclose(
            tpdf.ToyPDF().xfxQ2(pdg, torch.from_numpy(x), None).numpy(),
            np.asarray(jpdf.ToyPDF().xfxQ2(pdg, jnp.asarray(x), None)), rtol=1e-12)
    cb_t, cb_j = tpdf.CallbackPDF(_HostToy()), jpdf.CallbackPDF(_HostToy())
    for pdg in (21, -2):
        got = cb_t.xfxQ2(pdg, torch.from_numpy(x), torch.from_numpy(q2))
        want = np.asarray(jax.jit(lambda a, b: cb_j.xfxQ2(pdg, a, b))(jnp.asarray(x),
                                                                         jnp.asarray(q2)))
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-15)
    got32 = cb_t.xfxQ2(2, torch.from_numpy(x).float(), 100.0)
    assert got32.dtype == torch.float32
