"""The bin-axis scan (``nf_tpu_torch.ops.bin_scan``): ``bin_cumsum``, its
autograd rule, its ``vmap`` rule, and the six cumulative sums over the bins
in ``nf_tpu_torch.bijectors.coupling`` that go through it.

On the CPU the wrapper runs its plain version (``torch.cumsum``), and
nothing may change there: the coupling cells' outputs and gradients are held
bit for bit against the same cells with ``torch.cumsum`` in place of the
wrapper.  The kernel runs on the card only (the ``cuda`` cases), against a
column-by-column float sum in its own order bit for bit and against the
plain version within the rounding of two summation orders.  This module does
not import JAX, so its card cases run there with ``--noconftest -m cuda``.
"""

import pytest
import torch

from nf_tpu_torch.bijectors import coupling
from nf_tpu_torch.ops import bin_scan
from nf_tpu_torch.ops.bin_scan import bin_cumsum, bin_cumsum_ordered, bin_cumsum_ref
from nf_tpu_torch.utils import profiling

torch.set_num_threads(1)

NS = (1, 4, 5, 16, 17, 32, 100)


def _rows(n, dtype=torch.float64, device="cpu", lead=(7, 3), seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*lead, n, generator=g, dtype=dtype).to(device)


def _library(x, reverse):
    return torch.cumsum(x.flip(-1), -1).flip(-1) if reverse else torch.cumsum(x, -1)


@pytest.fixture
def spy(monkeypatch):
    """The plain version's calls, as the ``reverse`` flag of each."""
    calls = []

    def plain(x, reverse=False):
        calls.append(reverse)
        return bin_cumsum_ref(x, reverse)

    monkeypatch.setattr(bin_scan, "bin_cumsum_ref", plain)
    return calls


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", NS)
def test_bin_cumsum_is_torch_cumsum_on_cpu(n, reverse):
    """float64, forward and reversed: the wrapper's plain path is
    ``torch.cumsum`` (reversed: as torch takes a cumsum's gradient) bit for
    bit, and within 1e-12 of numpy's sum; a 1-D and a non-contiguous input
    alike."""
    x = _rows(n)
    want = _library(x, reverse)
    assert torch.equal(bin_cumsum(x, reverse), want)
    a = x.numpy()
    ref = a[..., ::-1].cumsum(-1)[..., ::-1] if reverse else a.cumsum(-1)
    torch.testing.assert_close(bin_cumsum(x, reverse), torch.from_numpy(ref.copy()),
                               rtol=1e-12, atol=1e-12)
    assert torch.equal(bin_cumsum(x[0, 0], reverse), want[0, 0])
    strided = x.transpose(0, 1)
    assert torch.equal(bin_cumsum(strided, reverse), _library(strided, reverse))


def test_ordered_sum_is_an_inclusive_scan():
    """The card tests' bit-for-bit yardstick is a scan: within float64
    rounding of ``torch.cumsum``, both ways."""
    x = _rows(9)
    for reverse in (False, True):
        torch.testing.assert_close(bin_cumsum_ordered(x, reverse), _library(x, reverse),
                                   rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("reverse", [False, True])
def test_gradcheck(reverse):
    """The Function's gradient (the scan from the other side) and its
    second derivative, in float64."""
    x = _rows(6, lead=(4, 2)).requires_grad_()
    fn = lambda t: bin_cumsum(t, reverse)  # noqa: E731
    assert torch.autograd.gradcheck(fn, (x,))
    assert torch.autograd.gradgradcheck(fn, (x,))


@pytest.mark.parametrize("in_dim", [0, 1, 2])
@pytest.mark.parametrize("reverse", [False, True])
def test_vmap_of_grad_equals_a_loop(in_dim, reverse):
    """``torch.func.vmap(torch.func.grad(...))`` through the Function, the
    runs' axis at each place (last: the physical last axis is the runs'),
    against a loop over the runs; the values under ``vmap`` too."""
    runs, t, n = 5, 3, 7
    xs = _rows(n, lead=(runs, t)).movedim(0, in_dim)
    ws = _rows(n, lead=(runs, t), seed=2).movedim(0, in_dim)

    def loss(x, w):
        return (bin_cumsum(x, reverse) * w).square().sum()

    grads = torch.func.vmap(torch.func.grad(loss), in_dims=(in_dim, in_dim))(xs, ws)
    values = torch.func.vmap(lambda x: bin_cumsum(x, reverse), in_dims=in_dim)(xs)
    for r in range(runs):
        x = xs.select(in_dim, r).detach().requires_grad_()
        w = ws.select(in_dim, r)
        (g,) = torch.autograd.grad(loss(x, w), x)
        torch.testing.assert_close(grads[r], g, rtol=1e-14, atol=1e-14)
        assert torch.equal(values[r], _library(xs.select(in_dim, r), reverse))


def _cell(kind, direction, dtype=torch.float64, device="cpu", batch=64, t=3, n_bins=5,
          seed=0):
    """A pwquad or pwlin cell's forward or inverse on seeded raw conditioner
    outputs ``z`` (requires grad) and points in (0, 1)."""
    g = torch.Generator().manual_seed(seed)
    width = t * (2 * n_bins + 1 if kind == "pwquad" else n_bins)
    z = torch.randn(batch, width, generator=g, dtype=dtype).to(device).requires_grad_()
    pts = torch.rand(batch, t, generator=g, dtype=dtype).to(device)
    fns = {("pwquad", "forward"): coupling.pwquad_transform,
           ("pwquad", "inverse"): coupling.pwquad_inverse,
           ("pwlin", "forward"): coupling.pwlin_transform,
           ("pwlin", "inverse"): coupling.pwlin_inverse}
    return fns[kind, direction], z, pts, n_bins


def _run_cell(fn, z, pts, n_bins):
    out, factor = fn(z, pts, n_bins)
    (grad,) = torch.autograd.grad(out.sum() + factor.log().sum(), z)
    return out, factor, grad


# scans a call of each cell: pwquad its bin widths and its trapezoid CDF,
# pwlin its CDF; each takes a gradient, so the backward scans as often
@pytest.mark.parametrize("kind, direction, scans", [
    ("pwquad", "forward", 2), ("pwquad", "inverse", 2),
    ("pwlin", "forward", 1), ("pwlin", "inverse", 1)])
def test_coupling_sites_take_the_wrapper(spy, monkeypatch, kind, direction, scans):
    """Each of the six sites in ``coupling.py`` goes through the wrapper, in
    the forward and, from the right, in the backward, counted on its plain
    path; outputs and gradients are those of ``torch.cumsum`` bit for bit;
    the kernel's launch count does not move on the CPU."""
    fn, z, pts, n_bins = _cell(kind, direction)
    launches = profiling.BIN_SCAN_LAUNCHES
    out, factor, grad = _run_cell(fn, z, pts, n_bins)
    assert spy == [False] * scans + [True] * scans
    assert profiling.BIN_SCAN_LAUNCHES == launches

    monkeypatch.setattr(coupling, "bin_cumsum", lambda x: torch.cumsum(x, dim=-1))
    want = _run_cell(fn, z, pts, n_bins)
    assert len(spy) == 2 * scans
    for got, ref in zip((out, factor, grad), want):
        assert torch.equal(got, ref)


def test_float32_cell_on_cpu_is_unchanged(monkeypatch):
    """float32, where torch's CPU cumsum adds in float64: the pwquad inverse
    and its gradient still equal ``torch.cumsum``'s bit for bit."""
    fn, z, pts, n_bins = _cell("pwquad", "inverse", dtype=torch.float32, n_bins=16)
    got = _run_cell(fn, z, pts, n_bins)
    monkeypatch.setattr(coupling, "bin_cumsum", lambda x: torch.cumsum(x, dim=-1))
    for a, b in zip(got, _run_cell(fn, z, pts, n_bins)):
        assert torch.equal(a, b)


def test_a_scalar_is_refused():
    with pytest.raises(ValueError, match="last axis"):
        bin_cumsum(torch.tensor(1.0))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the bin-axis scan kernel is CUDA C++")
    return torch.device("cuda")


# the three plans' scans: camel2d (4 bins, one transformed dim, batch 10000),
# zzmc (16 bins, 5 dims, minibatch 2^16), zz4l's first estimate (32 bins,
# 5 dims, 2^18)
PLAN_SHAPES = ((10000, 1, 4), (1 << 16, 5, 16), (1 << 18, 5, 32))


def _scan_bound(x, reverse):
    """How far two summation orders of the same row can lie apart: each is
    within (n - 1) u sum |x| of the exact sum (u the type's unit roundoff)."""
    u = torch.finfo(x.dtype).eps / 2
    return 2 * x.shape[-1] * u * _library(x.abs(), reverse)


def _check_kernel(x, reverse):
    before = profiling.BIN_SCAN_LAUNCHES
    got = bin_cumsum(x, reverse)
    torch.cuda.synchronize(x.device)
    assert profiling.BIN_SCAN_LAUNCHES == before + 1
    assert got.device == x.device
    assert got.shape == x.shape and got.dtype == x.dtype and got.is_contiguous()
    assert torch.equal(got, bin_cumsum_ordered(x, reverse))
    gap = (got - bin_cumsum_ref(x, reverse)).abs()
    assert bool((gap <= _scan_bound(x, reverse)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_kernel_at_the_plans_shapes(cuda, shape, dtype, reverse):
    """The kernel against its own order of adds bit for bit, and against the
    plain version (torch's scan, another order) within two orders' rounding,
    on positive bin heights as the cells scan them."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.rand(shape, generator=g, device=cuda, dtype=dtype).exp()
    _check_kernel(x, reverse)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", NS)
def test_kernel_at_any_width(cuda, n, dtype, reverse):
    """Widths past the staged 32 columns (chunks carrying the sum), an odd
    row count (a short last block) and a span that starts off a 16-byte
    boundary (the scalar head and tail around the vector body)."""
    flat = torch.randn(1001 * n + 3, device=cuda, dtype=dtype)
    for offset in (0, 1, 3):
        _check_kernel(flat[offset:offset + 1001 * n].view(1001, n), reverse)


@pytest.mark.cuda
def test_kernel_non_contiguous(cuda):
    """A strided input is made contiguous first: a transposed view and a
    view of every second bin."""
    x = torch.randn(16, 300, 5, device=cuda).transpose(0, 1)
    _check_kernel(x, False)
    _check_kernel(torch.randn(300, 5, 34, device=cuda)[..., ::2], True)


@pytest.mark.cuda
def test_kernel_on_a_device_that_is_not_current(cuda):
    """A tensor on the second card while the first is current: the launch
    runs on the tensor's card, in its context and on its stream, with that
    card's SMs sizing the grid."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs: a tensor on a card that is not the current one")
    with torch.cuda.device(0):
        x = torch.rand((1 << 12, 5, 16), device=torch.device("cuda", 1))
        for reverse in (False, True):
            _check_kernel(x, reverse)
        assert torch.cuda.current_device() == 0


@pytest.mark.cuda
def test_kernel_in_a_cuda_graph(cuda):
    """Captured once and replayed on new data: the replay scans the new data
    and the capture counted one launch, the replays none."""
    x = torch.rand((1 << 12, 5, 16), device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        bin_cumsum(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = profiling.BIN_SCAN_LAUNCHES
    with torch.cuda.graph(graph):
        y = bin_cumsum(x, True)
    assert profiling.BIN_SCAN_LAUNCHES == before + 1
    for seed in (1, 2):
        gen = torch.Generator(cuda).manual_seed(seed)
        x.copy_(torch.rand(x.shape, device=cuda, generator=gen))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, bin_cumsum_ordered(x, True))
    assert profiling.BIN_SCAN_LAUNCHES == before + 1


def _rel_gaps(a, ref):
    """The largest and the RMS elementwise relative gap of ``a`` to ``ref``,
    and the norm-wise one, ||a - ref|| / ||ref||."""
    diff = a.detach().double() - ref
    rel = (diff / ref.abs().clamp_min(1e-30)).abs()
    return (float(rel.max()), float(rel.square().mean().sqrt()),
            float(diff.norm() / ref.norm()))


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_pwquad_cell_on_card_against_the_plain_path(cuda, monkeypatch, direction):
    """A 16-bin pwquad cell through the kernel against the same cell through
    ``torch.cumsum`` on the card.  float64: values and gradients within
    1e-10 relative; the two scans add in different orders (1e-16 relative an
    add over 16 bins) and the cell's arithmetic magnifies that by far less
    than 1e6 (a sample lies within 1e-15 of a bin edge with a chance of
    ~1e-13).  float32: no elementwise tolerance holds both directions, since
    the inverse divides a CDF's rounding by its bin's width and PDF, so a
    narrow bin turns ~1e-7 into ~1e-3; so each float32 path is measured
    against the float64 run on the same inputs, and the kernel's path may lie
    no farther from it than the library's by 2.5x in the RMS relative gap
    and 8x in the largest (an ordered sum's rounding bound over 16 bins is
    15 u, a tree's 4 u).  The float32 gradient is held norm-wise, within
    2.5x of the library's ||g - g64|| / ||g64||: its entries pass through
    zero, where an elementwise relative gap measures only how near zero the
    float64 entry lies."""
    fn, z, pts, n_bins = _cell("pwquad", direction, device=cuda, batch=1 << 14, t=5,
                               n_bins=16)
    # the float32 inputs, and the float64 run on exactly those values
    z32, pts32 = z.detach().float().requires_grad_(), pts.float()
    z64, pts64 = z32.detach().double().requires_grad_(), pts32.double()
    launches = profiling.BIN_SCAN_LAUNCHES
    runs = {torch.float64: (z64, pts64), torch.float32: (z32, pts32)}
    kernel = {dtype: _run_cell(fn, zz, pp, n_bins) for dtype, (zz, pp) in runs.items()}
    assert profiling.BIN_SCAN_LAUNCHES == launches + 2 * 4
    monkeypatch.setattr(coupling, "bin_cumsum", lambda x: torch.cumsum(x, dim=-1))
    library = {dtype: _run_cell(fn, zz, pp, n_bins) for dtype, (zz, pp) in runs.items()}
    want = library[torch.float64]
    for a, b in zip(kernel[torch.float64], want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)
    for name, k, lib, ref in zip(("values", "factor", "gradient"), kernel[torch.float32],
                                 library[torch.float32], want):
        k_max, k_rms, k_norm = _rel_gaps(k, ref)
        l_max, l_rms, l_norm = _rel_gaps(lib, ref)
        print(f"{direction} {name}: float32 gap to float64, kernel max {k_max:.3e} rms "
              f"{k_rms:.3e} norm {k_norm:.3e}, library max {l_max:.3e} rms {l_rms:.3e} "
              f"norm {l_norm:.3e}")
        if name == "gradient":
            assert k_norm <= 2.5 * l_norm
        else:
            assert k_rms <= 2.5 * l_rms and k_max <= 8 * l_max


@pytest.mark.cuda
def test_vmap_of_grad_on_card(cuda):
    """The ensemble's form, ``vmap`` over ``grad``, takes the kernel: one
    launch forward and one backward for all runs, against a loop."""
    xs = torch.rand((4, 1000, 2, 16), device=cuda, dtype=torch.float64)

    def loss(x):
        return bin_cumsum(x).square().sum()

    before = profiling.BIN_SCAN_LAUNCHES
    grads = torch.func.vmap(torch.func.grad(loss))(xs)
    assert profiling.BIN_SCAN_LAUNCHES == before + 2
    for r in range(xs.shape[0]):
        x = xs[r].clone().requires_grad_()
        (g,) = torch.autograd.grad(loss(x), x)
        torch.testing.assert_close(grads[r], g, rtol=1e-13, atol=0)
