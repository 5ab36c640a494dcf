"""The reference against the program's plain path in float64 at small
sizes; each cell's check on the CPU (the program sound, then broken, then
the control in its place)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import flow, integrands
from benchmark.tests import _drive

PLANS = [(2, 2, 4, [3, 3, 3]), (10, 4, 32, [32, 32]), (5, 5, 8, [16])]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _program(plan_args):
    from nf_tpu_torch import PWQuadManager

    nf, nc, nb, hidden = plan_args
    mgr = PWQuadManager(n_flow=nf, seed=7, dtype=torch.float64, device="cpu")
    mgr.create_model(nc, nb, hidden)
    gen = torch.Generator().manual_seed(nf)
    with torch.no_grad():
        for k, v in mgr._model.state_dict().items():
            if k.endswith(".mean"):
                v.copy_(0.2 * torch.rand(v.shape, generator=gen, dtype=v.dtype))
            elif k.endswith(".var"):
                v.copy_(0.5 + torch.rand(v.shape, generator=gen, dtype=v.dtype))
            elif k.endswith("final.w") or k.endswith("final.b"):
                v.copy_(torch.rand(v.shape, generator=gen, dtype=v.dtype) - 0.5)
    return mgr, flow.pwquad_plan(nf, nc, nb, hidden)


@pytest.mark.parametrize("plan_args", PLANS, ids=lambda a: f"{a[0]}d")
def test_flow_matches_the_program(plan_args):
    from nf_tpu_torch.ops import pwquad_train

    mgr, plan = _program(plan_args)
    assert mgr._flow.ops == tuple(op if op[0] == "cell" else op for op in mgr._flow.ops)
    p = {k: v.clone() for k, v in mgr._model.state_dict().items()}
    w = torch.rand(777, plan.n_flow, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    x, jac = flow.forward(p, plan, w, "eval")
    x2, jac2 = mgr._model(w, False)
    torch.testing.assert_close(x, x2, rtol=0, atol=1e-13)
    torch.testing.assert_close(jac, jac2, rtol=1e-12, atol=0)
    new = {}
    x, jac = flow.forward(p, plan, w, "train", new_stats=new)
    x2, jac2 = mgr._model(w, True)     # moves the program's buffers
    torch.testing.assert_close(x, x2, rtol=0, atol=1e-12)
    torch.testing.assert_close(jac, jac2, rtol=1e-11, atol=0)
    for k, v in mgr._model.state_dict().items():
        if flow.is_buffer(k):
            torch.testing.assert_close(new[k], v, rtol=1e-13, atol=1e-15)
    # the stale trainer's statistics refresh; the program folds its weights
    # to float32 whatever the model's type, so the two agree to float32
    stats, p = {}, {k: v.clone() for k, v in mgr._model.state_dict().items()}
    flow.forward(p, plan, w, "eval", stats=stats)
    sums = pwquad_train.forward_stats_ref(mgr._flow, pwquad_train.fold_flow(mgr._model).double(),
                                          w)[3]
    pwquad_train.stats_to_bn_state(mgr._model, sums, w.shape[0])
    moved = flow.stats_update(p, stats, w.shape[0])
    for k, v in mgr._model.state_dict().items():
        if flow.is_buffer(k):
            torch.testing.assert_close(moved[k], v, rtol=1e-4, atol=1e-7)


def test_philox_matches_the_kernels_plain_version():
    from nf_tpu_torch.ops.pwquad_sampler import philox_uniform

    for seed, offset, n, nf in [(0, 0, 100, 2), ((1 << 62) - 5, 2 ** 33 + 7, 3000, 10),
                                (2_147_483_711, 12345, 513, 5)]:
        np.testing.assert_array_equal(flow.philox_latents(seed, offset, n, nf, "cpu").numpy(),
                                      philox_uniform(seed, offset, n, nf))


def test_integrands_match_the_programs():
    from benchmark import integrands as user

    w = torch.rand(20000, 10, dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    f1, f2 = user.zz4l()(w), integrands.zz4l(w)
    assert 0.1 < float(torch.mean((f1 != 0).double())) < 0.9
    torch.testing.assert_close(f2, f1, rtol=1e-12, atol=0)
    torch.testing.assert_close(integrands.camel(w[:, :2]), user.BUILD["camel"]()(w[:, :2]))
    u = torch.rand(2_000_000, 2, dtype=torch.float64, generator=torch.Generator().manual_seed(4))
    assert abs(float(integrands.camel(u).mean()) / integrands.camel_exact() - 1) < 3e-3


@pytest.mark.parametrize("cell", sorted(_drive.SMALL))
def test_sound_program_is_correct(cell):
    correct, numbers, run = _drive.drive(cell)
    assert correct, numbers
    assert all(v >= 0 for v in numbers.values())


def _faults(cell):
    """The faults each cell can have, planted in the program on the CPU."""
    import nf_tpu_torch.training.manager as manager
    import nf_tpu_torch.training.unweight as uw
    from nf_tpu_torch.ops import pwquad_sampler
    from nf_tpu_torch.parallel import sampling as psampling
    from nf_tpu_torch.phasespace import pdf

    build = pwquad_sampler.build_sampler
    accepted, batch = uw._accepted, uw.unweighted_batch
    xfx, combine_iterations = pdf.ToyPDF.xfxQ2, psampling.combine_iterations

    def half_sampler(*a, **k):
        sample = build(*a, **k)

        def run(seed, n, offset=0):
            x, jac = sample(seed, n, offset)
            cut = x.shape[-1] // 2 if k.get("layout") == "dim_major" else x.shape[0] // 2
            return (x[:, :cut], jac[:cut]) if k.get("layout") == "dim_major" else (x[:cut], jac[:cut])
        return run

    def half_proposals(*a, **k):
        sample = build(*a, **k)

        def run(seed, n, offset=0):
            x, jac = sample(seed, n, offset)
            half = x.shape[0] // 2
            return torch.cat([x[:half], x[:x.shape[0] - half]]), torch.cat([jac[:half], jac[:x.shape[0] - half]])
        return run

    def altered_sampler(*a, **k):
        sample = build(*a, **k)

        def run(seed, n, offset=0):
            x, jac = sample(seed, n, offset)
            x = x.clone()
            x.view(-1)[0] += 1e-2
            return x, jac
        return run

    def altered_accepted(x, accept, n_over, wtilde, capacity):
        rows, w, n_true, over = accepted(x, accept, n_over, wtilde, capacity)
        rows = rows.copy()
        if len(rows):
            rows[0, 0] += 1e-3
        return rows, w, n_true, over

    def half_accept(flow, model, f, generator, n, w_max, train=False, draw=None,
                    return_weights=False):
        x, accept, *rest = batch(flow, model, f, generator, n, w_max, train, draw, return_weights)
        accept = accept.clone()
        accept[n // 2:] = False
        return (x, accept, *rest)

    def dropped_events(x, accept, n_over, wtilde, capacity):
        rows, w, n_true, over = accepted(x, accept, n_over, wtilde, capacity)
        return rows[::2], w[::2], n_true, over

    def altered_weight(x, accept, n_over, wtilde, capacity):
        rows, w, n_true, over = accepted(x, accept, n_over, wtilde, capacity)
        w = w.copy()
        if len(w):
            w[0] *= 1.1
        return rows, w, n_true, over

    def pdf_high(self, pdg, x, q2):
        return 1.05 * xfx(self, pdg, x, q2)

    def plain_mean(means, variances, n_total, combine="iw"):
        sig = combine_iterations(means, variances, n_total, "mean")[0]
        return sig, combine_iterations(means, variances, n_total, combine)[1]

    step = manager.epoch_step

    def half_batch(model, optimizer, f, ws, *a, **k):
        return step(model, optimizer, f, [w[: w.shape[0] // 2] for w in ws], *a, **k)

    if cell.endswith("integrate"):
        return {"half_batch": (pwquad_sampler, "build_sampler", half_sampler),
                "altered_answer": (pwquad_sampler, "build_sampler", altered_sampler),
                "plain_mean": (psampling, "combine_iterations", plain_mean)}
    if cell.endswith("unweight"):
        return {"half_batch": (pwquad_sampler, "build_sampler", half_proposals),
                "altered_answer": (uw, "_accepted", altered_accepted),
                "half_accept": (uw, "unweighted_batch", half_accept),
                "dropped_events": (uw, "_accepted", dropped_events),
                "altered_weight": (uw, "_accepted", altered_weight),
                "integrand_high": (pdf.ToyPDF, "xfxQ2", pdf_high)}
    return {"unchanged_state": (torch.optim.Adamax, "step", lambda self, closure=None: None),
            "half_batch": (manager, "epoch_step", half_batch)}


FAULTS = {"integrate": ("half_batch", "altered_answer", "plain_mean"),
          "unweight": ("half_batch", "altered_answer", "half_accept", "dropped_events",
                       "altered_weight", "integrand_high"),
          "train": ("unchanged_state", "half_batch")}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(_drive.SMALL)
                                        for f in FAULTS[c.split(".")[1].split("_")[0]]])
def test_broken_program_is_not_correct(cell, fault, monkeypatch):
    owner, name, broken = _faults(cell)[fault]
    monkeypatch.setattr(owner, name, broken)
    correct, numbers, _ = _drive.drive(cell)
    assert not correct, numbers


@pytest.mark.parametrize("cell", sorted(_drive.SMALL))
def test_control_is_not_correct(cell):
    """The reference in the program's place, computed in float32 with TF32
    products, fails at least one of the cell's limits."""
    from benchmark import control

    spec, ctx, driver = _drive.driver_of(cell)
    driver.p0 = driver.params()
    if spec.wl["driver"] == "train":
        driver.check_seeds = [control.derive(driver.seed, "check", k) for k in range(2)]
    reading = control.readings(driver, spec.wl["driver"])["control"]
    assert any(reading[n] > lim for n, lim in spec.wl["limits"].items()), reading


# a proposal of a zz4l.unweight call on the card whose Delta R lies 8.7e-8
# below its cut in float64: float32's rounding of it passes the cut
NEAR_CUT = [0.0006275683990679681, 0.7543543577194214, 0.5073645710945129, 0.8445040583610535,
            0.9928712844848633, 0.08689384162425995, 0.18012630939483643, 0.9990938901901245,
            0.6630439758300781, 0.8197378516197205]


@pytest.mark.parametrize("taken,flips", [((0, 1, 2), 0), ((1, 2), 1)],
                         ids=["near_cut_taken", "clear_event_dropped"])
def test_clear_flips_leave_out_points_at_a_cut(taken, flips):
    """A decision that float32's rounding of a cut variable can turn is not
    clear: taking the point at the cut is no flip, dropping a clear event
    is one."""
    from benchmark.reference import checks

    f, dist = integrands.zz4l, integrands.CUT_DISTANCE["zz4l"]
    gen = torch.Generator().manual_seed(3)
    far = torch.rand(4096, 10, generator=gen, dtype=torch.float64)
    w_far = f(far)
    x64 = torch.cat([far[w_far > 0][:2], torch.tensor([NEAR_CUT], dtype=torch.float64)])
    x64 = x64[[0, 2, 1]]                       # rows: clear event, near cut, clear event
    x32 = x64.float()
    w64, w32 = f(x64), f(x32).double()
    assert w64[1] == 0 and w32[1] > 0 and float(dist(x64[1:2])) < checks.CUT_TOL
    assert float(dist(x64[[0, 2]]).min()) > checks.CUT_TOL
    w_max = 2.0 * float(torch.max(torch.stack([w64[0], w32[1], w64[2]])))
    u = torch.stack([0.5 * w64[0], 0.5 * w32[1], 0.5 * w64[2]]) / w_max
    ref = {"x": [x64], "w": [w64], "u": [u], "jac": [torch.ones(3, dtype=torch.float64)],
           "kept": [w64 > u * w_max], "w_max_used": w_max}
    rows = list(taken)
    out = {"x": [x32], "events": x32[rows].numpy(), "weights": np.ones(len(rows), np.float32)}
    nums = checks.unweight_numbers(out, ref, f, dist)
    assert nums["clear_flips"] == flips and nums["near_cut"] == 1, nums
    # without the cut's distance the point at the cut reads as a flip
    assert checks.unweight_numbers(out, ref, f)["clear_flips"] == flips + 1
