"""The port's learned multi-channel mixture against the benchmark's plain
reference (``benchmark/reference/mixture.py``), on the CPU at a small size.

The zzmc configuration's process, channels and flows (``benchmark/configs/
zzmc.json``): two channels, 2^10 samples a channel in two minibatches, each
channel's flow from the benchmark's seeded weights, perturbed from the
identity.  The program runs in float64 here, so the two agree to rounding:

  * the Z' pairing's kinematics, channel density and inverse kinematics,
    and their round trip; the reference's Z channel against the zz4l
    reference's own (``benchmark/reference/integrands.py``);
  * the mixture's weights, q and r (``mixture_weights``);
  * the KL loss and its gradient with respect to every channel's
    parameters;
  * a 2-epoch ``train_multichannel`` call: every epoch's loss and alphas,
    the first step's gradient and the parameters' change;
  * each fault the check is calibrated with fails the cell's limits;
  * the cell driven through the harness in float32: its check passes, and
    its two counters read what PERF.md section 3 derives.
"""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.drivers import mixture as drv
from benchmark.reference import integrands, mixture as ref
from nf_tpu_torch.flows.model import FlowModel
from nf_tpu_torch.training import multichannel as mc
from nf_tpu_torch.training import optimizers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "zzmc.train"
SEED = 2_147_483_711        # above 2^31, as the benchmark's seeds are
B, MB = 1 << 10, 1 << 9     # a channel's batch, in two minibatches
F64 = torch.float64
# float64 on both sides, the operations in other orders: every number agrees
# to a few thousand ulps (the flows' eight cells and the Breit-Wigner maps'
# tan / atan amplify rounding by ~1e3); the inverses' round trip to 1e-9
RTOL = 1e-9


def _spec():
    spec = harness.Spec(ROOT, CELL)
    spec.cfg["training"].update(batch_per_channel=B, mini_batch_per_channel=MB)
    spec.cfg["alphas"]["n_samples"] = 1 << 12
    spec.cfg["init"]["bn_pass"] = 1 << 12
    return spec


@pytest.fixture(scope="module")
def cell():
    """The driver (its channels and matrix element built) and its two
    flows' float32 parameters."""
    torch.set_num_threads(2)
    d = drv.Driver(harness.Ctx(_spec(), SEED, torch.device("cpu")))
    d._build()
    d.p0 = p0 = [drv.make_params(d.plan, d.rank, d.cfg["init"], SEED, "cpu", k)
                 for k in range(d.n_channels)]
    return d, p0


def _models(d, p0):
    fl = d.cfg["flow"]
    models = mc.build_channel_flows(torch.Generator().manual_seed(0), d.channels,
                                    fl["n_cells"], fl["n_bins"], fl["hidden"], dtype=F64,
                                    device="cpu", final_rank=d.rank)
    for m, p in zip(models, p0):
        m.load_state_dict({k: v.double() for k, v in p.items()})
    return models


@pytest.fixture
def f32_draws(monkeypatch):
    """The program's latents drawn as the reference draws them, in float32
    and then cast: the same stream for float64 flows."""
    monkeypatch.setattr(mc, "_uniform", lambda gen, shape, dtype, device: torch.rand(
        shape, generator=gen, dtype=torch.float32, device=device).to(dtype))


def _close(a, b, rtol=RTOL):
    a, b = torch.as_tensor(a, dtype=F64), torch.as_tensor(b, dtype=F64)
    assert a.shape == b.shape
    scale = torch.clamp_min(torch.abs(b), torch.max(torch.abs(b)) * 1e-6)
    gap = float(torch.max(torch.abs(a - b) / scale))
    assert gap <= rtol, gap


def test_zprime_kinematics_and_their_inverse(cell):
    d, _ = cell
    u = torch.rand((4096, 10), dtype=F64, generator=torch.Generator().manual_seed(1))
    ch, ch_r = d.channels[1], d.proc.channels[1]
    x, wt = ch.generateKinematics_batch(d.proc.e_cm, u, **d.cuts)
    x_r, wt_r, xb1, xb2 = ref.generate(ch_r, d.proc, u)
    live = wt_r > 0
    assert 0.2 < float(live.double().mean()) < 0.95   # the cuts take some, not all
    torch.testing.assert_close(x, x_r, rtol=0, atol=1e-9)    # GeV
    _close(wt, wt_r)
    _close(ch.channel_weight_ps(x), ref.channel_ps(ch_r, x_r))
    back = ch.invertKinematics_batch(d.proc.e_cm, x, xb1, xb2)
    back_r = ref.invert(ch_r, d.proc, x_r, xb1, xb2)
    torch.testing.assert_close(back_r, back, rtol=0, atol=1e-11)
    # the round trip of the events the cuts keep (a cut one far off the
    # Z' may sit where s's map is ill-conditioned), phi modulo its wrap
    gap = torch.abs(back_r - u)[live]
    gap[:, 3::2] = torch.minimum(gap[:, 3::2], 1.0 - gap[:, 3::2])
    assert float(gap.max()) < 1e-9
    # the Z channel is the zz4l reference's own, with its tau map left out
    m_z, w_z = integrands.zz_channel(u)
    m_r, w_r, _, _ = ref.generate(d.proc.channels[0], d.proc, u)
    torch.testing.assert_close(m_r, m_z, rtol=0, atol=1e-12)
    _close(w_r, w_z, 1e-13)


def test_mixture_weights_q_and_r(cell, f32_draws):
    d, p0 = cell
    alphas = torch.tensor([0.7, 0.3], dtype=F64)
    w, aux = mc.mixture_weights(d.channels, _models(d, p0), d.me, d.proc.e_cm,
                                torch.Generator().manual_seed(5), B, alphas, **d.cuts)
    gen = torch.Generator().manual_seed(5)
    zs = [torch.rand((B, 10), generator=gen, dtype=torch.float32).double() for _ in range(2)]
    p64 = [{k: v.double() for k, v in p.items()} for p in p0]
    with torch.no_grad():
        w_r, q_r, r_r, _ = ref.mixture(p64, d.plan, d.proc, alphas, zs)
    assert float((w_r > 0).double().mean()) > 0.3
    _close(w.detach(), w_r)
    _close(aux["q"].detach(), q_r)
    _close(aux["r"].detach(), r_r)


def test_kl_loss_and_its_gradient(cell, f32_draws):
    d, p0 = cell
    alphas = torch.tensor([0.6, 0.4], dtype=F64)
    models = _models(d, p0)
    w, aux = mc.mixture_weights(d.channels, models, d.me, d.proc.e_cm,
                                torch.Generator().manual_seed(6), MB, alphas, **d.cuts)
    w_scale = torch.max(w.detach())
    loss = mc._loss("kl", w, aux, w_scale, alphas)
    grads = torch.autograd.grad(loss, [p for m in models for p in m.parameters()])

    gen = torch.Generator().manual_seed(6)
    zs = [torch.rand((MB, 10), generator=gen, dtype=torch.float32).double() for _ in range(2)]
    p64 = [{k: v.double().requires_grad_(not k.endswith((".mean", ".var")))
            for k, v in p.items()} for p in p0]
    w_r, q_r, _, _ = ref.mixture(p64, d.plan, d.proc, alphas, zs)
    loss_r = ref.kl_loss(w_r, q_r, w_scale, alphas, MB)
    _close(loss.detach(), loss_r.detach())
    names = [(c, n) for c, m in enumerate(models) for n, _ in m.named_parameters()]
    grads_r = torch.autograd.grad(loss_r, [p64[c][n] for c, n in names])
    scale = max(float(torch.linalg.vector_norm(g)) for g in grads_r)
    for (c, n), g, g_r in zip(names, grads, grads_r):
        assert float(torch.linalg.vector_norm(g - g_r)) <= RTOL * scale, (c, n)


def _program_call(d, p0, seed, alphas0):
    """A 2-epoch call in float64: the result and the first step's
    gradient, the first moment after it over 1 - beta1."""
    grad = {}

    def factory(params):
        tr = d.cfg["training"]
        opt = optimizers.adamax(tr["lr"], tr["weight_decay"])(params)

        def first(opt, *_):
            if not grad:
                b1 = opt.param_groups[0]["betas"][0]
                grad.update({id(p): opt.state[p]["exp_avg"].clone() / (1 - b1)
                             for p in opt.param_groups[0]["params"]})
        opt.register_step_post_hook(first)
        return opt

    points = []

    def keep(module, args, output):
        if isinstance(module, FlowModel):
            points.append(output[0].detach())

    tr = d.cfg["training"]
    handle = torch.nn.modules.module.register_module_forward_hook(keep)
    try:
        out = mc.train_multichannel(
            d.channels, _models(d, p0), d.me, d.proc.e_cm, factory,
            torch.Generator().manual_seed(seed), alphas=alphas0, batch_per_channel=B,
            epochs=2, loss_mode="kl", learn_alphas=True, alpha_damping=tr["alpha_damping"],
            alpha_floor=tr["alpha_floor"], mini_batch_per_channel=MB, epochs_per_call=2,
            **d.cuts)
    finally:
        handle.remove()
    return {"loss": list(out["history"]["loss"]), "integral": list(out["history"]["integral"]),
            "ess": list(out["history"]["ess"]),
            "alphas": [torch.as_tensor(a) for a in out["history"]["alphas"]],
            "grad": {f"{c}.{n}": grad[id(p)] for c, m in enumerate(out["params"])
                     for n, p in m.named_parameters()},
            "params": {f"{c}.{n}": p.detach() for c, m in enumerate(out["params"])
                       for n, p in m.named_parameters()},
            # the first epoch's source points, after the pilot's
            "x": points[2:2 + 2 * (B // MB)]}


@pytest.fixture(scope="module")
def two_epochs(cell):
    """The program's 2-epoch call and the reference's, float64."""
    d, p0 = cell
    alphas0 = np.array([0.55, 0.45])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mc, "_uniform", lambda gen, shape, dtype, device: torch.rand(
            shape, generator=gen, dtype=torch.float32, device=device).to(dtype))
        out = _program_call(d, p0, 11, alphas0)
    args = (p0, d.plan, d.proc, [11], [2], alphas0, d.train_cfg(), torch.device("cpu"))
    reference = ref.train_outputs(*args)
    faults = {f: ref.train_outputs(*args, fault=f) for f in ref.FAULTS}
    p_flat = {k: v.double() for k, v in d.flat_p0().items()}
    return out, reference, faults, p_flat


def test_two_epoch_call_matches(two_epochs):
    out, reference, _, p_flat = two_epochs
    for key in ("loss", "integral", "ess"):
        _close(out[key], reference[key])
    _close(torch.stack(out["alphas"]), torch.stack(reference["alphas"]))
    assert not torch.allclose(reference["alphas"][0], reference["alphas"][1])   # they move
    nums = drv.numbers(out, reference, p_flat)
    for key in ("loss_gap", "grad_gap", "change_gap", "alpha_gap", "x_rms"):
        assert nums[key] < 1e-7, (key, nums[key])
    # every parameter moved, by the reference's amount
    for k, v in reference["params"].items():
        assert float(torch.max(torch.abs(v - p_flat[k]))) > 0, k
        _close(out["params"][k] - p_flat[k], v - p_flat[k], 1e-6)


@pytest.mark.parametrize("fault", ref.FAULTS)
def test_each_planted_fault_fails_the_cell_limits(two_epochs, fault):
    """Each fault, planted in the float64 reference put in the program's
    place, reads beyond a limit of the cell's, and beyond a thousand times
    the program's own reading there."""
    out, reference, faults, p_flat = two_epochs
    limits = json.loads(open(os.path.join(ROOT, "benchmark", "workloads",
                                          f"{CELL}.json")).read())["limits"]
    sound = drv.numbers(out, reference, p_flat)
    broken = drv.numbers(faults[fault], reference, p_flat)
    failed = [k for k in limits if k != "x_rms" and broken[k] > limits[k]
              and broken[k] > 1e3 * sound[k]]
    assert failed, broken


def test_the_cell_on_the_cpu():
    """The harness's run of the cell at the small size, the program in
    float32: the check passes, and the counters read the derived values
    (a call: one chunk's four history rows and three reads at its end; per
    epoch C^2 = 4 inverses a minibatch, and the pilot's 4 over a call's 2
    epochs)."""
    torch.set_num_threads(2)
    spec = _spec()
    ctx = harness.Ctx(spec, SEED + 2, torch.device("cpu"))
    d = drv.Driver(ctx)
    d.setup()
    recs = []
    for i in range(2):
        rec = d.call(i)
        recs.append(dict(rec, t0=float(i), t1=i + 1.0))
    run = harness.Run(spec, ctx, d, 1.0, 0.0, recs)
    read = {m: spec.load("metrics", m).read(run) for m in
            ("flow_inverses_per_epoch.mc", "host_reads_per_call.mc", "job_samples_per_s",
             "mfu_pct.mc")}
    assert read["host_reads_per_call.mc"] == 4 + 3
    assert read["flow_inverses_per_epoch.mc"] == 4 * (B // MB) + 4 / 2
    assert read["job_samples_per_s"] == 2 * (2 * 2 * B) / 2.0   # 2 calls in 2 s
    assert read["mfu_pct.mc"] > 0
    d.free()
    compared = d.check()
    assert all(v <= lim for _, v, lim in compared), compared
