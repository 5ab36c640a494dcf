"""The chunked trainer's optimizer update (``nf_tpu_torch.ops.optim_step``)
and the trainer's default cadence, on the CPU.

The update kernel reads each step's scalars from float64 tables: those must
be the scalars torch's Adamax / Adam step computes on the host, bit for bit.
The plain version (torch's foreach operations driven by the tables) must
take torch's own step's bits, and agree with nf_tpu's optax update at the
tolerances of tests/test_torch_manager.py.  The port's default
``epochs_per_sync`` is nf_tpu's, and a run at the default equals the
per-epoch run bit for bit.  The kernel itself runs on the card only
(tests/test_torch_chunk_graphs.py).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf_tpu import PWQuadManager as JPWQuadManager
from nf_tpu.training import optimizers as joptim
from nf_tpu_torch import PWQuadManager
from nf_tpu_torch.ops import optim_step
from nf_tpu_torch.training import manager as tmanager
from nf_tpu_torch.training import optimizers as toptim
from test_torch_chunked import BASE, STOPS, assert_same_run, camel_t
from test_torch_chunked import train as train_chunked

torch.set_num_threads(1)

SHAPES = ((3, 4), (7,), (1,), (16, 2))


def _record(monkeypatch, name, index):
    """Record argument ``index`` of every call of ``torch.<name>``."""
    seen, real = [], getattr(torch, name)

    def spy(*args, **kwargs):
        seen.append(args[index])
        return real(*args, **kwargs)

    monkeypatch.setattr(torch, name, spy)
    return seen


@pytest.mark.parametrize("adam", [False, True])
@pytest.mark.parametrize("lr, betas", [(2e-3, (0.9, 0.999)), (1e-2, (0.8, 0.99)),
                                       (3.7e-4, (0.95, 0.9999))])
def test_tables_equal_torch_host_scalars(monkeypatch, adam, lr, betas):
    """Steps 1 .. 10^4 of torch's foreach step: the step size it hands
    ``_foreach_addcdiv_`` and Adam's ``sqrt(1 - b2**t)`` it hands
    ``_foreach_div_`` equal the tables' entries bit for bit."""
    t_max = 10_000
    p = torch.zeros(2, dtype=torch.float64, requires_grad=True)
    make = torch.optim.Adam if adam else torch.optim.Adamax
    opt = make([p], lr=lr, betas=betas, foreach=True)
    sizes = _record(monkeypatch, "_foreach_addcdiv_", 3)
    divs = _record(monkeypatch, "_foreach_div_", 1)
    p.grad = torch.ones(2, dtype=torch.float64)
    for _ in range(t_max):
        opt.step()
    step_size, bc2_sqrt = optim_step.step_tables(lr, betas, t_max, adam, "cpu")
    assert [s[0] for s in sizes] == step_size[1:].tolist()
    if adam:
        assert [d[0] for d in divs] == bc2_sqrt[1:].tolist()
    else:
        assert bc2_sqrt is None


def _params(rng, dtype):
    return [torch.tensor(rng.standard_normal(s) * 0.3, dtype=dtype, requires_grad=True)
            for s in SHAPES]


def _grads(rng, params, step):
    """Gradients across 30 decades, with zeros; every 25th step subnormal
    ones in float32."""
    low = -44 if step % 25 == 0 else -8
    out = []
    for p in params:
        g = rng.standard_normal(p.shape) * 10.0 ** rng.uniform(low, 1)
        g[rng.random(p.shape) < 0.1] = 0
        out.append(torch.tensor(g, dtype=p.dtype))
    return out


@pytest.mark.parametrize("weight_decay", [0.0, 1e-4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("adam", [False, True])
def test_plain_update_equals_torch_step(adam, dtype, weight_decay):
    """100 steps of the plain update (what the wrapper runs on CPU tensors)
    against ``torch.optim.Adamax`` / ``Adam``'s own step: parameters and
    moments bit for bit after every step."""
    rng = np.random.default_rng(7)
    params = _params(rng, dtype)
    mine = [p.detach().clone() for p in params]
    make = (toptim.adam if adam else toptim.adamax)(2e-3, weight_decay)
    opt = make(params)
    m = [torch.zeros_like(p) for p in mine]
    v = [torch.zeros_like(p) for p in mine]
    step = torch.zeros(1, dtype=torch.int64)
    tables = optim_step.step_tables(2e-3, (0.9, 0.999), 100, adam, "cpu")
    second = "exp_avg_sq" if adam else "exp_inf"
    for t in range(1, 101):
        grads = _grads(rng, params, t)
        for p, g in zip(params, grads):
            p.grad = g.clone()
        opt.step()
        optim_step.update(mine, grads, m, v, step, tables, adam=adam, beta1=0.9, beta2=0.999,
                          eps=1e-8, weight_decay=weight_decay)
        for p, q, mm, vv in zip(params, mine, m, v):
            assert torch.equal(p.detach(), q)
            assert torch.equal(opt.state[p]["exp_avg"], mm)
            assert torch.equal(opt.state[p][second], vv)
    assert int(step) == 100


@pytest.mark.parametrize("adam", [False, True])
def test_update_past_its_tables_raises(adam):
    """The tables hold steps 1..t_max: the step after them raises on CPU
    tensors, as the kernel traps on the card
    (tests/test_torch_chunk_graphs.py), and leaves the parameters as they
    were."""
    p, g = [torch.zeros(4)], [torch.ones(4)]
    m, v = [torch.zeros(4)], [torch.zeros(4)]
    step = torch.zeros(1, dtype=torch.int64)
    tables = optim_step.step_tables(2e-3, (0.9, 0.999), 2, adam, "cpu")
    hyper = dict(adam=adam, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0)
    for _ in range(2):
        optim_step.update(p, g, m, v, step, tables, **hyper)
    before = p[0].clone()
    with pytest.raises(IndexError):
        optim_step.update(p, g, m, v, step, tables, **hyper)
    assert torch.equal(p[0], before) and int(step) == 2


@pytest.mark.parametrize("weight_decay", [0.0, 1e-4])
@pytest.mark.parametrize("adam", [False, True])
def test_plain_update_matches_nf_tpu(adam, weight_decay):
    """Three updates of the plain version against nf_tpu's optax update in
    float64, at tests/test_torch_manager.py's tolerances (Adamax 1e-10,
    Adam 1e-12)."""
    rng = np.random.RandomState(2)
    p0 = {"a": rng.standard_normal(5), "b": rng.standard_normal((2, 3))}
    grads = [{k: rng.standard_normal(v.shape) * 10.0 ** -i for k, v in p0.items()}
             for i in range(3)]
    opt_j = (joptim.adam if adam else joptim.adamax)(2e-3, weight_decay)
    pj = jax.tree.map(jnp.asarray, p0)
    state = opt_j.init(pj)
    mine = [torch.tensor(v) for v in p0.values()]
    m = [torch.zeros_like(p) for p in mine]
    v = [torch.zeros_like(p) for p in mine]
    step = torch.zeros(1, dtype=torch.int64)
    tables = optim_step.step_tables(2e-3, (0.9, 0.999), 3, adam, "cpu")
    for g in grads:
        upd, state = opt_j.update(jax.tree.map(jnp.asarray, g), state, pj)
        pj = jax.tree.map(lambda a, u: a + u, pj, upd)
        optim_step.update(mine, [torch.tensor(g[k]) for k in p0], m, v, step, tables,
                          adam=adam, beta1=0.9, beta2=0.999, eps=1e-8,
                          weight_decay=weight_decay)
    for k, q in zip(p0, mine):
        assert not np.allclose(q.numpy(), p0[k])
        np.testing.assert_allclose(q.numpy(), np.asarray(pj[k]), rtol=1e-12 if adam else 1e-10)


@pytest.mark.parametrize("adam", [False, True])
def test_device_step_equals_torch_step(adam):
    """The trainer's :class:`DeviceStep` (its plain path on CPU tensors):
    60 steps, a save after 20 and a restore after 40 replayed, then
    ``write_steps``: the optimizer's whole state dict equals torch's own
    run's, ``step`` included, and the tables end where they were made to."""
    rng = np.random.default_rng(11)
    a = _params(rng, torch.float32)
    b = [p.detach().clone().requires_grad_(True) for p in a]
    make = (toptim.adam if adam else toptim.adamax)(2e-3, 1e-4)
    ref, opt = make(a), make(b)
    stepper = toptim.DeviceStep(opt, 0, 60)
    grads = [_grads(rng, a, t) for t in range(60)]
    for t in range(60):
        for p, g in zip(a, grads[t]):
            p.grad = g.clone()
        ref.step()
    saved, replayed, t = None, False, 0
    while t < 60:
        if t == 20 and not replayed:
            saved = ([p.detach().clone() for p in b], [
                {k: x.clone() for k, x in opt.state[p].items()} for p in b], stepper.save())
        if t == 40 and not replayed:   # replay 20 .. 39 from the save
            with torch.no_grad():
                for p, s, st in zip(b, saved[0], saved[1]):
                    p.copy_(s)
                    for k, x in st.items():
                        opt.state[p][k].copy_(x)
            stepper.restore(saved[2])
            replayed, t = True, 20
        stepper.advance(1)
        for p, g in zip(b, grads[t]):
            p.grad = g.clone()
        stepper.step()
        t += 1
    stepper.write_steps()
    sa, sb = ref.state_dict(), opt.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i in sa["state"]:
        assert list(sa["state"][i]) == list(sb["state"][i])
        for k in sa["state"][i]:
            assert sa["state"][i][k].dtype == sb["state"][i][k].dtype
            assert torch.equal(sa["state"][i][k], sb["state"][i][k])
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    with pytest.raises(ValueError, match="tables hold steps up to 60"):
        stepper.advance(1)


def test_device_step_is_for_the_card():
    """``device_step`` covers parameters on a CUDA device only: on the CPU the
    chunk steps through the optimizer itself."""
    params = _params(np.random.default_rng(0), torch.float32)
    assert toptim.device_step(toptim.adamax(2e-3)(params), 10) is None


def test_default_epochs_per_sync_is_nf_tpus():
    def default(cls):
        return inspect.signature(cls._train_variance_forward_seq) \
            .parameters["epochs_per_sync"].default

    assert default(PWQuadManager) == default(JPWQuadManager) == "auto"


def camel(x):
    return (torch.exp(-((x[:, 0] - 0.75) ** 2 + (x[:, 1] - 0.75) ** 2) / 0.04)
            + torch.exp(-((x[:, 0] - 0.25) ** 2 + (x[:, 1] - 0.25) ** 2) / 0.04))


@pytest.mark.parametrize("bn_stats", ["batch", "stale"])
def test_default_run_equals_per_epoch(bn_stats):
    """A run at the default cadence (one chunk of 24 epochs here) equals the
    ``epochs_per_sync=1`` run bit for bit: histories, best and stop epochs,
    model, best model, optimizer state and generator."""
    runs = []
    for kw in ({}, {"epochs_per_sync": 1}):
        NF = PWQuadManager(n_flow=2, seed=4, device="cpu")
        NF.create_model(2, 4, [3] * 3)
        NF._train_variance_forward_seq(camel, toptim.adamax(5e-3, 1e-4), log=False,
                                       batch_size=1024, mini_batch_size=512, epochs=24,
                                       preburn_time=6, pretty_progressbar=False,
                                       bn_stats=bn_stats, **kw)
        runs.append(NF)
    a, b = runs
    assert a._bench[6]["k0"] == 24 and b._bench[6] is None
    assert a.history == b.history and len(a.history) == 24
    assert (a.best_epoch, a._last_epoch, a.best_loss) == (b.best_epoch, b._last_epoch, b.best_loss)
    for x, y in ((a._model, b._model), (a.best_model, b.best_model)):
        sx, sy = x.state_dict(), y.state_dict()
        assert all(torch.equal(sx[n], sy[n]) for n in sx)
    sa, sb = a._optimizer.state_dict(), b._optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"] and sa["state"].keys() == sb["state"].keys()
    assert all(torch.equal(sa["state"][i][k], sb["state"][i][k])
               for i in sa["state"] for k in sa["state"][i])
    assert torch.equal(a._gen.get_state(), b._gen.get_state())


@pytest.fixture
def device_step_on_cpu(monkeypatch):
    """The manager's chunk stepping through :class:`DeviceStep` on CPU
    parameters, whose wrapper runs the plain version there: on the card the
    same path launches the update kernel (``device_step`` takes CUDA
    parameters only)."""
    def make(optimizer, steps):
        params = list(optimizer.param_groups[0]["params"])
        return toptim.DeviceStep(optimizer, toptim._steps_taken(optimizer, params), steps)

    monkeypatch.setattr(tmanager, "device_step", make)


@pytest.mark.parametrize("bn_stats", ["batch", "stale"])
@pytest.mark.parametrize("scenario", ["kill", "stale_check"])
def test_device_step_chunk_stops_as_per_epoch(device_step_on_cpu, scenario, bn_stats):
    """A chunked run through the device step, stopped inside a chunk (the
    chunk replayed from its start, the step count restored), leaves what
    the per-epoch run with torch's own step leaves, optimizer state and
    ``step`` included; ``benchmark_train_step`` steps a bench copy through
    a device step of its own."""
    kw, seed, k, stop = STOPS[scenario][bn_stats]
    ref, _ = train_chunked(1, bn_stats, seed=seed, **kw)
    NF, _ = train_chunked(k, bn_stats, seed=seed, **kw)
    assert NF._bench[7] and not ref._bench[7]
    assert ref._last_epoch == stop and stop % k != k - 1, "the stop must fall inside a chunk"
    assert_same_run(NF, ref)
    sec, _ = NF.benchmark_train_step(reps=1)
    assert sec > 0


@pytest.mark.parametrize("bn_stats", ["batch", "stale"])
def test_device_step_chunk_resume_equals_per_epoch(device_step_on_cpu, tmp_path, bn_stats):
    """7 chunked epochs through the device step, saved (``step`` written
    back to the CPU state), then 9 more resumed through a device step made
    from that state, equal 16 per-epoch epochs of torch's own step."""
    kw = dict(integrate=False, preburn_time=2, kill_counter=100)
    full, _ = train_chunked(1, bn_stats, epochs=16, **kw)
    part, _ = train_chunked(3, bn_stats, epochs=7, **kw)
    part.save_training_state(tmp_path / "state.pt")
    NF = PWQuadManager(n_flow=2, seed=3, dtype=torch.float64, device="cpu")
    NF.create_model(2, 4, [4] * 2)
    NF._train_variance_forward_seq(camel_t, toptim.adamax(1e-2, 1e-4), epochs_per_sync=3,
                                   epochs=9, epoch_start=7, resume_from=tmp_path / "state.pt",
                                   **dict(BASE, bn_stats=bn_stats, **kw))
    assert NF._bench[7]
    assert_same_run(NF, full)
