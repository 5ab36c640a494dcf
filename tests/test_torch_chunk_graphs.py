"""The chunked trainer's CUDA graphs, on the card.

Imports neither JAX nor nf_tpu, so it runs on the card with
``python -m pytest --noconftest tests/test_torch_chunk_graphs.py``; without a
card every test skips.  A chunk replays the epoch and the refresh as CUDA
graphs (``_graphs`` left to the manager's rule); the same chunk run eagerly
(``_graphs=False``, the same update kernel) must give the same bits and the
same kernel launch counts, and a capture that fails raises.  The update
kernel (``ops/optim_step``) must take torch's per-epoch Adamax / Adam step's
bits, so the graph chunk at the default cadence equals the
``epochs_per_sync=1`` run bit for bit.
"""

import pytest
import torch

from nf_tpu_torch import PWQuadManager
from nf_tpu_torch.ops import optim_step
from nf_tpu_torch.ops import pwquad_train as pt
from nf_tpu_torch.training import optimizers


def camel(x):
    return (torch.exp(-((x[:, 0] - 0.75) ** 2 + (x[:, 1] - 0.75) ** 2) / 0.04)
            + torch.exp(-((x[:, 0] - 0.25) ** 2 + (x[:, 1] - 0.25) ** 2) / 0.04))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the chunk replays CUDA graphs")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def train(f, graphs, bn_stats="stale", epochs=6):
    NF = PWQuadManager(n_flow=2, seed=5, device="cuda")
    NF.create_model(2, 4, [3] * 3)
    pt.FWD_LAUNCHES = pt.BWD_LAUNCHES = 0
    NF._train_variance_forward_seq(
        f, optimizers.adamax(2e-3, 1e-4), log=False, batch_size=4096, epochs=epochs,
        mini_batch_size=2048, preburn_time=2, kill_counter=100, pretty_progressbar=False,
        bn_stats=bn_stats, stats_every=4, epochs_per_sync=3, _graphs=graphs)
    torch.cuda.synchronize()
    return NF, (pt.FWD_LAUNCHES, pt.BWD_LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("bn_stats", ["batch", "stale"])
def test_replays_equal_eager_epochs(cuda, bn_stats):
    """Epoch 0 runs eagerly and is captured, epochs 1-5 are replays (the
    refresh of epoch 4 too): the history, the model, the best model and the
    generator equal the eager chunk's, and the launches a replay adds equal
    the eager launches (two minibatches a step, one refresh in two)."""
    graph, launches = train(camel, None, bn_stats)
    eager, launches_e = train(camel, False, bn_stats)
    assert graph.history == eager.history and graph.best_epoch == eager.best_epoch
    for a, b in ((graph._model, eager._model), (graph.best_model, eager.best_model)):
        sa, sb = a.state_dict(), b.state_dict()
        assert all(torch.equal(sa[n], sb[n]) for n in sa)
    assert torch.equal(graph._gen.get_state(), eager._gen.get_state())
    expected = (12 + 2, 12) if bn_stats == "stale" else (0, 0)
    assert launches == launches_e == expected


@pytest.mark.cuda
def test_profiles_after_a_capture_hold_every_kernel(cuda):
    """After the chunk has captured its graphs, a ``torch.profiler`` trace of
    a call of three kernels holds all three, trace after trace (CUPTI torn
    down and set up again between traces dropped some or all of them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    train(camel, None)
    x = torch.rand(1 << 20, device=cuda)
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ((x * 2.0) + 1.0).sqrt()
            torch.cuda.synchronize()
        kernels = [e.name() for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
        assert len(kernels) == 3, kernels


@pytest.mark.cuda
def test_failed_capture_raises(cuda):
    """An integrand that syncs the host cannot be captured: the trainer
    raises rather than run the chunk another way, naming the integrand's
    call and the per-epoch cadence."""
    def syncing(x):
        return camel(x) * float(x[0, 0] >= 0)

    with pytest.raises(RuntimeError) as info:
        train(syncing, None, epochs=4)
    assert "float(x[0, 0] >= 0)" in str(info.value) and "epochs_per_sync=1" in str(info.value)


def train_camel(bn_stats, optimizer, **kw):
    NF = PWQuadManager(n_flow=2, seed=0, device="cuda")
    NF.create_model(2, 4, [3] * 3)
    NF._train_variance_forward_seq(
        camel, optimizer(2e-3, 1e-4), log=False, batch_size=4000, epochs=40,
        mini_batch_size=2000, preburn_time=12, pretty_progressbar=False, bn_stats=bn_stats, **kw)
    torch.cuda.synchronize()
    return NF


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["adamax", "adam"])
@pytest.mark.parametrize("bn_stats", ["batch", "stale"])
def test_default_equals_per_epoch_run(cuda, bn_stats, optimizer):
    """The default cadence on the card (chunks of 12 epochs, replayed
    graphs, the update kernel) against ``epochs_per_sync=1`` (torch's own
    step): everything the run leaves, bit for bit, the optimizer's ``step``
    on the CPU in both."""
    opt = getattr(optimizers, optimizer)
    optim_step.LAUNCHES = 0
    graph = train_camel(bn_stats, opt)
    assert graph._bench[6]["graphs"] and graph._bench[7]
    assert optim_step.LAUNCHES == graph._last_epoch + 1
    ref = train_camel(bn_stats, opt, epochs_per_sync=1)
    assert graph.history == ref.history
    assert (graph.best_epoch, graph._last_epoch) == (ref.best_epoch, ref._last_epoch)
    for a, b in ((graph._model, ref._model), (graph.best_model, ref.best_model)):
        sa, sb = a.state_dict(), b.state_dict()
        assert all(torch.equal(sa[n], sb[n]) for n in sa)
    sa, sb = graph._optimizer.state_dict(), ref._optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i in sb["state"]:
        assert list(sa["state"][i]) == list(sb["state"][i])
        assert sa["state"][i]["step"].device.type == "cpu"
        assert all(torch.equal(sa["state"][i][k], sb["state"][i][k]) for k in sb["state"][i])
    assert torch.equal(graph._gen.get_state(), ref._gen.get_state())


@pytest.mark.cuda
@pytest.mark.parametrize("weight_decay", [0.0, 1e-4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("adam", [False, True])
def test_update_kernel_equals_torch_step(cuda, adam, dtype, weight_decay):
    """200 steps of the update kernel against torch.optim's step (foreach,
    not capturable) and against its plain version, on 60 parameters of
    sizes 1 - 5000 (two launches a step): bit for bit after every step,
    gradients across 30 decades with zeros and, every 40th step, subnormal
    ones (``optim_step.compare_with_torch``, as ``chip_smoke.py`` holds it
    at the plans' shapes)."""
    sizes = [6, 3, 18, 3, 12, 4, 1000, 33, 5000, 1] + [7] * 50
    differ, _, taken = optim_step.compare_with_torch(
        [(n,) for n in sizes], adam=adam, weight_decay=weight_decay, steps=200, dtype=dtype,
        device=cuda, seed=3)
    assert differ == 0 and taken == 200


# One step past the tables, in a process of its own: the kernel traps, which
# leaves that process's CUDA context unusable
_PAST_THE_TABLES = """
import torch
from nf_tpu_torch.ops import optim_step
p = [torch.zeros(5, device="cuda")]
g = [torch.ones(5, device="cuda")]
m, u = [torch.zeros_like(p[0])], [torch.zeros_like(p[0])]
tables = optim_step.step_tables(2e-3, (0.9, 0.999), 3, ADAM, "cuda")
step = torch.zeros(1, dtype=torch.int64, device="cuda")
for _ in range(3):
    optim_step.update(p, g, m, u, step, tables, adam=ADAM, beta1=0.9, beta2=0.999, eps=1e-8,
                      weight_decay=0.0)
torch.cuda.synchronize()
print("THREE STEPS", flush=True)
optim_step.update(p, g, m, u, step, tables, adam=ADAM, beta1=0.9, beta2=0.999, eps=1e-8,
                  weight_decay=0.0)
torch.cuda.synchronize()
print("PAST THE TABLES", flush=True)
"""


@pytest.mark.cuda
@pytest.mark.parametrize("adam", [False, True])
def test_update_kernel_traps_past_its_tables(cuda, adam):
    """The kernel is told the tables' length: the step after their last
    entry fails its launch, and the synchronisation after it raises, where
    reading past the tables would write wrong parameters silently."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _PAST_THE_TABLES.replace("ADAM", str(adam))],
                         cwd=root, capture_output=True, text=True, timeout=600)
    assert "THREE STEPS" in out.stdout, out.stderr[-2000:]
    assert out.returncode != 0 and "PAST THE TABLES" not in out.stdout
    assert "CUDA error" in out.stderr or "cudaError" in out.stderr, out.stderr[-2000:]


@pytest.mark.cuda
def test_device_step_coverage(cuda):
    """The optimizers the update kernel covers, and those that keep torch's
    capturable step."""
    def params():
        return [torch.zeros(3, device=cuda, requires_grad=True)]

    assert optimizers.device_step(optimizers.adamax(1e-3)(params()), 5) is not None
    assert optimizers.device_step(optimizers.adam(1e-3, 1e-4)(params()), 5) is not None
    for opt in (torch.optim.Adam(params(), amsgrad=True), torch.optim.SGD(params(), lr=0.1),
                torch.optim.Adamax(params(), maximize=True),
                torch.optim.Adamax(params(), foreach=False),
                torch.optim.Adam([{"params": params()}, {"params": params(), "lr": 0.1}]),
                torch.optim.Adamax([torch.zeros(3, dtype=torch.float16, device=cuda,
                                                requires_grad=True)])):
        assert optimizers.device_step(opt, 5) is None
