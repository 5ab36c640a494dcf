"""Two gloo processes on localhost: the port's data parallelism across a real
process boundary (CPU, float64), the analogue of tests/test_distributed.py.

One module-scoped spawn runs every check's worker side.  The workers import
only torch, numpy and nf_tpu_torch; the parent computes nf_tpu's results on
a 2-device mesh of conftest's fake CPU devices and hands the workers nf_tpu's
parameters and draws as ``.npz`` files.  Held:

  * an all-reduce across the processes (1 + 2 = 3);
  * ``make_dp_loss``'s loss, gradients, BatchNorm state, integral and error
    against nf_tpu's ``make_dp_loss`` at tests/test_dp_shard_map.py's
    tolerances (a world of two: a gradient off by the world size fails);
  * one ``make_dp_train_step`` with Adamax against nf_tpu's;
  * ``dp_sample`` and ``dp_integrate`` against nf_tpu's on nf_tpu's
    per-device draws, replayed through ``flows.sampling._uniform``;
  * both trainers at the default cadence and at ``epochs_per_sync=1``,
    ``sample``, ``integrate`` and ``generate_unweighted`` under ``mesh=``
    and two epochs of ``train_multichannel`` against the
    single-process port (``mesh=None``) on the same seeds, at rtol 1e-8
    (1e-6 where the port computes in float32: the stale trainer's map and
    the unweighter's proposals).

The subprocesses and the process group have their own timeouts, so a hang
fails the test.
"""

import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nf_tpu.flows import factory as jfactory
from nf_tpu.parallel import (dp_integrate as jdp_integrate, dp_sample as jdp_sample,
                             make_dp_loss as jmake_dp_loss,
                             make_dp_train_step as jmake_dp_train_step, make_mesh as jmake_mesh)
from nf_tpu.training import optimizers as joptim
from nf_tpu_torch import interop

# the scenarios both sides run, the workers under a mesh and the parent
# without one
COMMON = textwrap.dedent("""
    import numpy as np
    import torch

    from nf_tpu_torch import PWQuadManager
    from nf_tpu_torch.phasespace import lorentz
    from nf_tpu_torch.phasespace.topology import BreitWignerSMap, ResonanceDecayPhasespace
    from nf_tpu_torch.training import multichannel as mc
    from nf_tpu_torch.training import optimizers, unweight

    torch.set_num_threads(1)


    def camel(x):
        return (torch.exp(-((x[:, 0] - 0.75) ** 2 + (x[:, 1] - 0.75) ** 2) / 0.04)
                + torch.exp(-((x[:, 0] - 0.25) ** 2 + (x[:, 1] - 0.25) ** 2) / 0.04))


    def mixture():
        def pair(mass, width, a, b):
            return {p: BreitWignerSMap(mass, width) for p in (a, b)}

        channels = [ResonanceDecayPhasespace([0.0, 0.0], [0.0] * 4, ((0, 1), (2, 3)),
                                             mass_maps=pair(91.188, 2.4952, (0, 1), (2, 3))),
                    ResonanceDecayPhasespace([0.0, 0.0], [0.0] * 4, ((0, 2), (1, 3)),
                                             mass_maps=pair(180.0, 8.0, (0, 2), (1, 3)))]

        def me(m):
            f = m[:, 2:, :]

            def bw(i, j, mass, width):
                s = lorentz.square(f[:, i] + f[:, j])
                return 1e4 / ((s - mass ** 2) ** 2 + (mass * width) ** 2)

            return (bw(0, 1, 91.188, 2.4952) * bw(2, 3, 91.188, 2.4952)
                    + 300.0 * bw(0, 2, 180.0, 8.0) * bw(1, 3, 180.0, 8.0))

        return channels, me


    def scenarios(mesh):
        out = {}
        # the per-epoch cadence (keys "per_epoch.*"), then the default
        for cadence, tag in ((1, "per_epoch."), ("auto", "")):
            for bn_stats in ("stale", "batch"):
                NF = PWQuadManager(n_flow=2, seed=0, dtype=torch.float64, device="cpu")
                NF.create_model(2, 4, [4] * 2)
                NF._train_variance_forward_seq(
                    camel, optimizers.adamax(2e-3, 1e-4), log=False, batch_size=256, epochs=6,
                    mini_batch_size=128, preburn_time=2, integrate=True,
                    pretty_progressbar=False, bn_stats=bn_stats, stats_every=2, mesh=mesh,
                    epochs_per_sync=cadence)
                key = tag + bn_stats
                out[key + ".history"] = np.array(NF.history)
                out[key + ".integ_hist"] = NF._integ_hist
                out[key + ".result"] = np.array([NF.integ_tot, NF.err_tot])
                for k, v in NF.best_model.state_dict().items():
                    out[key + ".best." + k] = v.numpy()
        x, jac = NF.sample(256, seed=4, method="folded", mesh=mesh)
        out["sample.x"], out["sample.jac"] = x.numpy(), jac.numpy()
        out["integrate"] = np.array(NF.integrate(camel, 3, 256, seed=5, method="folded",
                                                 mesh=mesh))
        ev, wts, info = unweight.generate_unweighted(
            NF._flow, NF.best_model, camel, torch.Generator().manual_seed(6), 400, batch=512,
            wmax_quantile=0.95, partial_unweight=True, method="folded", compact=False,
            mesh=mesh)
        out["unweight.events"], out["unweight.weights"] = ev, wts
        out["unweight.info"] = np.array([info["eff"], info["w_max"], info["n_overweight"]])
        channels, me = mixture()
        models = mc.build_channel_flows(torch.Generator().manual_seed(1), channels, 2, 4, [8],
                                        dtype=torch.float64, device="cpu")
        res = mc.train_multichannel(
            channels, models, me, 400.0, optimizers.adamax(5e-3, 1e-4),
            torch.Generator().manual_seed(3), alphas=[0.4, 0.6], batch_per_channel=32,
            mini_batch_per_channel=16, epochs=2, loss_mode="kl", pT_mincut=5.0,
            delR_mincut=0.2, rap_maxcut=3.0, mesh=mesh)
        for k, v in res["history"].items():
            out["mc." + k] = v
        for i, m in enumerate(res["params"]):
            for k, v in m.state_dict().items():
                out[f"mc.params.{i}.{k}"] = v.numpy()
        return out
""")

WORKER = COMMON + textwrap.dedent("""
    import sys

    import torch.distributed as dist

    from nf_tpu_torch.flows import factory
    from nf_tpu_torch.flows import sampling as fsampling
    from nf_tpu_torch.parallel import (dp_integrate, dp_sample, initialize_distributed,
                                       make_dp_loss, make_dp_train_step)
    from nf_tpu_torch.parallel.dp import average_gradients
    from nf_tpu_torch.parallel.mesh import group_of, shard_rows

    coord, rank, outdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    mesh = initialize_distributed(coord, 2, rank, device="cpu", timeout=60)
    group = group_of(mesh)
    inp = dict(np.load(outdir + "/inputs.npz"))
    out = {}

    total = torch.tensor([float(rank + 1)])
    dist.all_reduce(total)
    out["psum"] = total.numpy()


    def model():
        m = factory.build_pwquad_flow(torch.Generator(), 2, 2, 4, (4, 4), torch.float64, "cpu")
        m.load_state_dict({k[3:]: torch.from_numpy(v) for k, v in inp.items()
                           if k.startswith("sd.")})
        return m


    w = shard_rows(torch.from_numpy(inp["w"]), group)
    maxf = torch.tensor(2.0, dtype=torch.float64)
    m = model()
    loss, (integ, err) = make_dp_loss(m.flow, camel, mesh, maxf)(m, w)
    loss.backward()
    average_gradients(m.parameters(), group)
    out["loss"] = np.array([loss.item(), integ.item(), err.item()])
    for k, p in m.named_parameters():
        out["grad." + k] = p.grad.numpy()
    for k, b in m.named_buffers():
        out["bn." + k] = b.numpy()

    m = model()
    make_dp_train_step(m.flow, camel, mesh, maxf, optimizers.adamax(1e-3)(m.parameters()))(m, w)
    for k, p in m.named_parameters():
        out["step." + k] = p.detach().numpy()

    # nf_tpu's per-device draws, concatenated in device order
    uniform = fsampling._uniform
    draws = [inp["sample_w"]] + list(inp["integ_w"])

    def replay(generator, shape, dtype, device):
        a = draws.pop(0)
        assert tuple(shape) == a.shape and dtype == torch.float64
        return torch.from_numpy(a)

    fsampling._uniform = replay
    m = model()
    x, jac = dp_sample(m.flow, m, mesh, 256, seed=7, method="folded", dtype=torch.float64)
    out["dp_sample.x"], out["dp_sample.jac"] = x.numpy(), jac.numpy()
    out["dp_integrate"] = np.array(dp_integrate(m.flow, m, camel, mesh, 3, 256, seed=5,
                                                method="folded", dtype=torch.float64))
    assert not draws
    fsampling._uniform = uniform

    out.update(scenarios(mesh))
    np.savez(f"{outdir}/worker{rank}.npz", **out)
    dist.destroy_process_group()
    print(f"DPWORKER_{rank}_OK", flush=True)
""")


def camel_j(x):
    return (jnp.exp(-((x[:, 0] - 0.75) ** 2 + (x[:, 1] - 0.75) ** 2) / 0.04)
            + jnp.exp(-((x[:, 0] - 0.25) ** 2 + (x[:, 1] - 0.25) ** 2) / 0.04))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sd(flow, params, state):
    """nf_tpu trees as the port's ``state_dict`` names -> numpy arrays."""
    model = interop.from_numpy(flow, jax.tree.map(np.asarray, params),
                               jax.tree.map(np.asarray, state))
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _per_device_draws(key, n, n_dev=2):
    return np.concatenate([np.asarray(jax.random.uniform(jax.random.fold_in(key, d),
                                                         (n // n_dev, 2), jnp.float64))
                           for d in range(n_dev)])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp")
    flow, params, state = jfactory.build_pwquad_flow(jax.random.PRNGKey(0), 2, 2, 4, (4, 4),
                                                     jnp.float64)
    w = np.random.default_rng(1).uniform(size=(256, 2))
    integ_keys = jax.random.split(jax.random.PRNGKey(5), 3)
    np.savez(out / "inputs.npz", w=w,
             sample_w=_per_device_draws(jax.random.PRNGKey(7), 256),
             integ_w=np.stack([_per_device_draws(k, 256) for k in integ_keys]),
             **{"sd." + k: v for k, v in _sd(flow, params, state).items()})
    script = out / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, str(script), coord, str(r), str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for r in (0, 1)]
    try:
        # nf_tpu's results on a 2-device mesh, and the single-process port,
        # while the workers run
        mesh = jmake_mesh(jax.devices()[:2])
        (loss, (bn, integ, err)), grads = jax.jit(jax.value_and_grad(
            jmake_dp_loss(flow, camel_j, mesh, 2.0), has_aux=True))(params, state, w)
        opt = joptim.adamax(1e-3)
        p2 = jmake_dp_train_step(flow, camel_j, mesh, jnp.asarray(2.0), opt)(
            params, state, opt.init(params), w)[0]
        ref = {"loss": np.array([loss, integ, err]),
               "dp_sample": jdp_sample(flow, params, state, mesh, 256, seed=7, method="folded",
                                       dtype=jnp.float64),
               "dp_integrate": np.array(jdp_integrate(flow, params, state, camel_j, mesh, 3,
                                                      256, seed=5, method="folded",
                                                      dtype=jnp.float64))}
        ref.update({"grad." + k: v for k, v in _sd(flow, grads, bn).items()
                    if not k.endswith(("mean", "var"))})
        ref.update({"bn." + k: v for k, v in _sd(flow, grads, bn).items()
                    if k.endswith(("mean", "var"))})
        ref.update({"step." + k: v for k, v in _sd(flow, p2, state).items()
                    if not k.endswith(("mean", "var"))})
        ns = {}
        exec(COMMON, ns)
        single = ns["scenarios"](None)
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"DPWORKER_{r}_OK" in text, text
    workers = [dict(np.load(out / f"worker{r}.npz")) for r in (0, 1)]
    return ref, single, workers


def test_psum_across_processes(run):
    for worker in run[2]:
        assert worker["psum"].tolist() == [3.0]


def test_ranks_hold_the_same_results(run):
    """Every output is replicated: the two ranks' are equal bit for bit."""
    a, b = run[2]
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_dp_loss_matches_nf_tpu(run):
    ref, _, (worker, _) = run
    np.testing.assert_allclose(worker["loss"], ref["loss"], rtol=1e-10)
    grads = [k for k in ref if k.startswith("grad.")]
    assert len(grads) == sum(k.startswith("grad.") for k in worker) > 0
    for k in grads:
        np.testing.assert_allclose(worker[k], ref[k], rtol=1e-8, atol=1e-12, err_msg=k)
    for k in (k for k in ref if k.startswith("bn.")):
        np.testing.assert_allclose(worker[k], ref[k], rtol=1e-10, atol=1e-14, err_msg=k)


def test_dp_train_step_matches_nf_tpu(run):
    ref, _, (worker, _) = run
    for k in (k for k in ref if k.startswith("step.")):
        np.testing.assert_allclose(worker[k], ref[k], rtol=1e-9, atol=1e-11, err_msg=k)


def test_dp_sample_and_integrate_match_nf_tpu(run):
    ref, _, (worker, _) = run
    np.testing.assert_allclose(worker["dp_sample.x"], np.asarray(ref["dp_sample"][0]),
                               rtol=1e-12)
    np.testing.assert_allclose(worker["dp_sample.jac"], np.asarray(ref["dp_sample"][1]),
                               rtol=1e-12)
    np.testing.assert_allclose(worker["dp_integrate"], ref["dp_integrate"], rtol=1e-10)


# float32 arithmetic: the stale trainer's folded map and the unweighter's
# proposals; the ranks sum its results in another order
FLOAT32 = ("stale.best.", "per_epoch.stale.best.", "unweight.events", "unweight.weights")


@pytest.mark.parametrize("part", ["batch.", "stale.", "per_epoch.batch.", "per_epoch.stale.",
                                  "sample.", "integrate", "unweight.", "mc."])
def test_mesh_entry_points_match_the_single_process_run(run, part):
    """At rtol 1e-8, as tests/test_parallel.py holds nf_tpu's mesh trainer;
    what is computed in float32 at 1e-6.  The atol covers BatchNorm shifts
    that are zero up to rounding."""
    _, single, (worker, _) = run
    keys = [k for k in single if k.startswith(part)]
    assert keys and all(k in worker for k in keys)
    for k in keys:
        np.testing.assert_allclose(worker[k], single[k], rtol=1e-6 if k.startswith(FLOAT32)
                                   else 1e-8, atol=1e-14, err_msg=k)
