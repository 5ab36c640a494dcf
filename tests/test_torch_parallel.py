"""The port's data parallelism in one process (CPU, float64).

``nf_tpu_torch.parallel`` on a world of one over gloo: the mesh and the
bring-up, every entry point under ``mesh=`` against its ``mesh=None`` run
bit for bit (the reductions are the same sums either way), and, with the
rank and world size of the sampling module patched, the shards of a world of
four built rank by rank against the single-device draw.  ``combine_iterations``
and ``make_dp_rqmc``'s rounding and seed schedule are held against nf_tpu's
(a 4-device mesh of conftest's fake CPU devices).  The two-process runs are
in ``tests/test_torch_dp.py``.
"""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from nf_tpu.parallel import make_mesh as jmake_mesh
from nf_tpu.parallel import sampling as jsampling
from nf_tpu_torch import PWQuadManager
from nf_tpu_torch import parallel
from nf_tpu_torch.flows import sampling as fsampling
from nf_tpu_torch.parallel import dp
from nf_tpu_torch.parallel import mesh as pmesh
from nf_tpu_torch.parallel import sampling as psampling
from nf_tpu_torch.training import optimizers, unweight

torch.set_num_threads(1)


def camel_t(x):
    return (torch.exp(-((x[:, 0] - 0.75) ** 2 + (x[:, 1] - 0.75) ** 2) / 0.04)
            + torch.exp(-((x[:, 0] - 0.25) ** 2 + (x[:, 1] - 0.25) ** 2) / 0.04))


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world_of_one():
    """A 1-D CPU mesh over a gloo world of one (made once per process)."""
    if dist.is_initialized():
        return parallel.make_mesh(device="cpu")
    return parallel.initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, device="cpu",
                                           timeout=60)


@pytest.fixture(scope="module")
def manager():
    NF = PWQuadManager(n_flow=2, seed=3, dtype=torch.float64, device="cpu")
    NF.create_model(2, 4, [4] * 2)
    return NF


def test_world_of_one_bringup(world_of_one):
    mesh = world_of_one
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    assert mesh.mesh_dim_names == ("dp",) and mesh.size() == 1 and mesh.device_type == "cpu"
    group = pmesh.group_of(mesh)
    assert pmesh.rank_and_size(group) == (0, 1) and pmesh.rank_and_size(None) == (0, 1)
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(parallel.data_parallel_sharding(mesh)(x), x)
    assert torch.equal(dp.all_reduce_sum(x, group), x)
    assert torch.equal(dp.all_gather_rows(x, group), x)
    assert torch.equal(dp.all_reduce_max(x, group), x)


def test_global_moments_and_gradient_average(world_of_one):
    group = pmesh.group_of(world_of_one)
    rng = np.random.default_rng(0)
    xs = torch.tensor(rng.standard_normal((3, 50)))
    means, var = dp.global_mean_var(xs, group)
    torch.testing.assert_close(means, xs.mean(1), rtol=1e-14, atol=0)
    torch.testing.assert_close(var, xs.var(1), rtol=1e-13, atol=0)
    assert torch.equal(dp.global_mean_var(xs, None)[1], var)
    assert torch.equal(dp.global_unbiased_var(xs[1], group), var[1])
    assert torch.equal(dp.global_mean(xs[2], group), xs[2].sum() / 50)
    p = torch.nn.Parameter(torch.ones(4))
    p.grad = torch.full((4,), 6.0)
    dp.average_gradients([p], group, divisor=3)
    assert torch.equal(p.grad, torch.full((4,), 2.0))


@pytest.mark.parametrize("method", ["fused", "folded"])
def test_rank_streams_concatenate_to_the_single_device_draw(manager, monkeypatch, method):
    """The shards of a world of four, built rank by rank, concatenate to
    the single-device draw: the kernel's plain version at the rank's Philox
    offset, and the folded forward on the rank's rows of the global
    latents."""
    n, world = 64, 4
    model = manager.best_model
    ref = fsampling.make_draw(manager._flow, model, method, n, dtype=torch.float64)(
        torch.Generator().manual_seed(9))(0)
    monkeypatch.setattr(psampling, "group_of", lambda mesh: "dp")
    monkeypatch.setattr(psampling, "all_gather_rows", lambda x, group: x)
    shards = []
    for r in range(world):
        monkeypatch.setattr(psampling, "local_rows",
                            lambda n_, group, what: (r * n_ // world, (r + 1) * n_ // world))
        fn = psampling.make_dp_sampler(manager._flow, model, None, n, method,
                                       dtype=torch.float64)
        shards.append(fn(torch.Generator().manual_seed(9)))
    for got, want in zip(zip(*shards), ref):
        torch.testing.assert_close(torch.cat(got), want, rtol=1e-15, atol=0)


@pytest.mark.parametrize("combine", ["iw", "mean"])
def test_combine_iterations_matches_nf_tpu(combine):
    rng = np.random.default_rng(1)
    means, variances = rng.uniform(0.2, 0.3, 5), rng.uniform(0.01, 0.05, 5)
    got = psampling.combine_iterations(torch.tensor(means), torch.tensor(variances), 5000,
                                       combine)
    ref = jsampling.combine_iterations(jnp.asarray(means), jnp.asarray(variances), 5000,
                                       combine)
    np.testing.assert_allclose(got, ref, rtol=1e-14)


def test_dp_rqmc_rounding_and_seeds_match_nf_tpu(monkeypatch):
    """nitn = 5 on four ranks rounds up to 8 replications; rank r's are
    scrambled with nf_tpu's seeds, so its means are nf_tpu's device r's."""
    nitn, neval, world, seed0 = 5, 1000, 4, 123456

    def mean_t(w):
        return torch.mean(w[:, 0] * w[:, 1])

    jfn, n_j, reps_j = jsampling.make_dp_rqmc(lambda w: jnp.mean(w[:, 0] * w[:, 1]), 2, nitn,
                                              neval, jmake_mesh(jax.devices()[:world]))
    ref = np.asarray(jfn(jnp.uint32(seed0)))
    monkeypatch.setattr(psampling, "group_of", lambda mesh: "dp")
    monkeypatch.setattr(psampling, "all_gather_rows", lambda x, group: x)
    got = []
    for r in range(world):
        monkeypatch.setattr(psampling, "rank_and_size", lambda group: (r, world))
        fn, n, reps = psampling.make_dp_rqmc(mean_t, 2, nitn, neval, None, device="cpu")
        assert (n, reps) == (n_j, reps_j) == (1024, 8)
        got.append(fn(seed0))
    np.testing.assert_allclose(torch.cat(got).numpy(), ref, rtol=2e-7)


def test_mesh_refusals(manager, monkeypatch):
    """Sharded sampling is eval-mode only, and the global sizes must divide
    by the world size (here patched to 4)."""
    with pytest.raises(ValueError, match="eval-mode only"):
        manager.sample(16, mesh=object(), train=True)
    with pytest.raises(ValueError, match="eval-mode only"):
        manager.sample(16, mesh=object(), method="reference")
    with pytest.raises(ValueError, match="eval-mode only"):
        manager.integrate(camel_t, 2, 16, mesh=object(), method="stateful")
    monkeypatch.setattr(pmesh, "rank_and_size", lambda group: (0, 4))
    flow, model = manager._flow, manager.best_model
    with pytest.raises(ValueError, match="n=10 not divisible by mesh size 4"):
        psampling.make_dp_sampler(flow, model, None, 10, "folded")
    with pytest.raises(ValueError, match="neval=10 not divisible by mesh size 4"):
        psampling.make_dp_integrator(flow, model, camel_t, None, 2, 10, "folded")


def _train(mesh, bn_stats, **cadence):
    NF = PWQuadManager(n_flow=2, seed=0, dtype=torch.float64, device="cpu")
    NF.create_model(2, 4, [4] * 2)
    NF._train_variance_forward_seq(
        camel_t, optimizers.adamax(2e-3, 1e-4), log=False, batch_size=256, epochs=6,
        mini_batch_size=128, preburn_time=2, integrate=True, pretty_progressbar=False,
        bn_stats=bn_stats, stats_every=2, mesh=mesh, **cadence)
    return NF


def _same_runs(a, b):
    assert a.history == b.history and (a.integ_tot, a.err_tot) == (b.integ_tot, b.err_tot)
    assert np.array_equal(a._integ_hist, b._integ_hist)
    for x, y in zip(a.best_model.state_dict().values(), b.best_model.state_dict().values()):
        assert torch.equal(x, y)


@pytest.mark.parametrize("bn_stats", ["batch", "stale"])
def test_world_of_one_trainer_is_the_single_device_run(world_of_one, bn_stats):
    """At the default cadence: under a mesh the chunk runs eagerly."""
    _same_runs(_train(world_of_one, bn_stats), _train(None, bn_stats))


@pytest.mark.parametrize("bn_stats", ["batch", "stale"])
def test_world_of_one_per_epoch_trainer_is_the_single_device_run(world_of_one, bn_stats):
    """At ``epochs_per_sync=1``: the per-epoch loop under a mesh, one
    all-reduce and one host read an epoch."""
    _same_runs(_train(world_of_one, bn_stats, epochs_per_sync=1),
               _train(None, bn_stats, epochs_per_sync=1))


def test_world_of_one_endpoints_are_the_single_device_runs(world_of_one, manager):
    mesh, flow, model = world_of_one, manager._flow, manager.best_model
    for method in ("fused", "folded"):
        got = manager.sample(64, seed=2, method=method, mesh=mesh)
        ref = manager.sample(64, seed=2, method=method)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
    # the iterations' sums in float64 against torch.var
    np.testing.assert_allclose(manager.integrate(camel_t, 3, 64, seed=4, method="folded",
                                                 mesh=mesh),
                               manager.integrate(camel_t, 3, 64, seed=4, method="folded"),
                               rtol=1e-13)
    sig, err = manager.integrate(camel_t, 4, 64, seed=5, method="qmc", mesh=mesh)
    assert np.isfinite(sig) and err > 0
    kw = dict(n_events=300, batch=256, wmax_quantile=0.95, partial_unweight=True)
    got = unweight.generate_unweighted(flow, model, camel_t, torch.Generator().manual_seed(1),
                                       mesh=mesh, **kw)
    ref = unweight.generate_unweighted(flow, model, camel_t, torch.Generator().manual_seed(1),
                                       method="folded", compact=False, **kw)
    assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
    assert got[2] == ref[2]
