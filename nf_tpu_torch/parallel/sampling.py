"""Data-parallel sampling and integration over the ``"dp"`` mesh.

Counterpart of ``nf_tpu.parallel.sampling``: each rank maps its own rows of
every global batch through the eval-mode flow, the integral's per-iteration
sums are all-reduced, and the samples are gathered into global arrays in
rank order.  The parameters are replicated.

The rank streams: the ranks' shards, concatenated in rank order, are the
single-device draw of the global batch with the same seed.

  * The fused kernel (``method="fused"``, the default on a CUDA device):
    rank ``r`` of ``W`` launches the sampler for its ``n / W`` rows at the
    Philox counter ``offset = r n / W`` of the call's seed.  The counter is
    per sample (:func:`~nf_tpu_torch.ops.pwquad_sampler.philox_uniform`), so
    the shards equal one launch of ``n`` bit for bit; the offset takes the
    place of nf_tpu's ``SEED_STRIDE``.
  * The folded forward (``"folded"``, the default on the CPU): every rank
    draws the global latents from its generator (seeded alike on every
    rank) through :func:`nf_tpu_torch.flows.sampling._uniform` and keeps its
    rows.  Tests replay nf_tpu's per-device ``fold_in`` draws through that
    hook.

The method is :func:`nf_tpu_torch.flows.sampling.resolve_method`'s on an
eval-only path and the draw :func:`~nf_tpu_torch.flows.sampling.make_draw`'s
over the rank's rows.  Sharded sampling is eval-mode only: the train-mode
forward normalises with one replica's batch statistics.
"""

from __future__ import annotations

import math

import torch

from nf_tpu_torch.flows import sampling as fsampling
from nf_tpu_torch.ops.pwquad_sampler import model_device
from nf_tpu_torch.parallel.dp import all_gather_rows, all_reduce_sum
from nf_tpu_torch.parallel.mesh import group_of, local_rows, rank_and_size
from nf_tpu_torch.utils import profiling

_GOLDEN = 0x9E3779B9
_MASK = 0xFFFFFFFF


def make_dp_sampler(flow, model, mesh, n, method="auto", dtype=torch.float32):
    """Build ``fn(generator) -> (x [n, n_flow], jac [n])``: this rank maps
    its rows of the draw, and the global arrays come back on every rank (a
    gather in rank order).  ``n`` must divide by the mesh size."""
    method = fsampling.resolve_method(flow, model_device(model), method, eval_only=True)
    group = group_of(mesh)
    start = fsampling.make_draw(flow, model, method, n, local_rows(int(n), group, "n"),
                                dtype=dtype)

    def fn(generator):
        with torch.no_grad():
            x, jac = start(generator)(0)
            return all_gather_rows(x, group), all_gather_rows(jac, group)
    return fn


def dp_sample(flow, model, mesh, n, seed=0, method="auto", dtype=torch.float32):
    """Draw ``n`` samples sharded over the mesh; returns the global ``(x, jac)``."""
    gen = torch.Generator(device=model_device(model)).manual_seed(seed)
    return make_dp_sampler(flow, model, mesh, n, method, dtype)(gen)


def make_dp_integrator(flow, model, f, mesh, nitn, neval, method="auto",
                       dtype=torch.float32):
    """Build ``fn(generator) -> (means [nitn], variances [nitn])``, float64:
    ``nitn`` iterations of ``neval`` global samples, each rank mapping its
    rows (the fused kernel's iteration ``i`` at counter ``i neval`` plus the
    rank's offset, as ``integrate`` draws them), ``f`` on its rows, and the
    global mean and unbiased variance of each iteration from the all-reduced
    ``(sum f J, sum (f J)^2)`` (one all-reduce for all iterations).
    ``neval`` must divide by the mesh size."""
    method = fsampling.resolve_method(flow, model_device(model), method, eval_only=True)
    group = group_of(mesh)
    neval = int(neval)
    start = fsampling.make_draw(flow, model, method, neval, local_rows(neval, group, "neval"),
                                layout="dim_major", dtype=dtype)

    def fn(generator):
        with torch.no_grad():
            draw = start(generator)
            sums = []
            for i in range(nitn):
                x, jacv = draw(i)
                fres = (f(x) * jacv).to(torch.float64)
                sums.append(torch.stack([torch.sum(fres), torch.sum(fres * fres)]))
            s1, s2 = all_reduce_sum(torch.stack(sums), group).unbind(1)
            return s1 / neval, (s2 - s1 * s1 / neval) / (neval - 1)
    return fn


def combine_iterations(means, variances, n_total, combine="iw"):
    """Combine per-iteration ``(mean, variance)`` into ``(sig, sig_err)``
    floats: ``"iw"`` is the reference's inverse-variance weighting (biased
    low on heavy tails), ``"mean"`` the pooled mean with its standard
    error over ``n_total`` samples; the two are read to the host at once
    (the span ``nf.read.result``)."""
    means = torch.as_tensor(means)
    variances = torch.as_tensor(variances)
    if combine == "mean":
        sig, err = torch.mean(means), torch.sqrt(torch.mean(variances) / n_total)
    elif combine == "iw":
        sig = torch.sum(means / variances) / torch.sum(1.0 / variances)
        err = torch.sqrt(1.0 / torch.sum(1.0 / variances)) / math.sqrt(n_total)
    else:
        raise ValueError(f"unknown combine {combine!r}; expected 'iw' or 'mean'")
    result = torch.stack([sig, err])
    with profiling.span("nf.read.result"):
        profiling.HOST_READS += 1
        sig, err = result.tolist()
    return sig, err


def dp_integrate(flow, model, f, mesh, nitn, neval, seed=0, method="auto", combine="iw",
                 dtype=torch.float32):
    """Data-parallel integration (reference manager.py:380-405): ``nitn``
    iterations of ``neval`` global samples sharded over the mesh, combined
    on the host by ``combine``.  Equals the single-device estimate on the
    same draws to roundoff."""
    gen = torch.Generator(device=model_device(model)).manual_seed(seed)
    means, variances = make_dp_integrator(flow, model, f, mesh, nitn, neval, method, dtype)(gen)
    return combine_iterations(means, variances, int(neval) * nitn, combine)


def make_dp_rqmc(eval_mean, n_flow, nitn, neval, mesh, device=None):
    """Build a sharded randomized-QMC integrator: each rank generates and
    consumes its own Owen-scrambled Sobol replications
    (:func:`~nf_tpu_torch.utils.qmc.make_device_sobol` on ``device``, by
    default the mesh's device type) and the replication means are gathered.
    Returns ``(fn, n_points, reps_total)`` with ``fn(seed0) -> means
    [reps_total]``; ``nitn`` is rounded up to a multiple of the mesh size,
    and replication ``j`` of rank ``r`` is scrambled with seed ``seed0 +
    0x9E3779B9 (r reps_local + j) mod 2^32``, nf_tpu's schedule.
    ``eval_mean(w [n, n_flow] float32) -> 0-d tensor`` maps one replication."""
    from nf_tpu_torch.utils import qmc

    group = group_of(mesh)
    rank, size = rank_and_size(group)
    reps_local = -(-int(nitn) // size)
    m = max(int(math.ceil(math.log2(max(int(neval), 1)))), 0)
    n = 1 << m
    gen = qmc.make_device_sobol(n_flow, scramble=True)
    device = torch.device(mesh.device_type if device is None else device)

    def fn(seed0):
        with torch.no_grad():
            means = torch.stack([
                eval_mean(gen(n, (int(seed0) + _GOLDEN * (rank * reps_local + j)) & _MASK,
                              device))
                for j in range(reps_local)])
            return all_gather_rows(means, group)
    return fn, n, reps_local * size

