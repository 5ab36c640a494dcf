"""Data-parallel reductions and the hand-written DP loss and train step.

Counterpart of ``nf_tpu.parallel.dp``.  The collective inventory this
workload needs is all-reduce, plus the gathers that return global arrays:

  * each rank maps its own rows of the global batch (the batch is the
    scaling axis);
  * global-batch BatchNorm statistics all-reduce the batch mean and mean
    square inside the flow (``FlowModel.forward(w, True, group)``);
  * the global mean and unbiased variance of the weighted integrand come
    from all-reduced sums;
  * the parameter gradients are averaged across ranks after the backward.

Every function takes a process group (:func:`~nf_tpu_torch.parallel.mesh
.group_of`); with ``group=None`` it runs the same arithmetic without the
collective, so a world of one gives the bits of the single-device run.

Gradients through the collectives: :func:`all_reduce_sum`'s backward
all-reduces the cotangent, the true transpose of a sum over ranks.  A loss
computed from all-reduced values is replicated on every rank, so what each
rank's backward differentiates is, summed over ranks, ``W`` times the loss:
its gradient is its own rows' share of ``W`` times the global gradient.
:func:`average_gradients` sums those shares and divides by ``W``, giving the
global gradient on every rank.  nf_tpu gets the same from ``psum``'s
transpose under ``shard_map``.

The variance is two-pass (the global mean, then the all-reduced squared
deviations from it): the same value as nf_tpu's one-pass
``(s2 - s1^2/n) / (n - 1)`` in exact arithmetic, without its cancellation in
float32.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from nf_tpu_torch.parallel.mesh import group_of, rank_and_size


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(rank_and_size(group)[1])]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        # the transpose of a gather to every rank: the cotangents of this
        # rank's rows, summed over ranks
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        rank, size = rank_and_size(ctx.group)
        n = g.shape[0] // size
        return g[rank * n:(rank + 1) * n], None


def all_reduce_sum(x, group=None):
    """The sum of ``x`` over the ranks of ``group`` (``x`` itself for
    ``None``), differentiable."""
    return x if group is None else _AllReduceSum.apply(x, group)


def all_reduce_max(x, group=None):
    """The elementwise maximum of ``x`` over the ranks (not differentiable)."""
    if group is None:
        return x
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def all_gather_rows(x, group=None):
    """The rank shards ``x`` concatenated in rank order along the leading
    axis: the global array, on every rank.  Differentiable."""
    return x if group is None else _AllGatherRows.apply(x, group)


def global_mean(x, group=None):
    """Mean of the full cross-rank batch of the local ``[n]`` vector ``x``."""
    size = rank_and_size(group)[1]
    return all_reduce_sum(torch.sum(x), group) / (x.shape[0] * size)


def global_unbiased_var(x, group=None):
    """Unbiased variance of the full cross-rank batch of the local ``[n]``
    vector ``x`` (two-pass)."""
    return global_mean_var(x[None], group)[1][0]


def global_mean_var(xs, group=None):
    """Means and unbiased variances ``([k], [k])`` of the full cross-rank
    batch of each row of the local ``xs [k, n]``: two all-reduces for all
    ``k`` rows."""
    n = xs.shape[-1] * rank_and_size(group)[1]
    means = all_reduce_sum(torch.sum(xs, dim=-1), group) / n
    dev = xs - means[:, None]
    return means, all_reduce_sum(torch.sum(dev * dev, dim=-1), group) / (n - 1)


def average_gradients(params, group=None, divisor=1):
    """Divide every gradient by ``divisor``, after summing it over the ranks
    and dividing by the world size (one all-reduce for all of them).  With
    ``group=None`` only the division runs."""
    grads = [p.grad for p in params if p.grad is not None]
    size = rank_and_size(group)[1]
    with torch.no_grad():
        if group is not None and grads:
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=group)
            for g, part in zip(grads, torch.split(flat, [g.numel() for g in grads])):
                g.copy_(part.view_as(g))
        for g in grads:
            g.div_(divisor * size)


def broadcast_replicas(modules, group, generator=None):
    """Make every rank's copy equal to the first rank's, as DDP does at its
    start: the parameters and buffers of ``modules`` and, if given, the
    state of ``generator`` (whose draws each rank slices its rows from)."""
    if group is None:
        return
    src = dist.get_global_rank(group, 0)
    device = None
    with torch.no_grad():
        for m in modules:
            for t in list(m.parameters()) + list(m.buffers()):
                dist.broadcast(t.data, src, group=group)
                device = t.device
        if generator is not None:
            state = generator.get_state().to(device or generator.device)
            dist.broadcast(state, src, group=group)
            generator.set_state(state.cpu())


def make_dp_loss(flow, f, mesh, maxf, loss_mode="var"):
    """Build ``loss_fn(model, w) -> (loss, (integ, err))``: ``w`` is this
    rank's rows of the global ``[B, n_flow]`` latent batch and ``model`` a
    :class:`~nf_tpu_torch.flows.model.FlowModel` of ``flow`` (nf_tpu's
    ``(params, bn_state)``).  The forward runs in train mode with
    global-batch BatchNorm statistics, moving ``model``'s buffers; ``loss``
    is the global variance of ``f(x) J / maxf`` (``"var"``) or the global
    mean of ``(f(x) J)^2``, differentiable in the parameters through ``J``
    (see the module docstring for the gradient's scale); ``integ`` and
    ``err`` are the global mean and variance of ``f(x) J``."""
    group = group_of(mesh)

    def loss_fn(model, w):
        if model.flow != flow:
            raise ValueError("make_dp_loss: the model is not of this flow")
        x, jacv = model(w, True, group)
        fres = f(x.detach()) * jacv
        fXJ = fres / maxf
        if loss_mode == "var":
            loss = global_unbiased_var(fXJ, group)
        else:
            loss = global_mean((fXJ * maxf) ** 2, group)
        means, var = global_mean_var(fres.detach()[None], group)
        return loss, (means[0], var[0])

    return loss_fn


def make_dp_train_step(flow, f, mesh, maxf, optimizer, loss_mode="var"):
    """Build ``step(model, w) -> (loss, integ, err)``: the DP loss of
    :func:`make_dp_loss` on this rank's rows ``w``, its backward, the
    gradients averaged across ranks and one step of ``optimizer`` (a
    ``torch.optim.Optimizer`` over ``model``'s parameters).  The parameters
    are then bit-identical on every rank."""
    loss_fn = make_dp_loss(flow, f, mesh, maxf, loss_mode)
    group = group_of(mesh)

    def step(model, w):
        optimizer.zero_grad(set_to_none=True)
        loss, (integ, err) = loss_fn(model, w)
        loss.backward()
        average_gradients(model.parameters(), group)
        optimizer.step()
        return loss.detach(), integ, err

    return step
