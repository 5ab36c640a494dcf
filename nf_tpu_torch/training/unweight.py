"""Unweighted event generation from a trained flow.

Counterpart of ``nf_tpu.training.unweight``: accept-reject unweighting,
the production output of neural importance sampling.  A batch of proposals
is drawn through the flow, the weights ``w = f(x) * jac`` are compared with
``w_max * u``, and the accepted rows go to the host.  Over-weight events
(``w > w_max``) are accepted and counted.

Every function takes its device from the model and its randomness from a
``torch.Generator`` on that device.  On a CUDA model, ``method="auto"``
draws the proposals through the fused sampler kernel, one fresh kernel seed
per batch (:func:`nf_tpu_torch.flows.sampling.seed_from`), so no two batches
repeat a proposal.  Under a ``mesh`` each rank maps its rows of every
proposal batch (:func:`nf_tpu_torch.parallel.sampling.make_dp_sampler`) and
the rest runs on the gathered global batch on every rank, so the events
equal the single-device run's on the same draws.

Spans (:mod:`nf_tpu_torch.utils.profiling`): ``nf.unweight`` is the call,
``nf.unweight.pilot`` the w_max pilot, ``nf.unweight.batch`` one proposal
batch, with ``nf.unweight.propose`` (the draw), ``nf.unweight.accept``
(the uniforms, the compare, the over-weight count) and ``nf.read.rows``
(:func:`_accepted`) inside it; the integrand runs inside the batch span.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nf_tpu_torch.flows import sampling as fsampling
from nf_tpu_torch.ops.pwquad_sampler import model_device
from nf_tpu_torch.parallel.sampling import make_dp_sampler
from nf_tpu_torch.utils import profiling


def _make_draw(flow, model, n, train, method):
    """Proposal sampler ``draw(generator) -> (x, jac)`` of ``n`` points, a
    fresh :func:`nf_tpu_torch.flows.sampling.make_draw` start per call (the
    fused kernel: a fresh seed per batch): ``method=None`` is the stateful
    forward in the model's dtype (its BatchNorm buffers left as they are),
    any other method of ``make_draw`` draws in float32."""
    dtype = torch.float32
    if method is None:
        method, dtype = "stateful", next(model.parameters()).dtype
    start = fsampling.make_draw(flow, model, method, n, train=train, dtype=dtype)
    return lambda generator: start(generator)(0)


def _uniform(generator, n, dtype, device):
    """The acceptance uniforms of one batch."""
    return torch.rand(n, generator=generator, dtype=dtype, device=device)


def _quantile(a, q):
    """``jnp.quantile(a, q)`` of a 1-D tensor with a float64 ``q`` (as nf_tpu
    computes it with 64-bit types on): linear interpolation in float64
    between the sorted values at ``floor`` and ``ceil`` of ``q (n - 1)``,
    cast to ``a``'s dtype.  By a sort: ``torch.quantile`` refuses more than
    2^24 values."""
    s = torch.sort(a).values
    n = s.shape[0]
    pos = float(q) * (n - 1)
    lo, hi = min(max(math.floor(pos), 0), n - 1), min(max(math.ceil(pos), 0), n - 1)
    high_weight = pos - math.floor(pos)
    ref = s[lo].double() * (1.0 - high_weight) + s[hi].double() * high_weight
    return ref.to(a.dtype)


def _reference_weight(draw, f, generator, quantile):
    """The largest weight ``f(x) jac`` of one ``draw(generator)``, or with
    ``quantile < 1`` that quantile: one host read."""
    with torch.no_grad():
        x, jacv = draw(generator)
        weights = f(x) * jacv
        ref = torch.max(weights) if quantile >= 1.0 else _quantile(weights, quantile)
    with profiling.span("nf.read.wmax"):
        profiling.HOST_READS += 1
        return float(ref)


def estimate_wmax(flow, model, f, generator, n=100_000, train=False, safety=1.0,
                  quantile=1.0, method=None):
    """The reference weight over ``n`` fresh samples, times ``safety``: the
    largest, or with ``quantile < 1`` that quantile (heavy-tailed weights;
    the few over-weight events are kept and counted by the unweighter)."""
    return _reference_weight(_make_draw(flow, model, n, train, method), f, generator,
                             quantile) * safety


def unweighted_batch(flow, model, f, generator, n_proposals, w_max, train=False,
                     draw=None, return_weights=False):
    """One accept-reject pass: ``(x, accept, n_overweight)``, the proposals
    ``x [n_proposals, n_flow]``, the boolean acceptance mask and the count
    of over-weight events (0-d tensor), all on the model's device.  With
    ``return_weights`` a fourth element carries the partial-unweighting
    weights ``max(1, w / w_max)``.  ``draw(generator) -> (x, jac)`` defaults
    to the stateful forward."""
    if draw is None:
        draw = _make_draw(flow, model, n_proposals, train, None)
    with torch.no_grad():
        with profiling.span("nf.unweight.propose"):
            x, jacv = draw(generator)
        weights = f(x) * jacv
        with profiling.span("nf.unweight.accept"):
            u = _uniform(generator, n_proposals, weights.dtype, weights.device)
            accept = weights > u * w_max
            n_over = torch.sum(weights > w_max)
            if return_weights:
                return x, accept, n_over, torch.clamp_min(weights / w_max, 1.0)
    return x, accept, n_over


def _accepted(x, accept, n_over, wtilde, capacity):
    """The batch's first ``capacity`` (``None``: all) accepted rows of ``x``
    and of ``wtilde``, in order, gathered on the device and copied to the
    host: ``(rows, weights or None, n_accepted, n_overweight)``.  Host reads:
    the two counts together, the rows and the weights (the span
    ``nf.read.rows``)."""
    counts = torch.stack([accept.sum(), n_over])
    with profiling.span("nf.read.rows"):
        profiling.HOST_READS += 2 if wtilde is None else 3
        n_true, n_over = counts.tolist()
        k = n_true if capacity is None else min(n_true, capacity)
        idx = torch.searchsorted(torch.cumsum(accept, 0),
                                 torch.arange(1, k + 1, device=accept.device))
        rows = x[idx].cpu().numpy()
        return rows, None if wtilde is None else wtilde[idx].cpu().numpy(), n_true, n_over


@profiling.spanned("nf.unweight")
def generate_unweighted(flow, model, f, generator, n_events, w_max=None, train=False,
                        batch=1 << 17, max_batches=1000, wmax_quantile=1.0, method="auto",
                        mesh=None, partial_unweight=False, compact="auto"):
    """Generate at least ``n_events`` unweighted events (host-driven loop of
    proposal batches, at most ``max_batches``).

    Returns ``(events [>= n_events, n_flow], efficiency, n_overweight)`` as
    host numpy arrays and numbers.  ``method="auto"`` draws the proposals
    through the fused kernel on a CUDA model that is not in train mode, and
    through the stateful forward otherwise (``None``); with ``w_max=None``
    it is estimated by :func:`estimate_wmax` at quantile ``wmax_quantile``
    with a safety factor of 1.05.

    ``partial_unweight=True``: events are accepted with probability
    ``min(1, w / w_max)`` and each carries the weight ``max(1, w / w_max)``,
    so the weighted sample is f-distributed at any ``wmax_quantile``.  The
    return is then ``(events, weights, info)`` with ``info = {"eff",
    "accept_rate", "n_overweight", "w_max"}``, ``eff`` the Kish effective
    efficiency ``(sum w)^2 / sum w^2 / n_proposals``.

    ``compact`` keeps nf_tpu's capacity semantics: a batch keeps at most
    ``capacity`` accepted rows, the first in order (the accepted rows of a
    batch are exchangeable, so the kept ones stay f-distributed); a
    surplus is dropped, counted against the efficiency, and the capacity
    doubles for the next batches.  ``"auto"`` sizes the capacity from the
    first batch as ``max(1024, 1.5 rate batch)``; an ``int`` forces it from
    the first batch on; ``False`` keeps every accepted row.  Whatever the
    setting, only accepted rows are copied to the host.

    ``mesh`` draws the proposals, and the w_max pilot's, sharded over the
    mesh's ``"dp"`` axis: each rank maps its rows (the fused kernel per
    rank on the card; ``method="auto"`` is the folded forward off it) and
    gathers the global batch, whose maximum or quantile, acceptance and
    accepted rows are then the same on every rank.  It is eval-mode only,
    and ``compact="auto"`` is off under it (nf_tpu unweight.py:157-158).
    """
    if mesh is not None:
        if train:
            raise ValueError("mesh= sharded unweighting is eval-mode only")

        def draw_of(n):
            return make_dp_sampler(flow, model, mesh, n, method)
        if compact == "auto":
            compact = False
    else:
        if method == "auto":
            method = fsampling.resolve_method(flow, model_device(model), method, train)
            if method == "stateful":   # in the model's dtype
                method = None

        def draw_of(n):
            return _make_draw(flow, model, n, train, method)
    if w_max is None:   # estimate_wmax's pilot
        with profiling.span("nf.unweight.pilot"):
            w_max = _reference_weight(draw_of(100_000), f, generator, wmax_quantile) * 1.05
    draw = draw_of(batch)

    out, out_w, n_acc, n_prop, n_over = [], [], 0, 0, 0
    capacity = None
    if isinstance(compact, int) and not isinstance(compact, bool):
        capacity = int(min(max(compact, 1), batch))
    for _ in range(max_batches):
        with profiling.span("nf.unweight.batch"):
            x, accept, over, wtilde = unweighted_batch(flow, model, f, generator, batch, w_max,
                                                       train, draw, return_weights=True)
            rows, wts, n_true, over = _accepted(x, accept, over,
                                                wtilde if partial_unweight else None, capacity)
            out.append(rows)
            if partial_unweight:
                out_w.append(wts)
            n_acc += rows.shape[0]
            n_prop += batch
            n_over += over
            if capacity is not None and n_true > capacity:   # surplus dropped: grow
                capacity = min(2 * capacity, batch)
            if n_acc >= n_events:
                break
            if compact and capacity is None:
                # the first batch sizes the capacity: 1.5x its accept rate, at
                # least 1024 rows so a low first batch does not pin it small
                rate = max(n_acc / max(n_prop, 1), 1.0 / batch)
                capacity = int(min(max(1024, 1.5 * rate * batch), batch))
    events = np.concatenate(out, axis=0)
    if partial_unweight:
        w_all = np.concatenate(out_w, axis=0)
        kish = float(w_all.sum()) ** 2 / max(float((w_all ** 2).sum()), 1e-300)
        info = {"eff": kish / max(n_prop, 1), "accept_rate": n_acc / max(n_prop, 1),
                "n_overweight": n_over, "w_max": float(w_max)}
        return events, w_all, info
    return events, n_acc / max(n_prop, 1), n_over
