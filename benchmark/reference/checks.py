"""What the reference computes for a checked call, and the numbers that
compare it with what the program produced.

Each ``*_outputs`` function computes, without the program, what one call of
the timed path should give, from the benchmark's parameters and seeds, in
``dtype`` with the matrix product ``mm``: in float64 it is the reference;
in float32 with TF32 products it is the control, which stands in the
program's place.  Each ``*_numbers`` function compares outputs (the
program's, or the control's) with the reference's; every number is a gap,
0 where they agree.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import flow
from benchmark.reference.train import Trainer

INF = float("inf")


def _seed_from(gen):
    """The 62-bit kernel seed the program draws from a generator."""
    return int(torch.randint(0, 1 << 62, (1,), generator=gen, device=gen.device))


def _map(p, plan, f, lat, dtype, mm, block=1 << 18):
    """``(x, jac, f(x))`` of float32 latents, in ``dtype``, in row blocks."""
    def one(w):
        with torch.no_grad():
            x, jac = flow.forward(p, plan, w.to(dtype), "eval", mm)
            return x, jac, f(x)
    return flow.in_blocks(one, lat, block)


def eval_params(p0, plan, bn_latents, dtype, mm):
    """The served parameters: ``p0`` with its running statistics moved by
    the one seeded train-mode pass over ``bn_latents``."""
    p = {k: v.to(dtype) for k, v in p0.items()}
    new = {}
    with torch.no_grad():
        flow.forward(p, plan, bn_latents.to(dtype), "train", mm, new_stats=new)
    p.update(new)
    return p


def _max_gap(a_list, b_list):
    if len(a_list) != len(b_list) or any(a.shape != b.shape for a, b in zip(a_list, b_list)):
        return INF
    return max(float(torch.max(torch.abs(a.double() - b.double()))) for a, b in zip(a_list, b_list))


def _rms_gap(a_list, b_list):
    """The root-mean-square gap over every value of the lists."""
    if len(a_list) != len(b_list) or any(a.shape != b.shape for a, b in zip(a_list, b_list)):
        return INF
    sq = sum(float(torch.sum((a.double() - b.double()) ** 2)) for a, b in zip(a_list, b_list))
    return math.sqrt(sq / sum(a.numel() for a in a_list))


def _rel(a, b):
    return abs(a - b) / abs(b) if b != 0 else (0.0 if a == b else INF)


# ---------------------------------------------------------------------------
# integrate(f, nitn, neval, seed=...)
# ---------------------------------------------------------------------------

def integrate_outputs(p, plan, f, call_seed, nitn, neval, device, dtype, mm, combine="weighted"):
    """``nitn`` iterations of ``neval`` Philox samples, each iteration at its
    own counter range, combined by inverse-variance weighting (``combine=
    "plain"``: the fault of an unweighted mean of the iterations)."""
    gen = torch.Generator(device=device).manual_seed(call_seed)
    seed0 = _seed_from(gen)
    xs, means, variances = [], [], []
    for i in range(nitn):
        lat = flow.philox_latents(seed0, i * neval, neval, plan.n_flow, device)
        x, jac, fx = _map(p, plan, f, lat, dtype, mm)
        fres = fx * jac
        xs.append(x)
        means.append(float(torch.mean(fres.double())))
        variances.append(float(torch.var(fres.double())))
    inv = sum(1.0 / v for v in variances)
    if combine == "plain":
        sig = sum(means) / nitn
    else:
        sig = sum(m / v for m, v in zip(means, variances)) / inv
    err = math.sqrt(1.0 / inv) / math.sqrt(neval * nitn)
    return {"x": xs, "result": (sig, err)}


def integrate_numbers(out, ref):
    (sig, err), (sig_r, err_r) = out["result"], ref["result"]
    return {"x_gap": _max_gap(out["x"], ref["x"]), "x_rms": _rms_gap(out["x"], ref["x"]),
            "integral_gap": _rel(sig, sig_r), "error_gap": _rel(err, err_r)}


# ---------------------------------------------------------------------------
# generate_unweighted(..., partial_unweight=True)
# ---------------------------------------------------------------------------

def quantile(a, q):
    """Linear interpolation between the sorted values at ``floor`` and
    ``ceil`` of ``q (n - 1)``."""
    s = torch.sort(a.double()).values
    pos = q * (s.shape[0] - 1)
    lo, hi = math.floor(pos), math.ceil(pos)
    return float(s[lo]) * (1.0 - (pos - lo)) + float(s[hi]) * (pos - lo)


# an accept decision, or an event's weight, is judged where the reference's
# weight lies more than this share from the threshold, or from the event's
# weight, both at the reference's point and at the program's
MARGIN = 1e-2
# nor where the point, the reference's or the program's, lies within this
# share of a cut: there the weight jumps to 0, and float32's rounding of the
# cut variable (1.3e-5 of Delta R read once) decides the side
CUT_TOL = 1e-3


def unweight_outputs(p, plan, f, call_seed, batches, batch, w_max, device, dtype, mm,
                     pilot=0, quantile_q=0.999, safety=1.05, fault=None):
    """The proposals of a call's first ``batches`` batches (and, with
    ``pilot`` samples, the w_max pilot before them): each batch draws a
    kernel seed, ``batch`` Philox proposals and then ``batch`` uniforms from
    the call's generator; an event is a proposal with ``w > u w_max``, its
    weight ``max(1, w / w_max)``: at the ``w_max`` the call was given, or
    with ``None`` the pilot's.  A batch keeps its first ``capacity``
    accepted proposals: all in the first batch, then ``max(1024, 1.5 x``
    the first batch's accepts``)``, doubled after a batch that had more.
    ``fault`` plants one in this stand-in for the program: ``"half_accept"``
    (the second half of each batch rejected), ``"dropped_events"`` (every
    second event left out), ``"integrand"`` (f 2% high)."""
    gen = torch.Generator(device=device).manual_seed(call_seed)
    out = {"x": [], "w": [], "u": [], "jac": [], "kept": []}
    f_used = (lambda x: 1.02 * f(x)) if fault == "integrand" else f
    if pilot:
        lat = flow.philox_latents(_seed_from(gen), 0, pilot, plan.n_flow, device)
        x, jac, fx = _map(p, plan, f_used, lat, dtype, mm)
        out["pilot_x"] = x
        out["w_max"] = quantile((fx * jac).to(dtype), quantile_q) * safety
        if w_max is None:
            w_max = out["w_max"]
    events, weights, capacity, n_acc = [], [], None, 0
    for b in range(batches):
        lat = flow.philox_latents(_seed_from(gen), 0, batch, plan.n_flow, device)
        x, jac, fx = _map(p, plan, f_used, lat, dtype, mm)
        w = fx * jac
        u = torch.rand(batch, generator=gen, dtype=torch.float32, device=device).to(dtype)
        accept = w > u * w_max
        if fault == "half_accept":
            accept[batch // 2:] = False
        n_true = int(accept.sum())
        kept = accept & (torch.cumsum(accept, 0) <= (n_true if capacity is None else capacity))
        if fault == "dropped_events":
            kept &= torch.cumsum(kept, 0) % 2 == 1
        n_acc += int(kept.sum())
        if capacity is None:
            capacity = int(min(max(1024, 1.5 * max(n_acc / (batch * (b + 1)), 1.0 / batch) * batch),
                               batch))
        elif n_true > capacity:
            capacity = min(2 * capacity, batch)
        for k, v in (("x", x), ("w", w), ("u", u), ("jac", jac), ("kept", kept)):
            out[k].append(v)
        events.append(x[kept])
        weights.append(torch.clamp_min(w[kept] / w_max, 1.0))
    out["events"] = torch.cat(events).cpu().numpy()
    out["weights"] = torch.cat(weights).cpu().numpy()
    out["w_max_used"] = w_max
    return out


def unweight_numbers(out, ref, f, cut_distance=None):
    """``x_gap``, ``x_rms``: a proposal's point against the reference's;
    ``stray_events``: events that are no proposal of the call, or repeat
    one; ``clear_flips``: proposals that the reference keeps as events and
    the program's events lack, or that the reference rejects and the
    program took, where the reference's decision is clear (its weight,
    ``f(x) jac`` at its own point and, with ``f``, at the program's, lies
    more than ``MARGIN`` from ``u w_max`` on the same side, and neither
    point lies within ``CUT_TOL`` of a cut by ``cut_distance``);
    ``weight_errors``: events whose weight is more than ``MARGIN`` off the
    reference's at both points, away from the cuts alike.  Not compared:
    ``flip_share``, every differing decision per reference event;
    ``weight_gap``, the largest relative gap of an event's weight;
    ``near_cut``, the proposals left out as lying near a cut; ``wmax_gap``
    (with a pilot), the pilot's w_max against the reference's."""
    nums = {"x_gap": _max_gap(out["x"], ref["x"]), "x_rms": _rms_gap(out["x"], ref["x"])}
    if "pilot_x" in out:
        nums["wmax_gap"] = _rel(out["w_max"], ref["w_max"]) if "pilot_x" in ref else INF
    if nums["x_gap"] == INF:
        return dict(nums, x_rms=INF, flip_share=INF, weight_gap=INF, near_cut=INF,
                    stray_events=INF, clear_flips=INF, weight_errors=INF)
    rows = np.concatenate([x.cpu().numpy().astype(np.float32) for x in out["x"]])
    index = {r.tobytes(): i for i, r in enumerate(rows)}
    events = np.ascontiguousarray(out["events"], dtype=np.float32)
    idx = np.asarray([index.get(r.tobytes(), -1) for r in events], np.int64)
    stray = int(np.sum(idx < 0)) + (int(np.sum(idx >= 0)) - len(np.unique(idx[idx >= 0])))
    w_max = ref["w_max_used"]
    w_ref = torch.cat(ref["w"]).double().cpu().numpy()
    near = np.zeros(len(rows), dtype=bool)
    with torch.no_grad():
        w_at = torch.cat([f(x.to(j.dtype).to(j.device)) * j
                          for x, j in zip(out["x"], ref["jac"])]).double().cpu().numpy()
        if cut_distance is not None:
            near = torch.cat([(cut_distance(x.to(xr.dtype).to(xr.device)) < CUT_TOL)
                              | (cut_distance(xr) < CUT_TOL)
                              for x, xr in zip(out["x"], ref["x"])]).cpu().numpy()
    thr = torch.cat(ref["u"]).double().cpu().numpy() * w_max
    kept_ref = torch.cat(ref["kept"]).cpu().numpy()
    taken = np.zeros(len(rows), dtype=bool)
    taken[idx[idx >= 0]] = True
    clear_in = (w_ref > (1 + MARGIN) * thr) & (w_at > (1 + MARGIN) * thr) & ~near
    clear_out = (w_ref < (1 - MARGIN) * thr) & (w_at < (1 - MARGIN) * thr) & ~near
    clear = int(np.sum(clear_in & kept_ref & ~taken)) + int(np.sum(clear_out & taken))
    matched = idx >= 0
    wt = np.asarray(out["weights"], np.float64)
    if len(wt) != len(events):
        wgap = werr = INF
    elif np.any(matched):
        wt, i = wt[matched], idx[matched]
        wt_ref, wt_at = np.maximum(w_ref[i] / w_max, 1.0), np.maximum(w_at[i] / w_max, 1.0)
        wgap = float(np.max(np.abs(wt - wt_ref) / wt_ref))
        werr = int(np.sum((np.abs(wt - wt_ref) > MARGIN * wt_ref)
                          & (np.abs(wt - wt_at) > MARGIN * wt_at) & ~near[i]))
    else:
        wgap, werr = 0.0, 0
    flips = int(np.sum(taken != (w_ref > thr)))
    nums.update(flip_share=flips / max(int(np.sum(w_ref > thr)), 1), weight_gap=wgap,
                near_cut=float(np.sum(near)), stray_events=float(stray),
                clear_flips=float(clear), weight_errors=float(werr))
    return nums


# ---------------------------------------------------------------------------
# the trainer's first steps: a call of 1 epoch, then one of 2
# ---------------------------------------------------------------------------

def train_outputs(p0, plan, f, seeds, epochs, cfg, device, dtype, mm, trainer=Trainer):
    """The losses of every epoch of the calls (``epochs[k]`` epochs, the
    generator seeded with ``seeds[k]``), the gradient the optimizer took in
    the first step (its first moment after one step over ``1 - beta1``),
    the points the first call's first epoch handed ``f`` and the
    parameters after the last call."""
    gen = torch.Generator(device=device)
    tr = trainer(plan, f, p0, gen, cfg, dtype, mm)
    losses, grad = [], None
    for seed, n in zip(seeds, epochs):
        gen.manual_seed(seed)
        res = tr.call(n)
        losses += res["loss"]
        if grad is None:
            grad = {k: m / (1 - cfg["betas"][0]) for k, (m, _) in res["opt"].items()}
            points = res["points"]
    return {"loss": losses, "grad": grad, "x": points,
            "params": {k: v for k, v in tr.p.items() if not flow.is_buffer(k)}}


def _leaf_gap(vals, refs, keep=None):
    """The worst leaf's gap between two norms, over the larger of the
    reference leaf's norm and the median leaf's."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in refs.items()}
    median = float(np.median(list(norms.values())))
    worst = 0.0
    for k, r in norms.items():
        if keep is not None and k not in keep:
            continue
        if k not in vals or vals[k].shape != refs[k].shape:
            return INF
        gap = abs(float(torch.linalg.vector_norm(vals[k].double())) - r) / max(r, median)
        worst = max(worst, gap)
    return worst


def train_numbers(out, ref, p0):
    """``loss_gap``: the worst epoch's relative loss gap; ``grad_gap``: the
    first step's gradient by the worst leaf; ``change_gap``: the
    parameters' change over every step, by the worst leaf among those whose
    reference gradient is above a thousandth of the median leaf's (a leaf
    with none moves under Adamax by rounding alone); ``x_rms``: the RMS gap
    of the points the first epoch handed the integrand (the training
    forward's output, or in preburn the latents)."""
    if len(out["loss"]) != len(ref["loss"]):
        loss_gap = INF
    else:
        loss_gap = max(_rel(a, b) for a, b in zip(out["loss"], ref["loss"]))
    gnorm = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref["grad"].items()}
    median = float(np.median(list(gnorm.values())))
    keep = {k for k, g in gnorm.items() if g >= 1e-3 * median}
    delta = {k: out["params"][k].double().cpu() - p0[k].double().cpu()
             for k in ref["params"] if k in out["params"]}
    delta_ref = {k: ref["params"][k].double().cpu() - p0[k].double().cpu() for k in ref["params"]}
    return {"loss_gap": loss_gap,
            "grad_gap": _leaf_gap({k: v.cpu() for k, v in out["grad"].items()},
                                  {k: v.cpu() for k, v in ref["grad"].items()}),
            "change_gap": _leaf_gap(delta, delta_ref, keep),
            "x_rms": _rms_gap(out["x"], ref["x"])}
