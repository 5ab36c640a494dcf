"""Learned multi-channel importance sampling: one flow per channel.

Counterpart of ``nf_tpu.training.multichannel``.  Each channel k of a
multi-channel phase space gets its own normalizing flow on its own latent
cube, and samples are combined with the full learned mixture density

    q(x) = sum_m alpha_m  rho_m(u_m(x)) / w_m^PS(x) / C(x)

where rho_m is flow m's density (:func:`nf_tpu_torch.flows.model.inverse`:
the inverse map's Jacobian), u_m(x) the channel-m latents of the point
(``ResonanceDecayPhasespace.invertKinematics_batch``), w_m^PS the channel's
closed-form phase-space density and C(x) the channel-independent PDF * cuts
/ flux factor.  Every sample carries the weight f(x)/q(x), unbiased for any
positive alphas and any flow parameters (MadNIS-style; Heimel et al.,
arXiv 2311.01548).

Training (:func:`train_multichannel`) draws equal per-channel batches
weighted by alpha, trains the flows on the stratified variance, second
moment or reweighted KL of the mixture weights with the samples detached
(gradients flow only through the C^2 densities rho_m(u_m(x_k))), moves the
alphas by the Kleiss-Pittau update on the device, and keeps the best
(flows, alphas) by mixture ESS.  :func:`multichannel_unweight` draws
unweighted events from the trained mixture with a global or per-channel
maxima, plainly or partially.

Differences in idiom, against nf_tpu:

  * a channel's flow is one :class:`~nf_tpu_torch.flows.model.FlowModel`
    (plan, parameters and BatchNorm buffers) where nf_tpu passes ``flows,
    params, states``; :func:`build_channel_flows` returns a tuple of them;
  * randomness comes from a ``torch.Generator`` on the models' device,
    consumed in nf_tpu's order of draws, through the module-level hooks
    :func:`_uniform` and :func:`_seed` (tests replay nf_tpu's draws there);
  * the trainer runs epoch by epoch on the device and reads its history
    once per ``epochs_per_call`` chunk; there is no compiled program to
    cache (nf_tpu's ``_cached_jit`` has no counterpart);
  * flows run in eval mode and never move their BatchNorm buffers; the
    forward and the phase space run without autograd.

Plain torch: nf_tpu's functions here reach no Pallas kernel.

Spans (:mod:`nf_tpu_torch.utils.profiling`): ``nf.mc.train`` is the
trainer's call, with ``nf.mc.pilot`` (the ``w_scale`` pass) and per epoch
``nf.mc.epoch``; inside the pilot and each minibatch, per source channel
``nf.mc.propose`` (the flow's forward, the kinematics and the PDF) and per
(source, density channel) pair ``nf.mc.density`` (the channel weight, the
inverse kinematics and the flow's inverse); then ``nf.mc.loss``,
``nf.mc.backward``, the epoch's ``nf.mc.step`` and ``nf.mc.alphas`` (ESS,
the best-model copy and the Kleiss-Pittau update).  ``nf.read.history``
marks each blocking read, counted in ``profiling.HOST_READS``: the four
history rows of every chunk, then the alphas, the best alphas and the best
ESS at the end, so a call of one chunk makes 7.

``mesh`` (a 1-D ``"dp"`` mesh, :mod:`nf_tpu_torch.parallel`) shards each
channel's batch, as nf_tpu's ``_shard_batch``: every rank draws the global
latents and maps its rows; :func:`mixture_weights` gathers the global
arrays, and :func:`train_multichannel` all-reduces the losses' means, the
epoch's weight, ESS and Kleiss-Pittau sums and the pilot's maximum, and
averages the gradients across ranks.  The sums are the same with or without
a mesh, so a world of one gives the bits of the single-device run.
"""

from __future__ import annotations

import copy
import warnings

import numpy as np
import torch

from nf_tpu_torch.flows import factory
from nf_tpu_torch.flows.model import inverse as flow_inverse
from nf_tpu_torch.parallel.dp import (all_gather_rows, all_reduce_max, all_reduce_sum,
                                      average_gradients, broadcast_replicas)
from nf_tpu_torch.parallel.mesh import group_of, local_rows, rank_and_size
from nf_tpu_torch.training.unweight import _quantile
from nf_tpu_torch.utils import checkpoint, profiling

_EPS_U = 1e-9
# the per-channel knapsack's floor on a channel's schedule share, as a
# fraction of its share at the pilot maxima (see _knapsack)
_MIN_SHARE = 0.1
_HISTORY = ("loss", "integral", "ess", "alphas")
# what a resumed run must share with the run that wrote the checkpoint
_RESUME_CONFIG = ("epochs", "epochs_per_call", "seed", "batch_per_channel",
                  "mini_batch_per_channel", "loss_mode", "learn_alphas",
                  "alpha_damping", "alpha_floor")


def _uniform(generator, shape, dtype, device):
    """Every uniform draw of this module: latents and acceptance uniforms."""
    return torch.rand(shape, generator=generator, dtype=dtype, device=device)


def _seed(generator):
    """The seed of the per-channel unweighter's host schedule, in [0, 2^31 - 1)."""
    return int(torch.randint(0, np.iinfo(np.int32).max, (1,), generator=generator,
                             device=generator.device))


def _child_generator(generator, device):
    """A generator on ``device`` seeded by one draw of ``generator``."""
    seed = int(torch.randint(0, 1 << 62, (1,), generator=generator,
                             device=generator.device))
    return torch.Generator(device=device).manual_seed(seed)


def _n_latent(channel):
    return channel.nDimPhaseSpace() + (2 if channel.pdf_active else 0)


def _tiny(dtype):
    """nf_tpu's 1e-300 floor, raised to the dtype's smallest normal number:
    in float32 1e-300 rounds to 0 and the guard it stands for is lost."""
    return max(1e-300, torch.finfo(dtype).tiny)


def _dtype_device(models):
    p = next(models[0].parameters())
    return p.dtype, p.device


def build_channel_flows(generator, channels, n_cells, n_bins, nn_layers,
                        dtype=torch.float32, device="cuda", final_rank=None,
                        activation="exp"):
    """One identity-initialised PWQuad flow per channel, on the card unless
    the caller asks for the CPU (without a card, ``device="cuda"`` raises).

    Identity init makes the mixture start at the analytic channel maps'
    quality.  Each channel's weights come from its own generator, seeded by
    one draw of ``generator``.  Returns a tuple of ``FlowModel``s.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"build_channel_flows: no CUDA device for device={str(device)!r}; "
                           "pass device='cpu' to run on the CPU")
    n_lat = _n_latent(channels[0])
    models = []
    for _ in channels:
        gen_k = _child_generator(generator, device)
        models.append(factory.identity_init(factory.build_pwquad_flow(
            gen_k, n_lat, n_cells, n_bins, nn_layers, dtype, device,
            final_rank=final_rank, activation=activation)))
    return tuple(models)


def mixture_weights(channels, models, matrix_element, E_cm, generator,
                    batch_per_channel, alphas, pT_mincut=-1, delR_mincut=-1,
                    rap_maxcut=-1, pdgs=(0, 0), with_kinematics=False, mesh=None,
                    only_channel=None):
    """Draw stratified samples and return the mixture weights with their
    densities.

    Returns ``(w [C, B], aux)``: ``w[k]`` are the weights of channel k's
    samples (the integral estimate is ``sum_k alphas[k] * mean(w[k])``);
    ``aux["r"] [C, C, B]`` holds ``r[m, k] = (rho_m / ps_m) / q_hat``, what
    the Kleiss-Pittau update consumes; ``aux["q"] [C, B]`` the mixture
    density q_hat at each sample; ``aux["f"] [C, B]`` the matrix element.
    With ``with_kinematics``, ``aux["momenta"] [C, B, P, 4]`` and
    ``aux["xb"] [C, B, 2]`` (ones without a PDF).

    The samples are detached: the latents' forward, the phase space and the
    matrix element run without autograd, and gradients reach the flows'
    parameters only through rho_m (so ``w``, ``q`` and ``r`` carry them).
    Every flow runs in eval mode.  ``only_channel`` restricts the source of
    the samples to one channel (leading axis of length 1; the densities
    still go through every channel).  Latents are drawn channel by channel
    from ``generator`` through :func:`_uniform`.

    ``mesh`` shards each channel's batch over the mesh's ``"dp"`` axis: each
    rank maps its rows and the global arrays come back on every rank,
    differentiable (``batch_per_channel`` must divide by the mesh size).
    """
    group = group_of(mesh)
    w, aux = _mixture(channels, models, matrix_element, E_cm, generator, batch_per_channel,
                      alphas, pT_mincut, delR_mincut, rap_maxcut, pdgs, with_kinematics,
                      only_channel, group)
    if group is None:
        return w, aux

    def gather(t, axis):
        return all_gather_rows(t.movedim(axis, 0), group).movedim(0, axis)
    return gather(w, 1), {k: gather(v, 2 if k == "r" else 1) for k, v in aux.items()}


def _mixture(channels, models, matrix_element, E_cm, generator, batch_per_channel, alphas,
             pT_mincut, delR_mincut, rap_maxcut, pdgs, with_kinematics, only_channel, group):
    """:func:`mixture_weights` on this rank's rows of every channel's batch
    (all of it for ``group=None``): the arrays' batch axes hold the rank's
    rows."""
    dtype, device = _dtype_device(models)
    lo, hi = local_rows(batch_per_channel, group, "batch_per_channel")
    B = hi - lo
    n_lat = _n_latent(channels[0])
    alphas = torch.as_tensor(alphas, dtype=dtype, device=device)
    sources = range(len(channels)) if only_channel is None else [only_channel]
    ws, qs, rs, fs, moms, xbs = [], [], [], [], [], []
    for k in sources:
        ch = channels[k]
        with profiling.span("nf.mc.propose"):
            z = _uniform(generator, (batch_per_channel, n_lat), dtype, device)[lo:hi]
            with torch.no_grad():
                u_k, _ = models[k](z, False)
                u_k = torch.clamp(u_k, _EPS_U, 1.0 - _EPS_U)
                x, w_full = ch.generateKinematics_batch(
                    E_cm, u_k, pT_mincut=pT_mincut, delR_mincut=delR_mincut,
                    rap_maxcut=rap_maxcut, pdgs=pdgs)
                xb1 = xb2 = None
                if ch.pdf_active:
                    _, _, xb1, xb2, _ = ch._convolve_pdf(E_cm, u_k, pdgs)
        dens, ps_k = [], None
        for m, chm in enumerate(channels):
            with profiling.span("nf.mc.density"):
                with torch.no_grad():
                    ps_m = chm.channel_weight_ps(x)
                    if m == k:
                        ps_k, u_m, ok_m = ps_m, u_k, ps_m > 0
                    else:
                        u_m = chm.invertKinematics_batch(E_cm, x, xb1, xb2)
                        # in support: ps_m > 0 and the inverse inside the open
                        # cube (clip endpoints mark unreachable points)
                        ok_m = (ps_m > 0) & torch.all((u_m > 0.0) & (u_m < 1.0), dim=1)
                    u_m = torch.clamp(torch.where(ok_m[:, None], u_m, 0.5), _EPS_U,
                                      1.0 - _EPS_U)
                _, rho_m = flow_inverse(models[m].flow, models[m], u_m, train=False)
                dens.append(torch.where(ok_m, rho_m / torch.where(ok_m, ps_m, 1.0), 0.0))
        dens = torch.stack(dens, dim=0)                        # [C, B]
        q_hat = torch.sum(alphas[:, None] * dens, dim=0)
        with torch.no_grad():
            # C(x) = w_full / ps_k (PDF * cuts / flux; zero for cut events)
            ok = (ps_k > 0) & (q_hat > 0) & (w_full != 0)
            cfac = torch.where(ok, w_full / torch.where(ps_k > 0, ps_k, 1.0), 0.0)
            fval = matrix_element(x)
        ws.append(torch.where(ok, fval * cfac / torch.where(ok, q_hat, 1.0), 0.0))
        qs.append(q_hat)
        live = q_hat[None, :] > 0
        rs.append(torch.where(live, dens / torch.where(live, q_hat[None, :], 1.0), 0.0))
        fs.append(fval)
        if with_kinematics:
            moms.append(x)
            xbs.append(torch.stack([xb1, xb2], dim=-1) if ch.pdf_active
                       else torch.ones((B, 2), dtype=dtype, device=device))
    aux = {"r": torch.stack(rs, dim=1), "f": torch.stack(fs, dim=0),
           "q": torch.stack(qs, dim=0)}
    if with_kinematics:
        aux["momenta"] = torch.stack(moms, dim=0)       # [C, B, P, 4]
        aux["xb"] = torch.stack(xbs, dim=0)             # [C, B, 2]
    return torch.stack(ws, dim=0), aux


def _loss(loss_mode, w, aux, w_scale, alphas, group=None):
    """The training loss of the weights ``w [C, B]``.  Under a process
    ``group`` ``w`` and ``aux`` hold this rank's rows and the per-channel
    means are the global batch's (one all-reduce)."""
    wn = w / w_scale
    n = w.shape[1] * rank_and_size(group)[1]
    if loss_mode == "kl":
        # reweighted forward KL on the mixture density: -E[w~ log q_hat]
        # with w~ detached; gradients flow through every rho_m in q_hat,
        # and cut or out-of-support samples (w = 0) contribute 0
        logq = torch.log(torch.clamp_min(aux["q"], _tiny(w.dtype)))
        return -torch.sum(alphas * all_reduce_sum(torch.sum(wn.detach() * logq, dim=1),
                                                  group) / n)
    m2, m1 = (all_reduce_sum(torch.stack([torch.sum(wn ** 2, dim=1), torch.sum(wn, dim=1)]),
                             group) / n).unbind(0)
    if loss_mode == "var":
        return torch.sum(alphas * (m2 - m1 ** 2))
    return torch.sum(alphas * m2)


@profiling.spanned("nf.mc.train")
def train_multichannel(channels, models, matrix_element, E_cm, optimizer,
                       generator, alphas=None, batch_per_channel=4096, epochs=100,
                       loss_mode="var", learn_alphas=True, alpha_damping=0.5,
                       alpha_floor=1e-2, pT_mincut=-1, delR_mincut=-1, rap_maxcut=-1,
                       pdgs=(0, 0), mesh=None, mini_batch_per_channel=None,
                       epochs_per_call=None, save_state=None, resume_from=None,
                       stop_after_chunks=None):
    """Train per-channel flows (and Kleiss-Pittau alphas).

    ``models`` are copied: the caller's stay as they are.  ``optimizer`` is
    a factory of :mod:`nf_tpu_torch.training.optimizers`, bound to the
    parameters of every channel at once.  ``loss_mode``: ``"var"``
    (alpha-weighted within-channel variances), ``"secmom"`` (alpha-weighted
    second moment, the MadNIS objective) or ``"kl"`` (reweighted forward KL
    on the mixture density, mass-covering; nf_tpu's measured choice on
    narrow multi-resonance targets).  With ``learn_alphas`` the
    Kleiss-Pittau update runs on the device once per epoch with exponent
    ``alpha_damping / 2`` and floor ``alpha_floor``.

    The weights are scaled by ``w_scale``, the largest weight of one
    detached pilot batch at the initial parameters.  Each epoch runs
    ``batch_per_channel / mini_batch_per_channel`` minibatches, accumulating
    their gradients (averaged) and the epoch's weight sums, then takes one
    optimizer step.  The integral, ESS and Kleiss-Pittau sums are
    full-epoch estimates; the best (flows, alphas) is kept by mixture ESS.

    ``mesh`` trains data-parallel (module docstring): ``mini_batch_per_channel``
    must divide by the mesh size, the first rank's flows and generator state
    are broadcast to the others at the start, and only the first rank writes
    ``save_state``.

    ``epochs_per_call`` splits the epochs into chunks: the history is read
    back once per chunk, and with ``save_state`` (a path) the whole state
    (flows, optimizer, alphas, best snapshot, ``w_scale``, the generator's
    state, history) is checkpointed after every chunk.  ``resume_from``
    (a path) restores it and continues with the next chunk, reproducing the
    uninterrupted run; the checkpoint's generator seed (``generator
    .initial_seed()``), epochs, chunking, batch sizes and loss settings
    must equal this call's, or it raises.  ``stop_after_chunks`` (> 0)
    returns after that many chunks of this call.

    Returns a dict: ``params`` (the trained models), ``alphas``,
    ``best_params`` (models at the best epoch), ``best_alphas``,
    ``best_ess`` and per-epoch ``history`` numpy arrays (loss, integral,
    ess, alphas).  The alphas come back as numpy arrays.
    """
    if loss_mode not in ("var", "secmom", "kl"):
        raise ValueError(f"loss_mode={loss_mode!r} not in ('var', 'secmom', 'kl')")
    if stop_after_chunks is not None and stop_after_chunks <= 0:
        raise ValueError(f"stop_after_chunks={stop_after_chunks} must be positive")
    if mini_batch_per_channel is None:
        mini_batch_per_channel = batch_per_channel
    if batch_per_channel % mini_batch_per_channel != 0:
        raise ValueError(f"mini_batch_per_channel={mini_batch_per_channel} must divide "
                         f"batch_per_channel={batch_per_channel}")
    if epochs_per_call is None:
        epochs_per_call = epochs
    if epochs % epochs_per_call != 0:
        raise ValueError(f"epochs_per_call={epochs_per_call} must divide epochs={epochs}")
    n_mb, mb = batch_per_channel // mini_batch_per_channel, mini_batch_per_channel
    n_calls = epochs // epochs_per_call
    config = {"epochs": epochs, "epochs_per_call": epochs_per_call,
              "seed": generator.initial_seed(), "batch_per_channel": batch_per_channel,
              "mini_batch_per_channel": mb, "loss_mode": loss_mode,
              "learn_alphas": bool(learn_alphas), "alpha_damping": float(alpha_damping),
              "alpha_floor": float(alpha_floor)}

    dtype, device = _dtype_device(models)
    C = len(channels)
    if alphas is None:
        alphas = np.full((C,), 1.0 / C)
    alphas = torch.as_tensor(np.asarray(alphas, np.float64) / np.sum(alphas), dtype=dtype,
                             device=device)
    models = tuple(copy.deepcopy(m) for m in models)
    group = group_of(mesh)
    broadcast_replicas(models, group, generator)
    best_models = tuple(copy.deepcopy(m) for m in models)
    params = [p for m in models for p in m.parameters()]
    best_params = [p for m in best_models for p in m.parameters()]
    opt = optimizer(params)
    tiny = _tiny(dtype)
    best_ess = torch.tensor(-1.0, dtype=dtype, device=device)
    best_alphas = alphas.clone()
    w_scale = torch.ones((), dtype=dtype, device=device)
    kw = dict(pT_mincut=pT_mincut, delR_mincut=delR_mincut, rap_maxcut=rap_maxcut, pdgs=pdgs,
              with_kinematics=False, only_channel=None, group=group)
    # the history: read back chunks (host) and this chunk's epochs (device)
    hist_host = {name: [] for name in _HISTORY}
    hist_dev = {name: [] for name in _HISTORY}

    def snapshot(c_done, opt_state, hist):
        return {"c": c_done, "config": config, "generator": generator.get_state(),
                "w_scale": w_scale, "models": [m.state_dict() for m in models],
                "best_models": [m.state_dict() for m in best_models], "opt": opt_state,
                "alphas": alphas, "best_ess": best_ess, "best_alphas": best_alphas,
                "hist": hist}

    c_start = 0
    if resume_from is not None:
        payload = checkpoint.load(resume_from, snapshot(0, None, None))
        diff = [k for k in _RESUME_CONFIG if payload["config"][k] != config[k]]
        if diff:
            raise ValueError("resume_from was written with another "
                             + ", ".join(f"{k} ({payload['config'][k]!r}, now "
                                         f"{config[k]!r})" for k in diff))
        for m, sd in zip(models + best_models, payload["models"] + payload["best_models"]):
            m.load_state_dict(sd)
        opt.load_state_dict(payload["opt"])
        generator.set_state(payload["generator"])
        w_scale, alphas = payload["w_scale"], payload["alphas"]
        best_ess, best_alphas = payload["best_ess"], payload["best_alphas"]
        c_start = int(payload["c"])
        hist_host = {name: [torch.as_tensor(payload["hist"][name])] for name in _HISTORY}
    else:
        # the weight scale (the manager's maxf): one detached pass at the
        # initial parameters keeps the loss O(1)
        with torch.no_grad(), profiling.span("nf.mc.pilot"):
            w0, _ = _mixture(channels, models, matrix_element, E_cm, generator, mb, alphas,
                             **kw)
            w_scale = torch.clamp_min(all_reduce_max(torch.max(w0), group), tiny)

    @profiling.spanned("nf.mc.epoch")
    def epoch():
        nonlocal alphas, best_ess, best_alphas
        opt.zero_grad(set_to_none=True)
        zeros = torch.zeros((C,), dtype=dtype, device=device)
        loss_sum, s1, s2, sW = torch.zeros((), dtype=dtype, device=device), zeros, zeros, zeros
        for _ in range(n_mb):
            w, aux = _mixture(channels, models, matrix_element, E_cm, generator, mb, alphas,
                              **kw)
            with profiling.span("nf.mc.loss"):
                loss = _loss(loss_mode, w, aux, w_scale, alphas, group)
            with profiling.span("nf.mc.backward"):
                loss.backward()
            w = w.detach()
            loss_sum = loss_sum + loss.detach()
            s1 = s1 + torch.sum(w, dim=1)
            s2 = s2 + torch.sum(w ** 2, dim=1)
            # Kleiss-Pittau numerator sums W_m = E[(f/q)^2 p_m], stratified
            sW = sW + torch.sum(alphas[None, :, None] * w[None, :, :] ** 2
                                * aux["r"].detach(), dim=(1, 2))
        with profiling.span("nf.mc.step"):
            average_gradients(params, group, n_mb)
            opt.step()
        with torch.no_grad(), profiling.span("nf.mc.alphas"):
            s1, s2, sW = all_reduce_sum(torch.stack([s1, s2, sW]), group).unbind(0)
            m1 = torch.sum(alphas * s1) / batch_per_channel
            m2 = torch.sum(alphas * s2) / batch_per_channel
            ess = m1 ** 2 / torch.clamp_min(m2, tiny)
            improved = ess > best_ess
            best_ess = torch.where(improved, ess, best_ess)
            for bp, p in zip(best_params, params):
                bp.copy_(torch.where(improved, p, bp))
            best_alphas = torch.where(improved, alphas, best_alphas)
            if learn_alphas:
                W = sW / batch_per_channel
                new = alphas * torch.pow(torch.clamp_min(
                    W / torch.clamp_min(torch.max(W), tiny), 1e-12), alpha_damping / 2.0)
                new = torch.clamp_min(new / torch.sum(new), alpha_floor)
                alphas = new / torch.sum(new)
        for name, value in zip(_HISTORY, (loss_sum / n_mb, m1, ess, alphas)):
            hist_dev[name].append(value[None])

    for c in range(c_start, n_calls):
        for _ in range(epochs_per_call):
            epoch()
        with profiling.span("nf.read.history"):     # one read-back per chunk
            profiling.HOST_READS += len(_HISTORY)
            for name in _HISTORY:
                hist_host[name].append(torch.cat(hist_dev[name]).cpu())
                hist_dev[name].clear()
        if save_state is not None and rank_and_size(group)[0] == 0:
            checkpoint.save(save_state, snapshot(c + 1, opt.state_dict(), {
                name: torch.cat(v).numpy() for name, v in hist_host.items()}))
        if stop_after_chunks is not None and c + 1 - c_start >= stop_after_chunks:
            break
    history = {name: torch.cat(v).numpy() for name, v in hist_host.items()}
    with profiling.span("nf.read.history"):
        profiling.HOST_READS += 3
        alphas, best_alphas, best_ess = (alphas.cpu().numpy(), best_alphas.cpu().numpy(),
                                         float(best_ess))
    return {"params": models, "alphas": alphas, "best_params": best_models,
            "best_alphas": best_alphas, "best_ess": best_ess, "history": history}


@torch.no_grad()
def multichannel_sample(channels, models, matrix_element, E_cm, generator, n_per_channel,
                        alphas, **kw):
    """Eval-mode stratified sample without autograd: ``(weights [C, B],
    aux)`` from :func:`mixture_weights`, for integration
    (:func:`combine_stratified`) and unweighting."""
    return mixture_weights(channels, models, matrix_element, E_cm, generator, n_per_channel,
                           alphas, **kw)


def _accepted(acc, mom, xb, v, n_over, w_sum):
    """The accepted rows of one device batch and its bookkeeping, gathered
    on the device and copied to the host in one block.

    ``acc`` and ``v`` are ``[n]`` (or ``[C, B]``), ``mom`` ``[.., P, 4]``,
    ``xb`` ``[.., 2]``; ``n_over`` and ``w_sum`` are device scalars.  Returns
    numpy ``(momenta [a, P, 4], xb [a, 2], v [a], n_over, w_sum)`` of the
    ``a`` accepted rows, in proposal order."""
    n_p = mom.shape[-2]
    rows = torch.cat([mom.reshape(-1, n_p * 4), xb.reshape(-1, 2), v.reshape(-1, 1)],
                     dim=1)[acc.reshape(-1)]
    block = torch.cat([rows.reshape(-1), torch.stack([n_over.to(v.dtype), w_sum])])
    block = block.cpu().numpy()
    rows = block[:-2].reshape(-1, n_p * 4 + 3)
    return (rows[:, :n_p * 4].reshape(-1, n_p, 4), rows[:, n_p * 4:-1], rows[:, -1],
            int(block[-2]), float(block[-1]))


@torch.no_grad()
def multichannel_unweight(channels, models, matrix_element, E_cm, generator, alphas,
                          n_events, batch_per_channel=1 << 15, w_max=None,
                          wmax_quantile=1.0, max_batches=1000, per_channel_max=False,
                          partial_unweight=False, compact=True, batches_per_call=8, **kw):
    """Unweighted event generation from the learned mixture (host loop).

    Strata are equal-size, so channel k's proposals are accepted with
    probability ``C * alpha_k * w / w_max``: the accepted density is then
    exactly proportional to f(x).  ``w_max`` bounds ``C * alpha_k * w``;
    when absent it is 1.05 times the largest (``wmax_quantile < 1``: that
    quantile) of one pilot batch, and over-weight events are accepted and
    counted.

    ``partial_unweight=True``: acceptance is unchanged, but every accepted
    event carries the weight ``max(1, v / w_max)``, so the weighted sample
    is exactly f-distributed at any ``wmax_quantile``.  The return is then
    ``(events, xb, weights, info)`` with ``info = {"eff", "accept_rate",
    "n_overweight", "w_max"}``, ``eff`` the Kish effective efficiency
    ``(sum w)^2 / sum w^2 / n_proposals``.

    ``per_channel_max=True``: per-channel maxima (see
    :func:`_unweight_per_channel_max`): channel k accepts with probability
    ``w / w_max_k``, each batch's source channel drawn i.i.d. with
    probability ``alpha_k w_max_k`` (partial mode: thinned all-channel
    rounds); efficiency ``sigma / sum_k alpha_k w_max_k``.

    Each batch is accepted on the device, and its accepted rows are
    gathered there and copied to the host in one block (:func:`_accepted`).
    ``compact`` and ``batches_per_call`` are accepted for nf_tpu's signature
    and ignored: nf_tpu gathers into a fixed capacity because its compiled
    programs need static shapes; here the gather is exact, and a copy per
    batch costs nothing measurable beside the batch's ``mixture_weights``
    (PERF.md).

    Returns ``(events [>= n_events, n_particles, 4] COM momenta, xb [n, 2],
    efficiency, n_overweight)`` as numpy arrays and numbers.
    """
    if per_channel_max:
        return _unweight_per_channel_max(
            channels, models, matrix_element, E_cm, generator, alphas, n_events,
            batch_per_channel, w_max, wmax_quantile, max_batches,
            partial_unweight=partial_unweight, **kw)
    dtype, device = _dtype_device(models)
    C = len(channels)
    alphas = torch.as_tensor(alphas, dtype=dtype, device=device)

    def batch():
        w, aux = mixture_weights(channels, models, matrix_element, E_cm, generator,
                                 batch_per_channel, alphas, with_kinematics=True, **kw)
        v = C * alphas[:, None] * w
        u = _uniform(generator, v.shape, v.dtype, v.device)
        return v, u, aux["momenta"], aux["xb"]

    if w_max is None:
        v = batch()[0]
        ref = torch.max(v) if wmax_quantile >= 1.0 else _quantile(v.reshape(-1), wmax_quantile)
        w_max = float(ref) * 1.05

    out_ev, out_xb, out_w = [], [], []
    n_acc, n_prop, n_over, v_sum = 0, 0, 0, 0.0
    for _ in range(max_batches):
        v, u, mom, xb = batch()
        mom_a, xb_a, v_a, over, total = _accepted(u * w_max < v, mom, xb, v,
                                                  torch.sum(v > w_max), torch.sum(v))
        out_ev.append(mom_a)
        out_xb.append(xb_a)
        if partial_unweight:
            out_w.append(np.maximum(1.0, v_a / w_max))
        n_acc += len(v_a)
        n_prop += v.numel()
        n_over += over
        v_sum += total
        if n_acc >= n_events:
            break
    events = np.concatenate(out_ev, axis=0)
    xbs = np.concatenate(out_xb, axis=0)
    if partial_unweight:
        wts = np.concatenate(out_w, axis=0)
        kish = float(wts.sum()) ** 2 / max(float((wts ** 2).sum()), 1e-300)
        info = {"eff": kish / max(n_prop, 1), "accept_rate": n_acc / max(n_prop, 1),
                "n_overweight": n_over, "w_max": float(w_max)}
        return events, xbs, wts, info
    # efficiency = E[v] / w_max over all proposals
    return events, xbs, v_sum / max(n_prop, 1) / w_max, n_over

def _knapsack(pilots, a_np, B, wmax_quantile):
    """Per-channel thresholds from the pilots' descending order statistics:
    repeatedly lower the threshold of the channel that buys the largest
    ``alpha_k * delta(w_max_k)`` per unit of expected overweight rate, until
    the expected overweight fraction reaches ``1 - wmax_quantile``.

    No cut leaves a channel's schedule share ``alpha_k t_k / sum_j alpha_j
    t_j`` below ``_MIN_SHARE`` of its share at the pilot maxima.  Without
    that floor the greedy runs away (nf_tpu's does): a cut shrinks the
    channel's share and with it the overweight cost of its next cut, so at
    a loose quantile it descends to the channel's smallest pilot weights (0
    where they are), and the channel is all but never proposed or,
    partially unweighted, thinned to nothing while its events would carry
    weights past 1e30.  The floor keeps every live channel's thinning
    ``a_k >= _MIN_SHARE * share_k``; where it does not bind, the thresholds
    are nf_tpu's."""
    C = len(pilots)
    t = np.array([p[0] for p in pilots], np.float64)
    share0 = a_np * t / np.sum(a_np * t)
    cuts = np.zeros(C, np.int64)
    eps = 1.0 - float(wmax_quantile)
    cap = max(int(B * max(eps, 1e-6) * 100), 10)
    while eps > 0:
        shares = a_np * t
        live = shares > 0
        shares = shares / shares.sum()
        frac = float(np.sum(shares * cuts / B))
        best, best_gain = -1, 0.0
        for k in range(C):
            if not live[k] or cuts[k] + 1 >= min(cap, B):
                continue
            if frac + shares[k] / B > eps:
                continue
            rate = a_np * t
            rate[k] = a_np[k] * pilots[k][cuts[k] + 1]
            if rate[k] < _MIN_SHARE * share0[k] * rate.sum():
                continue
            # cutting channel k's next order statistic lowers sum alpha_j
            # w_max_j by alpha_k (t_k - next) at ~shares_k / B overweight
            gain = a_np[k] * (t[k] - pilots[k][cuts[k] + 1]) / (shares[k] / B)
            if gain > best_gain:
                best_gain, best = gain, k
        if best < 0:
            break
        cuts[best] += 1
        t[best] = pilots[best][cuts[best]]
    if eps > 0 and not cuts.any():
        warnings.warn(
            "per-channel knapsack made zero cuts (budget "
            f"1-q={eps:.2e} < min share/B): thresholds degenerate to "
            "the strict pilot maxima; consider a larger "
            "batch_per_channel or a looser wmax_quantile",
            stacklevel=3)
    return t * 1.05


def _unweight_per_channel_max(channels, models, matrix_element, E_cm, generator, alphas,
                              n_events, B, w_max, wmax_quantile, max_batches,
                              partial_unweight=False, **kw):
    """Per-channel-max unweighting (see :func:`multichannel_unweight`).

    ``w_max`` may be a length-C sequence of per-channel bounds; when absent
    they come from one pilot batch per channel: the pilot maxima at
    ``wmax_quantile=1``, else the greedy knapsack of :func:`_knapsack` (it
    warns when the budget admits no cut).  Each batch's source channel is
    drawn i.i.d. with probability ``alpha_k w_max_k`` by a host RNG seeded
    from ``generator``: i.i.d. batches keep the accepted sample exactly
    f-distributed under any stopping rule.  Channels whose maximum is 0 are
    left out of the schedule, with a warning.  The efficiency's sigma
    counts the pilot batches too.

    Partial mode runs every live channel each round and thins channel k by
    ``a_k = rate_k / max(rate)``: the accepted weighted density from channel
    k is ``q_k a_k min(1, w/w_max_k) max(1, w/w_max_k) ∝ alpha_k q_k f /
    q_hat``, summing to f, with the composition exact per round; the
    thinning's waste counts against the efficiency.
    """
    dtype, device = _dtype_device(models)
    C = len(channels)
    alphas = torch.as_tensor(alphas, dtype=dtype, device=device)
    a_np = alphas.cpu().numpy().astype(np.float64)

    def batch(k):
        w, aux = mixture_weights(channels, models, matrix_element, E_cm, generator, B, alphas,
                                 with_kinematics=True, only_channel=k, **kw)
        u = _uniform(generator, (B,), w.dtype, w.device)
        return w[0], u, aux["momenta"][0], aux["xb"][0]

    # sigma accumulators: the pilot batches are folded in, so every channel
    # contributes to the efficiency's sigma even without a generation batch
    w_sum = np.zeros(C)
    n_prop_k = np.zeros(C, np.int64)

    if w_max is None:
        pilots = []
        for k in range(C):
            v_np = batch(k)[0].cpu().numpy()
            w_sum[k] += float(v_np.sum())
            n_prop_k[k] += B
            pilots.append(np.sort(v_np)[::-1])
        w_max = _knapsack(pilots, a_np, B, wmax_quantile)
    else:
        w_max = np.broadcast_to(np.asarray(w_max, np.float64), (C,)).copy()
    if np.any(w_max < 0):
        raise ValueError(f"per-channel w_max must be non-negative: {w_max}")
    if np.all(w_max == 0):
        raise ValueError("all per-channel maxima are 0 — every pilot "
                         "proposal failed cuts in every channel")
    if np.any(w_max == 0):
        warnings.warn(
            "channels with zero pilot maximum excluded from the "
            f"schedule: {np.flatnonzero(w_max == 0).tolist()} — enlarge "
            "batch_per_channel if their true maxima are nonzero",
            stacklevel=3)

    rate = a_np * w_max
    p_src = rate / rate.sum()
    host_rng = np.random.default_rng(_seed(generator))
    wm = torch.as_tensor(w_max, dtype=dtype, device=device)

    out_ev, out_xb, out_w = [], [], []
    n_acc, n_prop, n_over = 0, 0, 0

    def take(k, acc, mom, xb, v, over, w):
        nonlocal n_acc, n_prop, n_over
        mom_a, xb_a, v_a, n_o, total = _accepted(acc, mom, xb, v, torch.sum(over), torch.sum(w))
        out_ev.append(mom_a)
        out_xb.append(xb_a)
        if partial_unweight:
            out_w.append(np.maximum(1.0, v_a))
        n_acc += len(v_a)
        n_prop += B
        n_prop_k[k] += B
        n_over += n_o
        w_sum[k] += total

    if partial_unweight:
        at = torch.as_tensor(rate / max(rate.max(), 1e-300), dtype=dtype, device=device)
        for _ in range(max_batches):
            for k in np.flatnonzero(rate > 0):
                w, u, mom, xb = batch(k)
                r = w / wm[k]
                take(k, u < at[k] * torch.clamp(r, max=1.0), mom, xb, r, r > 1.0, w)
            if n_acc >= n_events:
                break
        events = np.concatenate(out_ev, axis=0)
        xbs = np.concatenate(out_xb, axis=0)
        wts = np.concatenate(out_w, axis=0)
        kish = float(wts.sum()) ** 2 / max(float((wts ** 2).sum()), 1e-300)
        info = {"eff": kish / max(n_prop, 1), "accept_rate": n_acc / max(n_prop, 1),
                "n_overweight": n_over, "w_max": np.asarray(w_max)}
        return events, xbs, wts, info

    for _ in range(max_batches):
        k = int(host_rng.choice(C, p=p_src))
        w, u, mom, xb = batch(k)
        take(k, u * wm[k] < w, mom, xb, w, w > wm[k], w)
        if n_acc >= n_events:
            break
    events = np.concatenate(out_ev, axis=0)
    xbs = np.concatenate(out_xb, axis=0)
    # efficiency = sigma / sum_k alpha_k w_max_k, sigma from the proposals
    # themselves, pilots included: sigma = sum_k alpha_k E_k[w]
    ran = n_prop_k > 0
    sigma = float(np.sum(a_np[ran] * w_sum[ran] / n_prop_k[ran]))
    return events, xbs, sigma / float(np.sum(a_np * w_max)), n_over


def combine_stratified(w, alphas):
    """Combine stratified per-channel weights ``w [C, B]`` into the unbiased
    ``(integral, error, ess)``: the alpha-weighted sum of per-channel means,
    with the stratified error sqrt(sum_k alpha_k^2 Var_k / B)."""
    alphas = torch.as_tensor(alphas, dtype=w.dtype, device=w.device)
    B = w.shape[1]
    m1 = torch.sum(alphas * torch.mean(w, dim=1))
    m2 = torch.sum(alphas * torch.mean(w ** 2, dim=1))
    var_k = torch.var(w, dim=1, correction=1)
    err = torch.sqrt(torch.sum(alphas ** 2 * var_k) / B)
    ess = m1 ** 2 / torch.clamp_min(m2, _tiny(w.dtype))
    return m1, err, ess
