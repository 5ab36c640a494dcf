"""The chunked epoch cadence: ``k`` epochs of the trainer to one host read.

Counterpart of the chunk of nf_tpu's trainer (``chunk_fn``,
nf_tpu/training/manager.py:572-643).  The trainer's state machine runs on the
device as it does in nf_tpu: the preburn flag, the kill counter with
``end_pre_kill`` and ``killed``, ``last_loss``, the preburn exit, the best
metric (loss, or ESS) and the best ``(parameters, BatchNorm buffers)``
snapshot, taken where ``improved = ~pre & ~killed & better``: one step,
:func:`advance`, which the ensemble (training/ensemble.py) runs over
``[R]`` runs and the chunk over one, into 0-dim tensors updated in place.  Every epoch writes one row, ``[loss, var, integ,
err, ess, preburn at the epoch's start, kill counter after it]``; the
manager reads a chunk's rows in one transfer and runs its host state machine
over them (the one source of truth for bookkeeping, and the check on this
one).

An epoch is the manager's own: ``train(pre, ws)``, its minibatch step with
the preburn choice made on the device (``manager.epoch_step``), on latents
drawn in the per-epoch order, and with the stale trainer ``refresh()`` after
it when ``i % stats_every == 0``.  So a chunk draws what the per-epoch loop
draws and computes what it computes: on the CPU a chunked run equals the
per-epoch run bit for bit.  (nf_tpu's chunk changes its latents through the
key split, PARITY.md:48-51; the port's chunk does not.)

With ``graphs`` (the manager's rule: a CUDA device and no mesh) the epoch and
the refresh are CUDA graphs: each is first run eagerly, as a real epoch of
the run, on the runner's stream, then captured (capture records and runs
nothing), and replayed from then on; a chunk is ``k`` replays launched
without a host sync.  The manager's generator is registered with each graph,
so a replay draws what an eager epoch draws at the same offset.  The
kernels' launch counters (``pwquad_train.FWD_LAUNCHES`` / ``BWD_LAUNCHES`` /
``BWD_TILED_LAUNCHES``, ``optim_step.LAUNCHES``) are Python counters, which a replay does not move:
the launches a capture recorded are added once per replay, and the capture
itself counts none.  (``profiling.HOST_READS`` is not among them: a replay
reads nothing to the host.)  A failed capture or replay raises, naming the
call that could not be captured; nothing falls back to the eager chunk.  A capture
keeps CUPTI set up between profiler traces from then on (:func:`_keep_cupti`):
torn down and set up again after a capture, it drops device records.

Spans (:mod:`nf_tpu_torch.utils.profiling`): ``nf.chunk.run`` is one
chunk; inside it, for the epoch and the refresh alike (``<name>``),
``nf.chunk.eager.<name>`` an eager run (with graphs, the graph's first),
``nf.chunk.capture.<name>`` the capture and instantiation,
``nf.chunk.first_replay.<name>`` the first replay after it (where the
graph is uploaded) and ``nf.chunk.replay.<name>`` every later one.

The optimizer's step inside a graph is the manager's ``stepper``, a
:class:`~nf_tpu_torch.training.optimizers.DeviceStep`: the update kernel,
which reads each step's bias correction from float64 tables at a step count
on the device, so a replay rounds as torch's per-epoch step does and a chunk
on the card equals the per-epoch run bit for bit.  The runner counts the
``k`` steps of each chunk on it (:meth:`~nf_tpu_torch.training.optimizers
.DeviceStep.advance`).  An optimizer the kernel does not cover runs torch's
capturable step instead (``stepper`` is ``None``), which rounds its bias
correction otherwise: there the two cadences agree within that rounding.
The optimizer's state must exist before the capture: the eager first epoch
makes it.

:meth:`EpochChunk.save` and :meth:`EpochChunk.restore` let the manager
replay a chunk from its start up to a stop that fell inside it, so a
mid-chunk stop leaves the parameters, buffers, optimizer state (the device
step count too) and generator state of the stop epoch.  The optimizer's
state must start at zeros (it does for torch.optim's Adam family): a chunk
that began before the first step restores it as zeros.
"""

from __future__ import annotations

import contextlib
import copy
import os
import traceback

import torch

from nf_tpu_torch.ops import optim_step, pwquad_train
from nf_tpu_torch.utils import profiling

# the kernels' launch counters, which a graph replay adds to
COUNTERS = ((pwquad_train, "FWD_LAUNCHES"), (pwquad_train, "BWD_LAUNCHES"),
            (pwquad_train, "BWD_TILED_LAUNCHES"), (optim_step, "LAUNCHES"))
# one epoch's row: the five statistics of epoch_step, then the preburn flag
# at the epoch's start and the kill counter after it
ROW = 7
# the spans of a graph's life, by phase and by the name of what it runs
SPANS = {(phase, name): f"nf.chunk.{phase}.{name}"
         for phase in ("eager", "capture", "first_replay", "replay")
         for name in ("epoch", "refresh")}


def _counts():
    return [getattr(module, name) for module, name in COUNTERS]


def _add_counts(delta):
    for (module, name), d in zip(COUNTERS, delta):
        setattr(module, name, getattr(module, name) + d)


def _keep_cupti():
    """Keep CUPTI set up between ``torch.profiler`` traces.  By default a
    trace tears CUPTI down when it stops and sets it up again at the next;
    after a process has captured a CUDA graph, the traces set up again lose
    device records, some or all of a call's (chip_smoke.py phase 13 on an
    NVIDIA H100 with CUDA 12.8: none of a ToyPDF call's six, three traces
    running).  torch sets the
    same two variables for inductor's CUDA graphs; the profiler reads them
    when a trace stops."""
    os.environ["TEARDOWN_CUPTI"] = "0"
    os.environ["DISABLE_CUPTI_LAZY_REINIT"] = "1"


def _first_error(error):
    """The error a failed capture started with: ending the capture raises
    another, whose context it is."""
    while error.__context__ is not None and error.__context__ is not error:
        error = error.__context__
    return error


def _culprit(error):
    """The innermost call outside torch in ``error``'s traceback."""
    frames = traceback.extract_tb(error.__traceback__)
    outside = [f for f in frames if f"{os.sep}torch{os.sep}" not in f.filename]
    f = (outside or frames)[-1]
    return f"{f.filename}:{f.lineno} ({f.line})"


def advance(pre, killed, counter, last_loss, b_metric, loss, ess, epoch, pre_ref, *,
            by_ess, kill_counter, preburn_time):
    """One epoch of the trainer's state machine on the device (nf_tpu
    manager.py:590-622, ensemble.py:253-276), elementwise over any leading
    shape: ``[]`` for one run, ``[R]`` for the ensemble.  ``loss`` / ``ess``
    are the epoch's, ``epoch`` its index, ``pre_ref`` the loss the preburn
    exit compares with.  Returns ``(improved, b_metric, counter, killed,
    pre)`` after the epoch; ``last_loss`` becomes ``loss``."""
    metric = ess if by_ess else loss
    better = metric > b_metric if by_ess else metric < b_metric
    improved = ~pre & ~killed & better
    b_metric = torch.where(improved, metric, b_metric)
    counter = torch.where(loss < last_loss, 0, counter + 1)
    overflow = counter > kill_counter
    end_pre_kill = overflow & pre
    killed = killed | (overflow & ~pre)
    counter = torch.where(end_pre_kill, 0, counter)
    # the preburn exit
    leave = end_pre_kill | (loss < 0.25 * pre_ref) | (epoch > preburn_time)
    return improved, b_metric, counter, killed, pre & ~leave


class EpochChunk:
    """Chunks of epochs of one run of ``model``, the state machine on its
    device.

    ``train(pre, ws) -> [loss, var, integ, err, ess]`` is one epoch's step
    on the minibatches ``ws`` (``pre`` a 0-dim bool tensor),
    ``refresh()`` the stale trainer's statistics refresh or ``None``, both
    from the manager's epoch runner; ``uniform(shape)`` draws latents from
    ``generator``.  ``graphs`` replays CUDA graphs of the epoch and the
    refresh; ``stepper`` is the device step ``train`` steps through, or
    ``None`` (module docstring).
    """

    def __init__(self, model, optimizer, train, refresh, uniform, generator, *,
                 n_minibatches, mini_batch_size, stats_every, preburn_time, kill_counter,
                 by_ess, graphs, stepper=None):
        p = next(model.parameters())
        device, dtype = p.device, p.dtype
        if graphs and device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, the model is on {device}")
        self.model, self.optimizer, self.generator = model, optimizer, generator
        self.stepper = stepper
        self._train, self._refresh, self._uniform = train, refresh, uniform
        self._mb_shape = (mini_batch_size, model.flow.n_flow)
        self._n_mb, self._stats_every = n_minibatches, stats_every
        self._preburn_time, self._kill_counter, self._by_ess = preburn_time, kill_counter, by_ess
        self.graphs = graphs
        # the snapshot: the live tensors gathered into one flat vector, the
        # best kept as another, so one where() takes it
        self._live = list(model.parameters()) + list(model.buffers())
        n = sum(t.numel() for t in self._live)
        self._live_flat = torch.empty(n, dtype=dtype, device=device)
        self._best_flat = torch.empty(n, dtype=dtype, device=device)

        def scalar(dt):
            return torch.zeros((), dtype=dt, device=device)

        self._pre, self._killed, self._improved = (scalar(torch.bool) for _ in range(3))
        self._counter, self._epoch = scalar(torch.int64), scalar(torch.int64)
        self._last_loss, self._b_metric, self._pre_ref = (scalar(dtype) for _ in range(3))
        self._row = torch.zeros(ROW, dtype=dtype, device=device)
        self._saved = None
        if graphs:
            self.stream = torch.cuda.Stream(device)
            self._graph, self._captured, self._replayed = {}, {}, set()

    # -- one epoch, one refresh (what the graphs hold) ----------------------

    def _snapshot(self):
        torch.cat([t.detach().reshape(-1) for t in self._live], out=self._live_flat)
        torch.where(self._improved, self._live_flat, self._best_flat, out=self._best_flat)

    def _run_epoch(self):
        ws = [self._uniform(self._mb_shape) for _ in range(self._n_mb)]
        stats = self._train(self._pre, ws)
        with torch.no_grad():
            self._advance(stats)

    def _run_refresh(self):
        self._refresh()
        with torch.no_grad():
            # the buffers the refresh moved, into the snapshot the epoch took
            self._snapshot()

    def _advance(self, stats):
        """The state machine after one epoch (:func:`advance`), into the
        tensors the graphs hold."""
        loss, ess = stats[0], stats[4]
        improved, b_metric, counter, killed, pre = advance(
            self._pre, self._killed, self._counter, self._last_loss, self._b_metric, loss, ess,
            self._epoch, self._pre_ref, by_ess=self._by_ess, kill_counter=self._kill_counter,
            preburn_time=self._preburn_time)
        self._improved.copy_(improved)
        self._b_metric.copy_(b_metric)
        self._snapshot()
        torch.cat([stats, self._pre.to(stats.dtype)[None], counter.to(stats.dtype)[None]],
                  out=self._row)
        self._pre.copy_(pre)
        self._killed.copy_(killed)
        self._counter.copy_(counter)
        self._last_loss.copy_(loss)
        self._epoch.add_(1)

    # -- graphs ---------------------------------------------------------------

    def _call(self, name, fn):
        """``fn`` eagerly, or its graph: the first call runs it and captures it."""
        graph = self._graph.get(name) if self.graphs else None
        if graph is not None:
            phase = "replay" if name in self._replayed else "first_replay"
            with profiling.span(SPANS[phase, name]):
                graph.replay()
            self._replayed.add(name)
            _add_counts(self._captured[name])
            return
        with profiling.span(SPANS["eager", name]):
            fn()
        if not self.graphs:
            return
        _keep_cupti()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        before = _counts()
        try:
            with profiling.span(SPANS["capture", name]), \
                    torch.cuda.graph(graph, stream=self.stream):
                fn()
            self._captured[name] = [b - a for a, b in zip(before, _counts())]
        except RuntimeError as e:
            first = _first_error(e)
            raise RuntimeError(
                f"the chunk's {name} could not be captured as a CUDA graph at "
                f"{_culprit(first)}: {str(first).splitlines()[0]}.  A call inside the graph "
                "read the host or copied from it; the integrand runs there and must be "
                "capturable.  epochs_per_sync=1 trains without graphs") from e
        finally:
            _add_counts([a - b for a, b in zip(before, _counts())])
        self._graph[name] = graph

    # -- chunks ---------------------------------------------------------------

    @profiling.spanned("nf.chunk.run")
    def run(self, i0, k, init):
        """Epochs ``i0 .. i0 + k - 1``: returns their rows ``[k, ROW]`` on the
        device, not read.  ``init = (preburn, counter, last_loss, best
        metric, best loss, best model)`` is the host machine's state at
        ``i0``."""
        if self.stepper is not None:
            self.stepper.advance(k)
        device = self._row.device
        rows = torch.empty((k, ROW), dtype=self._row.dtype, device=device)
        ctx = contextlib.nullcontext()
        if self.graphs:
            self.stream.wait_stream(torch.cuda.current_stream(device))
            ctx = torch.cuda.stream(self.stream)
        with ctx:
            self._load(i0, init)
            for j in range(k):
                self._call("epoch", self._run_epoch)
                rows[j].copy_(self._row)
                if self._refresh is not None and (i0 + j) % self._stats_every == 0:
                    self._call("refresh", self._run_refresh)
        if self.graphs:
            torch.cuda.current_stream(device).wait_stream(self.stream)
        return rows

    def _load(self, i0, init):
        pre, counter, last_loss, b_metric, pre_ref, best = init
        with torch.no_grad():
            self._pre.fill_(bool(pre))
            self._killed.fill_(False)
            self._counter.fill_(int(counter))
            self._epoch.fill_(int(i0))
            self._last_loss.fill_(last_loss)
            self._b_metric.fill_(b_metric)
            self._pre_ref.fill_(pre_ref)
            torch.cat([t.detach().reshape(-1) for t in
                       list(best.parameters()) + list(best.buffers())], out=self._best_flat)

    def _opt_tensors(self):
        return [v for state in self.optimizer.state.values() for v in state.values()
                if torch.is_tensor(v)]

    def save(self):
        """Keep the state a replay from here restores: the parameters and
        buffers, the optimizer's state and the generator's."""
        with torch.no_grad():
            self._saved = ([t.detach().clone() for t in self._live],
                           [t.clone() for t in self._opt_tensors()],
                           self.generator.get_state(),
                           None if self.stepper is None else self.stepper.save())

    def restore(self):
        """Put back the state :meth:`save` kept, in place (a graph holds the
        tensors): optimizer state made after it restarts at zeros."""
        live, opt, gen_state, step = self._saved
        with torch.no_grad():
            for t, s in zip(self._live, live):
                t.copy_(s)
            tensors = self._opt_tensors()
            if opt:
                for t, s in zip(tensors, opt, strict=True):
                    t.copy_(s)
            else:
                for t in tensors:
                    t.zero_()
            if step is not None:
                self.stepper.restore(step)
        self.generator.set_state(gen_state)

    def best_model(self):
        """A copy of the model that holds the best snapshot."""
        best = copy.deepcopy(self.model)
        tensors = list(best.parameters()) + list(best.buffers())
        with torch.no_grad():
            for t, v in zip(tensors, torch.split(self._best_flat, [t.numel() for t in tensors])):
                t.copy_(v.view_as(t))
        return best
