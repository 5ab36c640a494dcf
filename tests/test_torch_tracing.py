"""The port's spans and its host-read counter (``nf_tpu_torch.utils.profiling``)
on the CPU.

Under a ``torch.profiler`` every entry point records its phases as
``record_function`` ranges named ``nf.*``, nested as the calls nest; with
no profiler recording no ``record_function`` is entered at all.
``profiling.HOST_READS`` counts the blocking reads of device data into host
memory, one per tensor read, the same on the CPU as on the card: the counts
below are derived from the code in PERF.md section 3 (camel: 21 tensors a
cell, 2 cells; the fold reads each once; the learned multi-channel trainer:
four history rows a chunk, then three).  ``profiling.FLOW_INVERSES`` counts
the flow inverses: the mixture makes C^2 a minibatch.
"""

import pytest
import torch

from nf_tpu_torch import PWQuadManager
from nf_tpu_torch.phasespace.topology import BreitWignerSMap, ResonanceDecayPhasespace
from nf_tpu_torch.training import multichannel, optimizers
from nf_tpu_torch.training.unweight import generate_unweighted
from nf_tpu_torch.utils import profiling

torch.set_num_threads(1)

# the camel model's tensors, each read once by the fold: a cell's input
# BatchNorm (scale, bias, mean, var), three hidden weights (no bias: a
# BatchNorm follows), three hidden BatchNorms of four, the final w and b
FOLD = 2 * (4 + 3 + 3 * 4 + 2)


def camel(x):
    return (torch.exp(-((x[:, 0] - 0.75) ** 2 + (x[:, 1] - 0.75) ** 2) / 0.04)
            + torch.exp(-((x[:, 0] - 0.25) ** 2 + (x[:, 1] - 0.25) ** 2) / 0.04))


def manager(hidden=(3, 3, 3), dtype=torch.float32, seed=0):
    """The README's camel model, ``create_model(2, 4, [3] * 3)``, on the CPU."""
    NF = PWQuadManager(n_flow=2, seed=seed, dtype=dtype, device="cpu")
    NF.create_model(2, 4, list(hidden))
    return NF


def train(NF, k, **kw):
    args = dict(log=False, batch_size=512, mini_batch_size=256, epochs=10, preburn_time=3,
                kill_counter=100, integrate=False, pretty_progressbar=False)
    args.update(kw)
    lr = args.pop("lr", 1e-2)
    return NF._train_variance_forward_seq(camel, optimizers.adamax(lr, 1e-4),
                                          epochs_per_sync=k, **args)


def unweight(NF, w_max, batches=3):
    gen = torch.Generator().manual_seed(7)
    return generate_unweighted(NF._flow, NF._model, camel, gen, 1 << 62, w_max=w_max,
                               batch=4096, max_batches=batches, method="fused",
                               partial_unweight=True)


# two channels of competing pairings, without a PDF, and their flows
MC_CHANNELS = [ResonanceDecayPhasespace(
    [0.0, 0.0], [0.0] * 4, pairs,
    mass_maps={tuple(sorted(pairs[0])): BreitWignerSMap(m, g),
               tuple(sorted(pairs[1])): BreitWignerSMap(m, g)})
    for pairs, m, g in ((((0, 1), (2, 3)), 91.188, 2.4952), (((0, 3), (1, 2)), 180.0, 8.0))]
MC_MINIBATCHES = 2


def mc_me(momenta):
    return torch.ones(momenta.shape[0], dtype=momenta.dtype)


def train_mixture(epochs=2, epochs_per_call=1):
    """A learned multi-channel call: 2 epochs of 2 minibatches, one chunk
    an epoch."""
    gen = torch.Generator().manual_seed(3)
    models = multichannel.build_channel_flows(gen, MC_CHANNELS, 2, 4, [8], device="cpu",
                                              final_rank=2)
    return multichannel.train_multichannel(
        MC_CHANNELS, models, mc_me, 400.0, optimizers.adamax(1e-3), gen, alphas=[0.5, 0.5],
        batch_per_channel=128 * MC_MINIBATCHES, mini_batch_per_channel=128, epochs=epochs,
        epochs_per_call=epochs_per_call, loss_mode="kl", pT_mincut=5.0)


# each entry point: what it runs, the (span, its innermost nf.* parent) pairs
# it must record, and the host reads it makes
CALLS = {
    "create_model": (lambda NF: NF.create_model(2, 4, [3] * 3), {("nf.create_model", None)}, 0),
    "integrate": (lambda NF: NF.integrate(camel, 3, 4096, seed=5, method="fused"),
                  {("nf.integrate", None), ("nf.fold", "nf.integrate"),
                   ("nf.read.fold", "nf.fold"), ("nf.read.seed", "nf.integrate"),
                   ("nf.integrate.iterations", "nf.integrate"),
                   ("nf.read.result", "nf.integrate")},
                  FOLD + 1 + 1),
    "sample": (lambda NF: NF.sample(1000, seed=5, method="fused"),
               {("nf.sample", None), ("nf.fold", "nf.sample"), ("nf.read.fold", "nf.fold"),
                ("nf.read.seed", "nf.sample")},
               FOLD + 1),
    "unweight_with_pilot": (
        lambda NF: unweight(NF, None),
        {("nf.unweight", None), ("nf.unweight.pilot", "nf.unweight"),
         ("nf.fold", "nf.unweight.pilot"), ("nf.read.seed", "nf.unweight.pilot"),
         ("nf.read.wmax", "nf.unweight.pilot"), ("nf.fold", "nf.unweight"),
         ("nf.read.fold", "nf.fold"), ("nf.unweight.batch", "nf.unweight"),
         ("nf.unweight.propose", "nf.unweight.batch"), ("nf.read.seed", "nf.unweight.propose"),
         ("nf.unweight.accept", "nf.unweight.batch"), ("nf.read.rows", "nf.unweight.batch")},
        # the pilot's fold, seed and w_max; the batches' fold; a batch's
        # seed, counts, rows and weights
        (FOLD + 1 + 1) + FOLD + 3 * (1 + 3)),
    "unweight": (lambda NF: unweight(NF, 0.5),
                 {("nf.unweight", None), ("nf.fold", "nf.unweight"),
                  ("nf.unweight.batch", "nf.unweight"), ("nf.read.rows", "nf.unweight.batch")},
                 FOLD + 3 * (1 + 3)),
    "train_chunked": (
        lambda NF: train(NF, 5),
        {("nf.train", None), ("nf.train.first_estimate", "nf.train"),
         ("nf.read.first_estimate", "nf.train.first_estimate"), ("nf.train.setup", "nf.train"),
         ("nf.chunk.run", "nf.train"), ("nf.chunk.eager.epoch", "nf.chunk.run"),
         ("nf.read.chunk", "nf.train"), ("nf.train.host", "nf.train")},
        # the first estimate's three, one a chunk
        3 + 2),
    "train_per_epoch": (
        lambda NF: train(NF, 1),
        {("nf.train", None), ("nf.train.first_estimate", "nf.train"),
         ("nf.train.setup", "nf.train"), ("nf.train.epoch", "nf.train"),
         ("nf.read.epoch", "nf.train"), ("nf.train.host", "nf.train")},
        3 + 10),
    # lr 0: the loss is a random walk and the kill counter stops the run at
    # epoch 21, inside the chunk of epochs 20-23 (tests/test_torch_chunked.py);
    # the chunk runs again up to the stop, then the tail integrates 18 epochs
    "train_stop_inside_a_chunk": (
        lambda NF: train(NF, 4, lr=0.0, kill_counter=2, epochs=40, preburn_time=0,
                         integrate=True, stats_every=3),
        {("nf.chunk.rerun", "nf.train.host"), ("nf.chunk.run", "nf.chunk.rerun"),
         ("nf.read.rerun", "nf.chunk.rerun"), ("nf.train.tail", "nf.train"),
         ("nf.read.tail", "nf.train.tail")},
        3 + 6 + 1 + 18),
    # the history's four rows a chunk (2 chunks), then the alphas, the best
    # alphas and the best ESS
    "train_multichannel": (
        lambda NF: train_mixture(),
        {("nf.mc.train", None), ("nf.mc.pilot", "nf.mc.train"),
         ("nf.mc.propose", "nf.mc.pilot"), ("nf.mc.density", "nf.mc.pilot"),
         ("nf.mc.epoch", "nf.mc.train"), ("nf.mc.propose", "nf.mc.epoch"),
         ("nf.mc.density", "nf.mc.epoch"), ("nf.mc.loss", "nf.mc.epoch"),
         ("nf.mc.backward", "nf.mc.epoch"), ("nf.mc.step", "nf.mc.epoch"),
         ("nf.mc.alphas", "nf.mc.epoch"), ("nf.read.history", "nf.mc.train")},
        4 * 2 + 3),
}
HIDDEN = {"train_stop_inside_a_chunk": ((4, 4), torch.float64, 1)}


def made(case):
    hidden, dtype, seed = HIDDEN.get(case, ((3, 3, 3), torch.float32, 0))
    return manager(hidden, dtype, seed)


def nf_pairs(prof):
    """``{(span, innermost nf.* span around it or None)}`` of a trace."""
    out = set()
    for e in prof.events():
        if not e.name.startswith("nf."):
            continue
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith("nf."):
            parent = parent.cpu_parent
        out.add((e.name, None if parent is None else parent.name))
    return out


@pytest.mark.parametrize("case", sorted(CALLS))
def test_spans_name_and_nest_each_phase(case):
    NF = made(case)
    run, pairs, _ = CALLS[case]
    with profiling.device_profile() as prof:
        run(NF)
    seen = nf_pairs(prof)
    assert pairs <= seen, sorted(pairs - seen)
    assert all(name.startswith("nf.") for name, _ in seen)


@pytest.mark.parametrize("case", sorted(CALLS))
def test_host_reads_counted_per_call(case):
    NF = made(case)
    run, _, reads = CALLS[case]
    before = profiling.HOST_READS
    run(NF)
    assert profiling.HOST_READS - before == reads


@pytest.mark.parametrize("case", sorted(CALLS))
def test_no_span_entered_without_a_profiler(case, monkeypatch):
    """With no profiler recording a span is the shared null context: a
    ``record_function`` that raises on the program's names is never reached
    (torch.optim's own ranges go on as they are)."""
    plain = torch.autograd.profiler.record_function

    def refuse(name, *args):
        if name.startswith("nf."):
            raise AssertionError(f"record_function({name!r}) entered without a profiler")
        return plain(name, *args)

    NF = made(case)
    run = CALLS[case][0]
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    run(NF)
    assert profiling.span("nf.x") is profiling.span("nf.y")


@pytest.mark.parametrize("epochs", [1, 3])
def test_flow_inverses_per_mixture_epoch(epochs):
    """C^2 inverses a minibatch, and the pilot's C^2 a call; the count
    syncs nothing, so it holds without a profiler as with one."""
    C = len(MC_CHANNELS)
    before = profiling.FLOW_INVERSES
    train_mixture(epochs, epochs)
    assert profiling.FLOW_INVERSES - before == C * C * (1 + MC_MINIBATCHES * epochs)


def test_fold_reads_every_parameter_and_buffer_once():
    NF = manager()
    assert FOLD == len(list(NF._model.parameters())) + len(list(NF._model.buffers()))


def test_spanned_keeps_the_signature():
    """The trainers' defaults are read from their signatures."""
    import inspect

    sig = inspect.signature(PWQuadManager._train_variance_forward_seq)
    assert sig.parameters["epochs_per_sync"].default == "auto"
    assert PWQuadManager.integrate.__name__ == "integrate"
