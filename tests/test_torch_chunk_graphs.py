"""The chunked trainer's CUDA graphs, on the card.

Imports neither JAX nor nf_tpu, so it runs on the card with
``python -m pytest --noconftest tests/test_torch_chunk_graphs.py``; without a
card every test skips.  A chunk replays the epoch and the refresh as CUDA
graphs (``_graphs`` left to the manager's rule); the same chunk run eagerly
(``_graphs=False``, the same capturable optimizer) must give the same bits
and the same kernel launch counts, and a capture that fails raises.
"""

import pytest
import torch

from nf_tpu_torch import PWQuadManager
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
def test_failed_capture_raises(cuda):
    """An integrand that syncs the host cannot be captured: the trainer
    raises rather than run the chunk another way."""
    def syncing(x):
        return camel(x) * float(x[0, 0] >= 0)

    with pytest.raises(RuntimeError):
        train(syncing, None, epochs=4)
