"""Which draw each entry point builds, for every requested method (CPU).

The table below is the eval-mode draw's whole resolution: per entry point,
requested method and ``train``, the builder that runs (the sampler kernel
by its layout, the folded forward by its dtype, the stateful forward by its
latents' dtype and BatchNorm mode) or the refusal.  The builders are
replaced by recorders that stop the call as soon as they run, so nothing
is computed.  ``train`` is the entry point's own argument where it has
one; ``integrate`` takes its mode from ``best_eval_mode``, so there the
axis sets ``best_eval_mode = train is False``.

The card's column runs on the CPU with the device check patched: the
resolver is handed a CUDA device in place of the model's, so it answers as
on the card, while the draws themselves stay on the CPU.
"""

import pytest
import torch

from nf_tpu_torch import PWQuadManager
from nf_tpu_torch.flows import fast_eval
from nf_tpu_torch.flows import sampling as fsampling
from nf_tpu_torch.flows.model import FlowModel
from nf_tpu_torch.ops import pwquad_sampler
from nf_tpu_torch.parallel import sampling as psampling
from nf_tpu_torch.training import unweight as uw

from test_torch_parallel import world_of_one  # noqa: F401  (fixture)

torch.set_num_threads(1)

K, KD, KL = "kernel batch_major", "kernel dim_major", "kernel latents"
F32, F64 = "folded float32", "folded float64"
EVAL_ONLY, UNKNOWN = "refused: eval-mode only", "refused: unknown method"


def S(dtype, train):
    return f"stateful float{dtype} train={train}"


TRAINS = (None, False, True)

# (entry, method, train) -> (on the CPU, on the card); rows of one entry
# and method list the trains in TRAINS' order
_ROWS = {
    "sample": {
        None: [(S(64, True), K), (S(64, False), K), (S(64, True), S(64, True))],
        "auto": [(S(64, True), K), (S(64, False), K), (S(64, True), S(64, True))],
        "fused": [(K, K)] * 3,
        "folded": [(F64, F64)] * 3,
        "reference": [(S(64, True),) * 2, (S(64, False),) * 2, (S(64, True),) * 2],
        "stateful": [(S(64, True),) * 2, (S(64, False),) * 2, (S(64, True),) * 2],
        "bogus": [(UNKNOWN, UNKNOWN)] * 3,
    },
    "integrate": {
        None: [(S(64, True), KD), (S(64, False), KD), (S(64, True), KD)],
        "auto": [(S(64, True), KD), (S(64, False), KD), (S(64, True), KD)],
        "fused": [(KD, KD)] * 3,
        "folded": [(F64, F64)] * 3,
        "reference": [(S(64, True),) * 2, (S(64, False),) * 2, (S(64, True),) * 2],
        "stateful": [(S(64, True),) * 2, (S(64, False),) * 2, (S(64, True),) * 2],
        "bogus": [(UNKNOWN, UNKNOWN)] * 3,
    },
    "integrate_qmc": {"qmc": [(F64, KL)] * 3},
    "generate_unweighted": {
        None: [(S(64, None),) * 2, (S(64, False),) * 2, (S(64, True),) * 2],
        "auto": [(S(64, None), K), (S(64, False), K), (S(64, True), S(64, True))],
        "fused": [(K, K)] * 3,
        "folded": [(F32, F32)] * 3,
        "reference": [(UNKNOWN, UNKNOWN)] * 3,
        "stateful": [(S(32, None),) * 2, (S(32, False),) * 2, (S(32, True),) * 2],
        "bogus": [(UNKNOWN, UNKNOWN)] * 3,
    },
    "dp_sample": {
        None: [(F64, K)], "auto": [(F64, K)], "fused": [(K, K)], "folded": [(F64, F64)],
        "reference": [(EVAL_ONLY, EVAL_ONLY)], "stateful": [(EVAL_ONLY, EVAL_ONLY)],
        "bogus": [(EVAL_ONLY, EVAL_ONLY)],
    },
    "dp_integrate": {
        None: [(F64, KD)], "auto": [(F64, KD)], "fused": [(KD, KD)], "folded": [(F64, F64)],
        "reference": [(EVAL_ONLY, EVAL_ONLY)], "stateful": [(EVAL_ONLY, EVAL_ONLY)],
        "bogus": [(EVAL_ONLY, EVAL_ONLY)],
    },
    "dp_generate_unweighted": {
        None: [(F32, K)] * 2 + [(EVAL_ONLY, EVAL_ONLY)],
        "auto": [(F32, K)] * 2 + [(EVAL_ONLY, EVAL_ONLY)],
        "fused": [(K, K)] * 2 + [(EVAL_ONLY, EVAL_ONLY)],
        "folded": [(F32, F32)] * 2 + [(EVAL_ONLY, EVAL_ONLY)],
        "reference": [(EVAL_ONLY, EVAL_ONLY)] * 3,
        "stateful": [(EVAL_ONLY, EVAL_ONLY)] * 3,
        "bogus": [(EVAL_ONLY, EVAL_ONLY)] * 3,
    },
}

# entry points without a train argument run once, at train=None
_TRAINS_OF = {"dp_sample": (None,), "dp_integrate": (None,)}

TABLE = {(entry, method, train): row
         for entry, rows in _ROWS.items() for method, cells in rows.items()
         for train, row in zip(_TRAINS_OF.get(entry, TRAINS), cells)}


class _Built(Exception):
    pass


def _f(x):
    return x[:, 0]


def _call(entry, manager, mesh, method, train):
    flow, model = manager._flow, manager.best_model
    manager.best_eval_mode = train is False
    gen = torch.Generator().manual_seed(1)
    if entry == "sample":
        manager.sample(8, method=method, train=train)
    elif entry == "integrate":
        manager.integrate(_f, 2, 8, method=method)
    elif entry == "integrate_qmc":
        manager.integrate(_f, 2, 8, seed=1, method=method)
    elif entry == "generate_unweighted":
        uw.generate_unweighted(flow, model, _f, gen, 4, w_max=1.0, train=train, batch=8,
                               method=method)
    elif entry == "dp_sample":
        psampling.dp_sample(flow, model, mesh, 8, method=method, dtype=torch.float64)
    elif entry == "dp_integrate":
        psampling.dp_integrate(flow, model, _f, mesh, 2, 8, method=method,
                               dtype=torch.float64)
    else:
        uw.generate_unweighted(flow, model, _f, gen, 4, w_max=1.0, train=train, batch=8,
                               method=method, mesh=mesh)


def _record(monkeypatch):
    """Replace the three builders by recorders that stop the call."""
    def kernel(flow, model, take_latents=False, layout="batch_major", config=None):
        raise _Built(KL if take_latents else f"kernel {layout}")

    def folded(flow, model, dtype=torch.float32):
        raise _Built(f"folded {str(dtype).removeprefix('torch.')}")

    def stateful(self, w, train):
        raise _Built(S(torch.finfo(w.dtype).bits, train))

    monkeypatch.setattr(pwquad_sampler, "build_sampler", kernel)
    monkeypatch.setattr(fast_eval, "make_folded_forward", folded)
    monkeypatch.setattr(FlowModel, "frozen_forward", stateful)


def _on_card(monkeypatch):
    """The resolver sees a CUDA device wherever it is asked."""
    resolve = fsampling.resolve_method
    monkeypatch.setattr(fsampling, "resolve_method",
                        lambda flow, device, *a, **k: resolve(flow, torch.device("cuda"),
                                                              *a, **k))


@pytest.fixture(scope="module")
def manager():
    NF = PWQuadManager(n_flow=2, seed=3, dtype=torch.float64, device="cpu")
    NF.create_model(2, 4, [4] * 2)
    return NF


@pytest.mark.parametrize("card", [False, True], ids=["cpu", "card"])
@pytest.mark.parametrize("entry,method,train", list(TABLE))
def test_resolution_table(manager, world_of_one, monkeypatch, entry, method, train,  # noqa: F811
                          card):
    _record(monkeypatch)
    if card:
        _on_card(monkeypatch)
    try:
        _call(entry, manager, world_of_one, method, train)
    except _Built as built:
        got = str(built)
    except ValueError as e:
        got = (EVAL_ONLY if "eval-mode only" in str(e)
               else UNKNOWN if "unknown sampling method" in str(e) else f"ValueError: {e}")
    else:
        got = "no builder ran"
    assert got == TABLE[entry, method, train][card]
