"""The reference's ``dev`` argument: the port's managers take it at nf_tpu's
positions and ignore it (the device is the constructor's), so a call
written for the reference or for nf_tpu binds the same way.  Compares the
signatures with nf_tpu's, then runs the calls on the CPU."""

import inspect

import pytest
import torch

from nf_tpu.training import manager as jmanager
from nf_tpu_torch import AffineManager, BasicManager, PWLinManager, PWQuadManager
from nf_tpu_torch.training import optimizers

torch.set_num_threads(1)


def flat(x):
    return torch.ones(x.shape[0], dtype=x.dtype)


OPT = optimizers.adamax(1e-3)

# (port method, nf_tpu method, reference-style positional arguments after self)
CALLS = {
    "pwquad_create_model": (PWQuadManager.create_model, jmanager.PWQuadManager.create_model,
                            (2, 4, [3, 3, 3], 1)),
    "pwlin_create_model": (PWLinManager.create_model, jmanager.PWLinManager.create_model,
                           (1, 2, 4, [3], 1, 0)),
    "affine_create_model": (AffineManager.create_model, jmanager.AffineManager.create_model,
                            (1, 2, [3], 1, 0)),
    "integrate": (BasicManager.integrate, jmanager.BasicManager.integrate,
                  (flat, 10, 1e5, 0, 7)),
    # dev is the 11th positional argument, right after run
    "trainer": (BasicManager._train_variance_forward_seq,
                jmanager.BasicManager._train_variance_forward_seq,
                (flat, OPT, False, None, 400, 2, 0, False, True, None, 0, 200)),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_positional_calls_bind_as_nf_tpu(name):
    port, ref, args = CALLS[name]
    ours = inspect.signature(port).bind(None, *args).arguments
    theirs = inspect.signature(ref).bind(None, *args).arguments
    assert ours == theirs and "dev" in ours


def _params(NF):
    return [p.detach().clone() for p in NF._model.parameters()]


@pytest.mark.parametrize("cls,args", [
    (PWQuadManager, (2, 4, [3, 3, 3])),
    (PWLinManager, (1, 2, 4, [3], 1)),
    (AffineManager, (1, 2, [3], 1)),
])
def test_create_model_ignores_dev(cls, args):
    """``create_model(..., dev)`` builds what ``create_model(...)`` builds
    (dev is not ``identity_init``), and ``dev=`` is accepted as a keyword."""
    models = []
    for extra, kwargs in (((), {}), ((1,), {}), ((), {"dev": 0})):
        NF = cls(n_flow=2, seed=0, device="cpu")
        NF.create_model(*args, *extra, **kwargs)
        models.append(_params(NF))
    for other in models[1:]:
        assert all(torch.equal(a, b) for a, b in zip(models[0], other))


def test_integrate_and_trainer_ignore_dev():
    """``integrate(f, nitn, neval, dev, seed)`` is ``integrate(f, nitn,
    neval, seed=seed)``; the trainer's 11th positional argument is dev, so
    the 12th sets ``mini_batch_size``; ``dev=`` is accepted as a keyword."""
    results = []
    for call in ("positional", "keyword"):
        NF = PWQuadManager(n_flow=2, seed=0, device="cpu")
        NF.create_model(2, 4, [3, 3, 3])
        if call == "positional":
            NF._train_variance_forward_seq(flat, OPT, False, None, 400, 2, 0, False, True, None,
                                           3, 200, preburn_time=0)
            results.append(NF.integrate(flat, 2, 300, 0, 7))
        else:
            NF._train_variance_forward_seq(flat, OPT, log=False, batch_size=400, epochs=2,
                                           pretty_progressbar=False, dev=3,
                                           mini_batch_size=200, preburn_time=0)
            results.append(NF.integrate(flat, 2, 300, seed=7, dev=0))
        assert NF._bench[3] == 200        # the minibatch size the run used
    assert results[0] == results[1]
