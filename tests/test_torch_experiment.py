"""The port's sweep workers, ``run_sweep``, metrics loggers and profiling.

``pro`` and ``prov`` run with ``device="cpu"``.  nf_tpu's ``pro`` trains in
chunks (``epochs_per_sync="auto"``) on its own draws, so the two workers'
numbers are held to the analytic integral, not to each other; their
``log.txt`` files must agree line for line with the numbers masked, and the
queue tuples in length, tags and ids.
"""

import json
import math
import os
import queue
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf_tpu.utils import experiment as jexp
from nf_tpu_torch.training import metrics
from nf_tpu_torch.utils import experiment as exp
from nf_tpu_torch.utils import profiling
from nf_tpu_torch.utils.sweep import RESULT_FIELDS, run_sweep

torch.set_num_threads(1)


def gauss2(x):
    return torch.exp(-torch.sum((x - 0.5) ** 2, dim=-1) / 0.02)


def gauss2_j(x):
    return jnp.exp(-jnp.sum((x - 0.5) ** 2, axis=-1) / 0.02)


def gauss2_exact():
    a = 0.02
    return (math.sqrt(a * math.pi) * math.erf(0.5 / math.sqrt(a))) ** 2


def _para(tmp_path, **kw):
    para = {"n_flow": 2, "n_bins": 4, "NN_width": 4, "NN_length": 2, "dev": 0, "lr": 2e-3,
            "weight_decay": 1e-4, "var_n": 2000, "batch_size": 500, "pt": 0, "id": 7,
            "f": gauss2, "logdir": str(tmp_path), "log": False, "seed": 0, "device": "cpu"}
    para.update(kw)
    return para


_NUMBER = re.compile(r"[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?|nan|inf")


def _masked_log(path):
    return [_NUMBER.sub("#", line) for line in open(path).read().splitlines()]


@pytest.mark.parametrize("worker", ["pro", "prov"])
def test_worker_matches_nf_tpu(tmp_path, monkeypatch, worker):
    monkeypatch.setattr(exp, "EPOCH_LENGTH", 12)
    monkeypatch.setattr(jexp, "EPOCH_LENGTH", 12)
    q_t, q_j = queue.Queue(), queue.Queue()
    log = tmp_path / "7" / "log.txt"
    getattr(exp, worker)(_para(tmp_path, q=q_t))
    mine = _masked_log(log)
    getattr(jexp, worker)(_para(tmp_path, q=q_j, f=gauss2_j))
    assert mine == _masked_log(log)
    got, want = q_t.get_nowait(), q_j.get_nowait()
    assert q_t.empty() and len(got) == len(want) == len(RESULT_FIELDS) == 14
    assert got[8] == want[8] == ("NIS" if worker == "pro" else "VEGAS")
    assert got[10] == want[10] == 7 and got[1] is None
    exact_pb = gauss2_exact() / exp.GEV2_TO_PB
    assert abs(got[11] - exact_pb) < 5 * got[12] + 0.01 * exact_pb
    if worker == "pro":
        assert got[3] == want[3] == 2 * 500 * 2 + 12 * 500
        assert all(np.isfinite(got[i]) for i in (0, 2, 4, 5, 6, 13))
    else:
        assert got[3] == want[3] == 35 * 5000


def test_pro_optional_keys(tmp_path):
    """``epochs``, ``loss_mode``, ``select_best_by`` and ``kill_counter``
    reach the trainer; ``log`` with ``logdir`` writes the checkpoints."""
    q = queue.Queue()
    exp.pro(_para(tmp_path, q=q, batch_size=400, var_n=500, epochs=6, loss_mode="kl",
                  select_best_by="ess", kill_counter=1000, log=True))
    tup = q.get_nowait()
    assert tup[8] == "NIS" and np.isfinite(tup[11])
    # func_count = 2 batch n_flow + epochs batch: all 6 epochs ran
    assert tup[3] == 2 * 400 * 2 + 6 * 400
    assert sorted(os.listdir(tmp_path / "7")) == ["log.txt", "torch", "torch_int"]


def test_run_sweep_sequential(tmp_path, monkeypatch):
    monkeypatch.setattr(exp, "EPOCH_LENGTH", 5)
    base = _para(tmp_path, batch_size=400, var_n=1000)
    results = run_sweep([dict(base, id=1), dict(base, id=2, worker=exp.prov)])
    assert sorted(r["method"] for r in results) == ["NIS", "VEGAS"]
    for r in results:
        assert set(r) == set(RESULT_FIELDS) and r["id"] in (1, 2)
        assert (tmp_path / str(r["id"]) / "log.txt").exists()


def test_run_sweep_thread_pool(tmp_path):
    base = _para(tmp_path, var_n=1000, worker=exp.prov)
    results = run_sweep([dict(base, id=i) for i in range(3)], mode="thread", max_workers=3)
    assert sorted(r["id"] for r in results) == [0, 1, 2]
    for r in results:
        assert r["method"] == "VEGAS"
        assert abs(r["sigma_pb"] * exp.GEV2_TO_PB - gauss2_exact()) < 0.1 * gauss2_exact()


def test_run_sweep_process_mode(tmp_path, monkeypatch):
    """One spawned child on the CPU; the integrand lives in a real module
    so that it pickles across the spawn."""
    (tmp_path / "sweep_integrand_torch.py").write_text(
        "import torch\n"
        "def gauss2(x):\n"
        "    return torch.exp(-torch.sum((x - 0.5) ** 2, dim=-1) / 0.02)\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    import sweep_integrand_torch
    para = _para(tmp_path, id=5, var_n=1000, f=sweep_integrand_torch.gauss2, worker=exp.prov)
    results = run_sweep([para], mode="process")
    assert len(results) == 1 and results[0]["id"] == 5 and results[0]["method"] == "VEGAS"
    assert abs(results[0]["sigma_pb"] * exp.GEV2_TO_PB - gauss2_exact()) < 0.1 * gauss2_exact()
    assert (tmp_path / "5" / "log.txt").exists()


def test_run_sweep_rejects_unknown_mode():
    with pytest.raises(ValueError, match="fork"):
        run_sweep([], mode="fork")


def test_metrics_loggers(tmp_path):
    mem = metrics.MemoryLogger()
    mem.log_scalar("a", torch.tensor(1.5, dtype=torch.float64), 0)
    mem.log_scalar("a", 2, 1)
    assert mem.scalars == {"a": [(0, 1.5), (1, 2.0)]}
    path = tmp_path / "m.jsonl"
    jl = metrics.JSONLLogger(str(path))
    jl.log_scalar("b", torch.tensor(0.25), 3)
    jl.log_scalar("b", 4.0, 4)
    lines = [json.loads(s) for s in path.read_text().splitlines()]
    assert [(d["name"], d["value"], d["step"]) for d in lines] == [("b", 0.25, 3), ("b", 4.0, 4)]
    metrics.NullLogger().log_scalar("c", 1.0, 0)
    for logger in (mem, jl, metrics.NullLogger()):
        assert isinstance(logger, metrics.MetricsLogger)


def test_profiling_on_the_cpu(tmp_path):
    x = torch.ones(1000)
    dt = profiling.benchmark(lambda a: (a * 2).sum(), x, reps=3, warmup=1)
    assert dt > 0
    with profiling.Timer() as t:
        out = t.block_on({"y": [x * 3]})
    assert t.seconds > 0 and torch.equal(out["y"][0], x * 3)
    with profiling.trace(str(tmp_path / "trace")):
        (x * 5).sum()
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    assert "aten::mul" in (tmp_path / "trace" / files[0]).read_text()
