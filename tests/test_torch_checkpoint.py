"""Checkpoints of the port and the multi-channel trainer's resume.

``utils.checkpoint``: the round trip of a nested tree of tensors, arrays
and scalars; a save that fails part way leaves the previous file as it was
and no temporary file behind.  ``train_multichannel``: split into chunks,
stopped and resumed, it repeats its single-call run bit for bit; the weight
scale comes from the checkpoint, not from the models the resumed call is
given; ``stop_after_chunks <= 0`` and a resume with other settings raise.
"""

import os

import numpy as np
import pytest
import torch

from nf_tpu_torch.phasespace import lorentz
from nf_tpu_torch.phasespace.topology import BreitWignerSMap, ResonanceDecayPhasespace
from nf_tpu_torch.training import multichannel as mc
from nf_tpu_torch.training import optimizers
from nf_tpu_torch.utils import checkpoint

torch.set_num_threads(1)
E = 400.0
MZ, GZ = 91.188, 2.4952


def _tree():
    return {"a": torch.arange(6.0).reshape(2, 3),
            "b": (np.arange(4, dtype=np.int64), 2.5, [torch.ones(2, dtype=torch.float64), 7]),
            "c": {"d": np.float64(1.25), "e": "text", "f": None}}


def test_round_trip(tmp_path):
    path = tmp_path / "ck.pt"
    tree = _tree()
    checkpoint.save(path, tree)
    template = _tree()
    template["a"] = torch.zeros(1)
    back = checkpoint.load(path, template)
    assert torch.equal(back["a"], tree["a"])
    assert isinstance(back["b"], tuple) and isinstance(back["b"][2], list)
    np.testing.assert_array_equal(back["b"][0], tree["b"][0])
    assert back["b"][0].dtype == np.int64 and back["b"][1] == 2.5 and back["b"][2][1] == 7
    assert torch.equal(back["b"][2][0], tree["b"][2][0])
    assert back["c"] == {"d": 1.25, "e": "text", "f": None}
    # a None in the template takes the stored subtree as it is
    assert checkpoint.load(path, {"a": None, "b": None, "c": None})["c"]["e"] == "text"
    with pytest.raises(ValueError):
        checkpoint.load(path, {"a": None, "b": None})
    with pytest.raises(ValueError):
        checkpoint.load(path, dict(_tree(), b=(None, None)))


def test_failed_save_leaves_the_previous_file(tmp_path, monkeypatch):
    path = tmp_path / "ck.pt"
    checkpoint.save(path, {"x": torch.ones(3)})
    before = path.read_bytes()

    def broken(obj, fh):
        fh.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken)
    with pytest.raises(OSError):
        checkpoint.save(path, {"x": torch.zeros(3)})
    assert path.read_bytes() == before
    assert os.listdir(tmp_path) == ["ck.pt"]


def _me(m):
    f = m[:, 2:, :]
    s01 = lorentz.square(f[:, 0] + f[:, 1])
    s23 = lorentz.square(f[:, 2] + f[:, 3])
    return 1e4 / ((s01 - MZ ** 2) ** 2 + (MZ * GZ) ** 2) \
        * 1e4 / ((s23 - MZ ** 2) ** 2 + (MZ * GZ) ** 2)


CHANNELS = [ResonanceDecayPhasespace([0.0, 0.0], [0.0] * 4, pairs,
                                     mass_maps={p: BreitWignerSMap(MZ, GZ) for p in pairs})
            for pairs in (((0, 1), (2, 3)), ((0, 2), (1, 3)))]
KW = dict(alphas=[0.3, 0.7], batch_per_channel=128, mini_batch_per_channel=64, epochs=4,
          loss_mode="kl")


@pytest.fixture(scope="module")
def models():
    return mc.build_channel_flows(torch.Generator().manual_seed(0), CHANNELS, 2, 4, [8],
                                  dtype=torch.float64, device="cpu")


def _train(models, **kw):
    return mc.train_multichannel(CHANNELS, models, _me, E, optimizers.adamax(5e-3, 1e-4),
                                 torch.Generator().manual_seed(9), **dict(KW, **kw))


def _same(a, b):
    for name in ("params", "best_params"):
        for ma, mb in zip(a[name], b[name]):
            sa, sb = ma.state_dict(), mb.state_dict()
            assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert a["best_ess"] == b["best_ess"]
    for name in ("alphas", "best_alphas"):
        np.testing.assert_array_equal(a[name], b[name])
    for name in ("loss", "integral", "ess", "alphas"):
        np.testing.assert_array_equal(a["history"][name], b["history"][name])


@pytest.fixture(scope="module")
def full(models):
    return _train(models)


def test_chunks_and_resume_repeat_the_single_call_run(models, full, tmp_path):
    _same(_train(models, epochs_per_call=2), full)
    path = tmp_path / "mc.pt"
    part = _train(models, epochs_per_call=1, save_state=path, stop_after_chunks=2)
    assert len(part["history"]["loss"]) == 2
    # the checkpoint holds the weight scale; resumed with other models, the
    # run takes its scale (and its flows) from the checkpoint
    assert float(torch.load(path, weights_only=True)["w_scale"]) > 0
    other = mc.build_channel_flows(torch.Generator().manual_seed(5), CHANNELS, 2, 4, [8],
                                   dtype=torch.float64, device="cpu")
    with torch.no_grad():
        for m in other:
            for p in m.parameters():
                p.add_(0.1)
    res = _train(other, epochs_per_call=1, resume_from=path)
    _same(res, full)
    assert full["history"]["ess"][-1] > 0


@pytest.mark.parametrize("change", [dict(epochs_per_call=2), dict(loss_mode="var"),
                                    dict(mini_batch_per_channel=128), dict(learn_alphas=False),
                                    dict(alpha_floor=0.05), dict(alpha_damping=1.0),
                                    dict(seed=10)])
def test_resume_with_other_settings_raises(models, tmp_path, change):
    path = tmp_path / "mc.pt"
    _train(models, epochs=2, epochs_per_call=1, save_state=path, stop_after_chunks=1)
    kw = dict(KW, epochs=2, epochs_per_call=1, resume_from=path)
    kw.update(change)
    gen = torch.Generator().manual_seed(kw.pop("seed", 9))
    with pytest.raises(ValueError, match="resume_from was written with another"):
        mc.train_multichannel(CHANNELS, models, _me, E, optimizers.adamax(5e-3, 1e-4), gen,
                              **kw)


@pytest.mark.parametrize("stop", [0, -1])
def test_stop_after_no_chunk_raises(models, stop):
    with pytest.raises(ValueError, match="stop_after_chunks"):
        _train(models, epochs_per_call=1, stop_after_chunks=stop)
