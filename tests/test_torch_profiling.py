"""The port's profiling helpers (``nf_tpu_torch.utils.profiling``):
``device_profile`` and the trace it writes.

On the card kineto drops a device record whose timestamp, moved onto the
host's clock, falls before the trace's window; the shift is largest right
after CUPTI's activities are enabled and grows with the process's age, so
a trace that records at once loses its first launches' records, and a
ToyPDF call of six kernels traced late in chip_smoke.py came back with
none (PERF.md section 6).  ``device_profile`` records after a
warm-up step and starts the block a lead after the recording.  The card
test reproduces the loss with plain traces and holds ``device_profile``
beside it, each in a fresh process of ``nf_tpu_torch/tools/trace_loss.py``.
It imports no JAX: run it on the card with ``--noconftest``.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from nf_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOOL = os.path.join(ROOT, "nf_tpu_torch", "tools", "trace_loss.py")


def test_device_profile_records_the_block():
    with profiling.device_profile() as prof:
        (torch.ones(8) * 3).sum()
    names = {e.key for e in prof.key_averages()}
    assert {"aten::mul", "aten::sum"} <= names


@pytest.mark.cuda
def test_warm_profile_keeps_what_a_plain_trace_loses():
    """Six traces of the ToyPDF call 10 s apart in a fresh process, plain
    and through ``device_profile``: ``device_profile`` loses no record.  The
    plain traces' losses are printed as a reading, not held: they are
    kineto's, which a later torch may repair."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the loss is CUPTI's")
    lost = {}
    for mode in ("plain", "warm"):
        proc = subprocess.run([sys.executable, TOOL, "--mode", mode], cwd=ROOT,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        lost[mode] = json.loads(proc.stdout.strip().splitlines()[-1])["lost"]
    print(f"launches without a device record, per trace: {lost}")
    assert not any(lost["warm"]), lost
