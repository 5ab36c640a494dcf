#!/usr/bin/env python3
"""Find the nondeterministic operations on the paths that promise exact repeats.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 nf_tpu_torch/tools/determinism.py

Sets ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` before CUDA starts and runs under
``torch.use_deterministic_algorithms(True, warn_only=True)`` the runs whose
repeats chip_smoke.py holds bit for bit: phase 15's camel-2D resumes (40 +
40 epochs against 80, both trainers), phase 14's learned-mixture resume
(2 x 2^17, 4 epochs in chunks of 2, stopped after the first and resumed) and
VEGAS (10 x 10^5) twice.  Prints every operation PyTorch reports as having
no deterministic implementation on the card, with its count, whether each
repeat equals its original bit for bit in this mode, and then one JSON line
with both beside the card's name and power limit from nvidia-smi.  Ops with
a deterministic implementation PyTorch switches to in this mode (such as the
backward of ``torch.gather``) are not reported; chip_smoke.py holds the
repeats in the default mode.
"""

import collections
import json
import os
import subprocess
import sys
import tempfile
import warnings

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("determinism: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from nf_tpu_torch import PWQuadManager
    from nf_tpu_torch.training import multichannel as mc
    from nf_tpu_torch.training import optimizers, vegas

    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    same = {}

    def camel_run(bn_stats, epochs, epoch_start=0, resume_from=None):
        NF = PWQuadManager(n_flow=2, seed=0, device=dev)
        NF.create_model(2, 4, [3] * 3)
        NF._train_variance_forward_seq(
            cs.camel, optimizers.adamax(2e-3, 1e-4), log=False,
            batch_size=cs.P15_CAMEL_BATCH, mini_batch_size=cs.P15_CAMEL_BATCH, epochs=epochs,
            epoch_start=epoch_start, resume_from=resume_from, pretty_progressbar=False,
            integrate=True, preburn_time=10, kill_counter=1000, bn_stats=bn_stats,
            stats_every=4)
        return NF

    with warnings.catch_warnings(record=True) as caught, \
            tempfile.TemporaryDirectory(prefix="determinism_") as tmp:
        warnings.simplefilter("always")
        epochs = cs.P15_CAMEL_EPOCHS
        for bn_stats in ("batch", "stale"):
            whole = camel_run(bn_stats, 2 * epochs)
            path = os.path.join(tmp, bn_stats + ".pt")
            camel_run(bn_stats, epochs).save_training_state(path)
            res = camel_run(bn_stats, epochs, epoch_start=epochs, resume_from=path)
            same[f"camel {bn_stats} resume"] = (
                res.history == whole.history
                and np.array_equal(res._integ_hist, whole._integ_hist)
                and cs.state_digest(res._model) == cs.state_digest(whole._model))

        channels, me = cs.mc_physics()
        models = mc.build_channel_flows(torch.Generator(device=dev).manual_seed(0), channels, 4,
                                        16, [32] * 2, final_rank=4, device=dev)

        def mixture(**extra):
            return mc.train_multichannel(
                channels, models, me, cs.E_MC, optimizers.adamax(5e-3, 1e-4),
                torch.Generator(device=dev).manual_seed(3), alphas=[0.5, 0.5],
                batch_per_channel=cs.MC_RESUME_PER_CHANNEL, mini_batch_per_channel=cs.MC_MB,
                epochs=cs.MC_RESUME_EPOCHS, epochs_per_call=2, loss_mode="kl", **cs.ZZ_CUTS,
                **extra)

        full = mixture()
        path = os.path.join(tmp, "mixture.pt")
        mixture(save_state=path, stop_after_chunks=1)
        res = mixture(resume_from=path)
        same["mixture resume"] = (
            all(np.array_equal(full["history"][k], res["history"][k]) for k in full["history"])
            and [cs.state_digest(m) for m in full["params"]]
            == [cs.state_digest(m) for m in res["params"]])

        runs = []
        for _ in range(2):
            v = vegas.VegasIntegrator(2, n_bins=50, seed=0, device=dev)
            runs.append((v.run(cs.camel, nitn=10, neval=cs.P15_VEGAS_NEVAL), v.edges))
        same["vegas repeat"] = runs[0][0] == runs[1][0] and torch.equal(runs[0][1], runs[1][1])
    flagged = collections.Counter(
        str(w.message).split(" does not have a deterministic implementation")[0]
        for w in caught if "does not have a deterministic implementation" in str(w.message))
    smi = card()
    for op, n in flagged.items():
        print(f"determinism: flagged {n} x: {op}")
    if not flagged:
        print("determinism: no operation flagged")
    for what, ok in same.items():
        print(f"determinism: {what} {'bit-identical' if ok else 'DIFFERS'} in deterministic mode")
    print(json.dumps({"flagged": dict(flagged), "bit_identical": same, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
