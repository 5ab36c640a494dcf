#!/usr/bin/env python3
"""Time the learned mixture's unweighters per proposal batch on the card.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 nf_tpu_torch/tools/unweight_timing.py [DIR ...]

For each tree DIR (a checkout's root; default: this one), in its own
process, imports that tree's ``nf_tpu_torch`` and runs
``multichannel_unweight`` on chip_smoke.py's ZZ/Z' physics (two
identity-initialised ``build_channel_flows(.., 4, 16, [32, 32],
final_rank=4)`` flows, alphas (0.85, 0.15), 2^15 proposals per channel a
batch, 16 batches with the event target out of reach) with the global
maximum, per-channel maxima and partial per-channel maxima, each with
``compact=True`` and ``compact=False`` in the order True, False, False, True
after one untimed warm-up.  Prints one JSON line per tree: the host-clock
milliseconds per proposal batch (pilot batches included) of every run and
the accepted events, beside the card's name and power limit from nvidia-smi.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
N_BATCHES, BATCH = 16, 1 << 15
MODES = {"global": dict(), "per_channel": dict(per_channel_max=True),
         "per_channel_partial": dict(per_channel_max=True, partial_unweight=True,
                                     wmax_quantile=0.9)}


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def run_tree(tree):
    sys.path[:0] = [tree, ROOT]
    import torch

    import nf_tpu_torch
    from chip_smoke import E_MC, ZZ_CUTS, mc_physics
    from nf_tpu_torch.training import multichannel as mc

    assert os.path.realpath(nf_tpu_torch.__file__).startswith(os.path.realpath(tree))
    dev = torch.device("cuda")
    channels, me = mc_physics()
    models = mc.build_channel_flows(torch.Generator(device=dev).manual_seed(0), channels, 4, 16,
                                    [32] * 2, final_rank=4, device=dev)
    alphas = [0.85, 0.15]

    def run(opts, compact, n_batches):
        opts = dict(dict(wmax_quantile=0.9999), **opts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mc.multichannel_unweight(channels, models, me, E_MC,
                                       torch.Generator(device=dev).manual_seed(7), alphas,
                                       n_events=10 ** 9, batch_per_channel=BATCH,
                                       max_batches=n_batches, compact=compact, **opts,
                                       **ZZ_CUTS)
        torch.cuda.synchronize()
        # batches of B proposals of one channel: the pilots (one of each
        # channel), then n_batches batches or rounds, each of every channel
        # (global, partial) or of one (per-channel)
        iid = "per_channel_max" in opts and "partial_unweight" not in opts
        n_prop = len(channels) + n_batches * (1 if iid else len(channels))
        return (time.perf_counter() - t0) * 1e3 / n_prop, len(out[0])

    result = {"tree": tree, "card": card(), "ms_per_channel_batch": {}, "events": {}}
    for name, opts in MODES.items():
        run(opts, True, 2)
        for compact in (True, False, False, True):
            ms, n = run(opts, compact, N_BATCHES)
            result["ms_per_channel_batch"].setdefault(f"{name} compact={compact}", []).append(
                round(ms, 3))
            result["events"].setdefault(f"{name} compact={compact}", []).append(n)
    print(json.dumps(result), flush=True)


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        run_tree(os.path.abspath(sys.argv[2]))
        return
    trees = sys.argv[1:] or [ROOT]
    for tree in trees:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree], check=True)


if __name__ == "__main__":
    main()
