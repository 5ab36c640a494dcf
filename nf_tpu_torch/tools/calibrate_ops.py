#!/usr/bin/env python3
"""Calibrate what each float32 elementwise op costs on an NVIDIA GPU, in
units of one FMA: the counterpart of ``tools/calibrate_vpu_ops.py``, which
measures the same on a TPU's VPU.

Why: the bounds of the port's kernels (``chip_smoke.kernel_work``) count an
``expf``, a ``sqrtf``, an ``atanf`` and an IEEE division as one FLOP each at
the card's float32 FMA rate, and the flow transforms are made of exactly
these ops.  The costs measured here say what they take as nvcc lowers them
with the port's flags (no ``--use_fast_math``).

Method, the Pallas tool's: the op-chain kernel (``nf_tpu_torch/ops/csrc/
op_chain.cu``, via ``nf_tpu_torch.ops.op_chain.chain``) applies one op K
times to each of 4096 x grid float32 elements, one element a thread, and
sums the results over the grid.  Seconds per op per element come from two
differences: over K (64 and 320), which cancels the loads, stores and the
sum; and over the number of launches between two CUDA events (2 and 10),
which cancels the events and the launch edge.  Each of the four times is
the median of 11 repeats, taken in turns.  Costs are
in units of the fma chain's.  The kernel's SASS (``cuobjdump -sass`` of the
built library) gives each op's instructions per step, the difference of
the K = 320 and K = 64 kernels over 256 steps.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 nf_tpu_torch/tools/calibrate_ops.py [--out FILE]

Prints each op's seconds per element, a markdown table, and one JSON line
(also written to ``--out``) with the card's name and power limit from
nvidia-smi.  Without a GPU it exits non-zero: it does not time the CPU.
"""

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the Pallas tool's sizes (tools/calibrate_vpu_ops.py main): grid steps of
# 4096 elements, the two chain lengths, the launches between two events
GRID = 1024
K1, K2 = 64, 320
LAUNCHES = (2, 10)
REPS = 11


def slope(times, elements):
    """Seconds per op per element from ``times[(k, m)]``, the seconds of
    ``m`` launches of ``elements`` chains of length ``k``: one launch's time
    at each ``k`` from the difference over ``m``, then the difference over
    ``k``."""
    m1, m2 = LAUNCHES
    one = {k: (times[k, m2] - times[k, m1]) / (m2 - m1) for k in (K1, K2)}
    return (one[K2] - one[K1]) / ((K2 - K1) * elements)


def cost_in_fma_units(sec_per_op):
    fma = sec_per_op["fma"]
    return {op: sec / fma for op, sec in sec_per_op.items()}


_FUNCTION = re.compile(r"Function : (\S+)")
_TEMPLATE = re.compile(r"op_chain_kernelILi(\d+)ELi(\d+)E")
_INSTRUCTION = re.compile(r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)[^;]*;")


def sass_counts(text):
    """``{(op index, k): {opcode: count}}`` of the op-chain kernels in
    ``cuobjdump -sass`` output, NOPs left out."""
    counts, current = {}, None
    for line in text.splitlines():
        m = _FUNCTION.search(line)
        if m:
            t = _TEMPLATE.search(m.group(1))
            current = counts.setdefault((int(t.group(1)), int(t.group(2))), {}) if t else None
            continue
        m = _INSTRUCTION.match(line)
        if current is not None and m and m.group(1) != "NOP":
            current[m.group(1)] = current.get(m.group(1), 0) + 1
    return counts


def sass_per_step(counts, ops):
    """Each op's instructions per chain step, in all and by opcode: the
    K = 320 kernel's count less the K = 64 kernel's, over 256 steps."""
    out = {}
    for index, op in enumerate(ops):
        a, b = counts.get((index, K1)), counts.get((index, K2))
        if a is None or b is None:
            continue
        by = {code: (b.get(code, 0) - a.get(code, 0)) / (K2 - K1) for code in set(a) | set(b)}
        by = {code: n for code, n in sorted(by.items(), key=lambda kv: -kv[1]) if n}
        out[op] = {"instructions": sum(by.values()), "by_opcode": by}
    return out


def read_sass():
    """``cuobjdump -sass`` of the built kernel library (the toolkit's,
    beside nvcc)."""
    from nf_tpu_torch.ops import _build

    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    return subprocess.run([str(tool), "-sass", _build.library()._name], capture_output=True,
                          text=True, check=True).stdout


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def event_seconds(fn):
    """Seconds of ``fn()`` between two CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def chain_rate(op, device, seed=1):
    """Seconds per ``op`` per element on the card, by :func:`slope`, and
    the four median times; they are taken in turns, ``REPS`` rounds."""
    import torch

    from nf_tpu_torch.ops import op_chain

    out = torch.empty((op_chain.SUB, op_chain.LANE), dtype=torch.float32, device=device)
    scratch = torch.empty(-(-GRID // op_chain.CHUNK) * op_chain.TILE, dtype=torch.float32,
                          device=device)
    cases = [(k, m) for k in (K1, K2) for m in LAUNCHES]

    def run(k, m):
        return lambda: op_chain.chain(op, k, GRID, seed, device, repeats=m, out=out,
                                      scratch=scratch)

    for k, m in cases:  # warm-up: module load, clocks
        run(k, m)()
    torch.cuda.synchronize()
    rounds = {case: [] for case in cases}
    for _ in range(REPS):
        for case in cases:
            rounds[case].append(event_seconds(run(*case)))
    times = {case: statistics.median(ts) for case, ts in rounds.items()}
    return slope(times, op_chain.TILE * GRID), times


def calibrate(device="cuda", log=print):
    """The calibration as a dict: seconds per op per element, costs in fma
    units, each op's four median times, and SASS instructions per step."""
    import torch

    from nf_tpu_torch.ops import op_chain

    smi = card()
    out = {"device": torch.cuda.get_device_name(device), "nvidia_smi": smi, "grid": GRID,
           "elements_per_launch": op_chain.TILE * GRID, "k": [K1, K2],
           "launches": list(LAUNCHES), "reps": REPS, "sec_per_op_per_element": {},
           "times_s": {}}
    for op in op_chain.OPS:
        sec, times = chain_rate(op, device)
        out["sec_per_op_per_element"][op] = sec
        out["times_s"][op] = {f"k{k}_x{m}": t for (k, m), t in times.items()}
        log(f"# {op:7s}: {sec:.4e} s/op/element ({1.0 / max(sec, 1e-30):.4e} ops/s) [{smi}]")
    out["cost_in_fma_units"] = cost_in_fma_units(out["sec_per_op_per_element"])
    out["sass_per_step"] = sass_per_step(sass_counts(read_sass()), op_chain.OPS)
    return out


def table(result):
    lines = ["| op | cost (fma units) | s/op/element | SASS instructions per step |",
             "|---|---|---|---|"]
    for op, c in sorted(result["cost_in_fma_units"].items(), key=lambda kv: kv[1]):
        s = result["sass_per_step"][op]
        mix = f"{s['instructions']:g}: " + ", ".join(
            f"{n:g} {code}" for code, n in s["by_opcode"].items())
        lines.append(f"| {op} | {c:.2f} | {result['sec_per_op_per_element'][op]:.4e} | {mix} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate_ops: needs an NVIDIA GPU (torch.cuda.is_available() is false); "
              "it does not time the CPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    result = calibrate()
    print()
    print(table(result))
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
        print(f"\n# wrote {args.out}")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
