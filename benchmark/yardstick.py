"""Peaks and the work each kernel needs: the benchmark's frozen yardstick.

The operations and bytes of one launch of a flow kernel are counted from
the configuration's shapes alone (:func:`benchmark.reference.flow.pwquad_plan`),
never from the program: every input read once and every output written
once; an FMA is 2 FLOPs; a transform's arithmetic per transformed
dimension as the kernels' code has it (pwquad with nb bins: 12 nb + 12
forward, 33 nb + 32 recompute and VJP).  The backward recomputes the MLP,
sends the cotangent back through it and forms dW: three products of the
forward's size.  The forward with statistics adds, per statistics value, an
add, a multiply and an add; its bytes are the plain forward's (its
per-block partial sums, which depend on the program's launch, are left
out, so its bound stays a lower bound).
"""

from __future__ import annotations

# One H100 SXM (NVIDIA's data sheet, at 700 W): float32 outside the tensor
# cores, and HBM3.  The program computes in float32 with TF32 off.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def n_stat_rows(plan):
    """Statistics values of the forward with stats: a sum and a sum of
    squares of every pass-through column and every hidden unit."""
    return sum(2 * (pt + sum(plan.hidden)) for pt in plan.pass_through)


def kernel_work(plan, kernel, n):
    """``(FLOPs, bytes)`` of one launch of ``kernel`` ("sampler", "fwd",
    "fwd_stats" or "bwd") over ``n`` samples of ``plan``."""
    if kernel == "fwd_stats":
        flops, nbytes = kernel_work(plan, "fwd", n)
        return flops + 3 * n * n_stat_rows(plan) // 2, nbytes
    nf, nb = plan.n_flow, plan.n_bins
    flops, n_weights = 0, 0
    for c, pt in enumerate(plan.pass_through):
        shapes = plan.layer_shapes(c)
        t = nf - pt
        mlp = sum(fi * fo for fi, fo, _ in shapes)
        n_weights += sum(fi * fo + fo for fi, fo, _ in shapes)
        if kernel == "bwd":
            flops += 6 * mlp + sum(fo for _, fo, _ in shapes) + t * (33 * nb + 32)
        else:
            flops += 2 * mlp + sum(fo for _, fo, relu in shapes if relu) + t * (12 * nb + 12)
    staged = 4 * len(plan.pass_through) * nf
    per_sample = {"sampler": 4 * nf + 4,
                  "fwd": 4 * nf + 4 * nf + 4 + staged,
                  "bwd": staged + 4 + 4 + 4 * nf + 4 * nf}[kernel]
    return n * flops, n * per_sample + 4 * n_weights * (2 if kernel == "bwd" else 1)


def bound_s(flops, nbytes):
    """The least time the card could take for this work, in seconds."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def flops_per_sample(plan, kernels):
    return sum(kernel_work(plan, k, 1)[0] for k in kernels)
