"""The plain normalizing flow the benchmark holds the program against.

A frozen, independent copy of the published architecture (Muller et al.,
"Neural Importance Sampling", arXiv:1808.03856, sections 4.1-4.2, as the
reference implementation's piecewise-quadratic coupling cells build it):
the cell plan (how many cells, which dimensions pass through), BatchNorm
MLP conditioners, the piecewise-quadratic transform, the Philox4x32-10
latent stream, and BatchNorm's running statistics.  Plain torch, any dtype;
it imports nothing of the program.

Parameters are one flat dict of tensors with the keys
``cells.<c>.bn_in.{scale,bias,mean,var}``, ``cells.<c>.linears.<i>.w``,
``cells.<c>.bns.<i>.{scale,bias,mean,var}``, ``cells.<c>.final.{w,b}``;
weights are ``[fan_in, fan_out]``.

``mm`` is the matrix product every layer uses: :func:`matmul` (exact in the
dtype) or :func:`tf32_matmul` (the inputs rounded to TF32's 10-bit mantissa,
the control's precision).
"""

from __future__ import annotations

import dataclasses
import math

import torch

EPS = 1e-5          # BatchNorm's epsilon
MOMENTUM = 0.1      # BatchNorm's running-statistics momentum
XB_CLAMP = 1.0 - 1e-6


@dataclasses.dataclass(frozen=True)
class Plan:
    n_flow: int
    n_bins: int
    hidden: tuple       # hidden widths of every conditioner
    pass_through: tuple  # per cell
    ops: tuple          # ("cell", c) or ("perm", src index tuple)

    def layer_shapes(self, c):
        """``(fan_in, fan_out, relu)`` of cell ``c``'s conditioner, BatchNorm
        folded: the hidden layers, then the final layer."""
        pt, out = self.pass_through[c], (self.n_flow - self.pass_through[c]) * (2 * self.n_bins + 1)
        sizes, prev = [], pt
        for width in self.hidden:
            sizes.append((prev, width, True))
            prev = width
        return tuple(sizes) + ((prev, out, False),)


def _bits(x, n):
    return [int(c) for c in format(x, "b").zfill(n)]


def pwquad_plan(n_flow, n_cells, n_bins, hidden):
    """The reference managers' piecewise-quadratic chain: the cell count
    raised to ``2 ceil(log2 n_flow)`` (or ``n_flow``) when too small; a chain
    of cells and rolls for ``n_flow <= 7``, else cells over the binary
    partitions of the dimension index, each between a gather and its
    inverse, then rolled cells for any cells left."""
    if n_cells < 2 * math.ceil(math.log2(n_flow)) and n_cells < n_flow:
        n_cells = n_flow if n_flow <= 6 else 6 if n_flow == 7 else int(2 * math.ceil(math.log2(n_flow)))
    pts, ops = [], []

    def roll(shift):
        return ("perm", tuple((i - shift) % n_flow for i in range(n_flow)))

    if n_flow <= 7:
        pt = 1 if n_flow <= 6 else 2
        for i in range(n_cells):
            pts.append(pt)
            ops += [("cell", i), roll(1 if i < n_cells - 1 else n_flow - ((n_cells - 1) % n_flow))]
    else:
        n = len(format(n_flow - 1, "b"))
        codes = [_bits(d, n) for d in range(n_flow)]
        for i in range(2 * n):
            feed, bit = i % 2, i // 2
            feeder = [d for d in range(n_flow) if codes[d][bit] == feed]
            trafoer = [d for d in range(n_flow) if codes[d][bit] != feed]
            perm = feeder + trafoer
            inv = [perm.index(d) for d in range(n_flow)]
            pts.append(len(feeder))
            ops += [("perm", tuple(perm)), ("cell", i), ("perm", tuple(inv))]
        extra = n_cells - 2 * n
        for j in range(extra):
            pts.append(n_flow // 2)
            ops += [("cell", 2 * n + j),
                    roll(1 if j < extra - 1 else n_flow - ((extra - 1) % n_flow))]
    return Plan(n_flow, n_bins, tuple(hidden), tuple(pts), tuple(ops))


def param_shapes(plan):
    """``{key: shape}`` of every parameter and BatchNorm buffer."""
    shapes = {}
    for c, pt in enumerate(plan.pass_through):
        p = f"cells.{c}."
        shapes.update({p + "bn_in.scale": (pt,), p + "bn_in.bias": (pt,)})
        prev = pt
        for i, width in enumerate(plan.hidden):
            shapes[p + f"linears.{i}.w"] = (prev, width)
            prev = width
        for i, width in enumerate(plan.hidden):
            shapes.update({p + f"bns.{i}.scale": (width,), p + f"bns.{i}.bias": (width,)})
        out = plan.layer_shapes(c)[-1][1]
        shapes.update({p + "final.w": (prev, out), p + "final.b": (out,)})
        shapes.update({p + "bn_in.mean": (pt,), p + "bn_in.var": (pt,)})
        for i, width in enumerate(plan.hidden):
            shapes.update({p + f"bns.{i}.mean": (width,), p + f"bns.{i}.var": (width,)})
    return shapes


def is_buffer(key):
    return key.endswith((".mean", ".var"))


# ---------------------------------------------------------------------------
# Matrix products
# ---------------------------------------------------------------------------

def matmul(a, b):
    return a @ b


def tf32_round(x):
    """Round float32 ``x`` to TF32 (10 explicit mantissa bits), to nearest,
    ties away from zero, as the tensor cores take their inputs."""
    bits = x.to(torch.float32).view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _tf32(x):
    """``x`` rounded to TF32, its gradient passed through unchanged."""
    return x + (tf32_round(x) - x).detach()


def tf32_matmul(a, b):
    """A float32 product of TF32-rounded inputs, accumulated in float32."""
    return _tf32(a) @ _tf32(b)


# ---------------------------------------------------------------------------
# Philox4x32-10 latents
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF


def _mul_hi_lo(a, m):
    """``(hi, lo)`` 32-bit words of ``a * m`` for int64 tensors of 32-bit
    words and a 32-bit constant, without overflowing int64."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    m_hi, m_lo = m >> 16, m & 0xFFFF
    mid = a_hi * m_lo + a_lo * m_hi
    lo_full = a_lo * m_lo + ((mid & 0xFFFF) << 16)
    hi = a_hi * m_hi + (mid >> 16) + (lo_full >> 32)
    return hi & _MASK32, lo_full & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 (Salmon et al., SC'11): four 32-bit counter words
    (int64 tensors) and a two-word key -> four output words."""
    for _ in range(10):
        hi0, lo0 = _mul_hi_lo(c0, 0xD2511F53)
        hi1, lo1 = _mul_hi_lo(c2, 0xCD9E8D57)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + 0x9E3779B9) & _MASK32, (k1 + 0xBB67AE85) & _MASK32
    return c0, c1, c2, c3


def philox_latents(seed, offset, n, n_flow, device):
    """The seeded sampler's latents: float32 ``[n, n_flow]``.  Sample ``i``,
    dimension ``d`` takes word ``d % 4`` of Philox4x32-10 at counter
    ``(lo(i + offset), hi(i + offset), d // 4, 0)`` under the key
    ``(lo(seed), hi(seed))``; its top 24 bits times 2^-24."""
    seed &= (1 << 64) - 1
    idx = torch.arange(n, dtype=torch.int64, device=device) + int(offset)
    c0, c1 = idx & _MASK32, idx >> 32
    out = torch.empty((n, n_flow), dtype=torch.float32, device=device)
    zero = torch.zeros_like(idx)
    for blk in range((n_flow + 3) // 4):
        words = philox4x32_10(c0, c1, zero + blk, zero, seed & _MASK32, seed >> 32)
        for j, word in enumerate(words[:n_flow - 4 * blk]):
            out[:, 4 * blk + j] = (word >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return out


# ---------------------------------------------------------------------------
# The flow
# ---------------------------------------------------------------------------

def _take(arr, b):
    return torch.gather(arr, -1, b.unsqueeze(-1)).squeeze(-1)


def pwquad(z, xB, n_bins):
    """The piecewise-quadratic coupling transform of ``xB [B, T]`` under the
    conditioner output ``z [B, T (2 nb + 1)]``: ``(yB, pdf [B])``, the pdf
    the product over the T dimensions.  Vertex heights and bin widths are
    exp of their logits; widths normalised to 1, heights so the
    piecewise-linear density integrates to 1."""
    xB = torch.clamp(xB, max=XB_CLAMP)
    z = z.reshape(z.shape[0], xB.shape[1], 2 * n_bins + 1)
    v, w = torch.exp(z[..., :n_bins + 1]), torch.exp(z[..., n_bins + 1:])
    wsum = torch.cumsum(w, -1)
    w = w / wsum[..., -1:]
    wsum = wsum / wsum[..., -1:]
    trap = (v[..., :-1] + v[..., 1:]) * 0.5 * w
    v = v / torch.sum(trap, -1, keepdim=True)
    b = torch.clamp(torch.sum((wsum <= xB.unsqueeze(-1)).long(), -1), max=n_bins - 1)
    w_b = _take(w, b)
    left = torch.nn.functional.pad(wsum, (1, 0))
    alpha = (xB - _take(left, b)) / w_b
    cdf = torch.nn.functional.pad(torch.cumsum((v[..., :-1] + v[..., 1:]) * 0.5 * w, -1), (1, 0))
    v_lo, v_hi = _take(v, b), _take(v, b + 1)
    yB = 0.5 * alpha ** 2 * (v_hi - v_lo) * w_b + alpha * v_lo * w_b + _take(cdf, b)
    pdf = v_lo + (v_hi - v_lo) * alpha
    return yB, torch.prod(pdf, -1)


def _batchnorm(h, p, key, mode, new_stats, stats):
    """BatchNorm ``key`` on ``h``: ``train`` normalises with the batch's mean
    and biased variance and records the moved running statistics in
    ``new_stats``; ``eval`` normalises with the running ones and, with
    ``stats``, records this input's mean and biased variance."""
    scale, bias = p[key + ".scale"], p[key + ".bias"]
    if mode == "train":
        n = h.shape[0]
        mean = torch.mean(h, 0)
        var = torch.mean(h * h, 0) - mean * mean
        if new_stats is not None:
            new_stats[key + ".mean"] = (1 - MOMENTUM) * p[key + ".mean"] + MOMENTUM * mean.detach()
            new_stats[key + ".var"] = (1 - MOMENTUM) * p[key + ".var"] \
                + MOMENTUM * var.detach() * (n / max(n - 1, 1))
        return (h - mean) / torch.sqrt(var + EPS) * scale + bias
    if stats is not None:
        hd = h.detach()
        mean = torch.mean(hd, 0)
        stats[key] = (mean, torch.mean(hd * hd, 0) - mean * mean)
    return (h - p[key + ".mean"]) / torch.sqrt(p[key + ".var"] + EPS) * scale + bias


def conditioner(p, c, plan, xA, mode, mm=matmul, new_stats=None, stats=None):
    pre = f"cells.{c}."
    h = _batchnorm(xA, p, pre + "bn_in", mode, new_stats, stats)
    for i in range(len(plan.hidden)):
        h = mm(h, p[pre + f"linears.{i}.w"])
        h = torch.relu(_batchnorm(h, p, pre + f"bns.{i}", mode, new_stats, stats))
    return mm(h, p[pre + "final.w"]) + p[pre + "final.b"]


def forward(p, plan, w, mode="eval", mm=matmul, new_stats=None, stats=None):
    """Map latents ``w [B, n_flow]`` to ``(x, jac)`` in ``w``'s dtype.
    ``mode="train"`` uses batch statistics and, given a dict ``new_stats``,
    puts every BatchNorm's moved running statistics there; ``"eval"`` the
    running statistics, and with a dict ``stats`` records each BatchNorm
    input's ``(mean, biased variance)``."""
    x = w
    jac = torch.ones(w.shape[0], dtype=w.dtype, device=w.device)
    for op in plan.ops:
        if op[0] == "perm":
            x = x[:, list(op[1])]
            continue
        c = op[1]
        pt = plan.pass_through[c]
        z = conditioner(p, c, plan, x[:, :pt], mode, mm, new_stats, stats)
        yB, pdf = pwquad(z, x[:, pt:], plan.n_bins)
        x = torch.cat([x[:, :pt], yB], 1)
        jac = jac * pdf
    return x, jac


def stats_update(p, stats, n):
    """The running statistics moved by one momentum step towards
    ``stats`` (each BatchNorm input's mean and biased variance over ``n``
    samples, :func:`forward` in ``eval`` mode), the variance made unbiased."""
    out = {}
    for key, (mean, var) in stats.items():
        out[key + ".mean"] = (1 - MOMENTUM) * p[key + ".mean"] + MOMENTUM * mean
        out[key + ".var"] = (1 - MOMENTUM) * p[key + ".var"] + MOMENTUM * var * (n / max(n - 1, 1))
    return out


def in_blocks(fn, w, block):
    """``fn`` over row blocks of ``w``, the results concatenated."""
    outs = [fn(w[i:i + block]) for i in range(0, w.shape[0], block)]
    return tuple(torch.cat(parts) for parts in zip(*outs))
