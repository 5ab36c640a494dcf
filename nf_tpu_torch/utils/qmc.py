"""Randomized quasi-Monte-Carlo latents and integration.

Counterpart of ``nf_tpu.utils.qmc``.  Feeding the trained flow a scrambled
Sobol point set instead of iid uniforms moves the integration error from
O(N^-1/2) toward O(N^-1) for smooth integrand-times-Jacobian compositions.

Two generators:

  * :func:`sobol_latents`: scipy's Owen-scrambled Sobol on the host, one
    replication at a time;
  * :func:`make_device_sobol`: Sobol generated on the device in plain torch,
    the Joe-Kuo direction numbers (:func:`_direction_numbers`) as a Gray-code
    XOR ladder, then Burley's hash-based Owen scrambling ("Practical
    Hash-based Owen Scrambling", JCGT 2020: bit-reverse, Laine-Karras
    permutation, bit-reverse).  Its points equal nf_tpu's bit for bit.

torch has no complete uint32 arithmetic, so the device generator keeps each
32-bit word in an int64 and masks it to 32 bits after every add, shift left
and multiply; a product by a 32-bit constant is formed from the constant's
two 16-bit halves (:func:`_mul32`), so no intermediate passes 2^49.

Owen scrambling makes each replication an unbiased estimator; the error of
:func:`rqmc_integrate` and :func:`rqmc_integrate_device` is the standard
error across replications.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
# the replication stride of rqmc_integrate_device's seeds (2^32 / golden ratio)
_GOLDEN = 0x9E3779B9


def sobol_latents(n, dim, seed, dtype=np.float64):
    """One scrambled-Sobol replication of ``n`` points in (0, 1)^dim, as a
    numpy array.

    ``n`` is rounded up to the next power of two (Sobol balance; the actual
    count is the array's length).  The points are clipped after the cast to
    ``dtype`` into [tiny, largest value below 1], so no point is 0 or 1.
    """
    from scipy.stats import qmc

    m = max(int(math.ceil(math.log2(max(n, 1)))), 0)
    pts = qmc.Sobol(dim, scramble=True, seed=seed).random_base2(m)
    dtype = np.dtype(dtype)
    eps = np.finfo(dtype).tiny
    upper = np.nextafter(dtype.type(1.0), dtype.type(0.0))
    return np.clip(pts.astype(dtype), eps, upper)


def _direction_numbers(dim):
    """``[dim, 32]`` uint32 Joe-Kuo direction numbers from scipy's table.

    Reads scipy's private ``Sobol._sv``, so a rename or a change of its
    layout fails here, loudly: the attribute must exist, have the shape
    ``(dim, 32)``, and its first dimension must be van der Corput's
    (``sv[0, j] = 2^(31-j)``), before the rest of the table is trusted.
    """
    from scipy.stats import qmc

    sv = getattr(qmc.Sobol(dim, scramble=False, bits=32), "_sv", None)
    if sv is None:
        raise RuntimeError(
            "scipy.stats.qmc.Sobol no longer exposes `_sv` (internal "
            "direction-number table); update nf_tpu_torch.utils.qmc."
            "_direction_numbers for this scipy version "
            "or vendor the Joe-Kuo table.")
    sv = np.asarray(sv, dtype=np.uint32)
    expected0 = np.uint32(1) << np.arange(31, -1, -1, dtype=np.uint32)
    if sv.shape != (dim, 32) or not np.array_equal(sv[0], expected0):
        raise RuntimeError(
            f"scipy Sobol._sv layout changed (shape {sv.shape}, "
            "first-dimension check failed); update _direction_numbers.")
    return sv


def _mul32(x, c: int):
    """``x * c mod 2^32`` for int64 ``x`` in [0, 2^32) and a 32-bit constant
    ``c``: ``x c = x c_lo + 2^16 x c_hi``, and only the low 16 bits of
    ``x c_hi`` reach the low 32 bits of the product."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK


def _reverse32(x):
    """The bits of each 32-bit word in reverse order."""
    for shift, m in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F),
                     (8, 0x00FF00FF)):
        x = ((x & m) << shift) | ((x >> shift) & m)
    return ((x << 16) & _MASK) | (x >> 16)


def _laine_karras(x, seed):
    """Burley 2020 section 3: a random nested-uniform permutation in the
    bit-reversed domain (each output bit depends on lower bits only)."""
    x = (x + seed) & _MASK
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        x = x ^ _mul32(x, c)
    return x


def _hash(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def make_device_sobol(dim, scramble=True):
    """Build ``gen(n, seed, device) -> [n, dim] float32`` in (0, 1).

    ``n`` should be a power of two (Sobol balance).  ``seed`` is taken
    modulo 2^32; different seeds give independently Owen-scrambled
    replications.  ``scramble=False`` gives scipy's unscrambled sequence in
    Gray-code order.  The top 24 bits of each word, plus half a unit in the
    last place, become the float32 point.  Every operation runs on
    ``device``; nothing is read back to the host.
    """
    sv_host = _direction_numbers(dim).astype(np.int64)
    sv_on = {}   # the table on each device, copied once: a copy from host
    #              memory waits for the device's queue to drain

    def gen(n, seed, device):
        device = torch.device(device)
        if device not in sv_on:
            sv_on[device] = torch.as_tensor(sv_host, device=device)
        sv = sv_on[device]
        i = torch.arange(n, dtype=torch.int64, device=device)
        g = (i ^ (i >> 1))[:, None]           # Gray code: scipy's order
        x = torch.zeros((n, dim), dtype=torch.int64, device=device)
        for j in range(max(n - 1, 0).bit_length()):   # the bits g can have set
            x = torch.where(((g >> j) & 1).bool(), x ^ sv[:, j], x)
        if scramble:
            dims = torch.arange(dim, dtype=torch.int64, device=device)
            dim_seeds = _hash(_hash(dims) ^ (int(seed) & _MASK))
            x = _reverse32(_laine_karras(_reverse32(x), dim_seeds))
        return (x >> 8).to(torch.float32) * (1.0 / (1 << 24)) + (0.5 / (1 << 24))

    return gen


def rqmc_integrate_device(eval_mean, n_flow, nitn, neval, seed, device):
    """RQMC on the device: ``nitn`` Owen-scrambled replications of ``neval``
    points (rounded up to a power of two), generated by
    :func:`make_device_sobol` on ``device`` and consumed there.

    ``eval_mean(w [n, n_flow] float32) -> 0-d tensor`` maps a replication to
    its mean of f(T(w)) J(w).  Replication ``r`` is scrambled with seed
    ``seed + 0x9E3779B9 r mod 2^32``.  No replication syncs with the host;
    the result is read once.  Returns ``(sig, sig_err, n_actual)``, the
    error the standard error across replications (inf for one).
    """
    m = max(int(math.ceil(math.log2(max(neval, 1)))), 0)
    n = 1 << m
    gen = make_device_sobol(n_flow, scramble=True)
    means = torch.stack([eval_mean(gen(n, (seed + _GOLDEN * r) & _MASK, device))
                         for r in range(nitn)])
    return (*rqmc_result(means), n)


def rqmc_result(means):
    """``(sig, sig_err)`` floats of the replication means ``[reps]`` (a
    tensor): their mean and standard error (inf for one), read in one sync."""
    reps = means.shape[0]
    err = torch.std(means, correction=1) / math.sqrt(reps) if reps > 1 \
        else torch.full_like(means[0], math.inf)
    sig, err = torch.stack([torch.mean(means), err]).tolist()
    return sig, err


def rqmc_integrate(eval_mean, n_flow, nitn, neval, seed, dtype=np.float64):
    """RQMC from the host: ``nitn`` scrambled Sobol replications of ``neval``
    points (rounded up to a power of two) from :func:`sobol_latents`, with
    seeds ``seed, seed + 1, ...``.

    ``eval_mean(w [n, n_flow] numpy) -> scalar`` returns the mean of
    f(T(w)) J(w) over the replication.  Returns ``(sig, sig_err, n_actual)``
    with the standard error across replications (the within-replication
    variance means nothing for QMC points).
    """
    means = []
    for i in range(nitn):
        w = sobol_latents(neval, n_flow, seed=seed + i, dtype=dtype)
        means.append(float(eval_mean(w)))
    means = np.asarray(means)
    sig = means.mean()
    sig_err = means.std(ddof=1) / math.sqrt(nitn) if nitn > 1 else float("inf")
    return float(sig), float(sig_err), len(w)
