"""Static permutation schedules between coupling cells.

Plain index arrays computed at model-build time (counterpart of
``nf_tpu.bijectors.permutations``; reference layers.py:6-51, manager.py:20-36).
"""

from __future__ import annotations

import numpy as np


def get_bin(x: int, n: int = 0) -> list[int]:
    """Binary digits of ``x``, zero-padded to ``n`` digits, MSB first."""
    return [int(c) for c in format(x, "b").zfill(n)]


def mask_partition(n_flow: int, pos: int) -> tuple[np.ndarray, np.ndarray]:
    """Partition dimensions by bit ``pos//2`` of their binary index.

    Returns ``(feeder, trafoer)``: the pass-through dims and the transformed
    dims for masked cell ``pos``.  ``pos % 2`` alternates which bit value
    passes through.
    """
    feed = pos % 2
    bit = pos // 2
    n_digits = len(get_bin(n_flow - 1, 0))
    codes = np.array([get_bin(d, n_digits) for d in range(n_flow)], dtype=np.int64)
    masker = codes[:, bit]
    feeder = np.nonzero(masker == feed)[0]
    trafoer = np.nonzero(masker == (1 - feed))[0]
    return feeder, trafoer


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv
