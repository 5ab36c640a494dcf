"""Checkpoint save/restore for nested trees of tensors, arrays and scalars.

Counterpart of ``nf_tpu.utils.checkpoint``.  nf_tpu writes flax msgpack,
which needs JAX; the port writes ``torch.save`` files and reads them back
with ``weights_only=True``.  So the two packages' checkpoint files are not
interchangeable.

A tree is nested dicts, tuples and lists whose leaves are tensors, numpy
arrays and Python scalars.  :func:`save` writes a temporary file in the
target's directory and moves it onto the target with ``os.replace``, so a
save that fails part way leaves the previous file as it was.
"""

from __future__ import annotations

import os
import tempfile
from collections.abc import Mapping

import numpy as np
import torch


def _to_saved(tree):
    """Tensors to the CPU, numpy arrays and numpy scalars to tensors (a
    ``weights_only`` load refuses numpy objects)."""
    if isinstance(tree, Mapping):
        return {k: _to_saved(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_saved(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(tree))
    return tree


def save(path, tree):
    """Write ``tree`` to ``path`` through a temporary file in its directory."""
    path = os.fspath(path)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)),
                               prefix=os.path.basename(path) + ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            torch.save(_to_saved(tree), fh)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def _restore(template, stored, where):
    if template is None:
        return stored
    if isinstance(template, Mapping):
        if not isinstance(stored, Mapping) or set(stored) != set(template):
            raise ValueError(f"checkpoint {where or 'root'}: keys differ from the template")
        return {k: _restore(template[k], stored[k], f"{where}/{k}") for k in template}
    if isinstance(template, (tuple, list)):
        if not isinstance(stored, (tuple, list)) or len(stored) != len(template):
            raise ValueError(f"checkpoint {where or 'root'}: length differs from the template")
        return type(template)(_restore(t, s, f"{where}/{i}")
                              for i, (t, s) in enumerate(zip(template, stored)))
    if isinstance(template, torch.Tensor):
        if not isinstance(stored, torch.Tensor):
            raise ValueError(f"checkpoint {where}: a tensor was expected")
        return stored.to(template.device)
    if isinstance(template, (np.ndarray, np.generic)):
        if not isinstance(stored, torch.Tensor):
            raise ValueError(f"checkpoint {where}: an array was expected")
        return stored.numpy()
    return stored


def load(path, template):
    """Restore a tree saved by :func:`save`.

    ``template`` gives the structure (the same keys and lengths) and each
    leaf's kind: a tensor leaf comes back as a tensor on the template's
    device, an array leaf as a numpy array, a scalar as stored.  Leaf values
    and shapes are the stored ones.  A ``None`` in the template takes the
    stored subtree as it is.
    """
    stored = torch.load(os.fspath(path), map_location="cpu", weights_only=True)
    return _restore(template, stored, "")
