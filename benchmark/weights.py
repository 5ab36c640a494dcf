"""The flow's parameters, made by the benchmark from the run's seed.

Every parameter and BatchNorm buffer of a configuration's flow, made on the
device from one ``torch.Generator`` in one draw, in float32 (the type the
program trains and serves in), keyed as the reference flow and the
program's ``state_dict`` both key them.

``default``: every weight ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``, as
``torch.nn.Linear`` initialises (the program's own rule); BatchNorm scale 1,
bias 0, running mean 0, variance 1.

``identity_perturbed`` with ``scale`` s: the published identity start (the
final layers zero, so every transform is the identity) perturbed in every
parameter, so that no transform is the identity and every bin takes part:
hidden weights as ``default``, final weights and biases ``U(-s/sqrt(fan_in),
s/sqrt(fan_in))``, BatchNorm scales ``1 + U(-s, s)`` and biases ``U(-s, s)``.
"""

from __future__ import annotations

import hashlib

import torch

from benchmark.reference import flow


def derive(seed, tag, i=0):
    """A 62-bit seed for stream ``tag`` / ``i`` of the run seed ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}:{int(i)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 62) - 1)


def make_params(plan, init, seed, device):
    """``{key: float32 tensor}`` for ``plan`` under the ``init`` entry of a
    configuration (``{"kind": ..., "scale": ...}``)."""
    shapes = flow.param_shapes(plan)
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    u = torch.rand(sum(torch.Size(s).numel() for s in shapes.values()), generator=gen,
                   dtype=torch.float32, device=device) * 2.0 - 1.0
    kind, s = init["kind"], float(init.get("scale", 0.0))
    if kind not in ("default", "identity_perturbed"):
        raise ValueError(f"unknown init {kind!r}")
    out, off = {}, 0
    fan_in = {}
    for key, shape in shapes.items():
        n = torch.Size(shape).numel()
        r = u[off:off + n].reshape(shape)
        off += n
        leaf = key.rsplit(".", 1)[1]
        layer = key.rsplit(".", 1)[0]
        if leaf == "w":
            fan_in[layer] = shape[0]
        if leaf == "mean":
            out[key] = torch.zeros(shape, dtype=torch.float32, device=device)
        elif leaf == "var":
            out[key] = torch.ones(shape, dtype=torch.float32, device=device)
        elif leaf in ("scale", "bias") and ".bn" in key:
            if kind == "default":
                out[key] = torch.full(shape, 1.0 if leaf == "scale" else 0.0,
                                      dtype=torch.float32, device=device)
            else:
                out[key] = (1.0 if leaf == "scale" else 0.0) + s * r
        else:
            bound = 1.0 / fan_in[layer] ** 0.5
            final = layer.endswith("final")
            out[key] = r * bound * (s if final and kind == "identity_perturbed" else 1.0)
    return out
