"""The port's flow plans, FlowModel and weight interop against nf_tpu.

Plans must be identical (``Flow.ops``); forwards are compared in float64 on
transplanted weights, in train mode (with the new BatchNorm buffers) and in
eval mode, at rtol 1e-10.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf_tpu.flows import factory as jfactory
from nf_tpu.flows import model as jmodel
from nf_tpu_torch import interop
from nf_tpu_torch.flows import factory as tfactory
from nf_tpu_torch.flows.fast_eval import make_folded_forward

torch.set_num_threads(1)
RTOL = 1e-10
PORT = Path(__file__).resolve().parent.parent / "nf_tpu_torch"


@pytest.mark.parametrize("n_flow,n_cells", [(2, 3), (4, 2), (7, 2), (10, 8), (10, 11)])
def test_pwquad_plan_matches_nf_tpu(n_flow, n_cells):
    jflow, _, _ = jfactory.build_pwquad_flow(jax.random.PRNGKey(0), n_flow, n_cells, 3,
                                             (4,), jnp.float64)
    tflow = tfactory.build_pwquad_flow(torch.Generator(), n_flow, n_cells, 3, (4,)).flow
    assert tflow.ops == jflow.ops
    assert [dataclasses.asdict(c) for c in tflow.cells] == \
        [dataclasses.asdict(c) for c in jflow.cells]
    assert tfactory.adjust_pwquad_cells(n_flow, n_cells) == \
        jfactory.adjust_pwquad_cells(n_flow, n_cells)


def test_pwlin_and_affine_plans_match_nf_tpu():
    key, gen = jax.random.PRNGKey(0), torch.Generator()
    jl, _, _ = jfactory.build_pwlin_flow(key, 5, 2, 3, 4, (6,), 2, jnp.float64)
    tl = tfactory.build_pwlin_flow(gen, 5, 2, 3, 4, (6,), 2).flow
    ja, _, _ = jfactory.build_affine_flow(key, 4, 1, 3, (6,), 1, jnp.float64)
    ta = tfactory.build_affine_flow(gen, 4, 1, 3, (6,), 1).flow
    assert tl.ops == jl.ops and ta.ops == ja.ops
    # every roll is kept (DESIGN.md fixed bug 1)
    assert sum(op[0] == "roll" for op in ta.ops) == 3


def _pair(name):
    """(flow, numpy params, numpy state) from nf_tpu with BN statistics moved
    off their init values, and the port's FlowModel holding the same."""
    factories = {
        "camel": lambda k: jfactory.build_pwquad_flow(k, 2, 2, 4, (3, 3, 3), jnp.float64),
        "masked_rank": lambda k: jfactory.build_pwquad_flow(k, 10, 8, 3, (6, 6), jnp.float64,
                                                             final_rank=2),
        "pwlin": lambda k: jfactory.build_pwlin_flow(k, 3, 1, 3, 5, (6,), 1, jnp.float64),
        "affine": lambda k: jfactory.build_affine_flow(k, 3, 1, 3, (5,), 1, jnp.float64),
    }
    flow, params, state = factories[name](jax.random.PRNGKey(3))
    params, state = jax.tree.map(np.asarray, (params, state))
    rng = np.random.RandomState(5)
    for s in state:
        for bs in [s["bn_in"]] + list(s["bns"]):
            bs["mean"] = rng.standard_normal(bs["mean"].shape) * 0.2
            bs["var"] = rng.uniform(0.5, 2.0, bs["var"].shape)
    return flow, params, state, interop.from_numpy(flow, params, state)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name", ["camel", "masked_rank", "pwlin", "affine"])
def test_flow_forward_matches_nf_tpu(name, train):
    flow, params, state, model = _pair(name)
    w = np.random.RandomState(1).uniform(size=(64, flow.n_flow))
    x_j, jac_j, state_j = jax.jit(jmodel.forward, static_argnums=(0, 4))(
        flow, params, state, jnp.asarray(w), train)
    with torch.no_grad():
        x_t, jac_t = model(torch.tensor(w), train)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(jac_t.numpy(), np.asarray(jac_j), rtol=RTOL)
    _, state_t = interop.to_numpy(model)
    for a, b in zip(jax.tree.leaves(state_t), jax.tree.leaves(state_j)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL)


def test_frozen_forward_keeps_buffers():
    flow, params, state, model = _pair("camel")
    w = torch.rand(32, 2, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.named_buffers()}
    with torch.no_grad():
        x_f, jac_f = model.frozen_forward(w, True)
    assert all(torch.equal(before[k], v) for k, v in model.named_buffers())
    with torch.no_grad():
        x, jac = model(w, True)
    assert torch.equal(x, x_f) and torch.equal(jac, jac_f)
    assert not torch.equal(before["cells.0.bn_in.mean"], model.cells[0].bn_in.mean)


def test_interop_round_trip():
    flow, params, state, model = _pair("masked_rank")
    p2, s2 = interop.to_numpy(model)
    assert jax.tree.structure((p2, s2)) == jax.tree.structure((params, state))
    for a, b in zip(jax.tree.leaves((p2, s2)), jax.tree.leaves((params, state))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        bad = jax.tree.map(lambda a: a, params)
        bad[0]["final"]["u"] = bad[0]["final"]["u"][:, :1]
        interop.from_numpy(flow, bad, state)


@pytest.mark.parametrize("name", ["camel", "masked_rank", "pwlin", "affine"])
def test_folded_forward_matches_eval_forward(name):
    """The kernel's plain version (BN folded, float64 here) equals the
    FlowModel's eval forward."""
    flow, _, _, model = _pair(name)
    w = torch.rand(100, flow.n_flow, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        x, jac = model(w, False)
    x_f, jac_f = make_folded_forward(flow, model, torch.float64)(w)
    torch.testing.assert_close(x_f, x, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(jac_f, jac, rtol=1e-9, atol=0)


def test_identity_init_is_the_identity():
    gen = torch.Generator().manual_seed(0)
    for model in (tfactory.build_pwquad_flow(gen, 3, 3, 4, (5,)),
                  tfactory.build_pwquad_flow(gen, 2, 2, 4, (5,), final_rank=2)):
        tfactory.identity_init(model)
        w = torch.rand(50, model.flow.n_flow, generator=gen)
        with torch.no_grad():
            x, jac = model(w, True)
        torch.testing.assert_close(x, w, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(jac, torch.ones(50), rtol=1e-6, atol=1e-6)


def test_port_imports_no_jax():
    """nf_tpu_torch never imports jax, flax, optax or nf_tpu: checked in a
    fresh interpreter and in the sources."""
    code = ("import sys, pkgutil, importlib, nf_tpu_torch\n"
            "for m in pkgutil.walk_packages(nf_tpu_torch.__path__, 'nf_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'nf_tpu'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=PORT.parent, timeout=120)
    for src in PORT.rglob("*.py"):
        for line in src.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in ("jax", "flax", "optax", "nf_tpu"), \
                    f"{src}: {line}"
