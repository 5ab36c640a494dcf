"""The port's fused sampler against nf_tpu's.

The kernel's plain version (``nf_tpu_torch.flows.fast_eval.
make_folded_forward``) is held against nf_tpu's Pallas sampler run in
interpret mode on the same numpy latents, at nf_tpu's own interpret-mode
bounds (tests/test_pallas.py), and the host BatchNorm fold against nf_tpu's.
The CUDA kernel itself is tested in tests/test_torch_kernel.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nf_tpu.flows import factory as jfactory
from nf_tpu.ops import pwquad_sampler as jsampler
from nf_tpu_torch import interop
from nf_tpu_torch.flows.fast_eval import make_folded_forward
from nf_tpu_torch.ops import pwquad_sampler as tsampler

torch.set_num_threads(1)


def _perturb(params, state, seed):
    """numpy copies of nf_tpu's trees with BN scales, shifts and running
    statistics moved off their init values, so the fold is not trivial."""
    rng = np.random.RandomState(seed)
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)

    def bn(p, s):
        n = p["scale"].shape[0]
        p["scale"] = (1.0 + 0.3 * rng.standard_normal(n)).astype(p["scale"].dtype)
        p["bias"] = (0.2 * rng.standard_normal(n)).astype(p["bias"].dtype)
        s["mean"] = (0.3 * rng.standard_normal(n)).astype(s["mean"].dtype)
        s["var"] = rng.uniform(0.5, 2.0, n).astype(s["var"].dtype)

    for p, s in zip(params, state):
        bn(p["bn_in"], s["bn_in"])
        for bp, bs in zip(p["bns"], s["bns"]):
            bn(bp, bs)
    return params, state


FLOWS = {
    # camel-2D main path architecture, narrowed
    "pwquad_camel": lambda dt: jfactory.build_pwquad_flow(
        jax.random.PRNGKey(0), 2, 2, 4, (3, 3, 3), dt),
    # masked n_flow > 7 plan (gather/scatter) with a factored final layer
    "pwquad_masked_rank": lambda dt: jfactory.build_pwquad_flow(
        jax.random.PRNGKey(8), 8, 6, 2, (4,), dt, final_rank=2),
    "pwlin_squareplus": lambda dt: jfactory.build_pwlin_flow(
        jax.random.PRNGKey(4), 3, 1, 2, 4, (4,), 1, dt, activation="squareplus"),
    "affine": lambda dt: jfactory.build_affine_flow(
        jax.random.PRNGKey(6), 2, 1, 2, (6,), 1, dt),
    # plans beyond the port's old kernel caps (32 bins, hidden width 64, 32
    # latent dims), which nf_tpu's kernel takes; narrow elsewhere, since
    # interpret mode unrolls every weight (n_flow 36 with pwquad cells would
    # take 12 masked cells)
    "pwquad_bins40": lambda dt: jfactory.build_pwquad_flow(
        jax.random.PRNGKey(3), 2, 2, 40, (3,), dt),
    "pwquad_hidden96": lambda dt: jfactory.build_pwquad_flow(
        jax.random.PRNGKey(7), 2, 2, 4, (96,), dt),
    "pwlin_flow36": lambda dt: jfactory.build_pwlin_flow(
        jax.random.PRNGKey(5), 36, 18, 2, 2, (2,), 18, dt),
}


def _flow(name, dtype=jnp.float32):
    flow, params, state = FLOWS[name](dtype)
    params, state = _perturb(params, state, seed=len(name))
    return flow, params, state


def _latents(n, n_flow, seed=11):
    return np.random.RandomState(seed).uniform(size=(n, n_flow)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(FLOWS))
def test_plain_version_matches_nf_tpu_kernel(name):
    """make_folded_forward == nf_tpu's build_sampler(take_latents=True) in
    interpret mode, on identical latents (n=300: a ragged tile there)."""
    flow, params, state = _flow(name)
    w = _latents(300, flow.n_flow)
    x_j, jac_j = jax.jit(jsampler.build_sampler(flow, params, state, interpret=True,
                                                take_latents=True))(jnp.asarray(w))
    model = interop.from_numpy(flow, params, state, dtype=torch.float32)
    x_t, jac_t = make_folded_forward(flow, model)(torch.from_numpy(w))
    # nf_tpu's interpret-mode bounds (test_pallas.py); its affine kernel
    # uses a polynomial atan, the port atanf
    rtol, atol = (5e-5, 5e-6) if name == "affine" else (2e-5, 2e-6)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=rtol, atol=atol)
    np.testing.assert_allclose(jac_t.numpy(), np.asarray(jac_j), rtol=10 * rtol)


@pytest.mark.parametrize("name", sorted(FLOWS))
def test_fold_matches_nf_tpu(name):
    flow, params, state = _flow(name, jnp.float64)
    model = interop.from_numpy(flow, params, state, dtype=torch.float64)
    ours = tsampler.fold_eval_params(flow, model, dtype=np.float64)
    theirs = jsampler.fold_eval_params(flow, params, state, dtype=np.float64)
    assert len(ours) == len(theirs)
    for lo, lt in zip(ours, theirs):
        assert [r for _, _, r in lo] == [r for _, _, r in lt]
        for (wo, bo, _), (wt, bt, _) in zip(lo, lt):
            np.testing.assert_allclose(wo, wt, rtol=1e-12, atol=1e-14)
            np.testing.assert_allclose(bo, bt, rtol=1e-12, atol=1e-14)
