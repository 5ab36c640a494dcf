"""Moving flow weights between nf_tpu's pytree layout and a FlowModel.

nf_tpu keeps a flow's weights as two tuples with one entry per cell:

    params[i] = {"bn_in": {"scale", "bias"},
                 "linears": [{"w", ("b")}, ...],
                 "bns": [{"scale", "bias"}, ...],
                 "final": {"w", "b"} or {"u", "v", "b"}}
    state[i]  = {"bn_in": {"mean", "var"}, "bns": [{"mean", "var"}, ...]}

Here every leaf is a numpy array.  The port keeps nf_tpu's ``w`` layout
``[fan_in, fan_out]`` (see :mod:`nf_tpu_torch.bijectors.conditioner`), so no
array is transposed either way.
"""

from __future__ import annotations

import numpy as np
import torch

from nf_tpu_torch.flows.model import Flow, FlowModel


def _copy_into(tensor, array):
    array = np.asarray(array)
    if tuple(array.shape) != tuple(tensor.shape):
        raise ValueError(f"shape {array.shape} != expected {tuple(tensor.shape)}")
    tensor.copy_(torch.tensor(array, dtype=tensor.dtype))


def from_numpy(flow: Flow, params, state, dtype=torch.float64,
               device="cpu") -> FlowModel:
    """Build a FlowModel for ``flow`` holding nf_tpu's ``(params, state)``."""
    model = FlowModel(flow, torch.Generator().manual_seed(0), dtype, device)
    with torch.no_grad():
        for cond, p, s in zip(model.cells, params, state):
            bns = [(cond.bn_in, p["bn_in"], s["bn_in"])] + list(
                zip(cond.bns, p["bns"], s["bns"]))
            for bn, bp, bs in bns:
                _copy_into(bn.scale, bp["scale"])
                _copy_into(bn.bias, bp["bias"])
                _copy_into(bn.mean, bs["mean"])
                _copy_into(bn.var, bs["var"])
            if len(cond.linears) != len(p["linears"]):
                raise ValueError("hidden layer count differs from the plan")
            for lin, lp in zip(cond.linears, p["linears"]):
                if set(lin.keys()) != set(lp.keys()):
                    raise ValueError(f"linear keys {sorted(lp)} != {sorted(lin.keys())}")
                for k in lin.keys():
                    _copy_into(lin[k], lp[k])
            if set(cond.final.keys()) != set(p["final"].keys()):
                raise ValueError("final layer keys differ from the plan")
            for k in cond.final.keys():
                _copy_into(cond.final[k], p["final"][k])
    return model


def to_numpy(model: FlowModel):
    """``(params, state)`` of ``model`` in nf_tpu's layout, as numpy arrays."""
    def arr(t):
        return t.detach().cpu().numpy().copy()

    def bn_p(bn):
        return {"scale": arr(bn.scale), "bias": arr(bn.bias)}

    def bn_s(bn):
        return {"mean": arr(bn.mean), "var": arr(bn.var)}

    params, state = [], []
    for cond in model.cells:
        params.append({
            "bn_in": bn_p(cond.bn_in),
            "linears": [{k: arr(v) for k, v in lin.items()} for lin in cond.linears],
            "bns": [bn_p(bn) for bn in cond.bns],
            "final": {k: arr(v) for k, v in cond.final.items()},
        })
        state.append({"bn_in": bn_s(cond.bn_in),
                      "bns": [bn_s(bn) for bn in cond.bns]})
    return tuple(params), tuple(state)


def channel_models_from_numpy(flows, params, states, dtype=torch.float64, device="cpu"):
    """nf_tpu's per-channel ``(flows, params, states)`` tuples (what its
    ``build_channel_flows`` returns, leaves as numpy arrays) as a tuple of
    the port's models, one per channel."""
    return tuple(from_numpy(f, p, s, dtype, device) for f, p, s in zip(flows, params, states))


def stack_models(models):
    """The parameters and buffers of equally built ``models``, stacked along
    a leading run axis: ``(params, buffers)``, dicts keyed by the models'
    ``named_parameters`` / ``named_buffers`` names."""
    def stack(named):
        names = [dict(named(m)) for m in models]
        return {k: torch.stack([n[k].detach() for n in names]) for k in names[0]}
    return (stack(lambda m: m.named_parameters()), stack(lambda m: m.named_buffers()))


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_index_tree(v, i) for v in tree)
    return np.asarray(tree)[i]


def ensemble_from_numpy(flow: Flow, params_stack, bn_stack, dtype=torch.float64,
                        device="cpu"):
    """nf_tpu's stacked ensemble pytrees (what its ``stack_ensemble``
    returns, leaves as numpy arrays with a leading run axis) as the port's
    ``(params, buffers)`` stacks (:func:`stack_models`)."""
    first = params_stack[0]["bn_in"]["scale"]
    return stack_models([from_numpy(flow, _index_tree(params_stack, r), _index_tree(bn_stack, r),
                                    dtype, device) for r in range(np.shape(first)[0])])


def ensemble_member(flow: Flow, stacked, i) -> FlowModel:
    """Run ``i`` of a ``(params, buffers)`` stack as a FlowModel, on the
    stack's device and dtype (to carry into a manager, load its
    ``state_dict`` into the manager's model)."""
    params, buffers = stacked
    leaf = next(iter(params.values()))
    model = FlowModel(flow, torch.Generator(device=leaf.device).manual_seed(0), leaf.dtype,
                      leaf.device)
    model.load_state_dict({k: v[i] for k, v in {**params, **buffers}.items()})
    return model
