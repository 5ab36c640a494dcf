"""Optimizers matching the torch configurations used by the reference harness.

The reference trains with ``torch.optim.Adamax(params, lr, weight_decay)``
(reference experiment_mg.py:50).  nf_tpu reproduces it as
``add_decayed_weights`` (L2 added to the gradient before the moments)
chained in front of ``optax.adamax``, whose infinity moment is
``max(b2 * u, |g| + eps)`` like torch's.  So the port uses
``torch.optim.Adamax`` itself, and :func:`adam` ``torch.optim.Adam`` for
nf_tpu's ``add_decayed_weights`` + ``optax.adam`` (optax's defaults:
``b1=0.9, b2=0.999, eps=1e-8``).  ``tests/test_torch_manager.py`` holds three
updates of each against nf_tpu's in float64.

Each factory returns ``make(params) -> torch.optim.Optimizer``: the manager
binds it to the model's parameters when training starts.  The per-epoch
trainer calls its ``step()``.  The chunked trainer on the card replays its
epochs as CUDA graphs, and a graph cannot take the host's float64 bias
correction that torch's step computes each epoch: there :func:`device_step`
runs the same step as the update kernel of :mod:`nf_tpu_torch.ops.optim_step`
(:class:`DeviceStep`), which gives the per-epoch step's bits.  An optimizer
it does not cover (another class, ``amsgrad``, ``maximize``, ``fused``,
``foreach=False``, several parameter groups) is made capturable instead
(:func:`set_capturable`): torch's capturable step computes its bias
correction on the device in the parameters' dtype, so there the two
cadences agree only within that rounding.
"""

from __future__ import annotations

import functools

import torch

from nf_tpu_torch.ops import optim_step


def adamax(learning_rate: float, weight_decay: float = 0.0,
           b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    return functools.partial(torch.optim.Adamax, lr=learning_rate,
                             betas=(b1, b2), eps=eps, weight_decay=weight_decay)


def adam(learning_rate: float, weight_decay: float = 0.0):
    return functools.partial(torch.optim.Adam, lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


def set_capturable(optimizer, capturable: bool):
    """Set every parameter group's ``capturable`` flag (a group without one
    is left alone) and put each parameter's ``step`` where that flag wants
    it: on the parameter's device for a CUDA graph, on the CPU otherwise.
    ``load_state_dict`` takes the flag from the file, so the manager calls
    this after it.  The capturable step computes its bias correction on the
    device in the parameters' dtype where the other computes it on the host
    in float64: the two round differently (PERF.md §6)."""
    for group in optimizer.param_groups:
        if "capturable" in group:
            group["capturable"] = capturable
        for p in group["params"]:
            state = optimizer.state.get(p, {})
            if torch.is_tensor(state.get("step")):
                state["step"] = state["step"].to(p.device if capturable else "cpu")


# the moments torch keeps beside "step", in the order it makes them
_MOMENTS = {torch.optim.Adamax: ("exp_avg", "exp_inf"),
            torch.optim.Adam: ("exp_avg", "exp_avg_sq")}


def _steps_taken(optimizer, params):
    """The step count every parameter's state holds, 0 with no state, or
    ``None`` where they differ or only some parameters have state."""
    steps = {float(optimizer.state[p]["step"]) if optimizer.state.get(p) else None
             for p in params}
    if len(steps) != 1:
        return None
    step = steps.pop()
    return 0 if step is None else int(step)


def device_step(optimizer, steps):
    """A :class:`DeviceStep` for ``optimizer`` that can take ``steps`` more
    steps, or ``None`` where the update kernel does not cover it: not
    exactly ``torch.optim.Adamax`` or ``Adam``, more than one parameter
    group, a flag other than the defaults the per-epoch trainer's step runs
    with (``amsgrad``, ``maximize``, ``fused``, ``foreach=False``,
    ``differentiable``, ``decoupled_weight_decay``), a tensor ``lr`` or
    betas, parameters that are not float32 or float64 on one CUDA device,
    or states whose step counts differ."""
    if type(optimizer) not in _MOMENTS or len(optimizer.param_groups) != 1:
        return None
    group = optimizer.param_groups[0]
    params = list(group["params"])
    if any(group.get(flag) for flag in ("amsgrad", "maximize", "fused", "differentiable",
                                        "decoupled_weight_decay")) \
            or group.get("foreach") is False:
        return None
    if any(torch.is_tensor(v) for v in (group["lr"], *group["betas"], group["eps"],
                                        group["weight_decay"])):
        return None
    device, dtype = params[0].device, params[0].dtype
    if device.type != "cuda" or dtype not in (torch.float32, torch.float64) or any(
            p.device != device or p.dtype != dtype or p.is_complex() for p in params):
        return None
    taken = _steps_taken(optimizer, params)
    if taken is None:
        return None
    return DeviceStep(optimizer, taken, steps)


class DeviceStep:
    """``optimizer.step()`` as the update kernel, for the chunked trainer:
    what torch's per-epoch step computes, bit for bit, with the step count
    on the device so a CUDA graph of it takes each epoch's scalars.

    It stands in for the optimizer where the trainer steps it
    (``zero_grad`` and ``step``).  The state stays torch's: ``step`` makes
    a parameter's state as torch's first step makes it and updates the
    moments in place; the host's ``step`` counts lag behind the device's
    until :meth:`write_steps`.  ``t`` counts the steps taken, as the host
    knows them: :meth:`advance` adds the ``k`` steps a chunk is about to
    take (a replayed graph runs no Python), within the ``steps`` the tables
    were made for."""

    def __init__(self, optimizer, taken, steps):
        self.optimizer = optimizer
        group = optimizer.param_groups[0]
        self._params = list(group["params"])
        self._adam = type(optimizer) is torch.optim.Adam
        self._hyper = dict(beta1=group["betas"][0], beta2=group["betas"][1], eps=group["eps"],
                           weight_decay=group["weight_decay"])
        device = self._params[0].device
        self.t, self.t_max = taken, taken + steps
        self._tables = optim_step.step_tables(group["lr"], group["betas"], self.t_max,
                                              self._adam, device)
        self.counter = torch.tensor([taken], dtype=torch.int64, device=device)

    def zero_grad(self, set_to_none=True):
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def step(self):
        """One step of every parameter: one launch of the update kernel."""
        if any(p.grad is None for p in self._params):
            raise RuntimeError("the device step updates every parameter at once: each needs "
                               "a gradient")
        names = _MOMENTS[type(self.optimizer)]
        states = []
        for p in self._params:
            state = self.optimizer.state[p]
            if not state:   # torch's first step makes it so (_init_group)
                dtype = torch.float64 if torch.get_default_dtype() == torch.float64 \
                    else torch.float32
                state["step"] = torch.tensor(0.0, dtype=dtype)
                for name in names:
                    state[name] = torch.zeros_like(p, memory_format=torch.preserve_format)
            states.append(state)
        optim_step.update(self._params, [p.grad for p in self._params],
                          [s[names[0]] for s in states], [s[names[1]] for s in states],
                          self.counter, self._tables, adam=self._adam, **self._hyper)

    def advance(self, k):
        """Count ``k`` steps about to be taken; raises where the tables end
        before them."""
        if self.t + k > self.t_max:
            raise ValueError(f"the update's tables hold steps up to {self.t_max}; "
                             f"{self.t} + {k} steps asked for")
        self.t += k

    def save(self):
        return self.counter.clone(), self.t

    def restore(self, saved):
        counter, self.t = saved
        self.counter.copy_(counter)

    def write_steps(self):
        """Every state's ``step`` to the steps taken, as the per-epoch run's
        holds it."""
        for p in self._params:
            state = self.optimizer.state.get(p)
            if state:
                state["step"].fill_(self.t)
