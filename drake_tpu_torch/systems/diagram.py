"""System composition combinators: the Diagram/DiagramBuilder role.

The PyTorch counterpart of ``drake_tpu/systems/diagram.py``: composition is
function composition, the lanes of a batch riding in the leading dimensions
of ``x`` and ``u``.

  - ``cascade(sys1, sys2)``: sys1's output feeds sys2's input (series).
  - ``feedback(plant, controller)``: u = controller(y) closes the loop.
  - ``parallel_compose(a, b)``: independent states side by side.

Composed systems carry tupled params: params = (params1, params2).
"""

from __future__ import annotations

from typing import Callable

import torch

from drake_tpu_torch.systems.base import ContinuousSystem


def _output_of(system: ContinuousSystem):
    if system.output is not None:
        return system.output
    return lambda params, x, u, t: x  # full-state output by default


def cascade(sys1: ContinuousSystem, sys2: ContinuousSystem) -> ContinuousSystem:
    """Series connection: u -> sys1 -> sys2 -> y.  State x = [x1; x2]."""
    n1 = sys1.num_states
    out1 = _output_of(sys1)
    out2 = _output_of(sys2)

    def f(params, x, u, t=0.0):
        p1, p2 = params
        x1, x2 = x[..., :n1], x[..., n1:]
        y1 = out1(p1, x1, u, t)
        return torch.cat([sys1.f(p1, x1, u, t), sys2.f(p2, x2, y1, t)], dim=-1)

    def output(params, x, u, t=0.0):
        p1, p2 = params
        x1, x2 = x[..., :n1], x[..., n1:]
        return out2(p2, x2, out1(p1, x1, u, t), t)

    return ContinuousSystem(
        f=f,
        num_states=n1 + sys2.num_states,
        num_inputs=sys1.num_inputs,
        output=output,
        default_params=(sys1.default_params, sys2.default_params),
    )


def feedback(plant: ContinuousSystem, controller: Callable,
             reference_input: bool = True) -> ContinuousSystem:
    """Close the loop: u_plant = controller(params, y_plant, r, t).

    ``controller`` is memoryless; the plant's output is evaluated at zero
    input (no direct-feedthrough loops, as Drake's DiagramBuilder rejects
    algebraic loops).  The composed system's input is the reference r (or
    nothing with reference_input=False)."""
    out = _output_of(plant)
    nu = plant.num_inputs

    def f(params, x, r, t=0.0):
        y = out(params, x, x.new_zeros(x.shape[:-1] + (nu,)), t)
        return plant.f(params, x, controller(params, y, r, t), t)

    return ContinuousSystem(
        f=f,
        num_states=plant.num_states,
        num_inputs=plant.num_inputs if reference_input else 0,
        output=plant.output,
        default_params=plant.default_params,
    )


def parallel_compose(a: ContinuousSystem, b: ContinuousSystem) -> ContinuousSystem:
    """Two independent systems side by side: x = [xa; xb], u = [ua; ub]."""
    na, ma = a.num_states, a.num_inputs

    def f(params, x, u, t=0.0):
        pa, pb = params
        return torch.cat([a.f(pa, x[..., :na], u[..., :ma], t),
                          b.f(pb, x[..., na:], u[..., ma:], t)], dim=-1)

    return ContinuousSystem(
        f=f,
        num_states=na + b.num_states,
        num_inputs=ma + b.num_inputs,
        default_params=(a.default_params, b.default_params),
    )
