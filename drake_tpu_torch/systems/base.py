"""The system abstraction: pure dynamics functions instead of System<T>.

The PyTorch counterpart of ``drake_tpu/systems/base.py``: a system is a
function

    f(params, x, u, t) -> xdot            (continuous dynamics)
    g(params, x, u, t) -> x_next          (discrete update)

with its signature metadata, where ``x`` and ``u`` carry the lanes of a batch
in their leading dimensions and the function maps them lane by lane.
``linearize`` takes the Jacobians in forward mode, lane by lane
(``lane_jacobian``), as the reference's ``jax.jacfwd`` on one lane.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

Tensor = torch.Tensor
DynamicsFn = Callable[[Any, Tensor, Tensor, Any], Tensor]


def lane_jacobian(fn: Callable, y: Tensor) -> Tensor:
    """d fn(y) / d y of a lane-wise `fn` at `y` (..., n): (..., m, n).

    Forward mode, as ``torch.func.jacfwd``: one ``jvp`` per basis vector e_i,
    the same e_i in every lane, vmapped over the basis.  Since lane l of
    ``fn(y)`` depends on lane l of ``y`` alone, column i of each lane's
    Jacobian comes out of the same pass."""
    n = y.shape[-1]
    basis = torch.eye(n, dtype=y.dtype, device=y.device)
    basis = basis.reshape((n,) + (1,) * (y.dim() - 1) + (n,)).expand((n,) + y.shape)
    cols = torch.func.vmap(lambda v: torch.func.jvp(fn, (y,), (v,))[1])(basis)
    return cols.movedim(0, -1)


def _linearize(fn, params, x0, u0, t0):
    A = lane_jacobian(lambda x: fn(params, x, u0, t0), x0)
    B = lane_jacobian(lambda u: fn(params, x0, u, t0), u0)
    return A, B


@dataclasses.dataclass(frozen=True)
class ContinuousSystem:
    """A continuous-time system dx/dt = f(params, x, u, t).

    Optional ``output`` defaults to full-state output.  ``num_q``/``num_v``:
    an optional second-order split x = [q; v]."""

    f: DynamicsFn
    num_states: int
    num_inputs: int
    default_params: Any = None
    output: Optional[Callable[[Any, Tensor, Tensor, Any], Tensor]] = None
    num_q: Optional[int] = None
    num_v: Optional[int] = None

    def __call__(self, params, x, u, t=0.0):
        return self.f(params, x, u, t)

    def linearize(self, params, x0, u0, t0=0.0):
        """(A, B) of the Jacobian linearization about (x0, u0), per lane."""
        return _linearize(self.f, params, x0, u0, t0)

    def with_params(self, params):
        return dataclasses.replace(self, default_params=params)


@dataclasses.dataclass(frozen=True)
class DiscreteSystem:
    """A discrete-time system x[k+1] = g(params, x[k], u[k], t[k]), period h."""

    g: DynamicsFn
    num_states: int
    num_inputs: int
    time_step: float
    default_params: Any = None
    output: Optional[Callable[[Any, Tensor, Tensor, Any], Tensor]] = None

    def __call__(self, params, x, u, t=0.0):
        return self.g(params, x, u, t)

    def linearize(self, params, x0, u0, t0=0.0):
        return _linearize(self.g, params, x0, u0, t0)


def discretize(system: ContinuousSystem, time_step: float, method: str = "rk4") -> DiscreteSystem:
    """Wrap a continuous system into a fixed-step discrete one."""
    from drake_tpu_torch.systems import integrators

    step = integrators.get(method)

    def g(params, x, u, t):
        return step(system.f, params, x, u, t, time_step)

    return DiscreteSystem(
        g=g,
        num_states=system.num_states,
        num_inputs=system.num_inputs,
        time_step=time_step,
        default_params=system.default_params,
        output=system.output,
    )
