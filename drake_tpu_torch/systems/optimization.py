"""systems/optimization: expose system structure to MathematicalProgram.

The PyTorch counterpart of ``drake_tpu/systems/optimization.py`` (reference
systems/optimization/system_constraint_adapter.h,
system_constraint_wrapper.h): a "system constraint" is any torch function
of the system's (x, u), and the adapter produces the generic-constraint
record the port's MathematicalProgram consumes; ``torch.func`` supplies the
derivatives the reference gets from AutoDiffXd.  Also the fixed-point
helpers (find an equilibrium / trim point), the reference's most frequent
use of the adapter.

A port system maps lanes in leading dimensions; inside a program it is
called on one lane, x of shape (nx,) and u of shape (nu,), which the port's
models take as they are.  Its parameters must sit on the device and in the
dtype of the solve.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from drake_tpu_torch.solvers.program import MathematicalProgram, Variables


def add_system_constraint(
    prog: MathematicalProgram,
    system,
    constraint: Callable,  # (params, x, u, t) -> residual vector
    x_var: Variables,
    u_var: Variables,
    lb,
    ub,
    params=None,
    t: float = 0.0,
) -> None:
    """Bind lb <= constraint(params, x, u, t) <= ub over (x_var, u_var).

    The two blocks must be contiguous in the program (allocate them
    back-to-back), matching the flat-z design of the program container;
    raises otherwise.
    """
    if x_var.start + x_var.size != u_var.start:
        raise ValueError(
            "x_var and u_var must be contiguous blocks (allocate u right "
            "after x)")
    joint = Variables(x_var.start, x_var.size + u_var.size, f"{x_var.name}+{u_var.name}")
    nx = x_var.size
    p = system.default_params if params is None else params

    def fn(z):
        return torch.atleast_1d(constraint(p, z[:nx], z[nx:], t))

    prog.AddConstraint(fn, lb, ub, joint)


def add_equilibrium_constraint(
    prog: MathematicalProgram,
    system,
    x_var: Variables,
    u_var: Variables,
    params=None,
    t: float = 0.0,
) -> None:
    """Constrain (x, u) to be a fixed point: f(x, u) = 0 for continuous
    systems, g(x, u) = x for discrete ones."""
    if hasattr(system, "f"):
        def resid(p, x, u, tt):
            return system.f(p, x, u, tt)
    else:
        def resid(p, x, u, tt):
            return system.g(p, x, u, tt) - x
    n = system.num_states
    add_system_constraint(prog, system, resid, x_var, u_var, lb=np.zeros(n), ub=np.zeros(n),
                          params=params, t=t)


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, float)


def find_fixed_point(
    system,
    x_guess,
    u_guess,
    params=None,
    x_cost_weight: float = 0.0,
    u_cost_weight: float = 1e-3,
    dtype=torch.float64,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Solve for an equilibrium near the guess (the FixedPoint/trim role), on
    `device` (the card by default).

    Returns (x*, u*, success) as NumPy.  Small regularizing costs keep the
    NLP well-posed when the equilibrium manifold is not a point.
    """
    x_guess = _host(x_guess)
    u_guess = _host(u_guess)
    prog = MathematicalProgram()
    x = prog.NewContinuousVariables(x_guess.size, "x")
    u = prog.NewContinuousVariables(u_guess.size, "u")
    add_equilibrium_constraint(prog, system, x, u, params=params)
    if x_cost_weight > 0:
        prog.AddQuadraticErrorCost(x_cost_weight * np.eye(x_guess.size), x_guess, x)
    if u_cost_weight > 0:
        prog.AddQuadraticErrorCost(u_cost_weight * np.eye(u_guess.size), u_guess, u)
    prog.SetInitialGuess(x, x_guess)
    prog.SetInitialGuess(u, u_guess)
    res = prog.Solve(dtype=dtype, device=device)
    return res.GetSolution(x), res.GetSolution(u), res.is_success()
