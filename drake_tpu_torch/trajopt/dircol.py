"""Direct collocation (Hermite-Simpson) as a pure residual + batched solve.

The PyTorch counterpart of ``drake_tpu/trajopt/dircol.py`` (Drake's
DirectCollocation): the transcription is a pair of functions (cost,
constraints) over a flat decision vector

    z = [h, x_0..x_{N-1}, u_0..u_{N-1}]      (one shared step h)

written on one problem, differentiated by ``torch.func`` and solved by the
Sl1QP solver (``solvers.sqp``) for a batch of initial guesses at once:
``solve`` takes ``z0`` of shape (B, n).  The collocation defect of interval
k (cubic Hermite state, first-order-hold input):

    x_c    = (x_k + x_{k+1})/2 + h (f_k - f_{k+1})/8
    xdot_c = -3 (x_k - x_{k+1}) / (2h) - (f_k + f_{k+1})/4
    defect = f(x_c, (u_k + u_{k+1})/2) - xdot_c

with a trapezoidal running cost.  ``running_cost(x, u)`` and
``final_cost(x)`` are written on one knot, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from drake_tpu_torch.solvers import sqp
from drake_tpu_torch.systems.base import ContinuousSystem
from drake_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DircolProblem:
    """Static description of a direct-collocation NLP."""

    system: ContinuousSystem
    num_time_samples: int
    minimum_time_step: float
    maximum_time_step: float
    running_cost: Optional[Callable] = None  # (x, u) -> scalar
    final_cost: Optional[Callable] = None  # (x,) -> scalar
    x0: Optional[torch.Tensor] = None  # initial-state equality constraint
    xf: Optional[torch.Tensor] = None  # final-state equality constraint
    u_lower: Optional[torch.Tensor] = None
    u_upper: Optional[torch.Tensor] = None
    x_lower: Optional[torch.Tensor] = None
    x_upper: Optional[torch.Tensor] = None

    @property
    def nx(self):
        return self.system.num_states

    @property
    def nu(self):
        return self.system.num_inputs

    @property
    def num_vars(self):
        return 1 + self.num_time_samples * (self.nx + self.nu)

    # ---- packing ---------------------------------------------------------
    def pack(self, h, xs, us):
        """z (..., n) from h (...), xs (..., N, nx) and us (..., N, nu)."""
        lead = xs.shape[:-2]
        h = torch.as_tensor(h, dtype=xs.dtype, device=xs.device).expand(lead)
        return torch.cat([h[..., None], xs.reshape(lead + (-1,)), us.reshape(lead + (-1,))],
                         dim=-1)

    def unpack(self, z):
        """(h (...), xs (..., N, nx), us (..., N, nu)) from z (..., n)."""
        N, nx, nu = self.num_time_samples, self.nx, self.nu
        lead = z.shape[:-1]
        return (z[..., 0], z[..., 1 : 1 + N * nx].reshape(lead + (N, nx)),
                z[..., 1 + N * nx :].reshape(lead + (N, nu)))

    # ---- NLP pieces (on one problem) ---------------------------------------
    def collocation_defects(self, params, z):
        h, xs, us = self.unpack(z)
        f = self.system.f
        fs = f(params, xs, us, 0.0)
        x_k, x_k1 = xs[:-1], xs[1:]
        f_k, f_k1 = fs[:-1], fs[1:]
        u_c = 0.5 * (us[:-1] + us[1:])
        x_c = 0.5 * (x_k + x_k1) + h * (f_k - f_k1) / 8.0
        xdot_c = -1.5 * (x_k - x_k1) / h - 0.25 * (f_k + f_k1)
        return (f(params, x_c, u_c, 0.0) - xdot_c).reshape(-1)

    def constraints(self, z, params):
        parts = [self.collocation_defects(params, z)]
        _, xs, _ = self.unpack(z)
        if self.x0 is not None:
            parts.append(xs[0] - self.x0)
        if self.xf is not None:
            parts.append(xs[-1] - self.xf)
        return torch.cat(parts)

    def cost(self, z, params):
        h, xs, us = self.unpack(z)
        total = torch.zeros((), dtype=z.dtype, device=z.device)
        if self.running_cost is not None:
            g = torch.func.vmap(self.running_cost)(xs, us)
            # Trapezoidal integration over equal steps h.
            total = total + h * (0.5 * g[0] + torch.sum(g[1:-1]) + 0.5 * g[-1])
        if self.final_cost is not None:
            total = total + self.final_cost(xs[-1])
        return total

    def bounds(self, dtype=torch.float32, device=None):
        """(lb, ub) of z, each (n,)."""
        device = resolve_device(device)
        N, nx = self.num_time_samples, self.nx
        lb = torch.full((self.num_vars,), -torch.inf, dtype=dtype, device=device)
        ub = torch.full((self.num_vars,), torch.inf, dtype=dtype, device=device)
        lb[0], ub[0] = self.minimum_time_step, self.maximum_time_step
        for bound, value, sl in ((lb, self.x_lower, slice(1, 1 + N * nx)),
                                 (ub, self.x_upper, slice(1, 1 + N * nx)),
                                 (lb, self.u_lower, slice(1 + N * nx, None)),
                                 (ub, self.u_upper, slice(1 + N * nx, None))):
            if value is not None:
                bound[sl] = torch.as_tensor(value, dtype=dtype, device=device).repeat(N)
        return lb, ub

    def initial_guess(self, x_init, x_final, timespan, dtype=torch.float32, device=None):
        """Straight-line state interpolation, zero input (the reference
        example's FirstOrderHold warm start); z (n,)."""
        device = resolve_device(device)
        N = self.num_time_samples
        alpha = torch.linspace(0.0, 1.0, N, dtype=dtype, device=device)[:, None]
        xs = ((1 - alpha) * torch.as_tensor(x_init, dtype=dtype, device=device)
              + alpha * torch.as_tensor(x_final, dtype=dtype, device=device))
        us = torch.zeros((N, self.nu), dtype=dtype, device=device)
        h = torch.clamp(torch.tensor(timespan / (N - 1), dtype=dtype, device=device),
                        self.minimum_time_step, self.maximum_time_step)
        return self.pack(h, xs, us)


class DircolSolution(NamedTuple):
    h: torch.Tensor  # (B,)
    xs: torch.Tensor  # (B, N, nx)
    us: torch.Tensor  # (B, N, nu)
    cost: torch.Tensor
    constraint_violation: torch.Tensor
    success: torch.Tensor
    iterations: torch.Tensor  # (B,) SQP iterations (the reference keeps them inside)

    @property
    def times(self):
        N = self.xs.shape[-2]
        return self.h[..., None] * torch.arange(N, dtype=self.xs.dtype, device=self.xs.device)


def solve(problem: DircolProblem, params, z0, options: sqp.SqpOptions = sqp.SqpOptions()
          ) -> DircolSolution:
    """Solve the dircol NLP from each row of z0 (B, n)."""
    lb, ub = problem.bounds(z0.dtype, z0.device)
    res = sqp.solve(problem.cost, problem.constraints, z0, lb, ub, options, args=(params,))
    h, xs, us = problem.unpack(res.z)
    return DircolSolution(h=h, xs=xs, us=us, cost=res.cost,
                          constraint_violation=res.constraint_violation, success=res.success,
                          iterations=res.iterations)


def _knot(sol: DircolSolution, t):
    """(k, s): the interval k (...) of time t and t / h clipped to [0, N-1]."""
    N = sol.us.shape[-2]
    s = torch.clamp(t / sol.h, 0.0, N - 1.0)
    k = torch.clamp(torch.floor(s).long(), 0, N - 2)
    return k, s


def _at(values, k):
    """values (..., N, d) at knots k (...)."""
    idx = k[..., None, None].expand(k.shape + (1, values.shape[-1]))
    return torch.take_along_dim(values, idx, dim=-2).squeeze(-2)


def reconstruct_input(sol: DircolSolution, t):
    """First-order-hold input interpolation (ReconstructInputTrajectory) at
    times t, which broadcast against the solution's lanes."""
    k, s = _knot(sol, t)
    frac = (s - k)[..., None]
    return (1 - frac) * _at(sol.us, k) + frac * _at(sol.us, k + 1)


def reconstruct_state(sol: DircolSolution, params, system: ContinuousSystem, t):
    """Cubic Hermite state interpolation (ReconstructStateTrajectory)."""
    k, s = _knot(sol, t)
    h = sol.h[..., None]
    tt = ((s - k)[..., None] * h) / h
    x_k, x_k1 = _at(sol.xs, k), _at(sol.xs, k + 1)
    f_k = system.f(params, x_k, _at(sol.us, k), 0.0)
    f_k1 = system.f(params, x_k1, _at(sol.us, k + 1), 0.0)
    h00 = 2 * tt**3 - 3 * tt**2 + 1
    h10 = tt**3 - 2 * tt**2 + tt
    h01 = -2 * tt**3 + 3 * tt**2
    h11 = tt**3 - tt**2
    return h00 * x_k + h10 * h * f_k + h01 * x_k1 + h11 * h * f_k1
