"""Augmented-Lagrangian Newton NLP solver, over lanes.

The PyTorch counterpart of ``drake_tpu/solvers/al_newton.py`` (the role of
the reference's IPOPT/SNOPT funnel and its in-house AugmentedLagrangian,
solvers/augmented_lagrangian.h) for a batch of B problems that share their
functions:

    minimize f(z)  s.t.  c(z) = 0,  lb <= z <= ub

    L_mu(z; lam) = f(z) + lam'c(z) + mu/2 ||c(z)||^2

Inner: projected damped-Newton steps on L_mu with a backtracking line
search (Hessian = the exact cost Hessian + the Gauss-Newton term mu C'C,
plus adaptive Levenberg-Marquardt damping).  Outer: first-order multiplier
updates with mu escalation.

``cost_fn(z, *args)`` and ``constraint_fn(z, *args)`` are written on one
lane (``z`` of shape (n,)); ``z0`` is (B, n).  The derivatives are those of
``solvers.sqp``: one vmapped ``jacrev`` of [f, c] for grad f and the
Jacobian of c, ``jacrev`` of ``jacrev`` for the Hessian of f.  The
reference's three nested ``while_loop``s (outer, inner, line search) run
over all lanes with per-lane masks: a lane that is done keeps its state bit
for bit while the others iterate, as under ``vmap``.  The host asks whether
a lane is active at each outer iteration and every ``_CHECK_EVERY`` inner
ones; the line search tries every step 0.5^k at once and each lane takes
its first.  Ranges for the profiler: ``al.inner`` and ``al.line_search``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch
from torch.profiler import record_function

from drake_tpu_torch.solvers.ipm import _CHECK_EVERY, _inf_norm
from drake_tpu_torch.solvers.sqp import _bounds, _derivatives, _dot
from drake_tpu_torch.utils.device import tensors_on
from drake_tpu_torch.utils.linalg import solve as lu_solve


@dataclasses.dataclass(frozen=True)
class AlNewtonOptions:
    outer_iters: int = 12
    inner_iters: int = 25
    mu0: float = 10.0
    mu_factor: float = 10.0
    mu_max: float = 1e8
    constraint_tol: float = 1e-6
    grad_tol: float = 1e-6
    lm_damping0: float = 1e-6
    line_search_steps: int = 20
    armijo: float = 1e-4


class AlNewtonResult(NamedTuple):
    z: torch.Tensor  # (B, n)
    lam: torch.Tensor  # (B, m)
    constraint_violation: torch.Tensor  # (B,)
    cost: torch.Tensor  # (B,)
    success: torch.Tensor  # (B,)
    iterations: torch.Tensor  # (B,) outer iterations


def solve(
    cost_fn: Callable,
    constraint_fn: Callable,
    z0,
    lb=None,
    ub=None,
    options: AlNewtonOptions = AlNewtonOptions(),
    args: Any = (),
    device=None,
) -> AlNewtonResult:
    """Solve min f(z, *args) s.t. c(z, *args) = 0, lb <= z <= ub from each
    row of `z0` (B, n); `lb` and `ub` are (n,) or (B, n).  Arrays from the
    host go to `device` (the card by default)."""
    opts = options
    z0, lb, ub = tensors_on((z0, lb, ub), device=device)
    B, n = z0.shape
    dtype, device = z0.dtype, z0.device
    lb, ub = _bounds(lb, ub, z0)
    vf, vc, first, hess = _derivatives(cost_fn, constraint_fn, args,
                                       exact_lagrangian_hessian=False)

    def al_value(z, lam, mu):
        cz = vc(z)
        return vf(z) + _dot(lam, cz) + 0.5 * mu * _dot(cz, cz)

    with torch.no_grad():
        eye = torch.eye(n, dtype=dtype, device=device)
        n_alpha = opts.line_search_steps + 1
        alphas = 0.5 ** torch.arange(n_alpha, dtype=dtype, device=device)

        def inner_step(z, lam, mu, damping):
            cz, grad_f, C = first(z)
            g = grad_f + (C.mT @ (lam + mu[:, None] * cz).unsqueeze(-1)).squeeze(-1)
            H = hess(z, lam) + mu[:, None, None] * (C.mT @ C)
            # Both of the reference's solves in one batched LU: the damped
            # step, and the steeper one taken where it is no descent direction.
            nus = torch.stack([damping, damping * 1e4 + 1e-2])[..., None, None]
            dzs = -lu_solve(H + nus * eye, g.expand(2, B, n))
            dz = torch.where((_dot(dzs[0], g) < 0)[:, None], dzs[0], dzs[1])

            with record_function("al.line_search"):
                # Backtracking projected search on the AL merit: alpha halves
                # from 1 while the Armijo test fails, at most
                # line_search_steps times.
                L0 = al_value(z, lam, mu)
                g_dz = _dot(g, dz)
                zs = torch.clamp(z[:, None] + alphas[:, None] * dz[:, None], lb[:, None], ub[:, None])
                Ls = al_value(zs.flatten(0, 1), lam.repeat_interleave(n_alpha, 0),
                              mu.repeat_interleave(n_alpha)).view(B, n_alpha)
                ok = Ls <= L0[:, None] + opts.armijo * alphas * g_dz[:, None]
                ok[:, -1] = True
                k = torch.argmax(ok.to(torch.uint8), dim=1)
                z_new = torch.clamp(z + alphas[k][:, None] * dz, lb, ub)
                improved = Ls.gather(1, k[:, None])[:, 0] < L0
            z_new = torch.where(improved[:, None], z_new, z)
            damping_new = torch.where(improved, torch.clamp_min(damping * 0.5, opts.lm_damping0),
                                      damping * 10.0)
            # Projected-gradient stationarity measure.
            pg = _inf_norm(z - torch.clamp(z - g, lb, ub))
            return z_new, damping_new, pg

        def inner_solve(z, lam, mu, outer_active):
            damping = torch.full((B,), opts.lm_damping0, dtype=dtype, device=device)
            pg = torch.full((B,), torch.inf, dtype=dtype, device=device)
            for step in range(opts.inner_iters):
                active = outer_active & (pg > opts.grad_tol)
                if step % _CHECK_EVERY == 0 and not bool(active.any()):
                    break
                with record_function("al.inner"):
                    z_new, damping_new, pg_new = inner_step(z, lam, mu, damping)
                    z = torch.where(active[:, None], z_new, z)
                    damping = torch.where(active, damping_new, damping)
                    pg = torch.where(active, pg_new, pg)
            return z

        z = torch.clamp(z0, lb, ub)
        m = vc(z).shape[-1]
        lam = z.new_zeros((B, m))
        mu = torch.full((B,), opts.mu0, dtype=dtype, device=device)
        viol = torch.full((B,), torch.inf, dtype=dtype, device=device)
        it = torch.zeros(B, dtype=torch.long, device=device)
        for _ in range(opts.outer_iters):
            active = viol > opts.constraint_tol
            if not bool(active.any()):
                break
            z_in = inner_solve(z, lam, mu, active)
            cz = vc(z_in)
            viol_new = _inf_norm(cz)
            lam_new = lam + mu[:, None] * cz
            # Escalate mu unless the violation shrank enough.
            mu_new = torch.where(viol_new > 0.25 * viol,
                                 torch.clamp_max(mu * opts.mu_factor, opts.mu_max), mu)
            z = torch.where(active[:, None], z_in, z)
            lam = torch.where(active[:, None], lam_new, lam)
            mu = torch.where(active, mu_new, mu)
            viol = torch.where(active, viol_new, viol)
            it = it + active.long()
        return AlNewtonResult(z=z, lam=lam, constraint_violation=viol, cost=vf(z),
                              success=viol <= opts.constraint_tol * 10, iterations=it)
