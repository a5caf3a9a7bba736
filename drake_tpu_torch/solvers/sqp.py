"""Sl1QP NLP solver: elastic SQP with an l1 exact penalty, over lanes.

The PyTorch counterpart of ``drake_tpu/solvers/sqp.py`` (Fletcher's
sequential l1-QP, the family of SNOPT's elastic mode) for a batch of B
problems that share their functions:

    minimize f(z)   s.t.  c(z) = 0,   lb <= z <= ub

Each iteration solves the elastic QP over w = [d, s+, s-] within the static
step bound,

    min  0.5 d'H d + g'd + nu 1'(s+ + s-)
    s.t. C d - s+ + s- = -c,   max(lb - z, -B) <= d <= min(ub - z, B),
         s+, s- >= 0,

by the interior-point QP solver (``solvers.ipm``), with H the exact
Lagrangian Hessian whose eigenvalues are clamped to >= ``hessian_reg``, and
globalizes by a backtracking Armijo search on phi(z) = f(z) + nu |c(z)|_1.

``cost_fn(z, *args)`` and ``constraint_fn(z, *args)`` are written on one
lane (``z`` of shape (n,)); ``z0`` is (B, n).  The derivatives come from
``torch.func`` vmapped over lanes: one ``jacrev`` of [f, c] for grad f and
the constraint Jacobian, and ``jacrev`` of ``jacrev`` for the Hessian of
f + lam . c (the reference: ``grad``, ``jacfwd`` and ``jax.hessian``; the
same derivatives in another summation order, for less host time).  The
reference's three nested ``while_loop``s (the SQP, the line search and the
QP's) are Python loops over all lanes with per-lane masks: a lane that is
done keeps its state bit for bit while the others iterate, as under
``vmap``; the host asks whether any lane is active every ``_CHECK_EVERY``
iterations.  Ranges for the profiler: ``sqp.derivatives``, ``ipm.solve``
and ``sqp.line_search``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.profiler import record_function

from drake_tpu_torch.solvers.ipm import _CHECK_EVERY, IpmOptions, _inf_norm, solve_qp_ipm


@dataclasses.dataclass(frozen=True)
class SqpOptions:
    max_iters: int = 120
    qp: IpmOptions = IpmOptions(max_iters=50, tol=1e-11)
    constraint_tol: float = 1e-6
    opt_tol: float = 1e-4  # accepted-step-size stationarity tolerance
    penalty0: float = 10.0
    penalty_factor: float = 10.0
    penalty_max: float = 1e6
    armijo: float = 1e-4
    line_search_steps: int = 25
    hessian_reg: float = 1e-6
    slack_reg: float = 1e-8
    step_bound: float = 100.0  # static per-iteration bound |d|_inf
    exact_lagrangian_hessian: bool = True


class SqpResult(NamedTuple):
    z: torch.Tensor  # (B, n)
    lam: torch.Tensor  # (B, m)
    cost: torch.Tensor  # (B,)
    constraint_violation: torch.Tensor  # (B,)
    iterations: torch.Tensor  # (B,)
    success: torch.Tensor  # (B,)


def _psd_eig_clamp(H, delta):
    """Clamp the eigenvalues of the symmetric part of H (B, n, n) to >=
    delta; ``jnp.linalg.eigh`` symmetrizes its input, so the port does too."""
    w, V = torch.linalg.eigh(0.5 * (H + H.mT))
    return (V * torch.clamp_min(w, delta)[..., None, :]) @ V.mT


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _derivatives(cost_fn, constraint_fn, args, exact_lagrangian_hessian=True):
    """(f, c, first, hess) over lanes: ``first(z)`` gives (c, grad f, the
    Jacobian of c) from one reverse-mode pass over the 1 + m outputs,
    ``hess(z, lam)`` the Hessian of f + lam . c (of f alone without the
    exact Lagrangian) by reverse over reverse mode.  The reference takes the
    Jacobian forward and the Hessian forward over reverse: the same
    derivatives, summed in another order, for fewer eager launches where
    the outputs are fewer than the inputs (the pendulum's 1 + 44 against
    64)."""

    def f(z):
        return cost_fn(z, *args)

    def c(z):
        return constraint_fn(z, *args)

    def fc(z):
        cz = c(z)
        return torch.cat([f(z)[None], cz]), cz

    jac_fc = torch.func.vmap(torch.func.jacrev(fc, has_aux=True))

    def first(z):
        J, cz = jac_fc(z)
        return cz, J[:, 0], J[:, 1:]

    if exact_lagrangian_hessian:
        hess = torch.func.vmap(torch.func.jacrev(torch.func.jacrev(
            lambda zz, lam: f(zz) + _dot(lam, c(zz)))))
    else:
        hess_f = torch.func.vmap(torch.func.jacrev(torch.func.jacrev(f)))

        def hess(z, lam):
            return hess_f(z)

    return torch.func.vmap(f), torch.func.vmap(c), first, hess


def _bounds(lb, ub, z):
    B, n = z.shape
    if lb is None:
        lb = torch.full((n,), -torch.inf, dtype=z.dtype, device=z.device)
    if ub is None:
        ub = torch.full((n,), torch.inf, dtype=z.dtype, device=z.device)
    return lb.expand(B, n), ub.expand(B, n)


def _elastic_qp(z, nu, cz, C, g, H, lb, ub, opts: SqpOptions):
    """The elastic QP over w = [d, s+, s-] with the static step bound:
    (P, q, G, b, lb_w, ub_w) for ``solve_qp_ipm``."""
    B, n = z.shape
    m = cz.shape[-1]
    nw = n + 2 * m
    slack = torch.arange(n, nw, device=z.device)
    eye_m = torch.eye(m, dtype=z.dtype, device=z.device).expand(B, m, m)
    zero_m = z.new_zeros((B, m))
    P = z.new_zeros((B, nw, nw))
    P[:, :n, :n] = H
    P[:, slack, slack] = opts.slack_reg
    q = torch.cat([g, nu[:, None].expand(B, 2 * m)], dim=-1)
    G = torch.cat([C, -eye_m, eye_m], dim=-1)
    lb_w = torch.cat([torch.clamp_min(lb - z, -opts.step_bound), zero_m, zero_m], dim=-1)
    ub_w = torch.cat([torch.clamp_max(ub - z, opts.step_bound), torch.full_like(zero_m, torch.inf),
                      torch.full_like(zero_m, torch.inf)], dim=-1)
    return P, q, G, -cz, lb_w, ub_w


def qp_at(cost_fn: Callable, constraint_fn: Callable, z, lam, nu, lb=None, ub=None,
          options: SqpOptions = SqpOptions(), args: Any = ()):
    """The elastic QP that an iteration of ``solve`` at (z, lam, nu) hands
    to ``solve_qp_ipm``: (P, q, G, b, lb_w, ub_w), each over the lanes of z."""
    _, _, first, hess = _derivatives(cost_fn, constraint_fn, args,
                                     options.exact_lagrangian_hessian)
    lb, ub = _bounds(lb, ub, z)
    with torch.no_grad():
        cz, g, C = first(z)
        H = _psd_eig_clamp(hess(z, lam), options.hessian_reg)
        return _elastic_qp(z, nu, cz, C, g, H, lb, ub, options)


def solve(
    cost_fn: Callable,
    constraint_fn: Callable,
    z0: torch.Tensor,
    lb: Optional[torch.Tensor] = None,
    ub: Optional[torch.Tensor] = None,
    options: SqpOptions = SqpOptions(),
    args: Any = (),
) -> SqpResult:
    """Solve min f(z, *args) s.t. c(z, *args) = 0, lb <= z <= ub from each
    row of `z0` (B, n); `lb` and `ub` are (n,) or (B, n)."""
    opts = options
    B, n = z0.shape
    dtype, device = z0.dtype, z0.device
    lb, ub = _bounds(lb, ub, z0)
    vf, vc, first, hess = _derivatives(cost_fn, constraint_fn, args,
                                       opts.exact_lagrangian_hessian)

    def phi(z, nu):
        return vf(z) + nu * torch.sum(torch.abs(vc(z)), dim=-1)

    with torch.no_grad():
        z = torch.clamp(z0, lb, ub)
        m = vc(z).shape[-1]
        n_alpha = opts.line_search_steps + 1
        alphas = 0.5 ** torch.arange(n_alpha, dtype=dtype, device=device)
        lam = z.new_zeros((B, m))
        nu = torch.full((B,), opts.penalty0, dtype=dtype, device=device)
        viol = torch.full((B,), torch.inf, dtype=dtype, device=device)
        it = torch.zeros(B, dtype=torch.long, device=device)
        done = torch.zeros(B, dtype=torch.bool, device=device)

        for step in range(opts.max_iters):
            active = ~done
            if step % _CHECK_EVERY == 0 and not bool(active.any()):
                break
            with record_function("sqp.derivatives"):
                cz, g, C = first(z)
                H = _psd_eig_clamp(hess(z, lam), opts.hessian_reg)

            qp = solve_qp_ipm(*_elastic_qp(z, nu, cz, C, g, H, lb, ub, opts), opts.qp)
            d = qp.w[:, :n]
            s_total = torch.sum(torch.abs(qp.w[:, n:]), dim=-1)
            lam_qp = torch.clamp(qp.y, -nu[:, None], nu[:, None])

            # Predicted decrease of the l1 model (>= 0 in exact arithmetic).
            viol1 = torch.sum(torch.abs(cz), dim=-1)
            pred = -(_dot(g, d) + 0.5 * _dot(d, (H @ d.unsqueeze(-1)).squeeze(-1))) + nu * (viol1 - s_total)
            pred = torch.clamp_min(pred, 0.0)

            with record_function("sqp.line_search"):
                # The reference halves alpha from 1 until the Armijo test
                # holds, at most line_search_steps times: every candidate
                # 0.5^k is tried at once, and each lane takes its first.
                phi0 = phi(z, nu)
                zs = z[:, None] + alphas[:, None] * d[:, None]
                phis = phi(zs.flatten(0, 1), nu.repeat_interleave(n_alpha)).view(B, n_alpha)
                ok = phis <= phi0[:, None] - opts.armijo * alphas * pred[:, None]
                ok[:, -1] = True
                k = torch.argmax(ok.to(torch.uint8), dim=1)
                alpha = alphas[k]
                improved = phis.gather(1, k[:, None])[:, 0] <= phi0
                alpha = torch.where(improved, alpha, 0.0)
                z_new = torch.clamp(z + alpha[:, None] * d, lb, ub)
                viol_new = _inf_norm(vc(z_new))

            # Steering rule: raise nu only when the slacks are materially active
            # and feasibility stalled.
            slacks_active = s_total > 1e-6 * torch.clamp_min(viol1, 1.0)
            stalled = viol_new > 0.9 * viol
            nu_new = torch.where(slacks_active & stalled,
                                 torch.clamp_max(nu * opts.penalty_factor, opts.penalty_max), nu)
            step_len = alpha * _inf_norm(d)
            done_new = (viol_new <= opts.constraint_tol) & (alpha >= 1.0) & (step_len <= opts.opt_tol)

            z = torch.where(active[:, None], z_new, z)
            lam = torch.where(active[:, None], lam_qp, lam)
            nu = torch.where(active, nu_new, nu)
            viol = torch.where(active, viol_new, viol)
            done = torch.where(active, done_new, done)
            it = it + active.long()

        return SqpResult(z=z, lam=lam, cost=vf(z), constraint_violation=viol, iterations=it,
                         success=viol <= opts.constraint_tol * 10)
