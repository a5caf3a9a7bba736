"""Dense ADMM QP solver (OSQP-style), over lanes.

The PyTorch counterpart of ``drake_tpu/solvers/qp.py`` (the OSQP role,
reference solvers/osqp_solver.cc) for a batch of B independent problems

    minimize    0.5 x'Px + q'x
    subject to  l <= Ax <= u

with ``P`` (B, n, n), ``q`` (B, n), ``A`` (B, m, n) and ``l``, ``u`` (B, m).
The operator splitting is the reference's: a Cholesky factorization of
(P + sigma I + A' diag(rho) A) per rho update, then chunks of triangular
solves and clips; per-row rho with equality boosting, residual-balancing
rho adaptation with refactorization, over-relaxation, warm starts and
active-set polishing.

The reference's two nested ``while_loop``s (the chunks and the steps of a
chunk) run over all lanes with per-lane masks: a lane that is done keeps
its state, its rho and its iteration count while the others iterate, as
under ``vmap``.  The host asks whether a lane is active at each chunk and
every ``_CHECK_EVERY`` steps.  The reference's upper Cholesky factor is a
lower one here, the same solves within rounding.  Ranges for the profiler:
``qp.chunk`` and ``qp.polish``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.profiler import record_function

from drake_tpu_torch.solvers.ipm import _CHECK_EVERY, _inf_norm, _mv
from drake_tpu_torch.utils.device import tensors_on
from drake_tpu_torch.utils.linalg import cho_solve, cholesky_or_nan, solve


@dataclasses.dataclass(frozen=True)
class QpOptions:
    sigma: float = 1e-6
    rho: float = 0.1
    rho_eq_scale: float = 1e3
    alpha: float = 1.6  # over-relaxation
    max_iters: int = 400
    rho_update_interval: int = 50
    eps_abs: float = 1e-8
    eps_rel: float = 1e-8
    polish: bool = True


class QpSolution(NamedTuple):
    x: torch.Tensor  # (B, n)
    y: torch.Tensor  # (B, m) dual for Ax in [l, u]
    iterations: torch.Tensor  # (B,)
    primal_residual: torch.Tensor  # (B,)
    dual_residual: torch.Tensor  # (B,)
    converged: torch.Tensor  # (B,)


def solve_qp(P, q, A, l, u, options: QpOptions = QpOptions(), x0=None, y0=None,
             device=None) -> QpSolution:
    """Solve the B QPs; warm-startable via x0 (B, n) and y0 (B, m).  Arrays
    from the host go to `device` (the card by default)."""
    opts = options
    P, q, A, l, u, x0, y0 = tensors_on((P, q, A, l, u, x0, y0), device=device)
    B, n = q.shape
    m = l.shape[-1]
    dtype, device = q.dtype, q.device
    At = A.mT
    eye = torch.eye(n, dtype=dtype, device=device)

    is_eq = torch.isclose(l, u)
    eq_scale = torch.where(is_eq, opts.rho_eq_scale, 1.0).to(dtype)
    q_n = _inf_norm(q)

    x = q.new_zeros((B, n)) if x0 is None else x0.expand(B, n).clone()
    y = q.new_zeros((B, m)) if y0 is None else y0.expand(B, m).clone()
    z = torch.clamp(_mv(A, x), l, u)
    rho_base = torch.full((B,), opts.rho, dtype=dtype, device=device)
    it = torch.zeros(B, dtype=torch.long, device=device)
    rp = torch.full((B,), torch.inf, dtype=dtype, device=device)
    rd = rp.clone()
    done = torch.zeros(B, dtype=torch.bool, device=device)

    def step(x, z, y, rho_vec, chol):
        rhs = opts.sigma * x - q + _mv(At, rho_vec * z - y)
        x_t = cho_solve(chol, rhs)
        z_t = _mv(A, x_t)
        x_new = opts.alpha * x_t + (1 - opts.alpha) * x
        z_relax = opts.alpha * z_t + (1 - opts.alpha) * z
        z_new = torch.clamp(z_relax + y / rho_vec, l, u)
        y_new = y + rho_vec * (z_relax - z_new)

        Ax = _mv(A, x_new)
        Px = _mv(P, x_new)
        Aty = _mv(At, y_new)
        rp_new = _inf_norm(Ax - z_new)
        rd_new = _inf_norm(Px + q + Aty)
        eps_p = opts.eps_abs + opts.eps_rel * torch.maximum(_inf_norm(Ax), _inf_norm(z_new))
        eps_d = opts.eps_abs + opts.eps_rel * torch.maximum(
            _inf_norm(Px), torch.maximum(_inf_norm(Aty), q_n))
        return x_new, z_new, y_new, rp_new, rd_new, (rp_new <= eps_p) & (rd_new <= eps_d)

    with torch.no_grad():
        # A lane that is not done runs whole chunks, so it leaves after at
        # most ceil(max_iters / rho_update_interval) of them.
        for _ in range(-(-opts.max_iters // opts.rho_update_interval)):
            chunk_active = ~done & (it < opts.max_iters)
            if not bool(chunk_active.any()):
                break
            with record_function("qp.chunk"):
                rho_vec = rho_base[:, None] * eq_scale
                K = P + opts.sigma * eye + (At * rho_vec[:, None, :]) @ A
                chol = cholesky_or_nan(K)
                done_in = done.clone()
                it_in = torch.zeros_like(it)
                for k in range(opts.rho_update_interval):
                    active = chunk_active & ~done_in
                    if k % _CHECK_EVERY == 0 and not bool(active.any()):
                        break
                    out = step(x, z, y, rho_vec, chol)
                    x, z, y = (torch.where(active[:, None], new, old)
                               for new, old in zip(out[:3], (x, z, y)))
                    rp, rd, done_in = (torch.where(active, new, old)
                                       for new, old in zip(out[3:], (rp, rd, done_in)))
                    it_in = it_in + active.long()

                # Residual-balancing rho adaptation (OSQP sec. 5.2).
                Ax_n = _inf_norm(_mv(A, x))
                z_n = _inf_norm(z)
                Px_n = _inf_norm(_mv(P, x))
                Aty_n = _inf_norm(_mv(At, y))
                rp_rel = rp / torch.clamp_min(torch.maximum(Ax_n, z_n), 1e-12)
                rd_rel = rd / torch.clamp_min(torch.maximum(Px_n, torch.maximum(Aty_n, q_n)), 1e-12)
                scale = torch.clamp(torch.sqrt(rp_rel / torch.clamp_min(rd_rel, 1e-18)), 0.1, 10.0)
                rho_new = torch.where(done_in, rho_base, torch.clamp(rho_base * scale, 1e-6, 1e6))
                rho_base = torch.where(chunk_active, rho_new, rho_base)
                it = it + it_in
                done = done_in

        if opts.polish:
            with record_function("qp.polish"):
                x, y = _polish(P, q, A, l, u, x, y, is_eq)
                Ax = _mv(A, x)
                rp = _inf_norm(torch.clamp(Ax, l, u) - Ax)
                rd = _inf_norm(_mv(P, x) + q + _mv(At, y))
                done = done | ((rp <= 10 * opts.eps_abs) & (rd <= 10 * opts.eps_abs))

    return QpSolution(x=x, y=y, iterations=it, primal_residual=rp, dual_residual=rd,
                      converged=done)


def _polish(P, q, A, l, u, x, y, is_eq):
    """Active-set polish: solve the equality-constrained QP on the active
    set (OSQP's ``polish: 1``), the active rows read off the dual and the
    inactive ones kept as unit rows so that shapes stay static; the polish
    is kept in each lane where it reduces the KKT residual.  The KKT matrix
    is indefinite: LU, NaN where it is singular."""
    B, n = q.shape
    m = l.shape[-1]
    dtype, device = q.dtype, q.device
    tol = 1e-7
    reg = 1e-10
    lower_active = y < -tol
    upper_active = y > tol
    active = lower_active | upper_active | is_eq
    b = torch.where(upper_active, u, l)
    b = torch.where(is_eq, l, b)

    act = active.to(dtype)
    A_act = A * act[:, :, None]
    K = torch.cat([
        torch.cat([P + reg * torch.eye(n, dtype=dtype, device=device), A_act.mT], dim=-1),
        torch.cat([A_act, -reg * torch.eye(m, dtype=dtype, device=device)
                   - torch.diag_embed(1.0 - act)], dim=-1),
    ], dim=-2)
    rhs = torch.cat([-q, torch.where(active, b, 0.0)], dim=-1)
    sol = solve(K, rhs)
    x_p, y_p = sol[:, :n], sol[:, n:] * act

    def kkt_res(x, y):
        r1 = _inf_norm(_mv(P, x) + q + _mv(A.mT, y))
        Ax = _mv(A, x)
        return torch.maximum(r1, _inf_norm(Ax - torch.clamp(Ax, l, u)))

    better = (kkt_res(x_p, y_p) < kkt_res(x, y))[:, None]
    return torch.where(better, x_p, x), torch.where(better, y_p, y)
