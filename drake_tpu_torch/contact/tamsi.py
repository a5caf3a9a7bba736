"""TAMSI: the transition-aware modified semi-implicit contact solver.

The PyTorch counterpart of ``drake_tpu/contact/tamsi.py`` (Drake's
tamsi_solver.h, Castro et al. 2019): Newton on the two-way coupled velocity
residual

    R(v) = A (v - v*) - h [Jn' fn(v) + Jt' ft(v)] = 0,
    fn = k (1 - d vn)+ (x0 - h vn)+,   ft = -mu_reg(|vt| / vs) fn t_hat,

with the quadratic friction regularizer mu_reg(s) = mu s (2 - s) below 1,
the residual's Jacobian in forward mode (``lane_jacobian``, the reference's
``jacfwd``), a step capped so that no contact's slip crosses the stiction
circle in one jump, and the best of five backtracked steps.  The
reference's ``while_loop`` runs over all lanes (the leading dimensions of
the ``SapData``) with a per-lane mask, the host asking every few
iterations whether a lane still runs; a lane that has converged keeps its
values and its count, as under ``vmap``.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from drake_tpu_torch.contact.sap import SapData, SapSolution
from drake_tpu_torch.systems.base import lane_jacobian
from drake_tpu_torch.utils.device import constant
from drake_tpu_torch.utils.linalg import solve

_CHECK_EVERY = 4
_ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.03)


def _lin(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def solve_tamsi(data: SapData, contact, h: float, v_guess=None, v_stiction: float = 1e-4,
                max_iterations: int = 40, rel_tolerance: float = 1e-8) -> SapSolution:
    """The TAMSI velocity update of the assembled problem: SapData's A,
    v_star and J with the raw contact (phi, stiffness, dissipation,
    friction).  Returns a SapSolution (gamma = h times the contact forces in
    the contact frames)."""
    batch = data.v_star.shape[:-1]
    nc = data.J.shape[-3]
    v0 = data.v_star if v_guess is None else v_guess
    if nc == 0:
        return SapSolution(v=data.v_star, gamma=data.v_star.new_zeros(batch + (0, 3)),
                           iterations=torch.zeros(batch, dtype=torch.long,
                                                  device=data.v_star.device),
                           momentum_residual=data.v_star.new_zeros(batch))
    k, d, mu = contact.stiffness, contact.dissipation, contact.friction
    vs = v_stiction

    def forces(v, Jn, Jt, x0):
        vn = _lin(Jn, v)  # (..., nc) separation velocities
        vt = _lin(Jt, v.unsqueeze(-2))  # (..., nc, 2)
        x = x0 - h * vn  # first-order penetration update
        zero = torch.zeros_like(vn)
        fn = k * torch.maximum(1.0 - d * vn, zero) * torch.maximum(x, zero)
        speed = torch.sqrt(torch.sum(vt * vt, dim=-1) + 1e-28)
        s = speed / vs
        mu_reg = mu * torch.where(s < 1.0, s * (2.0 - s), 1.0)
        ft = -mu_reg[..., None] * fn[..., None] * (vt / speed[..., None])
        return fn, ft

    def residual_with(A, v_star, Jn, Jt, x0):
        def residual(v):
            fn, ft = forces(v, Jn, Jt, x0)
            return (_lin(A, v - v_star) - h * _lin(Jn.mT, fn)
                    - h * _lin(Jt.flatten(-3, -2).mT, ft.flatten(-2)))
        return residual

    Jn = data.J[..., 2, :]  # (..., nc, nv)
    Jt = data.J[..., :2, :]  # (..., nc, 2, nv)
    x0 = -contact.phi  # penetration, positive when overlapping
    residual = residual_with(data.A, data.v_star, Jn, Jt, x0)
    # The same residual over a candidate axis before the lanes' last.
    residual_c = residual_with(data.A.unsqueeze(-3), data.v_star.unsqueeze(-2),
                               Jn.unsqueeze(-3), Jt.unsqueeze(-4), x0.unsqueeze(-2))
    scale = torch.linalg.vector_norm(_lin(data.A, data.v_star), dim=-1) + 1e-12
    alphas0 = constant(_ALPHAS, data.v_star)

    v = v0
    res = torch.linalg.vector_norm(residual(v0), dim=-1) / scale
    it = torch.zeros(batch, dtype=torch.long, device=v.device)
    for step in range(max_iterations):
        active = (res > rel_tolerance) & (it < max_iterations)
        if step % _CHECK_EVERY == 0 and not bool(active.any()):
            break
        with record_function("tamsi.newton"):
            dv = -solve(lane_jacobian(residual, v), residual(v))
            # Transition-aware step limiting (the TalsLimiter role): no
            # contact's tangential velocity crosses the stiction circle in
            # one jump.
            vt = _lin(Jt, v.unsqueeze(-2))
            dvt = _lin(Jt, dv.unsqueeze(-2))
            speed = torch.sqrt(torch.sum(vt * vt, dim=-1) + 1e-28)
            dspeed = torch.sqrt(torch.sum(dvt * dvt, dim=-1) + 1e-28)
            cap = torch.clamp_min(0.5 * speed, vs)
            a_lim = torch.amin(torch.clamp_max(cap / dspeed, 1.0), dim=-1)
            alphas = a_lim[..., None] * alphas0
            cands = v.unsqueeze(-2) + alphas[..., None] * dv.unsqueeze(-2)
            norms = torch.linalg.vector_norm(residual_c(cands), dim=-1)
            norms = torch.where(torch.isfinite(norms), norms, torch.inf)
            best = torch.argmin(norms, dim=-1, keepdim=True)
            v_new = torch.take_along_dim(cands, best[..., None], dim=-2).squeeze(-2)
            ok = torch.isfinite(v_new).all(dim=-1, keepdim=True)
            v_new = torch.where(ok, v_new, v)
            res_new = torch.take_along_dim(norms, best, dim=-1).squeeze(-1) / scale
            v = torch.where(active[..., None], v_new, v)
            res = torch.where(active, res_new, res)
            it = it + active.long()
    fn, ft = forces(v, Jn, Jt, x0)
    gamma = h * torch.cat([ft, fn[..., None]], dim=-1)
    return SapSolution(v=v, gamma=gamma, iterations=it, momentum_residual=res)
