"""PGS: projected Gauss-Seidel / Jacobi contact solver.

The PyTorch counterpart of ``drake_tpu/contact/pgs.py`` (Drake's
pgs_solver.h baseline): projected sweeps on the contact LCP with the
Delassus operator W = J A^-1 J' (one batched solve):

    gamma_n <- max(0, gamma_n - w (vc_n - vhat_n) / W_nn),
    gamma_t <- gamma_t - w vc_t / W_tt, then clipped to the friction disk
    ||gamma_t|| <= mu gamma_n.

Two sweep orders: "gs" (contact after contact, the reference's) and
"jacobi" (all at once, with relaxation).  PGS solves the unregularized LCP;
SAP its R-regularized convex approximation, so the two agree to O(R).

The lanes ride in the leading dimensions of the ``SapData``.  The sweeps
run through ``utils.scan``: on the card with autograd off, one sweep is a
CUDA graph replayed ``iterations`` times.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from drake_tpu_torch.contact.sap import SapData, SapSolution
from drake_tpu_torch.utils.linalg import solve_matrix
from drake_tpu_torch.utils.scan import scan


def _lin(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _contact_update(gam, vc, vhat, Wd, mu, w):
    """The projected step of contacts (..., 3) = [t1, t2, n]."""
    gn = torch.clamp_min(gam[..., 2] - w * (vc[..., 2] - vhat[..., 2]) / Wd[..., 2], 0.0)
    gt = gam[..., :2] - w * vc[..., :2] / Wd[..., :2]
    gt_norm = torch.linalg.vector_norm(gt, dim=-1)
    scale = torch.clamp_max(mu * gn / torch.clamp_min(gt_norm, 1e-12), 1.0)
    return torch.cat([gt * scale[..., None], gn[..., None]], dim=-1)


def solve_pgs(data: SapData, iterations: int = 100, method: str = "jacobi",
              relaxation: float = 0.5) -> SapSolution:
    """Solve the contact problem by `iterations` projected sweeps.  Only the
    contact cone constraints are handled, as in the reference."""
    batch = data.v_star.shape[:-1]
    nc = data.J.shape[-3]
    dev = data.v_star.device
    if nc == 0:
        return SapSolution(v=data.v_star, gamma=data.v_star.new_zeros(batch + (0, 3)),
                           iterations=torch.zeros(batch, dtype=torch.long, device=dev),
                           momentum_residual=data.v_star.new_zeros(batch))
    J2 = data.J.flatten(-3, -2)  # (..., 3 nc, nv)
    Ainv_Jt = solve_matrix(data.A, J2.mT)  # (..., nv, 3 nc)
    W2 = J2 @ Ainv_Jt
    vc_star = _lin(J2, data.v_star).unflatten(-1, (nc, 3))
    Wdiag = torch.clamp_min(torch.diagonal(W2, dim1=-2, dim2=-1).unflatten(-1, (nc, 3)), 1e-12)
    mu = data.mu

    def jacobi_sweep(gam):
        vc = vc_star + _lin(W2, gam.flatten(-2)).unflatten(-1, (nc, 3))
        return _contact_update(gam, vc, data.vhat, Wdiag, mu, relaxation)

    def gs_sweep(gam):
        for i in range(nc):
            vc_i = vc_star[..., i, :] + _lin(W2[..., 3 * i : 3 * i + 3, :], gam.flatten(-2))
            new = _contact_update(gam[..., i, :], vc_i, data.vhat[..., i, :], Wdiag[..., i, :],
                                  mu[..., i], 1.0)
            gam = torch.cat([gam[..., :i, :], new.unsqueeze(-2), gam[..., i + 1 :, :]], dim=-2)
        return gam

    sweep = jacobi_sweep if method == "jacobi" else gs_sweep
    gam = data.v_star.new_zeros(batch + (nc, 3))
    if iterations > 0:
        with record_function("pgs.sweep"):
            (gam,), _ = scan(lambda carry: ((sweep(carry[0]),), ()), (gam,), iterations)
    v = data.v_star + _lin(Ainv_Jt, gam.flatten(-2))
    # Optimality diagnostic: how far one more sweep would move gamma.
    resid = torch.linalg.vector_norm((sweep(gam) - gam).flatten(-2), dim=-1)
    return SapSolution(v=v, gamma=gam,
                       iterations=torch.full(batch, iterations, dtype=torch.long, device=dev),
                       momentum_residual=resid)
