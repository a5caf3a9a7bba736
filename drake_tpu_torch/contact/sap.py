"""SAP: Semi-Analytic Primal solver for discrete frictional contact.

The PyTorch counterpart of ``drake_tpu/contact/sap.py`` (Castro, Permenter,
Han 2021, arXiv:2110.10107):

    v_next = argmin_v  1/2 (v - v*)' A (v - v*) + sum_i l_i(J_i v)

with per-contact regularized friction-cone costs, dense Newton steps on
H = A + J' G J, the reference's two-level vectorized line search, and
gradients by the implicit-function theorem at the optimum.  Every tensor
carries the lanes of a batch in its leading dimensions.

What differs from the reference, by design:

- ``_solve_sap_core``'s converged loop is a Python loop over all lanes with
  a per-lane ``active`` mask (a lane that has converged keeps its values and
  its iteration count, as under ``vmap`` of ``lax.while_loop``); the host
  asks whether any lane is still active every ``_CHECK_EVERY`` iterations.
- G = -dgamma/dvc is the closed-form derivative of the cone projection, not
  ``jacfwd`` of it (the same matrix).
- ``make_contact_jacobian`` builds J by the analytic form (from the tree's
  world spatial Jacobians); the reference's default ``"jacfwd"`` form is a
  forward-mode Jacobian of the same linear map, so its ``contact_jacobian``
  switch has no counterpart here.  Nor has its ``stiction_tolerance``,
  which only the Hunt-Crossley models read.
- ``solve_sap`` is a ``torch.autograd.Function`` whose backward solves
  H' w = dL/dv and pulls -w back through the residual with
  ``torch.func.vjp``; it carries ``generate_vmap_rule`` so that
  ``torch.func.vmap`` of a pullback batches the cotangents.
- Only the ``"cone"`` contact model and contact constraints are carried:
  joint limits, couplers, ball/distance/weld constraints, implicit PD and
  the Hunt-Crossley models raise ``NotImplementedError`` (ROADMAP.md).
- Solves use the ``_ex`` forms of PyTorch's factorizations
  (``utils/linalg.py``): a matrix that is not positive definite gives NaN,
  as JAX's, and the guards below catch it as the reference's do.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch.profiler import record_function

from drake_tpu_torch.geometry.scene import CollisionScene, contact_frame
from drake_tpu_torch.math.rotations import hat
from drake_tpu_torch.multibody import dynamics as dyn
from drake_tpu_torch.multibody import kinematics as kin
from drake_tpu_torch.multibody.model import _NV, FLOATING, MultibodyModel, MultibodyParams
from drake_tpu_torch.utils.linalg import cho_solve, cholesky_or_nan, solve, solve_matrix

# The converged loop asks the host whether any lane is still active once
# every this many iterations (each question waits for the device).
_CHECK_EVERY = 4


@dataclasses.dataclass(frozen=True)
class SapParameters:
    beta: float = 1.0  # near-rigid parameter
    sigma: float = 1e-3  # friction regularization
    rel_tolerance: float = 1e-6  # momentum residual tolerance
    max_iterations: int = 30
    line_search_points: int = 16  # points per level of the line search
    alpha_max: float = 1.5
    # > 0: run exactly this many Newton iterations with a single-level line
    # search (the planning fast path); 0: the converged loop.
    unroll_iterations: int = 0
    contact_model: str = "cone"


class SapData(NamedTuple):
    """Assembled convex problem (contact constraints only in this slice)."""

    A: torch.Tensor  # (..., nv, nv) dynamics matrix
    v_star: torch.Tensor  # (..., nv) free-motion velocity
    J: torch.Tensor  # (..., nc, 3, nv) contact Jacobians (rows t1, t2, n)
    R: torch.Tensor  # (..., nc, 3) regularization diag (Rt, Rt, Rn)
    vhat: torch.Tensor  # (..., nc, 3) bias velocity (0, 0, vhat_n)
    mu: torch.Tensor  # (nc,) friction


class SapSolution(NamedTuple):
    v: torch.Tensor  # (..., nv) next-step generalized velocity
    gamma: torch.Tensor  # (..., nc, 3) contact impulses in contact frames
    iterations: torch.Tensor  # (...,) Newton iterations taken
    momentum_residual: torch.Tensor  # (...,)


# ---------------------------------------------------------------------------
# Per-contact projection gamma = P_R(y) and its derivative.
# ---------------------------------------------------------------------------


def _project_gamma(y, R, mu):
    """Projection of y (..., 3) = [yt1, yt2, yn] onto the friction cone in the
    R-metric (closed form): stiction keeps y, separation gives 0, sliding
    projects onto the boundary."""
    Rt, Rn = R[..., 0], R[..., 2]
    yt, yn = y[..., :2], y[..., 2]
    yr = torch.sqrt(torch.sum(yt * yt, dim=-1) + 1e-30)
    mu_hat = mu * Rt / Rn
    gn_slide = (Rt * mu * yr + Rn * yn) / (Rt * mu**2 + Rn)
    t_hat = yt / yr[..., None]
    gamma_slide = torch.cat([(mu * gn_slide)[..., None] * t_hat, gn_slide[..., None]], dim=-1)
    stiction = (yr <= mu * yn)[..., None]
    separate = (yn <= -mu_hat * yr)[..., None]
    return torch.where(stiction, y, torch.where(separate, torch.zeros_like(y), gamma_slide))


def _project_gamma_jacobian(y, R, mu):
    """dP/dy (..., 3, 3) of ``_project_gamma``, region by region."""
    Rt, Rn = R[..., 0], R[..., 2]
    yt, yn = y[..., :2], y[..., 2]
    yr = torch.sqrt(torch.sum(yt * yt, dim=-1) + 1e-30)
    t = yt / yr[..., None]
    D = Rt * mu**2 + Rn
    gn = (Rt * mu * yr + Rn * yn) / D
    dgn_dyt = (Rt * mu / D)[..., None] * t  # (..., 2)
    dgn_dyn = Rn / D
    eye2 = torch.eye(2, dtype=y.dtype, device=y.device)
    tt = t[..., :, None] * t[..., None, :]
    dgt_dyt = mu[..., None, None] * (t[..., :, None] * dgn_dyt[..., None, :]
                   + (gn / yr)[..., None, None] * (eye2 - tt))
    dgt_dyn = (mu * dgn_dyn)[..., None] * t
    slide = torch.cat([
        torch.cat([dgt_dyt, dgt_dyn[..., :, None]], dim=-1),
        torch.cat([dgn_dyt, dgn_dyn[..., None]], dim=-1)[..., None, :],
    ], dim=-2)
    stiction = (yr <= mu * yn)[..., None, None]
    separate = (yn <= -(mu * Rt / Rn) * yr)[..., None, None]
    eye3 = torch.eye(3, dtype=y.dtype, device=y.device)
    return torch.where(stiction, eye3, torch.where(separate, torch.zeros_like(slide), slide))


# ---------------------------------------------------------------------------
# Problem assembly.
# ---------------------------------------------------------------------------


def make_contact_jacobian(model, params, q, contact, frames, joints=None, poses=None):
    """J (..., nc, 3, nv) mapping v to the contact-frame velocity of A
    relative to B, by the analytic form (see the module docstring).
    `frames` (..., nc, 3, 3) holds the columns [t1 t2 n]."""
    nv = model.num_velocities
    batch = q.shape[:-1]
    nc = len(contact.body_a)
    if nc == 0:
        return q.new_zeros(batch + (0, 3, nv))
    joints = joints or kin.joint_transforms(model, params, q)
    _, p_WB = poses if poses is not None else kin.forward_kinematics(model, params, q, joints)
    J_W = kin.world_velocity_jacobians(model, params, q, joints)
    zero_J = J_W.new_zeros(batch + (6, nv))
    zero_p = p_WB.new_zeros(batch + (3,))

    def point_jacs(bodies):
        Jb = torch.stack([J_W[..., b, :, :] if b >= 0 else zero_J for b in bodies], dim=-3)
        pb = torch.stack([p_WB[..., b, :] if b >= 0 else zero_p for b in bodies], dim=-2)
        r = contact.p_W - pb
        # Jp = Jv + [w]x r per column == Jv - hat(r) Jw.
        return Jb[..., 3:, :] - hat(r) @ Jb[..., :3, :]

    Jp = point_jacs(contact.body_a) - point_jacs(contact.body_b)
    return frames.mT @ Jp


def _joint_damping(model: MultibodyModel, params: MultibodyParams):
    """Per-dof viscous damping (nv,): each joint's damping on every velocity
    of the joint, none on floating joints."""
    parts = []
    for i, jt in enumerate(model.joint_types):
        nvi = _NV[jt]
        if nvi == 0:
            continue
        if jt == FLOATING:
            parts.append(params.damping.new_zeros(nvi))
        else:
            parts.append(params.damping[i : i + 1].expand(nvi))
    return torch.cat(parts)


@record_function("sap.assemble")
def assemble(
    model: MultibodyModel,
    params: MultibodyParams,
    scene: CollisionScene,
    q,
    v0,
    tau_applied,
    h: float,
    sap_params: SapParameters = SapParameters(),
    external_forces_W=None,
    joint_limits=None,
    couplers=None,
    ball_constraints=None,
    distance_constraints=None,
    weld_constraints=None,
    pd_controllers=None,
) -> tuple:
    """Build (SapData, ContactData) at (q, v0): the SapDriver's
    CalcContactProblemCache role, for contact constraints with the "cone"
    model and implicit joint damping."""
    if sap_params.contact_model != "cone":
        raise NotImplementedError(
            f"contact_model={sap_params.contact_model!r} (the Hunt-Crossley models) "
            "is not ported yet (ROADMAP.md, slice 2 left-outs)")
    for name, arg in (("joint_limits", joint_limits), ("couplers", couplers),
                      ("ball_constraints", ball_constraints),
                      ("distance_constraints", distance_constraints),
                      ("weld_constraints", weld_constraints),
                      ("pd_controllers", pd_controllers)):
        if arg is not None:
            raise NotImplementedError(
                f"SAP {name} are not ported yet (ROADMAP.md, slice 2 left-outs)")
    joints = kin.joint_transforms(model, params, q)
    M = dyn.mass_matrix(model, params, q, joints)
    D = _joint_damping(model, params)
    A = M + h * torch.diag_embed(D)
    C = dyn.bias_forces(model, params, q, v0, external_forces_W, joints) - D * v0
    p0 = (M @ v0.unsqueeze(-1)).squeeze(-1) + h * (tau_applied - C)
    v_star = solve(A, p0)

    poses = kin.forward_kinematics(model, params, q, joints)
    contact = scene.query(model, params, q, poses)
    frames = contact_frame(contact.n_W)
    J = make_contact_jacobian(model, params, q, contact, frames, joints, poses)

    # Delassus diagonal scale per contact: w = tr(J A^-1 J') / 3.
    A_inv_Jt = solve_matrix(A, J.flatten(-3, -2).mT).mT.unflatten(-2, J.shape[-3:-1])
    w = torch.sum(J * A_inv_Jt, dim=(-1, -2)) / 3.0

    k = contact.stiffness
    tau_d = contact.dissipation
    Rn_phys = 1.0 / (h * k * (h + tau_d))
    Rn_near_rigid = sap_params.beta**2 / (4.0 * math.pi**2) * w
    Rn = torch.maximum(Rn_phys, Rn_near_rigid)
    Rt = sap_params.sigma * w
    R = torch.stack([Rt, Rt, Rn], dim=-1)
    # Push out at the rate of the compliant law; in the near-rigid regime
    # the time scale is clamped to h.
    t_scale = torch.where(Rn_phys >= Rn_near_rigid, h + tau_d, torch.full_like(w, h))
    vhat_n = -contact.phi / t_scale
    zero = torch.zeros_like(vhat_n)
    vhat = torch.stack([zero, zero, vhat_n], dim=-1)
    data = SapData(A=A, v_star=v_star, J=J, R=R, vhat=vhat, mu=contact.friction)
    return data, contact


# ---------------------------------------------------------------------------
# The convex Newton solve.
# ---------------------------------------------------------------------------


def _jv(J, v):
    """J v: (..., nc, 3)."""
    return (J.flatten(-3, -2) @ v.unsqueeze(-1)).squeeze(-1).unflatten(-1, J.shape[-3:-1])


def _jtg(J, g):
    """J' g: (..., nv)."""
    return (J.flatten(-3, -2).mT @ g.flatten(-2).unsqueeze(-1)).squeeze(-1)


def _residual(A, v_star, J, R, vhat, mu, v):
    """g(v; data) = A (v - v*) - J' gamma(J v): zero at the optimum."""
    gamma = _project_gamma((vhat - _jv(J, v)) / R, R, mu)
    return (A @ (v - v_star).unsqueeze(-1)).squeeze(-1) - _jtg(J, gamma)


def _grad_and_hess(A, v_star, J, R, vhat, mu, v):
    """The cost's gradient (the residual) and Hessian H = A + J' G J, with
    G = -dgamma/dvc = dP/dy diag(1/R) per contact."""
    y = (vhat - _jv(J, v)) / R
    gamma = _project_gamma(y, R, mu)
    G = _project_gamma_jacobian(y, R, mu) / R[..., None, :]
    grad = (A @ (v - v_star).unsqueeze(-1)).squeeze(-1) - _jtg(J, gamma)
    H = A + J.flatten(-3, -2).mT @ (G @ J).flatten(-3, -2)
    return grad, H


def _line_search(A, v_star, J, R, vhat, mu, v, dv, p: SapParameters):
    """Two-level vectorized bracketing plus a secant step on the monotone
    f(alpha) = dcost/dalpha (one level on the planning path)."""
    Adv = (A @ dv.unsqueeze(-1)).squeeze(-1)
    a0 = torch.sum(dv * (A @ (v - v_star).unsqueeze(-1)).squeeze(-1), dim=-1)
    a1 = torch.sum(dv * Adv, dim=-1)
    vc0 = _jv(J, v)[..., None, :, :]
    dvc = _jv(J, dv)[..., None, :, :]
    Rk, vhatk = R[..., None, :, :], vhat[..., None, :, :]

    def f(alphas):  # (..., K)
        g = _project_gamma((vhatk - (vc0 + alphas[..., None, None] * dvc)) / Rk, Rk, mu)
        return a0[..., None] + alphas * a1[..., None] - torch.sum(g * dvc, dim=(-1, -2))

    K = p.line_search_points
    grid = torch.arange(K, dtype=v.dtype, device=v.device) / (K - 1)

    def refine(lo, hi):
        alphas = lo[..., None] + (hi - lo)[..., None] * grid
        fs = f(alphas)
        i = torch.clamp_min(torch.sum(fs < 0, dim=-1) - 1, 0)[..., None]
        i1 = torch.clamp_max(i + 1, K - 1)
        pick = torch.gather
        return (pick(alphas, -1, i)[..., 0], pick(alphas, -1, i1)[..., 0],
                pick(fs, -1, i)[..., 0], pick(fs, -1, i1)[..., 0])

    zero = torch.zeros_like(a0)
    amax = torch.full_like(a0, p.alpha_max)
    lo, hi, flo, fhi = refine(zero, amax)
    if p.unroll_iterations <= 0:
        lo, hi, flo, fhi = refine(lo, hi)
    denom = fhi - flo
    alpha = lo - flo * (hi - lo) / torch.where(torch.abs(denom) > 1e-20, denom, torch.ones_like(denom))
    alpha = torch.minimum(torch.maximum(alpha, lo), hi)
    return torch.where(fhi <= 0, amax, alpha)


def _newton_step(data: SapData, v, grad, H, p: SapParameters):
    """One guarded Newton step: a lane whose step is not finite (a failed
    factorization gives NaN) keeps its iterate."""
    dv = -cho_solve(cholesky_or_nan(H), grad)
    alpha = _line_search(*data, v, dv, p)
    step = alpha[..., None] * dv
    ok = torch.isfinite(step).all(dim=-1, keepdim=True)
    return torch.where(ok, v + step, v)


@record_function("sap.newton")
def _solve_sap_core(data: SapData, v_guess, p: SapParameters) -> SapSolution:
    """Newton with the vectorized exact line search: the fixed
    ``unroll_iterations`` loop, or the loop converged to ``rel_tolerance``
    within ``max_iterations``, lane by lane."""
    momentum_scale = torch.linalg.vector_norm(
        (data.A @ data.v_star.unsqueeze(-1)).squeeze(-1), dim=-1) + 1e-12
    v = v_guess
    if p.unroll_iterations > 0:
        for _ in range(p.unroll_iterations):
            grad, H = _grad_and_hess(*data, v)
            v = _newton_step(data, v, grad, H, p)
        iterations = torch.full(v.shape[:-1], p.unroll_iterations, dtype=torch.long, device=v.device)
        # Residual diagnostic: the gradient where the last step was taken.
        res = torch.linalg.vector_norm(grad, dim=-1) / momentum_scale
    else:
        grad, H = _grad_and_hess(*data, v)
        res = torch.linalg.vector_norm(grad, dim=-1) / momentum_scale
        iterations = torch.zeros(v.shape[:-1], dtype=torch.long, device=v.device)
        for k in range(p.max_iterations):
            active = (res > p.rel_tolerance) & (iterations < p.max_iterations)
            if k % _CHECK_EVERY == 0 and not bool(active.any()):
                break
            v_new = _newton_step(data, v, grad, H, p)
            grad_new, H_new = _grad_and_hess(*data, v_new)
            res_new = torch.linalg.vector_norm(grad_new, dim=-1) / momentum_scale
            a = active[..., None]
            v = torch.where(a, v_new, v)
            grad = torch.where(a, grad_new, grad)
            H = torch.where(a[..., None], H_new, H)
            res = torch.where(active, res_new, res)
            iterations = iterations + active.long()
    gamma = _project_gamma((data.vhat - _jv(data.J, v)) / data.R, data.R, data.mu)
    return SapSolution(v=v, gamma=gamma, iterations=iterations, momentum_residual=res)


class _SapSolve(torch.autograd.Function):
    """solve_sap with implicit-function-theorem gradients at the optimum:
    dv = -H^{-1} dg for perturbations of the data, g the residual.  Only the
    velocity output carries gradients, as in the reference."""

    generate_vmap_rule = True

    @staticmethod
    def forward(A, v_star, J, R, vhat, mu, v_guess, sap_params):
        sol = _solve_sap_core(SapData(A, v_star, J, R, vhat, mu), v_guess, sap_params)
        if sol.v is v_guess:  # no lane took a step (a problem without contacts)
            sol = sol._replace(v=v_guess.clone())
        return tuple(sol)

    @staticmethod
    def setup_context(ctx, inputs, output):
        A, v_star, J, R, vhat, mu, _, _ = inputs
        ctx.save_for_backward(A, v_star, J, R, vhat, mu, output[0])
        ctx.mark_non_differentiable(*output[1:])

    @staticmethod
    @record_function("sap.ift_backward")
    def backward(ctx, g_v, *_):
        A, v_star, J, R, vhat, mu, v = ctx.saved_tensors
        _, H = _grad_and_hess(A, v_star, J, R, vhat, mu, v)
        w = solve(H.mT, g_v)
        _, pullback = torch.func.vjp(
            lambda *d: _residual(*d, v), A, v_star, J, R, vhat, mu)
        return (*pullback(-w), None, None)


def solve_sap(data: SapData, v_guess, sap_params: SapParameters = SapParameters()) -> SapSolution:
    """Solve the SAP problem from `v_guess`; differentiable in `data` by the
    implicit-function theorem (the guess gets no gradient)."""
    return SapSolution(*_SapSolve.apply(*data, v_guess, sap_params))
