"""SAP: Semi-Analytic Primal solver for discrete frictional contact.

The PyTorch counterpart of ``drake_tpu/contact/sap.py`` (Castro, Permenter,
Han 2021, arXiv:2110.10107):

    v_next = argmin_v  1/2 (v - v*)' A (v - v*) + sum_i l_i(J_i v)

with per-contact regularized friction-cone costs (or the convex
Hunt-Crossley models), one-sided joint limits, two-sided holonomic rows
(couplers, ball, distance and weld constraints) and effort-limited
implicit PD rows; dense Newton steps on H = A + J' G J, the reference's
two-level vectorized line search, and gradients by the implicit-function
theorem at the optimum.  Every tensor carries the lanes of a batch in its
leading dimensions.

What differs from the reference, by design:

- ``_solve_sap_core``'s converged loop is a Python loop over all lanes with
  a per-lane ``active`` mask (a lane that has converged keeps its values and
  its iteration count, as under ``vmap`` of ``lax.while_loop``); the host
  asks whether any lane is still active every ``_CHECK_EVERY`` iterations.
- G = -dgamma/dvc is the closed-form derivative of the cone projection, not
  ``jacfwd`` of it (the same matrix); the Hunt-Crossley impulses and their
  G are closed forms of the derivatives of the reference's scalar cost
  (``_hc_gamma_and_G``), not ``jax.grad`` and ``jacfwd`` of it.
- ``make_contact_jacobian`` builds J by the analytic form (from the tree's
  world spatial Jacobians), as do the ball, distance and weld rows; the
  reference's default ``"jacfwd"`` form is a forward-mode Jacobian of the
  same linear map, so its ``contact_jacobian`` switch has no counterpart.
- ``solve_sap`` is a ``torch.autograd.Function`` whose backward solves
  H' w = dL/dv and pulls -w back through the residual with
  ``torch.func.vjp``; it carries ``generate_vmap_rule`` so that
  ``torch.func.vmap`` of a pullback batches the cotangents.
- A constraint family that is absent is None in ``SapData`` (the
  reference's zero-row arrays), so the contact-only problem keeps the
  contact-only arithmetic.
- Solves use the ``_ex`` forms of PyTorch's factorizations
  (``utils/linalg.py``): a matrix that is not positive definite gives NaN,
  as JAX's, and the guards below catch it as the reference's do.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

from drake_tpu_torch.geometry.scene import CollisionScene, contact_frame
from drake_tpu_torch.math import rotations as rot
from drake_tpu_torch.math.rotations import hat
from drake_tpu_torch.multibody import dynamics as dyn
from drake_tpu_torch.multibody import kinematics as kin
from drake_tpu_torch.multibody.model import (_NV, FLOATING, PRISMATIC, REVOLUTE, MultibodyModel,
                                             MultibodyParams)
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
    # "cone": the regularized friction-cone projection; "hc_lagged" and
    # "hc_similar": the convex Hunt-Crossley approximations.
    contact_model: str = "cone"
    stiction_tolerance: float = 1e-4  # the Hunt-Crossley soft norm's floor


class HcData(NamedTuple):
    """Per-contact Hunt-Crossley data, each (..., nc)."""

    k: torch.Tensor  # contact stiffness
    d: torch.Tensor  # Hunt-Crossley dissipation (s/m)
    fe0: torch.Tensor  # previous-step elastic force k x0 (signed)
    n0: torch.Tensor  # previous-step normal impulse (the lagged friction's)
    eps: torch.Tensor  # soft-norm regularization
    h: torch.Tensor  # time step


class SapData(NamedTuple):
    """The assembled convex problem.  Limit rows act as one-sided
    frictionless contacts, equality rows (couplers, ball, distance, weld)
    are two-sided and always active, PD rows are clipped at the effort
    limit; a family that is absent is None."""

    A: torch.Tensor  # (..., nv, nv) dynamics matrix
    v_star: torch.Tensor  # (..., nv) free-motion velocity
    J: torch.Tensor  # (..., nc, 3, nv) contact Jacobians (rows t1, t2, n)
    R: torch.Tensor  # (..., nc, 3) regularization diag (Rt, Rt, Rn)
    vhat: torch.Tensor  # (..., nc, 3) bias velocity (0, 0, vhat_n)
    mu: torch.Tensor  # (nc,) friction
    J_lim: Optional[torch.Tensor] = None  # (nl, nv) limit rows (+e_j lower, -e_j upper)
    R_lim: Optional[torch.Tensor] = None  # (..., nl)
    vhat_lim: Optional[torch.Tensor] = None  # (..., nl)
    J_eq: Optional[torch.Tensor] = None  # (..., ne, nv) two-sided holonomic rows
    R_eq: Optional[torch.Tensor] = None  # (..., ne)
    vhat_eq: Optional[torch.Tensor] = None  # (..., ne)
    J_pd: Optional[torch.Tensor] = None  # (npd, nv) implicit-PD rows (e_j)
    R_pd: Optional[torch.Tensor] = None  # (npd,) 1 / (h (Kp h + Kd))
    vhat_pd: Optional[torch.Tensor] = None  # (..., npd) servo bias velocity
    glim_pd: Optional[torch.Tensor] = None  # (npd,) impulse bound h * effort_limit
    hc: Optional[HcData] = None  # the Hunt-Crossley models' data


# The fields after the contact block, as solve_sap passes them flat.
_ROW_FIELDS = SapData._fields[6:-1]


class SapSolution(NamedTuple):
    v: torch.Tensor  # (..., nv) next-step generalized velocity
    gamma: torch.Tensor  # (..., nc, 3) contact impulses in contact frames
    iterations: torch.Tensor  # (...,) Newton iterations taken
    momentum_residual: torch.Tensor  # (...,)


def _rows(x) -> bool:
    """Whether a constraint family is present (None or zero rows: absent)."""
    return x is not None and x.shape[-1] > 0


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
# Hunt-Crossley convex approximations (kLagged / kSimilar).
#
# The discrete normal impulse n(v) = h (fe0 - h k v)+ (1 - d v)+ has the
# antiderivative N (constant past v_hat = min(fe0 / (h k), 1 / d), where n
# vanishes); friction is regularized by the soft norm ||vt||_s =
# sqrt(|vt|^2 + eps^2) - eps.  The cost of a contact is
#   kSimilar: l = -N(z), z = vn - mu ||vt||_s
#   kLagged:  l = -N(vn) + mu ||vt||_s n0
# and its impulse gamma = -dl/dvc and G = d2l/dvc2 are written out below.
# ---------------------------------------------------------------------------


def _hc_v_hat(hc: HcData):
    k, d, fe0, _, _, h = hc
    return torch.minimum(fe0 / h / (k + 1e-20), 1.0 / (d + 1e-20))


def _hc_antiderivative(hc: HcData, vn):
    """N(vn), constant past v_hat."""
    k, d, fe0, _, _, h = hc
    v = torch.minimum(vn, _hc_v_hat(hc))
    df = -h * k * v
    return h * (v * (fe0 + 0.5 * df) - d * v * v / 2.0 * (fe0 + 2.0 / 3.0 * df))


def _hc_n(hc: HcData, v):
    """n(v) = dN/dv and its derivative n'(v), zero past v_hat.  At v = v_hat
    (where n itself is 0) the weights are the reference's: its minimum
    splits a tie's derivative in half, once in n and twice in n'."""
    k, d, fe0, _, _, h = hc
    v_hat = _hc_v_hat(hc)
    w = (v < v_hat).to(v.dtype) + 0.5 * (v == v_hat).to(v.dtype)
    f = fe0 - h * k * v
    n = h * f * (1.0 - d * v)
    dn = h * (-h * k * (1.0 - d * v) - d * f)
    return n * w, dn * w * w


def _soft_tangent(vt, eps):
    """(||vt||_s, its gradient t = vt / r, r = sqrt(|vt|^2 + eps^2))."""
    r = torch.sqrt(torch.sum(vt * vt, dim=-1) + eps * eps)
    return r - eps, vt / r[..., None], r


def _hc_cost(vc, mu, hc: HcData, similar: bool):
    """The scalar cost (..., nc) of each Hunt-Crossley contact at vc."""
    vt_soft, _, _ = _soft_tangent(vc[..., :2], hc.eps)
    if similar:
        return -_hc_antiderivative(hc, vc[..., 2] - mu * vt_soft)
    return -_hc_antiderivative(hc, vc[..., 2]) + mu * vt_soft * hc.n0


def _hc_gamma_and_G(vc, mu, hc: HcData, similar: bool, with_G: bool = True):
    """gamma = -dl/dvc (..., nc, 3) and G = d2l/dvc2 (..., nc, 3, 3) of
    ``_hc_cost``, in closed form."""
    vt_soft, t, r = _soft_tangent(vc[..., :2], hc.eps)
    if similar:
        n, dn = _hc_n(hc, vc[..., 2] - mu * vt_soft)
        f_t = mu * n  # the tangential impulse's magnitude
    else:
        n, dn = _hc_n(hc, vc[..., 2])
        f_t = mu * hc.n0
    gamma = torch.cat([-f_t[..., None] * t, n[..., None]], dim=-1)
    if not with_G:
        return gamma, None
    eye2 = torch.eye(2, dtype=vc.dtype, device=vc.device)
    G_tt = (f_t / r)[..., None, None] * (eye2 - t[..., :, None] * t[..., None, :])
    if similar:
        grad_z = torch.cat([-mu[..., None] * t, torch.ones_like(n)[..., None]], dim=-1)
        G = -dn[..., None, None] * (grad_z[..., :, None] * grad_z[..., None, :])
        G = G + torch.nn.functional.pad(G_tt, (0, 1, 0, 1))
    else:
        G = torch.nn.functional.pad(G_tt, (0, 1, 0, 1))
        G = G + torch.nn.functional.pad((-dn)[..., None, None], (2, 0, 2, 0))
    return gamma, G


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


def _delassus_diag(A, J_rows):
    """w = diag(J A^-1 J') (..., n) of rows J (..., n, nv)."""
    Ainv_Jt = solve_matrix(A, J_rows.mT.expand(A.shape[:-2] + J_rows.mT.shape[-2:]))
    return torch.sum(J_rows * Ainv_Jt.mT, dim=-1)


def _point_jacobian(J_W, p_WB, body, p_W):
    """kin.point_jacobian, None for a point on the world."""
    return None if body < 0 else kin.point_jacobian(J_W, p_WB, body, p_W)


def _difference(Ja, Jb, like):
    if Ja is None and Jb is None:
        return like.new_zeros(like.shape[:-1] + (3, like.shape[-1]))
    if Jb is None:
        return Ja
    return -Jb if Ja is None else Ja - Jb


def _constraint_rows(model, params, q, joints, poses, A, couplers, balls, distances, welds):
    """Equality rows (..., ne, nv) and their position errors (..., ne):
    couplers q_a = rho q_b + offset, then ball (3 rows: P on A and Q on B
    coincide), distance (1 row along the line of centres) and weld (3
    rotational rows by the SO(3) log, then 3 translational) constraints."""
    nv = model.num_velocities
    batch = q.shape[:-1]
    rows, phis = [], []
    for name_a, name_b, rho, offset in couplers or ():
        ia, ib = model.joint_names.index(name_a), model.joint_names.index(name_b)
        row = q.new_zeros(nv)
        row[model.v_offsets[ia]] = 1.0
        row[model.v_offsets[ib]] = -rho
        rows.append(row.expand(batch + (1, nv)))
        phis.append((q[..., model.q_offsets[ia]] - rho * q[..., model.q_offsets[ib]]
                     - offset)[..., None])
    if balls or distances or welds:
        R_WB, p_WB = poses
        J_W = kin.world_velocity_jacobians(model, params, q, joints)
        zero_row = q.new_zeros(batch + (nv,))

        def point(body, p_B):
            p_B = torch.as_tensor(p_B, dtype=q.dtype, device=q.device)
            if body < 0:
                return p_B.expand(batch + (3,))
            return p_WB[..., body, :] + (R_WB[..., body, :, :] @ p_B.unsqueeze(-1)).squeeze(-1)

        def rel_point(body_a, p_AP, body_b, p_BQ):
            p_WP, p_WQ = point(body_a, p_AP), point(body_b, p_BQ)
            J3 = _difference(_point_jacobian(J_W, p_WB, body_a, p_WP),
                             _point_jacobian(J_W, p_WB, body_b, p_WQ), zero_row)
            return p_WP - p_WQ, J3

        for body_a, p_AP, body_b, p_BQ in balls or ():
            phi3, J3 = rel_point(body_a, p_AP, body_b, p_BQ)
            rows.append(J3)
            phis.append(phi3)
        for body_a, p_AP, body_b, p_BQ, d0 in distances or ():
            d_vec, J3 = rel_point(body_a, p_AP, body_b, p_BQ)
            dist = torch.sqrt(torch.sum(d_vec * d_vec, dim=-1) + 1e-14)
            n_hat = d_vec / dist[..., None]
            rows.append((n_hat.unsqueeze(-2) @ J3))
            phis.append((dist - d0)[..., None])
        for body_a, R_AP, p_AP, body_b, R_BQ, p_BQ in welds or ():
            R_AP = torch.as_tensor(R_AP, dtype=q.dtype, device=q.device)
            R_BQ = torch.as_tensor(R_BQ, dtype=q.dtype, device=q.device)
            R_WP = R_WB[..., body_a, :, :] @ R_AP if body_a >= 0 else R_AP.expand(batch + (3, 3))
            R_WQ = R_WB[..., body_b, :, :] @ R_BQ if body_b >= 0 else R_BQ.expand(batch + (3, 3))
            Jw = _difference(J_W[..., body_a, :3, :] if body_a >= 0 else None,
                             J_W[..., body_b, :3, :] if body_b >= 0 else None, zero_row)
            phi3, J3 = rel_point(body_a, p_AP, body_b, p_BQ)
            rows += [Jw, J3]
            phis += [rot.rotation_log(R_WP @ R_WQ.mT), phi3]
    if not rows:
        return None, None
    return torch.cat(rows, dim=-2), torch.cat(phis, dim=-1)


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
    joint_limits=None,  # (q_lower, q_upper), indexed by velocity index
    couplers=None,  # [(joint_a, joint_b, ratio, offset), ...]
    ball_constraints=None,  # [(body_a, p_AP, body_b, p_BQ), ...]
    distance_constraints=None,  # [(body_a, p_AP, body_b, p_BQ, d0), ...]
    weld_constraints=None,  # [(body_a, R_AP, p_AP, body_b, R_BQ, p_BQ), ...]
    pd_controllers=None,  # (specs, qd, vd, u_ff); specs ((joint, Kp, Kd, e_lim), ...)
) -> tuple:
    """Build (SapData, ContactData) at (q, v0): the SapDriver's
    CalcContactProblemCache role, with implicit joint damping."""
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
    near_rigid = sap_params.beta**2 / (4.0 * math.pi**2)
    Rn_near_rigid = near_rigid * w
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

    if sap_params.contact_model != "cone":
        # fe0 = k x0 is signed, so a pair still apart engages only if it
        # approaches fast enough; the scene's dissipation is the HC d here.
        fe0 = -k * contact.phi
        vn0 = torch.sum(J[..., 2, :] * v0.unsqueeze(-2), dim=-1)
        zero_c = torch.zeros_like(fe0)
        n0 = h * torch.maximum(fe0, zero_c) * torch.maximum(1.0 - tau_d * vn0, zero_c)
        eps = torch.maximum(torch.full_like(n0, sap_params.stiction_tolerance),
                            contact.friction * Rt * n0)
        data = data._replace(hc=HcData(k=k.expand_as(fe0), d=tau_d.expand_as(fe0), fe0=fe0,
                                       n0=n0, eps=eps, h=torch.full_like(fe0, h)))

    nv = model.num_velocities
    if joint_limits is not None:
        # One-sided limits on the revolute and prismatic joints: q - q_lower
        # >= 0 with row +e_j, q_upper - q >= 0 with row -e_j.
        q_lower, q_upper = (torch.as_tensor(x, dtype=q.dtype, device=q.device)
                            for x in joint_limits)
        sel_v, sel_q = [], []
        for i, jt in enumerate(model.joint_types):
            if jt in (REVOLUTE, PRISMATIC):
                sel_v.append(model.v_offsets[i])
                sel_q.append(model.q_offsets[i])
        eye = torch.eye(nv, dtype=q.dtype, device=q.device)
        J_lim = torch.cat([eye[sel_v], -eye[sel_v]], dim=0)
        q_sel = q[..., sel_q]
        phi_lim = torch.cat([q_sel - q_lower[sel_v], q_upper[sel_v] - q_sel], dim=-1)
        data = data._replace(J_lim=J_lim, R_lim=near_rigid * _delassus_diag(A, J_lim),
                             vhat_lim=-phi_lim / h)

    J_eq, phi_eq = _constraint_rows(model, params, q, joints, poses, A, couplers,
                                    ball_constraints, distance_constraints, weld_constraints)
    if J_eq is not None:
        w_eq = _delassus_diag(A, J_eq)
        # Degenerate rows (the out-of-plane axis of a planar loop closure)
        # have w = 0: floor w at a small fraction of the largest row's.
        w_eq = torch.maximum(w_eq, 1e-8 * torch.amax(w_eq, dim=-1, keepdim=True) + 1e-14)
        data = data._replace(J_eq=J_eq, R_eq=near_rigid * w_eq, vhat_eq=-phi_eq / h)

    if pd_controllers is not None:
        # tau = clamp(Kp (qd - q_next) + Kd (vd - v) + u_ff, +-e_lim), implicit
        # in v (q_next = q + h v): gamma = clip((vhat - v_j) / R, +-h e_lim)
        # with R = 1 / (h (Kp h + Kd)).
        specs, qd_des, vd_des, u_ff = pd_controllers
        eye = torch.eye(nv, dtype=q.dtype, device=q.device)
        vos, qos, gains, R_pd, glim = [], [], [], [], []
        for jname, Kp, Kd, e_lim in specs:
            ij = model.joint_names.index(jname)
            denom = Kp * h + Kd
            if float(denom) <= 0.0:
                raise ValueError(f"pd controller on '{jname}': Kp*h + Kd must be > 0")
            vos.append(model.v_offsets[ij])
            qos.append(model.q_offsets[ij])
            gains.append((Kp, Kd, denom))
            R_pd.append(1.0 / (h * denom))
            glim.append(h * e_lim)
        Kp, Kd, denom = (torch.tensor([g[c] for g in gains], dtype=q.dtype, device=q.device)
                         for c in range(3))
        vhat_pd = (Kp * (qd_des - q[..., qos]) + Kd * vd_des + u_ff) / denom
        data = data._replace(J_pd=eye[vos], vhat_pd=vhat_pd,
                             R_pd=torch.tensor(R_pd, dtype=q.dtype, device=q.device),
                             glim_pd=torch.tensor(glim, dtype=q.dtype, device=q.device))
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


def _rv(J_rows, v):
    """Row velocities J v (..., n) of rows (..., n, nv)."""
    return (J_rows @ v.unsqueeze(-1)).squeeze(-1)


def _rtg(J_rows, g):
    """J' g (..., nv) of rows (..., n, nv) and impulses (..., n)."""
    return (J_rows.mT @ g.unsqueeze(-1)).squeeze(-1)


def _limit_gamma(data: SapData, v):
    """One-sided limit impulses: max(0, (vhat - J v) / R)."""
    y = (data.vhat_lim - _rv(data.J_lim, v)) / data.R_lim
    return torch.maximum(y, torch.zeros_like(y))


def _eq_gamma(data: SapData, v):
    """Two-sided holonomic impulses (vhat - J v) / R, always active."""
    return (data.vhat_eq - _rv(data.J_eq, v)) / data.R_eq


def _pd_gamma(data: SapData, v):
    """Effort-limited implicit-PD impulses clip((vhat - v_j) / R, +-h e_lim)."""
    y = (data.vhat_pd - _rv(data.J_pd, v)) / data.R_pd
    return torch.minimum(torch.maximum(y, -data.glim_pd), data.glim_pd)


def _pd_cost(data: SapData, v):
    """R (c^2 / 2 + c (y - c)), c = clip(y): quadratic inside the effort
    box, linear outside (the antiderivative of -gamma_pd)."""
    y = (data.vhat_pd - _rv(data.J_pd, v)) / data.R_pd
    c = torch.minimum(torch.maximum(y, -data.glim_pd), data.glim_pd)
    return torch.sum(data.R_pd * (0.5 * c * c + c * (y - c)), dim=-1)


def _total_cost(data: SapData, v, p: SapParameters = SapParameters()):
    """The convex cost at v (...,) and the contact impulses."""
    dv = v - data.v_star
    cost = 0.5 * torch.sum(dv * (data.A @ dv.unsqueeze(-1)).squeeze(-1), dim=-1)
    vc = _jv(data.J, v)
    if p.contact_model == "cone":
        y = (data.vhat - vc) / data.R
        gamma = _project_gamma(y, data.R, data.mu)
        costs = 0.5 * torch.sum(gamma * data.R * gamma, dim=-1)
    else:
        similar = p.contact_model == "hc_similar"
        costs = _hc_cost(vc, data.mu, data.hc, similar)
        gamma = _hc_gamma_and_G(vc, data.mu, data.hc, similar)[0]
    if _rows(data.R_lim):
        gl = _limit_gamma(data, v)
        cost = cost + 0.5 * torch.sum(data.R_lim * gl * gl, dim=-1)
    if _rows(data.R_eq):
        ge = _eq_gamma(data, v)
        cost = cost + 0.5 * torch.sum(data.R_eq * ge * ge, dim=-1)
    if _rows(data.R_pd):
        cost = cost + _pd_cost(data, v)
    return cost + torch.sum(costs, dim=-1), gamma


def _contact_gamma(data: SapData, vc, p: SapParameters, with_G: bool):
    """Contact impulses (..., nc, 3) at contact velocities vc, and with
    `with_G` G = -dgamma/dvc (..., nc, 3, 3)."""
    if p.contact_model == "cone":
        y = (data.vhat - vc) / data.R
        gamma = _project_gamma(y, data.R, data.mu)
        if not with_G:
            return gamma, None
        return gamma, _project_gamma_jacobian(y, data.R, data.mu) / data.R[..., None, :]
    gamma, G = _hc_gamma_and_G(vc, data.mu, data.hc, p.contact_model == "hc_similar")
    return gamma, G


def _residual(data: SapData, v, p: SapParameters):
    """g(v; data) = A (v - v*) - J' gamma(J v) - the rows' J' gamma: zero at
    the optimum."""
    gamma, _ = _contact_gamma(data, _jv(data.J, v), p, False)
    r = (data.A @ (v - data.v_star).unsqueeze(-1)).squeeze(-1) - _jtg(data.J, gamma)
    if _rows(data.R_lim):
        r = r - _rtg(data.J_lim, _limit_gamma(data, v))
    if _rows(data.R_eq):
        r = r - _rtg(data.J_eq, _eq_gamma(data, v))
    if _rows(data.R_pd):
        r = r - _rtg(data.J_pd, _pd_gamma(data, v))
    return r


def _grad_and_hess(data: SapData, v, p: SapParameters):
    """The cost's gradient (the residual) and Hessian H = A + J' G J plus
    each row family's J' G J."""
    A, v_star, J = data.A, data.v_star, data.J
    gamma, G = _contact_gamma(data, _jv(J, v), p, True)
    grad = (A @ (v - v_star).unsqueeze(-1)).squeeze(-1) - _jtg(J, gamma)
    H = A + J.flatten(-3, -2).mT @ (G @ J).flatten(-3, -2)
    if _rows(data.R_lim):
        gl = _limit_gamma(data, v)
        grad = grad - _rtg(data.J_lim, gl)
        G_l = (gl > 0).to(v.dtype) / data.R_lim
        H = H + data.J_lim.mT @ (G_l[..., None] * data.J_lim)
    if _rows(data.R_eq):
        grad = grad - _rtg(data.J_eq, _eq_gamma(data, v))
        H = H + data.J_eq.mT @ (data.J_eq / data.R_eq[..., None])
    if _rows(data.R_pd):
        grad = grad - _rtg(data.J_pd, _pd_gamma(data, v))
        y_pd = (data.vhat_pd - _rv(data.J_pd, v)) / data.R_pd
        act = (torch.abs(y_pd) < data.glim_pd).to(v.dtype)
        H = H + data.J_pd.mT @ ((act / data.R_pd)[..., None] * data.J_pd)
    return grad, H


def _line_search(data: SapData, v, dv, p: SapParameters):
    """Two-level vectorized bracketing plus a secant step on the monotone
    f(alpha) = dcost/dalpha (one level on the planning path)."""
    A, v_star, J, R, vhat, mu = data[:6]
    Adv = (A @ dv.unsqueeze(-1)).squeeze(-1)
    a0 = torch.sum(dv * (A @ (v - v_star).unsqueeze(-1)).squeeze(-1), dim=-1)
    a1 = torch.sum(dv * Adv, dim=-1)
    vc0 = _jv(J, v)[..., None, :, :]
    dvc = _jv(J, dv)[..., None, :, :]
    Rk, vhatk = R[..., None, :, :], vhat[..., None, :, :]
    if p.contact_model != "cone":
        hck = HcData(*(x[..., None, :] for x in data.hc))
        similar = p.contact_model == "hc_similar"
    rows = [(name, _rv(getattr(data, "J_" + name), v)[..., None, :],
             _rv(getattr(data, "J_" + name), dv)[..., None, :])
            for name in ("lim", "eq", "pd") if _rows(getattr(data, "R_" + name))]

    def f(alphas):  # (..., K)
        al = alphas[..., None]
        if p.contact_model == "cone":
            g = _project_gamma((vhatk - (vc0 + al[..., None] * dvc)) / Rk, Rk, mu)
        else:
            g = _hc_gamma_and_G(vc0 + al[..., None] * dvc, mu, hck, similar, False)[0]
        out = a0[..., None] + alphas * a1[..., None] - torch.sum(g * dvc, dim=(-1, -2))
        for name, r0, dr in rows:
            y = (getattr(data, "vhat_" + name)[..., None, :] - (r0 + al * dr)) / getattr(
                data, "R_" + name)[..., None, :]
            if name == "lim":
                y = torch.maximum(y, torch.zeros_like(y))
            elif name == "pd":
                glim = data.glim_pd[..., None, :]
                y = torch.minimum(torch.maximum(y, -glim), glim)
            out = out - torch.sum(y * dr, dim=-1)
        return out

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
    alpha = _line_search(data, v, dv, p)
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
            grad, H = _grad_and_hess(data, v, p)
            v = _newton_step(data, v, grad, H, p)
        iterations = torch.full(v.shape[:-1], p.unroll_iterations, dtype=torch.long, device=v.device)
        # Residual diagnostic: the gradient where the last step was taken.
        res = torch.linalg.vector_norm(grad, dim=-1) / momentum_scale
    else:
        grad, H = _grad_and_hess(data, v, p)
        res = torch.linalg.vector_norm(grad, dim=-1) / momentum_scale
        iterations = torch.zeros(v.shape[:-1], dtype=torch.long, device=v.device)
        for k in range(p.max_iterations):
            active = (res > p.rel_tolerance) & (iterations < p.max_iterations)
            if k % _CHECK_EVERY == 0 and not bool(active.any()):
                break
            v_new = _newton_step(data, v, grad, H, p)
            grad_new, H_new = _grad_and_hess(data, v_new, p)
            res_new = torch.linalg.vector_norm(grad_new, dim=-1) / momentum_scale
            a = active[..., None]
            v = torch.where(a, v_new, v)
            grad = torch.where(a, grad_new, grad)
            H = torch.where(a[..., None], H_new, H)
            res = torch.where(active, res_new, res)
            iterations = iterations + active.long()
    gamma, _ = _contact_gamma(data, _jv(data.J, v), p, False)
    return SapSolution(v=v, gamma=gamma, iterations=iterations, momentum_residual=res)


def _flatten(data: SapData):
    """The data's tensors in solve_sap's argument order (absent ones None)."""
    hc = tuple(data.hc) if data.hc is not None else (None,) * len(HcData._fields)
    return tuple(data[:6]), tuple(data[6:-1]) + hc


def _unflatten(head, extra) -> SapData:
    rows, hc = extra[: len(_ROW_FIELDS)], extra[len(_ROW_FIELDS):]
    return SapData(*head, *rows, hc=None if hc[0] is None else HcData(*hc))


class _SapSolve(torch.autograd.Function):
    """solve_sap with implicit-function-theorem gradients at the optimum:
    dv = -H^{-1} dg for perturbations of the data, g the residual.  Only the
    velocity output carries gradients, as in the reference."""

    generate_vmap_rule = True

    @staticmethod
    def forward(A, v_star, J, R, vhat, mu, v_guess, sap_params, *extra):
        data = _unflatten((A, v_star, J, R, vhat, mu), extra)
        sol = _solve_sap_core(data, v_guess, sap_params)
        if sol.v is v_guess:  # no lane took a step (a problem without contacts)
            sol = sol._replace(v=v_guess.clone())
        return tuple(sol)

    @staticmethod
    def setup_context(ctx, inputs, output):
        A, v_star, J, R, vhat, mu, _, sap_params, *extra = inputs
        ctx.sap_params = sap_params
        ctx.save_for_backward(A, v_star, J, R, vhat, mu, output[0], *extra)
        ctx.mark_non_differentiable(*output[1:])

    @staticmethod
    @record_function("sap.ift_backward")
    def backward(ctx, g_v, *_):
        A, v_star, J, R, vhat, mu, v, *extra = ctx.saved_tensors
        p = ctx.sap_params
        head = (A, v_star, J, R, vhat, mu)
        _, H = _grad_and_hess(_unflatten(head, extra), v, p)
        w = solve(H.mT, g_v)
        present = [i for i, x in enumerate(extra) if x is not None]

        def residual(*tensors):
            ext = list(extra)
            for i, x in zip(present, tensors[6:]):
                ext[i] = x
            return _residual(_unflatten(tensors[:6], ext), v, p)

        _, pullback = torch.func.vjp(residual, *head, *(extra[i] for i in present))
        grads = pullback(-w)
        extra_grads = [None] * len(extra)
        for i, g in zip(present, grads[6:]):
            extra_grads[i] = g
        return (*grads[:6], None, None, *extra_grads)


def solve_sap(data: SapData, v_guess, sap_params: SapParameters = SapParameters()) -> SapSolution:
    """Solve the SAP problem from `v_guess`; differentiable in `data` by the
    implicit-function theorem (the guess gets no gradient)."""
    head, extra = _flatten(data)
    return SapSolution(*_SapSolve.apply(*head, v_guess, sap_params, *extra))
