"""Articulated rigid-body dynamics: RNEA, CRBA mass matrix, forward dynamics.

The PyTorch counterpart of ``drake_tpu/multibody/dynamics.py``, in the same
Featherstone body-frame form, unrolled in Python over the static topology;
``q``, ``v`` and ``vdot`` carry the lanes of a batch in their leading
dimensions.  Forward dynamics is the CRBA mass matrix and a dense Cholesky
solve, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from drake_tpu_torch.math.rotations import hat
from drake_tpu_torch.math.spatial import cross_force, cross_motion
from drake_tpu_torch.multibody import kinematics as kin
from drake_tpu_torch.multibody.model import MultibodyModel, MultibodyParams
from drake_tpu_torch.utils.linalg import cho_solve, cholesky_or_nan


def _mv(R, x):
    return (R @ x.unsqueeze(-1)).squeeze(-1)


def _spatial_inertia_body(params: MultibodyParams, i: int):
    """6x6 spatial inertia of body i about its own origin, in its frame."""
    m = params.mass[i]
    C = hat(params.com[i])
    I_o = params.inertia_com[i] + m * (C @ C.T)
    eye = torch.eye(3, dtype=C.dtype, device=C.device)
    return torch.cat([torch.cat([I_o, m * C], dim=1), torch.cat([m * C.T, m * eye], dim=1)], dim=0)


def _xform_motion_to_child(R_PB, p_PB, V_P):
    R_BP = R_PB.mT
    w = _mv(R_BP, V_P[..., :3])
    v = _mv(R_BP, V_P[..., 3:] + torch.linalg.cross(V_P[..., :3], p_PB, dim=-1))
    return torch.cat([w, v], dim=-1)


def _xform_force_to_parent(R_PB, p_PB, F_B):
    f = _mv(R_PB, F_B[..., 3:])
    n = _mv(R_PB, F_B[..., :3]) + torch.linalg.cross(p_PB, f, dim=-1)
    return torch.cat([n, f], dim=-1)


def inverse_dynamics(
    model: MultibodyModel,
    params: MultibodyParams,
    q,
    v,
    vdot,
    external_forces_W: Optional[torch.Tensor] = None,
    joints: Optional[list] = None,
):
    """RNEA: generalized forces tau (..., nv) realizing vdot at (q, v),
    with gravity by the -g base acceleration and viscous joint damping.
    ``external_forces_W``: optional (..., nb, 6) spatial forces [n; f] in the
    world frame about each body origin."""
    joints = joints or kin.joint_transforms(model, params, q)
    nb = model.num_bodies
    batch = q.shape[:-1]
    zeros6 = q.new_zeros(batch + (6,))
    a_base = torch.cat([params.gravity.new_zeros(3), -params.gravity]).expand(batch + (6,))
    Vs, As, R_W = [], [], []
    for i, (R_PB, p_PB, S) in enumerate(joints):
        vo = model.v_offsets[i]
        nvi = S.shape[1]
        vJ = v[..., vo : vo + nvi] @ S.mT if nvi else zeros6
        aJ = vdot[..., vo : vo + nvi] @ S.mT if nvi else zeros6
        p_idx = model.parent[i]
        if p_idx < 0:
            V = vJ
            A = _xform_motion_to_child(R_PB, p_PB, a_base) + aJ + cross_motion(V, vJ)
            R_wi = R_PB
        else:
            V = _xform_motion_to_child(R_PB, p_PB, Vs[p_idx]) + vJ
            A = _xform_motion_to_child(R_PB, p_PB, As[p_idx]) + aJ + cross_motion(V, vJ)
            R_wi = R_W[p_idx] @ R_PB
        Vs.append(V)
        As.append(A)
        R_W.append(R_wi)

    Fs = []
    for i in range(nb):
        I = _spatial_inertia_body(params, i)
        F = As[i] @ I.T + cross_force(Vs[i], Vs[i] @ I.T)
        if external_forces_W is not None:
            n_W = external_forces_W[..., i, :3]
            f_W = external_forces_W[..., i, 3:]
            Rt = R_W[i].mT
            F = F - torch.cat([_mv(Rt, n_W), _mv(Rt, f_W)], dim=-1)
        Fs.append(F)

    taus = [None] * nb
    for i in reversed(range(nb)):
        R_PB, p_PB, S = joints[i]
        nvi = S.shape[1]
        if nvi:
            vo = model.v_offsets[i]
            taus[i] = Fs[i] @ S + params.damping[i] * v[..., vo : vo + nvi]
        p_idx = model.parent[i]
        if p_idx >= 0:
            Fs[p_idx] = Fs[p_idx] + _xform_force_to_parent(R_PB, p_PB, Fs[i])
    return torch.cat([t for t in taus if t is not None], dim=-1)


def bias_forces(model, params, q, v, external_forces_W=None, joints=None):
    """C(q, v) including gravity and damping: tau needed for vdot = 0."""
    return inverse_dynamics(model, params, q, v, torch.zeros_like(v), external_forces_W, joints)


def mass_matrix(model: MultibodyModel, params: MultibodyParams, q, joints: Optional[list] = None):
    """Composite-rigid-body mass matrix M(q): (..., nv, nv)."""
    joints = joints or kin.joint_transforms(model, params, q)
    nb = model.num_bodies
    batch = q.shape[:-1]
    Ic = [_spatial_inertia_body(params, i).expand(batch + (6, 6)) for i in range(nb)]

    # Inertias and Ic*S columns are force-like: they move to the parent with
    # the Plücker force transform X_F = [[R, p^ R], [0, R]].
    def force_xform_to_parent(R_PB, p_PB):
        top = torch.cat([R_PB, hat(p_PB) @ R_PB], dim=-1)
        bot = torch.cat([torch.zeros_like(R_PB), R_PB], dim=-1)
        return torch.cat([top, bot], dim=-2)

    Xups = [force_xform_to_parent(j.R, j.p) for j in joints]
    for i in reversed(range(nb)):
        p_idx = model.parent[i]
        if p_idx >= 0:
            X = Xups[i]
            Ic[p_idx] = Ic[p_idx] + X @ Ic[i] @ X.mT

    # Blocks (row joint, column joint) of M, filled along each ancestry.
    blocks = {}
    for i in range(nb):
        S_i = joints[i].S
        if S_i.shape[1] == 0:
            continue
        F = Ic[i] @ S_i
        blocks[(i, i)] = S_i.T @ F
        j = i
        while model.parent[j] >= 0:
            F = Xups[j] @ F
            j = model.parent[j]
            S_j = joints[j].S
            if S_j.shape[1]:
                blk = S_j.T @ F
                blocks[(j, i)] = blk
                blocks[(i, j)] = blk.mT

    refl = params.reflected_inertia
    if refl is not None:
        for i in range(nb):
            if joints[i].S.shape[1] == 1:
                blocks[(i, i)] = blocks[(i, i)] + refl[i]

    dof_joints = [i for i in range(nb) if joints[i].S.shape[1]]
    rows = []
    for i in dof_joints:
        nvi = joints[i].S.shape[1]
        row = []
        for j in dof_joints:
            blk = blocks.get((i, j))
            if blk is None:
                blk = q.new_zeros(batch + (nvi, joints[j].S.shape[1]))
            row.append(blk.expand(batch + blk.shape[-2:]))
        rows.append(torch.cat(row, dim=-1))
    return torch.cat(rows, dim=-2)


def forward_dynamics(model, params, q, v, tau_applied, external_forces_W=None):
    """vdot = M(q)^{-1} (tau_applied - C(q, v)) by a Cholesky solve."""
    joints = kin.joint_transforms(model, params, q)
    M = mass_matrix(model, params, q, joints)
    C = bias_forces(model, params, q, v, external_forces_W, joints)
    return cho_solve(cholesky_or_nan(M), tau_applied - C)


def kinetic_energy(model, params, q, v):
    """1/2 sum_b V_b' I_b V_b over the bodies: (...,)."""
    Vs, _ = kin.body_spatial_velocities(model, params, q, v)
    ke = 0.0
    for i in range(model.num_bodies):
        V = Vs[..., i, :]
        ke = ke + 0.5 * torch.sum(V * (V @ _spatial_inertia_body(params, i).T), dim=-1)
    return ke


def potential_energy(model, params, q):
    """Gravitational potential energy of the bodies' centres of mass: (...,)."""
    R_WB, p_WB = kin.forward_kinematics(model, params, q)
    p_com_W = p_WB + (R_WB @ params.com.unsqueeze(-1)).squeeze(-1)
    return -torch.sum(params.mass * (p_com_W @ params.gravity), dim=-1)


def total_energy(model, params, q, v):
    return kinetic_energy(model, params, q, v) + potential_energy(model, params, q)
