"""Forward kinematics over the static-topology tree.

The PyTorch counterpart of ``drake_tpu/multibody/kinematics.py``: the tree
loop runs in Python over the bodies and every tensor carries the lanes of a
batch in its leading dimensions (``q`` is ``(..., nq)``).  Spatial vectors are
``[w; v]`` in the body frame about the body origin.

Each function takes an optional ``joints``, the list that
``joint_transforms`` returns for the same ``q``: a caller that needs several
of these quantities at one configuration computes the joint transforms once
(the reference leaves that to XLA's common-subexpression elimination).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from drake_tpu_torch.math import rotations as rot
from drake_tpu_torch.multibody.model import (
    BALL,
    FLOATING,
    PLANAR,
    PRISMATIC,
    REVOLUTE,
    SCREW,
    WELD,
    MultibodyModel,
    MultibodyParams,
)
from drake_tpu_torch.utils.device import constant

# The planar joint's motion subspace: v = [vx_B, vy_B, wz] in the child frame.
_PLANAR_S = ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
             (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 0.0))


class JointKinematics(NamedTuple):
    R: torch.Tensor  # (..., 3, 3) R_PB child orientation in parent
    p: torch.Tensor  # (..., 3) child origin in parent
    S: torch.Tensor  # (6, nv_i) motion subspace in the child frame (no lanes)


def _mv(R, x):
    """R @ x for (..., n, m) R and (..., m) x."""
    return (R @ x.unsqueeze(-1)).squeeze(-1)


def joint_transform(model: MultibodyModel, params: MultibodyParams, i: int, q) -> JointKinematics:
    """X_PB(q_i) = X_PJ * X_J(q_i) and the motion subspace for joint i."""
    jt = model.joint_types[i]
    qo = model.q_offsets[i]
    R_PJ = params.X_PJ_R[i]
    p_PJ = params.X_PJ_p[i]
    axis = params.axis[i]
    batch = q.shape[:-1]
    if jt == REVOLUTE:
        R = R_PJ @ rot.axis_angle_to_rotation(axis, q[..., qo])
        p = p_PJ.expand(batch + (3,))
        S = torch.cat([axis, torch.zeros_like(axis)])[:, None]
    elif jt == PRISMATIC:
        R = R_PJ.expand(batch + (3, 3))
        p = p_PJ + q[..., qo, None] * (R_PJ @ axis)
        S = torch.cat([torch.zeros_like(axis), axis])[:, None]
    elif jt == WELD:
        R = R_PJ.expand(batch + (3, 3))
        p = p_PJ.expand(batch + (3,))
        S = axis.new_zeros((6, 0))
    elif jt == FLOATING:
        quat = rot.quat_normalize(q[..., qo : qo + 4])
        R = R_PJ @ rot.quat_to_rotation(quat)
        p = p_PJ + _mv(R_PJ, q[..., qo + 4 : qo + 7])
        S = torch.eye(6, dtype=axis.dtype, device=axis.device)
    elif jt == BALL:
        quat = rot.quat_normalize(q[..., qo : qo + 4])
        R = R_PJ @ rot.quat_to_rotation(quat)
        p = p_PJ.expand(batch + (3,))
        S = torch.eye(6, 3, dtype=axis.dtype, device=axis.device)
    elif jt == PLANAR:
        # Translate in the joint frame's x-y plane, rotate about its z; the
        # velocities are child-frame rates, so S is constant.
        ez = constant((0.0, 0.0, 1.0), axis)
        R = R_PJ @ rot.axis_angle_to_rotation(ez, q[..., qo + 2])
        xy0 = torch.cat([q[..., qo : qo + 2], torch.zeros_like(q[..., :1])], dim=-1)
        p = p_PJ + _mv(R_PJ, xy0)
        S = constant(_PLANAR_S, axis)
    elif jt == SCREW:
        # Rotation theta about `axis` with travel pitch * theta / (2 pi) along it.
        lead = params.screw_pitch[i] / (2.0 * torch.pi)
        R = R_PJ @ rot.axis_angle_to_rotation(axis, q[..., qo])
        p = p_PJ + (lead * q[..., qo, None]) * (R_PJ @ axis)
        S = torch.cat([axis, lead * axis])[:, None]
    else:
        raise ValueError(f"unknown joint type {jt!r}")
    return JointKinematics(R=R, p=p, S=S)


def joint_transforms(model: MultibodyModel, params: MultibodyParams, q) -> List[JointKinematics]:
    return [joint_transform(model, params, i, q) for i in range(model.num_bodies)]


def forward_kinematics(
    model: MultibodyModel, params: MultibodyParams, q, joints: Optional[list] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """World poses of all bodies: (R_WB (..., nb, 3, 3), p_WB (..., nb, 3))."""
    joints = joints or joint_transforms(model, params, q)
    Rs, ps = [], []
    for i, (R_PB, p_PB, _) in enumerate(joints):
        p_idx = model.parent[i]
        if p_idx < 0:
            Rs.append(R_PB)
            ps.append(p_PB)
        else:
            Rs.append(Rs[p_idx] @ R_PB)
            ps.append(ps[p_idx] + _mv(Rs[p_idx], p_PB))
    return torch.stack(Rs, dim=-3), torch.stack(ps, dim=-2)


def body_spatial_velocities(model, params, q, v, joints: Optional[list] = None):
    """(V_B (..., nb, 6) [w_B; v_Bo] in each body's frame, joints)."""
    joints = joints or joint_transforms(model, params, q)
    Vs = []
    for i, (R_PB, p_PB, S) in enumerate(joints):
        vo = model.v_offsets[i]
        nvi = S.shape[1]
        if nvi:
            vJ = v[..., vo : vo + nvi] @ S.mT
        else:
            vJ = v.new_zeros(v.shape[:-1] + (6,))
        p_idx = model.parent[i]
        if p_idx < 0:
            V = vJ
        else:
            Vp = Vs[p_idx]
            R_BP = R_PB.mT
            w = _mv(R_BP, Vp[..., :3])
            vv = _mv(R_BP, Vp[..., 3:] + torch.linalg.cross(Vp[..., :3], p_PB, dim=-1))
            V = torch.cat([w, vv], dim=-1) + vJ
        Vs.append(V)
    return torch.stack(Vs, dim=-2), joints


def world_velocities(model, params, q, v, joints: Optional[list] = None):
    """Spatial velocities in the world frame about each body origin: (..., nb, 6)."""
    joints = joints or joint_transforms(model, params, q)
    R_WB, _ = forward_kinematics(model, params, q, joints)
    V_B, _ = body_spatial_velocities(model, params, q, v, joints)
    return torch.cat([_mv(R_WB, V_B[..., :3]), _mv(R_WB, V_B[..., 3:])], dim=-1)


def world_velocity_jacobians(model, params, q, joints: Optional[list] = None):
    """World-frame spatial Jacobians (..., nb, 6, nv): world_velocities(q, v)
    [..., i, :] == J[..., i, :, :] @ v.  The tree recursion of
    body_spatial_velocities carried on (6, nv) matrices."""
    joints = joints or joint_transforms(model, params, q)
    nv = model.num_velocities
    R_WB, _ = forward_kinematics(model, params, q, joints)
    Js = []
    for i, (R_PB, p_PB, S) in enumerate(joints):
        own = S.new_zeros((6, nv))
        nvi = S.shape[1]
        if nvi:
            vo = model.v_offsets[i]
            own[:, vo : vo + nvi] = S
        p_idx = model.parent[i]
        if p_idx < 0:
            J = own.expand(q.shape[:-1] + (6, nv))
        else:
            Jp = Js[p_idx]
            R_BP = R_PB.mT
            w_cols = R_BP @ Jp[..., :3, :]
            v_cols = R_BP @ (Jp[..., 3:, :] - rot.hat(p_PB) @ Jp[..., :3, :])
            J = own + torch.cat([w_cols, v_cols], dim=-2)
        Js.append(J)
    J_B = torch.stack(Js, dim=-3)
    return torch.cat([R_WB @ J_B[..., :3, :], R_WB @ J_B[..., 3:, :]], dim=-2)


def point_jacobian(J_W, p_WB, body: int, p_W):
    """(..., 3, nv): the world velocity of the point p_W (..., 3) fixed on
    `body`, from the world Jacobians J_W and origins p_WB of
    world_velocity_jacobians and forward_kinematics: Jv - hat(p_W - p_WB) Jw."""
    Jb = J_W[..., body, :, :]
    return Jb[..., 3:, :] - rot.hat(p_W - p_WB[..., body, :]) @ Jb[..., :3, :]
