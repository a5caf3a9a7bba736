"""Force elements: springs, dampers, door hinges and bushings as generalized
forces.

The PyTorch counterpart of ``drake_tpu/multibody/force_elements.py``
(Drake's ForceElement family: linear_spring_damper.h, revolute_spring.h,
prismatic_spring.h, door_hinge.h, linear_bushing_roll_pitch_yaw.h).  Each
element has a deflection coordinate x(q) and a force law f = K x + D xdot,
mapped to generalized forces by virtual power, tau = -J' f with J the
Jacobian of xdot in v.  The reference builds J' f with a jvp and a vjp over
its coordinate function; here J is built from the tree's world velocity
Jacobians (the same linear map, so the same forces), which keeps tau a plain
differentiable function of (q, v) over the lanes in their leading
dimensions.

The element topology is static Python; the numeric parameters live in a
``ForceElementParams`` of tensors shared by every lane.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from drake_tpu_torch.math import rotations as rot
from drake_tpu_torch.multibody import kinematics as kin
from drake_tpu_torch.multibody.model import _NV, REVOLUTE, MultibodyModel, MultibodyParams
from drake_tpu_torch.utils.device import resolve_device
from drake_tpu_torch.utils.linalg import solve_matrix
from drake_tpu_torch.utils.struct import tensor_dataclass


@dataclasses.dataclass(frozen=True)
class ForceElementSet:
    """Static topology of all force elements."""

    spring_bodies: Tuple[Tuple[int, int], ...]  # (body_a, body_b) pairs
    joint_spring_joints: Tuple[int, ...]  # joint (== body) indices, 1-dof
    bushing_bodies: Tuple[Tuple[int, int], ...]  # (body_a, body_c) pairs
    door_hinge_joints: Tuple[int, ...] = ()  # 1-dof revolute joints


@tensor_dataclass
class ForceElementParams:
    """Numeric parameters, one leading axis per element."""

    sd_p_AP: torch.Tensor  # (ns, 3) attachment point on A, in A
    sd_p_BQ: torch.Tensor  # (ns, 3) attachment point on B, in B
    sd_free_length: torch.Tensor  # (ns,)
    sd_stiffness: torch.Tensor  # (ns,)
    sd_damping: torch.Tensor  # (ns,)
    js_stiffness: torch.Tensor  # (nj,)
    js_nominal: torch.Tensor  # (nj,) nominal angle/position
    bu_X_AF_R: torch.Tensor  # (nbu, 3, 3) frame F rotation in A
    bu_X_AF_p: torch.Tensor  # (nbu, 3)
    bu_X_CM_R: torch.Tensor  # (nbu, 3, 3) frame M rotation in C
    bu_X_CM_p: torch.Tensor  # (nbu, 3)
    bu_k: torch.Tensor  # (nbu, 6) diagonal stiffness [k_rpy; k_xyz]
    bu_d: torch.Tensor  # (nbu, 6) diagonal damping [d_rpy; d_xyz]
    # door hinges: columns [spring_zero_angle, spring_constant,
    # dynamic_friction, static_friction, viscous_friction, catch_width,
    # catch_torque, motion_threshold]
    dh_cfg: torch.Tensor = None  # (ndh, 8)


def _rpy_rotation(rpy) -> np.ndarray:
    return rot.rpy_to_rotation(torch.tensor(np.asarray(rpy, np.float64))).numpy()


class ForceElementBuilder:
    """Imperative builder mirroring MultibodyPlant's AddForceElement."""

    def __init__(self, model: MultibodyModel):
        self._model = model
        self._sd: List[tuple] = []
        self._js: List[tuple] = []
        self._dh: List[tuple] = []
        self._bu: List[tuple] = []

    def add_linear_spring_damper(self, body_a: str, p_AP, body_b: str, p_BQ,
                                 free_length: float, stiffness: float,
                                 damping: float = 0.0) -> "ForceElementBuilder":
        self._sd.append((self._model.body_index(body_a), self._model.body_index(body_b),
                         np.asarray(p_AP, np.float64), np.asarray(p_BQ, np.float64),
                         float(free_length), float(stiffness), float(damping)))
        return self

    def add_joint_spring(self, joint: str, nominal: float,
                         stiffness: float) -> "ForceElementBuilder":
        """Revolute/prismatic/screw spring: tau = -k (q - q0)."""
        i = self._model.joint_names.index(joint)
        if _NV[self._model.joint_types[i]] != 1:
            raise ValueError(f"joint springs need a 1-dof joint; {joint} is "
                             f"{self._model.joint_types[i]}")
        self._js.append((i, float(nominal), float(stiffness)))
        return self

    def add_door_hinge(self, joint: str, *, spring_zero_angle: float = 0.0,
                       spring_constant: float = 1.5, dynamic_friction_torque: float = 3.0,
                       static_friction_torque: float = 2.0, viscous_friction: float = 1.0,
                       catch_width: float = 0.02, catch_torque: float = 15.0,
                       motion_threshold: float = 0.001) -> "ForceElementBuilder":
        """DoorHinge (the reference's dishwasher-door defaults): a torsional
        spring, a tanh-doublet catch near closed, and dynamic, static and
        viscous friction smoothed by tanh curves at the motion threshold."""
        i = self._model.joint_names.index(joint)
        if self._model.joint_types[i] != REVOLUTE:
            raise ValueError(f"door hinges need a revolute joint; {joint} "
                             f"is {self._model.joint_types[i]}")
        if catch_width <= 0 or motion_threshold <= 0:
            raise ValueError("catch_width and motion_threshold must be > 0")
        self._dh.append((i, np.asarray([spring_zero_angle, spring_constant,
                                        dynamic_friction_torque, static_friction_torque,
                                        viscous_friction, catch_width, catch_torque,
                                        motion_threshold], np.float64)))
        return self

    def add_bushing(self, body_a: str, body_c: str, *, X_AF_rpy=(0, 0, 0), X_AF_xyz=(0, 0, 0),
                    X_CM_rpy=(0, 0, 0), X_CM_xyz=(0, 0, 0), torque_stiffness=(0, 0, 0),
                    torque_damping=(0, 0, 0), force_stiffness=(0, 0, 0),
                    force_damping=(0, 0, 0)) -> "ForceElementBuilder":
        self._bu.append((
            self._model.body_index(body_a), self._model.body_index(body_c),
            _rpy_rotation(X_AF_rpy), np.asarray(X_AF_xyz, np.float64),
            _rpy_rotation(X_CM_rpy), np.asarray(X_CM_xyz, np.float64),
            np.concatenate([np.asarray(torque_stiffness, np.float64),
                            np.asarray(force_stiffness, np.float64)]),
            np.concatenate([np.asarray(torque_damping, np.float64),
                            np.asarray(force_damping, np.float64)]),
        ))
        return self

    def build(self, dtype=torch.float32, device=None):
        """(ForceElementSet, ForceElementParams on `device`; None: the
        current CUDA device, an error without one)."""
        device = resolve_device(device)
        fe = ForceElementSet(
            spring_bodies=tuple((a, b) for a, b, *_ in self._sd),
            joint_spring_joints=tuple(i for i, _, _ in self._js),
            bushing_bodies=tuple((a, c) for a, c, *_ in self._bu),
            door_hinge_joints=tuple(i for i, _ in self._dh),
        )

        def stack(rows, shape):
            values = np.stack(rows) if rows else np.zeros((0,) + shape)
            return torch.tensor(values, dtype=dtype, device=device)

        params = ForceElementParams(
            sd_p_AP=stack([r[2] for r in self._sd], (3,)),
            sd_p_BQ=stack([r[3] for r in self._sd], (3,)),
            sd_free_length=stack([r[4] for r in self._sd], ()),
            sd_stiffness=stack([r[5] for r in self._sd], ()),
            sd_damping=stack([r[6] for r in self._sd], ()),
            js_stiffness=stack([r[2] for r in self._js], ()),
            js_nominal=stack([r[1] for r in self._js], ()),
            bu_X_AF_R=stack([r[2] for r in self._bu], (3, 3)),
            bu_X_AF_p=stack([r[3] for r in self._bu], (3,)),
            bu_X_CM_R=stack([r[4] for r in self._bu], (3, 3)),
            bu_X_CM_p=stack([r[5] for r in self._bu], (3,)),
            bu_k=stack([r[6] for r in self._bu], (6,)),
            bu_d=stack([r[7] for r in self._bu], (6,)),
            dh_cfg=stack([cfg for _, cfg in self._dh], (8,)),
        )
        return fe, params


def _eps(q):
    return 1e-7 if q.dtype == torch.float32 else 1e-12


def _mv(R, x):
    return (R @ x.unsqueeze(-1)).squeeze(-1)


def _frame(R_WB, p_WB, body, R_BF, p_BF):
    """World pose (R_WF, p_WF) of a frame fixed on `body`."""
    R = R_WB[..., body, :, :]
    return R @ R_BF, p_WB[..., body, :] + _mv(R, p_BF)


def _rpy_rate_matrix(rpy):
    """E (..., 3, 3) with w_parent = E rpy_dot (the roll-pitch-yaw rates of
    R = Rz(y) Ry(p) Rx(r) to the angular velocity in the parent frame)."""
    cols = [rot.rpy_rates_to_angular_velocity_in_parent(rpy, e.expand_as(rpy))
            for e in torch.eye(3, dtype=rpy.dtype, device=rpy.device)]
    return torch.stack(cols, dim=-1)


def _bushing_deflection(R_WF, p_WF, R_WM, p_WM):
    """x = [rpy(R_FM); p_FM_F] (..., 6)."""
    return torch.cat([rot.rotation_to_rpy(R_WF.mT @ R_WM), _mv(R_WF.mT, p_WM - p_WF)], dim=-1)


def generalized_forces(model: MultibodyModel, params: MultibodyParams, fe: ForceElementSet,
                       fp: ForceElementParams, q, v):
    """Total generalized force (..., nv) of all force elements at (q, v):
    each contributes -J' f, J = d xdot / d v of its deflection x."""
    tau = torch.zeros_like(v)
    joints = kin.joint_transforms(model, params, q)
    if fe.spring_bodies or fe.bushing_bodies:
        R_WB, p_WB = kin.forward_kinematics(model, params, q, joints)
        J_W = kin.world_velocity_jacobians(model, params, q, joints)

    for e, (a, b) in enumerate(fe.spring_bodies):
        p_WP = p_WB[..., a, :] + _mv(R_WB[..., a, :, :], fp.sd_p_AP[e])
        p_WQ = p_WB[..., b, :] + _mv(R_WB[..., b, :, :], fp.sd_p_BQ[e])
        d = p_WQ - p_WP
        # The soft length sqrt(|d|^2 + eps^2): finite force and gradient at 0.
        length = torch.sqrt(torch.sum(d * d, dim=-1) + _eps(q) ** 2)
        J_l = ((d / length[..., None]).unsqueeze(-2)
               @ (kin.point_jacobian(J_W, p_WB, b, p_WQ) - kin.point_jacobian(J_W, p_WB, a, p_WP)))
        J_l = J_l.squeeze(-2)
        ldot = torch.sum(J_l * v, dim=-1)
        f = fp.sd_stiffness[e] * (length - fp.sd_free_length[e]) + fp.sd_damping[e] * ldot
        tau = tau - f[..., None] * J_l

    parts = []
    for e, i in enumerate(fe.joint_spring_joints):
        qo, vo = model.q_offsets[i], model.v_offsets[i]
        parts.append((vo, -fp.js_stiffness[e] * (q[..., qo] - fp.js_nominal[e])))

    for e, i in enumerate(fe.door_hinge_joints):
        qo, vo = model.q_offsets[i], model.v_offsets[i]
        q0, k_ts, k_df, k_sf, k_vf, w, k_c, vt = fp.dh_cfg[e].unbind(-1)
        angle, rate = q[..., qo], v[..., vo]
        s_v = torch.tanh(rate / vt)
        tau_f = -(k_df * s_v + k_sf * 2.0 * s_v * (1.0 - s_v * s_v) + k_vf * rate)
        c = w / 2.0
        s_q = torch.tanh((angle - c) / c)
        tau_s = k_c * 2.0 * s_q * (1.0 - s_q * s_q) - k_ts * (angle - q0)
        parts.append((vo, tau_f + tau_s))

    if parts:
        eye = torch.eye(model.num_velocities, dtype=v.dtype, device=v.device)
        for vo, t in parts:
            tau = tau + t[..., None] * eye[vo]

    for e, (a, c) in enumerate(fe.bushing_bodies):
        R_WF, p_WF = _frame(R_WB, p_WB, a, fp.bu_X_AF_R[e], fp.bu_X_AF_p[e])
        R_WM, p_WM = _frame(R_WB, p_WB, c, fp.bu_X_CM_R[e], fp.bu_X_CM_p[e])
        x = _bushing_deflection(R_WF, p_WF, R_WM, p_WM)
        # rpy_dot = E^-1 R_WF' (w_M - w_F); d/dt p_FM_F = R_WF' (v_Mo - v_Fo
        # - w_F x (p_WM - p_WF)).
        J_rpy = solve_matrix(_rpy_rate_matrix(x[..., :3]),
                             R_WF.mT @ (J_W[..., c, :3, :] - J_W[..., a, :3, :]))
        J_p = R_WF.mT @ (kin.point_jacobian(J_W, p_WB, c, p_WM) - kin.point_jacobian(J_W, p_WB, a, p_WF)
                         + rot.hat(p_WM - p_WF) @ J_W[..., a, :3, :])
        J_x = torch.cat([J_rpy, J_p], dim=-2)
        xdot = _mv(J_x, v)
        f = fp.bu_k[e] * x + fp.bu_d[e] * xdot
        tau = tau - (J_x.mT @ f.unsqueeze(-1)).squeeze(-1)
    return tau


def spring_potential_energy(model: MultibodyModel, params: MultibodyParams, fe: ForceElementSet,
                            fp: ForceElementParams, q):
    """Elastic energy (...,) of all force elements (damping stores none)."""
    U = torch.zeros_like(q[..., 0])
    if fe.spring_bodies or fe.bushing_bodies:
        R_WB, p_WB = kin.forward_kinematics(model, params, q)
    for e, (a, b) in enumerate(fe.spring_bodies):
        p_WP = p_WB[..., a, :] + _mv(R_WB[..., a, :, :], fp.sd_p_AP[e])
        p_WQ = p_WB[..., b, :] + _mv(R_WB[..., b, :, :], fp.sd_p_BQ[e])
        d = p_WQ - p_WP
        stretch = torch.sqrt(torch.sum(d * d, dim=-1) + _eps(q) ** 2) - fp.sd_free_length[e]
        U = U + 0.5 * fp.sd_stiffness[e] * stretch**2
    for e, i in enumerate(fe.joint_spring_joints):
        dq = q[..., model.q_offsets[i]] - fp.js_nominal[e]
        U = U + 0.5 * fp.js_stiffness[e] * dq**2
    for e, i in enumerate(fe.door_hinge_joints):
        q0, k_ts, w, k_c = fp.dh_cfg[e, 0], fp.dh_cfg[e, 1], fp.dh_cfg[e, 5], fp.dh_cfg[e, 6]
        angle = q[..., model.q_offsets[i]]
        c = w / 2.0
        # The catch doublet's integral is -k_c c tanh((q - c) / c)^2.
        U = U + 0.5 * k_ts * (angle - q0) ** 2 - k_c * c * torch.tanh((angle - c) / c) ** 2
    for e, (a, c) in enumerate(fe.bushing_bodies):
        x = _bushing_deflection(*_frame(R_WB, p_WB, a, fp.bu_X_AF_R[e], fp.bu_X_AF_p[e]),
                                *_frame(R_WB, p_WB, c, fp.bu_X_CM_R[e], fp.bu_X_CM_p[e]))
        U = U + 0.5 * torch.sum(fp.bu_k[e] * x * x, dim=-1)
    return U
