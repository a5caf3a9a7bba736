"""MultibodyPlant's continuous dynamics: the articulated model as a
ContinuousSystem over x = [q; v].

The PyTorch counterpart of ``drake_tpu/multibody/plant.py``:

    qdot = N(q) v        (identity for 1-dof joints; quaternion kinematics
                          for floating bases)
    vdot = M(q)^-1 (B u + tau_ext - C(q, v))

over the lanes in the leading dimensions of ``x`` and ``u``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from drake_tpu_torch.math import rotations as rot
from drake_tpu_torch.multibody import dynamics as dyn
from drake_tpu_torch.multibody.model import (
    BALL,
    FLOATING,
    PLANAR,
    PRISMATIC,
    REVOLUTE,
    SCREW,
    MultibodyModel,
    MultibodyParams,
)
from drake_tpu_torch.systems.base import ContinuousSystem


def qdot_from_v(model: MultibodyModel, params: MultibodyParams, q, v):
    """Map generalized velocities to position derivatives: N(q) v."""
    parts = []
    for i, jt in enumerate(model.joint_types):
        qo = model.q_offsets[i]
        vo = model.v_offsets[i]
        if jt == FLOATING:
            quat = rot.quat_normalize(q[..., qo : qo + 4])
            R_JB = rot.quat_to_rotation(quat)
            parts += [rot.quat_derivative(quat, v[..., vo : vo + 3]),
                      (R_JB @ v[..., vo + 3 : vo + 6].unsqueeze(-1)).squeeze(-1)]
        elif jt == BALL:
            quat = rot.quat_normalize(q[..., qo : qo + 4])
            parts.append(rot.quat_derivative(quat, v[..., vo : vo + 3]))
        elif jt == PLANAR:
            # Child-frame rates rotated back into the joint frame for [xdot, ydot].
            th = q[..., qo + 2]
            c, s = torch.cos(th), torch.sin(th)
            vx, vy, wz = v[..., vo], v[..., vo + 1], v[..., vo + 2]
            parts.append(torch.stack([c * vx - s * vy, s * vx + c * vy, wz], dim=-1))
        elif jt in (REVOLUTE, PRISMATIC, SCREW):
            parts.append(v[..., vo : vo + 1])
    if not parts:
        return q.new_zeros(q.shape[:-1] + (0,))
    return torch.cat(parts, dim=-1)


def make_system(model: MultibodyModel, params: MultibodyParams,
                actuated_joints: Optional[Sequence[str]] = None,
                applied_forces=None) -> ContinuousSystem:
    """A ContinuousSystem with x = [q; v], u = the actuated joints' torques
    (by default every revolute and prismatic joint).

    ``applied_forces``: optional ``(params, q, v, t) -> tau (..., nv)``
    adding state-dependent generalized forces (the ForceElement hook)."""
    nq = model.num_positions
    nv = model.num_velocities
    if actuated_joints is None:
        act = [i for i, jt in enumerate(model.joint_types) if jt in (REVOLUTE, PRISMATIC)]
    else:
        act = [model.joint_names.index(n) for n in actuated_joints]
    nu = len(act)
    # tau = B u, B the (nv, nu) selection of the actuated dofs, made once here.
    B = torch.zeros((nv, nu), dtype=params.mass.dtype, device=params.mass.device)
    B[[model.v_offsets[i] for i in act], list(range(nu))] = 1.0

    def f(p: MultibodyParams, x, u, t=0.0):
        q, v = x[..., :nq], x[..., nq:]
        tau = u @ B.to(device=x.device, dtype=x.dtype).T
        if applied_forces is not None:
            tau = tau + applied_forces(p, q, v, t)
        vdot = dyn.forward_dynamics(model, p, q, v, tau)
        return torch.cat([qdot_from_v(model, p, q, v), vdot], dim=-1)

    return ContinuousSystem(f=f, num_states=nq + nv, num_inputs=nu, num_q=nq, num_v=nv,
                            default_params=params)
