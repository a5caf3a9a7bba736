"""Discrete contact plant: the MultibodyPlant(time_step > 0) + SAP pipeline.

The PyTorch counterpart of ``drake_tpu/contact/plant.py``: one function

    x_{t+1} = step(params, x_t, u_t)

assembles the SAP problem at (q, v), solves it, and advances the positions
symplectically, q_{t+1} = q + h N(q) v_{t+1}, with quaternions advanced by the
exponential map (ball joints too; planar joints in their rotated frame).
``x`` and ``u`` carry the lanes of a batch in their leading dimensions.

The continuous-time plant with compliant point contact
(``contact_forces_continuous``, ``make_continuous_contact_system``) is here
too: Hunt-Crossley normal forces and regularized Coulomb friction on the
port's scene pairs, for fixed-step or error-controlled integration.
"""

from __future__ import annotations

import torch

from drake_tpu_torch.contact import sap
from drake_tpu_torch.geometry.scene import CollisionScene, contact_frame
from drake_tpu_torch.math import rotations as rot
from drake_tpu_torch.multibody import kinematics as kin
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
from drake_tpu_torch.systems.base import DiscreteSystem


def advance_positions(model: MultibodyModel, params, q, v, h):
    """q_next = q (+) h*v with the quaternion exponential for floating joints."""
    parts = []
    for i, jt in enumerate(model.joint_types):
        qo = model.q_offsets[i]
        vo = model.v_offsets[i]
        if jt == FLOATING:
            quat = rot.quat_normalize(q[..., qo : qo + 4])
            quat_next = rot.quat_integrate(quat, v[..., vo : vo + 3], h)
            R_JB = rot.quat_to_rotation(quat)
            v_B = v[..., vo + 3 : vo + 6]
            xyz_next = q[..., qo + 4 : qo + 7] + h * (R_JB @ v_B.unsqueeze(-1)).squeeze(-1)
            parts += [quat_next, xyz_next]
        elif jt == BALL:
            quat = rot.quat_normalize(q[..., qo : qo + 4])
            parts.append(rot.quat_integrate(quat, v[..., vo : vo + 3], h))
        elif jt == PLANAR:
            # Child-frame rates rotated into the joint frame at the old angle.
            th = q[..., qo + 2]
            c, s = torch.cos(th), torch.sin(th)
            vx, vy, wz = v[..., vo], v[..., vo + 1], v[..., vo + 2]
            parts.append(torch.stack([q[..., qo] + h * (c * vx - s * vy),
                                      q[..., qo + 1] + h * (s * vx + c * vy),
                                      th + h * wz], dim=-1))
        elif jt in (REVOLUTE, PRISMATIC, SCREW):
            parts.append(q[..., qo : qo + 1] + h * v[..., vo : vo + 1])
    return torch.cat(parts, dim=-1)


def make_discrete_system(
    model: MultibodyModel,
    params: MultibodyParams,
    scene: CollisionScene,
    time_step: float,
    actuated_joints=None,
    sap_params: sap.SapParameters = sap.SapParameters(),
    joint_limits=None,
    couplers=None,
    ball_constraints=None,
    distance_constraints=None,
    weld_constraints=None,
    pd_joints=None,
) -> DiscreteSystem:
    """Discrete plant with SAP contact; x = [q; v].

    u: the efforts of the actuated joints (by default every revolute and
    prismatic joint without a PD servo), then the desired positions of the
    ``pd_joints`` ((joint, Kp, Kd, effort_limit), ...: implicit
    effort-limited PD servos solved inside SAP).  ``joint_limits``,
    ``couplers`` and the ball, distance and weld constraints go to
    ``sap.assemble`` as they are."""
    nq = model.num_positions
    nv = model.num_velocities
    h = time_step
    pd_joints = tuple(pd_joints or ())
    pd_names = {spec[0] for spec in pd_joints}
    if actuated_joints is None:
        act = [i for i, jt in enumerate(model.joint_types)
               if jt in (REVOLUTE, PRISMATIC) and model.joint_names[i] not in pd_names]
    else:
        act = [model.joint_names.index(n) for n in actuated_joints]
    nu = len(act)
    npd = len(pd_joints)
    # tau = B u with B the (nv, nu) selection of the actuated dofs, made once
    # here: indexing with host lists inside g would copy them to the card on
    # every step.
    B = torch.zeros((nv, nu), dtype=params.mass.dtype, device=params.mass.device)
    for k, i in enumerate(act):
        B[model.v_offsets[i], k] += 1.0

    def g(p: MultibodyParams, x, u, t=0.0):
        q, v = x[..., :nq], x[..., nq:]
        tau = u[..., :nu] @ B.to(device=x.device, dtype=x.dtype).T
        pd = None
        if npd:
            zero = torch.zeros_like(u[..., nu : nu + npd])
            pd = (pd_joints, u[..., nu : nu + npd], zero, zero)
        data, _ = sap.assemble(model, p, scene, q, v, tau, h, sap_params,
                               joint_limits=joint_limits, couplers=couplers,
                               ball_constraints=ball_constraints,
                               distance_constraints=distance_constraints,
                               weld_constraints=weld_constraints, pd_controllers=pd)
        v_next = sap.solve_sap(data, data.v_star, sap_params).v
        return torch.cat([advance_positions(model, p, q, v_next, h), v_next], dim=-1)

    return DiscreteSystem(g=g, num_states=nq + nv, num_inputs=nu + npd, time_step=h,
                          default_params=params)


def step_with_forces(model, params, scene, q, v, tau, h, sap_params=sap.SapParameters()):
    """One SAP step returning (q_next, v_next, the SAP solution, the
    contact data), for inspection (the ContactResults-reporting role)."""
    data, contact = sap.assemble(model, params, scene, q, v, tau, h, sap_params)
    sol = sap.solve_sap(data, data.v_star, sap_params)
    return advance_positions(model, params, q, sol.v, h), sol.v, sol, contact


def contact_forces_continuous(model: MultibodyModel, params: MultibodyParams,
                              scene: CollisionScene, q, v, dissipation_hc: float = 1.0,
                              stiction_velocity: float = 1e-3):
    """Compliant point-contact generalized forces for the continuous plant
    (MultibodyPlant with time_step = 0, the point contact model): the
    Hunt-Crossley normal force f = k x (1 + d xdot)+ and regularized
    Coulomb friction, mapped by the contact Jacobian.  Returns tau_c
    (..., nv) to add to the applied generalized forces."""
    joints = kin.joint_transforms(model, params, q)
    poses = kin.forward_kinematics(model, params, q, joints)
    contact = scene.query(model, params, q, poses)
    nc = contact.phi.shape[-1]
    if nc == 0:
        return q.new_zeros(q.shape[:-1] + (model.num_velocities,))
    J = sap.make_contact_jacobian(model, params, q, contact, contact_frame(contact.n_W), joints,
                                  poses)
    vc = (J @ v[..., None, :, None]).squeeze(-1)  # (..., nc, 3) [vt1, vt2, vn]
    zero = torch.zeros_like(contact.phi)
    x = torch.maximum(-contact.phi, zero)  # penetration depth
    xdot = -vc[..., 2]  # penetration rate (vn separates)
    d = dissipation_hc * contact.dissipation
    fn = contact.stiffness * x * torch.maximum(1.0 + d * xdot, zero)
    vt = vc[..., :2]
    slip = torch.sqrt(torch.sum(vt**2, dim=-1) + stiction_velocity**2)
    ft = -contact.friction[..., None] * fn[..., None] * vt / slip[..., None]
    f_c = torch.cat([ft, fn[..., None]], dim=-1)  # (..., nc, 3) in the contact frames
    return torch.sum((J.mT @ f_c[..., None]).squeeze(-1), dim=-2)


def make_continuous_contact_system(model: MultibodyModel, params: MultibodyParams,
                                   scene: CollisionScene, actuated_joints=None,
                                   dissipation_hc: float = 1.0,
                                   stiction_velocity: float = 1e-3):
    """The continuous plant with compliant point contact, xdot = f(params,
    x, u) (the ContactModel-point continuous MultibodyPlant role)."""
    from drake_tpu_torch.multibody.plant import make_system

    def contact_tau(p, q, v, t):
        return contact_forces_continuous(model, p, scene, q, v, dissipation_hc=dissipation_hc,
                                         stiction_velocity=stiction_velocity)

    return make_system(model, params, actuated_joints=actuated_joints,
                       applied_forces=contact_tau)
