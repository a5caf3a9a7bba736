"""Classical controllers: PID, inverse dynamics, joint stiffness.

The PyTorch counterpart of ``drake_tpu/control/controllers.py`` (Drake's
pid_controller.h, inverse_dynamics_controller.h,
joint_stiffness_controller.h) as policy factories for
``simulator.simulate_controlled``: ``(state, x, t) -> u`` or ``(state, x,
t) -> (u, state)`` for integral action, over the lanes in the leading
dimensions of ``x``, on the port's ``multibody.dynamics``.  The gains are
made once, on the card unless ``device="cpu"`` is passed (or where given
tensors lie), and a policy computes in its state's type.
"""

from __future__ import annotations

from typing import Callable

from drake_tpu_torch.multibody import dynamics as dyn
from drake_tpu_torch.utils.device import tensors_on


def pid_controller(Kp, Ki, Kd, desired_state_fn: Callable, dt: float, device=None):
    """PID on (q_d - q, v_d - v), the integral carried as the policy state
    (policy_state = zeros(nq) with simulate_controlled).
    desired_state_fn(t) -> (q_d, v_d)."""
    Kp, Ki, Kd = tensors_on((Kp, Ki, Kd), device)
    nq = Kp.shape[0]

    def policy(integral, x, t):
        q, v = x[..., :nq], x[..., nq : 2 * nq]
        q_d, v_d = desired_state_fn(t)
        e = q_d - q
        return (Kp.to(x) * e + Kd.to(x) * (v_d - v) + Ki.to(x) * integral,
                integral + dt * e)

    return policy


def inverse_dynamics_controller(model, params, Kp, Ki, Kd, desired_fn: Callable, dt: float,
                                device=None):
    """Computed-torque control: tau = ID(q, v, vdot_des) with
    vdot_des = vdot_d + Kp e + Kd edot + Ki int(e).
    desired_fn(t) -> (q_d, v_d, vdot_d)."""
    Kp, Ki, Kd = tensors_on((Kp, Ki, Kd), device)
    nq = Kp.shape[0]

    def policy(integral, x, t):
        q, v = x[..., :nq], x[..., nq : 2 * nq]
        q_d, v_d, vd_d = desired_fn(t)
        e = q_d - q
        vdot_des = vd_d + Kp.to(x) * e + Kd.to(x) * (v_d - v) + Ki.to(x) * integral
        return dyn.inverse_dynamics(model, params, q, v, vdot_des), integral + dt * e

    return policy


def joint_stiffness_controller(model, params, Kp, Kd, q_desired, device=None):
    """Gravity-compensated joint stiffness: tau = g(q) + Kp (q_d - q) - Kd v."""
    Kp, Kd, q_desired = tensors_on((Kp, Kd, q_desired), device)
    nq = Kp.shape[0]
    nv = model.num_velocities

    def policy(_, x, t):
        q, v = x[..., :nq], x[..., nq:]
        tau_g = dyn.bias_forces(model, params, q, x.new_zeros(x.shape[:-1] + (nv,)))
        return tau_g + Kp.to(x) * (q_desired.to(x) - q) - Kd.to(x) * v

    return policy
