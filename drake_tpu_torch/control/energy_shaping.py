"""Energy-shaping swing-up controllers.

The PyTorch counterpart of ``drake_tpu/control/energy_shaping.py``, written
without branches so that one policy drives a batch of lanes:

* ``pendulum_energy_shaping``: examples/pendulum/energy_shaping_simulation.cc
  (PendulumEnergyShapingController::CalcTau) cancels the damping and pumps
  the energy toward 1.1 m g l: tau = b thetadot + k thetadot (E_d - E).
* ``acrobot_spong_controller``: examples/acrobot/spong_controller.h
  (AcrobotSpongController::CalcControlTorque): collocated partial feedback
  linearization plus energy shaping far from the top, the LQR balancing law
  inside the ellipse (x - x0)'S(x - x0) < balancing_threshold, the torque
  saturated at +-20 N m.  The gains default to k_e = 5, k_p = 50, k_d = 5 and
  the threshold to 1e3 (spong_controller_params.h:59-62).

The controller switches with ``torch.where`` on the metric, as the reference
with ``jnp.where``.  Unlike the reference, which builds its upright state, Q
and R in the default dtype and linearizes at ``jnp.zeros((1,))``, the port
takes the parameters' dtype and device throughout.
"""

from __future__ import annotations

import math

import torch

from drake_tpu_torch.control.lqr import lqr
from drake_tpu_torch.models import acrobot as acrobot_model
from drake_tpu_torch.utils.linalg import solve_spd_2x2


def _wrap_to(x, lo, hi):
    """math::wrap_to: x wrapped into [lo, hi).  ``torch.remainder`` takes the
    divisor's sign, as ``jnp.mod`` does (``torch.fmod`` takes the dividend's)."""
    return lo + torch.remainder(x - lo, hi - lo)


def pendulum_energy_shaping(params, energy_gain: float = 0.1):
    """policy(x, t) -> u for the pendulum swing-up
    (energy_shaping_simulation.cc:34-58): the desired energy 1.1 m g l passes
    the upright with speed to spare."""
    m, g, length, b = params.mass, params.gravity, params.length, params.damping
    desired_energy = 1.1 * m * g * length

    def policy(x, t=0.0):
        theta, thetadot = x[..., 0], x[..., 1]
        current_energy = 0.5 * m * (length * thetadot) ** 2 - m * g * length * torch.cos(theta)
        tau = b * thetadot + energy_gain * thetadot * (desired_energy - current_energy)
        return tau[..., None]

    return policy


def acrobot_spong_controller(params=None, k_e=5.0, k_p=50.0, k_d=5.0,
                             balancing_threshold: float = 1e3, torque_limit: float = 20.0):
    """policy(x, t) -> u: Spong's swing-up and the LQR balance for the
    acrobot (spong_controller.h:88-168).

    * LQR about the upright with Q = diag(10, 10, 1, 1), R = [1] (ibid:64-68)
      gives (K, S); where the wrapped state's (x - x0)'S(x - x0) is below the
      threshold the balancing law u = K (x0 - x) acts.
    * Elsewhere energy shaping u_e = -k_e (E - E_d) q2dot with E_d = (m1 lc1 +
      m2 (l1 + lc2)) g (ibid:152-155), plus collocated PFL u_p = (a2 C0 +
      y) / a3 + C1 with y = -k_p q2 - k_d q2dot (ibid:157-160).
    * Saturation at +-torque_limit (ibid:163-166).

    The gains may be floats or tensors that broadcast against the lanes (one
    gain triple a lane)."""
    p = params if params is not None else acrobot_model.default_params()
    like = p.m1
    x_up = torch.tensor([math.pi, 0.0, 0.0, 0.0], dtype=like.dtype, device=like.device)
    A, B = acrobot_model.make_system(p).linearize(p, x_up, like.new_zeros((1,)))
    Q = torch.diag(torch.tensor([10.0, 10.0, 1.0, 1.0], dtype=like.dtype, device=like.device))
    res = lqr(A, B, Q, torch.eye(1, dtype=like.dtype, device=like.device))
    K, S = res.K, res.S
    E_desired = (p.m1 * p.lc1 + p.m2 * (p.l1 + p.lc2)) * p.gravity

    def policy(x, t=0.0):
        two_pi = 2.0 * math.pi
        xw = torch.stack([_wrap_to(x[..., 0], 0.0, two_pi), _wrap_to(x[..., 1], -math.pi, math.pi),
                          x[..., 2], x[..., 3]], dim=-1)
        err = xw - x_up
        cost = torch.sum(err * (err @ S.mT), dim=-1)

        # The balancing branch.
        u_lqr = -(err @ K.mT)[..., 0]

        # The swing-up branch: energy shaping and collocated PFL.  a2, a3 are
        # the second column of M^-1.
        q, v = x[..., :2], x[..., 2:]
        bias = acrobot_model.bias_term(p, q, v)
        m11, m12, m22 = acrobot_model.mass_entries(p, q)
        zero = torch.zeros_like(m11)
        a2, a3 = solve_spd_2x2(m11, m12, m22, zero, torch.ones_like(m11))
        E = acrobot_model.total_energy(p, x)
        u_e = -k_e * (E - E_desired) * v[..., 1]
        # The reference's deviation from spong_controller.h, kept: the PD
        # term takes theta2 wrapped, so that it never commands a full unwind
        # after swings of many turns; the gains were tuned for this form.
        y = -k_p * xw[..., 1] - k_d * v[..., 1]
        u_p = (a2 * bias[..., 0] + y) / a3 + bias[..., 1]

        u = torch.where(cost < balancing_threshold, u_lqr, u_e + u_p)
        return torch.clamp(u, -torque_limit, torque_limit)[..., None]

    return policy
