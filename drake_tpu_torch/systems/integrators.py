"""Fixed-step integrators as pure step functions.

The PyTorch counterpart of ``drake_tpu/systems/integrators.py``.  Each
integrator is

    step(f, params, x, u, t, dt) -> x_next

where ``x`` and ``u`` carry the lanes of a batch in their leading dimensions
and ``f(params, x, u, t)`` maps them lane by lane.  The Butcher tableaus are
the reference's.  The Newton-solved implicit steps run the reference's fixed
iteration count as a Python loop; their Jacobian is taken in forward mode
lane by lane (``systems.base.lane_jacobian``), as the reference's
``jax.jacfwd`` on one lane.
"""

from __future__ import annotations

import torch

from drake_tpu_torch.systems.base import lane_jacobian
from drake_tpu_torch.utils.linalg import solve


def explicit_euler(f, params, x, u, t, dt):
    return x + dt * f(params, x, u, t)


def midpoint(f, params, x, u, t, dt):
    """Explicit midpoint = Drake's RungeKutta2Integrator."""
    k1 = f(params, x, u, t)
    return x + dt * f(params, x + 0.5 * dt * k1, u, t + 0.5 * dt)


rk2 = midpoint


def rk3(f, params, x, u, t, dt):
    """Kutta's third-order method (Drake RungeKutta3Integrator tableau)."""
    k1 = f(params, x, u, t)
    k2 = f(params, x + 0.5 * dt * k1, u, t + 0.5 * dt)
    k3 = f(params, x + dt * (-k1 + 2.0 * k2), u, t + dt)
    return x + dt * (k1 + 4.0 * k2 + k3) / 6.0


def rk4(f, params, x, u, t, dt):
    """Classic RK4."""
    k1 = f(params, x, u, t)
    k2 = f(params, x + 0.5 * dt * k1, u, t + 0.5 * dt)
    k3 = f(params, x + 0.5 * dt * k2, u, t + 0.5 * dt)
    k4 = f(params, x + dt * k3, u, t + dt)
    return x + dt * (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0


def bogacki_shampine3(f, params, x, u, t, dt):
    """Bogacki-Shampine 3(2); returns the 3rd-order solution."""
    k1 = f(params, x, u, t)
    k2 = f(params, x + 0.5 * dt * k1, u, t + 0.5 * dt)
    k3 = f(params, x + 0.75 * dt * k2, u, t + 0.75 * dt)
    return x + dt * (2.0 * k1 + 3.0 * k2 + 4.0 * k3) / 9.0


# Dormand-Prince 5(4) coefficients.
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)


def _dopri_stages(f, params, x, u, t, dt):
    ks = []
    for i in range(7):
        xi = x
        for j, a in enumerate(_DP_A[i]):
            xi = xi + dt * a * ks[j]
        ks.append(f(params, xi, u, t + _DP_C[i] * dt))
    return ks


def _combine(bs, ks):
    """sum(b k) over the nonzero weights, in the reference's order."""
    return sum(b * k for b, k in zip(bs, ks) if b != 0.0)


def rk5(f, params, x, u, t, dt):
    """Dormand-Prince 5th order (Drake RungeKutta5Integrator family)."""
    return x + dt * _combine(_DP_B5, _dopri_stages(f, params, x, u, t, dt))


def semi_explicit_euler(f, params, x, u, t, dt, num_q=None):
    """Symplectic Euler for x = [q; v]: v first, then q with the new v;
    explicit Euler when the q/v split is unknown."""
    if num_q is None:
        return explicit_euler(f, params, x, u, t, dt)
    xdot = f(params, x, u, t)
    v_next = x[..., num_q:] + dt * xdot[..., num_q:]
    x_mid = torch.cat([x[..., :num_q], v_next], dim=-1)
    qdot = f(params, x_mid, u, t)[..., :num_q]
    q_next = x[..., :num_q] + dt * qdot
    return torch.cat([q_next, v_next], dim=-1)


def _newton(residual, y0, newton_iters):
    """The reference's fixed-count full Newton on a lane-wise residual."""
    y = y0
    for _ in range(newton_iters):
        r = residual(y)
        J = lane_jacobian(residual, y)
        y = y - solve(J, r)
    return y


def implicit_euler(f, params, x, u, t, dt, newton_iters: int = 8):
    """Implicit Euler via full Newton on r(y) = y - x - dt f(y)."""

    def residual(y):
        return y - x - dt * f(params, y, u, t + dt)

    return _newton(residual, x + dt * f(params, x, u, t), newton_iters)


def implicit_trapezoid(f, params, x, u, t, dt, newton_iters: int = 8):
    """Implicit trapezoid rule (2nd order A-stable), Newton-solved."""
    f0 = f(params, x, u, t)

    def residual(y):
        return y - x - 0.5 * dt * (f0 + f(params, y, u, t + dt))

    return _newton(residual, x + dt * f0, newton_iters)


# Radau IIA 2-stage (order 3, L-stable) tableau.
_RADAU_A = ((5.0 / 12.0, -1.0 / 12.0), (3.0 / 4.0, 1.0 / 4.0))
_RADAU_B = (3.0 / 4.0, 1.0 / 4.0)
_RADAU_C = (1.0 / 3.0, 1.0)


def radau3(f, params, x, u, t, dt, newton_iters: int = 8):
    """2-stage Radau IIA (order 3, L-stable): Newton on the stacked stage
    derivatives K = (k1, k2), r_i = k_i - f(x + dt sum_j a_ij k_j)."""
    n = x.shape[-1]

    def residual(K):
        k1, k2 = K[..., :n], K[..., n:]
        x1 = x + dt * (_RADAU_A[0][0] * k1 + _RADAU_A[0][1] * k2)
        x2 = x + dt * (_RADAU_A[1][0] * k1 + _RADAU_A[1][1] * k2)
        r1 = k1 - f(params, x1, u, t + _RADAU_C[0] * dt)
        r2 = k2 - f(params, x2, u, t + _RADAU_C[1] * dt)
        return torch.cat([r1, r2], dim=-1)

    k0 = f(params, x, u, t)
    K = _newton(residual, torch.cat([k0, k0], dim=-1), newton_iters)
    return x + dt * (_RADAU_B[0] * K[..., :n] + _RADAU_B[1] * K[..., n:])


def radau1(f, params, x, u, t, dt, newton_iters: int = 8):
    """1-stage Radau IIA == implicit Euler."""
    return implicit_euler(f, params, x, u, t, dt, newton_iters)


def velocity_implicit_euler(f, params, x, u, t, dt, num_q: int, newton_iters: int = 8):
    """Implicit Euler implicit in the velocities only, for x = [q; v] with
    qdot = v: q+ = q + dt v+, v+ = v + dt a(q+, v+)."""
    q, v = x[..., :num_q], x[..., num_q:]

    def residual(v_next):
        x_next = torch.cat([q + dt * v_next, v_next], dim=-1)
        return v_next - v - dt * f(params, x_next, u, t + dt)[..., num_q:]

    v0 = v + dt * f(params, x, u, t)[..., num_q:]
    v_next = _newton(residual, v0, newton_iters)
    return torch.cat([q + dt * v_next, v_next], dim=-1)


_REGISTRY = {
    "explicit_euler": explicit_euler,
    "euler": explicit_euler,
    "rk2": rk2,
    "midpoint": midpoint,
    "rk3": rk3,
    "rk4": rk4,
    "rk5": rk5,
    "bogacki_shampine3": bogacki_shampine3,
    "semi_explicit_euler": semi_explicit_euler,
    "implicit_euler": implicit_euler,
    "implicit_trapezoid": implicit_trapezoid,
    "radau3": radau3,
    "radau1": radau1,
    "velocity_implicit_euler": velocity_implicit_euler,
}


def get(name: str):
    """Look up an integrator step function by name (SimulatorConfig-style)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown integrator '{name}'; available: {sorted(_REGISTRY)}") from None


def step_error_controlled(f, params, x, u, t, dt):
    """One Dormand-Prince 5(4) attempt: returns (x5, error_estimate)."""
    ks = _dopri_stages(f, params, x, u, t, dt)
    dx5 = _combine(_DP_B5, ks)
    dx4 = _combine(_DP_B4, ks)
    return x + dt * dx5, dt * (dx5 - dx4)
