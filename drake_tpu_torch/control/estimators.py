"""State estimators: the steady-state Kalman filter and the Luenberger
observer.

The PyTorch counterpart of ``drake_tpu/control/estimators.py`` (Drake's
systems/estimators/kalman_filter.h:38, SteadyStateKalmanFilter by CARE or
DARE, and luenberger_observer.h); matrices may carry lanes in their leading
dimensions.  The observer is an update function for a step loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from drake_tpu_torch.math.riccati import solve_care, solve_dare
from drake_tpu_torch.systems import integrators


class KalmanGains(NamedTuple):
    L: torch.Tensor  # observer gain
    P: torch.Tensor  # steady-state covariance


def steady_state_kalman_filter(A, C, W, V) -> KalmanGains:
    """Continuous steady-state filter: L = P C' V^-1 with P the stabilizing
    solution of A P + P A' - P C' V^-1 C P + W = 0 (the dual CARE)."""
    P = solve_care(A.mT, C.mT, W, V)
    return KalmanGains(L=P @ C.mT @ torch.linalg.inv(V), P=P)


def discrete_kalman_filter(A, C, W, V) -> KalmanGains:
    """Discrete steady-state filter: P = DARE(A', C', W, V),
    L = A P C' (C P C' + V)^-1."""
    P = solve_dare(A.mT, C.mT, W, V)
    return KalmanGains(L=A @ P @ C.mT @ torch.linalg.inv(C @ P @ C.mT + V), P=P)


def luenberger_observer(system, params, L, C, dt: float, method: str = "rk4"):
    """The observer xhat' = f(xhat, u) + L (y - C xhat), discretized by
    `method`.  Returns update(xhat, u, y, t) -> xhat at t + dt (Drake's
    LuenbergerObserver)."""
    step = integrators.get(method)

    def f_obs(p, xhat, uy, t):
        u, y = uy
        innovation = y - xhat @ C.mT
        return system.f(p, xhat, u, t) + innovation @ L.mT

    def update(xhat, u, y, t=0.0):
        return step(f_obs, params, xhat, (u, y), t, dt)

    return update
