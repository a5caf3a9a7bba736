"""The LQR family: infinite horizon (CARE, DARE) and finite horizon.

The PyTorch counterpart of ``drake_tpu/control/lqr.py`` (Drake's
systems/controllers/linear_quadratic_regulator.h:43,72 and the overloads
that linearize a system, :103,148, and
finite_horizon_linear_quadratic_regulator.h:154).  Problems carry lanes in
their leading dimensions.  The finite-horizon Riccati flow is integrated
backward exactly on a uniform grid, one Hamiltonian matrix exponential a
step (``torch.linalg.matrix_exp``, every step's at once), as in the
reference; its ``lax.scan`` over the steps is a Python loop.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from drake_tpu_torch.math.riccati import solve_care, solve_dare, symmetrize
from drake_tpu_torch.systems.base import ContinuousSystem, lane_jacobian
from drake_tpu_torch.utils.linalg import solve, solve_matrix


def _mv(M, x):
    return (M @ x.unsqueeze(-1)).squeeze(-1)


@dataclasses.dataclass(frozen=True)
class LqrResult:
    K: torch.Tensor  # feedback gain (..., nu, nx)
    S: torch.Tensor  # cost to go, the Riccati solution (..., nx, nx)


def lqr(A, B, Q, R, N=None) -> LqrResult:
    """Continuous-time infinite-horizon LQR; with the cross term N, u = -R^-1
    N'x + v is substituted (linear_quadratic_regulator.cc:89)."""
    if N is not None:
        Rinv_Nt = solve_matrix(R, N.mT)
        S = solve_care(A - B @ Rinv_Nt, B, Q - N @ Rinv_Nt, R)
        K = solve_matrix(R, B.mT @ S + N.mT)
    else:
        S = solve_care(A, B, Q, R)
        K = solve_matrix(R.expand(S.shape[:-2] + R.shape[-2:]), B.mT @ S)
    return LqrResult(K=K, S=S)


def discrete_lqr(A, B, Q, R) -> LqrResult:
    """Discrete-time infinite-horizon LQR (DiscreteTimeLinearQuadraticRegulator)."""
    S = solve_dare(A, B, Q, R)
    return LqrResult(K=solve_matrix(R + B.mT @ S @ B, B.mT @ S @ A), S=S)


def lqr_for_system(system: ContinuousSystem, params, x0, u0, Q, R, N=None) -> LqrResult:
    """LQR of the system linearized about the fixed point (x0, u0); the
    closed loop is u = u0 - K (x - x0) (linear_quadratic_regulator.h:103)."""
    A, B = system.linearize(params, x0, u0)
    return lqr(A, B, Q, R, N)


@dataclasses.dataclass(frozen=True)
class FiniteHorizonLqrResult:
    """Gains on a uniform grid ts, index 0 at t0; lanes lead the others."""

    ts: torch.Tensor  # (N+1,)
    K: torch.Tensor  # (..., N+1, nu, nx)
    S: torch.Tensor  # (..., N+1, nx, nx)
    k0: torch.Tensor  # (..., N+1, nu) affine feedforward term
    sx: torch.Tensor  # (..., N+1, nx) linear cost-to-go term
    x0: torch.Tensor  # (..., N+1, nx) nominal state
    u0: torch.Tensor  # (..., N+1, nu) nominal input


def linspace(t0, tf, num_steps: int, like: torch.Tensor):
    """The reference's grid ``jnp.linspace(t0, tf, num_steps + 1)``, with
    the reassociation XLA makes of it: t0 (1 - i r) + (tf r) i with r =
    1/N, and tf itself last.  At t0 = 0 this is bit for bit the grid XLA
    computes on the CPU; ``torch.linspace`` rounds another way, and the
    policy's grid step ts[1] - ts[0] could then differ by an ulp, enough to
    move the knot that a time on the grid picks."""
    i = torch.arange(num_steps, dtype=like.dtype, device=like.device)
    r = 1.0 / num_steps
    ts = t0 * (1 - i * r) + (tf * r) * i
    return torch.cat([ts, torch.full((1,), tf, dtype=like.dtype, device=like.device)])


def finite_horizon_lqr(system: ContinuousSystem, params, Q, R, t0: float, tf: float,
                       num_steps: int, x0_traj=None, u0_traj=None, Qf=None,
                       xd_traj=None) -> FiniteHorizonLqrResult:
    """Time-varying LQR about a nominal trajectory on the uniform grid of
    num_steps + 1 knots from t0 to tf.

    x0_traj, u0_traj: (..., N+1, nx), (..., N+1, nu), or one point (nx,),
    (nu,) held over the grid (zero when None).  Qf: the terminal cost on the
    state error (zero when None).  xd_traj: the desired state, the nominal
    when None, which gives the affine terms as Drake's
    FiniteHorizonLinearQuadraticRegulatorOptions xd does.

    The gains give u*(t) = u0(t) - K(t) (x - x0(t)) - k0(t).  The Riccati
    flow -Sdot = Q + A'S + SA - SB R^-1 B'S steps backward exactly with the
    frozen coefficients of each knot, [Xp; Yp] = expm(-dt H) [I; S], S_prev =
    Yp Xp^-1 (unconditionally stable), and the linear term -sxdot = (A -
    BK)' sx - Q (x0 - xd) by implicit Euler."""
    nx, nu = system.num_states, system.num_inputs
    dtype, device = Q.dtype, Q.device
    ts = linspace(t0, tf, num_steps, Q)
    dt = (tf - t0) / num_steps

    def expand(traj, n):
        if traj is None:
            return torch.zeros((num_steps + 1, n), dtype=dtype, device=device)
        traj = torch.as_tensor(traj, dtype=dtype, device=device)
        return traj.expand((num_steps + 1, n)) if traj.dim() == 1 else traj

    x0s, u0s = expand(x0_traj, nx), expand(u0_traj, nu)
    lead = torch.broadcast_shapes(x0s.shape[:-2], u0s.shape[:-2])
    x0s, u0s = x0s.expand(lead + x0s.shape[-2:]), u0s.expand(lead + u0s.shape[-2:])
    xds = x0s if xd_traj is None else expand(xd_traj, nx).expand(x0s.shape)
    Qf = torch.zeros((nx, nx), dtype=dtype, device=device) if Qf is None else Qf

    # The linearization at every (lane, knot) at once.
    with record_function("tvlqr.linearize"):
        tk = ts.expand(x0s.shape[:-1])
        As = lane_jacobian(lambda x: system.f(params, x, u0s, tk), x0s)
        Bs = lane_jacobian(lambda u: system.f(params, x0s, u, tk), u0s)
    Rinv = torch.linalg.inv(R)
    with record_function("tvlqr.expm"):
        G = Bs @ Rinv @ Bs.mT
        Qs = Q.expand(As.shape)
        H = torch.cat([torch.cat([As, -G], dim=-1), torch.cat([-Qs, -As.mT], dim=-1)], dim=-2)
        Phis = torch.linalg.matrix_exp(-dt * H)  # (..., N+1, 2nx, 2nx)

    Ss, sxs = _backward(Phis, As, Bs, Rinv, Q, Qf, x0s - xds, dt)
    RBt = Rinv @ Bs.mT
    return FiniteHorizonLqrResult(ts=ts, K=RBt @ Ss, S=Ss, k0=_mv(RBt, sxs), sx=sxs, x0=x0s,
                                  u0=u0s)


@record_function("tvlqr.backward")
def _backward(Phis, As, Bs, Rinv, Q, Qf, xd_errs, dt):
    """The backward sweep from S(tf) = Qf over the knots: (S, sx) at every
    knot, (..., N+1, nx, nx) and (..., N+1, nx)."""
    nx = As.shape[-1]
    lead = As.shape[:-3]
    eye = torch.eye(nx, dtype=As.dtype, device=As.device).expand(lead + (nx, nx))
    S = Qf.expand(lead + (nx, nx))
    sx = _mv(Qf, xd_errs[..., -1, :])
    Ss, sxs = [S], [sx]
    for k in range(As.shape[-3] - 1, 0, -1):
        Phi, A, B = Phis[..., k, :, :], As[..., k, :, :], Bs[..., k, :, :]
        XYp = Phi @ torch.cat([eye, S], dim=-2)
        Xp, Yp = XYp[..., :nx, :], XYp[..., nx:, :]
        S = symmetrize(solve_matrix(Xp.mT, Yp.mT).mT)  # Yp Xp^-1
        # In backward time the linear term's ODE is dsx/dtau = (A - BK)' sx
        # - Q xd_err; implicit Euler: (I - dt Acl') sx_prev = sx - dt Q xd_err.
        Acl = A - B @ (Rinv @ B.mT @ S)
        sx = solve(eye - dt * Acl.mT, sx - dt * _mv(Q, xd_errs[..., k, :]))
        Ss.append(S)
        sxs.append(sx)
    return torch.stack(Ss[::-1], dim=-3), torch.stack(sxs[::-1], dim=-2)


def tvlqr_policy(res: FiniteHorizonLqrResult):
    """The closed-loop policy u(t, x), the gains held over each grid step.
    The knot is the reference's: (t - t0) / dt truncated toward zero and
    clipped to [0, N], with dt = ts[1] - ts[0]."""
    t0 = res.ts[0]
    dt = res.ts[1] - res.ts[0]
    n = res.ts.shape[0] - 1

    def policy(_, x, t):
        idx = torch.clamp(((t - t0) / dt).to(torch.int32), 0, n).reshape(1)

        def at(values, trailing):
            return values.index_select(-1 - trailing, idx).squeeze(-1 - trailing)

        return at(res.u0, 1) - _mv(at(res.K, 2), x - at(res.x0, 1)) - at(res.k0, 1)

    return policy
