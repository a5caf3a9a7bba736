"""Compass gait: passive dynamic walking down a slope (a hybrid limit cycle).

The port of ``examples/compass_gait.py`` (Drake's compass_gait.h: a
two-link passive walker with a heel-strike witness; defaults mass_hip 10,
mass_leg 5, length_leg 1, center_of_mass_leg 0.5, slope 0.0525), three
point masses in ramp coordinates (x down the slope, y the ramp normal,
angles from the ramp normal).  The impact conserves the whole walker's
angular momentum about the new contact and the trailing leg's about the
hip, two linear forms in qdot.

The reference derives both the dynamics and the impact map from the
Lagrangian by autodiff.  ``Walker.autodiff_dynamics`` and
``Walker.autodiff_heel_strike`` keep that construction (``torch.func``),
and the tests hold the rollout's forms to them: the rollout evaluates the
same derivatives in closed form (M(q) = [[m a^2 + (m_h + m) l^2, -m l b
cos(th1 - th2)], [., m b^2]], the gradient of the potential, the
momentum's derivative along qdot; the impact's linear map by its values
on the basis), since ``torch.func``'s derivatives of one evaluation trace
to 2,374 operations (``make_fx``) against 50 (tests/compass_gait_ops.py),
and every one is a kernel of the step that the card replays.

Checks (the reference's): at least 8 heel strikes, the post-impact
Poincare state settles (the last two within 0.05), and no impact adds
kinetic energy.

Run:  python -m drake_tpu_torch.examples.compass_gait [--cpu]
(float32 on the card by default; --cpu is float64 on the CPU).
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch
from torch.func import jacfwd, vmap

from drake_tpu_torch.utils.linalg import solve_spd_2x2

M_LEG, M_HIP, A, B = 5.0, 10.0, 0.5, 0.5
L = A + B
GAMMA = 0.0525
GRAV = 9.81
X0 = (0.0, 0.0, 0.4, -2.0)  # legs vertical, hip rolling forward, swing leg fast
T_FINAL, DT = 12.0, 2e-3


def _solve2(M, r):
    """The 2 x 2 solve M x = r by Cramer's rule."""
    det = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]
    return torch.stack([(r[0] * M[1, 1] - M[0, 1] * r[1]) / det,
                        (M[0, 0] * r[1] - M[1, 0] * r[0]) / det])


def _cross2(p, w):
    return p[..., 0] * w[..., 1] - p[..., 1] * w[..., 0]


class Walker:
    """The walker's model in a dtype on a device."""

    def __init__(self, dtype=torch.float32, device=None):
        from drake_tpu_torch.utils.device import resolve_device

        device = resolve_device(device)
        # gravity in ramp coordinates (x down the slope, y the ramp normal)
        self.g_ramp = torch.tensor([math.sin(GAMMA) * GRAV, -math.cos(GAMMA) * GRAV],
                                   dtype=dtype, device=device)
        self.masses = torch.tensor([M_LEG, M_HIP, M_LEG], dtype=dtype, device=device)

    @staticmethod
    def _u(th):
        return torch.stack([torch.sin(th), torch.cos(th)], dim=-1)

    @staticmethod
    def _du(th):
        return torch.stack([torch.cos(th), -torch.sin(th)], dim=-1)

    def mass_points(self, q):
        """The 3 point masses (stance leg, hip, swing leg) relative to the
        stance foot: (..., 3, 2)."""
        u1, u2 = self._u(q[..., 0]), self._u(q[..., 1])
        return torch.stack([A * u1, L * u1, L * u1 - B * u2], dim=-2)

    def velocities(self, q, qd):
        """The point masses' velocities (..., 3, 2)."""
        w1 = self._du(q[..., 0]) * qd[..., 0:1]
        w2 = self._du(q[..., 1]) * qd[..., 1:2]
        return torch.stack([A * w1, L * w1, L * w1 - B * w2], dim=-2)

    def kinetic(self, q, qd):
        v = self.velocities(q, qd)
        return 0.5 * torch.sum(self.masses[:, None] * v * v, dim=(-1, -2))

    # ---- closed forms of the Lagrangian's derivatives (the rollout's) -----
    def dynamics(self, params, x, u, t):
        """xdot (..., 4): M(q) qdd = dL/dq - (dp/dq) qd, p = M(q) qd."""
        th1, th2, th1d, th2d = x.unbind(-1)
        c12, s12 = torch.cos(th1 - th2), torch.sin(th1 - th2)
        mlb = M_LEG * L * B
        m11 = M_LEG * A**2 + (M_HIP + M_LEG) * L**2
        m12 = -mlb * c12
        m22 = M_LEG * B**2
        gx, gy = self.g_ramp.unbind(-1)
        # dL/dq: the kinetic energy's through cos(th1 - th2), the potential's
        # through the stance and swing legs' directions.
        dke = mlb * th1d * th2d * s12
        d1 = dke + (M_LEG * A + M_HIP * L + M_LEG * L) * (torch.cos(th1) * gx - torch.sin(th1) * gy)
        d2 = -dke - M_LEG * B * (torch.cos(th2) * gx - torch.sin(th2) * gy)
        # (dp/dq) qd = (dM/dth1 qd)(th1d - th2d), dM/dth1 = m l b s12 [[0, 1], [1, 0]].
        rel = th1d - th2d
        r1 = d1 - mlb * s12 * th2d * rel
        r2 = d2 - mlb * s12 * th1d * rel
        qdd1, qdd2 = solve_spd_2x2(m11, m12, m22, r1, r2)
        return torch.stack([th1d, th2d, qdd1, qdd2], dim=-1)

    def heel_strike(self, params, x, t):
        """The impact map: swap the legs, conserve the two angular momenta."""
        q, qd = x[..., :2], x[..., 2:]
        P = self.mass_points(q)
        v = self.velocities(q, qd)
        c = L * self._u(q[..., 0]) - L * self._u(q[..., 1])  # the new contact point
        m = self.masses[:, None]
        L1 = torch.sum(m[..., 0] * _cross2(P - c[..., None, :], v), dim=-1)
        L2 = M_LEG * _cross2(P[..., 0, :] - P[..., 1, :], v[..., 0, :])
        q_new = q.flip(-1)  # the labels swap (angles are absolute)
        Pn = self.mass_points(q_new)

        def post_momenta(qd_new):
            vn = self.velocities(q_new, qd_new)
            # the trailing leg is now the swing leg (mass 2) about the hip
            return (torch.sum(m[..., 0] * _cross2(Pn, vn), dim=-1),
                    M_LEG * _cross2(Pn[..., 2, :] - Pn[..., 1, :], vn[..., 2, :]))

        # The post-impact momenta are linear in qd_new: their columns are
        # their values on the basis.
        a11, a21 = post_momenta(torch.stack([torch.ones_like(L2), torch.zeros_like(L2)], -1))
        a12, a22 = post_momenta(torch.stack([torch.zeros_like(L2), torch.ones_like(L2)], -1))
        det = a11 * a22 - a12 * a21
        qd_new = torch.stack([(L1 * a22 - a12 * L2) / det, (a11 * L2 - a21 * L1) / det], dim=-1)
        return torch.cat([q_new, qd_new], dim=-1)

    # ---- the reference's construction, by autodiff (torch.func) -----------
    def _points_one(self, q):
        return self.mass_points(q)

    def lagrangian(self, q, qd):
        """L(q, qd) of one lane, the point masses' velocities by the
        Jacobian of their positions (as the reference)."""
        v = jacfwd(self._points_one)(q) @ qd
        ke = 0.5 * torch.sum(self.masses[:, None] * v * v)
        return ke + torch.sum(self.masses[:, None] * self.mass_points(q) * self.g_ramp[None, :])

    def _autodiff_dynamics_one(self, x):
        q, qd = x[:2], x[2:]
        p_of = jacfwd(self.lagrangian, argnums=1)  # the momentum dL/dqd
        M = jacfwd(lambda qd_: p_of(q, qd_))(qd)
        dLdq = jacfwd(self.lagrangian, argnums=0)(q, qd)
        dpdq = jacfwd(lambda q_: p_of(q_, qd))(q)
        return torch.cat([qd, _solve2(M, dLdq - dpdq @ qd)])

    def _autodiff_heel_strike_one(self, x):
        q, qd = x[:2], x[2:]
        P = self.mass_points(q)
        v = jacfwd(self._points_one)(q) @ qd
        c = L * self._u(q[0]) - L * self._u(q[1])
        L1 = torch.sum(torch.stack([self.masses[i] * _cross2(P[i] - c, v[i]) for i in range(3)]))
        L2 = M_LEG * _cross2(P[0] - P[1], v[0])
        q_new = torch.stack([q[1], q[0]])

        def post_momenta(qd_new):
            Pn = self.mass_points(q_new)
            vn = jacfwd(self._points_one)(q_new) @ qd_new
            L1n = torch.sum(torch.stack([self.masses[i] * _cross2(Pn[i], vn[i])
                                         for i in range(3)]))
            return torch.stack([L1n, M_LEG * _cross2(Pn[2] - Pn[1], vn[2])])

        A_post = jacfwd(post_momenta)(torch.zeros_like(qd))
        return torch.cat([q_new, _solve2(A_post, torch.stack([L1, L2]))])

    def autodiff_dynamics(self, params, x, u, t):
        """The dynamics from the Lagrangian by autodiff, lanes (..., 4)."""
        return vmap(self._autodiff_dynamics_one)(x.reshape(-1, 4)).reshape(x.shape)

    def autodiff_heel_strike(self, params, x, t):
        """The impact map by autodiff, lanes (..., 4)."""
        return vmap(self._autodiff_heel_strike_one)(x.reshape(-1, 4)).reshape(x.shape)

    def kinetic_energy(self, x):
        return self.kinetic(x[..., :2], x[..., 2:])

    @staticmethod
    def guard(params, x, t):
        """The swing toe's height above the ramp, disqualified until the
        inter-leg angle opens past 0.15 rad (the mid-stride scuff must not
        count, as the reference witness's disqualification)."""
        th1, th2 = x[..., 0], x[..., 1]
        y_sw = L * (torch.cos(th1) - torch.cos(th2))
        return torch.where((th1 - th2) > 0.15, y_sw, torch.ones_like(y_sw))

    def system(self):
        from drake_tpu_torch.systems.base import ContinuousSystem
        from drake_tpu_torch.systems.simulator import WitnessFunction

        return (ContinuousSystem(f=self.dynamics, num_states=4, num_inputs=0),
                WitnessFunction(g=self.guard, reset=self.heel_strike,
                                direction="positive_then_negative"))


def run(device=None, dtype=torch.float32, t_final=T_FINAL, dt=DT, verbose: bool = True):
    """The demo: returns its readings (strikes, the post-impact states, the
    Poincare contraction, the impacts' kinetic energy losses, ``ok``, the
    seconds of the rollout)."""
    from drake_tpu_torch.systems.simulator import simulate_hybrid

    walker = Walker(dtype, device)
    system, witness = walker.system()
    x0 = torch.tensor(X0, dtype=dtype, device=walker.masses.device)
    start = time.perf_counter()
    with torch.no_grad():
        xs, _, counts = simulate_hybrid(system, None, x0, t_final, dt, witnesses=(witness,))
        xs_host = xs.cpu().numpy()
    seconds = time.perf_counter() - start
    strikes = int(counts[0])
    swaps = np.where(np.abs(np.diff(xs_host[:, 0])) > 0.1)[0]
    post = xs_host[swaps + 1]
    out = {"strikes": strikes, "post": post, "xs": xs_host, "seconds": seconds}
    ok = strikes >= 8 and len(post) >= 2
    if len(post) >= 2:
        out["d_last"] = float(np.linalg.norm(post[-1] - post[-2]))
        out["d_first"] = float(np.linalg.norm(post[1] - post[0]) + 1e-12)
        with torch.no_grad():
            x_pre = xs[swaps[-3:]]
            x_post = walker.heel_strike(None, x_pre, 0.0)
            ke = (walker.kinetic_energy(x_pre) - walker.kinetic_energy(x_post)).cpu().numpy()
        out["ke_loss"] = [float(e) for e in ke]
        ok = ok and out["d_last"] < 0.05 and all(e > -1e-9 for e in out["ke_loss"])
    out["ok"] = ok
    if verbose:
        print(f"heel strikes: {strikes} over {t_final}s")
        print("post-impact states (th1, th2, th1d, th2d):")
        for p in post[-4:]:
            print(f"  [{p[0]:+.4f} {p[1]:+.4f} {p[2]:+.4f} {p[3]:+.4f}]")
        if "d_last" in out:
            print(f"Poincare contraction: |dx| {out['d_first']:.2e} -> {out['d_last']:.2e}")
            print(f"impact KE losses: {[f'{e:.3f}' for e in out['ke_loss']]} J")
        print(f"COMPASS GAIT OK: passive limit cycle at slope {GAMMA:.4f} rad, {strikes} steps"
              if ok else "COMPASS GAIT FAILURE")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="float64 on the CPU")
    args = ap.parse_args(argv)
    out = run(device="cpu" if args.cpu else None,
              dtype=torch.float64 if args.cpu else torch.float32)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
