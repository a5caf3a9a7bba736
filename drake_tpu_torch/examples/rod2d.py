"""Rod2D: the multi-modal contact rod through SAP instead of mode switching.

The port of ``examples/rod2d.py`` (Drake's examples/rod2d): a rod (a
capsule on a floating joint) launched tilted 30 degrees over a ground
halfspace visits ballistic flight, impact of its low end, sliding and
sticking rest, all through one discrete SAP plant (capsule-halfspace, 2
contacts) with no mode logic.  Checks (the reference's):

  1. the ballistic phase matches projectile motion (within 2 mm);
  2-3. the rod settles flat (< 1 deg), at rest (|v| < 5 cm/s), at ground
     height (CoM within 5 mm of the radius);
  4. with mu = 0.1 it slides more than 1.5x as far after impact as with
     mu = 0.8.

Run:  python -m drake_tpu_torch.examples.rod2d [--cpu] [--steps N]
(float32 on the card by default; --cpu is float64 on the CPU).
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

LEN, RAD, MASS = 1.0, 0.02, 1.0
G = 9.81
H, STEPS = 5e-4, 4000
BALLISTIC_TOL = 2e-3  # m, the flight's largest |z - the projectile's z|


def build(dtype=torch.float32, device=None, mu=0.8):
    """(model, params, scene) of the rod world."""
    from drake_tpu_torch.geometry import shapes as sh
    from drake_tpu_torch.geometry.scene import CollisionGeometry, CollisionScene
    from drake_tpu_torch.multibody.model import FLOATING, ModelBuilder

    b = ModelBuilder()
    ixx = MASS * LEN**2 / 12.0  # thin-rod inertia about the CoM (capsule axis z)
    b.add_body("rod", parent=None, joint_type=FLOATING, mass=MASS,
               inertia_com=np.diag([ixx, ixx, 0.5 * MASS * RAD**2]))
    model, params = b.build(dtype, device)
    geoms = [
        CollisionGeometry(name="rod", body=0, shape=sh.Capsule(RAD, LEN), friction=mu,
                          stiffness=1e6, dissipation=0.1),
        CollisionGeometry(name="ground", body=-1, shape=sh.HalfSpace(), friction=mu,
                          stiffness=1e10, dissipation=0.1),
    ]
    return model, params, CollisionScene.build(geoms)


def initial_state(model, dtype, device):
    """CoM at 0.5 m, the capsule axis 60 degrees off vertical, moving +x."""
    from drake_tpu_torch.math import rotations as rot

    tilt = math.pi / 2 - math.pi / 6
    axis = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float64)
    R = rot.axis_angle_to_rotation(axis, torch.tensor(tilt, dtype=torch.float64))
    x = model.default_state(torch.float64, "cpu")
    x[:4] = rot.rotation_to_quat(R)
    x[6] = 0.5
    x[10:13] = R.T @ torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64)
    return x.to(dtype=dtype, device=device)


def rollout(mu, dtype, device, steps=STEPS, x0=None):
    """(final state, CoM positions, world CoM velocities, world rod axes)
    of `steps` steps; the states are (..., 13)."""
    from drake_tpu_torch.contact import plant as cplant
    from drake_tpu_torch.math import rotations as rot
    from drake_tpu_torch.systems.simulator import simulate_discrete

    model, params, scene = build(dtype, device, mu)
    system = cplant.make_discrete_system(model, params, scene, H)
    x = initial_state(model, dtype, device) if x0 is None else x0

    def record(xx):
        R = rot.quat_to_rotation(xx[..., :4])
        v_W = (R @ xx[..., 10:13].unsqueeze(-1)).squeeze(-1)
        return xx[..., 4:7], v_W, R[..., :, 2]

    with torch.no_grad():
        return simulate_discrete(system, params, x, None, steps=steps, record=record)


def flight(ps, axes):
    """(the step of the first touch, whether it came, the largest |z - the
    projectile's z| before it) of CoM positions and rod axes (steps, 3)."""
    low_end_z = ps[:, 2] - np.abs(axes[:, 2]) * LEN / 2 - RAD
    touched = bool(np.any(low_end_z < 1e-4))
    k_touch = int(np.argmax(low_end_z < 1e-4)) if touched else len(ps) - 1
    n = max(k_touch - 5, 1)
    t = np.arange(1, n + 1) * H
    ball_err = float(np.max(np.abs(ps[:n, 2] - (0.5 - 0.5 * G * t**2))))
    return k_touch, touched, ball_err


def run(device=None, dtype=torch.float32, steps: int = STEPS, verbose: bool = True):
    """The demo: its readings (``ok`` only at the full depth, where the
    checks apply; the final states of both runs; the seconds)."""
    from drake_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    start = time.perf_counter()
    x_hi, (ps, vs, axes) = rollout(0.8, dtype, device, steps)
    x_lo, (ps_lo, _, _) = rollout(0.1, dtype, device, steps)
    ps, vs, axes, ps_lo = (a.double().cpu().numpy() for a in (ps, vs, axes, ps_lo))
    seconds = time.perf_counter() - start
    t = np.arange(1, len(ps) + 1) * H
    k_touch, touched, ball_err = flight(ps, axes)
    tilt_f = float(np.degrees(np.arcsin(min(1.0, abs(axes[-1, 2])))))
    z_f, v_f = float(ps[-1, 2]), float(np.linalg.norm(vs[-1]))
    dx_hi = float(ps[-1, 0] - ps[k_touch, 0])
    dx_lo = float(ps_lo[-1, 0] - ps_lo[k_touch, 0])
    out = {"x_hi": x_hi, "x_lo": x_lo, "seconds": seconds, "impact_step": k_touch + 1,
           "touched": touched, "ballistic_err": ball_err, "tilt_deg": tilt_f, "z": z_f,
           "speed": v_f, "dx_hi": dx_hi, "dx_lo": dx_lo,
           "finite": bool(torch.isfinite(x_hi).all() and torch.isfinite(x_lo).all())}
    out["ok"] = (out["finite"] and ball_err < BALLISTIC_TOL and tilt_f < 1.0
                 and abs(z_f - RAD) < 5e-3 and v_f < 5e-2 and dx_lo > 1.5 * dx_hi)
    if verbose:
        print(f"ballistic: impact at t={t[k_touch] * 1e3:.0f} ms, max |z - analytic| "
              f"pre-impact = {ball_err:.2e} m")
        print(f"settled:   tilt {tilt_f:.2f} deg, CoM height {z_f:.4f} m (rod radius {RAD}), "
              f"|v| {v_f:.2e} m/s")
        print(f"skid:      mu=0.8 slides {dx_hi:.3f} m after impact, mu=0.1 slides "
              f"{dx_lo:.3f} m; {2 * steps} steps in {seconds:.1f} s")
        print("ROD2D", "SUCCESS" if out["ok"] else "FAIL")
    return out


def smoke(depth, device, dtype=torch.float32):
    """Both rods for `depth` steps (past the impact, about step 434):
    (their final states, the checks that this depth reaches: the impact
    came, the flight before it was ballistic)."""
    x_hi, (ps, _, axes) = rollout(0.8, dtype, device, depth)
    x_lo, _ = rollout(0.1, dtype, device, depth)
    _, touched, err = flight(ps.double().cpu().numpy(), axes.double().cpu().numpy())
    return {"x_hi": x_hi, "x_lo": x_lo}, {"impact": touched, "ballistic": err < BALLISTIC_TOL}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="float64 on the CPU")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    out = run(device="cpu" if args.cpu else None,
              dtype=torch.float64 if args.cpu else torch.float32, steps=args.steps)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
