"""Rolling sphere: point contact against a hydroelastic patch.

The port of ``examples/rolling_sphere.py`` (Drake's
examples/multibody/rolling_sphere with --contact_model={point,
hydroelastic}): a ball settles on the ground, then is (a) launched sliding
and (b) spun about the vertical.  With a point contact the slide brakes to
the rolling speed 5/7 v0 and the spin never slows (no moment arm); with a
hydroelastic patch (quadrature rings over the contact cap) the distributed
friction decays the spin and a rolling resistance brings the ball towards
rest.  Checks (the reference's): point: final speed within 0.02 of 5/7
v0, slip < 1e-3, spin > 0.95 w0; hydro: speed < 0.2 v0, spin < 0.5 w0.

Run:  python -m drake_tpu_torch.examples.rolling_sphere [--cpu]
[--settle N] [--steps N] (float32 on the card by default; --cpu is float64
on the CPU).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

R = 0.1
E_MOD = 2e5
MU = 0.5
H, SETTLE, STEPS = 1e-3, 600, 1200
V0, W0 = 1.0, 10.0


def build(dtype=torch.float32, device=None, hydro: bool = False, rings: int = 3):
    """(model, params, scene) of the ball on the ground."""
    from drake_tpu_torch.geometry import shapes as sh
    from drake_tpu_torch.geometry.scene import CollisionGeometry, CollisionScene
    from drake_tpu_torch.multibody.model import FLOATING, ModelBuilder

    b = ModelBuilder()
    b.add_body("ball", parent=None, joint_type=FLOATING, mass=1.0,
               inertia_com=np.eye(3) * (0.4 * R**2))
    model, params = b.build(dtype, device)
    ball = dict(name="ball", body=0, shape=sh.Sphere(R), friction=MU, dissipation=0.1)
    if hydro:
        ball.update(hydroelastic_modulus=E_MOD, hydro_rings=rings)
    else:
        ball.update(stiffness=1e6)
    geoms = [CollisionGeometry(**ball),
             CollisionGeometry(name="ground", body=-1, shape=sh.HalfSpace(), friction=MU,
                               stiffness=1e10, dissipation=0.1)]
    return model, params, CollisionScene.build(geoms)


def rollouts(hydro: bool, dtype, device, settle=SETTLE, steps=STEPS):
    """(settled state, (x after the roll, vx, wy), (x after the spin, wz)),
    the speeds in the world frame a step."""
    from drake_tpu_torch.contact import plant as cplant
    from drake_tpu_torch.math import rotations as rot
    from drake_tpu_torch.systems.simulator import simulate_discrete

    model, params, scene = build(dtype, device, hydro)
    system = cplant.make_discrete_system(model, params, scene, H)

    def record(xx):
        Rw = rot.quat_to_rotation(xx[..., :4])
        v_W = (Rw @ xx[..., 10:13].unsqueeze(-1)).squeeze(-1)
        w_W = (Rw @ xx[..., 7:10].unsqueeze(-1)).squeeze(-1)
        return v_W[..., 0], w_W[..., 1], w_W[..., 2]

    def rollout(x, n, record=None):
        with torch.no_grad():
            return simulate_discrete(system, params, x, None, steps=n, record=record)

    x = model.default_state(dtype, device)
    x[6] = R
    x, _ = rollout(x, settle)
    x_roll = x.clone()
    x_roll[10] = V0
    x_roll, (vx, wy, _) = rollout(x_roll, steps, record)
    x_spin = x.clone()
    x_spin[9] = W0
    x_spin, (_, _, wz) = rollout(x_spin, steps, record)
    return x, (x_roll, vx, wy), (x_spin, wz)


def checks(vx, wy, wz, hydro: bool) -> bool:
    """The reference's checks of one contact model's speeds a step: a point
    rolls at 5/7 v0 without slip and keeps its spin; a patch slows both."""
    if hydro:
        return bool(vx[-1] < 0.2 * V0 and wz[-1] < 0.5 * W0)
    return bool(abs(vx[-1] - 5 * V0 / 7) < 0.02 and abs(vx[-1] - wy[-1] * R) < 1e-3
                and wz[-1] > 0.95 * W0)


def run(device=None, dtype=torch.float32, settle=SETTLE, steps=STEPS, verbose: bool = True):
    """The demo: its readings (the point and hydro runs' final states and
    speeds, ``ok``, the seconds)."""
    from drake_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    start = time.perf_counter()
    out = {}
    for tag, hydro in (("point", False), ("hydro", True)):
        x, (x_roll, vx, wy), (x_spin, wz) = rollouts(hydro, dtype, device, settle, steps)
        vx, wy, wz = (a.double().cpu().numpy() for a in (vx, wy, wz))
        out[tag] = {"x_settled": x, "x_roll": x_roll, "x_spin": x_spin, "vx": vx, "wy": wy,
                    "wz": wz, "finite": bool(torch.isfinite(x_roll).all()
                                             and torch.isfinite(x_spin).all())}
    out["seconds"] = time.perf_counter() - start
    p, h = out["point"], out["hydro"]
    slips = np.abs(p["vx"] - p["wy"] * R)
    onset = int(np.argmax(slips < 1e-4))
    point_ok, hydro_ok = checks(p["vx"], p["wy"], p["wz"], hydro=False), checks(
        h["vx"], h["wy"], h["wz"], hydro=True)
    out.update(point_ok=point_ok, hydro_ok=hydro_ok, roll_onset_step=onset + 1,
               finite=p["finite"] and h["finite"])
    out["ok"] = point_ok and hydro_ok and out["finite"]
    if verbose:
        print(f"[point]  slide->roll at t = {onset + 1} ms; rolling speed {p['vx'][-1]:.4f} m/s "
              f"(analytic 5/7 v0 = {5 * V0 / 7:.4f}); vertical spin {W0:.0f} -> "
              f"{p['wz'][-1]:.3f} rad/s (no torsional friction from a point)")
        print(f"[hydro]  rolling speed {h['vx'][min(200, steps - 1)]:.3f} (0.2 s) -> "
              f"{h['vx'][-1]:.4f} m/s (patch rolling resistance); vertical spin {W0:.0f} -> "
              f"{h['wz'][-1]:.3f} rad/s (patch torsional friction); {out['seconds']:.1f} s")
        print("ROLLING-SPHERE", "SUCCESS" if out["ok"] else "FAIL",
              f"(point_ok={point_ok}, hydro_ok={hydro_ok})")
    return out


def smoke(depth, device, dtype=torch.float32):
    """Both contact models at depth (settle, steps): the sphere settled
    and past its slide-to-roll (about step 58): (the final states, the
    checks that this depth reaches: the point's; the patch's decay runs
    past it)."""
    states, checks_ = {}, {}
    for tag, hydro in (("point", False), ("hydro", True)):
        _, (x_roll, vx, wy), (x_spin, wz) = rollouts(hydro, dtype, device, *depth)
        states.update({f"{tag} x_roll": x_roll, f"{tag} x_spin": x_spin})
        if not hydro:
            checks_["point"] = checks(*(a.double().cpu().numpy() for a in (vx, wy, wz)), False)
    return states, checks_


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="float64 on the CPU")
    ap.add_argument("--settle", type=int, default=SETTLE)
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    out = run(device="cpu" if args.cpu else None,
              dtype=torch.float64 if args.cpu else torch.float32, settle=args.settle,
              steps=args.steps)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
