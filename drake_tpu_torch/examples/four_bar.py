"""Four-bar linkage: a kinematic loop closed two ways.

The port of ``examples/four_bar.py`` (Drake's
examples/multibody/four_bar/passive_simulation.cc): a crank-coupler-rocker
chain whose rocker tip is tied back to a world anchor, driven by a constant
crank torque, closed

  1. by a stiff ball bushing (force stiffness 3e4, damping 300: the
     reference's bushing-as-joint) through the continuous plant's force
     element hook, rk4 at 5e-4 s (``simulator.simulate``); and
  2. by a SAP ball constraint in the discrete plant at 2e-3 s.

Checks (the reference's): the crank turns at least once in both, and the
constraint holds the loop 10x tighter than the bushing and within 1 mm.

Run:  python -m drake_tpu_torch.examples.four_bar [--cpu] [--seconds T]
[--torque N_m] (float32 on the card by default; --cpu is float64 on the
CPU).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

L_CRANK, L_COUPLER, L_ROCKER = 1.0, 2.0, 1.0
ANCHOR = (2.0, 0.0, 0.0)
H, H_BUSHING = 2e-3, 5e-4
SECONDS, TORQUE = 4.0, 15.0


def build(dtype=torch.float32, device=None, with_anchor_body: bool = False):
    """(model, params) of the chain (with a welded "anchor" body first for
    the bushing's frame)."""
    from drake_tpu_torch.multibody.model import ModelBuilder

    b = ModelBuilder(gravity=(0.0, 0.0, -9.81))
    if with_anchor_body:
        b.add_body("anchor", parent=None, joint_type="weld", mass=0.0, X_PJ_xyz=ANCHOR)
    b.add_body("crank", parent=None, joint_type="revolute", mass=1.0, com=(0, 0, -L_CRANK / 2),
               inertia_com=np.diag([1 / 12, 1 / 12, 1e-3]), axis=(0, 1, 0))
    b.add_body("coupler", parent="crank", joint_type="revolute", mass=1.0,
               com=(L_COUPLER / 2, 0, 0),
               inertia_com=np.diag([1e-3, L_COUPLER**2 / 12, L_COUPLER**2 / 12]),
               axis=(0, 1, 0), X_PJ_xyz=(0, 0, -L_CRANK))
    b.add_body("rocker", parent="coupler", joint_type="revolute", mass=1.0,
               com=(0, 0, L_ROCKER / 2), inertia_com=np.diag([1 / 12, 1 / 12, 1e-3]),
               axis=(0, 1, 0), X_PJ_xyz=(L_COUPLER, 0, 0))
    return b.build(dtype, device)


def loop_errors(model, params, qs):
    """|rocker tip - anchor| (...,) at configurations qs (..., 3)."""
    from drake_tpu_torch.multibody import kinematics as kin

    rocker = model.body_index("rocker")
    R, p = kin.forward_kinematics(model, params, qs)
    tip = p[..., rocker, :] + R[..., rocker, :, 2] * L_ROCKER
    return torch.linalg.vector_norm(tip - torch.tensor(ANCHOR, dtype=qs.dtype,
                                                       device=qs.device), dim=-1)


def bushing_run(dtype, device, seconds=SECONDS, torque=TORQUE):
    """The bushing closure: (states (steps + 1, 6), loop errors)."""
    from drake_tpu_torch.multibody import force_elements as fel
    from drake_tpu_torch.multibody import plant as mplant
    from drake_tpu_torch.systems import simulator

    model, params = build(dtype, device, with_anchor_body=True)
    feb = fel.ForceElementBuilder(model)
    feb.add_bushing("anchor", "rocker", X_CM_xyz=(0.0, 0.0, L_ROCKER),
                    torque_stiffness=(0.0, 0.0, 0.0), torque_damping=(0.0, 0.0, 0.0),
                    force_stiffness=(30000.0,) * 3, force_damping=(300.0,) * 3)
    fe, fp = feb.build(dtype, device)
    system = mplant.make_system(model, params, applied_forces=lambda p, q, v, t:
                                fel.generalized_forces(model, p, fe, fp, q, v))
    steps = int(seconds / H_BUSHING)
    u = torch.zeros((steps, 3), dtype=dtype, device=device)
    u[:, 0] = torque
    x0 = torch.zeros(6, dtype=dtype, device=device)
    with torch.no_grad():
        xs, _ = simulator.simulate(system, params, x0, u, H_BUSHING)
        return xs, loop_errors(model, params, xs[:, :3])


def constraint_run(dtype, device, seconds=SECONDS, torque=TORQUE):
    """The SAP ball-constraint closure: (final state, states a step, loop
    errors)."""
    from drake_tpu_torch.contact import plant as cplant
    from drake_tpu_torch.geometry.scene import CollisionScene
    from drake_tpu_torch.systems.simulator import simulate_discrete

    model, params = build(dtype, device)
    system = cplant.make_discrete_system(
        model, params, CollisionScene.build([]), H,
        ball_constraints=[(model.body_index("rocker"), (0.0, 0.0, L_ROCKER), -1, ANCHOR)])
    u = torch.tensor([torque, 0.0, 0.0], dtype=dtype, device=device)
    with torch.no_grad():
        x, xs = simulate_discrete(system, params, torch.zeros(6, dtype=dtype, device=device), u,
                                  steps=int(seconds / H), record=lambda xx: xx)
        return x, xs, loop_errors(model, params, xs[:, :3])


def tight(bush_err, cons_err):
    """The constraint closure holds the loop to under 1 mm, 10x tighter
    than the bushing."""
    return cons_err * 10 <= bush_err and cons_err < 1e-3


def run(device=None, dtype=torch.float32, seconds=SECONDS, torque=TORQUE, verbose: bool = True):
    """The demo: its readings (both closures' states and loop errors,
    ``ok``, the seconds)."""
    from drake_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    start = time.perf_counter()
    xs_b, errs_b = bushing_run(dtype, device, seconds, torque)
    x_c, xs_c, errs_c = constraint_run(dtype, device, seconds, torque)
    seconds_wall = time.perf_counter() - start
    revs_b = float(xs_b[-1, 0]) / (2 * np.pi)
    revs_c = float(x_c[0]) / (2 * np.pi)
    bush_err, cons_err = float(errs_b.max()), float(errs_c.max())
    out = {"x_bushing": xs_b[-1], "x_constraint": x_c, "revs_bushing": revs_b,
           "revs_constraint": revs_c, "bushing_err": bush_err, "constraint_err": cons_err,
           "seconds": seconds_wall,
           "finite": bool(torch.isfinite(xs_b).all() and torch.isfinite(xs_c).all())}
    ok_spin = abs(revs_b) >= 1.0 and abs(revs_c) >= 1.0
    ok_tight = tight(bush_err, cons_err)
    out["ok"] = out["finite"] and ok_spin and ok_tight
    if verbose:
        print(f"   bushing: crank revolutions = {revs_b:+.2f}, max loop error = {bush_err:.2e} m")
        print(f"constraint: crank revolutions = {revs_c:+.2f}, max loop error = {cons_err:.2e} m")
        print(f"constraint closure is {bush_err / max(cons_err, 1e-300):.0f}x tighter than the "
              f"bushing; {seconds_wall:.1f} s")
        print("FOUR-BAR SUCCESS" if out["ok"] else "FOUR-BAR FAILED")
    return out


def smoke(depth, device, dtype=torch.float32):
    """Both closures for `depth` seconds (part of a crank turn): (the
    final states, the check that this depth reaches: the constraint's
    tightness; the full turn comes later)."""
    xs_b, errs_b = bushing_run(dtype, device, depth)
    x_c, _, errs_c = constraint_run(dtype, device, depth)
    return ({"x_bushing": xs_b[-1], "x_constraint": x_c},
            {"tight": tight(float(errs_b.max()), float(errs_c.max()))})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="float64 on the CPU")
    ap.add_argument("--seconds", type=float, default=SECONDS)
    ap.add_argument("--torque", type=float, default=TORQUE,
                    help="constant crank torque [N m] (the reference's applied_torque)")
    args = ap.parse_args(argv)
    out = run(device="cpu" if args.cpu else None,
              dtype=torch.float64 if args.cpu else torch.float32, seconds=args.seconds,
              torque=args.torque)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
