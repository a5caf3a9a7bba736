"""Planar gripper: two fingers reorient a brick through contact.

The port of ``examples/planar_gripper.py`` (Drake's
examples/planar_gripper): two 2-link fingers with spherical tips, in the
horizontal plane, driven by SAP's effort-limited implicit PD servos along
keyframes (reach, press a few mm into the brick's +y and -y faces, sweep
the tips in opposite directions, hold), rotate a brick on a planar joint
by the friction couple.  Checks (the reference's): the brick turns
clockwise by more than 0.15 rad with its centre within 4 cm.

Run:  python -m drake_tpu_torch.examples.planar_gripper [--cpu] [--steps N]
(float32 on the card by default; --cpu is float64 on the CPU).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

L1, L2 = 0.16, 0.16          # finger link lengths
TIP_R = 0.015                # fingertip sphere radius
BRICK = (0.10, 0.10, 0.04)   # brick box extents (x, y, z)
BASE_Y = 0.28                # finger shoulder bases at (0, +-BASE_Y)
MU = 1.0
PRESS = 0.005                # commanded press depth into the face
DRIFT_TOL = 0.04             # m, the brick centre's largest drift


def ik_2link(base_xy, target_xy, elbow_sign):
    """Planar 2-link IK (joints about world z, links along local +x)."""
    r = np.asarray(target_xy, float) - np.asarray(base_xy, float)
    d2 = float(r @ r)
    c2 = np.clip((d2 - L1**2 - L2**2) / (2 * L1 * L2), -1.0, 1.0)
    q2 = elbow_sign * np.arccos(c2)
    q1 = np.arctan2(r[1], r[0]) - np.arctan2(
        L2 * np.sin(q2), L1 + L2 * np.cos(q2)
    )
    return np.asarray([q1, q2])


def keyframe_trajectory(n, h):
    """Desired joint positions (n, 4): reach -> press -> sweep -> hold."""
    face = BRICK[1] / 2  # +-0.05 contact faces
    # (time_s, top tip target, bottom tip target)
    keys = [
        (0.00, (0.0, face + TIP_R + 0.03), (0.0, -face - TIP_R - 0.03)),
        (0.30, (0.0, face + TIP_R + 0.002), (0.0, -face - TIP_R - 0.002)),
        (0.60, (0.0, face + TIP_R - PRESS), (0.0, -face - TIP_R + PRESS)),
        (1.40, (0.05, face + TIP_R - PRESS), (-0.05, -face - TIP_R + PRESS)),
        (1.60, (0.05, face + TIP_R - PRESS), (-0.05, -face - TIP_R + PRESS)),
    ]
    q_keys = []
    for _, top, bot in keys:
        q_top = ik_2link((0.0, BASE_Y), top, elbow_sign=+1.0)
        q_bot = ik_2link((0.0, -BASE_Y), bot, elbow_sign=+1.0)
        q_keys.append(np.concatenate([q_top, q_bot]))
    q_keys = np.asarray(q_keys)
    times = np.asarray([k[0] for k in keys])
    t = (np.arange(n) + 1) * h
    out = np.empty((n, 4))
    for j in range(4):
        out[:, j] = np.interp(t, times, q_keys[:, j])
    return out


H, STEPS = 2e-3, 800
PD = (50.0, 5.0, 8.0)  # Kp, Kd, effort limit
FINGER_JOINTS = ("f0_shoulder", "f0_elbow", "f1_shoulder", "f1_elbow")


def build(dtype=torch.float32, device=None):
    """(model, params, scene) of the fingers and the brick."""
    from drake_tpu_torch.geometry import shapes as sh
    from drake_tpu_torch.geometry.scene import CollisionGeometry, CollisionScene
    from drake_tpu_torch.multibody.model import ModelBuilder

    b = ModelBuilder()
    rod1 = np.diag([1e-5, 1e-4, 1e-4])
    for fi, by in ((0, BASE_Y), (1, -BASE_Y)):
        b.add_body(f"f{fi}_link1", parent=None, joint_type="revolute", mass=0.05,
                   com=(L1 / 2, 0, 0), inertia_com=rod1, axis=(0, 0, 1),
                   joint_name=f"f{fi}_shoulder", X_PJ_xyz=(0.0, by, 0.0), damping=0.05)
        b.add_body(f"f{fi}_link2", parent=f"f{fi}_link1", joint_type="revolute", mass=0.05,
                   com=(L2 / 2, 0, 0), inertia_com=rod1, axis=(0, 0, 1),
                   joint_name=f"f{fi}_elbow", X_PJ_xyz=(L1, 0.0, 0.0), damping=0.05)
    b.add_body("brick", parent=None, joint_type="planar", mass=0.3,
               inertia_com=np.diag([5e-4, 5e-4, 5e-4]), joint_name="brick_planar")
    model, params = b.build(dtype, device)
    geoms = [CollisionGeometry(name=f"f{fi}_tip", body=model.body_index(f"f{fi}_link2"),
                               shape=sh.Sphere(TIP_R), p_BG=np.asarray([L2, 0.0, 0.0]),
                               friction=MU, stiffness=2e4) for fi in (0, 1)]
    geoms.append(CollisionGeometry(name="brick", body=model.body_index("brick"),
                                   shape=sh.Box(BRICK), friction=MU, stiffness=2e4))
    return model, params, CollisionScene.build(geoms)


def rollout(dtype, device, steps=STEPS):
    """(the final state, the brick's (x, y, theta) a step (numpy)) of the
    keyframed fingers' `steps` steps."""
    from drake_tpu_torch.contact import plant as cplant
    from drake_tpu_torch.systems.simulator import simulate_discrete

    model, params, scene = build(dtype, device)
    system = cplant.make_discrete_system(model, params, scene, H, actuated_joints=[],
                                         pd_joints=[(name, *PD) for name in FINGER_JOINTS])
    iq = model.q_offsets[model.body_index("brick")]
    q_des = torch.tensor(keyframe_trajectory(steps, H), dtype=dtype, device=device)
    x = model.default_state(dtype, device)
    x[0:4] = q_des[0]  # the fingers start at their first keyframe
    with torch.no_grad():
        x, brick = simulate_discrete(system, params, x, q_des,
                                     record=lambda xx: xx[..., iq : iq + 3])
    return x, brick.double().cpu().numpy()


def drift(brick):
    """How far the brick's centre moved in the plane, at the last step."""
    return float(np.hypot(brick[-1, 0], brick[-1, 1]))


def run(device=None, dtype=torch.float32, steps: int = STEPS, verbose: bool = True):
    """The demo: its readings (the final state, the brick's pose a step,
    ``ok``, the seconds)."""
    from drake_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    start = time.perf_counter()
    x, brick = rollout(dtype, device, steps)
    seconds = time.perf_counter() - start
    theta = float(brick[-1, 2])
    moved = drift(brick)
    out = {"x": x, "brick": brick, "theta": theta, "drift": moved, "seconds": seconds,
           "finite": bool(torch.isfinite(x).all())}
    out["ok"] = out["finite"] and theta < -0.15 and moved < DRIFT_TOL
    if verbose:
        print(f"brick rotation: {np.degrees(theta):+.1f} deg (target: clockwise/negative), "
              f"center drift {moved * 1e3:.1f} mm; {steps} steps in {seconds:.1f} s")
        print("PLANAR-GRIPPER", "SUCCESS" if out["ok"] else "FAILURE")
    return out


def smoke(depth, device, dtype=torch.float32):
    """The keyframes' first `depth` steps (through the fingers' press):
    (the final state, the check that this depth reaches: the brick held in
    place; its turn comes later)."""
    x, brick = rollout(dtype, device, depth)
    return {"x": x}, {"drift": drift(brick) < DRIFT_TOL}


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
