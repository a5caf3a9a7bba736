"""Atlas-style humanoid drop: passive multibody dynamics under SAP contact.

The port of ``examples/atlas_drop.py`` (Drake's
examples/atlas/atlas_run_dynamics.cc): a procedural humanoid with the
Atlas topology's scale (a floating pelvis, torso and head, two legs with a
universal hip, knee and ankle, two arms with a universal shoulder and
elbow: 13 bodies and 4 massless universal bodies, 24 dofs) is dropped from
1.2 m onto the ground with 9 sphere pads, passive (no actuation).  Checks
(the reference's): the fall is ballistic at t = 0.2 s (within 2 mm), the
robot comes to rest (|v| < 0.05), and no pad sinks more than 2 mm.

Run:  python -m drake_tpu_torch.examples.atlas_drop [--cpu] [--steps N]
(float32 on the card by default; --cpu is float64 on the CPU).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

MU = 0.8
H, STEPS = 1e-3, 6000
BALLISTIC_TOL = 2e-3  # m, the pelvis at t = 0.2 s against free fall
DROP_Z = 1.2
# (body, pad centre in the body, radius)
PADS = (("pelvis", (0, 0, 0), 0.12), ("head", (0, 0, 0.1), 0.1),
        ("l_shin", (0, 0, 0), 0.06), ("r_shin", (0, 0, 0), 0.06),
        ("l_foot", (0.05, 0, -0.03), 0.05), ("r_foot", (0.05, 0, -0.03), 0.05),
        ("l_larm", (0, 0, -0.3), 0.05), ("r_larm", (0, 0, -0.3), 0.05),
        ("torso", (0, 0, 0.25), 0.15))
PAD_NAMES = ("pelvis_pad", "head_pad", "l_knee", "r_knee", "l_foot_pad", "r_foot_pad",
             "l_hand", "r_hand", "torso_pad")


def build(dtype=torch.float32, device=None):
    """(model, params, scene) of the humanoid over the ground."""
    from drake_tpu_torch.geometry import shapes as sh
    from drake_tpu_torch.geometry.scene import CollisionGeometry, CollisionScene
    from drake_tpu_torch.multibody.model import ModelBuilder

    b = ModelBuilder()
    ey = np.eye(3)
    b.add_body("pelvis", parent=None, joint_type="floating", mass=10.0, inertia_com=ey * 0.1)
    b.add_body("torso", parent="pelvis", joint_type="revolute", mass=20.0, axis=(0, 1, 0),
               com=(0, 0, 0.25), inertia_com=ey * 0.5, X_PJ_xyz=(0, 0, 0.1), damping=1.0)
    b.add_body("head", parent="torso", joint_type="revolute", mass=3.0, axis=(0, 1, 0),
               com=(0, 0, 0.1), inertia_com=ey * 0.02, X_PJ_xyz=(0, 0, 0.5), damping=0.5)
    for side, sy in (("l", 1.0), ("r", -1.0)):
        b.add_body(f"{side}_thigh", parent="pelvis", joint_type="universal", mass=6.0,
                   axis=(1, 0, 0), axis2=(0, 1, 0), com=(0, 0, -0.2), inertia_com=ey * 0.08,
                   X_PJ_xyz=(0, sy * 0.12, -0.05), damping=1.0)
        b.add_body(f"{side}_shin", parent=f"{side}_thigh", joint_type="revolute", mass=4.0,
                   axis=(0, 1, 0), com=(0, 0, -0.2), inertia_com=ey * 0.05,
                   X_PJ_xyz=(0, 0, -0.4), damping=1.0)
        b.add_body(f"{side}_foot", parent=f"{side}_shin", joint_type="revolute", mass=1.5,
                   axis=(0, 1, 0), com=(0.05, 0, -0.03), inertia_com=ey * 0.01,
                   X_PJ_xyz=(0, 0, -0.4), damping=0.5)
        b.add_body(f"{side}_uarm", parent="torso", joint_type="universal", mass=3.0,
                   axis=(1, 0, 0), axis2=(0, 1, 0), com=(0, 0, -0.15), inertia_com=ey * 0.03,
                   X_PJ_xyz=(0, sy * 0.25, 0.45), damping=1.0)
        b.add_body(f"{side}_larm", parent=f"{side}_uarm", joint_type="revolute", mass=2.0,
                   axis=(0, 1, 0), com=(0, 0, -0.15), inertia_com=ey * 0.02,
                   X_PJ_xyz=(0, 0, -0.3), damping=0.5)
    model, params = b.build(dtype, device)
    geoms = [CollisionGeometry(name=name, body=model.body_index(body), shape=sh.Sphere(r),
                               p_BG=np.asarray(p, float), friction=MU, stiffness=1e6,
                               dissipation=0.2)
             for name, (body, p, r) in zip(PAD_NAMES, PADS)]
    geoms.append(CollisionGeometry(name="ground", body=-1, shape=sh.HalfSpace(), friction=MU,
                                   stiffness=1e10, dissipation=0.2))
    return model, params, CollisionScene.build(geoms)


def initial_state(model, dtype, device):
    """The pelvis 1.2 m up, the knees bent 0.3 rad, the torso 0.2 rad."""
    x = model.default_state(torch.float64, "cpu")
    x[6] = DROP_Z
    for name, val in (("l_shin", 0.3), ("r_shin", 0.3), ("torso", 0.2)):
        x[model.q_offsets[model.body_index(name)]] = val
    return x.to(dtype=dtype, device=device)


def pad_clearance(model, params, q):
    """min over pads of (pad centre height - radius): (...,)."""
    from drake_tpu_torch.multibody.kinematics import forward_kinematics

    R_WB, p_WB = forward_kinematics(model, params, q)
    gaps = []
    for body, p, r in PADS:
        i = model.body_index(body)
        p_B = torch.tensor(p, dtype=q.dtype, device=q.device)
        gaps.append((p_WB[..., i, :] + (R_WB[..., i, :, :] @ p_B.unsqueeze(-1)).squeeze(-1))[
            ..., 2] - r)
    return torch.stack(gaps, dim=-1).amin(dim=-1)


def rollout(dtype, device, steps=STEPS):
    """(model, params, scene, the final state, the pelvis height a step,
    |v|^2 a step (numpy), the error of the pelvis height at step 200 (t =
    0.2 s, before the first touch) against free fall)."""
    from drake_tpu_torch.contact import plant as cplant
    from drake_tpu_torch.systems.simulator import simulate_discrete

    model, params, scene = build(dtype, device)
    nq = model.num_positions
    system = cplant.make_discrete_system(model, params, scene, H, actuated_joints=[])
    x0 = initial_state(model, dtype, device)
    with torch.no_grad():
        x, (pz, v2) = simulate_discrete(
            system, params, x0, None, steps=steps,
            record=lambda xx: (xx[..., 6], torch.sum(xx[..., nq:] ** 2, dim=-1)))
    pz, v2 = pz.double().cpu().numpy(), v2.double().cpu().numpy()
    t = (np.arange(steps) + 1) * H
    k = min(200, steps - 1)
    ball_err = float(abs(pz[k] - (DROP_Z - 0.5 * 9.81 * t[k] ** 2)))
    return model, params, scene, x, pz, v2, ball_err


def run(device=None, dtype=torch.float32, steps: int = STEPS, verbose: bool = True):
    """The demo: its readings (the final state, the pelvis height and |v|
    a step, ``ok``, the seconds)."""
    from drake_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    start = time.perf_counter()
    model, params, scene, x, pz, v2, ball_err = rollout(dtype, device, steps)
    seconds = time.perf_counter() - start
    nq = model.num_positions
    v_end = float(np.sqrt(v2[-1]))
    worst = float(pad_clearance(model, params, x[:nq]))
    out = {"x": x, "pz": pz, "v2": v2, "seconds": seconds, "ballistic_err": ball_err,
           "speed": v_end, "clearance": worst, "finite": bool(torch.isfinite(x).all())}
    out["ok"] = out["finite"] and ball_err < BALLISTIC_TOL and v_end < 0.05 and worst > -2e-3
    if verbose:
        print(f"humanoid: {model.num_bodies} bodies, {model.num_velocities} dofs, "
              f"{len(scene.pairs)} contact pairs")
        print(f"drop: pelvis {DROP_Z} m -> {pz[-1]:.3f} m; ballistic |err| at t=0.2s: "
              f"{ball_err:.1e} m; final |v| = {v_end:.2e}")
        print(f"settled: worst pad clearance = {worst * 1e3:.1f} mm (>= -2 mm contact layer); "
              f"{steps / seconds:.0f} steps/s ({steps / seconds * H:.2f}x realtime)")
        print("ATLAS DROP", "SUCCESS" if out["ok"] else "FAIL")
    return out


def smoke(depth, device, dtype=torch.float32):
    """The drop for `depth` steps (past the first touch, about step
    235): (the final state, the check that this depth reaches: the fall
    before it was ballistic)."""
    *_, x, _, _, ball_err = rollout(dtype, device, depth)
    return {"x": x}, {"ballistic": ball_err < BALLISTIC_TOL}


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
