"""Allegro hand: a constant-load curl to the joint stops, then a PD grasp.

The port of ``examples/allegro_hand.py`` (Drake's
run_allegro_constant_load_demo.cc and the joint_control demo): a fixed palm
with 4 fingers x 3 revolute joints (12 dofs) and SAP joint-limit
constraints.  Phase 1: +0.3 N m on every joint settles each at its upper
limit at rest; -0.3 N m sends it to the lower one.  Phase 2: palm up under
a free ball (a floating body resting on the palm halfspace), the implicit
effort-limited SAP PD servos curl the fingers to their targets (0.9, 0.9,
0.7 rad a finger) and cage the ball.  Checks (the reference's): phase 1
within 5 mm rad of each limit and |v| < 1e-3; phase 2 the ball's height in
(0.03, 0.12) m, the fingers' mean angle > 0.4 rad, max |v| < 0.5.

``grasp_lanes`` runs phase 2 over many lanes of targets at once.

Run:  python -m drake_tpu_torch.examples.allegro_hand [--cpu]
[--load-steps N] [--grasp-steps N] (float32 on the card by default;
--cpu is float64 on the CPU).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

N_FINGERS, N_JOINTS = 4, 3
LINK = 0.045
Q_LO, Q_HI = -0.3, 1.6
H, LOAD_STEPS, GRASP_STEPS = 1e-3, 1500, 2500
TARGETS = (0.9, 0.9, 0.7)  # a finger's PD targets
PD_GAINS = (2.0, 0.1, 0.6)  # Kp, Kd, effort limit
BALL_Z0 = 0.036


def build(dtype=torch.float32, device=None, with_ball: bool = False):
    """(model, params, scene, the 12 joint names)."""
    from drake_tpu_torch.geometry import shapes as sh
    from drake_tpu_torch.geometry.scene import CollisionGeometry, CollisionScene
    from drake_tpu_torch.multibody.model import ModelBuilder

    b = ModelBuilder()
    ey = np.eye(3)
    joints = []
    for k in range(N_FINGERS):
        yaw = np.pi / 2 * k + np.pi / 4  # the finger's place about the palm edge
        px, py = 0.07 * np.cos(yaw), 0.07 * np.sin(yaw)
        parent = None
        for j in range(N_JOINTS):
            name, jn = f"f{k}_l{j}", f"f{k}_j{j}"
            b.add_body(name, parent=parent, joint_type="revolute", mass=0.03, axis=(0, -1, 0),
                       com=(LINK / 2, 0, 0), inertia_com=ey * 2e-5, joint_name=jn,
                       damping=0.02, X_PJ_xyz=(px, py, 0.0) if j == 0 else (LINK, 0, 0),
                       X_PJ_rpy=(0, 0, yaw) if j == 0 else (0, 0, 0))
            parent = name
            joints.append(jn)
    if with_ball:
        b.add_body("ball", parent=None, joint_type="floating", mass=0.05, inertia_com=ey * 8e-6)
    model, params = b.build(dtype, device)
    geoms = []
    if with_ball:
        for k in range(N_FINGERS):
            for j in range(1, N_JOINTS):
                geoms.append(CollisionGeometry(
                    name=f"f{k}_pad{j}", body=model.body_index(f"f{k}_l{j}"),
                    shape=sh.Sphere(0.012), p_BG=np.array([LINK, 0.0, 0.0]), friction=1.0,
                    stiffness=2e4, dissipation=0.2))
        geoms.append(CollisionGeometry(name="ball", body=model.body_index("ball"),
                                       shape=sh.Sphere(0.035), friction=1.0, stiffness=2e4,
                                       dissipation=0.2))
        geoms.append(CollisionGeometry(name="palm", body=-1, shape=sh.HalfSpace(), friction=1.0,
                                       stiffness=1e7, dissipation=0.2))
    return model, params, CollisionScene.build(geoms), joints


def at_stops(x_hi, x_lo):
    """(phase 1's check, max |q - q_hi|, max |q - q_lo|): every joint within
    5e-3 of its stop both ways, at rest after the + load."""
    n = N_FINGERS * N_JOINTS
    err_hi = float((x_hi[:n] - Q_HI).abs().max())
    err_lo = float((x_lo[:n] - Q_LO).abs().max())
    return err_hi < 5e-3 and err_lo < 5e-3 and float(x_hi[n:].abs().max()) < 1e-3, err_hi, err_lo


def grasp_checks(x):
    """Phase 2's checks of final states x (..., nq + nv), a bool tensor a
    lane each: "closed", the fingers' mean angle over 0.4 rad; "caged", the
    ball's centre between 0.03 and 0.12 m; "still", every speed under 0.5
    (the fingers close on the ball by about step 300 and come to rest
    later)."""
    n = N_FINGERS * N_JOINTS
    z = x[..., n + 6]  # the ball's q follows the 12 joints: quaternion, then xyz
    return {"closed": x[..., :n].mean(-1) > 0.4, "caged": (z > 0.03) & (z < 0.12),
            "still": x[..., n + 7 :].abs().amax(-1) < 0.5}


def limits(n, dtype, device):
    return (torch.full((n,), Q_LO, dtype=dtype, device=device),
            torch.full((n,), Q_HI, dtype=dtype, device=device))


def load_phase(dtype, device, steps=LOAD_STEPS):
    """Phase 1: (state after +0.3 N m, state after -0.3 N m from there)."""
    from drake_tpu_torch.contact import plant as cplant
    from drake_tpu_torch.systems.simulator import simulate_discrete

    model, params, scene, joints = build(dtype, device)
    n = len(joints)
    system = cplant.make_discrete_system(model, params, scene, H, actuated_joints=joints,
                                         joint_limits=limits(n, dtype, device))
    x0 = model.default_state(dtype, device)
    tau = torch.full((n,), 0.3, dtype=dtype, device=device)
    with torch.no_grad():
        x_hi, _ = simulate_discrete(system, params, x0, tau, steps=steps)
        x_lo, _ = simulate_discrete(system, params, x_hi, -tau, steps=steps)
    return x_hi, x_lo


def grasp_system(dtype, device):
    """(model, params, the PD grasp's discrete system)."""
    from drake_tpu_torch.contact import plant as cplant

    model, params, scene, joints = build(dtype, device, with_ball=True)
    pd = [(jn, *PD_GAINS) for jn in joints]
    system = cplant.make_discrete_system(model, params, scene, H, actuated_joints=[],
                                         joint_limits=limits(len(joints), dtype, device),
                                         pd_joints=pd)
    return model, params, system


def grasp_lanes(targets, steps=GRASP_STEPS, record_ball: bool = False):
    """Phase 2 over lanes: targets (..., 12) on the card or the CPU; returns
    (the final states (..., nq + nv), the ball's height a step or None)."""
    from drake_tpu_torch.systems.simulator import simulate_discrete

    model, params, system = grasp_system(targets.dtype, targets.device)
    iq_ball = model.q_offsets[model.body_index("ball")]
    x = model.default_state(targets.dtype, targets.device)
    x[iq_ball + 6] = BALL_Z0
    x = x.expand(targets.shape[:-1] + x.shape).clone()
    record = (lambda xx: xx[..., iq_ball + 6]) if record_ball else None
    with torch.no_grad():
        return simulate_discrete(system, params, x, targets, steps=steps, record=record)


def run(device=None, dtype=torch.float32, load_steps=LOAD_STEPS, grasp_steps=GRASP_STEPS,
        verbose: bool = True):
    """The demo: its readings (both phases' final states, the checks,
    ``ok``, the seconds)."""
    from drake_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    start = time.perf_counter()
    x_hi, x_lo = load_phase(dtype, device, load_steps)
    n = N_FINGERS * N_JOINTS
    ok1, err_hi, err_lo = at_stops(x_hi, x_lo)
    v_hi = x_hi[n:].double().cpu().numpy()
    targets = torch.tensor(np.tile(TARGETS, N_FINGERS), dtype=dtype, device=device)
    x_end, ball_z = grasp_lanes(targets, grasp_steps, record_ball=True)
    seconds = time.perf_counter() - start
    q_end = x_end[:n].double().cpu().numpy()
    lifted = float(ball_z[-1])
    v_max = float(x_end[n + 7 :].abs().max())  # nq = the 12 joints and the ball's 7
    ok2 = all(bool(c) for c in grasp_checks(x_end).values())
    out = {"x_hi": x_hi, "x_lo": x_lo, "x_grasp": x_end, "err_hi": err_hi, "err_lo": err_lo,
           "ball_z": lifted, "q_mean": float(q_end.mean()), "v_max": v_max,
           "load_ok": bool(ok1), "grasp_ok": bool(ok2), "seconds": seconds,
           "finite": bool(torch.isfinite(x_end).all() and torch.isfinite(x_lo).all())}
    out["ok"] = out["finite"] and out["load_ok"] and out["grasp_ok"]
    if verbose:
        print(f"constant +load: all 12 joints at upper stop, max |q - q_hi| = {err_hi:.2e} rad, "
              f"max |v| = {np.abs(v_hi).max():.2e}")
        print(f"constant -load: all 12 joints at lower stop, max |q - q_lo| = {err_lo:.2e} rad")
        print(f"PD grasp: fingers curl to {q_end.mean():.2f} rad mean (targets 0.9/0.9/0.7), "
              f"ball center z = {lifted:.3f} m (caged on the palm, started {BALL_Z0}); "
              f"{seconds:.1f} s")
        print("ALLEGRO HAND", "SUCCESS" if out["ok"] else
              f"FAIL (limits={ok1}, grasp={ok2})")
    return out


def smoke(depth, device, dtype=torch.float32):
    """Phase 1 for depth[0] steps each way and phase 2 for depth[1]
    (past the fingers' closing on the ball, about step 300): (the final
    states, the checks that this depth reaches: the load's stops, the
    grasp closed and caged; its rest comes later).  Phase 1 at rest at its
    stops takes about 200 steps each way."""
    x_hi, x_lo = load_phase(dtype, device, depth[0])
    targets = torch.tensor(np.tile(TARGETS, N_FINGERS), dtype=dtype, device=device)
    x, _ = grasp_lanes(targets, depth[1])
    grasp = grasp_checks(x)
    return ({"x_hi": x_hi, "x_lo": x_lo, "x_grasp": x},
            {"load": at_stops(x_hi, x_lo)[0], "closed": bool(grasp["closed"]),
             "caged": bool(grasp["caged"])})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="float64 on the CPU")
    ap.add_argument("--load-steps", type=int, default=LOAD_STEPS)
    ap.add_argument("--grasp-steps", type=int, default=GRASP_STEPS)
    args = ap.parse_args(argv)
    out = run(device="cpu" if args.cpu else None,
              dtype=torch.float64 if args.cpu else torch.float32, load_steps=args.load_steps,
              grasp_steps=args.grasp_steps)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
