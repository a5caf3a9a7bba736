"""Simple gripper: grip against slip of a shaken parallel-jaw grasp.

The port of ``examples/simple_gripper.py`` (Drake's
examples/simple_gripper): a carriage on a vertical prismatic joint carries
two prismatic jaws tied symmetric by a SAP coupler (q_left = -q_right) that
squeeze a mug (a free box; box-box contacts) while a sine force shakes the
carriage.  The mug (0.1 kg) holds iff 2 mu F_grip >= m (g + a_shake): with
mu = 0.5, F = 4 N holds (drift < 2 mm), F = 0.3 N slips (> 2 cm).

Run:  python -m drake_tpu_torch.examples.simple_gripper [--cpu] [--steps N]
(float32 on the card by default; --cpu is float64 on the CPU).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

MU = 0.5
M_MUG = 0.1
G = 9.81
MUG_W = 0.06
PAD = (0.08, 0.02, 0.10)
H, STEPS = 1e-3, 3000
SHAKE_AMP, SHAKE_HZ = 4.0, 2.0
GRIPS = {"hold": 4.0, "weak": 0.3}
DRIFT_TOL, SLIP_MIN = 2e-3, 0.02  # m: the hold's largest drift, the weak grip's least slip


def build(dtype=torch.float32, device=None):
    """(model, params, scene) of the gripper and the mug."""
    from drake_tpu_torch.geometry import shapes as sh
    from drake_tpu_torch.geometry.scene import CollisionGeometry, CollisionScene
    from drake_tpu_torch.multibody.model import ModelBuilder

    b = ModelBuilder()
    b.add_body("carriage", parent=None, joint_type="prismatic", mass=0.8,
               inertia_com=np.eye(3) * 1e-3, axis=(0, 0, 1), joint_name="jz", damping=2.0)
    b.add_body("left_pad", parent="carriage", joint_type="prismatic", mass=0.1,
               inertia_com=np.eye(3) * 1e-4, axis=(0, 1, 0), joint_name="jl",
               X_PJ_xyz=(0, -0.08, 0), damping=0.5)
    b.add_body("right_pad", parent="carriage", joint_type="prismatic", mass=0.1,
               inertia_com=np.eye(3) * 1e-4, axis=(0, 1, 0), joint_name="jr",
               X_PJ_xyz=(0, 0.08, 0), damping=0.5)
    b.add_body("mug", parent=None, joint_type="floating", mass=M_MUG,
               inertia_com=np.eye(3) * 1e-4)
    model, params = b.build(dtype, device)
    geoms = [
        CollisionGeometry(name="lpad", body=model.body_index("left_pad"), shape=sh.Box(PAD),
                          friction=MU, stiffness=1e5),
        CollisionGeometry(name="rpad", body=model.body_index("right_pad"), shape=sh.Box(PAD),
                          friction=MU, stiffness=1e5),
        CollisionGeometry(name="mug", body=model.body_index("mug"),
                          shape=sh.Box((0.06, MUG_W, 0.08)), friction=MU, stiffness=1e5),
    ]
    return model, params, CollisionScene.build(geoms)


def inputs(f_grip, steps, dtype, device):
    """(steps, 2): the carriage's hold force plus the shake, and the squeeze
    on the left jaw (the coupler mirrors it onto the right)."""
    m_tot = 0.8 + 0.1 + 0.1 + M_MUG
    t = (np.arange(steps) + 1) * H
    fz = m_tot * G + SHAKE_AMP * np.sin(2 * np.pi * SHAKE_HZ * t)
    return torch.tensor(np.stack([fz, f_grip * np.ones(steps)], axis=1), dtype=dtype,
                        device=device)


def rollout(f_grip, dtype, device, steps=STEPS):
    """(final state, the mug's and the carriage's heights a step)."""
    from drake_tpu_torch.contact import plant as cplant
    from drake_tpu_torch.systems.simulator import simulate_discrete

    model, params, scene = build(dtype, device)
    system = cplant.make_discrete_system(model, params, scene, H, actuated_joints=["jz", "jl"],
                                         couplers=[("jl", "jr", -1.0, 0.0)])
    iq_mug = model.q_offsets[model.body_index("mug")]
    x = model.default_state(dtype, device)
    # The pads start at the mug's faces (pad centres at -+0.04).
    x[1], x[2] = 0.04, -0.04
    with torch.no_grad():
        return simulate_discrete(system, params, x, inputs(f_grip, steps, dtype, device),
                                 record=lambda xx: (xx[..., iq_mug + 6], xx[..., 0]))


def slide(rel, start: int = 200):
    """How far the mug slid down in the jaws from step `start` (the
    reference's 200: the shake under way) to the last, of its height over
    the carriage's a step."""
    k = min(start, len(rel) - 1)
    return float(rel[k] - rel[-1])


def run(device=None, dtype=torch.float32, steps: int = STEPS, verbose: bool = True):
    """The demo: its readings (both grips' final states, drift and slip,
    ``ok``, the seconds)."""
    from drake_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    start = time.perf_counter()
    out = {}
    for tag, f in GRIPS.items():
        x, (mug_z, car_z) = rollout(f, dtype, device, steps)
        out[tag] = {"x": x, "rel": (mug_z - car_z).double().cpu().numpy(),
                    "car_z": car_z.double().cpu().numpy(), "finite": bool(torch.isfinite(x).all())}
    out["seconds"] = time.perf_counter() - start
    drift, slip = abs(slide(out["hold"]["rel"])), slide(out["weak"]["rel"])
    out.update(drift=drift, slip=slip, finite=out["hold"]["finite"] and out["weak"]["finite"])
    out["ok"] = out["finite"] and drift < DRIFT_TOL and slip > SLIP_MIN
    if verbose:
        print(f"F_grip=4.0 N: carriage shaken +-{float(np.ptp(out['hold']['car_z'])) / 2:.3f} m, "
              f"mug-in-hand drift {drift * 1e3:.2f} mm (2muF=4.0 N >> load)")
        note = "falls free of the grasp" if slip > 0.1 else "slips in the jaws"
        print(f"F_grip=0.3 N: mug slides {min(slip, 0.1) * 1e3:.0f}+ mm down and {note} "
              f"(2muF=0.3 N < 1.47 N load); {out['seconds']:.1f} s")
        print("SIMPLE GRIPPER", "SUCCESS" if out["ok"] else "FAIL")
    return out


def smoke(depth, device, dtype=torch.float32):
    """Both grips for `depth` steps (past step 200, where the reference
    starts to read the slide): (the final states, both checks, read from
    step 200 to the last)."""
    states, rel = {}, {}
    for tag, f in GRIPS.items():
        states[tag], (mug_z, car_z) = rollout(f, dtype, device, depth)
        rel[tag] = (mug_z - car_z).double().cpu().numpy()
    return states, {"hold": abs(slide(rel["hold"])) < DRIFT_TOL,
                    "slip": slide(rel["weak"]) > SLIP_MIN}


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
