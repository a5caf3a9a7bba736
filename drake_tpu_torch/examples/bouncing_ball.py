"""Bouncing ball: continuous compliant contact and dense output.

The port of ``examples/bouncing_ball.py``: a point-contact ball (a sphere on
a floating joint) dropped on a ground halfspace and integrated continuously
through ``contact.plant.make_continuous_contact_system`` (Hunt-Crossley
normal force, regularized friction): 15,000 rk4 steps of 1e-4 s
(``simulator.simulate``, one CUDA graph a step on the card), then the
dense output queried at 6,001 times for the rebound apexes.

Checks (the reference's): the apex ratio in (0.1, 0.95), and the
apex-to-apex time within 25% of the ballistic 2 sqrt(2 h / g).

Run:  python -m drake_tpu_torch.examples.bouncing_ball [--cpu]
(float32 on the card by default; --cpu is float64 on the CPU).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

RADIUS, MASS = 0.05, 0.1
DROP_H = 0.3
H = 1e-4
STEPS = 15000
QUERIES = 6001


def build(dtype=torch.float32, device=None):
    """(model, params, the continuous contact system) of the ball world."""
    from drake_tpu_torch.contact.plant import make_continuous_contact_system
    from drake_tpu_torch.geometry import shapes as sh
    from drake_tpu_torch.geometry.scene import CollisionGeometry, CollisionScene
    from drake_tpu_torch.multibody.model import FLOATING, ModelBuilder

    b = ModelBuilder()
    b.add_body("ball", parent=None, joint_type=FLOATING, mass=MASS,
               inertia_com=np.eye(3) * 0.4 * MASS * RADIUS**2)
    model, params = b.build(dtype, device)
    scene = CollisionScene.build([
        CollisionGeometry(name="ground", body=-1, shape=sh.HalfSpace(), friction=0.4,
                          stiffness=1e12),
        CollisionGeometry(name="ball", body=0, shape=sh.Sphere(RADIUS), friction=0.4,
                          stiffness=2e4, dissipation=0.3),
    ])
    return model, params, make_continuous_contact_system(model, params, scene)


def apexes_of(tq, z):
    """The rebound apexes (t, z) of a dense trace, as the reference finds
    them."""
    return [(float(tq[i]), float(z[i])) for i in range(1, len(z) - 1)
            if z[i] > z[i - 1] and z[i] >= z[i + 1] and z[i] > RADIUS + 0.01]


def run(device=None, dtype=torch.float32, steps: int = STEPS, queries: int = QUERIES,
        verbose: bool = True):
    """The demo: returns its readings (the apexes, the ratio, the flight
    time against the ballistic one, ``ok``, the seconds of the rollout)."""
    from drake_tpu_torch.math.trajectories import linspace
    from drake_tpu_torch.systems import simulator
    from drake_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    _, params, system = build(dtype, device)
    x0 = torch.tensor([1, 0, 0, 0, 0, 0, RADIUS + DROP_H] + [0] * 6, dtype=dtype, device=device)
    us = torch.zeros((steps, 0), dtype=dtype, device=device)
    start = time.perf_counter()
    with torch.no_grad():
        xs, ts = simulator.simulate(system, params, x0, us, H)
        traj = simulator.dense_output(system, params, xs, ts, us)
        tq = linspace(0.0, steps * H, queries, x0)
        z = traj.value(tq)[:, 6]
        tq, z = tq.cpu().numpy(), z.cpu().numpy()
    seconds = time.perf_counter() - start
    apexes = apexes_of(tq, z)
    out = {"apexes": apexes, "xs": xs, "z": z, "tq": tq, "seconds": seconds,
           "finite": bool(torch.isfinite(xs).all())}
    ok = len(apexes) >= 2 and out["finite"]
    if len(apexes) >= 2:
        h1, h2 = apexes[0][1] - RADIUS, apexes[1][1] - RADIUS
        out["ratio"] = h2 / h1
        out["t_flight"] = apexes[1][0] - apexes[0][0]
        out["t_ballistic"] = 2.0 * np.sqrt(2.0 * (h1 + h2) / 2 / 9.81)
        ok = (ok and 0.1 < out["ratio"] < 0.95
              and abs(out["t_flight"] - out["t_ballistic"]) < 0.25 * out["t_ballistic"])
    out["ok"] = ok
    if verbose:
        print(f"drop height {DROP_H:.3f} m; {len(apexes)} rebound apexes")
        for t, zz in apexes[:4]:
            print(f"  apex at t={t:.3f}s  height={zz - RADIUS:.4f} m")
        if "ratio" in out:
            print(f"apex energy ratio e^2 = {out['ratio']:.3f} (Hunt-Crossley dissipation)")
            print(f"apex-to-apex {out['t_flight']:.3f}s vs ballistic {out['t_ballistic']:.3f}s")
        print("BOUNCING BALL OK" if ok else "BOUNCING BALL FAILURE")
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
