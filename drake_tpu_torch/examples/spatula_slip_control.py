"""Spatula slip control: a torsional grasp needs hydroelastic patches.

The port of ``examples/spatula_slip_control.py`` (Drake's
examples/hydroelastic/spatula_slip_control): a floating spatula whose grip
knob (a compliant sphere) is pinched between two world-anchored box pads,
its blade's centre of mass offset so that gravity twists it about the
pinch axis.  A point contact resists that twist with no moment and the
spatula spins away; hydroelastic patches hold a strong pinch and let a
weak one slip.  Checks (the reference's): the point contact's rotation
more than 5x the strong hydro pinch's, that one under 0.1 rad, and the
weak pinch's more than 2x it.

Run:  python -m drake_tpu_torch.examples.spatula_slip_control [--cpu]
[--steps N] (float32 on the card by default; --cpu is float64 on the CPU).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

R_KNOB = 0.02  # grip knob radius [m]
MU = 1.0
M = 0.2  # spatula mass [kg]
D_COM = 0.08  # the blade's CoM offset along +y from the grip point [m]
H, STEPS = 5e-4, 2000
RUNS = {"point strong": (False, 0.004), "hydro strong": (True, 0.004),
        "hydro weak": (True, 0.0008)}


def build(dtype=torch.float32, device=None, hydro: bool = False, overlap: float = 0.004):
    """(model, params, scene) of the pinched spatula."""
    from drake_tpu_torch.geometry import shapes as sh
    from drake_tpu_torch.geometry.scene import CollisionGeometry, CollisionScene
    from drake_tpu_torch.multibody.model import ModelBuilder

    b = ModelBuilder()
    b.add_body("spatula", parent=None, joint_type="floating", mass=M, com=(0.0, D_COM, 0.0),
               inertia_com=np.eye(3) * 2e-4)
    model, params = b.build(dtype, device)
    knob = dict(name="knob", body=0, shape=sh.Sphere(R_KNOB), friction=MU, dissipation=0.2)
    if hydro:
        knob.update(hydroelastic_modulus=5e6, hydro_rings=3)
    else:
        knob.update(stiffness=5e7)
    gap = R_KNOB - overlap  # the pads' faces from the grip centre
    pads = [CollisionGeometry(name=f"pad_{side}", body=-1, shape=sh.Box((0.02, 0.08, 0.08)),
                              p_BG=np.array([s * (gap + 0.01), 0.0, 0.0]), friction=MU,
                              stiffness=1e10, dissipation=0.2)
            for side, s in (("minus", -1.0), ("plus", 1.0))]
    return model, params, CollisionScene.build([CollisionGeometry(**knob)] + pads)


def rollout(hydro, overlap, dtype, device, steps=STEPS):
    """(final state, the world rate about the pinch axis a step)."""
    from drake_tpu_torch.contact import plant as cplant
    from drake_tpu_torch.math import rotations as rot
    from drake_tpu_torch.systems.simulator import simulate_discrete

    model, params, scene = build(dtype, device, hydro, overlap)
    system = cplant.make_discrete_system(model, params, scene, H)

    def record(xx):
        Rw = rot.quat_to_rotation(xx[..., :4])
        return (Rw @ xx[..., 7:10].unsqueeze(-1)).squeeze(-1)[..., 0]

    with torch.no_grad():
        return simulate_discrete(system, params, model.default_state(dtype, device), None,
                                 steps=steps, record=record)


def rotation(wx):
    """|the rotation| about the pinch axis (rad) of its rates a step."""
    return float(abs(wx.double().sum()) * H)


def point_spins(rp, rh):
    """The point pinch lets the spatula turn 5x more than the patches."""
    return rp > 5.0 * max(rh, 1e-4)


def run(device=None, dtype=torch.float32, steps: int = STEPS, verbose: bool = True):
    """The demo: its readings (each run's final state, rotation and final
    rate, ``ok``, the seconds)."""
    from drake_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    start = time.perf_counter()
    out = {}
    for tag, (hydro, overlap) in RUNS.items():
        x, wx = rollout(hydro, overlap, dtype, device, steps)
        out[tag] = {"x": x, "rotation": rotation(wx), "rate": float(abs(wx[-1])),
                    "finite": bool(torch.isfinite(x).all())}
    out["seconds"] = time.perf_counter() - start
    rp, rh, rw = (out[k]["rotation"] for k in RUNS)
    out["finite"] = all(out[k]["finite"] for k in RUNS)
    out["ok"] = out["finite"] and point_spins(rp, rh) and rh < 0.1 and rw > 2.0 * rh
    if verbose:
        window = steps * H
        print(f"point contact, strong pinch: |rotation| {rp:.3f} rad over {window:.1f} s "
              f"(final |wx| {out['point strong']['rate']:.2f} rad/s)")
        print(f"hydro patches, strong pinch: |rotation| {rh:.4f} rad (final |wx| "
              f"{out['hydro strong']['rate']:.4f} rad/s) -- grasp holds")
        print(f"hydro patches, weak pinch:   |rotation| {rw:.3f} rad -- controlled slip regime; "
              f"{out['seconds']:.1f} s")
        print("SPATULA SLIP", "SUCCESS" if out["ok"] else "FAILURE")
    return out


def smoke(depth, device, dtype=torch.float32):
    """The three runs for `depth` steps (through the first twist): (the
    final states, the check that this depth reaches: the point pinch
    turns, the patches hold; the weak pinch's slip comes later)."""
    states, turned = {}, {}
    for tag, (hydro, overlap) in RUNS.items():
        states[tag], wx = rollout(hydro, overlap, dtype, device, depth)
        turned[tag] = rotation(wx)
    return states, {"point spins": point_spins(turned["point strong"], turned["hydro strong"])}


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
