"""Strandbeest: one Jansen-linkage leg built from its link/joint graph.

The port of ``examples/strandbeest.py`` (Drake's
examples/multibody/strandbeest): the leg is declared as a ``LinkGraph``
with its three loops; ``multibody.topology`` picks a spanning forest and
cuts the loop joints into SAP ball constraints; the circle-intersection
construction seeds the walking assembly branch, which ``topology.assemble``
polishes.  A PD torque drives the crank at 2 rad/s through the discrete
plant.  Checks (the reference's): the loops stay closed (< 5 mm), the crank
turns a full revolution, and the foot traces the flat-bottomed stride (x
span > 0.5 m, below the axle, the lower quartile flat within a quarter of
the z span).

Run:  python -m drake_tpu_torch.examples.strandbeest [--cpu] [--seconds T]
(float32 on the card by default; --cpu is float64 on the CPU).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

# Jansen's holy numbers (cm -> m).
S = 0.01
LEN_A, LEN_B, LEN_C, LEN_D = 38.0 * S, 41.5 * S, 39.3 * S, 40.1 * S
LEN_E, LEN_F, LEN_G, LEN_H = 55.8 * S, 39.4 * S, 36.7 * S, 65.7 * S
LEN_I, LEN_J, LEN_K, LEN_L, LEN_M = (49.0 * S, 50.0 * S, 61.9 * S,
                                     7.8 * S, 15.0 * S)
P_PIVOT = np.array([-LEN_A, -LEN_L])  # (x, z): the second fixed pivot
Y = (0.0, 1.0, 0.0)                   # the mechanism lives in the x-z plane


def _plate(r1, r2, opposite):
    """Second vertex of a rigid plate (origin, (r1,0,0), V2), CCW branch."""
    cphi = (r1**2 + r2**2 - opposite**2) / (2 * r1 * r2)
    sphi = np.sqrt(max(0.0, 1 - cphi**2))
    return (r2 * cphi, 0.0, r2 * sphi)


C_V = _plate(LEN_B, LEN_D, LEN_E)  # knee vertex of the top plate
F_V = _plate(LEN_G, LEN_I, LEN_H)  # foot vertex of the bottom plate


def _bar(g, name: str, length: float):
    m = 0.1 * length
    g.add_link(name, mass=m, com=(length / 2, 0, 0),
               inertia_com=np.diag([1e-5, m * length**2 / 12,
                                    m * length**2 / 12]))


def build_leg():
    """The leg as a LinkGraph with its three loops."""
    from drake_tpu_torch.multibody import topology as topo

    g = topo.LinkGraph()
    g.add_link("crank", mass=0.2,
               inertia_com=np.diag([1e-5, 0.2 * LEN_M**2 / 3,
                                    0.2 * LEN_M**2 / 3]))
    _bar(g, "bar_j", LEN_J)
    _bar(g, "bar_k", LEN_K)
    _bar(g, "bar_c", LEN_C)
    _bar(g, "bar_f", LEN_F)
    # Ternary plates: frame at the pivot vertex, +x toward the 1st vertex.
    g.add_link("tri_top", mass=0.4, com=(0.15, 0, 0.15),
               inertia_com=np.diag([0.004, 0.008, 0.004]))
    g.add_link("tri_bot", mass=0.4, com=(0.1, 0, 0.1),
               inertia_com=np.diag([0.006, 0.012, 0.006]))

    tip = (LEN_M, 0.0, 0.0)
    piv = (P_PIVOT[0], 0.0, P_PIVOT[1])
    g.add_joint("world_crank", parent=topo.WORLD, child="crank", axis=Y)
    g.add_joint("crank_j", parent="crank", child="bar_j", axis=Y, p_PJ=tip)
    g.add_joint("crank_k", parent="crank", child="bar_k", axis=Y, p_PJ=tip)
    g.add_joint("world_tri_top", parent=topo.WORLD, child="tri_top",
                axis=Y, p_PJ=piv)
    g.add_joint("world_c", parent=topo.WORLD, child="bar_c", axis=Y,
                p_PJ=piv)
    # The three loops (cut by the spanning forest into ball constraints):
    g.add_joint("j_triTop", parent="bar_j", child="tri_top", axis=Y,
                p_PJ=(LEN_J, 0, 0), p_CJ=(LEN_B, 0, 0))
    g.add_joint("k_triBot", parent="bar_k", child="tri_bot", axis=Y,
                p_PJ=(LEN_K, 0, 0))
    g.add_joint("c_triBot", parent="bar_c", child="tri_bot", axis=Y,
                p_PJ=(LEN_C, 0, 0))
    g.add_joint("triTop_f", parent="tri_top", child="bar_f", axis=Y,
                p_PJ=C_V)
    g.add_joint("f_triBot", parent="bar_f", child="tri_bot", axis=Y,
                p_PJ=(LEN_F, 0, 0), p_CJ=(LEN_G, 0, 0))
    return g


def _circle_intersect(c1, r1, c2, r2, upper: bool):
    """(x,z)-plane circle-circle intersection, picking the upper/lower z."""
    d = np.linalg.norm(c2 - c1)
    if d > r1 + r2 or d < abs(r1 - r2):
        raise ValueError("linkage locked: circles do not intersect")
    a = (r1**2 - r2**2 + d**2) / (2 * d)
    h = np.sqrt(max(r1**2 - a**2, 0.0))
    mid = c1 + a * (c2 - c1) / d
    perp = np.array([-(c2 - c1)[1], (c2 - c1)[0]]) / d
    p1, p2 = mid + h * perp, mid - h * perp
    return p1 if (p1[1] > p2[1]) == upper else p2


def _rot_ccw(v, cphi, sphi):
    return np.array([cphi * v[0] - sphi * v[1], sphi * v[0] + cphi * v[1]])


def jansen_pose(psi: float, model) -> np.ndarray:
    """Joint angles of the WALKING branch at crank angle psi.

    The classic construction: B = circ(A,j) ∩ circ(P,b) upper;
    hip D = circ(A,k) ∩ circ(P,c) lower; knee C rigid (CCW) on the top
    plate; ankle E = circ(C,f) ∩ circ(D,g) lower; foot rigid on the
    bottom plate.  Joint angle = world angle − parent world angle, with
    R_y(θ)·x̂ = (cosθ, 0, −sinθ) ⇒ θ(d) = atan2(−d_z, d_x).
    """
    A = LEN_M * np.array([np.cos(psi), np.sin(psi)])
    B = _circle_intersect(A, LEN_J, P_PIVOT, LEN_B, upper=True)
    D = _circle_intersect(A, LEN_K, P_PIVOT, LEN_C, upper=False)
    cphi = (LEN_B**2 + LEN_D**2 - LEN_E**2) / (2 * LEN_B * LEN_D)
    C = P_PIVOT + LEN_D * _rot_ccw((B - P_PIVOT) / LEN_B, cphi,
                                   np.sqrt(1 - cphi**2))
    E = _circle_intersect(C, LEN_F, D, LEN_G, upper=False)

    theta = lambda d: np.arctan2(-d[1], d[0])
    th_crank = theta(A)
    th_top = theta((B - P_PIVOT) / LEN_B)
    th_c = theta((D - P_PIVOT) / LEN_C)
    th_j = theta((B - A) / LEN_J) - th_crank
    th_k = theta((D - A) / LEN_K) - th_crank
    th_f = theta((E - C) / LEN_F) - th_top
    th_bot = theta((E - D) / LEN_G) - th_c
    angles = {"crank": th_crank, "tri_top": th_top, "bar_c": th_c,
              "bar_j": th_j, "bar_k": th_k, "bar_f": th_f, "tri_bot": th_bot}
    return np.array([angles[n] for n in model.body_names])


H, SECONDS = 2e-3, 4.0
LOOP_TOL = 5e-3  # m, the largest loop error through the dynamics
OMEGA, KP, KD = 2.0, 40.0, 4.0


def build(dtype=torch.float32, device=None):
    """(graph, model, params, ball constraints, the assembled q0 (nq,))."""
    from drake_tpu_torch.multibody import topology as topo

    g = build_leg()
    model, params, balls, welds = g.build(dtype, device)
    assert not welds
    _, params64, _, _ = g.build(torch.float64, "cpu")
    q_seed = torch.tensor(jansen_pose(np.pi / 3, model), dtype=torch.float64)
    q0, err = topo.assemble(model, params64, balls, q_seed)
    if err >= 1e-8:
        raise RuntimeError(f"the leg did not assemble (residual {err:.2e})")
    return g, model, params, balls, q0.to(dtype=dtype, device=device)


def rollout(dtype, device, seconds=SECONDS):
    """(the link graph, the model, q0, the final state, the foot's
    position a step, the loop residual's norm a step) of the leg driven
    for `seconds`."""
    from drake_tpu_torch.contact import plant as cplant
    from drake_tpu_torch.contact.sap import SapParameters
    from drake_tpu_torch.geometry.scene import CollisionScene
    from drake_tpu_torch.multibody import kinematics as kin
    from drake_tpu_torch.multibody import topology as topo
    from drake_tpu_torch.systems.simulator import simulate_discrete

    g, model, params, balls, q0 = build(dtype, device)
    nq = model.num_positions
    crank, tri_bot = model.body_index("crank"), model.body_index("tri_bot")
    system = cplant.make_discrete_system(
        model, params, CollisionScene.build([]), H, ball_constraints=balls,
        sap_params=SapParameters(max_iterations=40, rel_tolerance=1e-8))
    foot_B = torch.tensor(F_V, dtype=dtype, device=device)
    select = torch.zeros(nq, dtype=dtype, device=device)
    select[crank] = 1.0

    def inputs(k, x):  # the crank's PD torque towards q0 - omega t
        th_des = q0[crank] - OMEGA * (k * H)
        return select * (KP * (th_des - x[crank]) + KD * (-OMEGA - x[nq + crank]))

    def record(x):
        q = x[:nq]
        R, p = kin.forward_kinematics(model, params, q)
        foot = p[tri_bot] + R[tri_bot] @ foot_B
        return foot, torch.linalg.vector_norm(topo.loop_residual(model, params, balls, q))

    with torch.no_grad():
        x, (feet, loop_errs) = simulate_discrete(
            system, params, torch.cat([q0, torch.zeros_like(q0)]), inputs,
            steps=int(seconds / H), record=record)
    return g, model, q0, x, feet, loop_errs


def loop_error(loop_errs):
    """The largest loop error every 10th step, as the reference samples."""
    return float(loop_errs[::10].max())


def run(device=None, dtype=torch.float32, seconds=SECONDS, verbose: bool = True):
    """The demo: its readings (the final state, the foot path every 10th
    step, the loop errors, ``ok``, the seconds)."""
    from drake_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    start = time.perf_counter()
    g, model, q0, x, feet, loop_errs = rollout(dtype, device, seconds)
    seconds_wall = time.perf_counter() - start
    crank = model.body_index("crank")
    n_steps = int(seconds / H)
    feet = feet[::10].double().cpu().numpy()  # every 10th step, as the reference samples
    loop_err = loop_error(loop_errs)
    swept = abs(float(x[crank] - q0[crank]))
    x_span = feet[:, 0].max() - feet[:, 0].min()
    z_span = feet[:, 2].max() - feet[:, 2].min()
    low = feet[feet[:, 2] <= np.percentile(feet[:, 2], 25)]
    flat = low[:, 2].max() - low[:, 2].min()
    out = {"x": x, "q0": q0, "loop_err": loop_err, "swept": swept, "x_span": x_span,
           "z_span": z_span, "z_max": float(feet[:, 2].max()), "flat": flat,
           "seconds": seconds_wall, "finite": bool(torch.isfinite(x).all()),
           "loops": len(g.spanning_forest().loop_joints)}
    out["ok"] = (out["finite"] and out["loops"] == 3 and loop_err < LOOP_TOL and swept > 2 * np.pi
                 and x_span > 0.5 and out["z_max"] < -0.5 and flat < 0.25 * z_span)
    if verbose:
        print(f"links: {model.num_bodies}, cut loops: {out['loops']}; max loop error through "
              f"dynamics: {loop_err:.2e}; crank swept {swept:.2f} rad")
        print(f"foot path: x span {x_span:.3f} m, z span {z_span:.3f} m, zmax "
              f"{out['z_max']:.3f}, lower-quartile flatness {flat * 1000:.1f} mm; "
              f"{n_steps} steps in {seconds_wall:.1f} s")
        print("strandbeest leg OK" if out["ok"] else "strandbeest leg FAILED")
    return out


def smoke(depth, device, dtype=torch.float32):
    """The leg driven for `depth` seconds (part of a crank turn): (the
    final state, the check that this depth reaches: the loops held
    closed; the foot path needs the full turn)."""
    *_, x, _, loop_errs = rollout(dtype, device, depth)
    return {"x": x}, {"loops": loop_error(loop_errs) < LOOP_TOL}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="float64 on the CPU")
    ap.add_argument("--seconds", type=float, default=SECONDS)
    args = ap.parse_args(argv)
    out = run(device="cpu" if args.cpu else None,
              dtype=torch.float64 if args.cpu else torch.float32, seconds=args.seconds)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
