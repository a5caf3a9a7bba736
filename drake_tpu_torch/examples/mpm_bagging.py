"""Bagging: a cloth sheet catches and lifts a rigid ball (the fork's
examples/multibody/deformable/mpm_bagging.cc), on the card.

The port of ``examples/mpm_bagging.py``.  A 22 x 22 sheet (484 vertices,
882 faces) hangs taut at z = 0.34, its four corner bunches held on a
scripted profile; a free ball (r 0.07 m, 0.15 kg, on a floating joint over
a ground halfspace at z = 0.05) drops 2 cm onto it.  After 500 steps the
corners rise 0.35 m and close in over 1,200 steps on a smoothstep profile,
then hold for 500: the ball is carried up by the two-way MPM-rigid coupling
alone (the cloth's contact impulses enter the ball's SAP step as external
forces).  Grid 32^3, dx 1/32, dt 5e-5, no wall band, 20 substeps a 1 ms
coupled step; particle contact k 3e4, d 30, mu 0.6, through the implicit
grid contact Newton (the demo's default) or, with ``--penalty``, the
explicit penalty.

    python -m drake_tpu_torch.examples.mpm_bagging [--penalty] [--out DIR] [--cpu]

Prints the pace, the ball's rest and final height and position, and
``BAGGING SUCCESS`` or ``BAGGING FAIL`` by the reference's checks (lifted
10 cm above its rest, carried within 10 cm of the bag's centre, held 5 cm
above the floor); exits 1 on FAIL.  ``--out`` writes the final sheet as an
OBJ.  Every P2G is checked to drop no particle.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from drake_tpu_torch.contact.coupled_plant import CoupledState, CoupledWorld
from drake_tpu_torch.geometry import shapes as sh
from drake_tpu_torch.geometry.scene import CollisionGeometry, CollisionScene
from drake_tpu_torch.mpm import cloth
from drake_tpu_torch.mpm import coupling as cpl
from drake_tpu_torch.mpm import solver as mpm
from drake_tpu_torch.multibody.model import ModelBuilder, MultibodyParams
from drake_tpu_torch.utils.device import resolve_device

R_BALL = 0.07
M_BALL = 0.15
FLOOR_Z = 0.05
Z0 = 0.34  # taut sheet height: the trampoline
NX = 22  # vertices a side
DROP = 0.02  # the ball's lowest point starts this far above the sheet
CORNERS = ((0.3, 0.3), (0.3, 0.7), (0.7, 0.3), (0.7, 0.7))
SETTLE_T, LIFT_T, HOLD_T = 500, 1200, 500
STEPS = SETTLE_T + LIFT_T + HOLD_T
SUBSTEPS = 20  # a coupled step of 1 ms


class Bagging(NamedTuple):
    world: CoupledWorld
    params: MultibodyParams
    state0: CoupledState  # one world, no lane axis
    grab: torch.Tensor  # (ng,) int64 vertices of the four corner bunches
    g_start: torch.Tensor  # (ng, 3) their positions at the start of the lift
    g_end: torch.Tensor  # (ng, 3) and at its end


def build(contact_model: str = "implicit", device=None, dtype=torch.float32,
          xla_only: bool = False) -> Bagging:
    """The bagging world, as the reference demo builds it, on `device`
    (None: the current CUDA device); ``xla_only`` takes the plain versions
    of the kernels."""
    device = resolve_device(device)
    b = ModelBuilder(gravity=(0.0, 0.0, -9.81))
    b.add_body("ball", parent=None, joint_type="floating", mass=M_BALL,
               inertia_com=np.eye(3) * (0.4 * M_BALL * R_BALL**2))
    model, params = b.build(dtype, device=device)
    geoms = [
        CollisionGeometry(name="ball", body=0, shape=sh.Sphere(R_BALL),
                          friction=0.6, stiffness=1e5, dissipation=0.1),
        CollisionGeometry(name="ground", body=-1, shape=sh.HalfSpace(),
                          p_BG=np.array([0.0, 0.0, FLOOR_Z]),
                          friction=0.6, stiffness=1e7, dissipation=0.1),
    ]
    # No wall band: a sticky band would glue a floor-resting cloth in place.
    grid = mpm.MpmConfig(grid_size=(32, 32, 32), dx=1.0 / 32, dt=5e-5, wall_width=0,
                         xla_only=xla_only)
    cfg = cloth.ClothConfig()
    sheet = cloth.make_grid_cloth(cfg, NX, NX, origin=(0.3, 0.3, Z0), size=(0.4, 0.4),
                                  dtype=dtype, device=device)
    world = CoupledWorld(
        model=model, scene=CollisionScene.build(geoms), mpm_config=grid,
        contact_params=cpl.MpmContactParams(stiffness=3e4, damping=30.0, friction=0.6),
        coupled_geometries=(0,),  # the ball
        substeps_per_step=SUBSTEPS, time_step=1e-3, cloth_config=cfg,
        contact_model=contact_model,
    )
    q0 = [1.0, 0.0, 0.0, 0.0, 0.5, 0.5, Z0 + R_BALL + DROP]
    rigid = torch.tensor(q0 + [0.0] * 6, dtype=dtype, device=device)

    # Corner grabs: each corner's bunch of vertices moves toward a point
    # just off the centre, high up, closing in to a quarter of its spread.
    pts0 = sheet.x.cpu().numpy()
    grabs, ends = [], []
    for cx, cy in CORNERS:
        g = np.where(np.linalg.norm(pts0[:, :2] - [cx, cy], axis=1) < 0.035)[0]
        tx = 0.5 + 0.05 * np.sign(cx - 0.5)
        ty = 0.5 + 0.05 * np.sign(cy - 0.5)
        grabs.append(g)
        ends.append(np.stack([np.full(len(g), tx) + (pts0[g, 0] - cx) * 0.25,
                              np.full(len(g), ty) + (pts0[g, 1] - cy) * 0.25,
                              np.full(len(g), Z0 + 0.35)], axis=1))
    grab = np.concatenate(grabs)
    kw = dict(dtype=dtype, device=device)
    return Bagging(
        world=world, params=params, state0=CoupledState(rigid=rigid, particles=sheet),
        grab=torch.as_tensor(grab, dtype=torch.int64, device=device),
        g_start=torch.as_tensor(pts0[grab], **kw),
        g_end=torch.as_tensor(np.concatenate(ends), **kw),
    )


def grab_pose(bag: Bagging, k: int):
    """(positions, velocities) (ng, 3) of the grabbed vertices after step
    k: the smoothstep lift over [SETTLE_T, SETTLE_T + LIFT_T]."""
    s = min(max((k - SETTLE_T) / LIFT_T, 0.0), 1.0)
    s2 = s * s * (3.0 - 2.0 * s)
    ds = 6.0 * s * (1.0 - s) / (LIFT_T * bag.world.time_step) if 0.0 < s < 1.0 else 0.0
    span = bag.g_end - bag.g_start
    return bag.g_start + s2 * span, ds * span


def lanes(state: CoupledState, count: int) -> CoupledState:
    """`count` copies of one world's state as lanes: a leading axis on the
    rigid state and on the sheet's per-vertex fields (the faces and rest
    data stay shared)."""
    def rep(t):
        return t.expand((count,) + t.shape).contiguous()

    p = state.particles
    return CoupledState(rigid=rep(state.rigid), particles=p.replace(
        x=rep(p.x), v=rep(p.v), C=rep(p.C), mass=rep(p.mass), dropped=rep(p.dropped)))


class BaggingRun(NamedTuple):
    state: CoupledState  # after the last step
    ball_z: torch.Tensor  # (steps, ...) the ball's height after each step
    impulses: torch.Tensor  # (steps, ..., 6) [tau; f] the sheet's impulse on the ball a step
    dropped: torch.Tensor  # (steps, ...) the largest P2G drop count of each step
    wall_s: float  # host wall, from a synchronised start to a synchronised end


def simulate(bag: Bagging, steps: int, state: Optional[CoupledState] = None,
             start: int = 0) -> BaggingRun:
    """`steps` coupled steps of the bagging world from `state` (default the
    start state) at step index `start`, the grabbed vertices put on their
    profile after every step.  The loop reads nothing back itself (the
    implicit solve asks the card whether its Newton may stop)."""
    world = bag.world
    state = bag.state0 if state is None else state
    tau = state.rigid.new_zeros(state.rigid.shape[:-1] + (world.model.num_velocities,))
    zs, imps, drops = [], [], []
    sync = state.rigid.device.type == "cuda"
    if sync:
        torch.cuda.synchronize(state.rigid.device)
    t0 = time.perf_counter()
    with torch.no_grad():
        for k in range(start, start + steps):
            state, imp = world.step_with_impulses(bag.params, state, tau)
            pos, vel = grab_pose(bag, k)
            p = state.particles
            x, v = p.x.clone(), p.v.clone()
            x[..., bag.grab, :] = pos
            v[..., bag.grab, :] = vel
            state = CoupledState(rigid=state.rigid, particles=p.replace(x=x, v=v))
            zs.append(state.rigid[..., 6])
            imps.append(imp[..., 0, :])
            drops.append(p.dropped)
    if sync:
        torch.cuda.synchronize(state.rigid.device)
    wall = time.perf_counter() - t0
    return BaggingRun(state=state, ball_z=torch.stack(zs), impulses=torch.stack(imps),
                      dropped=torch.stack(drops), wall_s=wall)


def run(steps: int = STEPS, contact_model: str = "implicit", device=None,
        dtype=torch.float32) -> BaggingRun:
    """The demo's first `steps` steps (all 2,200 by default) on `device`
    (None: the current CUDA device)."""
    return simulate(build(contact_model, device=device, dtype=dtype), steps)


def verdict(res: BaggingRun):
    """The reference demo's checks on a whole run of one world: (ok,
    lifted, carried, held, z at rest, z at the end)."""
    z_rest = float(res.ball_z[SETTLE_T - 1])
    z_final = float(res.ball_z[-1])
    qb = res.state.rigid[:7].double().cpu().numpy()
    lifted = z_final > z_rest + 0.10
    carried = abs(qb[4] - 0.5) < 0.1 and abs(qb[5] - 0.5) < 0.1
    held = z_final > FLOOR_Z + R_BALL + 0.05  # not resting on the floor
    return lifted and carried and held, lifted, carried, held, z_rest, z_final


def write_obj(path, vertices, faces):
    """Minimal OBJ dump (cuda_mpm_solver.cu Dump role)."""
    with open(path, "w") as f:
        for v in np.asarray(vertices):
            f.write(f"v {v[0]:.5f} {v[1]:.5f} {v[2]:.5f}\n")
        for tri in np.asarray(faces):
            f.write(f"f {tri[0] + 1} {tri[1] + 1} {tri[2] + 1}\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--penalty", action="store_true",
                    help="explicit per-particle penalty contact instead of the implicit "
                         "grid contact Newton")
    ap.add_argument("--out", default="", help="directory for bag.obj, the final sheet")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = "cpu" if args.cpu else None
    res = run(contact_model="penalty" if args.penalty else "implicit", device=device)
    substeps = res.ball_z.shape[0] * SUBSTEPS
    where = "cpu" if args.cpu else torch.cuda.get_device_name(0)
    print(f"{substeps} substeps in {res.wall_s:.1f}s -> {substeps / res.wall_s:.0f} "
          f"substeps/s ({where})")
    ok, lifted, carried, held, z_rest, z_final = verdict(res)
    qb = res.state.rigid[:7].double().cpu().numpy()
    x = res.state.particles.x.double().cpu().numpy()
    print(f"ball z: rest {z_rest:.3f} -> lifted {z_final:.3f} "
          f"(floor+r = {FLOOR_Z + R_BALL:.3f})")
    print(f"ball xy: ({qb[4]:.3f}, {qb[5]:.3f}) (bag centred at 0.5, 0.5)")
    if not np.all(np.isfinite(x)):
        raise SystemExit("cloth blew up")
    dropped = int(res.dropped.max())
    if dropped:
        raise SystemExit(f"{dropped} particles dropped by the P2G's capacities")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        write_obj(os.path.join(args.out, "bag.obj"), x,
                  res.state.particles.faces.cpu().numpy())
    print("BAGGING", "SUCCESS" if ok else "FAIL",
          f"(lifted={lifted}, carried={carried}, held={held})")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
