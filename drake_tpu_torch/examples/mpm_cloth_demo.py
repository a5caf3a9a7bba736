"""Cloth drape: a cloth patch falls onto a fixed rigid sphere (the fork's
examples/multibody/deformable/mpm_cloth.cc), on the card.

The port of ``examples/mpm_cloth_demo.py``: a 16 x 16 sheet (0.44 m a side,
from z = 0.62) over a sphere of r 0.12 at (0.5, 0.5, 0.35), by
``cloth.simulate_cloth`` with the explicit penalty contact (k 3e4, d 30,
mu 0.5) on a 32^3 grid (dx 1/32, dt 5e-5, no wall band).  Each frame of
``--substeps-per-frame`` substeps prints the sheet's height range and the
sphere's support force, and writes the sheet as an OBJ (the reference's
GpuMpmSolver::Dump role).

    python -m drake_tpu_torch.examples.mpm_cloth_demo [--frames N] [--out DIR] [--cpu]

Ends with ``CLOTH-DRAPE SUCCESS`` where the settled support is within half
of the cloth's weight, else ``PARTIAL``; exits 1 if the sheet goes
non-finite, and stops if a P2G drops a particle.  The reference's
``--publish`` and ``--meshcat-html`` are not ported (they need the io and
viz modules).
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from drake_tpu_torch.examples.mpm_bagging import write_obj
from drake_tpu_torch.geometry import shapes as sh
from drake_tpu_torch.mpm import cloth
from drake_tpu_torch.mpm import coupling as cpl
from drake_tpu_torch.mpm import solver as mpm
from drake_tpu_torch.utils.device import resolve_device

SPHERE_CENTER = (0.5, 0.5, 0.35)
SPHERE_RADIUS = 0.12
SHEET_Z = 0.62


def build(device=None, dtype=torch.float32, z: float = SHEET_Z):
    """(grid config, cloth config, sheet, [sphere], contact params) of the
    drape, the sheet at height `z`, on `device` (None: the current CUDA
    device)."""
    device = resolve_device(device)
    cfg = cloth.ClothConfig()
    grid = mpm.MpmConfig(grid_size=(32, 32, 32), dx=1.0 / 32, dt=5e-5, wall_width=0)
    sheet = cloth.make_grid_cloth(cfg, 16, 16, origin=(0.28, 0.28, z), size=(0.44, 0.44),
                                  dtype=dtype, device=device)
    center = torch.tensor(SPHERE_CENTER, dtype=dtype, device=device)
    sphere = cpl.RigidGeom(
        shape=sh.Sphere(SPHERE_RADIUS), body_index=0,
        R_WG=torch.eye(3, dtype=dtype, device=device), p_WG=center, p_WB=center,
        V_WB=torch.zeros(6, dtype=dtype, device=device),
    )
    params = cpl.MpmContactParams(stiffness=3e4, damping=30.0, friction=0.5)
    return grid, cfg, sheet, [sphere], params


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--substeps-per-frame", type=int, default=800)
    ap.add_argument("--out", default="mpm_cloth_frames", help="directory for the OBJ frames")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    grid, cfg, sheet, geoms, params = build(device="cpu" if args.cpu else None)
    os.makedirs(args.out, exist_ok=True)
    state = sheet
    fz = 0.0
    t0 = time.perf_counter()
    with torch.no_grad():
        for frame in range(args.frames):
            state, acc = cloth.simulate_cloth(grid, cfg, state, args.substeps_per_frame,
                                              geoms, params)
            z = state.x[:, 2]
            zr = (float(z.min()), float(z.max()))
            fz = float(-acc[0, 5]) / (args.substeps_per_frame * grid.dt)
            x = state.x.double().cpu().numpy()
            write_obj(os.path.join(args.out, f"cloth_{frame:04d}.obj"), x,
                      sheet.faces.cpu().numpy())
            print(f"frame {frame}: z [{zr[0]:.3f}, {zr[1]:.3f}] support {fz:.2f} N, "
                  f"dropped {int(state.dropped)}")
            if not bool(torch.isfinite(state.x).all()):
                print("CLOTH FAILURE (non-finite)")
                return 1
            if int(state.dropped):
                raise SystemExit(f"{int(state.dropped)} particles dropped by the P2G's capacities")
    wall = time.perf_counter() - t0
    total = args.frames * args.substeps_per_frame
    where = "cpu" if args.cpu else torch.cuda.get_device_name(0)
    print(f"{total} substeps in {wall:.1f}s -> {total / wall:.0f} substeps/s "
          f"({sheet.x.shape[0]} verts, {where}); OBJ frames in {args.out}")
    weight = float(sheet.mass.sum()) * 9.81
    ok = abs(fz - weight) < 0.5 * weight  # settled support ~ cloth weight
    print("CLOTH-DRAPE", "SUCCESS" if ok else "PARTIAL (still settling)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
