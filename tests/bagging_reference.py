"""The bagging demo's first steps (examples/mpm_bagging.py) on the CPU, by the
JAX package in float32 and by the port in float32 and float64: the ball's
height after each step.  ``chip_smoke.py`` phases 14b and 14d hold the
card's run against the JAX package's height after the last step
(``BAGGING_Z_END``), within a bound of at least 10x the spread of the port's
two CPU runs; this script gives both numbers.

    JAX_PLATFORMS=cpu python tests/bagging_reference.py [--steps 200] [--penalty]

Prints each run's first step off free fall (the ball's first contact with
the sheet) and its height after the last step, and one JSON line with the
heights, the spread and the wall times.

    python tests/bagging_reference.py --paths

measures instead what ``chip_smoke.py`` phase 14c's bounds rest on: the
port on the CPU in float32, 10 steps from its state at steps 60 and 160
through the scatter P2G (the plain path, as ``xla_only=True`` takes it on
the card) and through the blocked P2G's plain version (the order in which
the kernels sum), and the largest |x|, |v| and rigid-state differences.
The JAX world is the demo's, built as it builds it
(``test_torch_cloth.jax_bagging_world``) with its corner grabs; the port's
is ``drake_tpu_torch.examples.mpm_bagging``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def jax_grabs(world, sheet, dtype):
    """(grab, grab_pose) of examples/mpm_bagging.py, built as its main()
    builds them: the grabbed vertex indices of the four corner bunches and
    the smoothstep lift profile k -> (positions, velocities) in `dtype`."""
    import jax.numpy as jnp

    z0 = 0.34
    pts0 = np.asarray(sheet.x)
    corners = [(0.3, 0.3), (0.3, 0.7), (0.7, 0.3), (0.7, 0.7)]
    grabs, ends = [], []
    for cx, cy in corners:
        g = np.where(np.linalg.norm(pts0[:, :2] - [cx, cy], axis=1) < 0.035)[0]
        tx = 0.5 + 0.05 * np.sign(cx - 0.5)
        ty = 0.5 + 0.05 * np.sign(cy - 0.5)
        grabs.append(g)
        ends.append(np.stack([np.full(len(g), tx) + (pts0[g, 0] - cx) * 0.25,
                              np.full(len(g), ty) + (pts0[g, 1] - cy) * 0.25,
                              np.full(len(g), z0 + 0.35)], axis=1))
    grab = jnp.asarray(np.concatenate(grabs))
    g_start = jnp.asarray(pts0[np.concatenate(grabs)], dtype)
    g_end = jnp.asarray(np.concatenate(ends), dtype)
    settle_T, lift_T = 500, 1200

    def grab_pose(k):
        s = jnp.clip((k - settle_T) / lift_T, 0.0, 1.0)
        s2 = s * s * (3.0 - 2.0 * s)
        ds = jnp.where((s > 0) & (s < 1), 6.0 * s * (1.0 - s) / (lift_T * world.time_step), 0.0)
        return ((g_start + s2 * (g_end - g_start)).astype(dtype),
                (ds * (g_end - g_start)).astype(dtype))

    return grab, grab_pose


def jax_heights(steps: int, contact_model: str):
    """The JAX package's ball heights (steps,) in float32, the grabs set
    after every step as examples/mpm_bagging.py sets them."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from drake_tpu.contact.coupled_plant import CoupledState
    from test_torch_cloth import jax_bagging_world

    f32 = jnp.float32
    world, params, sheet = jax_bagging_world(22, 20, contact_model, dtype=f32)
    grab, grab_pose = jax_grabs(world, sheet, f32)
    q0 = jnp.asarray([1, 0, 0, 0, 0.5, 0.5, 0.34 + 0.07 + 0.02], f32)
    state = CoupledState(rigid=jnp.concatenate([q0, jnp.zeros(6, f32)]), particles=sheet)
    tau0 = jnp.zeros(6, f32)

    @jax.jit
    def run(state, ks):
        def body(st, k):
            st = world.step(params, st, tau0)
            pos, vel = grab_pose(k)
            p = st.particles
            p = p.replace(x=p.x.at[grab].set(pos), v=p.v.at[grab].set(vel))
            st = CoupledState(rigid=st.rigid, particles=p)
            return st, st.rigid[6]

        return jax.lax.scan(body, state, ks)

    _, z = run(state, jnp.arange(steps))
    return np.asarray(z, np.float64)


def port_heights(steps: int, contact_model: str, dtype):
    """The port's ball heights (steps,) on the CPU in `dtype`."""
    from drake_tpu_torch.examples import mpm_bagging

    res = mpm_bagging.run(steps=steps, contact_model=contact_model, device="cpu", dtype=dtype)
    assert int(res.dropped.max()) == 0
    return res.ball_z.double().numpy()


def first_contact(z, z0=0.43, g=9.81, h=1e-3):
    """The first step after which the ball is 1 um or more off its free
    fall (SAP's semi-implicit Euler: z_k = z0 - g h^2 k (k + 1) / 2), or
    None."""
    k = np.arange(1, len(z) + 1)
    off = np.abs(z - (z0 - g * h * h * k * (k + 1) / 2)) > 1e-6
    return int(k[off][0]) if off.any() else None


def path_differences(starts=(60, 160), steps=10):
    """{start: (max |dx|, max |dv|, max |d rigid|)} between the scatter P2G
    and the blocked P2G's plain version, float32 on the CPU."""
    import torch

    from drake_tpu_torch.examples import mpm_bagging as mb
    from drake_tpu_torch.mpm import solver as mpm

    def blocked(config, state):
        sort = mpm.sort_particles(config, state)
        vel, mass = mpm._velocity_from_blocks(config, sort, with_mass=True)
        return vel, mass, sort.dropped

    bag = mb.build("implicit", device="cpu", dtype=torch.float32)
    out, state, at = {}, None, 0
    for start in starts:
        state = mb.simulate(bag, start - at, state=state, start=at).state
        at = start
        scatter = mb.simulate(bag, steps, state=state, start=start).state
        scatter_path = mpm.grid_velocity_and_mass
        mpm.grid_velocity_and_mass = blocked
        try:
            block = mb.simulate(bag, steps, state=state, start=start).state
        finally:
            mpm.grid_velocity_and_mass = scatter_path
        out[start] = tuple(float((a - b).abs().max()) for a, b in (
            (scatter.particles.x, block.particles.x), (scatter.particles.v, block.particles.v),
            (scatter.rigid, block.rigid)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--penalty", action="store_true")
    ap.add_argument("--paths", action="store_true")
    args = ap.parse_args()
    import torch

    if args.paths:
        for start, (dx, dv, dr) in path_differences().items():
            print(json.dumps({"steps": [start, start + 10], "max_abs_dx": dx, "max_abs_dv": dv,
                              "max_abs_d_rigid": dr}))
        return 0

    model = "penalty" if args.penalty else "implicit"
    out = {"steps": args.steps, "contact_model": model}
    runs = {}
    for name, fn in (("jax_f32", lambda: jax_heights(args.steps, model)),
                     ("port_f32", lambda: port_heights(args.steps, model, torch.float32)),
                     ("port_f64", lambda: port_heights(args.steps, model, torch.float64))):
        t0 = time.perf_counter()
        runs[name] = fn()
        out[f"{name}_wall_s"] = time.perf_counter() - t0
        out[f"{name}_first_contact_step"] = first_contact(runs[name])
        print(f"{name}: first step off free fall {out[f'{name}_first_contact_step']}, z at "
              f"step {args.steps} {runs[name][-1]!r} ({out[f'{name}_wall_s']:.1f} s)",
              flush=True)
    for name, z in runs.items():
        out[f"{name}_z"] = float(z[-1])
    out["port_spread"] = abs(float(runs["port_f32"][-1] - runs["port_f64"][-1]))
    out["jax_f32_vs_port_f64"] = abs(float(runs["jax_f32"][-1] - runs["port_f64"][-1]))
    out["jax_f32_vs_port_f32"] = abs(float(runs["jax_f32"][-1] - runs["port_f32"][-1]))
    out["max_abs_over_steps_port_f32_vs_f64"] = float(
        np.abs(runs["port_f32"] - runs["port_f64"]).max())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
