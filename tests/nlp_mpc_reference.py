"""The JAX package's CPU float32 counts behind chip_smoke.py's gates of
phases 17b and 18c, on the port's own draws.  Run by hand, not by pytest.

Phase 17b runs the quadrotor obstacle MPC (BASELINE config 3,
benchmarks/bench_quadrotor_mpc.py: rk4 at dt 0.02, horizon 30, the RTI
schedule, chip_smoke.py's QUAD_STEPS MPC steps) from 4,096 initial states, and gates the lanes
progressing; phase 18c runs 32 float32 pendulum dircol solves from
jittered straight lines (benchmarks/bench_dircol_f32.py's options) and
gates the feasible count.  The port draws those states and guesses from
``torch.Generator``s (``drake_tpu_torch.benchmarks.bench_quadrotor_mpc.draws``
and ``bench_dircol_f32.draws``).  This script writes them to a file, with
the port alone (no JAX imported):

    python tests/nlp_mpc_reference.py --write-draws _chip/nlp_mpc_draws.npz

then runs the JAX package's programs (vmapped, jitted, on the CPU, float32)
on them and prints one JSON line with both counts:

    JAX_PLATFORMS=cpu python tests/nlp_mpc_reference.py --draws _chip/nlp_mpc_draws.npz

On the card, the port alone (no JAX imported) on the same draws, with
the same ``--nudge``; prints one JSON line.  ``--phases`` first runs
chip_smoke.py's phases 17 and 18 alone, with their ``--profile`` parts
(17c, 18d):

    python tests/nlp_mpc_reference.py --card _chip/nlp_mpc_draws.npz --nudge 2 [--phases]

``--quad-batch`` and ``--dircol-batch`` take the first lanes only;
``--skip-quad`` runs the dircol alone.  ``--nudge K`` also runs the dircol
from the guesses moved K ulps, for each K from -K to K but 0 (numpy's
``nextafter``, every entry, K times), and prints each run's feasible count
and lanes: the float32 solves are chaotic in the last bit, and these
counts show how far the count moves for that alone.  The
programs are the JAX benches' own; ``tests/test_torch_quadrotor.py`` and
``test_torch_dircol.py`` import them from here.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke  # noqa: E402  (the depth phase 17b runs)

QUAD_BATCH, QUAD_STEPS = 4096, chip_smoke.QUAD_STEPS
DIRCOL_BATCH = 32
FEAS_TOL = 1e-3


def jax_quadrotor(dtype, steps, rti=True, first_iters=8, iters=4):
    """The JAX bench's program: x0s (B, 12) -> the vmapped MPC rollout's
    result, and the goal."""
    import jax
    import jax.numpy as jnp

    from drake_tpu.control import mpc
    from drake_tpu.models import quadrotor
    from drake_tpu.systems import base as sysbase
    from drake_tpu.trajopt import ilqr

    system = quadrotor.make_system(quadrotor.default_params(dtype))
    params = system.default_params
    dt = 0.02
    dsys = sysbase.discretize(system, dt, "rk4")
    u_h = quadrotor.hover_input(params)
    x_goal = jnp.zeros(12, dtype).at[0].set(2.0).at[2].set(1.0)
    obst = jnp.asarray([1.0, 0.0, 0.5], dtype)

    def running_cost(p, x, u, t):
        d2 = jnp.sum((x[:3] - obst) ** 2)
        pen = jnp.maximum(0.0, 0.4**2 - d2) ** 2 * 100.0
        return 0.05 * jnp.sum((u - u_h) ** 2) + 0.05 * jnp.sum((x - x_goal) ** 2) + pen

    def final_cost(p, x):
        return 50.0 * jnp.sum((x - x_goal) ** 2)

    us0 = jnp.tile(u_h[None], (30, 1))
    if rti:
        options, first = ilqr.IlqrOptions(rti=True), ilqr.IlqrOptions(max_iters=first_iters)
    else:
        options, first = ilqr.IlqrOptions(max_iters=iters), None

    def scenario(x0):
        return mpc.ilqr_mpc_rollout(
            dsys.g, running_cost, final_cost, params, x0, us0, steps, dt=dt,
            u_lower=jnp.zeros(4, dtype), u_upper=jnp.full(4, 4.0, dtype),
            options=options, first_options=first)

    return jax.vmap(scenario), x_goal


def progressing(x0s, xs_final, x_goal):
    init_err = np.linalg.norm(np.asarray(x0s)[:, :3] - np.asarray(x_goal)[:3], axis=1)
    final_err = np.linalg.norm(np.asarray(xs_final)[:, :3] - np.asarray(x_goal)[:3], axis=1)
    return int(np.sum(final_err < init_err - 0.05))


def jax_dircol(dtype):
    """The pendulum swing-up problem of examples/pendulum_dircol.py and its
    params, from the JAX package."""
    import jax.numpy as jnp

    from drake_tpu.models import pendulum
    from drake_tpu.trajopt import dircol

    system = pendulum.make_system(pendulum.default_params(dtype))
    x0 = jnp.array([0.0, 0.0], dtype)
    xf = jnp.array([jnp.pi, 0.0], dtype)
    problem = dircol.DircolProblem(
        system=system, num_time_samples=21, minimum_time_step=0.2, maximum_time_step=0.5,
        running_cost=lambda x, u: 10.0 * u[0] ** 2, x0=x0, xf=xf,
        u_lower=jnp.array([-3.0], dtype), u_upper=jnp.array([3.0], dtype))
    return problem, system.default_params


def jax_dircol_f32_solve():
    """The JAX f32 bench's batched solve: z0s (B, n) -> DircolSolution."""
    import jax
    import jax.numpy as jnp

    from drake_tpu.solvers.ipm import IpmOptions
    from drake_tpu.solvers.sqp import SqpOptions
    from drake_tpu.trajopt import dircol

    problem, params = jax_dircol(jnp.float32)
    opts = SqpOptions(max_iters=300, qp=IpmOptions(max_iters=60, tol=1e-8),
                      constraint_tol=1e-4, opt_tol=1e-4)
    return jax.vmap(lambda z: dircol.solve(problem, params, z, opts))


def write_draws(path):
    from drake_tpu_torch.benchmarks import bench_dircol_f32, bench_quadrotor_mpc

    np.savez(path, x0s=bench_quadrotor_mpc.draws(QUAD_BATCH),
             z0s=bench_dircol_f32.draws(DIRCOL_BATCH))
    print(f"wrote {path}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--write-draws", help="write the port's draws to this .npz and exit")
    parser.add_argument("--draws", help="the .npz of --write-draws: the JAX package on the CPU")
    parser.add_argument("--card", help="the .npz of --write-draws: the port on the card")
    parser.add_argument("--quad-batch", type=int, default=QUAD_BATCH)
    parser.add_argument("--dircol-batch", type=int, default=DIRCOL_BATCH)
    parser.add_argument("--skip-quad", action="store_true")
    parser.add_argument("--nudge", type=int, default=0)
    parser.add_argument("--phases", action="store_true",
                        help="with --card: chip_smoke.py's phases 17-18 and their profiles first")
    args = parser.parse_args(argv)
    if args.write_draws:
        write_draws(args.write_draws)
        return 0
    if args.card:
        return run_card(args)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    data = np.load(args.draws)
    out = {}
    if not args.skip_quad:
        x0s = jnp.asarray(data["x0s"][: args.quad_batch], jnp.float32)
        rollout, x_goal = jax_quadrotor(jnp.float32, QUAD_STEPS)
        t0 = time.perf_counter()
        res = jax.jit(rollout)(x0s)
        out["quad_progressing"] = progressing(x0s, res.xs[:, -1], x_goal)
        out["quad_batch"], out["quad_steps"] = int(x0s.shape[0]), QUAD_STEPS
        out["quad_finite"] = bool(jnp.isfinite(res.xs).all())
        out["quad_s"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)

    solve = jax.jit(jax_dircol_f32_solve())
    for tag, z in nudged(data["z0s"][: args.dircol_batch], args.nudge):
        t0 = time.perf_counter()
        record(out, tag, np.asarray(solve(jnp.asarray(z)).constraint_violation),
               time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
    return 0


def nudged(z0s, nudge):
    """(tag, guesses) for the guesses themselves and, for k from -nudge to
    nudge but 0, every entry moved k ulps (numpy's ``nextafter``)."""
    z0s = np.asarray(z0s, np.float32)
    yield "dircol", z0s
    for k in (k for k in range(-nudge, nudge + 1) if k):
        z = z0s
        for _ in range(abs(k)):
            z = np.nextafter(z, np.float32(np.inf if k > 0 else -np.inf))
        yield f"dircol_nudged_{k:+d}", z


def record(out, tag, viol, seconds):
    out[f"{tag}_feasible"] = int(np.sum(viol < FEAS_TOL))
    out[f"{tag}_feasible_lanes"] = [int(i) for i in np.flatnonzero(viol < FEAS_TOL)]
    out[f"{tag}_s"] = seconds
    out["dircol_batch"] = int(viol.shape[0])


def run_card(args) -> int:
    """The port on the card from the draws: the quadrotor bench's progressing
    count and the float32 dircol bench's feasible counts."""
    import torch

    from drake_tpu_torch.benchmarks import bench_dircol_f32, bench_quadrotor_mpc

    torch.backends.cuda.matmul.allow_tf32 = False
    if args.phases:
        run_phases(torch)
    data = np.load(args.card)
    out = {}
    if not args.skip_quad:
        res = bench_quadrotor_mpc.run(args.quad_batch, QUAD_STEPS,
                                      x0s=data["x0s"][: args.quad_batch])
        out.update(quad_progressing=res["progressing"], quad_batch=args.quad_batch,
                   quad_finite=res["finite"], quad_s=res["wall_s"])
        print(json.dumps(out), flush=True)
    for tag, z in nudged(data["z0s"][: args.dircol_batch], args.nudge):
        res = bench_dircol_f32.run(z.shape[0], z)
        record(out, tag, res["solution"].constraint_violation.cpu().numpy(), res["wall_s"])
        print(json.dumps(out), flush=True)
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))
    return 0


def run_phases(torch):
    """chip_smoke.py's phases 17 and 18 with their profiles, alone."""
    import chip_smoke as cs
    from drake_tpu_torch.benchmarks import bench_dircol_f32, bench_quadrotor_mpc
    from drake_tpu_torch.control import mpc
    from drake_tpu_torch.examples import pendulum_dircol
    from drake_tpu_torch.ops import mpm_kernels as mk
    from drake_tpu_torch.solvers import ipm, sqp
    from drake_tpu_torch.trajopt import dircol, ilqr

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    cs.quad_parity(torch, bench_quadrotor_mpc, ilqr, dev, card)
    _, res = cs.quad_main_path(torch, bench_quadrotor_mpc, mk, dev, card)
    cs.quad_profile(torch, bench_quadrotor_mpc, mpc, ilqr, res, dev, card)
    del res
    cs.dircol_first_iteration(torch, pendulum_dircol, sqp, ipm, dev, card)
    cs.dircol_main_path(torch, pendulum_dircol, dircol, sqp, mk, dev, card)
    _, res = cs.dircol_bench_phase(torch, bench_dircol_f32, sqp, mk, dev, card)
    cs.dircol_profile(torch, bench_dircol_f32, dircol, res, dev, card)


if __name__ == "__main__":
    raise SystemExit(main())
