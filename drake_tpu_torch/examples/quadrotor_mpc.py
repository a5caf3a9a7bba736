"""Quadrotor receding-horizon MPC past an obstacle, batched scenarios.

The port of ``examples/quadrotor_mpc.py`` (BASELINE config 3's demo): every
scenario runs the closed-loop iLQR MPC (4 iterations a step, horizon 30, rk4
at dt 0.02, rotor forces in [0, 4] N) of
``drake_tpu_torch.benchmarks.bench_quadrotor_mpc`` from a randomized start
toward the goal [2, 0, 1] past the spherical obstacle, all scenarios in one
batched call on one device.  The reference also shards the scenario batch
over its device mesh (``parallel/mesh``); that waits for the port of the
mesh (ROADMAP.md item 21).

    python -m drake_tpu_torch.examples.quadrotor_mpc [--batch 64] [--steps 25] [--cpu]

Prints the pace, the median distance to the goal before and after, the
scenarios progressing (final distance below 0.8 of the initial, as the
reference) and the median clearance of the obstacle, then
``QUADROTOR-MPC SUCCESS`` (more than 90% progressing) or ``FAILURE``; exits
1 on FAILURE.  The starts come from a ``torch.Generator`` seeded 0, not
JAX's ``PRNGKey(0)``.
"""

from __future__ import annotations

import argparse
import time

import torch

from drake_tpu_torch.benchmarks import bench_quadrotor_mpc as bq
from drake_tpu_torch.utils.device import resolve_device


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--steps", type=int, default=25)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = parser.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    prob = bq.build(torch.float32, device)
    x0s = torch.tensor(bq.draws(args.batch), dtype=torch.float32, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    bq.rollout(prob, x0s, 1, rti=False)  # warm-up: one MPC step
    sync()
    t1 = time.perf_counter()
    res = bq.rollout(prob, x0s, args.steps, rti=False)
    sync()
    t2 = time.perf_counter()

    goal = prob["x_goal"][:3]
    init_err = torch.linalg.vector_norm(x0s[:, :3] - goal, dim=-1)
    final_err = torch.linalg.vector_norm(res.xs[:, -1, :3] - goal, dim=-1)
    min_obs = torch.amin(torch.linalg.vector_norm(res.xs[..., :3] - prob["obstacle"], dim=-1),
                         dim=1)
    n_ok = int(torch.sum(final_err < 0.8 * init_err))
    solves = args.batch * args.steps
    print(f"device: {device}, batch {args.batch}, steps {args.steps}")
    print(f"warm-up {t1 - t0:.1f}s; {solves} MPC solves in {(t2 - t1) * 1e3:.0f}ms "
          f"-> {solves / (t2 - t1):.0f} solves/s")
    print(f"median goal distance: {float(torch.quantile(init_err, 0.5)):.2f} -> "
          f"{float(torch.quantile(final_err, 0.5)):.2f} m; progressing {n_ok}/{args.batch}; "
          f"median obstacle clearance {float(torch.quantile(min_obs, 0.5)):.2f}m")
    ok = n_ok > 0.9 * args.batch
    print("QUADROTOR-MPC", "SUCCESS" if ok else "FAILURE")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
