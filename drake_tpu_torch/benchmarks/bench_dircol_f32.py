"""Batched float32 pendulum dircol from cold starts: feasibility and rate.

The port of ``benchmarks/bench_dircol_f32.py``: B swing-ups of
``examples/pendulum_dircol`` (21 knots, h in [0.2, 0.5], |u| <= 3, cost
10 u^2), each from the straight-line guess jittered by 0.05 N(0, 1), solved
in float32 by the Sl1QP solver with the reference's float32 options
(``SqpOptions(max_iters=300, qp=IpmOptions(max_iters=60, tol=1e-8),
constraint_tol=1e-4, opt_tol=1e-4)``), all B in one call: the reference ran
its TPU in chunks of 8, which the port does not carry.

    python -m drake_tpu_torch.benchmarks.bench_dircol_f32 [--batch 32]
        [--warm-start | --multi-start]

``--warm-start`` seeds every lane with a 40-iteration iLQR swing-up
(``trajopt.ilqr``, rk4 at the guess's mean step); ``--multi-start`` also
solves each lane from the plain straight line and keeps the solution of
lower violation (both halves in one call of 2B lanes).  Prints one JSON
line: B / wall solves/s (host clock, after a 2-iteration warm-up, ending in
a synchronise), the lanes feasible at violation < ``--feas-tol`` (1e-3), SQP
iterations, peak memory and the card.

Stated differences from the reference: the jitter comes from a
``torch.Generator`` seeded ``--seed`` (default 0), not JAX's
``PRNGKey(0)``.  The reference's docstring calls its QP Ruiz-equilibrated,
but its ``IpmOptions`` leave ``equilibrate`` at 0; the port keeps 0.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time

import numpy as np
import torch

from drake_tpu_torch.examples import pendulum_dircol
from drake_tpu_torch.solvers.ipm import IpmOptions
from drake_tpu_torch.solvers.sqp import SqpOptions
from drake_tpu_torch.systems import base as sysbase
from drake_tpu_torch.trajopt import dircol, ilqr
from drake_tpu_torch.utils.device import card, resolve_device

OPTIONS = SqpOptions(max_iters=300, qp=IpmOptions(max_iters=60, tol=1e-8),
                     constraint_tol=1e-4, opt_tol=1e-4)
JITTER = 0.05
WARMUP_ITERS = 2


def draws(batch: int, seed: int = 0) -> np.ndarray:
    """Initial guesses (batch, n) in float32: the straight line plus JITTER
    N(0, 1) from a generator seeded `seed`."""
    _, problem, x0, xf = pendulum_dircol.build_problem(torch.float32, "cpu")
    z_base = problem.initial_guess(x0, xf, pendulum_dircol.TIMESPAN, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(seed)
    dz = JITTER * torch.randn((batch, z_base.shape[0]), generator=gen, dtype=torch.float32)
    return (z_base + dz).numpy()


def ilqr_warm_start(system, problem, z0s):
    """Each lane's guess replaced by a 40-iteration iLQR swing-up from its
    inputs (the acrobot example's iLQR-then-dircol pattern)."""
    dtype, device = z0s.dtype, z0s.device
    B, N = z0s.shape[0], problem.num_time_samples
    h_mid = pendulum_dircol.TIMESPAN / (N - 1)
    dsys = sysbase.discretize(system, h_mid, "rk4")

    def rc(p, x, u, t):
        return 10.0 * u[..., 0] ** 2

    def fc(p, x):
        return 200.0 * ((x[..., 0] - math.pi) ** 2 + 0.2 * x[..., 1] ** 2)

    _, _, us_g = problem.unpack(z0s)
    lim = torch.tensor([pendulum_dircol.TORQUE_LIMIT], dtype=dtype, device=device)
    res = ilqr.solve(dsys.g, rc, fc, system.default_params, problem.x0.expand(B, 2),
                     us_g[:, :-1], dt=h_mid, u_lower=-lim, u_upper=lim,
                     options=ilqr.IlqrOptions(max_iters=40))
    us_full = torch.cat([res.us, res.us[:, -1:]], dim=1)
    return problem.pack(torch.full((B,), h_mid, dtype=dtype, device=device), res.xs, us_full)


def solve(system, problem, z0s, options=OPTIONS, multi_start=False):
    """The batch's solutions; with `multi_start`, each lane's better of its
    guess and the plain straight line."""
    B = z0s.shape[0]
    if multi_start:
        z_base = problem.initial_guess(problem.x0, problem.xf, pendulum_dircol.TIMESPAN,
                                       z0s.dtype, z0s.device)
        z0s = torch.cat([z0s, z_base.expand(B, -1)])
    sol = dircol.solve(problem, system.default_params, z0s, options)
    if not multi_start:
        return sol
    pick = sol.constraint_violation[:B] <= sol.constraint_violation[B:]
    return dircol.DircolSolution(*(
        torch.where(pick.view((B,) + (1,) * (a.dim() - 1)), a[:B], a[B:]) for a in sol))


def run(batch: int = 32, z0s=None, device=None, seed: int = 0, warm_start=False,
        multi_start=False, feas_tol: float = 1e-3, options=OPTIONS) -> dict:
    """Warm-up, then the timed batch from `z0s` (numpy (batch, n); default
    ``draws(batch, seed)``), float32."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    system, problem, _, _ = pendulum_dircol.build_problem(torch.float32, device)
    z0s = torch.tensor(draws(batch, seed) if z0s is None else z0s, dtype=torch.float32,
                       device=device)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    solve(system, problem, z0s, dataclasses.replace(options, max_iters=WARMUP_ITERS))
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    guesses = ilqr_warm_start(system, problem, z0s) if warm_start else z0s
    sol = solve(system, problem, guesses, options, multi_start)
    sync()
    wall = time.perf_counter() - t0
    viol = sol.constraint_violation
    return {
        "batch": batch, "solves_per_s": batch / wall, "wall_s": wall,
        "feasible": int(torch.sum(viol < feas_tol)), "feas_tol": feas_tol,
        "success": int(torch.sum(sol.success)),
        "finite": bool(torch.isfinite(sol.xs).all() and torch.isfinite(sol.us).all()),
        "sqp_iterations_max": int(sol.iterations.max()),
        "sqp_iterations_median": float(torch.quantile(sol.iterations.double(), 0.5)),
        "max_violation": float(viol.max()),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "solution": sol, "z0s": z0s,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--feas-tol", type=float, default=1e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--warm-start", action="store_true")
    parser.add_argument("--multi-start", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_dircol_f32 runs on the card: no CUDA device")
    res = run(args.batch, seed=args.seed, warm_start=args.warm_start,
              multi_start=args.multi_start, feas_tol=args.feas_tol)
    res.pop("solution")
    res.pop("z0s")
    start = ("ilqr warm start" if args.warm_start else "2-start" if args.multi_start
             else "cold start")
    res["metric"] = (f"pendulum dircol f32 batch (21 knots, {start}, {res['feasible']}/{args.batch} "
                     f"feasible @ viol<{args.feas_tol}, one call)")
    res["card"] = card()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
