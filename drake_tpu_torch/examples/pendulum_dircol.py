"""Pendulum swing-up by direct collocation, then PD tracking: BASELINE config 1.

The port of ``examples/pendulum_dircol.py`` (reference
examples/pendulum/trajectory_optimization_simulation.cc): 21 knots, equal
time steps in [0.2, 0.5] s, |u| <= 3 N m, running cost 10 u^2, swing from
[0, 0] to [pi, 0] by the Sl1QP solver from the straight-line guess; then the
trajectory's input plus PD tracking (Kp 10, Kd 1) of its Hermite state,
closed-loop through ``simulate_controlled`` at dt 1e-3, and the final
state's error.

    python -m drake_tpu_torch.examples.pendulum_dircol [--f32] [--cpu]

Float64 by default (the reference example's "CPU double"; the card computes
float64 natively), float32 with ``--f32``.  Prints the solve, its time and
SQP iterations, the closed loop's time and error, and ``SWING-UP SUCCESS``
(error < 1e-2, as the reference example) or ``FAILURE``; exits 1 on
FAILURE.
"""

from __future__ import annotations

import argparse
import math
import time

import torch

from drake_tpu_torch.models import pendulum
from drake_tpu_torch.solvers.sqp import SqpOptions
from drake_tpu_torch.systems import simulator
from drake_tpu_torch.trajopt import dircol
from drake_tpu_torch.utils.device import resolve_device

KNOTS = 21
TORQUE_LIMIT = 3.0
TIMESPAN = 4.0  # of the straight-line initial guess
KP, KD = 10.0, 1.0
DT_SIM = 1e-3
SUCCESS_ERR = 1e-2


def build_problem(dtype=torch.float64, device=None):
    """(system, problem, x0, xf) of the swing-up."""
    device = resolve_device(device)
    system = pendulum.make_system(pendulum.default_params(dtype, device))
    x0 = torch.tensor([0.0, 0.0], dtype=dtype, device=device)
    xf = torch.tensor([math.pi, 0.0], dtype=dtype, device=device)
    problem = dircol.DircolProblem(
        system=system,
        num_time_samples=KNOTS,
        minimum_time_step=0.2,
        maximum_time_step=0.5,
        running_cost=lambda x, u: 10.0 * u[0] ** 2,
        x0=x0,
        xf=xf,
        u_lower=torch.tensor([-TORQUE_LIMIT], dtype=dtype, device=device),
        u_upper=torch.tensor([TORQUE_LIMIT], dtype=dtype, device=device),
    )
    return system, problem, x0, xf


def track(system, sol: dircol.DircolSolution, x0, steps=None):
    """Closed loop from x0 (B, nx): the solution's first-order-hold input
    plus PD on its Hermite state, for the solution's duration (or its first
    `steps` steps).  Returns (xs, us, ts) of ``simulate_controlled``."""
    params = system.default_params

    def policy(_, x, t):
        u_ff = dircol.reconstruct_input(sol, t)
        x_des = dircol.reconstruct_state(sol, params, system, t)
        return u_ff + (KP * (x_des[..., 0] - x[..., 0]) + KD * (x_des[..., 1] - x[..., 1]))[..., None]

    if steps is None:
        steps = int(float(sol.h.max()) * (KNOTS - 1) / DT_SIM)
    return simulator.simulate_controlled(system, params, x0, policy, steps, DT_SIM)


def run(dtype=torch.float64, device=None, options: SqpOptions = SqpOptions()) -> dict:
    """The whole flow on one problem: the solve, its closed loop, their
    host-clock times (each ends in a synchronise) and the results."""
    device = resolve_device(device)
    system, problem, x0, xf = build_problem(dtype, device)
    z_init = problem.initial_guess(x0, xf, timespan=TIMESPAN, dtype=dtype, device=device)[None]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    sol = dircol.solve(problem, system.default_params, z_init, options)
    sync()
    t_solve = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.no_grad():  # on the card, utils.scan replays a step as a CUDA graph
        xs, us, ts = track(system, sol, x0[None])
    sync()
    t_track = time.perf_counter() - t0
    err = float(torch.linalg.vector_norm(xs[0, -1] - xf))
    return {"system": system, "problem": problem, "z_init": z_init, "sol": sol, "xs": xs,
            "solve_s": t_solve, "track_s": t_track, "err": err, "xf": xf}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--f32", action="store_true", help="float32 (default float64)")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = parser.parse_args(argv)
    out = run(torch.float32 if args.f32 else torch.float64, "cpu" if args.cpu else None)
    sol = out["sol"]
    h = float(sol.h[0])
    print(f"solve: success={bool(sol.success[0])} cost={float(sol.cost[0]):.4f} "
          f"viol={float(sol.constraint_violation[0]):.2e} h={h:.4f}s T={h * (KNOTS - 1):.2f}s "
          f"SQP iterations {int(sol.iterations[0])}")
    print(f"timing: solve {out['solve_s']:.2f} s, closed loop {out['track_s']:.2f} s "
          f"({out['xs'].shape[-2] - 1} steps)")
    print(f"|u| max = {float(sol.us.abs().max()):.3f} (limit {TORQUE_LIMIT})")
    print(f"closed-loop final state: {out['xs'][0, -1].tolist()}, target "
          f"{out['xf'].tolist()}, err {out['err']:.2e}")
    ok = out["err"] < SUCCESS_ERR
    print("SWING-UP", "SUCCESS" if ok else "FAILURE")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
