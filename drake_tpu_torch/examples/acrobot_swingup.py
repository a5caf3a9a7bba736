"""Acrobot swing-up by iLQR and direct collocation, stabilized by TV-LQR:
BASELINE config 2.

The port of ``examples/acrobot_swingup.py`` (the reference composes
DirectCollocation and FiniteHorizonLinearQuadraticRegulator on
AcrobotPlant, and hands off to the balancing LQR of
examples/acrobot/run_lqr.cc).  Its stages, each a function here:

1. ``warm_start``: iLQR from hanging rest to the upright, 150 knots of rk4
   at dt 0.02, |u| <= 12, 200 iterations at tol 1e-9 (the straight-line
   guess does not solve);
2. ``polish``: Hermite-Simpson dircol, 31 knots, h in [0.05, 0.2], cost
   u^2, by the Sl1QP solver (``SqpOptions(max_iters=300)``) from the iLQR
   trajectory sampled at the knots;
3. ``stabilize``: the solution resampled on 601 points, the balancing LQR
   at the upright (Q = diag(10, 10, 1, 1), R = [1]), and TV-LQR about the
   nominal with the balancing cost to go as its terminal cost;
4. ``closed_loop``: from the start perturbed by [0.02, -0.02, 0, 0], TV-LQR
   for the trajectory's T seconds, then the balancing LQR for 2 s more, at
   dt 1e-3 with |u| clipped to 20, through ``simulate_controlled``.

    python -m drake_tpu_torch.examples.acrobot_swingup [--cpu]

Float64, as the reference example (``jax_enable_x64``); on the card unless
``--cpu``.  Prints each stage with its seconds and iteration counts, the
closed loop's final error, and ``SWINGUP+TVLQR SUCCESS`` (final error below
1e-3, the reference's gate) or ``FAILURE``; exits 1 on FAILURE.
"""

from __future__ import annotations

import argparse
import time

import torch

from drake_tpu_torch.control import lqr as lqr_mod
from drake_tpu_torch.models import acrobot
from drake_tpu_torch.solvers.sqp import SqpOptions
from drake_tpu_torch.systems import base as sysbase
from drake_tpu_torch.systems import simulator
from drake_tpu_torch.trajopt import dircol, ilqr
from drake_tpu_torch.utils.device import resolve_device

DT_ILQR = 0.02
N_ILQR = 150
U_LIMIT = 12.0
ILQR_OPTIONS = ilqr.IlqrOptions(max_iters=200, tol=1e-9)
KNOTS = 31
# 300 majors: the acrobot NLP converges slowly from some iLQR warm starts (a
# warm start moved in its last bits took ~100 or ~200 iterations in the
# reference).
SQP_OPTIONS = SqpOptions(max_iters=300)
N_GRID = 600
Q_DIAG = (10.0, 10.0, 1.0, 1.0)
DT_SIM = 1e-3
HOLD_S = 2.0  # of the balancing LQR after the trajectory
PERTURB = (0.02, -0.02, 0.0, 0.0)
TORQUE_CLIP = 20.0
SUCCESS_ERR = 1e-3


def build(device=None):
    """(system, x0, xf): the acrobot in float64, hanging rest and upright."""
    device = resolve_device(device)
    system = acrobot.make_system(acrobot.default_params(torch.float64, device))
    return system, torch.zeros(4, dtype=torch.float64, device=device), acrobot.upright_state(
        torch.float64, device)


def _limits(x0):
    return (torch.full((1,), -U_LIMIT, dtype=x0.dtype, device=x0.device),
            torch.full((1,), U_LIMIT, dtype=x0.dtype, device=x0.device))


def warm_start(system, x0, xf, options: ilqr.IlqrOptions = ILQR_OPTIONS) -> ilqr.IlqrResult:
    """Stage 1: the iLQR swing-up from x0 (B, 4), zero initial inputs."""
    dsys = sysbase.discretize(system, DT_ILQR, "rk4")
    lo, hi = _limits(x0)
    return ilqr.solve(
        dsys.g,
        lambda p, x, u, t: 0.01 * torch.sum(u**2, dim=-1) + 0.1 * torch.sum((x - xf) ** 2, dim=-1),
        lambda p, x: 500.0 * torch.sum((x - xf) ** 2, dim=-1),
        system.default_params, x0, x0.new_zeros((x0.shape[0], N_ILQR, 1)), dt=DT_ILQR,
        u_lower=lo, u_upper=hi, options=options)


def dircol_problem(system, x0, xf) -> dircol.DircolProblem:
    lo, hi = _limits(x0)
    return dircol.DircolProblem(
        system=system, num_time_samples=KNOTS, minimum_time_step=0.05, maximum_time_step=0.2,
        running_cost=lambda x, u: 1.0 * u[0] ** 2, x0=x0, xf=xf, u_lower=lo, u_upper=hi)


def warm_guess(problem: dircol.DircolProblem, xs, us):
    """The dircol guess from an iLQR trajectory xs (B, 151, 4), us (B, 150,
    1): its knots every 5 steps, h = 3 s / 30."""
    idx = torch.linspace(0, N_ILQR, KNOTS, device=xs.device).long()
    return problem.pack(N_ILQR * DT_ILQR / (KNOTS - 1), xs[:, idx],
                        us[:, torch.clamp(idx, 0, N_ILQR - 1)])


def polish(problem: dircol.DircolProblem, z0, options: SqpOptions = SQP_OPTIONS):
    """Stage 2: the dircol solve from z0 (B, n)."""
    return dircol.solve(problem, problem.system.default_params, z0, options)


def stabilize(system, xf, sol: dircol.DircolSolution):
    """Stage 3 on lane 0 of `sol`: (T, the balancing LQR, the TV-LQR)."""
    params = system.default_params
    T = float(sol.h[0]) * (KNOTS - 1)
    ts = lqr_mod.linspace(0.0, T, N_GRID, xf)
    # Lane 0 at every time of the grid: the times are the lanes.
    grid = sol._replace(h=sol.h[:1].expand(N_GRID + 1), xs=sol.xs[:1].expand(N_GRID + 1, -1, -1),
                        us=sol.us[:1].expand(N_GRID + 1, -1, -1))
    xs_nom = dircol.reconstruct_state(grid, params, system, ts)
    us_nom = dircol.reconstruct_input(grid, ts)
    Q = torch.diag(torch.tensor(Q_DIAG, dtype=xf.dtype, device=xf.device))
    R = torch.ones((1, 1), dtype=xf.dtype, device=xf.device)
    bal = lqr_mod.lqr_for_system(system, params, xf, xf.new_zeros(1), Q, R)
    tvlqr = lqr_mod.finite_horizon_lqr(system, params, Q, R, t0=0.0, tf=T, num_steps=N_GRID,
                                       x0_traj=xs_nom, u0_traj=us_nom, Qf=bal.S)
    return T, bal, tvlqr


def policy(xf, T, bal, tvlqr):
    """TV-LQR until T, the balancing LQR after, clipped to +-20."""
    swing = lqr_mod.tvlqr_policy(tvlqr)

    def pi(_, x, t):
        u = torch.where(t < T, swing(None, x, t), -((x - xf) @ bal.K.mT))
        return torch.clamp(u, -TORQUE_CLIP, TORQUE_CLIP)

    return pi


def closed_loop(system, x_init, xf, T, bal, tvlqr, num_steps=None):
    """Stage 4 from x_init (B, 4): (xs, us) of ``simulate_controlled``."""
    num_steps = int((T + HOLD_S) / DT_SIM) if num_steps is None else num_steps
    xs, us, _ = simulator.simulate_controlled(system, system.default_params, x_init,
                                              policy(xf, T, bal, tvlqr), num_steps, DT_SIM)
    return xs, us


def run(device=None) -> dict:
    """The four stages on one problem, with each stage's seconds on the host
    clock (each ends in a synchronise)."""
    system, x0, xf = build(device)

    def sync():
        if x0.device.type == "cuda":
            torch.cuda.synchronize(x0.device)

    out, seconds = {"system": system, "x0": x0, "xf": xf}, {}
    with torch.no_grad():
        sync()
        t = time.perf_counter()
        out["warm"] = warm_start(system, x0[None], xf)
        sync()
        seconds["ilqr"] = time.perf_counter() - t
        problem = dircol_problem(system, x0, xf)
        out["z0"] = warm_guess(problem, out["warm"].xs, out["warm"].us)
        t = time.perf_counter()
        out["sol"] = polish(problem, out["z0"])
        sync()
        seconds["dircol"] = time.perf_counter() - t
        if bool(out["sol"].success[0]):
            t = time.perf_counter()
            out["T"], out["bal"], out["tvlqr"] = stabilize(system, xf, out["sol"])
            sync()
            seconds["tvlqr"] = time.perf_counter() - t
            x_init = x0 + torch.tensor(PERTURB, dtype=x0.dtype, device=x0.device)
            t = time.perf_counter()
            out["xs"], out["us"] = closed_loop(system, x_init[None], xf, out["T"], out["bal"],
                                               out["tvlqr"])
            sync()
            seconds["closed_loop"] = time.perf_counter() - t
            out["err"] = float(torch.linalg.vector_norm(out["xs"][0, -1] - xf))
    out["seconds"] = seconds
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = parser.parse_args(argv)
    out = run("cpu" if args.cpu else None)
    warm, sol, s = out["warm"], out["sol"], out["seconds"]
    print(f"iLQR warm start: final err {float(torch.linalg.vector_norm(warm.xs[0, -1] - out['xf'])):.3f}"
          f", {int(warm.iterations[0])} iterations, {s['ilqr']:.2f} s")
    print(f"dircol: success={bool(sol.success[0])} viol={float(sol.constraint_violation[0]):.1e} "
          f"cost={float(sol.cost[0]):.2f} T={float(sol.h[0]) * (KNOTS - 1):.2f}s, "
          f"{int(sol.iterations[0])} SQP iterations, {s['dircol']:.2f} s")
    if not bool(sol.success[0]):
        print("SWINGUP FAILURE (trajopt)")
        return 1
    print(f"TV-LQR: {N_GRID + 1} knots, {s['tvlqr']:.2f} s")
    print(f"closed loop from perturbed start: {out['xs'].shape[-2] - 1} steps in "
          f"{s['closed_loop']:.2f} s, final err {out['err']:.2e}")
    ok = out["err"] < SUCCESS_ERR
    print("SWINGUP+TVLQR", "SUCCESS" if ok else "FAILURE")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
