"""BASELINE config 3: the quadrotor obstacle MPC, solves/s on one card.

The port of ``benchmarks/bench_quadrotor_mpc.py``: batched receding-horizon
iLQR on the 12-state quadrotor (rk4 at dt 0.02, horizon 30, rotor forces in
[0, 4] N, hover warm start) flying from near the origin to the goal
[2, 0, 1] past a spherical obstacle of radius 0.4 m at [1, 0, 0.5] (cost
100 max(0, r^2 - d^2)^2).  The default schedule is the reference's
real-time iteration: one 8-iteration planning solve, then one RTI step per
MPC step; ``--no-rti`` runs 4-iteration iLQR at every step.  The whole batch
runs through ``control.mpc.ilqr_mpc_rollout`` in one call.

    python -m drake_tpu_torch.benchmarks.bench_quadrotor_mpc [--batch 512]
        [--steps 25] [--no-rti] [--draws FILE]

Prints one JSON line: batch * steps / wall solves/s (the host clock over the
timed rollout, after a 2-step warm-up, ending in a synchronise), the lanes
progressing (final distance to the goal below the initial one less 5 cm, as
the reference), frozen lanes, rejected plans, peak memory and the card.

Stated differences from the reference: the start offsets (0.2 N(0, 1) on
xyz) come from a ``torch.Generator`` seeded ``--seed`` (default 0), not from
JAX's ``PRNGKey(0)``; ``--draws`` reads given initial states instead (an
``.npz`` with ``x0s`` (B, 12), as ``tests/nlp_mpc_reference.py
--write-draws`` writes them).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from drake_tpu_torch.control import mpc
from drake_tpu_torch.models import quadrotor
from drake_tpu_torch.systems import base as sysbase
from drake_tpu_torch.trajopt import ilqr
from drake_tpu_torch.utils.device import card, resolve_device

DT = 0.02
HORIZON = 30
GOAL = (2.0, 0.0, 1.0)
OBSTACLE = (1.0, 0.0, 0.5)
R_OBS = 0.4
U_MAX = 4.0
PROGRESS = 0.05  # m: a lane progresses when it ends this much closer to the goal
WARMUP_STEPS = 2


def build(dtype=torch.float32, device=None) -> dict:
    """The bench's problem: params, the rk4 step, the costs, the warm start
    and the input bounds."""
    device = resolve_device(device)
    params = quadrotor.default_params(dtype, device)
    dsys = sysbase.discretize(quadrotor.make_system(params), DT, "rk4")
    u_h = quadrotor.hover_input(params)
    x_goal = torch.zeros(12, dtype=dtype, device=device)
    x_goal[[0, 1, 2]] = torch.tensor(GOAL, dtype=dtype, device=device)
    obst = torch.tensor(OBSTACLE, dtype=dtype, device=device)

    def running_cost(p, x, u, t):
        d2 = torch.sum((x[..., :3] - obst) ** 2, dim=-1)
        # torch.maximum splits its derivative at a tie, as jnp.maximum does,
        # so that the Hessian at the obstacle's surface is the reference's.
        pen = torch.maximum(torch.zeros_like(d2), R_OBS**2 - d2) ** 2 * 100.0
        return (0.05 * torch.sum((u - u_h) ** 2, dim=-1)
                + 0.05 * torch.sum((x - x_goal) ** 2, dim=-1) + pen)

    def final_cost(p, x):
        return 50.0 * torch.sum((x - x_goal) ** 2, dim=-1)

    return {
        "params": params, "step": dsys.g, "running_cost": running_cost,
        "final_cost": final_cost, "x_goal": x_goal, "obstacle": obst,
        "us0": u_h.expand(HORIZON, 4).clone(),
        "u_lower": torch.zeros(4, dtype=dtype, device=device),
        "u_upper": torch.full((4,), U_MAX, dtype=dtype, device=device),
    }


def draws(batch: int, seed: int = 0) -> np.ndarray:
    """Initial states (batch, 12): xyz 0.2 N(0, 1) from a generator seeded
    `seed`, the rest 0."""
    gen = torch.Generator().manual_seed(seed)
    x0s = np.zeros((batch, 12))
    x0s[:, :3] = 0.2 * torch.randn((batch, 3), generator=gen, dtype=torch.float64).numpy()
    return x0s


def rollout(prob: dict, x0s, steps: int, rti: bool = True, first_iters: int = 8,
            iters: int = 4) -> mpc.MpcRolloutResult:
    """The closed-loop MPC of every lane of x0s (B, 12) for `steps` steps."""
    if rti:
        options, first = ilqr.IlqrOptions(rti=True), ilqr.IlqrOptions(max_iters=first_iters)
    else:
        options, first = ilqr.IlqrOptions(max_iters=iters), None
    return mpc.ilqr_mpc_rollout(
        prob["step"], prob["running_cost"], prob["final_cost"], prob["params"], x0s,
        prob["us0"], steps, dt=DT, u_lower=prob["u_lower"], u_upper=prob["u_upper"],
        options=options, first_options=first)


def quality(res: mpc.MpcRolloutResult, x0s, prob: dict) -> dict:
    goal = prob["x_goal"][:3]
    init_err = torch.linalg.vector_norm(x0s[:, :3] - goal, dim=-1)
    final_err = torch.linalg.vector_norm(res.xs[:, -1, :3] - goal, dim=-1)
    return {
        "progressing": int(torch.sum(final_err < init_err - PROGRESS)),
        "finite": bool(torch.isfinite(res.xs).all() and torch.isfinite(res.us).all()),
        "frozen_lanes": int(torch.sum(res.frozen > 0)),
        "rejected_plans": int(torch.sum(res.plans_rejected)),
        "median_final_err": float(torch.quantile(final_err.double(), 0.5)),
    }


def run(batch: int = 512, steps: int = 25, rti: bool = True, x0s=None, device=None,
        dtype=torch.float32, seed: int = 0, first_iters: int = 8, iters: int = 4) -> dict:
    """Warm-up, then the timed rollout of `batch` lanes from `x0s` (numpy
    (batch, 12); default ``draws(batch, seed)``)."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    prob = build(dtype, device)
    x0s = torch.tensor(draws(batch, seed) if x0s is None else x0s, dtype=dtype, device=device)
    rollout(prob, x0s, WARMUP_STEPS, rti, first_iters, iters)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    res = rollout(prob, x0s, steps, rti, first_iters, iters)
    if cuda:
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    return {
        "batch": batch, "steps": steps, "horizon": HORIZON, "rti": rti,
        "solves_per_s": batch * steps / wall, "wall_s": wall, **quality(res, x0s, prob),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "result": res, "x0s": x0s,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=512)
    parser.add_argument("--steps", type=int, default=25)
    parser.add_argument("--iters", type=int, default=4)
    parser.add_argument("--rti", dest="rti", action="store_true", default=True)
    parser.add_argument("--no-rti", dest="rti", action="store_false")
    parser.add_argument("--first-iters", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--draws", help=".npz with x0s (B, 12): start from these states")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_quadrotor_mpc runs on the card: no CUDA device")
    x0s = None if args.draws is None else np.load(args.draws)["x0s"]
    batch = args.batch if x0s is None else x0s.shape[0]
    res = run(batch, args.steps, args.rti, x0s, seed=args.seed, first_iters=args.first_iters,
              iters=args.iters)
    res.pop("result")
    res.pop("x0s")
    res["metric"] = (f"quadrotor obstacle MPC solves/s (horizon={HORIZON}, batch={batch}"
                     f"{', RTI' if args.rti else ''}, {res['progressing']}/{batch} progressing)")
    res["card"] = card()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
