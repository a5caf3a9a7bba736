"""The acrobot swing-up (BASELINE config 2, examples/acrobot_swingup.py) in
the JAX package and in the port, and how its dircol stage's outcome moves
with the last bits of its warm start.  Run by hand, not by pytest.

The dircol stage (31 knots, the Sl1QP solver, 300 iterations) is chaotic
in the last bit of the iLQR warm start in both packages: its penalty climbs
to ``penalty_max`` = 1e6, where the interior-point QP, which the solver
runs without Ruiz equilibration, no longer solves the elastic QP in its 50
iterations, and the SQP creeps by tiny steps until a QP happens to
solve.  Whether the violation ends below the example's 1e-5 after 300
iterations then turns on rounding.  ``--nudge K`` runs the dircol from the
warm-start guess moved k ulps (every entry, ``nextafter`` k times) for each
k from -K to K as lanes of one call, and prints each lane's final
violation and the count that meets the example's test.

The JAX package on the CPU (float64; prints one JSON line):

    JAX_PLATFORMS=cpu python tests/acrobot_reference.py --jax [--nudge 8]

The port on the card (no JAX imported), after ``--phases``: chip_smoke.py's
phase 19 alone, with its ``--profile`` part (19d):

    python tests/acrobot_reference.py --card [--nudge 8] [--phases]

``tests/test_torch_acrobot.py`` imports the JAX example's stages from here.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def jax_swingup():
    """The JAX example's objects (examples/acrobot_swingup.py:45-133), its
    stages as functions of a ``run(fn, *args)`` that compiles and calls."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from drake_tpu.control import lqr as jl
    from drake_tpu.models import acrobot as ja
    from drake_tpu.solvers import sqp as jsqp
    from drake_tpu.systems import base as jbase
    from drake_tpu.systems import simulator as jsim
    from drake_tpu.trajopt import dircol as jdircol
    from drake_tpu.trajopt import ilqr as jilqr

    f64 = jnp.float64
    system = ja.make_system(ja.default_params(f64))
    params = system.default_params
    x0 = jnp.zeros(4, f64)
    xf = ja.upright_state(f64)
    dsys = jbase.discretize(system, 0.02, "rk4")
    lo, hi = jnp.array([-12.0], f64), jnp.array([12.0], f64)

    def jit(fn, *args):
        return jax.jit(fn)(*args)

    def warm(iters, run=jit):
        return run(lambda x, us: jilqr.solve(
            dsys.g,
            lambda p, x_, u_, t_: 0.01 * jnp.sum(u_**2) + 0.1 * jnp.sum((x_ - xf) ** 2),
            lambda p, x_: 500.0 * jnp.sum((x_ - xf) ** 2), params, x, us, dt=0.02,
            u_lower=lo, u_upper=hi, options=jilqr.IlqrOptions(max_iters=iters, tol=1e-9),
        ), x0, jnp.zeros((150, 1), f64))

    problem = jdircol.DircolProblem(
        system=system, num_time_samples=31, minimum_time_step=0.05, maximum_time_step=0.2,
        running_cost=lambda x, u: 1.0 * u[0] ** 2, x0=x0, xf=xf, u_lower=lo, u_upper=hi)

    def guess(w):
        idx = jnp.linspace(0, 150, 31).astype(int)
        return problem.pack(jnp.asarray(150 * 0.02 / 30, f64), w.xs[idx],
                            w.us[jnp.clip(idx, 0, 149)])

    def sqp(z0, iters, run=jit):
        """The SQP from z0 (n,), or (L, n) as lanes of one vmapped call."""
        lb, ub = problem.bounds(f64)

        def solve(z):
            return jsqp.solve(problem.cost, problem.constraints, z, lb, ub,
                              jsqp.SqpOptions(max_iters=iters), args=(params,))

        return run(solve if z0.ndim == 1 else jax.vmap(solve), z0)

    def solution(res):
        h, xs, us = problem.unpack(res.z)
        return jdircol.DircolSolution(h=h, xs=xs, us=us, cost=res.cost,
                                      constraint_violation=res.constraint_violation,
                                      success=res.success)

    def stabilize(sol, run=lambda fn, *args: fn(*args)):
        """Stage 3, run eagerly by default: XLA's default optimization of
        the 600-step TV-LQR program takes minutes to compile on a CPU."""
        T = float(sol.h) * 30

        def stages(h, xs, us):
            s = sol._replace(h=h, xs=xs, us=us)
            ts = jnp.linspace(0.0, T, 601, dtype=f64)
            xs_nom = jax.vmap(lambda tt: jdircol.reconstruct_state(s, params, system, tt))(ts)
            us_nom = jax.vmap(lambda tt: jdircol.reconstruct_input(s, tt))(ts)
            Q = jnp.diag(jnp.asarray([10.0, 10.0, 1.0, 1.0], f64))
            R = jnp.asarray([[1.0]], f64)
            bal = jl.lqr_for_system(system, params, xf, jnp.zeros(1, f64), Q, R)
            tv = jl.finite_horizon_lqr(system, params, Q, R, t0=0.0, tf=T, num_steps=600,
                                       x0_traj=xs_nom, u0_traj=us_nom, Qf=bal.S)
            return (bal.K, bal.S), dataclasses.asdict(tv)

        (K, S), tv = run(stages, sol.h, sol.xs, sol.us)
        return T, jl.LqrResult(K=K, S=S), jl.FiniteHorizonLqrResult(**tv)

    def closed_loop(T, bal, tv, steps):
        swing = jl.tvlqr_policy(tv)

        def policy(_, x, tt):
            u = jnp.where(tt < T, swing(None, x, tt), -bal.K @ (x - xf))
            return jnp.clip(u, -20.0, 20.0)

        x_init = x0 + jnp.asarray([0.02, -0.02, 0.0, 0.0], f64)
        return jsim.simulate_controlled(system, params, x_init, policy, steps, 1e-3)

    return dict(warm=warm, guess=guess, sqp=sqp, solution=solution, stabilize=stabilize,
                closed_loop=closed_loop, problem=problem, params=params, xf=xf)


def nudged(z, k):
    """numpy z (n,) moved k ulps, every entry: (2k + 1, n) for -k..k."""
    import numpy as np

    lanes = []
    for j in range(-k, k + 1):
        zj = np.array(z, dtype=np.float64)
        for _ in range(abs(j)):
            zj = np.nextafter(zj, np.inf if j > 0 else -np.inf)
        lanes.append(zj)
    return np.stack(lanes)


def run_jax(nudge):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    j = jax_swingup()
    t0 = time.perf_counter()
    warm = j["warm"](200)
    z0 = j["guess"](warm)
    res = j["sqp"](z0, 300)
    sol = j["solution"](res)
    T, bal, tv = j["stabilize"](sol)
    xs, _, _ = j["closed_loop"](T, bal, tv, int((T + 2.0) / 1e-3))
    out = {"ilqr_iterations": int(warm.iterations), "sqp_iterations": int(res.iterations),
           "success": bool(res.success), "viol": float(res.constraint_violation),
           "cost": float(res.cost), "T": T,
           "err": float(jnp.linalg.norm(xs[-1] - j["xf"])),
           "seconds": time.perf_counter() - t0}
    if nudge:
        lanes = j["sqp"](jnp.asarray(nudged(np.asarray(z0), nudge)), 300)
        viol = np.asarray(lanes.constraint_violation)
        out["nudge"] = {"k": list(range(-nudge, nudge + 1)), "viol": viol.tolist(),
                        "success": int(np.sum(np.asarray(lanes.success)))}
    print(json.dumps(out))


def run_card(nudge, phases):
    import torch

    import chip_smoke as cs
    from drake_tpu_torch.examples import acrobot_swingup as ex

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    if phases:
        from drake_tpu_torch.control import lqr
        from drake_tpu_torch.examples import (acrobot_lqr_estimator, acrobot_spong,
                                              acrobot_spong_optimize, cart_pole_lqr)
        from drake_tpu_torch.ops import mpm_kernels as mk
        from drake_tpu_torch.trajopt import ilqr

        cs.lqr_parity(torch, dev, card)
        _, out = cs.swingup_phase(torch, ex, mk, dev, card)
        cs.family_phase(torch, (cart_pole_lqr, acrobot_spong, acrobot_lqr_estimator,
                                acrobot_spong_optimize), mk, dev, card)
        cs.swingup_profile(torch, ex, ilqr, lqr, out, dev, card)
        z0 = out["z0"]
    else:
        system, x0, xf = ex.build(dev)
        with torch.no_grad():
            warm = ex.warm_start(system, x0[None], xf)
        z0 = ex.warm_guess(ex.dircol_problem(system, x0, xf), warm.xs, warm.us)
    if nudge:
        system, x0, xf = ex.build(dev)
        lanes = torch.tensor(nudged(z0[0].cpu().numpy(), nudge), device=dev)
        t0 = time.perf_counter()
        sol = ex.polish(ex.dircol_problem(system, x0, xf), lanes)
        viol = sol.constraint_violation.cpu().numpy()
        print(json.dumps({"k": list(range(-nudge, nudge + 1)), "viol": viol.tolist(),
                          "success": int(sol.success.sum()),
                          "iterations": sol.iterations.tolist(),
                          "seconds": time.perf_counter() - t0, "card": card}))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--jax", action="store_true", help="the JAX package on the CPU")
    parser.add_argument("--card", action="store_true", help="the port on the card")
    parser.add_argument("--nudge", type=int, default=0)
    parser.add_argument("--phases", action="store_true",
                        help="with --card: chip_smoke.py's phase 19 and its profile first")
    args = parser.parse_args(argv)
    if args.jax:
        run_jax(args.nudge)
    elif args.card:
        run_card(args.nudge, args.phases)
    else:
        parser.error("--jax or --card")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
