"""Parity of drake_tpu_torch's interior-point QP, Sl1QP solver and direct
collocation against drake_tpu's, on the CPU: the pendulum swing-up of
BASELINE config 1 (``examples/pendulum_dircol.py``) and its float32 bench
(``benchmarks/bench_dircol_f32.py``).

Tolerances (float64 unless stated): the IPM on seeded random QPs, with and
without Ruiz equilibration and with refinement and the barrier clamp, w and
y within 1e-8 of their scale and equal per-lane iteration counts (the
duals too, but within 1e-6 under the clamp, where no lane converges); the
transcription's pieces 1e-12; the first SQP iterations from the same state
1e-8 of scale with equal counts; the whole swing-up (120 SQP iterations in
both packages) h, xs and us within 1e-6 with equal iteration counts, and the
closed loop that tracks it within 1e-6; the float32 bench at batch 4 (the
port's own draws): its first QPs solved in float32 within 1e-5 of scale
with equal counts (its lanes' outcomes are chaotic in float32 and are not
compared; see the test).

torch and the port are imported when a test here runs, not when pytest
collects this file (see tests/test_torch_mpm_kernels.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nlp_mpc_reference import jax_dircol
from test_torch_multibody import close, run_jitted

TOL = 1e-12
SOLVER_TOL = 1e-8
SWINGUP_TOL = 1e-6
F32_LANES = 4
# Float32 IPM against float32 IPM on the same QPs, which float32 does not
# solve to their 1e-8: a few float32 roundings of the scale apart.
F32_QP_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    import torch

    return torch.tensor(np.asarray(a))


def scaled(got, ref, tol):
    ref = np.asarray(ref)
    close(got, ref, tol * max(1.0, float(np.abs(ref).max())))


# ---- the interior-point QP ------------------------------------------------------

def random_qps(seed, B=6, n=10, m=4):
    """B feasible QPs: P = A A' + 0.1 I, bounds of every kind (both, lower
    only, upper only, none), b = G w0 for a w0 inside the bounds."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n))
    P = A @ A.transpose(0, 2, 1) / n + 0.1 * np.eye(n)
    q = 3.0 * rng.standard_normal((B, n))
    G = rng.standard_normal((B, m, n))
    w0 = rng.uniform(-0.5, 0.5, (B, n))
    lb = np.full((B, n), -np.inf)
    ub = np.full((B, n), np.inf)
    lb[:, : n // 2] = -1.0
    ub[:, n // 4 : 3 * n // 4] = 1.0
    return P, q, G, np.einsum("bmn,bn->bm", G, w0), lb, ub


IPM_CASES = {
    "plain": dict(max_iters=30, tol=1e-9),
    "ruiz": dict(max_iters=30, tol=1e-9, equilibrate=3),
    "refined": dict(max_iters=30, tol=1e-9, refine_steps=1),
    # The barrier clamp caps the accuracy (ipm.py's note): no lane reaches
    # 1e-9 and all stop at the cap, so the duals of the last iterate are
    # compared at their own float64 spread.
    "clamped": dict(max_iters=30, tol=1e-9, refine_steps=1, d_max=1e6),
}


@pytest.mark.parametrize("case", list(IPM_CASES))
def test_ipm_matches_jax(case):
    from drake_tpu.solvers import ipm as jipm
    from drake_tpu_torch.solvers import ipm as tipm

    data = random_qps(1)
    ref = run_jitted(jax.vmap(lambda *a: jipm.solve_qp_ipm(*a, jipm.IpmOptions(**IPM_CASES[case]))),
                     *data)
    got = tipm.solve_qp_ipm(*(t(a) for a in data), tipm.IpmOptions(**IPM_CASES[case]))
    for name in ("w", "y"):
        scaled(getattr(got, name), getattr(ref, name), SOLVER_TOL)
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    assert bool(got.converged.all()) == (case != "clamped")
    for name in ("z_lower", "z_upper"):
        scaled(getattr(got, name), getattr(ref, name), SOLVER_TOL if case != "clamped" else 1e-6)
    scaled(got.residual, ref.residual, SOLVER_TOL)


def test_ipm_lane_that_is_done_keeps_its_values():
    """A lane keeps its solution, bit for bit, while a harder lane of the
    same batch iterates on."""
    import torch

    from drake_tpu_torch.solvers import ipm as tipm

    data = [t(a) for a in random_qps(2, B=3)]
    hard = [a.clone() for a in data]
    hard[1][1] = hard[1][1] * 1e3  # lane 1's cost gradient scaled up: more iterations
    alone = tipm.solve_qp_ipm(*(a[:1] for a in data))
    both = tipm.solve_qp_ipm(*(torch.cat([a[:1], h[1:2]]) for a, h in zip(data, hard)))
    assert int(both.iterations[1]) > int(both.iterations[0])
    for name in ("w", "y", "z_lower", "z_upper", "iterations", "residual"):
        assert torch.equal(getattr(both, name)[0], getattr(alone, name)[0]), name


def test_psd_eig_clamp_matches_jax():
    from drake_tpu.solvers import sqp as jsqp
    from drake_tpu_torch.solvers import sqp as tsqp

    rng = np.random.default_rng(3)
    H = rng.standard_normal((4, 9, 9))
    H = H + H.transpose(0, 2, 1)
    scaled(tsqp._psd_eig_clamp(t(H), 1e-6), jax.vmap(lambda h: jsqp._psd_eig_clamp(h, 1e-6))(H),
           TOL)


# ---- the transcription --------------------------------------------------------

@pytest.fixture(scope="module")
def pendulum():
    """(JAX problem, JAX params, port system, port problem), float64."""
    import torch

    from drake_tpu_torch.examples import pendulum_dircol

    jproblem, jparams = jax_dircol(jnp.float64)
    system, problem, _, _ = pendulum_dircol.build_problem(torch.float64, "cpu")
    return jproblem, jparams, system, problem


def random_z(seed, B=3):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, 64))
    z[:, 0] = rng.uniform(0.2, 0.5, B)
    return z


@pytest.mark.parametrize("piece", ["defects", "constraints", "cost", "unpack"])
def test_transcription_matches_jax(pendulum, piece):
    jproblem, jparams, system, problem = pendulum
    z = random_z(4)
    fn = {
        "defects": (lambda p, zz: p.collocation_defects(jparams if p is jproblem else
                                                        system.default_params, zz)),
        "constraints": (lambda p, zz: p.constraints(zz, jparams if p is jproblem else
                                                    system.default_params)),
        "cost": lambda p, zz: p.cost(zz, None),
        "unpack": lambda p, zz: p.unpack(zz)[1],
    }[piece]
    ref = jax.vmap(lambda zz: fn(jproblem, zz))(z)
    import torch

    got = torch.func.vmap(lambda zz: fn(problem, zz))(t(z))
    scaled(got, ref, TOL)


def test_pack_bounds_and_initial_guess_match_jax(pendulum):
    import math

    import torch

    jproblem, jparams, system, problem = pendulum
    z = random_z(5)
    h, xs, us = problem.unpack(t(z))
    close(problem.pack(h, xs, us), z, 0.0)
    close(problem.pack(h[0], xs[0], us[0]), z[0], 0.0)
    for got, ref in zip(problem.bounds(torch.float64, "cpu"), jproblem.bounds(jnp.float64)):
        close(got, ref, 0.0)
    got = problem.initial_guess([0.0, 0.0], [math.pi, 0.0], 4.0, torch.float64, "cpu")
    close(got, jproblem.initial_guess(jnp.zeros(2), jnp.array([jnp.pi, 0.0]), 4.0, jnp.float64),
          TOL)


def test_defects_zero_on_exact_linear_system():
    """For xdot = -x, samples of the true solution have Hermite-Simpson
    defects O(h^4) (the JAX package's test_dircol.py)."""
    import torch

    from drake_tpu_torch.systems.base import ContinuousSystem
    from drake_tpu_torch.trajopt import dircol

    system = ContinuousSystem(f=lambda p, x, u, tt: -x, num_states=1, num_inputs=1)
    problem = dircol.DircolProblem(system=system, num_time_samples=11, minimum_time_step=0.01,
                                   maximum_time_step=0.01)
    ts = 0.01 * torch.arange(11, dtype=torch.float64)
    z = problem.pack(torch.tensor(0.01, dtype=torch.float64), torch.exp(-ts)[:, None],
                     torch.zeros((11, 1), dtype=torch.float64))
    assert float(problem.collocation_defects(None, z).abs().max()) < 1e-8


# ---- the SQP ------------------------------------------------------------------

def jitter_guesses(jproblem, B=3, seed=6):
    z0 = np.asarray(jproblem.initial_guess(jnp.zeros(2), jnp.array([jnp.pi, 0.0]), 4.0,
                                           jnp.float64))
    dz = 0.05 * np.random.default_rng(seed).standard_normal((B, z0.shape[0]))
    dz[0] = 0.0
    return z0[None] + dz


@pytest.mark.parametrize("iterations", [1, 6])
def test_first_sqp_iterations_match_jax(pendulum, iterations):
    """The first SQP iterations from the same states: the straight line and
    two jittered guesses, lam = 0, nu = 10."""
    import torch

    from drake_tpu.solvers import sqp as jsqp
    from drake_tpu_torch.solvers import sqp as tsqp

    jproblem, jparams, system, problem = pendulum
    z0 = jitter_guesses(jproblem)
    lb, ub = jproblem.bounds(jnp.float64)
    ref = run_jitted(jax.vmap(lambda z: jsqp.solve(
        jproblem.cost, jproblem.constraints, z, lb, ub,
        jsqp.SqpOptions(max_iters=iterations), args=(jparams,))), z0)
    tlb, tub = problem.bounds(torch.float64, "cpu")
    got = tsqp.solve(problem.cost, problem.constraints, t(z0), tlb, tub,
                     tsqp.SqpOptions(max_iters=iterations), args=(system.default_params,))
    for name in ("z", "lam", "cost", "constraint_violation"):
        scaled(getattr(got, name), getattr(ref, name), SOLVER_TOL)
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))


@pytest.fixture(scope="module")
def swingup(pendulum):
    """Both packages' swing-up from the straight line, float64, and their
    closed loops."""
    import torch

    from drake_tpu.solvers import sqp as jsqp
    from drake_tpu.systems import simulator as jsim
    from drake_tpu.trajopt import dircol as jdircol
    from drake_tpu_torch.examples import pendulum_dircol

    jproblem, jparams, system, problem = pendulum
    out = pendulum_dircol.run(torch.float64, "cpu")
    z0 = jproblem.initial_guess(jnp.zeros(2), jnp.array([jnp.pi, 0.0]), 4.0, jnp.float64)
    lb, ub = jproblem.bounds(jnp.float64)
    ref = run_jitted(lambda z: jsqp.solve(jproblem.cost, jproblem.constraints, z, lb, ub,
                                          jsqp.SqpOptions(), args=(jparams,)), z0)
    h, xs, us = jproblem.unpack(ref.z)
    jsol = jdircol.DircolSolution(h=h, xs=xs, us=us, cost=ref.cost,
                                  constraint_violation=ref.constraint_violation,
                                  success=ref.success)
    jsys = jproblem.system

    def policy(_, x, tt):
        u_ff = jdircol.reconstruct_input(jsol, tt)
        x_des = jdircol.reconstruct_state(jsol, jparams, jsys, tt)
        return u_ff + jnp.array([10.0 * (x_des[0] - x[0]) + 1.0 * (x_des[1] - x[1])])

    n = int(float(h) * 20 / 1e-3)
    jxs, _, _ = run_jitted(lambda x0: jsim.simulate_controlled(jsys, jparams, x0, policy, n, 1e-3),
                           jnp.zeros(2))
    return out, ref, jsol, jxs


def test_swingup_matches_jax(swingup):
    out, ref, jsol, _ = swingup
    sol = out["sol"]
    assert int(sol.iterations[0]) == int(ref.iterations) == 120
    close(sol.h[0], jsol.h, SWINGUP_TOL)
    close(sol.xs[0], jsol.xs, SWINGUP_TOL)
    close(sol.us[0], jsol.us, SWINGUP_TOL)
    close(sol.cost[0], ref.cost, SWINGUP_TOL * float(ref.cost))


def test_swingup_meets_the_reference_gates(swingup):
    """tests/test_dircol.py's gates, on the port's solve and closed loop."""
    out, _, _, _ = swingup
    sol = out["sol"]
    assert bool(sol.success[0])
    assert float(sol.constraint_violation[0]) < 1e-5
    assert float(sol.us.abs().max()) <= 3.0 + 1e-6
    assert 0.2 - 1e-9 <= float(sol.h[0]) <= 0.5 + 1e-9
    close(sol.xs[0, -1], [np.pi, 0.0], 1e-6)
    close(sol.xs[0, 0], [0.0, 0.0], 1e-6)
    assert out["err"] < 1e-3


def test_closed_loop_matches_jax(swingup):
    out, _, _, jxs = swingup
    assert out["xs"].shape[1:] == jxs.shape
    close(out["xs"][0], jxs, SWINGUP_TOL)


def test_reconstruction_matches_jax(pendulum, swingup):
    """The interpolants of the JAX solution, carried across, at the knots
    (where they hit the knot values) and between them."""
    import torch

    from drake_tpu.trajopt import dircol as jdircol
    from drake_tpu_torch.trajopt import dircol

    jproblem, jparams, system, _ = pendulum
    _, _, jsol, _ = swingup
    sol = dircol.DircolSolution(*(t(np.asarray(a)) for a in jsol), iterations=None)
    times = float(jsol.h) * np.array([0.0, 0.37, 7.0, 12.5, 19.99, 20.0, 21.0])
    for tt in times:
        close(dircol.reconstruct_input(sol, torch.tensor(tt)),
              jdircol.reconstruct_input(jsol, jnp.asarray(tt)), TOL)
        close(dircol.reconstruct_state(sol, system.default_params, system, torch.tensor(tt)),
              jdircol.reconstruct_state(jsol, jparams, jproblem.system, jnp.asarray(tt)), TOL)
    close(sol.times, jsol.times, TOL)


def test_f32_bench_first_qp_matches_jax():
    """The float32 bench at batch 4 (the port's own draws): the first SQP
    iteration's QPs, built by the port and solved in float32 by both
    packages' IPM with the bench's options (60 iterations, tol 1e-8, which
    float32 does not reach), agree within F32_QP_TOL of their scale, with
    equal iteration counts.

    The bench's outcome, lane by lane, cannot be held: the float32 solve is
    chaotic in the last bit.  On chip_smoke.py's 32 guesses the JAX
    package's own count of feasible lanes reads 17, and 16, 14, 13 and 17
    on the same guesses moved -2, -1, +1 and +2 ulps, each time on other
    lanes (``tests/nlp_mpc_reference.py --nudge 2``).  The feasible count
    over the 32 lanes is gated on the card instead (chip_smoke.py phase
    18c, at the lowest of those counts)."""
    import torch

    from drake_tpu.solvers import ipm as jipm
    from drake_tpu_torch.benchmarks import bench_dircol_f32
    from drake_tpu_torch.examples import pendulum_dircol
    from drake_tpu_torch.solvers import ipm as tipm
    from drake_tpu_torch.solvers import sqp as tsqp

    system, problem, _, _ = pendulum_dircol.build_problem(torch.float32, "cpu")
    lb, ub = problem.bounds(torch.float32, "cpu")
    z0s = torch.tensor(bench_dircol_f32.draws(F32_LANES))
    m = problem.constraints(z0s[0], system.default_params).shape[0]
    opts = bench_dircol_f32.OPTIONS
    data = tsqp.qp_at(problem.cost, problem.constraints, z0s, z0s.new_zeros((F32_LANES, m)),
                      torch.full((F32_LANES,), opts.penalty0), lb, ub, opts,
                      (system.default_params,))
    assert data[0].dtype == torch.float32
    jopts = jipm.IpmOptions(max_iters=opts.qp.max_iters, tol=opts.qp.tol)
    ref = run_jitted(jax.vmap(lambda *a: jipm.solve_qp_ipm(*a, jopts)),
                     *(jnp.asarray(a.numpy()) for a in data))
    got = tipm.solve_qp_ipm(*data, opts.qp)
    for name in ("w", "y"):
        scaled(getattr(got, name), getattr(ref, name), F32_QP_TOL)
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(ref.iterations))


def test_f32_bench_ilqr_warm_start_matches_jax(pendulum):
    """``--warm-start``: each lane's guess replaced by the 40-iteration iLQR
    swing-up of the JAX bench's ``warm`` (float64 here, 2 lanes)."""
    import torch

    from drake_tpu.systems import base as jbase
    from drake_tpu.trajopt import ilqr as jilqr
    from drake_tpu_torch.benchmarks import bench_dircol_f32

    jproblem, jparams, system, problem = pendulum
    z0 = jitter_guesses(jproblem, B=2, seed=7)
    h_mid = 4.0 / 20
    dsys = jbase.discretize(jproblem.system, h_mid, "rk4")

    def warm(z):
        _, _, us_g = jproblem.unpack(z)
        res = jilqr.solve(
            dsys.g, lambda p, x, u, tt: 10.0 * u[0] ** 2,
            lambda p, x: 200.0 * ((x[0] - jnp.pi) ** 2 + 0.2 * x[1] ** 2), jparams,
            jnp.zeros(2), us_g[:-1], dt=h_mid, u_lower=jnp.array([-3.0]),
            u_upper=jnp.array([3.0]), options=jilqr.IlqrOptions(max_iters=40))
        return jproblem.pack(jnp.asarray(h_mid), res.xs, jnp.concatenate([res.us, res.us[-1:]]))

    ref = run_jitted(jax.vmap(warm), z0)
    got = bench_dircol_f32.ilqr_warm_start(system, problem, torch.tensor(z0))
    scaled(got, ref, SOLVER_TOL)


def test_f32_bench_multi_start_keeps_the_lower_violation(pendulum):
    """``--multi-start``: both halves in one call of 2B lanes, each lane the
    better of its guess and the straight line (3 SQP iterations here)."""
    import dataclasses

    import torch

    from drake_tpu_torch.benchmarks import bench_dircol_f32
    from drake_tpu_torch.trajopt import dircol

    jproblem, _, system, problem = pendulum
    z0 = torch.tensor(jitter_guesses(jproblem, B=3, seed=8))
    z0[0] += 0.5  # lane 0 starts far off: the straight line wins there
    opts = dataclasses.replace(bench_dircol_f32.OPTIONS, max_iters=3)
    both = bench_dircol_f32.solve(system, problem, z0, opts, multi_start=True)
    own = dircol.solve(problem, system.default_params, z0, opts)
    line = dircol.solve(problem, system.default_params, problem.initial_guess(
        problem.x0, problem.xf, 4.0, torch.float64, "cpu").expand(3, -1), opts)
    pick = own.constraint_violation <= line.constraint_violation
    assert not bool(pick[0])
    for got, a, b in zip(both, own, line):
        close(got, torch.where(pick.view((3,) + (1,) * (a.dim() - 1)), a, b), 1e-12)
