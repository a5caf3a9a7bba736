"""Parity of drake_tpu_torch's acrobot and cart-pole models, the acrobot
swing-up with TV-LQR (BASELINE config 2, ``examples/acrobot_swingup.py``)
and the LQR family's examples against drake_tpu's, on the CPU in float64.

The swing-up's stages are held apart, each fed the JAX stage's output: the
reference's dircol is chaotic in the last bit of its warm start (the JAX
example's own note, ``examples/acrobot_swingup.py:90-92``), so a whole
chain compares rounding as much as method.  The swing-up at full depth,
each port stage from the JAX stage's output, is the slow test at the end.  The examples run at a small
depth on the JAX package's own draws.

Tolerances (of the reference's largest magnitude where that exceeds 1):
- 1e-12 on the models (the same arithmetic in another order; the port's
  2x2 solve is elimination on m11, the reference's an LU);
- 1e-9 on the first iLQR iterations and the first SQP iterations, whose
  solves (Cholesky, LU, eigh) amplify rounding;
- 1e-9 on the TV-LQR gains about the same nominal: 600 Hamiltonian
  exponentials (``torch.linalg.matrix_exp`` against JAX's Pade 13, within
  1e-12 each) and 600 backward solves;
- 1e-8 on closed loops of hundreds of steps and on the examples' outputs.

torch and the port are imported when a test here runs, not when pytest
collects this file (see tests/test_torch_mpm_kernels.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from acrobot_reference import jax_swingup
from test_torch_multibody import close, run_jitted

F64 = jnp.float64
TOL = 1e-12
ITER_TOL = 1e-9
GAIN_TOL = 1e-9
LOOP_TOL = 1e-8
ILQR_ITERS = 3
SQP_ITERS = 2


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


def port_params(module, jparams):
    arrays = {f.name: np.asarray(getattr(jparams, f.name)) for f in dataclasses.fields(jparams)}
    return module.params_from_numpy(arrays, device="cpu")


# ---- the models ------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["acrobot", "cart_pole"])
def test_model_matches_jax(model):
    import importlib

    import torch

    jm = importlib.import_module(f"drake_tpu.models.{model}")
    tm = importlib.import_module(f"drake_tpu_torch.models.{model}")
    jp = jm.default_params(F64)
    tp = port_params(tm, jp)
    for name, value in tm.params_to_numpy(tp).items():
        close(value, np.asarray(getattr(jp, name)), 0.0)
    for name, value in tm.params_to_numpy(tm.default_params(torch.float64, "cpu")).items():
        close(value, np.asarray(getattr(jp, name)), 0.0)
    rng = np.random.default_rng(0)
    x = rng.uniform(-4.0, 4.0, (7, 4))
    u = rng.uniform(-10.0, 10.0, (7, 1))
    up = jm.upright_state(F64)

    def reference(x, u):
        out = {"dynamics": jax.vmap(lambda a, b: jm.dynamics(jp, a, b))(x, u),
               "mass_matrix": jax.vmap(lambda q: jm.mass_matrix(jp, q))(x[:, :2]),
               "linearize": jm.make_system(jp).linearize(jp, up, jnp.zeros(1, F64))}
        if model == "acrobot":
            out["bias_term"] = jax.vmap(lambda q, v: jm.bias_term(jp, q, v))(x[:, :2], x[:, 2:])
            out["total_energy"] = jax.vmap(lambda a: jm.total_energy(jp, a))(x)
        return out

    ref = run_jitted(reference, x, u)
    scaled(tm.dynamics(tp, t(x), t(u)), ref["dynamics"], TOL)
    scaled(tm.mass_matrix(tp, t(x[:, :2])), ref["mass_matrix"], TOL)
    if model == "acrobot":
        scaled(tm.bias_term(tp, t(x[:, :2]), t(x[:, 2:])), ref["bias_term"], TOL)
        scaled(tm.total_energy(tp, t(x)), ref["total_energy"], TOL)
    close(tm.upright_state(torch.float64, "cpu"), up, 0.0)
    tA, tB = tm.make_system(tp).linearize(tp, t(up), torch.zeros(1, dtype=torch.float64))
    scaled(tA, ref["linearize"][0], TOL)
    scaled(tB, ref["linearize"][1], TOL)


def test_spd_solve_is_the_mass_matrix_solve():
    """``solve_spd_2x2`` on the acrobot's mass matrices at many angles gives
    ``torch.linalg.solve``'s answer."""
    import torch

    from drake_tpu_torch.models import acrobot
    from drake_tpu_torch.utils.linalg import solve_spd_2x2

    p = acrobot.default_params(torch.float64, "cpu")
    q = torch.stack([torch.zeros(64, dtype=torch.float64),
                     torch.linspace(-7.0, 7.0, 64, dtype=torch.float64)], dim=-1)
    r = torch.randn((64, 2), dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    x0, x1 = solve_spd_2x2(*acrobot.mass_entries(p, q), r[:, 0], r[:, 1])
    ref = torch.linalg.solve(acrobot.mass_matrix(p, q), r.unsqueeze(-1)).squeeze(-1)
    close(torch.stack([x0, x1], dim=-1), ref.numpy(), 1e-13)


# ---- the swing-up's stages -----------------------------------------------------------

@pytest.fixture(scope="module")
def swingup():
    """The JAX stages at small depth: ILQR_ITERS iLQR iterations, the
    dircol guess from them, SQP_ITERS SQP iterations and the TV-LQR about
    their (infeasible but smooth) trajectory; and the port's example
    objects."""
    import torch

    from drake_tpu_torch.examples import acrobot_swingup as ex

    j = jax_swingup()
    warm = j["warm"](ILQR_ITERS, run_jitted)
    z0 = j["guess"](warm)
    res = j["sqp"](z0, SQP_ITERS, run_jitted)
    sol = j["solution"](res)
    T, bal, tv = j["stabilize"](sol, run_jitted)
    system, x0, xf = ex.build("cpu")
    return dict(j=j, warm=warm, z0=z0, res=res, sol=sol, T=T, bal=bal, tv=tv, ex=ex,
                system=system, x0=x0, xf=xf, torch=torch)


def test_build_matches_jax(swingup):
    s = swingup
    close(s["x0"], np.zeros(4), 0.0)
    close(s["xf"], s["j"]["xf"], 0.0)
    for name, value in s["ex"].acrobot.params_to_numpy(s["system"].default_params).items():
        close(value, np.asarray(getattr(s["j"]["params"], name)), 0.0)


def test_ilqr_warm_start_matches_jax(swingup):
    """Stage 1, its first ILQR_ITERS iterations from the same zero inputs."""
    from drake_tpu_torch.trajopt import ilqr

    s = swingup
    with s["torch"].no_grad():
        got = s["ex"].warm_start(s["system"], s["x0"][None], s["xf"],
                                 ilqr.IlqrOptions(max_iters=ILQR_ITERS, tol=1e-9))
    for name in ("xs", "us", "K", "k", "cost"):
        scaled(getattr(got, name)[0], getattr(s["warm"], name), ITER_TOL)
    assert int(got.iterations[0]) == int(s["warm"].iterations) == ILQR_ITERS


def test_dircol_guess_and_first_iterations_match_jax(swingup):
    """Stage 2: the guess from the JAX iLQR trajectory, and SQP_ITERS SQP
    iterations from the JAX guess."""
    s = swingup
    ex = s["ex"]
    problem = ex.dircol_problem(s["system"], s["x0"], s["xf"])
    close(ex.warm_guess(problem, t(s["warm"].xs)[None], t(s["warm"].us)[None])[0], s["z0"], 0.0)
    close(problem.bounds(s["torch"].float64, "cpu")[0], s["j"]["problem"].bounds(F64)[0], 0.0)
    with s["torch"].no_grad():
        sol = ex.polish(problem, t(s["z0"])[None],
                        dataclasses.replace(ex.SQP_OPTIONS, max_iters=SQP_ITERS))
    scaled(problem.pack(sol.h, sol.xs, sol.us)[0], s["res"].z, ITER_TOL)
    scaled(sol.cost[0], s["res"].cost, ITER_TOL)
    scaled(sol.constraint_violation[0], s["res"].constraint_violation, ITER_TOL)
    assert int(sol.iterations[0]) == int(s["res"].iterations) == SQP_ITERS


def port_solution(s):
    """The JAX stage 2's solution as the port's (one lane)."""
    from drake_tpu_torch.trajopt import dircol

    sol = s["sol"]
    return dircol.DircolSolution(h=t(sol.h)[None], xs=t(sol.xs)[None], us=t(sol.us)[None],
                                 cost=t(sol.cost)[None],
                                 constraint_violation=t(sol.constraint_violation)[None],
                                 success=t(sol.success)[None], iterations=None)


def test_stabilize_matches_jax(swingup):
    """Stage 3 about the JAX stage 2's trajectory: the 601-point nominal,
    the balancing LQR and the TV-LQR."""
    s = swingup
    with s["torch"].no_grad():
        T, bal, tv = s["ex"].stabilize(s["system"], s["xf"], port_solution(s))
    assert T == s["T"]
    scaled(tv.x0, s["tv"].x0, TOL)
    scaled(tv.u0, s["tv"].u0, TOL)
    scaled(bal.K, s["bal"].K, GAIN_TOL)
    scaled(bal.S, s["bal"].S, GAIN_TOL)
    for name in ("ts", "S", "K", "k0", "sx"):
        scaled(getattr(tv, name), getattr(s["tv"], name), GAIN_TOL)
    close(tv.ts, s["tv"].ts, 0.0)


def test_matrix_exp_matches_jax_expm():
    """The 601 Hamiltonian exponentials' algorithms: ``torch.linalg.matrix_exp``
    against ``jax.scipy.linalg.expm`` (Pade 13) on -dt H of the acrobot
    linearized at seeded states, dt = T / 600 of a 3.9 s swing-up."""
    import torch

    from drake_tpu.models import acrobot as ja

    jp = ja.default_params(F64)
    rng = np.random.default_rng(2)
    x = rng.uniform(-3.0, 3.0, (32, 4))
    u = rng.uniform(-12.0, 12.0, (32, 1))
    A, B = run_jitted(jax.vmap(jax.jacfwd(lambda a, b: ja.dynamics(jp, a, b), argnums=(0, 1))),
                      x, u)
    S = np.diag([10.0, 10.0, 1.0, 1.0])
    H = np.block([[np.asarray(A), -np.asarray(B @ B.transpose(0, 2, 1))],
                  [-np.broadcast_to(S, (32, 4, 4)), -np.asarray(A).transpose(0, 2, 1)]])
    dt = 3.86 / 600
    ref = run_jitted(jax.vmap(jax.scipy.linalg.expm), -dt * H)
    scaled(torch.linalg.matrix_exp(t(-dt * H)), ref, TOL)


def test_closed_loop_matches_jax(swingup):
    """Stage 4 with the JAX stage 3's gains: the first 800 steps at 1e-3
    from the perturbed start, TV-LQR throughout."""
    from drake_tpu_torch.control import lqr as tl

    s = swingup
    torch = s["torch"]
    tv = tl.FiniteHorizonLqrResult(**{f.name: t(getattr(s["tv"], f.name))
                                      for f in dataclasses.fields(tl.FiniteHorizonLqrResult)})
    bal = tl.LqrResult(K=t(s["bal"].K), S=t(s["bal"].S))
    steps = 800
    jxs, jus, _ = s["j"]["closed_loop"](s["T"], s["bal"], s["tv"], steps)
    x_init = s["x0"] + torch.tensor(s["ex"].PERTURB, dtype=torch.float64)
    with torch.no_grad():
        xs, us = s["ex"].closed_loop(s["system"], x_init[None], s["xf"], s["T"], bal, tv, steps)
    scaled(xs[0], jxs, LOOP_TOL)
    scaled(us[0], jus, LOOP_TOL)


# ---- the examples at small depth ---------------------------------------------------------

def test_cart_pole_example_matches_jax():
    """``examples/cart_pole_lqr.py`` on the JAX package's PRNGKey(0) draws,
    in full (800 steps, 256 lanes): the gain, the closed and open loops'
    errors, each lane's error and the example's gates."""
    import torch

    from drake_tpu.control import lqr as jl
    from drake_tpu.models import cart_pole as jc
    from drake_tpu.systems import simulator as jsim
    from drake_tpu_torch.examples import cart_pole_lqr

    params = jc.default_params(F64)
    system = jc.make_system(params)
    x_star = jc.upright_state(F64)
    A, B = system.linearize(params, x_star, jnp.zeros(1, F64))
    K = jl.lqr(A, B, jnp.diag(jnp.asarray([100.0, 50.0, 5.0, 5.0], F64)), jnp.eye(1)).K

    def scenario(x0):
        xs, _, _ = jsim.simulate_controlled(system, params, x0,
                                            lambda p, x, tt: -K @ (x - x_star), 800, 0.01)
        return jnp.linalg.norm(xs[-1] - x_star)

    perturb = np.array(0.2 * jax.random.normal(jax.random.PRNGKey(0), (256, 4), F64))
    x0 = x_star + jnp.asarray([0.1, 0.15, 0.0, 0.0], F64)
    err_cl = scenario(x0)
    xs_ol, _ = jsim.simulate(system, params, x0, jnp.zeros((800, 1), F64), 0.01)
    errs = run_jitted(jax.vmap(scenario), x_star[None] + perturb)
    out = cart_pole_lqr.run(torch.float64, "cpu", perturb=perturb)
    scaled(out["K"], K, GAIN_TOL)
    scaled(out["err_cl"], err_cl, LOOP_TOL)
    scaled(out["err_ol"], jnp.linalg.norm(xs_ol[-1] - x_star), LOOP_TOL)
    scaled(out["errs"], errs, LOOP_TOL)
    assert out["n_stable"] == int(np.sum(np.asarray(errs) < 5e-2))
    assert cart_pole_lqr.gates(out)


def test_spong_example_matches_jax():
    """``examples/acrobot_spong.py`` at 400 steps: the single swing-up and
    4 lanes from the JAX package's PRNGKey(0) draws, state for state."""
    import torch

    from drake_tpu.control.energy_shaping import acrobot_spong_controller
    from drake_tpu.models import acrobot as ja
    from drake_tpu.systems.simulator import simulate_controlled
    from drake_tpu_torch.examples import acrobot_spong

    steps, batch = 400, 4
    p = ja.default_params(F64)
    pol = acrobot_spong_controller(p)
    x0 = jnp.array([0.1, 0.0, 0.0, 0.0], F64)
    perturb = np.array(0.05 * jax.random.normal(jax.random.PRNGKey(0), (batch, 4), F64))
    finals = run_jitted(jax.vmap(lambda x: simulate_controlled(
        ja.make_system(p), p, x, lambda ps, xx, tt: pol(xx, tt), steps, 0.002)[0][-1]),
        jnp.concatenate([x0[None], x0 + perturb]))
    out = acrobot_spong.run(torch.float64, "cpu", batch, perturb, steps)
    scaled(out["xf"], finals[0], LOOP_TOL)
    wrap = lambda a: (a + np.pi) % (2 * np.pi) - np.pi  # noqa: E731
    errs = np.maximum(np.abs(wrap(finals[1:, 0] - np.pi)), np.abs(wrap(finals[1:, 1])))
    scaled(out["errs"], errs, LOOP_TOL)


def jax_spong_optimize(scenarios, candidates, iters, steps):
    """``examples/acrobot_spong_optimize.py``'s search at a small size:
    (base cost, each round's costs, best cost, draws fed to the port)."""
    from drake_tpu.control.energy_shaping import acrobot_spong_controller
    from drake_tpu.models import acrobot as ja
    from drake_tpu.systems import integrators

    p = ja.default_params(F64)
    system = ja.make_system(p)
    rk4 = integrators.get("rk4")

    def wrap(a, lo, hi):
        return (a - lo) % (hi - lo) + lo

    def rollout_cost(gains, x0):
        pol = acrobot_spong_controller(p, k_e=gains[0], k_p=gains[1], k_d=gains[2])
        xf, _ = jax.lax.scan(lambda x, _: (rk4(system.f, p, x, pol(x), 0.0, 2e-3), None), x0,
                             None, length=steps)
        return jnp.linalg.norm(jnp.stack([wrap(xf[0], 0.0, 2 * jnp.pi) - jnp.pi,
                                          wrap(xf[1], -jnp.pi, jnp.pi), xf[2], xf[3]]))

    key = jax.random.PRNGKey(7)
    x0s = 0.2 * jax.random.normal(key, (scenarios, 4), F64)
    ensemble = jax.jit(jax.vmap(lambda g: jnp.mean(jax.vmap(lambda x: rollout_cost(g, x))(x0s))))
    mean = jnp.log(jnp.array([5.0, 50.0, 5.0], F64))
    std = jnp.full(3, 0.4, F64)
    base = float(ensemble(jnp.exp(mean)[None])[0])
    best, rounds, eps = base, [], []
    for _ in range(iters):
        key, sub = jax.random.split(key)
        e = jax.random.normal(sub, (candidates, 3), F64)
        draws = mean + std * e
        costs = ensemble(jnp.exp(draws))
        best = min(best, float(jnp.min(costs)))
        elite = draws[jnp.argsort(costs)[:max(2, candidates // 4)]]
        mean, std = jnp.mean(elite, axis=0), jnp.std(elite, axis=0) + 0.02
        rounds.append(np.asarray(costs))
        eps.append(np.asarray(e))
    return base, rounds, best, (np.asarray(x0s), np.stack(eps))


def test_spong_optimize_example_matches_jax():
    """The CEM at 4 scenarios x 4 candidates, 2 rounds of 300 steps, on the
    JAX package's PRNGKey(7) stream: every round's ensemble costs."""
    import torch

    from drake_tpu_torch.examples import acrobot_spong_optimize

    base, rounds, best, noise = jax_spong_optimize(4, 4, 2, 300)
    out = acrobot_spong_optimize.run(torch.float64, "cpu", 4, 4, 2, noise, 300)
    scaled(out["base_cost"], base, LOOP_TOL)
    for got, ref in zip(out["rounds"], rounds):
        scaled(got, ref, LOOP_TOL)
    scaled(out["best_cost"], best, LOOP_TOL)
    assert out["lanes"] == 16


def test_estimator_example_matches_jax():
    """``examples/acrobot_lqr_estimator.py`` at 300 steps on the JAX
    package's noise (keys split from PRNGKey(0)): the gains, and the state,
    estimate and input of every step."""
    import torch

    from drake_tpu.control.estimators import luenberger_observer, steady_state_kalman_filter
    from drake_tpu.control.lqr import lqr
    from drake_tpu.models import acrobot as ja
    from drake_tpu.systems import integrators
    from drake_tpu_torch.examples import acrobot_lqr_estimator

    steps = 300
    p = ja.default_params(F64)
    system = ja.make_system(p)
    x_up = jnp.array([jnp.pi, 0.0, 0.0, 0.0], F64)
    A, B = system.linearize(p, x_up, jnp.zeros((1,), F64))
    K = lqr(A, B, jnp.diag(jnp.array([10.0, 10.0, 1.0, 1.0], F64)), jnp.eye(1, dtype=F64)).K
    C = jnp.concatenate([jnp.eye(2, dtype=F64), jnp.zeros((2, 2), F64)], 1)
    L = steady_state_kalman_filter(A, C, jnp.eye(4, dtype=F64), 0.1 * jnp.eye(2, dtype=F64)).L
    observe = luenberger_observer(system, p, L, C, 1e-3)
    rk4 = integrators.get("rk4")
    keys = jax.random.split(jax.random.PRNGKey(0), steps)
    noise = jax.vmap(lambda k: jax.random.normal(k, (2,), F64))(keys)

    def step(carry, n):
        x, xhat = carry
        u = -K @ (xhat - x_up)
        y = C @ x + 0.002 * n
        return (rk4(system.f, p, x, u, 0.0, 1e-3), observe(xhat, u, y)), (x, xhat, u)

    x0 = x_up + jnp.array([0.02, -0.01, 0.05, -0.05], F64)
    _, (xs, xhats, us) = run_jitted(lambda a, b: jax.lax.scan(step, (a, b), noise), x0, x_up)
    out = acrobot_lqr_estimator.run(torch.float64, "cpu", np.asarray(noise), steps)
    scaled(out["K"], K, GAIN_TOL)
    scaled(out["L"], L, GAIN_TOL)
    scaled(out["xs"], xs, LOOP_TOL)
    scaled(out["xhats"], xhats, LOOP_TOL)
    scaled(out["us"], us, LOOP_TOL)


def test_examples_draw_from_seeded_generators():
    from drake_tpu_torch.examples import (acrobot_lqr_estimator, acrobot_spong,
                                          acrobot_spong_optimize, cart_pole_lqr)

    close(cart_pole_lqr.draws(), cart_pole_lqr.draws().numpy(), 0.0)
    assert cart_pole_lqr.draws().shape == (256, 4)
    assert acrobot_spong.draws().shape == (64, 4)
    x0s, eps = acrobot_spong_optimize.draws()
    assert x0s.shape == (32, 4) and eps.shape == (4, 8, 3)
    assert acrobot_lqr_estimator.draws().shape == (5000, 2)


def test_cart_pole_example_runs_on_the_cpu(capsys):
    from drake_tpu_torch.examples import cart_pole_lqr

    assert cart_pole_lqr.main(["--cpu"]) == 0
    assert "CART-POLE LQR OK" in capsys.readouterr().out


# ---- the whole chain -------------------------------------------------------------------------

@pytest.mark.slow
def test_swingup_at_full_depth_matches_jax_example():
    """``examples/acrobot_swingup.py`` at full depth in the JAX package
    (about 2 min of CPU), which meets its gate, and the port's stages
    at full depth from the JAX stages' outputs: the 200-iteration iLQR (118
    iterations in both) within ITER_TOL; the TV-LQR about the JAX dircol
    solution within GAIN_TOL; its closed loop over all of T + 2 s within
    LOOP_TOL, under the gate.  The port's own dircol from the same guess
    is not held to the JAX one's end: both run all 300 iterations, and
    where each ends turns on rounding (ROADMAP, Reference traps)."""
    import torch

    from drake_tpu_torch.examples import acrobot_swingup as ex

    j = jax_swingup()
    warm = j["warm"](200)
    res = j["sqp"](j["guess"](warm), 300)
    sol = j["solution"](res)
    T, bal, tv = j["stabilize"](sol)
    steps = int((T + 2.0) / 1e-3)
    jxs, _, _ = j["closed_loop"](T, bal, tv, steps)
    jerr = float(jnp.linalg.norm(jxs[-1] - j["xf"]))
    assert bool(res.success) and jerr < 1e-3

    system, x0, xf = ex.build("cpu")
    s = dict(sol=sol)
    with torch.no_grad():
        got = ex.warm_start(system, x0[None], xf)
        T_, bal_, tv_ = ex.stabilize(system, xf, port_solution(s))
        xs, _ = ex.closed_loop(system, (x0 + torch.tensor(ex.PERTURB, dtype=torch.float64))[None],
                               xf, T_, bal_, tv_)
    scaled(got.xs[0], warm.xs, ITER_TOL)
    assert int(got.iterations[0]) == int(warm.iterations) == 118
    assert T_ == T
    for name in ("S", "K", "k0"):
        scaled(getattr(tv_, name), getattr(tv, name), GAIN_TOL)
    scaled(xs[0], jxs, LOOP_TOL)
    err = float(torch.linalg.vector_norm(xs[0, -1] - xf))
    assert abs(err - jerr) < 1e-8 and err < 1e-3


@pytest.mark.slow
def test_long_closed_loops_meet_the_reference_gates():
    """The closed loops that tier 1 holds only for their first steps:
    test_control.py:39's acrobot balance (8,000 steps, within 1e-4),
    test_control.py:54's quadrotor hover (6,000 steps, within 1e-5) and
    test_energy_shaping.py:44's Spong swing-up (12,000 steps, within 1e-2,
    |u| <= 20)."""
    import torch

    from drake_tpu_torch.control import lqr as tl
    from drake_tpu_torch.control.energy_shaping import acrobot_spong_controller
    from drake_tpu_torch.models import acrobot, quadrotor
    from drake_tpu_torch.systems import simulator

    p = acrobot.default_params(torch.float64, "cpu")
    system = acrobot.make_system(p)
    xu = acrobot.upright_state(torch.float64, "cpu")
    Q = torch.diag(torch.tensor([10.0, 10.0, 1.0, 1.0], dtype=torch.float64))
    res = tl.lqr_for_system(system, p, xu, torch.zeros(1, dtype=torch.float64), Q,
                            torch.eye(1, dtype=torch.float64))
    x_init = xu + torch.tensor([0.05, -0.05, 0.0, 0.0], dtype=torch.float64)
    pol = acrobot_spong_controller(p)
    with torch.no_grad():
        xs, _, _ = simulator.simulate_controlled(system, p, x_init[None],
                                                 lambda _, x, tt: -((x - xu) @ res.K.mT), 8000,
                                                 1e-3)
        assert float(torch.linalg.vector_norm(xs[0, -1] - xu)) < 1e-4
        xs, us, _ = simulator.simulate_controlled(
            system, p, torch.tensor([[0.1, 0.0, 0.0, 0.0]], dtype=torch.float64),
            lambda ps, x, tt: pol(x, tt), 12000, 0.002)
    xf = xs[0, -1].numpy()
    wrap = lambda a: (a + np.pi) % (2 * np.pi) - np.pi  # noqa: E731
    assert abs(wrap(xf[0] - np.pi)) < 1e-2 and abs(wrap(xf[1])) < 1e-2
    assert np.all(np.abs(xf[2:]) < 1e-2)
    assert float(us.abs().max()) <= 20.0 + 1e-9

    qp = quadrotor.default_params(torch.float64, "cpu")
    u0 = quadrotor.hover_input(qp)
    Qq = torch.diag(torch.tensor([10.0] * 6 + [1.0] * 6, dtype=torch.float64))
    hover = tl.lqr_for_system(quadrotor.make_system(qp), qp, torch.zeros(12, dtype=torch.float64),
                              u0, Qq, 0.1 * torch.eye(4, dtype=torch.float64))
    x_init = torch.zeros((1, 12), dtype=torch.float64)
    x_init[0, 0], x_init[0, 4] = 0.5, 0.1
    with torch.no_grad():
        xs, _, _ = simulator.simulate_controlled(quadrotor.make_system(qp), qp, x_init,
                                                 lambda _, x, tt: u0 - x @ hover.K.mT, 6000,
                                                 1e-3)
    assert float(torch.linalg.vector_norm(xs[0, -1])) < 1e-5
