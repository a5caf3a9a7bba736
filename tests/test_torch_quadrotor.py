"""Parity of drake_tpu_torch's quadrotor obstacle MPC (BASELINE config 3,
``drake_tpu_torch.benchmarks.bench_quadrotor_mpc``) against the JAX
package's bench program (``tests/nlp_mpc_reference.py::jax_quadrotor``), on
the CPU in float64.

Tolerances: 1e-12 on the costs, their derivatives and the rk4 step's
Jacobian; 1e-8 of the largest magnitude on the closed-loop rollout (4
lanes from the port's own draws, 3 MPC steps: the 8-iteration first solve,
then RTI steps), whose iLQR solves make the same discrete choices in both
packages (equal iteration counts).

torch and the port are imported when a test here runs, not when pytest
collects this file (see tests/test_torch_mpm_kernels.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nlp_mpc_reference import jax_quadrotor
from test_torch_multibody import close, run_jitted

TOL = 1e-12
ROLLOUT_TOL = 1e-8
LANES = 4
STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bench():
    import torch

    from drake_tpu_torch.benchmarks import bench_quadrotor_mpc as bq

    return bq, bq.build(torch.float64, "cpu")


def jax_costs():
    """The JAX bench's step, costs and params, float64."""
    from drake_tpu.models import quadrotor
    from drake_tpu.systems import base as sysbase

    params = quadrotor.default_params(jnp.float64)
    dsys = sysbase.discretize(quadrotor.make_system(params), 0.02, "rk4")
    u_h = quadrotor.hover_input(params)
    x_goal = jnp.zeros(12, jnp.float64).at[0].set(2.0).at[2].set(1.0)
    obst = jnp.asarray([1.0, 0.0, 0.5], jnp.float64)

    def running_cost(p, x, u, t):
        d2 = jnp.sum((x[:3] - obst) ** 2)
        pen = jnp.maximum(0.0, 0.4**2 - d2) ** 2 * 100.0
        return 0.05 * jnp.sum((u - u_h) ** 2) + 0.05 * jnp.sum((x - x_goal) ** 2) + pen

    def final_cost(p, x):
        return 50.0 * jnp.sum((x - x_goal) ** 2)

    return params, dsys.g, running_cost, final_cost


def lanes(seed=0):
    """States near the obstacle (some inside its 0.4 m), inputs near hover."""
    rng = np.random.default_rng(seed)
    x = 0.3 * rng.standard_normal((6, 12))
    x[:, :3] += np.array([1.0, 0.0, 0.5])
    return x, 1.9 + 0.5 * rng.standard_normal((6, 4))


def test_costs_and_their_derivatives_match_jax(bench):
    import torch

    from drake_tpu_torch.trajopt import ilqr

    bq, prob = bench
    params, _, jrc, jfc = jax_costs()
    x, u = lanes()
    xu = np.concatenate([x, u], axis=1)

    def jc(z):
        return jrc(params, z[:12], z[12:], 0.0)

    ref, ref_fc, ref_g, ref_H = run_jitted(
        lambda z: (jax.vmap(jc)(z), jax.vmap(lambda a: jfc(params, a[:12]))(z),
                   jax.vmap(jax.grad(jc))(z), jax.vmap(jax.hessian(jc))(z)), xu)
    close(prob["running_cost"](None, torch.tensor(x), torch.tensor(u), 0.0), ref, TOL)
    close(prob["final_cost"](None, torch.tensor(x)), ref_fc, TOL)
    g, H = ilqr.cost_derivatives(prob["running_cost"], None, torch.tensor(x), torch.tensor(u),
                                 torch.zeros(6, dtype=torch.float64))
    close(g, ref_g, TOL)
    close(H, ref_H, TOL * max(1.0, float(np.abs(ref_H).max())))


def test_obstacle_penalty_hessian_at_the_surface_matches_jax(bench):
    """At d = r exactly the penalty's second derivative depends on how the
    max splits its derivative at the tie: torch.maximum halves it as
    jnp.maximum does (torch.clamp_min would give 4x)."""
    import torch

    bq, prob = bench
    params, _, jrc, _ = jax_costs()
    x = np.zeros(12)
    x[:3] = [1.0, 0.4, 0.5]  # 0.4 from the centre along y: d^2 == 0.4**2 in float64
    u = np.asarray(jnp.full(4, 1.9))

    def jc(z):
        return jrc(params, z[:12], z[12:], 0.0)

    ref = jax.hessian(jc)(np.concatenate([x, u]))
    got = torch.func.hessian(lambda z: prob["running_cost"](None, z[:12], z[12:], 0.0))(
        torch.tensor(np.concatenate([x, u])))
    close(got, ref, TOL)


def test_rk4_step_and_its_jacobian_match_jax(bench):
    import torch

    from drake_tpu_torch.trajopt import ilqr

    bq, prob = bench
    params, jstep, _, _ = jax_costs()
    x, u = lanes(1)
    ref, ref_J = run_jitted(
        lambda z: (jax.vmap(lambda a: jstep(params, a[:12], a[12:], 0.0))(z),
                   jax.vmap(jax.jacfwd(lambda a: jstep(params, a[:12], a[12:], 0.0)))(z)),
        np.concatenate([x, u], axis=1))
    out, J = ilqr.linearize(prob["step"], prob["params"], torch.tensor(x), torch.tensor(u),
                            torch.zeros(6, dtype=torch.float64))
    close(out, ref, TOL)
    close(J, ref_J, TOL * max(1.0, float(np.abs(ref_J).max())))


def test_draws_are_seeded_and_shaped(bench):
    bq, _ = bench
    a, b = bq.draws(8), bq.draws(8)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (8, 12) and not a[:, 3:].any()
    assert not np.array_equal(a, bq.draws(8, seed=1))


@pytest.mark.parametrize("rti", [True, False])
def test_bench_rollout_matches_jax(bench, rti):
    """The bench's closed loop from the port's draws: 3 MPC steps of the RTI
    schedule (an 8-iteration first solve, then RTI steps), or of plain
    4-iteration iLQR."""
    import torch

    bq, prob = bench
    x0s = bq.draws(LANES)
    rollout, _ = jax_quadrotor(jnp.float64, STEPS, rti=rti)
    ref = run_jitted(rollout, x0s)
    res = bq.rollout(prob, torch.tensor(x0s), STEPS, rti=rti)
    for name in ("xs", "us", "costs"):
        want = np.asarray(getattr(ref, name))
        close(getattr(res, name), want, ROLLOUT_TOL * max(1.0, float(np.abs(want).max())))
    np.testing.assert_array_equal(res.solve_iters.numpy(), np.asarray(ref.solve_iters))
    assert int(res.frozen.sum()) == 0 and int(res.plans_rejected.sum()) == 0
    q = bq.quality(res, torch.tensor(x0s), prob)
    assert q["finite"] and q["frozen_lanes"] == 0


def test_example_runs_on_the_cpu(capsys):
    """examples/quadrotor_mpc.py's port end to end at a small size: 4
    scenarios, 2 MPC steps (too short to progress, so it reports FAILURE
    and exits 1, as the reference would)."""
    from drake_tpu_torch.examples import quadrotor_mpc

    code = quadrotor_mpc.main(["--batch", "4", "--steps", "2", "--cpu"])
    out = capsys.readouterr().out
    assert "progressing 0/4" in out and "QUADROTOR-MPC FAILURE" in out and code == 1
