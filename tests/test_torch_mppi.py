"""Parity of the port's MPPI (drake_tpu_torch.control.mppi) against the JAX
package's drake_tpu.control.mppi, on the CPU in float64.

The port draws its perturbations apart from the update, so the tests feed
it JAX's own ``jax.random.normal`` draws, taken from the keys exactly as the
reference takes them (one key per scenario under ``vmap``; per MPC step
``split(key, num_steps)``, then ``split(k, iterations_per_step)``).

- ``mppi_step`` and ``mppi_mpc_rollout`` on a small nonlinear system (a
  damped pendulum-like double integrator), with and without smoothing and
  the clamp, 3 scenarios x 5 samples.
- ``mppi_mpc_rollout`` through config 5's coupled world (cut to a 16^3
  grid, 2 substeps a step; see tests/test_torch_coupled.py): 2 scenarios x 2
  samples, horizon 2, 2 MPC steps, with the costs of
  benchmarks/bench_coupled_mpc.py.

Tolerance: 1e-9 on controls, costs and states (float64; the coupled
rollout's rigid state 1e-9, particles as in test_torch_coupled.py).

torch and the port are imported when a test here runs, not when pytest
collects this file (see tests/test_torch_mpm_kernels.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_coupled import assert_particles_close, jax_paddle_world, port_paddle_world
from test_torch_multibody import close, run_jitted

TOL = 1e-9
B, M, H = 3, 5, 4


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch on one thread while these tests run: pytest-xdist runs several
    workers on the same cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def toy_dynamics(x, u):
    """x = [p, v] (..., 2), u (..., 1)."""
    p, v = x[..., 0], x[..., 1]
    return jnp.stack([p + 0.1 * v, v + 0.1 * (u[..., 0] - jnp.sin(p) - 0.2 * v)], axis=-1)


def toy_running(x, u):
    return x[..., 0] ** 2 + 0.1 * x[..., 1] ** 2 + 0.01 * u[..., 0] ** 2


def toy_final(x):
    return 10.0 * (x[..., 0] - 1.0) ** 2


def port_toy():
    import torch

    def dyn(x, u):
        p, v = x[..., 0], x[..., 1]
        return torch.stack([p + 0.1 * v, v + 0.1 * (u[..., 0] - torch.sin(p) - 0.2 * v)], dim=-1)

    return dyn, toy_running, toy_final


OPTIONS = {
    "plain": dict(num_samples=M, temperature=0.5, noise_sigma=1.0),
    "smooth_clamp": dict(num_samples=M, temperature=0.2, noise_sigma=(0.7,), smoothing=0.6,
                         u_lower=(-0.5,), u_upper=(0.8,)),
}


def jax_options(mppi, kw):
    kw = dict(kw)
    for name in ("u_lower", "u_upper", "noise_sigma"):
        if isinstance(kw.get(name), tuple):
            kw[name] = jnp.asarray(kw[name])
    return mppi.MppiOptions(**kw)


def rollout_noise(keys, num_steps, iterations, shape, dtype=jnp.float64):
    """The reference rollout's draws, (num_steps, iterations, B, ...)."""

    def per_scenario(key):
        ks = jax.random.split(key, num_steps)
        return jax.vmap(lambda k: jax.vmap(
            lambda kk: jax.random.normal(kk, shape, dtype)
        )(jax.random.split(k, iterations)))(ks)

    return np.moveaxis(np.asarray(jax.vmap(per_scenario)(keys)), 0, 2)


@pytest.mark.parametrize("case", sorted(OPTIONS))
def test_mppi_step_matches_jax(case):
    import torch

    from drake_tpu.control import mppi as jmppi
    from drake_tpu_torch.control import mppi as tmppi

    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((B, 2))
    u_nom = 0.3 * rng.standard_normal((B, H, 1))
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    jopts = jax_options(jmppi, OPTIONS[case])
    ref = jax.jit(jax.vmap(lambda x, u, k: jmppi.mppi_step(
        toy_dynamics, toy_running, toy_final, x, u, k, jopts)))(x0, u_nom, keys)
    noise = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (M, H, 1), jnp.float64))(keys))

    dyn, run, fin = port_toy()
    got = tmppi.mppi_step(dyn, run, fin, torch.tensor(x0), torch.tensor(u_nom),
                          torch.tensor(noise), tmppi.MppiOptions(**OPTIONS[case]))
    close(got.u_traj, ref.u_traj, TOL)
    close(got.cost, ref.cost, TOL)
    close(got.best_cost, ref.best_cost, TOL)
    if case == "smooth_clamp":
        assert float(got.u_traj.min()) >= -0.5 and float(got.u_traj.max()) <= 0.8


def test_mppi_mpc_rollout_matches_jax_with_two_iterations_per_step():
    import torch

    from drake_tpu.control import mppi as jmppi
    from drake_tpu_torch.control import mppi as tmppi

    steps, iters = 3, 2
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal((B, 2))
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    kw = OPTIONS["smooth_clamp"]
    jopts = jax_options(jmppi, kw)
    u0 = np.zeros((H, 1))
    states, us, costs = jax.jit(jax.vmap(lambda x, k: jmppi.mppi_mpc_rollout(
        toy_dynamics, toy_running, toy_final, x, jnp.asarray(u0), k, steps, jopts,
        iterations_per_step=iters)))(x0, keys)
    noise = rollout_noise(keys, steps, iters, (M, H, 1))

    dyn, run, fin = port_toy()
    t_states, t_us, t_costs = tmppi.mppi_mpc_rollout(
        dyn, run, fin, torch.tensor(x0), torch.zeros(B, H, 1, dtype=torch.float64), steps,
        tmppi.MppiOptions(**kw), iterations_per_step=iters, noise=torch.tensor(noise))
    close(t_states, states, TOL)
    close(t_us, us, TOL)
    close(t_costs, costs, TOL)


def test_sample_noise_follows_its_generator():
    import torch

    from drake_tpu_torch.control import mppi as tmppi

    u = torch.zeros(B, H, 2, dtype=torch.float64)
    opts = tmppi.MppiOptions(num_samples=M)
    draw = [tmppi.sample_noise(torch.Generator().manual_seed(9), u, opts) for _ in range(2)]
    assert draw[0].shape == (B, M, H, 2) and draw[0].dtype == torch.float64
    torch.testing.assert_close(draw[0], draw[1], rtol=0, atol=0)
    with pytest.raises(ValueError, match="noise"):
        tmppi.mppi_step(*port_toy(), torch.zeros(B, 2, dtype=torch.float64), u[..., :1],
                        draw[0], opts)


# ---------------------------------------------------------------------------
# MPPI through the coupled world (config 5, cut to size).
# ---------------------------------------------------------------------------

COUPLED = dict(scenarios=2, samples=2, horizon=2, steps=2)
DX0 = np.asarray([0.012, -0.008])


def jax_bench_costs(goal_x=0.55):
    """running and final cost of benchmarks/bench_coupled_mpc.py."""
    centroid_x = lambda s: jnp.mean(s.particles.x[:, 0])  # noqa: E731

    def running(s, u):
        cx = centroid_x(s)
        gap = cx - (s.rigid[0] + 0.02)
        approach_on = jax.nn.sigmoid((goal_x - 0.03 - cx) / 0.01)
        vx = jnp.mean(s.particles.v[:, 0])
        return (200.0 * (cx - goal_x) ** 2 + 5.0 * approach_on * gap * gap
                + 1.0 * (1.0 - approach_on) * vx * vx + 1e-6 * u[0] ** 2)

    return running, lambda s: 200.0 * (centroid_x(s) - goal_x) ** 2


@pytest.fixture(scope="module")
def coupled_rollout():
    from drake_tpu.contact import coupled_plant as jcp
    from drake_tpu.control import mppi as jmppi

    jworld, jparams, jparticles = jax_paddle_world()
    running, final = jax_bench_costs()
    opts = jmppi.MppiOptions(num_samples=COUPLED["samples"], temperature=0.05,
                             noise_sigma=8.0, u_lower=jnp.array([-25.0]),
                             u_upper=jnp.array([25.0]))
    keys = jax.random.split(jax.random.PRNGKey(1), COUPLED["scenarios"])

    def scenario(dx0, key):
        p = jparticles.replace(x=jparticles.x.at[:, 0].add(dx0))
        s0 = jcp.CoupledState(rigid=jnp.asarray([0.31, 0.0]).at[0].add(dx0), particles=p)
        return jmppi.mppi_mpc_rollout(
            lambda s, u: jworld.step(jparams, s, u), running, final, s0,
            jnp.zeros((COUPLED["horizon"], 1)), key, num_steps=COUPLED["steps"], options=opts)

    ref = run_jitted(jax.vmap(scenario), DX0, keys)
    noise = rollout_noise(keys, COUPLED["steps"], 1,
                          (COUPLED["samples"], COUPLED["horizon"], 1))
    return ref, noise


def test_coupled_mppi_rollout_matches_jax(coupled_rollout):
    """2 scenarios x 2 samples x horizon 2 x 2 MPC steps through the coupled
    world, the port fed the reference's draws: applied forces, best costs
    and the closed-loop states."""
    import torch

    from drake_tpu_torch.benchmarks import paddle_blob
    from drake_tpu_torch.control import mppi as tmppi

    (states, us, costs), noise = coupled_rollout
    w = port_paddle_world()
    s0 = paddle_blob.shifted(paddle_blob.lanes(w.state0, COUPLED["scenarios"]),
                             torch.tensor(DX0))
    opts = tmppi.MppiOptions(num_samples=COUPLED["samples"], temperature=0.05,
                             noise_sigma=8.0, u_lower=(-25.0,), u_upper=(25.0,))
    t_states, t_us, t_costs = tmppi.mppi_mpc_rollout(
        lambda s, u: w.world.step(w.params, s, u), w.running_cost, w.final_cost, s0,
        torch.zeros(COUPLED["scenarios"], COUPLED["horizon"], 1, dtype=torch.float64),
        COUPLED["steps"], opts, noise=torch.tensor(noise))
    assert np.abs(np.asarray(us)).max() > 1.0  # the controller acts
    close(t_us, us, TOL)
    close(t_costs, costs, TOL * max(1.0, float(np.abs(np.asarray(costs)).max())))
    close(t_states.rigid, states.rigid, TOL)
    assert_particles_close(t_states.particles, states.particles)


@pytest.mark.parametrize("bench", ["bench_coupled_mpc", "bench_coupled_world"])
def test_bench_runs_on_the_cpu(bench):
    """The benches' own run on the CPU at a few lanes and steps of the full
    world (float32): finite, nothing dropped, the fields the JSON line
    prints."""
    import importlib

    mod = importlib.import_module(f"drake_tpu_torch.benchmarks.{bench}")
    if bench == "bench_coupled_mpc":
        res = mod.run(scenarios=1, samples=2, steps=1, device="cpu")
        assert res["nonfinite"] == 0 and res["reached"] in (0, 1)
        assert res["us"].shape == (1, 1, 1) and np.isfinite(res["median_err"])
    else:
        res = mod.run(lanes=2, horizon=2, device="cpu")
        assert res["finite"] and res["substeps_per_s"] > 0
    assert res["dropped_max"] == 0 and res["device"] == "cpu"
    assert dataclasses.is_dataclass(res.get("final_state", res.get("states")).particles)
