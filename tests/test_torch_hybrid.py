"""Parity of drake_tpu_torch's error-controlled, hybrid and dense-output
simulation (systems/simulator.py) and of the rimless-wheel and compass-gait
demos against drake_tpu's, on the CPU in float64.

The cases are the JAX tests' (tests/test_hybrid.py, test_integrators.py's
adaptive cases and TestDenseOutput), run by both packages on the same numpy
inputs; lanes from a seed ride in the leading dimensions of the port's
state, where the JAX function runs under ``vmap``.  The demos run at a
short depth (2 s each) with the models of examples/rimless_wheel.py and
examples/compass_gait.py, written here for the JAX package as the examples
write them.

Tolerance: 1e-10 of the state's scale on trajectories, equal event, step
and reject counts.  The bisection resolves an event to dt 2^-24, and a
state that differs in its last bit may end a bisection on the other side
of a level: the two witnesses' case does so at its 3rd floor bounce
(1e-17 apart before it, 5.8e-9 in the speed after it, the same in both
packages from either state), so its bound is 1e-8 of scale.  The compass
gait's trajectory, whose dynamics the port takes in closed form and the
reference by autodiff (within 4e-15 of each other), within 1e-9.  The
adaptive integrator's gradient is the JAX package's forward-mode Jacobian
(its while_loop has no reverse mode) within 1e-8 of scale: each step's
size depends on the state, and the derivatives of the step-size rule
follow both packages' rounding of the error ratio.

torch and the port are imported when a test here runs, not when pytest
collects this file (see tests/test_torch_mpm_kernels.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_multibody import run_jitted

TOL = 1e-10
F64 = jnp.float64


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, ref, tol=TOL):
    got = got.detach().cpu().numpy() if hasattr(got, "detach") else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(1.0, float(np.max(np.abs(ref))))
    np.testing.assert_allclose(got, ref, rtol=0.0, atol=tol * scale)


def t(a):
    import torch

    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


# ---- the falling ball of tests/test_hybrid.py, in both packages ----------


def j_ball():
    from drake_tpu.systems.base import ContinuousSystem

    return ContinuousSystem(f=lambda p, x, u, t: jnp.stack([x[1], -9.81 + 0.0 * x[0]]),
                            num_states=2, num_inputs=0, num_q=1, num_v=1)


def t_ball():
    import torch

    from drake_tpu_torch.systems.base import ContinuousSystem

    return ContinuousSystem(
        f=lambda p, x, u, t: torch.stack([x[..., 1], -9.81 + 0.0 * x[..., 0]], dim=-1),
        num_states=2, num_inputs=0, num_q=1, num_v=1)


def j_bounce(e):
    from drake_tpu.systems.simulator import WitnessFunction

    return WitnessFunction(g=lambda p, x, t: x[0],
                           reset=lambda p, x, t: jnp.stack([jnp.maximum(x[0], 0.0), -e * x[1]]))


def t_bounce(e):
    import torch

    from drake_tpu_torch.systems.simulator import WitnessFunction

    return WitnessFunction(
        g=lambda p, x, t: x[..., 0],
        reset=lambda p, x, t: torch.stack([torch.clamp_min(x[..., 0], 0.0), -e * x[..., 1]], -1))


def j_ceiling():
    from drake_tpu.systems.simulator import WitnessFunction

    return WitnessFunction(g=lambda p, x, t: 0.5 - x[0],
                           reset=lambda p, x, t: jnp.stack([x[0], -x[1]]))


def t_ceiling():
    import torch

    from drake_tpu_torch.systems.simulator import WitnessFunction

    return WitnessFunction(g=lambda p, x, t: 0.5 - x[..., 0],
                           reset=lambda p, x, t: torch.stack([x[..., 0], -x[..., 1]], -1))


# (x0, t_final, dt, witnesses): tests/test_hybrid.py's cases, the two
# witnesses' with a lane that meets the ceiling first.
HYBRID_CASES = {
    "one_bounce": ([1.0, 0.0], 1.0, 0.01, (0.8,)),
    "repeated_bounces": ([0.3, 0.0], 1.05, 0.005, (0.7,)),
    "no_event": ([100.0, 0.0], 0.5, 0.01, (0.8,)),
    "two_witnesses": ([0.4, -2.0], 1.0, 0.005, (1.0, "ceiling")),
}


def _witnesses(spec, jax_side):
    out = []
    for w in spec:
        if w == "ceiling":
            out.append(j_ceiling() if jax_side else t_ceiling())
        else:
            out.append(j_bounce(w) if jax_side else t_bounce(w))
    return out


@pytest.mark.parametrize("case", list(HYBRID_CASES))
def test_simulate_hybrid_matches_jax(case):
    """The trace, the times and each witness's event count."""
    from drake_tpu.systems import simulator as jsim
    from drake_tpu_torch.systems import simulator as tsim

    x0, t_final, dt, spec = HYBRID_CASES[case]
    jxs, jts, jcounts = run_jitted(
        lambda x: jsim.simulate_hybrid(j_ball(), None, x, t_final, dt, _witnesses(spec, True)),
        jnp.asarray(x0, F64))
    xs, ts, counts = tsim.simulate_hybrid(t_ball(), None, t(x0), t_final, dt,
                                          _witnesses(spec, False))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    close(xs, jxs, 1e-8 if case == "two_witnesses" else TOL)
    close(ts, jts)


def test_simulate_hybrid_lanes_match_jax_vmap():
    """Lanes (the reference's vmap over initial heights and speeds,
    tests/test_hybrid.py:82): each lane's trace and counts; a lane without
    an event in a step where another lane has one takes the plain step."""
    from drake_tpu.systems import simulator as jsim
    from drake_tpu_torch.systems import simulator as tsim

    rng = np.random.default_rng(5)
    x0 = np.stack([rng.uniform(0.3, 2.0, 6), rng.uniform(-1.0, 1.0, 6)], axis=1)
    x0[0] = [100.0, 0.0]  # a lane that never lands
    spec = (0.8, "ceiling")
    jxs, _, jcounts = run_jitted(jax.vmap(
        lambda x: jsim.simulate_hybrid(j_ball(), None, x, 1.5, 0.01, _witnesses(spec, True))),
        jnp.asarray(x0))
    xs, _, counts = tsim.simulate_hybrid(t_ball(), None, t(x0), 1.5, 0.01,
                                         _witnesses(spec, False))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert counts[1:, 0].min() >= 1 and int(counts[0].sum()) == 0
    close(xs, jxs)


def test_simulate_hybrid_gradient_matches_jax():
    """d x_final / d x0 through two bounces, by reverse mode in both
    packages (the reference differentiates the branch it takes)."""
    import torch

    from drake_tpu.systems import simulator as jsim
    from drake_tpu_torch.systems import simulator as tsim

    def jfinal(x):
        return jsim.simulate_hybrid(j_ball(), None, x, 0.9, 0.01, [j_bounce(0.8)])[0][-1]

    x0 = np.array([0.7, 0.3])
    ref = run_jitted(jax.jacrev(jfinal), jnp.asarray(x0))
    x = t(x0).requires_grad_(True)
    got = torch.autograd.functional.jacobian(
        lambda x: tsim.simulate_hybrid(t_ball(), None, x, 0.9, 0.01, [t_bounce(0.8)])[0][-1], x)
    close(got, ref)


def oscillator_j(params, x, u, t):
    return jnp.stack([x[..., 1], -x[..., 0]], axis=-1)


def oscillator_t(params, x, u, t):
    import torch

    return torch.stack([x[..., 1], -x[..., 0]], dim=-1)


def adaptive_lanes(seed=7, lanes=5):
    rng = np.random.default_rng(seed)
    return np.concatenate([[[1.0, 0.0]], rng.standard_normal((lanes - 1, 2))])


@pytest.mark.parametrize("accuracy, t_final", [(1e-8, 2 * math.pi), (1e-6, 1.0)])
def test_simulate_adaptive_matches_jax(accuracy, t_final):
    """The oscillator of tests/test_integrators.py:121-139 over lanes: the
    final state, time, and each lane's step and reject counts."""
    import torch

    from drake_tpu.systems import simulator as jsim
    from drake_tpu.systems.base import ContinuousSystem as JCS
    from drake_tpu_torch.systems import simulator as tsim
    from drake_tpu_torch.systems.base import ContinuousSystem as TCS

    x0 = adaptive_lanes()
    jsys = JCS(f=oscillator_j, num_states=2, num_inputs=1)
    tsys = TCS(f=oscillator_t, num_states=2, num_inputs=1)
    jx, jstats = run_jitted(jax.vmap(lambda x: jsim.simulate_adaptive(
        jsys, None, x, lambda s, y: jnp.zeros(1, F64), t_final=t_final, accuracy=accuracy)),
        jnp.asarray(x0))
    x, stats = tsim.simulate_adaptive(
        tsys, None, t(x0), lambda s, y: torch.zeros(y.shape[:-1] + (1,), dtype=y.dtype),
        t_final=t_final, accuracy=accuracy)
    np.testing.assert_array_equal(stats["num_steps"].numpy(), np.asarray(jstats["num_steps"]))
    np.testing.assert_array_equal(stats["num_rejected"].numpy(),
                                  np.asarray(jstats["num_rejected"]))
    close(stats["final_time"], jstats["final_time"])
    close(x, jx)
    if accuracy == 1e-8:
        np.testing.assert_allclose(x[0].numpy(), [1.0, 0.0], atol=1e-6)


def test_simulate_adaptive_max_steps_bounds_the_loop():
    """A lane stopped by max_steps keeps its state, as the reference's."""
    import torch

    from drake_tpu.systems import simulator as jsim
    from drake_tpu.systems.base import ContinuousSystem as JCS
    from drake_tpu_torch.systems import simulator as tsim
    from drake_tpu_torch.systems.base import ContinuousSystem as TCS

    x0 = adaptive_lanes(8, 3)
    jx, jstats = run_jitted(jax.vmap(lambda x: jsim.simulate_adaptive(
        JCS(f=oscillator_j, num_states=2, num_inputs=1), None, x,
        lambda s, y: jnp.zeros(1, F64), t_final=50.0, accuracy=1e-9, max_steps=37)),
        jnp.asarray(x0))
    x, stats = tsim.simulate_adaptive(
        TCS(f=oscillator_t, num_states=2, num_inputs=1), None, t(x0),
        lambda s, y: torch.zeros(y.shape[:-1] + (1,), dtype=y.dtype), t_final=50.0,
        accuracy=1e-9, max_steps=37)
    np.testing.assert_array_equal(stats["num_steps"].numpy(), np.asarray(jstats["num_steps"]))
    assert int(stats["num_steps"].max()) == 37
    close(x, jx)
    close(stats["final_time"], jstats["final_time"])


def test_simulate_adaptive_gradient_matches_jax():
    """d x_final / d x0 through the error-controlled loop (the derivative
    of the step sizes included): JAX's forward mode against the port's
    reverse mode."""
    import torch

    from drake_tpu.systems import simulator as jsim
    from drake_tpu.systems.base import ContinuousSystem as JCS
    from drake_tpu_torch.systems import simulator as tsim
    from drake_tpu_torch.systems.base import ContinuousSystem as TCS

    def jfinal(x):
        return jsim.simulate_adaptive(JCS(f=oscillator_j, num_states=2, num_inputs=1), None, x,
                                      lambda s, y: jnp.zeros(1, F64), t_final=1.0)[0]

    x0 = np.array([1.0, 0.2])
    ref = run_jitted(jax.jacfwd(jfinal), jnp.asarray(x0))
    tsys = TCS(f=oscillator_t, num_states=2, num_inputs=1)
    got = torch.autograd.functional.jacobian(
        lambda x: tsim.simulate_adaptive(
            tsys, None, x, lambda s, y: torch.zeros(y.shape[:-1] + (1,), dtype=y.dtype),
            t_final=1.0)[0], t(x0))
    close(got, ref, 1e-8)


def test_dense_output_matches_jax():
    """TestDenseOutput's oscillator: the Hermite interpolant's values and
    derivatives between the knots, and the knots themselves."""
    import torch

    from drake_tpu.systems import simulator as jsim
    from drake_tpu.systems.base import ContinuousSystem as JCS
    from drake_tpu_torch.systems import simulator as tsim
    from drake_tpu_torch.systems.base import ContinuousSystem as TCS

    jsys = JCS(f=lambda p, x, u, t: jnp.array([x[1], -x[0]]), num_states=2, num_inputs=0)
    tsys = TCS(f=oscillator_t, num_states=2, num_inputs=0)
    x0 = np.array([1.0, 0.0])
    jxs, jts = jsim.simulate(jsys, None, jnp.asarray(x0), jnp.zeros((50, 0), F64), 0.1)
    jtraj = jsim.dense_output(jsys, None, jxs, jts, jnp.zeros((50, 0), F64))
    us = torch.zeros((50, 0), dtype=torch.float64)
    xs, ts = tsim.simulate(tsys, None, t(x0), us, 0.1)
    traj = tsim.dense_output(tsys, None, xs, ts, us)
    tq = np.concatenate([np.linspace(0.0, 5.0, 77), np.asarray(jts)])
    close(traj.value(t(tq)), jax.vmap(jtraj.value)(tq))
    close(traj.derivative_value(t(tq)), jax.vmap(jtraj.derivative_value)(tq))
    np.testing.assert_allclose(traj.value(t(tq[:77]))[:, 0].numpy(), np.cos(tq[:77]), atol=2e-5)


# ---- the demos at a short depth --------------------------------------------


def j_rimless(dtype=F64):
    """examples/rimless_wheel.py's model, as the example writes it."""
    from drake_tpu.systems.base import ContinuousSystem
    from drake_tpu.systems.simulator import WitnessFunction

    g, l, k, slope = 9.81, 1.0, 8, 0.08
    alpha = np.pi / k

    def f(params, x, u, t):
        return jnp.stack([x[1], (g / l) * jnp.sin(x[0])])

    touchdown = WitnessFunction(
        g=lambda p, x, t: (slope + alpha) - x[0],
        reset=lambda p, x, t: jnp.stack([jnp.asarray(slope - alpha, x.dtype),
                                         jnp.cos(2 * jnp.asarray(alpha, x.dtype)) * x[1]]),
        direction="positive_then_negative")
    return ContinuousSystem(f=f, num_states=2, num_inputs=0), touchdown


def test_rimless_wheel_matches_jax_over_2s():
    """The demo over 2 s (2,000 macro steps, two strikes) and a lane of
    other pushes: the trace, the strikes and the post-impact speed."""
    import torch

    from drake_tpu.systems.simulator import simulate_hybrid as jhybrid
    from drake_tpu_torch.examples import rimless_wheel

    pushes = np.array([1.2, 0.9, 1.6])
    system, touchdown = j_rimless()
    x0 = np.stack([np.full(3, 0.08 - np.pi / 8), pushes], axis=1)
    jxs, _, jcounts = run_jitted(
        jax.vmap(lambda x: jhybrid(system, None, x, 2.0, 1e-3, witnesses=(touchdown,))),
        jnp.asarray(x0))
    xs, counts = rimless_wheel.rollout(t(pushes), t_final=2.0)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert int(counts[0, 0]) >= 2
    close(xs, jxs)
    close(rimless_wheel.post_impact_speed(xs.numpy()),
          rimless_wheel.post_impact_speed(np.asarray(jxs)))
    out = rimless_wheel.run(device="cpu", dtype=torch.float64, t_final=2.0, verbose=False)
    assert out["strikes"] == int(jcounts[0, 0])


def j_compass_gait():
    """examples/compass_gait.py's model (the Lagrangian by autodiff), as the
    example writes it: (system, witness, heel_strike)."""
    from drake_tpu.systems.base import ContinuousSystem
    from drake_tpu.systems.simulator import WitnessFunction

    m, mh, a, b = 5.0, 10.0, 0.5, 0.5
    l = a + b
    gamma, grav = 0.0525, 9.81
    g_ramp = jnp.asarray([np.sin(gamma) * grav, -np.cos(gamma) * grav])
    masses = jnp.asarray([m, mh, m])

    def u_vec(th):
        return jnp.stack([jnp.sin(th), jnp.cos(th)])

    def mass_points(q):
        p_h = l * u_vec(q[0])
        return jnp.stack([a * u_vec(q[0]), p_h, p_h - b * u_vec(q[1])])

    def lagrangian(q, qd):
        v = jnp.einsum("pij,j->pi", jax.jacfwd(mass_points)(q), qd)
        ke = 0.5 * jnp.sum(masses[:, None] * v * v)
        return ke + jnp.sum(masses[:, None] * mass_points(q) * g_ramp[None, :])

    def dynamics(params, x, u, t):
        q, qd = x[:2], x[2:]
        M = jax.jacfwd(lambda qd_: jax.grad(lagrangian, argnums=1)(q, qd_))(qd)
        dLdq = jax.grad(lagrangian, argnums=0)(q, qd)
        dpdq = jax.jacfwd(lambda q_: jax.grad(lagrangian, argnums=1)(q_, qd))(q)
        return jnp.concatenate([qd, jnp.linalg.solve(M, dLdq - dpdq @ qd)])

    def cross2(p, v):
        return p[0] * v[1] - p[1] * v[0]

    def heel_strike(params, x, t):
        q, qd = x[:2], x[2:]
        P = mass_points(q)
        v = jnp.einsum("pij,j->pi", jax.jacfwd(mass_points)(q), qd)
        c = l * u_vec(q[0]) - l * u_vec(q[1])
        L1 = jnp.sum(jnp.stack([masses[i] * cross2(P[i] - c, v[i]) for i in range(3)]))
        L2 = m * cross2(P[0] - P[1], v[0])
        q_new = jnp.stack([q[1], q[0]])

        def post_momenta(qd_new):
            Pn = mass_points(q_new)
            vn = jnp.einsum("pij,j->pi", jax.jacfwd(mass_points)(q_new), qd_new)
            L1n = jnp.sum(jnp.stack([masses[i] * cross2(Pn[i], vn[i]) for i in range(3)]))
            return jnp.stack([L1n, m * cross2(Pn[2] - Pn[1], vn[2])])

        A_post = jax.jacfwd(post_momenta)(jnp.zeros(2, x.dtype))
        return jnp.concatenate([q_new, jnp.linalg.solve(A_post, jnp.stack([L1, L2]))])

    def guard(params, x, t):
        y_sw = l * (jnp.cos(x[0]) - jnp.cos(x[1]))
        return jnp.where((x[0] - x[1]) > 0.15, y_sw, jnp.ones_like(y_sw))

    return (ContinuousSystem(f=dynamics, num_states=4, num_inputs=0),
            WitnessFunction(g=guard, reset=heel_strike), heel_strike)


def compass_states(seed=60, n=6):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-0.4, 0.4, (n, 2)), rng.uniform(-2.5, 2.5, (n, 2))], 1)


def test_compass_gait_model_matches_jax():
    """The dynamics and the impact map at seeded states: the port's closed
    forms and its torch.func construction against the JAX autodiff."""
    from drake_tpu_torch.examples.compass_gait import Walker

    system, witness, heel_strike = j_compass_gait()
    x = compass_states()
    jf = run_jitted(jax.vmap(lambda y: system.f(None, y, None, 0.0)), jnp.asarray(x))
    jh = run_jitted(jax.vmap(lambda y: heel_strike(None, y, 0.0)), jnp.asarray(x))
    jg = jax.vmap(lambda y: witness.g(None, y, 0.0))(jnp.asarray(x))
    w = Walker(dtype=__import__("torch").float64, device="cpu")
    close(w.dynamics(None, t(x), None, 0.0), jf, 1e-12)
    close(w.autodiff_dynamics(None, t(x), None, 0.0), jf, 1e-12)
    close(w.heel_strike(None, t(x), 0.0), jh, 1e-12)
    close(w.autodiff_heel_strike(None, t(x), 0.0), jh, 1e-12)
    close(w.guard(None, t(x), 0.0), jg, 1e-14)


def test_compass_gait_matches_jax_over_2s():
    """The demo over 2 s (1,000 macro steps, three heel strikes): the
    trace and the strikes."""
    import torch

    from drake_tpu.systems.simulator import simulate_hybrid as jhybrid
    from drake_tpu_torch.examples import compass_gait

    system, witness, _ = j_compass_gait()
    x0 = np.asarray(compass_gait.X0)
    jxs, _, jcounts = run_jitted(
        lambda x: jhybrid(system, None, x, 2.0, 2e-3, witnesses=(witness,)), jnp.asarray(x0))
    out = compass_gait.run(device="cpu", dtype=torch.float64, t_final=2.0, verbose=False)
    assert out["strikes"] == int(jcounts[0]) == 3
    close(out["xs"], jxs, 1e-9)
