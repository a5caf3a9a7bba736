"""Parity of drake_tpu_torch's system primitives (systems/primitives.py),
composition combinators (systems/diagram.py) and classical controllers
(control/controllers.py) against drake_tpu's, on the CPU in float64.

The cases are drawn from the JAX tests (tests/test_components.py's
Primitives, Controllers and Diagram classes, tests/test_primitive_blocks.py),
run by both packages on the same numpy inputs from a seed; the port maps
lanes in the leading dimensions where the JAX function runs under ``vmap``.
The MLP's weights are the JAX package's draws (the port draws from a
``torch.Generator``).  The controllers act on a two-link arm built by both
packages' ModelBuilders.

Tolerance: 1e-10 of the answer's scale (of 1 at least), far above float64
rounding of the same arithmetic in another order.

torch and the port are imported when a test here runs, not when pytest
collects this file (see tests/test_torch_mpm_kernels.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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
    scale = max(1.0, float(np.max(np.abs(ref)))) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=0.0, atol=tol * scale)


def t(a):
    import torch

    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def lti(seed, n=3, m=2, p=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n)), rng.standard_normal((n, m)), rng.standard_normal((p, n)),
            rng.standard_normal((p, m)), rng.standard_normal(n), rng.standard_normal(p),
            rng.standard_normal((6, n)), rng.standard_normal((6, m)))


@pytest.mark.parametrize("kind", ["linear", "affine", "discrete"])
def test_lti_systems_match_jax(kind):
    """Dynamics (or update) and output of LinearSystem, AffineSystem and
    the discrete linear system over lanes."""
    from drake_tpu.systems import primitives as jp
    from drake_tpu_torch.systems import primitives as tp

    A, B, C, D, f0, y0, x, u = lti({"linear": 1, "affine": 2, "discrete": 3}[kind])
    if kind == "linear":
        js, ts = jp.linear_system(A, B, C, D), tp.linear_system(A, B, C, D, device="cpu")
    elif kind == "affine":
        js, ts = (jp.affine_system(A, B, f0, C, D, y0),
                  tp.affine_system(A, B, f0, C, D, y0, device="cpu"))
    else:
        js, ts = jp.discrete_linear_system(A, B, 0.1), tp.discrete_linear_system(A, B, 0.1,
                                                                              device="cpu")
    fj = js.f if kind != "discrete" else js.g
    ft = ts.f if kind != "discrete" else ts.g
    close(ft(None, t(x), t(u)), jax.vmap(lambda a, b: fj(None, a, b))(x, u))
    if kind != "discrete":
        close(ts.output(None, t(x), t(u)), jax.vmap(lambda a, b: js.output(None, a, b))(x, u))
    assert (ts.num_states, ts.num_inputs) == (js.num_states, js.num_inputs)


def test_linear_system_simulation_and_linearize():
    """test_components.py's oscillator omega = 2 over 1,000 rk4 steps, and
    Linearize of the affine system."""
    from drake_tpu.systems import primitives as jp
    from drake_tpu.systems import simulator as jsim
    from drake_tpu_torch.systems import primitives as tp
    from drake_tpu_torch.systems import simulator as tsim

    A, B = np.array([[0.0, 1.0], [-4.0, 0.0]]), np.zeros((2, 1))
    jxs, _ = jsim.simulate(jp.linear_system(A, B), None, jnp.asarray([1.0, 0.0]),
                           jnp.zeros((1000, 1)), 1e-3)
    xs, _ = tsim.simulate(tp.linear_system(A, B, device="cpu"), None, t([1.0, 0.0]),
                          t(np.zeros((1000, 1))), 1e-3)
    close(xs, jxs)
    np.testing.assert_allclose(float(xs[-1, 0]), np.cos(2.0), atol=1e-4)
    A, B, _, _, f0, _, x, u = lti(4)
    jA, jB = jp.linearize(jp.affine_system(A, B, f0), None, x[0], u[0])
    tA, tB = tp.linearize(tp.affine_system(A, B, f0, device="cpu"), None, t(x[0]), t(u[0]))
    close(tA, jA)
    close(tB, jB)


def test_mlp_matches_jax_on_its_draws():
    """mlp_apply on the JAX package's mlp_init draws, over lanes, and the
    gradient of a loss in the weights."""
    import torch

    from drake_tpu.systems import primitives as jp
    from drake_tpu_torch.systems import primitives as tp

    jparams = jp.mlp_init(jax.random.PRNGKey(0), [3, 16, 8, 2], dtype=F64)
    tparams = tp.MlpParams(weights=tuple(t(w) for w in jparams.weights),
                           biases=tuple(t(b) for b in jparams.biases))
    x = np.random.default_rng(5).standard_normal((7, 3))
    close(tp.mlp_apply(tparams, t(x)), jp.mlp_apply(jparams, jnp.asarray(x)))
    jg = jax.grad(lambda p: jnp.sum(jp.mlp_apply(p, jnp.asarray(x)) ** 2))(jparams)
    ws = [w.clone().requires_grad_(True) for w in tparams.weights]
    loss = torch.sum(tp.mlp_apply(tp.MlpParams(weights=tuple(ws), biases=tparams.biases),
                                  t(x)) ** 2)
    for g, ref in zip(torch.autograd.grad(loss, ws), jg.weights):
        close(g, ref)
    # The port's own draws: the reference's shapes and scaling.
    mine = tp.mlp_init(torch.Generator().manual_seed(0), [3, 16, 2], dtype=torch.float64,
                       device="cpu")
    assert [w.shape for w in mine.weights] == [(3, 16), (16, 2)]
    assert all(float(b.abs().max()) == 0.0 for b in mine.biases)


def test_random_source_shapes_and_ranges():
    import torch

    from drake_tpu_torch.systems import primitives as tp

    g = torch.Generator().manual_seed(3)
    u = tp.random_source(g, (1000, 2), "uniform", device="cpu")
    n = tp.random_source(g, (1000, 2), device="cpu")
    assert u.shape == n.shape == (1000, 2)
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    assert abs(float(n.mean())) < 0.1 and abs(float(n.std()) - 1.0) < 0.1
    with pytest.raises(ValueError):
        tp.random_source(g, (2,), "cauchy", device="cpu")
    with pytest.raises(NotImplementedError, match="math/symbolic"):
        tp.symbolic_vector_system([], [])


def test_stateless_blocks_match_jax():
    """test_primitive_blocks.py's stateless blocks, on seeded vectors."""
    import torch

    from drake_tpu.systems import primitives as jp
    from drake_tpu_torch.systems import primitives as tp

    rng = np.random.default_rng(6)
    a, b, c = rng.standard_normal((3, 4)) * 3.0
    close(tp.adder(t(a), t(b), t(c)), jp.adder(a, b, c))
    close(tp.gain(2.5, t(a)), jp.gain(2.5, a))
    close(tp.gain(t(b), t(a)), jp.gain(b, a))
    close(tp.saturation(t(a), -1.0, 1.0), jp.saturation(a, -1.0, 1.0))
    close(tp.pass_through(t(a)), jp.pass_through(a))
    mux = tp.multiplexer(t(a[:2]), 3.0, t(b[:1]))
    close(mux, jp.multiplexer(a[:2], 3.0, b[:1]))
    for got, ref in zip(tp.demultiplexer(mux, [2, 1, 1]),
                        jp.demultiplexer(jp.multiplexer(a[:2], 3.0, b[:1]), [2, 1, 1])):
        close(got, ref)
    for i in (0, 1, 2):
        close(tp.port_switch(torch.tensor(i), t(a), t(b), t(c)), jp.port_switch(i, a, b, c))
    close(tp.wrap_to_system(t(a), -np.pi, np.pi, indices=[0, 2]),
          jp.wrap_to_system(a, -np.pi, np.pi, indices=[0, 2]))
    close(tp.wrap_to_system(t(a), -1.0, 2.0), jp.wrap_to_system(a, -1.0, 2.0))


def test_sources_and_holds_match_jax():
    """Constant and sine sources, first- and zero-order holds and the
    trajectory source at seeded times, the breaks and past both ends."""
    from drake_tpu.math.trajectories import PiecewisePolynomial as JPP
    from drake_tpu.systems import primitives as jp
    from drake_tpu_torch.math.trajectories import PiecewisePolynomial as TPP
    from drake_tpu_torch.systems import primitives as tp

    rng = np.random.default_rng(7)
    times = np.cumsum(rng.uniform(0.1, 0.5, 6))
    values = rng.standard_normal((6, 3))
    ts = np.concatenate([times, [times[0] - 1.0, times[-1] + 1.0], rng.uniform(0, 3, 9)])
    close(tp.constant_vector_source(values[0], device="cpu")(1.0),
          jp.constant_vector_source(values[0])(1.0))
    sine_t, sine_j = tp.sine_source(values[1], 0.7, 0.3, device="cpu"), jp.sine_source(
        values[1], 0.7, 0.3)
    for s in ts[:5]:
        close(sine_t(float(s)), sine_j(s))
    foh_t, foh_j = tp.first_order_hold(times, values, device="cpu"), jp.first_order_hold(
        times, values)
    close(foh_t(t(ts)), jax.vmap(foh_j)(ts))
    zoh_t, zoh_j = tp.zero_order_hold(values, 0.25, device="cpu"), jp.zero_order_hold(
        values, 0.25)
    close(zoh_t(t(np.abs(ts))), jax.vmap(zoh_j)(np.abs(ts)))
    src_t = tp.trajectory_source(TPP.first_order_hold(times, values, device="cpu"))
    src_j = jp.trajectory_source(JPP.first_order_hold(jnp.asarray(times), jnp.asarray(values)))
    close(src_t(None, None, t(ts)), jax.vmap(lambda s: src_j(None, None, s))(ts))


@pytest.mark.parametrize("suppress", [True, False])
def test_discrete_derivative_matches_jax(suppress):
    """DiscreteDerivative and the state interpolator over a seeded input
    sequence (test_primitive_blocks.py's TestDiscreteDerivative)."""
    from drake_tpu.systems import primitives as jp
    from drake_tpu.systems import simulator as jsim
    from drake_tpu_torch.systems import primitives as tp
    from drake_tpu_torch.systems import simulator as tsim

    us = np.random.default_rng(8).standard_normal((12, 2))
    for jmake, tmake in ((jp.discrete_derivative, tp.discrete_derivative),
                         (jp.state_interpolator_with_discrete_derivative,
                          tp.state_interpolator_with_discrete_derivative)):
        jd, td = jmake(2, 0.1, suppress), tmake(2, 0.1, suppress)
        x0 = np.zeros(jd.num_states)
        jxs = jsim.simulate_discrete(jd, None, jnp.asarray(x0), jnp.asarray(us))
        xs = tsim.simulate_discrete(td, None, t(x0), t(us))
        close(xs, jxs)
        u_next = np.concatenate([us, us[-1:]])
        close(td.output(None, xs, t(u_next)),
              jax.vmap(lambda x, u: jd.output(None, x, u))(jxs, u_next))


def test_diagram_combinators_match_jax():
    """cascade (test_components.py's integrator chain), feedback (the
    stabilized unstable plant) and parallel_compose, simulated over 1,000
    steps in both packages."""
    from drake_tpu.systems import diagram as jd
    from drake_tpu.systems import primitives as jp
    from drake_tpu.systems import simulator as jsim
    from drake_tpu_torch.systems import diagram as td
    from drake_tpu_torch.systems import primitives as tp
    from drake_tpu_torch.systems import simulator as tsim

    j_int = jp.linear_system(jnp.zeros((1, 1)), jnp.ones((1, 1)))
    t_int = tp.linear_system(np.zeros((1, 1)), np.ones((1, 1)), device="cpu")
    jdouble, tdouble = jd.cascade(j_int, j_int), td.cascade(t_int, t_int)
    us = np.ones((1000, 1))
    jxs, _ = jsim.simulate(jdouble, (None, None), jnp.zeros(2), jnp.asarray(us), 1e-3)
    xs, _ = tsim.simulate(tdouble, (None, None), t(np.zeros(2)), t(us), 1e-3)
    close(xs, jxs)
    close(tdouble.output((None, None), xs, t(np.ones((1001, 1)))),
          jax.vmap(lambda x: jdouble.output((None, None), x, jnp.ones(1)))(jxs))

    jplant = jp.linear_system(jnp.asarray([[1.0]]), jnp.asarray([[1.0]]))
    tplant = tp.linear_system(np.array([[1.0]]), np.array([[1.0]]), device="cpu")
    jc = jd.feedback(jplant, lambda p, y, r, s: 5.0 * (r - y))
    tc = td.feedback(tplant, lambda p, y, r, s: 5.0 * (r - y))
    rs = np.random.default_rng(9).standard_normal((1000, 1)) * 0.1
    jxs, _ = jsim.simulate(jc, None, jnp.asarray([1.0]), jnp.asarray(rs), 1e-3)
    xs, _ = tsim.simulate(tc, None, t([1.0]), t(rs), 1e-3)
    close(xs, jxs)

    A, B, _, _, _, _, x, u = lti(10, n=3, m=2)
    jpar = jd.parallel_compose(jp.linear_system(A, B), jplant)
    tpar = td.parallel_compose(tp.linear_system(A, B, device="cpu"), tplant)
    xx = np.concatenate([x, x[:, :1]], 1)
    uu = np.concatenate([u, u[:, :1]], 1)
    close(tpar.f((None, None), t(xx), t(uu)),
          jax.vmap(lambda a, b: jpar.f((None, None), a, b))(xx, uu))
    assert (tpar.num_states, tpar.num_inputs) == (jpar.num_states, jpar.num_inputs)


def two_link(jax_side):
    """A two-link arm on revolute joints, with damping, in either package."""
    if jax_side:
        from drake_tpu.multibody.model import ModelBuilder
    else:
        from drake_tpu_torch.multibody.model import ModelBuilder
    b = ModelBuilder()
    b.add_body("l1", parent=None, joint_type="revolute", mass=1.2, com=(0.0, 0.0, -0.3),
               inertia_com=np.diag([0.02, 0.03, 0.01]), axis=(0, 1, 0), damping=0.1)
    b.add_body("l2", parent="l1", joint_type="revolute", mass=0.8, com=(0.0, 0.0, -0.25),
               inertia_com=np.diag([0.01, 0.02, 0.01]), X_PJ_xyz=(0.0, 0.0, -0.6),
               axis=(0, 1, 0), damping=0.05)
    return b.build(F64) if jax_side else b.build(__import__("torch").float64, "cpu")


def test_controllers_match_jax():
    """PID on the pendulum closed loop (test_components.py, 6,000 steps),
    and the inverse-dynamics and joint-stiffness policies of the arm at
    seeded states."""
    import torch

    from drake_tpu.control import controllers as jc
    from drake_tpu.models import pendulum as jpend
    from drake_tpu.systems import simulator as jsim
    from drake_tpu_torch.control import controllers as tc
    from drake_tpu_torch.models import pendulum as tpend
    from drake_tpu_torch.systems import simulator as tsim

    jsys = jpend.make_system(jpend.default_params(F64))
    arrays = {f.name: np.asarray(getattr(jsys.default_params, f.name))
              for f in dataclasses.fields(jsys.default_params)}
    tsys = tpend.make_system(tpend.params_from_numpy(arrays, device="cpu"))
    jpol = jc.pid_controller(jnp.asarray([20.0]), jnp.asarray([10.0]), jnp.asarray([5.0]),
                             lambda s: (jnp.asarray([0.5]), jnp.zeros(1, F64)), dt=1e-3)
    tpol = tc.pid_controller([20.0], [10.0], [5.0],
                             lambda s: (t([0.5]), t(np.zeros(1))), dt=1e-3, device="cpu")
    jxs, jus, _ = jsim.simulate_controlled(jsys, jsys.default_params, jnp.zeros(2, F64), jpol,
                                           6000, 1e-3, policy_state=jnp.zeros(1, F64))
    xs, us, _ = tsim.simulate_controlled(tsys, tsys.default_params, t(np.zeros(2)), tpol, 6000,
                                         1e-3, policy_state=t(np.zeros(1)))
    close(xs, jxs)
    close(us, jus)
    assert abs(float(xs[-1, 0]) - 0.5) < 1e-2

    jm, jp_ = two_link(True)
    tm, tp_ = two_link(False)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((5, 4))
    integral = rng.standard_normal((5, 2))
    Kp, Ki, Kd = [30.0, 20.0], [1.0, 2.0], [4.0, 3.0]
    qd, vd, ad = rng.standard_normal((3, 2))
    jid = jc.inverse_dynamics_controller(jm, jp_, Kp, Ki, Kd,
                                         lambda s: (qd, vd, ad), dt=1e-3)
    tid = tc.inverse_dynamics_controller(tm, tp_, Kp, Ki, Kd,
                                         lambda s: (t(qd), t(vd), t(ad)), dt=1e-3, device="cpu")
    jtau, jint = jax.vmap(lambda i, y: jid(i, y, 0.0))(integral, x)
    ttau, tint = tid(t(integral), t(x), 0.0)
    close(ttau, jtau)
    close(tint, jint)
    jjs = jc.joint_stiffness_controller(jm, jp_, jnp.asarray(Kp), jnp.asarray(Kd), qd)
    tjs = tc.joint_stiffness_controller(tm, tp_, Kp, Kd, qd, device="cpu")
    close(tjs(None, t(x), 0.0), jax.vmap(lambda y: jjs(None, y, 0.0))(x))
    assert isinstance(ttau, torch.Tensor)
