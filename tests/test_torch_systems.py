"""Parity of drake_tpu_torch's integrators, system abstraction, fixed-step
simulator and rotation helpers against drake_tpu's, on the CPU in float64.

The systems are the pendulum (2 states, q/v split 1 + 1) and the quadrotor
(12 states) of both packages, the port's parameters carried across from the
JAX ones by ``params_from_numpy``.  Lanes are drawn from numpy seeds; the JAX
function runs on one lane under ``vmap``, the port on all lanes at once.

Tolerance: 1e-12 absolute on dynamics, steps, Jacobians, trajectories and
rotations (1e-12 of the largest magnitude where that exceeds 1), far above
float64 rounding of the same arithmetic in another order.

torch and the port are imported when a test here runs, not when pytest
collects this file (see tests/test_torch_mpm_kernels.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_multibody import close, run_jitted

TOL = 1e-12
LANES = 5
INTEGRATORS = [
    "explicit_euler", "euler", "rk2", "midpoint", "rk3", "rk4", "rk5", "bogacki_shampine3",
    "semi_explicit_euler", "implicit_euler", "implicit_trapezoid", "radau3", "radau1",
    "velocity_implicit_euler",
]


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_port_params(module, jparams):
    arrays = {f.name: np.asarray(getattr(jparams, f.name)) for f in dataclasses.fields(jparams)}
    return module.params_from_numpy(arrays, device="cpu")


def pendulum_pair():
    """(JAX system, port system) of the pendulum, with damping 0.3."""
    from drake_tpu.models import pendulum as jpend
    from drake_tpu_torch.models import pendulum as tpend

    jp = dataclasses.replace(jpend.default_params(jnp.float64), damping=jnp.asarray(0.3))
    return jpend.make_system(jp), tpend.make_system(to_port_params(tpend, jp))


def quadrotor_pair():
    from drake_tpu.models import quadrotor as jquad
    from drake_tpu_torch.models import quadrotor as tquad

    jp = jquad.default_params(jnp.float64)
    return jquad.make_system(jp), tquad.make_system(to_port_params(tquad, jp))


def pendulum_lanes(seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-2.0, 2.0, (LANES, 2)), rng.uniform(-1.0, 1.0, (LANES, 1))


def quadrotor_lanes(seed=1):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.standard_normal((LANES, 3)), 0.4 * rng.standard_normal((LANES, 3)),
                        rng.standard_normal((LANES, 3)), rng.standard_normal((LANES, 3))], axis=1)
    return x, rng.uniform(0.0, 4.0, (LANES, 4))


def t(a):
    import torch

    return torch.tensor(np.asarray(a))


# ---- rotations ---------------------------------------------------------------

def rotation_args(name):
    """Inputs of each rotation helper: rpy away from the gimbal lock,
    rotations whose dominant quaternion component is each of w, x, y, z,
    and rotation angles from 0 to 2.5 rad."""
    rng = np.random.default_rng(4)
    rpy = rng.uniform(-1.2, 1.2, (6, 3))
    quat = rng.standard_normal((8, 4)) * 0.2
    quat[np.arange(8), np.arange(8) % 4] += 1.0
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    from drake_tpu.math import rotations as jrot

    R = np.asarray(jrot.quat_to_rotation(quat))
    axis = rng.standard_normal((6, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    R_log = np.asarray(jrot.axis_angle_to_rotation(axis, np.array([0.0, 1e-7, 1e-3, 0.5, 1.5, 2.5])))
    vec = rng.standard_normal((6, 3))
    return {
        "rotation_to_rpy": (np.asarray(jrot.rpy_to_rotation(rpy)),),
        "rpy_rates_to_angular_velocity_in_child": (rpy, vec),
        "rpy_rates_to_angular_velocity_in_parent": (rpy, vec),
        "rpy_ddt_from_angular_accel_in_parent": (rpy, vec, vec[::-1].copy()),
        "quat_conjugate": (quat,),
        "rotation_to_quat": (R,),
        "quat_rotate": (quat[:6], vec),
        "quat_derivative": (quat[:6], vec),
        "vee": (np.asarray(jrot.hat(vec)),),
        "rotation_log": (R_log,),
    }[name]


@pytest.mark.parametrize("name", [
    "rotation_to_rpy", "rpy_rates_to_angular_velocity_in_child",
    "rpy_rates_to_angular_velocity_in_parent", "rpy_ddt_from_angular_accel_in_parent",
    "quat_conjugate", "rotation_to_quat", "quat_rotate", "quat_derivative", "vee",
    "rotation_log",
])
def test_rotation_helpers_match_jax(name):
    from drake_tpu.math import rotations as jrot
    from drake_tpu_torch.math import rotations as trot

    args = rotation_args(name)
    # One matrix at a time under vmap, where jnp.trace is each one's trace.
    ref = jax.vmap(getattr(jrot, name))(*args)
    close(getattr(trot, name)(*(t(a) for a in args)), ref, TOL)


def test_quat_identity_and_rotation_to_quat_round_trip():
    import torch

    from drake_tpu.math import rotations as jrot
    from drake_tpu_torch.math import rotations as trot

    close(trot.quat_identity(torch.float64, "cpu"), jrot.quat_identity(jnp.float64), 0.0)
    (R,) = rotation_args("rotation_to_quat")
    close(trot.quat_to_rotation(trot.rotation_to_quat(t(R))), R, TOL)


# ---- models and the system abstraction ---------------------------------------

@pytest.mark.parametrize("model", ["pendulum", "quadrotor"])
def test_dynamics_and_params_match_jax(model):
    from drake_tpu.models import quadrotor as jquad
    from drake_tpu_torch.models import pendulum as tpend
    from drake_tpu_torch.models import quadrotor as tquad

    jsys, tsys = pendulum_pair() if model == "pendulum" else quadrotor_pair()
    x, u = pendulum_lanes() if model == "pendulum" else quadrotor_lanes()
    ref = jax.vmap(lambda a, b: jsys.f(jsys.default_params, a, b, 0.0))(x, u)
    close(tsys.f(tsys.default_params, t(x), t(u), 0.0), ref, TOL)
    close(tsys.f(tsys.default_params, t(x[0]), t(u[0]), 0.0), ref[0], TOL)
    module = tpend if model == "pendulum" else tquad
    for name, value in module.params_to_numpy(tsys.default_params).items():
        close(value, getattr(jsys.default_params, name), 0.0)
    if model == "quadrotor":
        close(tquad.hover_input(tsys.default_params), jquad.hover_input(jsys.default_params), TOL)
    assert (tsys.num_states, tsys.num_inputs, tsys.num_q, tsys.num_v) == (
        jsys.num_states, jsys.num_inputs, jsys.num_q, jsys.num_v)


def test_pendulum_total_energy_matches_jax():
    from drake_tpu.models import pendulum as jpend
    from drake_tpu_torch.models import pendulum as tpend

    jsys, tsys = pendulum_pair()
    x, _ = pendulum_lanes()
    close(tpend.total_energy(tsys.default_params, t(x)),
          jpend.total_energy(jsys.default_params, x), TOL)


@pytest.mark.parametrize("which", ["continuous", "discrete"])
def test_linearize_matches_jax(which):
    from drake_tpu.systems import base as jbase
    from drake_tpu_torch.systems import base as tbase

    jsys, tsys = quadrotor_pair()
    if which == "discrete":
        jsys, tsys = jbase.discretize(jsys, 0.02, "rk4"), tbase.discretize(tsys, 0.02, "rk4")
        assert (tsys.time_step, tsys.num_states) == (0.02, 12)
    x, u = quadrotor_lanes()
    jA, jB = run_jitted(jax.vmap(lambda a, b: jsys.linearize(jsys.default_params, a, b, 0.1)),
                        x, u)
    A, B = tsys.linearize(tsys.default_params, t(x), t(u), 0.1)
    scale = max(1.0, float(np.abs(jA).max()), float(np.abs(jB).max()))
    close(A, jA, TOL * scale)
    close(B, jB, TOL * scale)
    A0, _ = tsys.linearize(tsys.default_params, t(x[0]), t(u[0]), 0.1)
    close(A0, jA[0], TOL * scale)


def test_with_params_and_call():
    jsys, tsys = pendulum_pair()
    x, u = pendulum_lanes()
    p2 = tsys.default_params.replace(length=tsys.default_params.length * 2)
    assert tsys.with_params(p2).default_params is p2
    close(tsys(tsys.default_params, t(x), t(u)), tsys.f(tsys.default_params, t(x), t(u), 0.0), 0.0)


# ---- integrators ------------------------------------------------------------

@pytest.mark.parametrize("name", INTEGRATORS)
def test_integrator_step_matches_jax(name):
    from drake_tpu.systems import integrators as jint
    from drake_tpu_torch.systems import integrators as tint

    jsys, tsys = pendulum_pair()
    x, u = pendulum_lanes(5)
    kw = {"num_q": 1} if name in ("semi_explicit_euler", "velocity_implicit_euler") else {}
    jstep, tstep = jint.get(name), tint.get(name)
    ref = jax.vmap(lambda a, b: jstep(jsys.f, jsys.default_params, a, b, 0.3, 0.05, **kw))(x, u)
    close(tstep(tsys.f, tsys.default_params, t(x), t(u), 0.3, 0.05, **kw), ref, TOL)


def test_quadrotor_rk4_and_error_controlled_step_match_jax():
    from drake_tpu.systems import integrators as jint
    from drake_tpu_torch.systems import integrators as tint

    jsys, tsys = quadrotor_pair()
    x, u = quadrotor_lanes(6)
    ref = jax.vmap(lambda a, b: jint.rk4(jsys.f, jsys.default_params, a, b, 0.0, 0.02))(x, u)
    close(tint.rk4(tsys.f, tsys.default_params, t(x), t(u), 0.0, 0.02), ref, TOL)
    ref5, ref_err = jax.vmap(lambda a, b: jint.step_error_controlled(
        jsys.f, jsys.default_params, a, b, 0.0, 0.02))(x, u)
    got5, got_err = tint.step_error_controlled(tsys.f, tsys.default_params, t(x), t(u), 0.0, 0.02)
    close(got5, ref5, TOL)
    close(got_err, ref_err, TOL)


def test_unknown_integrator_raises():
    from drake_tpu_torch.systems import integrators as tint

    with pytest.raises(ValueError, match="unknown integrator"):
        tint.get("leapfrog")


# ---- simulator --------------------------------------------------------------

@pytest.mark.parametrize("method", ["rk4", "euler", "implicit_euler"])
def test_simulate_and_batch_simulate_match_jax(method):
    from drake_tpu.systems import simulator as jsim
    from drake_tpu_torch.systems import simulator as tsim

    jsys, tsys = pendulum_pair()
    x, _ = pendulum_lanes(7)
    us = np.random.default_rng(8).uniform(-1.0, 1.0, (LANES, 40, 1))
    jxs, jts = jsim.batch_simulate(jsys, jsys.default_params, x, us, 0.05, method=method)
    xs, ts = tsim.batch_simulate(tsys, tsys.default_params, t(x), t(us), 0.05, method=method)
    close(xs, jxs, TOL)
    close(ts, jts[0], TOL)
    xs0, ts0 = tsim.simulate(tsys, tsys.default_params, t(x[0]), t(us[0]), 0.05, t0=0.5,
                             method=method)
    jxs0, jts0 = jsim.simulate(jsys, jsys.default_params, x[0], us[0], 0.05, t0=0.5,
                               method=method)
    close(xs0, jxs0, TOL)
    close(ts0, jts0, TOL)


def test_simulate_controlled_matches_jax():
    """A PD policy on the time and the state, with a policy state (a step
    counter) carried through."""
    import torch

    from drake_tpu.systems import simulator as jsim
    from drake_tpu_torch.systems import simulator as tsim

    jsys, tsys = pendulum_pair()
    x, _ = pendulum_lanes(9)

    def jpolicy(k, xx, tt):
        return jnp.stack([2.0 * jnp.sin(tt) - 3.0 * xx[0] - 0.5 * xx[1] + 0.01 * k]), k + 1

    def tpolicy(k, xx, tt):
        return (2.0 * torch.sin(tt) - 3.0 * xx[..., 0] - 0.5 * xx[..., 1] + 0.01 * k)[..., None], k + 1

    jxs, jus, jts = jax.vmap(lambda a: jsim.simulate_controlled(
        jsys, jsys.default_params, a, jpolicy, 60, 0.02, t0=0.1, policy_state=0.0))(x)
    xs, us, ts = tsim.simulate_controlled(tsys, tsys.default_params, t(x), tpolicy, 60, 0.02,
                                          t0=0.1, policy_state=0.0)
    close(xs, jxs, TOL)
    close(us, jus, TOL)
    close(ts, jts[0], TOL)


def test_simulate_discrete_matches_jax():
    from drake_tpu.systems import base as jbase
    from drake_tpu.systems import simulator as jsim
    from drake_tpu_torch.systems import base as tbase
    from drake_tpu_torch.systems import simulator as tsim

    jsys, tsys = quadrotor_pair()
    jd, td = jbase.discretize(jsys, 0.02, "rk3"), tbase.discretize(tsys, 0.02, "rk3")
    x, _ = quadrotor_lanes(10)
    us = np.random.default_rng(11).uniform(1.5, 2.5, (LANES, 25, 4))
    ref = jax.vmap(lambda a, b: jsim.simulate_discrete(jd, jsys.default_params, a, b))(x, us)
    got = tsim.simulate_discrete(td, tsys.default_params, t(x), t(us))
    close(got, ref, TOL * max(1.0, float(np.abs(ref).max())))
    assert tsim.SimulatorConfig().integration_scheme == "rk4"


@pytest.mark.parametrize("form", ["held", "callable", "sequence", "none"])
def test_simulate_discrete_step_forms(form):
    """The demos' form of simulate_discrete (a held, callable, sequence or
    absent input; a record a step) steps as the reference form does."""
    import torch

    from drake_tpu_torch.systems import base as tbase
    from drake_tpu_torch.systems import simulator as tsim

    _, tsys = quadrotor_pair()
    td = tbase.discretize(tsys, 0.02, "rk3")
    x, _ = quadrotor_lanes(10)
    x = t(x)
    u = torch.full(x.shape[:-1] + (4,), 2.0, dtype=x.dtype)
    if form == "none":  # a system with no input: the dynamics ignore a zero-width u
        td = tbase.DiscreteSystem(g=lambda p, xx, uu, tt: 0.5 * xx, num_states=12,
                                  num_inputs=0, time_step=0.02)
        u = x.new_zeros(x.shape[:-1] + (0,))
    seq = u.unsqueeze(-2).expand(x.shape[:-1] + (6, u.shape[-1]))
    ref = tsim.simulate_discrete(td, tsys.default_params, x, seq)
    given = {"held": (u, 6), "callable": (lambda k, xx: seq[..., k, :], 6),
             "sequence": (seq, None), "none": (None, 6)}[form]
    x_end, (first, norm) = tsim.simulate_discrete(
        td, tsys.default_params, x, given[0], steps=given[1],
        record=lambda xx: (xx[..., 0], xx.norm(dim=-1)))
    close(x_end, ref[..., -1, :], 0.0)
    close(first, ref[..., 1:, 0].movedim(-1, 0), 0.0)
    assert norm.shape == (6,) + x.shape[:-1]
    if given[1] is not None:  # a held, callable or absent input needs its count of steps
        x_end, none = tsim.simulate_discrete(td, tsys.default_params, x, given[0], steps=6)
        assert none is None
        close(x_end, ref[..., -1, :], 0.0)
