"""Parity of drake_tpu_torch's rotations, multibody model, kinematics and
dynamics against drake_tpu's, on the CPU in float64.

The world is the bench's (examples/iiwa_push_mpc.py ``build_world``: the iiwa
with a free box, nq = 14, nv = 13); the port gets the JAX parameters through
``multibody.convert``.  The lanes are random configurations from a numpy
seed: arm joints around the home pose, a random box orientation, random
velocities, torques and accelerations.  Each JAX function is vmapped over the
lanes in one jitted program.

Tolerance: 1e-10 absolute on every quantity (forward dynamics: relative to
its largest magnitude), far above float64 rounding of the same arithmetic in
another order and far below any modelling difference.

torch and the port are imported when a test here runs, not when pytest
collects this file (see tests/test_torch_mpm_kernels.py).
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

TOL = 1e-10
LANES = 6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# XLA's CPU backend at its lowest optimization level: the reference programs
# here are large and run once, and they compile in about half the time.  The
# arithmetic is the same IEEE float64 (XLA's CPU fast-math is off at every
# level); only the code's speed differs.
CHEAP_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch on one thread while these tests run: pytest-xdist runs several
    workers on the same cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_world():
    """(model, params, scene) of the bench world, from the JAX package."""
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        from iiwa_push_mpc import build_world
    finally:
        sys.path.pop(0)
    model, params, scene, _ = build_world(jnp.float64)
    return model, params, scene


def run_jitted(fn, *args):
    """fn(*args) as one jitted program, compiled with CHEAP_COMPILE."""
    return jax.jit(fn).lower(*args).compile(compiler_options=CHEAP_COMPILE)(*args)


def port_params(jparams):
    from drake_tpu_torch.multibody import convert

    arrays = {f.name: np.asarray(getattr(jparams, f.name)) for f in dataclasses.fields(jparams)}
    return convert.params_from_numpy(arrays, device="cpu")


def random_lanes(seed, lanes=LANES):
    """q (lanes, 14), v (lanes, 13), vdot (lanes, 13), tau (lanes, 13)."""
    rng = np.random.default_rng(seed)
    q = np.zeros((lanes, 14))
    q[:, :7] = np.array([0.0, 0.6, 0.0, -1.75, 0.0, 1.0, 0.0]) + 0.3 * rng.standard_normal((lanes, 7))
    quat = np.array([1.0, 0, 0, 0]) + 0.2 * rng.standard_normal((lanes, 4))
    q[:, 7:11] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 11:14] = np.array([0.62, 0.0, 0.06]) + 0.05 * rng.standard_normal((lanes, 3))
    v = 0.5 * rng.standard_normal((lanes, 13))
    vdot = rng.standard_normal((lanes, 13))
    tau = np.concatenate([20.0 * rng.standard_normal((lanes, 7)), np.zeros((lanes, 6))], axis=1)
    return q, v, vdot, tau


@pytest.fixture(scope="module")
def world():
    """Both packages' worlds, the lanes, and every JAX quantity of the tests
    below from one jitted program (one compile)."""
    import torch

    from drake_tpu.multibody import dynamics as jdyn
    from drake_tpu.multibody import kinematics as jkin
    from drake_tpu_torch.multibody import convert

    jm, jp, _ = jax_world()
    tm = convert.model_from_fields(dataclasses.asdict(jm))
    q, v, vdot, tau = random_lanes(0)
    f_ext = np.random.default_rng(1).standard_normal((LANES, jm.num_bodies, 6))
    lanes = {"q": q, "v": v, "vdot": vdot, "tau": tau, "f_ext": f_ext}

    def one(q1, v1, a1, tau1, f1):
        R, p = jkin.forward_kinematics(jm, jp, q1)
        return {
            "R": R, "p": p,
            "V_B": jkin.body_spatial_velocities(jm, jp, q1, v1)[0],
            "V_W": jkin.world_velocities(jm, jp, q1, v1),
            "J_W": jkin.world_velocity_jacobians(jm, jp, q1),
            "M": jdyn.mass_matrix(jm, jp, q1),
            "C": jdyn.bias_forces(jm, jp, q1, v1),
            "ID": jdyn.inverse_dynamics(jm, jp, q1, v1, a1, f1),
            "FD": jdyn.forward_dynamics(jm, jp, q1, v1, tau1),
        }

    ref = run_jitted(jax.vmap(one), q, v, vdot, tau, f_ext)
    return {
        "jm": jm, "jp": jp, "tm": tm, "tp": port_params(jp), "ref": ref,
        "np": lanes, "t": {k: torch.tensor(a) for k, a in lanes.items()},
    }


def close(got, ref, tol=TOL):
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    # Non-finite entries (a diverged lane) must sit at the same places.
    np.testing.assert_allclose(got, ref, rtol=0.0, atol=tol, equal_nan=True)


def test_model_topology_and_params_match_jax(world):
    """The port's own ModelBuilder builds the JAX world's parameters."""
    import torch

    from drake_tpu_torch import bench
    from drake_tpu_torch.multibody import convert

    tm, tp, scene, side = bench.build_world(torch.float64, device="cpu")
    jm = world["jm"]
    assert (tm.parent, tm.joint_types, tm.body_names, tm.joint_names) == (
        jm.parent, jm.joint_types, jm.body_names, jm.joint_names)
    assert (tm.q_offsets, tm.v_offsets, tm.num_positions, tm.num_velocities) == (
        jm.q_offsets, jm.v_offsets, 14, 13)
    assert scene.num_contacts == 9 and side == 0.12
    for name, ref in convert.params_to_numpy(world["tp"]).items():
        close(getattr(tp, name), ref, 1e-15)


@pytest.mark.parametrize("quantity", ["R", "p"])
def test_forward_kinematics_matches_jax(world, quantity):
    from drake_tpu_torch.multibody import kinematics as tkin

    got = tkin.forward_kinematics(world["tm"], world["tp"], world["t"]["q"])
    close(got[{"R": 0, "p": 1}[quantity]], world["ref"][quantity])


def test_body_and_world_velocities_match_jax(world):
    from drake_tpu_torch.multibody import kinematics as tkin

    q, v = world["t"]["q"], world["t"]["v"]
    close(tkin.body_spatial_velocities(world["tm"], world["tp"], q, v)[0], world["ref"]["V_B"])
    close(tkin.world_velocities(world["tm"], world["tp"], q, v), world["ref"]["V_W"])


def test_world_velocity_jacobians_match_jax(world):
    import torch

    from drake_tpu_torch.multibody import kinematics as tkin

    got = tkin.world_velocity_jacobians(world["tm"], world["tp"], world["t"]["q"])
    close(got, world["ref"]["J_W"])
    # And the Jacobian maps v to the world velocities.
    V = torch.einsum("lbiv,lv->lbi", got, world["t"]["v"])
    close(V, world["ref"]["V_W"])


def test_mass_matrix_matches_jax(world):
    from drake_tpu_torch.multibody import dynamics as tdyn

    got = tdyn.mass_matrix(world["tm"], world["tp"], world["t"]["q"])
    close(got, world["ref"]["M"])
    close(got, got.mT, 0.0)


def test_bias_forces_matches_jax(world):
    from drake_tpu_torch.multibody import dynamics as tdyn

    got = tdyn.bias_forces(world["tm"], world["tp"], world["t"]["q"], world["t"]["v"])
    close(got, world["ref"]["C"])


def test_inverse_dynamics_with_external_forces_matches_jax(world):
    from drake_tpu_torch.multibody import dynamics as tdyn

    t = world["t"]
    got = tdyn.inverse_dynamics(world["tm"], world["tp"], t["q"], t["v"], t["vdot"], t["f_ext"])
    close(got, world["ref"]["ID"])


def test_forward_dynamics_matches_jax(world):
    from drake_tpu_torch.multibody import dynamics as tdyn

    t = world["t"]
    ref = world["ref"]["FD"]
    got = tdyn.forward_dynamics(world["tm"], world["tp"], t["q"], t["v"], t["tau"])
    close(got, ref, TOL * float(np.abs(np.asarray(ref)).max()))


def test_iiwa_make_model_matches_jax():
    import torch

    from drake_tpu.models import iiwa as jiiwa
    from drake_tpu.multibody import dynamics as jdyn
    from drake_tpu_torch.models import iiwa as tiiwa
    from drake_tpu_torch.multibody import dynamics as tdyn

    jm, jp = jiiwa.make_model(jnp.float64)
    tm, tp = tiiwa.make_model(torch.float64, device="cpu")
    assert tm.joint_names == jm.joint_names
    q = np.asarray(jiiwa.home_position(jnp.float64))
    close(tiiwa.home_position(torch.float64, device="cpu"), q, 0.0)
    close(tdyn.mass_matrix(tm, tp, torch.tensor(q)), jdyn.mass_matrix(jm, jp, q))
    np.testing.assert_array_equal(tiiwa.EFFORT_LIMITS, jiiwa.EFFORT_LIMITS)


@pytest.mark.parametrize("name", [
    "rpy_to_rotation", "quat_to_rotation", "quat_multiply", "quat_normalize", "hat",
    "axis_angle_to_rotation",
])
def test_rotations_match_jax(name):
    import torch

    from drake_tpu.math import rotations as jrot
    from drake_tpu_torch.math import rotations as trot

    rng = np.random.default_rng(2)
    quat = rng.standard_normal((5, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    axis = rng.standard_normal((5, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    args = {
        "rpy_to_rotation": (rng.standard_normal((5, 3)),),
        "quat_to_rotation": (quat,),
        "quat_multiply": (quat, quat[::-1].copy()),
        "quat_normalize": (3.0 * quat,),
        "hat": (rng.standard_normal((5, 3)),),
        "axis_angle_to_rotation": (axis, rng.standard_normal(5)),
    }[name]
    ref = getattr(jrot, name)(*args)
    got = getattr(trot, name)(*(torch.tensor(a) for a in args))
    close(got, ref, 1e-14)


@pytest.mark.parametrize("w_scale", [0.0, 1e-8, 1.0])
def test_quat_integrate_and_its_gradient_match_jax(w_scale):
    """The exponential map and its gradient, at w = 0 too, where the
    reference records a NaN trap (BASELINE.md): both stay finite and agree."""
    import torch

    from drake_tpu.math import rotations as jrot
    from drake_tpu_torch.math import rotations as trot

    rng = np.random.default_rng(3)
    quat = rng.standard_normal(4)
    quat /= np.linalg.norm(quat)
    w = w_scale * rng.standard_normal(3)

    def jf(q, w_):
        return jnp.sum(jrot.quat_integrate(q, w_, 0.04) * jnp.arange(1.0, 5.0))

    ref = jrot.quat_integrate(quat, w, 0.04)
    ref_grad = jax.grad(jf, argnums=(0, 1))(quat, w)
    tq = torch.tensor(quat, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    got = trot.quat_integrate(tq, tw, 0.04)
    (got * torch.arange(1.0, 5.0, dtype=torch.float64)).sum().backward()
    close(got, ref, 1e-14)
    for g, r in zip((tq.grad, tw.grad), ref_grad):
        assert bool(torch.isfinite(g).all())
        close(g, r, 1e-12)


def test_unported_joint_types_raise():
    """Every joint type of the reference is taken (the ball, planar and
    screw joints, and the builder's universal); a type it does not know
    raises, as the reference's kinematics does."""
    from drake_tpu_torch.multibody.model import ModelBuilder

    b = ModelBuilder()
    for jt in ("ball", "planar", "screw", "universal"):
        b.add_body(jt, parent=None, joint_type=jt, mass=1.0)
    assert b.build(device="cpu")[0].joint_types == (
        "ball", "planar", "screw", "revolute", "revolute")
    with pytest.raises(ValueError, match="unknown joint type"):
        b.add_body("gimbal", parent=None, joint_type="gimbal", mass=1.0)


def test_entry_points_default_to_the_card():
    """device=None means the current CUDA device; on a machine without one
    the entry points raise rather than fall back to the CPU."""
    import torch

    from drake_tpu_torch import bench
    from drake_tpu_torch.models import iiwa
    from drake_tpu_torch.multibody import convert
    from drake_tpu_torch.multibody.model import ModelBuilder

    if torch.cuda.is_available():
        assert bench.build_world()[1].mass.device.type == "cuda"
        return
    arrays = convert.params_to_numpy(iiwa.make_model(torch.float64, device="cpu")[1])
    for call in (bench.build_world, iiwa.make_model, iiwa.home_position,
                 ModelBuilder().build, lambda: convert.params_from_numpy(arrays),
                 lambda: bench.build_rollout(batch=2, mpc_steps=1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
