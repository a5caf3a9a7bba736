"""Parity of drake_tpu_torch's ball, planar, screw and universal joints (and
the builder's rotor inertia) against drake_tpu's, on the CPU in float64.

One model carries every joint type: a revolute from the world, a ball
under it, a universal (two revolutes through a massless body, with a
geared rotor) under that, a prismatic at the tip, and apart from them a
planar joint from the world with a screw (pitch 0.1 m) on it.  Both
packages build it from the same builder calls.  The lanes come from a
numpy seed: random angles and positions, random unit quaternions for the
ball, random velocities and torques.  Each JAX quantity is vmapped over the
lanes in one jitted program.

Tolerance: 1e-10 absolute on every quantity, far above float64 rounding of
the same arithmetic in another order and far below any modelling
difference.

torch and the port are imported when a test here runs, not when pytest
collects this file (see tests/test_torch_mpm_kernels.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_multibody import close, run_jitted

LANES = 5
H = 0.01


def build(builder_cls, dtype, **kw):
    ey = np.eye(3)
    b = builder_cls(gravity=(0.0, 0.0, -9.81))
    b.add_body("a", parent=None, joint_type="revolute", mass=1.0, com=(0.1, 0, 0),
               inertia_com=ey * 0.02, axis=(0, 0, 1), damping=0.1)
    b.add_body("b", parent="a", joint_type="ball", mass=0.7, com=(0, 0.05, -0.1),
               inertia_com=np.diag([0.01, 0.02, 0.015]), X_PJ_xyz=(0.3, 0, 0),
               X_PJ_rpy=(0.1, -0.2, 0.3), damping=0.05)
    b.add_body("u", parent="b", joint_type="universal", mass=0.4, com=(0, 0, -0.1),
               inertia_com=ey * 0.004, axis=(1, 0, 0), axis2=(0, 1, 0),
               X_PJ_xyz=(0, 0, -0.25), damping=0.02, rotor_inertia=1e-4, gear_ratio=30.0)
    b.add_body("e", parent="u", joint_type="prismatic", mass=0.2, inertia_com=ey * 1e-3,
               axis=(0, 0, 1), X_PJ_xyz=(0, 0, -0.2))
    b.add_body("p", parent=None, joint_type="planar", mass=1.5, com=(0.02, 0, 0.01),
               inertia_com=np.diag([0.03, 0.02, 0.04]), X_PJ_xyz=(1.0, 0, 0.2),
               X_PJ_rpy=(0.0, 0.3, 0.0))
    b.add_body("s", parent="p", joint_type="screw", mass=0.3, inertia_com=ey * 2e-3,
               axis=(0, 0.6, 0.8), screw_pitch=0.1, X_PJ_xyz=(0, 0.1, 0))
    return b.build(dtype, **kw)


def lanes(model, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1.0, 1.0, (LANES, model.num_positions))
    for i, jt in enumerate(model.joint_types):
        if jt == "ball":
            o = model.q_offsets[i]
            quat = rng.standard_normal((LANES, 4))
            q[:, o : o + 4] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    v = rng.standard_normal((LANES, model.num_velocities))
    tau = rng.standard_normal((LANES, model.num_velocities))
    return q, v, tau


@pytest.fixture(scope="module")
def joints():
    import torch

    from drake_tpu.contact import plant as jcp
    from drake_tpu.multibody import dynamics as jdyn
    from drake_tpu.multibody import kinematics as jkin
    from drake_tpu.multibody import plant as jplant
    from drake_tpu.multibody.model import ModelBuilder as JBuilder
    from drake_tpu_torch.multibody.model import ModelBuilder as TBuilder

    torch.set_num_threads(1)
    jm, jp = build(JBuilder, jnp.float64)
    tm, tp = build(TBuilder, torch.float64, device="cpu")
    q, v, tau = lanes(jm)

    def one(q1, v1, tau1):
        R, p = jkin.forward_kinematics(jm, jp, q1)
        V, _ = jkin.body_spatial_velocities(jm, jp, q1, v1)
        return {
            "R_WB": R, "p_WB": p, "V_B": V,
            "V_W": jkin.world_velocities(jm, jp, q1, v1),
            "J_W": jkin.world_velocity_jacobians(jm, jp, q1),
            "M": jdyn.mass_matrix(jm, jp, q1),
            "C": jdyn.bias_forces(jm, jp, q1, v1),
            "vdot": jdyn.forward_dynamics(jm, jp, q1, v1, tau1),
            "qdot": jplant.qdot_from_v(jm, jp, q1, v1),
            "q_next": jcp.advance_positions(jm, jp, q1, v1, H),
            "energy": jdyn.total_energy(jm, jp, q1, v1),
        }

    ref = jax.tree_util.tree_map(np.asarray, run_jitted(jax.vmap(one), q, v, tau))
    return dict(jm=jm, jp=jp, tm=tm, tp=tp, ref=ref,
                q=torch.tensor(q), v=torch.tensor(v), tau=torch.tensor(tau))


def test_builder_matches_jax(joints):
    jm, jp, tm, tp = (joints[k] for k in ("jm", "jp", "tm", "tp"))
    assert dataclasses.asdict(jm) == dataclasses.asdict(tm)
    assert "u__U" in tm.body_names and tm.joint_names[2:4] == ("u_joint_1", "u_joint_2")
    for f in dataclasses.fields(jp):
        close(getattr(tp, f.name), getattr(jp, f.name), 0.0)


QUANTITIES = ["R_WB", "p_WB", "V_B", "V_W", "J_W", "M", "C", "vdot", "qdot", "q_next", "energy"]


@pytest.mark.parametrize("name", QUANTITIES)
def test_joint_quantities_match_jax(joints, name):
    from drake_tpu_torch.contact import plant as tcp
    from drake_tpu_torch.multibody import dynamics as tdyn
    from drake_tpu_torch.multibody import kinematics as tkin
    from drake_tpu_torch.multibody import plant as tplant

    tm, tp, q, v, tau = (joints[k] for k in ("tm", "tp", "q", "v", "tau"))
    got = {
        "R_WB": lambda: tkin.forward_kinematics(tm, tp, q)[0],
        "p_WB": lambda: tkin.forward_kinematics(tm, tp, q)[1],
        "V_B": lambda: tkin.body_spatial_velocities(tm, tp, q, v)[0],
        "V_W": lambda: tkin.world_velocities(tm, tp, q, v),
        "J_W": lambda: tkin.world_velocity_jacobians(tm, tp, q),
        "M": lambda: tdyn.mass_matrix(tm, tp, q),
        "C": lambda: tdyn.bias_forces(tm, tp, q, v),
        "vdot": lambda: tdyn.forward_dynamics(tm, tp, q, v, tau),
        "qdot": lambda: tplant.qdot_from_v(tm, tp, q, v),
        "q_next": lambda: tcp.advance_positions(tm, tp, q, v, H),
        "energy": lambda: tdyn.total_energy(tm, tp, q, v),
    }[name]()
    close(got, joints["ref"][name], 1e-10)


def test_ball_quaternion_integration_is_finite_at_rest(joints):
    """advance_positions differentiates through the ball's quaternion at zero
    rate without NaN (the normalisation and the exponential map's Taylor
    branch)."""
    import torch

    from drake_tpu_torch.contact import plant as tcp

    tm, tp = joints["tm"], joints["tp"]
    q = joints["q"][:1].clone().requires_grad_(True)
    v = torch.zeros_like(joints["v"][:1], requires_grad=True)
    out = tcp.advance_positions(tm, tp, q, v, H)
    gq, gv = torch.autograd.grad(out.sum(), (q, v))
    assert bool(torch.isfinite(gq).all()) and bool(torch.isfinite(gv).all())


def test_model_fields_carry_new_joints(joints):
    from drake_tpu_torch.multibody import convert

    tm = convert.model_from_fields(dataclasses.asdict(joints["jm"]))
    assert tm == joints["tm"]
    assert tm.num_positions == joints["jm"].num_positions
    assert tm.num_velocities == joints["jm"].num_velocities
