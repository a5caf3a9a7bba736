"""The ported rigid-contact demos' first steps against the JAX examples', on
the CPU in float64.

Each demo's world is built twice: by the JAX example's own ``build`` (the
example module imported from ``examples/``) and by the port's; the same
discrete plant options and inputs then step both from the same state.  The
state after ``STEPS`` steps (float64) is compared.  The JAX step is
compiled once per demo at XLA's lowest optimization level.

Tolerance: 1e-9 of the state's scale (max |x|): a few converged SAP solves
(rel_tolerance 1e-6, equal iteration counts), whose float64 rounding in
another order stays far below.

torch and the port are imported when a test here runs, not when pytest
collects this file (see tests/test_torch_mpm_kernels.py).
"""

import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_multibody import run_jitted

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
TOL = 1e-9


def jax_example(name):
    """The JAX example module (its argument parsing sees no arguments)."""
    sys.path.insert(0, os.path.join(REPO, "examples"))
    argv = sys.argv
    sys.argv = [name]
    try:
        return importlib.import_module(name)
    finally:
        sys.argv = argv
        sys.path.pop(0)


def jax_steps(system, params, x, u, steps=STEPS):
    def body(xx, _):
        return system.g(params, xx, u), None

    return np.asarray(run_jitted(lambda x0: jax.lax.scan(body, x0, None, length=steps)[0], x))


def port_steps(system, params, x, u, steps=STEPS):
    import torch

    from drake_tpu_torch.systems.simulator import simulate_discrete

    return simulate_discrete(system, params, torch.tensor(np.asarray(x)),
                             torch.tensor(np.asarray(u)), steps=steps)[0].numpy()


def _rod2d():
    import torch

    from drake_tpu.contact import plant as jcp
    from drake_tpu_torch.contact import plant as tcp
    from drake_tpu_torch.examples import rod2d

    jm, jp, js = jax_example("rod2d").build(jnp.float64, 0.8)
    tm, tp, ts = rod2d.build(torch.float64, "cpu", 0.8)
    x = rod2d.initial_state(tm, torch.float64, "cpu").numpy()
    x[6] = 0.02 + 0.5 * abs(np.cos(np.pi / 3))  # the low end just touching: the impact
    return (jcp.make_discrete_system(jm, jp, js, rod2d.H), jp,
            tcp.make_discrete_system(tm, tp, ts, rod2d.H), tp, x, np.zeros(0))


def _rolling_sphere(hydro):
    import torch

    from drake_tpu.contact import plant as jcp
    from drake_tpu_torch.contact import plant as tcp
    from drake_tpu_torch.examples import rolling_sphere as rs

    jm, jp, js = jax_example("rolling_sphere").build(jnp.float64, hydro)
    tm, tp, ts = rs.build(torch.float64, "cpu", hydro)
    x = tm.default_state(torch.float64, "cpu").numpy()
    x[6], x[9], x[10] = rs.R - 1e-3, 10.0, 1.0
    return (jcp.make_discrete_system(jm, jp, js, rs.H), jp,
            tcp.make_discrete_system(tm, tp, ts, rs.H), tp, x, np.zeros(0))


def _atlas():
    import torch

    from drake_tpu.contact import plant as jcp
    from drake_tpu_torch.contact import plant as tcp
    from drake_tpu_torch.examples import atlas_drop

    jm, jp, js = jax_example("atlas_drop").build(jnp.float64)
    tm, tp, ts = atlas_drop.build(torch.float64, "cpu")
    x = atlas_drop.initial_state(tm, torch.float64, "cpu").numpy()
    x[6] = 0.95  # the feet 5 cm into the ground
    return (jcp.make_discrete_system(jm, jp, js, atlas_drop.H, actuated_joints=[]), jp,
            tcp.make_discrete_system(tm, tp, ts, atlas_drop.H, actuated_joints=[]), tp, x,
            np.zeros(0))


def _allegro(phase):
    import torch

    from drake_tpu.contact import plant as jcp
    from drake_tpu_torch.contact import plant as tcp
    from drake_tpu_torch.examples import allegro_hand as ah

    ja = jax_example("allegro_hand")
    jm, jp, js, joints = ja.build(jnp.float64, with_ball=phase == "grasp")
    tm, tp, ts, _ = ah.build(torch.float64, "cpu", with_ball=phase == "grasp")
    n = len(joints)
    jl = (jnp.full(n, ah.Q_LO), jnp.full(n, ah.Q_HI))
    tl = ah.limits(n, torch.float64, "cpu")
    x = tm.default_state(torch.float64, "cpu").numpy()
    if phase == "load":
        x[:n] = np.linspace(-0.35, 1.65, n)  # some joints past their limits
        kw = dict(actuated_joints=joints)
        u = np.full(n, 0.3)
    else:
        x[n + 6] = ah.BALL_Z0 - 2e-3
        x[: n] = 0.5
        kw = dict(actuated_joints=[], pd_joints=[(j, *ah.PD_GAINS) for j in joints])
        u = np.tile(ah.TARGETS, ah.N_FINGERS)
    return (jcp.make_discrete_system(jm, jp, js, ah.H, joint_limits=jl, **kw), jp,
            tcp.make_discrete_system(tm, tp, ts, ah.H, joint_limits=tl, **kw), tp, x, u)


def _simple_gripper():
    import torch

    from drake_tpu.contact import plant as jcp
    from drake_tpu_torch.contact import plant as tcp
    from drake_tpu_torch.examples import simple_gripper as sg

    jm, jp, js = jax_example("simple_gripper").build(jnp.float64)
    tm, tp, ts = sg.build(torch.float64, "cpu")
    kw = dict(actuated_joints=["jz", "jl"], couplers=[("jl", "jr", -1.0, 0.0)])
    x = tm.default_state(torch.float64, "cpu").numpy()
    x[1], x[2] = 0.035, -0.04  # the left pad 5 mm into the mug
    return (jcp.make_discrete_system(jm, jp, js, sg.H, **kw), jp,
            tcp.make_discrete_system(tm, tp, ts, sg.H, **kw), tp, x, np.array([12.0, 4.0]))


def _four_bar():
    import torch

    from drake_tpu.contact import plant as jcp
    from drake_tpu.geometry.scene import CollisionScene as JScene
    from drake_tpu_torch.contact import plant as tcp
    from drake_tpu_torch.examples import four_bar
    from drake_tpu_torch.geometry.scene import CollisionScene as TScene

    jm, jp = jax_example("four_bar").build(jnp.float64)
    tm, tp = four_bar.build(torch.float64, "cpu")
    ball = [(3 - 1, (0.0, 0.0, four_bar.L_ROCKER), -1, four_bar.ANCHOR)]
    x = np.array([0.1, -0.05, 0.08, 1.0, -0.5, 0.2])
    return (jcp.make_discrete_system(jm, jp, JScene.build([]), four_bar.H, ball_constraints=ball),
            jp, tcp.make_discrete_system(tm, tp, TScene.build([]), four_bar.H,
                                         ball_constraints=ball), tp, x, np.array([15.0, 0, 0]))


def _strandbeest():
    import torch

    from drake_tpu.contact import plant as jcp
    from drake_tpu.contact.sap import SapParameters as JSap
    from drake_tpu.geometry.scene import CollisionScene as JScene
    from drake_tpu_torch.contact import plant as tcp
    from drake_tpu_torch.contact.sap import SapParameters as TSap
    from drake_tpu_torch.examples import strandbeest
    from drake_tpu_torch.geometry.scene import CollisionScene as TScene

    js = jax_example("strandbeest")
    g = js.build_leg()
    jm, jp, jballs, _ = g.build(jnp.float64)
    _, tm, tp, tballs, q0 = strandbeest.build(torch.float64, "cpu")
    kw = dict(max_iterations=40, rel_tolerance=1e-8)
    x = np.concatenate([q0.numpy(), np.zeros(q0.shape[0])])
    u = np.zeros(q0.shape[0])
    u[tm.body_index("crank")] = 3.0
    return (jcp.make_discrete_system(jm, jp, JScene.build([]), strandbeest.H,
                                     ball_constraints=jballs, sap_params=JSap(**kw)), jp,
            tcp.make_discrete_system(tm, tp, TScene.build([]), strandbeest.H,
                                     ball_constraints=tballs, sap_params=TSap(**kw)), tp, x, u)


def _planar_gripper():
    import torch

    from drake_tpu.contact import plant as jcp
    from drake_tpu_torch.contact import plant as tcp
    from drake_tpu_torch.examples import planar_gripper as pg

    jm, jp, js = jax_example("planar_gripper").build(jnp.float64)
    tm, tp, ts = pg.build(torch.float64, "cpu")
    pd = [(name, *pg.PD) for name in pg.FINGER_JOINTS]
    q_des = pg.keyframe_trajectory(800, pg.H)
    x = tm.default_state(torch.float64, "cpu").numpy()
    x[0:4] = q_des[400]  # the tips pressed into the brick's faces
    return (jcp.make_discrete_system(jm, jp, js, pg.H, actuated_joints=[], pd_joints=pd), jp,
            tcp.make_discrete_system(tm, tp, ts, pg.H, actuated_joints=[], pd_joints=pd), tp, x,
            q_des[700])


DEMOS = {
    "rod2d": _rod2d,
    "rolling_sphere point": lambda: _rolling_sphere(False),
    "rolling_sphere hydro": lambda: _rolling_sphere(True),
    "atlas_drop": _atlas,
    "allegro_hand load": lambda: _allegro("load"),
    "allegro_hand grasp": lambda: _allegro("grasp"),
    "simple_gripper": _simple_gripper,
    "four_bar": _four_bar,
    "strandbeest": _strandbeest,
    "planar_gripper": _planar_gripper,
}


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("demo", list(DEMOS))
def test_demo_first_steps_match_jax(demo):
    jsys, jp, tsys, tp, x, u = DEMOS[demo]()
    ref = jax_steps(jsys, jp, jnp.asarray(x), jnp.asarray(u))
    got = port_steps(tsys, tp, x, u)
    assert np.isfinite(got).all()
    scale = float(np.max(np.abs(ref)))
    np.testing.assert_allclose(got, ref, rtol=0.0, atol=TOL * scale)
    assert float(np.max(np.abs(ref - x))) > 1e-6  # the steps moved the state


def test_suspension_dynamics_match_jax():
    """The bushing suspension's continuous plant with its force elements:
    xdot at the demo's initial state.  (The spatula's one contact pair, a hydro sphere of
    modulus 5e6 and 3 rings against a box, is held to the JAX package in
    tests/test_torch_primitive_contact.py's "hydro sphere-box" case.)"""
    import torch

    from drake_tpu.multibody import force_elements as jfel
    from drake_tpu.multibody import plant as jplant
    from drake_tpu_torch.examples import bushing_suspension as bs
    from drake_tpu_torch.multibody import force_elements as tfel
    from drake_tpu_torch.multibody import plant as tplant

    bm, bp, fe, fp = bs.build(torch.float64, "cpu")
    jbm, jbp = _jax_suspension_model()
    jfeb = jfel.ForceElementBuilder(jbm)
    jfeb.add_bushing("anchor", "block", X_AF_xyz=(0.0, 0.0, 0.5), torque_stiffness=(6.0, 6.0, 4.0),
                     torque_damping=(0.5, 0.5, 0.3), force_stiffness=(300.0, 300.0, 250.0),
                     force_damping=(8.0, 8.0, 6.0))
    for sx in (1.0, -1.0):
        jfeb.add_linear_spring_damper("anchor", (0.4 * sx, 0.0, 0.5), "block",
                                      (0.1 * sx, 0.0, 0.0), free_length=0.3, stiffness=80.0,
                                      damping=2.0)
    jfe, jfp = jfeb.build(jnp.float64)
    jc = jplant.make_system(jbm, jbp, applied_forces=lambda p, q, v, t: jfel.generalized_forces(
        jbm, p, jfe, jfp, q, v))
    tc = tplant.make_system(bm, bp, applied_forces=lambda p, q, v, t: tfel.generalized_forces(
        bm, p, fe, fp, q, v))
    x = bm.default_state(torch.float64, "cpu")
    x[4:7] = torch.tensor([0.12, -0.08, 0.35])
    ref = np.asarray(run_jitted(lambda x0: jc.f(jbp, x0, jnp.zeros(0), 0.0),
                                jnp.asarray(x.numpy())))
    got = tc.f(bp, x, x.new_zeros(0), 0.0).numpy()
    np.testing.assert_allclose(got, ref, rtol=0.0, atol=TOL * float(np.max(np.abs(ref))))


def _jax_suspension_model():
    """The JAX example builds it inside main: the same calls here."""
    from drake_tpu.multibody.model import ModelBuilder

    b = ModelBuilder()
    b.add_body("anchor", parent=None, joint_type="weld", mass=0.0)
    b.add_body("block", parent="anchor", joint_type="floating", mass=2.0,
               inertia_com=np.diag([0.02, 0.03, 0.04]))
    return b.build(jnp.float64)


SMOKE_DEPTHS = {"simple_gripper": 5, "strandbeest": 0.01, "atlas_drop": 5,
                "spatula_slip_control": 5, "allegro_hand": [5, 5], "bushing_suspension": 20,
                "four_bar": 0.01, "rolling_sphere": [3, 5], "rod2d": 5, "planar_gripper": 5}


@pytest.mark.parametrize("name", list(SMOKE_DEPTHS))
def test_demo_smoke_entry(name):
    """Each demo's ``smoke`` (what chip_smoke.py phase 22b calls), a few
    steps on the CPU: finite final states under the names of the JAX
    package's readings in tests/contact_reference.json, whose depths are
    chip_smoke.py's, and checks that are booleans."""
    import json

    import torch

    sys.path.insert(0, REPO)
    try:
        import chip_smoke as cs
    finally:
        sys.path.pop(0)
    demo = importlib.import_module(f"drake_tpu_torch.examples.{name}")
    states, checks = demo.smoke(SMOKE_DEPTHS[name], torch.device("cpu"), torch.float32)
    with open(os.path.join(REPO, cs.RIGID_REFERENCE)) as f:
        ref = json.load(f)
    assert ref["depths"][name] == cs.RIGID_DEPTHS[name]
    assert set(states) == set(ref["demos"][name])
    for run, x in states.items():
        assert torch.isfinite(x).all()
        assert x.shape == np.asarray(ref["demos"][name][run]["f32"]).shape
    assert checks and all(ok in (True, False) for ok in checks.values())
