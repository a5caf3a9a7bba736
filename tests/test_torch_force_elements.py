"""Parity of drake_tpu_torch's force elements and loop topology against
drake_tpu's, on the CPU in float64.

Force elements: a welded anchor and a floating block joined by a bushing
(rotational and translational stiffness and damping) and two spring
dampers, and a revolute-prismatic arm with a joint spring, a door hinge
and a spring damper to the block; both packages build them from the same
builder calls.  The lanes come from a numpy seed (random block poses near
the anchor, arm angles, velocities).  ``generalized_forces`` and
``spring_potential_energy`` are compared, and the port's parameters are
carried across from the JAX ones by ``multibody.convert``.

Topology: the four-bar of ``tests/test_topology.py`` and a two-loop linkage,
as link graphs with their loops: the spanning forest, the cut joints' ball
constraints, ``loop_residual`` and ``assemble`` from a rough guess, and one
SAP step of the four-bar closed by its ball constraint.

Tolerance: 1e-10 of each quantity's scale; assemble's result within 1e-9
absolute (both stop on a residual of 1e-10).

torch and the port are imported when a test here runs, not when pytest
collects this file (see tests/test_torch_mpm_kernels.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_multibody import run_jitted

LANES = 5
TOL = 1e-10


def build_elements(pkg, dtype, **kw):
    if pkg == "jax":
        from drake_tpu.multibody import force_elements as fel
        from drake_tpu.multibody.model import ModelBuilder
    else:
        from drake_tpu_torch.multibody import force_elements as fel
        from drake_tpu_torch.multibody.model import ModelBuilder
    b = ModelBuilder()
    b.add_body("anchor", parent=None, joint_type="weld", mass=0.0)
    b.add_body("block", parent="anchor", joint_type="floating", mass=2.0,
               inertia_com=np.diag([0.02, 0.03, 0.04]))
    b.add_body("arm", parent=None, joint_type="revolute", mass=1.0, com=(0.2, 0, 0),
               inertia_com=np.eye(3) * 0.01, axis=(0, 0, 1), joint_name="hinge")
    b.add_body("slide", parent="arm", joint_type="prismatic", mass=0.5,
               inertia_com=np.eye(3) * 0.002, axis=(1, 0, 0), joint_name="slide",
               X_PJ_xyz=(0.4, 0, 0))
    model, params = b.build(dtype, **kw)
    feb = fel.ForceElementBuilder(model)
    feb.add_bushing("anchor", "block", X_AF_xyz=(0.0, 0.0, 0.5), X_AF_rpy=(0.1, 0.0, -0.2),
                    X_CM_xyz=(0.05, 0.0, 0.0), X_CM_rpy=(0.0, 0.2, 0.1),
                    torque_stiffness=(6.0, 6.0, 4.0), torque_damping=(0.5, 0.5, 0.3),
                    force_stiffness=(300.0, 300.0, 250.0), force_damping=(8.0, 8.0, 6.0))
    feb.add_linear_spring_damper("anchor", (0.4, 0.0, 0.5), "block", (0.1, 0.0, 0.0),
                                 free_length=0.3, stiffness=80.0, damping=2.0)
    feb.add_linear_spring_damper("slide", (0.05, 0.0, 0.0), "block", (-0.1, 0.02, 0.0),
                                 free_length=0.2, stiffness=40.0, damping=1.0)
    feb.add_joint_spring("slide", nominal=0.05, stiffness=30.0)
    feb.add_door_hinge("hinge")
    fe, fp = feb.build(dtype, **kw)
    return model, params, fe, fp


def element_lanes(seed=0):
    rng = np.random.default_rng(seed)
    q = np.zeros((LANES, 9))
    quat = np.array([1.0, 0, 0, 0]) + 0.3 * rng.standard_normal((LANES, 4))
    q[:, :4] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 4:7] = np.array([0.1, -0.05, 0.35]) + 0.1 * rng.standard_normal((LANES, 3))
    q[:, 7] = rng.uniform(-0.5, 0.5, LANES)
    q[:, 8] = rng.uniform(-0.05, 0.1, LANES)
    v = rng.standard_normal((LANES, 8))
    return q, v


@pytest.fixture(scope="module")
def elements():
    import torch

    from drake_tpu.multibody import force_elements as jfel
    from drake_tpu_torch.multibody import convert

    torch.set_num_threads(1)
    jm, jp, jfe, jfp = build_elements("jax", jnp.float64)
    q, v = element_lanes()

    def one(q1, v1):
        return (jfel.generalized_forces(jm, jp, jfe, jfp, q1, v1),
                jfel.spring_potential_energy(jm, jp, jfe, jfp, q1))

    tau, energy = (np.asarray(x) for x in run_jitted(jax.vmap(one), q, v))
    carried = convert.force_elements_from_numpy(
        dataclasses.asdict(jfe),
        {f.name: np.asarray(getattr(jfp, f.name)) for f in dataclasses.fields(jfp)},
        device="cpu")
    return dict(ref={"tau": tau, "energy": energy}, q=q, v=v, carried=carried)


def near(got, ref, tol=TOL):
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    scale = float(np.max(np.abs(ref))) or 1.0
    np.testing.assert_allclose(got, ref, rtol=0.0, atol=tol * scale)


@pytest.mark.parametrize("source", ["builder", "convert"])
@pytest.mark.parametrize("what", ["tau", "energy"])
def test_force_elements_match_jax(elements, source, what):
    import torch

    from drake_tpu_torch.multibody import force_elements as tfel

    tm, tp, fe, fp = build_elements("torch", torch.float64, device="cpu")
    if source == "convert":
        fe, fp = elements["carried"]
    q, v = torch.tensor(elements["q"]), torch.tensor(elements["v"])
    got = (tfel.generalized_forces(tm, tp, fe, fp, q, v) if what == "tau"
           else tfel.spring_potential_energy(tm, tp, fe, fp, q))
    near(got, elements["ref"][what])


def test_force_element_power_balances_energy(elements):
    """The conservative part of tau is -dU/dq mapped to v: at v = 0 the
    virtual power tau . dv equals -dU along qdot(dv), by autograd."""
    import torch

    from drake_tpu_torch.multibody import force_elements as tfel
    from drake_tpu_torch.multibody.plant import qdot_from_v

    tm, tp, fe, fp = build_elements("torch", torch.float64, device="cpu")
    q = torch.tensor(elements["q"], requires_grad=True)
    dv = torch.tensor(elements["v"])
    zero = torch.zeros_like(dv)
    U = tfel.spring_potential_energy(tm, tp, fe, fp, q)
    (dU,) = torch.autograd.grad(U.sum(), q)
    # The door hinge's catch and friction are not in U; leave its joint out.
    dv[:, 6] = 0.0
    power = torch.sum(tfel.generalized_forces(tm, tp, fe, fp, q.detach(), zero) * dv, dim=-1)
    dU_dt = torch.sum(dU * qdot_from_v(tm, tp, q.detach(), dv), dim=-1)
    near(power, -dU_dt.detach().numpy(), 1e-8)


def four_bar_graph(topo):
    g = topo.LinkGraph()
    rod = lambda L: np.diag([L**2 / 12, L**2 / 12, 1e-3])  # noqa: E731
    g.add_link("crank", mass=1.0, com=(0, 0, -0.5), inertia_com=rod(1.0))
    g.add_link("coupler", mass=1.0, com=(1.0, 0, 0), inertia_com=rod(2.0))
    g.add_link("rocker", mass=1.0, com=(0, 0, 0.5), inertia_com=rod(1.0))
    g.add_joint("ground_crank", parent=topo.WORLD, child="crank", axis=(0, 1, 0))
    g.add_joint("crank_coupler", parent="crank", child="coupler", axis=(0, 1, 0),
                p_PJ=(0, 0, -1.0))
    g.add_joint("coupler_rocker", parent="coupler", child="rocker", axis=(0, 1, 0),
                p_PJ=(2.0, 0, 0))
    g.add_joint("rocker_ground", parent="rocker", child=topo.WORLD, axis=(0, 1, 0),
                p_PJ=(0, 0, 1.0), p_CJ=(2.0, 0, 0))
    return g


def two_loop_graph(topo):
    """The four-bar with a second loop: a bar from the coupler's middle to a
    second ground pivot, and a welded plate closing on the crank."""
    g = four_bar_graph(topo)
    g.add_link("strut", mass=0.5, com=(0.0, 0, 0.4), inertia_com=np.eye(3) * 0.02)
    g.add_joint("coupler_strut", parent="coupler", child="strut", axis=(0, 1, 0),
                p_PJ=(1.0, 0, 0))
    g.add_joint("strut_ground", parent="strut", child=topo.WORLD, axis=(0, 1, 0),
                p_PJ=(0, 0, 0.9), p_CJ=(1.0, 0, -0.1))
    g.add_link("plate", mass=0.2, inertia_com=np.eye(3) * 0.001)
    g.add_joint("crank_plate", parent="crank", child="plate", axis=(0, 1, 0),
                p_PJ=(0, 0, -0.5))
    g.add_joint("plate_weld", parent="plate", child="crank", joint_type="weld",
                p_CJ=(0, 0, -0.5))
    return g


# Guesses a few Gauss-Newton steps from the loops' manifold (the JAX
# package's assemble runs eagerly, about a second a step).
GRAPHS = {"four_bar": (four_bar_graph, [0.3, -0.25, 0.2]),
          "two_loops": (two_loop_graph, [0.05, -0.05, 0.05, 0.02, 0.01])}


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_topology_matches_jax(graph):
    import torch

    from drake_tpu.multibody import topology as jtopo
    from drake_tpu_torch.multibody import convert
    from drake_tpu_torch.multibody import topology as ttopo

    make, guess = GRAPHS[graph]
    jg, tg = make(jtopo), make(ttopo)
    jf, tf = jg.spanning_forest(), tg.spanning_forest()
    assert [(j.name, fwd) for j, fwd in tf.tree_edges] == [(j.name, fwd) for j, fwd in
                                                           jf.tree_edges]
    assert [j.name for j in tf.loop_joints] == [j.name for j in jf.loop_joints]
    jm, jp, jballs, jwelds = jg.build(jnp.float64)
    tm, tp, tballs, twelds = tg.build(torch.float64, device="cpu")
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    for f in dataclasses.fields(jp):
        near(getattr(tp, f.name), np.asarray(getattr(jp, f.name)), 0.0)
    balls, welds = convert.constraints_from_numpy(jballs, jwelds)
    assert balls == convert.constraints_from_numpy(tballs, twelds)[0]
    assert welds == convert.constraints_from_numpy(tballs, twelds)[1]
    q_guess = np.asarray(guess[: jm.num_positions], np.float64)
    near(ttopo.loop_residual(tm, tp, tballs, torch.tensor(q_guess)),
         np.asarray(jtopo.loop_residual(jm, jp, jballs, jnp.asarray(q_guess))))
    jq, jerr = jtopo.assemble(jm, jp, jballs, jnp.asarray(q_guess))
    tq, terr = ttopo.assemble(tm, tp, tballs, torch.tensor(q_guess))
    assert terr < 1e-10 and jerr < 1e-10
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0.0, atol=1e-9)


def test_four_bar_sap_step_matches_jax():
    """One discrete step of the four-bar closed by its cut joint's ball
    constraint, under a crank torque, from an assembled pose."""
    import torch

    from drake_tpu.contact import plant as jcp
    from drake_tpu.geometry.scene import CollisionScene as JScene
    from drake_tpu.multibody import topology as jtopo
    from drake_tpu_torch.contact import plant as tcp
    from drake_tpu_torch.geometry.scene import CollisionScene as TScene
    from drake_tpu_torch.multibody import topology as ttopo

    jm, jp, jballs, _ = four_bar_graph(jtopo).build(jnp.float64)
    tm, tp, tballs, _ = four_bar_graph(ttopo).build(torch.float64, device="cpu")
    q0, _ = jtopo.assemble(jm, jp, jballs, jnp.asarray([0.4, -0.3, 0.2]))
    x = np.concatenate([np.asarray(q0), [0.5, -0.2, 0.1]])
    u = np.array([15.0, 0.0, 0.0])
    jsys = jcp.make_discrete_system(jm, jp, JScene.build([]), 2e-3, ball_constraints=jballs)
    tsys = tcp.make_discrete_system(tm, tp, TScene.build([]), 2e-3, ball_constraints=tballs)
    ref = np.asarray(run_jitted(lambda x1: jsys.g(jp, x1, jnp.asarray(u)), x))
    near(tsys.g(tp, torch.tensor(x), torch.tensor(u)), ref)
