"""The JAX package's float32 readings behind chip_smoke.py phase 22's gates.

The card has no JAX, so phase 22 holds the port's float32 demos on the card
to readings that this script computes with the JAX package on the CPU, and
writes to ``tests/contact_reference.json`` (read by chip_smoke.py):

- 22b: each rigid-contact demo at the depth chip_smoke.py runs it
  (``RIGID_DEPTHS``), built by the JAX example's own ``build`` (the
  spatula and the suspension, which the JAX examples build inside main,
  by the same calls), from the port's initial states, with the port's
  inputs: the final state of each run in float32, and its float32 floor,
  the largest |float32 - float64| of the same run;
- 22c: the allegro hand's PD grasp over the first ``GRASP_CHECK_LANES``
  lanes of phase 22c's targets (the demo's, plus 0.05 N(0, 1) from a
  ``torch.Generator`` seeded 0) at ``GRASP_LANE_STEPS``: each lane's final
  state in float32, and the float32 floor over them.

Phase 22 bounds each reading by ``RIGID_FLOOR_FACTOR`` times its floor
(at least ``RIGID_MIN_BOUND``).

Run from the repo root:  JAX_PLATFORMS=cpu python tests/contact_reference.py
(a few minutes on one core; ``--demo NAME`` for one demo).
"""

import argparse
import importlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)
OUT = os.path.join(HERE, "contact_reference.json")


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


def rollout(jax, system, params, x, steps, inputs=None):
    """The final state after `steps` steps; ``inputs`` None, (nu,) held, or
    (steps, nu) a row a step."""
    jnp = jax.numpy
    if inputs is None:
        inputs = jnp.zeros((0,), x.dtype)
    per_step = inputs.ndim == x.ndim + 1

    @jax.jit
    def run(x0, us):
        def body(xx, u):
            return system.g(params, xx, u), None

        if per_step:
            return jax.lax.scan(body, x0, us)[0]
        return jax.lax.scan(lambda xx, _: body(xx, us), x0, None, length=steps)[0]

    return np.asarray(run(x, inputs), np.float64)


def demos(jax, dtype, depths):
    """{demo: {run: final state (numpy float64)}} at `depths`, in `dtype`."""
    import torch

    jnp = jax.numpy
    from drake_tpu.contact import plant as jcp
    from drake_tpu.contact.sap import SapParameters
    from drake_tpu.geometry import shapes as jsh
    from drake_tpu.geometry.scene import CollisionGeometry, CollisionScene
    from drake_tpu.multibody import force_elements as jfel
    from drake_tpu.multibody import plant as jplant
    from drake_tpu.multibody.model import ModelBuilder
    from drake_tpu.systems import simulator as jsim
    from drake_tpu_torch.examples import (allegro_hand, atlas_drop, bushing_suspension, four_bar,
                                          planar_gripper, rod2d, rolling_sphere, simple_gripper,
                                          spatula_slip_control, strandbeest)

    def a(x):  # a port tensor or numpy array as a JAX array of `dtype`
        return jnp.asarray(np.asarray(x.cpu() if hasattr(x, "cpu") else x), dtype)

    out = {}
    ex = jax_example("rod2d")
    tm = rod2d.build(torch.float64, "cpu")[0]
    x0 = rod2d.initial_state(tm, torch.float64, "cpu")
    out["rod2d"] = {}
    for tag, mu in (("x_hi", 0.8), ("x_lo", 0.1)):
        m, p, s = ex.build(dtype, mu)
        out["rod2d"][tag] = rollout(jax, jcp.make_discrete_system(m, p, s, rod2d.H), p, a(x0),
                                    depths["rod2d"])

    ex = jax_example("rolling_sphere")
    settle, steps = depths["rolling_sphere"]
    out["rolling_sphere"] = {}
    for tag, hydro in (("point", False), ("hydro", True)):
        m, p, s = ex.build(dtype, hydro)
        system = jcp.make_discrete_system(m, p, s, rolling_sphere.H)
        x = m.default_state(dtype).at[6].set(rolling_sphere.R)
        x = jnp.asarray(rollout(jax, system, p, x, settle), dtype)
        out["rolling_sphere"][f"{tag} x_roll"] = rollout(
            jax, system, p, x.at[10].set(rolling_sphere.V0), steps)
        out["rolling_sphere"][f"{tag} x_spin"] = rollout(
            jax, system, p, x.at[9].set(rolling_sphere.W0), steps)

    m, p, s = jax_example("atlas_drop").build(dtype)
    tm = atlas_drop.build(torch.float64, "cpu")[0]
    out["atlas_drop"] = {"x": rollout(
        jax, jcp.make_discrete_system(m, p, s, atlas_drop.H, actuated_joints=[]), p,
        a(atlas_drop.initial_state(tm, torch.float64, "cpu")), depths["atlas_drop"])}

    ex = jax_example("allegro_hand")
    load, grasp = depths["allegro_hand"]
    m, p, s, joints = ex.build(dtype, with_ball=False)
    n = len(joints)
    lims = (jnp.full(n, allegro_hand.Q_LO, dtype), jnp.full(n, allegro_hand.Q_HI, dtype))
    system = jcp.make_discrete_system(m, p, s, allegro_hand.H, actuated_joints=joints,
                                      joint_limits=lims)
    tau = jnp.full((n,), 0.3, dtype)
    x_hi = rollout(jax, system, p, m.default_state(dtype), load, tau)
    x_lo = rollout(jax, system, p, a(x_hi), load, -tau)
    out["allegro_hand"] = {"x_hi": x_hi, "x_lo": x_lo,
                           "x_grasp": grasp_lanes(jax, dtype, np.tile(allegro_hand.TARGETS, allegro_hand.N_FINGERS),
                                                  grasp)[0]}

    ex = jax_example("simple_gripper")
    m, p, s = ex.build(dtype)
    system = jcp.make_discrete_system(m, p, s, simple_gripper.H, actuated_joints=["jz", "jl"],
                                      couplers=[("jl", "jr", -1.0, 0.0)])
    x = m.default_state(dtype).at[1].set(0.04).at[2].set(-0.04)
    out["simple_gripper"] = {
        tag: rollout(jax, system, p, x, depths["simple_gripper"],
                     a(simple_gripper.inputs(f, depths["simple_gripper"], torch.float64, "cpu")))
        for tag, f in simple_gripper.GRIPS.items()}

    ex = jax_example("four_bar")
    seconds = depths["four_bar"]
    mb, pb = ex.build(dtype, with_anchor_body=True)
    feb = jfel.ForceElementBuilder(mb)
    feb.add_bushing("anchor", "rocker", X_CM_xyz=(0.0, 0.0, four_bar.L_ROCKER),
                    torque_stiffness=(0.0, 0.0, 0.0), torque_damping=(0.0, 0.0, 0.0),
                    force_stiffness=(30000.0,) * 3, force_damping=(300.0,) * 3)
    fe, fp = feb.build(dtype)
    csys = jplant.make_system(mb, pb, applied_forces=lambda pp, q, v, t: jfel.generalized_forces(
        mb, pp, fe, fp, q, v))
    steps_c = int(seconds / four_bar.H_BUSHING)
    u = jnp.zeros((steps_c, 3), dtype).at[:, 0].set(four_bar.TORQUE)
    xs = jax.jit(lambda x0: jsim.simulate(csys, pb, x0, u, four_bar.H_BUSHING)[0])(
        jnp.zeros(6, dtype))
    mc, pc = ex.build(dtype)
    dsys = jcp.make_discrete_system(
        mc, pc, CollisionScene.build([]), four_bar.H,
        ball_constraints=[(mc.body_index("rocker"), (0.0, 0.0, four_bar.L_ROCKER), -1,
                           four_bar.ANCHOR)])
    out["four_bar"] = {"x_bushing": np.asarray(xs[-1], np.float64),
                       "x_constraint": rollout(jax, dsys, pc, jnp.zeros(6, dtype),
                                               int(seconds / four_bar.H),
                                               jnp.asarray([four_bar.TORQUE, 0.0, 0.0], dtype))}

    g = jax_example("strandbeest").build_leg()
    m, p, balls, _ = g.build(dtype)
    q0 = a(strandbeest.build(torch.float64, "cpu")[4])
    nq = m.num_positions
    crank = m.body_index("crank")
    system = jcp.make_discrete_system(
        m, p, CollisionScene.build([]), strandbeest.H, ball_constraints=balls,
        sap_params=SapParameters(max_iterations=40, rel_tolerance=1e-8))

    @jax.jit
    def beest(x, ts):
        def body(xx, t):
            th_des = q0[crank] - strandbeest.OMEGA * t
            uu = jnp.zeros(nq, dtype).at[crank].set(
                strandbeest.KP * (th_des - xx[crank]) + strandbeest.KD * (-strandbeest.OMEGA
                                                                          - xx[nq + crank]))
            return system.g(p, xx, uu), None

        return jax.lax.scan(body, x, ts)[0]

    n_beest = int(depths["strandbeest"] / strandbeest.H)
    ts = jnp.asarray(np.arange(n_beest) * strandbeest.H, dtype)
    out["strandbeest"] = {"x": np.asarray(beest(jnp.concatenate([q0, jnp.zeros(nq, dtype)]), ts),
                                          np.float64)}

    m, p, s = jax_example("planar_gripper").build(dtype)
    pd = [(name, *planar_gripper.PD) for name in planar_gripper.FINGER_JOINTS]
    system = jcp.make_discrete_system(m, p, s, planar_gripper.H, actuated_joints=[], pd_joints=pd)
    q_des = planar_gripper.keyframe_trajectory(depths["planar_gripper"], planar_gripper.H)
    x = m.default_state(dtype).at[0:4].set(a(q_des[0]))
    out["planar_gripper"] = {"x": rollout(jax, system, p, x, depths["planar_gripper"], a(q_des))}

    sp = spatula_slip_control
    out["spatula_slip_control"] = {}
    for tag, (hydro, overlap) in sp.RUNS.items():
        b = ModelBuilder()
        b.add_body("spatula", parent=None, joint_type="floating", mass=sp.M,
                   com=(0.0, sp.D_COM, 0.0), inertia_com=np.eye(3) * 2e-4)
        m, p = b.build(dtype)
        knob = dict(name="knob", body=0, shape=jsh.Sphere(sp.R_KNOB), friction=sp.MU,
                    dissipation=0.2)
        knob.update(dict(hydroelastic_modulus=5e6, hydro_rings=3) if hydro
                    else dict(stiffness=5e7))
        gap = sp.R_KNOB - overlap
        pads = [CollisionGeometry(name=f"pad_{side}", body=-1, shape=jsh.Box((0.02, 0.08, 0.08)),
                                  p_BG=np.array([sgn * (gap + 0.01), 0.0, 0.0]), friction=sp.MU,
                                  stiffness=1e10, dissipation=0.2)
                for side, sgn in (("minus", -1.0), ("plus", 1.0))]
        s = CollisionScene.build([CollisionGeometry(**knob)] + pads)
        out["spatula_slip_control"][tag] = rollout(
            jax, jcp.make_discrete_system(m, p, s, sp.H), p, m.default_state(dtype),
            depths["spatula_slip_control"])

    bs = bushing_suspension
    b = ModelBuilder()
    b.add_body("anchor", parent=None, joint_type="weld", mass=0.0)
    b.add_body("block", parent="anchor", joint_type="floating", mass=2.0,
               inertia_com=np.diag([0.02, 0.03, 0.04]))
    m, p = b.build(dtype)
    feb = jfel.ForceElementBuilder(m)
    feb.add_bushing("anchor", "block", X_AF_xyz=(0.0, 0.0, 0.5), torque_stiffness=(6.0, 6.0, 4.0),
                    torque_damping=(0.5, 0.5, 0.3), force_stiffness=(300.0, 300.0, 250.0),
                    force_damping=(8.0, 8.0, 6.0))
    for sx in (1.0, -1.0):
        feb.add_linear_spring_damper("anchor", (0.4 * sx, 0.0, 0.5), "block", (0.1 * sx, 0.0, 0.0),
                                     free_length=0.3, stiffness=80.0, damping=2.0)
    fe, fp = feb.build(dtype)
    csys = jplant.make_system(m, p, applied_forces=lambda pp, q, v, t: jfel.generalized_forces(
        m, pp, fe, fp, q, v))
    x0 = m.default_state(dtype).at[4:7].set(jnp.asarray([0.12, -0.08, 0.35], dtype))
    n = depths["bushing_suspension"]
    xs = jax.jit(lambda x: jsim.simulate(csys, p, x, jnp.zeros((n, 0), dtype), bs.H)[0])(x0)
    out["bushing_suspension"] = {"x": np.asarray(xs[-1], np.float64)}
    return out


def grasp_targets(lanes):
    """Phase 22c's targets (lanes, 12) float32: the demo's plus 0.05 N(0, 1)
    from a torch.Generator seeded 0, drawn on the CPU."""
    import torch

    from drake_tpu_torch.examples import allegro_hand

    g = torch.Generator().manual_seed(0)
    base = torch.tensor(np.tile(allegro_hand.TARGETS, allegro_hand.N_FINGERS), dtype=torch.float32)
    return (base + 0.05 * torch.randn((lanes, base.shape[0]), generator=g)).numpy()


def grasp_lanes(jax, dtype, targets, steps):
    """The JAX allegro PD grasp from the ball at rest over lanes of targets
    (..., 12): the final states (..., nx)."""
    jnp = jax.numpy
    from drake_tpu.contact import plant as jcp
    from drake_tpu_torch.examples import allegro_hand

    ex = jax_example("allegro_hand")
    m, p, s, joints = ex.build(dtype, with_ball=True)
    n = len(joints)
    lims = (jnp.full(n, allegro_hand.Q_LO, dtype), jnp.full(n, allegro_hand.Q_HI, dtype))
    system = jcp.make_discrete_system(m, p, s, allegro_hand.H, actuated_joints=[],
                                      joint_limits=lims,
                                      pd_joints=[(j, *allegro_hand.PD_GAINS) for j in joints])
    iq_ball = m.q_offsets[m.body_index("ball")]
    x0 = m.default_state(dtype).at[iq_ball + 6].set(allegro_hand.BALL_Z0)
    targets = jnp.asarray(np.asarray(targets), dtype).reshape(-1, n)

    @jax.jit
    def run(u):
        return jax.lax.scan(lambda xx, _: (system.g(p, xx, u), None), x0, None, length=steps)[0]

    return np.asarray(jax.vmap(run)(targets), np.float64)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--demo", default=None, help="print one demo's readings only")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import chip_smoke as cs

    depths = cs.RIGID_DEPTHS
    f32, f64 = demos(jax, jnp.float32, depths), demos(jax, jnp.float64, depths)
    out = {"depths": depths, "demos": {}}
    for demo, runs in f32.items():
        out["demos"][demo] = {run: {"f32": x.tolist(),
                                    "floor": float(np.max(np.abs(x - f64[demo][run])))}
                              for run, x in runs.items()}
        if args.demo in (None, demo):
            print(demo, {run: v["floor"] for run, v in out["demos"][demo].items()})
    if args.demo is not None:
        return
    targets = grasp_targets(cs.GRASP_CHECK_LANES)
    g32 = grasp_lanes(jax, jnp.float32, targets, cs.GRASP_LANE_STEPS)
    g64 = grasp_lanes(jax, jnp.float64, targets, cs.GRASP_LANE_STEPS)
    out["grasp_lanes"] = {"steps": cs.GRASP_LANE_STEPS, "f32": g32.tolist(),
                          "floor": float(np.max(np.abs(g32 - g64)))}
    print("grasp lanes floor", out["grasp_lanes"]["floor"])
    with open(OUT, "w") as f:
        json.dump(out, f)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
