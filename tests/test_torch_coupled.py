"""Parity of the port's coupled MPM + rigid world (drake_tpu_torch's
multibody prismatic joint, mpm.coupling and contact.coupled_plant) against
the JAX package's, on the CPU in float64.

The world is config 5's paddle and blob (drake_tpu_torch.benchmarks.
paddle_blob, from benchmarks/bench_coupled_mpc.py) cut to a 16^3 grid
(dx 1/16, 45 particles) and 2 substeps a coupled step.  Two lanes with
different paddle positions, velocities and torques, and particle
velocities from a numpy seed, so that both lanes' paddles press into the
blob.  Every JAX quantity comes from one jitted program (vmapped over the
lanes), compiled at XLA's lowest CPU optimization level.

Tolerances: the prismatic chain's kinematics and dynamics 1e-10; particle
x, v and F 1e-9 and C 1e-6 (it carries 4/dx^2); rigid state 1e-9;
impulses 1e-8 of their largest magnitude.  All far above float64 rounding
of the same arithmetic in another order.

torch and the port are imported when a test here runs, not when pytest
collects this file (see tests/test_torch_mpm_kernels.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_multibody import close, run_jitted

LANES = 2
GRID = (16, 16, 16)
SUBSTEPS = 2
XVF_TOL = 1e-9
C_TOL = 1e-6
RIGID_TOL = 1e-9
IMPULSE_TOL = 1e-8
CHAIN_TOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch on one thread while these tests run: pytest-xdist runs several
    workers on the same cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_paddle_world(grid=GRID, substeps=SUBSTEPS, dtype=jnp.float64):
    """The JAX package's config-5 world as benchmarks/bench_coupled_mpc.py
    builds it, in `dtype` (float64 by default), on `grid` with dx =
    1/grid[0]."""
    from drake_tpu.contact import coupled_plant
    from drake_tpu.geometry import shapes as sh
    from drake_tpu.geometry.scene import CollisionGeometry, CollisionScene
    from drake_tpu.mpm import coupling as cpl
    from drake_tpu.mpm import solver as mpm
    from drake_tpu.multibody.model import ModelBuilder

    b = ModelBuilder(gravity=(0.0, 0.0, -9.81))
    b.add_body(
        "paddle", parent=None, joint_type="prismatic", mass=2.0,
        inertia_com=np.eye(3) * 1e-3, axis=(1, 0, 0), damping=5.0,
        joint_name="slide", X_PJ_xyz=(0.0, 0.5, 0.0),
    )
    model, params = b.build(dtype)
    geoms = [CollisionGeometry(
        name="paddle", body=0, shape=sh.Box((0.02, 0.3, 0.3)), friction=0.5,
        stiffness=1e5, dissipation=0.1, p_BG=np.asarray([0.0, 0.0, 0.15]),
    )]
    config = mpm.MpmConfig(
        grid_size=grid, dx=1.0 / grid[0], dt=1e-3, wall_width=2, youngs_modulus=3e4,
        max_active_blocks=64, block_capacity=512,
    )
    world = coupled_plant.CoupledWorld(
        model=model, scene=CollisionScene.build(geoms), mpm_config=config,
        contact_params=cpl.MpmContactParams(stiffness=5e4, damping=100.0, friction=0.3),
        coupled_geometries=(0,), substeps_per_step=substeps, time_step=1e-2,
    )
    particles = mpm.make_particle_block(
        config, (0.35, 0.42, 0.08), (0.45, 0.58, 0.18), dtype=dtype
    )
    return world, params, particles


def port_paddle_world(grid=GRID, substeps=SUBSTEPS):
    """The port's world (drake_tpu_torch.benchmarks.paddle_blob) in float64
    on the CPU, cut as jax_paddle_world cuts the reference's."""
    import torch

    from drake_tpu_torch.benchmarks import paddle_blob
    from drake_tpu_torch.contact import coupled_plant
    from drake_tpu_torch.mpm import solver

    w = paddle_blob.build(device="cpu", dtype=torch.float64)
    config = dataclasses.replace(w.world.mpm_config, grid_size=grid, dx=1.0 / grid[0])
    world = dataclasses.replace(w.world, mpm_config=config, substeps_per_step=substeps)
    particles = solver.make_particle_block(config, *paddle_blob.BLOB, dtype=torch.float64,
                                           device="cpu")
    return w._replace(world=world, state0=coupled_plant.CoupledState(
        rigid=w.state0.rigid, particles=particles))


def lane_inputs(n, seed=0):
    """rigid (LANES, 2), particle x and v (LANES, n, 3), tau (LANES, 1):
    each lane's paddle face inside the blob's first layer, moving."""
    rng = np.random.default_rng(seed)
    rigid = np.asarray([[0.36, 0.3], [0.37, -0.2]])
    v = 0.05 * rng.standard_normal((LANES, n, 3))
    tau = np.asarray([[3.0], [-4.0]])
    return rigid, v, tau


def _state_np(state):
    return {f.name: np.asarray(getattr(state, f.name)) for f in dataclasses.fields(state)}


@pytest.fixture(scope="module")
def coupled():
    """Both packages' worlds, the lane inputs, and every JAX quantity of the
    coupling tests from one jitted program."""
    import torch

    from drake_tpu.geometry import shapes as jsh
    from drake_tpu.contact import coupled_plant as jcp
    from drake_tpu.mpm import coupling as jcpl

    jworld, jparams, jparticles = jax_paddle_world()
    n = jparticles.x.shape[0]
    rigid, v, tau = lane_inputs(n)
    # Extra geometries per lane, so that every ported shape meets particles:
    # a sphere among them and a tilted halfspace through the blob.
    sphere_c = np.asarray([[0.40, 0.50, 0.13], [0.42, 0.47, 0.12]])
    tilt = np.asarray([0.2, -0.3])

    def one(rigid1, v1, tau1, c1, a1):
        nq = jworld.model.num_positions
        p = jparticles.replace(v=v1)
        q, qd = rigid1[:nq], rigid1[nq:]
        geoms = jworld.rigid_geoms(jparams, q, qd)
        R_t = jnp.asarray([[1.0, 0.0, 0.0], [0.0, jnp.cos(a1), -jnp.sin(a1)],
                           [0.0, jnp.sin(a1), jnp.cos(a1)]])
        extra = [
            jcpl.RigidGeom(shape=jsh.Sphere(0.05), body_index=-1, R_WG=jnp.eye(3),
                           p_WG=c1, p_WB=jnp.zeros(3), V_WB=jnp.zeros(6)),
            jcpl.RigidGeom(shape=jsh.HalfSpace(), body_index=-1, R_WG=R_t,
                           p_WG=jnp.asarray([0.4, 0.5, 0.13]), p_WB=jnp.zeros(3),
                           V_WB=jnp.zeros(6)),
        ]
        cfg, cp = jworld.mpm_config, jworld.contact_params
        v_c, imp = jcpl.particle_rigid_contact(cp, p, geoms + extra, cfg.dt)
        sub, sub_imp = jcpl.coupled_substep(cfg, cp, p, geoms)
        nxt = jworld.step(jparams, jcp.CoupledState(rigid=rigid1, particles=p), tau1)
        return {
            "geom_R": geoms[0].R_WG, "geom_p": geoms[0].p_WG, "geom_V": geoms[0].V_WB,
            "contact_v": v_c, "contact_imp": imp,
            "substep": sub, "substep_imp": sub_imp,
            "step_rigid": nxt.rigid, "step_particles": nxt.particles,
        }

    ref = run_jitted(jax.vmap(one), rigid, v, tau, sphere_c, tilt)
    tw = port_paddle_world()
    t = {"rigid": torch.tensor(rigid), "v": torch.tensor(v), "tau": torch.tensor(tau),
         "sphere_c": torch.tensor(sphere_c), "tilt": torch.tensor(tilt)}
    return {"jworld": jworld, "jparams": jparams, "jparticles": jparticles, "tw": tw,
            "ref": ref, "t": t, "n": n}


def port_lanes(c):
    """The lanes' CoupledState in the port."""
    from drake_tpu_torch.benchmarks import paddle_blob
    from drake_tpu_torch.contact import coupled_plant

    s = paddle_blob.lanes(c["tw"].state0, LANES)
    particles = s.particles.replace(v=c["t"]["v"])
    return coupled_plant.CoupledState(rigid=c["t"]["rigid"], particles=particles)


def port_extra_geoms(c):
    """The sphere and the tilted halfspace of the fixture, over the lanes."""
    import torch

    from drake_tpu_torch.geometry import shapes as tsh
    from drake_tpu_torch.mpm import coupling as tcpl

    a = c["t"]["tilt"]
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    R_t = torch.stack([
        torch.stack([one, zero, zero], -1),
        torch.stack([zero, torch.cos(a), -torch.sin(a)], -1),
        torch.stack([zero, torch.sin(a), torch.cos(a)], -1),
    ], -2)
    eye = torch.eye(3, dtype=a.dtype).expand(LANES, 3, 3)
    z3, z6 = torch.zeros(LANES, 3, dtype=a.dtype), torch.zeros(LANES, 6, dtype=a.dtype)
    return [
        tcpl.RigidGeom(shape=tsh.Sphere(0.05), body_index=-1, R_WG=eye,
                       p_WG=c["t"]["sphere_c"], p_WB=z3, V_WB=z6),
        tcpl.RigidGeom(shape=tsh.HalfSpace(), body_index=-1, R_WG=R_t,
                       p_WG=torch.tensor([0.4, 0.5, 0.13], dtype=a.dtype).expand(LANES, 3),
                       p_WB=z3, V_WB=z6),
    ]


def assert_particles_close(got, ref):
    for name in ("x", "v", "F"):
        close(getattr(got, name), getattr(ref, name), XVF_TOL)
    close(got.C, ref.C, C_TOL)
    np.testing.assert_array_equal(got.dropped.numpy(), np.asarray(ref.dropped))


def assert_impulses_close(got, ref):
    ref = np.asarray(ref)
    scale = np.abs(ref).max()
    assert scale > 0, "no contact: the case tests nothing"
    close(got, ref, IMPULSE_TOL * scale)


def test_world_builder_matches_jax(coupled):
    """The port's builder makes the reference's model, parameters, scene,
    MPM config and particles (the prismatic joint included), at full size
    (but for xla_only, which the reference's bench sets) and cut."""
    import torch

    from drake_tpu_torch.benchmarks import paddle_blob
    from drake_tpu_torch.multibody import convert

    jfull, _, jparticles = jax_paddle_world((32, 32, 32), 10)
    full = paddle_blob.build(device="cpu", dtype=torch.float64)
    assert dataclasses.asdict(full.world.mpm_config) == dataclasses.asdict(jfull.mpm_config)
    assert full.world.substeps_per_step == jfull.substeps_per_step == 10
    assert (full.world.time_step, full.world.resolved_contact_model()) == (1e-2, "penalty")
    for name, ref in _state_np(jparticles).items():
        np.testing.assert_array_equal(getattr(full.state0.particles, name).numpy(), ref)
    assert full.state0.particles.x.shape == (360, 3)

    jw, tw = coupled["jworld"], coupled["tw"]
    tm, jm = tw.world.model, jw.model
    assert (tm.parent, tm.joint_types, tm.joint_names, tm.q_offsets, tm.v_offsets) == (
        jm.parent, jm.joint_types, jm.joint_names, jm.q_offsets, jm.v_offsets)
    for f in dataclasses.fields(coupled["jparams"]):
        close(getattr(tw.params, f.name), getattr(coupled["jparams"], f.name), 1e-15)
    assert dataclasses.asdict(tw.world.mpm_config) == dataclasses.asdict(jw.mpm_config)
    assert dataclasses.asdict(tw.world.contact_params) == dataclasses.asdict(jw.contact_params)
    assert len(tw.world.scene.geometries) == 1 and tw.world.scene.pairs == ()
    for name, ref in _state_np(coupled["jparticles"]).items():
        np.testing.assert_array_equal(getattr(tw.state0.particles, name).numpy(), ref)
    assert convert.model_from_fields(dataclasses.asdict(jm)).joint_types == ("prismatic",)


def test_rigid_geoms_match_jax(coupled):
    c = coupled
    nq = c["tw"].world.model.num_positions
    rigid = c["t"]["rigid"]
    (g,) = c["tw"].world.rigid_geoms(c["tw"].params, rigid[:, :nq], rigid[:, nq:])
    close(g.R_WG, c["ref"]["geom_R"], RIGID_TOL)
    close(g.p_WG, c["ref"]["geom_p"], RIGID_TOL)
    close(g.V_WB, c["ref"]["geom_V"], RIGID_TOL)


def test_particle_rigid_contact_matches_jax(coupled):
    """Box (the paddle), sphere and halfspace against the blob, per lane."""
    from drake_tpu_torch.mpm import coupling as tcpl

    c = coupled
    s = port_lanes(c)
    w = c["tw"].world
    nq = w.model.num_positions
    geoms = w.rigid_geoms(c["tw"].params, s.rigid[:, :nq], s.rigid[:, nq:])
    v, imp = tcpl.particle_rigid_contact(
        w.contact_params, s.particles, geoms + port_extra_geoms(c), w.mpm_config.dt)
    assert imp.shape == (LANES, 3, 6)
    close(v, c["ref"]["contact_v"], XVF_TOL)
    assert_impulses_close(imp, c["ref"]["contact_imp"])
    # Every shape touched particles in every lane.
    assert (imp.abs().amax(dim=-1) > 0).all()


def test_coupled_substep_matches_jax(coupled):
    from drake_tpu_torch.mpm import coupling as tcpl

    c = coupled
    s = port_lanes(c)
    w = c["tw"].world
    nq = w.model.num_positions
    geoms = w.rigid_geoms(c["tw"].params, s.rigid[:, :nq], s.rigid[:, nq:])
    got, imp = tcpl.coupled_substep(w.mpm_config, w.contact_params, s.particles, geoms)
    assert_particles_close(got, c["ref"]["substep"])
    assert_impulses_close(imp, c["ref"]["substep_imp"])


def test_coupled_world_step_matches_jax(coupled):
    """One coupled step (2 substeps, then SAP with no contact pairs and the
    particles' impulses as external forces) over 2 lanes."""
    c = coupled
    got = c["tw"].world.step(c["tw"].params, port_lanes(c), c["t"]["tau"])
    close(got.rigid, c["ref"]["step_rigid"], RIGID_TOL)
    assert_particles_close(got.particles, c["ref"]["step_particles"])
    # The paddles were pushed back by the blob: the step is not free motion.
    free = c["t"]["rigid"][:, 1] + 1e-2 * c["t"]["tau"][:, 0] / 2.0
    assert ((got.rigid[:, 1] - free).abs() > 1e-4).all()


def test_lane_of_a_batched_step_equals_the_unbatched_step(coupled):
    import torch

    from drake_tpu_torch.contact import coupled_plant
    from drake_tpu_torch.utils.struct import tree_map

    c = coupled
    s = port_lanes(c)
    both = c["tw"].world.step(c["tw"].params, s, c["t"]["tau"])
    for lane in range(LANES):
        one = tree_map(lambda t: t[lane], s)
        got = c["tw"].world.step(c["tw"].params, one, c["t"]["tau"][lane])
        want = tree_map(lambda t: t[lane], both)
        assert isinstance(got, coupled_plant.CoupledState)
        for a, b in ((got.rigid, want.rigid), (got.particles.x, want.particles.x),
                     (got.particles.C, want.particles.C)):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


def test_sap_step_without_contacts_takes_external_forces():
    """The scene has no contact pairs: SAP solves (m + h d) v' = m v + h (tau
    + f) for the 1-dof paddle, f the external force along its axis."""
    import torch

    from drake_tpu_torch.benchmarks import paddle_blob
    from drake_tpu_torch.contact import sap

    w = paddle_blob.build(device="cpu", dtype=torch.float64)
    model, params, h = w.world.model, w.params, w.world.time_step
    q = torch.tensor([[0.3], [0.4]], dtype=torch.float64)
    v = torch.tensor([[0.5], [-1.0]], dtype=torch.float64)
    tau = torch.tensor([[2.0], [0.0]], dtype=torch.float64)
    fext = torch.zeros(2, 1, 6, dtype=torch.float64)
    fext[:, 0, 3] = torch.tensor([7.0, -3.0])
    fext[:, 0, 5] = 100.0  # normal to the joint: no effect
    data, contact = sap.assemble(model, params, w.world.scene, q, v, tau, h,
                                 external_forces_W=fext)
    assert data.J.shape == (2, 0, 3, 1)
    sol = sap.solve_sap(data, data.v_star)
    want = (2.0 * v + h * (tau + fext[:, :, 3])) / (2.0 + h * 5.0)
    torch.testing.assert_close(sol.v, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("stiffness, model", [(5e4, "penalty"), (9.9e5, "penalty"),
                                               (1e6, "implicit"), (1e8, "implicit")])
def test_auto_contact_model_picks_as_the_reference(stiffness, model):
    """"auto" resolves by the reference's rule (drake_tpu/contact/
    coupled_plant.py: implicit where dt sqrt(k) >= 1; dt = 1e-3 here)."""
    from drake_tpu_torch.benchmarks import paddle_blob
    from drake_tpu_torch.mpm import coupling as tcpl

    w = paddle_blob.build(device="cpu").world
    w = dataclasses.replace(w, contact_params=tcpl.MpmContactParams(stiffness=stiffness))
    assert w.resolved_contact_model() == model
    assert (w.mpm_config.dt * np.sqrt(stiffness) >= 1.0) == (model == "implicit")


# The tiled implicit branch: the default of "implicit", and of "auto" on
# stiff contact (k 1e6: dt sqrt(k) = 1, where "auto" turns implicit).
TILED_WORLDS = {"implicit": dict(contact_model="implicit"), "auto_stiff": dict(stiffness=1e6)}
# Active blocks of the tiled worlds: the blob covers 2 of the 16^3 grid's 64
# blocks, and the reference's closure (4 A slots of 8^3 windows) costs it
# seconds a substep on the CPU at the bench's A = 64.
TILED_ACTIVE_BLOCKS = 8


def _tiled_world(world, case, contact_params):
    """`world` (either package's) switched to the tiled implicit branch,
    with TILED_ACTIVE_BLOCKS."""
    kw = TILED_WORLDS[case]
    world = dataclasses.replace(world, mpm_config=dataclasses.replace(
        world.mpm_config, max_active_blocks=TILED_ACTIVE_BLOCKS))
    if "stiffness" in kw:
        return dataclasses.replace(world, contact_params=contact_params(stiffness=kw["stiffness"]))
    return dataclasses.replace(world, **kw)


@pytest.fixture(scope="module")
def tiled_worlds():
    """The JAX package's tiled implicit world step over the lanes of the
    coupled fixture, for both cases, in one program."""
    from drake_tpu.contact import coupled_plant as jcp
    from drake_tpu.mpm import coupling as jcpl

    jworld, jparams, jparticles = jax_paddle_world()
    worlds = {case: _tiled_world(jworld, case, jcpl.MpmContactParams) for case in TILED_WORLDS}
    rigid, v, tau = lane_inputs(jparticles.x.shape[0])

    def one(rigid1, v1, tau1):
        state = jcp.CoupledState(rigid=rigid1, particles=jparticles.replace(v=v1))
        return {case: w.step(jparams, state, tau1) for case, w in worlds.items()}

    return {"ref": run_jitted(jax.vmap(one), rigid, v, tau), "rigid": rigid, "v": v, "tau": tau}


@pytest.mark.parametrize("case", list(TILED_WORLDS))
def test_tiled_implicit_world_step_matches_jax(tiled_worlds, case):
    """The tiled implicit branch -- "implicit" with the default tiled=True,
    and "auto" on stiff contact -- over 2 lanes: one group sort, 2 resident
    substeps with the grid contact on the closure, then SAP; ``dropped`` the
    step's sum, as the reference's."""
    import torch

    from drake_tpu_torch.benchmarks import paddle_blob
    from drake_tpu_torch.contact import coupled_plant
    from drake_tpu_torch.mpm import coupling as tcpl
    from drake_tpu_torch.mpm import grid_contact as tgc

    tw = port_paddle_world()
    world = _tiled_world(tw.world, case, tcpl.MpmContactParams)
    assert world.tiled and world.resolved_contact_model() == "implicit"
    s = paddle_blob.lanes(tw.state0, LANES)
    s = coupled_plant.CoupledState(
        rigid=torch.tensor(tiled_worlds["rigid"]),
        particles=s.particles.replace(v=torch.tensor(tiled_worlds["v"])))
    with tgc.solve_log() as log:
        got = world.step(tw.params, s, torch.tensor(tiled_worlds["tau"]))
    want = tiled_worlds["ref"][case]
    # The stiff case kicks the paddles to tens of m/s: RIGID_TOL of the
    # rigid state's scale.
    close(got.rigid, want.rigid, RIGID_TOL * max(1.0, float(np.abs(want.rigid).max())))
    assert_particles_close(got.particles, want.particles)
    assert [int(d) for d in got.particles.dropped] == [0, 0]
    assert len(log) == world.substeps_per_step
    assert (log[0].impulses.abs().amax(dim=(-2, -1)) > 0).all()
    assert (log[0].iterations > 1).all()


def test_cloth_branch_steps():
    """With a cloth_config the cloth branch runs, whatever ``tiled`` says
    (tests/test_torch_cloth.py holds it against the JAX package)."""
    import torch

    from drake_tpu_torch.examples import mpm_bagging

    bag = mpm_bagging.build("implicit", device="cpu", dtype=torch.float64)
    world = dataclasses.replace(bag.world, substeps_per_step=1)
    assert world.tiled and world.resolved_contact_model() == "implicit"
    nxt = world.step(bag.params, bag.state0, torch.zeros(6, dtype=torch.float64))
    assert bool(torch.isfinite(nxt.particles.x).all()) and bool(torch.isfinite(nxt.rigid).all())
    assert int(nxt.particles.dropped) == 0
    assert nxt.particles.faces is bag.state0.particles.faces


@pytest.mark.parametrize("contact_model", ["implicit", "auto_stiff"])
def test_dense_implicit_branch_steps(contact_model):
    """With tiled=False the implicit branch runs the dense grid contact
    (tests/test_torch_grid_contact.py holds it against the JAX package)."""
    import torch

    from drake_tpu_torch.benchmarks import paddle_blob
    from drake_tpu_torch.mpm import coupling as tcpl

    w = paddle_blob.build(device="cpu", dtype=torch.float64)
    world = dataclasses.replace(w.world, tiled=False, substeps_per_step=1)
    if contact_model == "implicit":
        world = dataclasses.replace(world, contact_model="implicit")
    else:
        world = dataclasses.replace(world, contact_params=tcpl.MpmContactParams(stiffness=1e7))
    assert world.resolved_contact_model() == "implicit"
    nxt = world.step(w.params, w.state0, torch.zeros(1, dtype=torch.float64))
    assert bool(torch.isfinite(nxt.particles.x).all()) and bool(torch.isfinite(nxt.rigid).all())
    assert int(nxt.particles.dropped) == 0


def test_unported_particle_shapes_raise():
    """Capsule, ellipsoid, cylinder and mesh SDFs wait for slice 5."""
    import torch

    from drake_tpu.geometry import shapes as jsh
    from drake_tpu_torch.benchmarks import paddle_blob
    from drake_tpu_torch.mpm import coupling as tcpl

    w = paddle_blob.build(device="cpu", dtype=torch.float64)
    eye, z = torch.eye(3, dtype=torch.float64), torch.zeros(3, dtype=torch.float64)
    for shape in (jsh.Capsule(0.05, 0.1), jsh.Ellipsoid((0.1, 0.1, 0.2)),
                  jsh.Cylinder(0.05, 0.1)):
        geom = tcpl.RigidGeom(shape=shape, body_index=-1, R_WG=eye, p_WG=z, p_WB=z,
                              V_WB=torch.zeros(6, dtype=torch.float64))
        with pytest.raises(NotImplementedError, match="slice 5"):
            tcpl.particle_rigid_contact(w.world.contact_params, w.state0.particles, [geom], 1e-3)


# ---------------------------------------------------------------------------
# The prismatic joint, in a chain that mixes it with revolute joints.
# ---------------------------------------------------------------------------


def _chain(builder_cls, dtype, **kw):
    """revolute (z) -> prismatic (a tilted axis, an offset and rotated joint
    frame) -> revolute (x), with damping and inertias off the axes."""
    b = builder_cls(gravity=(0.0, 0.0, -9.81))
    inertia = np.diag([0.02, 0.03, 0.04]) + 0.005
    b.add_body("base", parent=None, joint_type="revolute", mass=1.5, com=(0.1, 0.0, 0.05),
               inertia_com=inertia, axis=(0, 0, 1), damping=0.3)
    b.add_body("slider", parent="base", joint_type="prismatic", mass=0.8,
               com=(0.0, 0.02, -0.1), inertia_com=0.5 * inertia, axis=(0.6, 0.0, 0.8),
               X_PJ_rpy=(0.1, -0.2, 0.3), X_PJ_xyz=(0.2, 0.1, 0.0), damping=2.0)
    b.add_body("tip", parent="slider", joint_type="revolute", mass=0.4, com=(0.05, 0, 0),
               inertia_com=0.2 * inertia, axis=(1, 0, 0), X_PJ_xyz=(0.0, 0.0, 0.3))
    return b.build(dtype, **kw)


@pytest.fixture(scope="module")
def chain():
    import torch

    from drake_tpu.contact import plant as jplant
    from drake_tpu.multibody import dynamics as jdyn
    from drake_tpu.multibody import kinematics as jkin
    from drake_tpu.multibody.model import ModelBuilder as JBuilder
    from drake_tpu_torch.multibody.model import ModelBuilder as TBuilder

    jm, jp = _chain(JBuilder, jnp.float64)
    tm, tp = _chain(TBuilder, torch.float64, device="cpu")
    rng = np.random.default_rng(7)
    q = rng.standard_normal((4, 3))
    v = rng.standard_normal((4, 3))
    f_ext = rng.standard_normal((4, 3, 6))

    def one(q1, v1, f1):
        R, p = jkin.forward_kinematics(jm, jp, q1)
        return {"R": R, "p": p, "V_W": jkin.world_velocities(jm, jp, q1, v1),
                "M": jdyn.mass_matrix(jm, jp, q1), "C": jdyn.bias_forces(jm, jp, q1, v1, f1),
                "q_next": jplant.advance_positions(jm, jp, q1, v1, 0.01)}

    ref = run_jitted(jax.vmap(one), q, v, f_ext)
    return {"jm": jm, "jp": jp, "tm": tm, "tp": tp, "ref": ref,
            "q": torch.tensor(q), "v": torch.tensor(v), "f_ext": torch.tensor(f_ext)}


@pytest.mark.parametrize("quantity", ["R", "p", "V_W", "M", "C", "q_next"])
def test_prismatic_chain_matches_jax(chain, quantity):
    from drake_tpu_torch.contact import plant as tplant
    from drake_tpu_torch.multibody import dynamics as tdyn
    from drake_tpu_torch.multibody import kinematics as tkin

    tm, tp, q, v = chain["tm"], chain["tp"], chain["q"], chain["v"]
    assert tm.joint_types == ("revolute", "prismatic", "revolute")
    got = {
        "R": lambda: tkin.forward_kinematics(tm, tp, q)[0],
        "p": lambda: tkin.forward_kinematics(tm, tp, q)[1],
        "V_W": lambda: tkin.world_velocities(tm, tp, q, v),
        "M": lambda: tdyn.mass_matrix(tm, tp, q),
        "C": lambda: tdyn.bias_forces(tm, tp, q, v, chain["f_ext"]),
        "q_next": lambda: tplant.advance_positions(tm, tp, q, v, 0.01),
    }[quantity]()
    close(got, chain["ref"][quantity], CHAIN_TOL)
    for f in dataclasses.fields(chain["jp"]):
        close(getattr(tp, f.name), getattr(chain["jp"], f.name), 1e-15)
