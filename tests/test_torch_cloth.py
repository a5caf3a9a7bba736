"""Parity of the port's codimensional cloth (drake_tpu_torch.mpm.cloth), the
sphere-halfspace pair and the cloth branch of CoupledWorld.step against the
JAX package's, on the CPU in float64.

Scenes:
- the builders on both orientations, a mesh and a merge;
- a 6 x 6 patch, its vertices perturbed from a numpy seed, for the face
  deformation, the QR, the energy and the forces, and the same patch at
  rest (zero force, finite gradient);
- an 8 x 8 patch pressed 3 mm into a moving sphere on a 16^3 grid, the
  vertices moving from a numpy seed, for one cloth substep (penalty and
  implicit) and 5 substeps of simulate_cloth;
- the bagging world of examples/mpm_bagging.py cut to a 9 x 9 sheet and 2
  substeps a coupled step, the ball 5 mm into the sheet's centre moving
  down at 0.626 m/s (the demo's speed at contact), for one coupled step by
  each contact model; the ball on the ground for the sphere-halfspace pair
  and a SAP step.

Every JAX quantity of a scene comes from one jitted program, compiled at
XLA's lowest CPU optimization level.

Tolerances: the face quantities, the energy and the forces 1e-12 of their
scale; the substeps 1e-9 of their scale (C 1e-6: it carries 4/dx^2) with
equal Newton iteration counts; the world step those of
tests/test_torch_coupled.py.  All far above float64 rounding of the same
arithmetic in another order.

torch and the port are imported when a test here runs, not when pytest
collects this file (see tests/test_torch_mpm_kernels.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_coupled import C_TOL, IMPULSE_TOL, RIGID_TOL, XVF_TOL
from test_torch_multibody import close, run_jitted

FACE_TOL = 1e-12
SUBSTEP_TOL = 1e-9
# The patch over the sphere (the drape's sphere, moving).
SPHERE = dict(center=(0.5, 0.5, 0.35), radius=0.12, p_WB=(0.52, 0.47, 0.3),
              V_WB=(0.3, -0.2, 0.5, 0.05, -0.02, -0.1))
PATCH_Z = 0.463  # the 4 central vertices 3 mm into the sphere
# The small bagging world: the ball 5 mm into the sheet, moving down.
BALL_Z = 0.405
BALL_VZ = -0.626
WORLD_SUBSTEPS = 2
WORLD_NX = 9
WORLD_MODELS = ["penalty", "implicit_tiled", "implicit_dense", "auto"]


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch on one thread while these tests run: pytest-xdist runs several
    workers on the same cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturbed(x, seed, scale=2e-3):
    rng = np.random.default_rng(seed)
    return np.asarray(x) + scale * rng.standard_normal(np.shape(x))


def _patch_velocities(n, seed=1):
    rng = np.random.default_rng(seed)
    return np.asarray([0.02, -0.01, -0.3]) + 0.05 * rng.standard_normal((n, 3))


def _grid(mpm):
    return mpm.MpmConfig(grid_size=(16, 16, 16), dx=1.0 / 16, dt=1e-4, wall_width=0,
                         max_active_blocks=64)


def _patch(cloth, dtype, **kw):
    return cloth.make_grid_cloth(cloth.ClothConfig(), 8, 8, origin=(0.35, 0.35, PATCH_Z),
                                 size=(0.3, 0.3), dtype=dtype, **kw)


def _jax_sphere():
    from drake_tpu.geometry import shapes as sh
    from drake_tpu.mpm import coupling as cpl

    f64 = jnp.float64
    return cpl.RigidGeom(shape=sh.Sphere(SPHERE["radius"]), body_index=0,
                         R_WG=jnp.eye(3, dtype=f64), p_WG=jnp.asarray(SPHERE["center"], f64),
                         p_WB=jnp.asarray(SPHERE["p_WB"], f64),
                         V_WB=jnp.asarray(SPHERE["V_WB"], f64))


def _port_sphere(lanes=()):
    import torch

    from drake_tpu_torch.geometry import shapes as tsh
    from drake_tpu_torch.mpm import coupling as tcpl

    def t(values):
        return torch.tensor(values, dtype=torch.float64).expand(lanes + (len(values),))

    return tcpl.RigidGeom(shape=tsh.Sphere(SPHERE["radius"]), body_index=0,
                          R_WG=torch.eye(3, dtype=torch.float64).expand(lanes + (3, 3)),
                          p_WG=t(SPHERE["center"]), p_WB=t(SPHERE["p_WB"]),
                          V_WB=t(SPHERE["V_WB"]))


CONTACT = dict(stiffness=3e4, damping=30.0, friction=0.5)


@pytest.fixture(scope="module")
def patch():
    """The JAX side of the patch over the sphere in one program: one cloth
    substep by each contact model, the implicit solve's iterations, and 5
    penalty substeps of simulate_cloth."""
    from drake_tpu.mpm import cloth as jcloth
    from drake_tpu.mpm import coupling as jcpl
    from drake_tpu.mpm import grid_contact as jgc
    from drake_tpu.mpm import solver as jmpm

    cfg = _grid(jmpm)
    ccfg = jcloth.ClothConfig()
    sheet = _patch(jcloth, jnp.float64)
    n = sheet.x.shape[0]
    x0 = _perturbed(sheet.x, 0, 5e-4)
    v0 = _patch_velocities(n)
    geoms = [_jax_sphere()]
    cp = jcpl.MpmContactParams(**CONTACT)

    def program(x, v):
        s = sheet.replace(x=x, v=v)
        out = {}
        for model in ("penalty", "implicit"):
            s1, imp = jcloth.cloth_substep(cfg, ccfg, s, geoms, cp, contact_model=model)
            out[model] = {"x": s1.x, "v": s1.v, "C": s1.C, "impulses": imp}
        p = jcloth._to_mpm_state(cfg, s, jcloth.vertex_forces(ccfg, s))
        grid = jmpm.particle_to_grid(cfg, p)
        sol = jgc.solve_grid_contact(cfg, jgc.GridContactParams(**CONTACT), p, grid.mass,
                                     jmpm.update_grid(cfg, grid), geoms)
        out["iterations"] = sol.iterations
        s5, acc = jcloth.simulate_cloth(cfg, ccfg, s, 5, geoms, cp)
        out["simulate"] = {"x": s5.x, "v": s5.v, "C": s5.C, "impulses": acc}
        return out

    return {"ref": run_jitted(program, jnp.asarray(x0), jnp.asarray(v0)), "x0": x0, "v0": v0}


def _port_patch(c):
    import torch

    from drake_tpu_torch.mpm import cloth as tcloth
    from drake_tpu_torch.mpm import solver as T

    sheet = _patch(tcloth, torch.float64, device="cpu")
    return _grid(T), sheet.replace(x=torch.tensor(c["x0"]), v=torch.tensor(c["v0"]))


def _assert_cloth_close(got, ref, imp):
    for name in ("x", "v"):
        close(getattr(got, name), ref[name], SUBSTEP_TOL * max(1.0, np.abs(ref[name]).max()))
    close(got.C, ref["C"], C_TOL)
    want = np.asarray(ref["impulses"])
    assert np.abs(want).max() > 0, "no contact: the case tests nothing"
    close(imp, want, SUBSTEP_TOL * np.abs(want).max())
    assert int(got.dropped.max()) == 0


@pytest.mark.parametrize("orientation", ["xy", "xz"])
def test_make_grid_cloth_matches_jax_bit_for_bit(orientation):
    import torch

    from drake_tpu.mpm import cloth as jcloth
    from drake_tpu_torch.mpm import cloth as tcloth

    for jd, td in ((jnp.float64, torch.float64), (jnp.float32, torch.float32)):
        kw = dict(origin=(0.2, 0.25, 0.6), size=(0.3, 0.5), orientation=orientation)
        ref = jcloth.make_grid_cloth(jcloth.ClothConfig(density=1500.0), 5, 7, dtype=jd, **kw)
        got = tcloth.make_grid_cloth(tcloth.ClothConfig(density=1500.0), 5, 7, dtype=td,
                                     device="cpu", **kw)
        for f in dataclasses.fields(ref):
            want = np.asarray(getattr(ref, f.name))
            have = getattr(got, f.name).numpy()
            assert have.dtype == (np.int64 if f.name == "faces" else want.dtype), f.name
            np.testing.assert_array_equal(have, want, err_msg=f.name)
        assert got.dropped.dtype == torch.int32 and int(got.dropped) == 0


def test_mesh_and_merge_match_jax_bit_for_bit():
    """A tetrahedron's surface as a mesh cloth, merged after a grid patch."""
    import torch

    from drake_tpu.mpm import cloth as jcloth
    from drake_tpu_torch.mpm import cloth as tcloth

    pts = np.asarray([[0.4, 0.4, 0.5], [0.6, 0.42, 0.5], [0.5, 0.6, 0.52], [0.5, 0.5, 0.7]])
    faces = np.asarray([[0, 1, 2], [0, 1, 3], [1, 2, 3], [2, 0, 3]])
    jm = jcloth.make_cloth_from_mesh(jcloth.ClothConfig(), pts, faces, jnp.float64)
    tm = tcloth.make_cloth_from_mesh(tcloth.ClothConfig(), pts, faces, torch.float64,
                                     device="cpu")
    jg = jcloth.make_grid_cloth(jcloth.ClothConfig(), 3, 4, dtype=jnp.float64)
    tg = tcloth.make_grid_cloth(tcloth.ClothConfig(), 3, 4, dtype=torch.float64, device="cpu")
    for ref, got in ((jm, tm), (jcloth.merge_cloths(jg, jm), tcloth.merge_cloths(tg, tm))):
        for f in dataclasses.fields(ref):
            np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                          np.asarray(getattr(ref, f.name)), err_msg=f.name)
    assert tcloth.merge_cloths(tg, tm).x.shape == (16, 3)


def test_cloth_config_and_state_convert_from_jax():
    import torch

    from drake_tpu.mpm import cloth as jcloth
    from drake_tpu_torch.mpm import cloth as tcloth
    from drake_tpu_torch.mpm import convert

    jc = jcloth.ClothConfig(youngs_modulus=2e5, thickness=2e-3)
    tc = tcloth.ClothConfig(**dataclasses.asdict(jc))
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.lame_2d == jc.lame_2d
    js = jcloth.make_grid_cloth(jc, 4, 3, dtype=jnp.float64)
    arrays = {f.name: np.asarray(getattr(js, f.name)) for f in dataclasses.fields(js)}
    ts = convert.cloth_state_from_numpy(arrays, device="cpu", dtype=torch.float32)
    assert isinstance(ts, tcloth.ClothState)
    assert ts.x.dtype == torch.float32 and ts.faces.dtype == torch.int64
    back = convert.state_to_numpy(ts)
    np.testing.assert_array_equal(back["faces"], arrays["faces"])
    np.testing.assert_array_equal(back["area"], arrays["area"].astype(np.float32))
    assert int(ts.dropped) == 0


@pytest.mark.parametrize("state", ["perturbed", "rest"])
def test_face_quantities_energy_and_forces_match_jax(state):
    """A 6 x 6 patch: F, the QR, the energy and -dE/dx within 1e-12 of
    their scale; at rest the force is zero and the gradient finite."""
    import torch

    from drake_tpu.mpm import cloth as jcloth
    from drake_tpu_torch.mpm import cloth as tcloth

    cfg = jcloth.ClothConfig()
    js = jcloth.make_grid_cloth(cfg, 6, 6, dtype=jnp.float64)
    x = np.asarray(js.x) if state == "rest" else _perturbed(js.x, 3, 0.01)
    js = js.replace(x=jnp.asarray(x))

    def program(xx):
        F = jcloth.face_deformation(xx, js.faces, js.Dm_inv)
        Q, R = jcloth._qr_3x2(F)
        e = jcloth.elastic_energy(cfg, xx, js.faces, js.Dm_inv, js.area)
        return F, Q, R, e, jcloth.vertex_forces(cfg, js.replace(x=xx))

    ref = run_jitted(program, jnp.asarray(x))
    tc = tcloth.ClothConfig()
    ts = tcloth.make_grid_cloth(tc, 6, 6, dtype=torch.float64, device="cpu")
    ts = ts.replace(x=torch.tensor(x))
    F = tcloth.face_deformation(ts.x, ts.faces, ts.Dm_inv)
    Q, R = tcloth._qr_3x2(F)
    with torch.no_grad():  # vertex_forces takes its gradient under no_grad too
        f = tcloth.vertex_forces(tc, ts)
    got = (F, Q, R, tcloth.elastic_energy(tc, ts.x, ts.faces, ts.Dm_inv, ts.area), f)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        close(g, r, FACE_TOL * max(1.0, np.abs(r).max()))
    assert bool(torch.isfinite(f).all())
    assert not f.requires_grad
    if state == "rest":
        assert float(f.abs().max()) < 1e-9
        assert float(got[3]) < 1e-20
    else:
        assert float(f.abs().max()) > 1e-3


@pytest.mark.parametrize("contact_model", ["penalty", "implicit"])
def test_cloth_substep_matches_jax(patch, contact_model):
    import torch

    from drake_tpu_torch.mpm import cloth as tcloth
    from drake_tpu_torch.mpm import coupling as tcpl
    from drake_tpu_torch.mpm import grid_contact as tgc

    cfg, sheet = _port_patch(patch)
    with tgc.solve_log() as log:
        got, imp = tcloth.cloth_substep(cfg, tcloth.ClothConfig(), sheet, [_port_sphere()],
                                        tcpl.MpmContactParams(**CONTACT),
                                        contact_model=contact_model)
    _assert_cloth_close(got, patch["ref"][contact_model], imp)
    assert got.faces is sheet.faces and got.mass is sheet.mass
    if contact_model == "implicit":
        want = int(patch["ref"]["iterations"])
        assert [int(sol.iterations) for sol in log] == [want] and want > 1
    else:
        assert log == []
    assert imp.dtype == torch.float64 and imp.shape == (1, 6)


def test_simulate_cloth_matches_jax(patch):
    from drake_tpu_torch.mpm import cloth as tcloth
    from drake_tpu_torch.mpm import coupling as tcpl

    cfg, sheet = _port_patch(patch)
    got, acc = tcloth.simulate_cloth(cfg, tcloth.ClothConfig(), sheet, 5, [_port_sphere()],
                                     tcpl.MpmContactParams(**CONTACT))
    _assert_cloth_close(got, patch["ref"]["simulate"], acc)


def test_cloth_substep_without_geometry_is_the_mpm_substep():
    """No geometry: the elastic kick, then mpm_substep, and a (..., 0, 6)
    impulse over two lanes."""
    import torch

    from drake_tpu_torch.mpm import cloth as tcloth
    from drake_tpu_torch.mpm import solver as T

    cfg = _grid(T)
    sheet = _patch(tcloth, torch.float64, device="cpu")
    x = torch.stack([torch.tensor(_perturbed(sheet.x, s, 0.01)) for s in (5, 6)])
    lanes = sheet.replace(x=x, v=torch.zeros_like(x), C=torch.zeros(x.shape + (3,),
                          dtype=x.dtype), mass=sheet.mass.expand(2, -1),
                          dropped=torch.zeros(2, dtype=torch.int32))
    ccfg = tcloth.ClothConfig()
    got, imp = tcloth.cloth_substep(cfg, ccfg, lanes, contact_model="implicit")
    assert imp.shape == (2, 0, 6)
    p = tcloth._to_mpm_state(cfg, lanes, tcloth.vertex_forces(ccfg, lanes))
    want = T.mpm_substep(cfg, p)
    torch.testing.assert_close(got.x, want.x, rtol=0, atol=0)
    torch.testing.assert_close(got.v, want.v, rtol=0, atol=0)
    assert float((got.v - lanes.v).abs().max()) > 1e-3  # the elastic kick moved it


# ---- the bagging world ------------------------------------------------------


def jax_bagging_world(nx, substeps, contact_model="implicit", tiled=True,
                      dtype=jnp.float64):
    """(world, params, sheet) of examples/mpm_bagging.py in `dtype`, with an
    nx x nx sheet and `substeps` substeps a coupled step."""
    from drake_tpu.contact.coupled_plant import CoupledWorld
    from drake_tpu.geometry import shapes as sh
    from drake_tpu.geometry.scene import CollisionGeometry, CollisionScene
    from drake_tpu.mpm import cloth
    from drake_tpu.mpm import coupling as cpl
    from drake_tpu.mpm import solver as mpm
    from drake_tpu.multibody.model import ModelBuilder

    r_ball, m_ball = 0.07, 0.15
    b = ModelBuilder(gravity=(0.0, 0.0, -9.81))
    b.add_body("ball", parent=None, joint_type="floating", mass=m_ball,
               inertia_com=np.eye(3) * (0.4 * m_ball * r_ball**2))
    model, params = b.build(dtype)
    geoms = [
        CollisionGeometry(name="ball", body=0, shape=sh.Sphere(r_ball),
                          friction=0.6, stiffness=1e5, dissipation=0.1),
        CollisionGeometry(name="ground", body=-1, shape=sh.HalfSpace(),
                          p_BG=np.array([0.0, 0.0, 0.05]),
                          friction=0.6, stiffness=1e7, dissipation=0.1),
    ]
    grid = mpm.MpmConfig(grid_size=(32, 32, 32), dx=1.0 / 32, dt=5e-5, wall_width=0)
    cfg = cloth.ClothConfig()
    sheet = cloth.make_grid_cloth(cfg, nx, nx, origin=(0.3, 0.3, 0.34), size=(0.4, 0.4),
                                  dtype=dtype)
    world = CoupledWorld(
        model=model, scene=CollisionScene.build(geoms), mpm_config=grid,
        contact_params=cpl.MpmContactParams(stiffness=3e4, damping=30.0, friction=0.6),
        coupled_geometries=(0,), substeps_per_step=substeps, time_step=1e-3,
        cloth_config=cfg, contact_model=contact_model, tiled=tiled,
    )
    return world, params, sheet


def _variant(name):
    """(contact_model, tiled) of a WORLD_MODELS case."""
    return {"penalty": ("penalty", True), "implicit_tiled": ("implicit", True),
            "implicit_dense": ("implicit", False), "auto": ("auto", True)}[name]


def world_inputs(lanes=2):
    """rigid (lanes, 13): the ball BALL_Z high at the sheet's centre moving
    down (lane l shifted l cm in x, spinning slowly); the sheet's vertex
    velocities (lanes, nv, 3) from a numpy seed."""
    rng = np.random.default_rng(7)
    rigid = np.zeros((lanes, 13))
    rigid[:, 0] = 1.0
    rigid[:, 4] = 0.5 + 0.01 * np.arange(lanes)
    rigid[:, 5] = 0.5
    rigid[:, 6] = BALL_Z
    rigid[:, 7:10] = [0.3, -0.2, 0.1]
    rigid[:, 12] = BALL_VZ
    v = 0.02 * rng.standard_normal((lanes, WORLD_NX * WORLD_NX, 3))
    return rigid, v


@pytest.fixture(scope="module")
def bagging():
    """The JAX side of the small bagging world in one program: one coupled
    step of each lane by each contact model."""
    from drake_tpu.contact.coupled_plant import CoupledState

    rigid, v = world_inputs()
    worlds = {name: jax_bagging_world(WORLD_NX, WORLD_SUBSTEPS, *_variant(name))
              for name in WORLD_MODELS}
    _, params, sheet = worlds["penalty"]
    tau = jnp.zeros(6)

    def one(rigid1, v1):
        s = CoupledState(rigid=rigid1, particles=sheet.replace(v=v1))
        out = {}
        for name, (world, _, _) in worlds.items():
            nxt = world.step(params, s, tau)
            out[name] = {"rigid": nxt.rigid, "x": nxt.particles.x, "v": nxt.particles.v,
                         "C": nxt.particles.C}
        return out

    return {"ref": run_jitted(jax.vmap(one), rigid, v), "rigid": rigid, "v": v}


def port_bagging_world(name, nx=WORLD_NX):
    """The port's bagging world (drake_tpu_torch.examples.mpm_bagging) in
    float64 on the CPU, cut as jax_bagging_world cuts the reference's: (world,
    params, state of one world)."""
    import torch

    from drake_tpu_torch.contact.coupled_plant import CoupledState
    from drake_tpu_torch.examples import mpm_bagging
    from drake_tpu_torch.mpm import cloth as tcloth

    model, tiled = _variant(name)
    bag = mpm_bagging.build(model, device="cpu", dtype=torch.float64)
    world = dataclasses.replace(bag.world, substeps_per_step=WORLD_SUBSTEPS, tiled=tiled)
    sheet = tcloth.make_grid_cloth(tcloth.ClothConfig(), nx, nx, origin=(0.3, 0.3, 0.34),
                                   size=(0.4, 0.4), dtype=torch.float64, device="cpu")
    return world, bag.params, CoupledState(rigid=bag.state0.rigid, particles=sheet)


def _port_world_lanes(state0, rigid, v):
    import torch

    from drake_tpu_torch.contact.coupled_plant import CoupledState
    from drake_tpu_torch.examples import mpm_bagging

    s = mpm_bagging.lanes(state0, rigid.shape[0])
    return CoupledState(rigid=torch.tensor(rigid), particles=s.particles.replace(
        v=torch.tensor(v)))


@pytest.mark.parametrize("name", WORLD_MODELS)
def test_coupled_world_cloth_branch_matches_jax(bagging, name):
    """The cloth branch over 2 lanes, each contact model; "implicit" takes
    the cloth's solve whatever `tiled` says, "auto" resolves to the penalty
    (dt sqrt(k) = 0.0087)."""
    import torch

    world, params, state0 = port_bagging_world(name)
    assert world.resolved_contact_model() == ("penalty" if name == "auto" else
                                              _variant(name)[0])
    s = _port_world_lanes(state0, bagging["rigid"], bagging["v"])
    nxt, imp = world.step_with_impulses(params, s, torch.zeros(2, 6, dtype=torch.float64))
    ref = bagging["ref"][name]
    for field in ("x", "v"):
        close(getattr(nxt.particles, field), ref[field], XVF_TOL)
    close(nxt.particles.C, ref["C"], C_TOL)
    close(nxt.rigid, ref["rigid"], RIGID_TOL)
    assert imp.shape == (2, 1, 6) and bool((imp[:, 0, 5] > 0).all())
    np.testing.assert_array_equal(nxt.particles.dropped.numpy(), [0, 0])
    assert torch.equal(world.step(params, s, torch.zeros(2, 6, dtype=torch.float64)).rigid,
                       nxt.rigid)


def test_two_lanes_equal_their_single_lane_runs(bagging):
    """Each lane of a 2-lane implicit step against the same world alone."""
    import torch

    from drake_tpu_torch.contact.coupled_plant import CoupledState

    world, params, state0 = port_bagging_world("implicit_dense")
    s = _port_world_lanes(state0, bagging["rigid"], bagging["v"])
    both = world.step(params, s, torch.zeros(2, 6, dtype=torch.float64))
    for lane in range(2):
        one = CoupledState(rigid=s.rigid[lane], particles=s.particles.replace(
            x=s.particles.x[lane], v=s.particles.v[lane], C=s.particles.C[lane],
            mass=s.particles.mass[lane], dropped=s.particles.dropped[lane]))
        alone = world.step(params, one, torch.zeros(6, dtype=torch.float64))
        close(both.rigid[lane], alone.rigid.numpy(), 1e-12)
        for field in ("x", "v", "C"):
            want = getattr(alone.particles, field).numpy()
            close(getattr(both.particles, field)[lane], want,
                  1e-12 * max(1.0, np.abs(want).max()))


def test_sphere_halfspace_pair_and_sap_step_match_jax():
    """The ball on the ground: the pair's (phi, p, n) over lanes that
    penetrate, touch and clear it, and a SAP step of the ball resting 1 mm
    in, against the JAX package."""
    import torch

    from drake_tpu.contact import sap as jsap
    from drake_tpu_torch.contact import sap as tsap

    jworld, jparams, _ = jax_bagging_world(3, 1)
    world, params, _ = port_bagging_world("penalty", nx=3)
    assert world.scene.pairs == jworld.scene.pairs == ((0, 1),)
    assert world.scene.num_contacts == 1
    q = np.zeros((4, 7))
    q[:, 0] = 1.0
    q[:, 4:6] = [0.4, 0.6]
    q[:, 6] = 0.05 + 0.07 + np.asarray([-0.001, 0.0, 0.002, 0.3])
    q[3, :4] = np.asarray([0.9, 0.1, -0.3, 0.2]) / np.linalg.norm([0.9, 0.1, -0.3, 0.2])
    v = np.zeros((4, 6))
    v[:, 3:] = [0.1, -0.05, -0.2]
    tau = np.zeros((4, 6))
    h = 1e-3

    def one(q1, v1, tau1):
        c = jworld.scene.query(jworld.model, jparams, q1)
        data, _ = jsap.assemble(jworld.model, jparams, jworld.scene, q1, v1, tau1, h)
        return c.phi, c.p_W, c.n_W, jsap.solve_sap(data, data.v_star).v

    phi, p_W, n_W, v_next = run_jitted(jax.vmap(one), q, v, tau)
    tq, tv = torch.tensor(q), torch.tensor(v)
    c = world.scene.query(world.model, params, tq)
    for got, want in ((c.phi, phi), (c.p_W, p_W), (c.n_W, n_W)):
        close(got, want, 1e-14)
    assert c.body_a == (0,) and c.body_b == (-1,)
    np.testing.assert_allclose(np.asarray(n_W)[:, 0], np.tile([0.0, 0.0, 1.0], (4, 1)))
    data, _ = tsap.assemble(world.model, params, world.scene, tq, tv, torch.tensor(tau), h)
    sol = tsap.solve_sap(data, data.v_star)
    close(sol.v, v_next, 1e-10)
    assert float(sol.v[0, 5]) > 0.0  # the penetrating ball is pushed up


def test_bagging_run_keeps_the_grabs_on_their_profile_and_the_ball_falls_freely():
    """Two steps of the demo at full width on the CPU: the corner bunches
    sit where grab_pose puts them, the ball (2 cm above the sheet) falls as
    SAP's semi-implicit Euler step gives it, and no particle is dropped."""
    import torch

    from drake_tpu_torch.examples import mpm_bagging as mb

    res = mb.run(steps=2, device="cpu")
    bag = mb.build(device="cpu")
    assert bag.state0.particles.x.shape == (484, 3) and bag.state0.particles.faces.shape == (882, 3)
    assert bag.grab.numel() == 4 * 4
    pos, vel = mb.grab_pose(bag, 1)
    p = res.state.particles
    torch.testing.assert_close(p.x[bag.grab], pos, rtol=0, atol=0)
    torch.testing.assert_close(p.v[bag.grab], vel, rtol=0, atol=0)
    assert float(p.x.sub(bag.state0.particles.x).abs().max()) > 0  # the sheet moved
    h, g = 1e-3, 9.81
    z0 = mb.Z0 + mb.R_BALL + mb.DROP
    np.testing.assert_allclose(res.ball_z.numpy(), [z0 - g * h * h, z0 - 3 * g * h * h],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(res.state.rigid[12]), -2 * g * h, rtol=1e-5)
    assert res.impulses.shape == (2, 6) and float(res.impulses.abs().max()) == 0.0
    assert int(res.dropped.max()) == 0


def test_grab_profile_is_the_reference_smoothstep():
    """grab_pose against the JAX demo's corner grabs and lift profile
    (examples/mpm_bagging.py, built as its main() builds them) before,
    inside and after the lift."""
    import torch

    from bagging_reference import jax_grabs
    from drake_tpu_torch.examples import mpm_bagging as mb

    bag = mb.build(device="cpu", dtype=torch.float64)
    jworld, _, jsheet = jax_bagging_world(22, 20)
    jgrab, jpose = jax_grabs(jworld, jsheet, jnp.float64)
    np.testing.assert_array_equal(bag.grab.numpy(), np.asarray(jgrab))
    for k in (0, 499, 500, 501, 800, 1100, 1699, 1700, 2199):
        pos, vel = mb.grab_pose(bag, k)
        jpos, jvel = jpose(k)
        np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), rtol=0, atol=1e-15)
        np.testing.assert_allclose(vel.numpy(), np.asarray(jvel), rtol=0, atol=1e-15)
    end = bag.g_end.numpy()
    assert np.allclose(end[:, 2], mb.Z0 + 0.35)
