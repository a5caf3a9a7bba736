"""Parity of the port's implicit grid contact (drake_tpu_torch.mpm.
grid_contact) and of the dense implicit branch of CoupledWorld.step against
the JAX package's, on the CPU in float64.

Scenes:
- the block on the ground of tests/test_grid_contact.py (32^3 grid, the
  ground at z = 0.25 inside the grid, wall width 0); for the solve and the
  substeps the ground is raised into the block's lowest particle layer, the
  particles get velocities from a numpy seed and a moving sphere is pressed
  into the block's top, so that normal, friction and torque terms are all
  live;
- the paddle-and-blob world of tests/test_torch_coupled.py (16^3 grid, 2
  lanes, 2 substeps, each paddle pressed into the blob), its contact model
  switched to the dense implicit solve, with the solve every substep and
  every second substep.

Every JAX quantity of a scene comes from one jitted program, compiled once
per module at XLA's lowest CPU optimization level (CHEAP_COMPILE).

Tolerances: the pair gradient and Hessian 1e-12; the solve's grid velocity
and impulses 1e-9 of their largest magnitude, with equal iteration counts;
the substeps and the world step those of tests/test_torch_coupled.py
(XVF_TOL, C_TOL, RIGID_TOL, IMPULSE_TOL).  All far above float64 rounding of
the same arithmetic in another order.  Momentum balance: 5%, as
tests/test_grid_contact.py holds the reference.

torch and the port are imported when a test here runs, not when pytest
collects this file (see tests/test_torch_mpm_kernels.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_coupled import (C_TOL, IMPULSE_TOL, LANES, RIGID_TOL, XVF_TOL,
                                jax_paddle_world, lane_inputs, port_paddle_world)
from test_torch_multibody import close, run_jitted

Z0 = 0.25  # ground height, inside the grid
# The block's particle layers lie at Z0 + 0.0058 + k / 64, k = 0..4: the
# ground raised to RAISED cuts 0.2 mm into the lowest.
RAISED = Z0 + 0.006
SOLVE_TOL = 1e-9
PAIR_TOL = 1e-12
SUBSTEPS = 3
# The solve's parameters: the paddle world's (its Newton converges below
# the cap here); the momentum balance takes the reference test's.
SOLVE_PARAMS = dict(stiffness=5e4, damping=100.0, friction=0.3)
BLOCK_PARAMS = dict(stiffness=5e5, damping=500.0, friction=0.5)
# 1 mm into the block's top layer, its body moving and turning.
SPHERE = dict(center=(0.5, 0.5, Z0 + 0.1173), radius=0.05, p_WB=(0.52, 0.47, 0.4),
              V_WB=(0.3, -0.2, 0.5, 0.05, -0.02, -0.1))


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch on one thread while these tests run: pytest-xdist runs several
    workers on the same cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _block_config(mpm, gravity=(0.0, 0.0, -9.81), dt=5e-4):
    """The block-on-ground configuration of tests/test_grid_contact.py."""
    return mpm.MpmConfig(grid_size=(32, 32, 32), dx=1.0 / 32, dt=dt, wall_width=0,
                         gravity=gravity, youngs_modulus=5e4, max_active_blocks=64)


BLOCK = ((0.4, 0.4, Z0 - 0.002), (0.6, 0.6, Z0 + 0.078))


def _jax_geoms(z=RAISED, sphere=True):
    from drake_tpu.geometry import shapes as sh
    from drake_tpu.mpm import coupling as cpl

    f64 = jnp.float64
    out = [cpl.RigidGeom(shape=sh.HalfSpace(), body_index=-1, R_WG=jnp.eye(3, dtype=f64),
                         p_WG=jnp.asarray([0.0, 0.0, z], f64), p_WB=jnp.zeros(3, f64),
                         V_WB=jnp.zeros(6, f64))]
    if sphere:
        out.append(cpl.RigidGeom(
            shape=sh.Sphere(SPHERE["radius"]), body_index=0, R_WG=jnp.eye(3, dtype=f64),
            p_WG=jnp.asarray(SPHERE["center"], f64), p_WB=jnp.asarray(SPHERE["p_WB"], f64),
            V_WB=jnp.asarray(SPHERE["V_WB"], f64)))
    return out


def _port_geoms(lanes=(), z=RAISED, sphere=True):
    """The ground at height z (a float or one per lane) and the sphere,
    with poses over `lanes`."""
    import torch

    from drake_tpu_torch.geometry import shapes as tsh
    from drake_tpu_torch.mpm import coupling as tcpl

    def t(values):
        return torch.tensor(values, dtype=torch.float64).expand(lanes + (len(values),))

    p_ground = t((0.0, 0.0, 0.0)).clone()
    p_ground[..., 2] = z
    eye = torch.eye(3, dtype=torch.float64).expand(lanes + (3, 3))
    out = [tcpl.RigidGeom(shape=tsh.HalfSpace(), body_index=-1, R_WG=eye, p_WG=p_ground,
                          p_WB=t((0.0,) * 3), V_WB=t((0.0,) * 6))]
    if sphere:
        out.append(tcpl.RigidGeom(shape=tsh.Sphere(SPHERE["radius"]), body_index=0, R_WG=eye,
                                  p_WG=t(SPHERE["center"]), p_WB=t(SPHERE["p_WB"]),
                                  V_WB=t(SPHERE["V_WB"])))
    return out


def _velocities(n, seed=0):
    """Particle velocities: a slide along x and down, and noise."""
    rng = np.random.default_rng(seed)
    return np.asarray([0.02, 0.0, -0.02]) + 0.01 * rng.standard_normal((n, 3))


@pytest.fixture(scope="module")
def block():
    """The JAX side of the block scene in one program: the free-motion grid
    and the contact solve on it, then SUBSTEPS implicit substeps."""
    from drake_tpu.mpm import grid_contact as jgc
    from drake_tpu.mpm import solver as jmpm

    cfg = _block_config(jmpm)
    state = jmpm.make_particle_block(cfg, *BLOCK, dtype=jnp.float64, jitter_seed=None)
    v0 = _velocities(state.x.shape[0])
    params = jgc.GridContactParams(**SOLVE_PARAMS)
    geoms = _jax_geoms()

    def program(v):
        s = state.replace(v=v)
        grid = jmpm.particle_to_grid(cfg, s)
        gv = jmpm.update_grid(cfg, grid)
        sol = jgc.solve_grid_contact(cfg, params, s, grid.mass, gv, geoms)

        def body(carry, _):
            s_, acc = carry
            s_, imp = jgc.coupled_substep_implicit(cfg, params, s_, geoms)
            return (s_, acc + imp), imp

        (s_end, acc), imps = jax.lax.scan(
            body, (s, jnp.zeros((len(geoms), 6), jnp.float64)), None, length=SUBSTEPS)
        return {"mass": grid.mass, "vel": gv, "sol": sol, "substeps": s_end, "acc": acc,
                "imps": imps}

    ref = run_jitted(program, jnp.asarray(v0))
    return {"ref": ref, "v0": v0}


def _port_block_state(v0=None):
    import torch

    from drake_tpu_torch.mpm import solver as T

    cfg = _block_config(T)
    s = T.make_particle_block(cfg, *BLOCK, dtype=torch.float64, jitter_seed=None, device="cpu")
    if v0 is not None:
        s = s.replace(v=torch.tensor(v0))
    return cfg, s


def test_grid_contact_params_match_jax():
    from drake_tpu.mpm import grid_contact as jgc
    from drake_tpu_torch.mpm import grid_contact as tgc

    want = [(f.name, f.type, f.default) for f in dataclasses.fields(jgc.GridContactParams)]
    got = [(f.name, f.type, f.default) for f in dataclasses.fields(tgc.GridContactParams)]
    assert got == want
    assert tgc.GridContactSolution._fields == jgc.GridContactSolution._fields


def test_contact_grad_hess_matches_jax():
    """Random pairs: in and out of contact, inactive candidates, phi_hat
    near 0, and |vt| below the slip velocity."""
    import torch

    from drake_tpu.mpm import grid_contact as jgc
    from drake_tpu_torch.mpm import grid_contact as tgc

    rng = np.random.default_rng(1)
    m = 64
    p = jgc.GridContactParams(stiffness=3e4, damping=50.0, friction=0.4, slip_velocity=1e-3)
    dt = 1e-3
    n = rng.standard_normal((m, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    v_rel = 0.2 * rng.standard_normal((m, 3))
    phi0 = rng.uniform(-2e-3, 2e-3, m)
    vn = np.sum(v_rel * n, axis=1)
    # phi_hat = phi0 + dt vn: just below and just above 0.
    phi0[:8] = -dt * vn[:8] - np.where(np.arange(8) % 2 == 0, 1e-12, -1e-12)
    # |vt| below the slip velocity.
    v_rel[8:16] = vn[8:16, None] * n[8:16] + 1e-4 * rng.standard_normal((8, 3))
    active = rng.uniform(size=m) < 0.8
    ref = jax.jit(lambda *a: jgc._contact_grad_hess(p, dt, *a))(
        jnp.asarray(phi0), jnp.asarray(n), jnp.asarray(v_rel), jnp.asarray(active))
    got = tgc._contact_grad_hess(tgc.GridContactParams(**dataclasses.asdict(p)), dt,
                                 torch.tensor(phi0), torch.tensor(n), torch.tensor(v_rel),
                                 torch.tensor(active))
    for g, r in zip(got, ref):
        close(g, r, PAIR_TOL)
    f_n = np.asarray(ref[2])
    assert (f_n > 0).sum() >= 10 and (f_n == 0).sum() >= 10
    vt = v_rel - np.sum(v_rel * n, axis=1, keepdims=True) * n
    slow = (np.linalg.norm(vt, axis=1) < p.slip_velocity) & (f_n > 0)
    assert slow.any()
    close(tgc._contact_grad(tgc.GridContactParams(**dataclasses.asdict(p)), dt,
                            torch.tensor(phi0), torch.tensor(n), torch.tensor(v_rel),
                            torch.tensor(active)), ref[0], PAIR_TOL)


def test_solve_grid_contact_matches_jax(block):
    """The solve on the reference's own free-motion grid."""
    import torch

    from drake_tpu_torch.mpm import grid_contact as tgc

    ref = block["ref"]
    cfg, s = _port_block_state(block["v0"])
    sol = tgc.solve_grid_contact(cfg, tgc.GridContactParams(**SOLVE_PARAMS), s,
                                 torch.tensor(np.asarray(ref["mass"])),
                                 torch.tensor(np.asarray(ref["vel"])), _port_geoms())
    want = ref["sol"]
    params = tgc.GridContactParams(**SOLVE_PARAMS)
    assert 1 < int(sol.iterations) == int(want.iterations) < params.max_iterations
    assert sol.iterations.dtype == torch.int32
    close(sol.residual, want.residual, 1e-12)
    assert float(want.residual) <= params.rel_tolerance
    vel = np.asarray(want.grid_vel)
    close(sol.grid_vel, vel, SOLVE_TOL * np.abs(vel).max())
    imp = np.asarray(want.impulses)
    assert (np.abs(imp).max(axis=1) > 0).all(), "a geometry touched no particle"
    close(sol.impulses, imp, SOLVE_TOL * np.abs(imp).max())


def test_coupled_substep_implicit_matches_jax(block):
    import torch

    from drake_tpu_torch.mpm import grid_contact as tgc

    ref = block["ref"]
    cfg, s = _port_block_state(block["v0"])
    params = tgc.GridContactParams(**SOLVE_PARAMS)
    geoms = _port_geoms()
    acc = torch.zeros(2, 6, dtype=torch.float64)
    for k in range(SUBSTEPS):
        s, imp = tgc.coupled_substep_implicit(cfg, params, s, geoms)
        imp_ref = np.asarray(ref["imps"][k])
        close(imp, imp_ref, IMPULSE_TOL * np.abs(imp_ref).max())
        acc = acc + imp
    want = ref["substeps"]
    for name in ("x", "v", "F"):
        close(getattr(s, name), getattr(want, name), XVF_TOL)
    close(s.C, want.C, C_TOL)
    assert s.dropped.dtype == torch.int32
    np.testing.assert_array_equal(s.dropped.numpy(), np.asarray(want.dropped))
    close(acc, ref["acc"], IMPULSE_TOL * np.abs(np.asarray(ref["acc"])).max())


def test_lanes_match_single_lane_solves():
    """Three lanes (the ground 0.2 and 0.1 mm into the block's lowest
    layer, and below the block so that it touches nothing), each with its
    own velocities, in one solve: every lane equals its own unbatched solve
    within 1e-12 of the largest magnitude (the batched sums round
    differently), and the lanes stop at different iteration counts."""
    import torch

    from drake_tpu_torch.mpm import grid_contact as tgc
    from drake_tpu_torch.mpm import solver as T
    from drake_tpu_torch.utils.struct import tree_map

    cfg, s = _port_block_state()
    n = s.x.shape[0]
    v = np.asarray([[0.0, 0.0, -0.05], [0.02, 0.0, 0.0], [0.0, 0.0, 0.0]])[:, None]
    lanes = tree_map(lambda t: t.expand((3,) + t.shape).contiguous(), s)
    lanes = lanes.replace(v=torch.tensor(v).expand(3, n, 3).contiguous())
    z = Z0 + torch.tensor([0.006, 0.0059, -0.05], dtype=torch.float64)
    params = tgc.GridContactParams(**SOLVE_PARAMS)
    grid = T.particle_to_grid(cfg, lanes)
    vel = T.update_grid(cfg, grid)
    both = tgc.solve_grid_contact(cfg, params, lanes, grid.mass, vel,
                                  _port_geoms((3,), z, sphere=False))
    assert both.grid_vel.shape == (3, 32, 32, 32, 3) and both.impulses.shape == (3, 1, 6)
    for lane in range(3):
        one = tgc.solve_grid_contact(cfg, params, tree_map(lambda t: t[lane], lanes),
                                     grid.mass[lane], vel[lane],
                                     _port_geoms((), z[lane], sphere=False))
        assert int(one.iterations) == int(both.iterations[lane])
        for a, b in ((one.grid_vel, both.grid_vel[lane]), (one.impulses, both.impulses[lane]),
                     (one.residual, both.residual[lane])):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-12 * float(b.abs().max()))
    its = both.iterations.tolist()
    assert len(set(its)) == 3 and max(its) < params.max_iterations, its
    assert (both.residual <= params.rel_tolerance).all()
    assert its[2] == 1 and float(both.impulses[2].abs().max()) == 0.0
    assert float(both.impulses[:2, 0, 5].min()) < 0  # the ground pushes up: -f on it


@pytest.fixture(scope="module")
def world():
    """The JAX dense implicit world step over the lanes of
    tests/test_torch_coupled.py, with the solve every substep and every
    second substep, in one program."""
    from drake_tpu.contact import coupled_plant as jcp
    from drake_tpu.mpm import grid_contact as jgc
    from drake_tpu.mpm import solver as jmpm

    jworld, jparams, jparticles = jax_paddle_world()
    worlds = {freq: dataclasses.replace(jworld, contact_model="implicit", tiled=False,
                                        contact_query_frequency=freq) for freq in (1, 2)}
    rigid, v, tau = lane_inputs(jparticles.x.shape[0])
    cfg, cp = jworld.mpm_config, jworld.contact_params
    gcp = jgc.GridContactParams(stiffness=cp.stiffness, damping=cp.damping,
                                friction=cp.friction, slip_velocity=cp.slip_velocity)

    def one(rigid1, v1, tau1):
        state = jcp.CoupledState(rigid=rigid1, particles=jparticles.replace(v=v1))
        out = {"step": {freq: w.step(jparams, state, tau1) for freq, w in worlds.items()}}
        # The Newton iterations of the step's solves, which step does not
        # return: its substeps taken again (the substeps with the solve).
        nq = jworld.model.num_positions
        geoms = jworld.rigid_geoms(jparams, rigid1[:nq], rigid1[nq:])

        def substep(p, _):
            grid = jmpm.particle_to_grid(cfg, p)
            sol = jgc.solve_grid_contact(cfg, gcp, p, grid.mass, jmpm.update_grid(cfg, grid),
                                         geoms)
            return jmpm.grid_to_particle(cfg, p, sol.grid_vel), sol.iterations

        out["iterations"] = jax.lax.scan(substep, state.particles, None,
                                         length=jworld.substeps_per_step)[1]
        return out

    ref = run_jitted(jax.vmap(one), rigid, v, tau)
    return {"ref": ref, "rigid": rigid, "v": v, "tau": tau}


@pytest.mark.parametrize("freq", [1, 2])
def test_dense_implicit_world_step_matches_jax(world, freq):
    """One coupled step of the 2 lanes: 2 implicit substeps (freq 1), or an
    implicit and a free one (freq 2), then SAP with the impulses."""
    import torch

    from drake_tpu_torch.benchmarks import paddle_blob
    from drake_tpu_torch.contact import coupled_plant
    from drake_tpu_torch.mpm import grid_contact as tgc

    tw = port_paddle_world()
    w = dataclasses.replace(tw.world, contact_model="implicit", tiled=False,
                            contact_query_frequency=freq)
    s = paddle_blob.lanes(tw.state0, LANES)
    s = coupled_plant.CoupledState(rigid=torch.tensor(world["rigid"]),
                                   particles=s.particles.replace(v=torch.tensor(world["v"])))
    with tgc.solve_log() as log:
        got = w.step(tw.params, s, torch.tensor(world["tau"]))
    want = world["ref"]["step"][freq]
    close(got.rigid, want.rigid, RIGID_TOL)
    for name in ("x", "v", "F"):
        close(getattr(got.particles, name), getattr(want.particles, name), XVF_TOL)
    close(got.particles.C, want.particles.C, C_TOL)
    np.testing.assert_array_equal(got.particles.dropped.numpy(),
                                  np.asarray(want.particles.dropped))
    # Each solve's iterations, lane by lane, as the reference's (the solve
    # on every second substep is the first substep's solve).
    its = np.asarray(world["ref"]["iterations"])  # (lanes, substeps)
    assert [lg.iterations.tolist() for lg in log] == its[:, ::freq].T.tolist()
    # Both lanes' paddles met the blob, and the solve took Newton steps.
    assert (log[0].impulses.abs().amax(dim=(-2, -1)) > 0).all()
    assert (log[0].iterations > 1).all()
    # The blob pushed the paddles back: the step is not free motion.
    free = s.rigid[:, 1] + 1e-2 * torch.tensor(world["tau"])[:, 0] / 2.0
    assert ((got.rigid[:, 1] - free).abs() > 1e-5).all()


def test_momentum_balance():
    """The port alone, 100 substeps of the block falling onto the ground and
    bouncing: the block's momentum change is the ground's impulse on it
    less gravity's, so the ground's accumulated reaction impulse is -(m g t
    + p_z(end)).  tests/test_grid_contact.py holds the reference to the
    same balance after 400 substeps, where the block has settled and p_z
    is near zero (it writes + p_z(end), a sign that only shows while the
    block still moves, as it does here)."""
    import torch

    from drake_tpu_torch.mpm import grid_contact as tgc

    cfg, s = _port_block_state()
    params = tgc.GridContactParams(**BLOCK_PARAMS)
    geoms = _port_geoms(z=Z0, sphere=False)
    n = 100
    acc = torch.zeros(1, 6, dtype=torch.float64)
    for _ in range(n):
        s, imp = tgc.coupled_substep_implicit(cfg, params, s, geoms)
        acc = acc + imp
    m = float(s.mass.sum())
    pz_end = float(torch.sum(s.mass * s.v[:, 2]))
    expect = -(m * 9.81 * n * cfg.dt) - pz_end
    got = float(acc[0, 5])
    assert got == pytest.approx(expect, rel=0.05), (got, expect)
    # The block still moves: the sign of p_z(end) counts.
    assert abs(pz_end) > 0.1 * m * 9.81 * n * cfg.dt
    assert bool(torch.isfinite(s.x).all())


def test_update_grid_blocks_mass_is_the_block_grids_mass():
    """K1 from block windows asked for the mass: its plain version returns
    grid_from_blocks_reference's mass beside the same velocity, and that
    mass is the scatter P2G's.  grid_velocity_and_mass on the CPU is
    update_grid of particle_to_grid, with its mass."""
    import torch

    from drake_tpu_torch.mpm import solver as T
    from drake_tpu_torch.ops import mpm_kernels as mk

    cfg, s = _port_block_state(_velocities(_port_block_state()[1].x.shape[0]))
    sort = T.sort_particles(cfg, s)
    assert int(sort.dropped) == 0
    out = mk.p2g_block(sort.packed, sort.starts, sort.counts, cfg.block_capacity)
    args = (out, sort.active, cfg.grid_size, cfg.dx, cfg.dt, cfg.gravity, cfg.wall_width)
    vel, mass = mk.update_grid_blocks(*args, with_mass=True)
    assert torch.equal(vel, mk.update_grid_blocks(*args))
    assert torch.equal(mass, mk.grid_from_blocks_reference(out, sort.active, cfg.grid_size,
                                                           cfg.dx)[0])
    grid = T.particle_to_grid_scatter(cfg, s)
    torch.testing.assert_close(mass, grid.mass, rtol=0, atol=1e-12 * float(grid.mass.max()))
    v2, m2, dropped = T.grid_velocity_and_mass(cfg, s)
    assert torch.equal(v2, T.update_grid(cfg, T.particle_to_grid(cfg, s)))
    assert torch.equal(m2, grid.mass) and int(dropped) == 0
    assert mk.LAUNCHES_WITH_MASS == {"update_grid_blocks": 0}


def test_update_grid_blocks_mass_kernel_matches_plain():
    """On the card: the kernel's mass and velocity against its plain
    version, over lanes, within 1e-5 of their largest magnitudes."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    from drake_tpu_torch.mpm import solver as T
    from drake_tpu_torch.ops import mpm_kernels as mk
    from drake_tpu_torch.utils.struct import tree_map

    cfg, s = _port_block_state(_velocities(_port_block_state()[1].x.shape[0]))
    s = tree_map(lambda t: t.expand((2,) + t.shape).contiguous().to("cuda", torch.float32)
                 if t.is_floating_point() else t.expand((2,) + t.shape).contiguous().cuda(), s)
    sort = T.sort_particles(cfg, s)
    out = mk.p2g_block(sort.packed, sort.starts, sort.counts, cfg.block_capacity)
    args = (out, sort.active, cfg.grid_size, cfg.dx, cfg.dt, cfg.gravity, cfg.wall_width)
    vel, mass = mk.update_grid_blocks_cuda(*args, with_mass=True)
    vel_r, mass_r = mk.update_grid_blocks_reference(*args, with_mass=True)
    torch.testing.assert_close(mass, mass_r, rtol=0, atol=1e-5 * float(mass_r.abs().max()))
    torch.testing.assert_close(vel, vel_r, rtol=0, atol=1e-5 * float(vel_r.abs().max()))
    assert torch.equal(vel, mk.update_grid_blocks_cuda(*args))
