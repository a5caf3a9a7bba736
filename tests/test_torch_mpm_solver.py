"""Slice parity: drake_tpu_torch.mpm.solver against drake_tpu.mpm.solver on
the CPU, in float64, on the same state.

The scene is tests/test_mpm.py's blocked-substep scene: a 32^3 grid with
dx = 1/32, 4,096 particles, max_active_blocks 64, block_capacity 512, with v
and F perturbed from a numpy seed so that stress, APIC and G2P are all
nontrivial.  Each JAX function is jitted once per module.

Tolerances (float64): x, v and F within 1e-9; C within 1e-6, since it
carries the factor 4/dx^2 = 4,096; grids within 1e-9; ``dropped`` equal.

torch and the port are imported when a test here runs, not when pytest
collects this file (see tests/test_torch_mpm_kernels.py).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from drake_tpu.mpm import solver as J

XVF_TOL = 1e-9
C_TOL = 1e-6
LO, HI = (0.35, 0.35, 0.4), (0.6, 0.6, 0.65)


def _jax_config(**kw):
    return J.MpmConfig(
        grid_size=(32, 32, 32), dx=1.0 / 32, dt=1e-4,
        max_active_blocks=64, block_capacity=512, **kw,
    )


def _jax_state(config, seed=3):
    s = J.make_particle_block(config, LO, HI, dtype=np.float64)
    rng = np.random.default_rng(seed)
    n = s.x.shape[0]
    return s.replace(
        v=jnp.asarray(0.1 * rng.standard_normal((n, 3))),
        F=jnp.asarray(np.eye(3) + 0.01 * rng.standard_normal((n, 3, 3))),
    )


def _to_numpy(state):
    return {f.name: np.asarray(getattr(state, f.name)) for f in dataclasses.fields(state)}


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch on one thread while these tests run: pytest-xdist runs several
    workers on the same cores, and torch's default of one thread per core
    then oversubscribes them and slows these tests several-fold."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def T():
    from drake_tpu_torch.mpm import solver

    return solver


@pytest.fixture(scope="module")
def convert():
    from drake_tpu_torch.mpm import convert

    return convert


def _port(convert, jconfig, jstate):
    return (
        convert.config_from_reference(dataclasses.asdict(jconfig)),
        convert.state_from_numpy(_to_numpy(jstate), device="cpu"),
    )


def _assert_state_close(got, ref):
    for name in ("x", "v", "F"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
            rtol=0, atol=XVF_TOL, err_msg=name,
        )
    np.testing.assert_allclose(got.C.numpy(), np.asarray(ref.C), rtol=0, atol=C_TOL)
    np.testing.assert_array_equal(got.dropped.numpy(), np.asarray(ref.dropped))


@pytest.fixture(scope="module")
def scene(convert):
    jconfig = _jax_config()
    jstate = _jax_state(jconfig)
    tconfig, tstate = _port(convert, jconfig, jstate)
    return jconfig, jstate, tconfig, tstate


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_make_particle_block_bit_identical(T, convert, dtype):
    import torch

    jconfig = _jax_config()
    tconfig = convert.config_from_reference(dataclasses.asdict(jconfig))
    js = J.make_particle_block(jconfig, LO, HI, dtype=getattr(np, dtype))
    ts = T.make_particle_block(
        tconfig, LO, HI, dtype=getattr(torch, dtype), device="cpu"
    )
    assert ts.x.shape == (4096, 3)
    for name, ref in _to_numpy(js).items():
        got = getattr(ts, name).numpy()
        assert got.dtype == ref.dtype, name
        np.testing.assert_array_equal(got, ref, err_msg=name)


def test_constitutive_model_matches_jax(T):
    import torch

    rng = np.random.default_rng(0)
    F = np.eye(3) + 0.2 * rng.standard_normal((64, 3, 3))
    F[0] = np.diag([1.0, 1.0, -1.0])  # an inverted element: signed eps
    mu, lam = J.MpmConfig().lame
    for jfn, tfn in (
        (J._det3, T._det3),
        (J._inv3, T._inv3),
        (J._polar_rotation, T._polar_rotation),
        (functools.partial(J.fixed_corotated_stress, mu=mu, lam=lam),
         functools.partial(T.fixed_corotated_stress, mu=mu, lam=lam)),
    ):
        ref = np.asarray(jfn(jnp.asarray(F)))
        got = tfn(torch.from_numpy(F)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())


def test_bspline_weights_match_jax(T, scene):
    jconfig, jstate, tconfig, tstate = scene
    jb, jw = J._bspline_weights(jstate.x, jconfig.dx)
    tb, tw = T._bspline_weights(tstate.x, tconfig.dx)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-15)


@pytest.mark.parametrize("path", ["particle_to_grid_scatter", "particle_to_grid_blocked"])
def test_particle_to_grid_matches_jax(T, scene, path):
    jconfig, jstate, tconfig, tstate = scene
    ref = jax.jit(functools.partial(getattr(J, path), jconfig))(jstate)
    got = getattr(T, path)(tconfig, tstate)
    np.testing.assert_allclose(got.mass.numpy(), np.asarray(ref.mass), rtol=0, atol=XVF_TOL)
    np.testing.assert_allclose(
        got.momentum.numpy(), np.asarray(ref.momentum), rtol=0, atol=XVF_TOL
    )
    assert int(got.dropped) == int(ref.dropped)


def test_update_grid_and_grid_to_particle_match_jax(T, scene):
    import torch

    jconfig, jstate, tconfig, tstate = scene
    jgrid = jax.jit(functools.partial(J.particle_to_grid_scatter, jconfig))(jstate)
    jvel = jax.jit(functools.partial(J.update_grid, jconfig))(jgrid)
    tgrid = T.GridState(
        mass=torch.tensor(np.asarray(jgrid.mass)),
        momentum=torch.tensor(np.asarray(jgrid.momentum)),
    )
    tvel = T.update_grid(tconfig, tgrid)
    np.testing.assert_allclose(tvel.numpy(), np.asarray(jvel), rtol=0, atol=XVF_TOL)
    ref = jax.jit(functools.partial(J.grid_to_particle, jconfig))(jstate, jvel)
    got = T.grid_to_particle(tconfig, tstate, torch.tensor(np.asarray(jvel)))
    _assert_state_close(got, ref)


def test_block_windows_match_jax(T):
    """K3's windows (``block_velocity_windows``: each active block's 6^3
    nodes gathered, zero past the grid's upper faces and for the sentinel)
    are the JAX package's ``block_windows`` of those blocks, times 1 and the
    node positions; over lanes each lane reads its own grid."""
    import torch

    rng = np.random.default_rng(5)
    field = rng.standard_normal((2, 16, 8, 12, 3))
    ref = np.stack([np.asarray(J.block_windows(jnp.asarray(f), 4, 2, 3)) for f in field])
    config = T.MpmConfig(grid_size=(16, 8, 12), dx=1.0 / 16)
    active = torch.tensor([[0, 5, 11, 23, 24], [3, 4, 20, 24, 24]])  # 24: the sentinel
    node_pos = T.window_node_pos(config, active, torch.float64)
    got = T.block_velocity_windows(config, torch.from_numpy(field), active, node_pos).numpy()
    assert got.shape == (2, 5, 216, 12)
    for lane in range(2):
        for a, block in enumerate(active[lane].tolist()):
            win = ref[lane, block] if block < 24 else np.zeros((216, 3))
            np.testing.assert_array_equal(got[lane, a, :, 0:3], win)
            for c in range(3):
                np.testing.assert_array_equal(got[lane, a, :, 3 + 3 * c:6 + 3 * c],
                                              win * node_pos[lane, a, :, c:c + 1].numpy())


@pytest.mark.parametrize("substep", ["mpm_substep", "mpm_substep_blocked"])
def test_substep_matches_jax(T, scene, substep):
    jconfig, jstate, tconfig, tstate = scene
    ref = jax.jit(functools.partial(getattr(J, substep), jconfig))(jstate)
    got = getattr(T, substep)(tconfig, tstate)
    _assert_state_close(got, ref)
    assert int(got.dropped) == 0


def test_simulate_matches_jax_over_20_substeps(T, scene):
    jconfig, jstate, tconfig, tstate = scene
    ref = jax.jit(lambda s: J.simulate(jconfig, s, 20))(jstate)
    got = T.simulate(tconfig, tstate, 20)
    _assert_state_close(got, ref)


def _jax_block_table(jconfig, jstate):
    """(active, starts, counts, dropped) of the JAX package's block sort, as
    particle_to_grid_blocked makes them (drake_tpu/mpm/solver.py: sort by
    block id, fixed-size unique, searchsorted, clamp to the capacity)."""
    nx, ny, nz = jconfig.grid_size
    nby, nbz = ny // 4, nz // 4
    nblocks = (nx // 4) * nby * nbz
    base, _ = J._bspline_weights(jstate.x, jconfig.dx)
    base = jnp.clip(base, 0, jnp.asarray([nx - 3, ny - 3, nz - 3]))
    bxyz = base // 4
    bid = np.sort(np.asarray((bxyz[:, 0] * nby + bxyz[:, 1]) * nbz + bxyz[:, 2]))
    active = np.asarray(
        jnp.unique(jnp.asarray(bid), size=jconfig.max_active_blocks, fill_value=nblocks)
    )
    starts = np.searchsorted(bid, active, side="left")
    counts = np.searchsorted(bid, active, side="right") - starts
    counts = np.where(active < nblocks, np.minimum(counts, jconfig.block_capacity), 0)
    return active, starts, counts, bid.shape[0] - counts.sum()


@pytest.mark.parametrize("max_active_blocks, block_capacity", [(64, 512), (8, 512), (64, 100)])
def test_sort_particles_block_table_and_cell_order(
    T, convert, max_active_blocks, block_capacity
):
    """The (block, cell) sort key leaves the block table as the JAX package's
    sort by block makes it -- also when blocks or particles are dropped -- and
    orders every block's rows by local base cell, x slowest and z fastest."""
    jconfig = dataclasses.replace(
        _jax_config(), max_active_blocks=max_active_blocks, block_capacity=block_capacity
    )
    jstate = _jax_state(jconfig)
    tconfig, tstate = _port(convert, jconfig, jstate)
    active, starts, counts, dropped = _jax_block_table(jconfig, jstate)
    # The JAX substep reports the same count.
    ref = jax.jit(functools.partial(J.particle_to_grid_blocked, jconfig))(jstate)
    assert int(ref.dropped) == dropped

    sort = T.sort_particles(tconfig, tstate)
    np.testing.assert_array_equal(sort.active.numpy(), active)
    np.testing.assert_array_equal(sort.starts.numpy(), starts)
    np.testing.assert_array_equal(sort.counts.numpy(), counts)
    assert int(sort.dropped) == dropped
    assert (dropped > 0) == ((max_active_blocks, block_capacity) != (64, 512))

    packed = sort.packed.numpy()
    n = packed.shape[0]
    assert sorted(sort.perm.tolist()) == list(range(n))
    np.testing.assert_array_equal(packed[:, 28:31], tstate.x.numpy()[sort.perm.numpy()])
    lb = packed[:, 25:28]
    assert set(np.unique(lb)) <= {0.0, 1.0, 2.0, 3.0}
    cell = lb[:, 0] * 16 + lb[:, 1] * 4 + lb[:, 2]
    nblocks = 8 * 8 * 8
    for a in np.flatnonzero(active < nblocks):
        end = np.searchsorted(sort.bid.numpy()[sort.perm.numpy()], active[a], side="right")
        run = cell[starts[a]:end]  # the whole block, dropped rows included
        assert (np.diff(run) >= 0).all(), f"block {active[a]}"
        assert len(np.unique(run)) > 1


@pytest.mark.parametrize("substep", ["particle_to_grid_blocked", "mpm_substep_blocked"])
def test_capacity_drops_counted_as_in_jax(T, convert, substep):
    """With max_active_blocks too small, the first A blocks in sorted order
    are kept; both packages drop (and count) the same particles."""
    jconfig = _jax_config()
    jconfig = dataclasses.replace(jconfig, max_active_blocks=8)
    jstate = _jax_state(jconfig)
    tconfig, tstate = _port(convert, jconfig, jstate)
    ref = jax.jit(functools.partial(getattr(J, substep), jconfig))(jstate)
    got = getattr(T, substep)(tconfig, tstate)
    assert int(ref.dropped) > 0
    assert int(got.dropped) == int(ref.dropped)
    if substep == "mpm_substep_blocked":
        _assert_state_close(got, ref)
    else:
        np.testing.assert_allclose(
            got.mass.numpy(), np.asarray(ref.mass), rtol=0, atol=XVF_TOL
        )


def test_convert_round_trip(convert, scene):
    import torch

    jconfig, jstate, tconfig, tstate = scene
    assert dataclasses.asdict(tconfig) == dataclasses.asdict(jconfig)
    assert tconfig.lame == jconfig.lame
    assert dataclasses.asdict(tconfig.capacities_for(133_000)) == dataclasses.asdict(
        jconfig.capacities_for(133_000)
    )
    back = convert.state_to_numpy(tstate)
    for name, ref in _to_numpy(jstate).items():
        np.testing.assert_array_equal(back[name], ref, err_msg=name)
        assert back[name].dtype == ref.dtype, name
    f32 = convert.state_from_numpy(
        _to_numpy(jstate), device="cpu", dtype=torch.float32
    )
    assert f32.x.dtype == torch.float32 and f32.dropped.dtype == torch.int32


# ---------------------------------------------------------------------------
# Lanes: L independent states in one call, against jax.vmap of the reference.
# ---------------------------------------------------------------------------

LANE_CAPACITIES = {"A64": 64, "A8": 8}  # A = 8 drops blocks, differently per lane
P_CUT = 100  # a block_capacity that drops the last particles of the fullest blocks


def _jax_faces_state(jconfig):
    """Particles in the corner cells of the grid: within wall_width of the
    lower faces (base cell -1, clipped to 0) and at the upper faces (base
    cell n - 2, clipped to n - 3, weights from the unclipped base)."""
    lo = J.make_particle_block(jconfig, (0.0,) * 3, (0.11,) * 3, dtype=np.float64)
    hi = J.make_particle_block(jconfig, (0.89,) * 3, (1.0,) * 3, dtype=np.float64,
                               jitter_seed=1)
    s = jax.tree_util.tree_map(lambda a, b: jnp.concatenate([a, b]) if a.ndim else a, lo, hi)
    rng = np.random.default_rng(5)
    n = s.x.shape[0]
    return s.replace(
        v=jnp.asarray(0.1 * rng.standard_normal((n, 3))),
        F=jnp.asarray(np.eye(3) + 0.01 * rng.standard_normal((n, 3, 3))),
    )


def _kept_by_the_port(T, config, state):
    """(..., n) bool: the particles that the port's block sort keeps."""
    sort = T.sort_particles(config, state)
    kept = np.zeros(sort.perm.shape[0], bool)
    for start, count in zip(sort.starts.reshape(-1).tolist(), sort.counts.reshape(-1).tolist()):
        kept[sort.perm[start:start + count].numpy()] = True
    return kept.reshape(state.mass.shape)


def _jax_lane_states(jconfig):
    """Two lanes: the scene's state, and one with other velocities and
    deformations whose blob sits a few cells away (other blocks)."""
    s0 = _jax_state(jconfig, seed=3)
    s1 = _jax_state(jconfig, seed=4)
    s1 = s1.replace(x=s1.x + jnp.asarray([0.07, -0.05, 0.03]))
    return jax.tree_util.tree_map(lambda a, b: jnp.stack([a, b]), s0, s1)


@pytest.fixture(scope="module")
def lanes(convert):
    """The two lanes in both packages, and every vmapped JAX quantity of the
    lane tests from one jitted program."""
    from test_torch_multibody import run_jitted

    from drake_tpu_torch.mpm import solver as T

    jconfig = _jax_config()
    jstates = _jax_lane_states(jconfig)
    jfaces = _jax_faces_state(jconfig)
    configs = {k: dataclasses.replace(jconfig, max_active_blocks=a)
               for k, a in LANE_CAPACITIES.items()}
    configs["P100"] = dataclasses.replace(jconfig, block_capacity=P_CUT)
    tconfigs = {k: convert.config_from_reference(dataclasses.asdict(c))
                for k, c in configs.items()}
    tstates = convert.state_from_numpy(_to_numpy(jstates), device="cpu")
    tfaces = convert.state_from_numpy(_to_numpy(jfaces), device="cpu")
    # The JAX sort keeps other particles of an overflowing block than the
    # port's sort by cell, so the reference of the pmax cut is the JAX grid
    # of the particles the port keeps: the others get no mass and volume.
    kept = jnp.asarray(_kept_by_the_port(T, tconfigs["P100"], tstates))
    jkept = jstates.replace(mass=jnp.where(kept, jstates.mass, 0.0),
                            volume=jnp.where(kept, jstates.volume, 0.0))

    def one(s):
        grid = J.particle_to_grid_scatter(jconfig, s)
        vel = J.update_grid(jconfig, grid)
        out = {"scatter": grid, "vel": vel, "g2p": J.grid_to_particle(jconfig, s, vel),
               "substep": J.mpm_substep(jconfig, s)}
        for k in LANE_CAPACITIES:
            out[f"blocked_{k}"] = J.particle_to_grid_blocked(configs[k], s)
            out[f"vel_blocked_{k}"] = J.update_grid(jconfig, out[f"blocked_{k}"])
        return out

    def blocked_velocity(s):
        return J.update_grid(jconfig, J.particle_to_grid_blocked(jconfig, s))

    def program(states, faces, kept_states):
        out = jax.vmap(one)(states)
        out["vel_blocked_P100"] = jax.vmap(blocked_velocity)(kept_states)
        out["vel_blocked_faces"] = blocked_velocity(faces)
        return out

    ref = run_jitted(program, jstates, jfaces, jkept)
    return {"ref": ref, "tconfig": tconfigs["A64"], "tconfigs": tconfigs,
            "tstates": tstates, "jstates": jstates, "tfaces": tfaces}


def _assert_grid_close(got, ref):
    np.testing.assert_allclose(got.mass.numpy(), np.asarray(ref.mass), rtol=0, atol=XVF_TOL)
    np.testing.assert_allclose(
        got.momentum.numpy(), np.asarray(ref.momentum), rtol=0, atol=XVF_TOL
    )
    np.testing.assert_array_equal(got.dropped.numpy(), np.asarray(ref.dropped))


@pytest.mark.parametrize("piece", ["scatter", "blocked_A64", "blocked_A8", "update_grid",
                                   "grid_to_particle", "mpm_substep"])
def test_lanes_match_jax_vmap(T, lanes, piece):
    import torch

    ref, cfg, s = lanes["ref"], lanes["tconfig"], lanes["tstates"]
    if piece == "scatter":
        _assert_grid_close(T.particle_to_grid_scatter(cfg, s), ref["scatter"])
    elif piece.startswith("blocked"):
        k = piece.split("_")[1]
        got = T.particle_to_grid_blocked(lanes["tconfigs"][k], s)
        _assert_grid_close(got, ref[piece])
        if k == "A8":  # the lanes drop different counts
            drops = np.asarray(ref[piece].dropped)
            assert drops[0] != drops[1] and min(drops) > 0
    elif piece == "update_grid":
        grid = T.GridState(mass=torch.tensor(np.asarray(ref["scatter"].mass)),
                           momentum=torch.tensor(np.asarray(ref["scatter"].momentum)))
        np.testing.assert_allclose(T.update_grid(cfg, grid).numpy(), np.asarray(ref["vel"]),
                                   rtol=0, atol=XVF_TOL)
    elif piece == "grid_to_particle":
        _assert_state_close(
            T.grid_to_particle(cfg, s, torch.tensor(np.asarray(ref["vel"]))), ref["g2p"])
    else:
        got = T.mpm_substep(cfg, s)
        _assert_state_close(got, ref["substep"])
        assert got.dropped.shape == (2,)


@pytest.mark.parametrize("piece", ["scatter", "blocked_A8", "grid_to_particle"])
def test_lane_of_a_batched_call_equals_the_unbatched_call(T, lanes, piece):
    """Lane l of a call over lanes is the call on lane l's state alone:
    no lane reaches another's nodes or blocks."""
    import torch

    from drake_tpu_torch.utils.struct import tree_map

    s = lanes["tstates"]
    cfg = lanes["tconfigs"]["A8"]
    vel = torch.tensor(np.asarray(lanes["ref"]["vel"]))
    fn = {
        "scatter": lambda st, l: T.particle_to_grid_scatter(cfg, st),
        "blocked_A8": lambda st, l: T.particle_to_grid_blocked(cfg, st),
        "grid_to_particle": lambda st, l: T.grid_to_particle(cfg, st, vel if l is None else vel[l]),
    }[piece]
    def leaves(out):  # a GridState or an MpmState
        if dataclasses.is_dataclass(out):
            return [getattr(out, f.name) for f in dataclasses.fields(out)]
        return list(out)

    both = fn(s, None)
    for lane in range(2):
        one = fn(tree_map(lambda t: t[lane], s), lane)
        for got, want in zip(leaves(one), leaves(tree_map(lambda t: t[lane], both))):
            torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_sort_particles_over_lanes_keeps_each_lanes_block_table(T, lanes):
    """Over lanes the block table of lane l is that lane's own table, its
    starts moved by the l n rows of the lanes before it; drops per lane."""
    from drake_tpu_torch.utils.struct import tree_map

    cfg, s = lanes["tconfigs"]["A8"], lanes["tstates"]
    n = s.x.shape[1]
    both = T.sort_particles(cfg, s)
    assert both.active.shape == (2, 8) and both.dropped.shape == (2,)
    for lane in range(2):
        one = T.sort_particles(cfg, tree_map(lambda t: t[lane], s))
        np.testing.assert_array_equal(both.active[lane].numpy(), one.active.numpy())
        np.testing.assert_array_equal(both.counts[lane].numpy(), one.counts.numpy())
        np.testing.assert_array_equal(both.starts[lane].numpy(), one.starts.numpy() + lane * n)
        assert int(both.dropped[lane]) == int(one.dropped) > 0
        rows = slice(lane * n, (lane + 1) * n)
        np.testing.assert_array_equal(both.packed[rows].numpy(), one.packed.numpy())
        np.testing.assert_array_equal(both.perm[rows].numpy(), one.perm.numpy() + lane * n)


# ---------------------------------------------------------------------------
# K1 from block windows (mpm_kernels.update_grid_blocks): its plain version
# against the JAX package's update_grid(particle_to_grid_blocked(...)).
# ---------------------------------------------------------------------------


def _blocked_velocity(T, config, state):
    """The grid velocity through K2 and K1 from K2's block windows, as the
    card's substeps take it (their plain versions here)."""
    from drake_tpu_torch.ops import mpm_kernels as mk

    sort = T.sort_particles(config, state)
    out = mk.p2g_block(sort.packed, sort.starts, sort.counts, config.block_capacity)
    return mk.update_grid_blocks(out, sort.active, config.grid_size, config.dx, config.dt,
                                 config.gravity, config.wall_width)


@pytest.mark.parametrize("case", ["single", "lanes", "lanes_A8", "lanes_P100", "faces"])
def test_update_grid_blocks_matches_jax(T, lanes, case):
    """Within 1e-9 of max |v| in float64: one state (lane 0 of the vmapped
    reference), two lanes against jax.vmap, blocks cut by max_active_blocks
    and by block_capacity, and particles at the clipped faces and within
    the walls."""
    from drake_tpu_torch.utils.struct import tree_map

    ref, s = lanes["ref"], lanes["tstates"]
    key = {"lanes_A8": "A8", "lanes_P100": "P100"}.get(case, "A64")
    cfg = lanes["tconfigs"][key]
    want = np.asarray(ref[f"vel_blocked_{key}"])
    if case == "single":
        s, want = tree_map(lambda t: t[0], s), want[0]
    elif case == "faces":
        s, want = lanes["tfaces"], np.asarray(ref["vel_blocked_faces"])
        assert int(T.sort_particles(cfg, s).dropped) == 0
        base = np.floor(s.x.numpy() / cfg.dx - 0.5)
        assert (base < 0).any() and (base > cfg.grid_size[0] - 3).any()
        wall = np.asarray(cfg.grid_size) - cfg.wall_width
        assert np.abs(want[: cfg.wall_width]).max() == 0 == np.abs(want[wall[0]:]).max()
    elif case != "lanes":
        drops = T.sort_particles(cfg, s).dropped.numpy()
        assert (drops > 0).all()
    got = _blocked_velocity(T, cfg, s)
    assert got.shape == want.shape
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9 * np.abs(want).max())


@pytest.mark.parametrize("case", ["single", "lanes"])
def test_grid_velocity_on_the_cpu_is_update_grid_of_particle_to_grid(T, lanes, case):
    """On the CPU the substeps' P2G and grid update are the scatter and the
    plain dense update, bit for bit, and the dropped count is the P2G's."""
    import torch

    from drake_tpu_torch.utils.struct import tree_map

    cfg, s = lanes["tconfigs"]["A8"], lanes["tstates"]
    if case == "single":
        s = tree_map(lambda t: t[0], s)
    vel, dropped = T.grid_velocity(cfg, s)
    grid = T.particle_to_grid(cfg, s)
    assert torch.equal(vel, T.update_grid(cfg, grid))
    assert torch.equal(dropped, grid.dropped)
