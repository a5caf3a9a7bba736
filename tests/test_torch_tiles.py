"""Parity of the port's tile pipeline (drake_tpu_torch.mpm.tiles) against
the JAX package's drake_tpu.mpm.tiles, on the CPU in float64.

The scene is tests/test_mpm_tiles.py's, cut to about 1,000 particles: a 32^3
grid, dx = 1/32, dt = 2e-4, a block of 10^3 particles with v = 0.2 sin(7 x)
over 8 home blocks, max_active_blocks 16 (the reference's tiles cost grows
with it; its test takes 64).  The fast block of the staleness test moves 3 cells
a substep.  Every JAX quantity comes from one jitted program, compiled once
per module at XLA's lowest CPU optimization level.

Tolerances (float64): x, v and F 1e-9, C 1e-6 (it carries 4/dx^2), as
tests/test_torch_mpm_solver.py; ``dropped`` equal.  Lanes against their
own calls: 1e-12.

torch and the port are imported when a test here runs, not when pytest
collects this file (see tests/test_torch_mpm_kernels.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_multibody import close, run_jitted

XVF_TOL = 1e-9
C_TOL = 1e-6
LO, HI = (0.3, 0.3, 0.5), (0.45, 0.45, 0.65)
SUBSTEPS, RESORT = 17, 4  # 4 groups of 4, then a tile_substep


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch on one thread while these tests run: pytest-xdist runs several
    workers on the same cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_config(**kw):
    from drake_tpu.mpm import solver as jmpm

    return jmpm.MpmConfig(grid_size=(32, 32, 32), dx=1.0 / 32, dt=2e-4,
                          max_active_blocks=16, **kw)


def _force(n):
    """A per-particle force (n, 3) from a numpy seed."""
    return 0.5 * np.random.default_rng(7).standard_normal((n, 3))


@pytest.fixture(scope="module")
def tiles_ref():
    """The JAX package's quantities of every test here, from one program
    (with as few copies of the resident substep as the tests allow: each
    adds seconds of compile)."""
    from drake_tpu.mpm import solver as jmpm
    from drake_tpu.mpm import tiles as jt

    cfg = _jax_config()
    tiny = dataclasses.replace(cfg, max_active_blocks=2)
    s = jmpm.make_particle_block(cfg, LO, HI, dtype=jnp.float64)
    s = s.replace(v=0.2 * jnp.sin(7.0 * s.x))
    n = s.x.shape[0]
    force = jnp.asarray(_force(n))
    fast = s.replace(v=jnp.full_like(s.v, 3.0 * cfg.dx / cfg.dt))

    def substep(st, f):
        # particle_force is per slab row in the reference: each particle's
        # force at its row.
        ss = jt.sort_to_tiles(cfg, st)
        rows = jnp.zeros((ss.slab.shape[1], 3), st.x.dtype).at[ss.rowmap].set(f)
        return jt.tiles_to_state(jt.resident_substep(cfg, ss, particle_force=rows), st)

    def program(s):
        one = jax.vmap(substep)(
            jax.tree_util.tree_map(lambda *a: jnp.stack(a), s, s, fast),
            jnp.stack([jnp.zeros_like(force), force, jnp.zeros_like(force)]))
        out = {name: jax.tree_util.tree_map(lambda a, i=i: a[i], one)
               for i, name in enumerate(("substep", "forced", "fast_one"))}
        out["sort_dropped"] = jt.sort_to_tiles(cfg, s).dropped
        out["tiny_dropped"] = jt.sort_to_tiles(tiny, s).dropped
        out["tiny_substep"] = jt.tile_substep(tiny, s)
        out["simulated"] = jt.simulate_tiled(cfg, s, SUBSTEPS, resort_every=RESORT)
        ss = jt.sort_to_tiles(cfg, fast)
        out["fast_two"] = jt.tiles_to_state(
            jax.lax.scan(lambda c, _: (jt.resident_substep(cfg, c), None), ss, None,
                         length=2)[0], fast)
        return out

    return {"cfg": cfg, "state": s, "force": np.asarray(force), "ref": run_jitted(program, s)}


def _port(c, **kw):
    """The port's config (with `kw`) and the fixture's state, float64 on the
    CPU."""
    from drake_tpu_torch.mpm import convert

    cfg = convert.config_from_reference(dataclasses.asdict(c["cfg"]))
    arrays = {f.name: np.asarray(getattr(c["state"], f.name))
              for f in dataclasses.fields(c["state"])}
    return dataclasses.replace(cfg, **kw), convert.state_from_numpy(arrays, device="cpu")


def _assert_state_close(got, ref):
    for name in ("x", "v", "F"):
        close(getattr(got, name), getattr(ref, name), XVF_TOL)
    close(got.C, ref.C, C_TOL)
    np.testing.assert_array_equal(got.dropped.numpy(), np.asarray(ref.dropped))


def test_sort_unsort_identity(tiles_ref):
    """The group's sort and its unsort give the state back bit for bit; every
    particle has a home among the active blocks."""
    import torch

    from drake_tpu_torch.mpm import tiles

    cfg, s = _port(tiles_ref)
    ss = tiles.sort_to_tiles(cfg, s)
    back = tiles.tiles_to_state(ss, s)
    for name in ("x", "v", "F", "C", "mass", "volume"):
        assert torch.equal(getattr(back, name), getattr(s, name)), name
    assert int(ss.dropped) == int(tiles_ref["ref"]["sort_dropped"]) == 0
    assert not bool(ss.held.any())
    assert bool(torch.isin(ss.home, ss.active).all())
    assert bool((ss.active[1:] >= ss.active[:-1]).all())


def test_capacity_overflow_counted_as_in_jax(tiles_ref):
    """With 2 active blocks the other blocks' particles are held out: the
    sort's count equals the JAX package's, and a substep leaves them as they
    were while the others move as the reference moves them.  The held-out
    particles enter ``dropped`` once a group; the reference's substep counts
    them once more, as stale rows at the origin in its last active block's
    tiles (ROADMAP.md, "Reference traps")."""
    from drake_tpu_torch.mpm import tiles

    cfg, s = _port(tiles_ref, max_active_blocks=2)
    ref = tiles_ref["ref"]
    ss = tiles.sort_to_tiles(cfg, s)
    held = int(ss.dropped)
    assert held == int(ref["tiny_dropped"]) > 0
    got = tiles.tile_substep(cfg, s)
    assert int(got.dropped) == held
    assert int(ref["tiny_substep"].dropped) == 2 * held
    _assert_state_close(got, ref["tiny_substep"].replace(dropped=held))
    out = ss.held.numpy()
    np.testing.assert_array_equal(got.x.numpy()[out], s.x.numpy()[out])


def test_tile_substep_matches_jax(tiles_ref):
    from drake_tpu_torch.mpm import tiles

    cfg, s = _port(tiles_ref)
    got = tiles.tile_substep(cfg, s)
    _assert_state_close(got, tiles_ref["ref"]["substep"])
    assert int(got.dropped) == 0


def test_simulate_tiled_matches_jax(tiles_ref):
    """17 substeps, the group's sort every 4: four groups, then a
    tile_substep; ``dropped`` summed over groups."""
    from drake_tpu_torch.mpm import tiles

    cfg, s = _port(tiles_ref)
    got = tiles.simulate_tiled(cfg, s, SUBSTEPS, resort_every=RESORT)
    _assert_state_close(got, tiles_ref["ref"]["simulated"])


def test_grid_op_receives_dense_fields(tiles_ref):
    """grid_op sees each lane's dense velocity (nx, ny, nz, 3) and mass (nx,
    ny, nz), the whole particle mass on the grid; what it returns is what
    G2P reads: the identity gives the substep without the hook (the same
    grid, with the node mass written beside it), and the velocity halved
    moves every particle by half as much."""
    from drake_tpu_torch.mpm import tiles

    cfg, s = _port(tiles_ref)
    seen = {}

    def op(vel, mass):
        seen["shapes"] = (tuple(vel.shape), tuple(mass.shape))
        seen["mass"] = float(mass.sum())
        return vel

    same = tiles.tile_substep(cfg, s, grid_op=op)
    assert seen["shapes"] == ((32, 32, 32, 3), (32, 32, 32))
    np.testing.assert_allclose(seen["mass"], float(s.mass.sum()), rtol=1e-12)
    _assert_state_close(same, tiles_ref["ref"]["substep"])
    half = tiles.tile_substep(cfg, s, grid_op=lambda v, m: 0.5 * v)
    close(half.x - s.x, 0.5 * (same.x - s.x).numpy(), 1e-15)


def test_particle_force_matches_jax(tiles_ref):
    """particle_force adds dt f to each particle's momentum before P2G."""
    import torch

    from drake_tpu_torch.mpm import tiles

    cfg, s = _port(tiles_ref)
    ss = tiles.resident_substep(cfg, tiles.sort_to_tiles(cfg, s),
                                particle_force=torch.tensor(tiles_ref["force"]))
    _assert_state_close(tiles.tiles_to_state(ss, s), tiles_ref["ref"]["forced"])


def test_stale_particles_counted_and_frozen(tiles_ref):
    """A block moving 3 cells a substep: after the first resident substep
    (3 cells) nothing is stale; in the second the particles past their
    home's window are counted and keep x, v, F and C, as in the reference."""
    import torch

    from drake_tpu_torch.mpm import tiles

    cfg, s = _port(tiles_ref)
    fast = s.replace(v=torch.full_like(s.v, 3.0 * cfg.dx / cfg.dt))
    ss = tiles.sort_to_tiles(cfg, fast)
    one = tiles.resident_substep(cfg, ss)
    two = tiles.resident_substep(cfg, one)
    ref = tiles_ref["ref"]
    _assert_state_close(tiles.tiles_to_state(one, fast), ref["fast_one"])
    _assert_state_close(tiles.tiles_to_state(two, fast), ref["fast_two"])
    stale = tiles.stale_mask(cfg, one.state.x, one.home).numpy()
    assert int(two.dropped) == int(stale.sum()) > 0
    for name in ("x", "v", "F", "C"):
        np.testing.assert_array_equal(getattr(two.state, name).numpy()[stale],
                                      getattr(one.state, name).numpy()[stale])


def test_lanes_match_their_own_calls(tiles_ref):
    """Two lanes (the block, and the block shifted and turned around) in one
    simulate_tiled call against each lane's own call."""
    import torch

    from drake_tpu_torch.mpm import tiles
    from drake_tpu_torch.utils.struct import tree_map

    cfg, s = _port(tiles_ref)
    other = s.replace(x=s.x + torch.tensor([0.1, 0.05, -0.1], dtype=s.x.dtype), v=-s.v)
    lanes = tree_map(lambda a, b: torch.stack([a, b]), s, other)
    both = tiles.simulate_tiled(cfg, lanes, RESORT + 1, resort_every=RESORT)
    for lane, one in enumerate((s, other)):
        own = tiles.simulate_tiled(cfg, one, RESORT + 1, resort_every=RESORT)
        for name in ("x", "v", "F", "C"):
            torch.testing.assert_close(getattr(both, name)[lane], getattr(own, name),
                                       rtol=0, atol=1e-12)
        assert int(both.dropped[lane]) == int(own.dropped) == 0
