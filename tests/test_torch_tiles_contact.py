"""Parity of the port's implicit grid contact on the tile pipeline
(drake_tpu_torch.mpm.tiles_contact) against the JAX package's
drake_tpu.mpm.tiles_contact, on the CPU in float64.

Scenes, from tests/test_tiles_contact.py (32^3 grid, dx 1/32, wall width 0,
the ground halfspace at z = 0.25 inside the grid), with the paddle world's
contact (k 5e4, d 100, mu 0.3), at which the solves converge below the cap:
- the block on the ground (845 particles over 8 home blocks, max_active_blocks
  16: the reference's tiles cost grows with it), moved 6.5 mm into the ground and
  thrown at (0.2, 0, -0.1) m/s so that the solve engages at once; three
  resident substeps with the contact after one group sort, by each solve
  variant: converged (the defaults), the fixed count with the one-level
  line search (``unroll_iterations=3``, ``line_search_levels=1``), and the
  contact-row compaction (``max_contact_rows=-1``);
- a flat block spread over 32 home blocks (max_active_blocks 32) whose
  closure (144 blocks) overflows ``ext_capacity_factor=1`` (32 slots): two
  resident substeps.

Every JAX quantity comes from one jitted program, compiled once per module
at XLA's lowest CPU optimization level.

Tolerances (float64): x, v and F 1e-9, C 1e-6, impulses 1e-8 of their
largest magnitude (tests/test_torch_coupled.py's); ``dropped`` equal.  The
tiled solve against the dense one (the port alone, float32, 10 substeps):
tests/test_tiles_contact.py's bounds, x 1e-5, v 1e-3, impulses 2e-3.

torch and the port are imported when a test here runs, not when pytest
collects this file (see tests/test_torch_mpm_kernels.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_coupled import C_TOL, IMPULSE_TOL, XVF_TOL
from test_torch_multibody import close, run_jitted

Z0 = 0.25
SUBSTEPS = 3
PARAMS = dict(stiffness=5e4, damping=100.0, friction=0.3)
# Each variant is one more copy of the solve to compile (seconds each): the
# fixed count takes the one-level line search with it.
VARIANTS = {
    "converged": {},
    "fixed_count_one_level": dict(unroll_iterations=3, line_search_levels=1),
    "row_compaction": dict(max_contact_rows=-1),
}
SPREAD = ((0.2, 0.2, Z0 - 0.002), (0.6, 0.6, Z0 + 0.03))  # 32 home blocks
SPREAD_ACTIVE_BLOCKS = 32


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch on one thread while these tests run: pytest-xdist runs several
    workers on the same cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_block(lo_hi=((0.4, 0.4, Z0 - 0.002), (0.6, 0.6, Z0 + 0.078)), active_blocks=16):
    from drake_tpu.mpm import solver as jmpm

    cfg = jmpm.MpmConfig(
        grid_size=(32, 32, 32), dx=1.0 / 32, dt=5e-4, wall_width=0,
        youngs_modulus=5e4, max_active_blocks=active_blocks,
    )
    s = jmpm.make_particle_block(cfg, *lo_hi, jitter_seed=None, dtype=jnp.float64)
    return cfg, s


def _pressed(s):
    """The block 6.5 mm into the ground, thrown down and along x."""
    return s.replace(x=s.x.at[:, 2].add(-0.0065), v=s.v.at[:, 0].add(0.2).at[:, 2].add(-0.1))


@pytest.fixture(scope="module")
def contact_ref():
    """Both scenes' JAX results, from one program."""
    from drake_tpu.geometry import shapes as jsh
    from drake_tpu.mpm import coupling as jcpl
    from drake_tpu.mpm import grid_contact as jgc
    from drake_tpu.mpm import tiles as jt
    from drake_tpu.mpm import tiles_contact as jtc

    cfg, block = _jax_block()
    block = _pressed(block)
    spread_cfg, spread = _jax_block(SPREAD, SPREAD_ACTIVE_BLOCKS)
    ground = (jcpl.RigidGeom(
        shape=jsh.HalfSpace(), body_index=-1, R_WG=jnp.eye(3),
        p_WG=jnp.asarray([0.0, 0.0, Z0]), p_WB=jnp.zeros(3), V_WB=jnp.zeros(6),
    ),)

    def run(params, s, n, cfg=cfg):
        ss = jt.sort_to_tiles(cfg, s)

        def body(carry, _):
            ss_, acc = carry
            ss_, imp = jtc.resident_substep_contact(cfg, params, ss_, ground)
            return (ss_, acc + imp), None

        (ss, acc), _ = jax.lax.scan(body, (ss, jnp.zeros((1, 6))), None, length=n)
        return jt.tiles_to_state(ss, s), acc

    def program(block, spread):
        out = {name: run(jgc.GridContactParams(**PARAMS, **kw), block, SUBSTEPS)
               for name, kw in VARIANTS.items()}
        out["overflow"] = run(jgc.GridContactParams(**PARAMS, ext_capacity_factor=1),
                              spread, 2, spread_cfg)
        return out

    return {"cfg": cfg, "spread_cfg": spread_cfg, "block": block, "spread": spread,
            "ref": run_jitted(program, block, spread)}


def _port_state(c, name, dtype=None):
    from drake_tpu_torch.mpm import convert

    s = c[name]
    arrays = {f.name: np.asarray(getattr(s, f.name)) for f in dataclasses.fields(s)}
    cfg = convert.config_from_reference(dataclasses.asdict(
        c["spread_cfg" if name == "spread" else "cfg"]))
    return cfg, convert.state_from_numpy(arrays, device="cpu", dtype=dtype)


def _ground(dtype):
    import torch

    from drake_tpu_torch.geometry import shapes as tsh
    from drake_tpu_torch.mpm import coupling as tcpl

    return (tcpl.RigidGeom(
        shape=tsh.HalfSpace(), body_index=-1, R_WG=torch.eye(3, dtype=dtype),
        p_WG=torch.tensor([0.0, 0.0, Z0], dtype=dtype), p_WB=torch.zeros(3, dtype=dtype),
        V_WB=torch.zeros(6, dtype=dtype),
    ),)


def _run_port(cfg, params, s, n):
    """n resident substeps with the contact after one group sort: (state,
    impulse sum, the solves' log)."""
    from drake_tpu_torch.mpm import grid_contact as tgc
    from drake_tpu_torch.mpm import tiles
    from drake_tpu_torch.mpm import tiles_contact as ttc

    geoms = _ground(s.x.dtype)
    ss = tiles.sort_to_tiles(cfg, s)
    acc = 0.0
    with tgc.solve_log() as log:
        for _ in range(n):
            ss, imp = ttc.resident_substep_contact(cfg, params, ss, geoms)
            acc = acc + imp
    return tiles.tiles_to_state(ss, s), acc, log


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_resident_substep_contact_matches_jax(contact_ref, variant):
    from drake_tpu_torch.mpm import grid_contact as tgc

    cfg, s = _port_state(contact_ref, "block")
    params = tgc.GridContactParams(**PARAMS, **VARIANTS[variant])
    got, acc, log = _run_port(cfg, params, s, SUBSTEPS)
    ref, ref_acc = contact_ref["ref"][variant]
    for name in ("x", "v", "F"):
        close(getattr(got, name), getattr(ref, name), XVF_TOL)
    close(got.C, ref.C, C_TOL)
    ref_acc = np.asarray(ref_acc)
    assert np.abs(ref_acc).max() > 0, "no contact: the case tests nothing"
    close(acc, ref_acc, IMPULSE_TOL * np.abs(ref_acc).max())
    assert int(got.dropped) == int(ref.dropped) == 0
    its = [int(sol.iterations) for sol in log]
    if variant == "fixed_count_one_level":
        assert its == [3] * SUBSTEPS
    else:
        assert its[0] > 1 and max(its) <= params.max_iterations


def test_closure_overflow_dropped_matches_jax(contact_ref):
    """The spread block's closure (144 blocks) in 32 slots: the blocks past
    them are counted in every substep, and the particles whose home block
    lies past them are mapped to the last slot and mostly stale, as in the
    reference: ``dropped`` equals the JAX package's."""
    import torch

    from drake_tpu_torch.mpm import grid_contact as tgc
    from drake_tpu_torch.mpm import tiles
    from drake_tpu_torch.mpm import tiles_contact as ttc

    cfg, s = _port_state(contact_ref, "spread")
    params = tgc.GridContactParams(**PARAMS, ext_capacity_factor=1)
    ss = tiles.sort_to_tiles(cfg, s)
    assert int(ss.dropped) == 0  # every home block is active
    _, _, over = ttc._extend_active(cfg, ss.active, cfg.max_active_blocks)
    assert int(over) == 144 - SPREAD_ACTIVE_BLOCKS
    got, _, _ = _run_port(cfg, params, s, 2)
    ref, _ = contact_ref["ref"]["overflow"]
    assert int(got.dropped) == int(ref.dropped) > 2 * int(over)
    assert bool(torch.isfinite(got.x).all())


def test_tiled_matches_dense_solve(contact_ref):
    """The port alone, float32: 10 substeps of the pressed block through the
    tiled solve (one group sort) and through the dense one
    (grid_contact.coupled_substep_implicit) agree within the reference's own
    tiled-against-dense bounds."""
    import torch

    from drake_tpu_torch.mpm import grid_contact as tgc

    cfg, s = _port_state(contact_ref, "block", dtype=torch.float32)
    params = tgc.GridContactParams(**PARAMS)
    n = 10
    tiled, acc_t, _ = _run_port(cfg, params, s, n)
    dense, acc_d = s, 0.0
    geoms = _ground(torch.float32)
    for _ in range(n):
        dense, imp = tgc.coupled_substep_implicit(cfg, params, dense, geoms)
        acc_d = acc_d + imp
    close(tiled.x, dense.x, 1e-5)
    close(tiled.v, dense.v, 1e-3)
    assert float(acc_d.abs().max()) > 0
    close(acc_t, acc_d, 2e-3)
    assert int(tiled.dropped) == 0
