"""Implicit grid contact on the tile pipeline, on PyTorch + CUDA.

The PyTorch counterpart of ``drake_tpu/mpm/tiles_contact.py``: the grid
contact Newton of ``mpm/grid_contact.py`` (UpdateContact,
multibody/gpu_mpm/cuda_mpm_solver.cu:215-621) solved on the 27-block
closure of each lane's active blocks only -- Ae * 64 nodes a lane in place
of the whole grid -- inside the resident substep of ``mpm/tiles.py``.

- **The closure** (``_extend_active``): each lane's active blocks and their
  26 neighbours, sorted, deduplicated, in ``ext_capacity`` slots.  P2G mass
  spills one node past a particle's block, so every node with mass is owned
  by a block of the closure, and every node is solved once.  Blocks past
  the capacity are counted in ``dropped`` in every substep; as in the
  reference, an active block past it is mapped to the closure's last slot
  (which is then its particles' home for the staleness test), and the
  nodes of the blocks past it are not solved and move the particles with
  velocity 0.
- **The Newton** is ``grid_contact.newton``, the dense solve's, on the
  closure's nodes: each particle's 27 taps are mapped to closure slots by a
  block -> slot search in each lane's sorted closure.  Only particles that
  are neither held out nor stale take part.  The options that only this
  solve reads: ``line_search_levels`` (1: one bracket level and the secant,
  2: two levels), ``unroll_iterations`` (every lane does exactly N
  iterations, and the loop asks the host nothing) and ``max_contact_rows``
  (the pair work on the contact rows only: 0 off, -1 auto, > 0 fixed;
  rows past it are counted in ``dropped``).
- On the card the substep around the solve is K2, K1 from block windows
  with the node mass, and K3 (``solver.blocked_substep``).

What differs from the reference, by design: the auto row capacity is
max(512, n // 8) of the lane's n particles (the reference takes its padded
slab rows), and rows past it are the last in particle order (the
reference's, in slab order).  The substep's sort takes the closure
capacity of ``tiles.sort_to_tiles`` plus 27 (the closure of the one block
that overflowing home blocks are mapped to), so that it leaves no live
particle out.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

from drake_tpu_torch.mpm import grid_contact as gc
from drake_tpu_torch.mpm import solver as mpm
from drake_tpu_torch.mpm import tiles
from drake_tpu_torch.mpm.coupling import RigidGeom
from drake_tpu_torch.mpm.grid_contact import GridContactParams, GridContactSolution
from drake_tpu_torch.ops.mpm_kernels import device_constant

_LOCAL = tuple((i, j, k) for i in range(4) for j in range(4) for k in range(4))


def _extend_active(config, active, ext_capacity: int):
    """The 27-neighbourhood closure of each lane's active blocks (active
    (..., A)), sorted, deduplicated, in ``ext_capacity`` slots (tiles_contact.py
    :117).  Returns (ext (..., Ae) ascending with the sentinel nblocks last,
    smap (..., A) each active slot's closure slot, over (...,) int32 the
    closure's blocks past the capacity)."""
    nbx, nby, nbz = tiles._grid_blocks(config)
    nblocks = nbx * nby * nbz
    lanes = active.shape[:-1]
    A = active.shape[-1]
    L = math.prod(lanes)
    flat = active.reshape(L, A)
    cand, first = tiles.closure(config, flat)
    slot = torch.cumsum(first, dim=-1) - 1
    over = torch.clamp_min(first.sum(dim=-1) - ext_capacity, 0).to(torch.int32)
    wslot = torch.where(first & (slot < ext_capacity), slot, ext_capacity)
    ext = torch.full((L, ext_capacity + 1), nblocks, dtype=torch.int64, device=active.device)
    ext.scatter_(1, wslot, cand)
    ext = ext[:, :-1].contiguous()
    smap = torch.searchsorted(ext, flat).clamp(0, ext_capacity - 1)
    return (ext.reshape(lanes + (ext_capacity,)), smap.reshape(lanes + (A,)),
            over.reshape(lanes))


def _closure_stencil(config, x, live, ext) -> gc._Stencil:
    """The 27 taps of rows x (L, rows, 3) into the closure's nodes (slot
    * 64 + the node's place in its 4^3 block), with the weights of the
    clipped base; rows that are not live, and taps on blocks outside the
    closure, weigh 0 and scatter into the drop row."""
    _, nby, nbz = tiles._grid_blocks(config)
    L, rows = x.shape[:2]
    Ae = ext.shape[-1]
    nodes = Ae * 64
    dev = x.device
    base = tiles._clipped_base(config, x)
    w = mpm._bspline_taps(x / config.dx - base.to(x.dtype))  # (L, rows, 3, 3)
    offsets = device_constant(mpm._STENCIL, torch.int64, dev)  # (27, 3)
    idx = base[..., None, :] + offsets  # (L, rows, 27, 3), inside the grid
    blk = ((idx[..., 0] // 4) * nby + idx[..., 1] // 4) * nbz + idx[..., 2] // 4
    slot = torch.searchsorted(ext, blk.reshape(L, rows * 27)).clamp(max=Ae - 1)
    ok = (torch.gather(ext, 1, slot) == blk.reshape(L, -1)).reshape(L, rows, 27)
    ok = ok & live[..., None]
    loc = idx % 4
    node = slot.reshape(L, rows, 27) * 64 + (loc[..., 0] * 16 + loc[..., 1] * 4 + loc[..., 2])
    weight = (
        w[..., 0, offsets[:, 0]] * w[..., 1, offsets[:, 1]] * w[..., 2, offsets[:, 2]]
    ) * ok.to(x.dtype)
    lane = torch.arange(L, device=dev).reshape(L, 1, 1) * nodes
    drop = torch.where(ok, node + lane, L * nodes).reshape(-1)
    return gc._Stencil(index=node.reshape(L, rows * 27), drop_index=drop, weight=weight,
                       weight_sq=weight**2, nodes=nodes,
                       plan=mpm.scatter_plan(drop, L * nodes + 1))


def _contact_rows(params: GridContactParams, x, live, phi0, n_pg, v_g, active0):
    """The contact-row compaction (tiles_contact.py:210-239): with
    ``max_contact_rows`` != 0, the first C rows in particle order with a
    candidate pair, C = ``max_contact_rows`` or, at -1, max(512, n // 8),
    at most n.  Returns the rows' (x, live, phi0, n_pg, v_g, active0) and
    the count of contact rows past C (L,) int32."""
    L, n = x.shape[:2]
    if params.max_contact_rows == 0:
        return (x, live, phi0, n_pg, v_g, active0), torch.zeros(
            L, dtype=torch.int32, device=x.device)
    act_any = active0.any(dim=1)  # (L, n)
    cap = params.max_contact_rows if params.max_contact_rows > 0 else max(512, n // 8)
    cap = min(cap, n)
    rows = torch.sort((~act_any).to(torch.int8), dim=1, stable=True).indices[:, :cap]
    valid = torch.gather(act_any, 1, rows)
    over = torch.clamp_min(act_any.sum(dim=1) - cap, 0).to(torch.int32)
    G = phi0.shape[1]

    def take(t):  # (L, G, n, ...) -> (L, G, cap, ...)
        r = rows[:, None].expand(L, G, cap)
        if t.dim() == 4:
            return torch.gather(t, 2, r[..., None].expand(L, G, cap, t.shape[-1]))
        return torch.gather(t, 2, r)

    x_c = torch.gather(x, 1, rows[..., None].expand(L, cap, 3))
    live_c = torch.gather(live, 1, rows) & valid
    return (x_c, live_c, take(phi0), take(n_pg), take(v_g),
            take(active0) & valid[:, None]), over


def solve_contact_tiles(
    config: mpm.MpmConfig,
    params: GridContactParams,
    x: torch.Tensor,
    live: torch.Tensor,
    ext: torch.Tensor,
    grid_mass: torch.Tensor,
    grid_vel: torch.Tensor,
    geoms: Sequence[RigidGeom],
) -> Tuple[GridContactSolution, torch.Tensor]:
    """The grid contact Newton on the closure's nodes (tiles_contact.py:161)
    of every lane: x (..., n, 3) and ``live`` (..., n) the particles, ext
    (..., Ae) the closure, grid_mass (..., nx, ny, nz) and grid_vel (...,
    nx, ny, nz, 3) the free-motion grid.  Returns (the solution, its
    ``grid_vel`` the solved closure nodes with 0 elsewhere, and the contact
    rows past the compaction's capacity (...,) int32)."""
    nx, ny, nz = config.grid_size
    nbx, nby, nbz = tiles._grid_blocks(config)
    lanes = x.shape[:-2]
    L = math.prod(lanes)
    n = x.shape[-2]
    Ae = ext.shape[-1]
    dense = nx * ny * nz
    dev = x.device
    dtype = grid_vel.dtype
    ext = ext.reshape(L, Ae)

    # The closure's nodes, their dense index (the extra row for sentinel
    # slots) and whether they lie off the walls.
    c = 4 * tiles.block_coords(config, ext)[..., None, :] + device_constant(
        _LOCAL, torch.int64, dev)  # (L, Ae, 64, 3)
    real = (ext < nbx * nby * nbz)[..., None]
    flat = torch.where(real, (c[..., 0] * ny + c[..., 1]) * nz + c[..., 2], dense).reshape(L, -1)
    ww = config.wall_width
    lim = device_constant((nx, ny, nz), torch.int64, dev)
    inside = (((c >= ww) & (c < lim - ww)).all(dim=-1) & real).reshape(L, -1)
    mass = torch.cat([grid_mass.reshape(L, dense), grid_mass.new_zeros(L, 1)], dim=1)
    mass = torch.gather(mass, 1, flat)
    vel = torch.cat([grid_vel.reshape(L, dense, 3), grid_vel.new_zeros(L, 1, 3)], dim=1)
    v_star = torch.gather(vel, 1, flat[..., None].expand(L, Ae * 64, 3))

    x = x.reshape(L, n, 3)
    live = live.reshape(L, n)
    phi0, n_pg, v_g = gc.pair_quantities(x, geoms, lanes)
    active0 = (phi0 < params.margin) & live[:, None]
    (x, live, phi0, n_pg, v_g, active0), over_rows = _contact_rows(
        params, x, live, phi0, n_pg, v_g, active0)
    st = _closure_stencil(config, x, live, ext)
    v, it, res = gc.newton(
        params, config.dt, st, mass, v_star, inside, phi0, n_pg, v_g, active0,
        line_search_levels=params.line_search_levels,
        unroll_iterations=params.unroll_iterations,
    )
    out = torch.zeros((L, dense + 1, 3), dtype=dtype, device=dev)
    out.scatter_(1, flat[..., None].expand(L, Ae * 64, 3), v)
    sol = GridContactSolution(
        grid_vel=out[:, :-1].reshape(lanes + (nx, ny, nz, 3)),
        impulses=gc.impulses(params, config.dt, st, v, phi0, n_pg, v_g, active0, x, geoms,
                             lanes),
        iterations=it.reshape(lanes),
        residual=res.reshape(lanes),
    )
    if gc._LOG is not None:
        gc._LOG.append(sol._replace(grid_vel=None))
    return sol, over_rows.reshape(lanes)


@record_function("tiles.substep")
def resident_substep_contact(
    config: mpm.MpmConfig,
    params: GridContactParams,
    ss: tiles.SortedMpm,
    geoms: Sequence[RigidGeom],
    particle_force: Optional[torch.Tensor] = None,
    ext_capacity: Optional[int] = None,
) -> Tuple[tiles.SortedMpm, torch.Tensor]:
    """One resident substep with the implicit grid contact on the closure
    (tiles_contact.py:412): P2G -> grid update -> contact Newton -> G2P.
    ``ext_capacity`` defaults to ``params.ext_capacity_factor *
    max_active_blocks``.  Returns (the sorted state, whose ``dropped`` gains
    the stale particles, the closure's blocks past its capacity and the
    contact rows past the compaction's; the rigid spatial impulses (...,
    n_geoms, 6))."""
    nbx, nby, nbz = tiles._grid_blocks(config)
    A = config.max_active_blocks
    if ext_capacity is None:
        ext_capacity = params.ext_capacity_factor * A
    ext, smap, over = _extend_active(config, ss.active, ext_capacity)
    # Each particle's home in the closure: its active slot's closure block.
    a_slot = torch.searchsorted(ss.active, ss.home).clamp(max=A - 1)
    home = torch.gather(ext, -1, torch.gather(smap, -1, a_slot))
    stale = tiles.stale_mask(config, ss.state.x, home) & ~ss.held
    live = ~ss.held & ~stale
    capacity = min(nbx * nby * nbz, ss.capacity + 27)
    lanes = ss.state.x.shape[:-2]
    if len(geoms) == 0:
        out = tiles._substep(config, ss, live, stale, capacity, None, particle_force, over)
        return out, ss.state.x.new_zeros(lanes + (0, 6))

    solved = {}

    def grid_op(vel, mass):
        solved["sol"], solved["over_rows"] = solve_contact_tiles(
            config, params, ss.state.x, live, ext, mass, vel, geoms)
        return solved["sol"].grid_vel

    out = tiles._substep(config, ss, live, stale, capacity, grid_op, particle_force, over)
    out = out.replace(dropped=out.dropped + solved["over_rows"])
    return out, solved["sol"].impulses
