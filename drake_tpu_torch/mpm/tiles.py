"""The tile pipeline's resident substep on PyTorch + CUDA.

The PyTorch counterpart of ``drake_tpu/mpm/tiles.py``, built on the port's
own layouts and kernels, not on the TPU's (no tile slab, channel-major
planes, factorised weights or lane-roll halos; ROADMAP.md, "Not to port").
What it keeps are the reference's semantics:

- **The group's sort** (``sort_to_tiles``) fixes each lane's active blocks,
  the first A = ``max_active_blocks`` home blocks in ascending order (a
  particle's home block holds its base cell, clipped to [0, n-3]).
  Particles whose home block lies past A are held out for the whole group:
  they keep their state and add no mass, and their count enters
  ``dropped`` once.
- **Staleness.**  In each resident substep a particle is stale when its
  clipped base cell lies outside [4 home - 1, 4 home + 4] on some axis (the
  reference's 8^3 window about the home block).  A stale particle adds no
  mass and keeps x, v, F and C; it is counted in ``dropped`` in every
  substep in which it is stale.
- Every other particle gets exactly the dense MLS-MPM substep, with the
  B-spline weights taken from the clipped base as the reference takes them.
  On the card that substep is ``solver.blocked_substep``: one block sort,
  K2, K1 from block windows (with the node mass for a ``grid_op``), K3.

What differs from the reference, by design:

- **The sort runs every substep.**  K2 reads each block's rows in cell
  order, and K2 and K3 read 6^3 windows of each particle's current block,
  so the blocked substep sorts the live particles anew each time; the
  group's sort is bookkeeping (home blocks, held-out particles,
  staleness).  Its cost is not amortised as on the TPU.
- **The substep's own capacities.**  The blocked substep has an
  active-block capacity and ``block_capacity`` (pmax) that the tiles do not
  have.  ``sort_to_tiles`` sizes the first from the 27-block closure of the
  group's home blocks (every block a live particle can reach), which costs
  one host sync a group; pmax is the config's.  A particle the substep's
  sort leaves out all the same keeps its state and is counted in
  ``dropped``.

Every function takes leading lane axes: the particles ``(..., n, ...)``,
``dropped`` ``(...,)``; each lane has its own grid and its own group.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
from torch.profiler import record_function

from drake_tpu_torch.mpm import solver as mpm
from drake_tpu_torch.ops.mpm_kernels import device_constant
from drake_tpu_torch.utils.struct import static_field, tensor_dataclass

_NEIGHBOURS = tuple((i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1))


@tensor_dataclass
class SortedMpm:
    """The resident state of a group: the particles in their own order and
    what the group's sort fixed."""

    state: mpm.MpmState  # the particles, lanes leading: x (..., n, 3)
    home: torch.Tensor  # (..., n) int64 home block of each particle
    active: torch.Tensor  # (..., A) ascending home blocks, sentinel nblocks
    held: torch.Tensor  # (..., n) bool: home block past A, held out
    dropped: torch.Tensor  # (...,) int32 drops since the group's sort
    # Active-block capacity of each substep's sort: the largest lane's
    # closure of its home blocks.
    capacity: int = static_field()


def _grid_blocks(config):
    nx, ny, nz = config.grid_size
    if nx % 4 or ny % 4 or nz % 4:
        raise ValueError(f"grid dims must be multiples of 4, got {config.grid_size}")
    return nx // 4, ny // 4, nz // 4


def _clipped_base(config, x):
    """(..., n, 3) base cell floor(x / dx - 0.5), clipped to [0, n - 3]."""
    nx, ny, nz = config.grid_size
    base = torch.floor(x / config.dx - 0.5).long()
    hi = device_constant((nx - 3, ny - 3, nz - 3), torch.int64, x.device)
    return torch.minimum(base.clamp_min(0), hi)


def block_coords(config, blocks):
    """(..., 3) block coordinates of block ids (..., ) (the sentinel id
    nblocks lies past the grid along x)."""
    _, nby, nbz = _grid_blocks(config)
    return torch.stack([blocks // (nby * nbz), (blocks // nbz) % nby, blocks % nbz], dim=-1)


def stale_mask(config, x, home):
    """(..., n) bool: the particles whose clipped base cell lies outside
    [4 home - 1, 4 home + 4] on some axis (tiles.py:682-697's lb8 outside
    0..5)."""
    lb8 = _clipped_base(config, x) - 4 * block_coords(config, home) + 1
    return ((lb8 < 0) | (lb8 > 5)).any(dim=-1)


def closure(config, active):
    """The 27-block neighbourhood of each lane's active blocks (active
    (L, A), sentinel nblocks): (candidates (L, 27 A) ascending, with the
    sentinel for neighbours outside the grid, and the mask of each distinct
    block's first entry)."""
    nbx, nby, nbz = _grid_blocks(config)
    nblocks = nbx * nby * nbz
    c = block_coords(config, active)[..., None, :]  # (L, A, 1, 3)
    t = c + device_constant(_NEIGHBOURS, torch.int64, active.device)  # (L, A, 27, 3)
    lim = device_constant((nbx, nby, nbz), torch.int64, active.device)
    ok = ((t >= 0) & (t < lim)).all(dim=-1) & (active < nblocks)[..., None]
    ids = torch.where(ok, (t[..., 0] * nby + t[..., 1]) * nbz + t[..., 2], nblocks)
    cand = torch.sort(ids.reshape(active.shape[0], -1), dim=-1).values
    first = torch.ones_like(cand, dtype=torch.bool)
    first[:, 1:] = cand[:, 1:] != cand[:, :-1]
    return cand, first & (cand < nblocks)


def sort_to_tiles(config, state: mpm.MpmState) -> SortedMpm:
    """The group's sort (tiles.py:89): each particle's home block, each
    lane's first A home blocks ascending, the held-out particles past them
    (their count is the group's first ``dropped``), and the capacity of the
    substeps' sorts (one host sync)."""
    nbx, nby, nbz = _grid_blocks(config)
    nblocks = nbx * nby * nbz
    A = config.max_active_blocks
    lanes = state.x.shape[:-2]
    n = state.x.shape[-2]
    L = math.prod(lanes)
    dev = state.x.device
    base = _clipped_base(config, state.x.reshape(L, n, 3))
    home = ((base[..., 0] // 4) * nby + base[..., 1] // 4) * nbz + base[..., 2] // 4  # (L, n)
    # Each lane's distinct home blocks in ascending order: a block's rank is
    # the count of distinct smaller ones in its lane.
    key = home + torch.arange(L, device=dev)[:, None] * (nblocks + 1)
    key_s, perm = torch.sort(key.reshape(-1))
    first = torch.ones_like(key_s, dtype=torch.bool)
    first[1:] = key_s[1:] != key_s[:-1]
    rank = torch.cumsum(first, 0) - 1
    lane_s = key_s // (nblocks + 1)
    rank = rank - rank[lane_s * n]
    slot = torch.where(first & (rank < A), lane_s * A + rank, L * A)
    active = torch.full((L * A + 1,), nblocks, dtype=torch.int64, device=dev)
    active.scatter_(0, slot, key_s - lane_s * (nblocks + 1))
    active = active[:-1].reshape(L, A)
    held = torch.empty_like(first)
    held[perm] = rank >= A
    held = held.reshape(L, n)
    _, firsts = closure(config, active)
    capacity = max(1, min(nblocks, int(firsts.sum(dim=-1).max())))
    return SortedMpm(
        state=state, home=home.reshape(lanes + (n,)), active=active.reshape(lanes + (A,)),
        held=held.reshape(lanes + (n,)),
        dropped=held.sum(dim=-1).to(torch.int32).reshape(lanes), capacity=capacity,
    )


def tiles_to_state(sorted_state: SortedMpm, template: mpm.MpmState) -> mpm.MpmState:
    """The particles back in the template's state (tiles.py:177), with the
    group's ``dropped``.  Held-out particles were never touched, so they keep
    the template's state, as the reference's drop bucket does."""
    s = sorted_state.state
    return template.replace(x=s.x, v=s.v, F=s.F, C=s.C, dropped=sorted_state.dropped)


@record_function("tiles.substep")
def resident_substep(
    config,
    ss: SortedMpm,
    grid_op: Optional[Callable] = None,
    particle_force: Optional[torch.Tensor] = None,
) -> SortedMpm:
    """One MLS-MPM substep of the group (tiles.py:731): every particle that
    is neither held out nor stale takes the dense substep; the stale are
    counted.  ``grid_op(vel, mass) -> vel`` receives and returns each lane's
    dense fields, ([L,] nx, ny, nz, 3) and ([L,] nx, ny, nz);
    ``particle_force`` ([L,] n, 3) adds dt f to each particle's momentum
    before P2G."""
    stale = stale_mask(config, ss.state.x, ss.home) & ~ss.held
    return _substep(config, ss, ~ss.held & ~stale, stale, ss.capacity, grid_op,
                    particle_force)


def _substep(config, ss: SortedMpm, live, stale, capacity, grid_op, particle_force,
             extra_dropped=None):
    """``solver.blocked_substep`` over the live particles at the given
    active-block capacity; ``dropped`` gains the stale count, the substep
    sort's own drops and `extra_dropped`."""
    cfg = dataclasses.replace(config, max_active_blocks=capacity)
    out = mpm.blocked_substep(cfg, ss.state, live=live, clip_weights=True,
                              particle_force=particle_force, grid_op=grid_op)
    dropped = ss.dropped + stale.sum(dim=-1).to(torch.int32) + out.dropped
    if extra_dropped is not None:
        dropped = dropped + extra_dropped
    return ss.replace(state=out.replace(dropped=ss.state.dropped), dropped=dropped)


def tile_substep(config, state: mpm.MpmState, grid_op=None) -> mpm.MpmState:
    """One substep in the particles' order: sort, resident substep, unsort
    (tiles.py:822)."""
    ss = sort_to_tiles(config, state)
    ss = resident_substep(config, ss, grid_op=grid_op)
    return tiles_to_state(ss, state)


def simulate_tiled(config, state: mpm.MpmState, num_substeps: int,
                   resort_every: int = 8) -> mpm.MpmState:
    """A rollout of `num_substeps` substeps, the group's sort every
    `resort_every` (tiles.py:833): ``dropped`` is the sum over groups, and
    the remaining substeps are ``tile_substep``s."""
    groups, rem = divmod(num_substeps, resort_every)
    total = torch.zeros_like(state.dropped)
    for _ in range(groups):
        ss = sort_to_tiles(config, state)
        for _ in range(resort_every):
            ss = resident_substep(config, ss)
        state = tiles_to_state(ss, state)
        total = total + state.dropped
    for _ in range(rem):
        state = tile_substep(config, state)
        total = total + state.dropped
    return state.replace(dropped=total)
