"""MLS-MPM: particle-grid transfers and grid dynamics on PyTorch + CUDA.

Counterpart of drake_tpu/mpm/solver.py, function for function; the fork's
GPU pipeline it re-derives is multibody/gpu_mpm/cuda_mpm_solver.cu
(RebuildMapping, ParticleToGrid, UpdateGrid, GridToParticle).

- Dense background grid, quadratic B-spline weights, APIC/MLS-MPM transfers
  with the fused force B = -dt 4/dx^2 V0 P F^T + m C.
- P2G and grid update (``grid_velocity``, and ``grid_velocity_and_mass``
  with the node mass for the implicit grid contact): on CUDA the blocked
  path -- sort by 4^3-cell block, fixed-size active-block compaction, the
  K2 kernel per block, then K1 from K2's block windows (halo combine,
  B (x_node - o) and the update in one kernel, no dense grid); on the CPU the
  direct ``index_add_`` scatter and the plain grid update.  ``particle_to_grid``
  and ``update_grid`` (the dense K1) keep the dense grid between them.
- G2P: the 27-tap stencil gather in plain torch, or, in the fused
  ``blocked_substep`` (``mpm_substep_blocked`` and the tile pipeline of
  ``mpm/tiles.py``), the K3 kernel over the same block sort, one output row
  per sorted row, and one gather back to particle order.

The substep makes no host sync: capacities are static (``MpmConfig``), the
active-block compaction has a fixed size, and ``dropped`` stays a device
tensor.  ``MpmConfig.xla_only`` is the explicit switch to the plain versions
on the card; it is never set automatically.

Lanes: the transfers (``particle_to_grid`` and both its paths,
``update_grid``, ``grid_to_particle``) also take L independent states at
once -- ``MpmState`` fields ``(L, n, ...)``, ``GridState`` fields
``(L, nx, ny, nz, ...)`` and ``dropped`` ``(L,)`` -- as the JAX package
takes them under ``vmap``.  Every lane has its own grid: the lane enters the
flat node index and the block sort key, never the particle positions, so one
lane's stencil cannot reach another lane's nodes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from drake_tpu_torch.ops import mpm_kernels
from drake_tpu_torch.ops.mpm_kernels import P2G_NODES, device_constant
from drake_tpu_torch.utils.device import resolve_device
from drake_tpu_torch.utils.struct import tensor_dataclass


@dataclasses.dataclass(frozen=True)
class MpmConfig:
    """Mirror of the fork's MpmConfigParams + settings.h compile-time config
    (same fields as drake_tpu.mpm.solver.MpmConfig)."""

    grid_size: Tuple[int, int, int] = (64, 64, 64)
    dx: float = 1.0 / 64.0
    dt: float = 1e-4
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    # Fixed-corotated material.
    youngs_modulus: float = 4e5
    poisson_ratio: float = 0.3
    density: float = 1000.0
    # Domain-wall boundary: sticky walls this many cells thick.
    wall_width: int = 3
    # Blocked-path static capacities (4^3-cell blocks): at most
    # max_active_blocks touched blocks and block_capacity particles per
    # block.  Overflow is reported in MpmState.dropped / GridState.dropped;
    # size with `capacities_for(num_particles)`.
    max_active_blocks: int = 256
    block_capacity: int = 512
    # Plain PyTorch versions instead of the CUDA kernels (scatter P2G, plain
    # grid update and blocked transfers).  The CPU always takes them.
    xla_only: bool = False

    def capacities_for(self, num_particles: int, particles_per_cell: int = 8):
        """Config copy with capacities sized for `num_particles` (assumes
        near-dense seeding at `particles_per_cell`).

        block_capacity gets 25% headroom over the dense 64-cells-per-block
        count, because the base cell floor(x/dx - 0.5) shifts particles of a
        block's lowest half-cell into the previous block.  max_active_blocks
        is 4x the dense occupied-block count, rounded up to a power of two
        and capped at 8192; the blocked transfers' cost is linear in it."""
        dense_blocks = num_particles // (64 * particles_per_cell)
        blocks_needed = max(64, 4 * dense_blocks)
        a = 1
        while a < blocks_needed:
            a *= 2
        dense = 64 * particles_per_cell
        cap = ((dense + dense // 4 + 127) // 128) * 128
        return dataclasses.replace(
            self, max_active_blocks=min(a, 8192),
            block_capacity=max(cap, self.block_capacity),
        )

    @property
    def lame(self):
        E, nu = self.youngs_modulus, self.poisson_ratio
        mu = E / (2 * (1 + nu))
        lam = E * nu / ((1 + nu) * (1 - 2 * nu))
        return mu, lam


@tensor_dataclass
class MpmState:
    """Particle state (SoA, like GpuMpmState's particle buffers)."""

    # Each field may lead with a lane axis L: x (L, n, 3), dropped (L,).
    x: torch.Tensor  # (n, 3) positions
    v: torch.Tensor  # (n, 3) velocities
    F: torch.Tensor  # (n, 3, 3) deformation gradient
    C: torch.Tensor  # (n, 3, 3) APIC affine velocity field
    volume: torch.Tensor  # (n,) initial volume
    mass: torch.Tensor  # (n,)
    # Particles dropped by the blocked path's static capacities in the LAST
    # substep (int32 tensor on the state's device, one per lane); nonzero
    # means the capacities are undersized.  Left out, it is zero.
    dropped: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.dropped is None:
            zero = torch.zeros(self.x.shape[:-2], dtype=torch.int32, device=self.x.device)
            object.__setattr__(self, "dropped", zero)


def make_particle_block(
    config: MpmConfig,
    lower: Tuple[float, float, float],
    upper: Tuple[float, float, float],
    particles_per_cell: int = 8,
    dtype: torch.dtype = torch.float32,
    jitter_seed: Optional[int] = 0,
    device: Union[str, torch.device, None] = None,
) -> MpmState:
    """Fill an axis-aligned box with particles (the sample initializer).

    The state lies on `device`; ``None`` is the current CUDA device (an error
    without one), ``"cpu"`` the CPU.  The positions are made in float64 by
    numpy exactly as the JAX package makes them (same
    `default_rng(jitter_seed)` draws), then cast once, so both packages start
    from bit-identical particles."""
    device = resolve_device(device)
    lower = np.asarray(lower)
    upper = np.asarray(upper)
    spacing = config.dx / round(particles_per_cell ** (1 / 3))
    axes = [np.arange(lo + spacing / 2, hi, spacing) for lo, hi in zip(lower, upper)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    if jitter_seed is not None:
        rng = np.random.default_rng(jitter_seed)
        pts = pts + rng.uniform(-0.2, 0.2, pts.shape) * spacing
    n = pts.shape[0]
    vol = spacing**3
    mass = config.density * vol
    kw = dict(dtype=dtype, device=device)
    return MpmState(
        x=torch.as_tensor(pts, **kw),
        v=torch.zeros((n, 3), **kw),
        F=torch.eye(3, **kw).expand(n, 3, 3).contiguous(),
        C=torch.zeros((n, 3, 3), **kw),
        volume=torch.full((n,), vol, **kw),
        mass=torch.full((n,), mass, **kw),
        dropped=torch.zeros((), dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# Quadratic B-spline stencil.
# ---------------------------------------------------------------------------


def _bspline_weights(xp, dx):
    """Quadratic B-spline weights over the 3-cell stencil per axis.

    Returns (base (n,3) int64, w (n,3,3)): w[:, axis, k] is the weight of
    grid node base+k along `axis`."""
    inv_dx = 1.0 / dx
    pos = xp * inv_dx
    base = torch.floor(pos - 0.5).long()
    return base, _bspline_taps(pos - base.to(xp.dtype))


def _bspline_taps(fx):
    """The three taps' weights of each axis at offset fx = x / dx - base (in
    [0.5, 1.5] for the unclipped base): (..., 3 axes, 3 taps)."""
    w0 = 0.5 * (1.5 - fx) ** 2
    w1 = 0.75 - (fx - 1.0) ** 2
    w2 = 0.5 * (fx - 0.5) ** 2
    return torch.stack([w0, w1, w2], dim=-1)


_STENCIL = tuple((i, j, k) for i in range(3) for j in range(3) for k in range(3))


def _stencil_iter():
    """The 27 stencil offsets (i, j, k), k fastest: the reference's order."""
    return iter(_STENCIL)


# ---------------------------------------------------------------------------
# Constitutive model: fixed corotated (via Newton polar decomposition).
# ---------------------------------------------------------------------------


def _det3(A):
    """Closed-form batched 3x3 determinant."""
    return (
        A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
        - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
        + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0])
    )


def _inv3(A, eps=1e-12):
    """Closed-form (adjugate) batched 3x3 inverse; the determinant is pushed
    away from zero by a signed `eps`."""
    c00 = A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1]
    c01 = A[..., 0, 2] * A[..., 2, 1] - A[..., 0, 1] * A[..., 2, 2]
    c02 = A[..., 0, 1] * A[..., 1, 2] - A[..., 0, 2] * A[..., 1, 1]
    c10 = A[..., 1, 2] * A[..., 2, 0] - A[..., 1, 0] * A[..., 2, 2]
    c11 = A[..., 0, 0] * A[..., 2, 2] - A[..., 0, 2] * A[..., 2, 0]
    c12 = A[..., 0, 2] * A[..., 1, 0] - A[..., 0, 0] * A[..., 1, 2]
    c20 = A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]
    c21 = A[..., 0, 1] * A[..., 2, 0] - A[..., 0, 0] * A[..., 2, 1]
    c22 = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    adj = torch.stack(
        [
            torch.stack([c00, c01, c02], dim=-1),
            torch.stack([c10, c11, c12], dim=-1),
            torch.stack([c20, c21, c22], dim=-1),
        ],
        dim=-2,
    )
    det = _det3(A)
    return adj / torch.where(det >= 0, det + eps, det - eps)[..., None, None]


def _polar_rotation(F, iters: int = 8):
    """Rotation factor of F by Newton iteration R <- (R + R^-T)/2."""
    R = F
    for _ in range(iters):
        R = 0.5 * (R + _inv3(R).transpose(-1, -2))
    return R


def fixed_corotated_stress(F, mu, lam):
    """First Piola-Kirchhoff stress P = 2 mu (F - R) + lam (J - 1) J F^-T."""
    R = _polar_rotation(F)
    J = _det3(F)
    F_inv_T = _inv3(F).transpose(-1, -2)
    return 2.0 * mu * (F - R) + (lam * (J - 1.0) * J)[..., None, None] * F_inv_T


# ---------------------------------------------------------------------------
# The MLS-MPM substep.
# ---------------------------------------------------------------------------


class ScatterPlan(NamedTuple):
    """A fixed summation order for a scatter-add into `size` rows: the
    sources sorted stably by destination, and where each destination's run
    starts.  ``index_add_`` on the card sums with atomics, in no fixed
    order, so that two runs of the same program differ in the last bits;
    ``scatter_sum`` sums each destination's sources one after another in
    source order (on the CPU, ``index_add_``'s own order)."""

    order: torch.Tensor  # (N,) stable argsort of the destinations
    offsets: torch.Tensor  # (size + 1,) start of each destination's run in `order`


def scatter_plan(index, size: int) -> ScatterPlan:
    """The plan of a scatter of sources (N,) to the rows `index` (N,) of
    [0, size), made once for every scatter through the same index."""
    order = torch.argsort(index, stable=True)
    rows = torch.arange(size + 1, dtype=index.dtype, device=index.device)
    return ScatterPlan(order=order, offsets=torch.searchsorted(index[order], rows))


def scatter_sum(plan: ScatterPlan, values):
    """sum of values (N, ...) per destination: (size, ...), zero where
    nothing lands; bit for bit the same in every run."""
    return torch.segment_reduce(values[plan.order], "sum", offsets=plan.offsets, axis=0,
                                unsafe=True)


class GridState(NamedTuple):
    mass: torch.Tensor  # (nx, ny, nz), or (L, nx, ny, nz) over lanes
    momentum: torch.Tensor  # (nx, ny, nz, 3), or (L, nx, ny, nz, 3)
    # Particles dropped by static block capacities this transfer (int32
    # tensor, () or (L,); zero on the scatter path).
    dropped: Union[torch.Tensor, int] = 0


def _lane_offsets(lanes: Tuple[int, ...], stride: int, device, trailing: int):
    """Lane l's offset l * stride into a flat index over all lanes, shaped
    `lanes` plus `trailing` singleton axes; None for a single state."""
    if not lanes:
        return None
    off = torch.arange(math.prod(lanes), device=device) * stride
    return off.reshape(lanes + (1,) * trailing)


def particle_to_grid(config: MpmConfig, state: MpmState) -> GridState:
    """APIC P2G with the MLS-MPM fused force.

    Device dispatch: CUDA tensors take the blocked path (K2); CPU tensors,
    or ``config.xla_only``, the direct scatter."""
    if config.xla_only or state.x.device.type == "cpu":
        return particle_to_grid_scatter(config, state)
    return particle_to_grid_blocked(config, state)


def _p2g_affine(config: MpmConfig, state: MpmState):
    """Fused APIC+stress affine matrix B = -dt 4/dx^2 V0 P F^T + m C."""
    mu, lam = config.lame
    P = fixed_corotated_stress(state.F, mu, lam)
    stress_B = (-config.dt * 4.0 / config.dx**2) * state.volume[..., None, None] * (
        P @ state.F.transpose(-1, -2)
    )
    return stress_B + state.mass[..., None, None] * state.C


class BlockSort(NamedTuple):
    """The block sort shared by the blocked P2G and G2P.  Over L lanes the
    rows of all lanes form one sorted table (lane slowest), and the block
    fields lead with the lane axis."""

    packed: torch.Tensor  # (L n, 40) rows sorted by (lane, block, cell in block)
    perm: torch.Tensor  # (L n,) sorted row -> flat particle index
    bid: torch.Tensor  # ([L,] n) block id of each particle (unsorted order)
    active: torch.Tensor  # ([L,] A) ascending block ids, sentinel nblocks last
    starts: torch.Tensor  # ([L,] A) int32 first sorted row of each block
    counts: torch.Tensor  # ([L,] A) int32 rows of each block taken (<= PMAX)
    dropped: torch.Tensor  # ([L]) int32 particles left out by the capacities


def sort_particles(
    config: MpmConfig,
    state: MpmState,
    live: Optional[torch.Tensor] = None,
    clip_weights: bool = False,
    particle_force: Optional[torch.Tensor] = None,
) -> BlockSort:
    """Pack each particle's P2G/G2P inputs into one 40-column row, sort the
    rows by 4^3-cell block and, within a block, by base cell (x slowest, z
    fastest), and compact the active blocks to a fixed size (the
    RebuildMapping + touched-block compaction role).

    On the blocked paths the base cell is clipped to n-3 per axis (so the
    6^3 window stays in the grid) while the weights come from the unclipped
    base; with ``clip_weights`` they come from the clipped base, as the
    tile pipeline takes them (``drake_tpu/mpm/tiles.py:669-677``).

    ``live`` ([L,] n) bool, if given, leaves the other particles out of
    every block: their rows sort to the end of their lane, under the lane's
    sentinel block id, and ``dropped`` counts only live particles.
    ``particle_force`` ([L,] n, 3) adds dt f to each particle's momentum.

    Over L lanes the key leads with the lane, and each lane keeps its own
    first A distinct blocks: block ids and ``dropped`` are per lane, and
    ``starts`` index the one sorted table of all lanes' rows."""
    dx = config.dx
    dtype = state.x.dtype
    dev = state.x.device
    lanes = state.x.shape[:-2]
    L = math.prod(lanes)
    n = state.x.shape[-2]
    N = L * n
    nx, ny, nz = config.grid_size
    if nx % 4 or ny % 4 or nz % 4:
        raise ValueError(f"grid dims must be multiples of 4, got {config.grid_size}")
    nby, nbz = ny // 4, nz // 4
    nblocks = (nx // 4) * nby * nbz
    A = config.max_active_blocks
    PMAX = config.block_capacity

    affine = _p2g_affine(config, state).reshape(N, 3, 3)
    x = state.x.reshape(N, 3)
    mass = state.mass.reshape(N)
    base, w = _bspline_weights(x, dx)
    hi = device_constant((nx - 3, ny - 3, nz - 3), torch.int64, dev)
    base = torch.minimum(base.clamp_min(0), hi)
    if clip_weights:
        w = _bspline_taps(x / dx - base.to(dtype))
    bxyz = base // 4
    # u = m v + B (x_node - x_p) split into u0 = m v - B (x_p - o) and
    # + B (x_node - o), about the origin o of the particle's block: the
    # offsets are under 6 dx, so that in float32 no rounding of B x at
    # |x| ~ 1 cancels between the two (mpm_kernels, the packed row).
    origin = (4 * bxyz).to(dtype) * dx
    u0 = mass[:, None] * state.v.reshape(N, 3) - torch.einsum("nij,nj->ni", affine, x - origin)
    if particle_force is not None:
        u0 = u0 + config.dt * particle_force.reshape(N, 3)
    lb_local = base - 4 * bxyz  # 0..3
    # Sort key: (lane * (nblocks + 1) + block id) * 64 + cell in block
    # (lx * 16 + ly * 4 + lz).  The lane stride leaves each lane's sentinel
    # block id nblocks free of particles.
    radix = device_constant(
        (64 * nby * nbz, 64 * nbz, 64, 16, 4, 1), torch.int64, dev
    )
    key = (torch.cat([bxyz, lb_local], dim=1) * radix).sum(dim=1)
    if live is not None:
        key = torch.where(live.reshape(N), key, nblocks * 64)
    bid = key >> 6
    key = key + (torch.arange(N, device=dev) // n) * (64 * (nblocks + 1))

    packed = torch.cat(
        [
            mass[:, None], u0, affine.reshape(N, 9),
            torch.zeros((N, 3), dtype=dtype, device=dev),
            w.reshape(N, 9), lb_local.to(dtype), x, state.F.reshape(N, 9),
        ],
        dim=1,
    )
    # Blocks stay contiguous runs in ascending order.  Within a block the
    # cell order makes each cell one run of rows and each x-slab of cells one
    # run of runs, which K2 stages and walks, and gives K3's neighbouring
    # threads the same window nodes; a stable sort makes the order
    # reproducible.
    key_s, perm = torch.sort(key, stable=True)
    gid_s = key_s >> 6  # lane * (nblocks + 1) + block id
    packed_s = packed[perm]

    # Fixed-size compaction (jnp.unique(size=A, fill_value=nblocks)) per
    # lane: the first A distinct block ids of the lane in ascending order,
    # then the sentinel.
    first = torch.ones(N, dtype=torch.bool, device=dev)
    first[1:] = gid_s[1:] != gid_s[:-1]
    # Rank within the lane: lane l holds the sorted rows [l n, (l+1) n).
    rank = torch.cumsum(first, 0) - 1
    lane_s = gid_s // (nblocks + 1)
    rank = rank - rank[lane_s * n]
    slot = torch.where(first & (rank < A), lane_s * A + rank, L * A)
    active = torch.full((L * A + 1,), nblocks, dtype=gid_s.dtype, device=dev)
    active.scatter_(0, slot, gid_s - lane_s * (nblocks + 1))
    active = active[: L * A]
    active_g = active + (torch.arange(L * A, device=dev) // A) * (nblocks + 1)
    starts = torch.searchsorted(gid_s, active_g, right=False)
    ends = torch.searchsorted(gid_s, active_g, right=True)
    counts = torch.clamp(ends - starts, max=PMAX)
    # Sentinel entries cover no particle.
    counts = torch.where(active < nblocks, counts, 0)
    taken = counts.reshape(L, A).sum(dim=1)
    n_live = n if live is None else live.reshape(L, n).sum(dim=1)
    dropped = (n_live - taken).to(torch.int32)
    return BlockSort(
        packed=packed_s, perm=perm, bid=bid.reshape(lanes + (n,)),
        active=active.reshape(lanes + (A,)),
        starts=starts.to(torch.int32).reshape(lanes + (A,)),
        counts=counts.to(torch.int32).reshape(lanes + (A,)),
        dropped=dropped.reshape(lanes),
    )


def window_node_pos(config: MpmConfig, active, dtype):
    """(..., A, 216, 3) world positions of each active block's 6^3 window
    nodes, node l = (i*6+j)*6+k at grid index 4*block + (i, j, k)."""
    return mpm_kernels.window_node_pos(config.grid_size, config.dx, active, dtype)


def _grid_from_blocks(config: MpmConfig, sort: BlockSort, out) -> GridState:
    """The dense grid of each lane from the K2 output ([L,] A, 16, 216)
    (``mpm_kernels.grid_from_blocks_reference``)."""
    mass, momentum = mpm_kernels.grid_from_blocks_reference(
        out, sort.active, config.grid_size, config.dx
    )
    return GridState(mass=mass, momentum=momentum, dropped=sort.dropped)


def _velocity_from_blocks(config: MpmConfig, sort: BlockSort, with_mass: bool = False):
    """K2 over the block sort, then K1 from its block windows: the grid
    velocity ([L,] nx, ny, nz, 3) with no dense grid in between; with
    ``with_mass``, (velocity, node mass ([L,] nx, ny, nz)) from the same
    launch."""
    out = mpm_kernels.p2g_block(
        sort.packed, sort.starts, sort.counts, config.block_capacity,
        plain=config.xla_only,
    )
    return mpm_kernels.update_grid_blocks(
        out, sort.active, config.grid_size, config.dx, config.dt, config.gravity,
        config.wall_width, plain=config.xla_only, with_mass=with_mass,
    )


def particle_to_grid_blocked(config: MpmConfig, state: MpmState) -> GridState:
    """Scatter-free P2G: block sort, K2 per active block, halo combine.

    Particles beyond config.block_capacity in a block (its last ones in cell
    order), or outside the first config.max_active_blocks blocks, are dropped
    and counted."""
    sort = sort_particles(config, state)
    out = mpm_kernels.p2g_block(
        sort.packed, sort.starts, sort.counts, config.block_capacity,
        plain=config.xla_only,
    )
    return _grid_from_blocks(config, sort, out)


def particle_to_grid_scatter(config: MpmConfig, state: MpmState) -> GridState:
    """Direct scatter-add P2G (the oracle): the 27-tap stencil summed into a
    flat grid (each lane's after the one before) with one extra bucket for
    out-of-domain taps, in a fixed order (``scatter_sum``)."""
    dx = config.dx
    dtype = state.x.dtype
    dev = state.x.device
    nx, ny, nz = config.grid_size
    lanes = state.x.shape[:-2]
    nodes = nx * ny * nz
    size = math.prod(lanes) * nodes + 1

    affine = _p2g_affine(config, state)
    base, w = _bspline_weights(state.x, dx)
    offsets = device_constant(_STENCIL, torch.int64, dev)  # (27, 3)
    idx = base[..., None, :] + offsets  # (..., n, 27, 3)
    weight = (
        w[..., 0, offsets[:, 0]] * w[..., 1, offsets[:, 1]] * w[..., 2, offsets[:, 2]]
    )  # (..., n, 27)
    dpos = (idx.to(dtype) - state.x[..., None, :] / dx) * dx  # (..., n, 27, 3)
    mom = weight[..., None] * (
        (state.mass[..., None] * state.v)[..., None, :]
        + torch.einsum("...ij,...tj->...ti", affine, dpos)
    )  # (..., n, 27, 3)
    m_scatter = weight * state.mass[..., None]  # (..., n, 27)

    flat = (idx[..., 0] * ny + idx[..., 1]) * nz + idx[..., 2]  # (..., n, 27)
    in_bounds = (
        (idx[..., 0] >= 0) & (idx[..., 0] < nx)
        & (idx[..., 1] >= 0) & (idx[..., 1] < ny)
        & (idx[..., 2] >= 0) & (idx[..., 2] < nz)
    )
    off = _lane_offsets(lanes, nodes, dev, 2)
    if off is not None:
        flat = flat + off
    flat = torch.where(in_bounds, flat, size - 1).reshape(-1)
    grid = scatter_sum(scatter_plan(flat, size),
                       torch.cat([m_scatter.reshape(-1, 1), mom.reshape(-1, 3)], dim=1))
    return GridState(
        mass=grid[:-1, 0].reshape(lanes + (nx, ny, nz)),
        momentum=grid[:-1, 1:].reshape(lanes + (nx, ny, nz, 3)),
        dropped=torch.zeros(lanes, dtype=torch.int32, device=dev),
    )


def update_grid(config: MpmConfig, grid: GridState) -> torch.Tensor:
    """Momentum -> velocity, gravity (active nodes), domain-wall BCs, through
    K1 on CUDA.  Returns grid velocities ([L,] nx, ny, nz, 3)."""
    mom = grid.momentum.movedim(-1, -4).contiguous()  # ([L,] 3, nx, ny, nz)
    vel = mpm_kernels.update_grid(
        grid.mass.contiguous(), mom, config.dt, config.gravity, config.wall_width,
        plain=config.xla_only,
    )
    return vel.movedim(-4, -1)


def grid_to_particle(
    config: MpmConfig, state: MpmState, grid_vel: torch.Tensor
) -> MpmState:
    """G2P gather: new particle velocity, APIC C, F update, advection.

    C = 4/dx^2 sum_i w_i v_i dpos_i^T, F <- (I + dt C) F, x <- x + dt v.
    Over lanes, each lane gathers from its own grid ``grid_vel[l]``."""
    dx, dt = config.dx, config.dt
    dtype = state.x.dtype
    dev = state.x.device
    nx, ny, nz = config.grid_size
    base, w = _bspline_weights(state.x, dx)
    flat_vel = grid_vel.reshape(-1, 3)
    off = _lane_offsets(state.x.shape[:-2], nx * ny * nz, dev, 1)

    v_new = torch.zeros_like(state.v)
    C_new = torch.zeros_like(state.C)
    hi = device_constant((nx - 1, ny - 1, nz - 1), torch.int64, dev)
    offsets = device_constant(_STENCIL, torch.int64, dev)
    for t, (i, j, k) in enumerate(_STENCIL):
        idx = base + offsets[t]
        # Mask out-of-domain taps (negative indices would wrap); gather with
        # clamped indices.
        valid = ((idx >= 0) & (idx <= hi)).all(dim=-1)
        idx_c = torch.minimum(idx.clamp_min(0), hi)
        weight = w[..., 0, i] * w[..., 1, j] * w[..., 2, k] * valid.to(dtype)
        dpos = (idx.to(dtype) - state.x / dx) * dx
        flat = (idx_c[..., 0] * ny + idx_c[..., 1]) * nz + idx_c[..., 2]
        vi = flat_vel[flat if off is None else flat + off]
        v_new = v_new + weight[..., None] * vi
        C_new = C_new + (4.0 / dx**2) * weight[..., None, None] * (
            vi[..., :, None] * dpos[..., None, :]
        )

    F_new = (torch.eye(3, dtype=dtype, device=dev) + dt * C_new) @ state.F
    x_new = state.x + dt * v_new
    return state.replace(x=x_new, v=v_new, F=F_new, C=C_new)


def block_velocity_windows(config: MpmConfig, grid_vel, active, node_pos):
    """K3's input: each active block's 216-node velocity window, extended
    with v * node channels so that one contraction yields both v_p and
    sum_l w v n^T.  grid_vel ([L,] nx, ny, nz, 3), active and node_pos as
    ``window_node_pos`` makes them.  Returns ([L,] A, 216, 12) [v, v n_x,
    v n_y, v n_z], gathered for the active blocks only; window nodes past the
    grid's upper faces, and sentinel entries, get zero."""
    nx, ny, nz = config.grid_size
    lanes = tuple(active.shape[:-1])
    A = active.shape[-1]
    nodes = nx * ny * nz
    idx = mpm_kernels.window_node_index(config.grid_size, active)  # (..., A, 216, 3)
    inside = (idx[..., 0] < nx) & (idx[..., 1] < ny) & (idx[..., 2] < nz)
    flat = torch.where(inside, (idx[..., 0] * ny + idx[..., 1]) * nz + idx[..., 2], nodes)
    field = torch.cat(
        [grid_vel.reshape(lanes + (nodes, 3)), grid_vel.new_zeros(lanes + (1, 3))], dim=-2
    )
    flat = flat.reshape(lanes + (A * P2G_NODES, 1)).expand(lanes + (A * P2G_NODES, 3))
    win = torch.gather(field, -2, flat).reshape(lanes + (A, P2G_NODES, 3))
    return torch.cat(
        [win, win * node_pos[..., 0:1], win * node_pos[..., 1:2],
         win * node_pos[..., 2:3]],
        dim=-1,
    ).contiguous()


def grid_velocity(config: MpmConfig, state: MpmState):
    """P2G and grid update: (grid velocity ([L,] nx, ny, nz, 3), the P2G's
    ``dropped``).  On CUDA without ``config.xla_only``, the blocked path
    with K1 from K2's block windows; on the CPU or under ``xla_only``,
    ``update_grid(particle_to_grid(...))``."""
    if config.xla_only or state.x.device.type == "cpu":
        grid = particle_to_grid(config, state)
        return update_grid(config, grid), grid.dropped
    sort = sort_particles(config, state)
    return _velocity_from_blocks(config, sort), sort.dropped


def grid_velocity_and_mass(config: MpmConfig, state: MpmState):
    """``grid_velocity`` with the node mass beside the velocity: (velocity
    ([L,] nx, ny, nz, 3), mass ([L,] nx, ny, nz), the P2G's ``dropped``).
    On CUDA without ``config.xla_only``, K2 and K1 from block windows, which
    writes the mass too; on the CPU or under ``xla_only``, ``particle_to_grid``
    and ``update_grid``."""
    if config.xla_only or state.x.device.type == "cpu":
        grid = particle_to_grid(config, state)
        return update_grid(config, grid), grid.mass, grid.dropped
    sort = sort_particles(config, state)
    vel, mass = _velocity_from_blocks(config, sort, with_mass=True)
    return vel, mass, sort.dropped


def mpm_substep(config: MpmConfig, state: MpmState) -> MpmState:
    """One explicit MLS-MPM substep: P2G and grid update -> stencil G2P."""
    grid_vel, dropped = grid_velocity(config, state)
    out = grid_to_particle(config, state, grid_vel)
    return out.replace(dropped=dropped)


def blocked_substep(
    config: MpmConfig,
    state: MpmState,
    live: Optional[torch.Tensor] = None,
    clip_weights: bool = False,
    particle_force: Optional[torch.Tensor] = None,
    grid_op: Optional[Callable] = None,
) -> MpmState:
    """One substep on ONE block sort shared by P2G (K2) and G2P (K3): the
    grid update from K2's block windows between them (K1, with the node
    mass when there is a ``grid_op``), then ``grid_op(vel, mass) -> vel`` on
    each lane's dense fields ([L,] nx, ny, nz, 3) and ([L,] nx, ny, nz) if
    given, K3 on the result's windows (one output row per sorted row), and
    one gather back to particle order.

    ``live``, ``clip_weights`` and ``particle_force`` go to
    ``sort_particles``.  Particles that are not live, and those the
    capacities leave out, keep their state; ``dropped`` counts the second
    kind, per lane."""
    dtype = state.x.dtype
    lanes = state.x.shape[:-2]
    n = state.x.shape[-2]
    PMAX = config.block_capacity

    sort = sort_particles(config, state, live, clip_weights, particle_force)
    if grid_op is None:
        grid_vel = _velocity_from_blocks(config, sort)
    else:
        grid_vel, grid_mass = _velocity_from_blocks(config, sort, with_mass=True)
        grid_vel = grid_op(grid_vel, grid_mass)
    node_pos = window_node_pos(config, sort.active, dtype)
    vel_ext = block_velocity_windows(config, grid_vel, sort.active, node_pos)
    out = mpm_kernels.g2p_block(
        sort.packed, vel_ext, sort.starts, sort.counts, PMAX, 4.0 / config.dx**2,
        config.dt, plain=config.xla_only,
    )  # (L n, 24): x_new, v_new, F_new, C_new at each sorted row

    # Unsort: particle i sits at sorted row invperm[i].
    N = sort.perm.shape[0]
    invperm = torch.empty_like(sort.perm)
    invperm[sort.perm] = torch.arange(N, device=invperm.device)
    taken = mpm_kernels.taken_rows(sort.starts, sort.counts, N, PMAX)
    got = out[invperm].reshape(lanes + (n, mpm_kernels.G2P_OUT))
    cov = taken[invperm].reshape(lanes + (n, 1))
    return state.replace(
        x=torch.where(cov, got[..., 0:3], state.x),
        v=torch.where(cov, got[..., 3:6], state.v),
        F=torch.where(cov[..., None], got[..., 6:15].reshape(lanes + (n, 3, 3)), state.F),
        C=torch.where(cov[..., None], got[..., 15:24].reshape(lanes + (n, 3, 3)), state.C),
        dropped=sort.dropped,
    )


def mpm_substep_blocked(config: MpmConfig, state: MpmState) -> MpmState:
    """Fused blocked substep (``blocked_substep`` with every particle live):
    one block sort shared by K2 and K3, the grid update from K2's block
    windows between them, an unsort back to particle order.  Particles
    dropped by the capacities keep their old state."""
    return blocked_substep(config, state)


def simulate(config: MpmConfig, state: MpmState, num_substeps: int) -> MpmState:
    """Rollout of `num_substeps` substeps (the JAX package's lax.scan as a
    Python loop; no host sync inside)."""
    for _ in range(num_substeps):
        state = mpm_substep(config, state)
    return state
