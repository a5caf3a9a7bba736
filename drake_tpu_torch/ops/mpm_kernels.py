"""Kernels of the MPM substep: hand-written CUDA for Hopper, and beside each
its plain PyTorch version (counterpart of drake_tpu.ops.mpm_kernels).

Each public function dispatches on the device of its tensors:

- CPU tensors, or ``plain=True`` (``MpmConfig.xla_only``), take the plain
  version: the CPU path, and the oracle the kernel is checked against.
- CUDA tensors launch the kernel from ``csrc/mpm_kernels.cu`` or raise; there
  is no fallback.

Every launch adds one to ``LAUNCHES[name]``, so a run can show that its path
went through the kernels.

K1 comes in two forms.  ``update_grid`` is the direct counterpart of the TPU
kernel, on a dense grid (mass and momentum).  ``update_grid_blocks`` is the
grid update of the substeps: it reads K2's block windows and the active
block list, gathers each node's halo, adds B (x_node - o) and applies the
update in one kernel, so that no dense grid is built between K2 and K1;
asked (``with_mass=True``), it also writes the node mass, which the
implicit grid contact needs beside the velocity.

Lanes: every kernel also takes L independent problems in one launch.  K1
takes ``mass (L, nx, ny, nz)`` and ``momentum (L, 3, nx, ny, nz)``, the lane
a grid dimension of the kernel; ``update_grid_blocks`` K2's output of shape
``(L, A, 16, 216)`` and ``active (L, A)``; K2 and K3 take ``starts`` and
``counts`` of shape ``(L, A)`` into one packed table of all lanes' rows
(``sort_particles`` makes it), one CTA per (lane, block), and K3 its
windows as ``(L, A, 216, 12)``.  K3 writes one output row per sorted row,
at that row's index in the table.  The plain versions take the same
shapes.

The packed particle row keeps the JAX package's column meaning but is 40
wide instead of 128 (no TPU lane padding): 0:16 values [m, u0 (3), B (9),
pad (3)], 16:25 B-spline taps, 25:28 local base, 28:31 x, 31:40 F.  The
u0 = m v - B (x - o) is taken about the origin o = 4 dx b of the particle's
block b (the JAX package takes it about 0; in float32 the rounding of B x at
|x| ~ 1 then cancels against B x_node).  Rows are sorted by block and,
within a block, by local base (``sort_particles`` does both).  The second
order is part of ``p2g_block``'s contract: the K2 kernel
walks each cell's rows as one run and answers a block that breaks the order
with NaN, while the plain version adds the rows in any order.  The TPU's
8-row DMA alignment (``align_starts``/``align_window``), its custom_vmap batch
folding and the MXU weight factorisation have no counterpart here.
"""

from __future__ import annotations

import functools
import math

import torch

from drake_tpu_torch.ops import _build

P2G_NV = 16  # value channels: [mass, u0(3), B(9), pad(3)]
P2G_NODES = 216  # 6^3 block-window nodes
_TAPS = tuple((i, j, k) for i in range(3) for j in range(3) for k in range(3))
G2P_VEL_CH = 12  # [v(3), v*node_x(3), v*node_y(3), v*node_z(3)]
G2P_OUT = 24  # [x_new(3), v_new(3), F_new(9), C_new(9)]
PACKED_COLS = 40
LAUNCHES = {"update_grid": 0, "update_grid_blocks": 0, "p2g_block": 0, "g2p_block": 0}
# The launches of LAUNCHES["update_grid_blocks"] that also wrote the mass.
LAUNCHES_WITH_MASS = {"update_grid_blocks": 0}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, LAUNCHES_WITH_MASS):
        for name in counts:
            counts[name] = 0


@functools.lru_cache(maxsize=None)
def device_constant(values: tuple, dtype: torch.dtype, device: torch.device):
    """A small constant tensor, made once per (values, dtype, device).

    ``torch.tensor(..., device="cuda")`` copies from the host and waits for
    the stream; caching keeps such copies out of the substep loop, which
    then makes no host sync.  Callers must not write to the result."""
    return torch.tensor(values, dtype=dtype, device=device)


def _check(name, t, dtype=torch.float32, shape=None, device=None):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def _check_rows(packed, min_cols: int) -> None:
    """`packed` as K2 and K3 take it: (n, >= min_cols) float32 whose rows the
    kernels copy in 16-byte pieces, so each row must start 16-byte aligned."""
    _check("packed", packed)
    if packed.dim() != 2 or packed.shape[1] < min_cols:
        raise ValueError(
            f"packed: expected (n, >={min_cols}), got {tuple(packed.shape)}"
        )
    if packed.shape[1] % 4 or packed.data_ptr() % 16:
        raise ValueError(
            "packed: rows must be 16-byte aligned (a multiple of 4 columns, "
            f"aligned storage), got {packed.shape[1]} columns"
        )


def _raise_on_error(kernel: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed (cudaError_t {rc})")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# K1: grid update.
# ---------------------------------------------------------------------------


def update_grid_reference(mass, momentum, dt, gravity, wall_width):
    """Plain version.  mass: ([L,] nx, ny, nz); momentum: ([L,] 3, nx, ny,
    nz).  Returns the velocity shaped as `momentum`: p / m on nodes with mass
    (else 0), plus dt * g on nodes with mass, zeroed within `wall_width` of
    each face of each lane's grid."""
    g = device_constant(tuple(gravity), momentum.dtype, momentum.device)
    m = mass.unsqueeze(-4)
    active = m > 0
    vel = torch.where(active, momentum / m.clamp_min(1e-12), 0.0)
    vel = vel + dt * g[:, None, None, None] * active
    w = wall_width
    nx, ny, nz = momentum.shape[-3:]
    dev = momentum.device
    ii = torch.arange(nx, device=dev)[:, None, None]
    jj = torch.arange(ny, device=dev)[None, :, None]
    kk = torch.arange(nz, device=dev)[None, None, :]
    inside = (
        (ii >= w) & (ii < nx - w)
        & (jj >= w) & (jj < ny - w)
        & (kk >= w) & (kk < nz - w)
    )
    return torch.where(inside, vel, 0.0)


# Lanes of one K1 launch: the lane is the kernel's second grid dimension.
MAX_GRID_LANES = 65535


def update_grid_cuda(mass, momentum, dt, gravity, wall_width):
    """Launch K1 (``update_grid_kernel``) on CUDA float32 tensors, mass
    ([L,] nx, ny, nz) and momentum ([L,] 3, nx, ny, nz)."""
    if mass.dim() not in (3, 4):
        raise ValueError(f"mass: expected ([L,] nx, ny, nz), got {tuple(mass.shape)}")
    lanes = mass.shape[:-3]
    nx, ny, nz = mass.shape[-3:]
    L = math.prod(lanes)
    if L > MAX_GRID_LANES:
        raise ValueError(f"update_grid: {L} lanes, at most {MAX_GRID_LANES} a launch")
    _check("mass", mass)
    _check("momentum", momentum, shape=lanes + (3, nx, ny, nz), device=mass.device)
    if 3 * nx * ny * nz >= 2**31:
        raise ValueError(f"update_grid: grid {(nx, ny, nz)} too large for 32-bit indices")
    vel = torch.empty_like(momentum)
    if mass.numel() == 0:
        return vel
    lib = _build.load_library()
    gx, gy, gz = (float(g) for g in gravity)
    with torch.cuda.device(mass.device):
        rc = lib.mpm_update_grid(
            mass.data_ptr(), momentum.data_ptr(), vel.data_ptr(), L,
            nx, ny, nz, float(dt), gx, gy, gz, int(wall_width),
            _stream(mass.device),
        )
    _raise_on_error("update_grid", rc)
    LAUNCHES["update_grid"] += 1
    return vel


def update_grid(mass, momentum, dt, gravity, wall_width, plain=False):
    """Dispatcher: the plain version for CPU tensors or ``plain=True``,
    the K1 kernel for CUDA tensors."""
    if plain or mass.device.type == "cpu":
        return update_grid_reference(mass, momentum, dt, gravity, wall_width)
    return update_grid_cuda(mass, momentum, dt, gravity, wall_width)


def empty_launch_cuda(blocks: int, threads: int, device) -> None:
    """Launch an empty kernel of `blocks` CTAs of `threads` on `device`'s
    current stream: a probe of what a launch costs with no work.  It counts
    in no ``LAUNCHES`` entry."""
    lib = _build.load_library()
    with torch.cuda.device(device):
        rc = lib.mpm_empty(int(blocks), int(threads), _stream(device))
    _raise_on_error("empty", rc)


# ---------------------------------------------------------------------------
# K1 from block windows: the grid update of the substeps, from K2's output.
# ---------------------------------------------------------------------------


def window_node_index(grid_size, active):
    """(..., A, 216, 3) grid index 4*block + (i, j, k) of each active
    block's 6^3 window node l = (i*6+j)*6+k (past the grid's upper faces for
    the sentinel id and for the last blocks' halos)."""
    _, ny, nz = grid_size
    nby, nbz = ny // 4, nz // 4
    ablock = torch.stack(
        [active // (nbz * nby), (active // nbz) % nby, active % nbz], dim=-1
    )
    l_range = torch.arange(6, device=active.device)
    ll = torch.stack(
        torch.meshgrid(l_range, l_range, l_range, indexing="ij"), dim=-1
    ).reshape(P2G_NODES, 3)
    return 4 * ablock[..., None, :] + ll


def window_node_pos(grid_size, dx, active, dtype):
    """(..., A, 216, 3) world positions of each active block's 6^3 window
    nodes (``window_node_index`` times dx)."""
    return window_node_index(grid_size, active).to(dtype) * dx


def _combine(T, block_axis, local_axis, nb):
    """Halo combine along one axis: window row l of block b lands on grid
    index 4b + l; rows 4 and 5 spill into block b+1's rows 0 and 1."""
    core = T.movedim((block_axis, local_axis), (0, 1))
    res = core[:, 0:4].clone()
    res[1:, 0] += core[:-1, 4]
    res[1:, 1] += core[:-1, 5]
    return res.reshape((nb * 4,) + core.shape[2:]).movedim(0, block_axis)


def grid_from_blocks_reference(out, active, grid_size, dx):
    """The dense grid of each lane from K2's output ([L,] A, 16, 216) and
    the active block ids ([L,] A): add B (x_node - o) to the momentum at
    every window node, o the origin of the window's block (u0's origin), place each active block's window in its lane's grid (a
    block table), combine the halos (x, then y, then z).  Sentinel entries
    (id nblocks) contribute nothing.  Returns (mass ([L,] nx, ny, nz),
    momentum ([L,] nx, ny, nz, 3))."""
    nx, ny, nz = grid_size
    nbx, nby, nbz = nx // 4, ny // 4, nz // 4
    nblocks = nbx * nby * nbz
    lanes = tuple(active.shape[:-1])
    L = math.prod(lanes)
    LA = L * active.shape[-1]
    out = out.reshape(LA, P2G_NV, P2G_NODES)
    # Window node l's offset from its block's origin.
    offset = window_node_pos(grid_size, dx, torch.zeros((), dtype=torch.int64,
                                                        device=active.device), out.dtype)
    M_blk = out[:, 0, :]
    U_blk = out[:, 1:4, :].transpose(1, 2)  # (LA, 216, 3)
    C_blk = out[:, 4:13, :].transpose(1, 2).reshape(LA, P2G_NODES, 3, 3)
    mom_blk = U_blk + torch.sum(C_blk * offset[:, None, :], dim=-1)
    # Active ids are unique within a lane; sentinel entries (all zero) go to
    # the extra row.
    lane_off = (torch.arange(L, device=active.device) * nblocks).reshape(lanes + (1,))
    dest = torch.where(active < nblocks, active + lane_off, L * nblocks)
    T = torch.zeros((L * nblocks + 1, P2G_NODES, 4), dtype=out.dtype, device=out.device)
    T.index_add_(
        0, dest.reshape(LA), torch.cat([M_blk[..., None], mom_blk], dim=-1),
    )
    T = T[:-1].reshape(L, nbx, nby, nbz, 6, 6, 6, 4)
    Tx = _combine(T, 1, 4, nbx)  # (L, nx, nby, nbz, 6, 6, 4)
    Ty = _combine(Tx, 2, 4, nby)  # (L, nx, ny, nbz, 6, 4)
    Tz = _combine(Ty, 3, 4, nbz).reshape(lanes + (nx, ny, nz, 4))
    return Tz[..., 0], Tz[..., 1:]


def update_grid_blocks_reference(out, active, grid_size, dx, dt, gravity, wall_width,
                                 with_mass=False):
    """Plain version: the dense grid of ``grid_from_blocks_reference``, then
    ``update_grid_reference``.  Returns the grid velocity ([L,] nx, ny, nz,
    3), and with ``with_mass`` the pair (velocity, that grid's mass ([L,]
    nx, ny, nz)).  Takes the active ids in any order."""
    mass, momentum = grid_from_blocks_reference(out, active, grid_size, dx)
    vel = update_grid_reference(mass, momentum.movedim(-1, -4), dt, gravity, wall_width)
    vel = vel.movedim(-4, -1)
    return (vel, mass) if with_mass else vel


# Active ids of one lane that the kernel holds in shared memory (int32 each).
MAX_WINDOW_BLOCKS = 49_152


def update_grid_blocks_cuda(out, active, grid_size, dx, dt, gravity, wall_width,
                            with_mass=False):
    """Launch the grid update from block windows
    (``update_grid_blocks_kernel``).  out: ([L,] A, 16, 216) float32, K2's
    output; active: ([L,] A) int64, each lane's ids ascending and unique but
    for the sentinel nblocks, as ``sort_particles`` makes them.  Returns the
    velocity ([L,] nx, ny, nz, 3), contiguous, and with ``with_mass`` the
    pair (velocity, mass ([L,] nx, ny, nz)).  A lane whose ids are out of
    ascending order gets NaN in both."""
    _check("active", active, torch.int64)
    lanes = tuple(active.shape[:-1])
    A = active.shape[-1]
    L = math.prod(lanes)
    nx, ny, nz = grid_size
    _check("out", out, shape=lanes + (A, P2G_NV, P2G_NODES), device=active.device)
    if nx % 4 or ny % 4 or nz % 4:
        raise ValueError(f"grid dims must be multiples of 4, got {tuple(grid_size)}")
    if L > MAX_GRID_LANES:
        raise ValueError(f"update_grid_blocks: {L} lanes, at most {MAX_GRID_LANES} a launch")
    if A > MAX_WINDOW_BLOCKS:
        raise ValueError(f"update_grid_blocks: {A} active blocks, at most {MAX_WINDOW_BLOCKS}")
    vel = torch.empty(lanes + (nx, ny, nz, 3), dtype=torch.float32, device=out.device)
    mass = torch.empty(lanes + (nx, ny, nz), dtype=torch.float32, device=out.device) if (
        with_mass) else None
    result = (vel, mass) if with_mass else vel
    if vel.numel() == 0:
        return result
    lib = _build.load_library()
    gx, gy, gz = (float(g) for g in gravity)
    with torch.cuda.device(out.device):
        rc = lib.mpm_update_grid_blocks(
            out.data_ptr(), active.data_ptr(), L, A, nx, ny, nz, float(dx),
            float(dt), gx, gy, gz, int(wall_width), vel.data_ptr(),
            mass.data_ptr() if with_mass else None, _stream(out.device),
        )
    _raise_on_error("update_grid_blocks", rc)
    LAUNCHES["update_grid_blocks"] += 1
    if with_mass:
        LAUNCHES_WITH_MASS["update_grid_blocks"] += 1
    return result


def update_grid_blocks(out, active, grid_size, dx, dt, gravity, wall_width, plain=False,
                       with_mass=False):
    """Dispatcher: the plain version for CPU tensors or ``plain=True``, the
    grid update from block windows for CUDA tensors.  ``with_mass``: return
    (velocity, mass)."""
    args = (out, active, grid_size, dx, dt, gravity, wall_width, with_mass)
    if plain or out.device.type == "cpu":
        return update_grid_blocks_reference(*args)
    return update_grid_blocks_cuda(*args)


# ---------------------------------------------------------------------------
# Plain blocked transfers: gather each block's sorted rows into a
# (A, pmax, ...) table and take each row's 27 taps in the block's 6^3 window.
# ---------------------------------------------------------------------------


def _gather_blocks(packed, starts, counts, pmax):
    """Rows [starts[a], starts[a] + pmax) of `packed` (clipped to the array)
    and the mask of the first counts[a] of them."""
    n = packed.shape[0]
    s_idx = torch.arange(pmax, device=packed.device)
    pidx = (starts.long()[:, None] + s_idx[None, :]).clamp(0, n - 1)
    valid = (s_idx[None, :] < counts.long()[:, None]).to(packed.dtype)
    return packed[pidx], valid


def _axis_weights(pk):
    """(..., 3, 6): each slot's B-spline weight at each of its window's 6
    rows along each axis (taps at the local base + 0, 1, 2, columns 25:28
    and 16:25 of the packed row)."""
    lbb = pk[..., 25:28].long()
    wb = pk[..., 16:25].reshape(pk.shape[:-1] + (3, 3))
    rows = torch.arange(6, device=pk.device)
    acc = torch.zeros(pk.shape[:-1] + (3, 6), dtype=pk.dtype, device=pk.device)
    for t in range(3):
        acc = acc + (rows == (lbb + t)[..., None]).to(pk.dtype) * wb[..., t, None]
    return acc


def _window_taps(pk):
    """Each slot's 27 taps in its block's 6^3 window: (node index
    (i*6+j)*6+k (..., 27), weight wx_i wy_j wz_k (..., 27)) from the packed
    local base (columns 25:28) and taps (16:25)."""
    lbb = pk[..., 25:28].long()
    wb = pk[..., 16:25].reshape(pk.shape[:-1] + (3, 3))
    taps = device_constant(_TAPS, torch.int64, pk.device)  # (27, 3)
    node = ((lbb[..., None, 0] + taps[:, 0]) * 6 + lbb[..., None, 1] + taps[:, 1]) * 6 + (
        lbb[..., None, 2] + taps[:, 2])
    w = wb[..., 0, taps[:, 0]] * wb[..., 1, taps[:, 1]] * wb[..., 2, taps[:, 2]]
    # The local base is 0..3 by construction; the clamp keeps a corrupt row
    # inside the window, as the kernels' does.
    return node.clamp(0, P2G_NODES - 1), w


# ---------------------------------------------------------------------------
# K2: blocked P2G.
# ---------------------------------------------------------------------------


def p2g_block_reference(packed, starts, counts, pmax: int):
    """Plain version.  packed: (n, >=28) rows sorted by block; starts, counts:
    ([L,] A) into those rows.  Returns ([L,] A, 16, 216): for each block, the
    sum over its particles of the 16 value channels times each window node's
    B-spline weight.

    ``p2g_block`` also requires the rows of a block sorted by local base; this
    version does not use that order and does not check it."""
    pk, valid = _gather_blocks(packed, starts.reshape(-1), counts.reshape(-1), pmax)
    A = valid.shape[0]
    # The window weight wx_i wy_j wz_k factorised: the values times wx_i,
    # contracted over the slots with wy_j wz_k.
    wa = _axis_weights(pk)  # (A, pmax, 3, 6)
    Vx = (pk[..., 0:P2G_NV] * valid[..., None])[..., None] * wa[..., 0, None, :]
    Wyz = (wa[..., 1, :, None] * wa[..., 2, None, :]).reshape(A, pmax, 36)
    out = torch.einsum("apvi,apm->avim", Vx, Wyz)  # (A, 16, 6, 36)
    return out.reshape(starts.shape + (P2G_NV, P2G_NODES))


def p2g_block_cuda(packed, starts, counts, pmax: int):
    """Launch K2 (``p2g_block_kernel``).  packed: (n, >=28) float32; starts,
    counts: ([L,] A) int32, one CTA per entry.  Channels 0:13 as the plain
    version; the pad channels 13:16 are written 0 (the solver's packed rows
    carry zeros there).

    The kernel walks each cell's rows as one run, so within a block the rows
    must be sorted by the local base (columns 25:28, x slowest), as
    ``sort_particles`` sorts them.  A block whose rows break that order gets
    NaN in channels 0:13, not a wrong sum."""
    shape = tuple(starts.shape)
    A = math.prod(shape)
    _check_rows(packed, 28)
    _check("starts", starts, torch.int32, shape, packed.device)
    _check("counts", counts, torch.int32, shape, packed.device)
    out = torch.empty(shape + (P2G_NV, P2G_NODES), dtype=torch.float32, device=packed.device)
    if A == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(packed.device):
        rc = lib.mpm_p2g_block(
            packed.data_ptr(), packed.shape[0], packed.shape[1],
            starts.data_ptr(), counts.data_ptr(), A, int(pmax), out.data_ptr(),
            _stream(packed.device),
        )
    _raise_on_error("p2g_block", rc)
    LAUNCHES["p2g_block"] += 1
    return out


def p2g_block(packed, starts, counts, pmax: int, plain=False):
    """Dispatcher: plain version for CPU tensors or ``plain=True``, K2 for
    CUDA tensors.

    Contract on the rows, whichever version runs: sorted by block (each block
    the run ``starts[a] : starts[a] + counts[a]``) and, within a block, by
    local base (columns 25:28, x slowest, z fastest), as ``sort_particles``
    gives them.  Rows that break the second order are outside the contract:
    the kernel marks such a block with NaN, the plain version cannot tell."""
    if plain or packed.device.type == "cpu":
        return p2g_block_reference(packed, starts, counts, pmax)
    return p2g_block_cuda(packed, starts, counts, pmax)


# ---------------------------------------------------------------------------
# K3: blocked G2P.
# ---------------------------------------------------------------------------


def _row_owner(starts, counts, rows: int, pmax: int):
    """(rows,) int64: a + 1 on the rows ``starts[a] + s``, ``s <
    min(counts[a], pmax)``, that block a takes, 0 on the rows no block
    takes.  The blocks' runs may not overlap."""
    s = starts.reshape(-1).long().clamp(0, rows)
    e = (s + counts.reshape(-1).long().clamp(0, pmax)).clamp(max=rows)
    a1 = torch.arange(1, s.shape[0] + 1, device=starts.device) * (e > s)
    edge = torch.zeros(rows + 1, dtype=torch.int64, device=starts.device)
    edge.index_add_(0, s, a1)
    edge.index_add_(0, e, -a1)
    return torch.cumsum(edge, 0)[:-1]


def taken_rows(starts, counts, rows: int, pmax: int):
    """(rows,) bool: the rows of the packed table that some block takes,
    ``starts[a] + s`` for ``s < min(counts[a], pmax)`` -- the rows that K3
    writes.  The blocks' runs may not overlap."""
    return _row_owner(starts, counts, rows, pmax) > 0


def g2p_block_reference(packed, vel_ext, starts, counts, pmax: int, dxi2, dt):
    """Plain version.  packed: (n, 40) block-sorted rows; vel_ext: ([L,] A,
    216, >=12) per-block node channels [v, v*n_x, v*n_y, v*n_z]; starts,
    counts: ([L,] A) runs of `packed` that do not overlap.  Returns (n, 24):
    block a's particle s at row starts[a] + s (s < counts[a], at most
    pmax) with columns 0:3 x_new, 3:6 v_new, 6:15 F_new, 15:24 C_new; rows
    that no block takes are zero (the kernel does not write them).  Each
    row gathers its 27 taps from its block's window."""
    n = packed.shape[0]
    A = starts.numel()
    vel_ext = vel_ext.reshape(A * P2G_NODES, vel_ext.shape[-1])[:, :G2P_VEL_CH]
    owner = _row_owner(starts, counts, n, pmax)
    node, w = _window_taps(packed)  # (n, 27)
    win = vel_ext[(owner - 1).clamp_min(0)[:, None] * P2G_NODES + node]  # (n, 27, 12)
    g2p = torch.einsum("nt,ntv->nv", w, win)
    v_new = g2p[:, 0:3]
    # channel 3 + 3a + i = sum_l w v_i n_a; C[i][j] needs (i, a), hence the
    # transpose.
    wvn = g2p[:, 3:12].reshape(n, 3, 3)
    x_p = packed[:, 28:31]
    C_new = dxi2 * (wvn.transpose(-1, -2) - v_new[:, :, None] * x_p[:, None, :])
    F_p = packed[:, 31:40].reshape(n, 3, 3)
    eye = torch.eye(3, dtype=packed.dtype, device=packed.device)
    F_new = (eye + dt * C_new) @ F_p
    x_new = x_p + dt * v_new
    out = torch.cat([x_new, v_new, F_new.reshape(n, 9), C_new.reshape(n, 9)], dim=-1)
    return torch.where((owner > 0)[:, None], out, 0.0)


def g2p_block_cuda(packed, vel_ext, starts, counts, pmax: int, dxi2, dt):
    """Launch K3 (``g2p_block_kernel``).  packed: (n, >=40) float32; vel_ext:
    ([L,] A, 216, 12) float32; starts, counts: ([L,] A) int32 into the one
    packed table of all lanes' rows, one CTA per entry.  Returns (n, 24) as
    the plain version, but rows that no block takes (``taken_rows``) are
    left unwritten."""
    shape = tuple(starts.shape)
    A = math.prod(shape)
    _check_rows(packed, PACKED_COLS)
    _check("vel_ext", vel_ext, shape=shape + (P2G_NODES, G2P_VEL_CH), device=packed.device)
    if vel_ext.data_ptr() % 16:
        raise ValueError("vel_ext: storage must be 16-byte aligned")
    _check("starts", starts, torch.int32, shape, packed.device)
    _check("counts", counts, torch.int32, shape, packed.device)
    out = torch.empty((packed.shape[0], G2P_OUT), dtype=torch.float32, device=packed.device)
    if A == 0 or pmax == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(packed.device):
        rc = lib.mpm_g2p_block(
            packed.data_ptr(), packed.shape[0], packed.shape[1],
            vel_ext.data_ptr(), starts.data_ptr(), counts.data_ptr(),
            A, int(pmax), float(dxi2), float(dt), out.data_ptr(),
            _stream(packed.device),
        )
    _raise_on_error("g2p_block", rc)
    LAUNCHES["g2p_block"] += 1
    return out


def g2p_block(packed, vel_ext, starts, counts, pmax: int, dxi2, dt, plain=False):
    """Dispatcher: plain version for CPU tensors or ``plain=True``, K3 for
    CUDA tensors.  Only the rows that ``taken_rows`` marks are defined."""
    if plain or packed.device.type == "cpu":
        return g2p_block_reference(packed, vel_ext, starts, counts, pmax, dxi2, dt)
    return g2p_block_cuda(packed, vel_ext, starts, counts, pmax, dxi2, dt)
