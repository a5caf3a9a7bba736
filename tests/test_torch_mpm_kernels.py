"""Parity of the port's kernel modules (drake_tpu_torch.ops.mpm_kernels)
against the JAX package's drake_tpu.ops.mpm_kernels, on the CPU.

Both sides get the same numpy inputs made from a seed.  On the CPU the port's
dispatchers take their plain PyTorch versions (the CUDA kernels run only on
the card, where chip_smoke.py holds them against these same plain versions).
The JAX side runs its XLA oracles and, for K2 and K3, the Pallas kernel
bodies in interpret mode, as tests/test_mpm.py does.

Tolerances: float64 1e-10 (only the order of summation differs); float32
1e-5 for K1 and K3, and 1e-5 relative to max|out| for K2.  K3's C =
dxi2 (sum w v n - v x) is a difference of terms of size dxi2 |v| |x| (x in
the unit domain), so its columns are held to the tolerance times
dxi2 max|v|.

torch, the port and the JAX package's Pallas module are imported when a
test here runs, not when pytest collects this file: every pytest-xdist worker
imports every test file, and a worker that runs only other JAX tests then
loads neither torch nor Pallas (whose Mosaic extensions stay in the process
for the rest of the run).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

TOL = {np.float64: 1e-10, np.float32: 1e-5}
DXI2, DT = 1e3, 1e-4
DTYPES = [np.float64, np.float32]


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
def jmk():
    from drake_tpu.ops import mpm_kernels

    return mpm_kernels


@pytest.fixture(scope="module")
def tmk():
    from drake_tpu_torch.ops import mpm_kernels

    return mpm_kernels


def _t(a):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a))


def _random_packed(rng, n, dtype):
    """(n, 40) packed rows with the solver's column meaning."""
    packed = np.zeros((n, 40))
    packed[:, 0:16] = 0.1 * rng.standard_normal((n, 16))
    packed[:, 16:25] = rng.uniform(size=(n, 9))
    packed[:, 25:28] = rng.integers(0, 4, (n, 3))
    packed[:, 28:31] = rng.uniform(size=(n, 3))  # x in the unit domain
    packed[:, 31:40] = (np.eye(3) + 0.05 * rng.standard_normal((n, 3, 3))).reshape(n, 9)
    return packed.astype(dtype)


def _assert_g2p_close(out, ref, tol):
    """x, v, F columns to `tol`; C columns to tol * dxi2 * max|v|."""
    np.testing.assert_allclose(out[..., :15], ref[..., :15], rtol=0, atol=tol)
    c_tol = tol * DXI2 * np.abs(ref[..., 3:6]).max(initial=0.0)
    np.testing.assert_allclose(out[..., 15:24], ref[..., 15:24], rtol=0, atol=c_tol)


def _blocks():
    """Block table over 512 rows: unaligned starts, and counts of 0, 1 and
    a full pmax = 64 among them."""
    starts = np.arange(8, dtype=np.int32) * 56 + 3
    counts = np.asarray([40, 0, 64, 1, 40, 33, 17, 40], np.int32)
    return 512, 64, starts, counts


def _row_blocks():
    """Block table over 512 rows whose runs do not overlap, as K3 takes it
    (one output row per taken row): unaligned starts, and counts of 0, 1 and
    a full pmax = 64 among them."""
    counts = np.asarray([40, 0, 64, 1, 40, 33, 17, 40], np.int32)
    starts = (3 + np.concatenate([[0], np.cumsum(counts[:-1] + 5)])).astype(np.int32)
    return 512, 64, starts, counts


def _assert_g2p_rows(out, ref, starts, counts, tol):
    """K3's (n, 24) rows against a per-block (A, pmax, 24) oracle: block a's
    particle s at row starts[a] + s; rows that no block takes are zero."""
    taken = np.zeros(out.shape[0], bool)
    for a, (s0, c) in enumerate(zip(starts, counts)):
        _assert_g2p_close(out[s0:s0 + c], ref[a, :c], tol)
        taken[s0:s0 + c] = True
    assert not out[~taken].any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_update_grid_matches_jax(jmk, tmk, dtype):
    rng = np.random.default_rng(0)
    shape = (32, 32, 32)
    mass = rng.uniform(0.0, 2.0, shape)
    mass[rng.uniform(size=shape) < 0.3] = 0.0  # empty nodes
    mass = mass.astype(dtype)
    mom = rng.standard_normal((3,) + shape).astype(dtype)
    args = (1e-4, (0.5, -1.0, -9.81), 3)
    ref = jmk.update_grid_reference(jnp.asarray(mass), jnp.asarray(mom), *args)
    out = tmk.update_grid(_t(mass), _t(mom), *args)
    assert out.numpy().dtype == dtype
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_p2g_block_matches_jax_reference(jmk, tmk, dtype):
    rng = np.random.default_rng(1)
    n, pmax, starts, counts = _blocks()
    packed = _random_packed(rng, n, dtype)
    ref = jmk.p2g_block_matmul_reference(
        jnp.asarray(packed[:, 0:16]), jnp.asarray(packed[:, 25:28].astype(np.int32)),
        jnp.asarray(packed[:, 16:25]), jnp.asarray(starts), jnp.asarray(counts), pmax,
    )
    out = tmk.p2g_block(_t(packed), _t(starts), _t(counts), pmax)
    ref = np.asarray(ref)
    assert out.shape == (8, 16, 216)
    np.testing.assert_allclose(
        out.numpy(), ref, rtol=0, atol=TOL[dtype] * np.abs(ref).max()
    )


def test_p2g_block_plain_takes_any_order_within_a_block(tmk):
    """The plain version sums a block's rows whatever their order: rows
    sorted by local base (what the kernel requires) and the same rows
    shuffled within each block give the same sums."""
    rng = np.random.default_rng(5)
    n, pmax, _, counts = _blocks()
    starts = np.arange(8, dtype=np.int32) * 64  # disjoint runs
    shuffled = _random_packed(rng, n, np.float64)
    ordered = shuffled.copy()
    for s, c in zip(starts, counts):
        rows = shuffled[s:s + c]
        cell = (rows[:, 25] * 4 + rows[:, 26]) * 4 + rows[:, 27]
        ordered[s:s + c] = rows[np.argsort(cell, kind="stable")]
    assert not np.array_equal(ordered, shuffled)
    args = (_t(starts), _t(counts), pmax)
    np.testing.assert_allclose(
        tmk.p2g_block(_t(shuffled), *args).numpy(),
        tmk.p2g_block(_t(ordered), *args).numpy(), rtol=0, atol=1e-13,
    )


@pytest.mark.parametrize("dtype", DTYPES)
def test_g2p_block_matches_jax_reference(jmk, tmk, dtype):
    rng = np.random.default_rng(2)
    n, pmax, starts, counts = _row_blocks()
    packed = _random_packed(rng, n, dtype)
    vel_ext = (0.01 * rng.standard_normal((8, 216, 12))).astype(dtype)
    packed128 = np.zeros((n, 128), dtype)
    packed128[:, :40] = packed
    # The JAX oracle with starts_al = starts and offs = 0 gives block a's
    # particle s at slot s; the port writes it at row starts[a] + s.
    ref = jmk.g2p_block_matmul_reference(
        jnp.asarray(packed128), jnp.asarray(vel_ext), jnp.asarray(starts),
        jnp.zeros(8, jnp.int32), jnp.asarray(counts), pmax, DXI2, DT,
    )
    out = tmk.g2p_block(_t(packed), _t(vel_ext), _t(starts), _t(counts), pmax, DXI2, DT)
    assert out.shape == (n, 24)
    _assert_g2p_rows(out.numpy(), np.asarray(ref)[..., :24], starts, counts, TOL[dtype])
    # Over lanes: the same table as 2 lanes of 4 blocks, one output.
    lanes = tmk.g2p_block(_t(packed), _t(vel_ext.reshape(2, 4, 216, 12)),
                          _t(starts.reshape(2, 4)), _t(counts.reshape(2, 4)), pmax, DXI2, DT)
    np.testing.assert_array_equal(lanes.numpy(), out.numpy())
    taken = tmk.taken_rows(_t(starts), _t(counts), n, pmax).numpy()
    assert taken.sum() == counts.sum() and not out.numpy()[~taken].any()


def test_p2g_block_matches_pallas_interpret(jmk, tmk):
    """The port's K2 plain version against the Pallas TPU kernel body run in
    interpret mode (float32, the kernel's only type)."""
    rng = np.random.default_rng(3)
    n, pmax, starts, counts = _blocks()
    packed = _random_packed(rng, n, np.float32)
    packed128 = np.zeros((n, 128), np.float32)
    packed128[:, :40] = packed
    starts_al, offs, counts_c = jmk.align_starts(
        jnp.asarray(starts), jnp.asarray(counts), n, pmax
    )
    ref = jmk.p2g_block_matmul_pallas(
        jnp.asarray(packed128), starts_al, offs, counts_c,
        jmk.align_window(pmax), interpret=True,
    )
    out = tmk.p2g_block(_t(packed), _t(starts), _t(counts), pmax)
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_g2p_block_matches_pallas_interpret(jmk, tmk):
    """The port's K3 plain version against the Pallas TPU kernel body run in
    interpret mode.  The Pallas output keeps the TPU's 8-row alignment
    window (block a's particle s at row offs[a] + s of its block); the
    port's is one row per packed row (at row starts[a] + s)."""
    rng = np.random.default_rng(4)
    n, pmax, starts, counts = _row_blocks()
    packed = _random_packed(rng, n, np.float32)
    packed128 = np.zeros((n, 128), np.float32)
    packed128[:, :40] = packed
    vel_ext = (0.01 * rng.standard_normal((8, 216, 12))).astype(np.float32)
    starts_al, offs, counts_c = jmk.align_starts(
        jnp.asarray(starts), jnp.asarray(counts), n, pmax
    )
    ref = np.asarray(
        jmk.g2p_block_matmul_pallas(
            jnp.asarray(packed128), jnp.asarray(vel_ext), starts_al, offs, counts_c,
            jmk.align_window(pmax), DXI2, DT, interpret=True,
        )
    )
    out = tmk.g2p_block(
        _t(packed), _t(vel_ext), _t(starts), _t(counts), pmax, DXI2, DT
    ).numpy()
    offs = np.asarray(offs)
    ref_slots = np.stack([ref[a, offs[a]:offs[a] + pmax, :24] for a in range(8)])
    _assert_g2p_rows(out, ref_slots, starts, counts, 1e-5)


def test_update_grid_blocks_wrapper_refuses_cpu_tensors(tmk):
    """The wrapper of K1 from block windows launches or raises: CPU tensors
    are refused before any build is attempted."""
    import torch

    active = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        tmk.update_grid_blocks_cuda(torch.zeros((4, 16, 216)), active, (8, 8, 8), 0.125,
                                    1e-4, (0, 0, -9.81), 1)
    assert tmk.LAUNCHES["update_grid_blocks"] == 0


def test_kernel_wrappers_refuse_cpu_tensors(tmk):
    """The CUDA wrappers launch or raise: a CPU tensor is refused before any
    build is attempted (the dispatchers never send one there)."""
    import torch

    z = torch.zeros
    i = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tmk.update_grid_cuda(z((4, 4, 4)), z((3, 4, 4, 4)), 1e-4, (0, 0, -9.81), 1)
    with pytest.raises(ValueError, match="CUDA"):
        tmk.p2g_block_cuda(z((16, 40)), i, i, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tmk.g2p_block_cuda(z((16, 40)), z((4, 216, 12)), i, i, 8, 1.0, 1e-4)
    assert tmk.LAUNCHES == {"update_grid": 0, "update_grid_blocks": 0, "p2g_block": 0,
                            "g2p_block": 0}


# Lanes: L problems in one call, against jax.vmap of the reference.
LANES = 3


@pytest.mark.parametrize("dtype", DTYPES)
def test_update_grid_lanes_match_jax_vmap(jmk, tmk, dtype):
    import jax

    rng = np.random.default_rng(6)
    shape = (LANES, 16, 12, 20)
    mass = rng.uniform(0.0, 2.0, shape)
    mass[rng.uniform(size=shape) < 0.3] = 0.0
    mass = mass.astype(dtype)
    mom = rng.standard_normal((LANES, 3) + shape[1:]).astype(dtype)
    args = (1e-4, (0.5, -1.0, -9.81), 2)
    ref = jax.vmap(lambda m, p: jmk.update_grid_reference(m, p, *args))(
        jnp.asarray(mass), jnp.asarray(mom))
    out = tmk.update_grid(_t(mass), _t(mom), *args)
    assert out.shape == mom.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=TOL[dtype])
    # Each lane's walls are its own: lane by lane equals the unbatched call.
    for lane in range(LANES):
        np.testing.assert_array_equal(
            out[lane].numpy(), tmk.update_grid(_t(mass[lane]), _t(mom[lane]), *args).numpy())


@pytest.mark.parametrize("dtype", DTYPES)
def test_p2g_block_lanes_match_jax_vmap(jmk, tmk, dtype):
    """Starts and counts (L, A) into one table of all lanes' rows, against
    the reference vmapped over lanes with a table each."""
    import jax

    rng = np.random.default_rng(7)
    n, pmax, starts, counts = _blocks()
    packed = np.stack([_random_packed(rng, n, dtype) for _ in range(LANES)])
    lane_counts = np.stack([np.roll(counts, lane) for lane in range(LANES)])
    lane_starts = np.broadcast_to(starts, (LANES, 8))
    ref = jax.vmap(lambda pk, s, c: jmk.p2g_block_matmul_reference(
        pk[:, 0:16], pk[:, 25:28].astype(jnp.int32), pk[:, 16:25], s, c, pmax))(
        jnp.asarray(packed), jnp.asarray(lane_starts), jnp.asarray(lane_counts))
    table_starts = (lane_starts + n * np.arange(LANES)[:, None]).astype(np.int32)
    out = tmk.p2g_block(_t(packed.reshape(LANES * n, 40)), _t(table_starts),
                        _t(lane_counts.astype(np.int32)), pmax)
    ref = np.asarray(ref)
    assert out.shape == (LANES, 8, 16, 216)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=TOL[dtype] * np.abs(ref).max())


# K1 from block windows: K2's output (L, A, 16, 216) and the active ids
# (L, A) -> the grid velocity (L, nx, ny, nz, 3).
WIN_GRID = (16, 12, 20)  # 4 x 3 x 5 blocks
WIN_DX = 1.0 / 16


def _random_windows(rng, lanes, dtype, live=18, A=24):
    """K2-like outputs: masses in [0.1, 1] at every window node (so no
    velocity divides by a tiny mass), u0 and B of size 0.1, pad channels 0;
    each lane its own `live` ascending block ids, then sentinels."""
    nblocks = math.prod(n // 4 for n in WIN_GRID)
    out = np.zeros((lanes, A, 16, 216))
    out[:, :, 0] = rng.uniform(0.1, 1.0, (lanes, A, 216))
    out[:, :, 1:13] = 0.1 * rng.standard_normal((lanes, A, 12, 216))
    active = np.full((lanes, A), nblocks, np.int64)
    for lane in range(lanes):
        active[lane, :live] = np.sort(rng.choice(nblocks, live, replace=False))
    out[active == nblocks] = 0.0  # as K2 leaves the sentinel entries
    return out.astype(dtype), active


def _dense_grid_np(out, active):
    """Independent construction of one lane's grid: each active block's
    window added at grid index 4 block + l (rows past the grid dropped),
    momentum u0 + B (x_node - o) = u0 + B l dx, u0 taken about the block's
    origin o = 4 block dx (the packed row's contract)."""
    nx, ny, nz = WIN_GRID
    nby, nbz = ny // 4, nz // 4
    mass = np.zeros((nx + 2, ny + 2, nz + 2))
    mom = np.zeros((nx + 2, ny + 2, nz + 2, 3))
    l = np.arange(216)
    local = np.stack([l // 36, (l // 6) % 6, l % 6], axis=-1)
    for a, bid in enumerate(active):
        if bid >= (nx // 4) * nby * nbz:
            continue
        node = 4 * np.array([bid // (nby * nbz), (bid // nbz) % nby, bid % nbz]) + local
        B = out[a, 4:13].T.reshape(216, 3, 3).astype(np.float64)
        p = out[a, 1:4].T + np.einsum("lij,lj->li", B, local * WIN_DX)
        np.add.at(mass, tuple(node.T), out[a, 0])
        np.add.at(mom, tuple(node.T), p)
    return mass[:nx, :ny, :nz], np.moveaxis(mom[:nx, :ny, :nz], -1, 0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_update_grid_blocks_matches_jax(jmk, tmk, dtype):
    """The plain version against the JAX package's K1 oracle on grids built
    independently from the same windows: one state, and lanes against
    jax.vmap, lane by lane equal to the unbatched call."""
    import jax

    rng = np.random.default_rng(8)
    out, active = _random_windows(rng, LANES, dtype)
    grids = [_dense_grid_np(out[lane], active[lane]) for lane in range(LANES)]
    mass = np.stack([g[0] for g in grids]).astype(dtype)
    mom = np.stack([g[1] for g in grids]).astype(dtype)
    args = (1e-4, (0.5, -1.0, -9.81), 2)
    ref = jax.vmap(lambda m, p: jmk.update_grid_reference(m, p, *args))(
        jnp.asarray(mass), jnp.asarray(mom))
    ref = np.moveaxis(np.asarray(ref), 1, -1)
    got = tmk.update_grid_blocks(_t(out), _t(active), WIN_GRID, WIN_DX, *args)
    assert got.shape == (LANES,) + WIN_GRID + (3,)
    assert got.numpy().dtype == dtype
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL[dtype] * np.abs(ref).max())
    for lane in range(LANES):
        one = tmk.update_grid_blocks(_t(out[lane]), _t(active[lane]), WIN_GRID, WIN_DX, *args)
        np.testing.assert_array_equal(one.numpy(), got[lane].numpy())


def test_update_grid_blocks_plain_takes_any_order(tmk):
    """The plain version adds the blocks whatever the order of the active
    ids (the kernel requires them ascending): the entries permuted together
    with their windows give the same velocity."""
    rng = np.random.default_rng(9)
    out, active = _random_windows(rng, 1, np.float64)
    perm = rng.permutation(active.shape[1])
    args = (WIN_GRID, WIN_DX, 1e-4, (0.0, 0.0, -9.81), 3)
    np.testing.assert_array_equal(
        tmk.update_grid_blocks(_t(out[:, perm]), _t(active[:, perm]), *args).numpy(),
        tmk.update_grid_blocks(_t(out), _t(active), *args).numpy())
