// Hand-written Hopper (sm_90a) kernels of the MLS-MPM substep.
//
// Counterparts of the three Pallas TPU kernels in drake_tpu/ops/mpm_kernels.py.
// Plain C entry points (no PyTorch headers), built by nvcc into a shared
// library and called through ctypes from drake_tpu_torch/ops/mpm_kernels.py,
// which checks every tensor before a pointer reaches this file.  Each entry
// point launches on the caller's stream, never synchronises, allocates
// nothing, and returns cudaGetLastError() so the wrapper can raise on a
// refused launch.
//
// Packed particle rows (row stride `ld` floats, a multiple of 4, rows 16-byte
// aligned; sorted by block and, within a block, by base cell with x slowest
// and z fastest):
//   0:16 values [m, u0 = m v - B (x - o) (3), B (9), pad (3)], o = 4 dx b the
//        origin of the particle's block b (window node l lies at o + dx l)
//   16:25 B-spline taps [wx0..2, wy0..2, wz0..2]   25:28 local base (0..3)
//   28:31 x   31:40 F (row-major)
// Block window node l = (i * 6 + j) * 6 + k, i/j/k the local offsets 0..5.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kNodes = 216;         // 6^3 window nodes of a 4^3-cell block
constexpr int kP2GChannels = 16;    // output channels of K2
constexpr int kP2GLive = 13;        // m, u0, B; channels 13:16 are written 0
constexpr int kP2GThreads = 512;    // 16 warps, one per (ly, lz) cell column
constexpr int kP2GStageRows = 256;  // particle rows per staged chunk (K2)
constexpr int kP2GRowVec = 7;       // float4 per staged row: packed 0:28
constexpr int kP2GColNodes = 54;    // 3 x 3 x 6 window nodes of a cell column
// Two stages of rows and 16 columns' sums: dynamic shared memory (above the
// 48 KB static limit), sized so that two CTAs fit an SM.
constexpr int kP2GSmemBytes = 2 * kP2GStageRows * kP2GRowVec * 16 +
                              16 * kP2GLive * kP2GColNodes * 4;
constexpr int kG2PChannels = 12;    // [v, v*node_x, v*node_y, v*node_z]
constexpr int kG2POut = 24;         // [x_new, v_new, F_new, C_new]
constexpr int kG2PWarps = 4;        // warps of a K3 CTA
constexpr int kG2PRowVec = 6;       // float4 per row in and out: packed 16:40
constexpr int kG2PRowStride = 7;    // staged row stride in float4 (odd: no
                                    // bank conflict between a warp's rows)
constexpr int kK1Threads = 256;     // dense K1
constexpr int kK1bRun = 8;          // grid blocks along z of a K1 CTA
constexpr int kK1bZ = 4 * kK1bRun;  // its nodes along z
constexpr int kK1bThreads = 16 * kK1bZ;  // one node each: 4 x 4 x kK1bZ
constexpr int kK1bSlots = kK1bRun + 1;   // covering blocks along z, one below
constexpr int kK1bMaxTiles = 32;         // tiles a K1 CTA walks, at most

// 16-byte asynchronous copy from device memory into shared memory (both
// addresses 16-byte aligned), its commit into a group, and the wait until at
// most N of this thread's groups are still in flight.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int clamp03(float v) {
  return min(max(static_cast<int>(v), 0), 3);
}

// Particles of a block that the kernels read: at most pmax, and never a row
// outside [0, n_rows) -- the wrapper cannot check device-side starts and
// counts without a host sync, so the bound is enforced here.
__device__ __forceinline__ int block_count(int start, int count, int pmax,
                                           int n_rows) {
  if (start < 0 || start >= n_rows) return 0;
  return max(0, min(min(count, pmax), n_rows - start));
}

// K1's update of one velocity component: p / max(m, 1e-12) + dt g on a node
// with mass, else 0; and whether a node lies outside the sticky walls.
__device__ __forceinline__ float grid_velocity(float p, float m, float dt,
                                               float g) {
  return m > 0.f ? p / fmaxf(m, 1e-12f) + dt * g : 0.f;
}

__device__ __forceinline__ bool inside_walls(int i, int j, int k, int nx,
                                             int ny, int nz, int wall) {
  return i >= wall && i < nx - wall && j >= wall && j < ny - wall &&
         k >= wall && k < nz - wall;
}

// K1 -- grid update.  Replaces _update_grid_kernel (drake_tpu/ops/
// mpm_kernels.py:59), which ran one (ny, nz) x-slab per grid step in VMEM
// (B * nx slabs under vmap, its wall test on the slab index modulo nx).
// Bound on this card: device memory, ~28 B moved per node (mass + 3 momentum
// in, 3 velocity out) and a handful of flops.  Design: one thread per node,
// consecutive threads on consecutive z so every load and store is coalesced;
// the wall mask is recomputed from the index instead of read.  Lanes
// (independent grids stored one after the other, mass (L, nx, ny, nz),
// momentum and velocity (L, 3, nx, ny, nz)) are the grid's y dimension, and
// the wall test uses the node's index within its lane.  Index arithmetic is
// 32-bit within a lane (the wrapper keeps 3 nx ny nz below 2^31), the lane's
// offset 64-bit.  Kept for dense grids; the substeps take the grid update
// from K2's block windows instead (update_grid_blocks_kernel below).
__global__ void __launch_bounds__(kK1Threads)
update_grid_kernel(const float* __restrict__ mass,
                   const float* __restrict__ mom, float* __restrict__ vel,
                   int nx, int ny, int nz, float dt, float gx, float gy,
                   float gz, int wall) {
  const int n_nodes = nx * ny * nz;
  const int idx = blockIdx.x * kK1Threads + threadIdx.x;
  if (idx >= n_nodes) return;
  const int64_t lane = blockIdx.y;
  mass += lane * n_nodes;
  mom += lane * 3 * n_nodes;
  vel += lane * 3 * n_nodes;
  const int k = idx % nz;
  const int j = (idx / nz) % ny;
  const int i = idx / (ny * nz);
  const bool inside = inside_walls(i, j, k, nx, ny, nz, wall);
  const float m = mass[idx];
  const float g[3] = {gx, gy, gz};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v = grid_velocity(m > 0.f ? mom[c * n_nodes + idx] : 0.f, m, dt, g[c]);
    vel[c * n_nodes + idx] = inside ? v : 0.f;
  }
}

// An empty kernel: its back-to-back time at K1's launch shape is what the
// launch and the CTAs' scheduling alone cost (chip_smoke.py, phase 4).
__global__ void empty_kernel() {}

// K1 from block windows -- the grid update of the substeps.  Replaces, with
// the dense K1 above, _update_grid_kernel (drake_tpu/ops/mpm_kernels.py:59),
// and with it the dense grid that the TPU path builds between K2 and K1: the
// block table, the halo combine and the B x_node product of
// particle_to_grid_blocked (drake_tpu/mpm/solver.py:365-400).  Input: K2's
// output (L * A, 16, 216), channel-major per block, channels [m, u0 (3),
// B (9), pad (3)], window node l = (lx * 6 + ly) * 6 + lz at grid index
// 4 * block + (lx, ly, lz); and each lane's active block ids (L, A),
// ascending, the sentinel nblocks last.  Output: the grid velocity
// (L, nx, ny, nz, 3), node-major.  Node (i, j, k) of block b, local index
// (a, b', c), sums the window of b at (a, b', c) and, along each axis where
// the local index is < 2 and the block index > 0, the window of the block
// below on that axis at local index + 4: at most 8 blocks, of which only
// those in the lane's active list count.  Each contributes [m, u0 + B
// (x_node - o)], x_node - o = float(window index) * dx, the node's offset
// from the origin o of that window's block (u0 is taken about o, so that no
// float32 rounding of B x at |x| ~ 1 cancels against B x_node); the 8 terms
// are added in the order of the plain version's halo combine (x, then y,
// then z), a missing term as an exact zero, so the two differ only in the
// rounding of B (x_node - o).
// Then K1's update: p / max(m, 1e-12) + dt g on nodes with mass, zero within
// `wall` nodes of each face of the lane's grid.  With a non-null `mass`, the
// kernel also writes each node's mass m, the same sum of the 8 terms, as
// (L, nx, ny, nz) (walls included, 0 on nodes no active block covers, NaN in a
// lane whose ids are out of order): the grid mass that the implicit grid
// contact needs beside the velocity (drake_tpu/mpm/grid_contact.py:231).
// Bound on this card: bytes -- the 13 live channels of each active block read
// once and 12 B of velocity written per node, most of it the zeros of nodes
// no active block covers.  Design: a tile is (lane, grid blocks (bx, by), a
// run of kK1bRun blocks along z); a CTA walks `tiles_per_cta` consecutive
// tiles of one lane, so that its fixed cost (the launch, copying the lane's
// active ids into shared memory) is paid once for several tiles.  Up front
// the CTA finds, by binary search in shared memory, the slots of every
// covering block of all its tiles (one round, all threads) and marks the
// tiles some active block covers.  After that one barrier each warp runs on
// its own: warp w takes the (i, j) row w of every tile, 32 nodes along z,
// one a lane, and writes the row's 384 contiguous bytes as float4 (a warp
// shuffle moves each component to the lane that stores it); a tile none
// covers costs a warp one store.  At config 5's 256 lanes that is 262,144
// warp-tiles, most of them empty, so their instructions count: the walk
// steps the tile coordinates without a division.  The mass, where asked
// for, is one more row per warp and tile: 32 floats, 128 contiguous bytes,
// one store a lane.  An active list out of ascending order
// would make the search miss blocks: its lane gets NaN instead of wrong
// sums.  Indices within a lane are 32-bit, offsets into the (L * A, 16, 216)
// input and the output 64-bit.  The launch bound keeps two CTAs of 512 on an
// SM (at most 64 registers a thread).
__global__ void __launch_bounds__(kK1bThreads, 2)
update_grid_blocks_kernel(const float* __restrict__ win,
                          const int64_t* __restrict__ active, int num_active,
                          int nx, int ny, int nz, float dx, float dt,
                          float gx, float gy, float gz, int wall,
                          int tiles_per_cta, float* __restrict__ vel,
                          float* __restrict__ mass) {
  extern __shared__ int ids[];  // the lane's active block ids
  // [tile][dx * 2 + dy][bz - bz0 + 1]: slot of the covering block, or -1.
  __shared__ int slot[kK1bMaxTiles][4][kK1bSlots];
  __shared__ int covered[kK1bMaxTiles];
  const int nby = ny >> 2, nbz = nz >> 2;
  const int nblocks = (nx >> 2) * nby * nbz;
  const int runs = (nbz + kK1bRun - 1) / kK1bRun;
  const int first = blockIdx.x * tiles_per_cta;
  const int ntiles = min(tiles_per_cta, (nx >> 2) * nby * runs - first);
  const int lane = blockIdx.y;
  const int tid = threadIdx.x;
  const int64_t* act = active + static_cast<int64_t>(lane) * num_active;
  for (int e = tid; e < num_active; e += kK1bThreads) {
    const int64_t id = act[e];
    ids[e] = id < 0 ? -1 : static_cast<int>(id < nblocks ? id : nblocks);
  }
  if (tid < ntiles) covered[tid] = 0;
  __syncthreads();
  bool unsorted = false;
  for (int e = tid; e + 1 < num_active; e += kK1bThreads) {
    unsorted = unsorted || ids[e] > ids[e + 1];
  }
  for (int e = tid; e < ntiles * 4 * kK1bSlots; e += kK1bThreads) {
    const int q = e / (4 * kK1bSlots), p = (e / kK1bSlots) % 4, r = e % kK1bSlots;
    const int t = first + q;
    const int cbx = t / runs / nby - (p >> 1), cby = (t / runs) % nby - (p & 1);
    const int cbz = (t % runs) * kK1bRun + r - 1;
    int s = -1;
    if (cbx >= 0 && cby >= 0 && cbz >= 0 && cbz < nbz) {
      const int id = (cbx * nby + cby) * nbz + cbz;
      int lo = 0, hi = num_active;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (ids[mid] < id) lo = mid + 1; else hi = mid;
      }
      if (lo < num_active && ids[lo] == id) s = lo;
    }
    slot[q][p][r] = s;
    if (s >= 0) covered[q] = 1;
  }
  // Also completes the slot table and the covered marks.
  const bool bad = __syncthreads_or(unsorted);

  // Warp w takes row (a, b') = (w / 4, w % 4) of every tile: 32 nodes along
  // z, one a lane.
  static_assert(kK1bZ == 32 && kK1bThreads == 16 * 32, "a warp per row of a tile");
  const int row = tid >> 5, kk = tid & 31;
  const int a = row >> 2, b = row & 3, c = kk & 3;
  const float g[3] = {gx, gy, gz};
  // The first tile's block coordinates; the loop steps them (z runs, then
  // by, then bx) with no division.
  int run = first % runs, by = first / runs % nby, bx = first / runs / nby;
  for (int q = 0; q < ntiles;
       ++q, run = run + 1 < runs ? run + 1 : 0, by += run == 0,
       bx += run == 0 && by == nby, by = by == nby ? 0 : by) {
    const int bz0 = run * kK1bRun;
    const int zlen = min(kK1bZ, nz - 4 * bz0);  // nodes of the run along z
    const int i = 4 * bx + a, j = 4 * by + b, k = 4 * bz0 + kk;
    // The row's zlen nodes, 12 zlen bytes from node (i, j, 4 bz0) on.
    float4* out4 = reinterpret_cast<float4*>(
        vel + ((static_cast<int64_t>(lane) * nx + i) * ny + j) * static_cast<int64_t>(nz) * 3 +
        12 * bz0);
    const int row_vec = zlen * 3 / 4;
    // The row's zlen masses, from node (i, j, 4 bz0) on (no mass output
    // where `mass` is null); lane kk stores the mass of its node.
    const auto store_mass = [&](float value) {
      if (mass != nullptr && kk < zlen) {
        mass[((static_cast<int64_t>(lane) * nx + i) * ny + j) * static_cast<int64_t>(nz) +
             4 * bz0 + kk] = value;
      }
    };
    if (bad || !covered[q]) {
      const float f = bad ? __int_as_float(0x7fc00000) : 0.f;
      if (kk < row_vec) out4[kk] = make_float4(f, f, f, f);
      store_mass(f);
      continue;
    }
    float v[3] = {0.f, 0.f, 0.f};
    float m = 0.f;
    if (kk < zlen) {
      // Term u = (dx, dy, dz) bits (4, 2, 1): [m, p] of block (bx - dx,
      // by - dy, bz - dz) at window node l, p = u0 + B (x_node - o); 0 where
      // that block does not count.
      float tm[8], tp[3][8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int ox = u >> 2, oy = (u >> 1) & 1, oz = u & 1;
        const bool reach = (ox == 0 || a < 2) && (oy == 0 || b < 2) && (oz == 0 || c < 2);
        const int sl = reach ? slot[q][ox * 2 + oy][(kk >> 2) + 1 - oz] : -1;
        tm[u] = tp[0][u] = tp[1][u] = tp[2][u] = 0.f;
        if (sl >= 0) {
          const int l = ((a + 4 * ox) * 6 + (b + 4 * oy)) * 6 + (c + 4 * oz);
          const float* w = win + (static_cast<int64_t>(lane) * num_active + sl) *
                                     kP2GChannels * kNodes + l;
          const float xl[3] = {static_cast<float>(a + 4 * ox) * dx,
                               static_cast<float>(b + 4 * oy) * dx,
                               static_cast<float>(c + 4 * oz) * dx};
          tm[u] = w[0];
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            const float* B = w + (4 + 3 * r) * kNodes;
            tp[r][u] = w[(1 + r) * kNodes] +
                       fmaf(B[2 * kNodes], xl[2], fmaf(B[kNodes], xl[1], B[0] * xl[0]));
          }
        }
      }
      // ((t000 + t100) + (t010 + t110)) + ((t001 + t101) + (t011 + t111)).
      auto tree = [](const float (&s)[8]) {
        return ((s[0] + s[4]) + (s[2] + s[6])) + ((s[1] + s[5]) + (s[3] + s[7]));
      };
      m = tree(tm);
      if (inside_walls(i, j, k, nx, ny, nz, wall)) {
#pragma unroll
        for (int r = 0; r < 3; ++r) v[r] = grid_velocity(tree(tp[r]), m, dt, g[r]);
      }
    }
    // Lane e writes float4 e of the row, floats 4e .. 4e + 3: float f is
    // component f % 3 of the node of lane f / 3.
    float o[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int f = min(4 * kk + h, 3 * kK1bZ - 1);
      const float v0 = __shfl_sync(0xffffffffu, v[0], f / 3);
      const float v1 = __shfl_sync(0xffffffffu, v[1], f / 3);
      const float v2 = __shfl_sync(0xffffffffu, v[2], f / 3);
      o[h] = f % 3 == 0 ? v0 : (f % 3 == 1 ? v1 : v2);
    }
    if (kk < row_vec) out4[kk] = make_float4(o[0], o[1], o[2], o[3]);
    store_mass(m);
  }
}

// K2 -- blocked P2G.  Replaces _p2g_block_kernel (drake_tpu/ops/
// mpm_kernels.py:267), which DMA'd each active block's sorted particle rows
// into VMEM and contracted them against a factorised one-hot weight matrix
// on the MXU.  Bound on this card: bytes -- packed columns 0:28 read once
// (112 B a particle) and the (A, 16, 216) output written once, empty blocks
// included; the 27 x 13 FMAs a particle are far below that.  What a kernel
// pays beyond the bytes is arithmetic and address work, shared-memory reads
// and the barriers between its phases.  Design: one CTA per active block,
// one warp per (ly, lz) column of the block's cells, walked along x.  Rows
// arrive by 16-byte cp.async in double-buffered chunks of kP2GStageRows, the
// next chunk in flight while this one is walked; the rows are sorted by cell
// with x slowest, so a chunk holds whole x-slabs of the block and every warp
// finds rows of its column in it.  Cell boundaries are found in each staged
// chunk from the sorted base columns.  Within a warp, half-warp h takes
// every second row of a cell and lane c carries value channel c at all 27
// taps of the 3^3 stencil in registers: a row costs a lane one value, nine
// tap weights and 39 multiply-adds, with no coverage test.  The lane's sums
// belong to window nodes x = lx + di; when the walk steps to the next lx the
// sums at di = 0 are complete: the two halves are added (one shuffle) and
// stored, and the others move one x down in registers.  So a warp ends with
// its column's 6 x 3 x 3 node sums in its own part of shared memory, each
// written once.  Last, every output element adds the at most nine columns
// that cover its node, in a fixed order, and is written once: one owner per
// element, a fixed summation order, deterministic, no atomics.  A block with
// no particle only writes zeros.  The halo combine into the dense grid stays
// in PyTorch.  The walk relies on the rows' order: a block whose rows are not
// sorted by cell gets NaN in its 13 live channels instead of wrong sums.
// Lanes need nothing of the kernel: a batch of L problems is one table of
// all lanes' sorted rows and L * A (start, count) entries into it, one CTA
// each; row offsets into the table are taken in 64 bits.
__device__ __forceinline__ void p2g_stage_chunk(float4* dst,
                                                const float* __restrict__ packed,
                                                int64_t first_row, int ld,
                                                int nrows) {
  for (int e = threadIdx.x; e < nrows * kP2GRowVec; e += kP2GThreads) {
    const int r = e / kP2GRowVec, q = e % kP2GRowVec;
    cp_async16(dst + e, packed + (first_row + r) * ld + 4 * q);
  }
}

// Cell in block (lx * 16 + ly * 4 + lz) from a row's packed columns 24:28.
__device__ __forceinline__ int p2g_cell(float4 b) {
  return (clamp03(b.y) * 4 + clamp03(b.z)) * 4 + clamp03(b.w);
}

// The walk steps to the next lx: the nodes at the walk's trailing x are
// complete.  Each half-warp holds the sums over its own rows; their total is
// stored at `done` (nine taps, 6 floats apart) and the other sums move one x
// down.
__device__ __forceinline__ void p2g_slide(float (&acc)[3][9], float* done,
                                          bool store) {
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const float total = acc[0][t] + __shfl_xor_sync(0xffffffffu, acc[0][t], 16);
    if (store) done[t * 6] = total;
    acc[0][t] = acc[1][t];
    acc[1][t] = acc[2][t];
    acc[2][t] = 0.f;
  }
}

__global__ void __launch_bounds__(kP2GThreads, 2)
p2g_block_kernel(const float* __restrict__ packed, int n_rows, int ld,
                 const int* __restrict__ starts,
                 const int* __restrict__ counts, int pmax,
                 float* __restrict__ out) {
  // [2][kP2GStageRows * kP2GRowVec] float4 of rows, then the warps' column
  // sums [16][kP2GLive][kP2GColNodes] float.
  extern __shared__ float4 smem[];
  __shared__ int cell_start[65];
  // The last cell of each of the two chunks walked last, and whether any row
  // came before its predecessor in cell order.
  __shared__ int last_cell[2];
  __shared__ int out_of_order;
  static_assert(kP2GStageRows < kP2GThreads, "one thread per staged row + 1");
  constexpr int kStageVec = kP2GStageRows * kP2GRowVec;
  constexpr int kLive = kP2GLive * kNodes;  // floats of the live channels
  float4* rows = smem;
  float* part = reinterpret_cast<float*>(smem + 2 * kStageVec);
  const int a = blockIdx.x;
  const int tid = threadIdx.x;
  const int start = starts[a];
  const int count = block_count(start, counts[a], pmax, n_rows);
  float* o = out + static_cast<int64_t>(a) * kP2GChannels * kNodes;
  // Channels 13:16, and every channel of a block with no particle.
  const int first_zero = count == 0 ? 0 : kLive / 4;
  for (int e = first_zero + tid; e < kP2GChannels * kNodes / 4; e += kP2GThreads) {
    reinterpret_cast<float4*>(o)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (count == 0) return;

  const int nchunks = (count + kP2GStageRows - 1) / kP2GStageRows;
  p2g_stage_chunk(rows, packed, start, ld, min(kP2GStageRows, count));
  cp_async_commit();
  // Rows out of cell order leave entries unset; 0 keeps them in the stage.
  if (tid < 65) cell_start[tid] = 0;
  if (tid == 0) {
    last_cell[1] = -1;  // chunk 0 compares its first row with this
    out_of_order = 0;
  }

  const int warp = tid >> 5, lane = tid & 31;
  // Lanes 13..15 of a half-warp repeat channel 12 and store nothing.
  const int half = lane >> 4;
  const int c = min(lane & 15, kP2GLive - 1);
  const bool store = half == 0 && (lane & 15) < kP2GLive;
  float* mine = part + (warp * kP2GLive + c) * kP2GColNodes;
  float acc[3][9];  // [di][dj * 3 + dk], of window nodes x = lx + di
#pragma unroll
  for (int d = 0; d < 3; ++d) {
#pragma unroll
    for (int t = 0; t < 9; ++t) acc[d][t] = 0.f;
  }
  int lx = 0;

  for (int ch = 0; ch < nchunks; ++ch) {
    const int c0 = ch * kP2GStageRows;
    const int nrows = min(kP2GStageRows, count - c0);
    if (ch + 1 < nchunks) {
      p2g_stage_chunk(rows + ((ch + 1) & 1) * kStageVec, packed,
                      static_cast<int64_t>(start) + c0 + kP2GStageRows, ld,
                      min(kP2GStageRows, count - c0 - kP2GStageRows));
    }
    cp_async_commit();
    cp_async_wait<1>();  // this chunk has landed; the next may be in flight
    __syncthreads();
    const float4* chunk = rows + (ch & 1) * kStageVec;
    // cell_start[c] = first staged row of cell c or later, from the sorted
    // local bases of the rows: row r sets the entries of the cells that begin
    // between its predecessor and itself, thread nrows those past the last.
    if (tid <= nrows) {
      int prev = -1, cur = 64;
      if (tid > 0) prev = p2g_cell(chunk[(tid - 1) * kP2GRowVec + 6]);
      if (tid < nrows) cur = p2g_cell(chunk[tid * kP2GRowVec + 6]);
      for (int cell = prev + 1; cell <= cur; ++cell) cell_start[cell] = tid;
      // The walk needs every row at or after its predecessor's cell, across
      // chunks too (the first row against the last of the chunk before).
      if (cur < (tid > 0 ? prev : last_cell[(ch & 1) ^ 1])) out_of_order = 1;
      if (tid == nrows) last_cell[ch & 1] = prev;
    }
    __syncthreads();
    for (int x = 0; x < 4; ++x) {
      const int r_begin = cell_start[16 * x + warp];
      const int r_end = min(cell_start[16 * x + warp + 1], nrows);
      if (r_begin >= r_end) continue;
      for (; lx < x; ++lx) p2g_slide(acc, mine + lx, store);
      for (int r = r_begin; r < r_end; r += 2) {
        // An odd run's last step: the second half repeats the last row with
        // value 0.
        const bool valid = r + half < r_end;
        const float4* p4 = chunk + min(r + half, r_end - 1) * kP2GRowVec;
        const float* p = reinterpret_cast<const float*>(p4);
        const float4 t0 = p4[4], t1 = p4[5];
        const float wx[3] = {t0.x, t0.y, t0.z};
        const float wy[3] = {t0.w, t1.x, t1.y};
        const float wz[3] = {t1.z, t1.w, p[24]};
        const float v = valid ? p[c] : 0.f;
#pragma unroll
        for (int di = 0; di < 3; ++di) {
          const float vx = v * wx[di];
#pragma unroll
          for (int dj = 0; dj < 3; ++dj) {
            const float vxy = vx * wy[dj];
#pragma unroll
            for (int dk = 0; dk < 3; ++dk) acc[di][dj * 3 + dk] += vxy * wz[dk];
          }
        }
      }
    }
    __syncthreads();  // chunk and cell_start are free for the next round
  }
  for (; lx < 6; ++lx) p2g_slide(acc, mine + lx, store);
  __syncthreads();

  // Window node (i, j, k) is tap (dy, dz) of column (j - dy, k - dz) where
  // that column exists; the nine are added in a fixed order.  Two threads a
  // node, one for the even and one for the odd channels.
  if (tid < 2 * kNodes) {
    const int node = tid % kNodes;
    const int i = node / 36, j = (node / 6) % 6, k = node % 6;
    bool covers[3][3];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        covers[dy][dz] = j - dy >= 0 && j - dy <= 3 && k - dz >= 0 && k - dz <= 3;
      }
    }
    const bool unsorted = out_of_order != 0;
    for (int ch = tid / kNodes; ch < kP2GLive; ch += 2) {
      // Tap (0, 0) of column (j, k); the others sit at fixed offsets from it.
      const float* at = part + ((j * 4 + k) * kP2GLive + ch) * kP2GColNodes + i;
      float sum = 0.f;
#pragma unroll
      for (int dy = 2; dy >= 0; --dy) {
#pragma unroll
        for (int dz = 2; dz >= 0; --dz) {
          if (covers[dy][dz]) {
            sum += at[(dy * 3 + dz) * 6 -
                      (dy * 4 + dz) * kP2GLive * kP2GColNodes];
          }
        }
      }
      o[ch * kNodes + node] = unsorted ? __int_as_float(0x7fc00000) : sum;
    }
  }
}

// K3 -- blocked G2P.  Replaces _g2p_block_kernel (drake_tpu/ops/
// mpm_kernels.py:536), which rebuilt the factorised weights per block in
// VMEM and contracted them with the block's node-velocity window on the MXU.
// Output: one row of 24 per sorted row, written at the row's index in the
// packed table (block a's particle s at row starts[a] + s); rows that no
// block takes are not written.  Over lanes the CTAs of all lanes' blocks
// index the one sorted table of all lanes' rows.  Bound on this card: bytes
// -- packed columns 16:40 and the 24 outputs of every taken row (192 B a
// particle) and the (L A, 216, 12) windows read once; 27 taps x 12 channels
// of FMAs a particle are far below that.  Design: one CTA per (lane, block).
// A block with no particle returns at once.  Otherwise the 216 x 12 window
// is copied into shared memory once (cp.async) and read as three float4 a
// node; each warp takes every kG2PWarps-th chunk of 32 rows and needs no
// block-wide barrier after the window: it copies its chunk's packed columns
// 16:40 (96 B a row) into its own double-buffered stage with 16-byte
// cp.async, the next chunk in flight while this one is computed; each lane
// reads its row from the stage (row stride 7 float4, conflict free),
// computes the 27 taps and the particle update, and writes the 24 results
// back into its own row of the stage; the warp then writes the chunk's rows
// out as consecutive float4 (a row's 96 B start 16-byte aligned).  Rows
// sorted by cell make neighbouring lanes read the same window nodes
// (broadcasts).
__device__ __forceinline__ void g2p_stage_chunk(float4* dst,
                                                const float* __restrict__ packed,
                                                int64_t first_row, int ld,
                                                int nrows, int lane) {
  for (int e = lane; e < nrows * kG2PRowVec; e += 32) {
    const int r = e / kG2PRowVec, q = e % kG2PRowVec;
    cp_async16(dst + r * kG2PRowStride + q,
               packed + (first_row + r) * ld + 16 + 4 * q);
  }
}

__global__ void __launch_bounds__(kG2PWarps * 32)
g2p_block_kernel(const float* __restrict__ packed, int n_rows, int ld,
                 const float* __restrict__ vel_ext,
                 const int* __restrict__ starts,
                 const int* __restrict__ counts, int pmax, float dxi2,
                 float dt, float* __restrict__ out) {
  constexpr int kThreads = kG2PWarps * 32;
  constexpr int kWinVec = kNodes * kG2PChannels / 4;
  __shared__ float4 win[kWinVec];
  __shared__ float4 stage[kG2PWarps][2][32 * kG2PRowStride];
  const int64_t a = blockIdx.x;
  const int tid = threadIdx.x;
  const int start = starts[a];
  const int count = block_count(start, counts[a], pmax, n_rows);
  if (count == 0) return;
  float4* o4 = reinterpret_cast<float4*>(out + static_cast<int64_t>(start) * kG2POut);

  const float4* src4 = reinterpret_cast<const float4*>(vel_ext + a * kNodes * kG2PChannels);
  for (int e = tid; e < kWinVec; e += kThreads) cp_async16(win + e, src4 + e);
  cp_async_commit();
  const int warp = tid >> 5, lane = tid & 31;
  const int nchunks = (count + 31) / 32;
  if (warp < nchunks) {
    g2p_stage_chunk(stage[warp][0], packed,
                    static_cast<int64_t>(start) + warp * 32, ld,
                    min(32, count - warp * 32), lane);
  }
  cp_async_commit();
  cp_async_wait<1>();  // the window; the first chunk may be in flight
  __syncthreads();

  int buf = 0;
  for (int c = warp; c < nchunks; c += kG2PWarps) {
    const int s0 = c * 32;
    const int nslots = min(32, count - s0);
    float4* og = o4 + static_cast<int64_t>(s0) * kG2PRowVec;
    const int s_next = s0 + kG2PWarps * 32;
    if (s_next < count) {
      g2p_stage_chunk(stage[warp][buf ^ 1], packed,
                      static_cast<int64_t>(start) + s_next, ld,
                      min(32, count - s_next), lane);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this chunk has landed; the next may be in flight
    __syncwarp();
    float4* st = stage[warp][buf];
    float4* mine = st + lane * kG2PRowStride;
    if (lane < nslots) {
      const float4 q0 = mine[0], q1 = mine[1], q2 = mine[2];
      const float4 q3 = mine[3], q4 = mine[4], q5 = mine[5];
      const float wx[3] = {q0.x, q0.y, q0.z};
      const float wy[3] = {q0.w, q1.x, q1.y};
      const float wz[3] = {q1.z, q1.w, q2.x};
      // The local base is 0..3 by construction; the clamp keeps a corrupt
      // row inside the shared-memory window.
      const int base = (clamp03(q2.y) * 6 + clamp03(q2.z)) * 6 + clamp03(q2.w);
      const float x[3] = {q3.x, q3.y, q3.z};
      const float F[3][3] = {{q3.w, q4.x, q4.y}, {q4.z, q4.w, q5.x},
                             {q5.y, q5.z, q5.w}};
      float g[kG2PChannels];
#pragma unroll
      for (int ch = 0; ch < kG2PChannels; ++ch) g[ch] = 0.f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float wxy = wx[i] * wy[j];
          const float4* node = win + (base + i * 36 + j * 6) * 3;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float w = wxy * wz[k];
            const float4 n0 = node[3 * k], n1 = node[3 * k + 1], n2 = node[3 * k + 2];
            g[0] += w * n0.x; g[1] += w * n0.y; g[2] += w * n0.z; g[3] += w * n0.w;
            g[4] += w * n1.x; g[5] += w * n1.y; g[6] += w * n1.z; g[7] += w * n1.w;
            g[8] += w * n2.x; g[9] += w * n2.y; g[10] += w * n2.z; g[11] += w * n2.w;
          }
        }
      }
      // g[3 + 3 * c + r] = sum_l w v_r n_c, so C[r][c] = dxi2 (sum w v_r n_c
      // - v_r x_c).
      float C[3][3], o[kG2POut];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c) C[r][c] = dxi2 * (g[3 + 3 * c + r] - g[r] * x[c]);
      }
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        o[r] = x[r] + dt * g[r];
        o[3 + r] = g[r];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float f = 0.f;
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            f += ((r == q ? 1.f : 0.f) + dt * C[r][q]) * F[q][c];
          }
          o[6 + 3 * r + c] = f;
          o[15 + 3 * r + c] = C[r][c];
        }
      }
#pragma unroll
      for (int q = 0; q < kG2PRowVec; ++q) {
        mine[q] = make_float4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
      }
    }
    __syncwarp();
    for (int e = lane; e < nslots * kG2PRowVec; e += 32) {
      og[e] = st[(e / kG2PRowVec) * kG2PRowStride + e % kG2PRowVec];
    }
    __syncwarp();  // the stage is free for the chunk after next
    buf ^= 1;
  }
}

}  // namespace

extern "C" {

int mpm_update_grid(const float* mass, const float* mom, float* vel, int lanes,
                    int nx, int ny, int nz, float dt, float gx, float gy,
                    float gz, int wall, void* stream) {
  const int64_t n_nodes = static_cast<int64_t>(nx) * ny * nz;
  const int64_t blocks = (n_nodes + kK1Threads - 1) / kK1Threads;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(lanes));
  update_grid_kernel<<<grid, kK1Threads, 0, static_cast<cudaStream_t>(stream)>>>(
      mass, mom, vel, nx, ny, nz, dt, gx, gy, gz, wall);
  return static_cast<int>(cudaGetLastError());
}

int mpm_update_grid_blocks(const float* win, const int64_t* active, int lanes,
                           int num_active, int nx, int ny, int nz, float dx,
                           float dt, float gx, float gy, float gz, int wall,
                           float* vel, float* mass, void* stream) {
  // Tiles of a lane, split evenly over CTAs so that all lanes' CTAs number
  // at most about four per SM (two are resident at a time), a CTA at most
  // kK1bMaxTiles tiles.
  const int tiles = (nx / 4) * (ny / 4) * ((nz / 4 + kK1bRun - 1) / kK1bRun);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t wanted = (static_cast<int64_t>(tiles) * lanes + 4 * sms - 1) / (4 * sms);
  const int per = static_cast<int>(wanted < kK1bMaxTiles ? wanted : kK1bMaxTiles);
  const int ctas = (tiles + per - 1) / per;
  const int tiles_per_cta = (tiles + ctas - 1) / ctas;
  const int smem = num_active * static_cast<int>(sizeof(int));
  if (smem > 32 * 1024) {
    err = cudaFuncSetAttribute(update_grid_blocks_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(ctas), static_cast<unsigned>(lanes));
  update_grid_blocks_kernel<<<grid, kK1bThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      win, active, num_active, nx, ny, nz, dx, dt, gx, gy, gz, wall,
      tiles_per_cta, vel, mass);
  return static_cast<int>(cudaGetLastError());
}

int mpm_empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

int mpm_p2g_block(const float* packed, int n_rows, int ld, const int* starts,
                  const int* counts, int num_blocks, int pmax, float* out,
                  void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      p2g_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kP2GSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  p2g_block_kernel<<<num_blocks, kP2GThreads, kP2GSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      packed, n_rows, ld, starts, counts, pmax, out);
  return static_cast<int>(cudaGetLastError());
}

int mpm_g2p_block(const float* packed, int n_rows, int ld,
                  const float* vel_ext, const int* starts, const int* counts,
                  int num_blocks, int pmax, float dxi2, float dt, float* out,
                  void* stream) {
  g2p_block_kernel<<<num_blocks, kG2PWarps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      packed, n_rows, ld, vel_ext, starts, counts, pmax, dxi2, dt, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
