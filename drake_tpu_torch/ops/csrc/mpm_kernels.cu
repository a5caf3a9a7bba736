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
// Packed particle rows (row stride `ld` floats, block-sorted):
//   0:16 values [m, u0 = m v - B x (3), B (9), pad (3)]
//   16:25 B-spline taps [wx0..2, wy0..2, wz0..2]   25:28 local base (0..3)
//   28:31 x   31:40 F (row-major)
// Block window node l = (i * 6 + j) * 6 + k, i/j/k the local offsets 0..5.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kNodes = 216;         // 6^3 window nodes of a 4^3-cell block
constexpr int kP2GChannels = 16;    // output channels of K2
constexpr int kP2GLive = 13;        // m, u0, B; channels 13:16 are written 0
constexpr int kStageRows = 128;     // particle rows staged per chunk (K2)
constexpr int kStageCols = 28;      // packed columns K2 reads
constexpr int kG2PChannels = 12;    // [v, v*node_x, v*node_y, v*node_z]
constexpr int kG2POut = 24;         // [x_new, v_new, F_new, C_new]

// Particles of a block that the kernels read: at most pmax, and never a row
// outside [0, n_rows) -- the wrapper cannot check device-side starts and
// counts without a host sync, so the bound is enforced here.
__device__ __forceinline__ int block_count(int start, int count, int pmax,
                                           int n_rows) {
  if (start < 0 || start >= n_rows) return 0;
  return max(0, min(min(count, pmax), n_rows - start));
}

// K1 -- grid update.  Replaces _update_grid_kernel (drake_tpu/ops/
// mpm_kernels.py:59), which ran one (ny, nz) x-slab per grid step in VMEM.
// Bound on this card: device memory, ~28 B moved per node (mass + 3 momentum
// in, 3 velocity out) and a handful of flops.  Design: one thread per node,
// consecutive threads on consecutive z so every load and store is coalesced;
// the wall mask is recomputed from the index instead of read.
__global__ void update_grid_kernel(const float* __restrict__ mass,
                                   const float* __restrict__ mom,
                                   float* __restrict__ vel, int nx, int ny,
                                   int nz, float dt, float gx, float gy,
                                   float gz, int wall) {
  const int64_t n_nodes = static_cast<int64_t>(nx) * ny * nz;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n_nodes) return;
  const int k = static_cast<int>(idx % nz);
  const int j = static_cast<int>((idx / nz) % ny);
  const int i = static_cast<int>(idx / (static_cast<int64_t>(ny) * nz));
  const bool inside = i >= wall && i < nx - wall && j >= wall &&
                      j < ny - wall && k >= wall && k < nz - wall;
  const float m = mass[idx];
  const bool active = m > 0.f;
  const float denom = fmaxf(m, 1e-12f);
  const float g[3] = {gx, gy, gz};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v = active ? mom[c * n_nodes + idx] / denom + dt * g[c] : 0.f;
    vel[c * n_nodes + idx] = inside ? v : 0.f;
  }
}

// K2 -- blocked P2G.  Replaces _p2g_block_kernel (drake_tpu/ops/
// mpm_kernels.py:267), which DMA'd each active block's sorted particle rows
// into VMEM and contracted them against a factorised one-hot weight matrix
// on the MXU.  Bound on this card: the weight test and 13 FMAs per
// (particle, covered node) pair in registers -- about 27 * 13 FMAs per
// particle -- plus one read of 28 floats per particle; no tensor-core shape
// fits a 216 x 13 product with a ragged particle count.  Design: one CTA per
// active block; the block's rows are staged through shared memory in chunks
// of kStageRows (every thread then reads the same row: a broadcast, no bank
// conflicts); one thread per window node walks the staged particles in
// sorted order and accumulates the 13 live channels in registers for the
// particles whose 3^3 stencil covers its node.  Each output element has one
// owner and a fixed summation order: deterministic, no atomics.  The halo
// combine into the dense grid stays in PyTorch.
__global__ void __launch_bounds__(256)
p2g_block_kernel(const float* __restrict__ packed, int n_rows, int ld,
                 const int* __restrict__ starts,
                 const int* __restrict__ counts, int pmax,
                 float* __restrict__ out) {
  __shared__ float rows[kStageRows][kStageCols];
  const int a = blockIdx.x;
  const int start = starts[a];
  const int count = block_count(start, counts[a], pmax, n_rows);
  const int l = threadIdx.x;
  const int li = l / 36, lj = (l / 6) % 6, lk = l % 6;
  float acc[kP2GLive];
#pragma unroll
  for (int c = 0; c < kP2GLive; ++c) acc[c] = 0.f;

  for (int c0 = 0; c0 < count; c0 += kStageRows) {
    const int nrows = min(kStageRows, count - c0);
    __syncthreads();  // the previous chunk is fully consumed
    for (int e = threadIdx.x; e < nrows * kStageCols; e += blockDim.x) {
      const int r = e / kStageCols, c = e % kStageCols;
      rows[r][c] = packed[static_cast<int64_t>(start + c0 + r) * ld + c];
    }
    __syncthreads();
    if (l < kNodes) {
      for (int r = 0; r < nrows; ++r) {
        const float* p = rows[r];
        const int di = li - static_cast<int>(p[25]);
        const int dj = lj - static_cast<int>(p[26]);
        const int dk = lk - static_cast<int>(p[27]);
        if (static_cast<unsigned>(di) < 3u && static_cast<unsigned>(dj) < 3u &&
            static_cast<unsigned>(dk) < 3u) {
          const float w = p[16 + di] * p[19 + dj] * p[22 + dk];
#pragma unroll
          for (int c = 0; c < kP2GLive; ++c) acc[c] += w * p[c];
        }
      }
    }
  }
  if (l < kNodes) {
    float* o = out + static_cast<int64_t>(a) * kP2GChannels * kNodes + l;
#pragma unroll
    for (int c = 0; c < kP2GLive; ++c) o[c * kNodes] = acc[c];
#pragma unroll
    for (int c = kP2GLive; c < kP2GChannels; ++c) o[c * kNodes] = 0.f;
  }
}

// K3 -- blocked G2P.  Replaces _g2p_block_kernel (drake_tpu/ops/
// mpm_kernels.py:536), which rebuilt the factorised weights per block in
// VMEM and contracted them with the block's node-velocity window on the MXU.
// Bound on this card: 27 taps x 12 channels of shared-memory reads and FMAs
// per particle, the 40-float particle row read, and the (A, pmax, 24) output
// write (empty slots included).  Design: one CTA per active block loads the
// block's 216 x 12 window (10.4 KB) into shared memory once; one thread per
// particle slot computes its 27 taps, reads the window, and writes the
// whole particle update (x, v, F, C); slots past counts[a] are written 0.
// No alignment window: block a's particle s sits at slot s.
__global__ void __launch_bounds__(128)
g2p_block_kernel(const float* __restrict__ packed, int n_rows, int ld,
                 const float* __restrict__ vel_ext,
                 const int* __restrict__ starts,
                 const int* __restrict__ counts, int pmax, float dxi2,
                 float dt, float* __restrict__ out) {
  __shared__ float win[kNodes * kG2PChannels];
  const int a = blockIdx.x;
  const float* src = vel_ext + static_cast<int64_t>(a) * kNodes * kG2PChannels;
  for (int e = threadIdx.x; e < kNodes * kG2PChannels; e += blockDim.x) {
    win[e] = src[e];
  }
  __syncthreads();
  const int start = starts[a];
  const int count = block_count(start, counts[a], pmax, n_rows);

  for (int s = threadIdx.x; s < pmax; s += blockDim.x) {
    float* o = out + (static_cast<int64_t>(a) * pmax + s) * kG2POut;
    if (s >= count) {
#pragma unroll
      for (int c = 0; c < kG2POut; ++c) o[c] = 0.f;
      continue;
    }
    const float* p = packed + static_cast<int64_t>(start + s) * ld;
    // The local base is 0..3 by construction; the clamp keeps a corrupt row
    // inside the shared-memory window.
    const int lbx = min(max(static_cast<int>(p[25]), 0), 3);
    const int lby = min(max(static_cast<int>(p[26]), 0), 3);
    const int lbz = min(max(static_cast<int>(p[27]), 0), 3);
    float g[kG2PChannels];
#pragma unroll
    for (int c = 0; c < kG2PChannels; ++c) g[c] = 0.f;
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) {
        const float wxy = p[16 + i] * p[19 + j];
        const float* row = win + ((lbx + i) * 36 + (lby + j) * 6 + lbz) * kG2PChannels;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float w = wxy * p[22 + k];
#pragma unroll
          for (int c = 0; c < kG2PChannels; ++c) {
            g[c] += w * row[k * kG2PChannels + c];
          }
        }
      }
    }
    float x[3], F[3][3], C[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      x[r] = p[28 + r];
#pragma unroll
      for (int c = 0; c < 3; ++c) F[r][c] = p[31 + 3 * r + c];
    }
    // g[3 + 3 * c + r] = sum_l w v_r n_c, so C[r][c] = dxi2 (sum w v_r n_c
    // - v_r x_c).
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
  }
}

}  // namespace

extern "C" {

int mpm_update_grid(const float* mass, const float* mom, float* vel, int nx,
                    int ny, int nz, float dt, float gx, float gy, float gz,
                    int wall, void* stream) {
  const int64_t n_nodes = static_cast<int64_t>(nx) * ny * nz;
  const int threads = 256;
  const int64_t blocks = (n_nodes + threads - 1) / threads;
  update_grid_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      mass, mom, vel, nx, ny, nz, dt, gx, gy, gz, wall);
  return static_cast<int>(cudaGetLastError());
}

int mpm_p2g_block(const float* packed, int n_rows, int ld, const int* starts,
                  const int* counts, int num_blocks, int pmax, float* out,
                  void* stream) {
  p2g_block_kernel<<<num_blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      packed, n_rows, ld, starts, counts, pmax, out);
  return static_cast<int>(cudaGetLastError());
}

int mpm_g2p_block(const float* packed, int n_rows, int ld,
                  const float* vel_ext, const int* starts, const int* counts,
                  int num_blocks, int pmax, float dxi2, float dt, float* out,
                  void* stream) {
  g2p_block_kernel<<<num_blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      packed, n_rows, ld, vel_ext, starts, counts, pmax, dxi2, dt, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
