// Full-grid red-black SOR slab smoother: one block-Jacobi round.
//
// Replaces the Pallas TPU kernel rb_sor_slab_kernel / rb_sor_slabs
// (src/repro/kernels/poisson/kernel.py:37-87), the masked full-grid
// smoother behind rb_sor(packed=False).
//
// What it computes: for every env and every x-slab of width bx, `inner_iters`
// red+black SOR sweep pairs on the slab of the full (ny, nx) grid.  The
// ghost columns are frozen for the call: the neighbour slab's edge column,
// or at the domain ends the launch-time inlet column (Neumann) and the
// negated launch-time outlet column (Dirichlet 0).  The wall ghost rows are
// the point's own value, read live at every half-sweep (Neumann).  Red
// points have (i + j) even, i the slab-local column: bx is even, so that is
// the global checkerboard too.
//
// What bounds it on an H100: a whole solve (13 rounds of 4 pairs at
// iters=50) does ~10 flops per grid point and pair (two of them
// divisions) against p and rhs read and p written once: ~43 flop/byte at the
// res-16 shape, above the fp32 ridge (~20), so operations.  One round alone
// (4 pairs) is bound by its bytes; rounds are separate launches because the
// block-Jacobi ghosts are refreshed between them.
//
// Design: grid (nslabs, n_env), one block per slab of one env.  The slab's
// p and rhs (185,856 bytes for the whole res-16 grid) and its two frozen
// ghost columns live in dynamic shared memory for all `inner_iters` pairs.
// A half-sweep visits only the points of its colour (half the work of the
// TPU kernel's masked update, same values): their four neighbours have the
// other colour, so the in-place update equals the reference's
// out-of-place `where`.  A __syncthreads() separates the half-sweeps.
#include <cuda_runtime.h>

#include "common.cuh"

// One coloured half-sweep over the (ny, bx) slab `p` in shared memory.
// colour 0 updates (i + j) even, 1 the odd points.  The association is the
// reference's: nb = (w + e) / dx2 + (n + s) / dy2, p_gs = (nb - rhs) *
// inv_diag, then (1 - om) * p + om * p_gs.
__device__ __forceinline__ void full_half_sweep(
    float* p, const float* rhs, const float* lg, const float* rg, int ny,
    int bx, int colour, float dx2, float dy2, float inv_diag, float om,
    float one_m_om) {
  const int half = bx >> 1;
  const int n = ny * half;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int j = idx / half;
    const int i = 2 * (idx - j * half) + ((j + colour) & 1);
    const int at = j * bx + i;
    const float self = p[at];
    const float west = i == 0 ? lg[j] : p[at - 1];
    const float east = i == bx - 1 ? rg[j] : p[at + 1];
    const float north = j == 0 ? self : p[at - bx];
    const float south = j == ny - 1 ? self : p[at + bx];
    const float nb = (west + east) / dx2 + (north + south) / dy2;
    const float p_gs = (nb - rhs[at]) * inv_diag;
    p[at] = one_m_om * self + om * p_gs;
  }
}

__global__ void __launch_bounds__(1024) rb_sor_slab_full_kernel(
    const float* __restrict__ p_in, const float* __restrict__ rhs_in,
    float* __restrict__ p_out, int ny, int nx, int nslabs, int inner_iters,
    float dx2, float dy2, float inv_diag, float om, float one_m_om) {
  extern __shared__ float smem[];
  const int bx = nx / nslabs;
  const int s = blockIdx.x;
  const int n = ny * bx;
  float* p = smem;
  float* rhs = p + n;
  float* lg = rhs + n;
  float* rg = lg + ny;
  const size_t base = static_cast<size_t>(blockIdx.y) * ny * nx;
  const int c0 = s * bx;

  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int j = idx / bx;
    const size_t g = base + static_cast<size_t>(j) * nx + c0 + (idx - j * bx);
    p[idx] = p_in[g];
    rhs[idx] = rhs_in[g];
  }
  for (int j = threadIdx.x; j < ny; j += blockDim.x) {
    const size_t row = base + static_cast<size_t>(j) * nx;
    lg[j] = s == 0 ? p_in[row + c0] : p_in[row + c0 - 1];
    rg[j] = s == nslabs - 1 ? -p_in[row + c0 + bx - 1] : p_in[row + c0 + bx];
  }
  __syncthreads();

  for (int it = 0; it < inner_iters; ++it) {
    full_half_sweep(p, rhs, lg, rg, ny, bx, 0, dx2, dy2, inv_diag, om,
                    one_m_om);
    __syncthreads();
    full_half_sweep(p, rhs, lg, rg, ny, bx, 1, dx2, dy2, inv_diag, om,
                    one_m_om);
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int j = idx / bx;
    p_out[base + static_cast<size_t>(j) * nx + c0 + (idx - j * bx)] = p[idx];
  }
}

// smem: the block's dynamic shared memory in bytes, the slab's p and rhs and
// two ghost columns (computed by the wrapper, kernels/poisson/ops.py
// full_smem_bytes).  Launch on `stream`; returns the CUDA error code (0 =
// launched).
extern "C" int rb_sor_slabs_full_launch(
    const float* p, const float* rhs, float* p_out, int n_env, int ny, int nx,
    int nslabs, int inner_iters, int smem, float dx2, float dy2,
    float inv_diag, float om, float one_m_om, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      rb_sor_slab_full_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nslabs, n_env);
  rb_sor_slab_full_kernel<<<grid, threads_for(ny * (nx / nslabs) / 2), smem,
                            static_cast<cudaStream_t>(stream)>>>(
      p, rhs, p_out, ny, nx, nslabs, inner_iters, dx2, dy2, inv_diag, om,
      one_m_om);
  return static_cast<int>(cudaGetLastError());
}
