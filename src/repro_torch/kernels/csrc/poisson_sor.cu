// Packed red-black SOR slab smoother: one block-Jacobi round.
//
// Replaces the Pallas TPU kernel rb_sor_packed_slab_kernel /
// rb_sor_slabs_packed (src/repro/kernels/poisson/kernel.py:106-175).
//
// What it computes: for every env and every x-slab, `inner_iters` red+black
// SOR sweep pairs on the slab's packed planes, with single-parity ghost
// columns frozen for the call (the neighbour slab's packed edge columns;
// Neumann inlet / Dirichlet-0 outlet at the domain ends).
//
// What bounds it on an H100: a whole solve (rb_sor_planes: 13 rounds of 4
// pairs at iters=50) is bound by operations: ~10 flops per grid point and
// pair (two of them divisions) against planes read and written once, ~43
// flop/byte at the res-16 training shape, above the fp32 ridge (~20).  One
// round alone (4 pairs) is ~3.3 flop/byte, so a single launch is bound by
// its bytes; the rounds are separate launches because the block-Jacobi
// ghosts are refreshed between them.
//
// Design: grid (nslabs, n_env), one block per slab of one env.  The
// block's four planes (red, black, rhs_r, rhs_b: 185,856 bytes for the
// res-16 grid) live in dynamic shared memory for all `inner_iters` pairs,
// so global memory is touched once on the way in and once on the way out;
// a __syncthreads() separates the half-sweeps (Gauss-Seidel order).  Only
// n_env * nslabs of the 132 SMs are busy: the parallelism across a slab is
// the block's 1024 threads.
#include <cuda_runtime.h>

#include "sor_packed.cuh"

__global__ void __launch_bounds__(1024) rb_sor_slab_packed_kernel(
    const float* __restrict__ red_in, const float* __restrict__ black_in,
    const float* __restrict__ rhs_r_in, const float* __restrict__ rhs_b_in,
    float* __restrict__ red_out, float* __restrict__ black_out, int ny, int w,
    int nslabs, int inner_iters, float dx2, float dy2, float inv_diag,
    float om, float one_m_om) {
  extern __shared__ float smem[];
  const int bxp = w / nslabs;
  const int s = blockIdx.x;
  const int n = ny * bxp;
  float* red = smem;
  float* black = red + n;
  float* rhs_r = black + n;
  float* rhs_b = rhs_r + n;
  float* r_lg = rhs_b + n;
  float* r_rg = r_lg + ny;
  float* b_lg = r_rg + ny;
  float* b_rg = b_lg + ny;
  const size_t base = static_cast<size_t>(blockIdx.y) * ny * w;
  const int c0 = s * bxp;

  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int j = idx / bxp;
    const size_t g = base + static_cast<size_t>(j) * w + c0 + (idx - j * bxp);
    red[idx] = red_in[g];
    black[idx] = black_in[g];
    rhs_r[idx] = rhs_r_in[g];
    rhs_b[idx] = rhs_b_in[g];
  }
  // frozen single-parity ghosts: a red update's west/east neighbours are
  // black, so its interior ghosts are the neighbour slab's black edge
  // columns (and vice versa); at the domain ends the ghost has the update
  // parity (Neumann inlet = own first column, Dirichlet outlet = -own last)
  for (int j = threadIdx.x; j < ny; j += blockDim.x) {
    const size_t row = base + static_cast<size_t>(j) * w;
    const size_t first = row + c0, last = row + c0 + bxp - 1;
    r_lg[j] = s == 0 ? red_in[first] : black_in[first - 1];
    r_rg[j] = s == nslabs - 1 ? -red_in[last] : black_in[last + 1];
    b_lg[j] = s == 0 ? black_in[first] : red_in[first - 1];
    b_rg[j] = s == nslabs - 1 ? -black_in[last] : red_in[last + 1];
  }
  __syncthreads();

  for (int it = 0; it < inner_iters; ++it) {
    packed_half_sweep(red, black, rhs_r, r_lg, r_rg, ny, bxp, 1, dx2, dy2,
                      inv_diag, om, one_m_om);
    __syncthreads();
    packed_half_sweep(black, red, rhs_b, b_lg, b_rg, ny, bxp, 0, dx2, dy2,
                      inv_diag, om, one_m_om);
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int j = idx / bxp;
    const size_t g = base + static_cast<size_t>(j) * w + c0 + (idx - j * bxp);
    red_out[g] = red[idx];
    black_out[g] = black[idx];
  }
}

// smem: the block's dynamic shared memory in bytes, four slab planes and
// four ghost columns (computed by the wrapper, kernels/poisson/ops.py
// smem_bytes).  Launch on `stream`; returns the CUDA error code (0 =
// launched).
extern "C" int rb_sor_slabs_packed_launch(
    const float* red, const float* black, const float* rhs_r,
    const float* rhs_b, float* red_out, float* black_out, int n_env, int ny,
    int w, int nslabs, int inner_iters, int smem, float dx2, float dy2,
    float inv_diag, float om, float one_m_om, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      rb_sor_slab_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nslabs, n_env);
  rb_sor_slab_packed_kernel<<<grid, threads_for(ny * (w / nslabs)), smem,
                              static_cast<cudaStream_t>(stream)>>>(
      red, black, rhs_r, rhs_b, red_out, black_out, ny, w, nslabs,
      inner_iters, dx2, dy2, inv_diag, om, one_m_om);
  return static_cast<int>(cudaGetLastError());
}
