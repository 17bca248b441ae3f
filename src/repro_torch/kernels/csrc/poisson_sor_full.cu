// Full-grid red-black SOR slab smoother: `rounds` block-Jacobi rounds in
// one launch, one thread-block cluster per (grid, slab).
//
// Replaces the Pallas TPU kernel rb_sor_slab_kernel / rb_sor_slabs
// (src/repro/kernels/poisson/kernel.py:37-87), the masked full-grid
// smoother behind rb_sor(packed=False), which runs ONE round per call; the
// reference's rb_sor chains ceil(iters / inner_iters) calls.
//
// What it computes: for every grid and every x-slab of width bx (even),
// per round, `inner_iters` red+black SOR sweep pairs on the slab of the
// full (ny, nx) grid.  The ghost columns are frozen per round: the
// neighbour slab's edge column, or at the domain ends the round-start
// inlet column (Neumann) and the negated round-start outlet column
// (Dirichlet 0).  Wall rows are Neumann, read live.  Red points have
// (i + j) even.
//
// Design: the packed slab smoother of sor_slabs.cuh on the full grid
// (FullGrid).  Each block splits its band into red and black packed planes
// as it loads it, red[j, k] = p[j, 2k + j%2], and interleaves them back
// as it stores it.  A half-sweep then reads only its own colour's points'
// neighbours, contiguous in the other plane, where a masked update in the
// grid's own layout walks every other point (stride-2 bank conflicts) and
// does twice the reads.  The values are the reference's: a frozen
// full-width ghost column gives each coloured half-sweep exactly the
// packed kernel's single-parity ghosts (src/repro/kernels/poisson/
// ref.py:58-67).  The arithmetic multiplies by float32 reciprocals of dx^2
// and dy^2 (sor_packed.cuh) where the reference divides.  Shared memory per
// block is the packed kernel's, so 16 blocks hold a slab of every grid up
// to res 70 at the default aspect.
//
// What bounds it on an H100: as the packed kernel (poisson_sor.cu), the
// chain of 2 x rounds x inner_iters half-sweeps, not the arithmetic (48
// MFLOP per res-16 solve of 4 grids: 0.7 us at the fp32 peak) nor the
// bytes (p and rhs read, p written once).  The earlier design, one block per
// (grid, slab) and one launch per round, walked that chain on 4 of 132
// SMs at ~6.7 us per half-sweep (PERF.md).
#include <cuda_runtime.h>

#include "sor_slabs.cuh"

__global__ void __launch_bounds__(1024, 1) rb_sor_full_cluster_kernel(
    FullGrid io, int* __restrict__ block_sm, int ny, int w, int nslabs,
    int inner_iters, int rounds, int rows_max, int tx_dim, Bands bands,
    float inv_dx2, float inv_dy2, float inv_diag, float om, float one_m_om) {
  sor_slabs_cluster(io, block_sm, ny, w, nslabs, inner_iters, rounds,
                    rows_max, tx_dim, bands, inv_dx2, inv_dy2, inv_diag, om,
                    one_m_om);
}

// How many clusters of `cluster` blocks (`threads` threads, `smem` bytes
// of dynamic shared memory each) the card holds at once, into *out.
// Returns the CUDA error code (0 = success).
extern "C" int rb_sor_full_max_clusters(int cluster, int threads, int smem,
                                        int* out) {
  return static_cast<int>(max_active_clusters(
      rb_sor_full_cluster_kernel, cluster, threads, smem, out));
}

// Grids (n_env, ny, nx) float32, contiguous, nx even; the launch as
// sor_slabs.cuh launch_sor_slabs says, on packed planes of width nx / 2.
// Launch on `stream`; returns the CUDA error code (0 = launched).
extern "C" int rb_sor_slabs_full_launch(
    const float* p, const float* rhs, float* p_out, int* block_sm, int n_env,
    int ny, int nx, int nslabs, int inner_iters, int rounds, int cluster,
    const int* starts, int rows_max, int threads, int tx_dim, int smem,
    float inv_dx2, float inv_dy2, float inv_diag, float om, float one_m_om,
    void* stream) {
  if (nx % 2) return static_cast<int>(cudaErrorInvalidValue);
  const FullGrid io{p, rhs, p_out, nx / 2};
  return launch_sor_slabs(rb_sor_full_cluster_kernel, io, block_sm, n_env,
                          ny, nx / 2, nslabs, inner_iters, rounds, cluster,
                          starts, rows_max, threads, tx_dim, smem, inv_dx2,
                          inv_dy2, inv_diag, om, one_m_om,
                          static_cast<cudaStream_t>(stream));
}
