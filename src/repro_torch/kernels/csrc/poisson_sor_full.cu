// Full-grid red-black SOR slab smoother: `rounds` block-Jacobi rounds in
// one launch, one thread-block cluster per (grid, slab) where a cluster
// holds the slab, one group of blocks on a workspace in global memory
// where not.  Its full sweeps serve the grids of odd width.
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
// The full sweeps (rb_sor_full_sweeps_*, kFullSweeps): on a grid of odd
// width, where the reference's slab kernel has no checkerboard parity and
// its solve(backend="pallas") runs its full-grid sweep instead
// (src/repro/cfd/poisson.py:290-297), the same bodies compute that sweep:
// `iters` red+black pairs on the whole grid with the BCs read live, the
// pairs from n_sor on at omega 1, on packed planes of width (nx + 1) / 2
// with the odd width's row rule (sor_packed.cuh).
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

// kFullSweeps: the odd width's full sweeps (above), else the slab smoother
template <bool kFullSweeps>
__global__ void __launch_bounds__(1024, 1) rb_sor_full_cluster_kernel(
    FullGrid io, int* __restrict__ block_sm, int ny, int w, int nslabs,
    int inner_iters, int rounds, int n_sor, int rows_max, int tx_dim,
    Bands bands, float inv_dx2, float inv_dy2, float inv_diag, float om,
    float one_m_om) {
  sor_slabs_cluster<kFullSweeps>(io, block_sm, ny, w, nslabs, inner_iters,
                                 rounds, n_sor, rows_max, tx_dim, bands,
                                 inv_dx2, inv_dy2, inv_diag, om, one_m_om);
}

template <bool kFullSweeps>
__global__ void __launch_bounds__(1024, 1) rb_sor_full_global_kernel(
    FullGrid io, int* __restrict__ block_sm, float* ws, int group0,
    int n_groups, int ny, int w, int nslabs, int inner_iters, int rounds,
    int n_sor, int tx_dim, float inv_dx2, float inv_dy2, float inv_diag,
    float om, float one_m_om) {
  sor_slabs_global<kFullSweeps>(io, block_sm, ws, group0, n_groups, ny, w,
                                nslabs, inner_iters, rounds, n_sor, tx_dim,
                                inv_dx2, inv_dy2, inv_diag, om, one_m_om);
}

template <bool kFullSweeps>
__global__ void __launch_bounds__(1024, 1) rb_sor_full_resident_kernel(
    FullGrid io, int* __restrict__ block_sm, float* ws, int group0,
    int n_groups, int ny, int w, int nslabs, int inner_iters, int rounds,
    int n_sor, int rows_max, int tx_dim, float inv_dx2, float inv_dy2,
    float inv_diag, float om, float one_m_om) {
  sor_slabs_resident<kFullSweeps>(io, block_sm, ws, group0, n_groups, ny, w,
                                  nslabs, inner_iters, rounds, n_sor,
                                  rows_max, tx_dim, inv_dx2, inv_dy2,
                                  inv_diag, om, one_m_om);
}

// The grid's width as each kind of launch takes it: even for the slab
// smoother, odd for the full sweeps, which run one slab in one round.
static bool bad_grid(bool sweeps, int nx, int nslabs, int rounds) {
  return sweeps ? (nx % 2 == 0 || nslabs != 1 || rounds != 1) : nx % 2 != 0;
}

// -- the launches, each for the slab smoother and the full sweeps ---------

// Grids (n_env, ny, nx) float32, contiguous; the launch as sor_slabs.cuh
// launch_sor_slabs says, on packed planes of width ceil(nx / 2).  Launch
// on `stream`; returns the CUDA error code (0 = launched).
template <bool kFullSweeps>
static int launch_full(const float* p, const float* rhs, float* p_out,
                       int* block_sm, int n_env, int ny, int nx, int nslabs,
                       int inner_iters, int rounds, int n_sor, int cluster,
                       const int* starts, int rows_max, int threads,
                       int tx_dim, int smem, float inv_dx2, float inv_dy2,
                       float inv_diag, float om, float one_m_om,
                       void* stream) {
  if (bad_grid(kFullSweeps, nx, nslabs, rounds))
    return static_cast<int>(cudaErrorInvalidValue);
  const int w = (nx + 1) / 2;
  const FullGrid io{p, rhs, p_out, w, nx};
  return launch_sor_slabs(rb_sor_full_cluster_kernel<kFullSweeps>, io,
                          block_sm, n_env, ny, w, nslabs, inner_iters, rounds,
                          n_sor, cluster, starts, rows_max, threads, tx_dim,
                          smem, inv_dx2, inv_dy2, inv_diag, om, one_m_om,
                          static_cast<cudaStream_t>(stream));
}

// The operands as launch_full takes them; the global-memory kernel
// launched as sor_slabs.cuh launch_sor_slabs_global says (ws: the
// workspace of per_launch groups).
template <bool kFullSweeps>
static int launch_full_global(const float* p, const float* rhs, float* p_out,
                              int* block_sm, float* ws, int n_env, int ny,
                              int nx, int nslabs, int inner_iters, int rounds,
                              int n_sor, int group, int per_launch,
                              int threads, int tx_dim, float inv_dx2,
                              float inv_dy2, float inv_diag, float om,
                              float one_m_om, void* stream) {
  if (bad_grid(kFullSweeps, nx, nslabs, rounds))
    return static_cast<int>(cudaErrorInvalidValue);
  const int w = (nx + 1) / 2;
  const FullGrid io{p, rhs, p_out, w, nx};
  return launch_sor_slabs_global(rb_sor_full_global_kernel<kFullSweeps>, io,
                                 block_sm, ws, n_env, ny, w, nslabs,
                                 inner_iters, rounds, n_sor, group,
                                 per_launch, threads, tx_dim, inv_dx2,
                                 inv_dy2, inv_diag, om, one_m_om,
                                 static_cast<cudaStream_t>(stream));
}

// The operands as launch_full takes them; the resident kernel launched as
// sor_slabs.cuh launch_sor_slabs_resident says (ws: the workspace of
// per_launch groups).
template <bool kFullSweeps>
static int launch_full_resident(
    const float* p, const float* rhs, float* p_out, int* block_sm, float* ws,
    int n_env, int ny, int nx, int nslabs, int inner_iters, int rounds,
    int n_sor, int group, int cluster, int per_launch, int rows_max,
    int threads, int tx_dim, int smem, float inv_dx2, float inv_dy2,
    float inv_diag, float om, float one_m_om, void* stream) {
  if (bad_grid(kFullSweeps, nx, nslabs, rounds))
    return static_cast<int>(cudaErrorInvalidValue);
  const int w = (nx + 1) / 2;
  const FullGrid io{p, rhs, p_out, w, nx};
  return launch_sor_slabs_resident(
      rb_sor_full_resident_kernel<kFullSweeps>, io, block_sm, ws, n_env, ny,
      w, nslabs, inner_iters, rounds, n_sor, group, cluster, per_launch,
      rows_max, threads, tx_dim, smem, inv_dx2, inv_dy2, inv_diag, om,
      one_m_om, static_cast<cudaStream_t>(stream));
}

// -- the exports: the slab smoother (rb_sor_slabs_full_*, rb_sor_full_*),
//    and the full sweeps (rb_sor_full_sweeps_*), which take the same
//    operands with nslabs = rounds = 1, inner_iters = iters, nx odd -----

// How many blocks of `threads` threads of the global-memory kernel one SM
// holds at once, into *out.  Returns the CUDA error code (0 = success).
extern "C" int rb_sor_full_global_blocks_per_sm(int threads, int* out) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, rb_sor_full_global_kernel<false>, threads, 0));
}

extern "C" int rb_sor_full_sweeps_global_blocks_per_sm(int threads,
                                                       int* out) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, rb_sor_full_global_kernel<true>, threads, 0));
}

// How many clusters of `cluster` blocks (`threads` threads, `smem` bytes
// of dynamic shared memory each) the card holds at once, into *out.
// Returns the CUDA error code (0 = success).
extern "C" int rb_sor_full_max_clusters(int cluster, int threads, int smem,
                                        int* out) {
  return static_cast<int>(max_active_clusters(
      rb_sor_full_cluster_kernel<false>, cluster, threads, smem, out));
}

extern "C" int rb_sor_full_sweeps_max_clusters(int cluster, int threads,
                                               int smem, int* out) {
  return static_cast<int>(max_active_clusters(
      rb_sor_full_cluster_kernel<true>, cluster, threads, smem, out));
}

// The same of the resident kernel.
extern "C" int rb_sor_full_resident_max_clusters(int cluster, int threads,
                                                int smem, int* out) {
  return static_cast<int>(max_active_clusters(
      rb_sor_full_resident_kernel<false>, cluster, threads, smem, out));
}

extern "C" int rb_sor_full_sweeps_resident_max_clusters(int cluster,
                                                        int threads, int smem,
                                                        int* out) {
  return static_cast<int>(max_active_clusters(
      rb_sor_full_resident_kernel<true>, cluster, threads, smem, out));
}

// The cluster kernel: launch_full's operands.
extern "C" int rb_sor_slabs_full_launch(
    const float* p, const float* rhs, float* p_out, int* block_sm, int n_env,
    int ny, int nx, int nslabs, int inner_iters, int rounds, int n_sor,
    int cluster, const int* starts, int rows_max, int threads, int tx_dim,
    int smem, float inv_dx2, float inv_dy2, float inv_diag, float om,
    float one_m_om, void* stream) {
  return launch_full<false>(p, rhs, p_out, block_sm, n_env, ny, nx, nslabs,
                            inner_iters, rounds, n_sor, cluster, starts,
                            rows_max, threads, tx_dim, smem, inv_dx2,
                            inv_dy2, inv_diag, om, one_m_om, stream);
}

extern "C" int rb_sor_full_sweeps_launch(
    const float* p, const float* rhs, float* p_out, int* block_sm, int n_env,
    int ny, int nx, int nslabs, int inner_iters, int rounds, int n_sor,
    int cluster, const int* starts, int rows_max, int threads, int tx_dim,
    int smem, float inv_dx2, float inv_dy2, float inv_diag, float om,
    float one_m_om, void* stream) {
  return launch_full<true>(p, rhs, p_out, block_sm, n_env, ny, nx, nslabs,
                           inner_iters, rounds, n_sor, cluster, starts,
                           rows_max, threads, tx_dim, smem, inv_dx2, inv_dy2,
                           inv_diag, om, one_m_om, stream);
}

// The global-memory kernel: launch_full_global's operands.
extern "C" int rb_sor_slabs_full_global_launch(
    const float* p, const float* rhs, float* p_out, int* block_sm, float* ws,
    int n_env, int ny, int nx, int nslabs, int inner_iters, int rounds,
    int n_sor, int group, int per_launch, int threads, int tx_dim,
    float inv_dx2, float inv_dy2, float inv_diag, float om, float one_m_om,
    void* stream) {
  return launch_full_global<false>(p, rhs, p_out, block_sm, ws, n_env, ny,
                                   nx, nslabs, inner_iters, rounds, n_sor,
                                   group, per_launch, threads, tx_dim,
                                   inv_dx2, inv_dy2, inv_diag, om, one_m_om,
                                   stream);
}

extern "C" int rb_sor_full_sweeps_global_launch(
    const float* p, const float* rhs, float* p_out, int* block_sm, float* ws,
    int n_env, int ny, int nx, int nslabs, int inner_iters, int rounds,
    int n_sor, int group, int per_launch, int threads, int tx_dim,
    float inv_dx2, float inv_dy2, float inv_diag, float om, float one_m_om,
    void* stream) {
  return launch_full_global<true>(p, rhs, p_out, block_sm, ws, n_env, ny, nx,
                                  nslabs, inner_iters, rounds, n_sor, group,
                                  per_launch, threads, tx_dim, inv_dx2,
                                  inv_dy2, inv_diag, om, one_m_om, stream);
}

// The resident kernel: launch_full_resident's operands.
extern "C" int rb_sor_slabs_full_resident_launch(
    const float* p, const float* rhs, float* p_out, int* block_sm, float* ws,
    int n_env, int ny, int nx, int nslabs, int inner_iters, int rounds,
    int n_sor, int group, int cluster, int per_launch, int rows_max,
    int threads, int tx_dim, int smem, float inv_dx2, float inv_dy2,
    float inv_diag, float om, float one_m_om, void* stream) {
  return launch_full_resident<false>(
      p, rhs, p_out, block_sm, ws, n_env, ny, nx, nslabs, inner_iters,
      rounds, n_sor, group, cluster, per_launch, rows_max, threads, tx_dim,
      smem, inv_dx2, inv_dy2, inv_diag, om, one_m_om, stream);
}

extern "C" int rb_sor_full_sweeps_resident_launch(
    const float* p, const float* rhs, float* p_out, int* block_sm, float* ws,
    int n_env, int ny, int nx, int nslabs, int inner_iters, int rounds,
    int n_sor, int group, int cluster, int per_launch, int rows_max,
    int threads, int tx_dim, int smem, float inv_dx2, float inv_dy2,
    float inv_diag, float om, float one_m_om, void* stream) {
  return launch_full_resident<true>(
      p, rhs, p_out, block_sm, ws, n_env, ny, nx, nslabs, inner_iters,
      rounds, n_sor, group, cluster, per_launch, rows_max, threads, tx_dim,
      smem, inv_dx2, inv_dy2, inv_diag, om, one_m_om, stream);
}
