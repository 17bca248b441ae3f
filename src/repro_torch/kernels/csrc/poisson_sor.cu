// Packed red-black SOR slab smoother: `rounds` block-Jacobi rounds in one
// launch, one thread-block cluster per (env, slab) where a cluster holds
// the slab, one group of blocks on a workspace in global memory where
// not.
//
// Replaces the Pallas TPU kernel rb_sor_packed_slab_kernel /
// rb_sor_slabs_packed (src/repro/kernels/poisson/kernel.py:106-175), which
// runs ONE round per call; the reference's rb_sor_planes chains
// ceil(iters / inner_iters) calls.
//
// What it computes, and the design: sor_slabs.cuh, on the packed planes
// (n_env, ny, w) red, black, rhs_r, rhs_b as they lie in device memory.
//
// What bounds it on an H100: not the arithmetic (~10 flops per point and
// half-sweep, 48 MFLOP per res-16 solve of 4 envs: 0.7 us at the fp32
// peak) and not the bytes (the planes read and written once) but the chain
// of 2 x rounds x inner_iters half-sweeps, each of which reads rows the
// half-sweep before wrote.  A one-block-per-env design walked that chain
// on 4 of 132 SMs at ~6.3 us per half-sweep (PERF.md); the cluster design
// spreads each half-sweep over up to 16 SMs.
#include <cuda_runtime.h>

#include "sor_slabs.cuh"

__global__ void __launch_bounds__(1024, 1) rb_sor_packed_cluster_kernel(
    PackedPlanes io, int* __restrict__ block_sm, int ny, int w, int nslabs,
    int inner_iters, int rounds, int n_sor, int rows_max, int tx_dim,
    Bands bands, float inv_dx2, float inv_dy2, float inv_diag, float om,
    float one_m_om) {
  sor_slabs_cluster<false>(io, block_sm, ny, w, nslabs, inner_iters, rounds,
                           n_sor, rows_max, tx_dim, bands, inv_dx2, inv_dy2,
                           inv_diag, om, one_m_om);
}

__global__ void __launch_bounds__(1024, 1) rb_sor_packed_global_kernel(
    PackedPlanes io, int* __restrict__ block_sm, float* ws, int group0,
    int n_groups, int ny, int w, int nslabs, int inner_iters, int rounds,
    int n_sor, int tx_dim, float inv_dx2, float inv_dy2, float inv_diag,
    float om, float one_m_om) {
  sor_slabs_global<false>(io, block_sm, ws, group0, n_groups, ny, w, nslabs,
                          inner_iters, rounds, n_sor, tx_dim, inv_dx2,
                          inv_dy2, inv_diag, om, one_m_om);
}

__global__ void __launch_bounds__(1024, 1) rb_sor_packed_resident_kernel(
    PackedPlanes io, int* __restrict__ block_sm, float* ws, int group0,
    int n_groups, int ny, int w, int nslabs, int inner_iters, int rounds,
    int n_sor, int rows_max, int tx_dim, float inv_dx2, float inv_dy2,
    float inv_diag, float om, float one_m_om) {
  sor_slabs_resident<false>(io, block_sm, ws, group0, n_groups, ny, w,
                            nslabs, inner_iters, rounds, n_sor, rows_max,
                            tx_dim, inv_dx2, inv_dy2, inv_diag, om,
                            one_m_om);
}

// How many blocks of `threads` threads of the global-memory kernel one SM
// holds at once, into *out.  Returns the CUDA error code (0 = success).
extern "C" int rb_sor_packed_global_blocks_per_sm(int threads, int* out) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, rb_sor_packed_global_kernel, threads, 0));
}

// How many clusters of `cluster` blocks (`threads` threads, `smem` bytes
// of dynamic shared memory each) the card holds at once, into *out.
// Returns the CUDA error code (0 = success).
extern "C" int rb_sor_packed_max_clusters(int cluster, int threads, int smem,
                                          int* out) {
  return static_cast<int>(max_active_clusters(
      rb_sor_packed_cluster_kernel, cluster, threads, smem, out));
}

// Planes (n_env, ny, w) float32, contiguous; the launch as
// sor_slabs.cuh launch_sor_slabs says (the slab wrappers pass n_sor =
// rounds x inner_iters: no polish tail).  Launch on `stream`; returns the
// CUDA error code (0 = launched).
extern "C" int rb_sor_slabs_packed_launch(
    const float* red, const float* black, const float* rhs_r,
    const float* rhs_b, float* red_out, float* black_out, int* block_sm,
    int n_env, int ny, int w, int nslabs, int inner_iters, int rounds,
    int n_sor, int cluster, const int* starts, int rows_max, int threads,
    int tx_dim, int smem, float inv_dx2, float inv_dy2, float inv_diag,
    float om, float one_m_om, void* stream) {
  const PackedPlanes io{red, black, rhs_r, rhs_b, red_out, black_out, w};
  return launch_sor_slabs(rb_sor_packed_cluster_kernel, io, block_sm, n_env,
                          ny, w, nslabs, inner_iters, rounds, n_sor, cluster,
                          starts, rows_max, threads, tx_dim, smem, inv_dx2,
                          inv_dy2, inv_diag, om, one_m_om,
                          static_cast<cudaStream_t>(stream));
}

// The operands as the cluster launch takes them; the global-memory kernel
// launched as sor_slabs.cuh launch_sor_slabs_global says (ws: the
// workspace of per_launch groups).  Launch on `stream`; returns the CUDA
// error code (0 = launched).
extern "C" int rb_sor_slabs_packed_global_launch(
    const float* red, const float* black, const float* rhs_r,
    const float* rhs_b, float* red_out, float* black_out, int* block_sm,
    float* ws, int n_env, int ny, int w, int nslabs, int inner_iters,
    int rounds, int n_sor, int group, int per_launch, int threads,
    int tx_dim, float inv_dx2, float inv_dy2, float inv_diag, float om,
    float one_m_om, void* stream) {
  const PackedPlanes io{red, black, rhs_r, rhs_b, red_out, black_out, w};
  return launch_sor_slabs_global(rb_sor_packed_global_kernel, io, block_sm, ws,
                                 n_env, ny, w, nslabs, inner_iters, rounds,
                                 n_sor, group, per_launch, threads, tx_dim,
                                 inv_dx2, inv_dy2, inv_diag, om, one_m_om,
                                 static_cast<cudaStream_t>(stream));
}

// How many clusters of `cluster` blocks (`threads` threads, `smem` bytes
// of dynamic shared memory each) of the resident kernel the card holds at
// once, into *out.  Returns the CUDA error code (0 = success).
extern "C" int rb_sor_packed_resident_max_clusters(int cluster, int threads,
                                                int smem, int* out) {
  return static_cast<int>(max_active_clusters(
      rb_sor_packed_resident_kernel, cluster, threads, smem, out));
}

// The operands as the cluster launch takes them; the resident kernel
// launched as sor_slabs.cuh launch_sor_slabs_resident says (ws: the
// workspace of per_launch groups).  Launch on `stream`; returns the CUDA
// error code (0 = launched).
extern "C" int rb_sor_slabs_packed_resident_launch(
    const float* red, const float* black, const float* rhs_r,
    const float* rhs_b, float* red_out, float* black_out, int* block_sm,
    float* ws, int n_env, int ny, int w, int nslabs, int inner_iters,
    int rounds, int n_sor, int group, int cluster, int per_launch,
    int rows_max, int threads, int tx_dim, int smem, float inv_dx2,
    float inv_dy2, float inv_diag, float om, float one_m_om, void* stream) {
  const PackedPlanes io{red, black, rhs_r, rhs_b, red_out, black_out, w};
  return launch_sor_slabs_resident(
      rb_sor_packed_resident_kernel, io, block_sm, ws, n_env, ny, w, nslabs,
      inner_iters, rounds, n_sor, group, cluster, per_launch, rows_max,
      threads, tx_dim, smem, inv_dx2, inv_dy2, inv_diag, om, one_m_om,
      static_cast<cudaStream_t>(stream));
}
