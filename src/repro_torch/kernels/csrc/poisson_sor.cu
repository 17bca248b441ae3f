// Packed red-black SOR slab smoother: `rounds` block-Jacobi rounds in one
// launch, one thread-block cluster per (env, slab).
//
// Replaces the Pallas TPU kernel rb_sor_packed_slab_kernel /
// rb_sor_slabs_packed (src/repro/kernels/poisson/kernel.py:106-175), which
// runs ONE round per call; the reference's rb_sor_planes chains
// ceil(iters / inner_iters) calls.
//
// What it computes: for every env and every x-slab, per round,
// `inner_iters` red+black SOR sweep pairs on the slab's packed planes, with
// single-parity ghost columns frozen at the round's start (the neighbour
// slab's packed edge columns of the other colour; at the domain ends the
// slab's own first column, Neumann inlet, and minus its own last column,
// Dirichlet-0 outlet).  Wall rows are Neumann, read live.
//
// What bounds it on an H100: not the arithmetic (~10 flops per point and
// half-sweep, 48 MFLOP per res-16 solve of 4 envs: 0.7 us at the fp32
// peak) and not the bytes (the planes read and written once) but the chain
// of 2 x rounds x inner_iters half-sweeps, each of which reads rows the
// half-sweep before wrote.  A one-block-per-env design walked that chain
// on 4 of 132 SMs at ~6.3 us per half-sweep (PERF.md).
//
// Design, against that chain (the scheme of fused_interval.cu's SOR):
//   * One cluster of C <= 16 blocks per (env, slab), C chosen by the
//     wrapper (kernels/poisson/ops.py, through kernels/cluster.py
//     choose_cluster).  Rank r holds rows [start[r], start[r+1]) of red,
//     black, rhs_r and rhs_b in shared memory, with a halo row above and
//     below in red and black, for all rounds: global memory is touched once
//     on the way in and once on the way out.
//   * A half-sweep's edge rows go to the neighbours' halo rows by st.async,
//     counted by the receiver's mbarrier; only the edge rows' threads wait
//     for the rows of the half-sweep before (sor_packed.cuh).
//   * Between rounds each block snapshots its own rows' ghost columns.  With
//     one slab (every grid below res 48 at the default aspect, where the
//     reference's _pick_nslabs gives 1) those are the block's own edge
//     columns, so a block barrier orders the snapshot.  With several slabs a ghost is another cluster's
//     column: the wrapper then launches once per round (rounds = 1), and
//     the ghosts come from the launch's input planes.
//   * 2-D loops (rows by thread row, columns by lane: no index division)
//     and multiplications by float32 reciprocals of dx^2 and dy^2.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "sor_packed.cuh"

namespace cg = cooperative_groups;

__global__ void __launch_bounds__(1024, 1) rb_sor_packed_cluster_kernel(
    const float* __restrict__ red_in, const float* __restrict__ black_in,
    const float* __restrict__ rhs_r_in, const float* __restrict__ rhs_b_in,
    float* __restrict__ red_out, float* __restrict__ black_out,
    int* __restrict__ block_sm, int ny, int w, int nslabs, int inner_iters,
    int rounds, int rows_max, int tx_dim, Bands bands, float inv_dx2,
    float inv_dy2, float inv_diag, float om, float one_m_om) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int group = blockIdx.x / C;  // (env, slab), slabs fastest
  const int env = group / nslabs;
  const int s = group - env * nslabs;
  const int tid = threadIdx.x;
  const int TX = tx_dim;
  const int TY = blockDim.x / TX;
  const int ty = tid / TX;
  const int tx = tid - ty * TX;
  if (tid == 0) block_sm[blockIdx.x] = sm_id();  // the launch's record

  const int bxp = w / nslabs;
  const int c0 = s * bxp;
  const int R = rows_max;
  const int j0 = bands.start[rank];
  const int nrows = bands.start[rank + 1] - j0;
  const bool first = rank == 0, last = rank == C - 1;

  // shared-memory layout (kernels/poisson/ops.py smem_bytes): stored row
  // s of a plane with halo rows is local row s - 1
  unsigned long long* mbar = reinterpret_cast<unsigned long long*>(smem);
  float* red = smem + 4;               // (R + 2) x bxp, local rows -1..R
  float* black = red + (R + 2) * bxp;
  float* rhs_r = black + (R + 2) * bxp;  // R x bxp
  float* rhs_b = rhs_r + R * bxp;
  float* r_lg = rhs_b + R * bxp;       // R each: the frozen ghost columns
  float* r_rg = r_lg + R;
  float* b_lg = r_rg + R;
  float* b_rg = b_lg + R;

  const int nrows_prev = first ? 0 : j0 - bands.start[rank - 1];
  Link red_link{0u, 0u, 0u, 0u}, black_link{0u, 0u, 0u, 0u};
  if (!first) {
    red_link.prev = cluster_addr(red + (nrows_prev + 1) * bxp, rank - 1);
    red_link.prev_bar = cluster_addr(&mbar[0], rank - 1);
    black_link.prev = cluster_addr(black + (nrows_prev + 1) * bxp, rank - 1);
    black_link.prev_bar = cluster_addr(&mbar[1], rank - 1);
  }
  if (!last) {
    red_link.next = cluster_addr(red, rank + 1);
    red_link.next_bar = cluster_addr(&mbar[0], rank + 1);
    black_link.next = cluster_addr(black, rank + 1);
    black_link.next_bar = cluster_addr(&mbar[1], rank + 1);
  }
  // halo bytes a colour's phase waits for: a row from each neighbour
  const bool linked = C > 1;
  const int halo_bytes = 4 * bxp * ((first ? 0 : 1) + (last ? 0 : 1));
  unsigned red_parity = 0, black_parity = 0;
  if (linked && tid == 0) {
    mbar_init(&mbar[0]);
    mbar_init(&mbar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(&mbar[0], halo_bytes);
    mbar_expect(&mbar[1], halo_bytes);
  }

  const size_t base = static_cast<size_t>(env) * ny * w;
  for (int lj = ty - 1; lj <= nrows; lj += TY) {
    const int j = j0 + lj;
    const bool inside = j >= 0 && j < ny;
    const size_t g = base + static_cast<size_t>(inside ? j : 0) * w + c0;
    for (int k = tx; k < bxp; k += TX) {
      red[(lj + 1) * bxp + k] = inside ? red_in[g + k] : 0.0f;
      black[(lj + 1) * bxp + k] = inside ? black_in[g + k] : 0.0f;
      if (lj >= 0 && lj < nrows) {
        rhs_r[lj * bxp + k] = rhs_r_in[g + k];
        rhs_b[lj * bxp + k] = rhs_b_in[g + k];
      }
    }
  }
  // every block of the cluster has started, holds its band and has its
  // mbarriers set before any block stores into another's shared memory
  cluster_barrier();

  for (int round = 0; round < rounds; ++round) {
    // the round's frozen single-parity ghosts: a red update's west/east
    // neighbours are black, so its interior ghosts are the neighbour slab's
    // black edge columns (and vice versa); at the domain ends the ghost has
    // the update parity (Neumann inlet = own first column, Dirichlet outlet
    // = -own last column), as the round starts
    for (int lj = tid; lj < nrows; lj += blockDim.x) {
      if (round == 0) {
        const size_t first_col = base + static_cast<size_t>(j0 + lj) * w + c0;
        const size_t last_col = first_col + bxp - 1;
        r_lg[lj] = s == 0 ? red_in[first_col] : black_in[first_col - 1];
        r_rg[lj] = s == nslabs - 1 ? -red_in[last_col] : black_in[last_col + 1];
        b_lg[lj] = s == 0 ? black_in[first_col] : red_in[first_col - 1];
        b_rg[lj] = s == nslabs - 1 ? -black_in[last_col] : red_in[last_col + 1];
      } else {  // one slab (the wrapper's rule): the domain ends
        const float* rrow = red + (lj + 1) * bxp;
        const float* brow = black + (lj + 1) * bxp;
        r_lg[lj] = rrow[0];
        r_rg[lj] = -rrow[bxp - 1];
        b_lg[lj] = brow[0];
        b_rg[lj] = -brow[bxp - 1];
      }
    }
    __syncthreads();
    // a half-sweep's edge rows first wait for the other colour's halo rows
    // of the half-sweep before (the launch's first red one reads the loaded
    // halo rows); that colour's mbarrier is re-armed once the half-sweep's
    // block barrier is passed
    for (int it = 0; it < inner_iters; ++it) {
      const bool wait_black = linked && (round > 0 || it > 0);
      band_half_sweep<true>(red, black, rhs_r, r_lg, r_rg, red_link,
                            wait_black ? &mbar[1] : nullptr, black_parity,
                            nrows, j0, ny, bxp, 1, tx, ty, TX, TY, inv_dx2,
                            inv_dy2, inv_diag, om, one_m_om);
      if (wait_black) {
        black_parity ^= 1u;
        if (tid == 0) mbar_expect(&mbar[1], halo_bytes);
      }
      band_half_sweep<true>(black, red, rhs_b, b_lg, b_rg, black_link,
                            linked ? &mbar[0] : nullptr, red_parity, nrows,
                            j0, ny, bxp, 0, tx, ty, TX, TY, inv_dx2, inv_dy2,
                            inv_diag, om, one_m_om);
      if (linked) {
        red_parity ^= 1u;
        if (tid == 0) mbar_expect(&mbar[0], halo_bytes);
      }
    }
  }
  // the last black edge rows the neighbours sent are the last stores into
  // this block: wait for them before the block may exit
  if (linked && rounds * inner_iters > 0) mbar_wait(&mbar[1], black_parity);

  for (int lj = ty; lj < nrows; lj += TY) {
    const size_t g = base + static_cast<size_t>(j0 + lj) * w + c0;
    for (int k = tx; k < bxp; k += TX) {
      red_out[g + k] = red[(lj + 1) * bxp + k];
      black_out[g + k] = black[(lj + 1) * bxp + k];
    }
  }
  // no block exits while a neighbour may still address its shared memory
  cluster_barrier();
}

// How many clusters of `cluster` blocks (`threads` threads, `smem` bytes
// of dynamic shared memory each) the card holds at once, into *out.
// Returns the CUDA error code (0 = success).
extern "C" int rb_sor_packed_max_clusters(int cluster, int threads, int smem,
                                          int* out) {
  return static_cast<int>(max_active_clusters(
      rb_sor_packed_cluster_kernel, cluster, threads, smem, out));
}

// Planes (n_env, ny, w) float32, contiguous.  n_env x nslabs clusters of
// `cluster` blocks of `threads` = tx_dim x (threads / tx_dim) threads;
// starts: cluster + 1 row starts of the band partition (cluster.py
// band_starts), rows_max the largest band; smem: each block's dynamic
// shared memory in bytes (ops.smem_bytes); block_sm: n_env x nslabs x
// cluster ints, the SM id each block ran on (-1 where none ran).  rounds >
// 1 needs nslabs == 1 (the ghosts of later rounds are the block's own
// columns).  Launch on `stream`; returns the CUDA error code (0 =
// launched).
extern "C" int rb_sor_slabs_packed_launch(
    const float* red, const float* black, const float* rhs_r,
    const float* rhs_b, float* red_out, float* black_out, int* block_sm,
    int n_env, int ny, int w, int nslabs, int inner_iters, int rounds,
    int cluster, const int* starts, int rows_max, int threads, int tx_dim,
    int smem, float inv_dx2, float inv_dy2, float inv_diag, float om,
    float one_m_om, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || (rounds > 1 && nslabs != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Bands bands{};
  for (int r = 0; r <= cluster; ++r) bands.start[r] = starts[r];
  cudaError_t err = set_cluster_attributes(rb_sor_packed_cluster_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  fill_cluster_config(cfg, attr, n_env * nslabs, cluster, threads, smem,
                      static_cast<cudaStream_t>(stream));
  // -1 where no block wrote its SM: the record counts the blocks that ran
  err = cudaMemsetAsync(block_sm, 0xff, sizeof(int) * n_env * nslabs * cluster,
                        static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, rb_sor_packed_cluster_kernel, red, black,
                           rhs_r, rhs_b, red_out, black_out, block_sm, ny, w,
                           nslabs, inner_iters, rounds, rows_max, tx_dim,
                           bands, inv_dx2, inv_dy2, inv_diag, om, one_m_om);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
