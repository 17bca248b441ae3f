// The block-Jacobi red-black SOR slab smoother over thread-block clusters,
// shared by the two slab kernels: poisson_sor.cu on packed planes, and
// poisson_sor_full.cu on the full grid.  They differ only in where a
// point lives in device memory, which the IO type says (PackedPlanes,
// FullGrid); in shared memory both hold a band as its red and black packed
// planes, so both run sor_packed.cuh's half-sweep.
//
// What it computes: for every env and every x-slab, per round,
// `inner_iters` red+black SOR sweep pairs on the slab, with single-parity
// ghost columns frozen at the round's start (the neighbour slab's packed
// edge columns of the other colour; at the domain ends the slab's own first
// column, Neumann inlet, and minus its own last column, Dirichlet-0
// outlet).  Wall rows are Neumann, read live.  A frozen full-width ghost
// column gives each coloured half-sweep exactly these single-parity values,
// so the full-grid slab smoother is this one on the split grid (the
// reference's own oracle says so: src/repro/kernels/poisson/ref.py:58-67).
//
// Design:
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
//     columns, so a block barrier orders the snapshot.  With several slabs
//     a ghost is another cluster's column: the wrapper then launches once
//     per round (rounds = 1), and the ghosts come from the launch's input.
//   * 2-D loops (rows by thread row, columns by lane: no index division)
//     and multiplications by float32 reciprocals of dx^2 and dy^2.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "sor_packed.cuh"

// Packed planes (n_env, ny, w), one array per colour and field.  `row` is
// env * ny + j, `kg` a packed column of the whole plane.
struct PackedPlanes {
  const float* red;
  const float* black;
  const float* rhs_r;
  const float* rhs_b;
  float* red_out;
  float* black_out;
  int w;

  __device__ float p(size_t row, int kg, int colour, int) const {
    return (colour ? black : red)[row * w + kg];
  }
  __device__ void load(size_t row, int kg, int, float& r, float& b) const {
    r = red[row * w + kg];
    b = black[row * w + kg];
  }
  __device__ void load_rhs(size_t row, int kg, int, float& r,
                           float& b) const {
    r = rhs_r[row * w + kg];
    b = rhs_b[row * w + kg];
  }
  __device__ void store(size_t row, int kg, int, float r, float b) const {
    red_out[row * w + kg] = r;
    black_out[row * w + kg] = b;
  }
};

// The full grid (n_env, ny, 2 w), split into packed planes as it is loaded
// and interleaved back as it is stored (cfd/poisson pack_checkerboard):
//   red[j, k] = p[j, 2k + j%2]        black[j, k] = p[j, 2k + 1 - j%2]
// so the packed column kg of row j is the pair of grid columns (2 kg,
// 2 kg + 1), red first on even rows.
struct FullGrid {
  const float* p_in;
  const float* rhs;
  float* p_out;
  int w;

  __device__ float p(size_t row, int kg, int colour, int j) const {
    return p_in[row * 2 * w + 2 * kg + ((j + colour) & 1)];
  }
  __device__ static void split(const float* a, bool odd, float& r,
                               float& b) {
    const float x = a[0], y = a[1];
    r = odd ? y : x;
    b = odd ? x : y;
  }
  __device__ void load(size_t row, int kg, int j, float& r, float& b) const {
    split(p_in + row * 2 * w + 2 * kg, j & 1, r, b);
  }
  __device__ void load_rhs(size_t row, int kg, int j, float& r,
                           float& b) const {
    split(rhs + row * 2 * w + 2 * kg, j & 1, r, b);
  }
  __device__ void store(size_t row, int kg, int j, float r, float b) const {
    float* a = p_out + row * 2 * w + 2 * kg;
    const bool odd = j & 1;
    a[0] = odd ? b : r;
    a[1] = odd ? r : b;
  }
};

// The kernel body: `rounds` rounds of the (env, slab) of this block's
// cluster, on packed planes of width w (a slab w / nslabs packed columns).
template <class IO>
__device__ __forceinline__ void sor_slabs_cluster(
    const IO& io, int* __restrict__ block_sm, int ny, int w, int nslabs,
    int inner_iters, int rounds, int rows_max, int tx_dim,
    const Bands& bands, float inv_dx2, float inv_dy2, float inv_diag,
    float om, float one_m_om) {
  namespace cg = cooperative_groups;
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

  const size_t base = static_cast<size_t>(env) * ny;  // the env's row 0
  for (int lj = ty - 1; lj <= nrows; lj += TY) {
    const int j = j0 + lj;
    const bool inside = j >= 0 && j < ny;
    const size_t row = base + (inside ? j : 0);
    for (int k = tx; k < bxp; k += TX) {
      float r = 0.0f, b = 0.0f;
      if (inside) io.load(row, c0 + k, j, r, b);
      red[(lj + 1) * bxp + k] = r;
      black[(lj + 1) * bxp + k] = b;
      if (lj >= 0 && lj < nrows) {
        io.load_rhs(row, c0 + k, j, r, b);
        rhs_r[lj * bxp + k] = r;
        rhs_b[lj * bxp + k] = b;
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
        const int j = j0 + lj;
        const size_t row = base + j;
        const int kl = c0, kr = c0 + bxp - 1;
        r_lg[lj] = s == 0 ? io.p(row, kl, 0, j) : io.p(row, kl - 1, 1, j);
        r_rg[lj] = s == nslabs - 1 ? -io.p(row, kr, 0, j)
                                   : io.p(row, kr + 1, 1, j);
        b_lg[lj] = s == 0 ? io.p(row, kl, 1, j) : io.p(row, kl - 1, 0, j);
        b_rg[lj] = s == nslabs - 1 ? -io.p(row, kr, 1, j)
                                   : io.p(row, kr + 1, 0, j);
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
    const int j = j0 + lj;
    for (int k = tx; k < bxp; k += TX)
      io.store(base + j, c0 + k, j, red[(lj + 1) * bxp + k],
               black[(lj + 1) * bxp + k]);
  }
  // no block exits while a neighbour may still address its shared memory
  cluster_barrier();
}

// Launch `kernel` (a __global__ wrapper of sor_slabs_cluster on `io`):
// n_env x nslabs clusters of `cluster` blocks of `threads` = tx_dim x
// (threads / tx_dim) threads; starts: cluster + 1 row starts of the band
// partition (cluster.py band_starts), rows_max the largest band; smem:
// each block's dynamic shared memory in bytes (ops.smem_bytes); block_sm:
// n_env x nslabs x cluster ints, the SM id each block ran on (-1 where
// none ran).  rounds > 1 needs nslabs == 1 (the ghosts of later rounds
// are the block's own columns).  Returns the CUDA error code (0 =
// launched).
template <class K, class IO>
static int launch_sor_slabs(K kernel, const IO& io, int* block_sm, int n_env,
                            int ny, int w, int nslabs, int inner_iters,
                            int rounds, int cluster, const int* starts,
                            int rows_max, int threads, int tx_dim, int smem,
                            float inv_dx2, float inv_dy2, float inv_diag,
                            float om, float one_m_om, cudaStream_t stream) {
  if (cluster < 1 || cluster > kMaxCluster || (rounds > 1 && nslabs != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Bands bands{};
  for (int r = 0; r <= cluster; ++r) bands.start[r] = starts[r];
  cudaError_t err = set_cluster_attributes(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  fill_cluster_config(cfg, attr, n_env * nslabs, cluster, threads, smem,
                      stream);
  // -1 where no block wrote its SM: the record counts the blocks that ran
  err = cudaMemsetAsync(block_sm, 0xff, sizeof(int) * n_env * nslabs * cluster,
                        stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, kernel, io, block_sm, ny, w, nslabs,
                           inner_iters, rounds, rows_max, tx_dim, bands,
                           inv_dx2, inv_dy2, inv_diag, om, one_m_om);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
