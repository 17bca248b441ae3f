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
//   * A slab no 16-block cluster holds in shared memory goes to the
//     resident kernel (sor_slabs_resident below) where a group of up to
//     32 blocks in several clusters holds it, its bands in shared memory
//     and only the rows at cluster edges through global memory; past that
//     to the global-memory kernel (sor_slabs_global): a group of blocks
//     per (env, slab) on its planes in a workspace in global memory, the
//     same half-sweep on a band view, ordered by flags (grid_sync.cuh).
//
// The full sweeps (kFullSweeps, poisson_sor_full.cu's odd-width kernels):
// the same three bodies compute the reference's own solve on a grid of odd
// width, cfd/poisson's _full_sweeps, where it has no slabs and no rounds:
// one slab of the whole grid, one round of `iters` pairs with the domain
// BCs read live (sor_packed.cuh without kGhosts), the odd width's row rule,
// and the pairs from n_sor on at omega 1 (the polish tail).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "grid_sync.cuh"
#include "resident.cuh"
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

// The full grid (n_env, ny, nx), split into packed planes of width w =
// ceil(nx / 2) as it is loaded and interleaved back as it is stored
// (cfd/poisson pack_checkerboard):
//   red[j, k] = p[j, 2k + j%2]        black[j, k] = p[j, 2k + 1 - j%2]
// so the packed column kg of row j is the pair of grid columns (2 kg,
// 2 kg + 1), red first on even rows.  On an odd width the last pair's
// second column lies past the row: that plane's dead slot
// (sor_packed.cuh), loaded as 0 and never stored.
struct FullGrid {
  const float* p_in;
  const float* rhs;
  float* p_out;
  int w, nx;

  __device__ float p(size_t row, int kg, int colour, int j) const {
    return p_in[row * nx + 2 * kg + ((j + colour) & 1)];
  }
  __device__ void split(const float* a, int kg, bool odd, float& r,
                        float& b) const {
    const float x = a[0], y = 2 * kg + 1 < nx ? a[1] : 0.0f;
    r = odd ? y : x;
    b = odd ? x : y;
  }
  __device__ void load(size_t row, int kg, int j, float& r, float& b) const {
    split(p_in + row * nx + 2 * kg, kg, j & 1, r, b);
  }
  __device__ void load_rhs(size_t row, int kg, int j, float& r,
                           float& b) const {
    split(rhs + row * nx + 2 * kg, kg, j & 1, r, b);
  }
  __device__ void store(size_t row, int kg, int j, float r, float b) const {
    float* a = p_out + row * nx + 2 * kg;
    const bool odd = j & 1;
    a[0] = odd ? b : r;
    if (2 * kg + 1 < nx) a[1] = odd ? r : b;
  }
};

// -- what both slab kernels share: a block's band of one (env, slab) -------
//
// A band is rows [j0, j0 + nrows) of the slab's packed planes: red and black
// point at the band's stored row -1 (the halo row above), rhs_r, rhs_b and
// the four frozen ghost columns at its row 0, each plane bxp columns wide.
// The cluster kernel's band lives in the block's shared memory; the
// global-memory kernel's is a window onto the (env, slab)'s planes in its
// workspace, where the row above the band is the neighbour's own.
struct SlabBand {
  float *red, *black, *rhs_r, *rhs_b, *r_lg, *r_rg, *b_lg, *b_rg;
  int j0, nrows;
};

// Load the band's rows lj in [lo, hi] of the planes from `io` (zeros
// outside the grid), and its own rows of the right-hand sides.
template <class IO>
__device__ __forceinline__ void load_slab_rows(const IO& io,
                                               const SlabBand& b,
                                               size_t base, int c0, int ny,
                                               int bxp, int lo, int hi,
                                               int tx, int ty, int TX,
                                               int TY) {
  for (int lj = lo + ty; lj <= hi; lj += TY) {
    const int j = b.j0 + lj;
    const bool inside = j >= 0 && j < ny;
    const size_t row = base + (inside ? j : 0);
    for (int k = tx; k < bxp; k += TX) {
      float r = 0.0f, bl = 0.0f;
      if (inside) io.load(row, c0 + k, j, r, bl);
      b.red[(lj + 1) * bxp + k] = r;
      b.black[(lj + 1) * bxp + k] = bl;
      if (lj >= 0 && lj < b.nrows) {
        io.load_rhs(row, c0 + k, j, r, bl);
        b.rhs_r[lj * bxp + k] = r;
        b.rhs_b[lj * bxp + k] = bl;
      }
    }
  }
}

// The round's frozen single-parity ghosts of the band's rows: a red
// update's west/east neighbours are black, so its interior ghosts are the
// neighbour slab's black edge columns (and vice versa); at the domain ends
// the ghost has the update parity (Neumann inlet = own first column,
// Dirichlet outlet = -own last column), as the round starts.  Round 0 reads
// them from `io`, later rounds (one slab: the wrapper's rule) from the
// band's own edge columns.  A block barrier follows.
template <class IO>
__device__ __forceinline__ void freeze_ghosts(const IO& io,
                                              const SlabBand& b, int round,
                                              size_t base, int c0, int s,
                                              int nslabs, int bxp) {
  for (int lj = threadIdx.x; lj < b.nrows; lj += blockDim.x) {
    if (round == 0) {
      const int j = b.j0 + lj;
      const size_t row = base + j;
      const int kl = c0, kr = c0 + bxp - 1;
      b.r_lg[lj] = s == 0 ? io.p(row, kl, 0, j) : io.p(row, kl - 1, 1, j);
      b.r_rg[lj] = s == nslabs - 1 ? -io.p(row, kr, 0, j)
                                   : io.p(row, kr + 1, 1, j);
      b.b_lg[lj] = s == 0 ? io.p(row, kl, 1, j) : io.p(row, kl - 1, 0, j);
      b.b_rg[lj] = s == nslabs - 1 ? -io.p(row, kr, 1, j)
                                   : io.p(row, kr + 1, 0, j);
    } else {
      const float* rrow = b.red + (lj + 1) * bxp;
      const float* brow = b.black + (lj + 1) * bxp;
      b.r_lg[lj] = rrow[0];
      b.r_rg[lj] = -rrow[bxp - 1];
      b.b_lg[lj] = brow[0];
      b.b_rg[lj] = -brow[bxp - 1];
    }
  }
  __syncthreads();
}

// Store the band's own rows through `io`.
template <class IO>
__device__ __forceinline__ void store_slab_rows(const IO& io,
                                                const SlabBand& b,
                                                size_t base, int c0, int bxp,
                                                int tx, int ty, int TX,
                                                int TY) {
  for (int lj = ty; lj < b.nrows; lj += TY) {
    const int j = b.j0 + lj;
    for (int k = tx; k < bxp; k += TX)
      io.store(base + j, c0 + k, j, b.red[(lj + 1) * bxp + k],
               b.black[(lj + 1) * bxp + k]);
  }
}

// The relaxation of sweep pair `pair` of a launch: omega for the first
// n_sor pairs, 1 (the polish tail) after them.
struct Relax {
  float om, one_m_om;
};
__device__ __forceinline__ Relax relax(int pair, int n_sor, float om,
                                       float one_m_om) {
  return pair < n_sor ? Relax{om, one_m_om} : Relax{1.0f, 0.0f};
}

// The kernel body: `rounds` rounds of the (env, slab) of this block's
// cluster, on packed planes of width w (a slab w / nslabs packed columns);
// the pairs from n_sor on at omega 1.  kFullSweeps: the full sweeps (the
// header).
template <bool kFullSweeps, class IO>
__device__ __forceinline__ void sor_slabs_cluster(
    const IO& io, int* __restrict__ block_sm, int ny, int w, int nslabs,
    int inner_iters, int rounds, int n_sor, int rows_max, int tx_dim,
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
  SlabBand b;
  b.j0 = bands.start[rank];
  b.nrows = bands.start[rank + 1] - b.j0;
  const int j0 = b.j0, nrows = b.nrows;
  const bool first = rank == 0, last = rank == C - 1;

  // shared-memory layout (kernels/poisson/ops.py smem_bytes): stored row
  // s of a plane with halo rows is local row s - 1
  unsigned long long* mbar = reinterpret_cast<unsigned long long*>(smem);
  b.red = smem + 4;                    // (R + 2) x bxp, local rows -1..R
  b.black = b.red + (R + 2) * bxp;
  b.rhs_r = b.black + (R + 2) * bxp;   // R x bxp
  b.rhs_b = b.rhs_r + R * bxp;
  b.r_lg = b.rhs_b + R * bxp;          // R each: the frozen ghost columns
  b.r_rg = b.r_lg + R;
  b.b_lg = b.r_rg + R;
  b.b_rg = b.b_lg + R;

  const int nrows_prev = first ? 0 : j0 - bands.start[rank - 1];
  Link red_link{0u, 0u, 0u, 0u}, black_link{0u, 0u, 0u, 0u};
  if (!first) {
    red_link.prev = cluster_addr(b.red + (nrows_prev + 1) * bxp, rank - 1);
    red_link.prev_bar = cluster_addr(&mbar[0], rank - 1);
    black_link.prev = cluster_addr(b.black + (nrows_prev + 1) * bxp,
                                   rank - 1);
    black_link.prev_bar = cluster_addr(&mbar[1], rank - 1);
  }
  if (!last) {
    red_link.next = cluster_addr(b.red, rank + 1);
    red_link.next_bar = cluster_addr(&mbar[0], rank + 1);
    black_link.next = cluster_addr(b.black, rank + 1);
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
  load_slab_rows(io, b, base, c0, ny, bxp, -1, nrows, tx, ty, TX, TY);
  // every block of the cluster has started, holds its band and has its
  // mbarriers set before any block stores into another's shared memory
  cluster_barrier();

  for (int round = 0; round < rounds; ++round) {
    if constexpr (!kFullSweeps)
      freeze_ghosts(io, b, round, base, c0, s, nslabs, bxp);
    // a half-sweep's edge rows first wait for the other colour's halo rows
    // of the half-sweep before (the launch's first red one reads the loaded
    // halo rows); that colour's mbarrier is re-armed once the half-sweep's
    // block barrier is passed
    for (int it = 0; it < inner_iters; ++it) {
      const bool wait_black = linked && (round > 0 || it > 0);
      const Relax r = relax(round * inner_iters + it, n_sor, om, one_m_om);
      band_half_sweep<!kFullSweeps, kFullSweeps>(
          b.red, b.black, b.rhs_r, b.r_lg, b.r_rg, red_link,
          wait_black ? &mbar[1] : nullptr, black_parity, nrows, j0, ny, bxp,
          1, tx, ty, TX, TY, inv_dx2, inv_dy2, inv_diag, r.om, r.one_m_om);
      if (wait_black) {
        black_parity ^= 1u;
        if (tid == 0) mbar_expect(&mbar[1], halo_bytes);
      }
      band_half_sweep<!kFullSweeps, kFullSweeps>(
          b.black, b.red, b.rhs_b, b.b_lg, b.b_rg, black_link,
          linked ? &mbar[0] : nullptr, red_parity, nrows, j0, ny, bxp, 0, tx,
          ty, TX, TY, inv_dx2, inv_dy2, inv_diag, r.om, r.one_m_om);
      if (linked) {
        red_parity ^= 1u;
        if (tid == 0) mbar_expect(&mbar[0], halo_bytes);
      }
    }
  }
  // the last black edge rows the neighbours sent are the last stores into
  // this block: wait for them before the block may exit
  if (linked && rounds * inner_iters > 0) mbar_wait(&mbar[1], black_parity);

  store_slab_rows(io, b, base, c0, bxp, tx, ty, TX, TY);
  // no block exits while a neighbour may still address its shared memory
  cluster_barrier();
}

// -- the global-memory slab kernel: the slabs no cluster holds -------------
//
// One group of G <= kMaxGroup blocks per (env, slab) (G chosen by the
// wrapper, kernels/cluster.py global_group).  The slab's planes live in a
// workspace in global memory as one band of all ny rows (slab_ws_floats):
// rank r's band is the window of rows [r ny / G, (r + 1) ny / G), and the
// rows above and below it are its neighbours' own, read where they lie.
// The half-sweep is the cluster kernel's (sor_packed.cuh) on that band view
// without links; before each half-sweep a block waits for its two
// neighbours to have passed the half-sweep before (grid_sync.cuh), and the
// ghost snapshot between rounds reads only the block's own rows.  A point's
// arithmetic is the cluster kernel's, so the two give the same bits.

// floats of one (env, slab)'s planes in the workspace: red and black
// (ny + 2) x bxp, rhs_r and rhs_b ny x bxp, the four ghost columns ny each
// (kernels/poisson/ops.py workspace_bytes)
__host__ __device__ inline size_t slab_ws_floats(int ny, int bxp) {
  return 2 * static_cast<size_t>(ny + 2) * bxp
         + 2 * static_cast<size_t>(ny) * bxp + 4 * static_cast<size_t>(ny);
}

// The kernel body: `rounds` rounds of the (env, slab) of this block's
// group, the pairs from n_sor on at omega 1 (kFullSweeps: the header);
// this launch's groups are group0 .. group0 + gridDim.x / G - 1.
template <bool kFullSweeps, class IO>
__device__ __forceinline__ void sor_slabs_global(
    const IO& io, int* __restrict__ block_sm, float* ws, int group0,
    int n_groups, int ny, int w, int nslabs, int inner_iters, int rounds,
    int n_sor, int tx_dim, float inv_dx2, float inv_dy2, float inv_diag,
    float om, float one_m_om) {
  const int G = static_cast<int>(gridDim.x) / n_groups;
  const int local = blockIdx.x / G;
  const int rank = blockIdx.x - local * G;
  const int group = group0 + local;  // (env, slab), slabs fastest
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
  float* f = ws + local * slab_ws_floats(ny, bxp);
  unsigned* flags = reinterpret_cast<unsigned*>(
      ws + n_groups * slab_ws_floats(ny, bxp)) +
      static_cast<size_t>(local) * G * kFlagStride;
  unsigned* my_flag = flags + rank * kFlagStride;
  SlabBand b;
  b.j0 = band_start(rank, ny, G);
  b.nrows = band_start(rank + 1, ny, G) - b.j0;
  const bool first = rank == 0, last = rank == G - 1;
  float* red = f;
  float* black = red + (ny + 2) * bxp;
  float* rhs_r = black + (ny + 2) * bxp;
  float* rhs_b = rhs_r + ny * bxp;
  float* ghosts = rhs_b + ny * bxp;
  b.red = red + b.j0 * bxp;
  b.black = black + b.j0 * bxp;
  b.rhs_r = rhs_r + b.j0 * bxp;
  b.rhs_b = rhs_b + b.j0 * bxp;
  b.r_lg = ghosts + b.j0;
  b.r_rg = b.r_lg + ny;
  b.b_lg = b.r_rg + ny;
  b.b_rg = b.b_lg + ny;
  const Link none{0u, 0u, 0u, 0u};

  const size_t base = static_cast<size_t>(env) * ny;  // the env's row 0
  // the band's own rows, and the zero rows beyond the walls at its ends
  load_slab_rows(io, b, base, c0, ny, bxp, first ? -1 : 0,
                 b.nrows - 1 + (last ? 1 : 0), tx, ty, TX, TY);
  unsigned gen = 0;
  arrive(my_flag, ++gen);  // loaded: the first half-sweep waits for it

  for (int round = 0; round < rounds; ++round) {
    if constexpr (!kFullSweeps)
      freeze_ghosts(io, b, round, base, c0, s, nslabs, bxp);
    for (int it = 0; it < inner_iters; ++it) {
      const Relax r = relax(round * inner_iters + it, n_sor, om, one_m_om);
      wait_neighbours(flags, rank, G, gen);
      band_half_sweep<!kFullSweeps, kFullSweeps>(
          b.red, b.black, b.rhs_r, b.r_lg, b.r_rg, none, nullptr, 0u,
          b.nrows, b.j0, ny, bxp, 1, tx, ty, TX, TY, inv_dx2, inv_dy2,
          inv_diag, r.om, r.one_m_om);
      arrive(my_flag, ++gen);
      wait_neighbours(flags, rank, G, gen);
      band_half_sweep<!kFullSweeps, kFullSweeps>(
          b.black, b.red, b.rhs_b, b.b_lg, b.b_rg, none, nullptr, 0u,
          b.nrows, b.j0, ny, bxp, 0, tx, ty, TX, TY, inv_dx2, inv_dy2,
          inv_diag, r.om, r.one_m_om);
      arrive(my_flag, ++gen);
    }
  }
  store_slab_rows(io, b, base, c0, bxp, tx, ty, TX, TY);
}

// -- the resident slab kernel: bands in shared memory over several clusters
//
// One group of G = K C blocks per (env, slab), K >= 2 clusters of C blocks
// (G 24 or 32, C 16, 8, 4 or 2, chosen by the wrapper,
// kernels/cluster.py resident_plan), for the slabs whose band fits one block at some G <=
// kMaxGroup but at no cluster of up to 16 blocks.  Rank r holds rows [r ny
// / G, (r + 1) ny / G) of the slab's planes in shared memory, in the
// cluster kernel's layout, for every round; inside a cluster the halo rows
// travel as in sor_slabs_cluster, and at a cluster edge through the edge's
// tagged mirror slots (resident.cuh): each half-sweep at an edge block
// first receives the other colour's row of the half-sweep before, then
// sends its own edge row.  The ghost columns and rounds are sor_slabs_global's
// and each point's arithmetic the cluster kernel's, so the resident kernel
// at G gives the bits of sor_slabs_global at G.  The workspace holds only
// the mirror slots.

// The kernel body: `rounds` rounds of the (env, slab) of this block's
// group, the pairs from n_sor on at omega 1 (kFullSweeps: the header);
// this launch's groups are group0 .. group0 + gridDim.x / G - 1.
template <bool kFullSweeps, class IO>
__device__ __forceinline__ void sor_slabs_resident(
    const IO& io, int* __restrict__ block_sm, float* ws, int group0,
    int n_groups, int ny, int w, int nslabs, int inner_iters, int rounds,
    int n_sor, int rows_max, int tx_dim, float inv_dx2, float inv_dy2,
    float inv_diag, float om, float one_m_om) {
  namespace cg = cooperative_groups;
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int crank = static_cast<int>(cluster.block_rank());
  const int G = static_cast<int>(gridDim.x) / n_groups;
  const int K = G / C;
  const int local = blockIdx.x / G;
  const int rank = blockIdx.x - local * G;
  const int group = group0 + local;  // (env, slab), slabs fastest
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
  SlabBand b;
  b.j0 = band_start(rank, ny, G);
  b.nrows = band_start(rank + 1, ny, G) - b.j0;
  const int j0 = b.j0, nrows = b.nrows;
  const bool first = rank == 0, last = rank == G - 1;

  // shared memory: the cluster kernel's layout (ops.smem_bytes)
  unsigned long long* mbar = reinterpret_cast<unsigned long long*>(smem);
  b.red = smem + 4;
  b.black = b.red + (R + 2) * bxp;
  b.rhs_r = b.black + (R + 2) * bxp;
  b.rhs_b = b.rhs_r + R * bxp;
  b.r_lg = b.rhs_b + R * bxp;
  b.r_rg = b.r_lg + R;
  b.b_lg = b.r_rg + R;
  b.b_rg = b.b_lg + R;

  // the workspace: every group's mirror slots (ops.workspace_bytes)
  float* mirrors = ws + local * mirror_floats(K, kSorEdgeSlots, bxp);
  const Edge e = cluster_edge(mirrors, rank, C, K, kSorEdgeSlots, bxp);
  const bool cross = e.rank >= 0;
  const int edge_row = e.above ? 1 : nrows;  // stored rows
  const int halo_row = e.above ? 0 : nrows + 1;

  const bool prev_in = !first && crank > 0, next_in = !last && crank < C - 1;
  const int nrows_prev = first ? 0 : j0 - band_start(rank - 1, ny, G);
  Link red_link{0u, 0u, 0u, 0u}, black_link{0u, 0u, 0u, 0u};
  if (prev_in) {
    red_link.prev = cluster_addr(b.red + (nrows_prev + 1) * bxp, crank - 1);
    red_link.prev_bar = cluster_addr(&mbar[0], crank - 1);
    black_link.prev = cluster_addr(b.black + (nrows_prev + 1) * bxp,
                                   crank - 1);
    black_link.prev_bar = cluster_addr(&mbar[1], crank - 1);
  }
  if (next_in) {
    red_link.next = cluster_addr(b.red, crank + 1);
    red_link.next_bar = cluster_addr(&mbar[0], crank + 1);
    black_link.next = cluster_addr(b.black, crank + 1);
    black_link.next_bar = cluster_addr(&mbar[1], crank + 1);
  }
  // halo bytes a colour's phase waits for: a row from each neighbour in
  // this cluster
  const int halo_bytes = 4 * bxp * ((prev_in ? 1 : 0) + (next_in ? 1 : 0));
  unsigned red_parity = 0, black_parity = 0;
  if (tid == 0) {
    mbar_init(&mbar[0]);
    mbar_init(&mbar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(&mbar[0], halo_bytes);
    mbar_expect(&mbar[1], halo_bytes);
  }

  const size_t base = static_cast<size_t>(env) * ny;  // the env's row 0
  load_slab_rows(io, b, base, c0, ny, bxp, -1, nrows, tx, ty, TX, TY);
  // every block of the cluster has started, holds its band and has its
  // mbarriers set before any block stores into another's shared memory
  cluster_barrier();
  unsigned gen = 0;

  for (int round = 0; round < rounds; ++round) {
    if constexpr (!kFullSweeps)
      freeze_ghosts(io, b, round, base, c0, s, nslabs, bxp);
    for (int it = 0; it < inner_iters; ++it) {
      const int par = (round * inner_iters + it) & 1;
      const bool wait_black = round > 0 || it > 0;
      const Relax r = relax(round * inner_iters + it, n_sor, om, one_m_om);
      if (cross && wait_black)
        receive_tagged(e.recv_sor(kBlack0 + 1 - par),
                       b.black + halo_row * bxp, bxp, gen);
      band_half_sweep<!kFullSweeps, kFullSweeps>(
          b.red, b.black, b.rhs_r, b.r_lg, b.r_rg, red_link,
          wait_black ? &mbar[1] : nullptr, black_parity, nrows, j0, ny, bxp,
          1, tx, ty, TX, TY, inv_dx2, inv_dy2, inv_diag, r.om, r.one_m_om);
      if (wait_black) {
        black_parity ^= 1u;
        if (tid == 0) mbar_expect(&mbar[1], halo_bytes);
      }
      ++gen;
      if (cross) {
        send_tagged(e.send_sor(kRed0 + par), b.red + edge_row * bxp, bxp,
                    gen);
        receive_tagged(e.recv_sor(kRed0 + par), b.red + halo_row * bxp, bxp,
                       gen);
      }
      band_half_sweep<!kFullSweeps, kFullSweeps>(
          b.black, b.red, b.rhs_b, b.b_lg, b.b_rg, black_link, &mbar[0],
          red_parity, nrows, j0, ny, bxp, 0, tx, ty, TX, TY, inv_dx2,
          inv_dy2, inv_diag, r.om, r.one_m_om);
      red_parity ^= 1u;
      if (tid == 0) mbar_expect(&mbar[0], halo_bytes);
      ++gen;
      if (cross)
        send_tagged(e.send_sor(kBlack0 + par), b.black + edge_row * bxp, bxp,
                    gen);
    }
  }
  // the last black edge rows the neighbours in this cluster sent are the
  // last stores into this block: wait for them before the block may exit
  if (rounds * inner_iters > 0) mbar_wait(&mbar[1], black_parity);

  store_slab_rows(io, b, base, c0, bxp, tx, ty, TX, TY);
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
// are the block's own columns); the pairs from n_sor on run at omega 1.
// Returns the CUDA error code (0 = launched).
template <class K, class IO>
static int launch_sor_slabs(K kernel, const IO& io, int* block_sm, int n_env,
                            int ny, int w, int nslabs, int inner_iters,
                            int rounds, int n_sor, int cluster,
                            const int* starts, int rows_max, int threads,
                            int tx_dim, int smem, float inv_dx2,
                            float inv_dy2, float inv_diag, float om,
                            float one_m_om, cudaStream_t stream) {
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
                           inner_iters, rounds, n_sor, rows_max, tx_dim,
                           bands, inv_dx2, inv_dy2, inv_diag, om, one_m_om);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Launch `kernel` (a __global__ wrapper of sor_slabs_global on `io`):
// n_env x nslabs groups of `group` blocks (<= kMaxGroup, <= ny) of
// `threads` = tx_dim x (threads / tx_dim) threads, in cooperative launches
// of at most `per_launch` groups, each launch's blocks all resident at
// once; ws: the workspace of per_launch groups (ops.workspace_bytes),
// reused by each launch; block_sm: n_env x nslabs x group ints, the SM id
// each block ran on (-1 where none ran).  rounds > 1 needs nslabs == 1;
// the pairs from n_sor on run at omega 1.  Returns the CUDA error code (0
// = launched).
template <class K, class IO>
static int launch_sor_slabs_global(K kernel, const IO& io, int* block_sm,
                                   float* ws, int n_env, int ny, int w,
                                   int nslabs, int inner_iters, int rounds,
                                   int n_sor, int group, int per_launch,
                                   int threads, int tx_dim, float inv_dx2,
                                   float inv_dy2, float inv_diag, float om,
                                   float one_m_om, cudaStream_t stream) {
  if (group < 1 || group > kMaxGroup || group > ny || per_launch < 1 ||
      nslabs < 1 || w % nslabs || (rounds > 1 && nslabs != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_groups = n_env * nslabs;
  const int bxp = w / nslabs;
  cudaError_t err = cudaMemsetAsync(
      block_sm, 0xff, sizeof(int) * static_cast<size_t>(n_groups) * group,
      stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int g0 = 0; g0 < n_groups; g0 += per_launch) {
    const int n = n_groups - g0 < per_launch ? n_groups - g0 : per_launch;
    err = cudaMemsetAsync(ws + n * slab_ws_floats(ny, bxp), 0,
                          sizeof(unsigned) * n * group * kFlagStride, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    fill_cooperative_config(cfg, attr, n * group, threads, stream);
    err = cudaLaunchKernelEx(&cfg, kernel, io, block_sm + g0 * group, ws, g0,
                             n, ny, w, nslabs, inner_iters, rounds, n_sor,
                             tx_dim, inv_dx2, inv_dy2, inv_diag, om,
                             one_m_om);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Launch `kernel` (a __global__ wrapper of sor_slabs_resident on `io`):
// n_env x nslabs groups of `group` blocks (<= kMaxGroup, <= ny), each
// group / cluster clusters of `cluster` blocks (2 <= cluster <=
// kMaxCluster), of `threads` = tx_dim x (threads / tx_dim) threads and
// `smem` bytes of dynamic shared memory (ops.smem_bytes at `group`, whose
// largest band has rows_max rows), in launches of at most `per_launch`
// groups; ws: the workspace of per_launch groups (ops.workspace_bytes: the mirror
// slots), reused by each launch; block_sm: n_env x nslabs x group
// ints, the SM id each block ran on (-1 where none ran).  rounds > 1 needs
// nslabs == 1; the pairs from n_sor on run at omega 1.  Returns the CUDA
// error code (0 = launched).
template <class K, class IO>
static int launch_sor_slabs_resident(
    K kernel, const IO& io, int* block_sm, float* ws, int n_env, int ny,
    int w, int nslabs, int inner_iters, int rounds, int n_sor, int group,
    int cluster, int per_launch, int rows_max, int threads, int tx_dim,
    int smem, float inv_dx2, float inv_dy2, float inv_diag, float om,
    float one_m_om, cudaStream_t stream) {
  if (group < 1 || group > kMaxGroup || group > ny || cluster < 2 ||
      cluster > kMaxCluster || group % cluster || per_launch < 1 ||
      nslabs < 1 || w % nslabs || (rounds > 1 && nslabs != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_groups = n_env * nslabs;
  cudaError_t err = set_cluster_attributes(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(
      block_sm, 0xff, sizeof(int) * static_cast<size_t>(n_groups) * group,
      stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int g0 = 0; g0 < n_groups; g0 += per_launch) {
    const int n = n_groups - g0 < per_launch ? n_groups - g0 : per_launch;
    // the mirror slots zeroed: a phase counts from 1
    err = cudaMemsetAsync(
        ws, 0,
        sizeof(float) * n * mirror_floats(group / cluster, kSorEdgeSlots,
                                          w / nslabs),
        stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[2];
    fill_resident_config(cfg, attr, n * (group / cluster), cluster, threads,
                         smem, stream);
    err = cudaLaunchKernelEx(&cfg, kernel, io, block_sm + g0 * group, ws, g0,
                             n, ny, w, nslabs, inner_iters, rounds, n_sor,
                             rows_max, tx_dim, inv_dx2, inv_dy2, inv_diag, om,
                             one_m_om);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
