// The packed red-black SOR half-sweep over one block's band of rows, shared
// by the kernels that spread a pressure plane over a thread-block cluster
// (fused_interval.cu: live domain BCs; sor_slabs.cuh, the two slab
// kernels: ghost columns frozen per block-Jacobi round).  The reference is cfd/poisson's
// packed_half_sweep.
//
// Packed-checkerboard layout (nx even; row j, packed column k):
//   red[j, k] = p[j, 2k + j%2]        black[j, k] = p[j, 2k + 1 - j%2]
// Vertical neighbours of a point sit at the same packed index in the other
// plane; horizontal neighbours are the other plane's columns (k-1, k) on
// one row parity and (k, k+1) on the other.
//
// A band is rows [j0, j0 + nrows) of a plane, stored with one halo row
// above and one below.  A half-sweep reads only the other colour, so the
// band split changes no arithmetic, only when each row is read: a
// neighbour's edge row of the half-sweep before must be in the halo row
// (cluster.cuh: st.async counted by the receiver's mbarrier).
#pragma once

#include <cuda_runtime.h>

#include "cluster.cuh"
#include "common.cuh"

// One row lj of a coloured half-sweep over this block's band of a packed
// plane of width w.  `a` and `o` point at stored row -1 (the halo above)
// of this colour's and the other colour's band, `rhs` at this colour's own
// row 0.  Rows whose global parity equals shift_parity take their
// horizontal neighbours at packed columns (k, k+1).  Wall rows are Neumann
// (the point's own value).  Column ghosts: with kGhosts, `lg[lj]` and
// `rg[lj]` (frozen values: the slab kernel's block-Jacobi halos); without,
// the live domain BCs (Neumann inlet = own first column, Dirichlet-0
// outlet = negated own last column).  The arithmetic is the reference's,
// p_gs = (nb - rhs) * inv_diag then (1 - om) * a + om * p_gs, with the
// divisions by dx^2, dy^2 taken as multiplications by their reciprocals.
// Every read of `a` is of the point being updated, so the in-place update
// equals the reference's out-of-place one.  kEdge: the band's first or
// last row, whose values also go to the neighbours' halo rows.
template <bool kEdge, bool kGhosts>
__device__ __forceinline__ void sweep_row(
    float* a, const float* o, const float* rhs, const float* lg,
    const float* rg, const Link& link, int lj, int nrows, int j0, int ny,
    int w, int shift_parity, int tx, int TX, float inv_dx2, float inv_dy2,
    float inv_diag, float om, float one_m_om) {
  const int j = j0 + lj;
  float* arow = a + (lj + 1) * w;
  const float* orow = o + (lj + 1) * w;
  const float* rrow = rhs + lj * w;
  const bool shift = (j & 1) == shift_parity;
  const bool top = j == 0, bottom = j == ny - 1;
  const unsigned to_prev = (kEdge && lj == 0) ? link.prev : 0u;
  const unsigned to_next = (kEdge && lj == nrows - 1) ? link.next : 0u;
  for (int k = tx; k < w; k += TX) {
    const float self = arow[k];
    const float oc = orow[k];
    float horiz;
    if (shift) {
      horiz = oc + ((k == w - 1) ? (kGhosts ? rg[lj] : -self) : orow[k + 1]);
    } else {
      horiz = ((k == 0) ? (kGhosts ? lg[lj] : self) : orow[k - 1]) + oc;
    }
    const float north = top ? self : orow[k - w];
    const float south = bottom ? self : orow[k + w];
    const float nb = horiz * inv_dx2 + (north + south) * inv_dy2;
    const float p_gs = (nb - rrow[k]) * inv_diag;
    const float val = one_m_om * self + om * p_gs;
    arow[k] = val;
    if (kEdge) {
      if (to_prev) st_async(to_prev + 4 * k, val, link.prev_bar);
      if (to_next) st_async(to_next + 4 * k, val, link.next_bar);
    }
  }
}

// One coloured half-sweep over the band, rows taken in the order first,
// last, then the interior, round-robin over the thread rows: the edge rows
// (sent to the neighbours as they are computed) start in the first pass.
// Only the edge rows read the other colour's halo rows, so only their
// threads wait for them (`halo`: the mbarrier of that colour, nullptr when
// there is nothing to wait for; the wait returns at once if the phase of
// `parity` has completed); the interior rows go ahead.  A block barrier
// then orders the band before the next half-sweep reads it.
template <bool kGhosts>
__device__ __forceinline__ void band_half_sweep(
    float* a, const float* o, const float* rhs, const float* lg,
    const float* rg, const Link& link, unsigned long long* halo,
    unsigned parity, int nrows, int j0, int ny, int w, int shift_parity,
    int tx, int ty, int TX, int TY, float inv_dx2, float inv_dy2,
    float inv_diag, float om, float one_m_om) {
  const int n_edge = nrows > 1 ? 2 : 1;
  for (int q = ty; q < nrows; q += TY) {
    if (q < n_edge) {
      if (halo) mbar_wait(halo, parity);
      sweep_row<true, kGhosts>(a, o, rhs, lg, rg, link,
                               q == 0 ? 0 : nrows - 1, nrows, j0, ny, w,
                               shift_parity, tx, TX, inv_dx2, inv_dy2,
                               inv_diag, om, one_m_om);
    } else {
      sweep_row<false, kGhosts>(a, o, rhs, lg, rg, link, q - 1, nrows, j0,
                                ny, w, shift_parity, tx, TX, inv_dx2,
                                inv_dy2, inv_diag, om, one_m_om);
    }
  }
  __syncthreads();
}
