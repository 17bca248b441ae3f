// Device code of the packed-plane kernels: the packed red-black SOR
// half-sweep of one block (as in the reference's
// cfd/poisson.packed_half_sweep; fused_interval.cu keeps a banded copy
// of its arithmetic for a cluster) and a block-wide sum both use.
//
// Packed-checkerboard layout (nx even; row j, packed column k):
//   red[j, k] = p[j, 2k + j%2]        black[j, k] = p[j, 2k + 1 - j%2]
// Vertical neighbours of a point sit at the same packed index in the other
// plane; horizontal neighbours are the other plane's columns (k-1, k) on
// one row parity and (k, k+1) on the other.
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

// One coloured Gauss-Seidel half-sweep over a packed plane `a` of shape
// (ny, w) held in shared memory, in place, by all threads of the block.
// `o` is the other colour's plane, `rhs` this colour's right-hand side.
// Rows with (j & 1) == shift_parity take their horizontal neighbours at
// packed columns (k, k+1) (red: odd rows, black: even rows).
// Ghost columns: `lg`/`rg` (ny,) hold frozen values (the slab kernel's
// block-Jacobi halos); nullptr means the live domain BCs of a single
// domain (Neumann inlet = own first column, Dirichlet-0 outlet = negated
// own last column).  Wall ghost rows are Neumann: the point's own value.
// Every read of `a` is of the point being updated, so the in-place update
// equals the reference's out-of-place one.  The association is the
// reference's: p_gs = (nb - rhs) * inv_diag, then (1-om)*a + om*p_gs.
__device__ __forceinline__ void packed_half_sweep(
    float* a, const float* o, const float* rhs, const float* lg,
    const float* rg, int ny, int w, int shift_parity, float dx2, float dy2,
    float inv_diag, float om, float one_m_om) {
  const int n = ny * w;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int j = idx / w;
    const int k = idx - j * w;
    const float self = a[idx];
    const float oc = o[idx];
    float horiz;
    if ((j & 1) == shift_parity) {
      const float oe = (k == w - 1) ? (rg ? rg[j] : -self) : o[idx + 1];
      horiz = oc + oe;
    } else {
      const float ow = (k == 0) ? (lg ? lg[j] : self) : o[idx - 1];
      horiz = ow + oc;
    }
    const float north = (j == 0) ? self : o[idx - w];
    const float south = (j == ny - 1) ? self : o[idx + w];
    const float nb = horiz / dx2 + (north + south) / dy2;
    const float p_gs = (nb - rhs[idx]) * inv_diag;
    a[idx] = one_m_om * self + om * p_gs;
  }
}

// Sum of three per-thread values over the block (blockDim.x a multiple of
// 32).  `scratch` is shared memory of at least 100 floats.  Every thread
// returns the totals; contains __syncthreads(), so all threads must call.
__device__ __forceinline__ void block_sum3(float& a, float& b, float& c,
                                           float* scratch) {
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
    c += __shfl_down_sync(0xffffffffu, c, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    scratch[warp] = a;
    scratch[32 + warp] = b;
    scratch[64 + warp] = c;
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    a = lane < nwarps ? scratch[lane] : 0.0f;
    b = lane < nwarps ? scratch[32 + lane] : 0.0f;
    c = lane < nwarps ? scratch[64 + lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, off);
      b += __shfl_down_sync(0xffffffffu, b, off);
      c += __shfl_down_sync(0xffffffffu, c, off);
    }
    if (lane == 0) {
      scratch[96] = a;
      scratch[97] = b;
      scratch[98] = c;
    }
  }
  __syncthreads();
  a = scratch[96];
  b = scratch[97];
  c = scratch[98];
}
