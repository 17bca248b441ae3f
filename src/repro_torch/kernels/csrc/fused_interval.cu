// Fused actuation interval: n_steps solver dt's in one launch, one
// thread-block cluster per env (fused_interval_kernel) on the grids a
// cluster holds, one group of blocks per env whose fields live in global
// memory (fused_interval_global_kernel) on every other grid.
//
// Replaces the Pallas TPU megakernel _fused_dt_kernel / fused_step
// (src/repro/kernels/actuation/kernel.py:39-85), which ran ONE dt per
// launch under a lax.scan over the interval (ops.fused_interval).
//
// What it computes, per env and per dt (the reference's ops.fused_dt):
//   pad u/v; blended-upwind advection + diffusion (explicit Euler);
//   implicit penalization toward the jet/rotary target with the act_mode
//   blend; reaction forces fx, fy from the predictor; inlet/outlet BCs and
//   the outlet mass correction; the divergence rhs packed into red/black
//   planes; `iters` packed SOR pairs (omega, then an omega=1 polish tail of
//   n_polish pairs); the projection velocity correction and BCs; C_D, C_L.
//
// Two instantiations, by the compile-time body count NB:
//   NB = 0  the scalar amplitude (one jet speed or one surface speed for
//           every body) on one geometry shared by the batch: the cylinder
//           path.
//   NB > 0  per-body actuation, the reference's vector branch of
//           solver._momentum (which its TPU megakernel does not serve): one
//           amplitude vector a per env, the target
//           (1 - m) a_0 jet + m sum_b a_b rotb_b, and C_D / C_L per body,
//           the reaction force split by the one-hot ownership own_b.  Each
//           env reads its own geometry from a stacked bank (G geometries,
//           picked by geom_id[env]), so one launch serves a batch that
//           mixes the cylinder, the pinball and tandem cylinders.  The
//           2 NB + 1 force and outflux partials are summed as the scalar
//           body's three are: in one fixed order through DSMEM.
//
// What bounds it on an H100: the chain of dependent phases, not the
// arithmetic.  A dt is 2 x iters + 2 phases in sequence (the predictor,
// the SOR half-sweeps, the correction), and each reads the previous one's
// result across rows, so each waits for the rows another block wrote.  At
// res 16 a half-sweep is 11,616 points, ~10 flops each: ~0.1 us of work
// spread over 16 SMs, less than one synchronisation between SMs costs.
// The operation bound (~14 MFLOP per dt and env at 67 TFLOP/s) is far
// below what the chain of 50 x 122 synchronisations allows; PERF.md keeps
// the time per link of the chain beside the bound.
//
// Design, against that chain:
//   * One cluster of C blocks per env (C <= 16, chosen by the wrapper,
//     kernels/actuation/ops.py choose_cluster).  Rank r owns the pressure
//     rows [start[r], start[r+1]); u takes the same rows, v the same rows
//     plus the top wall row ny on the last rank.  A phase's points spread
//     over C SMs, and n_env x C SMs are busy in place of n_env.
//   * Every field of the interval lives in the cluster's shared memory:
//     each block holds its band of u, v, u_pen, v_pen and of the four
//     packed planes, with one halo row above and below where a stencil
//     reads across the band's edge.  Global memory is read once at the
//     start and written once at the end (the static geometry is read from
//     global memory, where L1/L2 hold it).
//   * Halo rows travel through distributed shared memory: the thread that
//     computes a band's first or last row also stores the value into the
//     neighbouring rank's halo row.  In the SOR, which is all but two
//     phases of a dt, that store is an st.async counted by an mbarrier of
//     the receiving block, and a half-sweep waits only for its two
//     neighbours' rows of the half-sweep before: red-black SOR reads only
//     the other colour, so one such exchange per half-sweep suffices, and
//     its arithmetic is the single-domain one.  The edge rows are computed
//     first.  On an H100 a half-sweep took about twice as long with a
//     release/acquire cluster barrier after it as with this exchange
//     (PERF.md); the two phases that need every block (the force sums
//     after the predictor, the velocity halos after the correction) keep
//     a cluster barrier.
//   * The force and outflux sums: each block reduces its band, every warp
//     of every block reads the C partials through DSMEM and sums them in
//     one fixed order (no atomics), so every block holds the same
//     correction and C_D/C_L, and two launches on one input are bitwise
//     identical.
//   * Few instructions per point: 2-D loops (rows by thread row, columns
//     by lane; no index division) and multiplications by float32
//     reciprocals of the grid constants in place of divisions by them.
//     The divisions by per-env or per-point values (lap / re, / (1 + lp))
//     stay.
//   * Past what a 16-block cluster's shared memory holds (res 39 and up at
//     the default aspect) the global-memory kernel below runs the same
//     phases, the same functions on a band view of the env's fields in a
//     workspace in global memory, ordered by flags (grid_sync.cuh).
//   * A grid of odd width, where the reference's megakernel has no
//     checkerboard parity and its fused interval runs its reference scan
//     instead (src/repro/kernels/actuation/ops.py:83-91), runs the same
//     kernels: the packed planes are (nx + 1) / 2 wide with a dead slot on
//     each row (sor_packed.cuh's odd row rule), which the divergence, the
//     correction, the load and the store skip.  The packed SOR sweeps the
//     reference's full-grid SOR point for point, so every phase of a dt is
//     the reference scan's.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "grid_sync.cuh"
#include "resident.cuh"
#include "sor_packed.cuh"

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

// Sum of K per-thread values over the block, as block_sum3 sums three:
// `scratch` is shared memory of at least 33 K floats; every thread returns
// the totals; contains __syncthreads(), so all threads must call.
template <int K>
__device__ __forceinline__ void block_sum(float (&x)[K], float* scratch) {
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      x[k] += __shfl_down_sync(0xffffffffu, x[k], off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) scratch[32 * k + warp] = x[k];
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
#pragma unroll
    for (int k = 0; k < K; ++k)
      x[k] = lane < nwarps ? scratch[32 * k + lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        x[k] += __shfl_down_sync(0xffffffffu, x[k], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) scratch[32 * K + k] = x[k];
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) x[k] = scratch[32 * K + k];
}

namespace cg = cooperative_groups;

struct Geom {  // the reference's GeomArrays order
  const float* chi_u;
  const float* chi_v;
  const float* jet_u;  // (2, ny, nx+1)
  const float* jet_v;  // (2, ny+1, nx)
  const float* jmask_u;
  const float* jmask_v;
  const float* rot_u;
  const float* rot_v;
  const float* rmask_u;
  const float* rmask_v;
  const float* inlet_u;  // (ny,)
};

// The per-body instantiation's geometry: a bank of G geometries, each
// field stacked on a leading dim of G planes (the per-body fields padded
// with zero bodies to NB), and the bank index of each env.
struct GeomBank : Geom {
  const float* rotb_u;  // (G, NB, ny, nx+1)
  const float* rotb_v;  // (G, NB, ny+1, nx)
  const float* own_u;   // (G, NB, ny, nx+1)
  const float* own_v;   // (G, NB, ny+1, nx)
  const int* geom_id;   // (n_env,)
};

template <int NB>
using GeomOf = std::conditional_t<NB == 0, Geom, GeomBank>;

// float slots of the partial sums a block publishes to its cluster
template <int NB>
constexpr int kPartSlots = NB == 0 ? 4 : (2 * NB + 1 + 3) / 4 * 4;

// float32 constants, each rounded from the float64 value the wrapper
// computes (order: see kernels/actuation/ops.py _consts)
struct Consts {
  float dt, dx, dy, inv_dx, inv_dy, inv_dx2, inv_dy2, inv_2dx, inv_2dy,
      inv_dt, blend, one_m_blend, lam, inv_diag, omega, one_m_omega, ny_dy,
      coef;
};
constexpr int kNumConsts = 18;

// Column ghosts of the reference's _pad_u on one stored row (i in
// [-1, nx+1]): inlet extrapolates (2 u0 - u1), outlet zero-gradient.  The
// wall ghost rows are stored (halo rows of the first and last rank).
__device__ __forceinline__ float U(const float* row, int i, int nx) {
  if (i < 0) return 2.0f * row[0] - row[1];
  if (i > nx) return row[nx];
  return row[i];
}
// Column ghosts of _pad_v (i in [-1, nx]): inlet reflects, outlet
// zero-gradient.
__device__ __forceinline__ float V(const float* row, int i, int nx) {
  if (i < 0) return -row[0];
  if (i >= nx) return row[nx - 1];
  return row[i];
}

// Store `val` at column i of own row lj of a banded field, and mirror it
// into the neighbours' halo rows when lj is the band's first (`prev`) or
// last (`next`) row.  `prev` / `next` point at the neighbour's halo row,
// nullptr where there is no neighbour (and throughout in the global-memory
// kernel, whose bands share one copy of each row).
__device__ __forceinline__ void put(float* row, float* prev, float* next,
                                    int lj, int nrows, int i, float val) {
  row[i] = val;
  if (lj == 0 && prev) prev[i] = val;
  if (lj == nrows - 1 && next) next[i] = val;
}

// -- what both kernels share: the phases of a dt over one block's band ------
//
// A band is rows [j0, j0 + nrows) of one env's fields.  u, v, red and black
// point at the band's stored row -1 (the halo row above), us, vs, rhs_r and
// rhs_b at its row 0, each field stored row after row at its own width.
// The cluster kernel's band lives in the block's shared memory, with halo
// rows the neighbours fill; the global-memory kernel's is a window onto the
// env's whole fields in its workspace, where the row above the band is the
// neighbour's own.  The arithmetic of a point is the same in both.
struct Band {
  float *u, *v, *us, *vs, *red, *black, *rhs_r, *rhs_b;
  int j0, nrows, nv_rows;  // nv_rows: + the top wall row ny on the last
  bool first, last;
};

// The neighbours' halo rows a band's edge rows are mirrored into (nullptr
// at the walls, and in the global-memory kernel).
struct Mirror {
  float *u_prev, *v_prev, *vs_prev, *u_next, *v_next;
};

// The thread layout: lanes tx of TX span a row, thread rows ty of TY step
// over the band's rows.
struct Lanes {
  int tx, ty, TX, TY;
};

// One env's amplitude (a scalar, or NB per-body speeds whose slot 0 doubles
// as the jet amplitude), Reynolds number and act_mode blend.
template <int NB>
struct Actuation {
  float jvb[NB > 0 ? NB : 1];
  float jv, re, m, one_m_m;
};

// A block's (then the env's) reaction force and outflux sums: fx, fy for
// the scalar body, fxb, fyb per body.
template <int NB>
struct Sums {
  float fx, fy, out;
  float fxb[NB > 0 ? NB : 1], fyb[NB > 0 ? NB : 1];
};

// Point `g` at env `env`'s geometry in the bank (NB > 0).
template <int NB>
__device__ __forceinline__ void env_geometry(GeomOf<NB>& g, int env,
                                             size_t nu, size_t nv, int ny) {
  if constexpr (NB > 0) {
    const size_t gid = static_cast<size_t>(g.geom_id[env]);
    g.chi_u += gid * nu;
    g.chi_v += gid * nv;
    g.jet_u += gid * 2 * nu;
    g.jet_v += gid * 2 * nv;
    g.jmask_u += gid * nu;
    g.jmask_v += gid * nv;
    g.rot_u += gid * nu;
    g.rot_v += gid * nv;
    g.rmask_u += gid * nu;
    g.rmask_v += gid * nv;
    g.inlet_u += gid * ny;
    g.rotb_u += gid * NB * nu;
    g.rotb_v += gid * NB * nv;
    g.own_u += gid * NB * nu;
    g.own_v += gid * NB * nv;
  }
}

template <int NB>
__device__ __forceinline__ Actuation<NB> env_actuation(
    const float* jet_vel, const float* re_arr, const float* mode_arr,
    int env) {
  Actuation<NB> a;
  if constexpr (NB > 0) {
#pragma unroll
    for (int b = 0; b < NB; ++b) a.jvb[b] = jet_vel[env * NB + b];
  }
  a.jv = NB == 0 ? jet_vel[env] : a.jvb[0];
  a.re = re_arr[env];
  a.m = mode_arr[env];
  a.one_m_m = 1.0f - a.m;
  return a;
}

// The packed planes' width: nx / 2, or (nx + 1) / 2 on an odd width, whose
// rows each hold one dead slot (sor_packed.cuh).  The device functions take
// the width's parity as kOdd, so an even grid's code is the even width's
// alone.
__host__ __device__ inline int packed_width(int nx) { return (nx + 1) / 2; }
template <bool kOdd>
__device__ __forceinline__ int packed_w(int nx) {
  return kOdd ? (nx + 1) / 2 : nx / 2;
}

// Load the band's rows lj in [lo, u_hi] of u and of the packed pressure
// planes and [lo, v_hi] of v from the env's input; the wall ghost rows of
// _pad_u / _pad_v (-u, 0 * v) where the band meets a wall; a dead slot of
// the planes 0.
template <bool kOdd>
__device__ __forceinline__ void load_rows(const Band& b, const float* u_in,
                                          const float* v_in,
                                          const float* p_in, const Lanes& l,
                                          int ny, int nx, int lo, int u_hi,
                                          int v_hi) {
  const int nxu = nx + 1, w = packed_w<kOdd>(nx);
  for (int lj = lo + l.ty; lj <= u_hi; lj += l.TY) {
    const int j = b.j0 + lj;
    const float sign = (j < 0 || j >= ny) ? -1.0f : 1.0f;
    const float* src = u_in + static_cast<size_t>(min(max(j, 0), ny - 1)) * nxu;
    for (int i = l.tx; i < nxu; i += l.TX) b.u[(lj + 1) * nxu + i] = sign * src[i];
  }
  for (int lj = lo + l.ty; lj <= v_hi; lj += l.TY) {
    const int j = b.j0 + lj;
    const bool ghost = j < 0 || j > ny;
    const float* src = v_in + static_cast<size_t>(min(max(j, 0), ny)) * nx;
    for (int i = l.tx; i < nx; i += l.TX)
      b.v[(lj + 1) * nx + i] = ghost ? src[i] * 0.0f : src[i];
  }
  for (int lj = lo + l.ty; lj <= u_hi; lj += l.TY) {
    const int j = b.j0 + lj;
    const bool inside = j >= 0 && j < ny;
    const float* src = p_in + static_cast<size_t>(inside ? j : 0) * nx;
    for (int k = l.tx; k < w; k += l.TX) {
      const int ir = 2 * k + (j & 1), ib = 2 * k + 1 - (j & 1);
      b.red[(lj + 1) * w + k] =
          inside && (!kOdd || ir < nx) ? src[ir] : 0.0f;
      b.black[(lj + 1) * w + k] =
          inside && (!kOdd || ib < nx) ? src[ib] : 0.0f;
    }
  }
}

// -- A: predictor, penalization, BCs but the outlet column of u_pen, this
//    block's force and outflux partial sums -------------------------------
template <int NB>
__device__ __forceinline__ void predictor(const Band& b, const Mirror& h,
                                          const GeomOf<NB>& g,
                                          const Actuation<NB>& a,
                                          const Consts& c, const Lanes& l,
                                          int ny, int nx, Sums<NB>& s) {
  const int nxu = nx + 1;
  const size_t nu = static_cast<size_t>(ny) * nxu;
  const size_t nv = static_cast<size_t>(ny + 1) * nx;
  const float jv = a.jv, re = a.re, m = a.m, one_m_m = a.one_m_m;
  s.fx = 0.0f;
  s.fy = 0.0f;
  s.out = 0.0f;
  if constexpr (NB > 0) {
#pragma unroll
    for (int k = 0; k < NB; ++k) s.fxb[k] = s.fyb[k] = 0.0f;
  }
  for (int lj = l.ty; lj < b.nrows; lj += l.TY) {
    const int j = b.j0 + lj;
    const float* ur0 = b.u + (lj + 1) * nxu;  // row j
    const float* urb = ur0 - nxu;             // j - 1
    const float* urt = ur0 + nxu;             // j + 1
    const float* vr0 = b.v + (lj + 1) * nx;   // v row j
    const float* vr1 = vr0 + nx;              // v row j + 1
    float* usr = b.us + lj * nx;
    const float inlet = g.inlet_u[j];
    for (int i = l.tx; i < nxu; i += l.TX) {
      const int gi = j * nxu + i;
      const float uc = U(ur0, i, nx);
      const float ul = U(ur0, i - 1, nx);
      const float ur = U(ur0, i + 1, nx);
      const float ub = U(urb, i, nx);
      const float ut = U(urt, i, nx);
      const float vau = 0.25f * (((V(vr0, i - 1, nx) + V(vr0, i, nx))
                                  + V(vr1, i - 1, nx)) + V(vr1, i, nx));
      const float dudx_up = uc > 0.0f ? (uc - ul) * c.inv_dx : (ur - uc) * c.inv_dx;
      const float dudy_up = vau > 0.0f ? (uc - ub) * c.inv_dy : (ut - uc) * c.inv_dy;
      const float dudx = c.blend * dudx_up + (c.one_m_blend * (ur - ul)) * c.inv_2dx;
      const float dudy = c.blend * dudy_up + (c.one_m_blend * (ut - ub)) * c.inv_2dy;
      const float adv = uc * dudx + vau * dudy;
      const float lap = ((ul + ur) - 2.0f * uc) * c.inv_dx2
                        + ((ub + ut) - 2.0f * uc) * c.inv_dy2;
      const float u_star = uc + c.dt * (-adv + lap / re);
      float tgt;
      if constexpr (NB == 0) {
        tgt = jv * (one_m_m * (g.jet_u[gi] - g.jet_u[nu + gi])
                    + m * g.rot_u[gi]);
      } else {
        float rot = 0.0f;
#pragma unroll
        for (int k = 0; k < NB; ++k) rot += a.jvb[k] * g.rotb_u[k * nu + gi];
        tgt = (one_m_m * jv) * (g.jet_u[gi] - g.jet_u[nu + gi]) + m * rot;
      }
      const float pen = fmaxf(g.chi_u[gi],
                              one_m_m * g.jmask_u[gi] + m * g.rmask_u[gi]);
      const float lp = c.lam * pen;
      const float u_pen = (u_star + lp * tgt) / (1.0f + lp);
      if constexpr (NB == 0) {
        s.fx += (u_pen - u_star) * c.inv_dt;
      } else {
        const float d = (u_pen - u_star) * c.inv_dt;
#pragma unroll
        for (int k = 0; k < NB; ++k) s.fxb[k] += g.own_u[k * nu + gi] * d;
      }
      if (i == nx - 1) s.out += u_pen;
      if (i < nx) usr[i] = i == 0 ? inlet : u_pen;  // column nx: in C
    }
  }
  for (int lj = l.ty; lj < b.nv_rows; lj += l.TY) {
    const int j = b.j0 + lj;
    const bool wall = j == 0 || j == ny;
    const float* vr0 = b.v + (lj + 1) * nx;  // row j
    const float* vrb = vr0 - nx;
    const float* vrt = vr0 + nx;
    const float* ur0 = b.u + (lj + 1) * nxu;  // u row j
    const float* urb = ur0 - nxu;             // u row j - 1
    float* vsr = b.vs + lj * nx;
    for (int i = l.tx; i < nx; i += l.TX) {
      const int gi = j * nx + i;
      const float vc = V(vr0, i, nx);
      const float vl = V(vr0, i - 1, nx);
      const float vr = V(vr0, i + 1, nx);
      const float vb = V(vrb, i, nx);
      const float vt = V(vrt, i, nx);
      const float uav = 0.25f * (((U(urb, i, nx) + U(urb, i + 1, nx))
                                  + U(ur0, i, nx)) + U(ur0, i + 1, nx));
      const float dvdx_up = uav > 0.0f ? (vc - vl) * c.inv_dx : (vr - vc) * c.inv_dx;
      const float dvdy_up = vc > 0.0f ? (vc - vb) * c.inv_dy : (vt - vc) * c.inv_dy;
      const float dvdx = c.blend * dvdx_up + (c.one_m_blend * (vr - vl)) * c.inv_2dx;
      const float dvdy = c.blend * dvdy_up + (c.one_m_blend * (vt - vb)) * c.inv_2dy;
      const float adv = uav * dvdx + vc * dvdy;
      const float lap = ((vl + vr) - 2.0f * vc) * c.inv_dx2
                        + ((vb + vt) - 2.0f * vc) * c.inv_dy2;
      const float v_star = vc + c.dt * (-adv + lap / re);
      float tgt;
      if constexpr (NB == 0) {
        tgt = jv * (one_m_m * (g.jet_v[gi] - g.jet_v[nv + gi])
                    + m * g.rot_v[gi]);
      } else {
        float rot = 0.0f;
#pragma unroll
        for (int k = 0; k < NB; ++k) rot += a.jvb[k] * g.rotb_v[k * nv + gi];
        tgt = (one_m_m * jv) * (g.jet_v[gi] - g.jet_v[nv + gi]) + m * rot;
      }
      const float pen = fmaxf(g.chi_v[gi],
                              one_m_m * g.jmask_v[gi] + m * g.rmask_v[gi]);
      const float lp = c.lam * pen;
      const float v_pen = (v_star + lp * tgt) / (1.0f + lp);
      if constexpr (NB == 0) {
        s.fy += (v_pen - v_star) * c.inv_dt;
      } else {
        const float d = (v_pen - v_star) * c.inv_dt;
#pragma unroll
        for (int k = 0; k < NB; ++k) s.fyb[k] += g.own_v[k * nv + gi] * d;
      }
      // _apply_bc_v: inlet 0, outlet copies column -2, walls 0
      if (i == nx - 1) continue;
      const float val = (i == 0 || wall) ? 0.0f : v_pen;
      put(vsr, h.vs_prev, nullptr, lj, b.nrows, i, val);
      if (i == nx - 2) put(vsr, h.vs_prev, nullptr, lj, b.nrows, nx - 1, val);
    }
  }
}

// The block's partial sums, reduced over its threads, into `part` (thread 0
// writes; `scratch`: the reduction's shared memory).
template <int NB>
__device__ __forceinline__ void publish_partials(Sums<NB>& s, float* part,
                                                 float* scratch) {
  if constexpr (NB == 0) {
    block_sum3(s.fx, s.fy, s.out, scratch);
    if (threadIdx.x == 0) {
      part[0] = s.fx;
      part[1] = s.fy;
      part[2] = s.out;
    }
  } else {  // per-body fx, per-body fy, outflux
    float sums[2 * NB + 1];
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      sums[k] = s.fxb[k];
      sums[NB + k] = s.fyb[k];
    }
    sums[2 * NB] = s.out;
    block_sum(sums, scratch);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int k = 0; k < 2 * NB + 1; ++k) part[k] = sums[k];
    }
  }
}

// The env's sums from its C blocks' partials, in one fixed order on every
// warp of every block: lane r < C reads rank r's (`part_of_lane`), then a
// butterfly over the 32 lanes.  C orders the sums, whichever kernel runs.
template <int NB>
__device__ __forceinline__ void gather_sums(const float* part_of_lane, int C,
                                            int lane, Sums<NB>& s) {
  if constexpr (NB == 0) {
    s.fx = lane < C ? part_of_lane[0] : 0.0f;
    s.fy = lane < C ? part_of_lane[1] : 0.0f;
    s.out = lane < C ? part_of_lane[2] : 0.0f;
    for (int off = 1; off < 32; off <<= 1) {
      s.fx += __shfl_xor_sync(0xffffffffu, s.fx, off);
      s.fy += __shfl_xor_sync(0xffffffffu, s.fy, off);
      s.out += __shfl_xor_sync(0xffffffffu, s.out, off);
    }
  } else {
    float sums[2 * NB + 1];
#pragma unroll
    for (int k = 0; k < 2 * NB + 1; ++k)
      sums[k] = lane < C ? part_of_lane[k] : 0.0f;
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < 2 * NB + 1; ++k)
        sums[k] += __shfl_xor_sync(0xffffffffu, sums[k], off);
    }
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      s.fxb[k] = sums[k];
      s.fyb[k] = sums[NB + k];
    }
    s.out = sums[2 * NB];
  }
}

// C_D and C_L of dt t from the env's sums (one thread of the env calls).
template <int NB>
__device__ __forceinline__ void write_coefficients(float* cd_out,
                                                   float* cl_out, int t,
                                                   const Sums<NB>& s,
                                                   const Consts& c) {
  if constexpr (NB == 0) {
    cd_out[t] = ((-s.fx * c.dx) * c.dy) / c.coef;
    cl_out[t] = ((-s.fy * c.dx) * c.dy) / c.coef;
  } else {
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      cd_out[t * NB + k] = ((-s.fxb[k] * c.dx) * c.dy) / c.coef;
      cl_out[t * NB + k] = ((-s.fyb[k] * c.dx) * c.dy) / c.coef;
    }
  }
}

// -- C: divergence rhs into the two rhs planes (a dead slot 0).  The
//    outlet column of u_bc is u_pen's column -2 plus the mass correction --
template <bool kOdd>
__device__ __forceinline__ float divergence_at(const float* usr,
                                               const float* vs0,
                                               const float* vs1, int i,
                                               float corr, const Consts& c,
                                               int nx) {
  if (kOdd && i >= nx) return 0.0f;
  const float u1 = i + 1 == nx ? usr[nx - 1] + corr : usr[i + 1];
  return ((u1 - usr[i]) * c.inv_dx + (vs1[i] - vs0[i]) * c.inv_dy) *
         c.inv_dt;
}

template <bool kOdd>
__device__ __forceinline__ void divergence_rhs(const Band& b, float corr,
                                               const Consts& c,
                                               const Lanes& l, int nx) {
  const int w = packed_w<kOdd>(nx);
  for (int lj = l.ty; lj < b.nrows; lj += l.TY) {
    const int j = b.j0 + lj;
    const float* usr = b.us + lj * nx;
    const float* vs0 = b.vs + lj * nx;
    const float* vs1 = vs0 + nx;
    for (int k = l.tx; k < w; k += l.TX) {
      b.rhs_r[lj * w + k] =
          divergence_at<kOdd>(usr, vs0, vs1, 2 * k + (j & 1), corr, c, nx);
      b.rhs_b[lj * w + k] =
          divergence_at<kOdd>(usr, vs0, vs1, 2 * k + 1 - (j & 1), corr, c,
                              nx);
    }
  }
}

// -- E: velocity correction and the BCs of _correct; the wall ghost rows
//    and the neighbours' halo rows follow the stores ---------------------
template <bool kOdd>
__device__ __forceinline__ void correct(const Band& b, const Mirror& h,
                                        const Consts& c, const Lanes& l,
                                        int ny, int nx) {
  const int nxu = nx + 1, w = packed_w<kOdd>(nx);
  for (int lj = l.ty; lj < b.nrows; lj += l.TY) {
    const int j = b.j0 + lj;
    const float* usr = b.us + lj * nx;
    const float* pr = b.red + (lj + 1) * w;
    const float* pb = b.black + (lj + 1) * w;
    float* urow = b.u + (lj + 1) * nxu;
    for (int i = l.tx; i < nx; i += l.TX) {
      float val = usr[i];
      if (i >= 1) {
        const float p1 = ((i + j) & 1) == 0 ? pr[i >> 1] : pb[i >> 1];
        const float p0 = ((i - 1 + j) & 1) == 0 ? pr[(i - 1) >> 1]
                                                : pb[(i - 1) >> 1];
        val = val + (-c.dt * (p1 - p0)) * c.inv_dx;
      }
      put(urow, h.u_prev, h.u_next, lj, b.nrows, i, val);
      if (i == nx - 1) put(urow, h.u_prev, h.u_next, lj, b.nrows, nx, val);
      if (b.first && lj == 0) {
        urow[i - nxu] = -val;
        if (i == nx - 1) urow[nx - nxu] = -val;
      }
      if (b.last && lj == b.nrows - 1) {
        urow[i + nxu] = -val;
        if (i == nx - 1) urow[nx + nxu] = -val;
      }
    }
  }
  for (int lj = l.ty; lj < b.nv_rows; lj += l.TY) {
    const int j = b.j0 + lj;
    const bool zero_row = j == 0 || j == ny;
    const float* vsr = b.vs + lj * nx;
    const float* pr = b.red + (lj + 1) * w;
    const float* pb = b.black + (lj + 1) * w;
    float* vrow = b.v + (lj + 1) * nx;
    for (int i = l.tx; i < nx - 1; i += l.TX) {
      float val = 0.0f;
      if (!(i == 0 || zero_row)) {
        const float p1 = ((i + j) & 1) == 0 ? pr[i >> 1] : pb[i >> 1];
        const float p0 = ((i + j - 1) & 1) == 0 ? pr[(i >> 1) - w]
                                                : pb[(i >> 1) - w];
        val = vsr[i] + (-c.dt * (p1 - p0)) * c.inv_dy;
      }
      put(vrow, h.v_prev, h.v_next, lj, b.nrows, i, val);
      if (i == nx - 2) put(vrow, h.v_prev, h.v_next, lj, b.nrows, nx - 1, val);
      if (b.first && lj == 0) {  // ghost row j = -1 of _pad_v: 0 * v[0]
        vrow[i - nx] = val * 0.0f;
        if (i == nx - 2) vrow[nx - 1 - nx] = val * 0.0f;
      }
      if (b.last && lj == b.nrows) {  // ghost row j = ny + 1: 0 * v[ny]
        vrow[i + nx] = val * 0.0f;
        if (i == nx - 2) vrow[nx - 1 + nx] = val * 0.0f;
      }
    }
  }
}

// Write the band's own rows back to the env's outputs (no dead slot).
template <bool kOdd>
__device__ __forceinline__ void write_band(const Band& b, float* u_out,
                                           float* v_out, float* p_out,
                                           const Lanes& l, int nx) {
  const int nxu = nx + 1, w = packed_w<kOdd>(nx);
  for (int lj = l.ty; lj < b.nrows; lj += l.TY) {
    const int j = b.j0 + lj;
    for (int i = l.tx; i < nxu; i += l.TX)
      u_out[static_cast<size_t>(j) * nxu + i] = b.u[(lj + 1) * nxu + i];
    for (int k = l.tx; k < w; k += l.TX) {
      const int ir = 2 * k + (j & 1), ib = 2 * k + 1 - (j & 1);
      if (!kOdd || ir < nx)
        p_out[static_cast<size_t>(j) * nx + ir] = b.red[(lj + 1) * w + k];
      if (!kOdd || ib < nx)
        p_out[static_cast<size_t>(j) * nx + ib] = b.black[(lj + 1) * w + k];
    }
  }
  for (int lj = l.ty; lj < b.nv_rows; lj += l.TY) {
    const int j = b.j0 + lj;
    for (int i = l.tx; i < nx; i += l.TX)
      v_out[static_cast<size_t>(j) * nx + i] = b.v[(lj + 1) * nx + i];
  }
}

// Offset the env's inputs and outputs to env `env`.
template <int NB>
struct EnvIO {
  const float *u_in, *v_in, *p_in;
  float *u_out, *v_out, *p_out, *cd_out, *cl_out;

  __device__ EnvIO(const float* u_i, const float* v_i, const float* p_i,
                   float* u_o, float* v_o, float* p_o, float* cd, float* cl,
                   int env, int ny, int nx, int n_steps) {
    const size_t nu = static_cast<size_t>(ny) * (nx + 1);
    const size_t nv = static_cast<size_t>(ny + 1) * nx;
    const size_t np = static_cast<size_t>(ny) * nx;
    u_in = u_i + env * nu;
    u_out = u_o + env * nu;
    v_in = v_i + env * nv;
    v_out = v_o + env * nv;
    p_in = p_i + env * np;
    p_out = p_o + env * np;
    // (n_env, n_steps), or (n_env, n_steps, NB)
    const size_t per = static_cast<size_t>(n_steps) * (NB > 0 ? NB : 1);
    cd_out = cd + env * per;
    cl_out = cl + env * per;
  }
};

// The inlet's volume flux, summed by every block in the same order: the
// first `nt` threads (the whole block but in the resident kernel) step
// over the rows, the others add zeros.
template <int NB>
__device__ __forceinline__ float inlet_flux(const GeomOf<NB>& g, int ny,
                                            const Consts& c, float* scratch,
                                            int nt) {
  float s_in = 0.0f, unused_b = 0.0f, unused_c = 0.0f;
  if (static_cast<int>(threadIdx.x) < nt)
    for (int j = threadIdx.x; j < ny; j += nt) s_in += g.inlet_u[j];
  block_sum3(s_in, unused_b, unused_c, scratch);
  return s_in * c.dy;
}

// One coloured half-sweep of the packed SOR over the band (sor_packed.cuh,
// the domain BCs live), under the odd width's row rule where kOdd.
template <bool kOdd>
__device__ __forceinline__ void sor_half_sweep(
    float* a, const float* o, const float* rhs, const Link& link,
    unsigned long long* halo, unsigned parity, int nrows, int j0, int ny,
    int w, int shift_parity, const Lanes& l, const Consts& c, float om,
    float one_m_om) {
  band_half_sweep<false, kOdd>(a, o, rhs, nullptr, nullptr, link, halo,
                               parity, nrows, j0, ny, w, shift_parity, l.tx,
                               l.ty, l.TX, l.TY, c.inv_dx2, c.inv_dy2,
                               c.inv_diag, om, one_m_om);
}

// kOdd: the grid's width is odd (its planes' dead slots, sor_packed.cuh)
template <int NB, bool kOdd>
__global__ void __launch_bounds__(1024, 1) fused_interval_kernel(
    const float* __restrict__ u_in, const float* __restrict__ v_in,
    const float* __restrict__ p_in, GeomOf<NB> g,
    const float* __restrict__ jet_vel, const float* __restrict__ re_arr,
    const float* __restrict__ mode_arr, float* __restrict__ u_out,
    float* __restrict__ v_out, float* __restrict__ p_out,
    float* __restrict__ cd_out, float* __restrict__ cl_out,
    int* __restrict__ block_sm, int ny, int nx, int n_steps, int iters,
    int n_polish, int rows_max, int tx_dim, Bands bands, Consts c) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int env = blockIdx.x / C;
  const int tid = threadIdx.x;
  Lanes l;
  l.TX = tx_dim;
  l.TY = blockDim.x / l.TX;
  l.ty = tid / l.TX;
  l.tx = tid - l.ty * l.TX;
  const int lane = tid & 31;

  const int w = packed_w<kOdd>(nx);
  const int nxu = nx + 1;
  const int R = rows_max;
  Band b;
  b.j0 = bands.start[rank];
  b.nrows = bands.start[rank + 1] - b.j0;
  b.first = rank == 0;
  b.last = rank == C - 1;
  b.nv_rows = b.nrows + (b.last ? 1 : 0);  // + the top wall row ny
  const int j0 = b.j0, nrows = b.nrows;
  const bool first = b.first, last = b.last;
  if (tid == 0) block_sm[blockIdx.x] = sm_id();  // the launch's record

  // shared-memory layout (kernels/actuation/ops.py smem_bytes): stored row
  // s of a field with a halo above is local row s - 1
  // 2 mbarriers (red, black halo rows received), then the fields
  unsigned long long* mbar = reinterpret_cast<unsigned long long*>(smem);
  b.u = smem + 4;                        // (R + 2) x nxu, local rows -1..R
  b.v = b.u + (R + 2) * nxu;             // (R + 3) x nx, local rows -1..R+1
  b.us = b.v + (R + 3) * nx;             // R x nx: u_pen with the inlet BC
  b.vs = b.us + R * nx;                  // (R + 1) x nx: v_pen with its BCs
  b.red = b.vs + (R + 1) * nx;           // (R + 2) x w, local rows -1..R
  b.black = b.red + (R + 2) * w;
  b.rhs_r = b.black + (R + 2) * w;       // R x w
  b.rhs_b = b.rhs_r + R * w;
  // this block's fx, fy, outflux (NB > 0: fx and fy per body), then the
  // reduction's scratch: 128 floats for block_sum3, 33 (2 NB + 1) for
  // block_sum
  float* part = b.rhs_b + R * w;
  float* scratch = part + kPartSlots<NB>;

  // the neighbours' halo rows (nullptr at the domain's walls)
  const int nrows_prev = first ? 0 : j0 - bands.start[rank - 1];
  Mirror h{nullptr, nullptr, nullptr, nullptr, nullptr};
  Link red_link{0u, 0u, 0u, 0u}, black_link{0u, 0u, 0u, 0u};
  if (!first) {
    h.u_prev = cluster.map_shared_rank(b.u, rank - 1) + (nrows_prev + 1) * nxu;
    h.v_prev = cluster.map_shared_rank(b.v, rank - 1) + (nrows_prev + 1) * nx;
    h.vs_prev = cluster.map_shared_rank(b.vs, rank - 1) + nrows_prev * nx;
    red_link.prev = cluster_addr(b.red + (nrows_prev + 1) * w, rank - 1);
    red_link.prev_bar = cluster_addr(&mbar[0], rank - 1);
    black_link.prev = cluster_addr(b.black + (nrows_prev + 1) * w, rank - 1);
    black_link.prev_bar = cluster_addr(&mbar[1], rank - 1);
  }
  if (!last) {
    h.u_next = cluster.map_shared_rank(b.u, rank + 1);
    h.v_next = cluster.map_shared_rank(b.v, rank + 1);
    red_link.next = cluster_addr(b.red, rank + 1);
    red_link.next_bar = cluster_addr(&mbar[0], rank + 1);
    black_link.next = cluster_addr(b.black, rank + 1);
    black_link.next_bar = cluster_addr(&mbar[1], rank + 1);
  }
  // halo bytes a colour's phase waits for: a row from each neighbour
  const bool linked = C > 1;
  const int halo_bytes = 4 * w * ((first ? 0 : 1) + (last ? 0 : 1));
  unsigned red_parity = 0, black_parity = 0;
  if (linked && tid == 0) {
    mbar_init(&mbar[0]);
    mbar_init(&mbar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(&mbar[0], halo_bytes);
    mbar_expect(&mbar[1], halo_bytes);
  }
  // lane r < C of every warp reads rank r's partial sums
  const float* part_of_lane =
      cluster.map_shared_rank(part, lane < C ? lane : 0);

  const size_t nu = static_cast<size_t>(ny) * nxu;
  const size_t nv = static_cast<size_t>(ny + 1) * nx;
  env_geometry<NB>(g, env, nu, nv, ny);
  const EnvIO<NB> io(u_in, v_in, p_in, u_out, v_out, p_out, cd_out, cl_out,
                     env, ny, nx, n_steps);
  const Actuation<NB> act = env_actuation<NB>(jet_vel, re_arr, mode_arr, env);
  const int n_sor = iters - n_polish;

  // -- load the band with its halo rows --------------------------------
  load_rows<kOdd>(b, io.u_in, io.v_in, io.p_in, l, ny, nx, -1, nrows,
                  nrows + 1);
  const float influx = inlet_flux<NB>(g, ny, c, scratch, blockDim.x);
  // every block of the cluster has started, holds its band and has its
  // mbarriers set before any block stores into another's shared memory
  cluster_barrier();

  for (int t = 0; t < n_steps; ++t) {
    // -- A -------------------------------------------------------------
    Sums<NB> s;
    predictor<NB>(b, h, g, act, c, l, ny, nx, s);
    publish_partials<NB>(s, part, scratch);
    cluster_barrier();  // partials, u_pen / v_pen and the vs halo complete

    // the cluster's sums, in one fixed order on every warp of every block
    gather_sums<NB>(part_of_lane, C, lane, s);
    const float corr = (influx - s.out * c.dy) / c.ny_dy;
    if (first && tid == 0) write_coefficients<NB>(io.cd_out, io.cl_out, t, s, c);

    // -- C -------------------------------------------------------------
    divergence_rhs<kOdd>(b, corr, c, l, nx);

    __syncthreads();

    // -- D: packed SOR, warm-started from the previous dt's planes.  A
    //    half-sweep's edge rows first wait for the other colour's halo
    //    rows of the half-sweep before (the first red one of a dt reads
    //    black halo rows E already waited for); that colour's mbarrier is
    //    re-armed once the half-sweep's block barrier is passed ------------
    for (int it = 0; it < iters; ++it) {
      const bool sor = it < n_sor;
      const float om = sor ? c.omega : 1.0f;
      const float one_m_om = sor ? c.one_m_omega : 0.0f;
      const bool wait_black = linked && it > 0;
      sor_half_sweep<kOdd>(b.red, b.black, b.rhs_r, red_link,
                           wait_black ? &mbar[1] : nullptr, black_parity,
                           nrows, j0, ny, w, 1, l, c, om, one_m_om);
      if (wait_black) {
        black_parity ^= 1u;
        if (tid == 0) mbar_expect(&mbar[1], halo_bytes);
      }
      sor_half_sweep<kOdd>(b.black, b.red, b.rhs_b, black_link,
                           linked ? &mbar[0] : nullptr, red_parity, nrows,
                           j0, ny, w, 0, l, c, om, one_m_om);
      if (linked) {
        red_parity ^= 1u;
        if (tid == 0) mbar_expect(&mbar[0], halo_bytes);
      }
    }
    // E reads the black halo rows of the last half-sweep
    const bool wait_last = linked && iters > 0;
    if (wait_last) {
      mbar_wait(&mbar[1], black_parity);
      black_parity ^= 1u;
    }

    // -- E -------------------------------------------------------------
    correct<kOdd>(b, h, c, l, ny, nx);
    cluster_barrier();  // u, v and their halo and ghost rows complete
    if (wait_last && tid == 0) mbar_expect(&mbar[1], halo_bytes);
  }

  // -- write the band back ---------------------------------------------
  write_band<kOdd>(b, io.u_out, io.v_out, io.p_out, l, nx);
}

// -- the global-memory kernel: the grids no cluster holds -------------------
//
// One group of G <= kMaxGroup blocks per env (G chosen by the wrapper,
// kernels/cluster.py global_group).  Each env's fields live in a workspace
// in global memory, laid out as one band of all ny rows (ws_floats below):
// rank r's band is the window of rows [r ny / G, (r + 1) ny / G), and the
// rows above and below it are its neighbours' own, read where they lie
// (L2 holds an env's fields: ~7 MB at res 48).  The phases of a dt are the
// cluster kernel's, the same functions on the same band view; what orders
// them is grid_sync.cuh's flags: a group barrier after the predictor (the
// force sums need every block's partials) and after the correction (the
// next predictor reads the neighbours' u and v rows), and before each SOR
// half-sweep and before the correction a wait on the two neighbours only.
// The partial sums go to the workspace and every block adds the G of them
// in the cluster kernel's order, so G orders the sums as the cluster size
// does, and two launches on one input are bitwise identical.

// floats of one env's fields in the workspace: u (ny + 2) x (nx + 1), v
// (ny + 3) x nx, u_pen ny x nx, v_pen (ny + 1) x nx, red and black
// (ny + 2) x w, rhs_r and rhs_b ny x w, w = packed_width(nx)
// (kernels/actuation/ops.py workspace_bytes)
__host__ __device__ inline size_t ws_floats(int ny, int nx) {
  const size_t w = packed_width(nx), nxu = nx + 1;
  return (ny + 2) * nxu + (ny + 3) * static_cast<size_t>(nx)
         + static_cast<size_t>(ny) * nx + (ny + 1) * static_cast<size_t>(nx)
         + 2 * (ny + 2) * w + 2 * static_cast<size_t>(ny) * w;
}

// the reduction's scratch of the global-memory kernel, in static shared
// memory: block_sum3's 100 floats, block_sum's 33 (2 NB + 1)
template <int NB>
constexpr int kScratchFloats = NB == 0 ? 128 : (33 * (2 * NB + 1) + 3) / 4 * 4;

template <int NB, bool kOdd>
__global__ void __launch_bounds__(1024, 1) fused_interval_global_kernel(
    const float* __restrict__ u_in, const float* __restrict__ v_in,
    const float* __restrict__ p_in, GeomOf<NB> g,
    const float* __restrict__ jet_vel, const float* __restrict__ re_arr,
    const float* __restrict__ mode_arr, float* __restrict__ u_out,
    float* __restrict__ v_out, float* __restrict__ p_out,
    float* __restrict__ cd_out, float* __restrict__ cl_out,
    int* __restrict__ block_sm, float* ws, int env0, int n_env, int ny,
    int nx, int n_steps, int iters, int n_polish, int tx_dim, Consts c) {
  __shared__ float scratch[kScratchFloats<NB>];
  const int G = static_cast<int>(gridDim.x) / n_env;
  const int local = blockIdx.x / G;  // the env within this launch
  const int rank = blockIdx.x - local * G;
  const int env = env0 + local;
  const int tid = threadIdx.x;
  Lanes l;
  l.TX = tx_dim;
  l.TY = blockDim.x / l.TX;
  l.ty = tid / l.TX;
  l.tx = tid - l.ty * l.TX;
  const int lane = tid & 31;
  if (tid == 0) block_sm[blockIdx.x] = sm_id();  // the launch's record

  const int w = packed_w<kOdd>(nx);
  const int nxu = nx + 1;
  // the env's fields, then every env's partial sums, then the flags
  float* f = ws + local * ws_floats(ny, nx);
  float* parts = ws + n_env * ws_floats(ny, nx);
  unsigned* flags = reinterpret_cast<unsigned*>(
      parts + static_cast<size_t>(n_env) * G * kPartSlots<NB>) +
      static_cast<size_t>(local) * G * kFlagStride;
  unsigned* my_flag = flags + rank * kFlagStride;
  Band b;
  b.j0 = band_start(rank, ny, G);
  b.nrows = band_start(rank + 1, ny, G) - b.j0;
  b.first = rank == 0;
  b.last = rank == G - 1;
  b.nv_rows = b.nrows + (b.last ? 1 : 0);
  float* u = f;
  float* v = u + (ny + 2) * nxu;
  float* us = v + (ny + 3) * nx;
  float* vs = us + ny * nx;
  float* red = vs + (ny + 1) * nx;
  float* black = red + (ny + 2) * w;
  float* rhs_r = black + (ny + 2) * w;
  float* rhs_b = rhs_r + ny * w;
  b.u = u + b.j0 * nxu;
  b.v = v + b.j0 * nx;
  b.us = us + b.j0 * nx;
  b.vs = vs + b.j0 * nx;
  b.red = red + b.j0 * w;
  b.black = black + b.j0 * w;
  b.rhs_r = rhs_r + b.j0 * w;
  b.rhs_b = rhs_b + b.j0 * w;
  const Mirror h{nullptr, nullptr, nullptr, nullptr, nullptr};
  const Link none{0u, 0u, 0u, 0u};
  float* part = parts + (static_cast<size_t>(local) * G + rank) * kPartSlots<NB>;
  const float* part_of_lane =
      parts + (static_cast<size_t>(local) * G + (lane < G ? lane : 0)) *
                  kPartSlots<NB>;

  const size_t nu = static_cast<size_t>(ny) * nxu;
  const size_t nv = static_cast<size_t>(ny + 1) * nx;
  env_geometry<NB>(g, env, nu, nv, ny);
  const EnvIO<NB> io(u_in, v_in, p_in, u_out, v_out, p_out, cd_out, cl_out,
                     env, ny, nx, n_steps);
  const Actuation<NB> act = env_actuation<NB>(jet_vel, re_arr, mode_arr, env);
  const int n_sor = iters - n_polish;

  // -- load the band's own rows, and the wall ghost rows at its ends -----
  load_rows<kOdd>(b, io.u_in, io.v_in, io.p_in, l, ny, nx,
                  b.first ? -1 : 0, b.nrows - 1 + (b.last ? 1 : 0),
                  b.nrows - 1 + (b.last ? 2 : 0));
  const float influx = inlet_flux<NB>(g, ny, c, scratch, blockDim.x);
  unsigned gen = 0;
  group_barrier(flags, rank, G, gen);  // every row loaded

  for (int t = 0; t < n_steps; ++t) {
    Sums<NB> s;
    predictor<NB>(b, h, g, act, c, l, ny, nx, s);
    publish_partials<NB>(s, part, scratch);
    group_barrier(flags, rank, G, gen);  // partials, u_pen and v_pen

    gather_sums<NB>(part_of_lane, G, lane, s);
    const float corr = (influx - s.out * c.dy) / c.ny_dy;
    if (b.first && tid == 0)
      write_coefficients<NB>(io.cd_out, io.cl_out, t, s, c);

    divergence_rhs<kOdd>(b, corr, c, l, nx);
    __syncthreads();

    // the first red half-sweep of a dt reads black rows the group barrier
    // after the last correction ordered
    for (int it = 0; it < iters; ++it) {
      const bool sor = it < n_sor;
      const float om = sor ? c.omega : 1.0f;
      const float one_m_om = sor ? c.one_m_omega : 0.0f;
      if (it > 0) wait_neighbours(flags, rank, G, gen);
      sor_half_sweep<kOdd>(b.red, b.black, b.rhs_r, none, nullptr, 0u,
                           b.nrows, b.j0, ny, w, 1, l, c, om, one_m_om);
      arrive(my_flag, ++gen);
      wait_neighbours(flags, rank, G, gen);
      sor_half_sweep<kOdd>(b.black, b.red, b.rhs_b, none, nullptr, 0u,
                           b.nrows, b.j0, ny, w, 0, l, c, om, one_m_om);
      arrive(my_flag, ++gen);
    }
    // the correction of v reads the planes' row above the band
    wait_neighbours(flags, rank, G, gen);
    correct<kOdd>(b, h, c, l, ny, nx);
    group_barrier(flags, rank, G, gen);  // u, v and their ghost rows
  }

  write_band<kOdd>(b, io.u_out, io.v_out, io.p_out, l, nx);
}

// -- the resident kernel: bands in shared memory over several clusters ----
//
// One group of G = K C blocks per env, K >= 2 clusters of C blocks (G 24
// or 32, C 16, 8, 4 or 2, chosen by the wrapper for the fewest launches,
// then the largest C: kernels/cluster.py resident_plan), for
// the grids whose band fits one block at some G <= kMaxGroup but at no
// cluster of up to 16 blocks (res 39 to 52 at the default aspect).  Rank r
// of the group holds rows [r ny / G, (r + 1) ny / G) of every field in its
// shared memory, in the cluster kernel's band layout, for the whole
// interval, and runs the cluster kernel's phases on it.  Inside a cluster
// the halo rows travel as in fused_interval_kernel; at a cluster edge
// (resident.cuh) the v_pen row after the predictor and the u and v rows
// after the correction go to the edge's mirror slots through the same
// Mirror pointers the DSMEM rows take (global ones there), and the SOR
// edge rows are sent as tagged words after each half-sweep and received
// before the next one that reads them.  The group barrier after the
// predictor and after the correction is a cluster barrier, then one flag
// a cluster.  The partial sums go to the workspace and every block adds
// the G of them in the global-memory kernel's order; each block sums its
// own partials in the global-memory kernel's thread layout (`pred_tx`
// lanes a row, `pred_threads` threads; the other phases take the block's
// thread rows side by side, `tx_dim` lanes a row), and each point's
// arithmetic is the cluster kernel's, so the resident kernel at G gives
// the bits of fused_interval_global_kernel at G.  The workspace holds only
// the partial sums, the flags and the mirror slots.
template <int NB, bool kOdd>
__global__ void __launch_bounds__(1024, 1) fused_interval_resident_kernel(
    const float* __restrict__ u_in, const float* __restrict__ v_in,
    const float* __restrict__ p_in, GeomOf<NB> g,
    const float* __restrict__ jet_vel, const float* __restrict__ re_arr,
    const float* __restrict__ mode_arr, float* __restrict__ u_out,
    float* __restrict__ v_out, float* __restrict__ p_out,
    float* __restrict__ cd_out, float* __restrict__ cl_out,
    int* __restrict__ block_sm, float* ws, int env0, int n_env, int ny,
    int nx, int n_steps, int iters, int n_polish, int rows_max, int tx_dim,
    int pred_tx, int pred_threads, Consts c) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int crank = static_cast<int>(cluster.block_rank());
  const int G = static_cast<int>(gridDim.x) / n_env;
  const int K = G / C;
  const int local = blockIdx.x / G;  // the env within this launch
  const int rank = blockIdx.x - local * G;
  const int env = env0 + local;
  const int tid = threadIdx.x;
  Lanes l;
  l.TX = tx_dim;
  l.TY = blockDim.x / l.TX;
  l.ty = tid / l.TX;
  l.tx = tid - l.ty * l.TX;
  // the predictor's layout, the global-memory kernel's: threads past it
  // stand on rows past every band and add zeros to the partial sums
  Lanes lp;
  lp.TX = pred_tx;
  lp.TY = pred_threads / pred_tx;
  lp.ty = tid < pred_threads ? tid / lp.TX : rows_max + 2;
  lp.tx = tid < pred_threads ? tid - lp.ty * lp.TX : 0;
  const int lane = tid & 31;
  if (tid == 0) block_sm[blockIdx.x] = sm_id();  // the launch's record

  const int w = packed_w<kOdd>(nx);
  const int nxu = nx + 1;
  const int R = rows_max;
  Band b;
  b.j0 = band_start(rank, ny, G);
  b.nrows = band_start(rank + 1, ny, G) - b.j0;
  b.first = rank == 0;
  b.last = rank == G - 1;
  b.nv_rows = b.nrows + (b.last ? 1 : 0);
  const int nrows = b.nrows;

  // shared memory: the cluster kernel's layout (ops.smem_bytes)
  unsigned long long* mbar = reinterpret_cast<unsigned long long*>(smem);
  b.u = smem + 4;
  b.v = b.u + (R + 2) * nxu;
  b.us = b.v + (R + 3) * nx;
  b.vs = b.us + R * nx;
  b.red = b.vs + (R + 1) * nx;
  b.black = b.red + (R + 2) * w;
  b.rhs_r = b.black + (R + 2) * w;
  b.rhs_b = b.rhs_r + R * w;
  float* scratch = b.rhs_b + R * w + kPartSlots<NB>;

  // the workspace: every env's partial sums, then the flags, then the
  // mirror slots (ops.workspace_bytes)
  float* parts = ws;
  unsigned* all_flags = reinterpret_cast<unsigned*>(
      parts + static_cast<size_t>(n_env) * G * kPartSlots<NB>);
  unsigned* flags = all_flags + static_cast<size_t>(local) * G * kFlagStride;
  float* mirrors = reinterpret_cast<float*>(
      all_flags + static_cast<size_t>(n_env) * G * kFlagStride) +
      local * mirror_floats(K, kFusedEdgeSlots, nxu);
  const Edge e = cluster_edge(mirrors, rank, C, K, kFusedEdgeSlots, nxu);
  float* part = parts + (static_cast<size_t>(local) * G + rank) * kPartSlots<NB>;
  const float* part_of_lane =
      parts + (static_cast<size_t>(local) * G + (lane < G ? lane : 0)) *
                  kPartSlots<NB>;

  // the neighbours' halo rows: DSMEM inside the cluster, the edge's mirror
  // slots across it (nullptr at the domain's walls)
  const bool prev_in = !b.first && crank > 0, next_in = !b.last && crank < C - 1;
  const int nrows_prev = b.first ? 0 : b.j0 - band_start(rank - 1, ny, G);
  Mirror h{nullptr, nullptr, nullptr, nullptr, nullptr};
  Link red_link{0u, 0u, 0u, 0u}, black_link{0u, 0u, 0u, 0u};
  if (prev_in) {
    h.u_prev = cluster.map_shared_rank(b.u, crank - 1) + (nrows_prev + 1) * nxu;
    h.v_prev = cluster.map_shared_rank(b.v, crank - 1) + (nrows_prev + 1) * nx;
    h.vs_prev = cluster.map_shared_rank(b.vs, crank - 1) + nrows_prev * nx;
    red_link.prev = cluster_addr(b.red + (nrows_prev + 1) * w, crank - 1);
    red_link.prev_bar = cluster_addr(&mbar[0], crank - 1);
    black_link.prev = cluster_addr(b.black + (nrows_prev + 1) * w, crank - 1);
    black_link.prev_bar = cluster_addr(&mbar[1], crank - 1);
  } else if (e.above) {
    h.u_prev = e.send_plain(kEdgeU);
    h.v_prev = e.send_plain(kEdgeV);
    h.vs_prev = e.send_plain(kEdgeVs);
  }
  if (next_in) {
    h.u_next = cluster.map_shared_rank(b.u, crank + 1);
    h.v_next = cluster.map_shared_rank(b.v, crank + 1);
    red_link.next = cluster_addr(b.red, crank + 1);
    red_link.next_bar = cluster_addr(&mbar[0], crank + 1);
    black_link.next = cluster_addr(b.black, crank + 1);
    black_link.next_bar = cluster_addr(&mbar[1], crank + 1);
  } else if (e.rank >= 0) {
    h.u_next = e.send_plain(kEdgeU);
    h.v_next = e.send_plain(kEdgeV);
  }
  // a cross-cluster edge's rows of each plane: this block's edge row and
  // its halo row on that side (stored rows)
  const bool cross = e.rank >= 0;
  const int edge_row = e.above ? 1 : nrows;
  const int halo_row = e.above ? 0 : nrows + 1;
  // halo bytes a colour's phase waits for: a row from each neighbour in
  // this cluster
  const int halo_bytes = 4 * w * ((prev_in ? 1 : 0) + (next_in ? 1 : 0));
  unsigned red_parity = 0, black_parity = 0;
  if (tid == 0) {
    mbar_init(&mbar[0]);
    mbar_init(&mbar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(&mbar[0], halo_bytes);
    mbar_expect(&mbar[1], halo_bytes);
  }

  const size_t nu = static_cast<size_t>(ny) * nxu;
  const size_t nv = static_cast<size_t>(ny + 1) * nx;
  env_geometry<NB>(g, env, nu, nv, ny);
  const EnvIO<NB> io(u_in, v_in, p_in, u_out, v_out, p_out, cd_out, cl_out,
                     env, ny, nx, n_steps);
  const Actuation<NB> act = env_actuation<NB>(jet_vel, re_arr, mode_arr, env);
  const int n_sor = iters - n_polish;

  // -- load the band with its halo rows --------------------------------
  load_rows<kOdd>(b, io.u_in, io.v_in, io.p_in, l, ny, nx, -1, nrows,
                  nrows + 1);
  const float influx = inlet_flux<NB>(g, ny, c, scratch, pred_threads);
  // every block of the cluster has started, holds its band and has its
  // mbarriers set before any block stores into another's shared memory
  cluster_barrier();
  unsigned gen = 0;

  for (int t = 0; t < n_steps; ++t) {
    Sums<NB> s;
    predictor<NB>(b, h, g, act, c, lp, ny, nx, s);
    publish_partials<NB>(s, part, scratch);
    resident_barrier(flags, rank, C, K, ++gen);  // partials, u_pen, v_pen
    if (cross && !e.above) {  // v_pen's halo row below, from the mirror
      fetch_row(b.vs + nrows * nx, e.recv_plain(kEdgeVs), nx);
      __syncthreads();
    }

    gather_sums<NB>(part_of_lane, G, lane, s);
    const float corr = (influx - s.out * c.dy) / c.ny_dy;
    if (b.first && tid == 0)
      write_coefficients<NB>(io.cd_out, io.cl_out, t, s, c);

    divergence_rhs<kOdd>(b, corr, c, l, nx);
    __syncthreads();

    // -- D: as the cluster kernel's, each half-sweep at a cross-cluster
    //    edge first receiving the other colour's row of the half-sweep
    //    before and then sending its own edge row ---------------------
    for (int it = 0; it < iters; ++it) {
      const bool sor = it < n_sor;
      const float om = sor ? c.omega : 1.0f;
      const float one_m_om = sor ? c.one_m_omega : 0.0f;
      const int par = it & 1;
      const bool wait_black = it > 0;
      if (cross && wait_black)
        receive_tagged(e.recv_sor(kBlack0 + 1 - par), b.black + halo_row * w,
                       w, gen);
      sor_half_sweep<kOdd>(b.red, b.black, b.rhs_r, red_link,
                           wait_black ? &mbar[1] : nullptr, black_parity,
                           nrows, b.j0, ny, w, 1, l, c, om, one_m_om);
      if (wait_black) {
        black_parity ^= 1u;
        if (tid == 0) mbar_expect(&mbar[1], halo_bytes);
      }
      ++gen;
      if (cross) {
        send_tagged(e.send_sor(kRed0 + par), b.red + edge_row * w, w, gen);
        receive_tagged(e.recv_sor(kRed0 + par), b.red + halo_row * w, w, gen);
      }
      sor_half_sweep<kOdd>(b.black, b.red, b.rhs_b, black_link, &mbar[0],
                           red_parity, nrows, b.j0, ny, w, 0, l, c, om,
                           one_m_om);
      red_parity ^= 1u;
      if (tid == 0) mbar_expect(&mbar[0], halo_bytes);
      ++gen;
      if (cross)
        send_tagged(e.send_sor(kBlack0 + par), b.black + edge_row * w, w, gen);
    }
    // E reads the black halo rows of the last half-sweep
    const bool wait_last = iters > 0;
    if (wait_last) {
      mbar_wait(&mbar[1], black_parity);
      black_parity ^= 1u;
      if (cross)
        receive_tagged(e.recv_sor(kBlack0 + ((iters - 1) & 1)),
                       b.black + halo_row * w, w, gen);
    }

    // -- E -------------------------------------------------------------
    correct<kOdd>(b, h, c, l, ny, nx);
    resident_barrier(flags, rank, C, K, ++gen);  // u, v, their halo rows
    if (wait_last && tid == 0) mbar_expect(&mbar[1], halo_bytes);
    if (cross) {  // u and v's halo rows on the edge's side, from the mirror
      fetch_row(b.u + halo_row * nxu, e.recv_plain(kEdgeU), nxu);
      fetch_row(b.v + halo_row * nx, e.recv_plain(kEdgeV), nx);
      __syncthreads();
    }
  }

  write_band<kOdd>(b, io.u_out, io.v_out, io.p_out, l, nx);
}

// The per-body instantiation's body count: grid.max_bodies(), the widest
// geometry (the pinball); a bank of fewer bodies is zero-padded to it
constexpr int kBodies = 3;

// The occupancy queries below read the even width's instantiations.  An
// odd width's (kOdd) launch at the same shape: the same threads, the same
// dynamic and static shared memory, and registers capped, as the even
// ones', at 64 a thread by __launch_bounds__(1024, 1) (ptxas gives every
// even instantiation 64), so the card holds no fewer of them at once.

// How many clusters of `cluster` blocks (`threads` threads, `smem` bytes
// of dynamic shared memory each) the card holds at once, into *out, for
// the scalar and the per-body instantiation.  Returns the CUDA error code
// (0 = success).
extern "C" int fused_interval_max_clusters(int cluster, int threads, int smem,
                                           int* out) {
  return static_cast<int>(max_active_clusters(
      fused_interval_kernel<0, false>, cluster, threads, smem, out));
}

extern "C" int fused_interval_bodies_max_clusters(int cluster, int threads,
                                                  int smem, int* out) {
  return static_cast<int>(max_active_clusters(
      fused_interval_kernel<kBodies, false>, cluster, threads, smem, out));
}

// The per-body count the library was built for (the wrapper checks it).
extern "C" int fused_interval_bodies() { return kBodies; }

template <int NB>
static cudaError_t launch(const GeomOf<NB>& g, const float* u_in,
                          const float* v_in, const float* p_in,
                          const float* jet_vel, const float* re,
                          const float* act_mode, float* u_out, float* v_out,
                          float* p_out, float* cd, float* cl, int* block_sm,
                          int n_env, int ny, int nx, int n_steps, int iters,
                          int n_polish, int cluster, int rows_max,
                          int threads, int tx_dim, int smem,
                          const Bands& bands, const Consts& c,
                          cudaStream_t stream) {
  const auto kernel = nx & 1 ? fused_interval_kernel<NB, true>
                             : fused_interval_kernel<NB, false>;
  cudaError_t err = set_cluster_attributes(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  fill_cluster_config(cfg, attr, n_env, cluster, threads, smem, stream);
  // -1 where no block wrote its SM: the record counts the blocks that ran
  err = cudaMemsetAsync(block_sm, 0xff, sizeof(int) * n_env * cluster,
                        stream);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, u_in, v_in, p_in, g, jet_vel, re,
                           act_mode, u_out, v_out, p_out, cd, cl, block_sm,
                           ny, nx, n_steps, iters, n_polish, rows_max, tx_dim,
                           bands, c);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// geom: 11 device pointers in GeomArrays order (n_bodies = 0: one geometry
// shared by the batch), or 15 (n_bodies = kBodies: a bank of geometries,
// each field G planes, the per-body fields kBodies bodies a geometry) and
// geom_id, each env's index into the bank; jet_vel: n_env amplitudes, or
// n_env x kBodies; cd, cl: n_env x n_steps, or n_env x n_steps x kBodies;
// consts: kNumConsts floats; block_sm: n_env x cluster ints, the SM id each
// block ran on (-1 where none ran); starts: cluster + 1 row starts of the
// band partition (ops.band_starts).
// n_env clusters of `cluster` blocks of `threads` = tx_dim x (threads /
// tx_dim) threads; smem: each block's dynamic shared memory in bytes
// (ops.smem_bytes).  Launch on `stream`; returns the CUDA error code
// (0 = launched).
// The geometry's device pointers (the 11 or 15 fields below, in GeomArrays
// order) and the float constants as the kernels take them.
static GeomBank unpack_geometry(const void* const* geom, const int* geom_id,
                                int n_bodies) {
  GeomBank g{};
  const float* const* gp = reinterpret_cast<const float* const*>(geom);
  g.chi_u = gp[0];
  g.chi_v = gp[1];
  g.jet_u = gp[2];
  g.jet_v = gp[3];
  g.jmask_u = gp[4];
  g.jmask_v = gp[5];
  g.rot_u = gp[6];
  g.rot_v = gp[7];
  g.rmask_u = gp[8];
  g.rmask_v = gp[9];
  g.inlet_u = gp[10];
  if (n_bodies) {
    g.rotb_u = gp[11];
    g.rotb_v = gp[12];
    g.own_u = gp[13];
    g.own_v = gp[14];
    g.geom_id = geom_id;
  }
  return g;
}

static Consts unpack_consts(const float* consts) {
  Consts c;
  float* cp = reinterpret_cast<float*>(&c);
  for (int k = 0; k < kNumConsts; ++k) cp[k] = consts[k];
  return c;
}

extern "C" int fused_interval_launch(
    const float* u_in, const float* v_in, const float* p_in,
    const void* const* geom, const int* geom_id, int n_bodies,
    const float* jet_vel, const float* re, const float* act_mode,
    float* u_out, float* v_out, float* p_out, float* cd, float* cl,
    int* block_sm, int n_env, int ny, int nx, int n_steps, int iters,
    int n_polish, int cluster, const int* starts, int rows_max, int threads,
    int tx_dim, int smem, const float* consts, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster ||
      (n_bodies != 0 && n_bodies != kBodies))
    return static_cast<int>(cudaErrorInvalidValue);
  const GeomBank g = unpack_geometry(geom, geom_id, n_bodies);
  const Consts c = unpack_consts(consts);
  Bands bands{};
  for (int r = 0; r <= cluster; ++r) bands.start[r] = starts[r];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_bodies == 0)
    return static_cast<int>(launch<0>(
        g, u_in, v_in, p_in, jet_vel, re, act_mode, u_out, v_out, p_out, cd,
        cl, block_sm, n_env, ny, nx, n_steps, iters, n_polish, cluster,
        rows_max, threads, tx_dim, smem, bands, c, st));
  return static_cast<int>(launch<kBodies>(
      g, u_in, v_in, p_in, jet_vel, re, act_mode, u_out, v_out, p_out, cd, cl,
      block_sm, n_env, ny, nx, n_steps, iters, n_polish, cluster, rows_max,
      threads, tx_dim, smem, bands, c, st));
}

// -- the global-memory kernel's exports ------------------------------------

// How many blocks of `threads` threads of the global-memory kernel's
// instantiation for `n_bodies` (0 or kBodies) one SM holds at once, into
// *out.  Returns the CUDA error code (0 = success).
extern "C" int fused_interval_global_blocks_per_sm(int n_bodies, int threads,
                                                   int* out) {
  return static_cast<int>(
      n_bodies ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     out, fused_interval_global_kernel<kBodies, false>,
                     threads, 0)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     out, fused_interval_global_kernel<0, false>, threads,
                     0));
}

// The float slots of one block's partial sums (ops.workspace_bytes).
extern "C" int fused_interval_part_slots(int n_bodies) {
  return n_bodies ? kPartSlots<kBodies> : kPartSlots<0>;
}

template <int NB>
static cudaError_t launch_global(const GeomOf<NB>& g, const float* u_in,
                                 const float* v_in, const float* p_in,
                                 const float* jet_vel, const float* re,
                                 const float* act_mode, float* u_out,
                                 float* v_out, float* p_out, float* cd,
                                 float* cl, int* block_sm, float* ws,
                                 int n_env, int per_launch, int ny, int nx,
                                 int n_steps, int iters, int n_polish,
                                 int group, int threads, int tx_dim,
                                 const Consts& c, cudaStream_t stream) {
  const auto kernel = nx & 1 ? fused_interval_global_kernel<NB, true>
                             : fused_interval_global_kernel<NB, false>;
  // -1 where no block wrote its SM: the record counts the blocks that ran
  cudaError_t err = cudaMemsetAsync(
      block_sm, 0xff, sizeof(int) * static_cast<size_t>(n_env) * group,
      stream);
  if (err != cudaSuccess) return err;
  for (int e0 = 0; e0 < n_env; e0 += per_launch) {
    const int n = n_env - e0 < per_launch ? n_env - e0 : per_launch;
    // the launch's flags, after its envs' fields and partial sums
    float* flags = ws + n * ws_floats(ny, nx)
                   + static_cast<size_t>(n) * group * kPartSlots<NB>;
    err = cudaMemsetAsync(flags, 0,
                          sizeof(unsigned) * n * group * kFlagStride, stream);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    fill_cooperative_config(cfg, attr, n * group, threads, stream);
    err = cudaLaunchKernelEx(&cfg, kernel, u_in, v_in, p_in, g, jet_vel, re,
                             act_mode, u_out, v_out, p_out, cd, cl,
                             block_sm + e0 * group, ws, e0, n, ny, nx,
                             n_steps, iters, n_polish, tx_dim, c);
    if (err != cudaSuccess) return err;
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The operands as fused_interval_launch takes them; ws: the workspace of
// `per_launch` envs (ops.workspace_bytes), reused by each launch; n_env
// envs in ceil(n_env / per_launch) cooperative launches of per_launch x
// group blocks (the last launch fewer) of `threads` = tx_dim x (threads /
// tx_dim) threads, each env on `group` blocks (<= kMaxGroup, <= ny), all
// of a launch resident at once; block_sm: n_env x group ints.  Launch on
// `stream`; returns the CUDA error code (0 = launched).
extern "C" int fused_interval_global_launch(
    const float* u_in, const float* v_in, const float* p_in,
    const void* const* geom, const int* geom_id, int n_bodies,
    const float* jet_vel, const float* re, const float* act_mode,
    float* u_out, float* v_out, float* p_out, float* cd, float* cl,
    int* block_sm, float* ws, int n_env, int per_launch, int ny, int nx,
    int n_steps, int iters, int n_polish, int group, int threads, int tx_dim,
    const float* consts, void* stream) {
  if (group < 1 || group > kMaxGroup || group > ny || per_launch < 1 ||
      (n_bodies != 0 && n_bodies != kBodies))
    return static_cast<int>(cudaErrorInvalidValue);
  const GeomBank g = unpack_geometry(geom, geom_id, n_bodies);
  const Consts c = unpack_consts(consts);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_bodies == 0)
    return static_cast<int>(launch_global<0>(
        g, u_in, v_in, p_in, jet_vel, re, act_mode, u_out, v_out, p_out, cd,
        cl, block_sm, ws, n_env, per_launch, ny, nx, n_steps, iters,
        n_polish, group, threads, tx_dim, c, st));
  return static_cast<int>(launch_global<kBodies>(
      g, u_in, v_in, p_in, jet_vel, re, act_mode, u_out, v_out, p_out, cd, cl,
      block_sm, ws, n_env, per_launch, ny, nx, n_steps, iters, n_polish,
      group, threads, tx_dim, c, st));
}

// -- the resident kernel's exports ------------------------------------------

// How many clusters of `cluster` blocks (`threads` threads, `smem` bytes of
// dynamic shared memory each) of the resident kernel the card holds at
// once, into *out, for the scalar and the per-body instantiation.
// Returns the CUDA error code (0 = success).
extern "C" int fused_interval_resident_max_clusters(int cluster, int threads,
                                                    int smem, int* out) {
  return static_cast<int>(max_active_clusters(
      fused_interval_resident_kernel<0, false>, cluster, threads, smem, out));
}

extern "C" int fused_interval_bodies_resident_max_clusters(int cluster,
                                                           int threads,
                                                           int smem,
                                                           int* out) {
  return static_cast<int>(
      max_active_clusters(fused_interval_resident_kernel<kBodies, false>,
                          cluster, threads, smem, out));
}

template <int NB>
static cudaError_t launch_resident(
    const GeomOf<NB>& g, const float* u_in, const float* v_in,
    const float* p_in, const float* jet_vel, const float* re,
    const float* act_mode, float* u_out, float* v_out, float* p_out,
    float* cd, float* cl, int* block_sm, float* ws, int n_env,
    int per_launch, int ny, int nx, int n_steps, int iters, int n_polish,
    int group, int cluster, int rows_max, int threads, int tx_dim,
    int pred_tx, int pred_threads, int smem, const Consts& c,
    cudaStream_t stream) {
  const auto kernel = nx & 1 ? fused_interval_resident_kernel<NB, true>
                             : fused_interval_resident_kernel<NB, false>;
  cudaError_t err = set_cluster_attributes(kernel, smem);
  if (err != cudaSuccess) return err;
  // -1 where no block wrote its SM: the record counts the blocks that ran
  err = cudaMemsetAsync(
      block_sm, 0xff, sizeof(int) * static_cast<size_t>(n_env) * group,
      stream);
  if (err != cudaSuccess) return err;
  for (int e0 = 0; e0 < n_env; e0 += per_launch) {
    const int n = n_env - e0 < per_launch ? n_env - e0 : per_launch;
    // the launch's flags and mirror slots, after its envs' partial sums,
    // zeroed: a phase counts from 1
    err = cudaMemsetAsync(
        ws + static_cast<size_t>(n) * group * kPartSlots<NB>, 0,
        sizeof(float) * n *
            (group * kFlagStride +
             mirror_floats(group / cluster, kFusedEdgeSlots, nx + 1)),
        stream);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[2];
    fill_resident_config(cfg, attr, n * (group / cluster), cluster, threads,
                         smem, stream);
    err = cudaLaunchKernelEx(&cfg, kernel, u_in, v_in, p_in, g, jet_vel, re,
                             act_mode, u_out, v_out, p_out, cd, cl,
                             block_sm + e0 * group, ws, e0, n, ny, nx,
                             n_steps, iters, n_polish, rows_max, tx_dim,
                             pred_tx, pred_threads, c);
    if (err != cudaSuccess) return err;
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The operands as fused_interval_global_launch takes them; ws: the
// workspace of `per_launch` envs (ops.workspace_bytes: partial sums, flags,
// mirror slots), reused by each launch; n_env envs in ceil(n_env /
// per_launch) launches of per_launch groups of `group` blocks (<=
// kMaxGroup, <= ny), each group group / cluster clusters of `cluster`
// blocks (2 <= cluster <= kMaxCluster), of `threads` = tx_dim x (threads /
// tx_dim) threads (the predictor's first pred_threads = pred_tx x
// (pred_threads / pred_tx), the global-memory kernel's layout: threads >=
// pred_threads) and `smem` bytes of dynamic shared memory (ops.smem_bytes
// at `group`, whose largest band has rows_max rows).  Launch on `stream`;
// returns the CUDA error code (0 = launched).
extern "C" int fused_interval_resident_launch(
    const float* u_in, const float* v_in, const float* p_in,
    const void* const* geom, const int* geom_id, int n_bodies,
    const float* jet_vel, const float* re, const float* act_mode,
    float* u_out, float* v_out, float* p_out, float* cd, float* cl,
    int* block_sm, float* ws, int n_env, int per_launch, int ny, int nx,
    int n_steps, int iters, int n_polish, int group, int cluster,
    int rows_max, int threads, int tx_dim, int pred_tx, int pred_threads,
    int smem, const float* consts, void* stream) {
  if (group < 1 || group > kMaxGroup || group > ny || cluster < 2 ||
      pred_threads > threads || pred_threads % pred_tx ||
      cluster > kMaxCluster || group % cluster || per_launch < 1 ||
      (n_bodies != 0 && n_bodies != kBodies))
    return static_cast<int>(cudaErrorInvalidValue);
  const GeomBank g = unpack_geometry(geom, geom_id, n_bodies);
  const Consts c = unpack_consts(consts);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_bodies == 0)
    return static_cast<int>(launch_resident<0>(
        g, u_in, v_in, p_in, jet_vel, re, act_mode, u_out, v_out, p_out, cd,
        cl, block_sm, ws, n_env, per_launch, ny, nx, n_steps, iters,
        n_polish, group, cluster, rows_max, threads, tx_dim, pred_tx,
        pred_threads, smem, c, st));
  return static_cast<int>(launch_resident<kBodies>(
      g, u_in, v_in, p_in, jet_vel, re, act_mode, u_out, v_out, p_out, cd, cl,
      block_sm, ws, n_env, per_launch, ny, nx, n_steps, iters, n_polish,
      group, cluster, rows_max, threads, tx_dim, pred_tx, pred_threads, smem,
      c, st));
}
