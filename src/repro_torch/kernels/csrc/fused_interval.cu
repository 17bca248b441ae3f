// Fused actuation interval: n_steps solver dt's in one launch, one
// thread-block cluster per env.
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
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

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
// nullptr where there is no neighbour.
__device__ __forceinline__ void put(float* row, float* prev, float* next,
                                    int lj, int nrows, int i, float val) {
  row[i] = val;
  if (lj == 0 && prev) prev[i] = val;
  if (lj == nrows - 1 && next) next[i] = val;
}

template <int NB>
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
  const int TX = tx_dim;
  const int TY = blockDim.x / TX;
  const int ty = tid / TX;
  const int tx = tid - ty * TX;
  const int lane = tid & 31;

  const int w = nx / 2;
  const int nxu = nx + 1;
  const int R = rows_max;
  const int j0 = bands.start[rank];
  const int nrows = bands.start[rank + 1] - j0;
  const bool first = rank == 0, last = rank == C - 1;
  const int nv_rows = nrows + (last ? 1 : 0);  // + the top wall row ny
  if (tid == 0) block_sm[blockIdx.x] = sm_id();  // the launch's record

  // shared-memory layout (kernels/actuation/ops.py smem_bytes): stored row
  // s of a field with a halo above is local row s - 1
  // 2 mbarriers (red, black halo rows received), then the fields
  unsigned long long* mbar = reinterpret_cast<unsigned long long*>(smem);
  float* u = smem + 4;                 // (R + 2) x nxu, local rows -1..R
  float* v = u + (R + 2) * nxu;        // (R + 3) x nx, local rows -1..R+1
  float* us = v + (R + 3) * nx;        // R x nx: u_pen with the inlet BC
  float* vs = us + R * nx;             // (R + 1) x nx: v_pen with its BCs
  float* red = vs + (R + 1) * nx;      // (R + 2) x w, local rows -1..R
  float* black = red + (R + 2) * w;
  float* rhs_r = black + (R + 2) * w;  // R x w
  float* rhs_b = rhs_r + R * w;
  // this block's fx, fy, outflux (NB > 0: fx and fy per body), then the
  // reduction's scratch: 128 floats for block_sum3, 33 (2 NB + 1) for
  // block_sum
  float* part = rhs_b + R * w;
  float* scratch = part + kPartSlots<NB>;

  // the neighbours' halo rows (nullptr at the domain's walls)
  const int nrows_prev = first ? 0 : j0 - bands.start[rank - 1];
  float *u_prev = nullptr, *v_prev = nullptr, *vs_prev = nullptr;
  float *u_next = nullptr, *v_next = nullptr;
  Link red_link{0u, 0u, 0u, 0u}, black_link{0u, 0u, 0u, 0u};
  if (!first) {
    u_prev = cluster.map_shared_rank(u, rank - 1) + (nrows_prev + 1) * nxu;
    v_prev = cluster.map_shared_rank(v, rank - 1) + (nrows_prev + 1) * nx;
    vs_prev = cluster.map_shared_rank(vs, rank - 1) + nrows_prev * nx;
    red_link.prev = cluster_addr(red + (nrows_prev + 1) * w, rank - 1);
    red_link.prev_bar = cluster_addr(&mbar[0], rank - 1);
    black_link.prev = cluster_addr(black + (nrows_prev + 1) * w, rank - 1);
    black_link.prev_bar = cluster_addr(&mbar[1], rank - 1);
  }
  if (!last) {
    u_next = cluster.map_shared_rank(u, rank + 1);
    v_next = cluster.map_shared_rank(v, rank + 1);
    red_link.next = cluster_addr(red, rank + 1);
    red_link.next_bar = cluster_addr(&mbar[0], rank + 1);
    black_link.next = cluster_addr(black, rank + 1);
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
  if constexpr (NB > 0) {  // this env's geometry in the bank
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
  u_in += env * nu;
  u_out += env * nu;
  v_in += env * nv;
  v_out += env * nv;
  p_in += static_cast<size_t>(env) * ny * nx;
  p_out += static_cast<size_t>(env) * ny * nx;
  if constexpr (NB == 0) {
    cd_out += static_cast<size_t>(env) * n_steps;
    cl_out += static_cast<size_t>(env) * n_steps;
  } else {  // (n_env, n_steps, NB)
    cd_out += static_cast<size_t>(env) * n_steps * NB;
    cl_out += static_cast<size_t>(env) * n_steps * NB;
  }
  // the amplitude: a scalar, or NB per-body speeds whose slot 0 doubles as
  // the jet amplitude
  float jvb[NB > 0 ? NB : 1];
  if constexpr (NB > 0) {
#pragma unroll
    for (int b = 0; b < NB; ++b) jvb[b] = jet_vel[env * NB + b];
  }
  const float jv = NB == 0 ? jet_vel[env] : jvb[0];
  const float re = re_arr[env];
  const float m = mode_arr[env];
  const float one_m_m = 1.0f - m;
  const int n_sor = iters - n_polish;

  // -- load the band with its halo rows; the wall ghost rows of _pad_u /
  //    _pad_v (-u, 0 * v) where the band meets a wall -------------------
  for (int lj = ty - 1; lj <= nrows; lj += TY) {
    const int j = j0 + lj;
    const float sign = (j < 0 || j >= ny) ? -1.0f : 1.0f;
    const float* src = u_in + static_cast<size_t>(min(max(j, 0), ny - 1)) * nxu;
    for (int i = tx; i < nxu; i += TX) u[(lj + 1) * nxu + i] = sign * src[i];
  }
  for (int lj = ty - 1; lj <= nrows + 1; lj += TY) {
    const int j = j0 + lj;
    const bool ghost = j < 0 || j > ny;
    const float* src = v_in + static_cast<size_t>(min(max(j, 0), ny)) * nx;
    for (int i = tx; i < nx; i += TX)
      v[(lj + 1) * nx + i] = ghost ? src[i] * 0.0f : src[i];
  }
  for (int lj = ty - 1; lj <= nrows; lj += TY) {
    const int j = j0 + lj;
    const bool inside = j >= 0 && j < ny;
    const float* src = p_in + static_cast<size_t>(inside ? j : 0) * nx;
    for (int k = tx; k < w; k += TX) {
      red[(lj + 1) * w + k] = inside ? src[2 * k + (j & 1)] : 0.0f;
      black[(lj + 1) * w + k] = inside ? src[2 * k + 1 - (j & 1)] : 0.0f;
    }
  }
  float s_in = 0.0f, unused_b = 0.0f, unused_c = 0.0f;
  for (int j = tid; j < ny; j += blockDim.x) s_in += g.inlet_u[j];
  block_sum3(s_in, unused_b, unused_c, scratch);
  const float influx = s_in * c.dy;
  // every block of the cluster has started, holds its band and has its
  // mbarriers set before any block stores into another's shared memory
  cluster_barrier();

  for (int t = 0; t < n_steps; ++t) {
    // -- A: predictor, penalization, BCs but the outlet column of u_pen,
    //    force and outflux partial sums --------------------------------
    float fx = 0.0f, fy = 0.0f, out = 0.0f;
    float fxb[NB > 0 ? NB : 1], fyb[NB > 0 ? NB : 1];
    if constexpr (NB > 0) {
#pragma unroll
      for (int b = 0; b < NB; ++b) fxb[b] = fyb[b] = 0.0f;
    }
    for (int lj = ty; lj < nrows; lj += TY) {
      const int j = j0 + lj;
      const float* ur0 = u + (lj + 1) * nxu;  // row j
      const float* urb = ur0 - nxu;           // j - 1
      const float* urt = ur0 + nxu;           // j + 1
      const float* vr0 = v + (lj + 1) * nx;   // v row j
      const float* vr1 = vr0 + nx;            // v row j + 1
      float* usr = us + lj * nx;
      const float inlet = g.inlet_u[j];
      for (int i = tx; i < nxu; i += TX) {
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
          for (int b = 0; b < NB; ++b) rot += jvb[b] * g.rotb_u[b * nu + gi];
          tgt = (one_m_m * jv) * (g.jet_u[gi] - g.jet_u[nu + gi]) + m * rot;
        }
        const float pen = fmaxf(g.chi_u[gi],
                                one_m_m * g.jmask_u[gi] + m * g.rmask_u[gi]);
        const float lp = c.lam * pen;
        const float u_pen = (u_star + lp * tgt) / (1.0f + lp);
        if constexpr (NB == 0) {
          fx += (u_pen - u_star) * c.inv_dt;
        } else {
          const float d = (u_pen - u_star) * c.inv_dt;
#pragma unroll
          for (int b = 0; b < NB; ++b) fxb[b] += g.own_u[b * nu + gi] * d;
        }
        if (i == nx - 1) out += u_pen;
        if (i < nx) usr[i] = i == 0 ? inlet : u_pen;  // column nx: in C
      }
    }
    for (int lj = ty; lj < nv_rows; lj += TY) {
      const int j = j0 + lj;
      const bool wall = j == 0 || j == ny;
      const float* vr0 = v + (lj + 1) * nx;  // row j
      const float* vrb = vr0 - nx;
      const float* vrt = vr0 + nx;
      const float* ur0 = u + (lj + 1) * nxu;  // u row j
      const float* urb = ur0 - nxu;           // u row j - 1
      float* vsr = vs + lj * nx;
      for (int i = tx; i < nx; i += TX) {
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
          for (int b = 0; b < NB; ++b) rot += jvb[b] * g.rotb_v[b * nv + gi];
          tgt = (one_m_m * jv) * (g.jet_v[gi] - g.jet_v[nv + gi]) + m * rot;
        }
        const float pen = fmaxf(g.chi_v[gi],
                                one_m_m * g.jmask_v[gi] + m * g.rmask_v[gi]);
        const float lp = c.lam * pen;
        const float v_pen = (v_star + lp * tgt) / (1.0f + lp);
        if constexpr (NB == 0) {
          fy += (v_pen - v_star) * c.inv_dt;
        } else {
          const float d = (v_pen - v_star) * c.inv_dt;
#pragma unroll
          for (int b = 0; b < NB; ++b) fyb[b] += g.own_v[b * nv + gi] * d;
        }
        // _apply_bc_v: inlet 0, outlet copies column -2, walls 0
        if (i == nx - 1) continue;
        const float val = (i == 0 || wall) ? 0.0f : v_pen;
        put(vsr, vs_prev, nullptr, lj, nrows, i, val);
        if (i == nx - 2) put(vsr, vs_prev, nullptr, lj, nrows, nx - 1, val);
      }
    }
    if constexpr (NB == 0) {
      block_sum3(fx, fy, out, scratch);
      if (tid == 0) {
        part[0] = fx;
        part[1] = fy;
        part[2] = out;
      }
    } else {  // per-body fx, per-body fy, outflux
      float sums[2 * NB + 1];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        sums[b] = fxb[b];
        sums[NB + b] = fyb[b];
      }
      sums[2 * NB] = out;
      block_sum(sums, scratch);
      if (tid == 0) {
#pragma unroll
        for (int k = 0; k < 2 * NB + 1; ++k) part[k] = sums[k];
      }
    }
    cluster_barrier();  // partials, u_pen / v_pen and the vs halo complete

    // the cluster's sums, in one fixed order on every warp of every block
    if constexpr (NB == 0) {
      fx = lane < C ? part_of_lane[0] : 0.0f;
      fy = lane < C ? part_of_lane[1] : 0.0f;
      out = lane < C ? part_of_lane[2] : 0.0f;
      for (int off = 1; off < 32; off <<= 1) {
        fx += __shfl_xor_sync(0xffffffffu, fx, off);
        fy += __shfl_xor_sync(0xffffffffu, fy, off);
        out += __shfl_xor_sync(0xffffffffu, out, off);
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
      for (int b = 0; b < NB; ++b) {
        fxb[b] = sums[b];
        fyb[b] = sums[NB + b];
      }
      out = sums[2 * NB];
    }
    const float corr = (influx - out * c.dy) / c.ny_dy;
    if (first && tid == 0) {
      if constexpr (NB == 0) {
        cd_out[t] = ((-fx * c.dx) * c.dy) / c.coef;
        cl_out[t] = ((-fy * c.dx) * c.dy) / c.coef;
      } else {
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          cd_out[t * NB + b] = ((-fxb[b] * c.dx) * c.dy) / c.coef;
          cl_out[t * NB + b] = ((-fyb[b] * c.dx) * c.dy) / c.coef;
        }
      }
    }

    // -- C: divergence rhs into the two rhs planes.  The outlet column of
    //    u_bc is u_pen's column -2 plus the mass correction ---------------
    for (int lj = ty; lj < nrows; lj += TY) {
      const int j = j0 + lj;
      const float* usr = us + lj * nx;
      const float* vs0 = vs + lj * nx;
      const float* vs1 = vs0 + nx;
      for (int k = tx; k < w; k += TX) {
        const int ir = 2 * k + (j & 1);
        const int ib = 2 * k + 1 - (j & 1);
        const float ur1 = ir + 1 == nx ? usr[nx - 1] + corr : usr[ir + 1];
        const float ub1 = ib + 1 == nx ? usr[nx - 1] + corr : usr[ib + 1];
        rhs_r[lj * w + k] = ((ur1 - usr[ir]) * c.inv_dx
                             + (vs1[ir] - vs0[ir]) * c.inv_dy) * c.inv_dt;
        rhs_b[lj * w + k] = ((ub1 - usr[ib]) * c.inv_dx
                             + (vs1[ib] - vs0[ib]) * c.inv_dy) * c.inv_dt;
      }
    }

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
      band_half_sweep<false>(red, black, rhs_r, nullptr, nullptr, red_link,
                             wait_black ? &mbar[1] : nullptr, black_parity,
                             nrows, j0, ny, w, 1, tx, ty, TX, TY, c.inv_dx2,
                             c.inv_dy2, c.inv_diag, om, one_m_om);
      if (wait_black) {
        black_parity ^= 1u;
        if (tid == 0) mbar_expect(&mbar[1], halo_bytes);
      }
      band_half_sweep<false>(black, red, rhs_b, nullptr, nullptr, black_link,
                             linked ? &mbar[0] : nullptr, red_parity, nrows,
                             j0, ny, w, 0, tx, ty, TX, TY, c.inv_dx2,
                             c.inv_dy2, c.inv_diag, om, one_m_om);
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

    // -- E: velocity correction and the BCs of _correct; the wall ghost
    //    rows and the neighbours' halo rows follow the stores ------------
    for (int lj = ty; lj < nrows; lj += TY) {
      const int j = j0 + lj;
      const float* usr = us + lj * nx;
      const float* pr = red + (lj + 1) * w;
      const float* pb = black + (lj + 1) * w;
      float* urow = u + (lj + 1) * nxu;
      for (int i = tx; i < nx; i += TX) {
        float val = usr[i];
        if (i >= 1) {
          const float p1 = ((i + j) & 1) == 0 ? pr[i >> 1] : pb[i >> 1];
          const float p0 = ((i - 1 + j) & 1) == 0 ? pr[(i - 1) >> 1]
                                                  : pb[(i - 1) >> 1];
          val = val + (-c.dt * (p1 - p0)) * c.inv_dx;
        }
        put(urow, u_prev, u_next, lj, nrows, i, val);
        if (i == nx - 1) put(urow, u_prev, u_next, lj, nrows, nx, val);
        if (first && lj == 0) {
          urow[i - nxu] = -val;
          if (i == nx - 1) urow[nx - nxu] = -val;
        }
        if (last && lj == nrows - 1) {
          urow[i + nxu] = -val;
          if (i == nx - 1) urow[nx + nxu] = -val;
        }
      }
    }
    for (int lj = ty; lj < nv_rows; lj += TY) {
      const int j = j0 + lj;
      const bool zero_row = j == 0 || j == ny;
      const float* vsr = vs + lj * nx;
      const float* pr = red + (lj + 1) * w;
      const float* pb = black + (lj + 1) * w;
      float* vrow = v + (lj + 1) * nx;
      for (int i = tx; i < nx - 1; i += TX) {
        float val = 0.0f;
        if (!(i == 0 || zero_row)) {
          const float p1 = ((i + j) & 1) == 0 ? pr[i >> 1] : pb[i >> 1];
          const float p0 = ((i + j - 1) & 1) == 0 ? pr[(i >> 1) - w]
                                                  : pb[(i >> 1) - w];
          val = vsr[i] + (-c.dt * (p1 - p0)) * c.inv_dy;
        }
        put(vrow, v_prev, v_next, lj, nrows, i, val);
        if (i == nx - 2) put(vrow, v_prev, v_next, lj, nrows, nx - 1, val);
        if (first && lj == 0) {  // ghost row j = -1 of _pad_v: 0 * v[0]
          vrow[i - nx] = val * 0.0f;
          if (i == nx - 2) vrow[nx - 1 - nx] = val * 0.0f;
        }
        if (last && lj == nrows) {  // ghost row j = ny + 1: 0 * v[ny]
          vrow[i + nx] = val * 0.0f;
          if (i == nx - 2) vrow[nx - 1 + nx] = val * 0.0f;
        }
      }
    }
    cluster_barrier();  // u, v and their halo and ghost rows complete
    if (wait_last && tid == 0) mbar_expect(&mbar[1], halo_bytes);
  }

  // -- write the band back ---------------------------------------------
  for (int lj = ty; lj < nrows; lj += TY) {
    const int j = j0 + lj;
    for (int i = tx; i < nxu; i += TX)
      u_out[static_cast<size_t>(j) * nxu + i] = u[(lj + 1) * nxu + i];
    for (int k = tx; k < w; k += TX) {
      p_out[static_cast<size_t>(j) * nx + 2 * k + (j & 1)] = red[(lj + 1) * w + k];
      p_out[static_cast<size_t>(j) * nx + 2 * k + 1 - (j & 1)] =
          black[(lj + 1) * w + k];
    }
  }
  for (int lj = ty; lj < nv_rows; lj += TY) {
    const int j = j0 + lj;
    for (int i = tx; i < nx; i += TX)
      v_out[static_cast<size_t>(j) * nx + i] = v[(lj + 1) * nx + i];
  }
}

// The per-body instantiation's body count: grid.max_bodies(), the widest
// geometry (the pinball); a bank of fewer bodies is zero-padded to it
constexpr int kBodies = 3;

// How many clusters of `cluster` blocks (`threads` threads, `smem` bytes
// of dynamic shared memory each) the card holds at once, into *out, for
// the scalar and the per-body instantiation.  Returns the CUDA error code
// (0 = success).
extern "C" int fused_interval_max_clusters(int cluster, int threads, int smem,
                                           int* out) {
  return static_cast<int>(max_active_clusters(fused_interval_kernel<0>,
                                              cluster, threads, smem, out));
}

extern "C" int fused_interval_bodies_max_clusters(int cluster, int threads,
                                                  int smem, int* out) {
  return static_cast<int>(max_active_clusters(
      fused_interval_kernel<kBodies>, cluster, threads, smem, out));
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
  cudaError_t err = set_cluster_attributes(fused_interval_kernel<NB>, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  fill_cluster_config(cfg, attr, n_env, cluster, threads, smem, stream);
  // -1 where no block wrote its SM: the record counts the blocks that ran
  err = cudaMemsetAsync(block_sm, 0xff, sizeof(int) * n_env * cluster,
                        stream);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, fused_interval_kernel<NB>, u_in, v_in,
                           p_in, g, jet_vel, re, act_mode, u_out, v_out,
                           p_out, cd, cl, block_sm, ny, nx, n_steps, iters,
                           n_polish, rows_max, tx_dim, bands, c);
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
  GeomBank g;
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
  Consts c;
  float* cp = reinterpret_cast<float*>(&c);
  for (int k = 0; k < kNumConsts; ++k) cp[k] = consts[k];
  Bands bands{};
  for (int r = 0; r <= cluster; ++r) bands.start[r] = starts[r];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_bodies == 0)
    return static_cast<int>(launch<0>(
        g, u_in, v_in, p_in, jet_vel, re, act_mode, u_out, v_out, p_out, cd,
        cl, block_sm, n_env, ny, nx, n_steps, iters, n_polish, cluster,
        rows_max, threads, tx_dim, smem, bands, c, st));
  g.rotb_u = gp[11];
  g.rotb_v = gp[12];
  g.own_u = gp[13];
  g.own_v = gp[14];
  g.geom_id = geom_id;
  return static_cast<int>(launch<kBodies>(
      g, u_in, v_in, p_in, jet_vel, re, act_mode, u_out, v_out, p_out, cd, cl,
      block_sm, n_env, ny, nx, n_steps, iters, n_polish, cluster, rows_max,
      threads, tx_dim, smem, bands, c, st));
}
