// Fused actuation interval: n_steps solver dt's in one launch.
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
// What bounds it on an H100: operations.  Per dt and env the SOR does
// iters x ny x nx x ~10 flops (13.9 MFLOP at res 16, iters=60) and the
// momentum/projection ~2.5 MFLOP, against ~0.6 MB of fields read and
// written once per interval: thousands of flops per byte.
//
// Design: one block per env, the whole n_steps loop inside the kernel.  The
// four packed pressure planes (red, black, rhs_r, rhs_b) live in dynamic
// shared memory for the whole interval (185,856 bytes at res 16, within
// the 227 KB a block may have), so the ~120 half-sweeps per dt never leave
// the SM.  u, v and their scratch copies (u_pen/v_pen, ~375 KB per env at
// res 16) do not fit beside them: they stay in global memory, which the
// 50 MB L2 holds for a batch of envs.  The passes of a dt are separated by
// __syncthreads(); the block reductions are fx, fy and the outflux of
// column -2 (one pass), the influx once, and C_D/C_L follow from fx, fy.
// Only n_env of the 132 SMs are busy; spreading an env over a thread-block
// cluster is later work.
#include <cuda_runtime.h>

#include "sor_packed.cuh"

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

// float32 constants, each rounded from the float64 value the reference
// computes in Python (order: see kernels/actuation/ops.py _CONSTS)
struct Consts {
  float dt, dx, dy, dx2, dy2, two_dx, two_dy, blend, one_m_blend, lam,
      inv_diag, omega, one_m_omega, ny_dy, coef;
};
constexpr int kNumConsts = 15;

// u with the ghosts of the reference's _pad_u: walls reflect (-u), inlet
// extrapolates (2 u0 - u1), outlet zero-gradient.  j in [-1, ny],
// i in [-1, nx+1].
__device__ __forceinline__ float u_row(const float* u, int j, int i, int ny,
                                       int nxu) {
  if (j < 0) return -u[i];
  if (j >= ny) return -u[(ny - 1) * nxu + i];
  return u[j * nxu + i];
}
__device__ __forceinline__ float U(const float* u, int j, int i, int ny,
                                   int nx) {
  if (i < 0) return 2.0f * u_row(u, j, 0, ny, nx + 1) - u_row(u, j, 1, ny, nx + 1);
  if (i > nx) return u_row(u, j, nx, ny, nx + 1);
  return u_row(u, j, i, ny, nx + 1);
}

// v with the ghosts of _pad_v: wall rows 0 * v (zero, NaN-propagating),
// inlet reflects (-v), outlet zero-gradient.  j in [-1, ny+1], i in
// [-1, nx].
__device__ __forceinline__ float v_row(const float* v, int j, int i, int ny,
                                       int nx) {
  if (j < 0) return v[i] * 0.0f;
  if (j > ny) return v[ny * nx + i] * 0.0f;
  return v[j * nx + i];
}
__device__ __forceinline__ float V(const float* v, int j, int i, int ny,
                                   int nx) {
  if (i < 0) return -v_row(v, j, 0, ny, nx);
  if (i >= nx) return v_row(v, j, nx - 1, ny, nx);
  return v_row(v, j, i, ny, nx);
}

// pressure at full-grid (j, i) from the packed planes
__device__ __forceinline__ float P(const float* red, const float* black,
                                   int j, int i, int w) {
  const int k = j * w + (i >> 1);
  return ((i + j) & 1) == 0 ? red[k] : black[k];
}

__global__ void __launch_bounds__(1024, 1) fused_interval_kernel(
    const float* __restrict__ u_in, const float* __restrict__ v_in,
    const float* __restrict__ p_in, Geom g,
    const float* __restrict__ jet_vel, const float* __restrict__ re_arr,
    const float* __restrict__ mode_arr, float* u, float* v,
    float* __restrict__ p_out, float* us, float* vs,
    float* __restrict__ cd_out, float* __restrict__ cl_out, int ny, int nx,
    int n_steps, int iters, int n_polish, Consts c) {
  extern __shared__ float smem[];
  const int w = nx / 2;
  const int np = ny * w;
  const int nxu = nx + 1;
  const int nu = ny * nxu;
  const int nv = (ny + 1) * nx;
  float* red = smem;
  float* black = red + np;
  float* rhs_r = black + np;
  float* rhs_b = rhs_r + np;
  float* scratch = rhs_b + np;  // 128 floats for block_sum3

  const int env = blockIdx.x;
  u_in += static_cast<size_t>(env) * nu;
  u += static_cast<size_t>(env) * nu;
  us += static_cast<size_t>(env) * nu;
  v_in += static_cast<size_t>(env) * nv;
  v += static_cast<size_t>(env) * nv;
  vs += static_cast<size_t>(env) * nv;
  p_in += static_cast<size_t>(env) * ny * nx;
  p_out += static_cast<size_t>(env) * ny * nx;
  cd_out += static_cast<size_t>(env) * n_steps;
  cl_out += static_cast<size_t>(env) * n_steps;
  const float jv = jet_vel[env];
  const float re = re_arr[env];
  const float m = mode_arr[env];
  const float one_m_m = 1.0f - m;
  const int n_sor = iters - n_polish;

  for (int idx = threadIdx.x; idx < nu; idx += blockDim.x) u[idx] = u_in[idx];
  for (int idx = threadIdx.x; idx < nv; idx += blockDim.x) v[idx] = v_in[idx];
  for (int idx = threadIdx.x; idx < np; idx += blockDim.x) {
    const int j = idx / w;
    const int k = idx - j * w;
    red[idx] = p_in[j * nx + 2 * k + (j & 1)];
    black[idx] = p_in[j * nx + 2 * k + 1 - (j & 1)];
  }
  float s_in = 0.0f, unused_b = 0.0f, unused_c = 0.0f;
  for (int j = threadIdx.x; j < ny; j += blockDim.x) s_in += g.inlet_u[j];
  block_sum3(s_in, unused_b, unused_c, scratch);  // also orders the copies
  const float influx = s_in * c.dy;

  for (int t = 0; t < n_steps; ++t) {
    // -- A: predictor, penalization, force and outflux partial sums ------
    float fx = 0.0f, fy = 0.0f, out = 0.0f;
    for (int idx = threadIdx.x; idx < nu; idx += blockDim.x) {
      const int j = idx / nxu;
      const int i = idx - j * nxu;
      const float uc = U(u, j, i, ny, nx);
      const float ul = U(u, j, i - 1, ny, nx);
      const float ur = U(u, j, i + 1, ny, nx);
      const float ub = U(u, j - 1, i, ny, nx);
      const float ut = U(u, j + 1, i, ny, nx);
      const float vau = 0.25f * (((V(v, j, i - 1, ny, nx) + V(v, j, i, ny, nx))
                                  + V(v, j + 1, i - 1, ny, nx))
                                 + V(v, j + 1, i, ny, nx));
      const float dudx_up = uc > 0.0f ? (uc - ul) / c.dx : (ur - uc) / c.dx;
      const float dudy_up = vau > 0.0f ? (uc - ub) / c.dy : (ut - uc) / c.dy;
      const float dudx = c.blend * dudx_up + (c.one_m_blend * (ur - ul)) / c.two_dx;
      const float dudy = c.blend * dudy_up + (c.one_m_blend * (ut - ub)) / c.two_dy;
      const float adv = uc * dudx + vau * dudy;
      const float lap = ((ul + ur) - 2.0f * uc) / c.dx2 + ((ub + ut) - 2.0f * uc) / c.dy2;
      const float u_star = uc + c.dt * (-adv + lap / re);
      const float tgt = jv * (one_m_m * (g.jet_u[idx] - g.jet_u[nu + idx])
                              + m * g.rot_u[idx]);
      const float pen = fmaxf(g.chi_u[idx],
                              one_m_m * g.jmask_u[idx] + m * g.rmask_u[idx]);
      const float lp = c.lam * pen;
      const float u_pen = (u_star + lp * tgt) / (1.0f + lp);
      us[idx] = u_pen;
      fx += (u_pen - u_star) / c.dt;
      if (i == nx - 1) out += u_pen;
    }
    for (int idx = threadIdx.x; idx < nv; idx += blockDim.x) {
      const int j = idx / nx;
      const int i = idx - j * nx;
      const float vc = V(v, j, i, ny, nx);
      const float vl = V(v, j, i - 1, ny, nx);
      const float vr = V(v, j, i + 1, ny, nx);
      const float vb = V(v, j - 1, i, ny, nx);
      const float vt = V(v, j + 1, i, ny, nx);
      const float uav = 0.25f * (((U(u, j - 1, i, ny, nx) + U(u, j - 1, i + 1, ny, nx))
                                  + U(u, j, i, ny, nx))
                                 + U(u, j, i + 1, ny, nx));
      const float dvdx_up = uav > 0.0f ? (vc - vl) / c.dx : (vr - vc) / c.dx;
      const float dvdy_up = vc > 0.0f ? (vc - vb) / c.dy : (vt - vc) / c.dy;
      const float dvdx = c.blend * dvdx_up + (c.one_m_blend * (vr - vl)) / c.two_dx;
      const float dvdy = c.blend * dvdy_up + (c.one_m_blend * (vt - vb)) / c.two_dy;
      const float adv = uav * dvdx + vc * dvdy;
      const float lap = ((vl + vr) - 2.0f * vc) / c.dx2 + ((vb + vt) - 2.0f * vc) / c.dy2;
      const float v_star = vc + c.dt * (-adv + lap / re);
      const float tgt = jv * (one_m_m * (g.jet_v[idx] - g.jet_v[nv + idx])
                              + m * g.rot_v[idx]);
      const float pen = fmaxf(g.chi_v[idx],
                              one_m_m * g.jmask_v[idx] + m * g.rmask_v[idx]);
      const float lp = c.lam * pen;
      const float v_pen = (v_star + lp * tgt) / (1.0f + lp);
      vs[idx] = v_pen;
      fy += (v_pen - v_star) / c.dt;
    }
    block_sum3(fx, fy, out, scratch);  // u_pen / v_pen complete after this
    const float corr = (influx - out * c.dy) / c.ny_dy;

    // -- B: BCs + outlet mass correction on the penalized fields ----------
    for (int j = threadIdx.x; j < ny; j += blockDim.x) {
      us[j * nxu] = g.inlet_u[j];
      us[j * nxu + nx] = us[j * nxu + nx - 1] + corr;
    }
    for (int j = threadIdx.x; j <= ny; j += blockDim.x) {
      const bool wall = (j == 0) || (j == ny);
      vs[j * nx] = 0.0f;
      vs[j * nx + nx - 1] = wall ? 0.0f : vs[j * nx + nx - 2];
    }
    for (int i = threadIdx.x; i < nx; i += blockDim.x) {
      vs[i] = 0.0f;
      vs[ny * nx + i] = 0.0f;
    }
    __syncthreads();

    // -- C: divergence rhs, packed into the two rhs planes ----------------
    for (int idx = threadIdx.x; idx < np; idx += blockDim.x) {
      const int j = idx / w;
      const int k = idx - j * w;
      const int ir = 2 * k + (j & 1);
      const int ib = 2 * k + 1 - (j & 1);
      rhs_r[idx] = ((us[j * nxu + ir + 1] - us[j * nxu + ir]) / c.dx
                    + (vs[(j + 1) * nx + ir] - vs[j * nx + ir]) / c.dy) / c.dt;
      rhs_b[idx] = ((us[j * nxu + ib + 1] - us[j * nxu + ib]) / c.dx
                    + (vs[(j + 1) * nx + ib] - vs[j * nx + ib]) / c.dy) / c.dt;
    }
    __syncthreads();

    // -- D: packed SOR, warm-started from the previous dt's planes --------
    for (int it = 0; it < iters; ++it) {
      const bool sor = it < n_sor;
      const float om = sor ? c.omega : 1.0f;
      const float one_m_om = sor ? c.one_m_omega : 0.0f;
      packed_half_sweep(red, black, rhs_r, nullptr, nullptr, ny, w, 1, c.dx2,
                        c.dy2, c.inv_diag, om, one_m_om);
      __syncthreads();
      packed_half_sweep(black, red, rhs_b, nullptr, nullptr, ny, w, 0, c.dx2,
                        c.dy2, c.inv_diag, om, one_m_om);
      __syncthreads();
    }

    // -- E: velocity correction; outlet columns wait for F ----------------
    for (int idx = threadIdx.x; idx < nu; idx += blockDim.x) {
      const int j = idx / nxu;
      const int i = idx - j * nxu;
      if (i == nx) continue;
      float val = us[idx];
      if (i >= 1) val = val + (-c.dt * (P(red, black, j, i, w) - P(red, black, j, i - 1, w))) / c.dx;
      u[idx] = val;
    }
    for (int idx = threadIdx.x; idx < nv; idx += blockDim.x) {
      const int j = idx / nx;
      const int i = idx - j * nx;
      if (i == nx - 1) continue;
      v[idx] = (i == 0 || j == 0 || j == ny)
                   ? 0.0f
                   : vs[idx] + (-c.dt * (P(red, black, j, i, w) - P(red, black, j - 1, i, w))) / c.dy;
    }
    __syncthreads();

    // -- F: outlet zero-gradient copies the corrected column -2 -----------
    for (int j = threadIdx.x; j < ny; j += blockDim.x)
      u[j * nxu + nx] = u[j * nxu + nx - 1];
    for (int j = threadIdx.x; j <= ny; j += blockDim.x)
      v[j * nx + nx - 1] = (j == 0 || j == ny) ? 0.0f : v[j * nx + nx - 2];
    if (threadIdx.x == 0) {
      cd_out[t] = ((-fx * c.dx) * c.dy) / c.coef;
      cl_out[t] = ((-fy * c.dx) * c.dy) / c.coef;
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < np; idx += blockDim.x) {
    const int j = idx / w;
    const int k = idx - j * w;
    p_out[j * nx + 2 * k + (j & 1)] = red[idx];
    p_out[j * nx + 2 * k + 1 - (j & 1)] = black[idx];
  }
}

// geom: 11 device pointers in GeomArrays order; consts: kNumConsts floats.
// smem: the block's dynamic shared memory in bytes, the four packed planes
// and the reduction slots (computed by the wrapper, kernels/actuation/ops.py
// smem_bytes).  Launch on `stream`; returns the CUDA error code (0 =
// launched).
extern "C" int fused_interval_launch(
    const float* u_in, const float* v_in, const float* p_in,
    const void* const* geom, const float* jet_vel, const float* re,
    const float* act_mode, float* u_out, float* v_out, float* p_out,
    float* u_scratch, float* v_scratch, float* cd, float* cl, int n_env,
    int ny, int nx, int n_steps, int iters, int n_polish, int smem,
    const float* consts, void* stream) {
  Geom g;
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
  cudaError_t err = cudaFuncSetAttribute(
      fused_interval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nu = ny * (nx + 1), nv = (ny + 1) * nx;
  fused_interval_kernel<<<n_env, threads_for(nu > nv ? nu : nv), smem,
                          static_cast<cudaStream_t>(stream)>>>(
      u_in, v_in, p_in, g, jet_vel, re, act_mode, u_out, v_out, p_out,
      u_scratch, v_scratch, cd, cl, ny, nx, n_steps, iters, n_polish, c);
  return static_cast<int>(cudaGetLastError());
}
