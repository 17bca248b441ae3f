// Chunked WKV6 recurrence (RWKV-6 "Finch" linear attention).
//
// Replaces the Pallas TPU kernel _wkv6_kernel / wkv6_bhsn
// (src/repro/kernels/rwkv6/kernel.py:27-91).
//
// What it computes, per (batch, head), exactly as the TPU kernel: the state
// S (N x N, fp32) starts from s0; for each chunk of C tokens, in fp32,
//   lw = log(max(w, 1e-30)),  lp = cumsum(lw) (inclusive),
//   r~ = r * exp(lp - lw),    k~ = k * exp(-lp),
//   out = r~ S + strict_tril(r~ k~^T) v + sum(r * u * k, -1) * v
//   S   = diag(exp(lp[C-1])) (S + k~^T v)
// out has the inputs' dtype, the final state is fp32.  The clamp and the
// association of exp(-lp) are the TPU kernel's: for strong decay exp(-lp)
// overflows in both alike.
//
// What bounds it on an H100: ~4 * C * N * (N + C) fp32 operations per chunk
// against r, k, v, w read and out written once, ~38 flop/byte at rwkv6-3b's
// N 64, C 32 in bf16, above the fp32 ridge (~20): operations, by about 2x.
//
// Design: grid (B * H), 256 threads; the chunk axis, sequential on the TPU,
// is a loop inside the block, and the state stays in shared memory for the
// whole sequence.  Per chunk: r, k, v, w go to shared memory (fp32, rows
// padded by one float so column reads are conflict-free); one thread per
// key channel n runs the cumulative log-decay in token order; then the
// strictly-lower C x C matrix, the C outputs and the N x N state update are
// plain loops over shared memory, separated by __syncthreads().  Only B * H
// of the 132 SMs work (40 at rwkv6-3b, batch 1).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS) wkv6_kernel(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ w,
    const T* __restrict__ u, const float* __restrict__ s0,
    T* __restrict__ out, float* __restrict__ s_fin, int S, int H, int N,
    int C) {
  extern __shared__ float smem[];
  const int LD = N + 1;
  float* st = smem;              // [N][N] state
  float* r_s = st + N * N;       // [C][LD] raw r
  float* k_s = r_s + C * LD;     // raw k
  float* v_s = k_s + C * LD;
  float* w_s = v_s + C * LD;
  float* rt = w_s + C * LD;      // r * exp(lp - lw)
  float* kt = rt + C * LD;       // k * exp(-lp)
  float* a_s = kt + C * LD;      // [C][C] strictly lower r~ k~^T
  float* dg = a_s + C * C;       // [C] sum(r * u * k)
  float* u_s = dg + C;           // [N]
  float* dec = u_s + N;          // [N] exp(lp[C-1])

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const size_t row = static_cast<size_t>(H) * N;
  const size_t base = static_cast<size_t>(b) * S * row + h * N;
  const size_t sbase = static_cast<size_t>(bh) * N * N;

  for (int idx = tid; idx < N * N; idx += THREADS) st[idx] = s0[sbase + idx];
  for (int n = tid; n < N; n += THREADS) u_s[n] = to_f(u[h * N + n]);

  for (int c0 = 0; c0 < S; c0 += C) {
    __syncthreads();   // the last chunk's state update is done
    for (int idx = tid; idx < C * N; idx += THREADS) {
      const int t = idx / N;
      const int n = idx - t * N;
      const size_t g = base + static_cast<size_t>(c0 + t) * row + n;
      r_s[t * LD + n] = to_f(r[g]);
      k_s[t * LD + n] = to_f(k[g]);
      v_s[t * LD + n] = to_f(v[g]);
      w_s[t * LD + n] = to_f(w[g]);
    }
    __syncthreads();
    for (int n = tid; n < N; n += THREADS) {
      float lp = 0.f;
      for (int t = 0; t < C; ++t) {
        const float lw = logf(fmaxf(w_s[t * LD + n], 1e-30f));
        lp += lw;
        rt[t * LD + n] = r_s[t * LD + n] * expf(lp - lw);
        kt[t * LD + n] = k_s[t * LD + n] * expf(-lp);
      }
      dec[n] = expf(lp);
    }
    __syncthreads();
    for (int idx = tid; idx < C * C; idx += THREADS) {
      const int t = idx / C;
      const int s = idx - t * C;
      float a = 0.f;
      if (s < t)
        for (int n = 0; n < N; ++n) a = fmaf(rt[t * LD + n], kt[s * LD + n], a);
      a_s[idx] = a;
    }
    for (int t = tid; t < C; t += THREADS) {
      float d = 0.f;
      for (int n = 0; n < N; ++n)
        d = fmaf(r_s[t * LD + n] * u_s[n], k_s[t * LD + n], d);
      dg[t] = d;
    }
    __syncthreads();
    for (int idx = tid; idx < C * N; idx += THREADS) {
      const int t = idx / N;
      const int m = idx - t * N;
      float inter = 0.f;
      for (int n = 0; n < N; ++n) inter = fmaf(rt[t * LD + n], st[n * N + m], inter);
      float intra = 0.f;
      for (int s = 0; s < t; ++s) intra = fmaf(a_s[t * C + s], v_s[s * LD + m], intra);
      out[base + static_cast<size_t>(c0 + t) * row + m] =
          from_f<T>(inter + intra + dg[t] * v_s[t * LD + m]);
    }
    __syncthreads();   // every read of the old state is done
    for (int idx = tid; idx < N * N; idx += THREADS) {
      const int n = idx / N;
      const int m = idx - n * N;
      float kv = 0.f;
      for (int t = 0; t < C; ++t) kv = fmaf(kt[t * LD + n], v_s[t * LD + m], kv);
      st[idx] = dec[n] * (st[idx] + kv);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < N * N; idx += THREADS) s_fin[sbase + idx] = st[idx];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const float* s0, void* out, float* s_fin, int B,
           int S, int H, int N, int C, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_kernel<T><<<B * H, THREADS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), s0, static_cast<T*>(out), s_fin, S, H, N, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, w, out (B, S, H, N) and u (H, N), contiguous, of one dtype:
// float32 (bf16 == 0) or bfloat16 (bf16 == 1); s0, s_fin (B, H, N, N)
// float32.  C divides S; smem from the wrapper (kernels/rwkv6/ops.py
// smem_bytes).  Launch on `stream`; returns the CUDA error code (0 =
// launched).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const float* s0,
                           void* out, float* s_fin, int bf16, int B, int S,
                           int H, int N, int C, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(r, k, v, w, u, s0, out, s_fin, B, S, H, N, C,
                                 smem, st);
  return launch<float>(r, k, v, w, u, s0, out, s_fin, B, S, H, N, C, smem,
                       st);
}
