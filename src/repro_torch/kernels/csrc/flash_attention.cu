// Causal / sliding-window flash attention with an online softmax, GQA-aware.
//
// Replaces the Pallas TPU kernel _flash_kernel / flash_attention_bhsd
// (src/repro/kernels/flash_attention/kernel.py:20-98) together with the
// KV-head repeat of its wrapper (flash_attention/ops.py:32-35).
//
// What it computes, per query row, exactly as the TPU kernel: scores
// s = (q . k) * scale in fp32 over key tiles of bk = min(128, S) keys;
// masked scores are -1e30 (not -inf); a running max m, sum l and fp32
// accumulator acc with m_new = max(m, rowmax(s)), p = exp(s - m_new),
// alpha = exp(m - m_new), l = alpha * l + sum(p), acc = acc * alpha +
// round(p) @ v, where round(p) is p cast to v's dtype (bf16 rounds it, as
// the TPU kernel's p.astype(v.dtype) does); out = acc / max(l, 1e-30) cast
// to q's dtype.  The key tile size is the TPU kernel's, because the running
// max at which p is rounded depends on it.
//
// Differences in the launch, not in the function: query head h reads KV
// head h / (H / Hkv) in place (no repeated K/V in memory); q, k, v and out
// are read and written in their public (B, S, heads, dh) layout; key tiles
// that are masked for every row of a block are skipped.  Skipping is exact:
// a tile after a row's last visible key adds p = 0 with alpha = 1, and a
// tile before its first visible key is wiped by alpha = exp(-1e30 - m) = 0
// once a visible key arrives.
//
// What bounds it on an H100: ~2 * B * H * S^2 * dh operations (causal)
// against q, k, v, out read and written once, ~1,500 flop/byte at the
// phi4-mini shape (S 4096, dh 128): operations.  This first version does
// its products on the CUDA cores in fp32 (a bf16 product is exact in fp32),
// not on the tensor cores, so it runs far from the 989 TFLOP/s bf16 bound.
//
// Design: grid (ceil(S / 64), B * H), 256 threads.  A block owns 64 query
// rows (in shared memory for the whole key loop) and walks the key tiles:
// the tile's K and V (fp32, rows padded by one float so column reads are
// conflict-free) go to shared memory, each thread computes a 4 x 8 patch of
// scores (4 rows, 8 key columns 16 apart), the row max and sum are shuffles
// over the 16 lanes that share a row, the rounded p goes to shared memory,
// and each thread accumulates a 4 x (dh / 16) patch of the output.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK_MAX = 128;    // key rows per tile: the TPU kernel's block_k
constexpr int THREADS = 256;   // 16 x 16: ty owns 4 rows, tx 8 key columns
constexpr float MASKED = -1e30f;

__device__ __forceinline__ float row_max16(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int S, int H, int Hkv,
    int bk, int causal, int window, float scale) {
  constexpr int LD = DH + 1;
  constexpr int LDP = BK_MAX + 1;
  constexpr int DC = DH / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                   // [BQ][LD]
  float* k_s = q_s + BQ * LD;          // [BK_MAX][LD]
  float* v_s = k_s + BK_MAX * LD;      // [BK_MAX][LD]
  float* p_s = v_s + BK_MAX * LD;      // [BQ][LDP]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t q_row = static_cast<size_t>(H) * DH;
  const size_t kv_row = static_cast<size_t>(Hkv) * DH;
  const T* qb = q + static_cast<size_t>(b) * S * q_row + h * DH;
  const T* kb = k + static_cast<size_t>(b) * S * kv_row + hk * DH;
  const T* vb = v + static_cast<size_t>(b) * S * kv_row + hk * DH;
  T* ob = o + static_cast<size_t>(b) * S * q_row + h * DH;

  for (int idx = tid; idx < BQ * DH; idx += THREADS) {
    const int r = idx / DH;
    const int d = idx - r * DH;
    q_s[r * LD + d] =
        q0 + r < S ? to_f(qb[static_cast<size_t>(q0 + r) * q_row + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASKED;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // the key tiles holding a visible key for some row of this block
  const int q_last = min(q0 + BQ, S) - 1;
  int kt_end = S / bk;
  if (causal) kt_end = min(kt_end, q_last / bk + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / bk;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * bk;
    __syncthreads();   // q_s written; the last tile's k_s, v_s, p_s read
    for (int idx = tid; idx < bk * DH; idx += THREADS) {
      const int r = idx / DH;
      const int d = idx - r * DH;
      const size_t g = static_cast<size_t>(k0 + r) * kv_row + d;
      k_s[r * LD + d] = to_f(kb[g]);
      v_s[r * LD + d] = to_f(vb[g]);
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int c = 0; c < 8; ++c) kv[c] = k_s[(tx + 16 * c) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = tx + 16 * c;
        const int kpos = k0 + col;
        float x;
        if (col >= bk) {
          x = -INFINITY;   // no key here (S < 128: the tile is S keys)
        } else {
          const bool visible = (!causal || kpos <= qpos) &&
                               (window == 0 || kpos > qpos - window);
          x = visible ? s[i][c] * scale : MASKED;
        }
        s[i][c] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float p = expf(s[i][c] - m_new);
        sum += p;
        p_s[(ty * 4 + i) * LDP + tx + 16 * c] = to_f(from_f<T>(p));
      }
      alpha[i] = expf(m[i] - m_new);
      l[i] = alpha[i] * l[i] + row_sum16(sum);
      m[i] = m_new;
    }
    __syncthreads();

    float pv[4][DC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c) pv[i][c] = 0.f;
    for (int kk = 0; kk < bk; ++kk) {
      float pr[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = p_s[(ty * 4 + i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = v_s[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) pv[i][c] = fmaf(pr[i], vv[c], pv[i][c]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] = acc[i][c] * alpha[i] + pv[i][c];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      ob[static_cast<size_t>(row) * q_row + tx + 16 * c] =
          from_f<T>(acc[i][c] / denom);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int Hkv, int bk, int causal, int window, float scale,
           int smem, cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, Hkv, bk, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(int dh, const void* q, const void* k, const void* v, void* o,
              int B, int S, int H, int Hkv, int bk, int causal, int window,
              float scale, int smem, cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, S, H, Hkv, bk, causal, window,
                           scale, smem, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, S, H, Hkv, bk, causal, window,
                           scale, smem, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, H, Hkv, bk, causal, window,
                            scale, smem, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, S, H, dh), k and v (B, S, Hkv, dh), o like q, all contiguous, of
// one dtype: float32 (bf16 == 0) or bfloat16 (bf16 == 1).  dh is 32, 64 or
// 128; bk = min(128, S) divides S; smem from the wrapper
// (kernels/flash_attention/ops.py smem_bytes).  Launch on `stream`; returns
// the CUDA error code (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int bf16, int B,
                                      int S, int H, int Hkv, int dh, int bk,
                                      int causal, int window, float scale,
                                      int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_dh<__nv_bfloat16>(dh, q, k, v, o, B, S, H, Hkv, bk, causal,
                                    window, scale, smem, st);
  return launch_dh<float>(dh, q, k, v, o, B, S, H, Hkv, bk, causal, window,
                          scale, smem, st);
}
