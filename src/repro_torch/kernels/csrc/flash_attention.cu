// Causal / sliding-window flash attention with an online softmax, GQA-aware:
// a bfloat16 kernel on Hopper's tensor cores (wgmma, fed by TMA) and a
// float32 kernel on the CUDA cores.
//
// Replaces the Pallas TPU kernel _flash_kernel / flash_attention_bhsd
// (src/repro/kernels/flash_attention/kernel.py:20-98) together with the
// KV-head repeat of its wrapper (flash_attention/ops.py:32-35).
//
// What both compute, per query row, exactly as the TPU kernel: scores
// s = (q . k) * scale in fp32 over key tiles of bk = min(128, S) keys;
// masked scores are -1e30 (not -inf); a running max m, sum l and fp32
// accumulator acc with m_new = max(m, rowmax(s)), p = exp(s - m_new),
// alpha = exp(m - m_new), l = alpha * l + sum(p), acc = acc * alpha +
// round(p) @ v, where round(p) is p cast to v's dtype (bf16 rounds it, as
// the TPU kernel's p.astype(v.dtype) does); out = acc / max(l, 1e-30) cast
// to q's dtype.  The key tile size is the TPU kernel's, because the running
// max at which p is rounded depends on it.  The bf16 kernel takes exp(x) as
// exp2f(x * log2(e)), which moves p by about one fp32 ulp.
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
// phi4-mini shape (B 1, S 4096, H 24 over 8 KV heads, dh 128): operations,
// 103 GFLOP, 0.104 ms at the 989 TFLOP/s of bf16 on the tensor cores.
//
// bfloat16 design (flash_attention_tc_kernel): grid (B * H, ceil(S / 128)),
// 384 threads in three warpgroups; a block owns 128 query rows of one
// (b, h).  What it does about each cause of the CUDA-core kernel's slowness:
// - products on the tensor cores: S = Q K^T is wgmma.m64n128k16 with Q and
//   K read from shared memory; O += P V is wgmma with P as the register A
//   operand and V from shared memory (transposed-B form, V is keys x dh).
//   The fp32 S accumulator is converted in registers to P's bf16 A
//   fragment, which is exactly the TPU kernel's rounding of p.
// - latency hidden: one producer warpgroup (its registers lowered with
//   setmaxnreg) issues TMA loads of K and V tiles into a 2-stage ring with
//   full and empty mbarriers; two consumer warpgroups of 64 query rows each
//   (registers raised) run the products and the softmax, so one
//   consumer's softmax overlaps the other's products.
// - asynchronous copies: Q is loaded once, K and V tile by tile, by TMA
//   (bf16, 128-byte swizzle, or 64-byte at dh 32; the wgmma shared-memory
//   descriptors use the same swizzle).  Loads of tile j + 1 overlap the
//   math of tile j.  TMA zero-fills rows past S; key columns past bk
//   (S < 128) get -inf, so they add exactly 0; query rows past S are not
//   stored.
// - causal balance: blockIdx.y walks the query blocks from the last (the
//   most key tiles) to the first, so the short blocks fill the tail.
// Shared memory at dh 128: Q 32 KB + 2 x (K 32 KB + V 32 KB) = 160 KB.
//
// float32 design (flash_attention_fp32_kernel): grid (ceil(S / 64), B * H),
// 256 threads.  A block owns 64 query rows (in shared memory for the whole
// key loop) and walks the key tiles: the tile's K and V (rows padded by one
// float so column reads are conflict-free) go to shared memory, each thread
// computes a 4 x 8 patch of scores (4 rows, 8 key columns 16 apart), the
// row max and sum are shuffles over the 16 lanes that share a row, p goes
// to shared memory, and each thread accumulates a 4 x (dh / 16) patch of
// the output.  Its products stay in fp32 on the CUDA cores: TF32 tensor
// cores would not hold the float32 path's tolerance.
#include <cuda.h>   // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel
// ---------------------------------------------------------------------------
namespace fp32 {

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

template <int DH>
__global__ void __launch_bounds__(THREADS) flash_attention_fp32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int S, int H, int Hkv,
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
  const float* qb = q + static_cast<size_t>(b) * S * q_row + h * DH;
  const float* kb = k + static_cast<size_t>(b) * S * kv_row + hk * DH;
  const float* vb = v + static_cast<size_t>(b) * S * kv_row + hk * DH;
  float* ob = o + static_cast<size_t>(b) * S * q_row + h * DH;

  for (int idx = tid; idx < BQ * DH; idx += THREADS) {
    const int r = idx / DH;
    const int d = idx - r * DH;
    q_s[r * LD + d] =
        q0 + r < S ? qb[static_cast<size_t>(q0 + r) * q_row + d] : 0.f;
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
      k_s[r * LD + d] = kb[g];
      v_s[r * LD + d] = vb[g];
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
        p_s[(ty * 4 + i) * LDP + tx + 16 * c] = p;
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
          acc[i][c] / denom;
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int Hkv, int bk, int causal, int window, float scale,
           int smem, cudaStream_t stream) {
  auto kern = flash_attention_fp32_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, Hkv, bk,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fp32

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel
// ---------------------------------------------------------------------------
namespace tc {

constexpr int BQ = 128;        // query rows per block: two consumers of 64
constexpr int BKT = 128;       // key rows of a shared-memory tile (>= bk)
constexpr int NST = 2;         // stages of the K/V ring
constexpr int THREADS = 384;   // producer + two consumer warpgroups
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// The shared-memory layout of one block.  A 128-row tile of q, k or v is
// stored as NCH chunks of ROWB-byte rows, each chunk one TMA box, swizzled
// with a ROWB-byte pattern (128 bytes, or 64 at dh 32) that the wgmma
// descriptors name too.  Tiles start on 1024-byte boundaries, the period
// of the 128-byte swizzle.
template <int DH>
struct Layout {
  static constexpr int ROWB = DH * 2 < 128 ? DH * 2 : 128;
  static constexpr int NCH = DH * 2 / ROWB;
  static constexpr int CHUNK = BKT * ROWB;     // bytes of one chunk
  static constexpr int TILE = NCH * CHUNK;     // bytes of one tile
  static constexpr int K_OFF = TILE;           // Q at 0
  static constexpr int V_OFF = K_OFF + NST * TILE;
  static constexpr int BAR_OFF = V_OFF + NST * TILE;
  // barriers: Q full, then K full, V full and K/V empty for each stage.
  // At least half an SM's shared memory, so that one block runs per SM:
  // the consumers' setmaxnreg.inc takes the registers the producer frees.
  static constexpr int NEED = 1024 + BAR_OFF + 8 * (1 + 3 * NST);
  static constexpr int SMEM = NEED > 120 * 1024 ? NEED : 120 * 1024;
  static constexpr uint64_t SWIZZLE = ROWB == 128 ? 1 : 2;   // descriptor
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// one arrival that also announces `bytes` of TMA traffic to the barrier
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait for the phase of the given parity to complete.  A wait that lasts
// millions of polls means a lost arrival: trap rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1u << 24)) __trap();
  }
}

// TMA: one box of a 4-D tensor map (coordinates innermost first) into
// shared memory, completion counted in bytes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle mode
template <int DH>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | Layout<DH>::SWIZZLE << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keep the compiler from moving reads of wgmma accumulators across waits
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 128, fp32) (+)= A (64 x 16) * B (16 x 128), both from shared
// memory, both K-major; accumulate == 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 32, fp32) += A (64 x 16, bf16 pairs in registers) * B (16 x
// 32, shared memory, MN-major: the transposed-B form)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 pairs in registers) * B (16 x
// 64, shared memory, MN-major: the transposed-B form)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 pairs in registers) * B (16 x
// 128, shared memory, MN-major: the transposed-B form)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&d)[DH / 2], const uint32_t* a,
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<32>(float (&d)[16], const uint32_t* a,
                                             uint64_t db) {
  wgmma_rs_n32(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&d)[32], const uint32_t* a,
                                             uint64_t db) {
  wgmma_rs_n64(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&d)[64],
                                              const uint32_t* a, uint64_t db) {
  wgmma_rs_n128(d, a, db);
}

// Register layout of a 64 x N wgmma accumulator d in a consumer warpgroup:
// warp w, lane l holds rows r0 = 16w + l/4 (d[4i], d[4i+1]) and r0 + 8
// (d[4i+2], d[4i+3]), columns 8i + 2(l%4) and 8i + 2(l%4) + 1.  The bf16
// A fragment of k-step kk of P V is then {d[8kk..8kk+1], d[8kk+2..+3],
// d[8kk+4..+5], d[8kk+6..+7]} as pairs: the conversion is in place.
template <int DH>
__global__ void __launch_bounds__(THREADS, 1) flash_attention_tc_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
    int S, int H, int Hkv, int bk, int causal, int window, float scale) {
  using L = Layout<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t bars = base + L::BAR_OFF;
  const uint32_t q_full = bars;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first

  // the key tiles holding a visible key for some row of this block
  const int q_last = min(q0 + BQ, S) - 1;
  int kt_end = S / bk;
  if (causal) kt_end = min(kt_end, q_last / bk + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / bk;
  const int n_tiles = kt_end - kt_begin;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < NST; ++st) {
      mbar_init(bars + 8 * (1 + st), 1);              // K full
      mbar_init(bars + 8 * (1 + NST + st), 1);        // V full
      mbar_init(bars + 8 * (1 + 2 * NST + st), 2);    // K/V empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::TILE);
      for (int ch = 0; ch < L::NCH; ++ch)
        tma_load(q_s + ch * L::CHUNK, &tq, q_full, ch * (L::ROWB / 2), h, q0,
                 b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % NST;
        const uint32_t ph = (j / NST) & 1;
        const int k0 = (kt_begin + j) * bk;
        const uint32_t k_full = bars + 8 * (1 + st);
        const uint32_t v_full = bars + 8 * (1 + NST + st);
        const uint32_t k_s = base + L::K_OFF + st * L::TILE;
        const uint32_t v_s = base + L::V_OFF + st * L::TILE;
        mbar_wait(bars + 8 * (1 + 2 * NST + st), ph ^ 1);   // stage free
        mbar_expect_tx(k_full, L::TILE);
        for (int ch = 0; ch < L::NCH; ++ch)
          tma_load(k_s + ch * L::CHUNK, &tk, k_full, ch * (L::ROWB / 2), hk,
                   k0, b);
        mbar_expect_tx(v_full, L::TILE);
        for (int ch = 0; ch < L::NCH; ++ch)
          tma_load(v_s + ch * L::CHUNK, &tv, v_full, ch * (L::ROWB / 2), hk,
                   k0, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int c = wg - 1;
    const int t = threadIdx.x & 127;
    const int lane = t & 31;
    const int r0 = q0 + 64 * c + 16 * (t >> 5) + (lane >> 2);
    const int cq = 2 * (lane & 3);
    const int row_first = q0 + 64 * c;
    const int row_last = row_first + 63;
    const uint32_t q_c = q_s + c * 64 * L::ROWB;

    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    float m0 = MASKED, m1 = MASKED, l0 = 0.f, l1 = 0.f;
    float s[BKT / 2];
    uint32_t pf[BKT / 4];   // p as bf16 pairs: the A fragments of P V

    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % NST;
      const uint32_t ph = (j / NST) & 1;
      const int k0 = (kt_begin + j) * bk;
      const uint32_t k_s = base + L::K_OFF + st * L::TILE;
      const uint32_t v_s = base + L::V_OFF + st * L::TILE;

      // S = Q K^T, dh / 16 k-steps of 16 (32 bytes of a swizzled row)
      mbar_wait(bars + 8 * (1 + st), ph);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t off = (kk * 32 / L::ROWB) * L::CHUNK + kk * 32 % L::ROWB;
        wgmma_ss_n128(s, desc<DH>(q_c + off, 16, 8 * L::ROWB),
                      desc<DH>(k_s + off, 16, 8 * L::ROWB), kk > 0);
      }
      wg_commit();
      wg_wait_all();
      pin(s);

#pragma unroll
      for (int i = 0; i < BKT / 2; ++i) s[i] *= scale;
      // the mask, only where this consumer's rows see a masked key
      const bool edge = bk < BKT || (causal && k0 + bk - 1 > row_first) ||
                        (window > 0 && k0 <= row_last - window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < BKT / 2; ++i) {
          const int col = 8 * (i / 4) + cq + (i & 1);
          const int qpos = r0 + 8 * ((i >> 1) & 1);
          const int kpos = k0 + col;
          const bool visible = (!causal || kpos <= qpos) &&
                               (window == 0 || kpos > qpos - window);
          s[i] = col >= bk ? -INFINITY : (visible ? s[i] : MASKED);
        }
      }

      // online softmax over the two rows this thread holds; a row's 128
      // columns are spread over the 4 lanes of a quad
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < BKT / 8; ++i) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = exp2f((m0 - mn0) * LOG2E);
      const float a1 = exp2f((m1 - mn1) * LOG2E);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < BKT / 8; ++i) {
        const float p0 = exp2f((s[4 * i] - mn0) * LOG2E);
        const float p1 = exp2f((s[4 * i + 1] - mn0) * LOG2E);
        const float p2 = exp2f((s[4 * i + 2] - mn1) * LOG2E);
        const float p3 = exp2f((s[4 * i + 3] - mn1) * LOG2E);
        sum0 += p0 + p1;
        sum1 += p2 + p3;
        pf[2 * i] = pack_bf16(p0, p1);
        pf[2 * i + 1] = pack_bf16(p2, p3);
      }
      // per-lane partial sums; the quad's lanes are added at the end
      l0 = a0 * l0 + sum0;
      l1 = a1 * l1 + sum1;
#pragma unroll
      for (int i = 0; i < DH / 8; ++i) {
        acc[4 * i] *= a0;
        acc[4 * i + 1] *= a0;
        acc[4 * i + 2] *= a1;
        acc[4 * i + 3] *= a1;
      }

      // O += P V, 8 k-steps of 16 keys (16 swizzled rows of V)
      mbar_wait(bars + 8 * (1 + NST + st), ph);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BKT / 16; ++kk)
        wgmma_pv<DH>(acc, &pf[4 * kk],
                     desc<DH>(v_s + kk * 16 * L::ROWB, L::CHUNK,
                              8 * L::ROWB));
      wg_commit();
      wg_wait_all();
      pin(acc);
      if (t == 0) mbar_arrive(bars + 8 * (1 + 2 * NST + st));   // stage free
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    const size_t q_row = static_cast<size_t>(H) * DH;
    __nv_bfloat16* ob = o + static_cast<size_t>(b) * S * q_row + h * DH + cq;
    if (r0 < S) {
#pragma unroll
      for (int i = 0; i < DH / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(ob + r0 * q_row + 8 * i) =
            __floats2bfloat162_rn(acc[4 * i] / d0, acc[4 * i + 1] / d0);
    }
    if (r0 + 8 < S) {
#pragma unroll
      for (int i = 0; i < DH / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(ob + (r0 + 8) * q_row + 8 * i) =
            __floats2bfloat162_rn(acc[4 * i + 2] / d1, acc[4 * i + 3] / d1);
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime when first
// needed, so that the library needs no -lcuda at link time
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a (B, S, heads, dh) bf16 tensor, innermost first: (dh, heads,
// S, B); the box is one ROWB-byte chunk of a head's row, 128 rows.
template <int DH>
CUresult make_map(CUtensorMap* map, EncodeTiled encode, const void* ptr,
                  int B, int S, int heads) {
  using L = Layout<DH>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(DH),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 2ull * DH;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {L::ROWB / 2, 1, BKT, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                L::ROWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                               : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int Hkv, int bk, int causal, int window, float scale,
           int smem, cudaStream_t stream) {
  if (smem != Layout<DH>::SMEM) return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  if (make_map<DH>(&tq, encode, q, B, S, H) != CUDA_SUCCESS ||
      make_map<DH>(&tk, encode, k, B, S, Hkv) != CUDA_SUCCESS ||
      make_map<DH>(&tv, encode, v, B, S, Hkv) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_attention_tc_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem, stream>>>(tq, tk, tv,
                                        static_cast<__nv_bfloat16*>(o), S, H,
                                        Hkv, bk, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

#define FLASH_DISPATCH(NS)                                                     \
  switch (dh) {                                                                \
    case 32:                                                                   \
      return NS::launch<32>(q, k, v, o, B, S, H, Hkv, bk, causal, window,      \
                            scale, smem, static_cast<cudaStream_t>(stream));   \
    case 64:                                                                   \
      return NS::launch<64>(q, k, v, o, B, S, H, Hkv, bk, causal, window,      \
                            scale, smem, static_cast<cudaStream_t>(stream));   \
    case 128:                                                                  \
      return NS::launch<128>(q, k, v, o, B, S, H, Hkv, bk, causal, window,     \
                             scale, smem, static_cast<cudaStream_t>(stream));  \
    default:                                                                   \
      return static_cast<int>(cudaErrorInvalidValue);                          \
  }

// q (B, S, H, dh), k and v (B, S, Hkv, dh), o like q, all contiguous.  dh is
// 32, 64 or 128; bk = min(128, S) divides S; smem from the wrapper
// (kernels/flash_attention/ops.py smem_bytes).  Launch on `stream`; returns
// the CUDA error code (0 = launched).
//
// bfloat16, on the tensor cores; the tensors 16-byte aligned (TMA).
extern "C" int flash_attention_bf16_launch(const void* q, const void* k,
                                           const void* v, void* o, int B,
                                           int S, int H, int Hkv, int dh,
                                           int bk, int causal, int window,
                                           float scale, int smem,
                                           void* stream) {
  FLASH_DISPATCH(tc)
}

// float32, on the CUDA cores.
extern "C" int flash_attention_fp32_launch(const void* q, const void* k,
                                           const void* v, void* o, int B,
                                           int S, int H, int Hkv, int dh,
                                           int bk, int causal, int window,
                                           float scale, int smem,
                                           void* stream) {
  FLASH_DISPATCH(fp32)
}
