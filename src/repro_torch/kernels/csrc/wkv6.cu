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
// N 64, C 32 in bf16: the fp32 operations, by about 2x.  But the chunks of
// a head are a chain through S, 128 links at S = 4096: what a design has
// to fight is the time of one link, and the SMs the chain leaves idle.
//
// Design: two launches on one stream.
//   * The chunk pass (wkv6_chunk_kernel) does everything that does not
//     read S, for every (batch, head, chunk) in parallel (5120 blocks at
//     rwkv6-3b, S = 4096): the cumulative log-decay, split over up to 256
//     threads (a channel and a part of the chunk each, the parts' sums
//     added in order), r~, k~, the chunk's decay, A = strict_tril(r~ k~^T), the
//     chunk's own output y = A v + sum(r u k) v and its state increment
//     k~^T v.  It writes r~, y, k~^T v and the decay in fp32 (33.5 KB a
//     chunk at N 64).
//   * The state pass (wkv6_state_kernel) walks the chain, which is left
//     with one product and an elementwise update a link: out = r~ S + y,
//     and S = decay * (S + k~^T v).  Every term of out[:, m] and S[:, m]
//     is linear in column m of S, so each group of kMb = 16 value columns
//     of a head runs on a block of its own: B * H * N / 16 blocks, 160 at
//     rwkv6-3b, batch 1 (40 with one block a head).  The product and the
//     update read the same S and nothing of each other, so they run side
//     by side (warps 0-3 a 16 x 8 output tile each, warps 4-7 the next S,
//     into a second buffer): one block barrier a link.  S is kept beside
//     its TF32 high and low parts, split once by the update that writes
//     them.  The next chunks' inputs stream into a 3-stage shared-memory
//     ring meanwhile: the chunk pass lays its scratch out as a stage, so a
//     stage is three bulk copies (TMA) counted by an mbarrier.
//   * Products on the tensor cores: mma.sync m16n8k8 in TF32 with the
//     3xTF32 split (x = hi + lo, both TF32; a b ~ a_lo b_hi + a_hi b_lo +
//     a_hi b_hi), which keeps about fp32 accuracy: single-pass TF32 rounds
//     each operand to 2^-11 and compounds over the chain of state updates
//     (tests/test_torch_partitions.py).  The small and the large terms go
//     to separate accumulators, and a warp runs the tiles that share an
//     operand together, splitting it once.
//   * A chunk shorter than 32 tokens (C divides S) is padded with zero
//     rows, which add nothing to any product.
//   * Head sizes: every multiple of 16 whose state-pass block fits shared
//     memory, 16 to 192 (WKV6_HEAD_SIZES), on the one-block passes; every
//     multiple of 16 past 192 on the cluster passes below, which split a
//     head's channels and state rows over a cluster of blocks (past 1024
//     over several clusters, whose parts a third launch adds).  The wrapper
//     zero-pads any other head (rwkv6/ops.py pad_heads, w padded with 1): to
//     a multiple of 16 up to 256, of 64 above.
//   * Element types: float32, bfloat16 and float16 in and out (the state
//     and every intermediate float32), one instantiation of each kernel per
//     type; the wrapper casts w and u to r's type, as the TPU kernel's
//     wrapper does.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "cluster.cuh"
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kCp = 32;        // tokens of a chunk, padded
constexpr int kMb = 16;        // value columns of a state-pass block
constexpr int kStages = 3;     // the state pass's ring of chunks
constexpr int kLdA = kCp + 4;  // A rows: A-operand reads hit 32 banks
constexpr int kLdY = kMb + 8;  // S rows: B-operand reads hit 32 banks
constexpr int kSmemMax = 232448;  // an H100 block's dynamic shared memory

// The head sizes the library is built for (ops.HEAD_SIZES).
#define WKV6_HEAD_SIZES(X) \
  X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128) X(144) X(160) X(176) X(192)

// The chunk pass's scan splits a chunk into parts, a thread per (channel,
// part): the most parts, a power of two so that they divide the chunk,
// whose threads fit the block.
__host__ __device__ constexpr int scan_parts(int n) {
  int p = 1;
  while (2 * p * n <= kThreads && 2 * p <= kCp) p *= 2;
  return p;
}

// Row tiles of k~^T v a warp takes in one call, sharing its v tile: the
// largest of 4, 3, 2, 1 that divides the head's groups of 16 rows.
__host__ __device__ constexpr int kv_tiles(int groups) {
  return groups % 4 == 0 ? 4 : groups % 3 == 0 ? 3 : groups % 2 == 0 ? 2 : 1;
}

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d += a b for one m16n8k8 TF32 tile.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// kTiles 16 x 8 tile products that share their B operand, over k_steps
// k-steps of 8, in 3xTF32: d[i] += A_i B, A_i(row, k) = a[i * a_tile +
// row * lda + k] (kTransA: a[i * a_tile + k * lda + row]), B(k, col) =
// b[k * ldb + col] (kTransB: b[col * ldb + k]), all in shared memory; with
// b_lo, b holds B's TF32 high parts and b_lo its low parts, already split.
// A k-step splits each operand into TF32 parts x = hi + lo and adds
// a_lo b_hi + a_hi b_lo to one accumulator and a_hi b_hi to another; each
// tile's accumulators meet at the end, so no product waits for the one
// before it on the same tile.  The fragments are the PTX ISA's for
// m16n8k8 .tf32: lane = 4 g + t holds A(g, t), A(g + 8, t), A(g, t + 4),
// A(g + 8, t + 4), B(t, g), B(t + 4, g).
template <int kTiles, bool kTransA, bool kTransB>
__device__ __forceinline__ void tiles_3xtf32(float (&d)[kTiles][4],
                                             const float* a, int a_tile,
                                             int lda, const float* b,
                                             const float* b_lo, int ldb,
                                             int k_steps, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int a_idx[4] = {
      kTransA ? t * lda + g : g * lda + t,
      kTransA ? t * lda + g + 8 : (g + 8) * lda + t,
      kTransA ? (t + 4) * lda + g : g * lda + t + 4,
      kTransA ? (t + 4) * lda + g + 8 : (g + 8) * lda + t + 4};
  const int b_idx[2] = {kTransB ? g * ldb + t : t * ldb + g,
                        kTransB ? g * ldb + t + 4 : (t + 4) * ldb + g};
  const int a_step = kTransA ? 8 * lda : 8;
  const int b_step = kTransB ? 8 : 8 * ldb;
  float hi[kTiles][4] = {}, lo[kTiles][4] = {};
#pragma unroll 2
  for (int kk = 0; kk < k_steps; ++kk) {
    unsigned bh[2], bl[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int bi = kk * b_step + b_idx[j];
      if (b_lo) {
        bh[j] = __float_as_uint(b[bi]);
        bl[j] = __float_as_uint(b_lo[bi]);
      } else {
        split_tf32(b[bi], bh[j], bl[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      unsigned ah[4], al[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split_tf32(a[i * a_tile + kk * a_step + a_idx[j]], ah[j], al[j]);
      mma_tf32(lo[i], al, bh);
      mma_tf32(lo[i], ah, bl);
      mma_tf32(hi[i], ah, bh);
    }
  }
#pragma unroll
  for (int i = 0; i < kTiles; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[i][e] += hi[i][e] + lo[i][e];
}

// The (row, col) of accumulator element e of lane's 16 x 8 tile fragment.
__device__ __forceinline__ int frag_row(int lane, int e) {
  return (lane >> 2) + (e >> 1) * 8;
}
__device__ __forceinline__ int frag_col(int lane, int e) {
  return 2 * (lane & 3) + (e & 1);
}

// ---------------------------------------------------------------------------
// the chunk pass: one block per (batch, head, chunk)
// ---------------------------------------------------------------------------

template <int N>
struct ChunkSmem {
  static constexpr int kLdK = N + 4;   // r~, k~ rows: A-operand reads
  static constexpr int kLdV = N + 8;   // v rows: B-operand reads
  static constexpr int kParts = scan_parts(N);
  static constexpr int kFloats = 2 * kCp * kLdK   // r~, k~
                                 + kCp * kLdA     // A
                                 + kCp * kLdV     // v
                                 + kCp * N        // r u k
                                 + kParts * N     // scan part sums
                                 + kCp;           // sum(r u k)
  static constexpr int kBytes = 4 * kFloats;
};

// Scratch (written here, read by the state pass), per (batch * head,
// chunk), fp32, laid out as a state-pass ring stage so that a stage is
// three bulk copies: r~ (kCp rows of stride N + 4; rows from C on zero);
// for each group of kMb value columns, y = A v + sum(r u k) v (kCp x kMb)
// then k~^T v (N x kMb); the chunk's decay exp(lp[C-1]) (N).
template <int N>
struct Scratch {
  static constexpr int kRt = 0;
  static constexpr int kGroup0 = kCp * (N + 4);
  static constexpr int kGroupFloats = (kCp + N) * kMb;  // y, then k~^T v
  static constexpr int kDec = kGroup0 + (N / kMb) * kGroupFloats;
  static constexpr int kFloats = kDec + N;  // a chunk's
  // where y at (token t, value column m) and k~^T v at (key channel n,
  // value column m) sit in a chunk's scratch
  static __device__ __forceinline__ int y(int t, int m) {
    return kGroup0 + (m / kMb) * kGroupFloats + t * kMb + m % kMb;
  }
  static __device__ __forceinline__ int kv(int n, int m) {
    return kGroup0 + (m / kMb) * kGroupFloats + kCp * kMb + n * kMb +
           m % kMb;
  }
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads) wkv6_chunk_kernel(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ w,
    const T* __restrict__ u, float* __restrict__ scratch, int S, int H,
    int C) {
  using L = ChunkSmem<N>;
  using G = Scratch<N>;
  constexpr int kLdK = L::kLdK, kLdV = L::kLdV, kParts = L::kParts;
  constexpr int kPer = kCp / kParts;  // tokens of a scan part
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) float smem[];
  float* rt = smem;
  float* kt = rt + kCp * kLdK;
  float* a_s = kt + kCp * kLdK;
  float* vf = a_s + kCp * kLdA;
  float* ruk = vf + kCp * kLdV;
  float* part = ruk + kCp * N;
  float* dg = part + kParts * N;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n_chunks = S / C;
  const int bh = blockIdx.x / n_chunks;
  const int ci = blockIdx.x - bh * n_chunks;
  const int b = bh / H;
  const int h = bh - b * H;
  const size_t row = static_cast<size_t>(H) * N;  // a token's stride
  const size_t base =
      (static_cast<size_t>(b) * S + static_cast<size_t>(ci) * C) * row +
      h * N;
  float* out = scratch + static_cast<size_t>(blockIdx.x) * G::kFloats;

  // -- 1. a channel n and a part q of the chunk per thread (threads from
  //    kParts * N on idle): the inputs, the running sum of log-decays,
  //    r u k --------------------------------------------------------------
  const int n = tid % N;
  const int q = tid / N;
  const bool scans = q < kParts;
  const float un = to_f(u[h * N + n]);
  float lw[kPer], lp[kPer], rv[kPer], kv[kPer];
  if (scans) {
    float run = 0.0f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int t = q * kPer + i;
      const bool in = t < C;
      const size_t gi = base + static_cast<size_t>(t) * row + n;
      lw[i] = in ? logf(fmaxf(to_f(w[gi]), 1e-30f)) : 0.0f;
      rv[i] = in ? to_f(r[gi]) : 0.0f;
      kv[i] = in ? to_f(k[gi]) : 0.0f;
      vf[t * kLdV + n] = in ? to_f(v[gi]) : 0.0f;
      ruk[t * N + n] = rv[i] * un * kv[i];
      run += lw[i];
      lp[i] = run;
    }
    part[q * N + n] = run;
  }
  __syncthreads();

  // -- 2. r~, k~ and the decay, the earlier parts' sums added in order;
  //    sum(r u k) per token ----------------------------------------------
  if (scans) {
    float off = 0.0f;
    for (int p = 0; p < q; ++p) off += part[p * N + n];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int t = q * kPer + i;
      const bool in = t < C;
      const float lpt = off + lp[i];
      const float rtv = in ? rv[i] * expf(lpt - lw[i]) : 0.0f;
      rt[t * kLdK + n] = rtv;
      kt[t * kLdK + n] = in ? kv[i] * expf(-lpt) : 0.0f;
      out[G::kRt + t * kLdK + n] = rtv;
      if (t == C - 1) out[G::kDec + n] = expf(lpt);
    }
  }
  for (int t = warp; t < kCp; t += kWarps) {
    float d = 0.0f;
    for (int nn = lane; nn < N; nn += 32) d += ruk[t * N + nn];
    for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
    if (lane == 0) dg[t] = d;
  }
  __syncthreads();

  // -- 3. A = strict_tril(r~ k~^T): its tiles on or below the diagonal,
  //    (0,0) (0,1) (1,0) (1,1) (1,2) (1,3), one a warp; warps 6 and 7 zero
  //    the two above it.  k~^T v: a warp takes the N / 16 tiles of a
  //    column tile of v, which share it ---------------------------------
  {
    const int at = warp < 2 || warp >= 6 ? 0 : 1;
    const int as = warp < 2 ? warp : (warp < 6 ? warp - 2 : warp - 4);
    float d[1][4] = {};
    if (warp < 6)
      tiles_3xtf32<1, false, true>(d, rt + at * 16 * kLdK, 0, kLdK,
                                   kt + as * 8 * kLdK, nullptr, kLdK, N / 8,
                                   lane);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = at * 16 + frag_row(lane, e);
      const int s = as * 8 + frag_col(lane, e);
      a_s[t * kLdA + s] = s < t ? d[0][e] : 0.0f;
    }
  }
  constexpr int kKvTiles = kv_tiles(N / 16);  // n tiles a call
  for (int mt = warp; mt < N / 8; mt += kWarps) {
    for (int n0 = 0; n0 < N / 16; n0 += kKvTiles) {
      float d[kKvTiles][4] = {};
      tiles_3xtf32<kKvTiles, true, false>(d, kt + n0 * 16, 16, kLdK,
                                          vf + mt * 8, nullptr, kLdV,
                                          kCp / 8, lane);
#pragma unroll
      for (int i = 0; i < kKvTiles; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          out[G::kv((n0 + i) * 16 + frag_row(lane, e),
                    mt * 8 + frag_col(lane, e))] = d[i][e];
    }
  }
  __syncthreads();

  // -- 4. y = A v + sum(r u k) v: a warp takes both row tiles of a column
  //    tile of v ----------------------------------------------------------
  for (int mt = warp; mt < N / 8; mt += kWarps) {
    float d[2][4] = {};
    tiles_3xtf32<2, false, false>(d, a_s, 16 * kLdA, kLdA, vf + mt * 8,
                                  nullptr, kLdV, kCp / 8, lane);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = i * 16 + frag_row(lane, e);
        const int m = mt * 8 + frag_col(lane, e);
        out[G::y(t, m)] = d[i][e] + dg[t] * vf[t * kLdV + m];
      }
  }
}

// ---------------------------------------------------------------------------
// the state pass: one block per (batch, head, group of kMb value columns)
// ---------------------------------------------------------------------------

// A ring stage, fp32, as the chunk's scratch lays it out: r~ (kCp x kLdK),
// the group's y (kCp x kMb) and k~^T v (N x kMb), the chunk's decay (N).
// Beside the ring, twice (the state a link reads, and the one it writes):
// S and its TF32 high and low parts, N x kLdY each; then an mbarrier a
// stage.
template <int N>
struct StateSmem {
  static constexpr int kLdK = N + 4;
  static constexpr int kStageFloats = kCp * kLdK + (kCp + N) * kMb + N;
  static constexpr int kStateFloats = 3 * N * kLdY;
  static constexpr int kFloats = kStages * kStageFloats + 2 * kStateFloats;
  static constexpr int kBytes = 4 * kFloats + 8 * kStages;
};

// cp.async.bulk: `bytes` (a multiple of 16) from global `src` to shared
// `dst`, both 16-byte aligned, counted against the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 2) wkv6_state_kernel(
    const float* __restrict__ scratch, const float* __restrict__ s0,
    T* __restrict__ out, float* __restrict__ s_fin,
    int* __restrict__ block_sm, int S, int H, int C) {
  using L = StateSmem<N>;
  using G = Scratch<N>;
  constexpr int kLdK = L::kLdK;
  constexpr int kGroups = N / kMb;
  extern __shared__ __align__(16) float smem[];
  float* states = smem + kStages * L::kStageFloats;
  unsigned long long* bar =
      reinterpret_cast<unsigned long long*>(states + 2 * L::kStateFloats);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int grp = blockIdx.x % kGroups;
  const int bh = blockIdx.x / kGroups;
  const int b = bh / H;
  const int h = bh - b * H;
  const int m0 = grp * kMb;
  const int n_chunks = S / C;
  const size_t row = static_cast<size_t>(H) * N;  // a token's stride
  const size_t base = static_cast<size_t>(b) * S * row + h * N + m0;
  const size_t sbase = static_cast<size_t>(bh) * N * N;
  if (tid == 0) block_sm[blockIdx.x] = sm_id();  // the launch's record

  // state buffer i: S, then its TF32 high and low parts
  auto state = [&](int i) { return states + (i & 1) * L::kStateFloats; };
  auto set_state = [&](float* sb, int n, int m, float x) {
    unsigned hi, lo;
    split_tf32(x, hi, lo);
    sb[n * kLdY + m] = x;
    sb[N * kLdY + n * kLdY + m] = __uint_as_float(hi);
    sb[2 * N * kLdY + n * kLdY + m] = __uint_as_float(lo);
  };
  for (int idx = tid; idx < N * kMb; idx += kThreads) {
    const int n = idx / kMb, m = idx - n * kMb;
    set_state(state(0), n, m, s0[sbase + n * N + m0 + m]);
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bar[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // one chunk's r~, the group's y and k~^T v, and the decay into a stage:
  // three bulk copies by one thread
  auto prefetch = [&](int ci) {
    if (tid != 0 || ci >= n_chunks) return;
    float* dst = smem + (ci % kStages) * L::kStageFloats;
    const float* src =
        scratch + (static_cast<size_t>(bh) * n_chunks + ci) * G::kFloats;
    constexpr int kRtBytes = 4 * kCp * kLdK;
    constexpr int kGroupBytes = 4 * G::kGroupFloats;
    unsigned long long* landed = &bar[ci % kStages];
    mbar_expect(landed, kRtBytes + kGroupBytes + 4 * N);
    bulk_copy(dst, src + G::kRt, kRtBytes, landed);
    bulk_copy(dst + kCp * kLdK, src + G::kGroup0 + grp * G::kGroupFloats,
              kGroupBytes, landed);
    bulk_copy(dst + kCp * kLdK + G::kGroupFloats, src + G::kDec, 4 * N,
              landed);
  };

  for (int s = 0; s < kStages - 1; ++s) prefetch(s);
  const int tt = warp >> 1, mt = warp & 1;  // warps 0-3: an output tile
  for (int ci = 0; ci < n_chunks; ++ci) {
    // the chunk has landed, every warp is done with the link before: the
    // state it wrote is complete, and the stage it read may be refilled
    mbar_wait(&bar[ci % kStages], (ci / kStages) & 1);
    __syncthreads();
    prefetch(ci + kStages - 1);
    const float* rts = smem + (ci % kStages) * L::kStageFloats;
    const float* ys = rts + kCp * kLdK;
    const float* kvs = ys + kCp * kMb;
    const float* ds = kvs + N * kMb;
    const float* cur = state(ci);
    if (warp < 4) {  // out = r~ S + y
      float d[1][4] = {};
      tiles_3xtf32<1, false, false>(d, rts + tt * 16 * kLdK, 0, kLdK,
                                    cur + N * kLdY + mt * 8,
                                    cur + 2 * N * kLdY + mt * 8, kLdY, N / 8,
                                    lane);
      const size_t c0 = static_cast<size_t>(ci) * C;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = tt * 16 + frag_row(lane, e);
        const int m = mt * 8 + frag_col(lane, e);
        if (t < C)
          out[base + (c0 + t) * row + m] =
              from_f<T>(d[0][e] + ys[t * kMb + m]);
      }
    } else {  // the next state: decay * (S + k~^T v)
      float* nxt = state(ci + 1);
      for (int idx = tid - 128; idx < N * kMb; idx += kThreads - 128) {
        const int nn = idx / kMb, m = idx - nn * kMb;
        set_state(nxt, nn, m,
                  ds[nn] * (cur[nn * kLdY + m] + kvs[nn * kMb + m]));
      }
    }
  }
  __syncthreads();
  const float* fin = state(n_chunks);
  for (int idx = tid; idx < N * kMb; idx += kThreads) {
    const int n = idx / kMb, m = idx - n * kMb;
    s_fin[sbase + n * N + m0 + m] = fin[n * kLdY + m];
  }
}

// ---------------------------------------------------------------------------
// heads past 192: both passes split over thread-block clusters
// ---------------------------------------------------------------------------
//
// Past N 192 neither pass fits one block: the state pass's ring and state
// buffers take 249,816 bytes at N 208, the chunk pass's r~, k~, v and r u k
// tiles outgrow a block near N 440.  So each problem (a chunk of a head in
// the chunk pass, a group of kMb value columns of a head in the state pass)
// runs on a cluster of G = ceil(N / R) blocks, block g owning R channels,
// or R rows of the state, [g R, g R + R); channels and rows from N to G R
// are zero and add nothing.  R is a template argument (R = 64: clusters of
// 4 to 16 blocks), N a launch argument, so one instantiation serves every
// head size.
//
// Past N 1024 a problem takes more than the card's largest cluster (16
// blocks).  Its R-row blocks are then split over NC = ceil(N / 1024)
// clusters of G = ceil(ceil(N / R) / NC) blocks, global block cl G + g
// owning rows [(cl G + g) R, ...).  Nothing in the chain needs another
// cluster: S = diag(decay) (S + k~^T v) is elementwise in S's rows, so each
// block runs its rows' chain alone, and only sums over channels or rows
// cross blocks.  Cluster cl adds its blocks' parts of A and sum(r u k) as
// above and forms its part of the chunk's own output, y_cl = A_cl v +
// sum_cl(r u k) v (the products are linear in the parts), for every value
// column; in the state pass it adds its blocks' parts of r~ S and y_cl and
// writes that float32 part of out to global memory.  A third launch
// (wkv6_add_parts_kernel) adds the NC parts in cluster order and rounds
// out: no atomics, so a call gives the same bits every time.  With NC = 1
// every index below is the single cluster's.
//
// The chunk pass: block g scans its channels (r~, k~, the decay), forms its
// part of A = strict_tril(r~ k~^T) and of sum(r u k) over them, and writes
// its rows of k~^T v (for every value column, v streamed through shared
// memory in tiles of R columns).  After a cluster barrier every block adds
// the G parts of A and sum(r u k) in rank order, read through distributed
// shared memory, so every block holds the same A; block g then forms y for
// value columns [g R, g R + R).
//
// The state pass: block g holds rows [g R, g R + R) of S for the group's
// kMb columns.  A link: its rows' part of r~ S (warps 0-3) beside the
// update of its rows of S (warps 4-7), a cluster barrier, then out = the G
// parts added in rank order through distributed shared memory, + y.  The
// parts are double-buffered, so one cluster barrier a link suffices.

constexpr int kClusterRows = 64;     // R of the instantiation

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

// `local`'s counterpart in block `rank` of the cluster
__device__ __forceinline__ float ld_cluster(const float* local, int rank) {
  float x;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(x) : "r"(cluster_addr(local, rank)) : "memory");
  return x;
}

// A problem's split for heads in blocks of R rows: NC clusters (nc) of G
// blocks (g), nc g row blocks in all.  Scratch per (batch * head, chunk),
// fp32: r~ by row block (nc g blocks of kCp x (R + 4)); for each group of
// kMb value columns, each cluster's y_cl (nc x kCp x kMb) then k~^T v (nc g
// R x kMb, row block b at rows [b R, b R + R)); the decay (nc g R).
template <int R>
struct ClusterScratch {
  static constexpr int kLdK = R + 4;
  static constexpr int kRtFloats = kCp * kLdK;   // one row block's r~
  int n, nc, g, np;
  __host__ __device__ explicit ClusterScratch(int n_)
      : n(n_),
        nc(((n_ + R - 1) / R + kMaxCluster - 1) / kMaxCluster),
        g(((n_ + R - 1) / R + nc - 1) / nc),
        np(nc * g * R) {}
  __host__ __device__ int group0() const { return nc * g * kRtFloats; }
  __host__ __device__ int group_floats() const {
    return (nc * kCp + np) * kMb;
  }
  __host__ __device__ int dec() const {
    return group0() + (n / kMb) * group_floats();
  }
  __host__ __device__ int floats() const { return dec() + np; }
  __device__ int y(int cl, int t, int m) const {
    return group0() + (m / kMb) * group_floats() + (cl * kCp + t) * kMb +
           m % kMb;
  }
  __device__ int kv(int row, int m) const {
    return group0() + (m / kMb) * group_floats() + (nc * kCp + row) * kMb +
           m % kMb;
  }
};

template <int R>
struct ChunkClusterSmem {
  static constexpr int kLdK = R + 4;
  static constexpr int kLdV = R + 8;
  static constexpr int kParts = scan_parts(R);
  static constexpr int kFloats = 2 * kCp * kLdK   // r~, k~
                                 + kCp * kLdV     // a tile of v
                                 + 2 * kCp * kLdA // this block's part of A, A
                                 + kCp * R        // r u k
                                 + kParts * R     // scan part sums
                                 + 2 * kCp;       // sum(r u k): part, whole
  static constexpr int kBytes = 4 * kFloats;
};

template <typename T, int R>
__global__ void __launch_bounds__(kThreads) wkv6_chunk_cluster_kernel(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ w,
    const T* __restrict__ u, float* __restrict__ scratch, int S, int H,
    int N, int C) {
  using L = ChunkClusterSmem<R>;
  constexpr int kLdK = L::kLdK, kLdV = L::kLdV, kParts = L::kParts;
  constexpr int kPer = kCp / kParts;  // tokens of a scan part
  constexpr int kWarps = kThreads / 32;
  const ClusterScratch<R> sc(N);
  extern __shared__ __align__(16) float smem[];
  float* rt = smem;
  float* kt = rt + kCp * kLdK;
  float* vt = kt + kCp * kLdK;
  float* a_part = vt + kCp * kLdV;
  float* a_s = a_part + kCp * kLdA;
  float* ruk = a_s + kCp * kLdA;
  float* part = ruk + kCp * R;
  float* dg_part = part + kParts * R;
  float* dg = dg_part + kCp;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int rank = cluster_rank();
  const int n_chunks = S / C;
  const int prob = blockIdx.x / (sc.nc * sc.g);   // (batch * head, chunk)
  const int cl = blockIdx.x / sc.g % sc.nc;       // the problem's cluster
  const int gb = cl * sc.g + rank;                // the problem's row block
  const int bh = prob / n_chunks;
  const int ci = prob - bh * n_chunks;
  const int b = bh / H;
  const int h = bh - b * H;
  const size_t row = static_cast<size_t>(H) * N;  // a token's stride
  const size_t base =
      (static_cast<size_t>(b) * S + static_cast<size_t>(ci) * C) * row +
      h * N;
  float* out = scratch + static_cast<size_t>(prob) * sc.floats();
  const int c0 = gb * R;  // this block's first channel

  // -- 1. a channel and a part of the chunk per thread: the inputs, the
  //    running sum of log-decays, r u k ---------------------------------
  const int n = tid % R;
  const int q = tid / R;
  const int ng = c0 + n;
  const bool scans = q < kParts;
  const bool has = ng < N;
  const float un = has ? to_f(u[h * N + ng]) : 0.0f;
  float lw[kPer], lp[kPer], rv[kPer], kv[kPer];
  if (scans) {
    float run = 0.0f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int t = q * kPer + i;
      const bool in = t < C && has;
      const size_t gi = base + static_cast<size_t>(t) * row + ng;
      lw[i] = in ? logf(fmaxf(to_f(w[gi]), 1e-30f)) : 0.0f;
      rv[i] = in ? to_f(r[gi]) : 0.0f;
      kv[i] = in ? to_f(k[gi]) : 0.0f;
      ruk[t * R + n] = rv[i] * un * kv[i];
      run += lw[i];
      lp[i] = run;
    }
    part[q * R + n] = run;
  }
  __syncthreads();

  // -- 2. r~, k~ and the decay, the earlier parts' sums added in order;
  //    this block's part of sum(r u k) per token ---------------------------
  if (scans) {
    float off = 0.0f;
    for (int p = 0; p < q; ++p) off += part[p * R + n];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int t = q * kPer + i;
      const bool in = t < C;
      const float lpt = off + lp[i];
      const float rtv = in ? rv[i] * expf(lpt - lw[i]) : 0.0f;
      rt[t * kLdK + n] = rtv;
      kt[t * kLdK + n] = in ? kv[i] * expf(-lpt) : 0.0f;
      out[gb * sc.kRtFloats + t * kLdK + n] = rtv;
      if (t == C - 1) out[sc.dec() + ng] = expf(lpt);
    }
  }
  for (int t = warp; t < kCp; t += kWarps) {
    float d = 0.0f;
    for (int nn = lane; nn < R; nn += 32) d += ruk[t * R + nn];
    for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
    if (lane == 0) dg_part[t] = d;
  }
  __syncthreads();

  // -- 3. this block's part of A = strict_tril(r~ k~^T), over its
  //    channels: tiles as in the one-block chunk pass ------------------------
  {
    const int at = warp < 2 || warp >= 6 ? 0 : 1;
    const int as = warp < 2 ? warp : (warp < 6 ? warp - 2 : warp - 4);
    float d[1][4] = {};
    if (warp < 6)
      tiles_3xtf32<1, false, true>(d, rt + at * 16 * kLdK, 0, kLdK,
                                   kt + as * 8 * kLdK, nullptr, kLdK, R / 8,
                                   lane);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = at * 16 + frag_row(lane, e);
      const int s = as * 8 + frag_col(lane, e);
      a_part[t * kLdA + s] = s < t ? d[0][e] : 0.0f;
    }
  }
  cluster_barrier();  // every block's parts are in its shared memory

  // -- 4. A and sum(r u k) (the cluster's part of them past 1024): the G
  //    blocks' parts added in rank order -----------------------------------
  for (int idx = tid; idx < kCp * kCp + kCp; idx += kThreads) {
    const bool in_a = idx < kCp * kCp;
    const int t = idx / kCp, s = idx - t * kCp;
    const float* src = in_a ? a_part + t * kLdA + s : dg_part + (idx - kCp * kCp);
    float acc = 0.0f;
    for (int gg = 0; gg < sc.g; ++gg) acc += ld_cluster(src, gg);
    if (in_a)
      a_s[t * kLdA + s] = acc;
    else
      dg[idx - kCp * kCp] = acc;
  }
  __syncthreads();

  // -- 5. v in tiles of R value columns: k~^T v on this block's rows for
  //    every tile (a warp takes a column tile of 8 and the R / 16 row tiles
  //    that share it); the cluster's y = A v + sum(r u k) v on the tiles j
  //    with j % G == rank ----------------------------------------------------
  constexpr int kRowTiles = R / 16;
  const int v_tiles = (N + R - 1) / R;
  for (int j = 0; j < v_tiles; ++j) {
    const int m0 = j * R;
    for (int idx = tid; idx < kCp * R; idx += kThreads) {
      const int t = idx / R, m = idx - t * R;
      const bool in = t < C && m0 + m < N;
      vt[t * kLdV + m] =
          in ? to_f(v[base + static_cast<size_t>(t) * row + m0 + m]) : 0.0f;
    }
    __syncthreads();
    for (int mt = warp; mt < R / 8; mt += kWarps) {
      float d[kRowTiles][4] = {};
      tiles_3xtf32<kRowTiles, true, false>(d, kt, 16, kLdK, vt + mt * 8,
                                           nullptr, kLdV, kCp / 8, lane);
#pragma unroll
      for (int i = 0; i < kRowTiles; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + mt * 8 + frag_col(lane, e);
          if (m < N) out[sc.kv(c0 + i * 16 + frag_row(lane, e), m)] = d[i][e];
        }
    }
    if (j % sc.g == rank) {
      for (int mt = warp; mt < R / 8; mt += kWarps) {
        float d[2][4] = {};
        tiles_3xtf32<2, false, false>(d, a_s, 16 * kLdA, kLdA, vt + mt * 8,
                                      nullptr, kLdV, kCp / 8, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = i * 16 + frag_row(lane, e);
            const int ml = mt * 8 + frag_col(lane, e);
            if (m0 + ml < N)
              out[sc.y(cl, t, m0 + ml)] =
                  d[i][e] + dg[t] * vt[t * kLdV + ml];
          }
      }
    }
    __syncthreads();
  }
  cluster_barrier();  // no block leaves while another reads its parts
}

// A ring stage of the cluster's state pass: this block's r~ (kCp x
// (R + 4)), the group's y (kCp x kMb), its rows of k~^T v (R x kMb) and of
// the decay (R).  Beside the ring: the two state buffers (S and its TF32
// high and low parts, R x kLdY each), the two buffers of this block's part
// of r~ S (kCp x kMb), and an mbarrier a stage.
template <int R>
struct StateClusterSmem {
  static constexpr int kLdK = R + 4;
  static constexpr int kStageFloats = kCp * kLdK + kCp * kMb + R * kMb + R;
  static constexpr int kStateFloats = 3 * R * kLdY;
  static constexpr int kFloats =
      kStages * kStageFloats + 2 * kStateFloats + 2 * kCp * kMb;
  static constexpr int kBytes = 4 * kFloats + 8 * kStages;
};

// Past 1024 (NC > 1) a cluster writes its float32 part of out to `parts`
// (NC x the output's B S H N elements, `total`) instead of out.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads, 2) wkv6_state_cluster_kernel(
    const float* __restrict__ scratch, const float* __restrict__ s0,
    T* __restrict__ out, float* __restrict__ parts_out,
    float* __restrict__ s_fin, int* __restrict__ block_sm, int S, int H,
    int N, int C, long long total) {
  using L = StateClusterSmem<R>;
  constexpr int kLdK = L::kLdK;
  const ClusterScratch<R> sc(N);
  extern __shared__ __align__(16) float smem[];
  float* states = smem + kStages * L::kStageFloats;
  float* parts = states + 2 * L::kStateFloats;
  unsigned long long* bar =
      reinterpret_cast<unsigned long long*>(parts + 2 * kCp * kMb);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int rank = cluster_rank();
  const int groups = N / kMb;
  const int prob = blockIdx.x / (sc.nc * sc.g);  // (batch * head, group)
  const int cl = blockIdx.x / sc.g % sc.nc;      // the problem's cluster
  const int gb = cl * sc.g + rank;               // the problem's row block
  const int grp = prob % groups;
  const int bh = prob / groups;
  const int b = bh / H;
  const int h = bh - b * H;
  const int m0 = grp * kMb;
  const int n0 = gb * R;  // this block's first row of S
  const int n_chunks = S / C;
  const size_t row = static_cast<size_t>(H) * N;  // a token's stride
  const size_t base = static_cast<size_t>(b) * S * row + h * N + m0;
  const size_t sbase = static_cast<size_t>(bh) * N * N;
  if (tid == 0) block_sm[blockIdx.x] = sm_id();  // the launch's record

  // state buffer i: S, then its TF32 high and low parts
  auto state = [&](int i) { return states + (i & 1) * L::kStateFloats; };
  auto set_state = [&](float* sb, int n, int m, float x) {
    unsigned hi, lo;
    split_tf32(x, hi, lo);
    sb[n * kLdY + m] = x;
    sb[R * kLdY + n * kLdY + m] = __uint_as_float(hi);
    sb[2 * R * kLdY + n * kLdY + m] = __uint_as_float(lo);
  };
  for (int idx = tid; idx < R * kMb; idx += kThreads) {
    const int n = idx / kMb, m = idx - n * kMb;
    set_state(state(0), n, m,
              n0 + n < N ? s0[sbase + (n0 + n) * N + m0 + m] : 0.0f);
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bar[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // one chunk's stage: four bulk copies by one thread
  auto prefetch = [&](int ci) {
    if (tid != 0 || ci >= n_chunks) return;
    float* dst = smem + (ci % kStages) * L::kStageFloats;
    const float* src =
        scratch + (static_cast<size_t>(bh) * n_chunks + ci) * sc.floats();
    const float* grp_src = src + sc.group0() + grp * sc.group_floats();
    constexpr int kRtBytes = 4 * kCp * kLdK;
    constexpr int kYBytes = 4 * kCp * kMb;
    constexpr int kKvBytes = 4 * R * kMb;
    constexpr int kDecBytes = 4 * R;
    unsigned long long* landed = &bar[ci % kStages];
    mbar_expect(landed, kRtBytes + kYBytes + kKvBytes + kDecBytes);
    bulk_copy(dst, src + gb * sc.kRtFloats, kRtBytes, landed);
    bulk_copy(dst + kCp * kLdK, grp_src + cl * kCp * kMb, kYBytes, landed);
    bulk_copy(dst + kCp * kLdK + kCp * kMb,
              grp_src + (sc.nc * kCp + n0) * kMb, kKvBytes, landed);
    bulk_copy(dst + kCp * kLdK + kCp * kMb + R * kMb, src + sc.dec() + n0,
              kDecBytes, landed);
  };

  for (int s = 0; s < kStages - 1; ++s) prefetch(s);
  const int tt = warp >> 1, mt = warp & 1;  // warps 0-3: an output tile
  for (int ci = 0; ci < n_chunks; ++ci) {
    mbar_wait(&bar[ci % kStages], (ci / kStages) & 1);
    __syncthreads();
    prefetch(ci + kStages - 1);
    const float* rts = smem + (ci % kStages) * L::kStageFloats;
    const float* ys = rts + kCp * kLdK;
    const float* kvs = ys + kCp * kMb;
    const float* ds = kvs + R * kMb;
    const float* cur = state(ci);
    float* part = parts + (ci & 1) * kCp * kMb;
    if (warp < 4) {  // this block's rows' part of r~ S
      float d[1][4] = {};
      tiles_3xtf32<1, false, false>(d, rts + tt * 16 * kLdK, 0, kLdK,
                                    cur + R * kLdY + mt * 8,
                                    cur + 2 * R * kLdY + mt * 8, kLdY, R / 8,
                                    lane);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[(tt * 16 + frag_row(lane, e)) * kMb + mt * 8 +
             frag_col(lane, e)] = d[0][e];
    } else {  // the next state of this block's rows: decay * (S + k~^T v)
      float* nxt = state(ci + 1);
      for (int idx = tid - 128; idx < R * kMb; idx += kThreads - 128) {
        const int nn = idx / kMb, m = idx - nn * kMb;
        set_state(nxt, nn, m,
                  ds[nn] * (cur[nn * kLdY + m] + kvs[nn * kMb + m]));
      }
    }
    cluster_barrier();  // every block's part of this link is written
    // out (past 1024 the cluster's part of it) = the G parts in rank
    // order + y, spread over the first blocks
    for (int o = rank * kThreads + tid; o < kCp * kMb;
         o += sc.g * kThreads) {
      const int t = o / kMb, m = o - t * kMb;
      if (t < C) {
        float acc = 0.0f;
        for (int gg = 0; gg < sc.g; ++gg) acc += ld_cluster(part + o, gg);
        const size_t at = base + (static_cast<size_t>(ci) * C + t) * row + m;
        if (sc.nc == 1)
          out[at] = from_f<T>(acc + ys[o]);
        else
          parts_out[cl * total + at] = acc + ys[o];
      }
    }
  }
  cluster_barrier();  // the last parts are read, the last state written
  const float* fin = state(n_chunks);
  for (int idx = tid; idx < R * kMb; idx += kThreads) {
    const int n = idx / kMb, m = idx - n * kMb;
    if (n0 + n < N) s_fin[sbase + (n0 + n) * N + m0 + m] = fin[n * kLdY + m];
  }
}

// out = the NC clusters' float32 parts added in cluster order, rounded to
// T; one thread an element.
template <typename T>
__global__ void __launch_bounds__(kThreads) wkv6_add_parts_kernel(
    const float* __restrict__ parts, T* __restrict__ out, long long total,
    int nc) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= total) return;
  float acc = parts[i];
  for (int cl = 1; cl < nc; ++cl) acc += parts[cl * total + i];
  out[i] = from_f<T>(acc);
}

template <typename T, int R>
int launch_chunk_cluster(const void* r, const void* k, const void* v,
                         const void* w, const void* u, float* scratch, int B,
                         int S, int H, int N, int C, cudaStream_t stream) {
  constexpr int smem = ChunkClusterSmem<R>::kBytes;
  static_assert(smem <= kSmemMax, "chunk pass over shared memory");
  auto kernel = wkv6_chunk_cluster_kernel<T, R>;
  cudaError_t err = set_cluster_attributes(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const ClusterScratch<R> sc(N);
  fill_cluster_config(cfg, attr, B * H * (S / C) * sc.nc, sc.g, kThreads,
                      smem, stream);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(r),
                           static_cast<const T*>(k), static_cast<const T*>(v),
                           static_cast<const T*>(w), static_cast<const T*>(u),
                           scratch, S, H, N, C);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int R>
int launch_state_cluster(const float* scratch, const float* s0, void* out,
                         float* parts, float* s_fin, int* block_sm, int B,
                         int S, int H, int N, int C, cudaStream_t stream) {
  constexpr int smem = StateClusterSmem<R>::kBytes;
  static_assert(smem <= kSmemMax, "state pass over shared memory");
  const ClusterScratch<R> sc(N);
  if (sc.nc > 1 && parts == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int clusters = B * H * (N / kMb) * sc.nc;
  const long long total = static_cast<long long>(B) * S * H * N;
  auto kernel = wkv6_state_cluster_kernel<T, R>;
  cudaError_t err = set_cluster_attributes(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // -1 where no block wrote its SM: the record counts the blocks that ran
  err = cudaMemsetAsync(block_sm, 0xff, sizeof(int) * clusters * sc.g,
                        stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  fill_cluster_config(cfg, attr, clusters, sc.g, kThreads, smem, stream);
  err = cudaLaunchKernelEx(&cfg, kernel, scratch, s0, static_cast<T*>(out),
                           parts, s_fin, block_sm, S, H, N, C, total);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_add_parts(const float* parts, void* out, long long total, int nc,
                     cudaStream_t stream) {
  const long long blocks = (total + kThreads - 1) / kThreads;
  wkv6_add_parts_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                             stream>>>(parts, static_cast<T*>(out), total,
                                       nc);
  return static_cast<int>(cudaGetLastError());
}

// a head the one-block passes do not take, which the cluster passes do
bool cluster_head(int N) { return N > 192 && N % kMb == 0; }

template <typename T, int N>
int launch_chunk(const void* r, const void* k, const void* v, const void* w,
                 const void* u, float* scratch, int B, int S, int H, int C,
                 cudaStream_t stream) {
  constexpr int smem = ChunkSmem<N>::kBytes;
  static_assert(smem <= kSmemMax, "chunk pass over shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_chunk_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_chunk_kernel<T, N><<<B * H * (S / C), kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), scratch, S, H, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int N>
int launch_state(const float* scratch, const float* s0, void* out,
                 float* s_fin, int* block_sm, int B, int S, int H, int C,
                 cudaStream_t stream) {
  constexpr int smem = StateSmem<N>::kBytes;
  static_assert(smem <= kSmemMax, "state pass over shared memory");
  const int blocks = B * H * (N / kMb);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_state_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // -1 where no block wrote its SM: the record counts the blocks that ran
  err = cudaMemsetAsync(block_sm, 0xff, sizeof(int) * blocks, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_state_kernel<T, N><<<blocks, kThreads, smem, stream>>>(
      scratch, s0, static_cast<T*>(out), s_fin, block_sm, S, H, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int chunk_n(const void* r, const void* k, const void* v, const void* w,
            const void* u, float* scratch, int B, int S, int H, int N, int C,
            cudaStream_t st) {
  switch (N) {
#define WKV6_CASE(n) \
  case n:            \
    return launch_chunk<T, n>(r, k, v, w, u, scratch, B, S, H, C, st);
    WKV6_HEAD_SIZES(WKV6_CASE)
#undef WKV6_CASE
    default:
      if (cluster_head(N))
        return launch_chunk_cluster<T, kClusterRows>(r, k, v, w, u, scratch,
                                                     B, S, H, N, C, st);
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int state_n(const float* scratch, const float* s0, void* out, float* parts,
            float* s_fin, int* block_sm, int B, int S, int H, int N, int C,
            cudaStream_t st) {
  switch (N) {
#define WKV6_CASE(n)                                                     \
  case n:                                                                \
    return launch_state<T, n>(scratch, s0, out, s_fin, block_sm, B, S, H, \
                              C, st);
    WKV6_HEAD_SIZES(WKV6_CASE)
#undef WKV6_CASE
    default:
      if (cluster_head(N))
        return launch_state_cluster<T, kClusterRows>(
            scratch, s0, out, parts, s_fin, block_sm, B, S, H, N, C, st);
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// A call is two launches on `stream`, the chunk pass, then the state pass
// (and past N 1024 a third, the add of the clusters' parts).  r, k, v, w,
// out (B, S, H, N) and u (H, N), contiguous and 16-byte aligned, of one
// dtype: float32 (dtype 0), bfloat16 (1) or float16 (2); s0, s_fin (B, H,
// N, N) float32.  N a multiple of 16 (past 192 on clusters of up to 16
// blocks of 64 rows, past 1024 on ceil(N / 1024) clusters a problem); C <=
// 32 divides S.  scratch: float32, 16-byte aligned, of
// kernels/rwkv6/ops.py scratch_floats (Scratch or ClusterScratch floats per
// (batch, head, chunk)), written by the chunk pass and read by the state
// pass; past 1024, parts: float32, NC x B S H N, written by the state pass
// and read by the add.  All take 256 threads a block and return the CUDA
// error code (0 = launched).

#define WKV6_BY_DTYPE(CALL)                                 \
  switch (dtype) {                                          \
    case 0:                                                 \
      return CALL(float);                                   \
    case 1:                                                 \
      return CALL(__nv_bfloat16);                           \
    case 2:                                                 \
      return CALL(__half);                                  \
    default:                                                \
      return static_cast<int>(cudaErrorInvalidValue);       \
  }

// The chunk pass: B * H * S / C blocks (past 192 times the blocks of a
// problem's clusters).
extern "C" int wkv6_chunk_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, float* scratch,
                                 int dtype, int B, int S, int H, int N, int C,
                                 void* stream) {
  if (C < 1 || C > kCp || S % C)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CHUNK_CALL(T) \
  chunk_n<T>(r, k, v, w, u, scratch, B, S, H, N, C, st)
  WKV6_BY_DTYPE(CHUNK_CALL)
#undef CHUNK_CALL
}

// The state pass: B * H * N / 16 blocks, past 192 times the blocks of a
// problem's clusters (ops.grid_blocks); block_sm, as many ints, gets the SM
// id each block ran on (-1 where none ran).
extern "C" int wkv6_state_launch(const float* scratch, const float* s0,
                                 void* out, float* parts, float* s_fin,
                                 int* block_sm, int dtype, int B, int S,
                                 int H, int N, int C, void* stream) {
  if (C < 1 || C > kCp || S % C)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define STATE_CALL(T) \
  state_n<T>(scratch, s0, out, parts, s_fin, block_sm, B, S, H, N, C, st)
  WKV6_BY_DTYPE(STATE_CALL)
#undef STATE_CALL
}

// Past N 1024: out (B S H N elements, `total`) = the nc clusters' float32
// parts added in cluster order.
extern "C" int wkv6_add_launch(const float* parts, void* out, long long total,
                               int nc, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ADD_CALL(T) launch_add_parts<T>(parts, out, total, nc, st)
  WKV6_BY_DTYPE(ADD_CALL)
#undef ADD_CALL
}
