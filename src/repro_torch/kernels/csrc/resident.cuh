// What the resident kernels share (fused_interval.cu
// fused_interval_resident_kernel, sor_slabs.cuh sor_slabs_resident): a
// group of G = K C blocks, K thread-block clusters of C blocks, each block
// holding its band of rows in shared memory for the whole launch.  Inside a
// cluster the halo rows travel as in the cluster kernels (cluster.cuh:
// st.async into the neighbour's shared memory, counted on its mbarrier).
// At the K - 1 cluster edges they go through mirror slots in the
// workspace in global memory, so only the rows at cluster edges cross L2:
//   * an SOR half-sweep's edge row travels as tagged words, each float
//     beside the phase that wrote it in one 8-byte store: the block sends
//     its edge row after the half-sweep (send_tagged), and the neighbour's
//     threads poll each its own words until they carry the phase, copying
//     them into its halo row before the half-sweep that reads it
//     (receive_tagged).  A word is its own flag: no fence and no flag round
//     trip between two half-sweeps (a row through L2 ordered by flags took
//     2.4 us a handoff on an H100, tagged 1.0 us, DSMEM 0.34 us: PERF.md);
//   * the fused kernel's rows that cross at its group barriers (v_pen
//     after the predictor, u and v after the correction) are plain floats,
//     ordered by the barrier's flags (grid_sync.cuh).
//
// A block has at most one neighbour in another cluster (C >= 2).  Each
// edge has two directions (down: rank r to r + 1; up: r + 1 to r), and each
// direction a slot for every kind of row that crosses it.  The SOR rows
// take one slot per colour and parity of the sweep pair: a write to a slot
// then needs the neighbour to have read the slot's row of two pairs
// before, which the sender's own wait for the neighbour's other colour
// already implies, so no write overtakes a row not yet read, and a phase
// names one row of a slot.  The wrappers zero the slots before a launch,
// and phases count from 1.
#pragma once

#include <cuda_runtime.h>

#include "cluster.cuh"
#include "grid_sync.cuh"

// the SOR rows that cross a cluster edge, as tagged slots: the colours by
// parity; then the fused kernel's velocity rows, as plain ones
enum SorEdgeRow { kRed0, kRed1, kBlack0, kBlack1 };
enum VelocityEdgeRow { kEdgeU, kEdgeV, kEdgeVs };
// slots of `slot` floats a direction: a tagged slot takes two
constexpr int kSorEdgeSlots = 8;
constexpr int kFusedEdgeSlots = 8 + 3;

// floats of one slot for rows of `width` floats (a tagged slot: two), on
// 128-byte lines
__host__ __device__ inline int slot_floats(int width) {
  return (width + 31) / 32 * 32;
}

// floats of one group's mirror slots: K - 1 edges, two directions,
// `slots` slots each (kernels/cluster.py mirror_floats)
__host__ __device__ inline size_t mirror_floats(int K, int slots,
                                                int width) {
  return static_cast<size_t>(K - 1) * 2 * slots * slot_floats(width);
}

// A block's neighbour in another cluster, if any: its rank (-1: none),
// whether it lies above (the previous rank), and the direction of the edge
// this block writes and the one it reads, each the four tagged SOR slots
// then the plain ones.
struct Edge {
  int rank;
  bool above;
  float* send;
  const float* recv;
  int slot;

  __device__ unsigned long long* send_sor(int k) const {
    return reinterpret_cast<unsigned long long*>(send) + k * slot;
  }
  __device__ const unsigned long long* recv_sor(int k) const {
    return reinterpret_cast<const unsigned long long*>(recv) + k * slot;
  }
  __device__ float* send_plain(int k) const {
    return send + (kSorEdgeSlots + k) * slot;
  }
  __device__ const float* recv_plain(int k) const {
    return recv + (kSorEdgeSlots + k) * slot;
  }
};

// The cross-cluster neighbour of rank `rank` of a group of K clusters of C
// blocks whose mirror slots start at `mirrors` (`slots` a direction).
__device__ __forceinline__ Edge cluster_edge(float* mirrors, int rank, int C,
                                             int K, int slots, int width) {
  Edge e{-1, false, nullptr, nullptr, slot_floats(width)};
  const int k = rank / C, crank = rank - k * C;
  const size_t dir = static_cast<size_t>(slots) * e.slot;
  if (crank == C - 1 && k < K - 1) {  // the next rank is across edge k
    e.rank = rank + 1;
    e.send = mirrors + (2 * k) * dir;      // down
    e.recv = mirrors + (2 * k + 1) * dir;  // up
  } else if (crank == 0 && k > 0) {  // the previous rank is across edge k - 1
    e.rank = rank - 1;
    e.above = true;
    e.send = mirrors + (2 * (k - 1) + 1) * dir;  // up
    e.recv = mirrors + (2 * (k - 1)) * dir;      // down
  }
  return e;
}

// Copy a row of n floats from a mirror slot to shared memory (read at L2,
// past this SM's L1, which other SMs' stores do not update).
__device__ __forceinline__ void fetch_row(float* dst, const float* src,
                                          int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldcg(src + i);
}

// Tagged words: a float's bits below, the phase that wrote it above, one
// 8-byte relaxed access at gpu scope, single-copy atomic, so a word is its
// own flag: no fence and no flag round trip between writer and reader.
__device__ __forceinline__ void st_tagged(unsigned long long* p, float v,
                                          unsigned gen) {
  const unsigned long long w =
      (static_cast<unsigned long long>(gen) << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n"
               :: "l"(p), "l"(w) : "memory");
}
__device__ __forceinline__ unsigned long long ld_tagged(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n"
               : "=l"(w) : "l"(p) : "memory");
  return w;
}

// The float of the tagged word at `p` once the word carries phase `gen`,
// polled; a word that never comes (a broken count) traps after
// kWaitBudgetNs, as a flag wait does.
__device__ __forceinline__ float wait_tagged(const unsigned long long* p,
                                             unsigned gen) {
  unsigned long long w = ld_tagged(p);
  unsigned long long start = 0;
  // the cross-cluster wait: until the word carries the phase
  for (unsigned polls = 0; static_cast<unsigned>(w >> 32) != gen; ++polls) {
    if (polls % 1024 == 0) {
      const unsigned long long now = global_ns();
      if (polls == 0) start = now;
      else if (now - start > kWaitBudgetNs) __trap();
    }
    w = ld_tagged(p);
  }
  return __uint_as_float(static_cast<unsigned>(w));
}

// Send this block's edge row `row` (n floats of its shared memory) to its
// cross-cluster neighbour's tagged `slot` as phase `gen` (no barrier: each
// word is its own flag).
__device__ __forceinline__ void send_tagged(unsigned long long* slot,
                                            const float* row, int n,
                                            unsigned gen) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    st_tagged(slot + i, row[i], gen);
}

// Copy the neighbour's row of phase `gen` from the tagged `slot` into the
// halo row `halo` (n floats), each thread polling its own words; a block
// barrier follows.
__device__ __forceinline__ void receive_tagged(
    const unsigned long long* slot, float* halo, int n, unsigned gen) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    halo[i] = wait_tagged(slot + i, gen);
  __syncthreads();
}

// Every block of the group has passed phase `gen`: each thread's global
// stores (partial sums, mirror rows) made visible at gpu scope, a cluster
// barrier (which also completes the DSMEM halo stores inside the cluster),
// then the first block of each cluster publishes `gen` and every block
// waits for the K first blocks' flags.
__device__ __forceinline__ void resident_barrier(unsigned* flags, int rank,
                                                 int C, int K, unsigned gen) {
  __threadfence();
  cluster_barrier();
  if (rank % C == 0 && threadIdx.x == 0)
    st_release(flags + rank * kFlagStride, gen);
  wait_strided(flags, 0, C, K, gen);
}

// The launch configuration of `n_clusters` clusters of `cluster` blocks of
// a resident kernel.  Each cluster of a group must be resident while the
// others are: the wrappers launch no more groups than the card holds
// clusters of this shape at once (kernels/cluster.py resident_plan), and
// the launch is cooperative as well, which an H100 takes beside the
// cluster dimension and which refuses a launch the card cannot hold at
// once rather than run it in waves.
static inline void fill_resident_config(cudaLaunchConfig_t& cfg,
                                        cudaLaunchAttribute* attr,
                                        int n_clusters, int cluster,
                                        int threads, int smem,
                                        cudaStream_t stream) {
  fill_cluster_config(cfg, attr, n_clusters, cluster, threads, smem, stream);
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.numAttrs = 2;
}
