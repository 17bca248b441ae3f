// Thread-block cluster primitives shared by the kernels that spread one
// problem over a cluster of blocks (fused_interval.cu, sor_slabs.cuh):
// the cluster barrier, shared::cluster addresses, the mbarriers that count
// a halo exchange (wkv6.cu counts its bulk copies with them too),
// st.async, and the band partition of rows over ranks.
#pragma once

#include <cuda_runtime.h>

constexpr int kMaxCluster = 16;

// The band partition, computed once by the wrapper (kernels/cluster.py
// band_starts): rank r owns rows [start[r], start[r+1]).
struct Bands {
  int start[kMaxCluster + 1];
};

// A full cluster barrier: every thread of every block, stores before it
// (local and remote) visible to every thread after it.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of `local`'s counterpart in block `rank`.
__device__ __forceinline__ unsigned cluster_addr(const void* local,
                                                 int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(smem_u32(local)), "r"(rank));
  return r;
}

// The halo exchange.  Each block has one mbarrier per colour; a
// neighbour's edge row lands in this block's halo row by st.async, each
// 4-byte store counted against the mbarrier's transaction bytes, and the
// phase completes when both neighbours' rows and this block's own arrival
// (which states the bytes to expect) are in.  No fence and no cluster
// barrier: a half-sweep waits only for its two neighbours.
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// Wait for the phase of `parity` to complete.  A phase that never does
// (a broken exchange) traps after ~2^31 cycles rather than hang the card.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const long long start = clock64();
  unsigned done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 31)) __trap();
  }
}
__device__ __forceinline__ void st_async(unsigned addr, float v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n"
      :: "r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

// Where a block's edge rows of one packed plane go: the shared::cluster
// addresses of the neighbours' halo rows and of their mbarriers for the
// plane's colour (0 where there is no neighbour).
struct Link {
  unsigned prev, prev_bar, next, next_bar;
};

// The SM a block runs on, for the launch's record.
__device__ __forceinline__ int sm_id() {
  unsigned sm;
  asm volatile("mov.u32 %0, %%smid;\n" : "=r"(sm));
  return static_cast<int>(sm);
}

// The launch configuration of `n_clusters` clusters of `cluster` blocks.
static inline void fill_cluster_config(cudaLaunchConfig_t& cfg,
                                       cudaLaunchAttribute* attr,
                                       int n_clusters, int cluster,
                                       int threads, int smem,
                                       cudaStream_t stream) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(n_clusters * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

// Let `kernel` take `smem` bytes of dynamic shared memory and clusters
// above the portable 8 blocks.
template <typename K>
static cudaError_t set_cluster_attributes(K kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// How many clusters of `cluster` blocks (`threads` threads, `smem` bytes
// of dynamic shared memory each) of `kernel` the card holds at once.
template <typename K>
static cudaError_t max_active_clusters(K kernel, int cluster, int threads,
                                       int smem, int* out) {
  cudaError_t err = set_cluster_attributes(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  fill_cluster_config(cfg, attr, 1, cluster, threads, smem, nullptr);
  return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}
