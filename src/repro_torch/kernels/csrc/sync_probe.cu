// The synchronisation floor of the CFD kernels' chains: the handoff
// between neighbouring blocks alone, with no arithmetic.  Replaces no TPU
// kernel; it measures what each design's chain of phases costs at least
// (PERF.md §6, "second floor"), beside the kernels that walk such a chain
// (fused_interval.cu, sor_slabs.cuh).
//
// A group of blocks runs `handoffs` phases in sequence; in each phase a
// block hands its neighbours (rank - 1 and rank + 1) what the next phase
// needs and waits for theirs, as the kernels' SOR half-sweeps do:
//   mode 0  L2 flags: arrive, then wait for both neighbours' flags
//           (grid_sync.cuh), the global-memory kernels' handoff, one
//           cooperative group of `blocks` blocks;
//   mode 1  L2 rows by flags: a row of `width` floats into a mirror slot
//           for each neighbour, arrive, wait for both neighbours' flags,
//           copy their rows into shared memory;
//   mode 2  L2 rows as tagged words: each neighbour's row written as
//           (float, phase) words, each polled until it carries the phase
//           and copied into shared memory (resident.cuh send_tagged /
//           receive_tagged), the resident kernels' handoff at a cluster
//           edge;
//   mode 3  DSMEM: a row of `width` floats into each neighbour's halo row
//           by st.async on its mbarrier, then a wait for this block's own
//           mbarrier (cluster.cuh), the cluster kernels' handoff, in
//           clusters of `cluster` blocks (blocks / cluster independent
//           chains).
// Two mbarriers and two slots a direction alternate by phase, as the SOR's
// colours do, so that a phase's rows never overtake the phase before.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "common.cuh"
#include "grid_sync.cuh"
#include "resident.cuh"

// shared memory: two mbarriers (4 floats), this block's row, the two halo
// rows
__host__ __device__ inline int probe_smem_bytes(int width) {
  return 4 * (4 + 3 * width);
}

__device__ __forceinline__ void copy_row(float* dst, const float* src,
                                         int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// modes 0 to 2: `rows` 0 (flags alone), 1 (rows by flags), 2 (tagged rows)
__global__ void __launch_bounds__(1024, 1) sync_probe_flags_kernel(
    float* ws, int handoffs, int width, int rows) {
  extern __shared__ float smem[];
  const int G = static_cast<int>(gridDim.x);
  const int rank = blockIdx.x;
  unsigned* flags = reinterpret_cast<unsigned*>(ws);
  unsigned* my_flag = flags + rank * kFlagStride;
  float* own = smem + 4;
  float* halo = own + width;
  const int slot = slot_floats(width);
  // the mirror slots: block r's row for its (previous, next) neighbour in
  // two parities (tagged: two floats a word)
  float* slots = ws + G * kFlagStride;
  float* mine = slots + static_cast<size_t>(rank) * 8 * slot;
  for (int i = threadIdx.x; i < width; i += blockDim.x) own[i] = rank;
  __syncthreads();
  unsigned gen = 0;
  for (int p = 0; p < handoffs; ++p) {
    const int par = p & 1;
    if (rows == 2) {  // the resident kernels' handoff: tagged words
      ++gen;
      unsigned long long* out = reinterpret_cast<unsigned long long*>(mine);
      const unsigned long long* in = reinterpret_cast<const unsigned long long*>(
          slots);
      if (rank > 0) send_tagged(out + par * slot, own, width, gen);
      if (rank < G - 1) send_tagged(out + (2 + par) * slot, own, width, gen);
      if (rank > 0)
        receive_tagged(in + (static_cast<size_t>(rank - 1) * 4 + 2 + par)
                                * slot, halo, width, gen);
      if (rank < G - 1)
        receive_tagged(in + (static_cast<size_t>(rank + 1) * 4 + par) * slot,
                       halo + width, width, gen);
      continue;
    }
    if (rows) {  // rows by flags
      if (rank > 0) copy_row(mine + par * slot, own, width);
      if (rank < G - 1) copy_row(mine + (2 + par) * slot, own, width);
    }
    arrive(my_flag, ++gen);
    wait_neighbours(flags, rank, G, gen);
    if (rows) {
      if (rank > 0)
        fetch_row(halo, slots + (static_cast<size_t>(rank - 1) * 8 + 2 + par)
                            * slot, width);
      if (rank < G - 1)
        fetch_row(halo + width,
                  slots + (static_cast<size_t>(rank + 1) * 8 + par) * slot,
                  width);
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(1024, 1) sync_probe_dsmem_kernel(
    int handoffs, int width) {
  namespace cg = cooperative_groups;
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  unsigned long long* mbar = reinterpret_cast<unsigned long long*>(smem);
  float* own = smem + 4;
  float* halo = own + width;
  const bool first = rank == 0, last = rank == C - 1;
  // a phase of parity q lands on the neighbours' mbarrier q: the previous
  // rank's halo row below, the next rank's halo row above
  unsigned prev = 0, next = 0, prev_bar[2] = {0, 0}, next_bar[2] = {0, 0};
  if (!first) {
    prev = cluster_addr(halo + width, rank - 1);
    for (int q = 0; q < 2; ++q) prev_bar[q] = cluster_addr(&mbar[q], rank - 1);
  }
  if (!last) {
    next = cluster_addr(halo, rank + 1);
    for (int q = 0; q < 2; ++q) next_bar[q] = cluster_addr(&mbar[q], rank + 1);
  }
  const int bytes = 4 * width * ((first ? 0 : 1) + (last ? 0 : 1));
  for (int i = threadIdx.x; i < width; i += blockDim.x) own[i] = rank;
  if (threadIdx.x == 0) {
    mbar_init(&mbar[0]);
    mbar_init(&mbar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(&mbar[0], bytes);
    mbar_expect(&mbar[1], bytes);
  }
  cluster_barrier();
  unsigned parity[2] = {0u, 0u};
  for (int p = 0; p < handoffs; ++p) {
    const int q = p & 1;
    if (p > 0) {  // the neighbours' rows of the phase before are in
      mbar_wait(&mbar[q ^ 1], parity[q ^ 1]);
      parity[q ^ 1] ^= 1u;
    }
    for (int i = threadIdx.x; i < width; i += blockDim.x) {
      if (prev) st_async(prev + 4 * i, own[i], prev_bar[q]);
      if (next) st_async(next + 4 * i, own[i], next_bar[q]);
    }
    __syncthreads();
    if (p > 0 && threadIdx.x == 0) mbar_expect(&mbar[q ^ 1], bytes);
  }
  // the last phase's rows are the last stores into this block
  if (handoffs > 0) mbar_wait(&mbar[(handoffs - 1) & 1],
                              parity[(handoffs - 1) & 1]);
  cluster_barrier();
}

// Floats of modes 0 to 2's workspace for `blocks` blocks: their flags, then
// four mirror slots a block (of tagged words: eight floats' room).
extern "C" long long sync_probe_workspace_floats(int blocks, int width) {
  return static_cast<long long>(blocks) * (kFlagStride + 8 * slot_floats(width));
}

// `handoffs` phases of `mode` (0: L2 flags, 1: L2 rows by flags, 2: L2
// tagged rows, 3: DSMEM) over `blocks` blocks of `threads` threads, in
// clusters of `cluster` blocks (mode 3; blocks a multiple of it); ws:
// sync_probe_workspace_floats floats (modes 0 to 2), zeroed here.  Launch on
// `stream`; returns the CUDA error code (0 = launched).
extern "C" int sync_probe_launch(int mode, int blocks, int cluster,
                                 int handoffs, int threads, int width,
                                 float* ws, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = probe_smem_bytes(width);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err;
  if (mode >= 0 && mode <= 2) {
    if (blocks < 1 || blocks > kMaxGroup)
      return static_cast<int>(cudaErrorInvalidValue);
    err = cudaMemsetAsync(
        ws, 0, sizeof(float) * sync_probe_workspace_floats(blocks, width), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(sync_probe_flags_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fill_cooperative_config(cfg, attr, blocks, threads, st);
    cfg.dynamicSmemBytes = smem;
    err = cudaLaunchKernelEx(&cfg, sync_probe_flags_kernel, ws, handoffs,
                             width, mode);
  } else if (mode == 3) {
    if (cluster < 2 || cluster > kMaxCluster || blocks % cluster)
      return static_cast<int>(cudaErrorInvalidValue);
    err = set_cluster_attributes(sync_probe_dsmem_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fill_cluster_config(cfg, attr, blocks / cluster, cluster, threads, smem,
                        st);
    err = cudaLaunchKernelEx(&cfg, sync_probe_dsmem_kernel, handoffs, width);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
