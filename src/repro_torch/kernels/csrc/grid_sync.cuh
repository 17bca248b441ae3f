// Synchronisation between the blocks of one group of the global-memory
// kernels (fused_interval.cu, sor_slabs.cuh): a group is one env (or one
// (env, slab)) whose fields live in a workspace in global memory (L2 holds
// it) and whose rows are split over G <= kMaxGroup blocks.  These kernels
// serve the grids whose bands no thread-block cluster holds in shared
// memory; a block reads its neighbours' rows where they lie, so no halo row
// is copied, and the phases of a group are ordered by one flag per block.
//
// Each block counts the phases it has passed (its generation, `gen`) and
// publishes the count in its flag with a gpu-scope release once its block
// barrier has passed; a waiting block polls the flags it needs with
// gpu-scope acquire loads (warp 0, a lane a rank), then a block barrier
// hands that ordering to all its threads.  Every block of a group passes
// the same phases in the same order, so a generation names one phase in
// every block.  The flags are zeroed before each launch, and every block of
// a group must be resident at once: the wrappers launch cooperatively and
// never more groups than the card holds (kernels/cluster.py global_plan).
// The resident kernels (resident.cuh) use these flags at their group
// barriers.
#pragma once

#include <cuda_runtime.h>

// the most blocks of one group: warp 0's lanes poll their flags and read
// their partial sums (kernels/cluster.py GROUP_MAX)
constexpr int kMaxGroup = 32;
// unsigned words between two blocks' flags: a 128-byte line each
constexpr int kFlagStride = 32;

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

// This block has passed phase `gen`: every thread's stores before it are
// visible, at gpu scope, to whoever acquires the flag.
__device__ __forceinline__ void arrive(unsigned* flag, unsigned gen) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(flag, gen);
  }
}

// The wall-clock nanoseconds of the card's global timer.
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// How long one wait may last before it traps: a minute.  It guards only
// against a broken count (a generation no block ever publishes), which
// would otherwise hang the card; the cooperative launch already rules out
// a block that is not resident.  A correct wait lasts microseconds, and
// the budget is far above the time slices in which the card may switch a
// process out when several share it.
constexpr unsigned long long kWaitBudgetNs = 60ull * 1000 * 1000 * 1000;

// Wait until the blocks of ranks [lo, hi) other than `self` have passed
// phase `gen` (hi - lo <= 32).
__device__ __forceinline__ void wait_ranks(const unsigned* flags, int lo,
                                           int hi, int self, unsigned gen) {
  if (threadIdx.x < 32) {
    const int r = lo + static_cast<int>(threadIdx.x);
    const bool mine = r < hi && r != self;
    unsigned long long start = 0;
    for (unsigned polls = 0; !__all_sync(
             0xffffffffu, !mine || ld_acquire(flags + r * kFlagStride) >= gen);
         ++polls) {
      if (polls % 1024 == 0) {  // the timer is read now and then
        const unsigned long long now = global_ns();
        if (polls == 0) start = now;
        else if (now - start > kWaitBudgetNs) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// Wait until the n <= 32 blocks of ranks first, first + step, ... have
// passed phase `gen` (the resident kernels' first block of each cluster).
__device__ __forceinline__ void wait_strided(const unsigned* flags,
                                             int first, int step, int n,
                                             unsigned gen) {
  if (threadIdx.x < 32) {
    const int lane = static_cast<int>(threadIdx.x);
    const unsigned* flag = flags + (first + lane * step) * kFlagStride;
    unsigned long long start = 0;
    for (unsigned polls = 0;
         !__all_sync(0xffffffffu, lane >= n || ld_acquire(flag) >= gen);
         ++polls) {
      if (polls % 1024 == 0) {
        const unsigned long long now = global_ns();
        if (polls == 0) start = now;
        else if (now - start > kWaitBudgetNs) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// Every block of the group has passed the phase this block just ended.
__device__ __forceinline__ void group_barrier(unsigned* flags, int rank,
                                              int G, unsigned& gen) {
  arrive(flags + rank * kFlagStride, ++gen);
  wait_ranks(flags, 0, G, rank, gen);
}

// Before a half-sweep (or a phase that reads the planes across its band's
// edges): both neighbours have passed phase `gen`, the half-sweep before.
// Red-black SOR reads only the other colour, so the rows this half-sweep
// reads across its edges are then the neighbours' of that half-sweep, and
// the rows of this colour it overwrites were read there for the last time.
__device__ __forceinline__ void wait_neighbours(const unsigned* flags,
                                                int rank, int G,
                                                unsigned gen) {
  const int lo = rank > 0 ? rank - 1 : 0, hi = rank + 2 < G ? rank + 2 : G;
  wait_ranks(flags, lo, hi, rank, gen);
}

// The band partition of a group: rank r of G owns rows [r ny / G,
// (r + 1) ny / G), as kernels/cluster.py band_starts.
__device__ __forceinline__ int band_start(int r, int ny, int G) {
  return static_cast<int>(static_cast<long long>(r) * ny / G);
}

// The launch configuration of `blocks` blocks that must all be resident at
// once (a cooperative launch).
static inline void fill_cooperative_config(cudaLaunchConfig_t& cfg,
                                           cudaLaunchAttribute* attr,
                                           int blocks, int threads,
                                           cudaStream_t stream) {
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}
