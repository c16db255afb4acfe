// Shared pieces of the port's hand-written Hopper kernels (frontend.cu,
// gru.cu, gru_bwd.cu, griffin_lim.cu; their register FFTs are in fft.cuh).
// Each .cu builds into its own shared library with a plain C interface
// (see ops/build.py); every library exports zs_error_string so the Python
// binding can render a cudaError_t.
#pragma once

#include <cuda_runtime.h>

#define ZS_EXPORT extern "C" __attribute__((visibility("default")))

#define ZS_DEFINE_ERROR_STRING                                   \
  ZS_EXPORT const char* zs_error_string(int e) {                 \
    return cudaGetErrorString(static_cast<cudaError_t>(e));      \
  }

namespace zs {

// cp.async copies global -> shared memory (sm_80 and later). Each kernel
// commits its copies in groups and waits for all but the newest N of them.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 4 bytes, cached in L1 (data no block of the launch writes)
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
// 16 bytes, cached in L2 only (rows other SMs wrote)
__device__ __forceinline__ void cp_async16_cg(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Barrier across n_blocks blocks that are all co-resident (the blocks of a
// cooperative launch, which cudaLaunchCooperativeKernel guarantees or
// refuses, or one group of them with a bar of its own). bar[0] counts
// arrivals and returns to 0 at each release; bar[1] is the generation that
// waiting blocks spin on. Both start at 0 (the host zeroes them before the
// launch). Every thread of every block must call it. The
// bar.sync, then thread 0's fence before it arrives and after it leaves,
// order each block's writes before every other block's reads after the
// barrier; those reads go through L2 (__ldcg), not a stale L1 line.
__device__ inline void grid_barrier(unsigned* bar, unsigned n_blocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == n_blocks - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) {
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// A cheaper barrier for a loop of steps: a monotone counter that starts at
// 0 (the host zeroes it before the launch) and is never reset. At the end
// of step s every block arrives (one atomic add with release semantics)
// and, after any work that does not depend on the other blocks, waits
// until the counter reaches n_blocks (s + 1) (loads with acquire
// semantics). The bar.sync before thread 0's release orders all the
// block's writes before its arrival; thread 0's acquire, then the bar.sync
// after it, order every other block's writes before this block's reads,
// which go through L2 (__ldcg, cp.async.cg). Every thread of every block
// must call both, in every step.
__device__ inline void step_arrive(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(bar) : "memory");
}

__device__ inline void step_wait(const unsigned* bar, unsigned target) {
  if (threadIdx.x == 0) {
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(bar) : "memory");
    } while (v < target);
  }
  __syncthreads();
}

}  // namespace zs
