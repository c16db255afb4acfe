// Shared pieces of the port's hand-written Hopper kernels (frontend.cu,
// gru.cu, gru_bwd.cu, griffin_lim.cu). Each .cu builds into its own shared
// library with a plain C interface (see ops/build.py); every library
// exports zs_error_string so the Python binding can render a cudaError_t.
#pragma once

#include <cuda_runtime.h>

#define ZS_EXPORT extern "C" __attribute__((visibility("default")))

#define ZS_DEFINE_ERROR_STRING                                   \
  ZS_EXPORT const char* zs_error_string(int e) {                 \
    return cudaGetErrorString(static_cast<cudaError_t>(e));      \
  }

namespace zs {

// Frames per block of the frontend's windowed-DFT analysis.
// Consecutive frames overlap (hop < win), so a block's frames are one
// contiguous span of (kAnalysisFrames - 1) * hop + win samples.
constexpr int kAnalysisFrames = 32;

// Threads for a loop over F frequency bins: two bins per thread, rounded
// to whole warps (513 bins -> 288 threads, 89% of the lanes busy).
inline int bin_threads(int F) {
  int t = ((F + 1) / 2 + 31) / 32 * 32;
  return t > 1024 ? 1024 : t;
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

// span[s] = sig[s0 + s] for s in [0, n), zero at and past sig[len].
__device__ inline void load_span(float* span, const float* __restrict__ sig, long s0, int n,
                                 long len) {
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    const long i = s0 + s;
    span[s] = i < len ? sig[i] : 0.f;
  }
}

// Windowed real DFT of kAnalysisFrames consecutive frames at bin f. Frame i
// is span[i*hop, i*hop + win); ca/sa are the [win, F] cos/-sin bases with
// the analysis window folded in (dsp/audio.py _fused_bases). Every thread of
// a warp reads the same span elements (a shared-memory broadcast) and its own
// basis column (coalesced, L2-resident). When hop and win are multiples of 4
// (every config the repo ships) the span is read as float4, four taps per
// load, so each shared-memory load feeds eight FMAs; `span` must then be
// 16-byte aligned.
__device__ inline void analyze_bin(const float* span, const float* __restrict__ ca,
                                   const float* __restrict__ sa, int f, int F, int win, int hop,
                                   float (&re)[kAnalysisFrames], float (&im)[kAnalysisFrames]) {
#pragma unroll
  for (int i = 0; i < kAnalysisFrames; ++i) {
    re[i] = 0.f;
    im[i] = 0.f;
  }
  if ((hop & 3) == 0 && (win & 3) == 0) {
    for (int k = 0; k < win; k += 4) {
      float c[4], s[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = __ldg(ca + static_cast<long>(k + j) * F + f);
        s[j] = __ldg(sa + static_cast<long>(k + j) * F + f);
      }
#pragma unroll
      for (int i = 0; i < kAnalysisFrames; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(span + i * hop + k);
        re[i] = fmaf(x.x, c[0], re[i]);
        im[i] = fmaf(x.x, s[0], im[i]);
        re[i] = fmaf(x.y, c[1], re[i]);
        im[i] = fmaf(x.y, s[1], im[i]);
        re[i] = fmaf(x.z, c[2], re[i]);
        im[i] = fmaf(x.z, s[2], im[i]);
        re[i] = fmaf(x.w, c[3], re[i]);
        im[i] = fmaf(x.w, s[3], im[i]);
      }
    }
    return;
  }
  for (int k = 0; k < win; ++k) {
    const float c = __ldg(ca + static_cast<long>(k) * F + f);
    const float s = __ldg(sa + static_cast<long>(k) * F + f);
#pragma unroll
    for (int i = 0; i < kAnalysisFrames; ++i) {
      const float x = span[i * hop + k];
      re[i] = fmaf(x, c, re[i]);
      im[i] = fmaf(x, s, im[i]);
    }
  }
}

}  // namespace zs
