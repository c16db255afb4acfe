// The register FFTs of the port's kernels (griffin_lim.cu, frontend.cu).
// A complex FFT of n_fft = P x L points (n_fft a power of two, 16 to 1024)
// runs as a four-step FFT on a unit of L lanes: lane l holds the P samples
// L n1 + l, runs a P-point FFT on them in registers (dif), multiplies by
// the twiddles W_nfft^(l k1), and after a transpose through shared memory
// runs L-point FFTs over l for its M = P / L values of k1. Bin k1 + P k2
// ends in lane k1 % L, value k1 / L, register brev(k2). Twiddles come from
// host float64 tables: W_nfft^(k1 l) (in shared memory, [P][L + 1]) and
// W_32^k in constant memory (c_w32, which each including kernel's C entry
// point fills with set_w32 before its launch), read as instruction
// operands by the unrolled stages.
//
// Everything here has internal linkage: each .cu builds into its own
// library with its own copy of c_w32.
#pragma once

#include <cuda_runtime.h>

namespace {

__constant__ float2 c_w32[16];  // exp(-2 pi i k / 32), k < 16

// c_w32 from w32 [16] complex f32 on the device (the host's float64 table,
// ops/griffin_lim.py _fft_tables), in stream order before the launch.
inline cudaError_t set_w32(const float* w32, cudaStream_t st) {
  return cudaMemcpyToSymbolAsync(c_w32, w32, sizeof(float2) * 16, 0, cudaMemcpyDeviceToDevice, st);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {  // a conj(b)
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }

__host__ __device__ constexpr int brev(int i, int lg) {
  int r = 0;
  for (int b = 0; b < lg; ++b) r |= ((i >> b) & 1) << (lg - 1 - b);
  return r;
}

// One radix-2 decimation-in-frequency stage of span H on x[0, Q), then the
// stages of span H / 2 .. 1. Twiddles W_Q^k = c_w32[k 32 / Q] (forward) or
// their conjugates (INV); every index is a compile-time constant, so x
// stays in registers and each twiddle is an instruction operand.
template <int Q, int H, bool INV>
__device__ __forceinline__ void dif_stage(float2 (&x)[Q]) {
  constexpr int S = Q / (2 * H);
#pragma unroll
  for (int blk = 0; blk < Q; blk += 2 * H) {
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float2 a = x[blk + j], b = x[blk + j + H];
      const float2 d = csub(a, b);
      const int k = j * S * (32 / Q);
      x[blk + j] = cadd(a, b);
      if (k == 0) {
        x[blk + j + H] = d;
      } else if (k == 8) {  // W_32^8 = -i
        x[blk + j + H] = INV ? make_float2(-d.y, d.x) : make_float2(d.y, -d.x);
      } else {
        x[blk + j + H] = INV ? cmulc(d, c_w32[k]) : cmul(d, c_w32[k]);
      }
    }
  }
  if constexpr (H > 1) dif_stage<Q, H / 2, INV>(x);
}

// In-place DFT of x[0, Q) (Q a power of two, 2 to 32) in registers:
// natural order in, bit-reversed order out.
template <int Q, bool INV>
__device__ __forceinline__ void dif(float2 (&x)[Q]) {
  dif_stage<Q, Q / 2, INV>(x);
}

// The four-step layout of an n_fft = 2^LG point FFT: L lanes a unit
// (L = 2^(LG / 2)), P = n_fft / L samples a lane (P = L or 2L).
template <int LG>
struct Fft4 {
  static constexpr int N = 1 << LG, LGL = LG / 2, L = 1 << LGL, LGP = LG - LGL, P = N / L;
  static constexpr int M = P / L;            // values of k1 a lane holds after the transpose
  static constexpr int G = 32 / L;           // units a warp
  static constexpr int F = N / 2 + 1;        // bins of a frame
  static constexpr int STRIDE = P * (L + 1); // float2 of a unit's buffer (>= N)
};

}  // namespace
