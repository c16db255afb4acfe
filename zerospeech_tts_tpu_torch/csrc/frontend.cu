// Kernel 1: fused spectrogram frontend.
//
// Replaces zerospeech_tts_tpu/ops/pallas_frontend.py::fused_frontend_pallas
// (body _kernel). Per frame: re/im = windowed real DFT of the 800-sample
// segment, mag = sqrt(re^2 + im^2 + 1e-12), mel = mag . mel_basis^T, and the
// dB-norm clip((20 log10(max(1e-5, x)) - ref_db + max_db) / max_db, 1e-8, 1)
// of both. Outputs mel [B, T, M] and mag [B, T, F] (f32).
//
// What bounds it on an H100: arithmetic. At the flagship shapes (B=8,
// T=512, win=800, F=513, M=80) the two DFT contractions are ~6.7 GFLOP and
// the mel product ~0.3 GFLOP, against ~13 MB of output and 3.3 MB of bases
// that stay in the 50 MB L2. This first version runs the contractions as
// f32 FMAs on the CUDA cores (no tensor cores, no TF32: the units are
// computed from these features in the challenge-exact f32 config).
//
// Design: the Pallas kernel needs a [T, win] segment tensor built by XLA
// slicing; here frame t is the contiguous span of the mirror-padded,
// preemphasised signal at lpad + t*hop, so a block of 32 consecutive frames
// reads one (31*hop + win)-sample span (28 KB) into shared memory and never
// materialises segments. Each thread owns one frequency bin and accumulates
// all 32 frames in registers (32 frames x 2 FMAs per basis element loaded).
// The block keeps its 32 x F magnitudes in shared memory (66 KB), so the mel
// product and both dB-norms finish in the same block with mag written to
// global memory once, already normalised.
#include "common.cuh"

namespace {

constexpr int TF = zs::kAnalysisFrames;

__device__ inline float db_norm(float x, float ref_db, float max_db) {
  const float db = 20.f * log10f(fmaxf(1e-5f, x));
  return fminf(fmaxf((db - ref_db + max_db) / max_db, 1e-8f), 1.f);
}

__host__ __device__ inline int span_floats(int win, int hop) { return ((TF - 1) * hop + win + 3) / 4 * 4; }

__global__ void frontend_kernel(const float* __restrict__ ypad, int P,
                                const float* __restrict__ ca, const float* __restrict__ sa,
                                const float* __restrict__ melT, float* __restrict__ mel_out,
                                float* __restrict__ mag_out, int T, int F, int M, int win, int hop,
                                int lpad, float ref_db, float max_db) {
  extern __shared__ float smem[];
  const int b = blockIdx.y, j0 = blockIdx.x * TF;
  float* span = smem;
  float* magt = smem + span_floats(win, hop);  // [TF][F] linear magnitudes
  zs::load_span(span, ypad + static_cast<long>(b) * P, lpad + static_cast<long>(j0) * hop,
                (TF - 1) * hop + win, P);
  __syncthreads();

  float re[TF], im[TF];
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    zs::analyze_bin(span, ca, sa, f, F, win, hop, re, im);
#pragma unroll
    for (int i = 0; i < TF; ++i) {
      const float m = sqrtf(re[i] * re[i] + im[i] * im[i] + 1e-12f);
      magt[i * F + f] = m;
      if (j0 + i < T) mag_out[(static_cast<long>(b) * T + j0 + i) * F + f] = db_norm(m, ref_db, max_db);
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < TF * M; idx += blockDim.x) {
    const int i = idx / M, m = idx % M;
    if (j0 + i >= T) continue;
    const float* row = magt + i * F;
    float acc = 0.f;
    for (int f = 0; f < F; ++f) acc = fmaf(row[f], __ldg(melT + static_cast<long>(f) * M + m), acc);
    mel_out[(static_cast<long>(b) * T + j0 + i) * M + m] = db_norm(acc, ref_db, max_db);
  }
}

}  // namespace

ZS_DEFINE_ERROR_STRING

// ypad [B, P]: preemphasised signal, mirror-padded by n_fft/2 on each side.
// Frame t reads ypad[b, lpad + t*hop : lpad + t*hop + win) (zero past P).
ZS_EXPORT int zs_frontend(const float* ypad, const float* ca, const float* sa, const float* melT,
                          float* mel_out, float* mag_out, int B, int P, int T, int F, int M,
                          int win, int hop, int lpad, float ref_db, float max_db, void* stream) {
  const size_t smem = (static_cast<size_t>(span_floats(win, hop)) + static_cast<size_t>(TF) * F) *
                      sizeof(float);
  cudaError_t e = zs::allow_smem(frontend_kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((T + TF - 1) / TF, B);
  frontend_kernel<<<grid, zs::bin_threads(F), smem, static_cast<cudaStream_t>(stream)>>>(
      ypad, P, ca, sa, melT, mel_out, mag_out, T, F, M, win, hop, lpad, ref_db, max_db);
  return cudaGetLastError();
}
