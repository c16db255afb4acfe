// Kernel 4: the whole fast Griffin-Lim vocoder with a signal-domain
// momentum carry.
//
// Replaces zerospeech_tts_tpu/ops/pallas_gl.py::griffin_lim_pallas (bodies
// _gl_body via _kernel_vmem/_kernel_stream, and _gl_v4_body). The recurrence
// (pallas_gl.py:18-21), with the iSTFT linear so momentum on spectra equals
// momentum on their signals:
//     v_1 = u_0 = istft(mag, zero phase)
//     repeat n_iters: (re, im) = stft(v_i);  n_i = mag (re, im) / max(|.|, 1e-8)
//                     u_i = istft(n_i);  v_{i+1} = u_i + alpha (u_i - u_{i-1})
//     out = istft(mag * phase(stft(v_{N+1})))
// stft analyses frames of the UNTRIMMED overlap-add signal (frame t = samples
// [t*hop, t*hop + win)), and istft is synthesis + overlap-add divided by the
// full window-square envelope _fused_wss(cfg, t). The caller trims the
// result to [lead, lead + (t-1)*hop).
//
// What bounds it on an H100: arithmetic. Per iteration and utterance the
// analysis and synthesis contractions are 8 * t * win * F FLOPs (3.4 GFLOP
// at t=512 with the flagship 800/200/1024 STFT), 101 sweeps for GL-100; the
// spectra and signals (~2 MB per utterance) stay in L2. This version runs
// f32 FMAs on the CUDA cores; bf16 bases on tensor cores (the TPU kernel's
// choice) are later work.
//
// Design: one design for every length up to 32768 frames (the TPU kernel
// needed three tiers for VMEM). The carries v, u live in global memory.
// Per iteration, two launches:
//   gl_analyze_kernel: a block takes 32 consecutive frames of one utterance
//     and a group of 128 bins, reads the frames' one contiguous span of v
//     into shared memory (as float4, four taps per load), and each thread
//     computes one bin for all 32 frames in registers, projects onto the
//     target magnitude and writes the projected spectra (sre, sim). Bin
//     groups multiply the block count, so short buckets with few rows
//     still fill the SMs.
//   gl_synth_kernel: a block owns 8 output rows of hop samples; it stages
//     the spectra of the r + 7 frames that overlap them in shared memory
//     (rows padded to a multiple of 4 bins, read as float4), and thread s
//     gathers each row's r frame contributions at sample s (no atomics,
//     deterministic), scales by 1/wss and applies the momentum update to u
//     and v in place (each element has one owner).
// All 2 * n_iters + 3 launches are issued from one C call.
#include "common.cuh"

namespace {

constexpr int TF = zs::kAnalysisFrames;
constexpr int RT = 8;         // output rows per synthesis block
constexpr int BIN_GROUP = 128;  // bins (threads) per analysis block
enum Mode { kInit = 0, kIter = 1, kFinal = 2 };

__global__ void gl_analyze_kernel(const float* __restrict__ v, const float* __restrict__ mag,
                                  const float* __restrict__ ca, const float* __restrict__ sa,
                                  float* __restrict__ sre, float* __restrict__ sim, int T, int F,
                                  int win, int hop, long n_sig) {
  extern __shared__ __align__(16) float span[];
  const int b = blockIdx.z, j0 = blockIdx.x * TF, f = blockIdx.y * BIN_GROUP + threadIdx.x;
  zs::load_span(span, v + static_cast<long>(b) * n_sig, static_cast<long>(j0) * hop,
                (TF - 1) * hop + win, n_sig);
  __syncthreads();
  if (f >= F) return;
  float re[TF], im[TF];
  zs::analyze_bin(span, ca, sa, f, F, win, hop, re, im);
#pragma unroll
  for (int i = 0; i < TF; ++i) {
    if (j0 + i < T) {
      const long o = (static_cast<long>(b) * T + j0 + i) * F + f;
      const float norm = fmaxf(sqrtf(re[i] * re[i] + im[i] * im[i]), 1e-8f);
      const float m = mag[o];
      sre[o] = m * re[i] / norm;
      sim[o] = m * im[i] / norm;
    }
  }
}

// kHasIm = false is the zero-phase init (spectrum = mag + 0i). cs/ss are
// [Fp, win] with Fp = F rounded up to 4 and zero rows past F.
template <bool kHasIm>
__global__ void gl_synth_kernel(const float* __restrict__ sre, const float* __restrict__ sim,
                                const float* __restrict__ cs, const float* __restrict__ ss,
                                const float* __restrict__ wss_inv, float* __restrict__ u,
                                float* __restrict__ v, float* __restrict__ out, int mode,
                                float alpha, int T, int F, int win, int hop) {
  extern __shared__ __align__(16) float smem[];
  const int r = win / hop, R = T - 1 + r, Q = RT + r - 1, Fp = (F + 3) & ~3;
  const int b = blockIdx.y, rho0 = blockIdx.x * RT;
  float* pre = smem;           // [Q][Fp]: spectra of frames rho0-(r-1) .. rho0+RT-1
  float* pim = smem + Q * Fp;  // (kHasIm only)
  for (int idx = threadIdx.x; idx < Q * Fp; idx += blockDim.x) {
    const int q = idx / Fp, f = idx % Fp, fr = rho0 - (r - 1) + q;
    const bool ok = fr >= 0 && fr < T && f < F;
    const long o = (static_cast<long>(b) * T + fr) * F + f;
    pre[idx] = ok ? sre[o] : 0.f;
    if (kHasIm) pim[idx] = ok ? sim[o] : 0.f;
  }
  __syncthreads();
  const int s = threadIdx.x;
  if (s >= hop) return;

  float acc[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) acc[i] = 0.f;
  // row rho0+i, sample s, receives frame rho0+i-k at its sample k*hop + s
  for (int k = 0; k < r; ++k) {
    const int col = k * hop + s;
    const int q0 = r - 1 - k;
    for (int f = 0; f < Fp; f += 4) {
      float c[4], sn[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = __ldg(cs + static_cast<long>(f + j) * win + col);
        sn[j] = kHasIm ? __ldg(ss + static_cast<long>(f + j) * win + col) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float4 p = *reinterpret_cast<const float4*>(pre + (q0 + i) * Fp + f);
        float a = acc[i];
        a = fmaf(p.x, c[0], a);
        a = fmaf(p.y, c[1], a);
        a = fmaf(p.z, c[2], a);
        a = fmaf(p.w, c[3], a);
        if (kHasIm) {
          const float4 pi = *reinterpret_cast<const float4*>(pim + (q0 + i) * Fp + f);
          a = fmaf(pi.x, sn[0], a);
          a = fmaf(pi.y, sn[1], a);
          a = fmaf(pi.z, sn[2], a);
          a = fmaf(pi.w, sn[3], a);
        }
        acc[i] = a;
      }
    }
  }
  const long n_sig = static_cast<long>(R) * hop;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int rho = rho0 + i;
    if (rho < R) {
      const long p = static_cast<long>(rho) * hop + s, o = static_cast<long>(b) * n_sig + p;
      const float y = acc[i] * wss_inv[p];
      if (mode == kInit) {
        u[o] = y;
        v[o] = y;
      } else if (mode == kIter) {
        const float up = u[o];
        u[o] = y;
        v[o] = y + alpha * (y - up);
      } else {
        out[o] = y;
      }
    }
  }
}

}  // namespace

ZS_DEFINE_ERROR_STRING

// mag [B, T, F] linear magnitudes; ca, sa [win, F]; cs, ss [Fp, win] with
// Fp = F rounded up to 4 (zero rows past F);
// wss_inv [(T-1+r)*hop]. Scratch sre, sim [B, T, F]; carries u, v and the
// result out [B, (T-1+r)*hop] (untrimmed).
ZS_EXPORT int zs_griffin_lim(const float* mag, const float* ca, const float* sa, const float* cs,
                             const float* ss, const float* wss_inv, float* sre, float* sim,
                             float* u, float* v, float* out, int B, int T, int F, int win, int hop,
                             int n_iters, float alpha, void* stream) {
  const int r = win / hop, R = T - 1 + r;
  const long n_sig = static_cast<long>(R) * hop;
  const size_t smem_a = static_cast<size_t>((TF - 1) * hop + win) * sizeof(float);
  const size_t smem_s = static_cast<size_t>(RT + r - 1) * ((F + 3) & ~3) * sizeof(float);
  cudaError_t e;
  if ((e = zs::allow_smem(gl_analyze_kernel, smem_a))) return e;
  if ((e = zs::allow_smem(gl_synth_kernel<false>, smem_s))) return e;
  if ((e = zs::allow_smem(gl_synth_kernel<true>, 2 * smem_s)))
    return e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid_a((T + TF - 1) / TF, (F + BIN_GROUP - 1) / BIN_GROUP, B);
  const dim3 grid_s((R + RT - 1) / RT, B);
  const int threads_s = (hop + 31) / 32 * 32;

  gl_synth_kernel<false><<<grid_s, threads_s, smem_s, st>>>(mag, nullptr, cs, ss, wss_inv, u, v,
                                                            out, kInit, alpha, T, F, win, hop);
  if ((e = cudaGetLastError())) return e;
  for (int it = 0; it <= n_iters; ++it) {
    gl_analyze_kernel<<<grid_a, BIN_GROUP, smem_a, st>>>(v, mag, ca, sa, sre, sim, T, F, win, hop,
                                                         n_sig);
    if ((e = cudaGetLastError())) return e;
    gl_synth_kernel<true><<<grid_s, threads_s, 2 * smem_s, st>>>(
        sre, sim, cs, ss, wss_inv, u, v, out, it < n_iters ? kIter : kFinal, alpha, T, F, win, hop);
    if ((e = cudaGetLastError())) return e;
  }
  return cudaSuccess;
}
