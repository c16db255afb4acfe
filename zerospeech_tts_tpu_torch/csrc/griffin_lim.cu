// Kernel 4: the whole fast Griffin-Lim vocoder with a signal-domain
// momentum carry, on FFTs held in registers.
//
// Replaces zerospeech_tts_tpu/ops/pallas_gl.py::griffin_lim_pallas (bodies
// _gl_body via _kernel_vmem/_kernel_stream, and _gl_v4_body). The recurrence
// (pallas_gl.py:18-21), with the iSTFT linear so momentum on spectra equals
// momentum on their signals:
//     v_1 = u_0 = istft(mag, zero phase)
//     repeat n_iters: (re, im) = stft(v_i);  n_i = mag (re, im) / max(|.|, 1e-8)
//                     u_i = istft(n_i);  v_{i+1} = u_i + alpha (u_i - u_{i-1})
//     out = istft(mag * phase(stft(v_{N+1})))
// stft analyses frames of the UNTRIMMED overlap-add signal: frame t is
// win[k] v[t*hop + k] placed at lpad = (n_fft - win) / 2 of a zeroed n_fft
// buffer, then rfft (the ca/sa bases of dsp/audio.py _fused_bases). istft is
// irfft (1/n_fft; interior bins twice, the imaginary parts of DC and Nyquist
// ignored: the _idft_basis), samples [lpad, lpad + win) times the window,
// overlap-add, times 1 / the full window-square envelope _fused_wss(cfg, t).
// The caller trims the result to [lead, lead + (t-1)*hop).
//
// What bounds it on an H100: an rfft and an irfft of n_fft points per
// frame and iteration, 2.5 n log2 n FLOPs each (~26 kFLOP at n_fft = 1024):
// ~0.3 GFLOP an iteration for the conversion path's 5,760 frames, whose
// signals (~4 MB) stay in L2. At the path's sizes an iteration is a few
// thousand dependent instructions per lane on a partly filled card, so
// what a launch costs is the length of that chain.
//
// Design: one launch per iteration (n_iters + 2 in all, from one C call).
// Two real frames are packed as the real and imaginary parts of one
// complex n_fft-point FFT, which a unit of L lanes computes in registers
// as a four-step FFT, n_fft = P x L (L = 32 and P = 32 at n_fft = 1024;
// P = L or 2L): lane l holds the P samples L n1 + l, runs a P-point FFT
// on them in registers, multiplies by the twiddles W^(l k1), and after a
// transpose through shared memory each lane runs L-point FFTs over l for
// its P / L values of k1. The inverse runs the same steps backwards. A
// block of 8 warps holds 8 x 32 / L units, that is F_B = 16 x 32 / L
// consecutive frames of one utterance, and owns F_B - (r - 1) output rows
// of hop samples (r = win / hop; the other r - 1 frames are halo frames
// that the neighbour block analyses too). Per unit:
//   1. its two frames' magnitudes start copying to shared memory
//      (cp.async) while the frames load from v and the forward FFT runs;
//   2. split the packed pair into its two frames' spectra, project them
//      onto mag, and pack them again as one Hermitian pair (each lane its
//      own bins, reading the bins n_fft - f from a copy in shared memory);
//   3. inverse FFT; the frame pair's samples go to shared memory;
// then, after one __syncthreads, 4. the overlap-add of the r frames that
// reach each owned sample, in a fixed order (no atomics, deterministic),
// times the window, 1/n_fft and 1/wss, and the momentum update of u (in
// place) and the next v. Spectra never leave the SM. v is read whole
// (halo frames reach into the neighbours' rows), so it ping-pongs between
// two buffers. The twiddles come from tables the host computes in float64:
// W_nfft^(k1 l) in shared memory, W_32^k in constant memory (read as
// instruction operands by the unrolled register FFTs).
#include "common.cuh"
#include "fft.cuh"

namespace {

constexpr int NWARP = 8;
constexpr int THREADS = 32 * NWARP;
enum Mode { kInit = 0, kIter = 1, kFinal = 2 };

template <int LG>
struct Geo : Fft4<LG> {
  using Base = Fft4<LG>;
  static constexpr int UNITS = NWARP * Base::G;  // units a block: 2 UNITS frames
  static constexpr int MAGS = 2 * Base::F;    // floats of a unit's magnitudes
  static size_t smem(int win) {
    return static_cast<size_t>(Base::STRIDE + UNITS * Base::STRIDE) * sizeof(float2) +
           static_cast<size_t>(UNITS * MAGS + win) * sizeof(float);
  }
};

// Block (x, y): rows [x RT, x RT + RT) of utterance y, RT = 2 UNITS - (r - 1).
// Frame q of the block is t = x RT - (r - 1) + q, in unit q / 2, real part
// for even q and imaginary part for odd q.
template <int LG>
__global__ void __launch_bounds__(THREADS, 2)
gl_iter_kernel(const float* __restrict__ mag, const float* __restrict__ win_w,
               const float2* __restrict__ tw, const float* __restrict__ wss_inv,
               float* __restrict__ u, const float* __restrict__ v_in, float* __restrict__ v_out,
               int mode, float alpha, int T, int win, int hop) {
  using Gm = Geo<LG>;
  constexpr int N = Gm::N, L = Gm::L, P = Gm::P, M = Gm::M, F = Gm::F, STRIDE = Gm::STRIDE;
  extern __shared__ float2 sm[];
  float2* tw_s = sm;                                                 // [P][L + 1]: W_N^(k1 l)
  float2* bufs = sm + STRIDE;                                        // [UNITS][STRIDE]
  float* mag_s = reinterpret_cast<float*>(bufs + Gm::UNITS * STRIDE);  // [UNITS][2 F]
  float* win_s = mag_s + Gm::UNITS * Gm::MAGS;                       // [win]
  const int tid = threadIdx.x, lane = tid % 32;
  const int jl = lane % L, unit = (tid / 32) * Gm::G + lane / L;
  float2* z = bufs + unit * STRIDE;
  float* ms = mag_s + unit * Gm::MAGS;
  const int r = win / hop, R = T - 1 + r, RT = 2 * Gm::UNITS - (r - 1), lpad = (N - win) / 2;
  const int b = blockIdx.y, rho0 = blockIdx.x * RT;
  const int ta = rho0 - (r - 1) + 2 * unit;  // the unit's frames ta (real) and ta + 1 (imaginary)
  const bool va = ta >= 0 && ta < T, vb = ta + 1 >= 0 && ta + 1 < T;
  const long n_sig = static_cast<long>(R) * hop;

  // the unit's magnitudes, [frame a | frame b], copied while the frames load
  const float* mag_a = mag + (static_cast<long>(b) * T + ta) * F;
  for (int i = jl; i < 2 * F; i += L) {
    if (i < F ? va : vb) {
      zs::cp_async4(ms + i, mag_a + i);
    } else {
      ms[i] = 0.f;
    }
  }
  zs::cp_async_commit();
  for (int i = tid; i < STRIDE; i += THREADS) tw_s[i] = tw[i];
  for (int i = tid; i < win; i += THREADS) win_s[i] = win_w[i];
  __syncthreads();

  float2 x[M][L];  // lane jl, after the forward FFT: bin k1 + P brev(r2) in x[i][r2], k1 = jl + i L
  if (mode == kInit) {
    zs::cp_async_wait<0>();
    __syncwarp();
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int r2 = 0; r2 < L; ++r2) {
        const int f = jl + i * L + P * brev(r2, Gm::LGL), fm = f <= N / 2 ? f : N - f;
        x[i][r2] = make_float2(ms[fm], ms[F + fm]);  // zero phase: the spectra are mag itself
      }
  } else {
    // forward: lane jl loads samples L n1 + jl of both frames (windowed, at lpad)
    float2 y[P];
    const float* v = v_in + b * n_sig;
#pragma unroll
    for (int n1 = 0; n1 < P; ++n1) {
      const int k = L * n1 + jl - lpad;
      float2 s = make_float2(0.f, 0.f);
      if (k >= 0 && k < win) {
        const float w = win_s[k];
        if (va) s.x = w * v[static_cast<long>(ta) * hop + k];
        if (vb) s.y = w * v[static_cast<long>(ta + 1) * hop + k];
      }
      y[n1] = s;
    }
    dif<P, false>(y);
#pragma unroll
    for (int rr = 0; rr < P; ++rr) {
      const int k1 = brev(rr, Gm::LGP);
      z[k1 * (L + 1) + jl] = cmul(y[rr], tw_s[k1 * (L + 1) + jl]);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int lp = 0; lp < L; ++lp) x[i][lp] = z[(jl + i * L) * (L + 1) + lp];
    __syncwarp();
#pragma unroll
    for (int i = 0; i < M; ++i) dif<L, false>(x[i]);
    // split the packed pair, project onto mag, pack again: bin f's partner
    // n_fft - f is read from a copy of the spectrum in z (natural order)
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int r2 = 0; r2 < L; ++r2) z[jl + i * L + P * brev(r2, Gm::LGL)] = x[i][r2];
    zs::cp_async_wait<0>();
    __syncwarp();
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int r2 = 0; r2 < L; ++r2) {
        const int f = jl + i * L + P * brev(r2, Gm::LGL), fm = f <= N / 2 ? f : N - f;
        const float2 z1 = x[i][r2], z2 = z[(N - f) & (N - 1)];
        float2 xa = make_float2(0.5f * (z1.x + z2.x), 0.5f * (z1.y - z2.y));
        float2 xb = make_float2(0.5f * (z1.y + z2.y), 0.5f * (z2.x - z1.x));
        // mag / max(|X|, 1e-8) as mag / sqrt(max(|X|^2, 1e-16)): one rsqrt
        const float sa = ms[fm] * rsqrtf(fmaxf(xa.x * xa.x + xa.y * xa.y, 1e-16f));
        const float sb = ms[F + fm] * rsqrtf(fmaxf(xb.x * xb.x + xb.y * xb.y, 1e-16f));
        xa = make_float2(xa.x * sa, xa.y * sa);
        xb = make_float2(xb.x * sb, xb.y * sb);
        // Ya + i Yb; at DC and Nyquist irfft ignores the imaginary parts
        x[i][r2] = (f & (N / 2 - 1)) == 0 ? make_float2(xa.x, xb.x)
                                          : make_float2(xa.x - xb.y, xa.y + xb.x);
      }
    __syncwarp();
  }
  // inverse: L-point inverse FFTs over k2, twiddles conjugated, transpose,
  // P-point inverse FFT; the frame pair's samples to z in natural order
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float2 t[L];
#pragma unroll
    for (int k2 = 0; k2 < L; ++k2) t[k2] = x[i][brev(k2, Gm::LGL)];
    dif<L, true>(t);
    const int k1 = jl + i * L;
#pragma unroll
    for (int rr = 0; rr < L; ++rr) {
      const int l = brev(rr, Gm::LGL);
      z[k1 * (L + 1) + l] = cmulc(t[rr], tw_s[k1 * (L + 1) + l]);
    }
  }
  __syncwarp();
  {
    float2 y[P];
#pragma unroll
    for (int k1 = 0; k1 < P; ++k1) y[k1] = z[k1 * (L + 1) + jl];
    __syncwarp();
    dif<P, true>(y);
#pragma unroll
    for (int rr = 0; rr < P; ++rr) z[L * brev(rr, Gm::LGP) + jl] = y[rr];
  }
  __syncthreads();
  // overlap-add: row rho0 + i, sample s gets frame rho0 + i - k at lpad + k hop + s
  const float inv_n = 1.f / static_cast<float>(N);
#pragma unroll 4
  for (int idx = tid; idx < RT * hop; idx += THREADS) {
    const int i = idx / hop, s = idx % hop, rho = rho0 + i;
    if (rho < R) {
      float acc = 0.f;
      for (int k = 0; k < r; ++k) {
        const int t = rho - k, q = i + r - 1 - k;
        if (t >= 0 && t < T) {
          const float2 y = bufs[(q / 2) * STRIDE + lpad + k * hop + s];
          acc = fmaf(win_s[k * hop + s], (q & 1) ? y.y : y.x, acc);
        }
      }
      const long pos = static_cast<long>(rho) * hop + s, o = b * n_sig + pos;
      const float y = acc * inv_n * wss_inv[pos];
      if (mode == kInit) {
        u[o] = y;
        v_out[o] = y;
      } else if (mode == kIter) {
        const float up = u[o];
        u[o] = y;
        v_out[o] = y + alpha * (y - up);
      } else {
        v_out[o] = y;  // the result
      }
    }
  }
}

template <int LG>
cudaError_t run(const float* mag, const float* win_w, const float2* tw, const float* wss_inv,
                float* u, float* va, float* vb, float* out, int B, int T, int win, int hop,
                int n_iters, float alpha, cudaStream_t st) {
  using Gm = Geo<LG>;
  const int r = win / hop, R = T - 1 + r, rt = 2 * Gm::UNITS - (r - 1);
  const size_t smem = Gm::smem(win);
  cudaError_t e;
  if ((e = zs::allow_smem(gl_iter_kernel<LG>, smem))) return e;
  const dim3 grid((R + rt - 1) / rt, B);
  gl_iter_kernel<LG><<<grid, THREADS, smem, st>>>(mag, win_w, tw, wss_inv, u, nullptr, va, kInit,
                                                  alpha, T, win, hop);
  if ((e = cudaGetLastError())) return e;
  for (int it = 0; it < n_iters; ++it) {
    gl_iter_kernel<LG><<<grid, THREADS, smem, st>>>(mag, win_w, tw, wss_inv, u, va, vb, kIter,
                                                    alpha, T, win, hop);
    if ((e = cudaGetLastError())) return e;
    float* tmp = va;
    va = vb;
    vb = tmp;
  }
  gl_iter_kernel<LG><<<grid, THREADS, smem, st>>>(mag, win_w, tw, wss_inv, u, va, out, kFinal,
                                                  alpha, T, win, hop);
  return cudaGetLastError();
}

}  // namespace

ZS_DEFINE_ERROR_STRING

// mag [B, T, n_fft/2 + 1] linear magnitudes, n_fft = 2^lg with 4 <= lg <= 10;
// win_w [win] the window's support (win / hop <= 2 x 8 x 32 / L, see Geo);
// tw [P][L + 1] complex W_nfft^(k1 l) (column L unused) and w32 [16] complex
// exp(-2 pi i k / 32), both from zs_griffin_lim_geometry's P and L;
// wss_inv [(T-1+r)*hop]. Carries u, va, vb and the result out [B,
// (T-1+r)*hop] (untrimmed).
ZS_EXPORT int zs_griffin_lim(const float* mag, const float* win_w, const float* tw,
                             const float* w32, const float* wss_inv, float* u, float* va,
                             float* vb, float* out, int B, int T, int lg, int win, int hop,
                             int n_iters, float alpha, void* stream) {
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cudaError_t e = set_w32(w32, st)) return e;
#define ZS_GL_CASE(LGV) \
  case LGV:             \
    return run<LGV>(mag, win_w, tw2, wss_inv, u, va, vb, out, B, T, win, hop, n_iters, alpha, st);
  switch (lg) {
    ZS_GL_CASE(4)
    ZS_GL_CASE(5)
    ZS_GL_CASE(6)
    ZS_GL_CASE(7)
    ZS_GL_CASE(8)
    ZS_GL_CASE(9)
    ZS_GL_CASE(10)
    default:
      return cudaErrorInvalidValue;
  }
#undef ZS_GL_CASE
}
