// Kernel 1: fused spectrogram frontend, on FFTs held in registers.
//
// Replaces zerospeech_tts_tpu/ops/pallas_frontend.py::fused_frontend_pallas
// (body _kernel). Per frame: re/im = windowed real DFT, mag = sqrt(re^2 +
// im^2 + 1e-12), mel = mag . mel_basis^T, and the dB-norm
// clip((20 log10(max(1e-5, x)) - ref_db + max_db) / max_db, 1e-8, 1) of
// both. Outputs mel [B, T, n_mels] and mag [B, T, F] (f32).
//
// What bounds it on an H100: one n_fft-point rfft a frame (2.5 n log2 n
// FLOPs, ~26 kFLOP at n_fft = 1024) and the outputs (~2.4 KB a frame); the
// conversion path's calls hold 128-1,536 frames, a few microseconds of
// either. So a launch costs the length of one lane's chain of dependent
// instructions, and the grid must spread the frames over the SMs. On
// speech the longest chains are the near-floor bins summed directly
// (below): 0.091 ms for one 512-frame wav against 0.017 ms for silence on
// an H100 80GB HBM3 at 700 W (PERF.md).
//
// Design: frame t is ypad[b, t hop : t hop + n_fft) with the window's
// support at lpad = (n_fft - win) / 2 and zero past the row (what
// dsp/audio.py _fused_bases folds into ca/sa). Two consecutive frames are
// packed as the real and imaginary parts of one complex n_fft-point FFT,
// which a unit of L lanes computes in registers as a four-step FFT
// (fft.cuh; L = 32 at n_fft = 1024, so a warp a frame pair); a block of 4
// warps holds 4 x 32 / L units. Per unit:
//   1. load both frames, windowed, straight from ypad (lanes on
//      consecutive samples), P-point FFTs, twiddles, a transpose through
//      shared memory, L-point FFTs;
//   2. split the pair's spectra with bin n_fft - f (read from a copy of
//      the spectrum in shared memory), |.| in registers, the dB-normed
//      magnitudes written once (lanes on consecutive bins), the linear
//      ones kept in the unit's shared buffer;
//   3. each mel band of both frames as a sum over the band's nonzero bins
//      [lo, hi) only (the host packs the basis's nonzero runs; the terms
//      skipped are exact zeros), dB-normed and written.
// Where a magnitude sits near the dB floor (1e-4), the norm turns f32
// rounding into differences above 1e-4 (the plain version's own matmul is
// 1.2e-4 from a float64 reference there, on a speech-like input); such
// bins, few and data dependent (the preemphasised DC and the lowest bins;
// in a loud frame also any bin below 3e-4 of the frame's largest), are
// summed again with the plain version's bases as plain dot products over
// the window (k = 0 .. win - 1 in sequence), a chain of win FMAs each.
// That is the order of a sequential sum, not necessarily cuBLAS's: on the
// card the plain version's matmul may group its terms otherwise, so those
// bins agree closely, not bit for bit (PERF.md).
// No [win, F] DFT products, no segments in device memory; a frame pair's
// spectra never leave the warp.
#include "common.cuh"
#include "fft.cuh"

namespace {

constexpr int NWARP = 4;
constexpr int THREADS = 32 * NWARP;

// sqrt(re^2 + im^2 + 1e-12), rounded at each step as the plain version's
// elementwise ops round (no fused multiply-add).
__device__ inline float magnitude(float re, float im) {
  return sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)), 1e-12f));
}

// Where an FFT magnitude m lies so that the dB-norm turns f32 rounding
// into differences above 1e-4: from just under the floor (1e-4, below
// which the norm clips whatever the rounding) up to `hi`, the larger of
// 1e-2 and kNearTop times the frame's largest magnitude. The norm's
// slope is 0.087 / m, and both sums' absolute rounding grows with the
// frame's scale: up to ~6e-7 of its largest magnitude between the FFT and
// a plain f32 product, on full-scale tones (a CPU measurement, PERF.md).
// Below 1e-2 of a quiet frame, or 3e-4 of a loud one's top, a bin can
// miss the bar; above both, the differences stayed under 2e-5.
constexpr float kNearTop = 3e-4f;
__device__ inline bool near_floor(float m, float hi) { return m >= 9e-5f && m < hi; }

__device__ inline float db_norm(float x, float ref_db, float max_db) {
  const float db = 20.f * log10f(fmaxf(1e-5f, x));
  return fminf(fmaxf((db - ref_db + max_db) / max_db, 1e-8f), 1.f);
}

template <int LG>
struct FGeo : Fft4<LG> {
  using Base = Fft4<LG>;
  static constexpr int UNITS = NWARP * Base::G;  // frame pairs a block
  static size_t smem(int win, int nnz, int n_mels) {
    return static_cast<size_t>(Base::STRIDE + UNITS * Base::STRIDE) * sizeof(float2) +
           static_cast<size_t>(win + nnz) * sizeof(float) + 3 * static_cast<size_t>(n_mels) * sizeof(int);
  }
};

// Block (x, y): frames [2 UNITS x, 2 UNITS (x + 1)) of row y; unit u holds
// frames ta = 2 (UNITS x + u) (real part) and ta + 1 (imaginary part).
// bands [3][n_mels]: each band's first nonzero bin, one past its last, and
// the offset of its weights in melw.
template <int LG>
__global__ void __launch_bounds__(THREADS)
frontend_kernel(const float* __restrict__ ypad, int n_sig, const float* __restrict__ win_w,
                const float2* __restrict__ tw, const float* __restrict__ caT,
                const float* __restrict__ saT, const float* __restrict__ melw,
                const int* __restrict__ bands, float* __restrict__ mel_out, float* __restrict__ mag_out,
                int T, int n_mels, int nnz, int win, int hop, float ref_db, float max_db) {
  using Gm = FGeo<LG>;
  constexpr int N = Gm::N, L = Gm::L, P = Gm::P, M = Gm::M, F = Gm::F, STRIDE = Gm::STRIDE;
  extern __shared__ float2 sm[];
  float2* tw_s = sm;                                                  // [P][L + 1]: W_N^(k1 l)
  float2* bufs = sm + STRIDE;                                         // [UNITS][STRIDE]
  float* win_s = reinterpret_cast<float*>(bufs + Gm::UNITS * STRIDE);  // [win]
  float* melw_s = win_s + win;                                        // [nnz]
  int* band_s = reinterpret_cast<int*>(melw_s + nnz);                 // [3][n_mels]
  const int tid = threadIdx.x, lane = tid % 32;
  const int jl = lane % L, unit = (tid / 32) * Gm::G + lane / L;
  float2* z = bufs + unit * STRIDE;
  const int b = blockIdx.y, ta = 2 * (blockIdx.x * Gm::UNITS + unit);
  const bool va = ta < T, vb = ta + 1 < T;
  const int lpad = (N - win) / 2;
  // the tables, copied asynchronously: the FFT's first (a group), the mel
  // tables' while the FFT runs (a second group)
  const float* tw_f = reinterpret_cast<const float*>(tw);
  float* tw_sf = reinterpret_cast<float*>(tw_s);
  for (int i = tid; i < 2 * STRIDE; i += THREADS) zs::cp_async4(tw_sf + i, tw_f + i);
  for (int i = tid; i < win; i += THREADS) zs::cp_async4(win_s + i, win_w + i);
  zs::cp_async_commit();
  for (int i = tid; i < nnz; i += THREADS) zs::cp_async4(melw_s + i, melw + i);
  for (int i = tid; i < 3 * n_mels; i += THREADS)
    zs::cp_async4(reinterpret_cast<float*>(band_s) + i, reinterpret_cast<const float*>(bands) + i);
  zs::cp_async_commit();
  zs::cp_async_wait<1>();
  __syncthreads();

  const float* sig = ypad + static_cast<long>(b) * n_sig;
  const long s0 = static_cast<long>(ta) * hop + lpad;
  // 1. forward FFT: lane jl loads samples L n1 + jl of both frames
  float2 y[P];
#pragma unroll
  for (int n1 = 0; n1 < P; ++n1) {
    const int k = L * n1 + jl - lpad;
    float2 s = make_float2(0.f, 0.f);
    if (k >= 0 && k < win) {
      const float w = win_s[k];
      const long ia = s0 + k, ib = ia + hop;
      if (va && ia < n_sig) s.x = w * sig[ia];
      if (vb && ib < n_sig) s.y = w * sig[ib];
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
  float2 x[M][L];  // lane jl: bin k1 + P brev(r2) in x[i][r2], k1 = jl + i L
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int lp = 0; lp < L; ++lp) x[i][lp] = z[(jl + i * L) * (L + 1) + lp];
  __syncwarp();
#pragma unroll
  for (int i = 0; i < M; ++i) dif<L, false>(x[i]);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int r2 = 0; r2 < L; ++r2) z[jl + i * L + P * brev(r2, Gm::LGL)] = x[i][r2];
  __syncwarp();

  // 2. split the packed pair; magnitudes of both frames into x
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int r2 = 0; r2 < L; ++r2) {
      const int f = jl + i * L + P * brev(r2, Gm::LGL);
      const float2 z1 = x[i][r2], z2 = z[(N - f) & (N - 1)];
      const float2 xa = make_float2(0.5f * (z1.x + z2.x), 0.5f * (z1.y - z2.y));
      const float2 xb = make_float2(0.5f * (z1.y + z2.y), 0.5f * (z2.x - z1.x));
      x[i][r2] = make_float2(magnitude(xa.x, xa.y), magnitude(xb.x, xb.y));
    }
  __syncwarp();  // every lane has read z: it now holds the magnitudes [frame a | frame b]
  // each frame's largest magnitude, over the unit's L lanes (aligned
  // groups of a warp: xor offsets below L stay inside the unit)
  float top_a = 0.f, top_b = 0.f;
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int r2 = 0; r2 < L; ++r2)
      if (jl + i * L + P * brev(r2, Gm::LGL) <= N / 2) {
        top_a = fmaxf(top_a, x[i][r2].x);
        top_b = fmaxf(top_b, x[i][r2].y);
      }
#pragma unroll
  for (int o = L / 2; o > 0; o /= 2) {
    top_a = fmaxf(top_a, __shfl_xor_sync(0xffffffffu, top_a, o));
    top_b = fmaxf(top_b, __shfl_xor_sync(0xffffffffu, top_b, o));
  }
  const float hi_a = fmaxf(1e-2f, kNearTop * top_a), hi_b = fmaxf(1e-2f, kNearTop * top_b);
  float* ms = reinterpret_cast<float*>(z);
  float* mag_a = mag_out + (static_cast<long>(b) * T + ta) * F;
  unsigned near_a = 0, near_b = 0;  // bit i L + r2: bin f of frame a / b lies in the near-floor range
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int r2 = 0; r2 < L; ++r2) {
      const int f = jl + i * L + P * brev(r2, Gm::LGL);
      if (f <= N / 2) {
        ms[f] = x[i][r2].x;
        ms[F + f] = x[i][r2].y;
        if (va) mag_a[f] = db_norm(x[i][r2].x, ref_db, max_db);
        if (vb) mag_a[F + f] = db_norm(x[i][r2].y, ref_db, max_db);
        near_a |= static_cast<unsigned>(va && near_floor(x[i][r2].x, hi_a)) << (i * L + r2);
        near_b |= static_cast<unsigned>(vb && near_floor(x[i][r2].y, hi_b)) << (i * L + r2);
      }
    }
  // near the dB floor, the bins again as sequential sums over the window
  // with the plain version's bases (a dot product's rounding, not the
  // FFT's). At DC and Nyquist those are the window itself (times (-1)^n at
  // Nyquist) and 0.
  for (int frame = 0; frame < 2; ++frame) {
    for (unsigned near = frame ? near_b : near_a; near; near &= near - 1) {
      const int idx = __ffs(near) - 1, f = jl + (idx / L) * L + P * brev(idx % L, Gm::LGL);
      const long x0 = s0 + frame * hop;
      float re = 0.f, im = 0.f;
      if ((f & (N / 2 - 1)) == 0) {
#pragma unroll 8
        for (int k = 0; k < win; ++k) {
          const float v = x0 + k < n_sig ? sig[x0 + k] : 0.f;
          re = fmaf(v, f && ((lpad + k) & 1) ? -win_s[k] : win_s[k], re);
        }
      } else {
        const float* cr = caT + static_cast<long>(f) * win;  // the bin's basis rows, contiguous
        const float* sr = saT + static_cast<long>(f) * win;
        // Each lane reads rows of its own bins, so a warp's load touches a
        // sector a lane: eight floats a row a step (two float4, one whole
        // 32-byte sector; a row starts on one when win % 8 == 0), the rest
        // one by one. The sum's order stays k = 0 .. win - 1.
        int k = 0;
        if (win % 8 == 0) {
          for (; k < win; k += 8) {
            const float4 c0 = __ldg(reinterpret_cast<const float4*>(cr + k));
            const float4 c1 = __ldg(reinterpret_cast<const float4*>(cr + k + 4));
            const float4 s0 = __ldg(reinterpret_cast<const float4*>(sr + k));
            const float4 s1 = __ldg(reinterpret_cast<const float4*>(sr + k + 4));
            const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
            const float sn[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float v = x0 + k + j < n_sig ? sig[x0 + k + j] : 0.f;
              re = fmaf(v, c[j], re);
              im = fmaf(v, sn[j], im);
            }
          }
        }
#pragma unroll 8
        for (; k < win; ++k) {
          const float v = x0 + k < n_sig ? sig[x0 + k] : 0.f;
          re = fmaf(v, __ldg(cr + k), re);
          im = fmaf(v, __ldg(sr + k), im);
        }
      }
      const float m = magnitude(re, im);
      ms[frame * F + f] = m;
      mag_a[frame * F + f] = db_norm(m, ref_db, max_db);
    }
  }
  zs::cp_async_wait<0>();
  __syncthreads();  // the mel tables, and every unit's magnitudes

  // 3. mel bands over their nonzero bins
  float* mel_a = mel_out + (static_cast<long>(b) * T + ta) * n_mels;
  for (int m = jl; m < n_mels; m += L) {
    const int lo = band_s[m], n = band_s[n_mels + m] - lo;
    const float* w = melw_s + band_s[2 * n_mels + m];
    float acc_a = 0.f, acc_b = 0.f;
    for (int i = 0; i < n; ++i) {
      acc_a = fmaf(ms[lo + i], w[i], acc_a);
      acc_b = fmaf(ms[F + lo + i], w[i], acc_b);
    }
    if (va) mel_a[m] = db_norm(acc_a, ref_db, max_db);
    if (vb) mel_a[n_mels + m] = db_norm(acc_b, ref_db, max_db);
  }
}

template <int LG>
cudaError_t run(const float* ypad, const float* win_w, const float2* tw, const float* caT,
                const float* saT, const float* melw,
                const int* bands, float* mel_out, float* mag_out, int B, int n_sig, int T, int n_mels,
                int nnz, int win, int hop, float ref_db, float max_db, cudaStream_t st) {
  using Gm = FGeo<LG>;
  const size_t smem = Gm::smem(win, nnz, n_mels);
  cudaError_t e;
  if ((e = zs::allow_smem(frontend_kernel<LG>, smem))) return e;
  const dim3 grid((T + 2 * Gm::UNITS - 1) / (2 * Gm::UNITS), B);
  frontend_kernel<LG><<<grid, THREADS, smem, st>>>(ypad, n_sig, win_w, tw, caT, saT, melw, bands, mel_out,
                                                   mag_out, T, n_mels, nnz, win, hop, ref_db, max_db);
  return cudaGetLastError();
}

}  // namespace

ZS_DEFINE_ERROR_STRING

// ypad [B, n_sig]: preemphasised signal, mirror-padded by n_fft/2 on each
// side; frame t is ypad[b, t*hop + lpad : t*hop + lpad + win) (zero past
// n_sig) times win_w [win], the window's support. n_fft = 2^lg, 4 <= lg
// <= 10. tw [P][L + 1] complex W_nfft^(k1 l) and w32 [16] complex
// exp(-2 pi i k / 32) (the tables of ops/griffin_lim.py _fft_tables);
// caT, saT [n_fft/2 + 1, win] the plain version's window-folded DFT
// bases, transposed (read for near-floor bins only); melw [nnz] the mel
// basis's nonzero runs, bands [3][n_mels] int32 (lo, hi, offset of each
// band's run). Outputs mel [B, T, n_mels], mag [B, T, n_fft/2 + 1],
// dB-normed.
ZS_EXPORT int zs_frontend(const float* ypad, const float* win_w, const float* tw, const float* w32,
                          const float* caT, const float* saT, const float* melw, const int* bands, float* mel_out,
                          float* mag_out, int B, int n_sig, int T, int lg, int n_mels, int nnz, int win,
                          int hop, float ref_db, float max_db, void* stream) {
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cudaError_t e = set_w32(w32, st)) return e;
#define ZS_FE_CASE(LGV) \
  case LGV:             \
    return run<LGV>(ypad, win_w, tw2, caT, saT, melw, bands, mel_out, mag_out, B, n_sig, T, n_mels, nnz, win, \
                    hop, ref_db, max_db, st);
  switch (lg) {
    ZS_FE_CASE(4)
    ZS_FE_CASE(5)
    ZS_FE_CASE(6)
    ZS_FE_CASE(7)
    ZS_FE_CASE(8)
    ZS_FE_CASE(9)
    ZS_FE_CASE(10)
    default:
      return cudaErrorInvalidValue;
  }
#undef ZS_FE_CASE
}
