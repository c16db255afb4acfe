// Kernel 4: the whole fast Griffin-Lim vocoder with a signal-domain
// momentum carry, each frame pair's FFT spread over a unit of threads.
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
// signals (~4 MB) stay in L2. That is microseconds of the card's float32
// rate. When one warp computed a frame pair (32 points a lane, 128
// registers, 16 warps an SM) a launch took tens of microseconds: a block's
// time was one lane's chain of ~4,700 dependent instructions, the same
// ~24 us alone on its SM as beside a second block. Spread over four warps
// the chain is a quarter as long and 32 warps share an SM, so a block is
// bound by what the SM issues and by its shared-memory bandwidth (every
// radix pass moves the whole spectrum through shared memory), and by L2
// for the ~100 KB each block copies in at its start.
//
// Design: one launch per iteration (n_iters + 2 in all, from one C call).
// Two real frames are packed as the real and imaginary parts of one
// complex n_fft-point FFT, which TU = n_fft / 8 threads compute with 8
// points a thread (TU = 128, four warps, at n_fft = 1024). The FFT is a
// Stockham radix-8 decimation in time: passes of radix 8 (the last of
// radix 4 or 2 where log2 n_fft - 1 is not a multiple of 3; at n_fft =
// 1024: 8 x 8 x 8), in place in a shared-memory buffer a frame pair, each
// thread a radix-R DFT in registers on the values j + r n_fft / R after
// the twiddles W_(NS R)^(r (j mod NS)). The last radix-2 stage is fused
// with the projection: a thread takes the two butterflies e and n_fft/2 - e
// (bins e, e + n_fft/2, n_fft/2 - e, n_fft - e: both Hermitian pairs
// whole), splits the packed pair into its two frames' spectra, projects
// them onto mag, packs them again and runs the inverse's first radix-2
// stage in place. The inverse is the forward transposed (each pass reads
// where its forward pass wrote, conjugate DFT, conjugate twiddles after),
// so both share one twiddle table. A unit of TU threads carries PU frame
// pairs, the same sub-DFTs of each (one twiddle read for both), and meets
// at a named barrier of its own (bar.sync 1 + unit, TU) before each pass
// stores and after it, or at the warp's where a unit is a warp or less;
// shared-memory indices are padded by one float2 every 16 against bank
// conflicts. A block holds UB = max(8, 256 / TU) units, that is F_B = 2 PU
// UB consecutive frames of one utterance, and owns F_B - (r - 1) output
// rows of hop samples (r = win / hop; the other r - 1 frames are halo
// frames that the neighbour block analyses too). PU = 2 (32 frames and
// 29 rows a block at n_fft = 1024, win/hop = 4) halves the halo's share;
// PU = 1 halves a block's time. The C entry takes the one whose round
// needs the fewer waves times frames a block, asking the occupancy
// calculator what an SM holds; rounds of under one wave of small blocks
// take PU = 1. A block copies in its span of v (each sample once) and the
// tables with cp.async before pass 0, and each unit its frames'
// magnitudes during the forward passes; after one __syncthreads every
// thread of the block takes samples of the overlap-add of the r frames
// that reach each owned sample, in a fixed order (no atomics,
// deterministic), times the window, 1/n_fft and 1/wss, and the momentum
// update of u (in place) and the next v, with no integer division a
// sample and each batch's global loads in flight together. Spectra never
// leave the SM. v is read whole (halo frames reach into the neighbours'
// rows), so it ping-pongs between two buffers. The twiddles come from
// tables the host computes in float64: each pass's W_(NS R)^(r m) and
// W_nfft^e (e < n_fft / 2) in shared memory, W_32^k in constant memory
// (read as instruction operands by the unrolled register DFTs of fft.cuh).
// Registers are held to 64 a thread (__launch_bounds__ for 1,024 threads
// an SM), so 32 warps stay resident on an SM where the shared memory
// allows. At n_fft = 1024 a block is 1,024 threads, one block an SM, with
// 113,984 bytes of shared memory (PU = 1) or 216,384 (PU = 2) at win =
// 800; ptxas (-Xptxas -v, sm_90a): 60 registers (PU = 1) and 64 (PU = 2),
// no spills, no stack frame.
#include <type_traits>

#include "common.cuh"
#include "fft.cuh"

namespace {

enum Mode { kInit = 0, kIter = 1, kFinal = 2 };

__host__ __device__ constexpr int ilog2(int n) { return n > 1 ? 1 + ilog2(n / 2) : 0; }

// Kernel 4's radix passes before its fused last radix-2 stage, for n_fft =
// 2^LG: they cover LG - 1 stages, radix 8 and then one pass of radix 4 or
// 2 for the rest. Pass i has radix gl_radix(i) and NS = gl_ns(i) (the
// product of the radices before it); pass i >= 1 keeps W_(NS R)^(r m) at
// gl_twoff(i) + (r - 1) NS + m of the twiddle table.
template <int LG>
__host__ __device__ constexpr int gl_radix(int i) {
  return i < (LG - 1) / 3 ? 8 : 1 << ((LG - 1) % 3);
}
template <int LG>
__host__ __device__ constexpr int gl_ns(int i) {
  return i == 0 ? 1 : gl_ns<LG>(i - 1) * gl_radix<LG>(i - 1);
}
template <int LG>
__host__ __device__ constexpr int gl_twoff(int i) {
  return i <= 1 ? 0 : gl_twoff<LG>(i - 1) + (gl_radix<LG>(i - 1) - 1) * gl_ns<LG>(i - 1);
}

// The plan of kernel 4 for n_fft = 2^LG (4 <= LG <= 10) with P frame
// pairs a unit of TU threads.
template <int LG, int P>
struct Gl {
  static constexpr int N = 1 << LG, H = N / 2, F = H + 1;
  static constexpr int TU = N / 8;                    // threads a frame pair, 8 points each
  static constexpr int PU = P;                        // frame pairs a unit
  static constexpr int UB = TU >= 32 ? 8 : 256 / TU;  // units a block
  static constexpr int THREADS = UB * TU, FB = 2 * PU * UB;
  static constexpr int NP = (LG + 1) / 3;             // radix passes
  static constexpr int TWF = gl_twoff<LG>(NP), TW = TWF + H;  // the fused stage's W_N^e at TWF + e
  static constexpr int BUF = N + N / 16;  // float2 of a pair's padded buffer
  static_assert(gl_ns<LG>(NP) == H, "the passes cover all but the last radix-2 stage");
  // the window's floats, rounded up to 16 bytes; then each unit's
  // magnitudes, 3 floats of room ahead so they sit as in global memory
  // mod 16 bytes, each unit's region a multiple of 16 bytes
  static constexpr int MAGS = (2 * PU * F + 4 + 3) & ~3;
  __host__ __device__ static int win_floats(int win) { return (win + 3) & ~3; }
  static size_t smem(int win) {
    return static_cast<size_t>(TW + PU * UB * BUF) * sizeof(float2) +
           static_cast<size_t>(win_floats(win) + UB * MAGS) * sizeof(float);
  }
};

__host__ __device__ constexpr int pad(int i) { return i + (i >> 4); }
// pad(o + c) = pad(o) + pad(c) for every constant c a pass adds to its
// base o (their low four bits never carry), so c folds into the address.

// fn(std::integral_constant<int, I>()) for I = B .. E - 1: each I a
// compile-time constant, so a register array's bit-reversed index folds
// (brev's own loop, called at run time, does not).
template <int B, int E, class Fn>
__device__ __forceinline__ void static_for(Fn&& fn) {
  if constexpr (B < E) {
    fn(std::integral_constant<int, B>());
    static_for<B + 1, E>(fn);
  }
}

// n floats from src to dst with cp.async, each of `threads` threads a
// share: 16-byte copies between src's first and last 16-byte boundaries,
// 4-byte ones before and after. dst and src are equal mod 16 bytes.
__device__ __forceinline__ void copy_async(float* dst, const float* src, int n, int tid, int threads) {
  const int head = min(n, static_cast<int>((16 - (reinterpret_cast<size_t>(src) & 15)) & 15) / 4);
  const int body = (n - head) / 4;
#pragma unroll 1
  for (int i = tid; i < head; i += threads) zs::cp_async4(dst + i, src + i);
#pragma unroll 1
  for (int i = tid; i < body; i += threads) zs::cp_async16_cg(dst + head + 4 * i, src + head + 4 * i);
#pragma unroll 1
  for (int i = head + 4 * body + tid; i < n; i += threads) zs::cp_async4(dst + i, src + i);
}

// The unit's threads meet: a named barrier of their own (ids 1 .. UB;
// __syncthreads is 0) across warps, the warp's own otherwise.
template <int TU>
__device__ __forceinline__ void unit_sync(int unit) {
  if constexpr (TU > 32) {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + unit), "n"(TU) : "memory");
  } else {
    __syncwarp();
  }
}

// Pass I in place on the unit's PU pair buffers z + p BUF: every thread
// loads its sub-DFTs' values (sub-DFT j = t + q TU: j + r N / R), the unit
// meets, then twiddles W_(NS R)^(r (j mod NS)) (read once for all pairs),
// a radix-R DFT and the store at (j / NS) NS R + (j mod NS) + r NS; or,
// transposed (INV), loads where the forward stores, the conjugate DFT and
// twiddles, and the store where the forward loads. The unit meets again.
template <int LG, int PU, int I, bool INV>
__device__ __forceinline__ void pass(float2* z, const float2* tw_s, int t, int unit) {
  using G = Gl<LG, PU>;
  constexpr int R = gl_radix<LG>(I), NS = gl_ns<LG>(I), Q = 8 / R, LR = ilog2(R), TWO = gl_twoff<LG>(I);
  float2 x[G::PU][Q][R];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int j = t + q * G::TU;
    const int in = INV ? pad((j / NS) * NS * R + (j & (NS - 1))) : pad(j);
#pragma unroll
    for (int p = 0; p < G::PU; ++p)
#pragma unroll
      for (int r = 0; r < R; ++r) x[p][q][r] = z[p * G::BUF + in + (INV ? pad(r * NS) : pad(r * (G::N / R)))];
  }
  unit_sync<G::TU>(unit);
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int j = t + q * G::TU, m = j & (NS - 1);
    const int out = INV ? pad(j) : pad((j / NS) * NS * R + m);
    if constexpr (!INV && NS > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) {
        const float2 w = tw_s[TWO + (r - 1) * NS + m];
#pragma unroll
        for (int p = 0; p < G::PU; ++p) x[p][q][r] = cmul(x[p][q][r], w);
      }
    }
#pragma unroll
    for (int p = 0; p < G::PU; ++p) dif<R, INV>(x[p][q]);
    static_for<0, R>([&](auto rc) {
      constexpr int r = decltype(rc)::value, br = brev(r, LR);
      float2 w = make_float2(1.f, 0.f);
      if constexpr (INV && NS > 1 && r > 0) w = tw_s[TWO + (r - 1) * NS + m];
#pragma unroll
      for (int p = 0; p < G::PU; ++p) {
        float2 y = x[p][q][br];
        if constexpr (INV && NS > 1 && r > 0) y = cmulc(y, w);
        z[p * G::BUF + out + (INV ? pad(r * (G::N / R)) : pad(r * NS))] = y;
      }
    });
  }
  unit_sync<G::TU>(unit);
}

template <int LG, int PU, int I>
__device__ __forceinline__ void fwd_passes(float2* z, const float2* tw_s, int t, int unit) {
  if constexpr (I < Gl<LG, PU>::NP) {
    pass<LG, PU, I, false>(z, tw_s, t, unit);
    fwd_passes<LG, PU, I + 1>(z, tw_s, t, unit);
  }
}

template <int LG, int PU, int I>
__device__ __forceinline__ void inv_passes(float2* z, const float2* tw_s, int t, int unit) {
  if constexpr (I >= 1) {
    pass<LG, PU, I, true>(z, tw_s, t, unit);
    inv_passes<LG, PU, I - 1>(z, tw_s, t, unit);
  }
}

// z1 = Z[f] and z2 = Z[N - f] of the packed pair (the two frames' spectra
// Xa + i Xb), ma and mb the frames' magnitudes at f: Z'[f] and Z'[N - f]
// of the projected spectra packed again. z2 = z1 at DC and Nyquist, where
// it gives the real parts alone, as irfft reads them.
__device__ __forceinline__ void project(float2 z1, float2 z2, float ma, float mb, float2& zf, float2& zn) {
  float2 xa = make_float2(0.5f * (z1.x + z2.x), 0.5f * (z1.y - z2.y));
  float2 xb = make_float2(0.5f * (z1.y + z2.y), 0.5f * (z2.x - z1.x));
  // mag / max(|X|, 1e-8) as mag / sqrt(max(|X|^2, 1e-16)): one rsqrt
  const float sa = ma * rsqrtf(fmaxf(xa.x * xa.x + xa.y * xa.y, 1e-16f));
  const float sb = mb * rsqrtf(fmaxf(xb.x * xb.x + xb.y * xb.y, 1e-16f));
  xa = make_float2(xa.x * sa, xa.y * sa);
  xb = make_float2(xb.x * sb, xb.y * sb);
  zf = make_float2(xa.x - xb.y, xa.y + xb.x);  // Xa' + i Xb'
  zn = make_float2(xa.x + xb.y, xb.x - xa.y);  // conj(Xa') + i conj(Xb')
}

// The forward's last radix-2 stage, the projection and the inverse's first
// radix-2 stage for the butterflies e1 and e2 (each on e and e + N/2,
// twiddle W_N^e), in place in one pair's buffer z with its magnitudes ms
// ([frame a | frame b]). In general e2 = N/2 - e1, and the pairs are (e1,
// N - e1) and (e1 + N/2, N/2 - e1); the one merged group (e1 = 0, e2 =
// N/4) pairs DC and Nyquist with themselves and N/4 with 3N/4.
template <int LG>
__device__ __forceinline__ void fused(float2* z, const float* ms, float2 w1, float2 w2, int e1, int e2,
                                      bool merged, bool init) {
  constexpr int H = (1 << LG) / 2, F = H + 1;
  float2 za1, zb1, za2, zb2;  // bins e1, e1 + H, e2, e2 + H
  if (init) {  // zero phase: the spectra are mag itself
    za1 = make_float2(ms[e1], ms[F + e1]);
    zb1 = make_float2(ms[H - e1], ms[F + H - e1]);
    za2 = make_float2(ms[e2], ms[F + e2]);
    zb2 = make_float2(ms[H - e2], ms[F + H - e2]);
  } else {
    const float2 y1 = z[pad(e1)], y2 = cmul(z[pad(e1) + pad(H)], w1);
    const float2 y3 = z[pad(e2)], y4 = cmul(z[pad(e2) + pad(H)], w2);
    project(cadd(y1, y2), merged ? cadd(y1, y2) : csub(y3, y4), ms[e1], ms[F + e1], za1, zb2);
    project(csub(y1, y2), merged ? csub(y1, y2) : cadd(y3, y4), ms[H - e1], ms[F + H - e1], zb1, za2);
    if (merged) project(cadd(y3, y4), csub(y3, y4), ms[e2], ms[F + e2], za2, zb2);
  }
  z[pad(e1)] = cadd(za1, zb1);
  z[pad(e1) + pad(H)] = cmulc(csub(za1, zb1), w1);
  z[pad(e2)] = cadd(za2, zb2);
  z[pad(e2) + pad(H)] = cmulc(csub(za2, zb2), w2);
}

// Block (x, y): rows [x RT, x RT + RT) of utterance y, RT = F_B - (r - 1).
// Frame q of the block is t = x RT - (r - 1) + q, in pair q / 2 (unit
// q / (2 PU)), real part for even q and imaginary part for odd q.
template <int LG, int P>
__global__ void __launch_bounds__(Gl<LG, P>::THREADS, 1024 / Gl<LG, P>::THREADS)
gl_iter_kernel(const float* __restrict__ mag, const float* __restrict__ win_w,
               const float2* __restrict__ tw, const float* __restrict__ wss_inv,
               float* __restrict__ u, const float* __restrict__ v_in, float* __restrict__ v_out,
               int mode, float alpha, int T, int win, int hop, int r) {
  using G = Gl<LG, P>;
  constexpr int N = G::N, H = G::H, F = G::F, TU = G::TU, PU = G::PU, BUF = G::BUF, THREADS = G::THREADS;
  extern __shared__ float2 sm[];
  float2* tw_s = sm;                                                // [TW]
  float2* zs_ = sm + G::TW;                                         // [UB PU][BUF]: a pair's buffer
  float* win_s = reinterpret_cast<float*>(zs_ + G::UB * PU * BUF);  // [win]
  float* mag_s = win_s + G::win_floats(win);                        // [UB][MAGS]
  const int tid = threadIdx.x, t = tid % TU, unit = tid / TU;
  float2* z = zs_ + unit * PU * BUF;  // the unit's pairs' buffers
  const int R = T - 1 + r, RT = G::FB - (r - 1), lpad = (N - win) / 2;
  const int b = blockIdx.y, rho0 = blockIdx.x * RT, t0 = rho0 - (r - 1);
  const long n_sig = static_cast<long>(R) * hop;

  // cp.async, first group: the block's span of v (its frames' samples,
  // once each) into the pair buffers, free until pass 0 stores, and the
  // tables; second group, which lands during the forward passes: the
  // unit's frames' magnitudes (frame q of the unit at mu + q F, zero
  // outside [0, T))
  float* span = reinterpret_cast<float*>(zs_);
  if (mode != kInit) {
    const long g0 = b * n_sig + static_cast<long>(t0) * hop;
    const long end = g0 + (G::FB - 1) * hop + win;
    const long lo = g0 > b * n_sig ? g0 : b * n_sig, hi = end < (b + 1) * n_sig ? end : (b + 1) * n_sig;
    span += (reinterpret_cast<size_t>(v_in) / 4 + g0) & 3;
    copy_async(span + (lo - g0), v_in + lo, static_cast<int>(hi - lo), tid, THREADS);
  }
  copy_async(reinterpret_cast<float*>(tw_s), reinterpret_cast<const float*>(tw), 2 * G::TW, tid, THREADS);
  copy_async(win_s, win_w, win, tid, THREADS);
  zs::cp_async_commit();
  float* mu;
  {
    const int tu = t0 + 2 * PU * unit;
    const long e0 = (static_cast<long>(b) * T + tu) * F;
    mu = mag_s + unit * G::MAGS + ((reinterpret_cast<size_t>(mag) / 4 + e0) & 3);
    const int q0 = min(2 * PU, max(0, -tu)), q1 = max(q0, min(2 * PU, T - tu));
    copy_async(mu + q0 * F, mag + e0 + q0 * F, (q1 - q0) * F, t, TU);
    for (int i = t; i < q0 * F; i += TU) mu[i] = 0.f;
    for (int i = q1 * F + t; i < 2 * PU * F; i += TU) mu[i] = 0.f;
  }
  zs::cp_async_commit();
  zs::cp_async_wait<1>();
  __syncthreads();

  if (mode != kInit) {
    // pass 0 (radix 8, NS = 1): thread t takes samples t + r8 N / 8 of each
    // pair's two frames, windowed, at lpad; the block meets before the
    // stores overwrite the span
    float2 x[PU][1][8];
#pragma unroll
    for (int p = 0; p < PU; ++p) {
      const int ta = t0 + 2 * (unit * PU + p);
      const bool va = ta >= 0 && ta < T, vb = ta + 1 >= 0 && ta + 1 < T;
      const float* fa = span + (ta - t0) * hop;
#pragma unroll
      for (int r8 = 0; r8 < 8; ++r8) {
        const int k = t + r8 * (N / 8) - lpad;
        const bool in = k >= 0 && k < win;
        const float w = in ? win_s[k] : 0.f;
        x[p][0][r8] = make_float2(in && va ? w * fa[k] : 0.f, in && vb ? w * fa[hop + k] : 0.f);
      }
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < PU; ++p) {
      dif<8, false>(x[p][0]);
      static_for<0, 8>([&](auto rc) {
        constexpr int r8 = decltype(rc)::value, br = brev(r8, 3);
        z[p * BUF + pad(8 * t) + r8] = x[p][0][br];
      });
    }
    unit_sync<TU>(unit);
    fwd_passes<LG, PU, 1>(z, tw_s, t, unit);
  }
  zs::cp_async_wait<0>();
  unit_sync<TU>(unit);
  {
    // thread t: butterflies (t, N/2 - t) and (N/4 - t, N/4 + t); thread 0
    // the merged group (0, N/4) and (N/8, 3N/8)
    const float2* twf = tw_s + G::TWF;
    const bool init = mode == kInit;
    const int e1 = t, e2 = t ? H - t : N / 4, e3 = t ? N / 4 - t : N / 8, e4 = H - e3;
    const float2 w1 = twf[e1], w2 = twf[e2], w3 = twf[e3], w4 = twf[e4];
#pragma unroll
    for (int p = 0; p < PU; ++p) {
      const float* ms = mu + 2 * p * F;
      fused<LG>(z + p * BUF, ms, w1, w2, e1, e2, t == 0, init);
      fused<LG>(z + p * BUF, ms, w3, w4, e3, e4, false, init);
    }
  }
  unit_sync<TU>(unit);
  inv_passes<LG, PU, G::NP - 1>(z, tw_s, t, unit);
  // pass 0 transposed: samples [lpad, lpad + win) of the block's frame q
  // to frames[q BUF, q BUF + win) (floats: pair p's two frames fill its
  // buffer)
  float* frames = reinterpret_cast<float*>(zs_);
  {
    float2 x[PU][8];
#pragma unroll
    for (int p = 0; p < PU; ++p)
#pragma unroll
      for (int r8 = 0; r8 < 8; ++r8) x[p][r8] = z[p * BUF + pad(8 * t) + r8];
    unit_sync<TU>(unit);
#pragma unroll
    for (int p = 0; p < PU; ++p) {
      dif<8, true>(x[p]);
      float* fa = frames + 2 * (unit * PU + p) * BUF - lpad;
      static_for<0, 8>([&](auto rc) {
        constexpr int r8 = decltype(rc)::value, br = brev(r8, 3);
        const int n = t + r8 * (N / 8);
        if (n >= lpad && n < lpad + win) {
          fa[n] = x[p][br].x;
          fa[BUF + n] = x[p][br].y;
        }
      });
    }
  }
  // overlap-add: row rho = rho0 + i, sample s gets frame q = i + r - 1 - k
  // (frame t = rho - k) at k hop + s, for k < r and t in [0, T). A thread's
  // samples step by THREADS, (i, s) without a division, OLA_K at a time:
  // their wss and u values load first, so the loads' latencies overlap.
  constexpr int OLA_K = 3;
  const float inv_n = 1.f / static_cast<float>(N), inv_hop = __frcp_rn(static_cast<float>(hop));
  // (tid + 1/2) / hop is at least 1 / (2 hop) from an integer, far above
  // the float product's error: the quotients are exact
  const int di = static_cast<int>((THREADS + 0.5f) * inv_hop), ds = THREADS - di * hop;
  const int dk = hop - BUF;
  int i = static_cast<int>((tid + 0.5f) * inv_hop), s = tid - i * hop;
  int is[OLA_K], ss[OLA_K];  // a batch's rows (-1 past the last) and samples
  float wv[OLA_K], up[OLA_K];
  auto fetch = [&]() {
#pragma unroll
    for (int kk = 0; kk < OLA_K; ++kk) {
      const long pos = static_cast<long>(rho0 + i) * hop + s;
      const bool ok = i < RT && rho0 + i < R;
      is[kk] = ok ? i : -1;
      ss[kk] = s;
      wv[kk] = ok ? wss_inv[pos] : 0.f;
      up[kk] = ok && mode == kIter ? u[b * n_sig + pos] : 0.f;
      i += di;
      s += ds;
      if (s >= hop) {
        s -= hop;
        ++i;
      }
    }
  };
  fetch();  // the first batch's loads fly while the block meets
  __syncthreads();
#pragma unroll 1
  while (is[0] >= 0) {
#pragma unroll
    for (int kk = 0; kk < OLA_K; ++kk) {
      if (is[kk] < 0) break;
      const int rho = rho0 + is[kk], k0 = max(0, rho - T + 1), k1 = min(r, rho + 1);
      const float* f = frames + (is[kk] + r - 1) * BUF + ss[kk] + k0 * dk;
      const float* w = win_s + ss[kk] + k0 * hop;
      float acc = 0.f;
#pragma unroll 1
      for (int k = k0; k < k1; ++k, f += dk, w += hop) acc = fmaf(*w, *f, acc);
      const long o = b * n_sig + static_cast<long>(rho) * hop + ss[kk];
      const float y = acc * inv_n * wv[kk];
      v_out[o] = mode == kIter ? y + alpha * (y - up[kk]) : y;  // kFinal: the result
      if (mode != kFinal) u[o] = y;
    }
    fetch();
  }
}

// One of kernel 4's two shapes for a call: its grid, shared memory and
// blocks resident an SM.
template <int LG, int P>
struct Shape {
  using G = Gl<LG, P>;
  dim3 grid;
  size_t smem = 0;
  int per_sm = 0;
  cudaError_t prepare(int B, int T, int win, int hop) {
    const int r = win / hop, rt = G::FB - (r - 1);
    grid = dim3((T - 1 + r + rt - 1) / rt, B);
    smem = G::smem(win);
    if (cudaError_t e = zs::allow_smem(gl_iter_kernel<LG, P>, smem)) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gl_iter_kernel<LG, P>, G::THREADS, smem);
  }
  // a round's waves times its blocks' frames, which set a block's time
  long cost(int sms) const {
    const long cap = static_cast<long>(per_sm > 0 ? per_sm : 1) * sms;
    return (static_cast<long>(grid.x) * grid.y + cap - 1) / cap * G::FB;
  }
  cudaError_t launch(const float* mag, const float* win_w, const float2* tw, const float* wss_inv,
                     float* u, float* va, float* vb, float* out, int* plan, int sms, int T, int win,
                     int hop, int n_iters, float alpha, cudaStream_t st) const {
    const int r = win / hop;
    plan[0] = G::TU;
    plan[1] = static_cast<int>(grid.x * grid.y);
    plan[2] = per_sm;
    plan[3] = sms;
    gl_iter_kernel<LG, P><<<grid, G::THREADS, smem, st>>>(mag, win_w, tw, wss_inv, u, nullptr, va,
                                                          kInit, alpha, T, win, hop, r);
    cudaError_t e;
    if ((e = cudaGetLastError())) return e;
    for (int it = 0; it < n_iters; ++it) {
      gl_iter_kernel<LG, P><<<grid, G::THREADS, smem, st>>>(mag, win_w, tw, wss_inv, u, va, vb,
                                                            kIter, alpha, T, win, hop, r);
      if ((e = cudaGetLastError())) return e;
      float* tmp = va;
      va = vb;
      vb = tmp;
    }
    gl_iter_kernel<LG, P><<<grid, G::THREADS, smem, st>>>(mag, win_w, tw, wss_inv, u, va, out,
                                                          kFinal, alpha, T, win, hop, r);
    return cudaGetLastError();
  }
};

// Launches the shape whose rounds take the fewer waves of frames: two
// frame pairs a unit (a block of 2 x 16 frames, less halo) unless one
// pair a unit fits in fewer waves for its half-length blocks. plan [4]
// gets what was launched: threads a frame pair, blocks a round, blocks
// resident an SM (the occupancy calculator's) and SMs.
template <int LG>
cudaError_t run(const float* mag, const float* win_w, const float2* tw, const float* wss_inv,
                float* u, float* va, float* vb, float* out, int* plan, int B, int T, int win,
                int hop, int n_iters, float alpha, cudaStream_t st) {
  // the tables copy 16 bytes at a time to 16-byte aligned shared memory
  if ((reinterpret_cast<size_t>(tw) | reinterpret_cast<size_t>(win_w)) & 15) return cudaErrorMisalignedAddress;
  int dev = 0, sms = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev))) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return e;
  Shape<LG, 1> one;
  Shape<LG, 2> two;
  if ((e = one.prepare(B, T, win, hop)) || (e = two.prepare(B, T, win, hop))) return e;
  if (two.per_sm == 0 || (one.per_sm > 0 && one.cost(sms) < two.cost(sms)))
    return one.launch(mag, win_w, tw, wss_inv, u, va, vb, out, plan, sms, T, win, hop, n_iters, alpha, st);
  return two.launch(mag, win_w, tw, wss_inv, u, va, vb, out, plan, sms, T, win, hop, n_iters, alpha, st);
}

}  // namespace

ZS_DEFINE_ERROR_STRING

// mag [B, T, n_fft/2 + 1] linear magnitudes, n_fft = 2^lg with 4 <= lg <= 10;
// win_w [win] the window's support (win / hop <= 16, see Gl::FB); tw the
// twiddle table of Gl<lg> (ops/griffin_lim.py _gl_tables: each radix pass
// after the first, W_(NS R)^(r m) for 1 <= r < R, m < NS; then W_nfft^e,
// e < n_fft / 2; complex) and w32 [16] complex exp(-2 pi i k / 32);
// wss_inv [(T-1+r)*hop]. Carries u, va, vb and the result out [B,
// (T-1+r)*hop] (untrimmed). plan [4] (host) gets what was launched: threads
// a frame pair, blocks a round, blocks resident an SM, SMs.
ZS_EXPORT int zs_griffin_lim(const float* mag, const float* win_w, const float* tw,
                             const float* w32, const float* wss_inv, float* u, float* va,
                             float* vb, float* out, int* plan, int B, int T, int lg, int win,
                             int hop, int n_iters, float alpha, void* stream) {
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cudaError_t e = set_w32(w32, st)) return e;
#define ZS_GL_CASE(LGV)                                                                       \
  case LGV:                                                                                   \
    return run<LGV>(mag, win_w, tw2, wss_inv, u, va, vb, out, plan, B, T, win, hop, n_iters, \
                    alpha, st);
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
