// Kernel 2: GRU recurrence, forward and (length-masked) reverse, in ONE
// cooperative launch a scan, with xw, wh, bh, ys and the state in f32.
//
// Replaces zerospeech_tts_tpu/ops/pallas_gru.py::pallas_gru_scan in its
// f32 mode; its bf16 mode is a kernel of its own, csrc/gru_bf16.cu (the
// product on the tensor cores). Given the hoisted input projections xw = x Wi + bi
// [B, T, 3H] (a plain matmul outside the kernel), each step computes
//     hw = h wh + bh;  r, z = sigmoid(x_{r,z} + hw_{r,z})
//     n  = tanh(x_n + r * hw_n);  h' = (1 - z) n + z h
// with gate order r, z, n and f32 state. With `lengths` (reverse scans
// only) steps at t >= lengths[b] pass the state through, so each row's
// first real step sees h0 = 0 exactly as an exact-length run does.
//
// The storage type S is only ever float: the bf16 branches below (S =
// bf16, a `state` buffer between steps) are the former bf16 mode, which
// nothing instantiates since csrc/gru_bf16.cu replaced it. They stay so
// that the f32 kernel compiles exactly as before: a copy with them taken
// out measured 0.9% slower at B=16 T=512 H=512 on an H100 (PERF.md section 6).
//
// What bounds it on an H100: the serial chain of T dependent steps, not
// arithmetic. A step is B x 3H x H FMAs (0.4 us of the card's f32 rate at
// B=16, H=512; the conversion path runs 1-6 rows) and needs every column
// of the previous step's h, so the time of a step is the length of its
// chain of dependent memory operations.
//
// Design: a cooperative launch (every block co-resident, at most one per
// SM) runs all T steps. Blocks form NK column groups x NB batch groups
// (make_plan); block (g, q) owns kc hidden columns j and with them the
// three gate columns {j, H+j, 2H+j} of wh, which stay on chip for the whole
// scan (H x 3kc values: 10 to 104 KB at H=512 in f32, kc = 5 to 17, half
// that in bf16): in shared memory, and in registers too when a thread's
// share fits in 8 float4 (so a step reads only h from shared memory),
// beside bh and its rows' lengths. A batch
// row's recurrence needs only that row's h, so only the NK blocks of a
// batch group wait for each other, on a counter of their own
// (zs::step_arrive / step_wait: one atomic a block a step). Step
// t, for the block's nb rows (in chunks of cb when they do not fit):
//   1. stage the rows of h_{t-1} from ys (f32) or the state buffer (bf16),
//      written by the group's blocks last step, into shared memory with
//      cp.async.cg (through L2, every load in flight at once); with the
//      first chunk, start copying the next step's xw for its rows and
//      columns, which does not depend on the state and arrives while the
//      step runs (double-buffered; in bf16 two columns a 4-byte copy, so kc
//      is even);
//   2. hw = h_{t-1} wh for the 3kc columns: thread (c, ks) sums every
//      KS-th float4 group of the H terms for column c over 8 rows at a
//      time (float4 reads of h, broadcast across the columns), then a
//      thread an output adds the KS k-slices in a fixed order;
//   3. the gates, and h_t of its columns straight into ys[:, t], which is
//      the output anyway (and in bf16 also into the state buffer);
//   4. arrive at the group's counter (a release add) and wait for it (an
//      acquire spin).
// A step's chain is thus one barrier and one L2 round trip for h, not a
// launch. Any B runs: rows a group holds are staged in chunks, and a batch
// too large for the shared memory runs as slices, a launch each.
//
// Wide H: a block's columns of wh (ceil(H / SMs) x 3H values) fit in its
// shared memory, beside one staged row, up to H of about 1,550 in f32 and
// about 2,100 in bf16 on an H100. Past that no spread fits, and the plan
// keeps only the first Hs rows of the block's columns in shared memory (as
// many as fit beside the other arrays). Before the scan a pack pass copies
// rows Hs..H-1 of every block's columns into `wpack`, one float4 (bf16: 8
// bytes) per (group of 4 rows, column) in the block's column order, so the
// product loop reads them each step as coalesced __ldg loads, eight in
// flight a thread, through L2 (the whole copy, 3H x (H - Hs) values, stays
// resident there while it is under 50 MB: up to H of about 2,900 in f32).
// Such a step is bound by those reads, not by the chain; the
// register-cached mode is off. A spread that fits runs exactly as before
// (Hs = H).
#include <cuda_bf16.h>

#include <algorithm>
#include <cmath>
#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 512;
constexpr int RR = 8;           // batch rows a thread accumulates at once
constexpr int WQ = 8;           // float4 groups of wh a thread holds in registers (when they fit)
constexpr int BAR_STRIDE = 32;  // unsigned words between batch groups' counters (128 bytes)
constexpr int PK = 8;           // wide spreads: packed float4 groups of wh a thread loads at once

// kc hidden columns and nb batch rows a block; NK x NB blocks (blockIdx.x
// = group * NK + column group); a block's rows of h staged cb at a time;
// rows 0..Hs-1 of its columns of wh in shared memory (Hs a multiple of 4:
// all of pad4(H) unless the spread is wide), the rest read from wpack.
struct Plan {
  int kc, NK, nb, NB, cb, Hs;
};

__host__ __device__ inline int pad4(int h) { return (h + 3) / 4 * 4; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename S>
__device__ __forceinline__ S from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
// h as the product takes it: h itself in f32, rounded to bf16 in bf16 mode
// (pallas_gru.py:143, hprev.astype(w_dt))
template <typename S>
__device__ __forceinline__ float product_input(float h) {
  if constexpr (std::is_same<S, float>::value) {
    return h;
  } else {
    return __bfloat162float(__float2bfloat16_rn(h));
  }
}

// Whether a thread's share of the block's columns of wh (its column, every
// KS-th float4 group of the H terms) fits in WQ float4 of registers.
bool wh_in_registers(const Plan& p, int H) {
  const int ks = THREADS / (3 * p.kc), g4 = pad4(H) / 4;
  return p.Hs == pad4(H) && (g4 + ks - 1) / ks <= WQ;
}

// Elements of wpack a plan reads: per column group, its rows Hs..pad4(H)-1
// of 3 kc columns (0 when the spread is not wide).
long pack_elems(const Plan& p, int H) { return static_cast<long>(p.NK) * (pad4(H) - p.Hs) * 3 * p.kc; }

// Byte offsets of a block's shared-memory arrays (ws at 0) and their total.
struct Layout {
  size_t hs, part, hws, xs, bhs, lens, total;
};

template <typename S>
__host__ __device__ inline Layout layout(const Plan& p, int H) {
  const size_t C = 3 * p.kc, H4 = pad4(H), KS = THREADS / C;
  Layout L;
  L.hs = (p.Hs * C * sizeof(S) + 15) / 16 * 16;     // ws [Hs][C]: the block's columns of wh, rows < Hs
  L.part = L.hs + p.cb * H4 * sizeof(float);         // hs [cb][H4]: a chunk of its rows of h_{t-1}
  L.hws = L.part + KS * p.cb * C * sizeof(float);    // part [KS][cb][C]: k-slice partial sums
  L.xs = L.hws + p.cb * C * sizeof(float);           // hws [cb][C]: their totals
  L.bhs = L.xs + (2 * p.nb * C * sizeof(S) + 3) / 4 * 4;  // xs [2][nb][C]: this step's and the next's xw
  L.lens = L.bhs + C * sizeof(float);                // bhs [C] f32
  L.total = L.lens + p.nb * sizeof(int);             // lens [nb]
  return L;
}

// The spread for B rows on a card of n_sm SMs with optin bytes of shared
// memory a block: for each column-group count NK, as many batch groups as
// the SMs left over allow, and the largest chunk of rows that fits beside
// the block's columns of wh. Of these, the least estimated step time in
// microseconds: a thread's product loop (its float4 groups of wh times
// its row blocks, each reading a float4 of h a row, and four scalars of wh
// when they are not in registers: shared-memory bound), staging the
// block's rows of h, a round of loads and syncs a chunk, and a term a
// float4 group. The weights were fitted by least squares (non-negative) to
// f32 step times on an H100 at H=512 with the column-group count forced
// (tools/gru_spread_sweep.py), B = 1 to 128; PERF.md keeps that table.
// bf16 uses the same weights, with an even kc (columns copied in pairs).
//
// With `wide`, when no spread holds its columns whole, every NK and chunk
// count is tried with as many rows Hs of the columns in shared memory as
// fit, and the step's cost adds the block's reads of the other rows from
// wpack (bytes over ~25 KB/us, an SM's share of the card's memory rate),
// once a row block a chunk. False when not even that fits.
template <typename S>
bool make_plan(Plan& best, int B, int H, int n_sm, size_t optin, bool wide) {
  double best_cost = -1.0;
  auto consider = [&](const Plan& p, int chunks, double extra) {
    const double ks = THREADS / (3 * p.kc), q4 = std::ceil(pad4(H) / 4 / ks);
    const double row_blocks = (p.nb + RR - 1) / RR, rows = p.nb < RR ? p.nb : RR;
    const double cost = 0.0086 * q4 * row_blocks * (4 * rows + (wh_in_registers(p, H) ? 0 : 4))
                        + 0.185 * p.nb * H / 512 + 2.79 * chunks + 0.061 * q4 + extra;
    if (best_cost < 0 || cost < best_cost) {
      best = p;
      best_cost = cost;
    }
  };
  // pass 0: the columns whole on chip; pass 1 (wide, only when pass 0
  // found nothing): rows Hs.. of them in wpack
  for (int pass = 0; pass < (wide ? 2 : 1) && best_cost < 0; ++pass) {
    for (int nk = 1; nk <= H && nk <= n_sm; ++nk) {
      Plan p;
      p.kc = (H + nk - 1) / nk;
      if (sizeof(S) == 2) p.kc += p.kc & 1;  // bf16: xw's columns copied two at a time
      p.NK = (H + p.kc - 1) / p.kc;
      if (p.NK != nk || 3 * p.kc > THREADS) continue;  // the same spread as another nk, or too wide
      const int nbg = n_sm / p.NK < B ? n_sm / p.NK : B;
      p.nb = (B + nbg - 1) / nbg;
      p.NB = (B + p.nb - 1) / p.nb;
      if (pass == 0) {
        p.Hs = pad4(H);
        p.cb = p.nb;
        while (p.cb > 0 && layout<S>(p, H).total > optin) --p.cb;
        if (p.cb == 0) continue;
        const int chunks = (p.nb + p.cb - 1) / p.cb;
        p.cb = (p.nb + chunks - 1) / chunks;  // even chunks, none larger than what fits
        consider(p, chunks, 0.0);
        continue;
      }
      const size_t row = 3 * static_cast<size_t>(p.kc) * sizeof(S);  // a row of the block's columns
      int last_cb = 0;
      for (int chunks = 1; chunks <= p.nb && chunks <= 64; ++chunks) {
        p.cb = (p.nb + chunks - 1) / chunks;
        if (p.cb == last_cb) continue;
        last_cb = p.cb;
        p.Hs = 0;
        const size_t base = layout<S>(p, H).total;
        if (base > optin) continue;
        p.Hs = static_cast<int>(std::min<size_t>((optin - base) / row, pad4(H))) / 4 * 4;
        while (p.Hs > 0 && layout<S>(p, H).total > optin) p.Hs -= 4;
        const int used = (p.nb + p.cb - 1) / p.cb;
        const double reads = static_cast<double>(used) * ((p.cb + RR - 1) / RR);  // row blocks a step
        consider(p, used, reads * (pad4(H) - p.Hs) * row / 25e3);
      }
    }
  }
  return best_cost >= 0;
}

__device__ inline float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// hs[r][k] = src[r rstride + k] for r < nr, k < H, through L2, eight loads
// in flight a thread (rows that are not 16-byte aligned when H % 4 != 0).
__device__ inline void stage_rows_scalar(float* hs, const float* src, int nr, int H, int H4, long rstride) {
  constexpr int U = 8;
  for (int i0 = threadIdx.x; i0 < nr * H; i0 += U * blockDim.x) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * blockDim.x, r = i / H;
      v[u] = i < nr * H ? __ldcg(src + r * rstride + (i - r * H)) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * blockDim.x, r = i / H;
      if (i < nr * H) hs[r * H4 + (i - r * H)] = v[u];
    }
  }
}

// acc[r] += hs[r0 + r][4 q4 .. 4 q4 + 3] . w for the rows r0 + r < nr (h as
// the product takes it in this mode).
template <typename S>
__device__ __forceinline__ void accumulate(float (&acc)[RR], const float* hs, int H4, int r0, int nr,
                                           int q4, float4 w) {
#pragma unroll
  for (int r = 0; r < RR; ++r) {
    if (r0 + r < nr) {
      const float4 hv = reinterpret_cast<const float4*>(hs + (r0 + r) * H4)[q4];
      acc[r] = fmaf(product_input<S>(hv.w), w.w,
                    fmaf(product_input<S>(hv.z), w.z,
                         fmaf(product_input<S>(hv.y), w.y, fmaf(product_input<S>(hv.x), w.x, acc[r]))));
    }
  }
}

// wh[k .. k + 3][c] of the block's columns as f32 (ws row stride C)
template <typename S>
__device__ __forceinline__ float4 wh_group(const S* ws, int q4, int C, int c) {
  const S* wp = ws + 4 * q4 * C + c;
  return make_float4(to_f32(wp[0]), to_f32(wp[C]), to_f32(wp[2 * C]), to_f32(wp[3 * C]));
}

// The same four values of column c for the g-th float4 group past Hs, from
// the block's packed copy wg [g][C][4] (one read-only 16- or 8-byte load)
__device__ __forceinline__ float4 wh_group_packed(const float* wg, int g, int C, int c) {
  return __ldg(reinterpret_cast<const float4*>(wg) + static_cast<long>(g) * C + c);
}
__device__ __forceinline__ float4 wh_group_packed(const bf16* wg, int g, int C, int c) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(wg) + static_cast<long>(g) * C + c);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// wpack[q][g][c][e] = wh[4 (GS + g) + e][(c / kc) H + q kc + c % kc] for
// column group q < NK, g < GW float4 groups past GS = Hs / 4, column c < 3kc
// (0 past H): the rows a wide spread leaves out of shared memory, in the
// order the product loop reads them. Reads coalesce over a gate's columns.
template <typename S>
__global__ void pack_overflow_kernel(const S* __restrict__ wh, S* __restrict__ wpack, int H, int kc,
                                     int NK, int GS, int GW) {
  const int C = 3 * kc;
  const long n = static_cast<long>(NK) * GW * 4 * C;
  for (long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % C);
    const long r = i / C;
    const int e = static_cast<int>(r % 4), g = static_cast<int>(r / 4 % GW), q = static_cast<int>(r / 4 / GW);
    const int k = 4 * (GS + g) + e, col = q * kc + c % kc;
    wpack[((static_cast<long>(q) * GW + g) * C + c) * 4 + e] =
        k < H && col < H ? wh[static_cast<long>(k) * 3 * H + (c / kc) * H + col] : from_f32<S>(0.f);
  }
}

// WREG: the thread's share of wh also in registers; WIDE: rows Hs.. of the
// block's columns come from wpack (never both)
template <typename S, bool WREG, bool WIDE>
__global__ void __launch_bounds__(THREADS, 1)
gru_scan_kernel(const S* __restrict__ xw, const S* __restrict__ wh, const S* __restrict__ bh,
                const int* __restrict__ lengths, const S* __restrict__ wpack, S* ys, float* state,
                unsigned* bar, int B, int T, int H, Plan pl, int rev) {
  constexpr bool F32 = std::is_same<S, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<S>(pl, H);
  const int kc = pl.kc, C = 3 * kc, H4 = (H + 3) & ~3, KS = THREADS / C, G4 = H4 / 4;
  const int H3 = 3 * H, tid = threadIdx.x, GS = pl.Hs / 4;
  const int g = blockIdx.x / pl.NK, q = blockIdx.x % pl.NK;
  const int k0 = q * kc, nk = min(kc, H - k0), b0 = g * pl.nb, nb = min(pl.nb, B - b0);
  S* ws = reinterpret_cast<S*>(smem);                       // [Hs][C]: column gate * kc + jj is wh[:, gate H + k0 + jj]
  float* hs = reinterpret_cast<float*>(smem + L.hs);        // [cb][H4]
  float* part = reinterpret_cast<float*>(smem + L.part);    // [KS][cb][C]
  float* hws = reinterpret_cast<float*>(smem + L.hws);      // [cb][C]
  S* xs = reinterpret_cast<S*>(smem + L.xs);                // [2][nb][C]: this step's and the next step's xw
  float* bhs = reinterpret_cast<float*>(smem + L.bhs);      // [C]
  int* lens = reinterpret_cast<int*>(smem + L.lens);        // [nb]
  unsigned* gbar = bar + BAR_STRIDE * g;
  const S* wg = WIDE ? wpack + static_cast<long>(q) * (G4 - GS) * C * 4 : nullptr;  // [G4 - GS][C][4]
  const S zero = from_f32<S>(0.f);

  // xs[buf][r][gate kc + jj] = xw[b0 + r, t, gate H + k0 + jj], copied
  // asynchronously (0 past the last column); in bf16 two columns a copy
  // (kc even, so a pair never straddles a gate), or one at a time
  // synchronously when H is odd (pairs would not be 4-byte aligned)
  auto prefetch_x = [&](int buf, int t) {
    S* dst = xs + buf * nb * C;
    auto src = [&](int r, int c) {
      return xw + (static_cast<long>(b0 + r) * T + t) * H3 + (c / kc) * H + k0 + c % kc;
    };
    if constexpr (F32) {
      for (int i = tid; i < nb * C; i += THREADS) {
        const int r = i / C, c = i % C;
        if (c % kc < nk) {
          zs::cp_async4(dst + i, src(r, c));
        } else {
          dst[i] = zero;
        }
      }
    } else if ((H & 1) == 0) {
      for (int i = 2 * tid; i < nb * C; i += 2 * THREADS) {
        const int r = i / C, c = i % C;
        if (c % kc < nk) {
          zs::cp_async4(reinterpret_cast<float*>(dst + i), reinterpret_cast<const float*>(src(r, c)));
        } else {
          dst[i] = dst[i + 1] = zero;
        }
      }
    } else {
      for (int i = tid; i < nb * C; i += THREADS) {
        const int r = i / C, c = i % C;
        dst[i] = c % kc < nk ? src(r, c)[0] : zero;
      }
    }
  };
  // the block's columns of wh (rows < Hs) and bh, and the first step's xw,
  // copied asynchronously in f32 (every load in flight at once), element by
  // element in bf16 (once a scan)
  for (int i = tid; i < pl.Hs * C; i += THREADS) {
    const int k = i / C, c = i % C, jj = c % kc;
    const S* w = wh + static_cast<long>(k) * H3 + (c / kc) * H + k0 + jj;
    if (k >= H || jj >= nk) {
      ws[i] = zero;
    } else if constexpr (F32) {
      zs::cp_async4(ws + i, w);
    } else {
      ws[i] = *w;
    }
  }
  for (int c = tid; c < C; c += THREADS) {
    const S* b = bh + (c / kc) * H + k0 + c % kc;
    if (c % kc >= nk) {
      bhs[c] = 0.f;
    } else if constexpr (F32) {
      zs::cp_async4(bhs + c, b);
    } else {
      bhs[c] = to_f32(*b);
    }
  }
  prefetch_x(0, rev ? T - 1 : 0);
  zs::cp_async_commit();
  for (int r = tid; r < nb; r += THREADS) lens[r] = lengths ? lengths[b0 + r] : T;
  for (int i = tid; i < pl.cb * H4; i += THREADS) hs[i] = 0.f;  // h0 = 0, and the padding past H
  zs::cp_async_wait<0>();
  __syncthreads();

  const int c = tid % C, ks = tid / C;  // this thread's column and k-slice in the product
  float4 wr[WREG ? WQ : 1];             // its float4 groups of ws, when they fit
  if constexpr (WREG) {
#pragma unroll
    for (int i = 0; i < WQ; ++i) {
      const int q4 = ks + i * KS;
      wr[i] = ks < KS && q4 < G4 ? wh_group(ws, q4, C, c) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  for (int s = 0; s < T; ++s) {
    const int t = rev ? T - 1 - s : s, tp = rev ? t + 1 : t - 1;
    for (int c0 = 0; c0 < nb; c0 += pl.cb) {  // the same chunks in every thread
      const int nr = min(pl.cb, nb - c0);
      // 1. the chunk's rows of h_{t-1} (at s = 0 still the zeros above: one
      // chunk), and with the first chunk the next step's xw (which does not
      // depend on the state: it arrives while the step runs)
      if (s > 0) {
        const float* src;
        long rstride;
        if constexpr (F32) {  // ys is the f32 state
          src = ys + (static_cast<long>(b0 + c0) * T + tp) * H;
          rstride = static_cast<long>(T) * H;
        } else {  // the other half of the state buffer
          src = state + static_cast<long>((s - 1) & 1) * B * H + static_cast<long>(b0 + c0) * H;
          rstride = H;
        }
        if ((H & 3) == 0) {
          const int w = H / 4;
          for (int i = tid; i < nr * w; i += THREADS) {
            const int r = i / w, kq = i - r * w;
            zs::cp_async16_cg(hs + r * H4 + 4 * kq, src + r * rstride + 4 * kq);
          }
        } else {
          stage_rows_scalar(hs, src, nr, H, H4, rstride);
        }
      }
      zs::cp_async_commit();
      if (c0 == 0) {
        if (s + 1 < T) prefetch_x((s + 1) & 1, rev ? t - 1 : t + 1);
        zs::cp_async_commit();
        zs::cp_async_wait<1>();  // all but the prefetch
      } else {
        zs::cp_async_wait<0>();
      }
      __syncthreads();
      // 2. partial sums of h_{t-1} wh over this thread's k-slice, RR rows at a time
      if (ks < KS) {
        for (int r0 = 0; r0 < nr; r0 += RR) {
          float acc[RR];
#pragma unroll
          for (int r = 0; r < RR; ++r) acc[r] = 0.f;
          if constexpr (WREG) {
#pragma unroll
            for (int i = 0; i < WQ; ++i)
              if (ks + i * KS < G4) accumulate<S>(acc, hs, H4, r0, nr, ks + i * KS, wr[i]);
          } else if constexpr (WIDE) {
            int q4 = ks;
            for (; q4 < GS; q4 += KS) accumulate<S>(acc, hs, H4, r0, nr, q4, wh_group(ws, q4, C, c));
            // the rows past Hs: PK loads in flight before their sums (a
            // thread's reads through L2 would otherwise wait one by one)
            for (; q4 + (PK - 1) * KS < G4; q4 += PK * KS) {
              float4 w[PK];
#pragma unroll
              for (int u = 0; u < PK; ++u) w[u] = wh_group_packed(wg, q4 + u * KS - GS, C, c);
#pragma unroll
              for (int u = 0; u < PK; ++u) accumulate<S>(acc, hs, H4, r0, nr, q4 + u * KS, w[u]);
            }
            for (; q4 < G4; q4 += KS) accumulate<S>(acc, hs, H4, r0, nr, q4, wh_group_packed(wg, q4 - GS, C, c));
          } else {
            for (int q4 = ks; q4 < G4; q4 += KS) accumulate<S>(acc, hs, H4, r0, nr, q4, wh_group(ws, q4, C, c));
          }
#pragma unroll
          for (int r = 0; r < RR; ++r)
            if (r0 + r < nr) part[(ks * pl.cb + r0 + r) * C + c] = acc[r];
        }
      }
      __syncthreads();
      // ... their totals over the k-slices, a thread an output, in a fixed order
      for (int o = tid; o < nr * C; o += THREADS) {
        float v = 0.f;
#pragma unroll 8
        for (int k = 0; k < KS; ++k) v += part[k * pl.cb * C + o];
        hws[o] = v;
      }
      __syncthreads();
      // 3. the gates; h_t of the block's columns into ys (and the state buffer)
      for (int i = tid; i < nr * kc; i += THREADS) {
        const int r = i / kc, jj = i - r * kc, rb = c0 + r;
        if (jj >= nk) continue;
        const S* x = xs + ((s & 1) * nb + rb) * C;
        const float* hw = hws + r * C;
        const float rg = sigmoid(to_f32(x[jj]) + hw[jj] + bhs[jj]);
        const float zg = sigmoid(to_f32(x[kc + jj]) + hw[kc + jj] + bhs[kc + jj]);
        const float ng = tanhf(to_f32(x[2 * kc + jj]) + rg * (hw[2 * kc + jj] + bhs[2 * kc + jj]));
        const float hp = hs[r * H4 + k0 + jj];
        const float hn = t < lens[rb] ? (1.f - zg) * ng + zg * hp : hp;
        ys[(static_cast<long>(b0 + rb) * T + t) * H + k0 + jj] = from_f32<S>(hn);
        if constexpr (!F32) state[static_cast<long>(s & 1) * B * H + static_cast<long>(b0 + rb) * H + k0 + jj] = hn;
      }
      if (c0 + pl.cb < nb) __syncthreads();  // hs, part and hws are refilled by the next chunk
    }
    if (s == T - 1) break;
    // 4. arrive and wait for the group
    zs::step_arrive(gbar);
    zs::step_wait(gbar, static_cast<unsigned>(pl.NK) * (s + 1));
  }
}

cudaError_t card(int* n_sm, int* optin) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (!e) e = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (!e) e = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return e;
}

// The rows a launch takes (all B when they fit, else the largest half,
// quarter, ... that does) and their spread: with the columns of wh whole
// when any number of rows allows it (a large B runs in slices, as it
// always has), else a wide spread. False when not even one row fits.
template <typename S>
bool slice_plan(Plan& p, int& rows, int B, int H, int n_sm, size_t optin) {
  for (const bool wide : {false, true}) {
    for (rows = B;; rows = (rows + 1) / 2) {
      if (make_plan<S>(p, rows, H, n_sm, optin, wide)) return true;
      if (rows == 1) break;
    }
  }
  return false;
}

template <typename S>
int plan_of(int* plan, int B, int H) {
  int n_sm, optin;
  if (cudaError_t e = card(&n_sm, &optin)) return e;
  Plan p{};
  int rows = 0;
  const bool ok = B > 0 && slice_plan<S>(p, rows, B, H, n_sm, static_cast<size_t>(optin));
  long pack = ok ? pack_elems(p, H) : 0;
  Plan last{};
  if (ok && B % rows && make_plan<S>(last, B % rows, H, n_sm, static_cast<size_t>(optin), true))
    pack = std::max(pack, pack_elems(last, H));  // the last slice's own spread
  const int v[10] = {p.kc, p.NK, p.nb, p.NB, p.cb, ok ? static_cast<int>(layout<S>(p, H).total) : 0, rows,
                     ok && wh_in_registers(p, H), std::min(p.Hs, H), static_cast<int>(pack)};
  for (int i = 0; i < 10; ++i) plan[i] = ok ? v[i] : 0;
  return cudaSuccess;
}

template <typename S>
const void* kernel_for(bool wide, bool wreg) {
  return wide ? reinterpret_cast<const void*>(gru_scan_kernel<S, false, true>)
              : wreg ? reinterpret_cast<const void*>(gru_scan_kernel<S, true, false>)
                     : reinterpret_cast<const void*>(gru_scan_kernel<S, false, false>);
}

template <typename S>
int scan(const S* xw, const S* wh, const S* bh, const int* lengths, S* wpack, S* ys, float* state,
         unsigned* bar, int* n_launches, int B, int T, int H, int reverse, void* stream) {
  *n_launches = 0;
  if (B == 0 || T == 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int n_sm, optin;
  cudaError_t e = card(&n_sm, &optin);
  if (e != cudaSuccess) return e;
  Plan pl;
  int rows;
  if (!slice_plan<S>(pl, rows, B, H, n_sm, static_cast<size_t>(optin))) return cudaErrorInvalidConfiguration;
  for (int r0 = 0; r0 < B; r0 += rows) {
    int nrow = B - r0 < rows ? B - r0 : rows;
    Plan p = pl;
    if (nrow != rows && !make_plan<S>(p, nrow, H, n_sm, static_cast<size_t>(optin), true))
      return cudaErrorInvalidConfiguration;
    const size_t smem = layout<S>(p, H).total;
    const bool wide = p.Hs < pad4(H), wreg = wh_in_registers(p, H);
    if (wide) {  // this spread's rows past Hs, in the order its blocks read them
      if (!wpack) return cudaErrorInvalidValue;
      const long n = pack_elems(p, H);
      pack_overflow_kernel<S><<<static_cast<int>(std::min<long>((n + 255) / 256, 8L * n_sm)), 256, 0, st>>>(
          wh, wpack, H, p.kc, p.NK, p.Hs / 4, (pad4(H) - p.Hs) / 4);
      if ((e = cudaGetLastError())) return e;
    }
    const void* kernel = kernel_for<S>(wide, wreg);
    if ((e = zs::allow_smem(kernel, smem))) return e;
    if ((e = cudaMemsetAsync(bar, 0, BAR_STRIDE * p.NB * sizeof(unsigned), st))) return e;
    const S* x = xw + static_cast<long>(r0) * T * 3 * H;
    const int* len = lengths ? lengths + r0 : nullptr;
    const S* wp = wpack;
    S* y = ys + static_cast<long>(r0) * T * H;
    // a slice's state uses the first 2 x nrow x H floats of the buffer
    // (slices run one after another on the stream)
    void* args[] = {&x, &wh, &bh, &len, &wp, &y, &state, &bar, &nrow, &T, &H, &p, &reverse};
    e = cudaLaunchCooperativeKernel(kernel, dim3(p.NK * p.NB), dim3(THREADS), args, smem, st);
    if (e != cudaSuccess) return e;
    ++*n_launches;
  }
  return cudaSuccess;
}

}  // namespace

ZS_DEFINE_ERROR_STRING

// The spread zs_gru_scan picks for B rows on the current device
// (plan[0..9] = kc, NK, nb, NB, cb, a
// block's shared memory in bytes, rows a launch, 1 when wh sits in
// registers, Hs: the rows of the block's columns of wh held in shared
// memory (H unless the spread is wide), and the elements of wpack the
// call needs (0 unless wide); all 0 when none fits), for diagnostics and
// for the wrapper's scratch. Returns a CUDA error.
ZS_EXPORT int zs_gru_scan_plan(int* plan, int B, int H) { return plan_of<float>(plan, B, H); }

// xw [B, T, 3H], wh [H, 3H], bh [3H], lengths [B] int32 or null -> ys
// [B, T, H], all f32. reverse != 0 scans t = T-1 .. 0 (outputs stay in
// original time order). wpack: scratch of plan[9] elements of
// zs_gru_scan_plan (null when that is 0). bar: scratch of 32 x the SM
// count unsigned words (the batch groups' counters). *n_launches (host
// memory) receives the number of cooperative launches made (one unless B
// is split into slices). Returns a CUDA error (cudaErrorInvalidConfiguration
// when not even one row of a wide spread fits a block's shared memory).
ZS_EXPORT int zs_gru_scan(const float* xw, const float* wh, const float* bh, const int* lengths,
                          float* wpack, float* ys, unsigned* bar, int* n_launches, int B, int T, int H,
                          int reverse, void* stream) {
  return scan<float>(xw, wh, bh, lengths, wpack, ys, nullptr, bar, n_launches, B, T, H, reverse, stream);
}
