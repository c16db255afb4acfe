// Kernel 2, bf16 mode: the GRU recurrence, forward and (length-masked)
// reverse, with xw, wh, bh and ys in bf16 and the state in f32, in ONE
// cooperative launch a scan, its product on the tensor cores.
//
// Replaces zerospeech_tts_tpu/ops/pallas_gru.py::pallas_gru_scan in its
// bf16 mode (:84, bf16 semantics at :141-146). Given the hoisted input
// projections xw = x Wi + bi [B, T, 3H], each step computes
//     hw = bf16(h) wh + bh;  r, z = sigmoid(x_{r,z} + hw_{r,z})
//     n  = tanh(x_n + r * hw_n);  h' = (1 - z) n + z h
// (gate order r, z, n): the product takes h rounded to bf16 once, with
// exact products and f32 sums; the state and the gates stay f32 for the
// whole scan; ys stores bf16(h_t). With `lengths` (reverse scans only)
// steps at t >= lengths[b] pass the state through.
//
// What bounds it on an H100: the serial chain of T dependent steps. A step
// is B x 3H x H multiply-adds (25.2 MFLOP at B=16, H=512: 0.03 us of the
// tensor cores' bf16 rate) and needs every column of the previous step's
// h, so a step costs a barrier among the blocks of a batch group and one
// L2 round trip for h, plus the work each block does between the two.
//
// Design (the f32 mode, csrc/gru.cu, keeps its own design): a cooperative
// launch runs all T steps; blocks form NK column groups x NB batch groups
// (make_plan); block (g, q) owns kc hidden columns j and with them the
// gate columns {j, H+j, 2H+j}, and meets the other NK - 1 blocks of its
// batch group at a counter of their own (zs::step_arrive / step_wait).
//   - The product runs on the tensor cores, mma.sync m16n8k16 bf16 -> f32:
//     A = the group's rows of bf16(h_{t-1}) (ldmatrix; rows past nb read
//     a real row and their results are dropped), B = the block's 3kc gate
//     columns padded to n-tiles of 8, K = H in k-tiles of 16 (padded with
//     zeros). Warp w sums the k-tiles w, w + NW, ... in that order; the
//     warps' 16 x 8 partial tiles meet in shared memory and each output is
//     their sum in warp order, so a run is deterministic. wgmma is not the
//     tool: it takes M = 64 rows a warpgroup and this path has 1-16.
//   - B's fragments, laid out as each lane holds them, are read from wh
//     once a scan: into registers when a warp's share fits (KR k-tiles of
//     at most NG n-tiles: every shipped path, H <= 512), else into shared
//     memory (a batch too large beside them runs in slices of fewer rows).
//     Past what shared memory holds even for one row (H above ~2,110 on an
//     H100: the wide mode), k-tiles KS.. are packed per call into `wpack`
//     in the same layout and read each step through L2, PKW k-tiles of
//     loads in flight a warp.
//   - h crosses between blocks in bf16: ys[:, t-1] (reverse: t+1) already
//     holds bf16(h_{t-1}), the product's input bit for bit, so each step
//     stages the group's rows from ys (cp.async.cg, through L2): half the
//     bytes of an f32 state. Each block keeps the f32 state of its own
//     columns and rows in shared memory for z h and the masked
//     pass-through, so h is rounded exactly once, where ys is written, and
//     no state buffer exists.
//   - xw of the next step is copied (cp.async, double-buffered) while the
//     step runs; it does not depend on the state.
// A step: stage h; the product; one bar.sync; the gates (h_t into ys and
// the block's state); arrive and wait. Any B runs (a batch too large for
// the shared memory runs in slices, a launch each), and any H.
#include <cuda_bf16.h>

#include <algorithm>
#include <cmath>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;  // warps: warp w sums the k-tiles w, w + NW, ... of a step's product
constexpr int NG = 8;             // n-tiles a warp accumulates at once (an n-tile: 8 gate columns)
constexpr int KR = 4;             // k-tiles a warp holds in registers (register mode: NG n-tiles each)
constexpr int PKW = 2;            // wide: k-tiles of fragments a warp loads from L2 before their products
constexpr int BAR_STRIDE = 32;    // unsigned words between batch groups' counters (128 bytes)

// kc hidden columns and nb batch rows a block; NK x NB blocks (blockIdx.x
// = group * NK + column group); KS k-tiles of the block's fragments of wh
// in shared memory (all KT unless the spread is wide; 0 in register mode).
struct Plan {
  int kc, NK, nb, NB, KS, wreg;
};

// 3kc gate columns in NT n-tiles of 8; KT k-tiles of 16 rows; MT m-tiles
// of 16 batch rows; staged rows LDA bf16 apart (16 bytes past the k-tiles,
// so ldmatrix's eight rows fall in distinct banks); partial rows PN floats
// apart.
struct Dims {
  int C, NT, KT, MT, LDA, PN;
};

__host__ __device__ inline Dims dims(const Plan& p, int H) {
  Dims d;
  d.C = 3 * p.kc;
  d.NT = (d.C + 7) / 8;
  d.KT = (H + 15) / 16;
  d.MT = (p.nb + 15) / 16;
  d.LDA = 16 * d.KT + 8;
  d.PN = 8 * d.NT + 4;
  return d;
}

// Byte offsets of a block's shared-memory arrays (frag at 0) and their total.
struct Layout {
  size_t hs, part, xs, bhs, hown, lens, total;
};

__host__ __device__ inline Layout layout(const Plan& p, int H) {
  const Dims d = dims(p, H);
  Layout L;
  L.hs = static_cast<size_t>(p.KS) * d.NT * 32 * sizeof(uint2);             // frag [KS][NT][32]
  L.part = L.hs + static_cast<size_t>(p.nb) * d.LDA * sizeof(bf16);         // hs [nb][LDA]: bf16(h_{t-1})
  L.xs = L.part + static_cast<size_t>(NW) * p.nb * d.PN * sizeof(float);    // part [NW][nb][PN]
  L.bhs = L.xs + (2 * static_cast<size_t>(p.nb) * d.C * sizeof(bf16) + 15) / 16 * 16;  // xs [2][nb][C]
  L.hown = L.bhs + d.C * sizeof(float);                                      // bhs [C] f32
  L.lens = L.hown + static_cast<size_t>(p.nb) * p.kc * sizeof(float);       // hown [nb][kc]: the f32 state
  L.total = L.lens + p.nb * sizeof(int);                                     // lens [nb]
  return L;
}

// Elements (bf16) of wpack a plan reads: per column group, its k-tiles
// KS.. of fragments (0 unless the spread is wide).
long pack_elems(const Plan& p, int H) {
  const Dims d = dims(p, H);
  return p.wreg || p.KS >= d.KT ? 0 : static_cast<long>(p.NK) * (d.KT - p.KS) * d.NT * 32 * 4;
}

// The spread for B rows on a card of n_sm SMs with optin bytes of shared
// memory a block: for each column-group count NK, as many batch groups as
// the SMs left over allow; the fragments in registers when a warp's share
// fits, else in shared memory (pass 0), else (`wide`, pass 1) the first KS
// k-tiles that fit there and the rest through L2. Of these, the least
// estimated step time in microseconds: the block's staged rows, the
// mma.sync a warp issues, the rounds of the gate epilogue, the arrivals at
// the group's counter, and in the wide mode the block's fragment bytes
// from L2 (~25 KB/us, an SM's share of the card's memory rate). The
// weights were fitted by least squares (non-negative) to bf16 step times
// on an H100 at H=512 with the column-group count forced
// (tools/gru_spread_sweep.py --bf16), B = 1 to 128; PERF.md keeps that
// table. False when none fits.
bool make_plan(Plan& best, int B, int H, int n_sm, size_t optin, bool wide) {
  double best_cost = -1.0;
  const int KT = (H + 15) / 16, kpw = (KT + NW - 1) / NW;
  auto consider = [&](const Plan& p) {
    const Dims d = dims(p, H);
    const double wide_bytes = 256.0 * d.NT * d.MT * (p.wreg ? 0 : KT - p.KS);
    const double cost = 0.0577 * p.nb * H / 512 + 0.0317 * d.MT * d.NT * kpw
                        + 0.642 * ((p.nb * p.kc + THREADS - 1) / THREADS) + 0.00564 * p.NK + wide_bytes / 25e3;
    if (best_cost < 0 || cost < best_cost) {
      best = p;
      best_cost = cost;
    }
  };
  for (int pass = 0; pass < (wide ? 2 : 1) && best_cost < 0; ++pass) {
    for (int nk = 1; nk <= H && nk <= n_sm; ++nk) {
      Plan p;
      p.kc = (H + nk - 1) / nk;
      p.kc += p.kc & 1;  // xw's columns are copied two at a time
      p.NK = (H + p.kc - 1) / p.kc;
      if (p.NK != nk) continue;  // the same spread as another nk
      const int nbg = n_sm / p.NK < B ? n_sm / p.NK : B;
      p.nb = (B + nbg - 1) / nbg;
      p.NB = (B + p.nb - 1) / p.nb;
      const Dims d = dims(p, H);
      p.wreg = pass == 0 && d.NT <= NG && kpw <= KR;
      p.KS = p.wreg ? 0 : KT;
      if (pass == 0) {
        if (layout(p, H).total <= optin) consider(p);
        continue;
      }
      p.KS = 0;
      const size_t base = layout(p, H).total;
      if (base > optin) continue;
      p.KS = static_cast<int>(std::min<size_t>((optin - base) / (d.NT * 32 * sizeof(uint2)), KT - 1));
      consider(p);
    }
  }
  return best_cost >= 0;
}

__device__ inline float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// The B fragment of mma.m16n8k16 (.col) that lane `lane` holds for k-tile
// kt and n-tile nt of column group q: {W[k][n], W[k+1][n]} and {W[k+8][n],
// W[k+9][n]} (the lower k in the lower half), k = 16 kt + 2 (lane % 4), n =
// 8 nt + lane / 4, where W[k][c] = wh[k][(c / kc) H + q kc + c % kc] and 0
// past H rows, past the group's columns and past 3kc.
__device__ inline uint2 b_fragment(const bf16* wh, int H, int kc, int q, int kt, int nt, int lane) {
  const int n = 8 * nt + lane / 4, k = 16 * kt + 2 * (lane % 4), col = q * kc + n % kc;
  const bool ok = n < 3 * kc && col < H;
  const bf16* w = ok ? wh + (n / kc) * H + col : wh;
  auto at = [&](int kk) { return ok && kk < H ? w[static_cast<long>(kk) * 3 * H] : __float2bfloat16_rn(0.f); };
  const __nv_bfloat162 lo = __halves2bfloat162(at(k), at(k + 1)), hi = __halves2bfloat162(at(k + 8), at(k + 9));
  return make_uint2(*reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
}

// wpack[q][kt - KS][nt][lane] = b_fragment(.., q, kt, nt, lane) for k-tiles
// kt = KS..KT-1 of every column group q: what a wide spread reads from L2,
// in the order its warps read it (a warp's 32 lanes: 256 bytes in a row).
__global__ void pack_fragments_kernel(const bf16* __restrict__ wh, uint2* __restrict__ wpack, int H, int kc,
                                      int NK, int KS, int KT, int NT) {
  const long n = static_cast<long>(NK) * (KT - KS) * NT * 32;
  for (long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long>(gridDim.x) * blockDim.x) {
    const long r = i / 32;
    const int nt = static_cast<int>(r % NT), kt = KS + static_cast<int>(r / NT % (KT - KS));
    wpack[i] = b_fragment(wh, H, kc, static_cast<int>(r / NT / (KT - KS)), kt, nt, static_cast<int>(i % 32));
  }
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&a)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(zs::smem_addr(p)));
}

// d += a b on the tensor cores: 16 x 16 bf16 by 16 x 8 bf16, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// WREG: a warp's fragments in registers (NT <= NG, at most KR k-tiles a
// warp); WIDE: k-tiles KS.. come from wpack (never both)
template <bool WREG, bool WIDE>
__global__ void __launch_bounds__(THREADS, 1)
gru_scan_bf16_kernel(const bf16* __restrict__ xw, const bf16* __restrict__ wh, const bf16* __restrict__ bh,
                     const int* __restrict__ lengths, const uint2* __restrict__ wpack, bf16* ys, unsigned* bar,
                     int B, int T, int H, Plan pl, int rev) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(pl, H);
  const Dims d = dims(pl, H);
  const int kc = pl.kc, C = d.C, H3 = 3 * H, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = blockIdx.x / pl.NK, q = blockIdx.x % pl.NK;
  const int k0 = q * kc, nk = min(kc, H - k0), b0 = g * pl.nb, nb = min(pl.nb, B - b0);
  const int kpw = (d.KT - warp + NW - 1) / NW;  // this warp's k-tiles: warp, warp + NW, ...
  uint2* frag = reinterpret_cast<uint2*>(smem);                // [KS][NT][32]: fragments of k-tiles < KS
  bf16* hs = reinterpret_cast<bf16*>(smem + L.hs);            // [nb][LDA]: bf16(h_{t-1}) of the group's rows
  float* part = reinterpret_cast<float*>(smem + L.part);      // [NW][nb][PN]: each warp's partial products
  bf16* xs = reinterpret_cast<bf16*>(smem + L.xs);            // [2][nb][C]: this step's and the next step's xw
  float* bhs = reinterpret_cast<float*>(smem + L.bhs);        // [C]
  float* hown = reinterpret_cast<float*>(smem + L.hown);      // [nb][kc]: the f32 state of the block's columns
  int* lens = reinterpret_cast<int*>(smem + L.lens);          // [nb]
  unsigned* gbar = bar + BAR_STRIDE * g;
  const uint2* wg = WIDE ? wpack + static_cast<long>(q) * (d.KT - pl.KS) * d.NT * 32 : nullptr;
  const bf16 zero = __float2bfloat16_rn(0.f);

  // xs[buf][r][gate kc + jj] = xw[b0 + r, t, gate H + k0 + jj], copied
  // asynchronously two columns a copy (kc even, so a pair never straddles
  // a gate), or one at a time synchronously when H is odd (pairs would not
  // be 4-byte aligned); 0 past the block's last column
  auto prefetch_x = [&](int buf, int t) {
    bf16* dst = xs + buf * nb * C;
    auto src = [&](int r, int c) {
      return xw + (static_cast<long>(b0 + r) * T + t) * H3 + (c / kc) * H + k0 + c % kc;
    };
    if ((H & 1) == 0) {
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
  // once a scan: the fragments (shared memory or registers), bh, the
  // first step's xw, h0 = 0 (and the padding past H, never written)
  for (int i = tid; i < pl.KS * d.NT * 32; i += THREADS)
    frag[i] = b_fragment(wh, H, kc, q, i / 32 / d.NT, i / 32 % d.NT, i % 32);
  for (int c = tid; c < C; c += THREADS)
    bhs[c] = c % kc < nk ? __bfloat162float(bh[(c / kc) * H + k0 + c % kc]) : 0.f;
  prefetch_x(0, rev ? T - 1 : 0);
  zs::cp_async_commit();
  for (int r = tid; r < nb; r += THREADS) lens[r] = lengths ? lengths[b0 + r] : T;
  for (int i = tid; i < nb * kc; i += THREADS) hown[i] = 0.f;
  for (int i = tid; i < nb * d.LDA; i += THREADS) hs[i] = zero;
  uint2 breg[WREG ? KR : 1][WREG ? NG : 1];
  if constexpr (WREG) {
#pragma unroll
    for (int kk = 0; kk < KR; ++kk)
#pragma unroll
      for (int j = 0; j < NG; ++j)
        breg[kk][j] = kk < kpw && j < d.NT ? b_fragment(wh, H, kc, q, warp + kk * NW, j, lane) : make_uint2(0, 0);
  }
  zs::cp_async_wait<0>();
  __syncthreads();

  // the A fragment of k-tile kt, m-tile mt (rows past nb read row nb - 1;
  // their results are never stored)
  auto load_a = [&](unsigned(&a)[4], int mt, int kt) {
    ldmatrix_x4(a, hs + min(16 * mt + lane % 16, nb - 1) * d.LDA + 16 * kt + 8 * (lane / 16));
  };
  for (int s = 0; s < T; ++s) {
    const int t = rev ? T - 1 - s : s, tp = rev ? t + 1 : t - 1;
    // 1. the group's rows of bf16(h_{t-1}) = ys[:, tp] (at s = 0 the zeros
    // above), and the next step's xw, which arrives while the step runs
    if (s > 0) {
      const bf16* src = ys + (static_cast<long>(b0) * T + tp) * H;
      const long rs = static_cast<long>(T) * H;
      if ((H & 7) == 0) {
        const int w = H / 8;
        for (int i = tid; i < nb * w; i += THREADS) {
          const int r = i / w, kq = i - r * w;
          zs::cp_async16_cg(reinterpret_cast<float*>(hs + r * d.LDA + 8 * kq),
                            reinterpret_cast<const float*>(src + r * rs + 8 * kq));
        }
      } else {  // rows not 16-byte aligned: element by element, through L2
        for (int i = tid; i < nb * H; i += THREADS) {
          const int r = i / H, k = i - r * H;
          hs[r * d.LDA + k] = __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(src + r * rs + k)));
        }
      }
    }
    zs::cp_async_commit();
    if (s + 1 < T) prefetch_x((s + 1) & 1, rev ? t - 1 : t + 1);
    zs::cp_async_commit();
    zs::cp_async_wait<1>();  // all but the prefetch
    __syncthreads();
    // 2. this warp's partial product over its k-tiles, NG n-tiles at a time
    for (int mt = 0; mt < d.MT; ++mt) {
      for (int n0 = 0; n0 < d.NT; n0 += NG) {
        float acc[NG][4];
#pragma unroll
        for (int j = 0; j < NG; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
        unsigned a[4];
        if constexpr (WREG) {
#pragma unroll
          for (int kk = 0; kk < KR; ++kk) {
            if (kk < kpw) {
              load_a(a, mt, warp + kk * NW);
#pragma unroll
              for (int j = 0; j < NG; ++j)
                if (j < d.NT) mma_bf16(acc[j], a, breg[kk][j]);
            }
          }
        } else {
          int kk = 0;
          for (; kk < kpw && warp + kk * NW < pl.KS; ++kk) {
            const int kt = warp + kk * NW;
            const uint2* f = frag + (kt * d.NT + n0) * 32 + lane;
            load_a(a, mt, kt);
#pragma unroll
            for (int j = 0; j < NG; ++j)
              if (n0 + j < d.NT) mma_bf16(acc[j], a, f[32 * j]);
          }
          if constexpr (WIDE) {
            for (; kk < kpw; kk += PKW) {  // PKW k-tiles' loads in flight before their products
              uint2 b[PKW][NG];
#pragma unroll
              for (int u = 0; u < PKW; ++u)
#pragma unroll
                for (int j = 0; j < NG; ++j)
                  b[u][j] = kk + u < kpw && n0 + j < d.NT
                                ? __ldg(wg + ((warp + (kk + u) * NW - pl.KS) * d.NT + n0 + j) * 32 + lane)
                                : make_uint2(0, 0);
#pragma unroll
              for (int u = 0; u < PKW; ++u) {
                if (kk + u < kpw) {
                  load_a(a, mt, warp + (kk + u) * NW);
#pragma unroll
                  for (int j = 0; j < NG; ++j)
                    if (n0 + j < d.NT) mma_bf16(acc[j], a, b[u][j]);
                }
              }
            }
          }
        }
        // d0, d1: row lane / 4, columns 2 (lane % 4) + {0, 1}; d2, d3: 8 rows down
        const int r0 = 16 * mt + lane / 4;
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          if (n0 + j < d.NT) {
            float* p = part + (warp * pl.nb + r0) * d.PN + 8 * (n0 + j) + 2 * (lane % 4);
            if (r0 < nb) *reinterpret_cast<float2*>(p) = make_float2(acc[j][0], acc[j][1]);
            if (r0 + 8 < nb) *reinterpret_cast<float2*>(p + 8 * d.PN) = make_float2(acc[j][2], acc[j][3]);
          }
        }
      }
    }
    __syncthreads();
    // 3. the gates: hw as the warps' partials summed in warp order; h_t of
    // the block's columns into its state and, rounded once, into ys[:, t]
    for (int i = tid; i < nb * kc; i += THREADS) {
      const int r = i / kc, jj = i - r * kc;
      if (jj >= nk) continue;
      float hw[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float* p = part + (w * pl.nb + r) * d.PN + jj;
        hw[0] += p[0];
        hw[1] += p[kc];
        hw[2] += p[2 * kc];
      }
      const bf16* x = xs + ((s & 1) * nb + r) * C;
      const float rg = sigmoid(__bfloat162float(x[jj]) + hw[0] + bhs[jj]);
      const float zg = sigmoid(__bfloat162float(x[kc + jj]) + hw[1] + bhs[kc + jj]);
      const float ng = tanhf(__bfloat162float(x[2 * kc + jj]) + rg * (hw[2] + bhs[2 * kc + jj]));
      const float hp = hown[i];
      const float hn = t < lens[r] ? (1.f - zg) * ng + zg * hp : hp;
      hown[i] = hn;
      ys[(static_cast<long>(b0 + r) * T + t) * H + k0 + jj] = __float2bfloat16_rn(hn);
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
// quarter, ... that does) and their spread: fragments on chip when any
// number of rows allows it, else a wide spread. False when not even one
// row fits.
bool slice_plan(Plan& p, int& rows, int B, int H, int n_sm, size_t optin) {
  for (const bool wide : {false, true}) {
    for (rows = B;; rows = (rows + 1) / 2) {
      if (make_plan(p, rows, H, n_sm, optin, wide)) return true;
      if (rows == 1) break;
    }
  }
  return false;
}

const void* kernel_for(const Plan& p, int H) {
  if (p.wreg) return reinterpret_cast<const void*>(gru_scan_bf16_kernel<true, false>);
  return p.KS < dims(p, H).KT ? reinterpret_cast<const void*>(gru_scan_bf16_kernel<false, true>)
                              : reinterpret_cast<const void*>(gru_scan_bf16_kernel<false, false>);
}

int plan_of(int* plan, int B, int H) {
  int n_sm, optin;
  if (cudaError_t e = card(&n_sm, &optin)) return e;
  Plan p{};
  int rows = 0;
  const bool ok = B > 0 && slice_plan(p, rows, B, H, n_sm, static_cast<size_t>(optin));
  long pack = ok ? pack_elems(p, H) : 0;
  Plan last{};
  if (ok && B % rows && make_plan(last, B % rows, H, n_sm, static_cast<size_t>(optin), true))
    pack = std::max(pack, pack_elems(last, H));  // the last slice's own spread
  const int hs = p.wreg ? H : std::min(16 * p.KS, H);
  const int v[10] = {p.kc, p.NK, p.nb, p.NB, p.nb, ok ? static_cast<int>(layout(p, H).total) : 0, rows,
                     p.wreg, hs, static_cast<int>(pack)};
  for (int i = 0; i < 10; ++i) plan[i] = ok ? v[i] : 0;
  return cudaSuccess;
}

int scan(const bf16* xw, const bf16* wh, const bf16* bh, const int* lengths, uint2* wpack, bf16* ys,
         unsigned* bar, int* n_launches, int B, int T, int H, int reverse, void* stream) {
  *n_launches = 0;
  if (B == 0 || T == 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int n_sm, optin;
  cudaError_t e = card(&n_sm, &optin);
  if (e != cudaSuccess) return e;
  Plan pl;
  int rows;
  if (!slice_plan(pl, rows, B, H, n_sm, static_cast<size_t>(optin))) return cudaErrorInvalidConfiguration;
  for (int r0 = 0; r0 < B; r0 += rows) {
    int nrow = B - r0 < rows ? B - r0 : rows;
    Plan p = pl;
    if (nrow != rows && !make_plan(p, nrow, H, n_sm, static_cast<size_t>(optin), true))
      return cudaErrorInvalidConfiguration;
    const Dims d = dims(p, H);
    const size_t smem = layout(p, H).total;
    if (const long n = pack_elems(p, H) / 4) {  // this spread's k-tiles past KS, as its warps read them
      if (!wpack) return cudaErrorInvalidValue;
      pack_fragments_kernel<<<static_cast<int>(std::min<long>((n + 255) / 256, 8L * n_sm)), 256, 0, st>>>(
          wh, wpack, H, p.kc, p.NK, p.KS, d.KT, d.NT);
      if ((e = cudaGetLastError())) return e;
    }
    const void* kernel = kernel_for(p, H);
    if ((e = zs::allow_smem(kernel, smem))) return e;
    if ((e = cudaMemsetAsync(bar, 0, BAR_STRIDE * p.NB * sizeof(unsigned), st))) return e;
    const bf16* x = xw + static_cast<long>(r0) * T * 3 * H;
    const int* len = lengths ? lengths + r0 : nullptr;
    const uint2* wp = wpack;
    bf16* y = ys + static_cast<long>(r0) * T * H;
    void* args[] = {&x, &wh, &bh, &len, &wp, &y, &bar, &nrow, &T, &H, &p, &reverse};
    e = cudaLaunchCooperativeKernel(kernel, dim3(p.NK * p.NB), dim3(THREADS), args, smem, st);
    if (e != cudaSuccess) return e;
    ++*n_launches;
  }
  return cudaSuccess;
}

}  // namespace

ZS_DEFINE_ERROR_STRING

// The spread zs_gru_scan_bf16 picks for B rows on the current device
// (plan[0..9] = kc, NK, nb, NB, nb again (rows staged at once), a block's
// shared memory in bytes, rows a launch, 1 when the fragments of wh sit in
// registers, Hs: the rows of the block's columns of wh on chip (H unless
// the spread is wide), and the bf16 elements of wpack the call needs (0
// unless wide); all 0 when none fits). Returns a CUDA error.
ZS_EXPORT int zs_gru_scan_bf16_plan(int* plan, int B, int H) { return plan_of(plan, B, H); }

// xw [B, T, 3H], wh [H, 3H], bh [3H] bf16, lengths [B] int32 or null ->
// ys [B, T, H] bf16, the state f32 on chip. reverse != 0 scans t = T-1 ..
// 0 (outputs stay in original time order). wpack: scratch of plan[9] bf16
// elements of zs_gru_scan_bf16_plan, 8-byte aligned (null when that is
// 0). bar: scratch of 32 x the SM count unsigned words. *n_launches (host
// memory) receives the number of cooperative launches made (one unless B
// is split into slices). Returns a CUDA error.
ZS_EXPORT int zs_gru_scan_bf16(const void* xw, const void* wh, const void* bh, const int* lengths, void* wpack,
                               void* ys, unsigned* bar, int* n_launches, int B, int T, int H, int reverse,
                               void* stream) {
  return scan(static_cast<const bf16*>(xw), static_cast<const bf16*>(wh), static_cast<const bf16*>(bh), lengths,
              static_cast<uint2*>(wpack), static_cast<bf16*>(ys), bar, n_launches, B, T, H, reverse, stream);
}
