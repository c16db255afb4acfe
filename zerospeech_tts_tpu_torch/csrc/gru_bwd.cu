// Kernel 3: backward pass of the unmasked GRU scan, either time direction.
//
// Replaces zerospeech_tts_tpu/ops/pallas_gru.py::_gru_bwd_call. From the
// forward inputs xw [B, T, 3H], wh [H, 3H], bh [3H], the outputs ys
// [B, T, H] and their gradient dys it computes dxw [B, T, 3H], dwh [H, 3H]
// and dbh [3H]. The forward scan ran in time order (rev = 0: h_{t-1} =
// ys[:, t-1]) or back to front (rev = 1: h_{t-1} means ys[:, t+1]), with
// the first step's state 0. Walking the scan's steps backwards:
//     hw = h_{t-1} wh + bh;  r, z = sigmoid(x_{r,z} + hw_{r,z});
//     n  = tanh(x_n + r hw_n);  dh += dys_t
//     dn = dh (1-z)(1-n^2);  dz = dh (h_{t-1} - n) z (1-z);  dr = dn hw_n r (1-r)
//     dxw_t = [dr, dz, dn];  dhw_t = [dr, dz, dn r];  dh <- dh z + dhw_t wh^T
//     dwh = sum_t h_{t-1}^T dhw_t;  dbh = sum_{b,t} dhw_t
//
// What bounds it on an H100: three products of 2 B T H 3H FMAs each
// (hw, the dh recurrence, dwh), f32 CUDA-core FLOPs (6.4 GFLOP each at
// B=32, T=128, H=512: ~0.29 ms at 67 TFLOP/s). Only the dh recurrence is
// serial: T dependent steps of a [B, 3H] x [3H, H] product, each far below
// a microsecond of arithmetic, so step latency sets the time.
//
// Design: the products that do not depend on the carry run as parallel
// passes, and the recurrence runs in ONE persistent launch:
//   1. hw for all B*T rows at once (a tiled f32 product, 128 x 128 tiles,
//      8 x 8 outputs a thread), into a scratch buffer;
//   2. the recurrence, a cooperative launch (every block co-resident, at
//      most one per SM). Blocks form a grid of NB batch groups x NK column
//      groups: block (g, q) owns nb = ceil(B / NB) batch rows and kc =
//      ceil(H / NK) columns K of dh. Its rows wh[K, :] (kc x 3H f32) are
//      loaded into shared memory once and stay there; beside them it
//      stages its batch rows of dhw_t cb at a time (make_plan: the fewest
//      chunks, then the fewest column groups; NK = 16, kc = 32, NB = 8,
//      nb = cb = 4: 128 blocks at B=32 H=512). Only kc x 3H bounds H; any
//      B has a spread, in more chunks. The block's dh carry stays in [B, H]
//      scratch that no other block touches. The recurrence of a batch row
//      needs only that row's dhw, so only the NK blocks of a batch group
//      wait for each other. Step t:
//        a. elementwise on its rows and columns: dh += dys_t, recompute r,
//           z, n from xw_t, hw_t and h_{t-1}, write dxw_t and dhw_t for
//           the columns {K, H+K, 2H+K} (dhw_t into the [B, T, 3H] scratch
//           that the dwh pass reads; row t is written once, so it is also
//           the exchange between blocks);
//        b. barrier of the batch group (common.cuh grid_barrier on the
//           group's own counter);
//        c. per chunk, stage its rows of dhw_t from L2 into shared memory,
//           then dh[rows, K] = dh z + dhw_t wh[K, :]^T: a warp takes a
//           2-row x 4-column tile, its lanes stride over the 3H terms and
//           reduce with shuffles; where tiles are fewer than warps, the 3H
//           terms are split between warps and their sums added in a fixed
//           order.
//      A step costs a group barrier and an L2 read of nb rows (24 KB at
//      B=32), not a launch and a re-read of wh (3 MB). Wide H: a block's
//      kc rows of wh fit beside one staged row up to H of about 1,480 on
//      an H100; past that (make_plan's second pass) the block keeps its
//      first Kr rows (a multiple of the tile's 4 columns) in shared memory
//      and its warps read the tiles of the other rows straight from wh,
//      whose rows are already contiguous, with read-only loads through L2
//      each step. Such a step is bound by those reads;
//   3. dwh = h_prev^T dhw over all B*T rows (the same tiled product, A read
//      transposed, split over K into enough slices to fill the card, their
//      partial products summed in a fixed order) and dbh as column sums (8
//      row slices a column, reduced in shared memory): deterministic, no
//      atomics.
// Tensor-core products and the passes' fusion into the recurrence are
// later work.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int TM = 128, TN = 128, TK = 8;  // product tile
constexpr int GEMM_THREADS = 256;          // 16 x 16 threads, 8 x 8 outputs each
constexpr int REC_THREADS = 512;          // recurrence block: 16 warps
constexpr int NWARPS = REC_THREADS / 32;
constexpr int RB = 2;                     // batch rows of a warp's tile
constexpr int KG = 4;                     // dh columns of a warp's tile

__device__ inline float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// h_{t-1} of flat row m = b * T + t, column k: ys one step earlier in the
// scan's own order, 0 at its first step.
__device__ inline float hprev_at(const float* __restrict__ ys, int m, int k, int T, int H,
                                 int rev) {
  const int t = m % T;
  if (rev) return t < T - 1 ? ys[static_cast<long>(m + 1) * H + k] : 0.f;
  return t ? ys[static_cast<long>(m - 1) * H + k] : 0.f;
}

// C[M, N] = A[M, K] Bm[K, N] (+ bias[N]), or with split-K (gridDim.z = S
// > 1) S partial products over K slices of kslice, into C + z M N.
// TRANS == false: A(m, k) = h_prev(row m, column k) (the hw pass, M = B*T,
// K = H). TRANS == true: A(m, k) = h_prev(row k, column m) (the dwh pass,
// M = H, K = B*T). 128 x 128 tiles, 8 deep; a thread computes 8 x 8
// outputs from float4 reads of the tiles, and loads the next tiles into
// registers while it computes on the current ones.
template <bool TRANS>
__global__ void __launch_bounds__(GEMM_THREADS)
hprev_gemm_kernel(const float* __restrict__ ys, const float* __restrict__ Bm,
                  const float* __restrict__ bias, float* __restrict__ C, int M, int N, int K,
                  int kslice, int T, int H, int rev) {
  __shared__ __align__(16) float As[TK][TM + 4];
  __shared__ __align__(16) float Bs[TK][TN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int kb = blockIdx.z * kslice, ke = min(K, kb + kslice);
  float a_next[4], b_next[4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = tid + u * GEMM_THREADS;
      // consecutive threads read consecutive addresses of ys
      const int mm = TRANS ? i % TM : i / TK, kk = TRANS ? i / TM : i % TK;
      const int m = m0 + mm, k = k0 + kk;
      a_next[u] = m < M && k < ke ? (TRANS ? hprev_at(ys, k, m, T, H, rev) : hprev_at(ys, m, k, T, H, rev))
                                  : 0.f;
      const int kb_ = i / TN, nn = i % TN, kB = k0 + kb_, n = n0 + nn;
      b_next[u] = kB < ke && n < N ? Bm[static_cast<long>(kB) * N + n] : 0.f;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = tid + u * GEMM_THREADS;
      const int mm = TRANS ? i % TM : i / TK, kk = TRANS ? i / TM : i % TK;
      As[kk][mm] = a_next[u];
      Bs[i / TN][i % TN] = b_next[u];
    }
  };
  float acc[8][8] = {};
  fetch(kb);
  for (int k0 = kb; k0 < ke; k0 += TK) {
    store();
    __syncthreads();
    if (k0 + TK < ke) fetch(k0 + TK);
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = C + static_cast<long>(blockIdx.z) * M * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < N) out[static_cast<long>(m) * N + n] = acc[i][j] + (bias ? bias[n] : 0.f);
    }
  }
}

// out[i] = sum over the S partials part[s, i], in order s = 0 .. S-1.
__global__ void sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out, int S,
                                    long n) {
  for (long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long>(gridDim.x) * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < S; ++s) v += part[s * n + i];
    out[i] = v;
  }
}

// How the recurrence is spread: kc columns and nb batch rows a block, NK x
// NB blocks (blockIdx.x = group * NK + column group); the block's rows of
// dhw_t are staged cb at a time; its first Kr rows of wh (all kc unless
// the spread is wide) sit in shared memory.
struct Plan {
  int kc, nb, cb, NK, NB, Kr;
};

int tiles(int rows, int kc) { return ((rows + RB - 1) / RB) * ((kc + KG - 1) / KG); }

size_t rec_smem_bytes(const Plan& p, int H) {
  const int nt = tiles(p.cb, p.kc), slots = nt > NWARPS ? nt : NWARPS;
  return (static_cast<size_t>(p.Kr + p.cb) * 3 * H  // wh rows, a chunk of staged dhw rows
          + static_cast<size_t>(slots) * RB * KG)    // warp partial sums
         * sizeof(float);
}

// The rows of wh a batch group's blocks hold in shared memory (H unless
// the spread is wide).
int rows_on_chip(const Plan& p, int H) {
  int n = 0;
  for (int q = 0; q < p.NK; ++q) n += std::min(p.Kr, std::min(p.kc, H - q * p.kc));
  return n;
}

// The spread on a card of n_sm SMs with optin bytes of shared memory a
// block. For each column-group count NK (NK <= n_sm), as many batch groups
// as the SMs left over allow (NK x NB <= n_sm), and the largest chunk of
// staged rows that fits beside the block's rows of wh; of these, the fewest
// chunks, then the fewest column groups. Any B has a spread, in more
// chunks. When no NK leaves room for its kc rows and one staged row (wide
// H), every NK and chunk count is tried with as many of the rows (Kr, a
// multiple of KG) in shared memory as fit, and the least estimated step
// time wins: each chunk's tiles of RB batch rows read the other rows of wh
// once (bytes over ~25 KB/us), plus ~2 us a chunk. False when not even one
// staged row fits.
bool make_plan(Plan& best, int B, int H, int n_sm, size_t optin) {
  const size_t row = 3 * static_cast<size_t>(H) * sizeof(float);
  int best_chunks = 0;
  for (int nk = 1; nk <= H && nk <= n_sm; ++nk) {
    Plan p;
    p.kc = (H + nk - 1) / nk;
    p.NK = (H + p.kc - 1) / p.kc;
    const int nbg = n_sm / p.NK < B ? n_sm / p.NK : B;
    p.nb = (B + nbg - 1) / nbg;
    p.NB = (B + p.nb - 1) / p.nb;
    p.Kr = p.kc;
    if (p.kc * row >= optin) continue;
    p.cb = static_cast<int>((optin - p.kc * row) / row);
    if (p.cb > p.nb) p.cb = p.nb;
    while (p.cb > 0 && rec_smem_bytes(p, H) > optin) --p.cb;
    if (p.cb == 0) continue;
    const int chunks = (p.nb + p.cb - 1) / p.cb;
    p.cb = (p.nb + chunks - 1) / chunks;  // even chunks, none larger than what fits
    if (!best_chunks || chunks < best_chunks) {
      best = p;
      best_chunks = chunks;
    }
  }
  if (best_chunks) return true;
  double best_cost = -1.0;
  for (int nk = 1; nk <= H && nk <= n_sm; ++nk) {  // wide H
    Plan p;
    p.kc = (H + nk - 1) / nk;
    p.NK = (H + p.kc - 1) / p.kc;
    const int nbg = n_sm / p.NK < B ? n_sm / p.NK : B;
    p.nb = (B + nbg - 1) / nbg;
    p.NB = (B + p.nb - 1) / p.nb;
    int last_cb = 0;
    for (int chunks = 1; chunks <= p.nb && chunks <= 64; ++chunks) {
      p.cb = (p.nb + chunks - 1) / chunks;
      if (p.cb == last_cb) continue;
      last_cb = p.cb;
      p.Kr = 0;
      const size_t base = rec_smem_bytes(p, H);
      if (base > optin) continue;
      p.Kr = static_cast<int>(std::min<size_t>((optin - base) / row, p.kc)) / KG * KG;
      const int used = (p.nb + p.cb - 1) / p.cb;
      const double tile_rows = static_cast<double>(used) * ((p.cb + RB - 1) / RB);  // row tiles a step
      const double cost = tile_rows * (p.kc - p.Kr) * row / 25e3 + 2.0 * used;
      if (best_cost < 0 || cost < best_cost) {
        best = p;
        best_cost = cost;
      }
    }
  }
  return best_cost >= 0;
}

// st[bb, :] = dhw[b0 + bb, t, :] for bb < n, in units V (float4 when 3H
// is a multiple of 4) of which a row holds w. The rows were written by
// other blocks, so they are read through L2.
template <typename V>
__device__ inline void stage_rows(float* st, const float* dhw, int b0, int n, int t, int T, int w) {
  constexpr int per = sizeof(V) / sizeof(float);
  V* dst = reinterpret_cast<V*>(st);
  for (int i = threadIdx.x; i < n * w; i += REC_THREADS) {
    const int bb = i / w;
    const V* row = reinterpret_cast<const V*>(dhw + (static_cast<long>(b0 + bb) * T + t) * w * per);
    dst[i] = __ldcg(row + (i - bb * w));
  }
}

// acc[i][c] += sum over this lane's n of rows[i][n] cols[c][n]: a warp
// tile's terms n = n0, n0 + stride, ... < H3; GLOBAL: the columns are rows
// of wh in global memory (read-only loads), else in shared memory.
template <bool GLOBAL>
__device__ __forceinline__ void tile_terms(float (&acc)[RB][KG], const float* const (&rows)[RB],
                                           const float* const (&cols)[KG], int n0, int stride, int H3) {
#pragma unroll 4
  for (int n = n0; n < H3; n += stride) {
    float w[KG];
#pragma unroll
    for (int c = 0; c < KG; ++c) w[c] = GLOBAL ? __ldg(cols[c] + n) : cols[c][n];
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const float d = rows[i][n];
#pragma unroll
      for (int c = 0; c < KG; ++c) acc[i][c] = fmaf(d, w[c], acc[i][c]);
    }
  }
}

// The whole dh recurrence. The carry dh = dhz + dhv (dh z of the step, and
// dhw_t wh^T) lives in [B, H] scratch that only the block owning those
// rows and columns touches (ordered by __syncthreads, L1-resident), so a
// block's shared memory holds only its rows of wh and one staged chunk.
// WIDE: its rows from Kr on are read from wh each step.
template <bool WIDE>
__global__ void __launch_bounds__(REC_THREADS)
gru_bwd_rec_kernel(const float* __restrict__ xw, const float* __restrict__ wh,
                   const float* __restrict__ hw, const float* __restrict__ ys,
                   const float* __restrict__ dys, float* __restrict__ dxw, float* dhw, float* dhz,
                   float* dhv, unsigned* bar, int B, int T, int H, Plan pl, int rev) {
  extern __shared__ __align__(16) float smem[];
  const int H3 = 3 * H, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = blockIdx.x / pl.NK, q = blockIdx.x % pl.NK;
  const int k0 = q * pl.kc, nk = min(pl.kc, H - k0), b0 = g * pl.nb, nb = min(pl.nb, B - b0);
  float* wh_s = smem;                  // [Kr][3H]: rows k0 .. k0+min(nk, Kr)-1 of wh
  float* st_s = wh_s + pl.Kr * H3;     // [cb][3H]: a chunk of the group's rows of dhw_t
  float* red_s = st_s + pl.cb * H3;    // [slots][RB * KG]: warp partial sums
  unsigned* gbar = bar + 2 * g;
  for (int i = tid; i < min(nk, pl.Kr) * H3; i += REC_THREADS) wh_s[i] = wh[static_cast<long>(k0) * H3 + i];
  __syncthreads();

  const int nct = (nk + KG - 1) / KG;
  for (int s = 0; s < T; ++s) {
    const int t = rev ? s : T - 1 - s;
    const bool first = rev ? t == T - 1 : t == 0;  // the scan's first step: h_{t-1} = 0
    const int tp = rev ? t + 1 : t - 1;
    for (int idx = tid; idx < nb * nk; idx += REC_THREADS) {
      const int bb = idx / nk, kk = idx % nk, b = b0 + bb, j = k0 + kk;
      const long row = static_cast<long>(b) * T + t, o = static_cast<long>(b) * H + j;
      const float* x = xw + row * H3;
      const float* gw = hw + row * H3;
      const float hp = first ? 0.f : ys[(static_cast<long>(b) * T + tp) * H + j];
      const float dh = (s ? dhz[o] + dhv[o] : 0.f) + dys[row * H + j];
      const float hn = gw[2 * H + j];
      const float r = sigmoid(x[j] + gw[j]);
      const float z = sigmoid(x[H + j] + gw[H + j]);
      const float n = tanhf(x[2 * H + j] + r * hn);
      const float dn = dh * (1.f - z) * (1.f - n * n);
      const float dz = dh * (hp - n) * z * (1.f - z);
      const float dr = dn * hn * r * (1.f - r);
      float* dx = dxw + row * H3;
      float* dg = dhw + row * H3;
      dx[j] = dr;
      dx[H + j] = dz;
      dx[2 * H + j] = dn;
      dg[j] = dr;
      dg[H + j] = dz;
      dg[2 * H + j] = dn * r;
      dhz[o] = dh * z;
    }
    if (s == T - 1) break;  // the carry into the first step is not an output
    zs::grid_barrier(gbar, pl.NK);

    for (int c0 = 0; c0 < nb; c0 += pl.cb) {  // the same chunks in every thread
      const int n_rows = min(pl.cb, nb - c0);
      if ((H3 & 3) == 0) {
        stage_rows<float4>(st_s, dhw, b0 + c0, n_rows, t, T, H3 / 4);
      } else {
        stage_rows<float>(st_s, dhw, b0 + c0, n_rows, t, T, H3);
      }
      __syncthreads();
      const int nt = ((n_rows + RB - 1) / RB) * nct, splits = nt < NWARPS ? NWARPS / nt : 1;
      for (int wt = warp; wt < nt * splits; wt += NWARPS) {
        const int tile = wt % nt, sp = wt / nt, rt = tile / nct, ct = tile % nct;
        const float* rows[RB];
        const float* cols[KG];
#pragma unroll
        for (int i = 0; i < RB; ++i) rows[i] = st_s + min(rt * RB + i, n_rows - 1) * H3;
        float acc[RB][KG] = {};
        if (!WIDE || ct * KG < pl.Kr) {  // Kr is a multiple of KG: the whole tile is on chip
#pragma unroll
          for (int c = 0; c < KG; ++c) cols[c] = wh_s + min(ct * KG + c, nk - 1) * H3;
          tile_terms<false>(acc, rows, cols, sp * 32 + lane, 32 * splits, H3);
        } else {
#pragma unroll
          for (int c = 0; c < KG; ++c) cols[c] = wh + static_cast<long>(k0 + min(ct * KG + c, nk - 1)) * H3;
          tile_terms<true>(acc, rows, cols, sp * 32 + lane, 32 * splits, H3);
        }
#pragma unroll
        for (int i = 0; i < RB; ++i)
#pragma unroll
          for (int c = 0; c < KG; ++c) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], off);
            if (lane == 0) red_s[wt * RB * KG + i * KG + c] = acc[i][c];
          }
      }
      __syncthreads();
      for (int idx = tid; idx < n_rows * nk; idx += REC_THREADS) {
        const int bb = idx / nk, kk = idx % nk;
        const int tile = (bb / RB) * nct + kk / KG, e = (bb % RB) * KG + kk % KG;
        float v = 0.f;
        for (int sp = 0; sp < splits; ++sp) v += red_s[(sp * nt + tile) * RB * KG + e];
        dhv[static_cast<long>(b0 + c0 + bb) * H + k0 + kk] = v;
      }
      __syncthreads();  // st_s and red_s are refilled by the next chunk
    }
  }
}

// dbh[n] = sum over the R rows of dhw[:, n]: 32 columns a block, 8 row
// slices a column, reduced in a fixed order.
__global__ void col_sum_kernel(const float* __restrict__ a, float* __restrict__ out, int R, int N) {
  __shared__ float part[8][32];
  const int c = threadIdx.x % 32, s = threadIdx.x / 32, n = blockIdx.x * 32 + c;
  float acc = 0.f;
  if (n < N)
    for (int r = s; r < R; r += 8) acc += a[static_cast<long>(r) * N + n];
  part[s][c] = acc;
  __syncthreads();
  if (s == 0 && n < N) {
    float v = 0.f;
    for (int q = 0; q < 8; ++q) v += part[q][c];
    out[n] = v;
  }
}

}  // namespace

ZS_DEFINE_ERROR_STRING

namespace {

cudaError_t card(int* n_sm, int* optin) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (!e) e = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (!e) e = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return e;
}

}  // namespace

// The spread zs_gru_bwd picks on the current device (plan[0..6] = kc, nb,
// cb, NK, NB, a block's shared memory in bytes, and Hs: the rows of wh a
// batch group holds in shared memory, H unless the spread is wide; all 0
// when none fits), for diagnostics. Returns a CUDA error.
ZS_EXPORT int zs_gru_bwd_plan(int* plan, int B, int H) {
  int n_sm, optin;
  if (cudaError_t e = card(&n_sm, &optin)) return e;
  Plan p{};
  const bool ok = make_plan(p, B, H, n_sm, static_cast<size_t>(optin));
  const int v[7] = {p.kc, p.nb, p.cb, p.NK, p.NB, ok ? static_cast<int>(rec_smem_bytes(p, H)) : 0,
                    ok ? rows_on_chip(p, H) : 0};
  for (int i = 0; i < 7; ++i) plan[i] = ok ? v[i] : 0;
  return cudaSuccess;
}

// Inputs xw [B, T, 3H], wh [H, 3H], bh [3H], ys [B, T, H], dys [B, T, H];
// outputs dxw [B, T, 3H], dwh [H, 3H], dbh [3H]; scratch hw and dhw
// [B, T, 3H], dhz and dhv [B, H] (the carry) and bar [2 x the SM count]
// (the batch groups' barrier words). Returns a CUDA error
// (cudaErrorInvalidConfiguration when not even one staged row fits).
ZS_EXPORT int zs_gru_bwd(const float* xw, const float* wh, const float* bh, const float* ys,
                         const float* dys, float* dxw, float* dwh, float* dbh, float* hw,
                         float* dhw, float* dhz, float* dhv, unsigned* bar, int B, int T, int H,
                         int rev, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int H3 = 3 * H, M = B * T;
  int n_sm, optin;
  cudaError_t e = card(&n_sm, &optin);
  if (e != cudaSuccess) return e;
  Plan pl;
  if (!make_plan(pl, B, H, n_sm, static_cast<size_t>(optin))) return cudaErrorInvalidConfiguration;
  if ((e = cudaMemsetAsync(bar, 0, 2 * pl.NB * sizeof(unsigned), st))) return e;

  hprev_gemm_kernel<false><<<dim3((H3 + TN - 1) / TN, (M + TM - 1) / TM), GEMM_THREADS, 0, st>>>(
      ys, wh, bh, hw, M, H3, H, H, T, H, rev);
  if ((e = cudaGetLastError())) return e;

  const size_t smem = rec_smem_bytes(pl, H);
  const void* rec = pl.Kr < pl.kc ? reinterpret_cast<const void*>(gru_bwd_rec_kernel<true>)
                                  : reinterpret_cast<const void*>(gru_bwd_rec_kernel<false>);
  if ((e = zs::allow_smem(rec, smem))) return e;
  const float* hw_c = hw;
  void* args[] = {&xw, &wh, &hw_c, &ys, &dys, &dxw, &dhw, &dhz, &dhv, &bar, &B, &T, &H, &pl, &rev};
  e = cudaLaunchCooperativeKernel(rec, dim3(pl.NK * pl.NB), dim3(REC_THREADS), args, smem, st);
  if (e != cudaSuccess) return e;

  // dwh in S K-slices (enough blocks to fill the card), their partial
  // products in hw (free once the recurrence is done: B T 3H >= S H 3H
  // floats), summed in a fixed order
  const dim3 tiles_dwh((H3 + TN - 1) / TN, (H + TM - 1) / TM);
  int S = 2 * n_sm / static_cast<int>(tiles_dwh.x * tiles_dwh.y);
  S = S < 1 ? 1 : S > 8 ? 8 : S;
  if (S > M / H) S = M / H > 1 ? M / H : 1;
  const int kslice = ((M + S - 1) / S + TK - 1) / TK * TK;
  S = (M + kslice - 1) / kslice;
  hprev_gemm_kernel<true><<<dim3(tiles_dwh.x, tiles_dwh.y, S), GEMM_THREADS, 0, st>>>(
      ys, dhw, nullptr, S > 1 ? hw : dwh, H, H3, M, kslice, T, H, rev);
  if ((e = cudaGetLastError())) return e;
  if (S > 1) {
    sum_partials_kernel<<<2 * n_sm, 256, 0, st>>>(hw, dwh, S, static_cast<long>(H) * H3);
    if ((e = cudaGetLastError())) return e;
  }
  col_sum_kernel<<<(H3 + 31) / 32, 256, 0, st>>>(dhw, dbh, M, H3);
  return cudaGetLastError();
}
