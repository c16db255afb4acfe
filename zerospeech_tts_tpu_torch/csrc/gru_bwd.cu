// Kernel 3: backward pass of the unmasked GRU scan (forward time).
//
// Replaces zerospeech_tts_tpu/ops/pallas_gru.py::_gru_bwd_call. From the
// forward inputs xw [B, T, 3H], wh [H, 3H], bh [3H], the outputs ys
// [B, T, H] and their gradient dys it computes dxw [B, T, 3H], dwh [H, 3H]
// and dbh [3H]. With h_{t-1} = ys[:, t-1] (h_{-1} = 0), in reverse time:
//     hw = h_{t-1} wh + bh;  r, z = sigmoid(x_{r,z} + hw_{r,z});
//     n  = tanh(x_n + r hw_n);  dh += dys_t
//     dn = dh (1-z)(1-n^2);  dz = dh (h_{t-1} - n) z (1-z);  dr = dn hw_n r (1-r)
//     dxw_t = [dr, dz, dn];  dhw_t = [dr, dz, dn r];  dh <- dh z + dhw_t wh^T
//     dwh = sum_t h_{t-1}^T dhw_t;  dbh = sum_{b,t} dhw_t
//
// What bounds it on an H100: three products of 2 B T H 3H FMAs each
// (hw, the dh recurrence, dwh), f32 CUDA-core FLOPs (6.4 GFLOP each at
// B=32, T=128, H=512: ~0.29 ms at 67 TFLOP/s), but only the dh recurrence
// is serial: T dependent steps of a [B, 3H] x [3H, H] product, whose
// launch latency and L2 reads of wh (3 MB) set the time at these shapes.
//
// Design: the TPU kernel runs all three products inside one sequential
// grid with dwh accumulated in VMEM. Here the two products that do not
// depend on the carry run as parallel passes, and only the recurrence is
// serial:
//   1. hw for all B*T rows at once (a tiled f32 product, 64 x 64 tiles,
//      4 x 4 outputs a thread), into a scratch buffer;
//   2. one launch per step (T launches from one C call): a block owns 8
//      batch rows and 8 columns k of dh. It forms its rows' dhw over all 3H
//      from hw, xw, h_{t-1} and dh (elementwise; every column block repeats
//      this cheap part for its rows), keeps them in shared memory, writes
//      the dxw and dhw columns of its own k, and then each warp takes one
//      column k: its 32 lanes stride over the 3H terms of dhw . wh[k, :]
//      (coalesced rows of wh) and reduce with shuffles. The dh carry
//      ping-pongs between two [B, H] buffers;
//   3. dwh = h_prev^T dhw over all B*T rows (the same tiled product, A read
//      transposed) and dbh as column sums (8 row slices a column, reduced
//      in shared memory): deterministic, no atomics.
// A persistent single-launch recurrence and tensor-core products are later
// work.
#include "common.cuh"

namespace {

constexpr int TM = 64, TN = 64, TK = 16;  // product tile
constexpr int GEMM_THREADS = 256;         // 16 x 16 threads, 4 x 4 outputs each
constexpr int BB = 8;                     // batch rows per step block
constexpr int KC = 8;                     // dh columns per step block (one warp each)
constexpr int STEP_THREADS = 32 * KC;

__device__ inline float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// h_{t-1} of flat row m = b * T + t, column k (0 at t = 0).
__device__ inline float hprev_at(const float* __restrict__ ys, int m, int k, int T, int H) {
  return (m % T) ? ys[static_cast<long>(m - 1) * H + k] : 0.f;
}

// C[M, N] = A[M, K] Bm[K, N] (+ bias[N]). TRANS == false: A(m, k) =
// h_prev(row m, column k) (the hw pass, M = B*T, K = H). TRANS == true:
// A(m, k) = h_prev(row k, column m) (the dwh pass, M = H, K = B*T).
template <bool TRANS>
__global__ void hprev_gemm_kernel(const float* __restrict__ ys, const float* __restrict__ Bm,
                                  const float* __restrict__ bias, float* __restrict__ C, int M,
                                  int N, int K, int T, int H) {
  __shared__ float As[TK][TM + 4];
  __shared__ float Bs[TK][TN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int i = tid; i < TM * TK; i += GEMM_THREADS) {
      // consecutive threads read consecutive addresses of ys
      const int mm = TRANS ? i % TM : i / TK, kk = TRANS ? i / TM : i % TK;
      const int m = m0 + mm, k = k0 + kk;
      float v = 0.f;
      if (m < M && k < K) v = TRANS ? hprev_at(ys, k, m, T, H) : hprev_at(ys, m, k, T, H);
      As[kk][mm] = v;
    }
    for (int i = tid; i < TK * TN; i += GEMM_THREADS) {
      const int kk = i / TN, nn = i % TN, k = k0 + kk, n = n0 + nn;
      Bs[kk][nn] = (k < K && n < N) ? Bm[static_cast<long>(k) * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) C[static_cast<long>(m) * N + n] = acc[i][j] + (bias ? bias[n] : 0.f);
    }
  }
}

// One reverse-time step t: dh_out = dh z + dhw_t wh^T for this block's 8
// rows and 8 columns; dxw_t and dhw_t for its columns.
__global__ void gru_bwd_step_kernel(const float* __restrict__ xw, const float* __restrict__ wh,
                                    const float* __restrict__ hw, const float* __restrict__ ys,
                                    const float* __restrict__ dys, const float* __restrict__ dh_in,
                                    float* __restrict__ dh_out, float* __restrict__ dxw,
                                    float* __restrict__ dhw, int B, int T, int H, int t) {
  extern __shared__ float smem[];
  float* dhw_s = smem;                // [BB][3H]
  float* dhz_s = smem + BB * 3 * H;   // [BB][KC]: dh * z of this block's columns
  const int tid = threadIdx.x, H3 = 3 * H;
  const int k0 = blockIdx.x * KC, b0 = blockIdx.y * BB;

  for (int idx = tid; idx < BB * H; idx += STEP_THREADS) {
    const int bb = idx / H, j = idx % H, b = b0 + bb;
    float* row = dhw_s + bb * H3;
    if (b >= B) {
      row[j] = row[H + j] = row[2 * H + j] = 0.f;
      continue;
    }
    const long base = (static_cast<long>(b) * T + t) * H3;
    const float* x = xw + base;
    const float* g = hw + base;
    const float hp = t > 0 ? ys[(static_cast<long>(b) * T + t - 1) * H + j] : 0.f;
    const float dh = dh_in[static_cast<long>(b) * H + j] + dys[(static_cast<long>(b) * T + t) * H + j];
    const float hn = g[2 * H + j];
    const float r = sigmoid(x[j] + g[j]);
    const float z = sigmoid(x[H + j] + g[H + j]);
    const float n = tanhf(x[2 * H + j] + r * hn);
    const float dn = dh * (1.f - z) * (1.f - n * n);
    const float dz = dh * (hp - n) * z * (1.f - z);
    const float dr = dn * hn * r * (1.f - r);
    row[j] = dr;
    row[H + j] = dz;
    row[2 * H + j] = dn * r;
    if (j >= k0 && j < k0 + KC) {
      dxw[base + j] = dr;
      dxw[base + H + j] = dz;
      dxw[base + 2 * H + j] = dn;
      dhw[base + j] = dr;
      dhw[base + H + j] = dz;
      dhw[base + 2 * H + j] = dn * r;
      dhz_s[bb * KC + (j - k0)] = dh * z;
    }
  }
  __syncthreads();

  const int w = tid / 32, lane = tid % 32, k = k0 + w;
  if (k >= H) return;
  float acc[BB];
#pragma unroll
  for (int bb = 0; bb < BB; ++bb) acc[bb] = 0.f;
  const float* wrow = wh + static_cast<long>(k) * H3;
  for (int n = lane; n < H3; n += 32) {
    const float wv = __ldg(wrow + n);
#pragma unroll
    for (int bb = 0; bb < BB; ++bb) acc[bb] = fmaf(dhw_s[bb * H3 + n], wv, acc[bb]);
  }
#pragma unroll
  for (int bb = 0; bb < BB; ++bb)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[bb] += __shfl_xor_sync(0xffffffffu, acc[bb], off);
  if (lane < BB && b0 + lane < B) {
    float v = 0.f;
#pragma unroll
    for (int bb = 0; bb < BB; ++bb)
      if (bb == lane) v = acc[bb];
    dh_out[static_cast<long>(b0 + lane) * H + k] = dhz_s[lane * KC + w] + v;
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

// Inputs xw [B, T, 3H], wh [H, 3H], bh [3H], ys [B, T, H], dys [B, T, H];
// outputs dxw [B, T, 3H], dwh [H, 3H], dbh [3H]; scratch hw and dhw
// [B, T, 3H], dh [2, B, H].
ZS_EXPORT int zs_gru_bwd(const float* xw, const float* wh, const float* bh, const float* ys,
                         const float* dys, float* dxw, float* dwh, float* dbh, float* hw,
                         float* dhw, float* dh, int B, int T, int H, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int H3 = 3 * H, M = B * T;
  cudaError_t e = cudaMemsetAsync(dh, 0, static_cast<size_t>(B) * H * sizeof(float), st);
  if (e != cudaSuccess) return e;

  hprev_gemm_kernel<false><<<dim3((H3 + TN - 1) / TN, (M + TM - 1) / TM), GEMM_THREADS, 0, st>>>(
      ys, wh, bh, hw, M, H3, H, T, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const size_t smem = static_cast<size_t>(BB * H3 + BB * KC) * sizeof(float);
  e = zs::allow_smem(gru_bwd_step_kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((H + KC - 1) / KC, (B + BB - 1) / BB);
  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    const float* dh_in = dh + static_cast<long>(s % 2) * B * H;
    float* dh_out = dh + static_cast<long>((s + 1) % 2) * B * H;
    gru_bwd_step_kernel<<<grid, STEP_THREADS, smem, st>>>(xw, wh, hw, ys, dys, dh_in, dh_out, dxw,
                                                          dhw, B, T, H, t);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }

  hprev_gemm_kernel<true><<<dim3((H3 + TN - 1) / TN, (H + TM - 1) / TM), GEMM_THREADS, 0, st>>>(
      ys, dhw, nullptr, dwh, H, H3, M, T, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  col_sum_kernel<<<(H3 + 31) / 32, 256, 0, st>>>(dhw, dbh, M, H3);
  return cudaGetLastError();
}
