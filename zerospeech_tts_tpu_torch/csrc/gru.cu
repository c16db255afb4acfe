// Kernel 2: GRU recurrence, forward and (length-masked) reverse.
//
// Replaces zerospeech_tts_tpu/ops/pallas_gru.py::pallas_gru_scan. Given the
// hoisted input projections xw = x Wi + bi [B, T, 3H] (a plain matmul
// outside the kernel), each step computes
//     hw = h wh + bh;  r, z = sigmoid(x_{r,z} + hw_{r,z})
//     n  = tanh(x_n + r * hw_n);  h' = (1 - z) n + z h
// with gate order r, z, n and f32 state. With `lengths` (reverse scans
// only) steps at t >= lengths[b] pass the state through, so each row's
// first real step sees h0 = 0 exactly as an exact-length run does.
//
// What bounds it on an H100: the serial chain of T dependent steps, not
// arithmetic. One decoder step at B=16, H=512 is 12.6 M FMAs (~1 us of one
// SM's FP32 rate spread over 64 blocks) and reads wh (3 MB f32, L2-resident
// after the first step), so launch latency and the L2 read of wh set the
// per-step time.
//
// Design: the simplest correct form, one launch per time step, all T
// launches issued from one C call onto the caller's stream. A block owns 16
// hidden columns j (48 columns of wh across the three gates) and 8 batch
// rows: 256 threads split the H-long dot products into 16 strided k-slices,
// each wh element loaded once per block and reused across the 8 rows held
// in shared memory, then one thread per (row, column) sums the 16 partials,
// applies the gates and the length mask, and writes ys[b, t, j]. The
// previous state is read back from ys[:, t -/+ 1] (h0 = 0 at the first
// step), so the kernel needs no state buffer. A persistent single-launch
// version with wh spread over the SMs and a grid-wide barrier is later work.
#include "common.cuh"

namespace {

constexpr int JT = 16;  // hidden columns per block
constexpr int KS = 16;  // k-slices of the recurrent dot product
constexpr int BB = 8;   // batch rows per block
constexpr int THREADS = JT * KS;

__device__ inline float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__global__ void gru_step_kernel(const float* __restrict__ xw, const float* __restrict__ wh,
                                const float* __restrict__ bh, const int* __restrict__ lengths,
                                float* __restrict__ ys, int B, int T, int H, int t, int t_prev) {
  extern __shared__ float smem[];
  float* hs = smem;             // [BB][H]: h_{t_prev} of this block's rows
  float* part = smem + BB * H;  // [KS][3][BB][JT]: partial dot products
  const int tid = threadIdx.x, jj = tid % JT, ks = tid / JT;
  const int j0 = blockIdx.x * JT, b0 = blockIdx.y * BB, H3 = 3 * H;

  for (int idx = tid; idx < BB * H; idx += THREADS) {
    const int bb = idx / H, k = idx % H, b = b0 + bb;
    hs[idx] = (t_prev >= 0 && b < B) ? ys[(static_cast<long>(b) * T + t_prev) * H + k] : 0.f;
  }
  __syncthreads();

  float acc[3][BB];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int bb = 0; bb < BB; ++bb) acc[g][bb] = 0.f;
  const int j = j0 + jj;
  if (j < H) {
    for (int k = ks; k < H; k += KS) {
      const float* w = wh + static_cast<long>(k) * H3 + j;
      const float wr = __ldg(w), wz = __ldg(w + H), wn = __ldg(w + 2 * H);
#pragma unroll
      for (int bb = 0; bb < BB; ++bb) {
        const float hv = hs[bb * H + k];
        acc[0][bb] = fmaf(hv, wr, acc[0][bb]);
        acc[1][bb] = fmaf(hv, wz, acc[1][bb]);
        acc[2][bb] = fmaf(hv, wn, acc[2][bb]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int bb = 0; bb < BB; ++bb) part[((ks * 3 + g) * BB + bb) * JT + jj] = acc[g][bb];
  __syncthreads();

  if (tid >= BB * JT) return;
  const int bb = tid / JT, jo = tid % JT, b = b0 + bb, jc = j0 + jo;
  if (b >= B || jc >= H) return;
  float hw[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    float s = 0.f;
    for (int q = 0; q < KS; ++q) s += part[((q * 3 + g) * BB + bb) * JT + jo];
    hw[g] = s + bh[g * H + jc];
  }
  const float* x = xw + (static_cast<long>(b) * T + t) * H3;
  const float r = sigmoid(x[jc] + hw[0]);
  const float z = sigmoid(x[H + jc] + hw[1]);
  const float n = tanhf(x[2 * H + jc] + r * hw[2]);
  const float hp = hs[bb * H + jc];
  float hn = (1.f - z) * n + z * hp;
  if (lengths != nullptr && t >= lengths[b]) hn = hp;
  ys[(static_cast<long>(b) * T + t) * H + jc] = hn;
}

}  // namespace

ZS_DEFINE_ERROR_STRING

// xw [B, T, 3H], wh [H, 3H], bh [3H], lengths [B] int32 or null -> ys [B, T, H].
// reverse != 0 scans t = T-1 .. 0 (outputs stay in original time order).
ZS_EXPORT int zs_gru_scan(const float* xw, const float* wh, const float* bh, const int* lengths,
                          float* ys, int B, int T, int H, int reverse, void* stream) {
  const size_t smem = static_cast<size_t>(BB * H + KS * 3 * BB * JT) * sizeof(float);
  cudaError_t e = zs::allow_smem(gru_step_kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((H + JT - 1) / JT, (B + BB - 1) / BB);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const int t_prev = s == 0 ? -1 : (reverse ? t + 1 : t - 1);
    gru_step_kernel<<<grid, THREADS, smem, st>>>(xw, wh, bh, lengths, ys, B, T, H, t, t_prev);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}
