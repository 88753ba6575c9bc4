// Confidence head: the 128 -> 32 -> 32 -> 1 ReLU MLP per correspondence,
// CUDA C++ for sm_90a.
//
// Replaces the TPU kernel pointdsc_tpu/kernels/conf_mlp.py:43 (_conf_kernel,
// pallas_call at :67), entry confidence_head (:84):
//
//   h1 = relu(W0 x + b0), h2 = relu(W1 h1 + b1), logit = W2 h2 + b2
//
// x [M, 128] f32 (M = B N rows), W0 [32, 128], W1 [32, 32], W2 [1, 32] in
// torch.nn.Linear's [out, in] layout, b0 [32], b1 [32], b2 [1]; out [M] f32.
//
// Bound on the H100 at N = 5120: the features are 2.6 MB (0.78 us at
// 3.35 TB/s) and the MLP 2 (128 32 + 32 32 + 32) = 10.3 kflop per row, 53
// MFLOP (0.79 us at 67 TFLOP/s in f32): bytes and operations are even, both
// under the cost of one launch. The TPU pads the 32-wide layers to 128 lanes
// so the three matmuls stay full MXU passes; on the card there is nothing to
// pad for. Design: a block owns 32 rows; it stages their features and the
// transposed weights in shared memory, 4 threads per row compute 8 hidden
// units each, and the 32-wide intermediates never leave shared memory. Only
// the [M] logits are written.

#include <cuda_runtime.h>

namespace {

constexpr int C = 128;
constexpr int H = 32;
constexpr int ROWS = 32;
constexpr int THREADS = 128;
constexpr int PER = H / (THREADS / ROWS);  // hidden units per thread: 8
constexpr int XP = C + 1;                  // padded feature row
constexpr int HP = H + 1;                  // padded hidden row

__global__ void __launch_bounds__(THREADS)
conf_mlp_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                const float* __restrict__ b0, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, float* __restrict__ out, int m) {
  __shared__ float xs[ROWS * XP];
  __shared__ float w0t[C * H];  // w0t[c][h] = W0[h][c]
  __shared__ float w1t[H * H];  // w1t[i][h] = W1[h][i]
  __shared__ float h1[ROWS * HP];
  __shared__ float h2[ROWS * HP];
  const int row0 = blockIdx.x * ROWS;
  for (int e = threadIdx.x; e < C * H; e += THREADS) {
    const int h = e / C, c = e % C;
    w0t[c * H + h] = w0[e];
  }
  for (int e = threadIdx.x; e < H * H; e += THREADS) {
    const int h = e / H, i = e % H;
    w1t[i * H + h] = w1[e];
  }
  for (int e = threadIdx.x; e < ROWS * C; e += THREADS) {
    const int r = e / C, c = e % C;
    xs[r * XP + c] = row0 + r < m ? x[static_cast<size_t>(row0 + r) * C + c] : 0.0f;
  }
  __syncthreads();

  const int r = threadIdx.x / (THREADS / ROWS);
  const int h0 = (threadIdx.x % (THREADS / ROWS)) * PER;
  float acc[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) acc[u] = 0.0f;
  for (int c = 0; c < C; ++c) {
    const float xv = xs[r * XP + c];
#pragma unroll
    for (int u = 0; u < PER; ++u) acc[u] += xv * w0t[c * H + h0 + u];
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) h1[r * HP + h0 + u] = fmaxf(acc[u] + b0[h0 + u], 0.0f);
  __syncthreads();

#pragma unroll
  for (int u = 0; u < PER; ++u) acc[u] = 0.0f;
  for (int i = 0; i < H; ++i) {
    const float hv = h1[r * HP + i];
#pragma unroll
    for (int u = 0; u < PER; ++u) acc[u] += hv * w1t[i * H + h0 + u];
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) h2[r * HP + h0 + u] = fmaxf(acc[u] + b1[h0 + u], 0.0f);
  __syncthreads();

  if (threadIdx.x < ROWS && row0 + threadIdx.x < m) {
    float logit = 0.0f;
    for (int i = 0; i < H; ++i) logit += h2[threadIdx.x * HP + i] * w2[i];
    out[row0 + threadIdx.x] = logit + b2[0];
  }
}

}  // namespace

extern "C" int confidence_head(const void* x, const void* w0, const void* b0, const void* w1,
                               const void* b1, const void* w2, const void* b2, void* out,
                               int m, void* stream) {
  const int blocks = (m + ROWS - 1) / ROWS;
  conf_mlp_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w0),
      static_cast<const float*>(b0), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), m);
  return static_cast<int>(cudaGetLastError());
}
