// Hypothesis scoring: inlier count of every seed transform, CUDA C++ for
// sm_90a.
//
// Replaces the TPU kernel pointdsc_tpu/kernels/scoring.py:56
// (_scoring_kernel, pallas_call at :120), entry seed_inlier_counts:
//
//   count[b, s] = sum_n [ |R_s x_n + t_s - y_n|^2 < thr^2 ] * mask_n
//
// trans [B, S, 16] (cols 4i..4i+3 = row i of [R | t]), points [B, 8, N]
// (rows 0-2 src xyz, 3 ones, 4-6 tgt xyz, 7 mask), counts [B, S] f32 holding
// integers, as in JAX.
//
// Bound on the H100: S x N = 2.6 M seed-point pairs at S = 512, N = 5120,
// ~20 flops each: ~52 MFLOP, under 1 us at 67 TFLOP/s; the inputs are
// 196 KB. The kernel is launch-bound. Design: one block per seed, 256
// threads stride over the points (coalesced row reads of the strip, which
// stays in L2 across the 512 blocks), integer counts, one warp-shuffle plus
// shared-memory block reduction.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
scoring_kernel(const float* __restrict__ trans, const float* __restrict__ pts,
               float* __restrict__ counts, int s, int n, float thr2) {
  __shared__ int warp_sums[THREADS / 32];
  const int seed = blockIdx.x, b = blockIdx.y;
  const float* tr = trans + (static_cast<size_t>(b) * s + seed) * 16;
  const float* p = pts + static_cast<size_t>(b) * 8 * n;
  float T[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) T[i] = tr[i];
  int cnt = 0;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const float x = p[i], y = p[n + i], z = p[2 * n + i];
    const float p0 = T[0] * x + T[1] * y + T[2] * z + T[3];
    const float p1 = T[4] * x + T[5] * y + T[6] * z + T[7];
    const float p2 = T[8] * x + T[9] * y + T[10] * z + T[11];
    const float e0 = p0 - p[4 * n + i], e1 = p1 - p[5 * n + i], e2 = p2 - p[6 * n + i];
    const float d2 = e0 * e0 + e1 * e1 + e2 * e2;
    cnt += (d2 < thr2 && p[7 * n + i] != 0.0f) ? 1 : 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < THREADS / 32; ++w) total += warp_sums[w];
    counts[static_cast<size_t>(b) * s + seed] = static_cast<float>(total);
  }
}

}  // namespace

extern "C" int seed_inlier_counts(const void* trans, const void* pts, void* counts, int batch,
                                  int s, int n, float thr2, void* stream) {
  const dim3 grid(s, batch);
  scoring_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(trans), static_cast<const float*>(pts),
      static_cast<float*>(counts), s, n, thr2);
  return static_cast<int>(cudaGetLastError());
}
