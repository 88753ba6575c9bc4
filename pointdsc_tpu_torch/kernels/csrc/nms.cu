// Seed-NMS local-max flags, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel pointdsc_tpu/kernels/nms.py:40 (_nms_kernel,
// pallas_call at :78), entry of pick_seeds_nms_fused / _prefiltered:
//
//   flag[i] = AND_j ( s_i >= s_j  OR  d2(i, j) >= R^2 )
//   d2(i, j) = max(|x_i|^2 + |x_j|^2 - 2 x_i.x_j, 0)
//
// from the packed [B, 8, N] strip (rows 0-2 src xyz, 3 |src|^2, 4 score with
// invalid points at -1e9 so they never suppress). Output: [B, N] f32 in {0, 1}.
// The top-k over score * flag stays in PyTorch.
//
// Bound on the H100: N^2 pair tests (26.2 M at N = 5120), ~10 f32 operations
// each: ~0.26 GFLOP, about 4 us at 67 TFLOP/s; the bytes (the 160 KB strip in,
// 20 KB of flags out) are negligible. Design: a block holds 64 queries, four
// lanes per query each walk a quarter of every 256-key tile staged in shared
// memory (the four lanes read four addresses, broadcast to the warp), then
// AND their flags with two shuffles. 64-query blocks give 80 blocks at
// N = 5120, against 20 with one thread per query and 256-query blocks.

#include <cuda_runtime.h>

namespace {

constexpr int QT = 64;
constexpr int SPLIT = 4;
constexpr int THREADS = QT * SPLIT;
constexpr int KT = 256;

__global__ void __launch_bounds__(THREADS)
nms_kernel(const float* __restrict__ geom, float* __restrict__ flags, int n, float r2) {
  __shared__ float ks[5][KT];
  const int b = blockIdx.y;
  const float* g = geom + static_cast<size_t>(b) * 8 * n;
  const int qi = blockIdx.x * QT + threadIdx.x / SPLIT;
  const int part = threadIdx.x % SPLIT;
  const bool live = qi < n;
  float xq = 0.f, yq = 0.f, zq = 0.f, sqq = 0.f, sq = 0.f;
  if (live) {
    xq = g[qi];
    yq = g[n + qi];
    zq = g[2 * n + qi];
    sqq = g[3 * n + qi];
    sq = g[4 * n + qi];
  }
  bool ok = true;
  for (int k0 = 0; k0 < n; k0 += KT) {
    __syncthreads();
    for (int i = threadIdx.x; i < 5 * KT; i += THREADS) {
      const int r = i / KT, c = i % KT, col = k0 + c;
      // a key past the end never suppresses: score -inf
      ks[r][c] = col < n ? g[static_cast<size_t>(r) * n + col] : (r == 4 ? -INFINITY : 0.f);
    }
    __syncthreads();
    for (int c = part; c < KT; c += SPLIT) {
      const float inner = xq * ks[0][c] + yq * ks[1][c] + zq * ks[2][c];
      const float d2 = fmaxf(sqq + ks[3][c] - 2.0f * inner, 0.0f);
      ok = ok && ((sq >= ks[4][c]) || (d2 >= r2));
    }
  }
  int flag = ok ? 1 : 0;
  flag &= __shfl_xor_sync(0xffffffffu, flag, 1);
  flag &= __shfl_xor_sync(0xffffffffu, flag, 2);
  if (live && part == 0) flags[static_cast<size_t>(b) * n + qi] = static_cast<float>(flag);
}

}  // namespace

extern "C" int nms_local_max(const void* geom, void* flags, int batch, int n, float r2,
                             void* stream) {
  const dim3 grid((n + QT - 1) / QT, batch);
  nms_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(geom), static_cast<float*>(flags), n, r2);
  return static_cast<int>(cudaGetLastError());
}
