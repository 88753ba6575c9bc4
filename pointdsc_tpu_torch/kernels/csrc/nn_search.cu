// Exact 3-D nearest neighbour, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel pointdsc_tpu/kernels/nn_search.py:38 (_nn_kernel,
// pallas_call :78, entry nearest_neighbors :102), which the ICP loop and the
// registration information matrix (ops/icp.py) call: for every query point
// the (squared distance, index) of its nearest base point, with no [N, M]
// matrix in device memory.
//
//   d2_ij = (|q_i|^2 + |b_j|^2) - 2 (q_i.b_j),   not clamped,
//   q_i.b_j = (qx bx + qy by) + qz bz,
//
// each operation rounded on its own (__fmul_rn / __fadd_rn: no FMA
// contraction) in the order of the plain PyTorch version, which computes the
// same terms elementwise, so kernel and plain version agree bit for bit.
// Inputs are packed [B, N, 4] / [B, M, 4] f32: (x, y, z, |p|^2), with
// |b|^2 = 1e30 for a masked base point, which then never wins.
//
// The TPU kernel keeps a running (min, argmin) per query row over base tiles,
// starts it at (1e30, 0) and merges a tile only when its minimum is strictly
// below, so ties go to the lowest index and a row whose base points are all
// masked returns (1e30, 0). Here the same: a block owns 64 query rows, each
// row is walked by 4 threads, each over its quarter of every base tile
// staged in shared memory as float4; the 4 partial (min, argmin) are merged
// by (d2, index) order, which gives the first index of the global minimum
// whatever the split.
//
// Bound on the H100: ~9 f32 operations per (query, base) pair against 16
// bytes per point read once, so the operations bound it (N = M = 20480:
// 3.8e9 operations, 56 us at 67 TFLOP/s). The base is re-read from L2 by
// every block (M * 16 bytes each).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;    // query rows per block
constexpr int SPLIT = 4;    // threads per row
constexpr int THREADS = ROWS * SPLIT;
constexpr int TILE = 1024;  // base points per shared tile (16 KB)
constexpr float BIG = 1e30f;

__global__ void __launch_bounds__(THREADS)
nn_kernel(const float4* __restrict__ query, const float4* __restrict__ base,
          float* __restrict__ d2_out, int32_t* __restrict__ idx_out, int n, int m) {
  __shared__ float4 tile[TILE];
  __shared__ float part_d[SPLIT][ROWS];
  __shared__ int32_t part_i[SPLIT][ROWS];

  const int b = blockIdx.z;
  const int r = threadIdx.x % ROWS;
  const int s = threadIdx.x / ROWS;
  const int row = blockIdx.x * ROWS + r;
  const float4* bb = base + static_cast<size_t>(b) * m;
  const float4 q = row < n ? query[static_cast<size_t>(b) * n + row]
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  float best = BIG;
  int32_t best_i = 0;
  constexpr int PER = TILE / SPLIT;
  for (int t0 = 0; t0 < m; t0 += TILE) {
    const int len = min(TILE, m - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += THREADS) tile[i] = bb[t0 + i];
    __syncthreads();
    const int lo = s * PER;
    const int hi = min(lo + PER, len);
#pragma unroll 4
    for (int j = lo; j < hi; ++j) {
      const float4 p = tile[j];
      const float inner =
          __fadd_rn(__fadd_rn(__fmul_rn(q.x, p.x), __fmul_rn(q.y, p.y)), __fmul_rn(q.z, p.z));
      const float d2 = __fsub_rn(__fadd_rn(q.w, p.w), __fmul_rn(2.0f, inner));
      if (d2 < best) {  // strict: the first index of an equal minimum stays
        best = d2;
        best_i = t0 + j;
      }
    }
  }
  part_d[s][r] = best;
  part_i[s][r] = best_i;
  __syncthreads();
  if (s != 0 || row >= n) return;
  for (int k = 1; k < SPLIT; ++k) {
    const float d = part_d[k][r];
    const int32_t i = part_i[k][r];
    // a part that found nothing below 1e30 holds (1e30, 0) and never wins
    if (d < best || (d == best && d < BIG && i < best_i)) {
      best = d;
      best_i = i;
    }
  }
  d2_out[static_cast<size_t>(b) * n + row] = best;
  idx_out[static_cast<size_t>(b) * n + row] = best_i;
}

}  // namespace

extern "C" int nearest_neighbors(const void* query, const void* base, void* d2, void* idx,
                                 int batch, int n, int m, void* stream) {
  const dim3 grid((n + ROWS - 1) / ROWS, 1, batch);
  nn_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(query), static_cast<const float4*>(base),
      static_cast<float*>(d2), static_cast<int32_t*>(idx), n, m);
  return static_cast<int>(cudaGetLastError());
}
