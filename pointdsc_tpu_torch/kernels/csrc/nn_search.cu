// Exact 3-D nearest neighbour, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel pointdsc_tpu/kernels/nn_search.py:38 (_nn_kernel,
// pallas_call :78, entry nearest_neighbors :102), which the ICP loop and the
// registration information matrix (ops/icp.py) call: for every query point
// the (squared distance, index) of its nearest base point, with no [N, M]
// matrix in device memory.
//
//   d2_ij = (|q_i|^2 + |b_j|^2) - 2 (q_i.b_j),   not clamped,
//   q_i.b_j = (qx bx + qy by) + qz bz,   |p|^2 = (x x + y y) + z z,
//
// each operation rounded on its own (__fmul_rn / __fadd_rn: no FMA
// contraction) in the order of the plain PyTorch version, which computes the
// same terms elementwise, so kernel and plain version agree bit for bit. The
// last step is one fmaf(-2, inner, s): 2 inner is exact, so its one rounding
// is the plain version's rounding of s - 2 inner. The kernel reads the
// clouds as they are, [B, N, 3] / [B, M, 3] f32 and the [B, M] bool mask,
// and computes the norms itself; a masked base point gets |b|^2 = 1e30, as
// in the plain version, and then never wins.
//
// The TPU kernel keeps a running (min, argmin) per query row over base tiles,
// starts it at (1e30, 0) and merges a tile only when its minimum is strictly
// below, so ties go to the lowest index and a row whose base points are all
// masked returns (1e30, 0). Here the same result, laid out for the H100:
// - Bound: ~10 instructions a pair (3 FMUL, 3 FADD, FFMA, the compare, two
//   selects) at 128 lanes a clock an SM, so the issue rate bounds it, not
//   the bytes (kernels/nn_search.py::nn_issue_floor_ms).
// - A thread holds R = 4 query rows in registers (rows tid + 128 r of its
//   block's 512), so each base point, one broadcast 16-byte shared load,
//   feeds 4 pairs.
// - Base tiles of 256 points in two shared stages: a thread loads its two
//   points of the next tile into registers before it works the current one,
//   then stores them as (x, y, z, |b|^2 or 1e30). Points past the range are
//   (0, 0, 0, 1e30): never below 1e30, so the loop runs in steps of 4.
// - The grid is (query blocks, splits, batch): the base is cut into `splits`
//   consecutive ranges of `range` points, chosen by the wrapper
//   (nn_search.py::nn_grid) so that the blocks fill about one wave at small
//   N. A block reduces its range to each row's (min, first argmin), strictly
//   below 1e30. With one range it writes the result; with several it lowers
//   a 64-bit key per row (order-preserving bits of d2, index) by atomicMin in
//   a workspace that the entry sets to ones (no candidate) before the
//   launch, on the same stream, and the last
//   block of its query rows to finish (a counter) reads the keys and writes
//   d2 and the int64 index. Keys order by d2, then index, so the result is
//   the first index of the minimum whatever order the blocks run in, the
//   same from run to run, and negative d2 order below zero.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int R = 4;               // query rows a thread
constexpr int ROWS = THREADS * R;  // query rows a block
constexpr int TILE = 256;          // base points a shared stage
constexpr int PER = TILE / THREADS;
constexpr float BIG = 1e30f;
constexpr unsigned long long NONE = ~0ull;

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// bits of a finite float whose unsigned order is the float order
__device__ __forceinline__ unsigned int ordered_bits(float d) {
  const unsigned int u = __float_as_uint(d);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered_bits(unsigned int o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__global__ void __launch_bounds__(THREADS, 8)
nn_kernel(const float* __restrict__ query, const float* __restrict__ base,
          const uint8_t* __restrict__ mask, float* __restrict__ d2_out,
          int64_t* __restrict__ idx_out, unsigned long long* __restrict__ keys,
          unsigned int* __restrict__ counters, int n, int m, int range) {
  __shared__ float4 tile[2][TILE];
  __shared__ bool last;

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int r0 = blockIdx.x * ROWS;
  const int m0 = blockIdx.y * range;
  const int m1 = min(m0 + range, m);
  const size_t rows0 = static_cast<size_t>(b) * n;
  query += rows0 * 3;
  base += static_cast<size_t>(b) * m * 3;
  if (mask != nullptr) mask += static_cast<size_t>(b) * m;

  float qx[R], qy[R], qz[R], qw[R], best[R];
  int best_i[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = r0 + r * THREADS + tid;
    qx[r] = row < n ? __ldg(query + 3 * row) : 0.0f;
    qy[r] = row < n ? __ldg(query + 3 * row + 1) : 0.0f;
    qz[r] = row < n ? __ldg(query + 3 * row + 2) : 0.0f;
    qw[r] = sq_norm(qx[r], qy[r], qz[r]);
    best[r] = BIG;
    best_i[r] = 0;
  }

  // this thread's points of the next tile, held in registers
  float px[PER], py[PER], pz[PER];
  bool pv[PER];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int j = t0 + i * THREADS + tid;
      const bool in = j < m1;
      px[i] = in ? __ldg(base + 3 * j) : 0.0f;
      py[i] = in ? __ldg(base + 3 * j + 1) : 0.0f;
      pz[i] = in ? __ldg(base + 3 * j + 2) : 0.0f;
      pv[i] = in && (mask == nullptr || mask[j] != 0);
    }
  };
  auto stage = [&](float4* dst) {
#pragma unroll
    for (int i = 0; i < PER; ++i)
      dst[i * THREADS + tid] =
          make_float4(px[i], py[i], pz[i], pv[i] ? sq_norm(px[i], py[i], pz[i]) : BIG);
  };

  if (m0 < m1) {
    fetch(m0);
    stage(tile[0]);
  }
  __syncthreads();
  int st = 0;
  for (int t0 = m0; t0 < m1; t0 += TILE, st ^= 1) {
    const bool more = t0 + TILE < m1;
    if (more) fetch(t0 + TILE);  // in flight while this tile is worked
    const int len = (min(TILE, m1 - t0) + 3) & ~3;
    const float4* tl = tile[st];
#pragma unroll 4
    for (int j = 0; j < len; ++j) {
      const float4 p = tl[j];
      const int at = t0 + j;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float inner = __fadd_rn(__fadd_rn(__fmul_rn(qx[r], p.x), __fmul_rn(qy[r], p.y)),
                                      __fmul_rn(qz[r], p.z));
        const float d2 = __fmaf_rn(-2.0f, inner, __fadd_rn(qw[r], p.w));
        if (d2 < best[r]) {  // strict: the first index of an equal minimum stays
          best[r] = d2;
          best_i[r] = at;
        }
      }
    }
    if (more) stage(tile[st ^ 1]);  // its readers finished at the last barrier
    __syncthreads();
  }

  if (gridDim.y == 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = r0 + r * THREADS + tid;
      if (row < n) {  // (1e30, 0) when nothing was below 1e30
        d2_out[rows0 + row] = best[r];
        idx_out[rows0 + row] = best_i[r];
      }
    }
    return;
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = r0 + r * THREADS + tid;
    if (row < n && best[r] < BIG)
      atomicMin(keys + rows0 + row,
                (static_cast<unsigned long long>(ordered_bits(best[r])) << 32) |
                    static_cast<unsigned int>(best_i[r]));
  }
  __threadfence();
  __syncthreads();
  // counters start at all ones: the k-th block to arrive reads k - 2
  unsigned int* counter = counters + static_cast<size_t>(b) * gridDim.x + blockIdx.x;
  if (tid == 0) last = atomicAdd(counter, 1u) == gridDim.y - 2u;
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = r0 + r * THREADS + tid;
    if (row < n) {
      const unsigned long long key = __ldcg(keys + rows0 + row);
      const bool found = key != NONE;
      d2_out[rows0 + row] = found ? from_ordered_bits(static_cast<unsigned int>(key >> 32)) : BIG;
      idx_out[rows0 + row] = found ? static_cast<int64_t>(key & 0xffffffffull) : 0;
    }
  }
}

}  // namespace

// query [B, n, 3], base [B, m, 3] f32, mask [B, m] bool or null; d2 [B, n]
// f32, idx [B, n] int64; ranges of `range` base points, `splits` of them
// covering m; qblocks must be the launch's ceil(n / 512) query blocks. With
// splits > 1, work (`words` 8-byte words, at least 8 B n + 4 B qblocks
// bytes) holds the merge's keys [B n] u64 and then its counters
// [B qblocks] u32, which this entry sets to all ones before the launch.
extern "C" int nearest_neighbors(const void* query, const void* base, const void* mask, void* d2,
                                 void* idx, void* work, int batch, int n, int m, int qblocks,
                                 int splits, int range, int words, void* stream) {
  const size_t bytes = static_cast<size_t>(batch) * (8ull * n + 4ull * qblocks);
  if (batch < 1 || n < 1 || m < 0 || splits < 1 || range < 1 ||
      qblocks != (n + ROWS - 1) / ROWS || static_cast<long long>(splits) * range < m ||
      (splits > 1 && (work == nullptr || 8ull * words < bytes)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* keys = static_cast<unsigned long long*>(work);
  auto* counters =
      splits > 1 ? reinterpret_cast<unsigned int*>(keys + static_cast<size_t>(batch) * n) : nullptr;
  const auto st = static_cast<cudaStream_t>(stream);
  if (splits > 1) {
    const cudaError_t err = cudaMemsetAsync(work, 0xff, bytes, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(qblocks, splits, batch);
  nn_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const float*>(query), static_cast<const float*>(base),
      static_cast<const uint8_t*>(mask), static_cast<float*>(d2), static_cast<int64_t*>(idx),
      keys, counters, n, m, range);
  return static_cast<int>(cudaGetLastError());
}
