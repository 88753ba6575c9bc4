// int8 spatial-consistency cache, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel pointdsc_tpu/kernels/sc_attention.py:236
// (_compat_cache_kernel via _build_compat_cache_single); the symmetric
// triangle + mirror pair of :343/:368 is compat_cache_sym.cu, which writes
// the same bytes.
//
//   out[b, i, j] = round(max(127 - coef * (d_s - d_t)^2, 0)),  coef = 127 / sigma_d^2
//
// with the one-sqrt form (d_s - d_t)^2 = s2 + t2 - 2 sqrt(s2 t2) and the gram
// form s2 = max(|x_i|^2 + |x_j|^2 - 2 x_i.x_j, 0): compat::compat_level of
// csrc/compat_tile.cuh, with IEEE sqrtf (its branch-free path,
// compat::sqrt_in_range, for every entry of a row whose products all lie in
// its range, and sqrtf for the rows that hold a zero distance:
// compat::row_bytes), rounded and packed four bytes at a time by
// compat::pack_levels. Nothing is masked: the attention kernel's key bias
// handles invalid keys. The value is clamped at 127 so a rounding excess can
// never wrap the int8.
//
// The kernel reads src and tgt [B, N, 3] in place and computes the squared
// norms itself (compat::sq_norm, as the symmetric build does): the bytes
// equal the symmetric build's.
//
// Bound on the H100: issue, not bytes. Each entry takes ~30 instructions on
// its common path (two 3-dots, two gram distances, the IEEE sqrtf and its
// range check, the clamps, the rounding and a share of the packing; the
// count of the compiled row loop is tools/kernel_report.py's) against one
// byte written: at 132 SMs x 128 lanes x 1.98 GHz that floor is ~0.023 ms at
// N = 5120 and ~0.13 ms at 12288, above the N^2 bytes' 7.8 and 45 us at
// 3.35 TB/s. Design: each thread keeps the geometry of 16 consecutive key
// columns in registers (loaded once, as 16-byte loads, no shared memory) and
// walks a band of rows; a row's query point is the same for the whole warp
// (a broadcast load), and the thread stores its 16 bytes of the row in one
// 128-bit store, so a warp writes 512 contiguous bytes. A block of 4 warps
// owns 512 columns and walks bands of 4 rows; the grid is sized to the card
// (the resident blocks of all SMs shared out over the column strips), so
// every block stays resident, loads its keys once and takes the same number
// of rows, give or take a band.
// Where N is not a multiple of 16, a second instantiation guards the ragged
// edge with byte stores. The symmetric build computes each unordered pair
// once; kernels/sc_attention.py::use_symmetric_cache takes it at the N where
// it measured faster on an H100 (PERF.md, row 15).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "compat_tile.cuh"

namespace {

constexpr int COLS = 16;               // key columns a thread
constexpr int WARPS = 4;               // warps a block, one row each at a time
constexpr int BLOCK_COLS = 32 * COLS;  // 512 columns a block (each warp all of them)
constexpr int MIN_BLOCKS = 2;          // resident blocks an SM (at 3, 168 registers, it spills)

// a thread's COLS bytes of a row in one store (dst aligned to COLS bytes)
__device__ __forceinline__ void store_row(int8_t* dst, const uint32_t (&w)[COLS / 4]) {
  static_assert(COLS == 8 || COLS == 16, "one 64- or 128-bit store a row");
  if constexpr (COLS == 16)
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  else
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
}

// kVector: n % COLS == 0, so every thread's columns lie inside the row and
// start on a COLS-byte boundary (one store a row); else guarded stores
template <bool kVector>
__global__ void __launch_bounds__(32 * WARPS, MIN_BLOCKS)
compat_cache_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
                    int8_t* __restrict__ out, int n, float coef) {
  const int b = blockIdx.z, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = static_cast<int>(blockIdx.x) * BLOCK_COLS + lane * COLS;  // first column
  if (j0 >= n) return;
  const float* s = src + static_cast<size_t>(b) * n * 3;
  const float* t = tgt + static_cast<size_t>(b) * n * 3;

  // the keys' geometry in compat_level's layout: xyz, |.|^2 of src then tgt
  float k[COLS][8];
  compat::load_keys<COLS>(s, t, j0, n, k);

  // bands of WARPS rows, block y taking bands y, y + gridDim.y, ...
  for (int row = static_cast<int>(blockIdx.y) * WARPS + warp; row < n;
       row += static_cast<int>(gridDim.y) * WARPS) {
    float q[8];
    compat::load_query(s, t, row, q);
    uint32_t w[COLS / 4];
    compat::row_bytes<COLS>(q, k, coef, w);
    int8_t* dst = out + (static_cast<size_t>(b) * n + row) * n + j0;
    if (kVector) {
      store_row(dst, w);
    } else {
      for (int c = 0; c < COLS && j0 + c < n; ++c)
        dst[c] = static_cast<int8_t>((w[c / 4] >> (8 * (c % 4))) & 0xFFu);
    }
  }
}

// The rectangular form: rows from one pair of clouds, the nq points of a
// row shard (src_rows, tgt_rows [B, nq, 3]), columns from another, all nk
// keys (src_cols, tgt_cols [B, nk, 3]), out [B, nq, nk]. Replaces the TPU
// kernel's rectangular build, _build_compat_cache_single(..., geom_cols=...)
// (pointdsc_tpu/kernels/sc_attention.py:262-298, pallas_call at :285): each
// device of the sequence-parallel encoder builds only its [N/D, N] slice.
// The layout, the entry and the stores are the square kernel's, so a row
// holds the same bytes as that row of the square cache of the whole cloud.
template <bool kVector>
__global__ void __launch_bounds__(32 * WARPS, MIN_BLOCKS)
compat_cache_rect_kernel(const float* __restrict__ src_rows, const float* __restrict__ tgt_rows,
                         const float* __restrict__ src_cols, const float* __restrict__ tgt_cols,
                         int8_t* __restrict__ out, int nq, int nk, float coef) {
  const int b = blockIdx.z, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = static_cast<int>(blockIdx.x) * BLOCK_COLS + lane * COLS;  // first column
  if (j0 >= nk) return;
  const float* sr = src_rows + static_cast<size_t>(b) * nq * 3;
  const float* tr = tgt_rows + static_cast<size_t>(b) * nq * 3;

  float k[COLS][8];
  compat::load_keys<COLS>(src_cols + static_cast<size_t>(b) * nk * 3,
                          tgt_cols + static_cast<size_t>(b) * nk * 3, j0, nk, k);
  for (int row = static_cast<int>(blockIdx.y) * WARPS + warp; row < nq;
       row += static_cast<int>(gridDim.y) * WARPS) {
    float q[8];
    compat::load_query(sr, tr, row, q);
    uint32_t w[COLS / 4];
    compat::row_bytes<COLS>(q, k, coef, w);
    int8_t* dst = out + (static_cast<size_t>(b) * nq + row) * nk + j0;
    if (kVector) {
      store_row(dst, w);
    } else {
      for (int c = 0; c < COLS && j0 + c < nk; ++c)
        dst[c] = static_cast<int8_t>((w[c / 4] >> (8 * (c % 4))) & 0xFFu);
    }
  }
}

// blocks a column strip gets: the card's resident blocks shared out over
// the strips and samples (per device, computed once), at most one band of
// the `rows` rows each
int grid_rows(int strips, int batch, int rows) {
  static int resident[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 1;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, compat_cache_kernel<true>,
                                                  32 * WARPS, 0);
    resident[dev] = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  const int bands = (rows + WARPS - 1) / WARPS;
  return std::max(1, std::min(bands, resident[dev] / (strips * batch)));
}

}  // namespace

extern "C" int compat_cache_int8(const void* src, const void* tgt, void* out, int batch, int n,
                                 float coef, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int strips = (n + BLOCK_COLS - 1) / BLOCK_COLS;
  const dim3 grid(strips, grid_rows(strips, batch, n), batch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(src);
  const float* t = static_cast<const float*>(tgt);
  int8_t* o = static_cast<int8_t*>(out);
  if (n % COLS == 0)
    compat_cache_kernel<true><<<grid, 32 * WARPS, 0, st>>>(s, t, o, n, coef);
  else
    compat_cache_kernel<false><<<grid, 32 * WARPS, 0, st>>>(s, t, o, n, coef);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int compat_cache_int8_rect(const void* src_rows, const void* tgt_rows,
                                      const void* src_cols, const void* tgt_cols, void* out,
                                      int batch, int nq, int nk, float coef, void* stream) {
  if (nq < 1 || nk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int strips = (nk + BLOCK_COLS - 1) / BLOCK_COLS;
  const dim3 grid(strips, grid_rows(strips, batch, nq), batch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sr = static_cast<const float*>(src_rows);
  const float* tr = static_cast<const float*>(tgt_rows);
  const float* sc = static_cast<const float*>(src_cols);
  const float* tc = static_cast<const float*>(tgt_cols);
  int8_t* o = static_cast<int8_t*>(out);
  if (nk % COLS == 0)
    compat_cache_rect_kernel<true><<<grid, 32 * WARPS, 0, st>>>(sr, tr, sc, tc, o, nq, nk, coef);
  else
    compat_cache_rect_kernel<false><<<grid, 32 * WARPS, 0, st>>>(sr, tr, sc, tc, o, nq, nk, coef);
  return static_cast<int>(cudaGetLastError());
}
