// Symmetric int8 spatial-consistency cache, CUDA C++ for sm_90a.
//
// Replaces the TPU kernels of pointdsc_tpu/kernels/sc_attention.py:343,368
// (_build_compat_cache_symmetric's triangle kernel, pallas_call :351, and its
// mirror, pallas_call :371: JAX's build at N % 1024 == 0, N >= 2048) and their
// copy in tools/exp_symcache.py (tri_kernel :49, pallas_call :55;
// mirror_kernel :73, pallas_call :78), in one launch.
//
// compat_level(q, k) == compat_level(k, q) exactly (csrc/compat_tile.cuh),
// so each unordered pair is computed once and written twice. The entry,
// its register layout and its rule for the square root are the full-grid
// kernel's (compat_cache.cu: compat::load_keys, load_query, row_bytes): the
// bytes equal it, byte for byte.
//
// Layout. A block of 4 warps owns a strip of 512 key columns, 16 a thread in
// registers; a row's query point is a warp broadcast. Strip s computes only
// the rows 0 .. 512 (s + 1) - 1, at or above its diagonal block, in bands of
// 32 rows (8 a warp, one at a time: the unrolled band overflowed the
// instruction cache). Each row's 16 bytes go to the row as one 128-bit
// store, as in the full-grid kernel. A strictly-upper band (its rows left of
// the strip) is also written transposed, from the computation, never read
// back from `out`: each thread also stores its row's 16 bytes one by one in
// a 16 KB staging tile in shared memory, column-major ([column][row], 32
// bytes a column), swizzled so that a warp's byte stores and the word loads
// below hit 32 distinct banks. After one barrier two lanes load the 8 words
// of one of the strip's columns, 4 each, and write them as the 32 contiguous
// bytes of the mirrored row (a 128-bit store each, one 32-byte sector). Two
// staging tiles alternate, so a band costs one barrier. The diagonal block's
// bands are computed whole and written directly (1 / (2 strips) more
// arithmetic than the triangle's).
//
// Balance. Strip s holds 16 (s + 1) bands, the last 16 its diagonal block's,
// each of whose rows holds the diagonal's zero distance and so takes the
// sqrtf fallback (the plan weighs such a band 1.75 bands above it:
// kernels/sc_attention.py::SYM_DIAGONAL_COST). The
// wrapper cuts the strips into work items (strip, first band, bands) of
// near-equal work, the most first, no more than the card's resident blocks
// (kernels/sc_attention.py::symmetric_cache_plan, a read-only table made
// once a shape), so the build is one wave. The batch is the grid's y.
//
// Bound on the H100: issue, as the full-grid kernel's. An output byte takes
// about half an entry's instructions plus the mirror's few (a shared byte
// store an entry, a word load and a quarter of a 128-bit store a mirrored
// word): tools/kernel_report.py counts the band and row loops and prints the
// issue floor; the N^2 bytes written take 7.8 / 45 / 125 us at
// N = 5120 / 12288 / 20480 at 3.35 TB/s.
//
// Ragged N: rows are 16-byte aligned where N % 16 == 0, else the stores go
// in units of 8, 4 or 1 bytes (the A instantiations), guarded at the edge.

#include <cuda_runtime.h>
#include <stdint.h>

#include "compat_tile.cuh"

namespace {

constexpr int COLS = 16;                      // key columns a thread
constexpr int WARPS = 4;                      // warps a block
constexpr int BLOCK_COLS = 32 * COLS;         // 512 columns a block: its strip
constexpr int BAND = 32;                      // rows a band: 32 bytes a mirrored row
constexpr int ROWS = BAND / WARPS;            // rows a warp computes a band
constexpr int STAGE_WORDS = BLOCK_COLS * BAND / 4;
constexpr int MIN_BLOCKS = 2;  // resident blocks an SM (kernels/sc_attention.py: SYM_BLOCKS_PER_SM)

// the staging tile's word of (column c of the strip, row group g of the
// band: rows 4 g .. 4 g + 3, one a byte): column c's 8 words lie together,
// permuted by c's bits 6-8, and the columns' places permuted by their bits
// 4-5, so that the 32 columns 16 l + c' of a warp's byte store (one per lane
// l) and the 16 columns x 2 halves of a warp's word load (4 consecutive
// columns in each of 4 groups of 64) fall in 32 distinct banks
__device__ __forceinline__ int stage_word(int c, int g) {
  return (c ^ ((c >> 4) & 3)) * (BAND / 4) + (g ^ ((c >> 6) & 7));
}

// the first `count` bytes of w (four a word, the first in the lowest) at
// dst, in units of A bytes: dst is A-aligned, count a multiple of A or at
// least 4 W
template <int A, int W>
__device__ __forceinline__ void store_bytes(int8_t* dst, const uint32_t (&w)[W], int count) {
#pragma unroll
  for (int u = 0; u < 4 * W / A; ++u) {
    if (A * u >= count) break;
    if constexpr (A == 16)
      reinterpret_cast<uint4*>(dst)[u] = make_uint4(w[4 * u], w[4 * u + 1], w[4 * u + 2],
                                                    w[4 * u + 3]);
    else if constexpr (A == 8)
      reinterpret_cast<uint2*>(dst)[u] = make_uint2(w[2 * u], w[2 * u + 1]);
    else if constexpr (A == 4)
      reinterpret_cast<uint32_t*>(dst)[u] = w[u];
    else
      dst[u] = static_cast<int8_t>((w[u / 4] >> (8 * (u % 4))) & 0xFFu);
  }
}

// A: the bytes of a store unit, 16 where n % 16 == 0, else 8, 4 or 1
template <int A>
__global__ void __launch_bounds__(32 * WARPS, MIN_BLOCKS)
compat_cache_sym_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
                        const int* __restrict__ plan, int8_t* __restrict__ out, int n,
                        float coef) {
  __shared__ uint32_t stage[2][STAGE_WORDS];
  const int b = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int strip = __ldg(plan + 3 * blockIdx.x), first = __ldg(plan + 3 * blockIdx.x + 1),
            bands = __ldg(plan + 3 * blockIdx.x + 2);
  const int col0 = strip * BLOCK_COLS;  // the strip's first column
  const int j0 = col0 + lane * COLS;    // the thread's first column
  const float* s = src + static_cast<size_t>(b) * n * 3;
  const float* t = tgt + static_cast<size_t>(b) * n * 3;
  int8_t* o = out + static_cast<size_t>(b) * n * n;

  float k[COLS][8];
  compat::load_keys<COLS>(s, t, j0, n, k);
  // the staging tile's byte of (column 16 lane + 4 a + b, row r of the band)
  // is 4 stage_word(.., r / 4) + r % 4 = col_off[b] + 128 a + 4 (r / 4 ^ lane / 4) + r % 4
  int col_off[4];
#pragma unroll
  for (int b4 = 0; b4 < 4; ++b4) col_off[b4] = 512 * lane + 32 * (b4 ^ (lane & 3));
  // the mirror's reads: lanes 2 m' and 2 m' + 1 load the two 16-byte halves h
  // of the strip's column j = jr + 4 it (it = 0 .. 7), the 32 bytes of the
  // mirrored row col0 + j, and store them as one 32-byte sector. Over it, j's
  // bits 6-8 stay, and bits 4-5 (the columns' place) change once, so the
  // words stage_word(j, 4 h + u) are rd_word[u] + rd_off[it / 4] + 32 it
  const int h = lane & 1, a = (lane >> 1) & 3;
  const int jr = a + 64 * (lane >> 3) + 32 * (warp & 1) + 256 * (warp >> 1);
  const int n_strip = n - col0;  // the strip's columns inside the matrix
  int rd_word[4], rd_off[2];
#pragma unroll
  for (int u = 0; u < 4; ++u) rd_word[u] = 8 * (jr - a) + ((4 * h + u) ^ ((jr >> 6) & 7));
#pragma unroll
  for (int half = 0; half < 2; ++half) rd_off[half] = 8 * (a ^ (2 * (warp & 1) + half));
  int8_t* rd_row = o + static_cast<size_t>(col0 + jr) * n + 16 * h;

  for (int i = 0; i < bands; ++i) {
    const int band0 = (first + i) * BAND;
    const bool mirror = band0 < col0;  // left of the diagonal block: the same for the block
    uint8_t* st = reinterpret_cast<uint8_t*>(stage[i & 1]);
    // one row at a time, not unrolled: the loop stays in the instruction cache
#pragma unroll 1
    for (int rb = warp * ROWS; rb < (warp + 1) * ROWS; ++rb) {  // the row in the band
      const int row = band0 + rb;
      // a row past n (the last diagonal block's) is computed, not stored
      float q[8];
      compat::load_query(s, t, min(row, n - 1), q);
      uint32_t w[COLS / 4];
      compat::row_bytes<COLS>(q, k, coef, w);
      if (row < n && j0 < n) store_bytes<A>(o + static_cast<size_t>(row) * n + j0, w, n - j0);
      if (mirror) {
        uint8_t* dst = st + 4 * ((rb >> 2) ^ (lane >> 2)) + (rb & 3);
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          dst[col_off[c & 3] + 128 * (c >> 2)] = static_cast<uint8_t>(w[c / 4] >> (8 * (c % 4)));
      }
    }
    if (mirror) {
      __syncthreads();  // the band's tile is staged (and the tile before it read)
#pragma unroll
      for (int it = 0; it < 2 * BLOCK_COLS / (32 * WARPS); ++it) {
        if (jr + 4 * it < n_strip) {
          uint32_t v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) v[u] = stage[i & 1][rd_word[u] + rd_off[it >> 2] + 32 * it];
          store_bytes<A>(rd_row + static_cast<size_t>(it) * 4 * n + band0, v, 16);
        }
      }
    }
  }
}

// the bands of the triangle's strips: strip s holds ceil(min(512 (s + 1), n) / 32)
long long triangle_bands(int n) {
  long long total = 0;
  for (long long c = BLOCK_COLS; c - BLOCK_COLS < n; c += BLOCK_COLS)
    total += ((c < n ? c : n) + BAND - 1) / BAND;
  return total;
}

template <int A>
void launch(const dim3& grid, cudaStream_t st, const void* src, const void* tgt,
            const void* plan, void* out, int n, float coef) {
  compat_cache_sym_kernel<A><<<grid, 32 * WARPS, 0, st>>>(
      static_cast<const float*>(src), static_cast<const float*>(tgt),
      static_cast<const int*>(plan), static_cast<int8_t*>(out), n, coef);
}

}  // namespace

// plan: [items, 3] int32 on the device, each row (strip, first band, bands)
// (kernels/sc_attention.py::symmetric_cache_plan); `bands` the plan's band
// total, which must be the triangle's, else the launch is refused.
extern "C" int compat_cache_sym(const void* src, const void* tgt, const void* plan, int items,
                                int bands, void* out, int batch, int n, float coef,
                                void* stream) {
  if (n < 1 || batch < 1 || batch > 65535 || items < 1 || plan == nullptr ||
      bands != triangle_bands(n))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(items, batch);
  const auto st = static_cast<cudaStream_t>(stream);
  if (n % 16 == 0)
    launch<16>(grid, st, src, tgt, plan, out, n, coef);
  else if (n % 8 == 0)
    launch<8>(grid, st, src, tgt, plan, out, n, coef);
  else if (n % 4 == 0)
    launch<4>(grid, st, src, tgt, plan, out, n, coef);
  else
    launch<1>(grid, st, src, tgt, plan, out, n, coef);
  return static_cast<int>(cudaGetLastError());
}
