// Symmetric int8 spatial-consistency cache (an experiment), CUDA C++ for sm_90a.
//
// Replaces the TPU kernels of tools/exp_symcache.py: the triangle build
// (tri_kernel :49, pallas_call :55) and the mirror (mirror_kernel :73,
// pallas_call :78), the experiment copy of pointdsc_tpu/kernels/
// sc_attention.py:343,368.
//
// compat_value(q, k) is exactly symmetric in f32 (csrc/compat_tile.cuh), so
// the strict lower triangle need not be computed:
//   1. compat_tri_kernel: one block per upper-triangular square tile (i, j >= i)
//      of side `blk` (a multiple of 256) and sample, walking it in 64 x 256
//      sub-tiles with the full-grid kernel's own tile body; the tile list
//      comes from the wrapper, as the TPU version scalar-prefetches it;
//   2. compat_mirror_kernel: one block per strictly-upper tile, which copies
//      it transposed into tile (j, i) through shared memory, 64 x 64 bytes at
//      a time, 16-byte loads and stores.
// The result equals compat_cache.cu's byte for byte.
//
// Bound on the H100: the bytes. The full-grid build writes N^2 bytes; this
// one writes ~N^2/2 in step 1 and reads and writes ~N^2/2 each in step 2,
// ~1.5 N^2 bytes in all against ~0.5 N^2 entries computed: it can win only
// where the arithmetic, not the write, limits the full-grid kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "compat_tile.cuh"

namespace {

constexpr int MT = 64;  // side of the mirror's shared tile, bytes

__global__ void __launch_bounds__(compat::THREADS)
compat_tri_kernel(const float* __restrict__ geom, const int2* __restrict__ tiles,
                  int8_t* __restrict__ out, int n, int blk, float coef) {
  __shared__ compat::TileSmem sm;
  const int b = blockIdx.z;
  const int2 t = tiles[blockIdx.x];  // (tile row i, tile column j >= i)
  const float* g = geom + static_cast<size_t>(b) * 16 * n;
  int8_t* o = out + static_cast<size_t>(b) * n * n;
  for (int r = 0; r < blk; r += compat::TQ)
    for (int c = 0; c < blk; c += compat::TK)
      compat::cache_tile(g, o, n, t.x * blk + r, t.y * blk + c, coef, sm);
}

__global__ void __launch_bounds__(256)
compat_mirror_kernel(const int2* __restrict__ tiles, int8_t* __restrict__ out, int n, int blk) {
  __shared__ int8_t sm[MT][MT + 4];
  const int b = blockIdx.z;
  const int2 t = tiles[blockIdx.x];  // strictly upper: j > i
  int8_t* o = out + static_cast<size_t>(b) * n * n;
  const int lr = threadIdx.x / 4;         // row of the 64 x 64 sub-tile
  const int lc = (threadIdx.x % 4) * 16;  // first of this thread's 16 bytes
  for (int r = 0; r < blk; r += MT) {
    for (int c = 0; c < blk; c += MT) {
      const size_t src_row = static_cast<size_t>(t.x) * blk + r + lr;
      const size_t src_col = static_cast<size_t>(t.y) * blk + c + lc;
      const int4 v = *reinterpret_cast<const int4*>(o + src_row * n + src_col);
      const int8_t* vb = reinterpret_cast<const int8_t*>(&v);
      __syncthreads();  // the previous sub-tile has been written out
#pragma unroll
      for (int k = 0; k < 16; ++k) sm[lr][lc + k] = vb[k];
      __syncthreads();
      // destination row (t.y * blk + c + lr) holds source column c + lr
      alignas(16) int8_t w[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) w[k] = sm[lc + k][lr];
      const size_t dst_row = static_cast<size_t>(t.y) * blk + c + lr;
      const size_t dst_col = static_cast<size_t>(t.x) * blk + r + lc;
      *reinterpret_cast<int4*>(o + dst_row * n + dst_col) = *reinterpret_cast<const int4*>(w);
    }
  }
}

}  // namespace

extern "C" int compat_cache_tri(const void* geom, const void* tiles, void* out, int batch, int n,
                                int blk, int num_tiles, float coef, void* stream) {
  const dim3 grid(num_tiles, 1, batch);
  compat_tri_kernel<<<grid, compat::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(geom), static_cast<const int2*>(tiles),
      static_cast<int8_t*>(out), n, blk, coef);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int compat_cache_mirror(const void* tiles, void* out, int batch, int n, int blk,
                                   int num_tiles, void* stream) {
  if (num_tiles == 0) return 0;
  const dim3 grid(num_tiles, 1, batch);
  compat_mirror_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int2*>(tiles), static_cast<int8_t*>(out), n, blk);
  return static_cast<int>(cudaGetLastError());
}
