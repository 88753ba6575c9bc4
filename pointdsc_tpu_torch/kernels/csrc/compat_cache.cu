// int8 spatial-consistency cache, CUDA C++ for sm_90a.
//
// Replaces the TPU kernels pointdsc_tpu/kernels/sc_attention.py:236
// (_compat_cache_kernel via _build_compat_cache_single) and :343/:368 (the
// symmetric triangle + mirror pair): both write the same bytes.
//
//   out[b, i, j] = round(max(127 - coef * (d_s - d_t)^2, 0)),  coef = 127 / sigma_d^2
//
// with the one-sqrt form (d_s - d_t)^2 = s2 + t2 - 2 sqrt(s2 t2) and the gram
// form s2 = max(|x_i|^2 + |x_j|^2 - 2 x_i.x_j, 0), from the packed [B, 16, N]
// geometry strip (rows 0-2 src xyz, 3 |src|^2, 4-6 tgt xyz, 7 |tgt|^2).
// Nothing is masked: the attention kernel's key bias handles invalid keys.
// The value is clamped at 127 so a rounding excess can never wrap the int8.
// The tile body is csrc/compat_tile.cuh, shared with compat_cache_sym.cu.
//
// Bound on the H100: the N^2 int8 bytes written (26.2 MB at N = 5120, 7.8 us
// at 3.35 TB/s); the ~25 flops and one sqrt per entry are far below the
// compute roof. Design: a block owns a 64 x 256 output tile, stages the 64
// query and 256 key geometry columns in shared memory once, and each thread
// writes 4 consecutive bytes per row as one 32-bit store, so a warp writes
// 128 contiguous bytes of a row. The symmetric half-build of the TPU version
// is not used here: measured on an H100 (compat_cache_sym.cu, the experiment),
// it takes 0.91x this kernel's time at N = 20480 and more at N = 5120, its
// mirror pass costing about what the skipped arithmetic saves.

#include <cuda_runtime.h>
#include <stdint.h>

#include "compat_tile.cuh"

namespace {

__global__ void __launch_bounds__(compat::THREADS)
compat_cache_kernel(const float* __restrict__ geom, int8_t* __restrict__ out, int n, float coef) {
  __shared__ compat::TileSmem sm;
  const int b = blockIdx.z;
  compat::cache_tile(geom + static_cast<size_t>(b) * 16 * n, out + static_cast<size_t>(b) * n * n,
                     n, blockIdx.y * compat::TQ, blockIdx.x * compat::TK, coef, sm);
}

}  // namespace

extern "C" int compat_cache_int8(const void* geom, void* out, int batch, int n, float coef,
                                 void* stream) {
  const dim3 grid((n + compat::TK - 1) / compat::TK, (n + compat::TQ - 1) / compat::TQ, batch);
  compat_cache_kernel<<<grid, compat::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(geom), static_cast<int8_t*>(out), n, coef);
  return static_cast<int>(cudaGetLastError());
}
