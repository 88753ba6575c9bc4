// f32 tiles at C = 128 on the CUDA cores, shared by the kernels that walk
// 32-row tiles past 64 owned rows with 8 x 8 register tiles: the trainable
// attention's (sc_attention_train.cu) and the SM loss's (sm_loss.cu).
// - cp.async copies of [rows][C] stages and of a strip's columns, zero-filled
//   past n, so that a tile can be copied while the one before it is worked;
// - warp_rows_dot: a warp's 8 own rows against a 32-row tile, the 128
//   channels split over 8 lanes and summed by three shuffle levels.
// Blocks of THREADS threads; rows of C floats, unpadded.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace f32_tiles {

constexpr int C = 128;
constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes, or 16 zeros when !ok (nothing is read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// rows [r0, r0 + ROWS) of a [n, C] array into a [ROWS][C] stage, zeros past n
template <int ROWS>
__device__ __forceinline__ void copy_rows(float* dst, const float* __restrict__ src, int r0,
                                          int n) {
  static_assert(ROWS * C / 4 % THREADS == 0, "whole passes");
#pragma unroll
  for (int pass = 0; pass < ROWS * C / 4 / THREADS; ++pass) {
    const int i = threadIdx.x + pass * THREADS;
    const int r = i / (C / 4), c4 = (i % (C / 4)) * 4;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * C + c4, ok ? src + static_cast<size_t>(r0 + r) * C + c4 : src, ok);
  }
}

// columns [c0, c0 + COLS) of the first `rows` rows of a [rows, n] array
template <int COLS>
__device__ __forceinline__ void copy_cols(float* dst, const float* __restrict__ src, int rows,
                                          int c0, int n) {
  for (int i = threadIdx.x; i < rows * COLS; i += THREADS) {
    const int r = i / COLS, c = i % COLS;
    const bool ok = c0 + c < n;
    cp_async4(dst + i, ok ? src + static_cast<size_t>(r) * n + c0 + c : src, ok);
  }
}

// Phase 1's product for one warp: the whole sums of own row 8w + kg against
// tile rows tg + 4t (t = 0..7), over all C channels. own: the warp's 8 rows.
__device__ __forceinline__ void warp_rows_dot(const float* own, const float* tile, int kg, int tg,
                                              float (&out)[8]) {
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int t = 0; t < 8; ++t) acc[r][t] = 0.f;
#pragma unroll
  for (int i = 0; i < C / 32; ++i) {
    const int c = 4 * (kg + 8 * i);
    float4 a[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) a[r] = ld4(own + (r ^ kg) * C + c);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float4 x = ld4(tile + (tg + 4 * t) * C + c);
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[r][t] = dot4(a[r], x, acc[r][t]);
    }
  }
  // acc[r] holds row r ^ kg; the partner across each level holds the same
  // rows in the other half
#pragma unroll
  for (int t = 0; t < 8; ++t) {
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[r][t] += __shfl_xor_sync(0xffffffffu, acc[r + 4][t], 4);
#pragma unroll
    for (int r = 0; r < 2; ++r) acc[r][t] += __shfl_xor_sync(0xffffffffu, acc[r + 2][t], 2);
    out[t] = acc[0][t] + __shfl_xor_sync(0xffffffffu, acc[1][t], 1);
  }
}

}  // namespace f32_tiles
