// One f32 spatial-compatibility entry from two packed geometry strips, shared
// by the trainable attention (sc_attention_train.cu) and the no-cache eval
// attention (the geometry source of offset_attention.cuh), so both evaluate
// the same operations as the plain version (kernels/sc_attention.py::
// compat_from_geometry):
//
//   compat_ij = max(1 - (d_src_ij - d_tgt_ij)^2 / sigma_d^2, 0),
//   d_ij = sqrt(max(|a_i|^2 + |a_j|^2 - 2 a_i.a_j, 0))   (the packed norms).
//
// Every operation is rounded once, in the plain version's order (no FMA
// contraction): the difference of two distances is divided by sigma_d^2 =
// 0.01, so another cancellation would be another function. Kernel and plain
// version then see the same compat bit for bit.
//
// A strip holds rows 0-2 src xyz, 3 |src|^2, 4-6 tgt xyz, 7 |tgt|^2 of a
// run of points, row r of point i at [r * stride + i].

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace geo {

__device__ __forceinline__ float pair_dist(float ax, float ay, float az, float a2, float bx,
                                           float by, float bz, float b2) {
  const float inner =
      __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
  const float d2 = __fsub_rn(__fadd_rn(a2, b2), __fmul_rn(2.0f, inner));
  return sqrtf(fmaxf(d2, 0.0f));
}

// go: strip of the owned (query) rows, row stride SO; gt: strip of the
// walked (key) rows, row stride ST
template <int SO, int ST>
__device__ __forceinline__ float compat_entry(const float* go, int i, const float* gt, int j,
                                              float sig2) {
  const float ds = pair_dist(go[0 * SO + i], go[1 * SO + i], go[2 * SO + i], go[3 * SO + i],
                             gt[0 * ST + j], gt[1 * ST + j], gt[2 * ST + j], gt[3 * ST + j]);
  const float dt = pair_dist(go[4 * SO + i], go[5 * SO + i], go[6 * SO + i], go[7 * SO + i],
                             gt[4 * ST + j], gt[5 * ST + j], gt[6 * ST + j], gt[7 * ST + j]);
  const float diff = __fsub_rn(ds, dt);
  return fmaxf(__fsub_rn(1.0f, __fdiv_rn(__fmul_rn(diff, diff), sig2)), 0.0f);
}

}  // namespace geo
