// Horn's closed-form rotation of a weighted Procrustes fit, on one warp:
// shared by the post-refinement (refine.cu, from its raw Gram sums) and the
// seed hypotheses (scoring.cu, from centred points).
//
// The arithmetic is the JAX package's (pointdsc_tpu/ops/procrustes.py,
// pointdsc_tpu/ops/linalg.py::dominant_eigvec4x4) in f32: Horn's symmetric
// 4x4 N of H = sum w a b^T, shifted by its trace / 4 and scaled by its
// Frobenius norm, 14 Newton steps on its characteristic quartic from 1, the
// adjugate column of the largest diagonal entry (e0 when it vanishes), then
// q / (|q| + 1e-12) and the rotation of the unit quaternion. The entries of
// B^2, the 4 + 10 minors of the determinant and the adjugate are spread over
// the lanes (the matrix in shared memory, so that a lane picks its entries
// by index); the Newton steps run on every lane alike, so every lane ends
// with the same R.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ inline float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// 3x3 minor of the row-major 4x4 m (shared memory) without row skip_r and
// column skip_c
__device__ float minor3(const float* m, int skip_r, int skip_c) {
  const int r0 = skip_r == 0 ? 1 : 0, r1 = skip_r <= 1 ? 2 : 1, r2 = skip_r <= 2 ? 3 : 2;
  const int c0 = skip_c == 0 ? 1 : 0, c1 = skip_c <= 1 ? 2 : 1, c2 = skip_c <= 2 ? 3 : 2;
  const float a = m[4 * r0 + c0], b = m[4 * r0 + c1], c = m[4 * r0 + c2];
  const float d = m[4 * r1 + c0], e = m[4 * r1 + c1], f = m[4 * r1 + c2];
  const float g = m[4 * r2 + c0], h = m[4 * r2 + c1], i = m[4 * r2 + c2];
  return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g);
}

// R maximising tr(R H) (R a ~= b for H = sum w a b^T), on one warp: every
// lane returns the same R. Bs and adj are 16 floats of the warp's shared
// memory each, free again when it returns.
__device__ void horn_rotation(const float (&H)[3][3], float* Bs, float* adj, float (&R)[3][3]) {
  const int lane = threadIdx.x & 31;
  const float Sxx = H[0][0], Sxy = H[0][1], Sxz = H[0][2];
  const float Syx = H[1][0], Syy = H[1][1], Syz = H[1][2];
  const float Szx = H[2][0], Szy = H[2][1], Szz = H[2][2];
  const float N[4][4] = {
      {Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx},
      {Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz},
      {Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy},
      {Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz}};

  // unit dominant eigenvector of the symmetric N (pointdsc_tpu/ops/linalg.py:135)
  float A[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) A[i][j] = 0.5f * (N[i][j] + N[j][i]);
  const float mu = (((A[0][0] + A[1][1]) + A[2][2]) + A[3][3]) / 4.0f;
  float fro2 = 0.0f, mine = 0.0f;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      const float bij = A[i][j] - (i == j ? mu : 0.0f);
      fro2 += bij * bij;
      if (4 * i + j == lane) mine = bij;
    }
  const float scale = fmaxf(sqrtf(fro2), 1e-30f);
  if (lane < 16) Bs[lane] = mine / scale;
  __syncwarp();
  // lane (i, j) < 16: the entry of B^2, for tr(B^2) and sum (B^2 o B) = tr(B^3)
  const int ri = (lane >> 2) & 3, rj = lane & 3;
  float b2 = 0.0f;
  for (int l = 0; l < 4; ++l) b2 += Bs[4 * ri + l] * Bs[4 * l + rj];
  const float tr2 = warp_sum(lane < 16 && ri == rj ? b2 : 0.0f);
  const float e3 = warp_sum(lane < 16 ? b2 * Bs[lane & 15] : 0.0f) / 3.0f;
  // det B along row 0, a minor a lane
  const float e4 = warp_sum(lane < 4 ? ((lane & 1) ? -1.0f : 1.0f) * Bs[lane] * minor3(Bs, 0, lane)
                                     : 0.0f);
  const float c2 = -0.5f * tr2;
  float lam = 1.0f;
  for (int it = 0; it < 14; ++it) {
    const float lam2 = lam * lam;
    const float p = lam2 * lam2 + c2 * lam2 - e3 * lam + e4;
    const float dp = 4.0f * lam2 * lam + 2.0f * c2 * lam - e3;
    lam = lam - p / fmaxf(dp, 1e-12f);
  }
  __syncwarp();  // every lane has read B
  if (lane < 16 && ri == rj) Bs[lane] -= lam;
  __syncwarp();
  // adj_ij = (-1)^(i+j) minor_ji: the upper triangle, a minor a lane, mirrored
  if (lane < 10) {
    const int i = lane < 4 ? 0 : (lane < 7 ? 1 : (lane < 9 ? 2 : 3));
    const int j = i + lane - (i == 0 ? 0 : (i == 1 ? 4 : (i == 2 ? 7 : 9)));
    const float e = (((i + j) & 1) ? -1.0f : 1.0f) * minor3(Bs, j, i);
    adj[4 * i + j] = e;
    adj[4 * j + i] = e;
  }
  __syncwarp();
  int col = 0;
  float best = fabsf(adj[0]);
  for (int j = 1; j < 4; ++j)
    if (fabsf(adj[5 * j]) > best) {
      best = fabsf(adj[5 * j]);
      col = j;
    }
  float nv2 = 0.0f;
  for (int i = 0; i < 4; ++i) nv2 += adj[4 * i + col] * adj[4 * i + col];
  const float nv = sqrtf(nv2);
  const float tiny = 1e-20f;
  float q[4];
  for (int i = 0; i < 4; ++i)
    q[i] = nv > tiny ? adj[4 * i + col] / fmaxf(nv, tiny) : (i == 0 ? 1.0f : 0.0f);
  __syncwarp();  // Bs and adj are free again

  const float qn = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]) + 1e-12f;
  const float w = q[0] / qn, x = q[1] / qn, y = q[2] / qn, z = q[3] / qn;
  const float ww = w * w, xx = x * x, yy = y * y, zz = z * z;
  const float wx = w * x, wy = w * y, wz = w * z, xy = x * y, xz = x * z, yz = y * z;
  R[0][0] = ww + xx - yy - zz;
  R[0][1] = 2 * (xy - wz);
  R[0][2] = 2 * (xz + wy);
  R[1][0] = 2 * (xy + wz);
  R[1][1] = ww - xx + yy - zz;
  R[1][2] = 2 * (yz - wx);
  R[2][0] = 2 * (xz - wy);
  R[2][1] = 2 * (yz + wx);
  R[2][2] = ww - xx - yy + zz;
}

}  // namespace
