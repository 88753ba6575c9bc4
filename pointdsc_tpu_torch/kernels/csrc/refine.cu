// Post-refinement of the winning hypothesis, the whole iteration loop in one
// launch, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel pointdsc_tpu/kernels/refine.py:55
// (_refine_gram_kernel, pallas_call at :100), driven by
// fused_post_refinement (:151). Each round of up to max_iters:
//
//   d2_i  = |R s_i + t - t_i|^2,  inl_i = [d2_i < thr^2] * mask_i,
//   w_i   = inl_i / (1 + d2_i / thr^2)
//   G     = sums of w s t^T (3x3), w s, w t, w and inl   (the TPU's 8x8 Gram)
//   trans = Horn fit of G (closed-form 4x4 eigen solve), unless the inlier
//           count equals the previous round's, which freezes the sample.
//
// strip [B, 8, N] (rows 0-2 src xyz, 3 mask, 4-6 tgt xyz, both clouds centred
// on their masked means by the wrapper), trans0 [B, 16] (row-major 4x4 in the
// centred frame), out [B, 16], iters [B] int32 (rounds run, for the bound).
//
// Bound on the H100: per round the kernel reads the 8 x N strip (164 KB at
// N = 5120, L2-resident after the first round) and does ~40 flops per point:
// 0.2 MFLOP, a few ns at 67 TFLOP/s. It is bound by latency, not by bytes or
// operations: each round is a block-wide reduction followed by a serial 4x4
// solve that the next round depends on. On the TPU the loop is a while_loop
// around one Pallas reduction per round; on the card one launch per round
// would leave the device idle between launches, so one block per sample runs
// all rounds itself: 512 threads reduce the point sums (warp shuffles, then
// shared memory), thread 0 solves Procrustes in f32 with the JAX package's
// closed form (ops/linalg.py: 14 Newton steps on the characteristic quartic,
// adjugate column, fallback to e0) and publishes the new transform through
// shared memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int NSUM = 17;  // 9 w s t^T, 3 w s, 3 w t, w, inl

__device__ float det3(const float m[4][4], int r0, int r1, int r2, int c0, int c1, int c2) {
  const float a = m[r0][c0], b = m[r0][c1], c = m[r0][c2];
  const float d = m[r1][c0], e = m[r1][c1], f = m[r1][c2];
  const float g = m[r2][c0], h = m[r2][c1], i = m[r2][c2];
  return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g);
}

// 3x3 minor of m without row `skip_r` and column `skip_c`
__device__ float minor3(const float m[4][4], int skip_r, int skip_c) {
  int r[3], c[3], nr = 0, nc = 0;
  for (int x = 0; x < 4; ++x) {
    if (x != skip_r) r[nr++] = x;
    if (x != skip_c) c[nc++] = x;
  }
  return det3(m, r[0], r[1], r[2], c[0], c[1], c[2]);
}

// unit dominant eigenvector of a symmetric 4x4 (pointdsc_tpu/ops/linalg.py:135)
__device__ void dominant_eigvec4x4(const float A_in[4][4], float v[4]) {
  float A[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) A[i][j] = 0.5f * (A_in[i][j] + A_in[j][i]);
  const float mu = (((A[0][0] + A[1][1]) + A[2][2]) + A[3][3]) / 4.0f;
  float B[4][4];
  float fro2 = 0.0f;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      B[i][j] = A[i][j] - (i == j ? mu : 0.0f);
      fro2 += B[i][j] * B[i][j];
    }
  const float scale = fmaxf(sqrtf(fro2), 1e-30f);
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) B[i][j] /= scale;
  float tr2 = 0.0f, e3 = 0.0f;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      float b2 = 0.0f;
      for (int l = 0; l < 4; ++l) b2 += B[i][l] * B[l][j];
      if (i == j) tr2 += b2;
      e3 += b2 * B[i][j];
    }
  e3 /= 3.0f;
  float e4 = 0.0f, sign = 1.0f;
  for (int j = 0; j < 4; ++j) {
    e4 += sign * B[0][j] * minor3(B, 0, j);
    sign = -sign;
  }
  const float c2 = -0.5f * tr2;
  float lam = 1.0f;
  for (int it = 0; it < 14; ++it) {
    const float lam2 = lam * lam;
    const float p = lam2 * lam2 + c2 * lam2 - e3 * lam + e4;
    const float dp = 4.0f * lam2 * lam + 2.0f * c2 * lam - e3;
    lam = lam - p / fmaxf(dp, 1e-12f);
  }
  for (int i = 0; i < 4; ++i) B[i][i] -= lam;
  // adj_ij = (-1)^(i+j) minor_ji, upper triangle mirrored (symmetric input)
  float adj[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = i; j < 4; ++j) {
      const float e = (((i + j) & 1) ? -1.0f : 1.0f) * minor3(B, j, i);
      adj[i][j] = e;
      adj[j][i] = e;
    }
  int col = 0;
  float best = fabsf(adj[0][0]);
  for (int j = 1; j < 4; ++j)
    if (fabsf(adj[j][j]) > best) {
      best = fabsf(adj[j][j]);
      col = j;
    }
  float nv2 = 0.0f;
  for (int i = 0; i < 4; ++i) nv2 += adj[i][col] * adj[i][col];
  const float nv = sqrtf(nv2);
  const float tiny = 1e-20f;
  for (int i = 0; i < 4; ++i)
    v[i] = nv > tiny ? adj[i][col] / fmaxf(nv, tiny) : (i == 0 ? 1.0f : 0.0f);
}

// Horn fit from the sums (pointdsc_tpu/kernels/refine.py:140): T row-major
__device__ void procrustes_from_sums(const float* g, float T[16]) {
  const float wsum = g[15] + 1e-6f;
  float cs[3], ct[3], H[3][3];
  for (int i = 0; i < 3; ++i) {
    cs[i] = g[9 + i] / wsum;
    ct[i] = g[12 + i] / wsum;
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) H[i][j] = g[3 * i + j] - wsum * (cs[i] * ct[j]);
  const float Sxx = H[0][0], Sxy = H[0][1], Sxz = H[0][2];
  const float Syx = H[1][0], Syy = H[1][1], Syz = H[1][2];
  const float Szx = H[2][0], Szy = H[2][1], Szz = H[2][2];
  const float N[4][4] = {
      {Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx},
      {Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz},
      {Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy},
      {Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz}};
  float q[4];
  dominant_eigvec4x4(N, q);
  const float qn = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]) + 1e-12f;
  const float w = q[0] / qn, x = q[1] / qn, y = q[2] / qn, z = q[3] / qn;
  const float ww = w * w, xx = x * x, yy = y * y, zz = z * z;
  const float wx = w * x, wy = w * y, wz = w * z, xy = x * y, xz = x * z, yz = y * z;
  const float R[3][3] = {{ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy)},
                         {2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx)},
                         {2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz}};
  for (int i = 0; i < 3; ++i) {
    T[4 * i + 0] = R[i][0];
    T[4 * i + 1] = R[i][1];
    T[4 * i + 2] = R[i][2];
    T[4 * i + 3] = ct[i] - ((R[i][0] * cs[0] + R[i][1] * cs[1]) + R[i][2] * cs[2]);
  }
  T[12] = 0.0f;
  T[13] = 0.0f;
  T[14] = 0.0f;
  T[15] = 1.0f;
}

__global__ void __launch_bounds__(THREADS)
refine_kernel(const float* __restrict__ strip, const float* __restrict__ trans0,
              float* __restrict__ out, int* __restrict__ iters, int n, float thr,
              int max_iters) {
  __shared__ float T[16];
  __shared__ float partial[WARPS][NSUM];
  __shared__ int go;
  const int b = blockIdx.x;
  const float* s = strip + static_cast<size_t>(b) * 8 * n;
  const float thr2 = thr * thr;
  if (threadIdx.x < 16) T[threadIdx.x] = trans0[b * 16 + threadIdx.x];
  int prev_num = 0, it = 0;
  __syncthreads();
  for (; it < max_iters; ++it) {
    float acc[NSUM];
#pragma unroll
    for (int j = 0; j < NSUM; ++j) acc[j] = 0.0f;
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const float sx = s[i], sy = s[n + i], sz = s[2 * n + i], m = s[3 * n + i];
      const float tx = s[4 * n + i], ty = s[5 * n + i], tz = s[6 * n + i];
      const float dx = T[0] * sx + T[1] * sy + T[2] * sz + T[3] - tx;
      const float dy = T[4] * sx + T[5] * sy + T[6] * sz + T[7] - ty;
      const float dz = T[8] * sx + T[9] * sy + T[10] * sz + T[11] - tz;
      const float d2 = dx * dx + dy * dy + dz * dz;
      const float inl = (d2 < thr2 ? 1.0f : 0.0f) * m;
      const float w = inl / (1.0f + d2 / thr2);
      const float ws[3] = {w * sx, w * sy, w * sz};
      const float t[3] = {tx, ty, tz};
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[3 * r + c] += ws[r] * t[c];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        acc[9 + r] += ws[r];
        acc[12 + r] += w * t[r];
      }
      acc[15] += w;
      acc[16] += inl;
    }
#pragma unroll
    for (int j = 0; j < NSUM; ++j) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
    }
    if ((threadIdx.x & 31) == 0)
      for (int j = 0; j < NSUM; ++j) partial[threadIdx.x >> 5][j] = acc[j];
    __syncthreads();
    if (threadIdx.x == 0) {
      float g[NSUM];
      for (int j = 0; j < NSUM; ++j) {
        g[j] = 0.0f;
        for (int w = 0; w < WARPS; ++w) g[j] += partial[w][j];
      }
      const int num = static_cast<int>(g[16]);
      go = abs(num - prev_num) >= 1;
      prev_num = num;
      if (go) {
        float Tn[16];
        procrustes_from_sums(g, Tn);
        for (int j = 0; j < 16; ++j) T[j] = Tn[j];
      }
    }
    __syncthreads();
    if (!go) {
      ++it;  // the round that saw no change ran too
      break;
    }
  }
  if (threadIdx.x < 16) out[b * 16 + threadIdx.x] = T[threadIdx.x];
  if (threadIdx.x == 0) iters[b] = it;
}

}  // namespace

extern "C" int fused_post_refinement(const void* strip, const void* trans0, void* out,
                                     void* iters, int batch, int n, float thr, int max_iters,
                                     void* stream) {
  refine_kernel<<<batch, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(strip), static_cast<const float*>(trans0),
      static_cast<float*>(out), static_cast<int*>(iters), n, thr, max_iters);
  return static_cast<int>(cudaGetLastError());
}
