// Post-refinement of the winning hypothesis, the whole function in one
// launch, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel pointdsc_tpu/kernels/refine.py:55
// (_refine_gram_kernel, pallas_call at :100) and the function around it,
// fused_post_refinement (:151). Per sample (one cluster of 8 blocks):
//
//   a_s, a_t = masked means of src and tgt (count clamped at 1); both clouds
//              centred on them, and trans0 moved into that frame:
//              t' = (t + R a_s) - a_t
//   up to max_iters rounds of
//     d2_i  = |R s_i + t - t_i|^2,  inl_i = [d2_i < thr^2] * mask_i,
//     w_i   = inl_i / (1 + d2_i / thr^2)
//     G     = sums of w s t^T (3x3), w s, w t, w and inl   (the TPU's 8x8 Gram)
//     trans = Horn fit of G (closed-form 4x4 eigen solve), unless the inlier
//             count equals the previous round's, which freezes the sample
//   the result moved back: t = (t' - R a_s) + a_t
//
// trans0 [B, 16] (row-major 4x4), src, tgt [B, N, 3] f32, mask [B, N] bytes
// (a bool tensor), out [B, 16], iters [B] int32 (rounds run, the one that saw
// no change included).
//
// Bound on the H100: the function reads 25 bytes a point once (0.5 MB at
// N = 20480: 0.15 us at 3.35 TB/s) and does ~63 flops a point a round. It is
// bound by latency, not by bytes or operations: each round is a reduction
// over the points followed by a serial 4x4 solve that the next round depends
// on. On the TPU the loop is a while_loop around one Pallas reduction per
// round and the centring is XLA around it; here one thread-block cluster per
// sample runs all of it, so the wrapper makes no launch besides this one.
// What the design does about the latency of a round:
// - a sample's points are spread over a cluster of 8 blocks (8 SMs; one
//   block's point loop, ~80 instructions a point with its two IEEE
//   divisions, is bound by instruction throughput: 40 us at N = 20480 on one), each
//   thread taking points i, i + 4096, ... eight at once so that their loads
//   are in flight together, centred in registers as they are loaded (no
//   packed strip);
// - a block sums the 17 terms with warp shuffles, and one warp reduces its
//   16 warps' partials, a term a lane; the 8 blocks' sums meet through
//   distributed shared memory after one cluster barrier, summed in rank
//   order, and every block solves the same sums itself, so that the round
//   needs no second barrier to hand out the transform (the sums sit in two
//   buffers by the round's parity: a block can be at most one round ahead);
// - the Horn solve runs on that warp (csrc/horn.cuh, which the seed
//   hypotheses of scoring.cu share): the scaling of the 4x4 matrix, the
//   entries of its square and the 4 + 10 minors of its determinant and
//   adjugate are spread over the lanes (the matrix in shared memory, so that
//   a lane picks its entries by index); the 14 Newton steps on the quartic
//   stay serial, on every lane alike. The arithmetic is the JAX package's
//   closed form (ops/linalg.py: 14 Newton steps, adjugate column, fallback to
//   e0) in f32, and the same in every block of the cluster, bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "horn.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int NSUM = 17;  // 9 w s t^T, 3 w s, 3 w t, w, inl
constexpr int CLUSTER = 8;  // blocks a sample
constexpr int STRIDE = CLUSTER * THREADS;  // between a thread's points
constexpr int BATCH = 8;  // points a thread loads at once (i, i + STRIDE, ...)

// Points i0 + u STRIDE, u < BATCH, of one sample: src xyz, tgt xyz and the
// mask as 0 / 1, loaded together so that their loads are in flight at once.
// A point past n reads as masked.
__device__ inline void load_points(const float* s, const float* t, const uint8_t* m, int n,
                                   int i0, float (&p)[BATCH][7]) {
#pragma unroll
  for (int u = 0; u < BATCH; ++u) {
    const int i = i0 + u * STRIDE;
    const bool in = i < n;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      p[u][c] = in ? s[3 * i + c] : 0.0f;
      p[u][3 + c] = in ? t[3 * i + c] : 0.0f;
    }
    p[u][6] = in && m[i] ? 1.0f : 0.0f;
  }
}

// The cluster's sums of K terms, one value of each per thread in acc: warp 0
// of every block returns with them in g, the blocks' sums added in rank
// order. ``mine`` holds this block's sums for the other blocks to read; it
// must not be written again before the next cluster barrier has passed.
template <int K>
__device__ void cluster_sums(float (&acc)[K], float (*partial)[NSUM], float* mine, float* g,
                             const cg::cluster_group& cluster) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < K; ++j) acc[j] = warp_sum(acc[j]);
  if (lane == 0)
    for (int j = 0; j < K; ++j) partial[warp][j] = acc[j];
  __syncthreads();
  if (warp == 0 && lane < K) {  // a term a lane, the 16 warps in order
    float sum = 0.0f;
    for (int w = 0; w < WARPS; ++w) sum += partial[w][lane];
    mine[lane] = sum;
  }
  cluster.sync();  // every block's sums are in its shared memory
  if (warp == 0) {
    if (lane < K) {
      float sum = 0.0f;
      for (int r = 0; r < CLUSTER; ++r) sum += cluster.map_shared_rank(mine, r)[lane];
      g[lane] = sum;
    }
    __syncwarp();
  }
}

// Horn fit from the sums g (pointdsc_tpu/kernels/refine.py:140), on one
// warp: every lane returns the same row-major T. Bs and adj are 16 floats of
// the warp's shared memory each.
__device__ void procrustes_warp(const float* g, float* Bs, float* adj, float T[16]) {
  const float wsum = g[15] + 1e-6f;
  float cs[3], ct[3], H[3][3];
  for (int i = 0; i < 3; ++i) {
    cs[i] = g[9 + i] / wsum;
    ct[i] = g[12 + i] / wsum;
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) H[i][j] = g[3 * i + j] - wsum * (cs[i] * ct[j]);
  float R[3][3];
  horn_rotation(H, Bs, adj, R);
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

// t' = (t + sign R a) - sign b, without contraction into FMAs (the plain
// version's order: R a summed left to right, then the two additions)
__device__ float shifted(const float* T, int i, const float* a, const float* b, float sign) {
  const float ra = __fadd_rn(__fadd_rn(__fmul_rn(T[4 * i], a[0]), __fmul_rn(T[4 * i + 1], a[1])),
                             __fmul_rn(T[4 * i + 2], a[2]));
  return __fsub_rn(__fadd_rn(T[4 * i + 3], __fmul_rn(sign, ra)), __fmul_rn(sign, b[i]));
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
refine_kernel(const float* __restrict__ trans0, const float* __restrict__ src,
              const float* __restrict__ tgt, const uint8_t* __restrict__ mask,
              float* __restrict__ out, int* __restrict__ iters, int n, float thr,
              int max_iters) {
  __shared__ float T[16];
  __shared__ float partial[WARPS][NSUM];
  __shared__ float mine[2][NSUM];  // this block's sums, by the round's parity
  __shared__ float g[NSUM];
  __shared__ float Bs[16], adj[16];
  __shared__ float anchor[6];  // a_s, a_t
  __shared__ int go;
  const cg::cluster_group cluster = cg::this_cluster();
  const int b = blockIdx.x / CLUSTER, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = static_cast<int>(cluster.block_rank()) * THREADS + threadIdx.x;
  const float* s = src + static_cast<size_t>(b) * n * 3;
  const float* t = tgt + static_cast<size_t>(b) * n * 3;
  const uint8_t* m = mask + static_cast<size_t>(b) * n;
  const float thr2 = thr * thr;

  // masked means
  {
    float acc[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int i0 = first; i0 < n; i0 += BATCH * STRIDE) {
      float p[BATCH][7];
      load_points(s, t, m, n, i0, p);
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        if (i0 + u * STRIDE >= n) break;
#pragma unroll
        for (int c = 0; c < 6; ++c) acc[c] += p[u][c] * p[u][6];
        acc[6] += p[u][6];
      }
    }
    cluster_sums(acc, partial, mine[0], g, cluster);
    if (warp == 0) {
      const float count = fmaxf(g[6], 1.0f);
      if (lane < 6) anchor[lane] = g[lane] / count;
      __syncwarp();
      if (lane == 0) {
        float T0[16];
        for (int j = 0; j < 16; ++j) T0[j] = trans0[b * 16 + j];
        for (int i = 0; i < 3; ++i) {
          for (int j = 0; j < 3; ++j) T[4 * i + j] = T0[4 * i + j];
          T[4 * i + 3] = shifted(T0, i, anchor, anchor + 3, 1.0f);
        }
        T[12] = 0.0f;
        T[13] = 0.0f;
        T[14] = 0.0f;
        T[15] = 1.0f;
      }
    }
    __syncthreads();
  }
  const float as0 = anchor[0], as1 = anchor[1], as2 = anchor[2];
  const float at0 = anchor[3], at1 = anchor[4], at2 = anchor[5];

  int prev_num = 0, it = 0;
  for (; it < max_iters; ++it) {
    float acc[NSUM];
#pragma unroll
    for (int j = 0; j < NSUM; ++j) acc[j] = 0.0f;
    for (int i0 = first; i0 < n; i0 += BATCH * STRIDE) {
      float p[BATCH][7];
      load_points(s, t, m, n, i0, p);
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        if (i0 + u * STRIDE >= n) break;
        const float sx = p[u][0] - as0, sy = p[u][1] - as1, sz = p[u][2] - as2;
        const float tx = p[u][3] - at0, ty = p[u][4] - at1, tz = p[u][5] - at2;
        const float mi = p[u][6];
        const float dx = T[0] * sx + T[1] * sy + T[2] * sz + T[3] - tx;
        const float dy = T[4] * sx + T[5] * sy + T[6] * sz + T[7] - ty;
        const float dz = T[8] * sx + T[9] * sy + T[10] * sz + T[11] - tz;
        const float d2 = dx * dx + dy * dy + dz * dz;
        const float inl = (d2 < thr2 ? 1.0f : 0.0f) * mi;
        const float w = inl / (1.0f + d2 / thr2);
        const float ws[3] = {w * sx, w * sy, w * sz};
        const float tt[3] = {tx, ty, tz};
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
          for (int c = 0; c < 3; ++c) acc[3 * r + c] += ws[r] * tt[c];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          acc[9 + r] += ws[r];
          acc[12 + r] += w * tt[r];
        }
        acc[15] += w;
        acc[16] += inl;
      }
    }
    cluster_sums(acc, partial, mine[(it + 1) & 1], g, cluster);
    if (warp == 0) {
      const int num = static_cast<int>(g[16]);
      const bool changed = abs(num - prev_num) >= 1;
      prev_num = num;
      if (changed) {
        float Tn[16];
        procrustes_warp(g, Bs, adj, Tn);
        if (lane < 16) {
          float v = 0.0f;
#pragma unroll
          for (int j = 0; j < 16; ++j)
            if (j == lane) v = Tn[j];
          T[lane] = v;
        }
      }
      if (lane == 0) go = changed;
    }
    __syncthreads();
    if (!go) {
      ++it;  // the round that saw no change ran too
      break;
    }
  }
  cluster.sync();  // no block leaves while another may read its sums
  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    const float a[6] = {as0, as1, as2, at0, at1, at2};
    float* o = out + b * 16;
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) o[4 * i + j] = T[4 * i + j];
      o[4 * i + 3] = shifted(T, i, a, a + 3, -1.0f);
    }
    o[12] = 0.0f;
    o[13] = 0.0f;
    o[14] = 0.0f;
    o[15] = 1.0f;
    iters[b] = it;
  }
}

}  // namespace

extern "C" int fused_post_refinement(const void* trans0, const void* src, const void* tgt,
                                     const void* mask, void* out, void* iters, int batch, int n,
                                     float thr, int max_iters, void* stream) {
  refine_kernel<<<batch * CLUSTER, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(trans0), static_cast<const float*>(src),
      static_cast<const float*>(tgt), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), static_cast<int*>(iters), n, thr, max_iters);
  return static_cast<int>(cudaGetLastError());
}
