// The seed stage of the eval forward after the seed k-NN: every seed's
// hypothesis, its inlier count and the selection of the best, in three
// launches, CUDA C++ for sm_90a.
//
// 1. hypotheses_kernel: no TPU kernel; it replaces the XLA glue of
//    pointdsc_tpu/models/pointdsc.py:363-413 (_seed_transforms: the gather,
//    the k x k compatibility, the power iteration, the weighted Procrustes).
//    One block a seed:
//      gather the k neighbours' features, src, tgt and mask in place from
//        [B, N, C], [B, N, 3], [B, N] (no concatenated bundle);
//      M_ij = clamp(1 - (1 - f_i.f_j) / sigma^2, 0)
//             * clamp(1 - (|s_i - s_j| - |t_i - t_j|)^2 / sigma_d^2, 0),
//        the distances in the exact-difference form (the gram expansion
//        loses ~1e-4 to cancellation, amplified by 1 / sigma_d^2), zero on
//        the diagonal and where either neighbour is invalid;
//      num_iterations power steps v <- M v / (sqrt(|M v|^2 + 1e-30) + 1e-6)
//        from v = 1 (pointdsc_tpu/ops/eig.py);
//      w = |v| mask / (sum + 1e-6);
//      the weighted Procrustes of pointdsc_tpu/ops/procrustes.py: centroids
//        over sum w + 1e-6, H from the centred points, Horn's rotation
//        (horn.cuh, the solve the refinement uses), t = c_t - R c_s.
//    sigma is read from the device (the model's parameter): no host read.
// 2. scoring_kernel: replaces the TPU kernel pointdsc_tpu/kernels/scoring.py:56
//    (_scoring_kernel, pallas_call at :120), entry seed_inlier_counts:
//      count[b, s] = sum_n [ |R_s x_n + t_s - y_n|^2 < thr^2 ] * mask_n
//    with the transforms in the layout launch 1 writes ([B, S, 4, 4]
//    row-major) and src, tgt and mask read in place; counts [B, S] f32
//    holding integers, as in JAX. One block a seed.
// 3. select_kernel: the rest of the JAX function around #2 (:415-424): the
//    fitness count / max(sum mask, 1), -1 for an invalid seed; the argmax,
//    the first maximum as torch.argmax and jnp.argmax take it; the winner's
//    transform; the labels |T x_n - y_n| < thr and mask_n. One block a sample.
//
// Bound on the H100, at N = 5120 (S = 512, k = 40, C = 128): the gather moves
// S k (C + 7) 4 B = 11 MB (3.3 us at 3.35 TB/s) and the feature gram is
// S k^2 C 2 = 0.21 GFLOP (3.1 us at 67 TFLOP/s f32); the counts are S N ~29
// operations (1.1 us) on 0.14 MB. About 3.3 us in all, 8 us at N = 12288
// (S = 1228). On the TPU and in the plain version this stage is ~700 small
// operations; here it is three launches and no host sync, which is what the
// design is for: the forward at N = 5120 waited on its host. Inside launch 1
// a block's neighbours sit in shared memory (k x C features, 27 KB at
// k = 40, C = 128; eight blocks an SM), M is built once, upper triangle
// mirrored, and every power step is k dot products of k terms and one block
// reduction; the gram is one f32 dot product a thread an entry from
// 16-byte shared loads, not register-tiled: making it fast is later work.
//
// Any k and C: thread t owns neighbour rows t, t + 128, ... (their power-step
// products, their terms of the moments). The per-row arrays (points, valid
// flags, indices, v and the power step's new v) and, while they fit the
// 200 KB the block opts into, the features (k x (C + 4) floats) and M
// (k x (k + 1)) share the dynamic arena. Past that M, then also the features,
// live in a workspace in device memory that the wrapper allocates, a slice a
// seed (M first leaves at about k = 180 with C = 128). The template arguments
// say which is where, so the shipped k = 40 keeps both in shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "horn.cuh"

namespace {

constexpr int HYP_THREADS = 128;  // one block a seed; thread t owns rows t + 128 i
constexpr int HYP_WARPS = HYP_THREADS / 32;
constexpr int MAX_HYP_SMEM = 200 * 1024;  // the dynamic arena's opt-in
constexpr int ROW_FLOATS = 10;  // per neighbour row: 6 coordinates, valid, index, v, new v
constexpr int THREADS = 256;
constexpr int SEL_THREADS = 1024;

// The sums over the block of K values a thread; every thread returns them.
// red [HYP_WARPS][K] in shared memory.
template <int K>
__device__ __forceinline__ void block_sums(float (&v)[K], float (*red)[16]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < K; ++j) v[j] = warp_sum(v[j]);
  if (lane == 0)
#pragma unroll
    for (int j = 0; j < K; ++j) red[warp][j] = v[j];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < HYP_WARPS; ++w) s += red[w][j];
    v[j] = s;
  }
  __syncthreads();  // red may be written again
}

// the squared distance of two points, each product and sum rounded on its
// own in the plain version's order
__device__ __forceinline__ float dist(const float* a, const float* b) {
  const float dx = a[0] - b[0], dy = a[1] - b[1], dz = a[2] - b[2];
  return sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)));
}

// floats of the arena before the features: the per-row arrays, 16-byte aligned
__host__ __device__ inline int row_arrays(int k) { return (ROW_FLOATS * k + 3) & ~3; }

// kFGlobal / kMGlobal: the features / M in the workspace slices ws_f
// [B, S, k, fs] / ws_m [B, S, k, k + 1] instead of the arena
template <bool kFGlobal, bool kMGlobal>
__global__ void __launch_bounds__(HYP_THREADS)
hypotheses_kernel(const float* __restrict__ feats, const int64_t* __restrict__ knn,
                  const float* __restrict__ src, const float* __restrict__ tgt,
                  const uint8_t* __restrict__ mask, const float* __restrict__ sigma,
                  float inv_sigma_d2, int n, int c, int s, int k, int iters,
                  float* __restrict__ trans, float* __restrict__ ws_f,
                  float* __restrict__ ws_m) {
  extern __shared__ float4 dyn4[];
  float* P = reinterpret_cast<float*>(dyn4);  // [k][6] src xyz, tgt xyz
  float* valid = P + 6 * k;
  int* idx = reinterpret_cast<int*>(valid + k);
  float* v = reinterpret_cast<float*>(idx + k);
  float* v_new = v + k;
  const int c4 = (c + 3) & ~3, fs = c4 + 4;  // 16-byte rows, staggered banks
  const int ms = k + 1;
  const size_t slot = static_cast<size_t>(blockIdx.y) * s + blockIdx.x;
  float* arena = P + row_arrays(k);
  float* F = kFGlobal ? ws_f + slot * k * fs : arena;  // [k][fs] features, zero-padded rows
  float* M = kMGlobal ? ws_m + slot * k * ms : arena + (kFGlobal ? 0 : k * fs);  // [k][k + 1]
  __shared__ float red[HYP_WARPS][16];
  __shared__ float Bs[16], adj[16];
  const int seed = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  const int64_t* nb = knn + (static_cast<size_t>(b) * s + seed) * k;
  for (int i = tid; i < k; i += HYP_THREADS) {
    const int p = static_cast<int>(nb[i]);
    const size_t o = static_cast<size_t>(b) * n + p;
    idx[i] = p;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      P[6 * i + d] = src[3 * o + d];
      P[6 * i + 3 + d] = tgt[3 * o + d];
    }
    valid[i] = (mask == nullptr || mask[o] != 0) ? 1.0f : 0.0f;
  }
  __syncthreads();
  const float* fb = feats + static_cast<size_t>(b) * n * c;
  for (int i = warp; i < k; i += HYP_WARPS) {
    const float* row = fb + static_cast<size_t>(idx[i]) * c;
    for (int ch = lane; ch < fs; ch += 32) F[i * fs + ch] = ch < c ? row[ch] : 0.0f;
  }
  __syncthreads();

  // M: the upper triangle and the diagonal, mirrored
  const float sig = *sigma;
  const float sig2 = sig * sig;
  for (int e = tid; e < k * k; e += HYP_THREADS) {
    const int i = e / k, j = e - i * k;
    if (j < i) continue;
    const float4* fi = reinterpret_cast<const float4*>(F + i * fs);
    const float4* fj = reinterpret_cast<const float4*>(F + j * fs);
    float dot = 0.0f;
    for (int q = 0; q < c4 / 4; ++q) {
      const float4 a = fi[q], bq = fj[q];
      dot += a.x * bq.x;
      dot += a.y * bq.y;
      dot += a.z * bq.z;
      dot += a.w * bq.w;
    }
    const float feat = fmaxf(1.0f - (1.0f - dot) / sig2, 0.0f);
    const float dd = dist(P + 6 * i, P + 6 * j) - dist(P + 6 * i + 3, P + 6 * j + 3);
    const float spat = fmaxf(1.0f - (dd * dd) * inv_sigma_d2, 0.0f);
    const float m = (i == j || valid[i] == 0.0f || valid[j] == 0.0f) ? 0.0f : feat * spat;
    M[i * ms + j] = m;
    M[j * ms + i] = m;
  }
  for (int i = tid; i < k; i += HYP_THREADS) v[i] = 1.0f;
  __syncthreads();

  // power iteration: thread t owns rows t + 128 i
  for (int it = 0; it < iters; ++it) {
    float sq[1] = {0.0f};
    for (int row = tid; row < k; row += HYP_THREADS) {
      float w = 0.0f;
      for (int j = 0; j < k; ++j) w += M[row * ms + j] * v[j];
      v_new[row] = w;
      sq[0] += w * w;
    }
    block_sums(sq, red);  // every thread has read v
    for (int row = tid; row < k; row += HYP_THREADS)
      v[row] = v_new[row] / (sqrtf(sq[0] + 1e-30f) + 1e-6f);
    __syncthreads();
  }

  // NSM weights, then the weighted Procrustes on the centred neighbours
  float tot[1] = {0.0f};
  for (int row = tid; row < k; row += HYP_THREADS) tot[0] += fabsf(v[row]) * valid[row];
  block_sums(tot, red);
  auto weight = [&](int row) { return fabsf(v[row]) * valid[row] / (tot[0] + 1e-6f); };
  float m7[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int row = tid; row < k; row += HYP_THREADS) {
    const float wi = weight(row);
    const float* p = P + 6 * row;
    m7[0] += wi;
#pragma unroll
    for (int d = 0; d < 6; ++d) m7[1 + d] += wi * p[d];
  }
  block_sums(m7, red);
  const float wsum = m7[0] + 1e-6f;
  float cs[3], ct[3];
  for (int d = 0; d < 3; ++d) {
    cs[d] = m7[1 + d] / wsum;
    ct[d] = m7[4 + d] / wsum;
  }
  float h[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int row = tid; row < k; row += HYP_THREADS) {
    const float wi = weight(row);
    const float* p = P + 6 * row;
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int q = 0; q < 3; ++q) h[3 * r + q] += (p[r] - cs[r]) * wi * (p[3 + q] - ct[q]);
  }
  block_sums(h, red);
  if (warp == 0) {
    const float H[3][3] = {{h[0], h[1], h[2]}, {h[3], h[4], h[5]}, {h[6], h[7], h[8]}};
    float R[3][3];
    horn_rotation(H, Bs, adj, R);
    if (lane == 0) {
      float* T = trans + (static_cast<size_t>(b) * s + seed) * 16;
      for (int r = 0; r < 3; ++r) {
        T[4 * r + 0] = R[r][0];
        T[4 * r + 1] = R[r][1];
        T[4 * r + 2] = R[r][2];
        T[4 * r + 3] = ct[r] - ((R[r][0] * cs[0] + R[r][1] * cs[1]) + R[r][2] * cs[2]);
      }
      T[12] = 0.0f;
      T[13] = 0.0f;
      T[14] = 0.0f;
      T[15] = 1.0f;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
scoring_kernel(const float* __restrict__ trans, const float* __restrict__ src,
               const float* __restrict__ tgt, const uint8_t* __restrict__ mask,
               float* __restrict__ counts, int s, int n, float thr2) {
  __shared__ int warp_sums[THREADS / 32];
  const int seed = blockIdx.x, b = blockIdx.y;
  const float* tr = trans + (static_cast<size_t>(b) * s + seed) * 16;
  const float* ps = src + static_cast<size_t>(b) * n * 3;
  const float* pt = tgt + static_cast<size_t>(b) * n * 3;
  const uint8_t* m = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * n;
  float T[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) T[i] = tr[i];
  int cnt = 0;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const float x = ps[3 * i], y = ps[3 * i + 1], z = ps[3 * i + 2];
    const float p0 = T[0] * x + T[1] * y + T[2] * z + T[3];
    const float p1 = T[4] * x + T[5] * y + T[6] * z + T[7];
    const float p2 = T[8] * x + T[9] * y + T[10] * z + T[11];
    const float e0 = p0 - pt[3 * i], e1 = p1 - pt[3 * i + 1], e2 = p2 - pt[3 * i + 2];
    const float d2 = e0 * e0 + e1 * e1 + e2 * e2;
    cnt += (d2 < thr2 && (m == nullptr || m[i] != 0)) ? 1 : 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) cnt += __shfl_xor_sync(FULL, cnt, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < THREADS / 32; ++w) total += warp_sums[w];
    counts[static_cast<size_t>(b) * s + seed] = static_cast<float>(total);
  }
}

// (value, index) of the larger, the lower index on a tie
__device__ __forceinline__ void arg_max(float& val, int& at, float other, int other_at) {
  if (other > val || (other == val && other_at < at)) {
    val = other;
    at = other_at;
  }
}

__global__ void __launch_bounds__(SEL_THREADS)
select_kernel(const float* __restrict__ trans, const float* __restrict__ counts,
              const int64_t* __restrict__ seeds, const float* __restrict__ src,
              const float* __restrict__ tgt, const uint8_t* __restrict__ mask, int s, int n,
              float thr, float* __restrict__ fitness, float* __restrict__ final_trans,
              float* __restrict__ labels) {
  __shared__ int part[SEL_THREADS / 32];
  __shared__ float part_val[SEL_THREADS / 32];
  __shared__ int part_at[SEL_THREADS / 32];
  __shared__ float T[16];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint8_t* m = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * n;

  int valid = 0;
  for (int i = tid; i < n; i += SEL_THREADS) valid += (m == nullptr || m[i] != 0) ? 1 : 0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) valid += __shfl_xor_sync(FULL, valid, off);
  if (lane == 0) part[warp] = valid;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < SEL_THREADS / 32; ++w) total += part[w];
  const float denom = static_cast<float>(max(total, 1));

  float best = -INFINITY;
  int at = INT32_MAX;
  for (int j = tid; j < s; j += SEL_THREADS) {
    const size_t o = static_cast<size_t>(b) * s + j;
    const int64_t sd = seeds[o];
    const float f = (m == nullptr || m[sd] != 0) ? counts[o] / denom : -1.0f;
    fitness[o] = f;
    arg_max(best, at, f, j);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    arg_max(best, at, __shfl_xor_sync(FULL, best, off), __shfl_xor_sync(FULL, at, off));
  if (lane == 0) {
    part_val[warp] = best;
    part_at[warp] = at;
  }
  __syncthreads();
  if (tid < 16) {
    best = part_val[0];
    at = part_at[0];
    for (int w = 1; w < SEL_THREADS / 32; ++w) arg_max(best, at, part_val[w], part_at[w]);
    const float t = trans[(static_cast<size_t>(b) * s + at) * 16 + tid];
    T[tid] = t;
    final_trans[static_cast<size_t>(b) * 16 + tid] = t;
  }
  __syncthreads();

  const float* ps = src + static_cast<size_t>(b) * n * 3;
  const float* pt = tgt + static_cast<size_t>(b) * n * 3;
  for (int i = tid; i < n; i += SEL_THREADS) {
    const float x = ps[3 * i], y = ps[3 * i + 1], z = ps[3 * i + 2];
    const float e0 = T[0] * x + T[1] * y + T[2] * z + T[3] - pt[3 * i];
    const float e1 = T[4] * x + T[5] * y + T[6] * z + T[7] - pt[3 * i + 1];
    const float e2 = T[8] * x + T[9] * y + T[10] * z + T[11] - pt[3 * i + 2];
    const bool in = sqrtf(e0 * e0 + e1 * e1 + e2 * e2) < thr && (m == nullptr || m[i] != 0);
    labels[static_cast<size_t>(b) * n + i] = in ? 1.0f : 0.0f;
  }
}

// the dynamic shared memory launch 1 may use, raised once per device and form
template <bool kFGlobal, bool kMGlobal>
bool raise_smem_limit() {
  static bool raised[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return false;
  if (raised[dev]) return true;
  if (cudaFuncSetAttribute(hypotheses_kernel<kFGlobal, kMGlobal>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           MAX_HYP_SMEM) != cudaSuccess)
    return false;
  raised[dev] = true;
  return true;
}

template <bool kFGlobal, bool kMGlobal>
int launch_hypotheses(const void* feats, const void* knn, const void* src, const void* tgt,
                      const void* mask, const void* sigma, void* trans, void* ws_f, void* ws_m,
                      int batch, int n, int c, int s, int k, int iters, float inv_sigma_d2,
                      size_t bytes, void* stream) {
  if (!raise_smem_limit<kFGlobal, kMGlobal>()) return static_cast<int>(cudaGetLastError());
  hypotheses_kernel<kFGlobal, kMGlobal>
      <<<dim3(s, batch), HYP_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(feats), static_cast<const int64_t*>(knn),
          static_cast<const float*>(src), static_cast<const float*>(tgt),
          static_cast<const uint8_t*>(mask), static_cast<const float*>(sigma), inv_sigma_d2, n,
          c, s, k, iters, static_cast<float*>(trans), static_cast<float*>(ws_f),
          static_cast<float*>(ws_m));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ws_f [B, S, k, fs] (fs = C rounded up to 4, plus 4) and ws_m [B, S, k, k + 1]
// f32: the workspaces of the features and of M, or nullptr for the arena;
// the arena (the per-row arrays and what is not in a workspace) must fit
// MAX_HYP_SMEM (the wrapper's choice: kernels/scoring.py::hypotheses_layout).
extern "C" int seed_hypotheses(const void* feats, const void* knn, const void* src,
                               const void* tgt, const void* mask, const void* sigma,
                               void* trans, void* ws_f, void* ws_m, int batch, int n, int c,
                               int s, int k, int iters, float inv_sigma_d2, void* stream) {
  const bool f_global = ws_f != nullptr, m_global = ws_m != nullptr;
  const size_t fs = ((c + 3) & ~3) + 4;
  const size_t bytes = (row_arrays(k) + (f_global ? 0 : k * fs) +
                        (m_global ? 0 : static_cast<size_t>(k) * (k + 1))) * 4;
  if (k < 1 || c < 1 || bytes > MAX_HYP_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const auto launch = f_global ? (m_global ? launch_hypotheses<true, true>
                                           : launch_hypotheses<true, false>)
                               : (m_global ? launch_hypotheses<false, true>
                                           : launch_hypotheses<false, false>);
  return launch(feats, knn, src, tgt, mask, sigma, trans, ws_f, ws_m, batch, n, c, s, k, iters,
                inv_sigma_d2, bytes, stream);
}

extern "C" int seed_inlier_counts(const void* trans, const void* src, const void* tgt,
                                  const void* mask, void* counts, int batch, int s, int n,
                                  float thr2, void* stream) {
  scoring_kernel<<<dim3(s, batch), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(trans), static_cast<const float*>(src),
      static_cast<const float*>(tgt), static_cast<const uint8_t*>(mask),
      static_cast<float*>(counts), s, n, thr2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int select_hypothesis(const void* trans, const void* counts, const void* seeds,
                                 const void* src, const void* tgt, const void* mask,
                                 void* fitness, void* final_trans, void* labels, int batch, int s,
                                 int n, float thr, void* stream) {
  select_kernel<<<batch, SEL_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(trans), static_cast<const float*>(counts),
      static_cast<const int64_t*>(seeds), static_cast<const float*>(src),
      static_cast<const float*>(tgt), static_cast<const uint8_t*>(mask), s, n, thr,
      static_cast<float*>(fitness), static_cast<float*>(final_trans),
      static_cast<float*>(labels));
  return static_cast<int>(cudaGetLastError());
}
