// Attention over the int8 spatial-consistency cache, CUDA C++ for sm_90a:
// the running-max (flash) kernel, and at the end of the file the
// offset-softmax kernel.
//
// Replaces the TPU kernel pointdsc_tpu/kernels/sc_attention.py:417
// (_sc_attention_cached_kernel, pallas_call at :590), the
// fused_sc_attention_cached(offset_softmax=False) path:
//
//   out = softmax_j(compat_ij / 127 * q_i.k_j / sqrt(C) + bias_j) v_j
//
// q, k, v [B, N, 128] f32, compat [B, N, N] int8, bias [B, N] (0 valid,
// -1e9 padded), out [B, N, 128] f32. The 1/sqrt(C)/127 decode is folded into
// one qk scale; m starts at -1e9 and the result is acc / (l + 1e-30), as on
// the TPU.
//
// A TPU grid carries m, l and acc in scratch across sequential key steps; a
// CUDA block cannot, so the key loop is the block's own: a block owns 32
// query rows and walks all key tiles of 64 rows, keeping acc [32 x 128] in
// registers (16 per thread) and m, l per row.
//
// Bound on the H100: per layer at N = 5120 the kernel must read the 26.2 MB
// cache and do 2 N^2 C = 13.4 GFLOP of products. In f32 on the CUDA cores
// (67 TFLOP/s) that is 0.20 ms; on bf16 tensor cores it would be 14 us. This
// first version keeps f32 FMAs through shared memory (no tensor cores, no
// TMA), so it is bound by the f32 operations; bf16 wgmma tiles are later
// work. Shared rows of Q and K are padded to 129 floats so the 16 lanes that
// share a query row read 16 different banks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "offset_attention.cuh"

namespace {

constexpr int C = 128;
constexpr int BQ = 32;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int CP = C + 1;   // padded Q/K row
constexpr int PP = BK + 1;  // padded P row
constexpr float NEG = -1e9f;

// dynamic shared memory, in floats: V first (float4-aligned rows)
constexpr int OFF_V = 0;
constexpr int OFF_K = OFF_V + BK * C;
constexpr int OFF_Q = OFF_K + BK * CP;
constexpr int OFF_P = OFF_Q + BQ * CP;
constexpr int OFF_C = OFF_P + BQ * PP;
constexpr int OFF_BIAS = OFF_C + BQ * BK;
constexpr int OFF_ALPHA = OFF_BIAS + BK;
constexpr int OFF_L = OFF_ALPHA + BQ;
constexpr int SMEM_FLOATS = OFF_L + BQ;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

__global__ void __launch_bounds__(THREADS)
sc_attention_cached_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const int8_t* __restrict__ compat,
                           const float* __restrict__ bias, float* __restrict__ out, int n,
                           float qk_scale) {
  extern __shared__ __align__(16) float smem[];
  float* Vs = smem + OFF_V;
  float* Ks = smem + OFF_K;
  float* Qs = smem + OFF_Q;
  float* Ps = smem + OFF_P;
  float* Cs = smem + OFF_C;
  float* bias_s = smem + OFF_BIAS;
  float* alpha_s = smem + OFF_ALPHA;
  float* l_s = smem + OFF_L;

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t base = static_cast<size_t>(b) * n;

  // Q tile: BQ x C floats as float4 loads
  for (int i = tid; i < BQ * C / 4; i += THREADS) {
    const int r = i / (C / 4), c4 = (i % (C / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < n) x = *reinterpret_cast<const float4*>(q + (base + q0 + r) * C + c4);
    Qs[r * CP + c4 + 0] = x.x;
    Qs[r * CP + c4 + 1] = x.y;
    Qs[r * CP + c4 + 2] = x.z;
    Qs[r * CP + c4 + 3] = x.w;
  }

  // phase-1 layout: 16 row pairs x 16 column lanes (columns tx + 16 j)
  const int ty = tid >> 4, tx = tid & 15;
  // phase-2 layout: 8 row quads x 32 column lanes (columns cx + 32 j)
  const int ry = tid >> 5, cx = tid & 31;

  float m[2] = {NEG, NEG};
  float l[2] = {0.f, 0.f};
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * C / 4; i += THREADS) {
      const int r = i / (C / 4), c4 = (i % (C / 4)) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + r < n) {
        kx = *reinterpret_cast<const float4*>(k + (base + k0 + r) * C + c4);
        vx = *reinterpret_cast<const float4*>(v + (base + k0 + r) * C + c4);
      }
      Ks[r * CP + c4 + 0] = kx.x;
      Ks[r * CP + c4 + 1] = kx.y;
      Ks[r * CP + c4 + 2] = kx.z;
      Ks[r * CP + c4 + 3] = kx.w;
      *reinterpret_cast<float4*>(Vs + r * C + c4) = vx;
    }
    for (int i = tid; i < BQ * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      float cv = 0.f;
      if (q0 + r < n && k0 + c < n) cv = static_cast<float>(compat[(base + q0 + r) * n + k0 + c]);
      Cs[i] = cv;
    }
    if (tid < BK) bias_s[tid] = (k0 + tid < n) ? bias[base + k0 + tid] : 0.f;
    __syncthreads();

    // ---- phase 1: s = compat * (q.k * scale) + bias, online softmax stats
    float s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < C; ++c) {
      const float qa = Qs[(2 * ty) * CP + c];
      const float qb = Qs[(2 * ty + 1) * CP + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kk = Ks[(tx + 16 * j) * CP + c];
        s[0][j] = fmaf(qa, kk, s[0][j]);
        s[1][j] = fmaf(qb, kk, s[1][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = 2 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        float val = Cs[row * BK + col] * (s[i][j] * qk_scale) + bias_s[col];
        if (k0 + col >= n) val = -INFINITY;
        s[i][j] = val;
        mx = fmaxf(mx, val);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[row * PP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
      if (tx == 0) alpha_s[row] = alpha;
    }
    __syncthreads();

    // ---- phase 2: acc = acc * alpha + P V
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = alpha_s[4 * ry + r];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] *= a;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float vv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = Vs[kk * C + cx + 32 * j];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = Ps[(4 * ry + r) * PP + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(p, vv[j], acc[r][j]);
      }
    }
  }

  if (tx == 0) {
    l_s[2 * ty] = l[0];
    l_s[2 * ty + 1] = l[1];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 4 * ry + r;
    if (q0 + row >= n) continue;
    const float inv = 1.0f / (l_s[row] + 1e-30f);
#pragma unroll
    for (int j = 0; j < 4; ++j) out[(base + q0 + row) * C + cx + 32 * j] = acc[r][j] * inv;
  }
}

}  // namespace

extern "C" int sc_attention_cached(const void* q, const void* k, const void* v,
                                   const void* compat, const void* bias, void* out, int batch,
                                   int n, float qk_scale, void* stream) {
  // per call: the attribute belongs to the current device
  const cudaError_t err = cudaFuncSetAttribute(
      sc_attention_cached_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BQ - 1) / BQ, batch);
  sc_attention_cached_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int8_t*>(compat), static_cast<const float*>(bias),
      static_cast<float*>(out), n, qk_scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Offset-softmax attention over the same cache.
//
// Replaces the TPU kernel pointdsc_tpu/kernels/sc_attention.py:472
// (_sc_attention_cached_offset_kernel, pallas_call at :582), the
// fused_sc_attention_cached(offset_softmax=True) path:
//
//   p_ij = exp(max(compat_ij / 127 * q_i.k_j / sqrt(C) + bias_j - o_i, -80)),
//   p_ij = 0 where bias_j < 0,   o_i = ||q_i|| * kscale,
//   out_i = sum_j p_ij v_j / (sum_j p_ij + 1e-30)
//
// kscale = max_j ||k_j|| / sqrt(C) is one f32 per pair in device memory,
// reduced by the wrapper and read here by pointer, so no host read sits
// between the layers. q, k, v are bf16 (the half-precision encoder's own
// type; the wrapper rounds f32 inputs, as the JAX wrapper does off the CPU),
// and p is rounded to bf16 before the p v product, as the TPU kernel rounds
// it to its v's type. The loop is offset_attention.cuh's: the two N^2 C
// products on the bf16 tensor cores (mma.sync), the cache stream read once.

namespace {

__global__ void __launch_bounds__(oa::THREADS, 2)
sc_attention_offset_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const int8_t* __restrict__ compat, const float* __restrict__ bias,
                           const float* __restrict__ kscale, float* __restrict__ out, int n,
                           float qk_scale) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * oa::BQ;
  const size_t base = static_cast<size_t>(b) * n;
  float acc[4][4];
  oa::attention_rows(q + base * oa::C, k + base * oa::C, v + base * oa::C, compat + base * n,
                     bias + base, kscale[b], n, q0, qk_scale, smem, acc);
  const int ry = threadIdx.x >> 5, cx = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 4 * ry + r;
    if (q0 + row >= n) continue;
    const float l = smem[oa::OFF_L + row] + 1e-30f;
#pragma unroll
    for (int j = 0; j < 4; ++j) out[(base + q0 + row) * oa::C + cx + 32 * j] = acc[r][j] / l;
  }
}

}  // namespace

extern "C" int sc_attention_cached_offset(const void* q, const void* k, const void* v,
                                          const void* compat, const void* bias,
                                          const void* kscale, void* out, int batch, int n,
                                          float qk_scale, void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      sc_attention_offset_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(oa::SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + oa::BQ - 1) / oa::BQ, batch);
  sc_attention_offset_kernel<<<grid, oa::THREADS, oa::SMEM_BYTES,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int8_t*>(compat),
      static_cast<const float*>(bias), static_cast<const float*>(kscale),
      static_cast<float*>(out), n, qk_scale);
  return static_cast<int>(cudaGetLastError());
}
