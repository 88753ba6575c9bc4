// Offset-softmax attention over the int8 spatial-consistency cache: the
// device function shared by the offset cached attention (sc_attention.cu)
// and the whole-encoder-layer kernels (encoder_layer.cu), as the JAX package
// shares _offset_attn_p between its kernels
// (pointdsc_tpu/kernels/encoder_layer.py:59, sc_attention.py:472).
//
//   o_i  = ||q_i|| * kscale               kscale = max_j ||k_j|| / sqrt(C)
//   p_ij = exp(max(compat_ij * (q_i.k_j * scale) + bias_j - o_i, -80))
//   p_ij = 0 where bias_j < 0             (only when a bias row is given)
//   l_i  = sum_j p_ij                     (f32, before any rounding of p)
//   acc_i = sum_j bf16(p_ij) v_j          q, k, v are bf16
//
// The offset bounds every logit from above, so no running max, no rescale of
// the accumulator and no max pass are needed: a block owns 32 query rows and
// walks all key tiles of 64 rows, acc [32 x 128] in registers (16 per thread).
// f32 FMAs through shared memory on the bf16 operands, widened exactly;
// tensor cores and TMA are later work. Rows of Q and K in
// shared memory are padded to 129 floats so that the 16 lanes which share a
// query row read 16 different banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace oa {

constexpr int C = 128;
constexpr int BQ = 32;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int CP = C + 1;   // padded Q/K row
constexpr int PP = BK + 1;  // padded P row

// dynamic shared memory, in floats: V first (float4-aligned rows)
constexpr int OFF_V = 0;
constexpr int OFF_K = OFF_V + BK * C;
constexpr int OFF_Q = OFF_K + BK * CP;
constexpr int OFF_P = OFF_Q + BQ * CP;
constexpr int OFF_C = OFF_P + BQ * PP;
constexpr int OFF_BIAS = OFF_C + BQ * BK;
constexpr int OFF_OFFS = OFF_BIAS + BK;
constexpr int OFF_L = OFF_OFFS + BQ;
constexpr int SMEM_FLOATS = OFF_L + BQ;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

// four consecutive bf16 channels of a row as loaded (8 bytes), and widened
__device__ inline uint2 load_raw4(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint2*>(p);
}

__device__ inline float4 widen(uint2 r) {
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// four consecutive channels of a row as f32
__device__ inline float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ inline float4 load4(const __nv_bfloat16* p) { return widen(load_raw4(p)); }

__device__ inline void store_padded(float* row, int c4, float4 x) {
  row[c4 + 0] = x.x;
  row[c4 + 1] = x.y;
  row[c4 + 2] = x.z;
  row[c4 + 3] = x.w;
}

// Attention of query rows [q0, q0 + BQ) of one pair over all n keys.
// q, k, v [n, C] bf16, compat [n, n] int8, bias [n] or nullptr.
// On return acc[r][j] holds the unnormalised output of row 4 * (tid >> 5) + r,
// channel (tid & 31) + 32 * j, and smem[OFF_L + row] the row's sum of p; the
// block is synchronised, so the caller may reuse the V, K, Q, P and compat
// regions.
__device__ void attention_rows(const __nv_bfloat16* q, const __nv_bfloat16* k,
                               const __nv_bfloat16* v, const int8_t* compat, const float* bias,
                               float kscale, int n, int q0, float qk_scale, float* smem,
                               float (&acc)[4][4]) {
  float* Vs = smem + OFF_V;
  float* Ks = smem + OFF_K;
  float* Qs = smem + OFF_Q;
  float* Ps = smem + OFF_P;
  float* Cs = smem + OFF_C;
  float* bias_s = smem + OFF_BIAS;
  float* offs_s = smem + OFF_OFFS;
  float* l_s = smem + OFF_L;

  const int tid = threadIdx.x;
  // layout 1 (logits): 16 row pairs x 16 column lanes (key columns tx + 16 j)
  const int ty = tid >> 4, tx = tid & 15;
  // layout 2 (p v and everything after): 8 row quads x 32 channel lanes
  const int ry = tid >> 5, cx = tid & 31;
  const bool has_bias = bias != nullptr;

  __syncthreads();  // whoever used the shared memory before is done
  for (int i = tid; i < BQ * C / 4; i += THREADS) {
    const int r = i / (C / 4), c4 = (i % (C / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < n) x = load4(q + static_cast<size_t>(q0 + r) * C + c4);
    store_padded(Qs + r * CP, c4, x);
  }
  __syncthreads();

  // per-row offset ||q_i|| * kscale: a warp owns four rows
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 4 * ry + r;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x = Qs[row * CP + cx + 32 * j];
      sq = fmaf(x, x, sq);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    if (cx == 0) offs_s[row] = sqrtf(sq) * kscale;
  }

  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  for (int k0 = 0; k0 < n; k0 += BK) {
    // Stage the tile through registers: every global load is issued before
    // the barrier and the first shared store, so the 24 loads of a thread are
    // in flight together, and while slower warps still finish the previous
    // tile (the compiler cannot hoist them itself past stores it cannot prove
    // distinct). A tile takes 34 registers, within the 128 that let two
    // blocks share an SM.
    constexpr int KV_ITERS = BK * C / 4 / THREADS;
    constexpr int C_ITERS = BQ * BK / THREADS;
    uint2 kreg[KV_ITERS], vreg[KV_ITERS];
    int8_t creg[C_ITERS];
#pragma unroll
    for (int it = 0; it < KV_ITERS; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / (C / 4), c4 = (i % (C / 4)) * 4;
      if (k0 + r < n) {
        kreg[it] = load_raw4(k + static_cast<size_t>(k0 + r) * C + c4);
        vreg[it] = load_raw4(v + static_cast<size_t>(k0 + r) * C + c4);
      } else {
        kreg[it] = make_uint2(0u, 0u);
        vreg[it] = make_uint2(0u, 0u);
      }
    }
#pragma unroll
    for (int it = 0; it < C_ITERS; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / BK, c = i % BK;
      creg[it] = (q0 + r < n && k0 + c < n)
                     ? compat[static_cast<size_t>(q0 + r) * n + k0 + c] : int8_t(0);
    }
    const float bias_reg = (has_bias && tid < BK && k0 + tid < n) ? bias[k0 + tid] : 0.f;
    __syncthreads();  // the previous tile's readers are done; offs_s is visible
#pragma unroll
    for (int it = 0; it < KV_ITERS; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / (C / 4), c4 = (i % (C / 4)) * 4;
      store_padded(Ks + r * CP, c4, widen(kreg[it]));
      *reinterpret_cast<float4*>(Vs + r * C + c4) = widen(vreg[it]);
    }
#pragma unroll
    for (int it = 0; it < C_ITERS; ++it) Cs[tid + it * THREADS] = static_cast<float>(creg[it]);
    if (tid < BK) bias_s[tid] = bias_reg;
    __syncthreads();

    // ---- logits and weights
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
      const float o = offs_s[row];
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        float val = Cs[row * BK + col] * (s[i][j] * qk_scale);
        if (has_bias) val += bias_s[col];
        float p = expf(fmaxf(val - o, -80.0f));
        if ((has_bias && bias_s[col] < 0.f) || k0 + col >= n) p = 0.f;
        sum += p;
        // the TPU kernels round p to their v's type before p v
        Ps[row * PP + col] = __bfloat162float(__float2bfloat16_rn(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] += sum;
    }
    __syncthreads();

    // ---- acc += P V
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
}

}  // namespace oa
