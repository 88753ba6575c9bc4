// Spatial-consistency attention without a cache, forward and backward, CUDA
// C++ for sm_90a: the compat tile is recomputed from two geometry strips, so
// nothing [N, N] exists in device memory in either pass.
//
// Replaces the TPU kernels of pointdsc_tpu/kernels/sc_attention.py:
//   _sc_attention_fwd_kernel      (:649, pallas_call :787)  forward + row LSE
//   _sc_attention_bwd_dq_kernel   (:710, pallas_call :826)
//   _sc_attention_bwd_dkv_kernel  (:742, pallas_call :848)
//
//   compat_ij = max(1 - (d_src_ij - d_tgt_ij)^2 / sigma_d^2, 0),
//   d_ij = sqrt(max(|a_i|^2 + |a_j|^2 - 2 a_i.a_j, 0))   (the packed norms),
//   s_ij = compat_ij * q_i.k_j / sqrt(C) + bias_j,  p = softmax_j(s),
//   out_i = sum_j p_ij v_j,  lse_i = m_i + log(l_i + 1e-30);
//   backward, with P recomputed as exp(s - lse) and D_i = sum_c dO_ic O_ic:
//   dS = P (dO V^T - D),  dlogits = dS * compat / sqrt(C),
//   dQ = dlogits K,  dK = dlogits^T Q,  dV = P^T dO.
//
// q, k, v, dO [B, N, 128] f32; geom [B, 16, N] f32 (rows 0-2 src xyz, 3
// |src|^2, 4-6 tgt xyz, 7 |tgt|^2, 8 key bias: 0 valid, -1e9 padded); lse and
// D [B, N]. Geometry has no gradient.
//
// The compat entry is compat_geom.cuh's, explicitly rounded operations in the
// order of the plain PyTorch version, so kernel and plain version see the
// same compat bit for bit and differ only in the order of the 128- and
// N-term sums. (The eval attention without a cache, JAX's
// _sc_attention_kernel, runs on the tensor cores in sc_attention.cu with
// the same entry.)
//
// A TPU grid carries the softmax state, or the dQ / dK, dV sums, in scratch
// across sequential steps. Here a block owns 32 rows (queries in the forward
// and in dQ, keys in dK, dV) and walks over all tiles of 64 rows of the other
// side itself, so every output row has one owner: no atomics, and the result
// is the same from run to run. dQ and dK, dV are one templated body.
//
// Bound on the H100: the operands are f32, so the products run on the CUDA
// cores (67 TFLOP/s): 4 N^2 C operations per sample forward, 6 N^2 C for dQ
// and 8 N^2 C for dK, dV, against a few [N, C] streams. These first versions
// stage tiles through shared memory and use scalar FMAs.
//
// Above C = 128 (kWide): q, k, v, dO and the outputs are [B, N, ld], the
// model's channels zero-padded to ld = 128 m. A block makes m passes, one per
// 128-wide output chunk; in each it recomputes, tile by tile, the logits (and
// in the backward dP) summed over all m chunks in one order, staging the
// chunks one at a time into the same 128-wide tiles, so every pass sees the
// same s, P, m, l and LSE. The LSE and D are full-width row quantities; the
// forward writes the LSE once. m^2 passes' worth of the products: the cost
// of widths no shipped model has.

#include <cuda_runtime.h>
#include <math.h>

#include "compat_geom.cuh"

namespace {

constexpr int C = 128;  // a narrower model is zero-padded to it by the wrapper
constexpr int BO = 32;  // rows a block owns
constexpr int BT = 64;  // rows of the tile it walks over
constexpr int THREADS = 256;
constexpr int CP = C + 1;   // padded row of a [rows, C] tile
constexpr int PP = BT + 1;  // padded row of a [BO, BT] tile
constexpr int GROWS = 9;    // geometry rows the kernels read
constexpr int GSTRIDE = 16;
constexpr float NEG = -1e9f;

// rows [r0, r0 + rows), channels [col0, col0 + C) of a [n, ld] array into a
// padded shared tile, zeros past n
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int r0,
                                          int rows, int n, int ld = C, int col0 = 0) {
  for (int i = threadIdx.x; i < rows * C / 4; i += THREADS) {
    const int r = i / (C / 4), c4 = (i % (C / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n)
      x = *reinterpret_cast<const float4*>(src + static_cast<size_t>(r0 + r) * ld + col0 + c4);
    dst[r * CP + c4 + 0] = x.x;
    dst[r * CP + c4 + 1] = x.y;
    dst[r * CP + c4 + 2] = x.z;
    dst[r * CP + c4 + 3] = x.w;
  }
}

// columns [c0, c0 + cols) of the first GROWS rows of a [16, n] strip
__device__ __forceinline__ void load_geom(float* dst, const float* __restrict__ geom, int c0,
                                          int cols, int n) {
  for (int i = threadIdx.x; i < GROWS * cols; i += THREADS) {
    const int r = i / cols, c = i % cols;
    dst[i] = (c0 + c < n) ? geom[static_cast<size_t>(r) * n + c0 + c] : 0.f;
  }
}

// ---------------------------------------------------------------- forward

constexpr int F_OFF_V = 0;  // float4-aligned rows
constexpr int F_OFF_K = F_OFF_V + BT * C;
constexpr int F_OFF_Q = F_OFF_K + BT * CP;
constexpr int F_OFF_P = F_OFF_Q + BO * CP;
constexpr int F_OFF_GQ = F_OFF_P + BO * PP;
constexpr int F_OFF_GK = F_OFF_GQ + GROWS * BO;
constexpr int F_OFF_ALPHA = F_OFF_GK + GROWS * BT;
constexpr int F_OFF_L = F_OFF_ALPHA + BO;
constexpr int F_OFF_M = F_OFF_L + BO;
constexpr size_t F_SMEM_BYTES = (F_OFF_M + BO) * sizeof(float);

template <bool kWide>
__global__ void __launch_bounds__(THREADS)
sc_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ geom,
                        float* __restrict__ out, float* __restrict__ lse, int n, float sig2,
                        float scale, int ld) {
  extern __shared__ __align__(16) float smem[];
  float* Vs = smem + F_OFF_V;
  float* Ks = smem + F_OFF_K;
  float* Qs = smem + F_OFF_Q;
  float* Ps = smem + F_OFF_P;
  float* Gq = smem + F_OFF_GQ;
  float* Gk = smem + F_OFF_GK;
  float* alpha_s = smem + F_OFF_ALPHA;
  float* l_s = smem + F_OFF_L;
  float* m_s = smem + F_OFF_M;

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BO;
  const size_t base = static_cast<size_t>(b) * n;
  const int w = kWide ? ld : C;  // row width
  const int chunks = kWide ? ld / C : 1;
  q += base * w;
  k += base * w;
  v += base * w;
  geom += base * GSTRIDE;

  if constexpr (!kWide) load_rows(Qs, q, q0, BO, n);
  load_geom(Gq, geom, q0, BO, n);

  // phase-1 layout: 16 row pairs x 16 column lanes (columns tx + 16 j)
  const int ty = tid >> 4, tx = tid & 15;
  // phase-2 layout: 8 row quads x 32 column lanes (columns cx + 32 j)
  const int ry = tid >> 5, cx = tid & 31;

  for (int oc = 0; oc < chunks; ++oc) {
    float m[2] = {NEG, NEG};
    float l[2] = {0.f, 0.f};
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

    for (int k0 = 0; k0 < n; k0 += BT) {
      __syncthreads();  // the previous tile's readers are done
      if constexpr (kWide) {
        load_rows(Qs, q, q0, BO, n, ld, 0);
        load_rows(Ks, k, k0, BT, n, ld, 0);
      } else {
        load_rows(Ks, k, k0, BT, n);
      }
      for (int i = tid; i < BT * C / 4; i += THREADS) {
        const int r = i / (C / 4), c4 = (i % (C / 4)) * 4;
        float4 vx = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + r < n)
          vx = *reinterpret_cast<const float4*>(v + static_cast<size_t>(k0 + r) * w + C * oc + c4);
        *reinterpret_cast<float4*>(Vs + r * C + c4) = vx;
      }
      load_geom(Gk, geom, k0, BT, n);
      __syncthreads();

      // ---- phase 1: s = compat * (q.k * scale) + bias, online softmax stats
      float s[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      for (int ch = 0; ch < chunks; ++ch) {
        if constexpr (kWide) {
          if (ch > 0) {  // the next chunk of Q and K
            __syncthreads();
            load_rows(Qs, q, q0, BO, n, ld, C * ch);
            load_rows(Ks, k, k0, BT, n, ld, C * ch);
            __syncthreads();
          }
        }
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
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = 2 * ty + i;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          const float compat = geo::compat_entry<BO, BT>(Gq, row, Gk, col, sig2);
          float val = compat * (s[i][j] * scale) + Gk[8 * BT + col];
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
      for (int kk = 0; kk < BT; ++kk) {
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
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l_s[2 * ty + i] = l[i];
        m_s[2 * ty + i] = m[i];
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 4 * ry + r;
      if (q0 + row >= n) continue;
      const float inv = 1.0f / (l_s[row] + 1e-30f);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[(base + q0 + row) * w + C * oc + cx + 32 * j] = acc[r][j] * inv;
    }
    if (oc == 0 && tid < BO && q0 + tid < n)
      lse[base + q0 + tid] = m_s[tid] + logf(l_s[tid] + 1e-30f);
  }  // output chunks
}

// ---------------------------------------------------------------- backward
//
// One body for both kernels. The block owns BO rows and walks over tiles of
// BT rows of the other side:
//   DKV = false: owns queries (A_own = Q, B_own = dO), tiles are keys
//                (A_tile = K, B_tile = V); dQ += dlogits K.
//   DKV = true:  owns keys (A_own = K, B_own = V), tiles are queries
//                (A_tile = Q, B_tile = dO); dK += dlogits^T Q, dV += P^T dO.
// Either way s = A_own.A_tile and dP = B_own.B_tile for the (own, tile) pair.

constexpr int B_OFF_AO = 0;
constexpr int B_OFF_BO = B_OFF_AO + BO * CP;
constexpr int B_OFF_AT = B_OFF_BO + BO * CP;
constexpr int B_OFF_BT = B_OFF_AT + BT * CP;
constexpr int B_OFF_GO = B_OFF_BT + BT * CP;
constexpr int B_OFF_GT = B_OFF_GO + GROWS * BO;
constexpr int B_OFF_LSE = B_OFF_GT + GROWS * BT;
constexpr int B_OFF_D = B_OFF_LSE + BT;
constexpr int B_OFF_DL = B_OFF_D + BT;
constexpr int B_OFF_PT = B_OFF_DL + BO * PP;  // dK, dV only
constexpr size_t B_SMEM_BYTES_DQ = B_OFF_PT * sizeof(float);
constexpr size_t B_SMEM_BYTES_DKV = (B_OFF_PT + BO * PP) * sizeof(float);

template <bool DKV, bool kWide>
__global__ void __launch_bounds__(THREADS)
sc_attention_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ d_out,
                        const float* __restrict__ geom, const float* __restrict__ lse,
                        const float* __restrict__ dvec, float* __restrict__ out_a,
                        float* __restrict__ out_b, int n, float sig2, float scale, int ld) {
  extern __shared__ __align__(16) float smem[];
  float* Ao = smem + B_OFF_AO;
  float* Bo = smem + B_OFF_BO;
  float* At = smem + B_OFF_AT;
  float* Bt = smem + B_OFF_BT;
  float* Go = smem + B_OFF_GO;
  float* Gt = smem + B_OFF_GT;
  float* lse_s = smem + B_OFF_LSE;
  float* d_s = smem + B_OFF_D;
  float* DL = smem + B_OFF_DL;
  float* PT = smem + B_OFF_PT;

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int o0 = blockIdx.x * BO;
  const size_t base = static_cast<size_t>(b) * n;
  const int w = kWide ? ld : C;  // row width
  const int chunks = kWide ? ld / C : 1;
  q += base * w;
  k += base * w;
  v += base * w;
  d_out += base * w;
  geom += base * GSTRIDE;
  lse += base;
  dvec += base;
  const float* a_own = DKV ? k : q;
  const float* b_own = DKV ? v : d_out;
  const float* a_tile = DKV ? q : k;
  const float* b_tile = DKV ? d_out : v;

  if constexpr (!kWide) {
    load_rows(Ao, a_own, o0, BO, n);
    load_rows(Bo, b_own, o0, BO, n);
  }
  load_geom(Go, geom, o0, BO, n);
  if (!DKV && tid < BO) {  // the statistics belong to the queries
    lse_s[tid] = (o0 + tid < n) ? lse[o0 + tid] : 0.f;
    d_s[tid] = (o0 + tid < n) ? dvec[o0 + tid] : 0.f;
  }

  const int ty = tid >> 4, tx = tid & 15;
  const int ry = tid >> 5, cx = tid & 31;

  for (int oc = 0; oc < chunks; ++oc) {
    float acc_a[4][4], acc_b[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc_a[r][j] = acc_b[r][j] = 0.f;

    for (int t0 = 0; t0 < n; t0 += BT) {
      __syncthreads();  // the previous tile's readers are done
      if constexpr (kWide) {
        load_rows(Ao, a_own, o0, BO, n, ld, 0);
        load_rows(Bo, b_own, o0, BO, n, ld, 0);
        load_rows(At, a_tile, t0, BT, n, ld, 0);
        load_rows(Bt, b_tile, t0, BT, n, ld, 0);
      } else {
        load_rows(At, a_tile, t0, BT, n);
        load_rows(Bt, b_tile, t0, BT, n);
      }
      load_geom(Gt, geom, t0, BT, n);
      if (DKV && tid < BT) {
        lse_s[tid] = (t0 + tid < n) ? lse[t0 + tid] : 0.f;
        d_s[tid] = (t0 + tid < n) ? dvec[t0 + tid] : 0.f;
      }
      __syncthreads();

      // ---- phase 1: s and dP for the (own, tile) pairs, then P and dlogits
      float s[2][4], dp[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int ch = 0; ch < chunks; ++ch) {
        if constexpr (kWide) {
          if (ch > 0) {  // the next chunk of the four tiles
            __syncthreads();
            load_rows(Ao, a_own, o0, BO, n, ld, C * ch);
            load_rows(Bo, b_own, o0, BO, n, ld, C * ch);
            load_rows(At, a_tile, t0, BT, n, ld, C * ch);
            load_rows(Bt, b_tile, t0, BT, n, ld, C * ch);
            __syncthreads();
          }
        }
#pragma unroll 4
        for (int c = 0; c < C; ++c) {
          const float a0 = Ao[(2 * ty) * CP + c], a1 = Ao[(2 * ty + 1) * CP + c];
          const float b0 = Bo[(2 * ty) * CP + c], b1 = Bo[(2 * ty + 1) * CP + c];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float at = At[(tx + 16 * j) * CP + c];
            const float bt = Bt[(tx + 16 * j) * CP + c];
            s[0][j] = fmaf(a0, at, s[0][j]);
            s[1][j] = fmaf(a1, at, s[1][j]);
            dp[0][j] = fmaf(b0, bt, dp[0][j]);
            dp[1][j] = fmaf(b1, bt, dp[1][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = 2 * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          const float compat = geo::compat_entry<BO, BT>(Go, row, Gt, col, sig2);
          const float bias = DKV ? Go[8 * BO + row] : Gt[8 * BT + col];
          const int stat = DKV ? col : row;
          float p = expf(compat * (s[i][j] * scale) + bias - lse_s[stat]);
          if (t0 + col >= n) p = 0.f;
          const float dl = p * (dp[i][j] - d_s[stat]) * compat * scale;
          DL[row * PP + col] = dl;
          if (DKV) PT[row * PP + col] = p;
        }
      }
      __syncthreads();
      if constexpr (kWide) {
        if (oc != chunks - 1) {  // the tile's output chunk (phase 1 left the last one)
          load_rows(At, a_tile, t0, BT, n, ld, C * oc);
          if (DKV) load_rows(Bt, b_tile, t0, BT, n, ld, C * oc);
          __syncthreads();
        }
      }

      // ---- phase 2: the owned rows' sums against the tile's rows
#pragma unroll 4
      for (int kk = 0; kk < BT; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          av[j] = At[kk * CP + cx + 32 * j];
          if (DKV) bv[j] = Bt[kk * CP + cx + 32 * j];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float dl = DL[(4 * ry + r) * PP + kk];
          const float p = DKV ? PT[(4 * ry + r) * PP + kk] : 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc_a[r][j] = fmaf(dl, av[j], acc_a[r][j]);
            if (DKV) acc_b[r][j] = fmaf(p, bv[j], acc_b[r][j]);
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 4 * ry + r;
      if (o0 + row >= n) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const size_t at = (base + o0 + row) * w + C * oc + cx + 32 * j;
        out_a[at] = acc_a[r][j];
        if (DKV) out_b[at] = acc_b[r][j];
      }
    }
  }  // output chunks
}

template <bool DKV, bool kWide>
int launch_bwd(const void* q, const void* k, const void* v, const void* d_out, const void* geom,
               const void* lse, const void* dvec, void* out_a, void* out_b, int batch, int n,
               int ld, float sig2, float scale, void* stream) {
  const size_t bytes = DKV ? B_SMEM_BYTES_DKV : B_SMEM_BYTES_DQ;
  const cudaError_t err =
      cudaFuncSetAttribute(sc_attention_bwd_kernel<DKV, kWide>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BO - 1) / BO, batch);
  sc_attention_bwd_kernel<DKV, kWide><<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(d_out), static_cast<const float*>(geom),
      static_cast<const float*>(lse), static_cast<const float*>(dvec),
      static_cast<float*>(out_a), static_cast<float*>(out_b), n, sig2, scale, ld);
  return static_cast<int>(cudaGetLastError());
}

template <bool kWide>
int launch_fwd(const void* q, const void* k, const void* v, const void* geom, void* out,
               void* lse, int batch, int n, int ld, float sig2, float scale, void* stream) {
  // per call: the attribute belongs to the current device
  const cudaError_t err =
      cudaFuncSetAttribute(sc_attention_fwd_kernel<kWide>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(F_SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BO - 1) / BO, batch);
  sc_attention_fwd_kernel<kWide><<<grid, THREADS, F_SMEM_BYTES,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(geom), static_cast<float*>(out), static_cast<float*>(lse), n,
      sig2, scale, ld);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ld: the row width of q, k, v, dO and the outputs (128, or a wider model's 128 m)
extern "C" int sc_attention_train_fwd(const void* q, const void* k, const void* v,
                                      const void* geom, void* out, void* lse, int batch, int n,
                                      int ld, float sig2, float scale, void* stream) {
  if (ld < C || ld % C) return static_cast<int>(cudaErrorInvalidValue);
  return ld == C ? launch_fwd<false>(q, k, v, geom, out, lse, batch, n, ld, sig2, scale, stream)
                 : launch_fwd<true>(q, k, v, geom, out, lse, batch, n, ld, sig2, scale, stream);
}

extern "C" int sc_attention_train_bwd_dq(const void* q, const void* k, const void* v,
                                         const void* d_out, const void* geom, const void* lse,
                                         const void* dvec, void* dq, int batch, int n, int ld,
                                         float sig2, float scale, void* stream) {
  if (ld < C || ld % C) return static_cast<int>(cudaErrorInvalidValue);
  return ld == C ? launch_bwd<false, false>(q, k, v, d_out, geom, lse, dvec, dq, nullptr, batch,
                                            n, ld, sig2, scale, stream)
                 : launch_bwd<false, true>(q, k, v, d_out, geom, lse, dvec, dq, nullptr, batch,
                                           n, ld, sig2, scale, stream);
}

extern "C" int sc_attention_train_bwd_dkv(const void* q, const void* k, const void* v,
                                          const void* d_out, const void* geom, const void* lse,
                                          const void* dvec, void* dk, void* dv, int batch, int n,
                                          int ld, float sig2, float scale, void* stream) {
  if (ld < C || ld % C) return static_cast<int>(cudaErrorInvalidValue);
  return ld == C ? launch_bwd<true, false>(q, k, v, d_out, geom, lse, dvec, dk, dv, batch, n, ld,
                                           sig2, scale, stream)
                 : launch_bwd<true, true>(q, k, v, d_out, geom, lse, dvec, dk, dv, batch, n, ld,
                                          sig2, scale, stream);
}
