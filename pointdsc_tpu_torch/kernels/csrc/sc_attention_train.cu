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
// across sequential steps. Here a block owns a run of rows (queries in the
// forward and in dQ, keys in dK, dV) and walks over all tiles of the other
// side itself, so every output row has one owner: no atomics, and the result
// is the same from run to run. dQ and dK, dV are one templated body.
//
// Bound on the H100: the operands are f32, so the products run on the CUDA
// cores (67 TFLOP/s): 4 N^2 C operations per sample forward, 6 N^2 C for dQ
// and 8 N^2 C for dK, dV, against a few [N, C] streams. Above C = 128 the
// kernels stage tiles through shared memory and use scalar FMAs; at C = 128
// (sc_attention_bwd128_kernel, sc_attention_fwd128_kernel) they are built
// for the FMA rate: 64 owned rows a block, register tiles in both phases
// whose operands are read as float4, and the next tile copied by cp.async
// while the current one is worked (their notes below).
//
// Above C = 128: q, k, v, dO and the outputs are [B, N, ld], the
// model's channels zero-padded to ld = 128 m. A block makes m passes, one per
// 128-wide output chunk; in each it recomputes, tile by tile, the logits (and
// in the backward dP) summed over all m chunks in one order, staging the
// chunks one at a time into the same 128-wide tiles, so every pass sees the
// same s, P, m, l and LSE. The LSE and D are full-width row quantities; the
// forward writes the LSE once. m^2 passes' worth of the products: the cost
// of widths no shipped model has.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "compat_geom.cuh"
#include "compat_tile.cuh"
#include "f32_tiles.cuh"

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

// ---------------------------------------------------- forward, above C = 128

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
  const int chunks = ld / C;
  q += base * ld;
  k += base * ld;
  v += base * ld;
  geom += base * GSTRIDE;

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
      load_rows(Qs, q, q0, BO, n, ld, 0);
      load_rows(Ks, k, k0, BT, n, ld, 0);
      for (int i = tid; i < BT * C / 4; i += THREADS) {
        const int r = i / (C / 4), c4 = (i % (C / 4)) * 4;
        float4 vx = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + r < n)
          vx = *reinterpret_cast<const float4*>(v + static_cast<size_t>(k0 + r) * ld + C * oc + c4);
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
        if (ch > 0) {  // the next chunk of Q and K
          __syncthreads();
          load_rows(Qs, q, q0, BO, n, ld, C * ch);
          load_rows(Ks, k, k0, BT, n, ld, C * ch);
          __syncthreads();
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
        out[(base + q0 + row) * ld + C * oc + cx + 32 * j] = acc[r][j] * inv;
    }
    if (oc == 0 && tid < BO && q0 + tid < n)
      lse[base + q0 + tid] = m_s[tid] + logf(l_s[tid] + 1e-30f);
  }  // output chunks
}

// ---------------------------------------------------------------- backward
//
// Above C = 128 (the C = 128 kernel follows). One body for both kernels. The
// block owns BO rows and walks over tiles of BT rows of the other side:
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

template <bool DKV>
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
  const int chunks = ld / C;
  q += base * ld;
  k += base * ld;
  v += base * ld;
  d_out += base * ld;
  geom += base * GSTRIDE;
  lse += base;
  dvec += base;
  const float* a_own = DKV ? k : q;
  const float* b_own = DKV ? v : d_out;
  const float* a_tile = DKV ? q : k;
  const float* b_tile = DKV ? d_out : v;

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
      load_rows(Ao, a_own, o0, BO, n, ld, 0);
      load_rows(Bo, b_own, o0, BO, n, ld, 0);
      load_rows(At, a_tile, t0, BT, n, ld, 0);
      load_rows(Bt, b_tile, t0, BT, n, ld, 0);
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
        if (ch > 0) {  // the next chunk of the four tiles
          __syncthreads();
          load_rows(Ao, a_own, o0, BO, n, ld, C * ch);
          load_rows(Bo, b_own, o0, BO, n, ld, C * ch);
          load_rows(At, a_tile, t0, BT, n, ld, C * ch);
          load_rows(Bt, b_tile, t0, BT, n, ld, C * ch);
          __syncthreads();
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
      if (oc != chunks - 1) {  // the tile's output chunk (phase 1 left the last one)
        load_rows(At, a_tile, t0, BT, n, ld, C * oc);
        if (DKV) load_rows(Bt, b_tile, t0, BT, n, ld, C * oc);
        __syncthreads();
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
        const size_t at = (base + o0 + row) * ld + C * oc + cx + 32 * j;
        out_a[at] = acc_a[r][j];
        if (DKV) out_b[at] = acc_b[r][j];
      }
    }
  }  // output chunks
}

// ------------------------------------------------------- backward, C = 128
//
// The roles of the body above (A_own.A_tile = s, B_own.B_tile = dP; dQ or
// dK, dV summed over the tiles), laid out for the card's two limits: 128 FMAs
// and 128 bytes of shared memory a clock an SM. A warp's 128-bit load moves
// 512 bytes whatever it broadcasts, so a lane's m x n register tile of a
// product costs 4 (m + n) / (m n) shared-memory clocks per FMA clock: 8 x 8,
// at one, is the smallest tile whose loads keep pace with its FMAs.
// - A block of 8 warps owns OWN = 64 rows (half the L2 reads of the tile side
//   that 32-row owners make) and walks tiles of TILE = 32 rows.
// - Phase 1 (dP, then s): warp w takes own rows 8w .. 8w + 7 against the 32
//   tile rows. Lane (tg, kg) = (lane / 8, lane % 8) sums an 8 x 8 tile over
//   the channels of 16-byte units kg + 8i, own rows 8w + (r ^ kg) against
//   tile rows tg + 4t; three shuffle levels (xor 4, 2, 1) then leave each
//   lane the 8 whole sums of own row 8w + kg, with no select (the r ^ kg
//   order lines the halves up). Own rows are read by 8 lanes at once in
//   distinct bank groups at any row order, since the stages have no padding.
//   The lane then makes the compat entries (compat_entries: compat_geom.cuh's
//   bits, without branches), P and dlogits of its 8 pairs and stores them in
//   [TILE][OWN] stages, the owned rows contiguous.
// - Phase 2: a lane holds an 8 x 8 tile (8 owned rows, channels
//   4 (lane % 16) + {0..3} and 64 + the same). dK, dV: warps 0-3 sum dK, 4-7
//   dV. dQ: warps 0-3 sum the tile's rows 0-15, 4-7 rows 16-31, and the two
//   halves are added once at the end, in that order.
// - The owned rows (and in dQ their lse and D) are copied once; each tile's
//   two operands, its 9 geometry rows and in dK, dV its lse and D are
//   double-buffered: tile t + 1 is copied by cp.async (zero-filled past n)
//   while tile t is worked.
// - Every sum has one owner and a fixed order: the result is the same from
//   run to run.
// Shared memory: 142 KB (dQ), 151 KB (dK, dV): one block an SM.
// The copies and the phase-1 product are f32_tiles.cuh's, shared with the SM
// loss's kernels (sm_loss.cu).

namespace b128 {

constexpr int OWN = 64;
constexpr int TILE = 32;
constexpr int DS = OWN + 8;  // row of the [TILE][OWN] P and dlogits stages
constexpr int STAGES = 2;
constexpr int S_AO = 0;                             // [OWN][C]
constexpr int S_BO = S_AO + OWN * C;                // [OWN][C]
constexpr int S_AT = S_BO + OWN * C;                // [STAGES][TILE][C]
constexpr int S_BT = S_AT + STAGES * TILE * C;      // [STAGES][TILE][C]
constexpr int S_GO = S_BT + STAGES * TILE * C;      // [GROWS][OWN]
constexpr int S_GT = S_GO + GROWS * OWN;            // [STAGES][GROWS][TILE]
constexpr int S_ST = S_GT + STAGES * GROWS * TILE;  // lse, D: dQ [2][OWN], dK, dV [STAGES][2][TILE]
constexpr int S_DL = S_ST + 2 * OWN;                // [TILE][DS] dlogits
constexpr int S_PT = S_DL + TILE * DS;              // [TILE][DS] P (dK, dV only)
constexpr size_t BYTES_DQ = S_PT * sizeof(float);
constexpr size_t BYTES_DKV = (S_PT + TILE * DS) * sizeof(float);
static_assert(STAGES * 2 * TILE <= 2 * OWN, "statistics stage");
static_assert(S_GO % 4 == 0 && S_DL % 4 == 0 && S_PT % 4 == 0 && DS % 4 == 0,
              "16-byte aligned rows");
static_assert(OWN == 8 * (THREADS / 32) && TILE == 32 && C == 128, "the lane roles below");
// the forward's stages
constexpr int F_Q = 0;                               // [OWN][C]
constexpr int F_K = F_Q + OWN * C;                   // [STAGES][TILE][C]
constexpr int F_V = F_K + STAGES * TILE * C;         // [STAGES][TILE][C]
constexpr int F_GO = F_V + STAGES * TILE * C;        // [GROWS][OWN]
constexpr int F_GT = F_GO + GROWS * OWN;             // [STAGES][GROWS][TILE]
constexpr int F_P = F_GT + STAGES * GROWS * TILE;    // [TILE][DS] P
constexpr int F_ALPHA = F_P + TILE * DS;             // [OWN] the tile's rescale
constexpr int F_L = F_ALPHA + OWN;                   // [OWN] l, then m, at the end
constexpr int F_M = F_L + OWN;
constexpr size_t BYTES_FWD = (F_M + OWN) * sizeof(float);
static_assert(F_P % 4 == 0 && F_ALPHA % 4 == 0, "16-byte aligned rows");

using f32_tiles::copy_cols;
using f32_tiles::copy_rows;
using f32_tiles::cp_async_commit;
using f32_tiles::cp_async_wait_all;
using f32_tiles::ld4;
using f32_tiles::warp_rows_dot;
static_assert(f32_tiles::C == C && f32_tiles::THREADS == THREADS, "one layout");

// geo::pair_dist's argument of the square root, the same rounded operations
__device__ __forceinline__ float pair_d2(float ax, float ay, float az, float a2, float bx,
                                         float by, float bz, float b2) {
  const float inner =
      __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
  return fmaxf(__fsub_rn(__fadd_rn(a2, b2), __fmul_rn(2.0f, inner)), 0.0f);
}

// geo::compat_entry of own row i against tile rows tg + 4t (t = 0..7), the
// same bits without its branches, so that the 8 chains interleave: each
// square root by compat_tile.cuh's branch-free sequence of sqrtf (its
// argument 0, or in its range; else, rarely, compat_entry itself), and the
// division by sig2 as the double product with inv_sig2 = 1 / sig2 rounded to
// float. That rounding is the division's: the quotient of two floats lies
// at least 2^-49 of itself from a midpoint of two floats (a 25-bit
// significand), and the product errs by at most 2^-52 of it; a quotient
// below 2^-25, where that bound fails, leaves 1 - q = 1 either way.
__device__ __forceinline__ void compat_entries(const float* go, int i, const float* gt, int tg,
                                               float sig2, double inv_sig2, float (&out)[8]) {
  float o[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) o[r] = go[r * OWN + i];
  float s2[8], t2[8];
  bool rare = false;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int j = tg + 4 * t;
    s2[t] = pair_d2(o[0], o[1], o[2], o[3], gt[j], gt[TILE + j], gt[2 * TILE + j],
                    gt[3 * TILE + j]);
    t2[t] = pair_d2(o[4], o[5], o[6], o[7], gt[4 * TILE + j], gt[5 * TILE + j],
                    gt[6 * TILE + j], gt[7 * TILE + j]);
    rare |= (s2[t] != 0.0f && !compat::in_sqrt_range(s2[t])) ||
            (t2[t] != 0.0f && !compat::in_sqrt_range(t2[t]));
  }
  if (rare) {
#pragma unroll
    for (int t = 0; t < 8; ++t) out[t] = geo::compat_entry<OWN, TILE>(go, i, gt, tg + 4 * t, sig2);
    return;
  }
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const float ds = s2[t] > 0.0f ? compat::sqrt_in_range(s2[t]) : 0.0f;
    const float dt = t2[t] > 0.0f ? compat::sqrt_in_range(t2[t]) : 0.0f;
    const float diff = __fsub_rn(ds, dt);
    const float q = __double2float_rn(__dmul_rn(__fmul_rn(diff, diff), inv_sig2));
    out[t] = fmaxf(__fsub_rn(1.0f, q), 0.0f);
  }
}

}  // namespace b128

template <bool DKV>
__global__ void __launch_bounds__(THREADS, 1)
sc_attention_bwd128_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ d_out,
                           const float* __restrict__ geom, const float* __restrict__ lse,
                           const float* __restrict__ dvec, float* __restrict__ out_a,
                           float* __restrict__ out_b, int n, float sig2, float scale) {
  using namespace b128;
  extern __shared__ __align__(16) float smem[];
  const float* Go = smem + S_GO;
  float* St = smem + S_ST;
  float* DL = smem + S_DL;
  float* PT = smem + S_PT;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y;
  const int o0 = blockIdx.x * OWN;
  const size_t base = static_cast<size_t>(b) * n;
  q += base * C;
  k += base * C;
  v += base * C;
  d_out += base * C;
  geom += base * GSTRIDE;
  lse += base;
  dvec += base;
  const float* a_own = DKV ? k : q;
  const float* b_own = DKV ? v : d_out;
  const float* a_tile = DKV ? q : k;
  const float* b_tile = DKV ? d_out : v;
  const double inv_sig2 = 1.0 / static_cast<double>(sig2);

  auto issue_tile = [&](int t0, int st) {
    copy_rows<TILE>(smem + S_AT + st * TILE * C, a_tile, t0, n);
    copy_rows<TILE>(smem + S_BT + st * TILE * C, b_tile, t0, n);
    copy_cols<TILE>(smem + S_GT + st * GROWS * TILE, geom, GROWS, t0, n);
    if (DKV) {  // the statistics belong to the queries
      copy_cols<TILE>(St + st * 2 * TILE, lse, 1, t0, n);
      copy_cols<TILE>(St + st * 2 * TILE + TILE, dvec, 1, t0, n);
    }
    cp_async_commit();
  };
  copy_rows<OWN>(smem + S_AO, a_own, o0, n);
  copy_rows<OWN>(smem + S_BO, b_own, o0, n);
  copy_cols<OWN>(smem + S_GO, geom, GROWS, o0, n);
  if (!DKV) {  // lse and D of owned rows past n read as 0
    copy_cols<OWN>(St, lse, 1, o0, n);
    copy_cols<OWN>(St + OWN, dvec, 1, o0, n);
  }
  issue_tile(0, 0);  // one group with the owned rows

  const int kg = lane & 7, tg = lane >> 3;  // phase 1
  const int ro = 8 * warp + kg;             //   own row of the lane's whole sums
  const int half = warp >> 2;               // phase 2
  const int rp = 16 * (warp & 3) + 8 * (lane >> 4);  // own rows rp .. rp + 7
  const int cq = 4 * (lane & 15);           //   channels cq + {0..3}, 64 + cq + {0..3}

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  const int tiles = (n + TILE - 1) / TILE;
  for (int t = 0; t < tiles; ++t) {
    const int st = t & 1, t0 = t * TILE;
    cp_async_wait_all();
    __syncthreads();  // tile t has landed; phase 2 of tile t - 1 is done
    if (t + 1 < tiles) issue_tile(t0 + TILE, st ^ 1);
    const float* At = smem + S_AT + st * TILE * C;
    const float* Bt = smem + S_BT + st * TILE * C;
    const float* Gt = smem + S_GT + st * GROWS * TILE;
    const float* lse_s = DKV ? St + st * 2 * TILE : St;
    const float* d_s = lse_s + (DKV ? TILE : OWN);

    // ---- phase 1: dP, then s, of own row ro against tile rows tg + 4 j
    float dp[8], s[8], compat[8];
    warp_rows_dot(smem + S_BO + 8 * warp * C, Bt, kg, tg, dp);
    warp_rows_dot(smem + S_AO + 8 * warp * C, At, kg, tg, s);
    compat_entries(Go, ro, Gt, tg, sig2, inv_sig2, compat);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tg + 4 * j;
      const float bias = DKV ? Go[8 * OWN + ro] : Gt[8 * TILE + col];
      const int stat = DKV ? col : ro;
      float p = expf(compat[j] * (s[j] * scale) + bias - lse_s[stat]);
      if (t0 + col >= n) p = 0.f;
      DL[col * DS + ro] = p * (dp[j] - d_s[stat]) * compat[j] * scale;
      if (DKV) PT[col * DS + ro] = p;
    }
    __syncthreads();  // P and dlogits of the whole tile

    // ---- phase 2: own rows rp .. rp + 7 against the tile's rows:
    // dK, dV: dlogits.Q (warps 0-3) or P.dO (4-7) over all 32;
    // dQ: dlogits.K over rows 16 half .. 16 half + 15
    const float* w_s = DKV && half ? PT : DL;
    const float* x_s = DKV && half ? Bt : At;
    const int j0 = DKV ? 0 : 16 * half;
#pragma unroll 16
    for (int jj = 0; jj < (DKV ? TILE : TILE / 2); ++jj) {
      const int j = j0 + jj;
      const float4 d0 = ld4(w_s + j * DS + rp), d1 = ld4(w_s + j * DS + rp + 4);
      const float4 x0 = ld4(x_s + j * C + cq), x1 = ld4(x_s + j * C + 64 + cq);
      const float d[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
      const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(d[r], x[c], acc[r][c]);
    }
  }

  float* out = DKV && half ? out_b : out_a;
  if (!DKV) {  // dQ: the second half's sums join the first's through the owned A stage
    float* part = smem + S_AO;
    __syncthreads();  // every warp is past its last phase 2
    if (half) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        *reinterpret_cast<float4*>(part + (rp + r) * C + cq) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        *reinterpret_cast<float4*>(part + (rp + r) * C + 64 + cq) =
            make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
      }
    }
    __syncthreads();
    if (half) return;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float4 y0 = ld4(part + (rp + r) * C + cq), y1 = ld4(part + (rp + r) * C + 64 + cq);
      const float y[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] += y[c];
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = rp + r;
    if (o0 + row >= n) continue;
    float* o = out + (base + o0 + row) * C;
    *reinterpret_cast<float4*>(o + cq) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    *reinterpret_cast<float4*>(o + 64 + cq) =
        make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
  }
}

// ------------------------------------------------------- forward, C = 128
//
// The C = 128 backward's layout on the forward (the same helpers): a block
// of 8 warps owns OWN = 64 query rows, copied once with their 9 geometry
// rows; K, V and each tile's 9 geometry rows (row 8: the key bias) are
// double-buffered by cp.async in tiles of TILE = 32 rows.
// - Phase 1: warp_rows_dot gives lane (tg, kg) q.k of own row 8w + kg
//   against tile rows tg + 4t; compat_entries their compat bits.
//   s = compat * (q.k * scale) + bias, -inf past n (a padded key within n
//   has bias -1e9, as in the plain version). The row's tile maximum and the
//   sum of exp(s - m_new) over its 32 keys are reduced across its four tg
//   lanes by xor shuffles (8, then 16); each lane adds the same two terms at
//   each level, so all four hold the same m and l. P goes to a [TILE][OWN]
//   stage, alpha = exp(m_old - m_new) of each own row to shared memory.
// - Phase 2: a lane holds an 8 x 8 tile of the output (own rows rp .. rp + 7,
//   channels cq + {0..3} and 64 + the same); warps 0-3 sum the tile's rows
//   0-15, warps 4-7 rows 16-31, each half rescaled by the same alpha every
//   tile; the halves are added once at the end, in that order.
// - Epilogue: out = acc * (1 / (l + 1e-30)), lse = m + log(l + 1e-30). Every sum
//   has one owner and a fixed order: the result is the same from run to run.
// Shared memory: 113 KB; one block an SM (the registers).

__global__ void __launch_bounds__(THREADS, 1)
sc_attention_fwd128_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ geom,
                           float* __restrict__ out, float* __restrict__ lse, int n, float sig2,
                           float scale) {
  using namespace b128;
  extern __shared__ __align__(16) float smem[];
  const float* Go = smem + F_GO;
  float* P = smem + F_P;
  float* alpha_s = smem + F_ALPHA;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y;
  const int o0 = blockIdx.x * OWN;
  const size_t base = static_cast<size_t>(b) * n;
  q += base * C;
  k += base * C;
  v += base * C;
  geom += base * GSTRIDE;
  const double inv_sig2 = 1.0 / static_cast<double>(sig2);

  auto issue_tile = [&](int t0, int st) {
    copy_rows<TILE>(smem + F_K + st * TILE * C, k, t0, n);
    copy_rows<TILE>(smem + F_V + st * TILE * C, v, t0, n);
    copy_cols<TILE>(smem + F_GT + st * GROWS * TILE, geom, GROWS, t0, n);
    cp_async_commit();
  };
  copy_rows<OWN>(smem + F_Q, q, o0, n);
  copy_cols<OWN>(smem + F_GO, geom, GROWS, o0, n);
  issue_tile(0, 0);  // one group with the owned rows

  const int kg = lane & 7, tg = lane >> 3;  // phase 1
  const int ro = 8 * warp + kg;             //   own row of the lane's logits
  const int half = warp >> 2;               // phase 2
  const int rp = 16 * (warp & 3) + 8 * (lane >> 4);  // own rows rp .. rp + 7
  const int cq = 4 * (lane & 15);           //   channels cq + {0..3}, 64 + cq + {0..3}

  float m_row = NEG, l_row = 0.f;  // own row ro's softmax state
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  const int tiles = (n + TILE - 1) / TILE;
  for (int t = 0; t < tiles; ++t) {
    const int st = t & 1, t0 = t * TILE;
    cp_async_wait_all();
    __syncthreads();  // tile t has landed; phase 2 of tile t - 1 is done
    if (t + 1 < tiles) issue_tile(t0 + TILE, st ^ 1);
    const float* Kt = smem + F_K + st * TILE * C;
    const float* Vt = smem + F_V + st * TILE * C;
    const float* Gt = smem + F_GT + st * GROWS * TILE;

    // ---- phase 1: s of own row ro against tile rows tg + 4 j, the softmax state
    float s[8], compat[8];
    warp_rows_dot(smem + F_Q + 8 * warp * C, Kt, kg, tg, s);
    compat_entries(Go, ro, Gt, tg, sig2, inv_sig2, compat);
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tg + 4 * j;
      s[j] = compat[j] * (s[j] * scale) + Gt[8 * TILE + col];
      if (t0 + col >= n) s[j] = -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
    const float m_new = fmaxf(m_row, mx);
    const float alpha = expf(m_row - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p = expf(s[j] - m_new);
      P[(tg + 4 * j) * DS + ro] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 8);
    sum += __shfl_xor_sync(0xffffffffu, sum, 16);
    l_row = l_row * alpha + sum;
    m_row = m_new;
    if (tg == 0) alpha_s[ro] = alpha;
    __syncthreads();  // P and alpha of the whole tile

    // ---- phase 2: acc = acc * alpha + P V over the half's 16 tile rows
    const float4 a0 = ld4(alpha_s + rp), a1 = ld4(alpha_s + rp + 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] *= a[r];
#pragma unroll 16
    for (int jj = 0; jj < TILE / 2; ++jj) {
      const int j = 16 * half + jj;
      const float4 p0 = ld4(P + j * DS + rp), p1 = ld4(P + j * DS + rp + 4);
      const float4 x0 = ld4(Vt + j * C + cq), x1 = ld4(Vt + j * C + 64 + cq);
      const float p[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(p[r], x[c], acc[r][c]);
    }
  }

  // the second half's sums join the first's through the owned Q stage
  float* part = smem + F_Q;
  if (tg == 0) {
    smem[F_L + ro] = l_row;
    smem[F_M + ro] = m_row;
  }
  __syncthreads();  // every warp is past its last phase 2
  if (half) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      *reinterpret_cast<float4*>(part + (rp + r) * C + cq) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      *reinterpret_cast<float4*>(part + (rp + r) * C + 64 + cq) =
          make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
  }
  __syncthreads();
  if (half) return;
  if (tid < OWN && o0 + tid < n)
    lse[base + o0 + tid] = smem[F_M + tid] + logf(smem[F_L + tid] + 1e-30f);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = rp + r;
    if (o0 + row >= n) continue;
    const float4 y0 = ld4(part + row * C + cq), y1 = ld4(part + row * C + 64 + cq);
    const float inv = 1.0f / (smem[F_L + row] + 1e-30f);
    float* o = out + (base + o0 + row) * C;
    *reinterpret_cast<float4*>(o + cq) =
        make_float4((acc[r][0] + y0.x) * inv, (acc[r][1] + y0.y) * inv,
                    (acc[r][2] + y0.z) * inv, (acc[r][3] + y0.w) * inv);
    *reinterpret_cast<float4*>(o + 64 + cq) =
        make_float4((acc[r][4] + y1.x) * inv, (acc[r][5] + y1.y) * inv,
                    (acc[r][6] + y1.z) * inv, (acc[r][7] + y1.w) * inv);
  }
}

int launch_fwd128(const void* q, const void* k, const void* v, const void* geom, void* out,
                  void* lse, int batch, int n, float sig2, float scale, void* stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(sc_attention_fwd128_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(b128::BYTES_FWD));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + b128::OWN - 1) / b128::OWN, batch);
  sc_attention_fwd128_kernel<<<grid, THREADS, b128::BYTES_FWD,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(geom), static_cast<float*>(out), static_cast<float*>(lse), n,
      sig2, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool DKV>
int launch_bwd128(const void* q, const void* k, const void* v, const void* d_out,
                  const void* geom, const void* lse, const void* dvec, void* out_a, void* out_b,
                  int batch, int n, float sig2, float scale, void* stream) {
  const size_t bytes = DKV ? b128::BYTES_DKV : b128::BYTES_DQ;
  const cudaError_t err =
      cudaFuncSetAttribute(sc_attention_bwd128_kernel<DKV>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + b128::OWN - 1) / b128::OWN, batch);
  sc_attention_bwd128_kernel<DKV><<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(d_out), static_cast<const float*>(geom),
      static_cast<const float*>(lse), static_cast<const float*>(dvec),
      static_cast<float*>(out_a), static_cast<float*>(out_b), n, sig2, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool DKV>
int launch_bwd(const void* q, const void* k, const void* v, const void* d_out, const void* geom,
               const void* lse, const void* dvec, void* out_a, void* out_b, int batch, int n,
               int ld, float sig2, float scale, void* stream) {
  const size_t bytes = DKV ? B_SMEM_BYTES_DKV : B_SMEM_BYTES_DQ;
  const cudaError_t err =
      cudaFuncSetAttribute(sc_attention_bwd_kernel<DKV>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BO - 1) / BO, batch);
  sc_attention_bwd_kernel<DKV><<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(d_out), static_cast<const float*>(geom),
      static_cast<const float*>(lse), static_cast<const float*>(dvec),
      static_cast<float*>(out_a), static_cast<float*>(out_b), n, sig2, scale, ld);
  return static_cast<int>(cudaGetLastError());
}

int launch_fwd(const void* q, const void* k, const void* v, const void* geom, void* out,
               void* lse, int batch, int n, int ld, float sig2, float scale, void* stream) {
  // per call: the attribute belongs to the current device
  const cudaError_t err =
      cudaFuncSetAttribute(sc_attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(F_SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BO - 1) / BO, batch);
  sc_attention_fwd_kernel<<<grid, THREADS, F_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
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
  return ld == C ? launch_fwd128(q, k, v, geom, out, lse, batch, n, sig2, scale, stream)
                 : launch_fwd(q, k, v, geom, out, lse, batch, n, ld, sig2, scale, stream);
}

extern "C" int sc_attention_train_bwd_dq(const void* q, const void* k, const void* v,
                                         const void* d_out, const void* geom, const void* lse,
                                         const void* dvec, void* dq, int batch, int n, int ld,
                                         float sig2, float scale, void* stream) {
  if (ld < C || ld % C) return static_cast<int>(cudaErrorInvalidValue);
  return ld == C ? launch_bwd128<false>(q, k, v, d_out, geom, lse, dvec, dq, nullptr, batch, n,
                                        sig2, scale, stream)
                 : launch_bwd<false>(q, k, v, d_out, geom, lse, dvec, dq, nullptr, batch,
                                           n, ld, sig2, scale, stream);
}

extern "C" int sc_attention_train_bwd_dkv(const void* q, const void* k, const void* v,
                                          const void* d_out, const void* geom, const void* lse,
                                          const void* dvec, void* dk, void* dv, int batch, int n,
                                          int ld, float sig2, float scale, void* stream) {
  if (ld < C || ld % C) return static_cast<int>(cudaErrorInvalidValue);
  return ld == C ? launch_bwd128<true>(q, k, v, d_out, geom, lse, dvec, dk, dv, batch, n, sig2,
                                       scale, stream)
                 : launch_bwd<true>(q, k, v, d_out, geom, lse, dvec, dk, dv, batch, n, ld,
                                          sig2, scale, stream);
}
