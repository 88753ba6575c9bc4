// Spatial-consistency attention on the tensor cores: the device function
// shared by the attention kernels (sc_attention.cu; over the int8 cache, or
// without one) and the whole-encoder-layer kernels (encoder_layer.cu), as the JAX package
// shares _offset_attn_p (pointdsc_tpu/kernels/encoder_layer.py:59) between
// its kernels: _make_kernel (:109), _make_attn_mlp_kernel (:326) and
// _sc_attention_cached_offset_kernel (pointdsc_tpu/kernels/sc_attention.py:472).
// Its running-max form is _sc_attention_cached_kernel (sc_attention.py:417)
// for wider models (C > 128) and row shards, and, with the geometry as its
// compat source, _sc_attention_kernel (:82). The square running-max cached
// call at C = 128 does not run it: sc_attention_cached.cu has its own kernel.
//
// Offset softmax (attention_rows<false>, the default):
//   o_i  = ||q_i|| * kscale               kscale = max_j ||k_j|| / sqrt(C)
//   p_ij = exp(max(compat_ij * (q_i.k_j * scale) + bias_j - o_i, -80))
//   p_ij = 0 where bias_j < 0             (only when a bias row is given)
//   l_i  = sum_j p_ij                     (f32, before any rounding of p)
//   acc_i = sum_j bf16(p_ij) v_j          q, k, v are bf16
// The offset bounds every logit from above, so no running max, no rescale of
// the accumulator and no max pass are needed.
//
// Running max (attention_rows<true>), exact for any weights:
//   s_ij = compat_ij * (q_i.k_j * scale) + bias_j      (-inf past the last key)
//   per key tile: m' = max(m, max_j s_ij), alpha = exp(m - m'),
//   l = l alpha + sum_j p_ij, acc = acc alpha + sum_j bf16(p_ij) v_j,
//   p_ij = exp(s_ij - m'), m starting at -1e9 as on the TPU. Masked keys keep
//   their -1e9 bias and no p = 0 override, as in the TPU kernel.
//
// A block owns 32 query rows and walks all key tiles of 64 rows.
//
// Compat source (a template parameter):
//   kCacheInt8: compat_ij = the cache's byte; the 1/127 decode is folded into
//     the caller's qk scale. Each lane reads its own eight bytes at its
//     fragment positions straight into registers, a tile ahead.
//   kGeometry (running max only; the no-cache eval attention): compat_ij is
//     computed in f32 from the pair's packed [16, n] geometry strip by
//     compat_geom.cuh's entry, the operations the plain version writes out,
//     so both see the same compat bits. The query rows' strip (rows 0-7) is
//     staged once and the key tile's (rows 0-7) with K and V, a tile ahead;
//     the key bias is row 8 of the same strip, passed as the bias row.
//     Per lane and tile that is eight entries of two distances (a sqrt each)
//     and an IEEE division, in place of eight byte loads. A lane computes its
//     entries before Q K^T and keeps them in its own shared-memory slots
//     behind the bf16 K tile: computed beside the live logit fragments they
//     cost the loop a register spill under its 128-register limit.
//
// What bounds it on an H100, per pair of N keys: the two N^2 C products
// (4 N^2 C operations on bf16 operands, 989 TFLOP/s on the tensor cores:
// 14 us at N = 5120, 77 us at N = 12288), the N^2 int8 compat stream (read
// once: 8 us / 45 us at 3.35 TB/s), and, a cost of the 32-row block rather
// than of the function, K and V re-read by every block (N / 32 blocks x
// 4 N C bytes: 0.42 GB at N = 5120, 2.4 GB at N = 12288, which the 50 MB L2
// serves). What the design does about each:
//
// - Both products run on the tensor cores as warp-level
//   mma.sync.m16n8k16 (bf16 x bf16 -> f32), exact products summed in f32 as
//   the TPU's MXU sums them. Q, K and V stay bf16 in shared memory, rows
//   padded to 136 values (272 bytes) so that the eight rows an ldmatrix
//   phase reads fall in eight different 16-byte bank groups. The 8 warps
//   split the 32 x 64 logit tile as 2 x 4 tiles of 16 x 16 (two n8 tiles each,
//   8 k-steps over the channels), and the 32 x 128 output as 2 x 4 tiles of
//   16 rows x 32 channels (four n8 tiles, 4 k-steps over the keys). A is
//   loaded with ldmatrix.x4, K (Kt in column order) with ldmatrix.x4, V (the
//   k x n operand, row-major) with ldmatrix.x4.trans.
// - The softmax epilogue runs on the logit fragments in registers: a lane
//   holds rows lane/4 and lane/4 + 8 and columns 2 (lane % 4) + {0, 1} of its
//   warp's two n8 tiles, reads its own eight compat bytes from device memory
//   (fetched a tile ahead), and keeps f32 row partials of p that a quad
//   shuffle and one pass through shared memory reduce after the last tile.
//   p is rounded to bf16 into a 32 x 64 tile (rows padded to 72) for P V.
// - The running max is taken on the fragments too: a quad shuffle gives each
//   warp's maximum over its 16 columns of a row, the four column warps'
//   maxima of a row meet in the compat region (unused by the loop) after one
//   more barrier, and every warp of a row then computes the same m' and
//   alpha and rescales its own output fragments and row partials of l. The
//   offset form has neither the barrier nor the rescale.
// - The next tile's K, V, compat and bias are loaded into registers before
//   P V runs, so the loads are in flight during the second product; they are
//   stored to shared memory after the barrier that ends it.
// - The compat region (OFF_C, BQ x BK floats) is not a compat tile: the
//   int8 source reads its bytes into registers. It holds the running max's
//   row maxima and, after the loop, the row partials of l (4 x BQ floats),
//   and beside them the geometry source's two strips (8 x BQ and 8 x BK).
//   The K region, sized for padded f32 rows, holds the bf16 K tile in its
//   first half; the geometry source's per-lane entries sit in the rest.
// - The 32-row block keeps the K and V re-reads (the L2 floor above) and
//   two blocks per SM (99 KB of shared memory each, __launch_bounds__(256, 2):
//   at most 128 registers a thread); a larger block is later work.
//
// Wider models (kWide): q, k and v are [n, ld] with ld = 128 m, the
// model's channels zero-padded to m chunks of 128 (zero channels add exact
// zeros). A call computes output chunk oc: every key tile's logits are
// summed over the m chunks of Q and K, staged into the same Q and K tiles
// one chunk at a time, and P V reads V's chunk oc. The caller makes m calls,
// one per output chunk; each sees the same logits (the chunks summed in one
// order), offsets, running maxima and l, so the chunks of a row are those of
// one softmax. That is m^2 Q K^T products a tile where one width pass has
// one: the cost of widths no shipped model has. The wide form stages its
// tiles straight from device memory (no register prefetch), and the offset
// form takes ||q_i|| over all ld channels from device memory.
//
// The callers' layout is kept: after the last tile the accumulators go
// through the (then unused) Q region as a 32 x CP f32 tile into acc[4][4],
// and the shared-memory arena (OFF_*, SMEM_FLOATS) is the one the callers'
// static_asserts and epilogues were written for. No -use_fast_math:
// exp(-80) must not flush.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "compat_geom.cuh"

namespace oa {

// where a tile's compat entries come from (see the notes above)
enum CompatSource { kCacheInt8, kGeometry };

constexpr int C = 128;  // a narrower model is zero-padded to it by the wrapper
constexpr int BQ = 32;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int CP = C + 1;   // padded f32 row of the callers' tiles
constexpr int PP = BK + 1;  // f32 row of the P region
constexpr int RB = C + 8;   // bf16 row of the Q, K and V tiles (272 bytes)
constexpr int PB = BK + 8;  // bf16 row of the P tile (144 bytes)
constexpr float NEG = -1e9f;  // the running max's start, the TPU kernel's _NEG

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
// inside the compat region: the row maxima / partials, then the geometry
// source's query strip [8][BQ] and key strip [8][BK]
constexpr int GEOM_ROWS = 8;
constexpr int OFF_GQ = OFF_C + 4 * BQ;
constexpr int OFF_GK = OFF_GQ + GEOM_ROWS * BQ;
// the geometry source's eight entries per lane and tile, [8][THREADS], in the
// K region's tail, which the bf16 K tile leaves unused
constexpr int OFF_CT = OFF_K + BK * RB / 2;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

static_assert(BK * RB * 2 <= BK * C * 4, "the bf16 V tile must fit the V region");
static_assert(BK * RB * 2 <= BK * CP * 4, "the bf16 K tile must fit the K region");
static_assert(BQ * RB * 2 <= BQ * CP * 4, "the bf16 Q tile must fit the Q region");
static_assert(BQ * PB * 2 <= BQ * PP * 4, "the bf16 P tile must fit the P region");
static_assert(OFF_GK + GEOM_ROWS * BK <= OFF_C + BQ * BK,
              "the row partials, maxima and geometry strips must fit the compat region");
static_assert(OFF_CT + 8 * THREADS <= OFF_K + BK * CP,
              "the staged compat entries must fit behind the bf16 K tile");
static_assert((OFF_K * 4) % 16 == 0 && (OFF_Q * 4) % 16 == 0 && (OFF_P * 4) % 16 == 0 &&
                  (RB * 2) % 16 == 0 && (PB * 2) % 16 == 0,
              "ldmatrix and the 16-byte stores need 16-byte aligned rows");

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

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ inline void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ inline void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b for a 16 x 16 bf16 A (row) and a 16 x 8 bf16 B (column), f32 d
__device__ inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(d[0]), "f"(d[1]),
        "f"(d[2]), "f"(d[3]));
}

// Attention of query rows [q0, q0 + BQ) of one pair over all n keys.
// q, k, v [n, C] bf16 (16-byte aligned), compat [n, n] int8, bias [n] or nullptr.
// kRunningMax: the running max instead of the offset (kscale is not read).
// kSrc == kGeometry: compat is not read; geom is the pair's [16, n] strip,
// sig2 = sigma_d^2, and bias its row 8.
// On return acc[r][j] holds the unnormalised output of row 4 * (tid >> 5) + r,
// channel (tid & 31) + 32 * j, and smem[OFF_L + row] the row's sum of p; the
// block is synchronised, so the caller may reuse the V, K, Q, P and compat
// regions.
// kWide: q, k, v are [n, ld] (ld a multiple of C) and acc holds output chunk
// oc, channels C oc + (tid & 31) + 32 j (see the notes above).
// kRect: q holds nq_arg query rows (a row shard of the sequence-parallel
// encoder) over the n keys of k and v; compat is then [nq_arg, n], its row
// stride n. Without it the query rows are the n keys' own (nq = n, the
// square calls, whose code the flag leaves as it was).
template <bool kRunningMax = false, CompatSource kSrc = kCacheInt8, bool kWide = false,
          bool kRect = false>
__device__ void attention_rows(const __nv_bfloat16* q, const __nv_bfloat16* k,
                               const __nv_bfloat16* v, const int8_t* compat, const float* bias,
                               float kscale, int n, int q0, float qk_scale, float* smem,
                               float (&acc)[4][4], const float* geom = nullptr,
                               float sig2 = 0.f, int ld = C, int oc = 0, int nq_arg = 0) {
  static_assert(kRunningMax || kSrc == kCacheInt8, "the offset form reads the int8 cache");
  static_assert(!kRect || kSrc == kCacheInt8, "a row shard streams its cache slice");
  const int nq = kRect ? nq_arg : n;  // query rows
  __nv_bfloat16* Vb = reinterpret_cast<__nv_bfloat16*>(smem + OFF_V);
  __nv_bfloat16* Kb = reinterpret_cast<__nv_bfloat16*>(smem + OFF_K);
  __nv_bfloat16* Qb = reinterpret_cast<__nv_bfloat16*>(smem + OFF_Q);
  __nv_bfloat16* Pb = reinterpret_cast<__nv_bfloat16*>(smem + OFF_P);
  float* l_part = smem + OFF_C;  // [4][BQ] row partials of the four column warps
  float* m_part = smem + OFF_C;  // [4][BQ] a tile's row maxima of the four column warps
  float* bias_s = smem + OFF_BIAS;
  float* offs_s = smem + OFF_OFFS;
  float* l_s = smem + OFF_L;
  float* gq_s = smem + OFF_GQ;
  float* gk_s = smem + OFF_GK;
  float* ct_s = smem + OFF_CT;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  // mma tiles: warp rows [16 mi, 16 mi + 16); logit columns [16 nj, 16 nj + 16),
  // output channels [32 nj, 32 nj + 32). A lane's fragment rows are r0, r0 + 8.
  const int mi = warp >> 2, nj = warp & 3;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = 16 * mi + g;
  const bool has_bias = bias != nullptr;

  // rows [row0, row0 + rows) of chunk ch of a [bound, ld] array into a bf16
  // tile (wide form)
  auto stage_chunk = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, int row0, int rows,
                         int ch, int bound) {
    for (int i = tid; i < rows * C / 8; i += THREADS) {
      const int r = i / (C / 8), c8 = (i % (C / 8)) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < bound)
        x = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * ld + C * ch +
                                            c8);
      *reinterpret_cast<uint4*>(dst + r * RB + c8) = x;
    }
  };
  const int chunks = kWide ? ld / C : 1;

  __syncthreads();  // whoever used the shared memory before is done
  if constexpr (!kWide) {
    for (int i = tid; i < BQ * C / 8; i += THREADS) {
      const int r = i / (C / 8), c8 = (i % (C / 8)) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < nq)
        x = *reinterpret_cast<const uint4*>(q + static_cast<size_t>(q0 + r) * C + c8);
      *reinterpret_cast<uint4*>(Qb + r * RB + c8) = x;
    }
  }
  if constexpr (kSrc == kGeometry) {
    for (int i = tid; i < GEOM_ROWS * BQ; i += THREADS) {
      const int r = i / BQ, c = i % BQ;
      gq_s[i] = (q0 + c < nq) ? geom[static_cast<size_t>(r) * n + q0 + c] : 0.f;
    }
  }
  __syncthreads();

  // per-row offset ||q_i|| * kscale: a warp owns four rows
  if constexpr (!kRunningMax) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 4 * warp + r;
      float sq = 0.f;
      if constexpr (kWide) {
        if (q0 + row < nq)
          for (int j = 0; j < ld / 32; ++j) {
            const float x = __bfloat162float(q[static_cast<size_t>(q0 + row) * ld + lane + 32 * j]);
            sq = fmaf(x, x, sq);
          }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x = __bfloat162float(Qb[row * RB + lane + 32 * j]);
          sq = fmaf(x, x, sq);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
      if (lane == 0) offs_s[row] = sqrtf(sq) * kscale;
    }
  }

  // A tile's loads, staged through registers: K and V as 16-byte chunks, the
  // lane's own compat bytes at its fragment positions (or the key tile's
  // geometry strip), and the bias row.
  constexpr int KV_ITERS = BK * C / 8 / THREADS;
  constexpr int G_ITERS = GEOM_ROWS * BK / THREADS;
  uint4 kreg[KV_ITERS], vreg[KV_ITERS];
  int8_t creg[2][4];
  float greg[G_ITERS];
  float bias_reg;
  auto fetch = [&](int k0) {
#pragma unroll
    for (int it = 0; it < KV_ITERS; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / (C / 8), c8 = (i % (C / 8)) * 8;
      if (k0 + r < n) {
        const size_t at = static_cast<size_t>(k0 + r) * C + c8;
        kreg[it] = *reinterpret_cast<const uint4*>(k + at);
        vreg[it] = *reinterpret_cast<const uint4*>(v + at);
      } else {
        kreg[it] = make_uint4(0u, 0u, 0u, 0u);
        vreg[it] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    if constexpr (kSrc == kGeometry) {
#pragma unroll
      for (int it = 0; it < G_ITERS; ++it) {
        const int i = tid + it * THREADS;
        const int r = i / BK, c = i % BK;
        greg[it] = (k0 + c < n) ? geom[static_cast<size_t>(r) * n + k0 + c] : 0.f;
      }
    } else {
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + 8 * (e >> 1), col = 16 * nj + 8 * t + 2 * tq + (e & 1);
          creg[t][e] = (q0 + row < nq && k0 + col < n)
                           ? compat[static_cast<size_t>(q0 + row) * n + k0 + col] : int8_t(0);
        }
    }
    bias_reg = (has_bias && tid < BK && k0 + tid < n) ? bias[k0 + tid] : 0.f;
  };
  // the wide form's compat bytes of a tile (it stages the rest directly)
  auto fetch_compat = [&](int k0) {
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + 8 * (e >> 1), col = 16 * nj + 8 * t + 2 * tq + (e & 1);
        creg[t][e] = (q0 + row < nq && k0 + col < n)
                         ? compat[static_cast<size_t>(q0 + row) * n + k0 + col] : int8_t(0);
      }
  };

  // ldmatrix addresses of this lane at k-step 0 (bytes in the shared window)
  const uint32_t q_addr = smem_addr(Qb + (16 * mi + (lane & 15)) * RB + 8 * (lane >> 4));
  const uint32_t k_addr =
      smem_addr(Kb + (16 * nj + (lane & 7) + 8 * (lane >> 4)) * RB + 8 * ((lane >> 3) & 1));
  const uint32_t p_addr = smem_addr(Pb + (16 * mi + (lane & 15)) * PB + 8 * (lane >> 4));
  const uint32_t v_addr =
      smem_addr(Vb + ((lane & 7) + 8 * ((lane >> 3) & 1)) * RB + 32 * nj + 8 * (lane >> 4));

  float o[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float l_row[2] = {0.f, 0.f};
  float m_row[2] = {NEG, NEG};  // the running max of rows r0, r0 + 8

  if constexpr (!kWide) fetch(0);
  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // the previous tile's P V is done; offs_s is visible
    if constexpr (kWide) {
      // chunk 0 of Q and K, V's chunk oc, the bias and the key strip, direct
      stage_chunk(Qb, q, q0, BQ, 0, nq);
      stage_chunk(Kb, k, k0, BK, 0, n);
      stage_chunk(Vb, v, k0, BK, oc, n);
      if (tid < BK) bias_s[tid] = (has_bias && k0 + tid < n) ? bias[k0 + tid] : 0.f;
      if constexpr (kSrc == kGeometry) {
        for (int i = tid; i < GEOM_ROWS * BK; i += THREADS) {
          const int r = i / BK, c = i % BK;
          gk_s[i] = (k0 + c < n) ? geom[static_cast<size_t>(r) * n + k0 + c] : 0.f;
        }
      } else {
        fetch_compat(k0);
      }
    } else {
#pragma unroll
      for (int it = 0; it < KV_ITERS; ++it) {
        const int i = tid + it * THREADS;
        const int r = i / (C / 8), c8 = (i % (C / 8)) * 8;
        *reinterpret_cast<uint4*>(Kb + r * RB + c8) = kreg[it];
        *reinterpret_cast<uint4*>(Vb + r * RB + c8) = vreg[it];
      }
      if (tid < BK) bias_s[tid] = bias_reg;
      if constexpr (kSrc == kGeometry) {
#pragma unroll
        for (int it = 0; it < G_ITERS; ++it) gk_s[tid + it * THREADS] = greg[it];
      }
    }
    __syncthreads();

    if constexpr (kSrc == kGeometry) {
      // this lane's eight compat entries, a fragment row at a time, into its
      // own slots: computed before Q K^T so that the logit fragments are not
      // yet live (read back by this thread alone, so no barrier)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            ct_s[(4 * h + 2 * t + c) * THREADS + tid] = geo::compat_entry<BQ, BK>(
                gq_s, r0 + 8 * h, gk_s, 16 * nj + 8 * t + 2 * tq + c, sig2);
    }

    // ---- S = Q K^T on this warp's 16 x 16 tile
    float s[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
    for (int ch = 0; ch < chunks; ++ch) {
      if constexpr (kWide) {
        if (ch > 0) {  // the next chunk of Q and K, once every warp is done with this one
          __syncthreads();
          stage_chunk(Qb, q, q0, BQ, ch, nq);
          stage_chunk(Kb, k, k0, BK, ch, n);
          __syncthreads();
        }
      }
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk) {
        uint32_t a[4], b[4];
        ldmatrix_x4(a, q_addr + kk * 32);
        ldmatrix_x4(b, k_addr + kk * 32);
        mma_bf16(s[0], a, b[0], b[1]);
        mma_bf16(s[1], a, b[2], b[3]);
      }
    }

    // ---- weights, on the fragments: s[t][e] is row r0 + 8 (e >> 1), column
    // 16 nj + 8 t + 2 tq + (e & 1)
    if constexpr (kRunningMax) {
      // logits, -inf past the last key; this warp's maximum of each row
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cc = 16 * nj + 8 * t + 2 * tq + (e & 1);
          float cval;
          if constexpr (kSrc == kGeometry)
            cval = ct_s[(4 * (e >> 1) + 2 * t + (e & 1)) * THREADS + tid];
          else
            cval = static_cast<float>(creg[t][e]);
          float val = cval * (s[t][e] * qk_scale) + bias_s[cc];
          if (k0 + cc >= n) val = -INFINITY;
          s[t][e] = val;
          mx[e >> 1] = fmaxf(mx[e >> 1], val);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      }
      if (tq == 0) {
        m_part[nj * BQ + r0] = mx[0];
        m_part[nj * BQ + r0 + 8] = mx[1];
      }
      __syncthreads();
      // every column warp of a row computes the same m' and alpha
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        const float tile_max = fmaxf(fmaxf(m_part[row], m_part[BQ + row]),
                                     fmaxf(m_part[2 * BQ + row], m_part[3 * BQ + row]));
        const float m_new = fmaxf(m_row[h], tile_max);
        alpha[h] = expf(m_row[h] - m_new);
        m_row[h] = m_new;
        l_row[h] *= alpha[h];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int col = 16 * nj + 8 * t + 2 * tq;
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = expf(s[t][e] - m_row[e >> 1]);
          l_row[e >> 1] += p[e];
        }
        *reinterpret_cast<__nv_bfloat162*>(Pb + r0 * PB + col) =
            __floats2bfloat162_rn(p[0], p[1]);
        *reinterpret_cast<__nv_bfloat162*>(Pb + (r0 + 8) * PB + col) =
            __floats2bfloat162_rn(p[2], p[3]);
      }
    } else {
      const float offs[2] = {offs_s[r0], offs_s[r0 + 8]};
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int col = 16 * nj + 8 * t + 2 * tq;
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cc = col + (e & 1);
          float val = static_cast<float>(creg[t][e]) * (s[t][e] * qk_scale);
          if (has_bias) val += bias_s[cc];
          p[e] = expf(fmaxf(val - offs[e >> 1], -80.0f));
          if ((has_bias && bias_s[cc] < 0.f) || k0 + cc >= n) p[e] = 0.f;
          l_row[e >> 1] += p[e];
        }
        // the TPU kernels round p to their v's type before p v
        *reinterpret_cast<__nv_bfloat162*>(Pb + r0 * PB + col) = __floats2bfloat162_rn(p[0], p[1]);
        *reinterpret_cast<__nv_bfloat162*>(Pb + (r0 + 8) * PB + col) =
            __floats2bfloat162_rn(p[2], p[3]);
      }
    }
    if constexpr (!kWide) {
      if (k0 + BK < n) fetch(k0 + BK);  // in flight during P V
    }
    __syncthreads();

    // ---- acc += P V on this warp's 16 rows x 32 channels
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4], b[4];
      ldmatrix_x4(a, p_addr + kk * 32);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ldmatrix_x4_trans(b, v_addr + kk * 16 * RB * 2 + h * 32);
        mma_bf16(o[2 * h], a, b[0], b[1]);
        mma_bf16(o[2 * h + 1], a, b[2], b[3]);
      }
    }
  }

  // Hand back in the callers' layout. Every warp passed the last tile's
  // second barrier, so nobody reads Q any more: its region takes the f32
  // output tile, and the compat region (unused in the loop) the row partials.
  float* out_s = smem + OFF_Q;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int ch = 32 * nj + 8 * j + 2 * tq;
    out_s[r0 * CP + ch] = o[j][0];
    out_s[r0 * CP + ch + 1] = o[j][1];
    out_s[(r0 + 8) * CP + ch] = o[j][2];
    out_s[(r0 + 8) * CP + ch + 1] = o[j][3];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_row[h] += __shfl_xor_sync(0xffffffffu, l_row[h], 1);
    l_row[h] += __shfl_xor_sync(0xffffffffu, l_row[h], 2);
  }
  if (tq == 0) {
    l_part[nj * BQ + r0] = l_row[0];
    l_part[nj * BQ + r0 + 8] = l_row[1];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = out_s[(4 * warp + r) * CP + lane + 32 * j];
  if (tid < BQ)
    l_s[tid] = (l_part[tid] + l_part[BQ + tid]) + (l_part[2 * BQ + tid] + l_part[3 * BQ + tid]);
  __syncthreads();
}

}  // namespace oa
