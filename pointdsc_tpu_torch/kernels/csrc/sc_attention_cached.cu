// The running-max attention over the int8 cache at C = 128, for the H100:
// warpgroup matrix multiplies (wgmma) on 128-row query tiles, TMA-fed rings
// of K, compat and V tiles, and key splits planned to fill the card's SMs.
//
// Replaces the TPU kernel pointdsc_tpu/kernels/sc_attention.py:417
// (_sc_attention_cached_kernel, pallas_call at :590), the
// fused_sc_attention_cached(offset_softmax=False) path at C = 128:
//
//   out = softmax_j(compat_ij / 127 * q_i.k_j / sqrt(C) + bias_j) v_j
//
// q, k, v [B, N, 128] bf16, compat [B, N, N] int8, bias [B, N] (0 valid,
// -1e9 padded), out [B, N, 128] f32. As on the TPU, where the JAX wrapper
// rounds q, k, v to bf16 (sc_attention.py:631) and the kernel rounds p to its
// v's type (:460): the products are exact on bf16 operands with f32 sums, m
// starts at -1e9, masked keys keep their -1e9 bias (no p = 0 override), keys
// past N count as -inf, p is rounded to bf16 before p v while l sums the f32
// p, and the result is acc / (l + 1e-30). The logits are taken in log2 units
// (log2 e folded into the qk scale and the bias), so p = 2^(s - m) on the
// MUFU's ex2. Wider models and row shards run sc_attention.cu's kernels.
//
// What bounds it on the card, per call of N keys: the two N^2 C products,
// 4 N^2 C operations on bf16 operands (0.078 ms at N = 12288, 0.217 ms at
// 20480 at 989 TFLOP/s); the N^2 int8 cache, read once (0.045 / 0.125 ms at
// 3.35 TB/s); per entry of the N^2 logits about ten instructions of softmax
// on the CUDA cores beside one ex2 on the MUFU; and shared memory, which the
// products' operands, the TMA writes and the compat reads share (about 2000
// clocks of its 128 bytes a clock per 128 x 128 tile pair, as many as the
// products take at the peak). What the design does about each:
//
// - A block runs three warpgroups: two consumers of 64 query rows each (128
//   rows a work item) and one producer. A consumer's S = Q K^T is
//   wgmma.m64n128k16 over a 128-key tile with Q resident in shared memory;
//   the softmax runs on the accumulator fragments, each thread holding two
//   whole-row quarters, so the row max is a quad shuffle and no barrier; p
//   goes from the S registers, rounded to bf16, straight into the A operand
//   of the P V wgmma (the accumulator layout is the A fragment layout). A
//   128-row item re-reads K and V from L2 a quarter as often as 32-row blocks.
// - Within a warpgroup the next tile's S product is issued beside this
//   tile's P V and the softmax runs while P V is in flight; the two
//   warpgroups take turns issuing their products (named barriers), one's
//   exponentials beside the other's products.
// - Two rings, each stage on an mbarrier: K with the compat tile and the bias
//   row (KC_STAGES), freed as soon as a tile's softmax has read them, and V
//   (V_STAGES), freed when its P V is done, so the next tile's loads are in
//   flight a whole tile ahead (one shared ring left each load's latency in
//   the loop). One producer thread issues the TMA loads: K and V as two
//   64-channel halves each in the 128-byte swizzle that wgmma reads, the
//   [128 x 128] compat tile; the producer's threads write the bias row (log2
//   units, -inf past N). Where N is not a multiple of 16 (TMA needs 16-byte
//   row strides) its threads stage the compat tile byte by byte.
// - A compat byte is decoded without I2F: xor 0x80 makes it unsigned, a byte
//   permute puts it under the exponent of 2^23 and one add removes the
//   offset, exact, on the ALU and FMA pipes rather than at the MUFU's rate.
// - One wave of blocks (the plan's, kernels/sc_attention.py::
//   cached_attention_plan): the (sample, query tile, key tile) sequence is
//   cut into equal runs, one a block, so a block may take the end of one
//   query tile's keys and the start of the next. A query tile whose keys are
//   split writes each run's (m, l, acc) to a workspace slot, and
//   sc_attention_cached_kernel_merge combines the slots with weights
//   2^(m_s - m); a split whose keys are all masked gets weight exactly 0.
//
// Measured on an H100 SXM (PERF.md, Findings): a cluster of two blocks sharing
// K and V by TMA multicast was slower (each stage waited on both blocks),
// and with the two rings the K and V traffic no longer binds.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int C = 128;        // channels (a narrower model is zero-padded to it)
constexpr int BM = 128;       // query rows a work item: two consumer warpgroups of 64
constexpr int BK = 128;       // keys a tile
constexpr int KC_STAGES = 2;  // the ring of K tiles, compat tiles and bias rows
constexpr int V_STAGES = 2;   // the ring of V tiles
constexpr int THREADS = 384;  // warpgroups 0 and 1 consume, 2 produces
constexpr int CONSUMER_WARPS = 8;
constexpr int ITEM_INTS = 8;  // a plan item: sample, query tile, first key tile, key tiles, slot
constexpr int MERGE_ROWS = 8;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG2 = -1e9f * LOG2E;  // the running max's start (the TPU kernel's _NEG)

// Shared memory from a 1024-byte aligned base: the Q tile (two 64-channel
// halves of [BM rows x 128 bytes]); KC_STAGES stages of [K halves, compat
// tile [BM x BK] bytes]; V_STAGES stages of [V halves]; KC_STAGES bias rows
// [BK] f32; then the barriers.
constexpr int HALF_Q = BM * 128;
constexpr int HALF_KV = BK * 128;
constexpr int OFF_C = 2 * HALF_KV;  // in a KC stage, after K
constexpr int KC_BYTES = OFF_C + BM * BK;
constexpr int OFF_KC = 2 * HALF_Q;
constexpr int OFF_V = OFF_KC + KC_STAGES * KC_BYTES;
constexpr int OFF_BIAS = OFF_V + V_STAGES * 2 * HALF_KV;
constexpr int OFF_BAR = OFF_BIAS + KC_STAGES * BK * 4;
constexpr int BARRIERS = 2 * KC_STAGES + 2 * V_STAGES + 2;
constexpr int SMEM_BYTES = OFF_BAR + 8 * BARRIERS + 1024;
constexpr uint32_t Q_BYTES = 2 * HALF_Q;
constexpr uint32_t K_BYTES = 2 * HALF_KV;
constexpr uint32_t V_BYTES = 2 * HALF_KV;
constexpr uint32_t C_BYTES = BM * BK;

static_assert(BK == 128 && BM == 128, "one compat row is one 128-byte swizzle row");
static_assert(SMEM_BYTES <= 232448, "the H100 gives a block 227 KB of shared memory");

// the compat tile's bytes of local row r, columns k0 .. k0 + BK, staged by
// one producer thread where TMA cannot load it (N % 16 != 0): the 16-byte
// chunk ch at ch ^ (r % 8), as TMA's 128-byte swizzle places it
__device__ void stage_compat_row(uint8_t* tile, const int8_t* compat, int row, int k0, int n,
                                 int r) {
  for (int ch = 0; ch < BK / 16; ++ch) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t x = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + 16 * ch + 4 * i + j;
        if (row < n && col < n)
          x |= static_cast<uint32_t>(static_cast<uint8_t>(
                   compat[static_cast<size_t>(row) * n + col]))
               << (8 * j);
      }
      w[i] = x;
    }
    *reinterpret_cast<uint4*>(tile + r * 128 + ((ch ^ (r & 7)) << 4)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// a position in a ring of mbarrier-guarded stages: the stage and the parity
// of its current round
struct Ring {
  int size, stage = 0;
  uint32_t phase = 0;
  __device__ explicit Ring(int n) : size(n) {}
  __device__ void advance() {
    if (++stage == size) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// a compat byte (xor 0x80, in byte 0 or 1 of e) as an exact f32
template <int kByte>
__device__ __forceinline__ float decode(uint32_t e) {
  return __int_as_float(__byte_perm(e, 0x4B000000u, 0x7440 | kByte)) - 8388736.0f;
}

// S = Q K^T for one warpgroup: its 64 rows of the Q tile (q_addr) over the 128
// keys of a K tile (k_addr), eight k-steps of 16 channels
__device__ __forceinline__ void qk_tile(float (&s)[64], uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk) {
    const uint32_t off = (kk >> 2) * HALF_KV + (kk & 3) * 32;
    hop::wgmma_ss_n128(s, hop::desc_sw128(q_addr + (kk >> 2) * HALF_Q + (kk & 3) * 32, 16, 1024),
                       hop::desc_sw128(k_addr + off, 16, 1024), kk > 0);
  }
}

// o += P V for one warpgroup: p the bf16 A fragments of its 64 x 128 weights,
// V's tile (v_addr) MN-major, eight k-steps of 16 keys
__device__ __forceinline__ void pv_tile(float (&o)[64], const uint32_t (&p)[32], uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    hop::wgmma_rs_n128(o, a, hop::desc_sw128(v_addr + kk * 16 * 128, HALF_KV, 1024));
  }
}

__global__ void __launch_bounds__(THREADS, 1)
sc_attention_cached_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                                 const __grid_constant__ CUtensorMap tm_k,
                                 const __grid_constant__ CUtensorMap tm_v,
                                 const __grid_constant__ CUtensorMap tm_c,
                                 const int8_t* __restrict__ compat,
                                 const float* __restrict__ bias, const int* __restrict__ items,
                                 const int* __restrict__ first, float* __restrict__ out,
                                 float* __restrict__ part, int n, int slots, float scale2,
                                 int compat_tma) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* kc_full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* kc_empty = kc_full + KC_STAGES;
  uint64_t* v_full = kc_empty + KC_STAGES;
  uint64_t* v_empty = v_full + V_STAGES;
  uint64_t* q_full = v_empty + V_STAGES;
  uint64_t* q_empty = q_full + 1;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < KC_STAGES; ++s) {
      hop::mbar_init(&kc_full[s], 128);  // the producer's threads, one with the TMA bytes
      hop::mbar_init(&kc_empty[s], CONSUMER_WARPS);
    }
    for (int s = 0; s < V_STAGES; ++s) {
      hop::mbar_init(&v_full[s], 1);
      hop::mbar_init(&v_empty[s], CONSUMER_WARPS);
    }
    hop::mbar_init(q_full, 1);
    hop::mbar_init(q_empty, CONSUMER_WARPS);
    hop::fence_barrier_init();
  }
  __syncthreads();
  const int item0 = first[blockIdx.x], item1 = first[blockIdx.x + 1];
  const int wg = tid >> 7;

  if (wg == 2) {
    // ---- producer: Q once an item, then the item's key tiles into the ring
    hop::reg_dealloc<40>();
    const int pt = tid - 256;
    if (pt == 0) {
      hop::prefetch_map(&tm_q);
      hop::prefetch_map(&tm_k);
      hop::prefetch_map(&tm_v);
      if (compat_tma) hop::prefetch_map(&tm_c);
    }
    Ring kc(KC_STAGES), vr(V_STAGES);
    for (int it = item0; it < item1; ++it) {
      const int* item = items + ITEM_INTS * it;
      const int b = item[0], q0 = item[1] * BM, kt0 = item[2], kts = item[3];
      hop::mbar_wait(q_empty, ((it - item0) & 1) ^ 1);
      if (pt == 0) {
        hop::mbar_arrive_expect_tx(q_full, Q_BYTES);
        hop::tma_load_3d(smem, &tm_q, q_full, 0, q0, b);
        hop::tma_load_3d(smem + HALF_Q, &tm_q, q_full, 64, q0, b);
      }
      for (int t = 0; t < kts; ++t) {
        const int k0 = (kt0 + t) * BK;
        // K, compat and bias of tile t
        uint8_t* st = smem + OFF_KC + kc.stage * KC_BYTES;
        hop::mbar_wait(&kc_empty[kc.stage], kc.phase ^ 1);
        reinterpret_cast<float*>(smem + OFF_BIAS)[kc.stage * BK + pt] =
            k0 + pt < n ? bias[static_cast<size_t>(b) * n + k0 + pt] * LOG2E : -INFINITY;
        if (!compat_tma)
          stage_compat_row(st + OFF_C, compat + static_cast<size_t>(b) * n * n, q0 + pt, k0, n,
                           pt);
        if (pt == 0) {
          hop::mbar_arrive_expect_tx(&kc_full[kc.stage], K_BYTES + (compat_tma ? C_BYTES : 0u));
          hop::tma_load_3d(st, &tm_k, &kc_full[kc.stage], 0, k0, b);
          hop::tma_load_3d(st + HALF_KV, &tm_k, &kc_full[kc.stage], 64, k0, b);
          if (compat_tma) hop::tma_load_3d(st + OFF_C, &tm_c, &kc_full[kc.stage], k0, q0, b);
        } else {
          hop::mbar_arrive(&kc_full[kc.stage]);
        }
        kc.advance();
        // V of tile t: its P V runs beside the next tile's S, so it is freed later
        if (pt == 0) {
          uint8_t* vt = smem + OFF_V + vr.stage * V_BYTES;
          hop::mbar_wait(&v_empty[vr.stage], vr.phase ^ 1);
          hop::mbar_arrive_expect_tx(&v_full[vr.stage], V_BYTES);
          hop::tma_load_3d(vt, &tm_v, &v_full[vr.stage], 0, k0, b);
          hop::tma_load_3d(vt + HALF_KV, &tm_v, &v_full[vr.stage], 64, k0, b);
        }
        vr.advance();
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each item
    hop::reg_alloc<232>();
    const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, tq = lane & 3;
    const int r_lo = 64 * wg + 16 * warp + g;  // this thread's rows: r_lo and r_lo + 8
    const uint32_t q_addr = hop::smem_u32(smem) + wg * 64 * 128;
    const uint32_t sel = (2 * tq) | ((2 * tq + 1) << 4);  // its two bytes of a half chunk
    auto kc_at = [&](int s) { return smem + OFF_KC + s * KC_BYTES; };
    auto v_at = [&](int s) { return hop::smem_u32(smem + OFF_V + s * V_BYTES); };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(bar);
    };
    Ring kc(KC_STAGES), vr(V_STAGES);
    // the two warpgroups take turns issuing their products (named barriers 1
    // and 2), so that one's softmax runs beside the other's wgmma
    auto my_turn = [&]() { hop::bar_sync(1 + wg, 256); };
    auto your_turn = [&]() { hop::bar_arrive(2 - wg, 256); };
    if (wg == 1) your_turn();
    for (int it = item0; it < item1; ++it) {
      const int* item = items + ITEM_INTS * it;
      const int b = item[0], q0 = item[1] * BM, kts = item[3], slot = item[4];
      float s[64], o[64];
      uint32_t p[32];
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] = 0.f;
      float m_lo = NEG2, m_hi = NEG2, l_lo = 0.f, l_hi = 0.f;

      // The tile's logits (log2 units) in s, then its weights: s = 2^(s - m')
      // with m' the new running max; l and m updated, alpha returned.
      auto softmax = [&](int st, float& a_lo, float& a_hi) {
        const uint8_t* cs = kc_at(st) + OFF_C;
        const float* bs = reinterpret_cast<const float*>(smem + OFF_BIAS) + st * BK;
        float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
        for (int ch = 0; ch < BK / 16; ++ch) {
          const uint4 x_lo = *reinterpret_cast<const uint4*>(cs + r_lo * 128 + ((ch ^ g) << 4));
          const uint4 x_hi =
              *reinterpret_cast<const uint4*>(cs + (r_lo + 8) * 128 + ((ch ^ g) << 4));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = 2 * ch + h;  // the n8 block: columns 8 j + 2 tq + {0, 1}
            const uint32_t e_lo =
                __byte_perm(h ? x_lo.z : x_lo.x, h ? x_lo.w : x_lo.y, sel) ^ 0x8080u;
            const uint32_t e_hi =
                __byte_perm(h ? x_hi.z : x_hi.x, h ? x_hi.w : x_hi.y, sel) ^ 0x8080u;
            const float2 bb = *reinterpret_cast<const float2*>(bs + 8 * j + 2 * tq);
            s[4 * j + 0] = fmaf(decode<0>(e_lo), s[4 * j + 0] * scale2, bb.x);
            s[4 * j + 1] = fmaf(decode<1>(e_lo), s[4 * j + 1] * scale2, bb.y);
            s[4 * j + 2] = fmaf(decode<0>(e_hi), s[4 * j + 2] * scale2, bb.x);
            s[4 * j + 3] = fmaf(decode<1>(e_hi), s[4 * j + 3] * scale2, bb.y);
            mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j + 0], s[4 * j + 1]));
            mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
          }
        }
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
        const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
        a_lo = hop::ex2(m_lo - mn_lo);
        a_hi = hop::ex2(m_hi - mn_hi);
        m_lo = mn_lo;
        m_hi = mn_hi;
        float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          s[4 * j + 0] = hop::ex2(s[4 * j + 0] - mn_lo);
          s[4 * j + 1] = hop::ex2(s[4 * j + 1] - mn_lo);
          s[4 * j + 2] = hop::ex2(s[4 * j + 2] - mn_hi);
          s[4 * j + 3] = hop::ex2(s[4 * j + 3] - mn_hi);
          sum_lo += s[4 * j + 0] + s[4 * j + 1];
          sum_hi += s[4 * j + 2] + s[4 * j + 3];
        }
        l_lo = fmaf(l_lo, a_lo, sum_lo);
        l_hi = fmaf(l_hi, a_hi, sum_hi);
      };
      // p rounded to bf16 into the P V product's A fragments
      auto pack = [&]() {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const __nv_bfloat162 x = __floats2bfloat162_rn(s[2 * i], s[2 * i + 1]);
          p[i] = *reinterpret_cast<const uint32_t*>(&x);
        }
      };

      hop::mbar_wait(q_full, (it - item0) & 1);
      float a_lo, a_hi;
      hop::mbar_wait(&kc_full[kc.stage], kc.phase);
      my_turn();
      hop::wgmma_fence();
      qk_tile(s, q_addr, hop::smem_u32(kc_at(kc.stage)));
      hop::wgmma_commit();
      your_turn();
      hop::wgmma_wait<0>();
      hop::fence_regs(s);
      if (kts == 1) release(q_empty);
      softmax(kc.stage, a_lo, a_hi);
      release(&kc_empty[kc.stage]);
      pack();
      kc.advance();
      for (int t = 1; t < kts; ++t) {
        hop::mbar_wait(&kc_full[kc.stage], kc.phase);
        hop::mbar_wait(&v_full[vr.stage], vr.phase);  // tile t - 1's
        hop::fence_regs(p);
        hop::fence_regs(o);
        my_turn();
        hop::wgmma_fence();
        qk_tile(s, q_addr, hop::smem_u32(kc_at(kc.stage)));
        hop::wgmma_commit();
        pv_tile(o, p, v_at(vr.stage));
        hop::wgmma_commit();
        your_turn();
        hop::wgmma_wait<1>();  // S is in; P V may still run
        hop::fence_regs(s);
        if (t == kts - 1) release(q_empty);
        softmax(kc.stage, a_lo, a_hi);
        release(&kc_empty[kc.stage]);
        kc.advance();
        hop::wgmma_wait<0>();
        hop::fence_regs(o);
        hop::fence_regs(p);
        release(&v_empty[vr.stage]);
        vr.advance();
        if (__any_sync(0xffffffffu, a_lo != 1.f || a_hi != 1.f)) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            o[4 * j + 0] *= a_lo;
            o[4 * j + 1] *= a_lo;
            o[4 * j + 2] *= a_hi;
            o[4 * j + 3] *= a_hi;
          }
        }
        pack();
      }
      hop::mbar_wait(&v_full[vr.stage], vr.phase);
      hop::fence_regs(p);
      hop::fence_regs(o);
      my_turn();
      hop::wgmma_fence();
      pv_tile(o, p, v_at(vr.stage));
      hop::wgmma_commit();
      your_turn();
      hop::wgmma_wait<0>();
      hop::fence_regs(o);
      hop::fence_regs(p);
      release(&v_empty[vr.stage]);
      vr.advance();

      // ---- the item's rows: out (a whole query tile) or its workspace slot
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
      const int row_lo = q0 + r_lo, row_hi = row_lo + 8;
      if (slot < 0) {
        const float d_lo = l_lo + 1e-30f, d_hi = l_hi + 1e-30f;
        float* o_lo = out + (static_cast<size_t>(b) * n + row_lo) * C + 2 * tq;
        float* o_hi = o_lo + 8 * C;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (row_lo < n)
            *reinterpret_cast<float2*>(o_lo + 8 * j) =
                make_float2(o[4 * j + 0] / d_lo, o[4 * j + 1] / d_lo);
          if (row_hi < n)
            *reinterpret_cast<float2*>(o_hi + 8 * j) =
                make_float2(o[4 * j + 2] / d_hi, o[4 * j + 3] / d_hi);
        }
      } else {
        float* pa = part + (static_cast<size_t>(slot) * BM + r_lo) * C + 2 * tq;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          *reinterpret_cast<float2*>(pa + 8 * j) = make_float2(o[4 * j + 0], o[4 * j + 1]);
          *reinterpret_cast<float2*>(pa + 8 * C + 8 * j) =
              make_float2(o[4 * j + 2], o[4 * j + 3]);
        }
        if (tq == 0) {
          float* pm = part + static_cast<size_t>(slots) * BM * C + slot * BM;
          float* pl = pm + slots * BM;
          pm[r_lo] = m_lo;
          pm[r_lo + 8] = m_hi;
          pl[r_lo] = l_lo;
          pl[r_lo + 8] = l_hi;
        }
      }
    }
  }
}

// The split query tiles: merges[i] = (sample, query tile, first slot, slots);
// a block takes MERGE_ROWS rows of one tile, a thread four channels of a row.
__global__ void __launch_bounds__(C / 4 * MERGE_ROWS)
sc_attention_cached_kernel_merge(const int* __restrict__ merges, const float* __restrict__ part,
                                 float* __restrict__ out, int n, int slots) {
  const int* mg = merges + 4 * blockIdx.x;
  const int b = mg[0], q0 = mg[1] * BM, s0 = mg[2], count = mg[3];
  const int r = blockIdx.y * MERGE_ROWS + threadIdx.y, c = 4 * threadIdx.x;
  if (q0 + r >= n) return;
  const float* pm = part + static_cast<size_t>(slots) * BM * C;
  const float* pl = pm + slots * BM;
  float m = -INFINITY;
  for (int s = 0; s < count; ++s) m = fmaxf(m, pm[(s0 + s) * BM + r]);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < count; ++s) {
    const float w = hop::ex2(pm[(s0 + s) * BM + r] - m);
    const float4 a =
        *reinterpret_cast<const float4*>(part + (static_cast<size_t>(s0 + s) * BM + r) * C + c);
    l = fmaf(w, pl[(s0 + s) * BM + r], l);
    acc = make_float4(fmaf(w, a.x, acc.x), fmaf(w, a.y, acc.y), fmaf(w, a.z, acc.z),
                      fmaf(w, a.w, acc.w));
  }
  const float d = l + 1e-30f;
  *reinterpret_cast<float4*>(out + (static_cast<size_t>(b) * n + q0 + r) * C + c) =
      make_float4(acc.x / d, acc.y / d, acc.z / d, acc.w / d);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the CUDA driver API's tensor-map encoder, looked up once through the runtime (no
// link against libcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a [batch, rows, inner] tensor (row stride `stride` bytes) read in boxes of
// [box_rows, box_inner] with the 128-byte swizzle; false if refused
bool encode(EncodeTiled fn, CUtensorMap* map, CUtensorMapDataType type, const void* base,
            int inner, int rows, int batch, uint64_t stride, int box_inner, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {stride, stride * static_cast<cuuint64_t>(rows)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace

// q, k, v [batch, n, 128] bf16, compat [batch, n, n] int8, bias [batch, n]
// f32, out [batch, n, 128] f32; items [.., 8] and first [blocks + 1] the
// plan's (kernels/sc_attention.py::cached_attention_plan), merges [n_merges,
// 4] its split query tiles, part the workspace of its `slots` slots
// (slots x (128 x 128 + 2 x 128) f32). Two launches on the stream: the
// attention, then the merge where a query tile is split.
extern "C" int sc_attention_cached128(const void* q, const void* k, const void* v,
                                      const void* compat, const void* bias, void* out,
                                      void* part, const void* items, const void* first,
                                      const void* merges, int blocks, int n_merges, int slots,
                                      int batch, int n, float qk_scale, void* stream) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (blocks < 1 || batch < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, tc;
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!encode(fn, &tq, bf16, q, C, n, batch, C * 2, 64, BM) ||
      !encode(fn, &tk, bf16, k, C, n, batch, C * 2, 64, BK) ||
      !encode(fn, &tv, bf16, v, C, n, batch, C * 2, 64, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  // TMA takes 16-byte aligned rows; otherwise the producer stages the bytes
  int compat_tma = n % 16 == 0 && reinterpret_cast<uintptr_t>(compat) % 16 == 0;
  if (compat_tma && !encode(fn, &tc, CU_TENSOR_MAP_DATA_TYPE_UINT8, compat, n, n, batch,
                            static_cast<uint64_t>(n), BK, BM))
    compat_tma = 0;
  if (!compat_tma) tc = tq;  // not read
  const cudaError_t err = cudaFuncSetAttribute(sc_attention_cached_kernel_wgmma,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale2 = static_cast<float>(static_cast<double>(qk_scale) * 1.4426950408889634);
  sc_attention_cached_kernel_wgmma<<<blocks, THREADS, SMEM_BYTES, st>>>(
      tq, tk, tv, tc, static_cast<const int8_t*>(compat), static_cast<const float*>(bias),
      static_cast<const int*>(items), static_cast<const int*>(first), static_cast<float*>(out),
      static_cast<float*>(part), n, slots, scale2, compat_tma);
  if (n_merges > 0)
    sc_attention_cached_kernel_merge<<<dim3(n_merges, BM / MERGE_ROWS), dim3(C / 4, MERGE_ROWS),
                                       0, st>>>(static_cast<const int*>(merges),
                                             static_cast<const float*>(part),
                                             static_cast<float*>(out), n, slots);
  return static_cast<int>(cudaGetLastError());
}
