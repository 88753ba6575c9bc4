// Whole-encoder-layer kernels, CUDA C++ for sm_90a.
//
// One encoder layer is PointCN (Dense + BatchNorm + ReLU) followed by the
// spatial-consistency attention block (Q/K/V projections, offset-softmax
// attention over the int8 cache, a three-Dense message MLP with two
// BatchNorms, residual). With the eval-mode BatchNorms folded into the Dense
// before them, the layer is
//
//   h   = relu(x W1 + b1)                                  f32
//   qkv = h Wqkv + bqkv, stored bf16; kscale = max_j ||k_j|| / sqrt(C)
//   o   = offset attention(q, k, v, compat, kbias, kscale)   (offset_attention.cuh)
//   out = h + (relu(relu(o Wm0 + bm0) Wm1 + bm1) Wm2 + bm2)  f32
//
// Three kernels replace the TPU kernels of pointdsc_tpu/kernels/encoder_layer.py:
//
//   fused_encoder_layer  <- _make_kernel :109 (pallas_call :235), N <= 6144
//   pcn_qkv              <- _pcn_qkv_kernel :272 (pallas_call :418)
//   attn_mlp_residual    <- _make_attn_mlp_kernel :326 (pallas_call :458)
//
// The TPU's one-call form runs a sequential grid whose first row is phase 1
// and keeps h, q, k, v of the whole pair in on-chip memory. A CUDA grid has
// no order and a block 227 KB, so here h, q, k, v live in a global workspace
// (N C 10 bytes: 6.5 MB at N = 5120, resident in the 50 MB L2) and the two
// phases of the one-launch form are separated by a grid-wide barrier: a
// cooperative launch with a persistent grid (occupancy x SM count blocks),
// each block looping over row tiles. If the card cannot launch cooperatively
// the entry returns the error; nothing falls back to the split pair.
//
// The running max of the key norms is a block reduction and an atomicMax on
// the bit pattern of the non-negative float kscale, zeroed on the stream
// before each launch (multiplying by 1/sqrt(C) and the square root are
// monotonic, so the max of the scaled norms is the scaled max norm). Phase 2
// and attn_mlp_residual read it from device memory.
//
// Rounding follows the TPU kernels: q, k, v are rounded to bf16 where they are
// stored, the key norm is of the rounded keys, the query norm of the rounded
// queries, p is rounded to bf16 before p v; h, every accumulation, the MLP and
// the residual are f32. No -use_fast_math: exp(-80) must not flush.
//
// Bound on the H100 per layer at N = 5120: the 26.2 MB cache stream and
// 4 N^2 C = 13.4 GFLOP in the two attention products, against 0.6 GFLOP in the
// five weight products. The two N^2 C products run on the bf16 tensor cores
// (offset_attention.cuh: 14 us at 989 TFLOP/s; the cache stream 8 us); the
// weight products stay f32 FMAs through shared memory. Weight matrices are staged in
// shared memory one 64 KB piece at a time (W1, then the q, k and v thirds of
// Wqkv; Wm0, Wm1, Wm2 into the V region after the key loop), so the block
// stays within the attention loop's 99 KB and two blocks fit an SM.
// The split pair's PointCN + QKV kernel has a design of its own (below
// pcn_qkv_tile).

#include <atomic>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "offset_attention.cuh"

namespace cg = cooperative_groups;

namespace {

using oa::BQ;
using oa::C;
using oa::CP;
using oa::THREADS;
constexpr int CH = C / 2;    // message MLP's inner width
constexpr int MP = CH + 1;   // padded row of the MLP's intermediates

// phase-1 shared memory, in floats: one weight matrix, the x tile, the h tile
constexpr int P1_W = 0;
constexpr int P1_X = P1_W + C * C;
constexpr int P1_H = P1_X + BQ * CP;
static_assert(P1_H + BQ * CP <= oa::SMEM_FLOATS, "phase 1 must fit the attention layout");
// epilogue: weights in the V region, o in the Q region, intermediates in the K region
static_assert(C * CH <= oa::BK * C, "Wm0 / Wm2 must fit the V region");
static_assert(2 * BQ * MP <= oa::BK * CP, "MLP intermediates must fit the K region");

struct LayerArgs {
  const float* x;        // [B, N, C]
  const int8_t* compat;  // [B, N, N]
  const float* kbias;    // [B, N] or nullptr
  const float *w1, *b1;      // [C, C], [C]      BN folded
  const float *wqkv, *bqkv;  // [C, 3C], [3C]
  const float *wm0, *bm0;    // [C, C/2], [C/2]  BN folded
  const float *wm1, *bm1;    // [C/2, C/2], [C/2]  BN folded
  const float *wm2, *bm2;    // [C/2, C], [C]
  float* h;               // [B, N, C] f32
  __nv_bfloat16 *q, *k, *v;  // [B, N, C] bf16
  float* kscale;          // [B], zeroed before the launch
  float* out;             // [B, N, C]
  int batch, n;
  float qk_scale, inv_sqrt_c;
};

__device__ inline void copy_to_smem(float* dst, const float* src, int rows, int cols,
                                    int src_stride) {
  const int per_row = cols / 4;
  for (int i = threadIdx.x; i < rows * per_row; i += THREADS) {
    const int r = i / per_row, c4 = (i % per_row) * 4;
    *reinterpret_cast<float4*>(dst + r * cols + c4) =
        *reinterpret_cast<const float4*>(src + static_cast<size_t>(r) * src_stride + c4);
  }
}

// acc[r][j] = sum_kk A[row][kk] * W[kk][col] for row = 4 * (tid >> 5) + r and
// col = (tid & 31) + 32 * j; A [BQ, kdim] with row stride lda and W
// [kdim, NOUT] both in shared memory.
template <int NOUT>
__device__ inline void tile_matmul(const float* A, int lda, const float* W, int kdim,
                                   float (&acc)[4][NOUT / 32]) {
  const int ry = threadIdx.x >> 5, cx = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < NOUT / 32; ++j) acc[r][j] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < kdim; ++kk) {
    float w[NOUT / 32];
#pragma unroll
    for (int j = 0; j < NOUT / 32; ++j) w[j] = W[kk * NOUT + cx + 32 * j];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = A[(4 * ry + r) * lda + kk];
#pragma unroll
      for (int j = 0; j < NOUT / 32; ++j) acc[r][j] = fmaf(a, w[j], acc[r][j]);
    }
  }
}

// PointCN + QKV of rows [r0, r0 + BQ) of pair b.
__device__ void pcn_qkv_tile(const LayerArgs& a, int b, int r0, float* smem) {
  float* Ws = smem + P1_W;
  float* Xs = smem + P1_X;
  float* Hs = smem + P1_H;
  const int tid = threadIdx.x;
  const int ry = tid >> 5, cx = tid & 31;
  const size_t base = static_cast<size_t>(b) * a.n;

  __syncthreads();  // whoever used the shared memory before is done
  for (int i = tid; i < BQ * C / 4; i += THREADS) {
    const int r = i / (C / 4), c4 = (i % (C / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < a.n) x = oa::load4(a.x + (base + r0 + r) * C + c4);
    oa::store_padded(Xs + r * CP, c4, x);
  }
  copy_to_smem(Ws, a.w1, C, C, C);
  __syncthreads();

  float acc[4][4];
  tile_matmul<C>(Xs, CP, Ws, C, acc);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 4 * ry + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = cx + 32 * j;
      const float hv = fmaxf(acc[r][j] + a.b1[col], 0.f);
      Hs[row * CP + col] = hv;
      if (r0 + row < a.n) a.h[(base + r0 + row) * C + col] = hv;
    }
  }

  __nv_bfloat16* outs[3] = {a.q, a.k, a.v};
  for (int part = 0; part < 3; ++part) {
    __syncthreads();  // Hs is complete; the previous weight matrix is no longer read
    copy_to_smem(Ws, a.wqkv + part * C, C, C, 3 * C);
    __syncthreads();
    tile_matmul<C>(Hs, CP, Ws, C, acc);
    float kmax_sq = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 4 * ry + r;
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = cx + 32 * j;
        const __nv_bfloat16 val = __float2bfloat16_rn(acc[r][j] + a.bqkv[part * C + col]);
        if (r0 + row < a.n) outs[part][(base + r0 + row) * C + col] = val;
        const float vf = __bfloat162float(val);
        sq = fmaf(vf, vf, sq);
      }
      if (part == 1) {
        // norm of the rounded key row: the 32 lanes of a warp hold its 128 channels
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
        if (r0 + row < a.n) kmax_sq = fmaxf(kmax_sq, sq);
      }
    }
    if (part == 1 && cx == 0)
      atomicMax(reinterpret_cast<unsigned int*>(a.kscale + b),
                __float_as_uint(sqrtf(kmax_sq) * a.inv_sqrt_c));
  }
}

// Offset attention of rows [q0, q0 + BQ) of pair b, then the message MLP and
// the residual; writes the layer's output rows.
__device__ void attn_mlp_tile(const LayerArgs& a, int b, int q0, float* smem) {
  const int tid = threadIdx.x;
  const int ry = tid >> 5, cx = tid & 31;
  const size_t base = static_cast<size_t>(b) * a.n;
  // written by atomics of this or an earlier kernel: read past L1
  const float kscale = __ldcg(a.kscale + b);

  float acc[4][4];
  oa::attention_rows(
      a.q + base * C, a.k + base * C, a.v + base * C, a.compat + base * a.n,
      a.kbias ? a.kbias + base : nullptr, kscale, a.n, q0, a.qk_scale, smem, acc);

  float* Wb = smem + oa::OFF_V;
  float* Os = smem + oa::OFF_Q;
  float* M0 = smem + oa::OFF_K;
  float* M1 = M0 + BQ * MP;
  const float* l_s = smem + oa::OFF_L;

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 4 * ry + r;
    const float l = l_s[row] + 1e-30f;
#pragma unroll
    for (int j = 0; j < 4; ++j) Os[row * CP + cx + 32 * j] = acc[r][j] / l;
  }
  copy_to_smem(Wb, a.wm0, C, CH, CH);
  __syncthreads();

  float m[4][2];
  tile_matmul<CH>(Os, CP, Wb, C, m);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      M0[(4 * ry + r) * MP + cx + 32 * j] = fmaxf(m[r][j] + a.bm0[cx + 32 * j], 0.f);
  __syncthreads();
  copy_to_smem(Wb, a.wm1, CH, CH, CH);
  __syncthreads();

  tile_matmul<CH>(M0, MP, Wb, CH, m);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      M1[(4 * ry + r) * MP + cx + 32 * j] = fmaxf(m[r][j] + a.bm1[cx + 32 * j], 0.f);
  __syncthreads();
  copy_to_smem(Wb, a.wm2, CH, C, C);
  __syncthreads();

  tile_matmul<C>(M1, MP, Wb, CH, acc);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 4 * ry + r;
    if (q0 + row >= a.n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = cx + 32 * j;
      const size_t at = (base + q0 + row) * C + col;
      a.out[at] = a.h[at] + (acc[r][j] + a.bm2[col]);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2) fused_layer_kernel(LayerArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int tiles = (a.n + BQ - 1) / BQ;
  const int work = a.batch * tiles;
  for (int w = blockIdx.x; w < work; w += gridDim.x)
    pcn_qkv_tile(a, w / tiles, (w % tiles) * BQ, smem);
  __threadfence();
  cg::this_grid().sync();  // every h, q, k, v row and kscale is written
  for (int w = blockIdx.x; w < work; w += gridDim.x)
    attn_mlp_tile(a, w / tiles, (w % tiles) * BQ, smem);
}

// ---------------------------------------------------------------- the split kernel (7b)
//
// PointCN + QKV alone, for the split pair above N = 6144. It runs no
// attention, so it is not held to the attention arena's 99 KB: a block owns
// R = 96 rows in 82 KB of dynamic shared memory.
//
// What bounds it: 2 N C (C + 3C) = 1.61 GFLOP at N = 12288 in f32 FMAs
// (24 us at 67 TFLOP/s; its bytes, ~22 MB, take 7 us). What the design does:
// - Each thread accumulates a 4 x 8 tile in registers. The A operand (x,
//   then h) sits transposed in shared memory, [C][R + 4], and the weight
//   slab row-major, so that per k a thread reads its rows and its columns
//   with 16-byte loads: 3 LDS.128 for 32 FMAs. A warp spans 4 row groups and
//   8 column groups, so each load is one 64- or 128-byte wavefront. Rows
//   ty*4..+3, columns tx*4..+3 and 64 + tx*4..+3: neighbouring lanes read
//   neighbouring 16 bytes.
// - The weights stream through a double buffer of 32-row k-slabs with
//   cp.async (W1, then the q, v and k thirds of Wqkv: 16 slabs of 16 KB), so
//   the L2 reads of slab s + 1 overlap the FMAs of slab s. Weights are read
//   from L2 once per R rows (256 KB each): 32 MiB at N = 12288.
// - h stays in shared memory (it overwrites x, transposed) between the two
//   products; q, v and k are three passes over it. Each product sums its
//   128 terms in k order with fmaf from 0, as pcn_qkv_tile does, so h, q, k
//   and v are the one-launch kernel's bit for bit.
// - The key norms: k comes last, so that its rounded rows can go through the
//   free A tile and be summed in pcn_qkv_tile's order; then one block
//   maximum and one atomicMax per block.
// The grid is (ceil(n / R), batch). R = 96 was chosen by measurement over
// 48, 64, 96 and 128 at N = 12288 and 20480 (PERF.md): it fills the 132 SMs
// most evenly at those sizes.

constexpr int PR = 96;             // rows of a block
constexpr int PTM = 4;             // rows of a thread's tile
constexpr int PNT = PR / PTM * 16; // threads: row groups x 16 column groups
constexpr int PAP = PR + 4;        // row of the transposed A tile
constexpr int MAX_DEVICES = 64;    // the devices whose shared-memory opt-in is remembered
constexpr int KS = 32;             // k rows of a weight slab
constexpr int SLABS_PER_MATRIX = C / KS;
constexpr int SLABS = 4 * SLABS_PER_MATRIX;  // W1, then the q, v and k thirds of Wqkv

constexpr size_t SPLIT_SMEM_BYTES = (C * PAP + 2 * KS * C + 32) * sizeof(float);

__device__ inline void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(oa::smem_addr(dst)),
               "l"(src));
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int PENDING>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

__global__ void __launch_bounds__(PNT, 2) pcn_qkv_kernel(LayerArgs a) {
  constexpr int R = PR, TM = PTM, NT = PNT, AP = PAP;
  static_assert((R / TM) % 4 == 0 && R % 16 == 0, "tile shape");
  extern __shared__ __align__(16) float smem[];
  float* As = smem;              // [C][AP]: x, then h, transposed
  float* Ws = As + C * AP;       // [2][KS][C]: weight slabs
  float* wmax = Ws + 2 * KS * C;  // [32]: the warps' maxima of the key norms
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = (warp >> 1) * 4 + (lane >> 3);  // row group
  const int tx = (warp & 1) * 8 + (lane & 7);    // column group
  const int b = blockIdx.y, r0 = blockIdx.x * R;
  const size_t base = static_cast<size_t>(b) * a.n;

  auto load_slab = [&](int s) {
    const int m = s / SLABS_PER_MATRIX, k0 = (s % SLABS_PER_MATRIX) * KS;
    const int part = m == 1 ? 0 : (m == 2 ? 2 : 1);  // q, v, then k
    const float* src = m == 0 ? a.w1 + k0 * C : a.wqkv + k0 * 3 * C + part * C;
    const int stride = m == 0 ? C : 3 * C;
    float* dst = Ws + (s & 1) * KS * C;
    for (int i = tid; i < KS * C / 4; i += NT) {
      const int r = i / (C / 4), c4 = (i % (C / 4)) * 4;
      cp_async16(dst + r * C + c4, src + r * stride + c4);
    }
    cp_async_commit();
  };

  load_slab(0);
  // x transposed; the lanes of a warp take consecutive rows of one channel
  // group, so that their shared-memory stores fall in distinct banks
#pragma unroll 4
  for (int i = tid; i < R * C / 4; i += NT) {
    const int r = i % R, c4 = (i / R) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < a.n) x = oa::load4(a.x + (base + r0 + r) * C + c4);
    As[(c4 + 0) * AP + r] = x.x;
    As[(c4 + 1) * AP + r] = x.y;
    As[(c4 + 2) * AP + r] = x.z;
    As[(c4 + 3) * AP + r] = x.w;
  }

  float acc[TM][8];
  for (int s = 0; s < SLABS; ++s) {
    if (s + 1 < SLABS) {
      load_slab(s + 1);  // into the buffer slab s - 1 used: done, by the barrier below
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // slab s, and the A tile of its matrix, are in shared memory
    const int m = s / SLABS_PER_MATRIX;
    if (s % SLABS_PER_MATRIX == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    const float* W = Ws + (s & 1) * KS * C;
    const float* A = As + (s % SLABS_PER_MATRIX) * KS * AP;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const float4 a0 = oa::load4(A + kk * AP + ty * 4);
      const float4 w0 = oa::load4(W + kk * C + tx * 4), w1 = oa::load4(W + kk * C + 64 + tx * 4);
      const float av[TM] = {a0.x, a0.y, a0.z, a0.w};
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();  // buffer s & 1 is free, and at a matrix's end so is its A tile
    if (s % SLABS_PER_MATRIX != SLABS_PER_MATRIX - 1) continue;

    if (m == 0) {
      // h = relu(x W1 + b1): to device memory, and transposed over x
      const float4 bl = oa::load4(a.b1 + tx * 4), bh = oa::load4(a.b1 + 64 + tx * 4);
      const float bias[8] = {bl.x, bl.y, bl.z, bl.w, bh.x, bh.y, bh.z, bh.w};
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaxf(acc[i][j] + bias[j], 0.f);
        const int row = ty * 4 + i;
        if (r0 + row < a.n) {
          float* hrow = a.h + (base + r0 + row) * C;
          *reinterpret_cast<float4*>(hrow + tx * 4) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          *reinterpret_cast<float4*>(hrow + 64 + tx * 4) =
              make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4);
        *reinterpret_cast<float4*>(As + col * AP + ty * 4) =
            make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
      }
      continue;  // the next iteration's barrier publishes h
    }

    // q, v, then k = h W + b, rounded to bf16
    const int part = m == 1 ? 0 : (m == 2 ? 2 : 1);
    __nv_bfloat16* out = part == 0 ? a.q : (part == 1 ? a.k : a.v);
    const float* bp = a.bqkv + part * C;
    const float4 bl = oa::load4(bp + tx * 4), bh = oa::load4(bp + 64 + tx * 4);
    const float bias[8] = {bl.x, bl.y, bl.z, bl.w, bh.x, bh.y, bh.z, bh.w};
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      uint32_t bits[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16 val = __float2bfloat16_rn(acc[i][j] + bias[j]);
        bits[j] = __bfloat16_as_ushort(val);
        acc[i][j] = __bfloat162float(val);
      }
      const int row = ty * 4 + i;
      if (r0 + row < a.n) {
        __nv_bfloat16* orow = out + (base + r0 + row) * C;
        *reinterpret_cast<uint2*>(orow + tx * 4) =
            make_uint2(bits[0] | (bits[1] << 16), bits[2] | (bits[3] << 16));
        *reinterpret_cast<uint2*>(orow + 64 + tx * 4) =
            make_uint2(bits[4] | (bits[5] << 16), bits[6] | (bits[7] << 16));
      }
    }
    if (part != 1) continue;
    // The norms of the rounded key rows, summed as pcn_qkv_tile sums them (so
    // that kscale is the one-launch kernel's, bit for bit): lane l of a warp
    // takes columns l + 32 j of a row, then a butterfly over the 32 lanes.
    // The rows go through the A tile, free after the last product.
    constexpr int KP = C + 4;  // row of the rounded keys
    static_assert(R * KP <= C * AP, "the key rows must fit the A tile");
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float* krow = As + (ty * 4 + i) * KP;
      *reinterpret_cast<float4*>(krow + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(krow + 64 + tx * 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
    __syncthreads();
    float kmax_sq = 0.f;
    for (int row = warp; row < R; row += NT / 32) {
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float vf = As[row * KP + lane + 32 * j];
        sq = fmaf(vf, vf, sq);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
      if (r0 + row < a.n) kmax_sq = fmaxf(kmax_sq, sq);
    }
    if (lane == 0) wmax[warp] = kmax_sq;
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < NT / 32; ++w) kmax_sq = fmaxf(kmax_sq, wmax[w]);
      atomicMax(reinterpret_cast<unsigned int*>(a.kscale + b),
                __float_as_uint(sqrtf(kmax_sq) * a.inv_sqrt_c));
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2) attn_mlp_kernel(LayerArgs a) {
  extern __shared__ __align__(16) float smem[];
  attn_mlp_tile(a, blockIdx.y, blockIdx.x * BQ, smem);
}

// ---------------------------------------------------------------- above C = 128
//
// A wider model runs as the split pair at every N, on the same wrappers: its
// channels zero-padded to ld = 128 m (the message MLP's C/2 to ldh, a
// multiple of 64; q, k and v each within their own third of Wqkv), so that
// the padded channels stay exact zeros. The one-launch kernel keeps a C x C
// weight matrix in shared memory (64 KB at 128) and does not run there.
//
// Both kernels own 32 rows a block (256 threads) and compute their Dense
// products with wide_dense: 32 x 64 output tiles, each thread 4 rows x 2
// columns in registers, the A rows and the weights streamed through shared
// memory in 64-deep k-slabs, so no tile grows with C. The weights are re-read
// from L2 by every block; these kernels are for widths no shipped model has,
// and are simple rather than fast.
//   pcn_qkv_wide_kernel: h = relu(x W1 + b1) to device memory, then q, k, v
//     = h W + b from it (the block reads back its own rows after a barrier),
//     bf16; the key norms summed over the chunks, one atomicMax a block.
//   attn_mlp_wide_kernel: m passes of the wide attention loop, one per
//     output chunk (offset_attention.cuh), the normalised rows into a
//     workspace [B, N, ld + 2 ldh] f32, then the three Dense of the message
//     MLP through the same workspace and the residual.

constexpr int WK = 64;        // k rows of a slab
constexpr int WN = 64;        // output columns of a tile
constexpr int WAP = WK + 1;   // row of the A slab

// acc[r][j] = sum_k A[row][k] W[k][col0 + cx + 32 j] for row = 4 ry + r, over
// k < kdim (a multiple of WK); A [rows, kdim] with row stride lda in device
// memory (rows >= nrows read as 0), W [kdim, ldw]. Starts with a barrier, so
// rows the block wrote before the call are read back.
__device__ __forceinline__ void wide_dense(const float* A, int lda, int nrows, const float* W,
                                           int ldw, int kdim, int col0, float* As, float* Ws,
                                           float (&acc)[4][2]) {
  const int tid = threadIdx.x, ry = tid >> 5, cx = tid & 31;
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r][0] = acc[r][1] = 0.f;
  for (int k0 = 0; k0 < kdim; k0 += WK) {
    __syncthreads();  // the previous slab's readers are done
    for (int i = tid; i < BQ * WK / 4; i += THREADS) {
      const int r = i / (WK / 4), c4 = (i % (WK / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < nrows) x = oa::load4(A + static_cast<size_t>(r) * lda + k0 + c4);
      oa::store_padded(As + r * WAP, c4, x);
    }
    for (int i = tid; i < WK * WN / 4; i += THREADS) {
      const int r = i / (WN / 4), c4 = (i % (WN / 4)) * 4;
      *reinterpret_cast<float4*>(Ws + r * WN + c4) =
          oa::load4(W + static_cast<size_t>(k0 + r) * ldw + col0 + c4);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < WK; ++kk) {
      const float w0 = Ws[kk * WN + cx], w1 = Ws[kk * WN + cx + 32];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = As[(4 * ry + r) * WAP + kk];
        acc[r][0] = fmaf(a, w0, acc[r][0]);
        acc[r][1] = fmaf(a, w1, acc[r][1]);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS) pcn_qkv_wide_kernel(LayerArgs a, int ld) {
  __shared__ __align__(16) float As[BQ * WAP];
  __shared__ __align__(16) float Ws[WK * WN];
  __shared__ float wmax[THREADS / 32];
  const int tid = threadIdx.x, ry = tid >> 5, cx = tid & 31;
  const int b = blockIdx.y, r0 = blockIdx.x * BQ;
  const int rows = min(BQ, a.n - r0);
  const size_t at0 = (static_cast<size_t>(b) * a.n + r0) * ld;
  float acc[4][2];

  float* h = a.h + at0;
  for (int col0 = 0; col0 < ld; col0 += WN) {
    wide_dense(a.x + at0, ld, rows, a.w1, ld, ld, col0, As, Ws, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = 4 * ry + r, col = col0 + cx + 32 * j;
        if (row < rows)
          h[static_cast<size_t>(row) * ld + col] = fmaxf(acc[r][j] + a.b1[col], 0.f);
      }
  }

  float ksq[4] = {0.f, 0.f, 0.f, 0.f};  // a row's squared key norm, over the tiles
  for (int part = 0; part < 3; ++part) {
    __nv_bfloat16* out = (part == 0 ? a.q : (part == 1 ? a.k : a.v)) + at0;
    for (int col0 = 0; col0 < ld; col0 += WN) {
      wide_dense(h, ld, rows, a.wqkv + part * ld, 3 * ld, ld, col0, As, Ws, acc);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 4 * ry + r;
        float sq = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = col0 + cx + 32 * j;
          const __nv_bfloat16 val = __float2bfloat16_rn(acc[r][j] + a.bqkv[part * ld + col]);
          if (row < rows) out[static_cast<size_t>(row) * ld + col] = val;
          const float vf = __bfloat162float(val);
          sq = fmaf(vf, vf, sq);
        }
        if (part == 1) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
          ksq[r] += sq;
        }
      }
    }
  }
  float kmax_sq = 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (4 * ry + r < rows) kmax_sq = fmaxf(kmax_sq, ksq[r]);
  if (cx == 0) wmax[ry] = kmax_sq;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < THREADS / 32; ++w) kmax_sq = fmaxf(kmax_sq, wmax[w]);
    atomicMax(reinterpret_cast<unsigned int*>(a.kscale + b),
              __float_as_uint(sqrtf(kmax_sq) * a.inv_sqrt_c));
  }
}

__global__ void __launch_bounds__(THREADS, 2)
attn_mlp_wide_kernel(LayerArgs a, int ld, int ldh, float* ws) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, ry = tid >> 5, cx = tid & 31;
  const int b = blockIdx.y, q0 = blockIdx.x * BQ;
  const int rows = min(BQ, a.n - q0);
  const size_t base = static_cast<size_t>(b) * a.n;
  const int wsr = ld + 2 * ldh;  // a workspace row: o, then the MLP's two intermediates
  float* o = ws + (base + q0) * wsr;
  float* m0 = o + ld;
  float* m1 = m0 + ldh;
  const float kscale = __ldcg(a.kscale + b);

  for (int oc = 0; oc < ld / C; ++oc) {
    float acc[4][4];
    oa::attention_rows<false, oa::kCacheInt8, true>(
        a.q + base * ld, a.k + base * ld, a.v + base * ld, a.compat + base * a.n,
        a.kbias ? a.kbias + base : nullptr, kscale, a.n, q0, a.qk_scale, smem, acc, nullptr,
        0.f, ld, oc);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 4 * ry + r;
      const float l = smem[oa::OFF_L + row] + 1e-30f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (row < rows) o[static_cast<size_t>(row) * wsr + C * oc + cx + 32 * j] = acc[r][j] / l;
    }
  }

  float* As = smem + oa::OFF_V;
  float* Ws = As + BQ * WAP;
  float acc[4][2];
  for (int col0 = 0; col0 < ldh; col0 += WN) {
    wide_dense(o, wsr, rows, a.wm0, ldh, ld, col0, As, Ws, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = 4 * ry + r, col = col0 + cx + 32 * j;
        if (row < rows)
          m0[static_cast<size_t>(row) * wsr + col] = fmaxf(acc[r][j] + a.bm0[col], 0.f);
      }
  }
  for (int col0 = 0; col0 < ldh; col0 += WN) {
    wide_dense(m0, wsr, rows, a.wm1, ldh, ldh, col0, As, Ws, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = 4 * ry + r, col = col0 + cx + 32 * j;
        if (row < rows)
          m1[static_cast<size_t>(row) * wsr + col] = fmaxf(acc[r][j] + a.bm1[col], 0.f);
      }
  }
  for (int col0 = 0; col0 < ld; col0 += WN) {
    wide_dense(m1, wsr, rows, a.wm2, ld, ldh, col0, As, Ws, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = 4 * ry + r, col = col0 + cx + 32 * j;
        if (row >= rows) continue;
        const size_t at = (base + q0 + row) * ld + col;
        a.out[at] = a.h[at] + (acc[r][j] + a.bm2[col]);
      }
  }
}

template <typename K>
cudaError_t opt_in_smem(K kernel) {
  // per call: the attribute belongs to the current device
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(oa::SMEM_BYTES));
}

}  // namespace

extern "C" int fused_encoder_layer(const void* x, const void* compat, const void* kbias,
                                   const void* w1, const void* b1, const void* wqkv,
                                   const void* bqkv, const void* wm0, const void* bm0,
                                   const void* wm1, const void* bm1, const void* wm2,
                                   const void* bm2, void* h, void* q, void* k, void* v,
                                   void* kscale, void* out, int batch, int n, float qk_scale,
                                   float inv_sqrt_c, void* stream) {
  LayerArgs a{static_cast<const float*>(x), static_cast<const int8_t*>(compat),
              static_cast<const float*>(kbias), static_cast<const float*>(w1),
              static_cast<const float*>(b1), static_cast<const float*>(wqkv),
              static_cast<const float*>(bqkv), static_cast<const float*>(wm0),
              static_cast<const float*>(bm0), static_cast<const float*>(wm1),
              static_cast<const float*>(bm1), static_cast<const float*>(wm2),
              static_cast<const float*>(bm2), static_cast<float*>(h),
              static_cast<__nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(k),
              static_cast<__nv_bfloat16*>(v), static_cast<float*>(kscale),
              static_cast<float*>(out), batch, n, qk_scale, inv_sqrt_c};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = opt_in_smem(fused_layer_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_layer_kernel, THREADS,
                                                      oa::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const int work = batch * ((n + BQ - 1) / BQ);
  const int grid = work < per_sm * sms ? work : per_sm * sms;
  err = cudaMemsetAsync(kscale, 0, sizeof(float) * batch, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fused_layer_kernel), dim3(grid),
                                    dim3(THREADS), params, oa::SMEM_BYTES, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ld: the row width of x, h, q, k, v (128, or a wider model's 128 m)
extern "C" int pcn_qkv(const void* x, const void* w1, const void* b1, const void* wqkv,
                       const void* bqkv, void* h, void* q, void* k, void* v, void* kscale,
                       int batch, int n, int ld, float inv_sqrt_c, void* stream) {
  LayerArgs a{};
  a.x = static_cast<const float*>(x);
  a.w1 = static_cast<const float*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.wqkv = static_cast<const float*>(wqkv);
  a.bqkv = static_cast<const float*>(bqkv);
  a.h = static_cast<float*>(h);
  a.q = static_cast<__nv_bfloat16*>(q);
  a.k = static_cast<__nv_bfloat16*>(k);
  a.v = static_cast<__nv_bfloat16*>(v);
  a.kscale = static_cast<float*>(kscale);
  a.batch = batch;
  a.n = n;
  a.inv_sqrt_c = inv_sqrt_c;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ld != C) {
    if (ld % C) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = cudaMemsetAsync(kscale, 0, sizeof(float) * batch, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    pcn_qkv_wide_kernel<<<dim3((n + BQ - 1) / BQ, batch), THREADS, 0, s>>>(a, ld);
    return static_cast<int>(cudaGetLastError());
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // The attribute belongs to the device: set it once per device.
  static std::atomic<bool> opted_in[MAX_DEVICES] = {};
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted_in[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(pcn_qkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(SPLIT_SMEM_BYTES));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev].store(true, std::memory_order_release);
  }
  err = cudaMemsetAsync(kscale, 0, sizeof(float) * batch, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  pcn_qkv_kernel<<<dim3((n + PR - 1) / PR, batch), PNT, SPLIT_SMEM_BYTES, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ld: the row width of q, k, v, h and out; ldh the message MLP's inner width
// (C = 128: ld 128, ldh 64, ws unused; wider: ld = 128 m, ldh a multiple of
// 64, ws [B, N, ld + 2 ldh] f32)
extern "C" int attn_mlp_residual(const void* kscale, const void* q, const void* k, const void* v,
                                 const void* compat, const void* kbias, const void* h,
                                 const void* wm0, const void* bm0, const void* wm1,
                                 const void* bm1, const void* wm2, const void* bm2, void* out,
                                 void* ws, int batch, int n, int ld, int ldh, float qk_scale,
                                 void* stream) {
  LayerArgs a{};
  // the kernel only reads these five; the struct is shared with the one-launch form
  a.kscale = const_cast<float*>(static_cast<const float*>(kscale));
  a.q = const_cast<__nv_bfloat16*>(static_cast<const __nv_bfloat16*>(q));
  a.k = const_cast<__nv_bfloat16*>(static_cast<const __nv_bfloat16*>(k));
  a.v = const_cast<__nv_bfloat16*>(static_cast<const __nv_bfloat16*>(v));
  a.h = const_cast<float*>(static_cast<const float*>(h));
  a.compat = static_cast<const int8_t*>(compat);
  a.kbias = static_cast<const float*>(kbias);
  a.wm0 = static_cast<const float*>(wm0);
  a.bm0 = static_cast<const float*>(bm0);
  a.wm1 = static_cast<const float*>(wm1);
  a.bm1 = static_cast<const float*>(bm1);
  a.wm2 = static_cast<const float*>(wm2);
  a.bm2 = static_cast<const float*>(bm2);
  a.out = static_cast<float*>(out);
  a.batch = batch;
  a.n = n;
  a.qk_scale = qk_scale;
  const dim3 grid((n + BQ - 1) / BQ, batch);
  if (ld != C) {
    if (ld % C || ldh < WN || ldh % WN || ws == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = opt_in_smem(attn_mlp_wide_kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_mlp_wide_kernel<<<grid, THREADS, oa::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
        a, ld, ldh, static_cast<float*>(ws));
    return static_cast<int>(cudaGetLastError());
  }
  if (ldh != CH) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = opt_in_smem(attn_mlp_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_mlp_kernel<<<grid, THREADS, oa::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
