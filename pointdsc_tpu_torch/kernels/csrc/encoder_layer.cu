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

__global__ void __launch_bounds__(THREADS) pcn_qkv_kernel(LayerArgs a) {
  extern __shared__ __align__(16) float smem[];
  pcn_qkv_tile(a, blockIdx.y, blockIdx.x * BQ, smem);
}

__global__ void __launch_bounds__(THREADS, 2) attn_mlp_kernel(LayerArgs a) {
  extern __shared__ __align__(16) float smem[];
  attn_mlp_tile(a, blockIdx.y, blockIdx.x * BQ, smem);
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

extern "C" int pcn_qkv(const void* x, const void* w1, const void* b1, const void* wqkv,
                       const void* bqkv, void* h, void* q, void* k, void* v, void* kscale,
                       int batch, int n, float inv_sqrt_c, void* stream) {
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
  cudaError_t err = opt_in_smem(pcn_qkv_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(kscale, 0, sizeof(float) * batch, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BQ - 1) / BQ, batch);
  pcn_qkv_kernel<<<grid, THREADS, oa::SMEM_BYTES, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int attn_mlp_residual(const void* kscale, const void* q, const void* k, const void* v,
                                 const void* compat, const void* kbias, const void* h,
                                 const void* wm0, const void* bm0, const void* wm1,
                                 const void* bm1, const void* wm2, const void* bm2, void* out,
                                 int batch, int n, float qk_scale, void* stream) {
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
  const cudaError_t err = opt_in_smem(attn_mlp_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BQ - 1) / BQ, batch);
  attn_mlp_kernel<<<grid, THREADS, oa::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
