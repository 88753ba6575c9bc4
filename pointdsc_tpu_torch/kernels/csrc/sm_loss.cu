// Spectral-matching loss without the [N, N] feature-similarity matrix,
// forward and backward, CUDA C++ for sm_90a.
//
// Replaces the TPU kernels pointdsc_tpu/kernels/sm_loss.py:87
// (_sm_loss_fwd_kernel, pallas_call :169) and :108 (_sm_loss_bwd_kernel,
// pallas_call :191). Per pair (i, j):
//
//   S = F_i F_j^T,  u = 1 - (1 - S) / sigma^2,  M = clip(u, 0, 1) off the
//   diagonal (0 on it),  pm = valid_i valid_j,  gtM = gt_i gt_j off the diagonal;
//   forward:  sum_p += (M - 1)^2 gtM,   sum_n += M^2 (pm - gtM);
//   backward: g = wp 2 (M - 1) gtM + wn 2 M (pm - gtM),
//             gate = [0 < u < 1] off the diagonal, times pm,
//             dF_i += (2 / sigma^2) (g gate) F_j       (2: the mirrored pair),
//             dsigma += sum g gate 2 (1 - S) / sigma^3.
//
// F [B, N, 128] f32; strips [B, 8, N] f32 (row 0 gt masked to 0, row 1
// valid); scalars [B, 4] f32 (sigma, wp, wn, unused), read from device memory
// so that the learned sigma never passes through the host.
//
// The TPU kernels keep one scalar alive across a sequential grid. A CUDA grid
// has no order, so each block writes its partial sums to a small buffer and
// the wrapper adds them in a fixed order: the loss is the same from run to
// run, which f32 atomics on one scalar would not give. In the backward a
// block owns 64 rows of dF and walks the column tiles itself. Rows past N
// read as 0, so every N is taken.
//
// Bound on the H100: f32 operands, so the CUDA cores' 67 TFLOP/s. Every term
// is symmetric in (i, j) and the diagonal's is 0, so the forward's least work
// is 2 C operations for each of the N (N - 1) / 2 unordered pairs; the
// backward's dF rows each have one owner, so it makes 4 C for each ordered
// pair. Both read one [N, C] stream.
//
// At C = 128 (sm_loss_fwd128_kernel, sm_loss_bwd128_kernel) both are built
// for the FMA rate on f32_tiles.cuh's layout (their notes below). Above
// (sm_loss_fwd_kernel, sm_loss_bwd_kernel), F is [B, N, ld], the model's
// channels zero-padded to ld = 128 m: 64 x 64 tiles staged through shared
// memory with scalar FMAs, the tile products S summed over the m chunks,
// staged one at a time into the same 128-wide tiles; the backward makes one
// pass per 128-wide chunk of dF, recomputing S (in one chunk order, so every
// pass sees the same S and g) and adding dsigma in its first pass only.

#include <cuda_runtime.h>
#include <math.h>

#include "f32_tiles.cuh"

namespace {

constexpr int C = 128;  // a narrower model is zero-padded to it by the wrapper
constexpr int TS = 64;  // tile side above C = 128
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CP = C + 1;
constexpr int PP = TS + 1;
constexpr int SROWS = 2;  // strip rows the kernels read
constexpr int SSTRIDE = 8;

// rows [r0, r0 + TS), channels [col0, col0 + C) of a [n, ld] array, zeros past n
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int r0,
                                          int n, int ld, int col0) {
  for (int i = threadIdx.x; i < TS * C / 4; i += THREADS) {
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

// gt and valid of rows [r0, r0 + TS): dst[0..TS) gt, dst[TS..2 TS) valid; 0 past n
__device__ __forceinline__ void load_strip(float* dst, const float* __restrict__ strip, int r0,
                                           int n) {
  for (int i = threadIdx.x; i < SROWS * TS; i += THREADS) {
    const int r = i / TS, c = i % TS;
    dst[i] = (r0 + c < n) ? strip[static_cast<size_t>(r) * n + r0 + c] : 0.f;
  }
}

// S for the thread's 4 x 4 entries, rows 4 ty + r, columns tx + 16 j, added
// to s: the sum over a further chunk of channels
__device__ __forceinline__ void tile_products(const float* Fi, const float* Fj, int ty, int tx,
                                              float s[4][4]) {
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    float a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = Fi[(4 * ty + r) * CP + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Fj[(tx + 16 * j) * CP + c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = fmaf(a[r], b[j], s[r][j]);
  }
}

// sum over the block in a fixed order; the result is valid in thread 0
__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  __syncthreads();  // red may still be read from an earlier call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < WARPS; ++w) total += red[w];
  return total;
}

constexpr int OFF_FI = 0;
constexpr int OFF_FJ = OFF_FI + TS * CP;
constexpr int OFF_LI = OFF_FJ + TS * CP;
constexpr int OFF_LJ = OFF_LI + SROWS * TS;
constexpr int OFF_RED = OFF_LJ + SROWS * TS;
constexpr int OFF_GG = OFF_RED + WARPS;  // backward only
constexpr size_t FWD_SMEM_BYTES = OFF_GG * sizeof(float);
constexpr size_t BWD_SMEM_BYTES = (OFF_GG + TS * PP) * sizeof(float);

// S over the m = ld / C chunks of rows [i0, i0 + TS) and [j0, j0 + TS): the
// chunks staged into Fi and Fj in turn; starts with a barrier
__device__ __forceinline__ void wide_products(const float* __restrict__ f, int i0, int j0, int n,
                                              int ld, float* Fi, float* Fj, int ty, int tx,
                                              float s[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
  for (int ch = 0; ch < ld / C; ++ch) {
    __syncthreads();  // the previous chunk's readers are done
    load_rows(Fi, f, i0, n, ld, C * ch);
    load_rows(Fj, f, j0, n, ld, C * ch);
    __syncthreads();
    tile_products(Fi, Fj, ty, tx, s);
  }
}

// ------------------------------------------------------- above C = 128

__global__ void __launch_bounds__(THREADS)
sm_loss_fwd_kernel(const float* __restrict__ f, const float* __restrict__ strips,
                   const float* __restrict__ scalars, float* __restrict__ partial, int n,
                   int ld) {
  extern __shared__ __align__(16) float smem[];
  float* Fi = smem + OFF_FI;
  float* Fj = smem + OFF_FJ;
  float* Li = smem + OFF_LI;
  float* Lj = smem + OFF_LJ;
  float* red = smem + OFF_RED;

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * TS, j0 = blockIdx.x * TS;
  f += static_cast<size_t>(b) * n * ld;
  strips += static_cast<size_t>(b) * SSTRIDE * n;
  const float sigma = scalars[b * 4];
  const float sig2 = sigma * sigma;

  load_strip(Li, strips, i0, n);
  load_strip(Lj, strips, j0, n);
  __syncthreads();

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float s[4][4];
  wide_products(f, i0, j0, n, ld, Fi, Fj, ty, tx, s);

  float sum_p = 0.f, sum_n = 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 4 * ty + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      const float offdiag = (i0 + row != j0 + col) ? 1.f : 0.f;
      const float u = 1.0f - (1.0f - s[r][j]) / sig2;
      const float m = fminf(fmaxf(u, 0.f), 1.f) * offdiag;
      const float pm = Li[TS + row] * Lj[TS + col];
      const float gtm = Li[row] * Lj[col] * offdiag;
      sum_p += (m - 1.0f) * (m - 1.0f) * gtm;
      sum_n += m * m * (pm - gtm);
    }
  }
  const float tp = block_sum(sum_p, red);
  const float tn = block_sum(sum_n, red);
  if (threadIdx.x == 0) {
    const size_t tile = (static_cast<size_t>(b) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    partial[tile * 2] = tp;
    partial[tile * 2 + 1] = tn;
  }
}

__global__ void __launch_bounds__(THREADS)
sm_loss_bwd_kernel(const float* __restrict__ f, const float* __restrict__ strips,
                   const float* __restrict__ scalars, float* __restrict__ df,
                   float* __restrict__ dsigma_partial, int n, int ld) {
  extern __shared__ __align__(16) float smem[];
  float* Fi = smem + OFF_FI;
  float* Fj = smem + OFF_FJ;
  float* Li = smem + OFF_LI;
  float* Lj = smem + OFF_LJ;
  float* red = smem + OFF_RED;
  float* GG = smem + OFF_GG;

  const int b = blockIdx.y;
  const int i0 = blockIdx.x * TS;
  const int chunks = ld / C;
  f += static_cast<size_t>(b) * n * ld;
  df += static_cast<size_t>(b) * n * ld;
  strips += static_cast<size_t>(b) * SSTRIDE * n;
  const float sigma = scalars[b * 4], wp = scalars[b * 4 + 1], wn = scalars[b * 4 + 2];
  const float sig2 = sigma * sigma;

  load_strip(Li, strips, i0, n);

  // phase-1 layout: 16 row quads x 16 column lanes (columns tx + 16 j)
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  // phase-2 layout: 8 row octets x 32 column lanes (columns cx + 32 j)
  const int ry = threadIdx.x >> 5, cx = threadIdx.x & 31;

  for (int oc = 0; oc < chunks; ++oc) {
    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
    float dsig = 0.f;

    for (int j0 = 0; j0 < n; j0 += TS) {
      __syncthreads();  // the previous tile's readers are done
      load_strip(Lj, strips, j0, n);
      __syncthreads();

      float s[4][4];
      wide_products(f, i0, j0, n, ld, Fi, Fj, ty, tx, s);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 4 * ty + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          const float offdiag = (i0 + row != j0 + col) ? 1.f : 0.f;
          const float u = 1.0f - (1.0f - s[r][j]) / sig2;
          const float m = fminf(fmaxf(u, 0.f), 1.f) * offdiag;
          const float pm = Li[TS + row] * Lj[TS + col];
          const float gtm = Li[row] * Lj[col] * offdiag;
          const float g = wp * 2.0f * (m - 1.0f) * gtm + wn * 2.0f * m * (pm - gtm);
          const float gate = (u > 0.f && u < 1.f) ? offdiag * pm : 0.f;
          const float gg = g * gate;
          GG[row * PP + col] = gg;
          dsig += gg * 2.0f * (1.0f - s[r][j]);
        }
      }
      __syncthreads();
      if (oc != chunks - 1) {  // the tile's chunk of dF (the products left the last one)
        load_rows(Fj, f, j0, n, ld, C * oc);
        __syncthreads();
      }

#pragma unroll 4
      for (int kk = 0; kk < TS; ++kk) {
        float fv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) fv[j] = Fj[kk * CP + cx + 32 * j];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float gg = GG[(8 * ry + r) * PP + kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(gg, fv[j], acc[r][j]);
        }
      }
    }

    const float coef = 2.0f / sig2;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = 8 * ry + r;
      if (i0 + row >= n) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        df[static_cast<size_t>(i0 + row) * ld + C * oc + cx + 32 * j] = coef * acc[r][j];
    }
    if (oc == 0) {  // every pass sums the same dsigma
      const float total = block_sum(dsig, red);
      if (threadIdx.x == 0)
        dsigma_partial[static_cast<size_t>(b) * gridDim.x + blockIdx.x] = total / (sig2 * sigma);
    }
  }  // output chunks
}

// ------------------------------------------------------------- C = 128
//
// f32_tiles.cuh's layout, as the trainable attention's C = 128 kernels use
// it: a block of 8 warps owns OWN = 64 rows of F, copied once with their
// strip entries (gt, valid), and walks 32-row tiles of F, each copied by
// cp.async with its strip entries while the one before it is worked
// (zero-filled past n, so that pm and gtM vanish there).
// - Phase 1: warp_rows_dot gives lane (tg, kg) = (lane / 8, lane % 8) S of
//   own row 8w + kg against tile rows tg + 4t (t = 0..7); the lane makes the
//   pair terms of its 8 pairs. u is the plain version's for the same S (u_of);
//   S sums the channels in another order, so a u within rounding of 0 or 1
//   may fall on the other side of the gate: the sums are continuous there,
//   dF moves by that pair's term (kernels/sm_loss.py::grads_gate_slack).
// - Sums (sm_loss_fwd128_kernel): each unordered pair once. A work item is
//   (owned block o, a run of tiles at or past o's diagonal); the diagonal
//   64 x 64 block is walked in full at weight 1, so each of its unordered
//   pairs counts as (i, j) and as (j, i), and every tile past it at weight
//   2 (exact in f32): each unordered pair counts twice, as in the sum over
//   all ordered pairs. The items come from the wrapper's plan
//   (kernels/sm_loss.py::sums_plan), longest first; a lane adds its pair
//   terms in registers in a fixed order, and the block's sum is one
//   (sum_p, sum_n) partial per item and sample. One block an SM: at two, the
//   128-register cap costs more instructions (and a spill) than the second
//   block hides.
// - Gradients (sm_loss_bwd128_kernel): the lane stores g gate of its 8 pairs
//   in a [TILE][OWN] stage (the owned rows contiguous) and adds the dsigma
//   terms in registers; phase 2 is 8 x 8 register tiles of owned rows x
//   channels (cq + {0..3}, 64 + the same), warps 0-3 over the tile's rows
//   0-15, warps 4-7 over 16-31. Every FLUSH tiles a lane adds its register
//   tile into its own entries of its half's f32 sums in shared memory and
//   starts again from 0: chains of 128 terms, not N / 2, so that dF keeps
//   within 1e-6 of its largest entry at N = 12288 (one chain of 3072 terms
//   drifted 1.07e-6). The two halves' sums are added once at the end. Where
//   the row blocks alone leave the card part-empty (kernels/sm_loss.py::
//   grads_plan), each row block's walk is split into two consecutive runs
//   of tiles: the first writes its dF to df, the second to a workspace that
//   the wrapper adds (a + b, the same either way); each run's dsigma is its
//   own partial. One block an SM (the 64 + 64 accumulators).
// Every sum has one owner and a fixed order: the result is the same from run
// to run.

namespace b128 {

using f32_tiles::copy_cols;
using f32_tiles::copy_rows;
using f32_tiles::cp_async_commit;
using f32_tiles::cp_async_wait_all;
using f32_tiles::ld4;
using f32_tiles::warp_rows_dot;
static_assert(f32_tiles::C == C && f32_tiles::THREADS == THREADS, "one layout");

constexpr int OWN = 64;
constexpr int TILE = 32;
constexpr int DS = OWN + 8;  // row of the [TILE][OWN] g gate stage
constexpr int STAGES = 2;
constexpr int S_FO = 0;                             // [OWN][C] owned rows
constexpr int S_FT = S_FO + OWN * C;                // [STAGES][TILE][C]
constexpr int S_LO = S_FT + STAGES * TILE * C;      // [SROWS][OWN] gt, valid of the owned rows
constexpr int S_LT = S_LO + SROWS * OWN;            // [STAGES][SROWS][TILE]
constexpr int S_RED = S_LT + STAGES * SROWS * TILE; // [WARPS]
constexpr int S_GG = S_RED + WARPS;                 // [TILE][DS] g gate (gradients only)
constexpr int S_ACC = S_GG + TILE * DS;             // [2][OWN][C] each half's flushed dF sums
constexpr size_t BYTES_FWD = S_GG * sizeof(float);
constexpr size_t BYTES_BWD = (S_ACC + 2 * OWN * C) * sizeof(float);
constexpr int FLUSH = 8;  // tiles a register chain of dF sums runs before it is flushed
static_assert(S_GG % 4 == 0 && S_ACC % 4 == 0 && DS % 4 == 0, "16-byte aligned rows");
static_assert(OWN == 8 * WARPS && TILE == 32, "the lane roles above");

// u = 1 - (1 - s) / sig2 with the quotient the f32 division's bits: the
// double product with inv_sig2 = 1 / sig2, rounded to float (the argument of
// sc_attention_train.cu's compat_entries), so that u is the plain version's
// for the same s and the sums carry no bias of a rounded reciprocal
__device__ __forceinline__ float u_of(float s, double inv_sig2) {
  return 1.0f - __double2float_rn(__dmul_rn(static_cast<double>(1.0f - s), inv_sig2));
}

// M, pm and gtM of pair (i, j), from u and the two strip entries
struct Pair {
  float m, pm, gtm;
};
__device__ __forceinline__ Pair pair_terms(float u, bool offdiag, float gi, float vi, float gj,
                                           float vj) {
  return {offdiag ? fminf(fmaxf(u, 0.f), 1.f) : 0.f, vi * vj, offdiag ? gi * gj : 0.f};
}

}  // namespace b128

__global__ void __launch_bounds__(THREADS, 1)
sm_loss_fwd128_kernel(const float* __restrict__ f, const float* __restrict__ strips,
                      const float* __restrict__ scalars, const int* __restrict__ plan,
                      float* __restrict__ partial, int n, int batch) {
  using namespace b128;
  extern __shared__ __align__(16) float smem[];
  const float* Lo = smem + S_LO;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int item = blockIdx.x / batch, b = blockIdx.x % batch;
  const int o = plan[3 * item], first = plan[3 * item + 1], count = plan[3 * item + 2];
  const int o0 = o * OWN;
  f += static_cast<size_t>(b) * n * C;
  strips += static_cast<size_t>(b) * SSTRIDE * n;
  const float sigma = scalars[b * 4];
  const double inv_sig2 = 1.0 / static_cast<double>(sigma * sigma);

  auto issue_tile = [&](int tile, int st) {
    copy_rows<TILE>(smem + S_FT + st * TILE * C, f, tile * TILE, n);
    copy_cols<TILE>(smem + S_LT + st * SROWS * TILE, strips, SROWS, tile * TILE, n);
    cp_async_commit();
  };
  copy_rows<OWN>(smem + S_FO, f, o0, n);
  copy_cols<OWN>(smem + S_LO, strips, SROWS, o0, n);
  issue_tile(first, 0);  // one group with the owned rows

  const int kg = lane & 7, tg = lane >> 3;
  const int ro = 8 * warp + kg;  // own row of the lane's sums
  float sum_p = 0.f, sum_n = 0.f;
  for (int t = 0; t < count; ++t) {
    const int st = t & 1, tile = first + t, t0 = tile * TILE;
    cp_async_wait_all();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    if (t + 1 < count) issue_tile(tile + 1, st ^ 1);
    const float* Lt = smem + S_LT + st * SROWS * TILE;

    float s[8];
    warp_rows_dot(smem + S_FO + 8 * warp * C, smem + S_FT + st * TILE * C, kg, tg, s);
    const float gi = Lo[ro], vi = Lo[OWN + ro];
    float tp = 0.f, tn = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tg + 4 * j;
      const float u = u_of(s[j], inv_sig2);
      const Pair p = pair_terms(u, o0 + ro != t0 + col, gi, vi, Lt[col], Lt[TILE + col]);
      tp += (p.m - 1.0f) * (p.m - 1.0f) * p.gtm;
      tn += p.m * p.m * (p.pm - p.gtm);
    }
    const float w = (tile >> 1) == o ? 1.f : 2.f;  // the diagonal block walks both orders
    sum_p += w * tp;
    sum_n += w * tn;
  }
  const float tp = block_sum(sum_p, smem + S_RED);
  const float tn = block_sum(sum_n, smem + S_RED);
  if (threadIdx.x == 0) {
    partial[2 * static_cast<size_t>(blockIdx.x)] = tp;
    partial[2 * static_cast<size_t>(blockIdx.x) + 1] = tn;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
sm_loss_bwd128_kernel(const float* __restrict__ f, const float* __restrict__ strips,
                      const float* __restrict__ scalars, float* __restrict__ df,
                      float* __restrict__ df_split, float* __restrict__ dsigma_partial, int n,
                      int run) {
  using namespace b128;
  extern __shared__ __align__(16) float smem[];
  const float* Lo = smem + S_LO;
  float* GG = smem + S_GG;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y, split = blockIdx.z;
  const int o0 = blockIdx.x * OWN;
  const int first = split * run, last = min((n + TILE - 1) / TILE, first + run);
  const size_t base = static_cast<size_t>(b) * n * C;
  f += base;
  strips += static_cast<size_t>(b) * SSTRIDE * n;
  const float sigma = scalars[b * 4], wp = scalars[b * 4 + 1], wn = scalars[b * 4 + 2];
  const float sig2 = sigma * sigma;
  const double inv_sig2 = 1.0 / static_cast<double>(sig2);

  auto issue_tile = [&](int tile, int st) {
    copy_rows<TILE>(smem + S_FT + st * TILE * C, f, tile * TILE, n);
    copy_cols<TILE>(smem + S_LT + st * SROWS * TILE, strips, SROWS, tile * TILE, n);
    cp_async_commit();
  };
  copy_rows<OWN>(smem + S_FO, f, o0, n);
  copy_cols<OWN>(smem + S_LO, strips, SROWS, o0, n);
  issue_tile(first, 0);  // one group with the owned rows

  const int kg = lane & 7, tg = lane >> 3;  // phase 1
  const int ro = 8 * warp + kg;             //   own row of the lane's pairs
  const int half = warp >> 2;               // phase 2
  const int rp = 16 * (warp & 3) + 8 * (lane >> 4);  // own rows rp .. rp + 7
  const int cq = 4 * (lane & 15);           //   channels cq + {0..3}, 64 + cq + {0..3}

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  float dsig = 0.f;
  // this half's sums: the lane's own entries only, so no barrier guards them
  float* sums = smem + S_ACC + half * OWN * C;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    *reinterpret_cast<float4*>(sums + (rp + r) * C + cq) = zero;
    *reinterpret_cast<float4*>(sums + (rp + r) * C + 64 + cq) = zero;
  }
  auto flush = [&]() {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float4* y0 = reinterpret_cast<float4*>(sums + (rp + r) * C + cq);
      float4* y1 = reinterpret_cast<float4*>(sums + (rp + r) * C + 64 + cq);
      const float4 s0 = *y0, s1 = *y1;
      *y0 = make_float4(s0.x + acc[r][0], s0.y + acc[r][1], s0.z + acc[r][2], s0.w + acc[r][3]);
      *y1 = make_float4(s1.x + acc[r][4], s1.y + acc[r][5], s1.z + acc[r][6], s1.w + acc[r][7]);
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
    }
  };

  for (int tile = first; tile < last; ++tile) {
    const int st = (tile - first) & 1, t0 = tile * TILE;
    cp_async_wait_all();
    __syncthreads();  // tile t has landed; phase 2 of tile t - 1 is done
    if (tile + 1 < last) issue_tile(tile + 1, st ^ 1);
    const float* Ft = smem + S_FT + st * TILE * C;
    const float* Lt = smem + S_LT + st * SROWS * TILE;

    // ---- phase 1: g gate of own row ro against tile rows tg + 4 j
    float s[8];
    warp_rows_dot(smem + S_FO + 8 * warp * C, Ft, kg, tg, s);
    const float gi = Lo[ro], vi = Lo[OWN + ro];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tg + 4 * j;
      const bool offdiag = o0 + ro != t0 + col;
      const float u = u_of(s[j], inv_sig2);
      const Pair p = pair_terms(u, offdiag, gi, vi, Lt[col], Lt[TILE + col]);
      const float g = wp * 2.0f * (p.m - 1.0f) * p.gtm + wn * 2.0f * p.m * (p.pm - p.gtm);
      const float gg = (u > 0.f && u < 1.f && offdiag) ? g * p.pm : 0.f;
      GG[col * DS + ro] = gg;
      dsig += gg * 2.0f * (1.0f - s[j]);
    }
    __syncthreads();  // g gate of the whole tile

    // ---- phase 2: own rows rp .. rp + 7 against the tile's rows
    // 16 half .. 16 half + 15
#pragma unroll 16
    for (int jj = 0; jj < TILE / 2; ++jj) {
      const int j = 16 * half + jj;
      const float4 d0 = ld4(GG + j * DS + rp), d1 = ld4(GG + j * DS + rp + 4);
      const float4 x0 = ld4(Ft + j * C + cq), x1 = ld4(Ft + j * C + 64 + cq);
      const float d[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
      const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(d[r], x[c], acc[r][c]);
    }
    if ((tile - first) % FLUSH == FLUSH - 1) flush();
  }
  flush();

  // dsigma's partial (every thread passes block_sum's barriers, which also
  // order the halves' last flushes before the reads below), then the first
  // half adds the second's sums to its own
  const float total = block_sum(dsig, smem + S_RED);
  if (threadIdx.x == 0)
    dsigma_partial[(static_cast<size_t>(split) * gridDim.y + b) * gridDim.x + blockIdx.x] =
        total / (sig2 * sigma);
  if (half) return;
  const float* other = sums + OWN * C;
  const float coef = 2.0f / sig2;
  float* out = (split ? df_split : df) + base;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = rp + r;
    if (o0 + row >= n) continue;
    const float4 a0 = ld4(sums + row * C + cq), a1 = ld4(sums + row * C + 64 + cq);
    const float4 y0 = ld4(other + row * C + cq), y1 = ld4(other + row * C + 64 + cq);
    float* o = out + static_cast<size_t>(o0 + row) * C;
    *reinterpret_cast<float4*>(o + cq) =
        make_float4(coef * (a0.x + y0.x), coef * (a0.y + y0.y), coef * (a0.z + y0.z),
                    coef * (a0.w + y0.w));
    *reinterpret_cast<float4*>(o + 64 + cq) =
        make_float4(coef * (a1.x + y1.x), coef * (a1.y + y1.y), coef * (a1.z + y1.z),
                    coef * (a1.w + y1.w));
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// ld: the row width of f and df (128, or a wider model's 128 m).
// At ld = 128: plan [items, 3] int32 on the device, each row (owned block,
// first tile, tiles) (kernels/sm_loss.py::sums_plan), partial [items, batch,
// 2]. Above: plan null, items 0, partial [batch, tiles, tiles, 2] with
// tiles = ceil(n / 64).
extern "C" int sm_loss_fwd(const void* f, const void* strips, const void* scalars,
                           const void* plan, int items, void* partial, int batch, int n, int ld,
                           void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (ld < C || ld % C || batch < 1 || n < 1 || (ld == C) != (items > 0) ||
      (ld == C) != (plan != nullptr) || static_cast<long long>(items) * batch > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ld == C) {
    const cudaError_t err = set_smem(sm_loss_fwd128_kernel, b128::BYTES_FWD);
    if (err != cudaSuccess) return static_cast<int>(err);
    sm_loss_fwd128_kernel<<<items * batch, THREADS, b128::BYTES_FWD, st>>>(
        static_cast<const float*>(f), static_cast<const float*>(strips),
        static_cast<const float*>(scalars), static_cast<const int*>(plan),
        static_cast<float*>(partial), n, batch);
  } else {
    const cudaError_t err = set_smem(sm_loss_fwd_kernel, FWD_SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int tiles = (n + TS - 1) / TS;
    sm_loss_fwd_kernel<<<dim3(tiles, tiles, batch), THREADS, FWD_SMEM_BYTES, st>>>(
        static_cast<const float*>(f), static_cast<const float*>(strips),
        static_cast<const float*>(scalars), static_cast<float*>(partial), n, ld);
  }
  return static_cast<int>(cudaGetLastError());
}

// dsigma_partial [splits, batch, ceil(n / 64)]. At ld = 128 each row block's
// walk over the ceil(n / 32) tiles is cut into `splits` consecutive runs of
// `run` tiles, none empty (kernels/sm_loss.py::grads_plan); the second run's
// dF goes to df_split. Above, splits is 1.
extern "C" int sm_loss_bwd(const void* f, const void* strips, const void* scalars, void* df,
                           void* df_split, void* dsigma_partial, int batch, int n, int ld,
                           int splits, int run, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const int tiles = (n + b128::TILE - 1) / b128::TILE;
  if (ld < C || ld % C || batch < 1 || n < 1 || splits < 1 || splits > 2 ||
      (ld != C && splits != 1) ||
      (ld == C && (run < 1 || static_cast<long long>(splits) * run < tiles ||
                   (splits - 1) * run >= tiles)) ||
      (splits > 1 && df_split == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + TS - 1) / TS;
  if (ld == C) {
    const cudaError_t err = set_smem(sm_loss_bwd128_kernel, b128::BYTES_BWD);
    if (err != cudaSuccess) return static_cast<int>(err);
    sm_loss_bwd128_kernel<<<dim3(blocks, batch, splits), THREADS, b128::BYTES_BWD, st>>>(
        static_cast<const float*>(f), static_cast<const float*>(strips),
        static_cast<const float*>(scalars), static_cast<float*>(df),
        static_cast<float*>(df_split), static_cast<float*>(dsigma_partial), n, run);
  } else {
    const cudaError_t err = set_smem(sm_loss_bwd_kernel, BWD_SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    sm_loss_bwd_kernel<<<dim3(blocks, batch), THREADS, BWD_SMEM_BYTES, st>>>(
        static_cast<const float*>(f), static_cast<const float*>(strips),
        static_cast<const float*>(scalars), static_cast<float*>(df),
        static_cast<float*>(dsigma_partial), n, ld);
  }
  return static_cast<int>(cudaGetLastError());
}
