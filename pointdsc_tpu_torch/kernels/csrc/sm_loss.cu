// Spectral-matching loss without the [N, N] feature-similarity matrix,
// forward and backward, CUDA C++ for sm_90a.
//
// Replaces the TPU kernels pointdsc_tpu/kernels/sm_loss.py:87
// (_sm_loss_fwd_kernel, pallas_call :169) and :108 (_sm_loss_bwd_kernel,
// pallas_call :191). Per (i, j) tile of 64 x 64 pairs:
//
//   S = F_i F_j^T,  u = 1 - (1 - S) / sigma^2,  M = clip(u, 0, 1) off the
//   diagonal (0 on it),  pm = valid_i valid_j,  gtM = gt_i gt_j off the diagonal;
//   forward:  sum_p += (M - 1)^2 gtM,   sum_n += M^2 (pm - gtM);
//   backward: g = wp 2 (M - 1) gtM + wn 2 M (pm - gtM),
//             gate = [0 < u < 1] off the diagonal, times pm,
//             dF_i += (2 / sigma^2) (g gate) F_j       (2: the mirrored tile),
//             dsigma += sum g gate 2 (1 - S) / sigma^3.
//
// F [B, N, 128] f32; strips [B, 8, N] f32 (row 0 gt masked to 0, row 1
// valid); scalars [B, 4] f32 (sigma, wp, wn, unused), read from device memory
// so that the learned sigma never passes through the host.
//
// The TPU kernels keep one scalar alive across a sequential grid. A CUDA grid
// has no order, so each block writes its partial sums to a small buffer
// ([B, tiles, 2] forward, [B, row tiles] for dsigma) and the wrapper adds
// them in a fixed order: the loss is the same from run to run, which f32
// atomics on one scalar would not give. In the backward a block owns 64 rows
// of dF and loops over the column tiles itself. Tail tiles are guarded, so
// every N is taken.
//
// Bound on the H100: f32 operands, so the CUDA cores' 67 TFLOP/s: 2 N^2 C
// operations per sample forward, 4 N^2 C backward, against one [N, C] stream.
//
// Above C = 128 (kWide): F is [B, N, ld], the model's channels zero-padded to
// ld = 128 m. The tile products S sum over the m chunks, staged one at a time
// into the same 128-wide tiles; the backward makes one pass per 128-wide
// chunk of dF, recomputing S (in one chunk order, so every pass sees the same
// S and g) and adding dsigma in its first pass only.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int C = 128;  // a narrower model is zero-padded to it by the wrapper
constexpr int TS = 64;  // tile side
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CP = C + 1;
constexpr int PP = TS + 1;
constexpr int SROWS = 2;  // strip rows the kernels read
constexpr int SSTRIDE = 8;

// rows [r0, r0 + TS), channels [col0, col0 + C) of a [n, ld] array, zeros past n
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int r0,
                                          int n, int ld = C, int col0 = 0) {
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

// S for the thread's 4 x 4 entries: rows 4 ty + r, columns tx + 16 j (kAdd:
// added to s, the sum over a further chunk of channels)
template <bool kAdd = false>
__device__ __forceinline__ void tile_products(const float* Fi, const float* Fj, int ty, int tx,
                                              float s[4][4]) {
  if constexpr (!kAdd) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
  }
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

// S over the m = ld / C chunks of rows [i0, i0 + TS) and [j0, j0 + TS) (wide
// form): the chunks staged into Fi and Fj in turn; starts with a barrier
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
    tile_products<true>(Fi, Fj, ty, tx, s);
  }
}

template <bool kWide>
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
  f += static_cast<size_t>(b) * n * (kWide ? ld : C);
  strips += static_cast<size_t>(b) * SSTRIDE * n;
  const float sigma = scalars[b * 4];
  const float sig2 = sigma * sigma;

  if constexpr (!kWide) {
    load_rows(Fi, f, i0, n);
    load_rows(Fj, f, j0, n);
  }
  load_strip(Li, strips, i0, n);
  load_strip(Lj, strips, j0, n);
  __syncthreads();

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float s[4][4];
  if constexpr (kWide)
    wide_products(f, i0, j0, n, ld, Fi, Fj, ty, tx, s);
  else
    tile_products(Fi, Fj, ty, tx, s);

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

template <bool kWide>
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
  const int w = kWide ? ld : C;  // row width
  const int chunks = kWide ? ld / C : 1;
  f += static_cast<size_t>(b) * n * w;
  df += static_cast<size_t>(b) * n * w;
  strips += static_cast<size_t>(b) * SSTRIDE * n;
  const float sigma = scalars[b * 4], wp = scalars[b * 4 + 1], wn = scalars[b * 4 + 2];
  const float sig2 = sigma * sigma;

  if constexpr (!kWide) load_rows(Fi, f, i0, n);
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
      if constexpr (!kWide) load_rows(Fj, f, j0, n);
      load_strip(Lj, strips, j0, n);
      __syncthreads();

      float s[4][4];
      if constexpr (kWide)
        wide_products(f, i0, j0, n, ld, Fi, Fj, ty, tx, s);
      else
        tile_products(Fi, Fj, ty, tx, s);
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
      if constexpr (kWide) {
        if (oc != chunks - 1) {  // the tile's chunk of dF (the products left the last one)
          load_rows(Fj, f, j0, n, ld, C * oc);
          __syncthreads();
        }
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
        df[static_cast<size_t>(i0 + row) * w + C * oc + cx + 32 * j] = coef * acc[r][j];
    }
    if (oc == 0) {  // every pass sums the same dsigma
      const float total = block_sum(dsig, red);
      if (threadIdx.x == 0)
        dsigma_partial[static_cast<size_t>(b) * gridDim.x + blockIdx.x] = total / (sig2 * sigma);
    }
  }  // output chunks
}

template <bool kWide>
int launch_fwd(const void* f, const void* strips, const void* scalars, void* partial, int batch,
               int n, int ld, void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      sm_loss_fwd_kernel<kWide>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(FWD_SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n + TS - 1) / TS;
  const dim3 grid(tiles, tiles, batch);
  sm_loss_fwd_kernel<kWide><<<grid, THREADS, FWD_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<const float*>(strips),
      static_cast<const float*>(scalars), static_cast<float*>(partial), n, ld);
  return static_cast<int>(cudaGetLastError());
}

template <bool kWide>
int launch_bwd(const void* f, const void* strips, const void* scalars, void* df,
               void* dsigma_partial, int batch, int n, int ld, void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      sm_loss_bwd_kernel<kWide>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(BWD_SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + TS - 1) / TS, batch);
  sm_loss_bwd_kernel<kWide><<<grid, THREADS, BWD_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<const float*>(strips),
      static_cast<const float*>(scalars), static_cast<float*>(df),
      static_cast<float*>(dsigma_partial), n, ld);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ld: the row width of f and df (128, or a wider model's 128 m)
// partial: [batch, tiles, tiles, 2] with tiles = ceil(n / 64)
extern "C" int sm_loss_fwd(const void* f, const void* strips, const void* scalars, void* partial,
                           int batch, int n, int ld, void* stream) {
  if (ld < C || ld % C) return static_cast<int>(cudaErrorInvalidValue);
  return ld == C ? launch_fwd<false>(f, strips, scalars, partial, batch, n, ld, stream)
                 : launch_fwd<true>(f, strips, scalars, partial, batch, n, ld, stream);
}

// dsigma_partial: [batch, tiles]
extern "C" int sm_loss_bwd(const void* f, const void* strips, const void* scalars, void* df,
                           void* dsigma_partial, int batch, int n, int ld, void* stream) {
  if (ld < C || ld % C) return static_cast<int>(cudaErrorInvalidValue);
  return ld == C ? launch_bwd<false>(f, strips, scalars, df, dsigma_partial, batch, n, ld, stream)
                 : launch_bwd<true>(f, strips, scalars, df, dsigma_partial, batch, n, ld, stream);
}
