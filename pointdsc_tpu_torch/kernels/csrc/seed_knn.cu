// Exact k nearest feature neighbours of the seed correspondences, CUDA C++
// for sm_90a.
//
// Replaces the TPU kernels pointdsc_tpu/kernels/seed_knn.py:48 (chunk top-k,
// pallas_call at :166) and :87 (union select, pallas_call at :128), entry
// seed_knn_exact (:191):
//
//   sim[s, j] = f[seed_s] . f[j]          (features are L2-normalised, so the
//                                          largest inner products are the
//                                          nearest neighbours)
//   invalid j -> -1e30, j == seed_s -> -3e38
//   idx[s, :] = the k largest sim[s, :], descending, ties to the lower index
//
// features [B, N, c] f32 (c = 128, or a wider model's 128 m), seeds [B, S] int32, bias [B, N] f32 (0 valid,
// -1e30 invalid), idx [B, S, k] int64; scratch [B, S, NP] f32, NP = N rounded
// up to 64, allocated by the wrapper.
//
// Bound on the H100 at N = 5120, S = 512, k = 40: the [S, N] similarities are
// 2 S N C = 0.67 GFLOP (10 us at 67 TFLOP/s in f32) and the inputs 2.6 MB
// (0.8 us), so operations bound it (58 us at N = 12288, S = 1228).
//
// Two launches, as the TPU's two pallas_calls, one C entry:
//
// 1. Similarities (seed_sim_kernel): a register-tiled f32 FMA product. A
//    block owns 64 seeds x 64 candidates, stages the channels 32 at a time in
//    shared memory (k-major, so a thread reads its 4 seeds and its 4
//    candidates as two float4), and each of its 256 threads keeps 4 x 4
//    sums. The masked and self tiers are applied in the epilogue and the
//    tile is written to the scratch (10 MB at N = 5120, which the 50 MB L2
//    holds; 60 MB at 12288). The width is a template argument: 128 for the
//    shipped models, else 0, a runtime count of 32-channel steps. f32 x f32 with f32 sums, as JAX's product
//    (seed_knn.py:59-62): bf16 or TF32 operands would move neighbour sets
//    beyond the near-tie rule. A tail seed tile is masked, not repeated.
// 2. Selection (seed_select_kernel): one block per seed row. The row is
//    staged in shared memory as order-preserving uint32 keys (larger float,
//    larger key; -0.0 is taken as +0.0, which the plain sort treats as
//    equal), and an exact radix select over four 8-bit digits, most
//    significant first (radix_select.cuh, shared with nms.cu), finds the
//    k-th largest key T (a shared-memory histogram per digit, then a block
//    scan over the bins from the top) and how many entries equal to T
//    belong to the top k. Each thread then
//    counts, in its contiguous run of indices, the entries above T and
//    equal to T; one block scan gives every entry its slot, the ties taken
//    strictly in index order (the plain version's stable sort). One warp
//    sorts the <= k winners by (value descending, index ascending) with a
//    bitonic network over 32, 64 or 128 slots.
// The earlier design (4 seeds and 128 threads a block, one block per SM at
// S = 512; each chunk of 1024 candidates merged by k serial argmax passes of
// one warp; every block re-reading all N rows) ran at ~79x its bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "radix_select.cuh"

namespace {

constexpr int C = 128;  // a model is zero-padded to a multiple of it by the wrapper
constexpr int KMAX = 128;
constexpr float MASKED = -1e30f;
constexpr float SELF = -3e38f;

// ---------------------------------------------------------------- similarities

constexpr int TS = 64;            // seeds a block owns
constexpr int TN = 64;            // candidates a block owns
constexpr int TC = 32;            // channels staged per step
constexpr int SIM_THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int TP = TS + 4;        // row of a k-major tile (floats, 16-byte aligned)
constexpr int LOAD_ITERS = TS * TC / 4 / SIM_THREADS;
static_assert(TS == TN, "one load slot layout serves both tiles");

// kC: the feature width (C), or 0 for a width c read at run time
template <int kC>
__global__ void __launch_bounds__(SIM_THREADS)
seed_sim_kernel(const float* __restrict__ feats, const int* __restrict__ seeds,
                const float* __restrict__ bias, float* __restrict__ sim, int n, int s, int np,
                int c) {
  const int cw = kC ? kC : c;
  __shared__ __align__(16) float As[TC][TP];  // seed channels, k-major
  __shared__ __align__(16) float Bs[TC][TP];  // candidate channels, k-major
  const int b = blockIdx.z;
  const int s0 = blockIdx.y * TS, j0 = blockIdx.x * TN;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float* f = feats + static_cast<size_t>(b) * n * cw;
  const int* sd = seeds + static_cast<size_t>(b) * s;

  // load slots: row i / 8 of the tile, channels 4 (i % 8) + [0, 4) of a step
  const float* a_row[LOAD_ITERS];
  const float* b_row[LOAD_ITERS];
#pragma unroll
  for (int it = 0; it < LOAD_ITERS; ++it) {
    const int r = (tid + it * SIM_THREADS) >> 3;
    a_row[it] = s0 + r < s ? f + static_cast<size_t>(sd[s0 + r]) * cw : nullptr;
    b_row[it] = j0 + r < n ? f + static_cast<size_t>(j0 + r) * cw : nullptr;
  }
  const int c4 = (tid & 7) * 4;
  float4 areg[LOAD_ITERS], breg[LOAD_ITERS];
  auto fetch = [&](int c0) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int it = 0; it < LOAD_ITERS; ++it) {
      areg[it] = a_row[it] ? *reinterpret_cast<const float4*>(a_row[it] + c0 + c4) : zero;
      breg[it] = b_row[it] ? *reinterpret_cast<const float4*>(b_row[it] + c0 + c4) : zero;
    }
  };

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  fetch(0);
  for (int c0 = 0; c0 < cw; c0 += TC) {
    __syncthreads();  // the previous step's readers are done
#pragma unroll
    for (int it = 0; it < LOAD_ITERS; ++it) {
      const int r = (tid + it * SIM_THREADS) >> 3;
      As[c4 + 0][r] = areg[it].x;
      As[c4 + 1][r] = areg[it].y;
      As[c4 + 2][r] = areg[it].z;
      As[c4 + 3][r] = areg[it].w;
      Bs[c4 + 0][r] = breg[it].x;
      Bs[c4 + 1][r] = breg[it].y;
      Bs[c4 + 2][r] = breg[it].z;
      Bs[c4 + 3][r] = breg[it].w;
    }
    __syncthreads();
    if (c0 + TC < cw) fetch(c0 + TC);  // in flight during this step's sums
#pragma unroll 8
    for (int kk = 0; kk < TC; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bw[c], acc[r][c]);
    }
  }

  // the masked tier, then the self tier below it; columns past n stay
  // unread by the selection
  const int jb = j0 + 4 * tx;
  bool masked[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    masked[c] = jb + c < n && bias[static_cast<size_t>(b) * n + jb + c] != 0.0f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = s0 + 4 * ty + r;
    if (row >= s) continue;
    const int own = sd[row];
    float out[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      out[c] = masked[c] ? MASKED : acc[r][c];
      if (jb + c == own) out[c] = SELF;
    }
    *reinterpret_cast<float4*>(sim + (static_cast<size_t>(b) * s + row) * np + jb) =
        make_float4(out[0], out[1], out[2], out[3]);
  }
}

// ---------------------------------------------------------------- selection

constexpr int SEL_THREADS = 256;  // one histogram bin per thread
constexpr int BINS = radix::BINS;
constexpr int WARPS = SEL_THREADS / 32;
// rows up to this length are staged in shared memory (160 KB); longer rows
// read their keys from the scratch on every pass
constexpr int MAX_STAGED = 40960;
static_assert(SEL_THREADS == BINS, "a thread clears and scans one bin");

// larger float -> larger key; -0.0 and +0.0 -> one key (the plain version's
// sort compares them equal and keeps index order)
__device__ __forceinline__ uint32_t order_key(float v) {
  if (v == 0.0f) v = 0.0f;
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// (key a, index ia) comes before (key b, index ib)
__device__ __forceinline__ bool before(uint32_t a, int ia, uint32_t b, int ib) {
  return a > b || (a == b && ia < ib);
}

__global__ void __launch_bounds__(SEL_THREADS)
seed_select_kernel(const float* __restrict__ sim, int64_t* __restrict__ idx_out, int n, int s,
                   int np, int k) {
  extern __shared__ uint32_t keys[];  // [n] when staged
  __shared__ int hist[BINS];
  __shared__ int warp_sums[WARPS];
  __shared__ uint32_t digit_s;
  __shared__ int rank_s;
  __shared__ uint32_t win_key[KMAX];
  __shared__ int win_idx[KMAX];
  const int tid = threadIdx.x;
  const int row = blockIdx.x, b = blockIdx.y;
  const float* r = sim + (static_cast<size_t>(b) * s + row) * np;
  const bool staged = n <= MAX_STAGED;
  if (staged)
    for (int i = tid; i < n; i += SEL_THREADS) keys[i] = order_key(r[i]);
  auto key_at = [&](int i) { return staged ? keys[i] : order_key(r[i]); };

  const uint2 sel = radix::radix_select<SEL_THREADS, false>(key_at, n, k, hist, warp_sums,
                                                             digit_s, rank_s);
  const uint32_t kth = sel.x;                 // the k-th largest key
  const int ties = static_cast<int>(sel.y);  // entries equal to it among the top k
  const int above = k - ties;                 // entries larger than it

  // compaction in index order: a contiguous run of indices per thread
  const int run = (n + SEL_THREADS - 1) / SEL_THREADS;
  const int lo = min(n, tid * run), hi = min(n, lo + run);
  int n_gt = 0, n_eq = 0;
  for (int i = lo; i < hi; ++i) {
    const uint32_t key = key_at(i);
    n_gt += key > kth;
    n_eq += key == kth;
  }
  // above < k <= 128: the count of larger keys fits the low 8 bits
  const int own = (n_eq << 8) | n_gt;
  const int before_me = radix::block_scan<WARPS>(own, warp_sums) - own;
  int slot_gt = before_me & 0xFF, rank_eq = before_me >> 8;
  for (int i = lo; i < hi && (slot_gt < above || rank_eq < ties); ++i) {
    const uint32_t key = key_at(i);
    if (key > kth) {
      win_key[slot_gt] = key;
      win_idx[slot_gt++] = i;
    } else if (key == kth) {
      if (rank_eq < ties) {
        win_key[above + rank_eq] = key;
        win_idx[above + rank_eq] = i;
      }
      ++rank_eq;
    }
  }
  const int slots = k <= 32 ? 32 : (k <= 64 ? 64 : 128);
  for (int t = k + tid; t < slots; t += SEL_THREADS) {
    win_key[t] = 0u;  // below every key a float maps to
    win_idx[t] = INT32_MAX;
  }
  __syncthreads();

  // one warp: bitonic sort of the slots, first the best
  if (tid < 32) {
    for (int size = 2; size <= slots; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int p = tid; p < slots / 2; p += 32) {
          const int i = 2 * p - (p & (stride - 1));
          const int j = i + stride;
          const bool first_half = (i & size) == 0;  // this run is sorted best first
          const uint32_t ki = win_key[i], kj = win_key[j];
          const int ii = win_idx[i], ij = win_idx[j];
          if (before(kj, ij, ki, ii) == first_half) {
            win_key[i] = kj;
            win_key[j] = ki;
            win_idx[i] = ij;
            win_idx[j] = ii;
          }
        }
        __syncwarp();
      }
    }
    int64_t* o = idx_out + (static_cast<size_t>(b) * s + row) * k;
    for (int t = tid; t < k; t += 32) o[t] = win_idx[t];
  }
}

}  // namespace

// c: the feature width, a multiple of 128
extern "C" int seed_knn_exact(const void* feats, const void* seeds, const void* bias,
                              void* idx, void* scratch, int batch, int n, int s, int k, int c,
                              void* stream) {
  if (k < 1 || k > KMAX || k >= n || c < C || c % C)
    return static_cast<int>(cudaErrorInvalidValue);
  const int np = (n + TN - 1) / TN * TN;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 sim_grid(np / TN, (s + TS - 1) / TS, batch);
  const auto sim_kernel = c == C ? seed_sim_kernel<C> : seed_sim_kernel<0>;
  sim_kernel<<<sim_grid, SIM_THREADS, 0, st>>>(
      static_cast<const float*>(feats), static_cast<const int*>(seeds),
      static_cast<const float*>(bias), static_cast<float*>(scratch), n, s, np, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t keys_bytes = n <= MAX_STAGED ? static_cast<size_t>(n) * sizeof(uint32_t) : 0;
  // per call: the attribute belongs to the current device
  err = cudaFuncSetAttribute(seed_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(keys_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  seed_select_kernel<<<dim3(s, batch), SEL_THREADS, keys_bytes, st>>>(
      static_cast<const float*>(scratch), static_cast<int64_t*>(idx), n, s, np, k);
  return static_cast<int>(cudaGetLastError());
}
