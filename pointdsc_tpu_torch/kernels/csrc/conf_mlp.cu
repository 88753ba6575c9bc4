// Confidence head: the 128 -> 32 -> 32 -> 1 ReLU MLP per correspondence,
// CUDA C++ for sm_90a.
//
// Replaces the TPU kernel pointdsc_tpu/kernels/conf_mlp.py:43 (_conf_kernel,
// pallas_call at :67), entry confidence_head (:84):
//
//   h1 = relu(W0 x + b0), h2 = relu(W1 h1 + b1), logit = W2 h2 + b2
//
// x [M, 128] f32 (M = B N rows, 16-byte aligned), out [M] f32, and the
// weights packed once per model by the wrapper (kernels/conf_mlp.py::
// pack_head_weights) in the layout read here: W0^T [128][32], b0 [32],
// W1^T [32][32], b1 [32], w2 [32], b2, zero-padded to a multiple of 4 floats.
//
// Bound on the H100 at N = 5120: the features are 2.6 MB (0.78 us at
// 3.35 TB/s) and the MLP 2 (128 32 + 32 32 + 32) = 10.3 kflop per row, 53
// MFLOP (0.79 us at 67 TFLOP/s in f32): bytes and operations are even, both
// under the cost of one launch. The TPU pads the 32-wide layers to 128 lanes
// so the three matmuls stay full MXU passes; on the card there is nothing to
// pad for, and tensor cores would change JAX's f32 function, so the products
// stay f32 FMAs on the CUDA cores.
//
// Design:
// - At most one wave of blocks (the SM count times the blocks an SM holds),
//   each walking its share of 32-row tiles, so that the weights are staged
//   once per block, not once per tile: 20.9 KB with 16-byte cp.async copies
//   in the layout the loops read (no transpose in the kernel, no bank
//   conflicts).
// - The feature tiles are double-buffered with cp.async: tile t + grid is in
//   flight while tile t is computed; every row is read once, 16 bytes a copy.
// - The 128 -> 32 layer is a register tile: thread t owns rows 2 (t / 8) + {0,
//   1} and hidden units 4 (t % 8) + [0, 4); per four channels it reads its two
//   rows and four weight rows as float4 (a warp's eight weight addresses are
//   one 128-byte row, the rows' eight float4 fall in distinct banks with the
//   132-float row) for 32 FMAs. The 32 -> 32 layer is the same tile over h1 in
//   shared memory; the 32 -> 1 layer is the thread's four terms and a shuffle
//   over the eight threads of a row pair. The logits of a tile go out as one
//   coalesced 128-byte row.
// The former design (one block a tile, ceil(M / 32) blocks each staging and
// transposing all the weights with a 32-way bank conflict, scalar loads) took
// 0.0149 ms at N = 5120 (PERF.md).

#include <atomic>

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 128;
constexpr int H = 32;
constexpr int ROWS = 32;       // rows of a tile
constexpr int THREADS = 128;   // 16 row pairs x 8 groups of 4 hidden units
constexpr int XP = C + 4;      // feature row in shared memory (16-byte aligned)
constexpr int HP = H + 4;      // h1 row
constexpr int MAX_DEVICES = 64;

// the packed weights, in floats
constexpr int OFF_B0 = C * H;
constexpr int OFF_W1 = OFF_B0 + H;
constexpr int OFF_B1 = OFF_W1 + H * H;
constexpr int OFF_W2 = OFF_B1 + H;
constexpr int OFF_B2 = OFF_W2 + H;
constexpr int PACKED = (OFF_B2 + 1 + 3) & ~3;

// shared memory, in floats
constexpr int S_X = PACKED;                // [2][ROWS][XP] feature tiles
constexpr int S_H1 = S_X + 2 * ROWS * XP;  // [ROWS][HP]
constexpr int S_L = S_H1 + ROWS * HP;      // [ROWS] logits
constexpr size_t SMEM_BYTES = (S_L + ROWS) * sizeof(float);
static_assert(PACKED % 4 == 0 && S_X % 4 == 0 && S_H1 % 4 == 0, "16-byte aligned regions");

__device__ inline void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int PENDING>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

__device__ inline float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__global__ void __launch_bounds__(THREADS)
conf_mlp_kernel(const float* __restrict__ x, const float* __restrict__ packed,
                float* __restrict__ out, int m) {
  extern __shared__ __align__(16) float smem[];
  const float* W = smem;
  float* X = smem + S_X;
  float* H1 = smem + S_H1;
  float* L = smem + S_L;
  const int tid = threadIdx.x, hg = tid & 7, r0 = 2 * (tid >> 3);
  const int tiles = (m + ROWS - 1) / ROWS;

  for (int i = tid; i < PACKED / 4; i += THREADS) cp_async16(smem + 4 * i, packed + 4 * i);
  cp_async_commit();
  auto load_tile = [&](int t, int buf) {
    const int row0 = t * ROWS;
    float* dst = X + buf * ROWS * XP;
    for (int i = tid; i < ROWS * C / 4; i += THREADS) {
      const int r = i / (C / 4), c4 = (i % (C / 4)) * 4;
      if (row0 + r < m)
        cp_async16(dst + r * XP + c4, x + static_cast<size_t>(row0 + r) * C + c4);
    }
    cp_async_commit();
  };

  if (blockIdx.x < tiles) load_tile(blockIdx.x, 0);
  int buf = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, buf ^= 1) {
    // the other buffer's readers finished with the previous tile's last barrier
    if (t + gridDim.x < tiles) {
      load_tile(t + gridDim.x, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t and the weights are in shared memory

    // ---- h1 = relu(x W0^T + b0): rows r0, r0 + 1, units 4 hg + [0, 4)
    const float* xs = X + buf * ROWS * XP;
    float acc[2][4] = {};
#pragma unroll 4
    for (int c = 0; c < C; c += 4) {
      const float4 xa = ld4(xs + r0 * XP + c), xb = ld4(xs + (r0 + 1) * XP + c);
      const float xv[2][4] = {{xa.x, xa.y, xa.z, xa.w}, {xb.x, xb.y, xb.z, xb.w}};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 w = ld4(W + (c + e) * H + 4 * hg);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[i][u] = fmaf(xv[i][e], wv[u], acc[i][u]);
      }
    }
    const float4 b0 = ld4(W + OFF_B0 + 4 * hg);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float4*>(H1 + (r0 + i) * HP + 4 * hg) =
          make_float4(fmaxf(acc[i][0] + b0.x, 0.f), fmaxf(acc[i][1] + b0.y, 0.f),
                      fmaxf(acc[i][2] + b0.z, 0.f), fmaxf(acc[i][3] + b0.w, 0.f));
    __syncthreads();

    // ---- h2 = relu(h1 W1^T + b1), then logit = h2 w2 + b2
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][u] = 0.f;
#pragma unroll
    for (int c = 0; c < H; c += 4) {
      const float4 ha = ld4(H1 + r0 * HP + c), hb = ld4(H1 + (r0 + 1) * HP + c);
      const float hv[2][4] = {{ha.x, ha.y, ha.z, ha.w}, {hb.x, hb.y, hb.z, hb.w}};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 w = ld4(W + OFF_W1 + (c + e) * H + 4 * hg);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[i][u] = fmaf(hv[i][e], wv[u], acc[i][u]);
      }
    }
    const float4 b1 = ld4(W + OFF_B1 + 4 * hg), w2 = ld4(W + OFF_W2 + 4 * hg);
    const float b1v[4] = {b1.x, b1.y, b1.z, b1.w}, w2v[4] = {w2.x, w2.y, w2.z, w2.w};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float part = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) part = fmaf(fmaxf(acc[i][u] + b1v[u], 0.f), w2v[u], part);
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      if (hg == 0) L[r0 + i] = part + W[OFF_B2];
    }
    __syncthreads();
    const int row0 = t * ROWS;
    if (tid < ROWS && row0 + tid < m) out[row0 + tid] = L[tid];
  }
}

}  // namespace

// packed: PACKED floats (kernels/conf_mlp.py::PACKED_FLOATS), 16-byte aligned
extern "C" int confidence_head(const void* x, const void* packed, void* out, int m,
                               void* stream) {
  // the grid: at most one wave, from the SM count and the occupancy, read once per device
  static std::atomic<int> wave[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  int blocks = wave[dev].load(std::memory_order_acquire);
  if (blocks == 0) {
    err = cudaFuncSetAttribute(conf_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(SMEM_BYTES));
    if (err != cudaSuccess) return static_cast<int>(err);
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conf_mlp_kernel, THREADS,
                                                        SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    blocks = sms * per_sm;
    wave[dev].store(blocks, std::memory_order_release);
  }
  const int tiles = (m + ROWS - 1) / ROWS;
  if (tiles == 0) return 0;
  const int grid = tiles < blocks ? tiles : blocks;
  conf_mlp_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(packed), static_cast<float*>(out),
      m);
  return static_cast<int>(cudaGetLastError());
}
