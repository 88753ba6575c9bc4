// Seed NMS of the eval forward, CUDA C++ for sm_90a: the local-max flags
// with the seed keys, the exact select of the seeds, and the exact select of
// the prefilter's top-M scores.
//
// Replaces the TPU kernel pointdsc_tpu/kernels/nms.py:40 (_nms_kernel,
// pallas_call at :78) and the jax.lax.top_k calls and lax.cond decisions of
// its entries pick_seeds_nms_fused / pick_seeds_nms_prefiltered (:111-214):
//
//   flag[i] = AND_j ( s_i >= s_j  OR  d2(i, j) >= R^2 )
//   d2(i, j) = max((|x_i|^2 + |x_j|^2) - 2 x_i.x_j, 0)
//   key[i]   = score[i] * flag[i], -inf for an invalid point
//   seeds    = the S largest keys by IEEE total order (+0.0 above -0.0),
//              ties to the lower index
//
// with s = score, or -1e9 for an invalid point (it never suppresses). Every
// product and sum of d2 and of the squared norms is rounded on its own (no
// FMA contraction but the exact doubling's), in the order of the plain
// version's elementwise torch operations, so that the flags equal the plain
// version's bit for bit.
//
// Keys travel as int32 total-order keys, bits ^ ((bits >> 31) & 0x7FFFFFFF)
// of the float (ops/nms.py::_total_order_key); the selects flip the sign bit
// to order them as unsigned integers.
//
// 1. nms_flags_kernel: a block owns 32 queries (one a lane) and its 16 warps
//    split the keys; each warp stages 32 keys at a time in its own slice of
//    shared memory and every lane walks them (broadcast reads). Points are
//    read in place from src [B, N, 3], scores and mask (optionally through a
//    subset's index list), and the squared norms computed here: there is no
//    packed strip. A block's queries still unsuppressed are a bit mask in
//    shared memory; each warp ANDs its own into it after every tile and
//    leaves its key loop once none is left (the AND cannot turn true again,
//    so the flags are the same). Grid: N / 32 blocks a sample (160 at
//    N = 5120 on 132 SMs).
// 2. nms_select_kernel: one block a sample. An exact radix select over four
//    8-bit digits (radix_select.cuh, shared with seed_knn.cu: a
//    shared-memory histogram a digit, here with warp-aggregated atomics, a
//    block scan over the bins from the top) finds the k-th largest key and
//    how many keys equal to it belong to the top k; one pass over a
//    contiguous run of positions a thread and one block scan place every
//    winner, the ties at the threshold taken in position order; a bitonic
//    sort in shared memory orders the k winners by (key desc, position asc).
//    Positions map through the subset's index list when there is one. Above
//    MAX_SLOTS winners (8192, 64 KB) nms_select_wide_kernel does the same
//    with the winners in a workspace in device memory that the caller
//    allocates ([B, 2 * slots] int32: keys, positions), sorted there by the
//    same network: any S, as JAX's lax.top_k takes any.
// 3. nms_top_m_kernel: the same select of the M largest masked scores, whose
//    winners stay in index order (no sort: ties at the subset's keys are
//    equal scores, which the top-M list orders by index too), with the M-th
//    score (tau_M) and the prefilter's positivity precheck (at least S
//    strictly positive masked scores).
//
// The prefilter's decisions are device flags: the subset's flags and select
// run only when every sample's precheck holds, the select writes each
// sample's certificate (the S-th key > max(tau_M, 0)), and the full-grid
// flags and select run only when some certificate fails; a gated-off block
// returns at once. One decision for the whole batch, as JAX's scalar
// lax.cond. No host sync.
//
// Bound on the H100: the N^2 pair tests (26.2 M at N = 5120, ~13 operations
// each: 0.34 GFLOP, ~5 us at 67 TFLOP/s) when no warp leaves early; the
// selects move a few tens of KB. The selects run one block a sample, so at
// batch 1 they hold one SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "compat_tile.cuh"
#include "radix_select.cuh"

namespace {

using compat::sq_norm;  // (x x + y y) + z z, each product and sum rounded

constexpr unsigned FULL = 0xffffffffu;
constexpr float INVALID_SCORE = -1e9f;

// ------------------------------------------------------------ shared helpers

// ops/nms.py::_total_order_key: an int32 whose order is IEEE total order
__device__ __forceinline__ int total_order(float v) {
  const int bits = __float_as_int(v);
  return bits ^ ((bits >> 31) & 0x7FFFFFFF);
}

// the float of a total-order key (the map is its own inverse)
__device__ __forceinline__ float key_value(uint32_t ukey) {
  const int k = static_cast<int>(ukey ^ 0x80000000u);
  return __int_as_float(k ^ ((k >> 31) & 0x7FFFFFFF));
}

// signed total-order key -> unsigned integer of the same order
__device__ __forceinline__ uint32_t unsigned_key(int key) {
  return static_cast<uint32_t>(key) ^ 0x80000000u;
}

// the block runs iff the AND of gate[0..batch) equals want (no gate: runs)
__device__ __forceinline__ bool gate_open(const int* gate, int batch, int want) {
  if (gate == nullptr) return true;
  int all = 1;
  for (int i = 0; i < batch; ++i) all &= gate[i] != 0;
  return all == want;
}

// ------------------------------------------------------------ flags and keys

constexpr int KWARPS = 16;                // warps a block, each a slice of the keys
constexpr int FLAG_THREADS = 32 * KWARPS;  // 32 queries a block, one a lane

__global__ void __launch_bounds__(FLAG_THREADS)
nms_flags_kernel(const float* __restrict__ src, const float* __restrict__ scores,
                 const uint8_t* __restrict__ mask, const int* __restrict__ subset,
                 const int* __restrict__ gate, int gate_want, int batch, int n_all, int n,
                 float r2, float* __restrict__ flags, int* __restrict__ keys,
                 unsigned long long* __restrict__ tiles) {
  __shared__ float4 kpt[KWARPS][32];  // x, y, z, |x|^2 of a warp's 32 keys
  __shared__ float ksc[KWARPS][32];   // their scores, -1e9 invalid, -inf past the end
  __shared__ unsigned alive;          // the block's queries not yet suppressed
  if (!gate_open(gate, batch, gate_want)) return;
  const int b = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* sb = src + static_cast<size_t>(b) * n_all * 3;
  const float* cb = scores + static_cast<size_t>(b) * n_all;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * n_all;
  const int* ib = subset == nullptr ? nullptr : subset + static_cast<size_t>(b) * n;

  const int q0 = static_cast<int>(blockIdx.x) * 32;
  const int qp = q0 + lane;  // this lane's query, a position in [0, n)
  const bool live = qp < n;
  float xq = 0.f, yq = 0.f, zq = 0.f, sqq = 0.f, sq = 0.f, raw = 0.f;
  bool valid = false;
  if (live) {
    int i = ib == nullptr ? qp : ib[qp];
    if (i < 0 || i >= n_all) i = 0;  // a subset index off the cloud reads no memory past it
    xq = sb[3 * i];
    yq = sb[3 * i + 1];
    zq = sb[3 * i + 2];
    sqq = sq_norm(xq, yq, zq);
    raw = cb[i];
    valid = mb == nullptr || mb[i] != 0;
    sq = valid ? raw : INVALID_SCORE;
  }
  if (threadIdx.x == 0) alive = n - q0 >= 32 ? FULL : (1u << (n - q0)) - 1u;
  __syncthreads();

  // warp w walks the keys [w * per_warp, (w + 1) * per_warp) in tiles of 32
  const int per_warp = (n + FLAG_THREADS - 1) / FLAG_THREADS * 32;
  const int k_lo = warp * per_warp, k_hi = min(n, k_lo + per_warp);
  bool ok = live;
  int walked = 0;
  // R^2 <= 0: max(d2, 0) >= R^2 for every pair, so no point is suppressed
  for (int k0 = k_lo; k0 < k_hi && r2 > 0.0f; k0 += 32) {
    const int kp = k0 + lane;
    float4 pt = make_float4(0.f, 0.f, 0.f, 0.f);
    float s = -INFINITY;  // a key past the end never suppresses
    if (kp < k_hi) {
      int j = ib == nullptr ? kp : ib[kp];
      if (j < 0 || j >= n_all) j = 0;
      pt.x = sb[3 * j];
      pt.y = sb[3 * j + 1];
      pt.z = sb[3 * j + 2];
      pt.w = sq_norm(pt.x, pt.y, pt.z);
      s = (mb == nullptr || mb[j] != 0) ? cb[j] : INVALID_SCORE;
    }
    __syncwarp();  // the previous tile's reads are done
    kpt[warp][lane] = pt;
    ksc[warp][lane] = s;
    __syncwarp();
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const float4 p = kpt[warp][c];
      const float inner =
          __fadd_rn(__fadd_rn(__fmul_rn(xq, p.x), __fmul_rn(yq, p.y)), __fmul_rn(zq, p.z));
      // (|x|^2 + |x'|^2) - 2 inner in one FMA (2 inner is exact: one rounding
      // either way); with R^2 > 0, max(d2, 0) >= R^2 iff d2 >= R^2
      const float d2 = fmaf(-2.0f, inner, __fadd_rn(sqq, p.w));
      ok &= (sq >= ksc[warp][c]) | (d2 >= r2);
    }
    ++walked;
    const unsigned mine = __ballot_sync(FULL, ok);
    unsigned left = 0;
    if (lane == 0) left = atomicAnd(&alive, mine) & mine;
    left = __shfl_sync(FULL, left, 0);
    ok = (left >> lane) & 1u;
    if (left == 0) break;
  }
  if (tiles != nullptr && lane == 0) atomicAdd(tiles, static_cast<unsigned long long>(walked));
  __syncthreads();
  if (warp == 0 && live) {
    const bool flag = (alive >> lane) & 1u;
    const size_t o = static_cast<size_t>(b) * n + qp;
    if (flags != nullptr) flags[o] = flag ? 1.0f : 0.0f;
    if (keys != nullptr) keys[o] = total_order(valid ? raw * (flag ? 1.0f : 0.0f) : -INFINITY);
  }
}

// ------------------------------------------------------------ exact selects

constexpr int SEL_THREADS = 1024;
constexpr int SEL_WARPS = SEL_THREADS / 32;
constexpr int BINS = radix::BINS;
// rows up to this length are staged in shared memory (128 KB); longer rows
// are read from device memory on every pass
constexpr int MAX_STAGED = 32768;
constexpr int MAX_SLOTS = 8192;  // the largest k the seed select sorts in shared memory (64 KB)

struct SelectSmem {
  int hist[BINS];
  int warp_sums[SEL_WARPS];
  unsigned long long warp_sums64[SEL_WARPS];
  uint32_t digit;
  int rank;
};

// the k-th largest of the n keys key_at(i) and its ties among the top k
template <typename KeyAt>
__device__ __forceinline__ uint2 select_kth(const KeyAt& key_at, int n, int k, SelectSmem& sm) {
  return radix::radix_select<SEL_THREADS, true>(key_at, n, k, sm.hist, sm.warp_sums, sm.digit,
                                                sm.rank);
}

// Calls emit(slot, i, key) for every winner of the top k: the keys above kth
// and the first `ties` keys equal to it, slots in position order.
template <typename KeyAt, typename Emit>
__device__ void compact(const KeyAt& key_at, int n, uint2 sel, SelectSmem& sm, const Emit& emit) {
  const uint32_t kth = sel.x;
  const int ties = static_cast<int>(sel.y);
  const int run = (n + SEL_THREADS - 1) / SEL_THREADS;
  const int lo = min(n, static_cast<int>(threadIdx.x) * run), hi = min(n, lo + run);
  unsigned gt = 0, eq = 0;
  for (int i = lo; i < hi; ++i) {
    const uint32_t key = key_at(i);
    gt += key > kth;
    eq += key == kth;
  }
  const unsigned long long own = (static_cast<unsigned long long>(eq) << 32) | gt;
  const unsigned long long before = radix::block_scan<SEL_WARPS>(own, sm.warp_sums64) - own;
  const int gt_before = static_cast<int>(before & 0xFFFFFFFFu);
  int eq_rank = static_cast<int>(before >> 32);
  int slot = gt_before + min(eq_rank, ties);
  for (int i = lo; i < hi; ++i) {
    const uint32_t key = key_at(i);
    if (key > kth || (key == kth && eq_rank++ < ties)) emit(slot++, i, key);
  }
}

// (key a, position ia) comes before (key b, position ib)
__device__ __forceinline__ bool before(uint32_t a, int ia, uint32_t b, int ib) {
  return a > b || (a == b && ia < ib);
}

// keys [B, n] -> out [B, k] int64: positions (or subset[b, position]) of the
// k largest keys, by key descending, ties to the lower position. With tau
// and cert: cert[b] = (k-th key > max(tau[b], 0)). A gated-off block writes
// cert[b] = 0 and nothing else.
__global__ void __launch_bounds__(SEL_THREADS)
nms_select_kernel(const int* __restrict__ keys, const int* __restrict__ subset,
                  const int* __restrict__ gate, int gate_want, const float* __restrict__ tau,
                  int* __restrict__ cert, int64_t* __restrict__ out, int batch, int n, int k,
                  int slots) {
  extern __shared__ uint32_t dyn[];  // [slots] keys, [slots] positions, [n] staged keys
  __shared__ SelectSmem sm;
  const int tid = threadIdx.x, b = blockIdx.x;
  if (!gate_open(gate, batch, gate_want)) {
    if (cert != nullptr && tid == 0) cert[b] = 0;
    return;
  }
  uint32_t* win_key = dyn;
  int* win_pos = reinterpret_cast<int*>(dyn + slots);
  uint32_t* staged = dyn + 2 * slots;
  const int* kb = keys + static_cast<size_t>(b) * n;
  const bool is_staged = n <= MAX_STAGED;
  if (is_staged)
    for (int i = tid; i < n; i += SEL_THREADS) staged[i] = unsigned_key(kb[i]);
  __syncthreads();
  const auto key_at = [&](int i) { return is_staged ? staged[i] : unsigned_key(kb[i]); };

  const uint2 sel = select_kth(key_at, n, k, sm);
  compact(key_at, n, sel, sm, [&](int slot, int i, uint32_t key) {
    win_key[slot] = key;
    win_pos[slot] = i;
  });
  for (int t = k + tid; t < slots; t += SEL_THREADS) {
    win_key[t] = 0u;  // below every key, and past every position
    win_pos[t] = INT32_MAX;
  }
  __syncthreads();

  // bitonic sort of the slots, best first
  for (int size = 2; size <= slots; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = tid; p < slots / 2; p += SEL_THREADS) {
        const int i = 2 * p - (p & (stride - 1));
        const int j = i + stride;
        const bool best_first = (i & size) == 0;
        const uint32_t ki = win_key[i], kj = win_key[j];
        const int pi = win_pos[i], pj = win_pos[j];
        if (before(kj, pj, ki, pi) == best_first) {
          win_key[i] = kj;
          win_key[j] = ki;
          win_pos[i] = pj;
          win_pos[j] = pi;
        }
      }
      __syncthreads();
    }
  }
  const int* ib = subset == nullptr ? nullptr : subset + static_cast<size_t>(b) * n;
  int64_t* o = out + static_cast<size_t>(b) * k;
  for (int t = tid; t < k; t += SEL_THREADS) o[t] = ib == nullptr ? win_pos[t] : ib[win_pos[t]];
  if (cert != nullptr && tid == 0) {
    const float v = key_value(sel.x);
    cert[b] = (v > tau[b] && v > 0.0f) ? 1 : 0;  // v > max(tau, 0), NaN tau failing
  }
}

// nms_select_kernel for k > MAX_SLOTS: the winners are placed and sorted in
// work [B, 2 * slots] (keys, then positions) in device memory. Writes and
// reads of one block's threads are ordered by __syncthreads, as in shared
// memory; the bitonic network, and so the order, is the one above. Its own
// copy of that body: one inline body for both changed nms_select_kernel's
// code (64 -> 92 bytes spilled), which the k <= 8192 path keeps.
__global__ void __launch_bounds__(SEL_THREADS)
nms_select_wide_kernel(const int* __restrict__ keys, const int* __restrict__ subset,
                       const int* __restrict__ gate, int gate_want, const float* __restrict__ tau,
                       int* __restrict__ cert, int64_t* __restrict__ out,
                       uint32_t* __restrict__ work, int batch, int n, int k, int slots) {
  extern __shared__ uint32_t staged[];  // [n] when staged
  __shared__ SelectSmem sm;
  const int tid = threadIdx.x, b = blockIdx.x;
  if (!gate_open(gate, batch, gate_want)) {
    if (cert != nullptr && tid == 0) cert[b] = 0;
    return;
  }
  uint32_t* win_key = work + static_cast<size_t>(b) * 2 * slots;
  int* win_pos = reinterpret_cast<int*>(win_key + slots);
  const int* kb = keys + static_cast<size_t>(b) * n;
  const bool is_staged = n <= MAX_STAGED;
  if (is_staged)
    for (int i = tid; i < n; i += SEL_THREADS) staged[i] = unsigned_key(kb[i]);
  __syncthreads();
  const auto key_at = [&](int i) { return is_staged ? staged[i] : unsigned_key(kb[i]); };

  const uint2 sel = select_kth(key_at, n, k, sm);
  compact(key_at, n, sel, sm, [&](int slot, int i, uint32_t key) {
    win_key[slot] = key;
    win_pos[slot] = i;
  });
  for (int t = k + tid; t < slots; t += SEL_THREADS) {
    win_key[t] = 0u;
    win_pos[t] = INT32_MAX;
  }
  __syncthreads();
  for (int size = 2; size <= slots; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = tid; p < slots / 2; p += SEL_THREADS) {
        const int i = 2 * p - (p & (stride - 1));
        const int j = i + stride;
        const bool best_first = (i & size) == 0;
        const uint32_t ki = win_key[i], kj = win_key[j];
        const int pi = win_pos[i], pj = win_pos[j];
        if (before(kj, pj, ki, pi) == best_first) {
          win_key[i] = kj;
          win_key[j] = ki;
          win_pos[i] = pj;
          win_pos[j] = pi;
        }
      }
      __syncthreads();
    }
  }
  const int* ib = subset == nullptr ? nullptr : subset + static_cast<size_t>(b) * n;
  int64_t* o = out + static_cast<size_t>(b) * k;
  for (int t = tid; t < k; t += SEL_THREADS) o[t] = ib == nullptr ? win_pos[t] : ib[win_pos[t]];
  if (cert != nullptr && tid == 0) {
    const float v = key_value(sel.x);
    cert[b] = (v > tau[b] && v > 0.0f) ? 1 : 0;
  }
}

// scores, mask [B, n] -> idx_m [B, m] int32: the indices of the m largest
// masked scores (invalid -inf; ties to the lower index) in index order;
// tau [B]: the m-th largest; pre_ok [B]: at least s_need masked scores > 0.
__global__ void __launch_bounds__(SEL_THREADS)
nms_top_m_kernel(const float* __restrict__ scores, const uint8_t* __restrict__ mask, int n, int m,
                 int s_need, int* __restrict__ idx_m, float* __restrict__ tau,
                 int* __restrict__ pre_ok) {
  extern __shared__ uint32_t staged[];  // [n] when staged
  __shared__ SelectSmem sm;
  const int tid = threadIdx.x, b = blockIdx.x;
  const float* cb = scores + static_cast<size_t>(b) * n;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * n;
  const auto ranked = [&](int i) {
    return unsigned_key(total_order((mb == nullptr || mb[i] != 0) ? cb[i] : -INFINITY));
  };
  const bool is_staged = n <= MAX_STAGED;
  if (is_staged)
    for (int i = tid; i < n; i += SEL_THREADS) staged[i] = ranked(i);
  __syncthreads();
  const auto key_at = [&](int i) { return is_staged ? staged[i] : ranked(i); };

  const uint2 sel = select_kth(key_at, n, m, sm);
  int* o = idx_m + static_cast<size_t>(b) * m;
  compact(key_at, n, sel, sm, [&](int slot, int i, uint32_t) { o[slot] = i; });

  int positive = 0;
  for (int i = tid; i < n; i += SEL_THREADS) positive += key_value(key_at(i)) > 0.0f;
  const int incl = radix::block_scan<SEL_WARPS>(positive, sm.warp_sums);
  if (tid == SEL_THREADS - 1) {
    tau[b] = key_value(sel.x);
    pre_ok[b] = incl >= s_need ? 1 : 0;
  }
}

// per device: the dynamic shared memory the selects may use is raised once
bool raise_smem_limits() {
  static bool raised[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return false;
  if (raised[dev]) return true;
  const int sel_bytes = (2 * MAX_SLOTS + MAX_STAGED) * 4;
  if (cudaFuncSetAttribute(nms_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           sel_bytes) != cudaSuccess)
    return false;
  if (cudaFuncSetAttribute(nms_top_m_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           MAX_STAGED * 4) != cudaSuccess)
    return false;
  if (cudaFuncSetAttribute(nms_select_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           MAX_STAGED * 4) != cudaSuccess)
    return false;
  raised[dev] = true;
  return true;
}

}  // namespace

extern "C" int nms_local_max(const void* src, const void* scores, const void* mask,
                             const void* subset, const void* gate, int gate_want, int batch,
                             int n_all, int n, float r2, void* flags, void* keys, void* tiles,
                             void* stream) {
  if (n < 1 || n > n_all) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + 31) / 32, batch);
  nms_flags_kernel<<<grid, FLAG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float*>(scores),
      static_cast<const uint8_t*>(mask), static_cast<const int*>(subset),
      static_cast<const int*>(gate), gate_want, batch, n_all, n, r2, static_cast<float*>(flags),
      static_cast<int*>(keys), static_cast<unsigned long long*>(tiles));
  return static_cast<int>(cudaGetLastError());
}

// work: [batch, 2 * slots] int32 (slots the power of two >= k) when
// k > MAX_SLOTS, else unused
extern "C" int nms_select(const void* keys, const void* subset, const void* gate, int gate_want,
                          const void* tau, void* cert, void* out, void* work, int batch, int n,
                          int k, void* stream) {
  if (k < 1 || k > n) return static_cast<int>(cudaErrorInvalidValue);
  if (!raise_smem_limits()) return static_cast<int>(cudaGetLastError());
  int slots = 1;
  while (slots < k) slots <<= 1;
  if (k > MAX_SLOTS) {
    if (work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const size_t staged = (n <= MAX_STAGED ? static_cast<size_t>(n) : 0) * 4;
    nms_select_wide_kernel<<<batch, SEL_THREADS, staged, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(keys), static_cast<const int*>(subset),
        static_cast<const int*>(gate), gate_want, static_cast<const float*>(tau),
        static_cast<int*>(cert), static_cast<int64_t*>(out), static_cast<uint32_t*>(work), batch,
        n, k, slots);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t bytes = (2 * static_cast<size_t>(slots) + (n <= MAX_STAGED ? n : 0)) * 4;
  nms_select_kernel<<<batch, SEL_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), static_cast<const int*>(subset),
      static_cast<const int*>(gate), gate_want, static_cast<const float*>(tau),
      static_cast<int*>(cert), static_cast<int64_t*>(out), batch, n, k, slots);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nms_top_m(const void* scores, const void* mask, void* idx_m, void* tau,
                         void* pre_ok, int batch, int n, int m, int s_need, void* stream) {
  if (m < 1 || m > n) return static_cast<int>(cudaErrorInvalidValue);
  if (!raise_smem_limits()) return static_cast<int>(cudaGetLastError());
  const size_t bytes = (n <= MAX_STAGED ? static_cast<size_t>(n) : 0) * 4;
  nms_top_m_kernel<<<batch, SEL_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<const uint8_t*>(mask), n, m, s_need,
      static_cast<int*>(idx_m), static_cast<float*>(tau), static_cast<int*>(pre_ok));
  return static_cast<int>(cudaGetLastError());
}
