// The exact radix select of the k-th largest key, shared by the seed k-NN's
// selection (seed_knn.cu) and the seed NMS's two selects (nms.cu).
//
// A block owns one row of n unsigned keys, read through key_at(i). Four
// passes over 8-bit digits, most significant first: each builds a
// shared-memory histogram of the digit among the keys that share the digits
// found so far, and one block scan over the bins from the top finds the bin
// that holds the k-th largest key and its rank there. The result is the
// k-th largest key and how many keys equal to it belong to the top k, from
// which a caller compacts the winners in its own order (seed_knn.cu packs
// its counts for k <= 128; nms.cu places any k).
//
// AGGREGATE: one shared atomic a digit a warp (__match_any_sync), for rows
// whose keys share few digits (the NMS's, mostly +-0.0); else one atomic a
// key. Every operation of the one-atomic-a-key instantiation is the one
// seed_knn.cu held before it moved here: its kernel compiles to the same SASS
// (tools/kernel_report.py --csrc against the earlier sources).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace radix {

constexpr int BINS = 256;

// inclusive prefix sum over the block (WARPS warps), in thread order
template <int WARPS, typename T>
__device__ __forceinline__ T block_scan(T x, T* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = lane < WARPS ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < WARPS; off <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    if (lane < WARPS) warp_sums[lane] = w;
  }
  __syncthreads();
  if (warp > 0) x += warp_sums[warp - 1];
  __syncthreads();  // warp_sums may be reused
  return x;
}

// The k-th largest of the n keys key_at(i) (1 <= k <= n) and how many of the
// top k equal it: (kth, ties). hist [BINS], warp_sums [THREADS / 32],
// digit_s and rank_s live in shared memory.
template <int THREADS, bool AGGREGATE, typename KeyAt>
__device__ __forceinline__ uint2 radix_select(const KeyAt& key_at, int n, int k, int* hist,
                                              int* warp_sums, uint32_t& digit_s, int& rank_s) {
  static_assert(THREADS >= BINS && THREADS % 32 == 0, "a thread clears and scans a bin");
  const int tid = threadIdx.x;
  // after the pass of shift, prefix holds the top digits of the k-th largest
  // key and kk its rank among the keys that share them (declared pmask
  // first: the order in which seed_knn.cu's kernel compiled them before)
  uint32_t pmask = 0, prefix = 0;
  int kk = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    if (THREADS == BINS || tid < BINS) hist[tid] = 0;
    __syncthreads();  // the keys are staged, the bins cleared
    if constexpr (AGGREGATE) {
      const int lane = tid & 31;
      for (int base = 0; base < n; base += THREADS) {
        const int i = base + tid;
        uint32_t digit = BINS;  // no bin
        if (i < n) {
          const uint32_t key = key_at(i);
          if ((key & pmask) == prefix) digit = (key >> shift) & 0xFFu;
        }
        const unsigned peers = __match_any_sync(0xffffffffu, digit);
        if (digit < BINS && lane == __ffs(peers) - 1) atomicAdd(&hist[digit], __popc(peers));
      }
    } else {
      for (int i = tid; i < n; i += THREADS) {
        const uint32_t key = key_at(i);
        if ((key & pmask) == prefix) atomicAdd(&hist[(key >> shift) & 0xFFu], 1);
      }
    }
    __syncthreads();
    // bins from the top: thread t holds digit 255 - t (a thread past the
    // bins holds 0, so its sum cannot straddle kk)
    const int h = (THREADS == BINS || tid < BINS) ? hist[BINS - 1 - tid] : 0;
    const int above_and_own = block_scan<THREADS / 32>(h, warp_sums);
    if (above_and_own >= kk && above_and_own - h < kk) {
      digit_s = BINS - 1 - tid;
      rank_s = kk - (above_and_own - h);
    }
    __syncthreads();
    prefix |= digit_s << shift;
    pmask |= 0xFFu << shift;
    kk = rank_s;
  }
  return make_uint2(prefix, static_cast<uint32_t>(kk));
}

}  // namespace radix
