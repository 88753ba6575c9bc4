// Spatial-consistency attention, CUDA C++ for sm_90a: over the int8 cache
// the running-max (flash) kernel and, further down, the offset-softmax
// kernel; at the end of the file the running-max kernel without a cache,
// which computes the compat tile from the geometry. All three run the loop of
// offset_attention.cuh: the two N^2 C products on the bf16 tensor cores
// (mma.sync), the cache stream read once where there is one.
//
// Replaces the TPU kernel pointdsc_tpu/kernels/sc_attention.py:417
// (_sc_attention_cached_kernel, pallas_call at :590), the
// fused_sc_attention_cached(offset_softmax=False) path:
//
//   out = softmax_j(compat_ij / 127 * q_i.k_j / sqrt(C) + bias_j) v_j
//
// q, k, v [B, N, 128] bf16, compat [B, N, N] int8, bias [B, N] (0 valid,
// -1e9 padded), out [B, N, 128] f32 (a wider model: [B, N, 128 m], run by
// the wide kernel just below, at the cost of m^2 Q K^T passes). The
// 1/sqrt(C)/127 decode is folded into one qk scale; m starts at -1e9, p is
// rounded to bf16 before p v (l is summed from the f32 p) and the result is
// acc / (l + 1e-30), as on the TPU,
// where the JAX wrapper rounds q, k, v to bf16 (sc_attention.py:631) and the
// kernel rounds p to its v's type (:460).
//
// A TPU grid carries m, l and acc in scratch across sequential key steps; a
// CUDA block cannot, so the key loop is the block's own: a block owns 32
// query rows and walks all key tiles of 64 rows, keeping acc in mma
// fragments and m, l per row (attention_rows<true>).
//
// Bound on the H100: per layer at N = 5120 the kernel must read the 26.2 MB
// cache and do 4 N^2 C = 13.4 GFLOP of products on bf16 operands: 14 us on
// the tensor cores (0.20 ms on the f32 CUDA cores); the K and V re-reads of
// the 32-row blocks come from L2.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "offset_attention.cuh"

namespace {

// Every form above C = 128: q, k, v [B, N, ld] bf16, ld = 128 m (a wider
// model zero-padded to m chunks), out [B, N, ld] f32. A block owns 32 query
// rows and makes m passes of the wide loop (offset_attention.cuh), one per
// output chunk. bias is the key bias row (kCacheInt8) or unused (kGeometry:
// row 8 of the strip); kscale is read by the offset form only.
template <bool kRunningMax, oa::CompatSource kSrc>
__global__ void __launch_bounds__(oa::THREADS, 2)
sc_attention_wide_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const int8_t* __restrict__ compat, const float* __restrict__ bias,
                         const float* __restrict__ kscale, const float* __restrict__ geom,
                         float* __restrict__ out, int n, int ld, float sig2, float qk_scale) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * oa::BQ;
  const size_t base = static_cast<size_t>(b) * n;
  const float* g = kSrc == oa::kGeometry ? geom + base * 16 : nullptr;
  const float* brow = kSrc == oa::kGeometry ? g + 8 * static_cast<size_t>(n) : bias + base;
  const float ks = kRunningMax ? 0.f : kscale[b];
  const int ry = threadIdx.x >> 5, cx = threadIdx.x & 31;
  for (int oc = 0; oc < ld / oa::C; ++oc) {
    float acc[4][4];
    oa::attention_rows<kRunningMax, kSrc, true>(
        q + base * ld, k + base * ld, v + base * ld,
        kSrc == oa::kGeometry ? nullptr : compat + base * n, brow, ks, n, q0, qk_scale, smem,
        acc, g, sig2, ld, oc);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 4 * ry + r;
      if (q0 + row >= n) continue;
      const float l = smem[oa::OFF_L + row] + 1e-30f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[(base + q0 + row) * ld + oa::C * oc + cx + 32 * j] = acc[r][j] / l;
    }
  }
}

template <bool kRunningMax, oa::CompatSource kSrc>
int launch_wide(const void* q, const void* k, const void* v, const void* compat,
                const void* bias, const void* kscale, const void* geom, void* out, int batch,
                int n, int ld, float sig2, float qk_scale, void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(sc_attention_wide_kernel<kRunningMax, kSrc>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(oa::SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ld < oa::C || ld % oa::C) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + oa::BQ - 1) / oa::BQ, batch);
  sc_attention_wide_kernel<kRunningMax, kSrc>
      <<<grid, oa::THREADS, oa::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), static_cast<const int8_t*>(compat),
          static_cast<const float*>(bias), static_cast<const float*>(kscale),
          static_cast<const float*>(geom), static_cast<float*>(out), n, ld, sig2, qk_scale);
  return static_cast<int>(cudaGetLastError());
}

__global__ void __launch_bounds__(oa::THREADS, 2)
sc_attention_cached_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const int8_t* __restrict__ compat, const float* __restrict__ bias,
                           float* __restrict__ out, int n, float qk_scale) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * oa::BQ;
  const size_t base = static_cast<size_t>(b) * n;
  float acc[4][4];
  oa::attention_rows<true>(q + base * oa::C, k + base * oa::C, v + base * oa::C,
                           compat + base * n, bias + base, 0.f, n, q0, qk_scale, smem, acc);
  const int ry = threadIdx.x >> 5, cx = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 4 * ry + r;
    if (q0 + row >= n) continue;
    const float l = smem[oa::OFF_L + row] + 1e-30f;
#pragma unroll
    for (int j = 0; j < 4; ++j) out[(base + q0 + row) * oa::C + cx + 32 * j] = acc[r][j] / l;
  }
}

}  // namespace

// ld: the row width of q, k, v and out (128, or a wider model's 128 m)
extern "C" int sc_attention_cached(const void* q, const void* k, const void* v,
                                   const void* compat, const void* bias, void* out, int batch,
                                   int n, int ld, float qk_scale, void* stream) {
  if (ld != oa::C)
    return launch_wide<true, oa::kCacheInt8>(q, k, v, compat, bias, nullptr, nullptr, out, batch,
                                             n, ld, 0.f, qk_scale, stream);
  // per call: the attribute belongs to the current device
  const cudaError_t err = cudaFuncSetAttribute(
      sc_attention_cached_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(oa::SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + oa::BQ - 1) / oa::BQ, batch);
  sc_attention_cached_kernel<<<grid, oa::THREADS, oa::SMEM_BYTES,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int8_t*>(compat),
      static_cast<const float*>(bias), static_cast<float*>(out), n, qk_scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Offset-softmax attention over the same cache.
//
// Replaces the TPU kernel pointdsc_tpu/kernels/sc_attention.py:472
// (_sc_attention_cached_offset_kernel, pallas_call at :582), the
// fused_sc_attention_cached(offset_softmax=True) path:
//
//   p_ij = exp(max(compat_ij / 127 * q_i.k_j / sqrt(C) + bias_j - o_i, -80)),
//   p_ij = 0 where bias_j < 0,   o_i = ||q_i|| * kscale,
//   out_i = sum_j p_ij v_j / (sum_j p_ij + 1e-30)
//
// kscale = max_j ||k_j|| / sqrt(C) is one f32 per pair in device memory,
// reduced by the wrapper and read here by pointer, so no host read sits
// between the layers. q, k, v are bf16 (the half-precision encoder's own
// type; the wrapper rounds f32 inputs, as the JAX wrapper does off the CPU),
// and p is rounded to bf16 before the p v product, as the TPU kernel rounds
// it to its v's type. The loop is offset_attention.cuh's: the two N^2 C
// products on the bf16 tensor cores (mma.sync), the cache stream read once.

namespace {

__global__ void __launch_bounds__(oa::THREADS, 2)
sc_attention_offset_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const int8_t* __restrict__ compat, const float* __restrict__ bias,
                           const float* __restrict__ kscale, float* __restrict__ out, int n,
                           float qk_scale) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * oa::BQ;
  const size_t base = static_cast<size_t>(b) * n;
  float acc[4][4];
  oa::attention_rows(q + base * oa::C, k + base * oa::C, v + base * oa::C, compat + base * n,
                     bias + base, kscale[b], n, q0, qk_scale, smem, acc);
  const int ry = threadIdx.x >> 5, cx = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 4 * ry + r;
    if (q0 + row >= n) continue;
    const float l = smem[oa::OFF_L + row] + 1e-30f;
#pragma unroll
    for (int j = 0; j < 4; ++j) out[(base + q0 + row) * oa::C + cx + 32 * j] = acc[r][j] / l;
  }
}

}  // namespace

extern "C" int sc_attention_cached_offset(const void* q, const void* k, const void* v,
                                          const void* compat, const void* bias,
                                          const void* kscale, void* out, int batch, int n,
                                          int ld, float qk_scale, void* stream) {
  if (ld != oa::C)
    return launch_wide<false, oa::kCacheInt8>(q, k, v, compat, bias, kscale, nullptr, out, batch,
                                              n, ld, 0.f, qk_scale, stream);
  const cudaError_t err = cudaFuncSetAttribute(
      sc_attention_offset_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(oa::SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + oa::BQ - 1) / oa::BQ, batch);
  sc_attention_offset_kernel<<<grid, oa::THREADS, oa::SMEM_BYTES,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int8_t*>(compat),
      static_cast<const float*>(bias), static_cast<const float*>(kscale),
      static_cast<float*>(out), n, qk_scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Running-max attention without a cache: the compat tile from the geometry.
//
// Replaces the TPU kernel pointdsc_tpu/kernels/sc_attention.py:82
// (_sc_attention_kernel, pallas_call at :159), the fused_sc_attention path
// (the model's fused_cache_compat=False):
//
//   compat_ij = max(1 - (d_src_ij - d_tgt_ij)^2 / sigma_d^2, 0)
//   out = softmax_j(compat_ij * q_i.k_j / sqrt(C) + bias_j) v_j
//
// q, k, v [B, N, 128] bf16, geom [B, 16, N] f32 (pack_geometry: rows 0-7 the
// two clouds' coordinates and squared norms, row 8 the key bias, 0 valid /
// -1e9 padded), out [B, N, 128] f32. As on the TPU, where the JAX wrapper
// rounds q, k, v to bf16 off the CPU (sc_attention.py:209-212) and the kernel
// rounds p to its v's type (:128): m starts at -1e9, masked keys keep their
// -1e9 bias (no p = 0 override), l is summed from the f32 p, and the result
// is acc / (l + 1e-30). The loop is the running max of offset_attention.cuh
// with its geometry compat source (compat_geom.cuh's entry, bit for bit the
// plain version's compat).
//
// Bound on the H100, per pair at N = 5120: the two N^2 C products, 13.4
// GFLOP on bf16 operands (14 us on the tensor cores), and the N^2 compat
// entries in f32 (25 operations each, 10 us at 67 TFLOP/s); nothing [N, N]
// is read. The compat entries take the place of the int8 stream of the
// cached kernel: two sqrt and an IEEE division per entry on the CUDA cores.

namespace {

__global__ void __launch_bounds__(oa::THREADS, 2)
sc_attention_nocache_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const float* __restrict__ geom, float* __restrict__ out, int n,
                            float sig2, float qk_scale) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * oa::BQ;
  const size_t base = static_cast<size_t>(b) * n;
  const float* g = geom + base * 16;
  float acc[4][4];
  oa::attention_rows<true, oa::kGeometry>(q + base * oa::C, k + base * oa::C, v + base * oa::C,
                                          nullptr, g + 8 * static_cast<size_t>(n), 0.f, n, q0,
                                          qk_scale, smem, acc, g, sig2);
  const int ry = threadIdx.x >> 5, cx = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 4 * ry + r;
    if (q0 + row >= n) continue;
    const float l = smem[oa::OFF_L + row] + 1e-30f;
#pragma unroll
    for (int j = 0; j < 4; ++j) out[(base + q0 + row) * oa::C + cx + 32 * j] = acc[r][j] / l;
  }
}

}  // namespace

extern "C" int sc_attention_nocache(const void* q, const void* k, const void* v,
                                    const void* geom, void* out, int batch, int n, int ld,
                                    float sig2, float qk_scale, void* stream) {
  if (ld != oa::C)
    return launch_wide<true, oa::kGeometry>(q, k, v, nullptr, nullptr, nullptr, geom, out, batch,
                                            n, ld, sig2, qk_scale, stream);
  const cudaError_t err = cudaFuncSetAttribute(
      sc_attention_nocache_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(oa::SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + oa::BQ - 1) / oa::BQ, batch);
  sc_attention_nocache_kernel<<<grid, oa::THREADS, oa::SMEM_BYTES,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(geom),
      static_cast<float*>(out), n, sig2, qk_scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Both cached attentions on a row shard: nq query rows over all nk keys.
//
// Replaces the rectangular form of the same TPU kernels (sc_attention.py:417
// and :472 through _fused_sc_attention_cached_single, pallas_call at :590
// and :582, whose q "may hold a row shard (nq rows) attending over all nk
// keys"), the sequence-parallel encoder's per-shard attention
// (pointdsc_tpu/parallel/seq_parallel.py::sp_encode_fused):
//
//   q [B, nq, ld], k, v [B, nk, ld] bf16, compat [B, nq, nk] int8 (the
//   shard's slice of the cache, row stride nk), bias [B, nk], out [B, nq, ld]
//   f32; the offset form's kscale [B] = max over all nk keys of ||k_j|| /
//   sqrt(C), as on the TPU, where it is reduced over the gathered keys.
//
// The math and the loop are the square kernels' (attention_rows with kRect:
// only the query rows' bound and the strides differ), so a shard's rows equal
// the square kernel's rows of the whole cloud when nq = nk. ld = 128 runs the
// one-pass loop, a wider model the wide loop, one pass per 128-wide output
// chunk. Bound on the H100, per shard and layer: the shard's nq nk cache bytes
// and 4 nq nk C products on bf16 operands, 1/D of the square kernel's.

namespace {

template <bool kRunningMax, bool kWide>
__global__ void __launch_bounds__(oa::THREADS, 2)
sc_attention_rect_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const int8_t* __restrict__ compat, const float* __restrict__ bias,
                         const float* __restrict__ kscale, float* __restrict__ out, int nq,
                         int nk, int ld, float qk_scale) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * oa::BQ;
  const size_t qbase = static_cast<size_t>(b) * nq, kbase = static_cast<size_t>(b) * nk;
  const float ks = kRunningMax ? 0.f : kscale[b];
  const int ry = threadIdx.x >> 5, cx = threadIdx.x & 31;
  for (int oc = 0; oc < ld / oa::C; ++oc) {
    float acc[4][4];
    oa::attention_rows<kRunningMax, oa::kCacheInt8, kWide, true>(
        q + qbase * ld, k + kbase * ld, v + kbase * ld, compat + qbase * nk, bias + kbase, ks,
        nk, q0, qk_scale, smem, acc, nullptr, 0.f, ld, oc, nq);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 4 * ry + r;
      if (q0 + row >= nq) continue;
      const float l = smem[oa::OFF_L + row] + 1e-30f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[(qbase + q0 + row) * ld + oa::C * oc + cx + 32 * j] = acc[r][j] / l;
    }
  }
}

template <bool kRunningMax, bool kWide>
int launch_rect(const void* q, const void* k, const void* v, const void* compat,
                const void* bias, const void* kscale, void* out, int batch, int nq, int nk,
                int ld, float qk_scale, void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(sc_attention_rect_kernel<kRunningMax, kWide>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(oa::SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nq + oa::BQ - 1) / oa::BQ, batch);
  sc_attention_rect_kernel<kRunningMax, kWide>
      <<<grid, oa::THREADS, oa::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), static_cast<const int8_t*>(compat),
          static_cast<const float*>(bias), static_cast<const float*>(kscale),
          static_cast<float*>(out), nq, nk, ld, qk_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// running_max: 1 the running-max form (kscale unused), 0 the offset form
extern "C" int sc_attention_cached_rect(const void* q, const void* k, const void* v,
                                        const void* compat, const void* bias,
                                        const void* kscale, void* out, int batch, int nq, int nk,
                                        int ld, float qk_scale, int running_max, void* stream) {
  if (nq < 1 || nk < 1 || ld < oa::C || ld % oa::C)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = ld != oa::C;
  if (running_max)
    return wide ? launch_rect<true, true>(q, k, v, compat, bias, kscale, out, batch, nq, nk, ld,
                                          qk_scale, stream)
                : launch_rect<true, false>(q, k, v, compat, bias, kscale, out, batch, nq, nk, ld,
                                           qk_scale, stream);
  return wide ? launch_rect<false, true>(q, k, v, compat, bias, kscale, out, batch, nq, nk, ld,
                                         qk_scale, stream)
              : launch_rect<false, false>(q, k, v, compat, bias, kscale, out, batch, nq, nk, ld,
                                          qk_scale, stream);
}
