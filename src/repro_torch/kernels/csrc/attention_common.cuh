// Pieces shared by the port's attention kernels (flash_attention.cu,
// decode_rows.cuh and the two decode kernels that include it,
// paged_mla_decode_attention.cu): element conversion, warp reductions,
// the online-softmax fold of one 32-key chunk (flash's fp32 entry), the
// opt-in to more than 48 KB of dynamic shared memory, and the device's SM
// count (the MLA kernel's split).  topk_router.cu uses the warp
// reductions and the opt-in, mamba_chunk_scan.cu the element conversion
// and the opt-in.
//
// Every kernel accumulates in fp32 whatever its input type (fp32 or bf16;
// the bf16 tensor-core paths multiply bf16 operands, the softmax weights
// rounded to bf16), masks with -1e30 as the JAX kernels do, and clamps
// the softmax denominator at 1e-30.  Every function here is inline or a
// template, so each translation unit may include this header.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn {

constexpr float kNegInf = -1e30f;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch casts
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = kWarp / 2; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Online-softmax state of one query row, spread over a warp: every lane
// holds m and l, lane i holds output dims i, i + 32, ..., kChunks of
// them (value dims up to 32 * kChunks)
template <int kChunks>
struct RowState {
  float m, l, acc[kChunks];
  __device__ __forceinline__ void init() {
    m = kNegInf;
    l = 0.0f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) acc[c] = 0.0f;
  }
};

// Fold one chunk of 32 keys into `st`.  The calling warp has staged the
// keys in `ks` (32 rows of stride D + 1, so lane j reading row j hits
// its own bank) and the values in `vs` (32 rows of stride Dv); lane j
// scores key j against the query row `qrow` (shared memory, read by all
// lanes at once), `ok` says whether key j is unmasked.  Rows of keys past
// the data must hold zeros, not garbage: a masked key still meets a
// 0 * v.
//
// As in the JAX kernels, a chunk in which a row sees no unmasked key
// while its running max is still -1e30 adds junk (exp(0) weights) that
// the first unmasked key wipes out (alpha = exp(-1e30 - m) = 0).
template <int kChunks>
__device__ __forceinline__ void fold_chunk(RowState<kChunks>& st, const float* qrow,
                                           const float* ks, const float* vs,
                                           int D, int Dv, float scale,
                                           float soft_cap, bool ok, int lane) {
  const float* kr = ks + lane * (D + 1);
  float s = 0.0f;
  for (int d = 0; d < D; ++d) s = fmaf(qrow[d], kr[d], s);
  s *= scale;
  if (soft_cap > 0.0f) s = tanhf(s / soft_cap) * soft_cap;
  s = ok ? s : kNegInf;
  const float m_new = fmaxf(st.m, warp_max(s));
  const float alpha = expf(st.m - m_new);
  const float p = expf(s - m_new);
  st.l = st.l * alpha + warp_sum(p);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) st.acc[c] *= alpha;
  for (int j = 0; j < kWarp; ++j) {
    const float pj = __shfl_sync(kFull, p, j);
    const float* vr = vs + j * Dv;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int d = lane + c * kWarp;
      if (d < Dv) st.acc[c] = fmaf(pj, vr[d], st.acc[c]);
    }
  }
  st.m = m_new;
}

// A kernel that needs more than 48 KB of dynamic shared memory has to
// opt in before its launch.  The grant is remembered per kernel (one
// static per instantiation of this template), so a launch inside CUDA
// graph capture that needs no more than an earlier one makes no call.
template <auto kernel>
inline cudaError_t allow_smem(size_t bytes) {
  static size_t granted = 48 * 1024;
  if (bytes <= granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) granted = bytes;
  return err;
}

// The current device's SM count, read once per device.
inline int multiprocessors() {
  constexpr int kMaxDevices = 64;
  static int count[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (dev < kMaxDevices && count[dev] > 0) return count[dev];
  int n = 1;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) n = 1;
  if (dev < kMaxDevices) count[dev] = n;
  return n;
}

}  // namespace attn
