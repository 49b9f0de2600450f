// Pieces shared by the port's attention kernels (flash_attention.cu,
// decode_attention.cu, paged_decode_attention.cu,
// paged_mla_decode_attention.cu): element conversion, warp reductions,
// the online-softmax fold of one 32-key chunk (the paged kernels and
// flash's fp32 entry), register-held row pieces loaded as 16-byte vectors
// (decode_attention.cu), and the opt-in to more than 48 KB of dynamic
// shared memory.  topk_router.cu uses the warp
// reductions and the opt-in, mamba_chunk_scan.cu the element conversion
// and the opt-in.
//
// Every kernel computes in fp32 whatever its input type (fp32 or bf16),
// masks with -1e30 as the JAX kernels do, and clamps the softmax
// denominator at 1e-30.  Every function here is inline or a template, so
// each translation unit may include this header.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace attn {

constexpr float kNegInf = -1e30f;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
// value dims (and the decode kernels' head dims) are at most kMaxDim:
// each lane owns kDimChunks output dims (lane, lane + 32, ...)
constexpr int kMaxDim = 128;
constexpr int kDimChunks = kMaxDim / kWarp;

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
// holds m and l, lane i holds output dims i, i + 32, ...
struct RowState {
  float m, l, acc[kDimChunks];
  __device__ __forceinline__ void init() {
    m = kNegInf;
    l = 0.0f;
#pragma unroll
    for (int c = 0; c < kDimChunks; ++c) acc[c] = 0.0f;
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
__device__ __forceinline__ void fold_chunk(RowState& st, const float* qrow,
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
  for (int c = 0; c < kDimChunks; ++c) st.acc[c] *= alpha;
  for (int j = 0; j < kWarp; ++j) {
    const float pj = __shfl_sync(kFull, p, j);
    const float* vr = vs + j * Dv;
#pragma unroll
    for (int c = 0; c < kDimChunks; ++c) {
      const int d = lane + c * kWarp;
      if (d < Dv) st.acc[c] = fmaf(pj, vr[d], st.acc[c]);
    }
  }
  st.m = m_new;
}

// Stage rows [0, 32) of a chunk into shared memory (row stride `stride`
// floats) with the calling warp: `src(j, d)` gives element d of row j,
// and `have(j)` says whether row j exists; missing rows are zeroed.
template <typename Src, typename Have>
__device__ __forceinline__ void stage_chunk(float* dst, int width, int stride,
                                            Src src, Have have, int lane) {
  for (int i = lane; i < kWarp * width; i += kWarp) {
    const int j = i / width, d = i - j * width;
    dst[j * stride + d] = have(j) ? src(j, d) : 0.0f;
  }
}

// Register-held row pieces (decode_attention.cu): a lane loads kEpl
// consecutive elements of a K or V row at once, as one 16-byte vector
// (`uint4`, 8 bf16 or 4 fp32) when rows allow it, else one element.
template <typename T, bool kVec>
struct RowPiece {
  static constexpr int kEpl = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
  using Raw = typename std::conditional<kVec, uint4, T>::type;

  __device__ __forceinline__ static Raw load(const T* p) {
    if constexpr (kVec) {
      return __ldg(reinterpret_cast<const uint4*>(p));
    } else {
      return p[0];
    }
  }
  __device__ __forceinline__ static Raw zero() {
    if constexpr (kVec) {
      return make_uint4(0u, 0u, 0u, 0u);
    } else {
      return from_float<T>(0.0f);
    }
  }
  // element i < kEpl of the piece, widened to fp32
  __device__ __forceinline__ static float get(const Raw& r, int i) {
    if constexpr (!kVec) {
      return to_float(r);
    } else if constexpr (sizeof(T) == 4) {
      const unsigned w[4] = {r.x, r.y, r.z, r.w};
      return __uint_as_float(w[i]);
    } else {
      const unsigned w[4] = {r.x, r.y, r.z, r.w};
      const unsigned half = (i & 1) ? (w[i >> 1] >> 16) : (w[i >> 1] & 0xffffu);
      return __uint_as_float(half << 16);  // bf16 -> fp32 is a shift
    }
  }
};

// Sum over the `kLanes` consecutive lanes of a lane group (a power of 2).
template <int kLanes>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = kLanes / 2; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Per-head state of the paged decode kernels: up to kMaxGroup query heads
// of one kv head share every K/V chunk a warp stages.
constexpr int kMaxGroup = 8;
constexpr int kDecodeWarps = 4;

// Shared memory of a paged decode block: the group's query rows (kMaxGroup, D)
// and, per warp, one staged chunk of K (32, D + 1) and V (32, Dv).  The
// cross-warp merge reuses the chunk area.
inline size_t decode_smem_floats(int D, int Dv) {
  const size_t per_warp = kWarp * (D + 1) + kWarp * Dv;
  const size_t merge = kMaxGroup * (2 + Dv);
  return kMaxGroup * D + kDecodeWarps * (per_warp > merge ? per_warp : merge);
}

// End of a decode block: each warp has folded its share of the keys into
// st[g] for the block's ng heads; combine the warps' partial softmaxes
// (rescaled to the common max) and write out[row(g) * Dv + d].
template <typename T, typename Row>
__device__ __forceinline__ void merge_warps(const RowState (&st)[kMaxGroup], int ng,
                                            int Dv, float* red, T* out, Row row) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  __syncthreads();  // every warp is done with its chunk area
  float* mine = red + warp * kMaxGroup * (2 + Dv);
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g >= ng) continue;
    float* e = mine + g * (2 + Dv);
    if (lane == 0) {
      e[0] = st[g].m;
      e[1] = st[g].l;
    }
#pragma unroll
    for (int c = 0; c < kDimChunks; ++c) {
      const int d = lane + c * kWarp;
      if (d < Dv) e[2 + d] = st[g].acc[c];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng * Dv; i += blockDim.x) {
    const int g = i / Dv, d = i - g * Dv;
    float m = kNegInf;
    for (int w = 0; w < kDecodeWarps; ++w)
      m = fmaxf(m, red[(w * kMaxGroup + g) * (2 + Dv)]);
    float l = 0.0f, o = 0.0f;
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float* e = red + (w * kMaxGroup + g) * (2 + Dv);
      const float f = expf(e[0] - m);
      l = fmaf(e[1], f, l);
      o = fmaf(e[2 + d], f, o);
    }
    out[row(g) * Dv + d] = from_float<T>(o / fmaxf(l, 1e-30f));
  }
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

}  // namespace attn
