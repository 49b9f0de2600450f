// decode_attention: one query token per sequence against a contiguous
// KV cache with a validity mask, written for NVIDIA Hopper (sm_90a).
// The dense serving engine's decode step runs it, once per layer.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// decode_attention (its pallas_call is at decode_attention.py:71).  Same
// function: q (B,H,D), k/v (B,C,Hkv,D|Dv), valid (B,C) bool ->
// (B,H,Dv) in q's dtype, scale 1/sqrt(D); query head h reads kv head
// h / G (G = H / Hkv).
//
// What bounds it on this card: bytes.  At the serving shape (B = 8,
// H = Hkv = 32, C = 256, D = 64, bf16) one call reads a layer's whole
// cache, 16.8 MB of K and V, for 16.8 MFLOP: 5.0 us at the HBM rate
// against 0.02 us at the bf16 tensor-core rate.  Reading each K/V row once is
// the whole game.
//
// Design (simple and right first): one block of 4 warps per (b, kv
// head, group of up to 8 query heads), so the G query heads of a kv head
// share every K/V read.  The warps take 32-key chunks in turn; each
// stages its chunk in shared memory (K rows padded to D + 1 floats), and
// lane j scores key j for every head of the group, folding it into the
// head's running max, sum and output held in registers (lane i holds
// dims i, i + 32, ...).  At the end the warps' partial softmaxes are
// rescaled to their common max and summed through shared memory.  fp32
// throughout, expf without fast math; D, Dv <= 128.

#include "attention_common.cuh"

namespace {

using namespace attn;

template <typename T>
__global__ void __launch_bounds__(kDecodeWarps * kWarp)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const unsigned char* __restrict__ valid,
                        T* __restrict__ out, int C, int H, int Hkv, int D, int Dv,
                        float scale) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / Hkv;
  const int h0 = kvh * G + blockIdx.z * kMaxGroup;  // first query head
  const int ng = min(kMaxGroup, kvh * G + G - h0);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  float* qs = smem;                                       // (kMaxGroup, D)
  float* chunks = qs + kMaxGroup * D;
  float* ks = chunks + warp * (kWarp * (D + 1) + kWarp * Dv);
  float* vs = ks + kWarp * (D + 1);

  for (int i = threadIdx.x; i < ng * D; i += blockDim.x)
    qs[i] = to_float(q[(static_cast<size_t>(b) * H + h0) * D + i]);
  __syncthreads();

  RowState st[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) st[g].init();

  const size_t row0 = static_cast<size_t>(b) * C;  // cache row of key 0
  for (int c0 = warp * kWarp; c0 < C; c0 += kDecodeWarps * kWarp) {
    auto have = [&](int j) { return c0 + j < C; };
    stage_chunk(ks, D, D + 1,
                [&](int j, int d) {
                  return to_float(k[((row0 + c0 + j) * Hkv + kvh) * D + d]);
                }, have, lane);
    stage_chunk(vs, Dv, Dv,
                [&](int j, int d) {
                  return to_float(v[((row0 + c0 + j) * Hkv + kvh) * Dv + d]);
                }, have, lane);
    __syncwarp();
    const bool ok = c0 + lane < C && valid[row0 + c0 + lane];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < ng) fold_chunk(st[g], qs + g * D, ks, vs, D, Dv, scale, 0.0f, ok, lane);
    __syncwarp();  // chunk fully read before the next one is staged
  }
  merge_warps(st, ng, Dv, chunks, out,
              [&](int g) { return static_cast<size_t>(b) * H + h0 + g; });
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid, void* out,
           int B, int H, int Hkv, int C, int D, int Dv, void* stream) {
  const size_t smem = sizeof(float) * decode_smem_floats(D, Dv);
  cudaError_t err = allow_smem<&decode_attention_kernel<T>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = H / Hkv;
  const dim3 grid(Hkv, B, (G + kMaxGroup - 1) / kMaxGroup);
  decode_attention_kernel<T><<<grid, kDecodeWarps * kWarp, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const unsigned char*>(valid), static_cast<T*>(out), C, H, Hkv, D, Dv,
      1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; return cudaGetLastError() (0 when accepted).  The
// caller checks shapes: Hkv divides H, B and C >= 1, D and Dv in 1..128,
// `valid` one byte per (b, c).
extern "C" int decode_attention_f32(const void* q, const void* k, const void* v,
                                    const void* valid, void* out, int B, int H, int Hkv,
                                    int C, int D, int Dv, void* stream) {
  return launch<float>(q, k, v, valid, out, B, H, Hkv, C, D, Dv, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* valid, void* out, int B, int H, int Hkv,
                                     int C, int D, int Dv, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, valid, out, B, H, Hkv, C, D, Dv, stream);
}
