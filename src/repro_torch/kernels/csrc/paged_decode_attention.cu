// paged_decode_attention: one query token per sequence against a paged
// KV cache read through per-sequence block tables, written for NVIDIA
// Hopper (sm_90a).  The paged serving engine's decode step runs it, once
// per layer.
//
// Replaces the TPU kernel src/repro/kernels/paged_decode_attention.py:
// paged_decode_attention (its pallas_call is at
// paged_decode_attention.py:108), the GQA variant.  Same function:
// q (B,H,D), k/v_pages (P, ps, Hkv, D|Dv), block_tables (B, Pseq) int32,
// lengths (B,) int32 -> (B,H,Dv) in q's dtype, scale 1/sqrt(D).  Token t
// of row b lies at page block_tables[b, t / ps], slot t % ps, and counts
// iff t < lengths[b] and, with a window, lengths[b] - 1 - t < window;
// with soft_cap > 0 a score s becomes tanh(s / cap) * cap before the
// mask.  A row with no such token gives zeros.
//
// What bounds it on this card: bytes.  At the serving shape (B = 32,
// H = Hkv = 32, D = 64, bf16, 65 to 72 tokens a row) one call reads
// 19 MB of K and V for 19 MFLOP: 5.7 us at the HBM rate against 0.02 us
// at the bf16 tensor-core rate.
//
// Design (simple and right first): the block and warp layout of
// decode_attention.cu (one block of 4 warps per (b, kv head, group of up
// to 8 query heads); the warps take 32-token chunks in turn, stage them
// in shared memory and fold them into per-head online-softmax state in
// registers; a merge through shared memory at the end).  Where the TPU
// kernel's grid walks every entry of the block table, a block here loads
// its row's length and visits only the tokens that can count: from
// lengths[b] - window (or 0) to lengths[b] - 1.  Each lane gathers
// through the block table itself, so the pages may lie anywhere in the
// pool; ids past a row's last page are never read.  fp32 throughout,
// expf and tanhf without fast math; D, Dv <= 128.

#include "attention_common.cuh"

namespace {

using namespace attn;

template <typename T>
__global__ void __launch_bounds__(kDecodeWarps * kWarp)
paged_decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                              const T* __restrict__ v_pages,
                              const int* __restrict__ block_tables,
                              const int* __restrict__ lengths, T* __restrict__ out,
                              int H, int Hkv, int ps, int Pseq, int D, int Dv,
                              float scale, float soft_cap, int window) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / Hkv;
  const int h0 = kvh * G + blockIdx.z * kMaxGroup;
  const int ng = min(kMaxGroup, kvh * G + G - h0);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  float* qs = smem;
  float* chunks = qs + kMaxGroup * D;
  float* ks = chunks + warp * (kWarp * (D + 1) + kWarp * Dv);
  float* vs = ks + kWarp * (D + 1);

  for (int i = threadIdx.x; i < ng * D; i += blockDim.x)
    qs[i] = to_float(q[(static_cast<size_t>(b) * H + h0) * D + i]);
  __syncthreads();

  RowState st[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) st[g].init();

  const int n_tok = min(lengths[b], Pseq * ps);
  const int t_lo = window > 0 ? max(0, n_tok - window) : 0;
  const int* table = block_tables + static_cast<size_t>(b) * Pseq;
  // (page * ps + slot) * Hkv + kvh: the K/V row of token t
  auto kv_row = [&](int t) {
    return (static_cast<size_t>(table[t / ps]) * ps + t % ps) * Hkv + kvh;
  };
  for (int c0 = (t_lo / kWarp) * kWarp + warp * kWarp; c0 < n_tok;
       c0 += kDecodeWarps * kWarp) {
    auto have = [&](int j) { return c0 + j < n_tok; };
    stage_chunk(ks, D, D + 1,
                [&](int j, int d) { return to_float(k_pages[kv_row(c0 + j) * D + d]); },
                have, lane);
    stage_chunk(vs, Dv, Dv,
                [&](int j, int d) { return to_float(v_pages[kv_row(c0 + j) * Dv + d]); },
                have, lane);
    __syncwarp();
    const int t = c0 + lane;
    const bool ok = t >= t_lo && t < n_tok;
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < ng)
        fold_chunk(st[g], qs + g * D, ks, vs, D, Dv, scale, soft_cap, ok, lane);
    __syncwarp();
  }
  merge_warps(st, ng, Dv, chunks, out,
              [&](int g) { return static_cast<size_t>(b) * H + h0 + g; });
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* block_tables, const void* lengths, void* out, int B, int H,
           int Hkv, int ps, int Pseq, int D, int Dv, float soft_cap, int window,
           void* stream) {
  const size_t smem = sizeof(float) * decode_smem_floats(D, Dv);
  cudaError_t err = allow_smem<&paged_decode_attention_kernel<T>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = H / Hkv;
  const dim3 grid(Hkv, B, (G + kMaxGroup - 1) / kMaxGroup);
  paged_decode_attention_kernel<T><<<grid, kDecodeWarps * kWarp, smem,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(block_tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), H, Hkv, ps, Pseq, D, Dv,
      1.0f / sqrtf(static_cast<float>(D)), soft_cap, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; return cudaGetLastError() (0 when accepted).  The
// caller checks shapes: Hkv divides H, B >= 1, D and Dv in 1..128,
// window 0 (none) or >= 1, soft_cap 0 (none) or > 0; every page id of a
// row's first ceil(lengths[b] / ps) table entries lies in the pool.
extern "C" int paged_decode_attention_f32(const void* q, const void* k_pages,
                                          const void* v_pages, const void* block_tables,
                                          const void* lengths, void* out, int B, int H,
                                          int Hkv, int ps, int Pseq, int D, int Dv,
                                          float soft_cap, int window, void* stream) {
  return launch<float>(q, k_pages, v_pages, block_tables, lengths, out, B, H, Hkv, ps,
                       Pseq, D, Dv, soft_cap, window, stream);
}

extern "C" int paged_decode_attention_bf16(const void* q, const void* k_pages,
                                           const void* v_pages, const void* block_tables,
                                           const void* lengths, void* out, int B, int H,
                                           int Hkv, int ps, int Pseq, int D, int Dv,
                                           float soft_cap, int window, void* stream) {
  return launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables, lengths, out, B, H,
                               Hkv, ps, Pseq, D, Dv, soft_cap, window, stream);
}
