// decode_attention: one query token per sequence against a contiguous
// KV cache with a validity mask, written for NVIDIA Hopper (sm_90a).
// The dense serving engine's decode step runs it, once per layer.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// decode_attention (its pallas_call is at decode_attention.py:71).  Same
// function: q (B,H,D), k/v (B,C,Hkv,D|Dv), valid (B,C) bool ->
// (B,H,Dv) in q's dtype, scale 1/sqrt(D); query head h reads kv head
// h / G (G = H / Hkv).  One argument more than the TPU kernel: with
// soft_cap > 0 a score s becomes tanh(s / cap) * cap before the mask, as
// in the paged kernel, so that the model's dense decode keeps parity with
// JAX's gqa_decode, which applies a config's logit_soft_cap there (the
// JAX models never call their own kernel).  No registered config sets a
// cap: gemma3-1b's is 0.
//
// A second instance the TPU kernel lacks: decode_attention_partial_*,
// the same body over one rank's share of a cache split along its slots
// (the reference's "kv_seq" rule, launch/shardings.py), whose epilogue
// writes the softmax statistics in fp32 in place of o / l: the
// unnormalised output (B,H,Dv), the row max (B,H) and the row sum (B,H),
// for models/sharded.py to merge across the ranks.  Its outputs are the
// deviation: on the TPU, XLA's partitioner splits the reference's
// gqa_decode itself and the Pallas kernel never sees a share.  Invalid
// slots weigh as in the full instance; a row with no valid slot in the
// share reports max -2e38 (the plain version's mask), sum C and the sum
// of V, from the same V-only walk.
//
// What bounds it on this card: bytes.  At the serving shape (B = 8,
// H = Hkv = 32, C = 256 slots of which 57-64 are valid, D = 64, bf16) the
// valid keys are 2.1 MB of K and V for 2.1 MFLOP: 0.6 us at the HBM rate
// against 0.002 us at the bf16 tensor-core rate.  Reading each valid K/V
// row once, with enough bytes in flight to cover the memory latency, is
// the whole game; a launch costs more than either.  At gemma3's shape
// (H = 4, Hkv = 1, D = 256, bf16, C = 256 ring slots of which 57-64 are
// valid) a row's valid keys are 64 KB of K and V, read by four blocks,
// one a query head (decode_rows.cuh says why).  The partial instance at
// a 32,768-slot cache split over two ranks reads up to 16,384 slots a
// row a rank: stablelm's (H = Hkv = 32, D 64) 4.2 MB of K and V a row,
// still one block a (row, kv head): 64 blocks at B 2 on 132 SMs.
//
// Design: one block of 8 warps per (b, kv head, group of up to kGB query
// heads), so the query heads of a kv head share every K/V read; the body
// (16-byte vector loads by 8-lane groups, U keys in flight a lane,
// masked 32-slot windows skipped by ballot, per-group online softmax
// merged by shuffles) is decode_rows.cuh's, shared with the paged kernel.
// Here slot s of row b is cache row (b * C + s) * Hkv + kvh and counts
// iff valid[b, s].  The block first asks whether the row has any valid
// slot (C bytes, from L2): a row with none reads every slot's V and no K,
// and gives the uniform mean of V, as the plain version and the JAX
// kernel do.  Rows wider than 128 are spread over 16 lanes
// (decode_rows.cuh).  The grid is (Hkv, B, ceil(G / kGB)); a row's keys are not
// split over blocks: the time is nearly flat from B = 1 to B = 8
// (PERF.md), so a block's own latency, not the number of idle SMs, sets
// it, and a second combining pass would add a launch.

#include <cstdint>

#include "decode_rows.cuh"

namespace {

using namespace attn;

constexpr int kWarps = 8;

// slot s of a row: cache row (b * C + s) * Hkv + kvh, counted iff valid
struct DenseRows {
  const unsigned char* valid;  // the row's C bytes
  size_t row0;                 // b * C
  int C, Hkv, kvh;
  __device__ __forceinline__ int begin() const { return 0; }
  __device__ __forceinline__ int end() const { return C; }
  __device__ __forceinline__ bool counts(int s) const { return valid[s]; }
  __device__ __forceinline__ size_t row(int s) const {
    return (row0 + s) * Hkv + kvh;
  }
};

// kPartial: the partial instance (decode_rows.cuh), `out` unused and
// `part` pointing at the (B,H,Dv) output and (B,H) max and sum, fp32
template <typename T, bool kVec, int kLanes, int kDims, int kGB, bool kPartial>
__global__ void __launch_bounds__(kWarps * kWarp)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const unsigned char* __restrict__ valid,
                        T* __restrict__ out, PartialOut part, int C, int H, int Hkv,
                        int D, int Dv, float scale, float soft_cap) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / Hkv;
  const int h0 = kvh * G + blockIdx.z * kGB;  // first query head
  const int ng = min(kGB, kvh * G + G - h0);
  float* qs = smem;             // (kGB, D), pre-scaled
  float* red = qs + kGB * D;    // (kWarps, kGB, 2 + Dv)

  const size_t row0 = static_cast<size_t>(b) * C;  // cache row of slot 0
  load_query(qs, q + (static_cast<size_t>(b) * H + h0) * D, ng * D, scale);
  int mine = 0;
  for (int c = threadIdx.x; c < C; c += blockDim.x) mine |= valid[row0 + c];
  const bool any = __syncthreads_or(mine);  // also publishes qs
  const DenseRows rows{valid + row0, row0, C, Hkv, kvh};
  const size_t first = static_cast<size_t>(b) * H + h0;  // the block's first row
  if constexpr (kPartial) {
    part = PartialOut{part.o + first * Dv, part.m + first, part.l + first};
  } else {
    out += first * Dv;
  }
  decode_rows<T, kVec, kLanes, kDims, kGB, kWarps, kPartial>(
      k, v, out, qs, red, rows, any, ng, D, Dv, soft_cap, part);
}

template <bool kPartial>
struct Launch {
  const void *q, *k, *v, *valid;
  void* out;
  PartialOut part;
  int B, H, Hkv, C, D, Dv;
  float soft_cap;
  cudaStream_t stream;

  template <typename T, bool kVec, int kLanes, int kDims, int kGB>
  int run() {
    constexpr auto kernel =
        &decode_attention_kernel<T, kVec, kLanes, kDims, kGB, kPartial>;
    const size_t smem = decode_smem_bytes(kGB, kWarps, D, Dv);
    cudaError_t err = allow_smem<kernel>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int G = H / Hkv;
    const dim3 grid(Hkv, B, (G + kGB - 1) / kGB);
    kernel<<<grid, kWarps * kWarp, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const unsigned char*>(valid), static_cast<T*>(out), part, C, H,
        Hkv, D, Dv, 1.0f / sqrtf(static_cast<float>(D)), soft_cap);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T, bool kPartial>
int launch(const void* q, const void* k, const void* v, const void* valid, void* out,
           PartialOut part, int B, int H, int Hkv, int C, int D, int Dv, float soft_cap,
           void* stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  Launch<kPartial> one{q, k, v, valid, out, part, B, H, Hkv, C, D, Dv, soft_cap,
                       static_cast<cudaStream_t>(stream)};
  return decode_dispatch<T>(D, Dv, aligned(k) && aligned(v), H / Hkv, one);
}

}  // namespace

// Launch on `stream`; return cudaGetLastError() (0 when accepted).  The
// caller checks shapes: Hkv divides H, B and C >= 1, D and Dv in 1..256,
// `valid` one byte per (b, c), soft_cap 0 (none) or > 0.
extern "C" int decode_attention_f32(const void* q, const void* k, const void* v,
                                    const void* valid, void* out, int B, int H, int Hkv,
                                    int C, int D, int Dv, float soft_cap, void* stream) {
  return launch<float, false>(q, k, v, valid, out, PartialOut{}, B, H, Hkv, C, D, Dv,
                              soft_cap, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* valid, void* out, int B, int H, int Hkv,
                                     int C, int D, int Dv, float soft_cap, void* stream) {
  return launch<__nv_bfloat16, false>(q, k, v, valid, out, PartialOut{}, B, H, Hkv, C,
                                      D, Dv, soft_cap, stream);
}

// The partial instance over one share of a row's C slots: o (B,H,Dv), m
// (B,H) and l (B,H), fp32, whatever q's dtype (decode_rows.cuh).  Same
// caller checks; B and C >= 1.
extern "C" int decode_attention_partial_f32(const void* q, const void* k, const void* v,
                                            const void* valid, void* o, void* m, void* l,
                                            int B, int H, int Hkv, int C, int D, int Dv,
                                            float soft_cap, void* stream) {
  const PartialOut part{static_cast<float*>(o), static_cast<float*>(m),
                        static_cast<float*>(l)};
  return launch<float, true>(q, k, v, valid, nullptr, part, B, H, Hkv, C, D, Dv,
                             soft_cap, stream);
}

extern "C" int decode_attention_partial_bf16(const void* q, const void* k, const void* v,
                                             const void* valid, void* o, void* m,
                                             void* l, int B, int H, int Hkv, int C, int D,
                                             int Dv, float soft_cap, void* stream) {
  const PartialOut part{static_cast<float*>(o), static_cast<float*>(m),
                        static_cast<float*>(l)};
  return launch<__nv_bfloat16, true>(q, k, v, valid, nullptr, part, B, H, Hkv, C, D,
                                     Dv, soft_cap, stream);
}
