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
// (H = 4, Hkv = 1, D = 256, bf16) a row's valid keys are 1 KB of K and V
// a slot, read by four blocks, one a query head (decode_rows.cuh says
// why): at B 2 that is 8 blocks on 132 SMs, each walking its row alone.
// The partial instance at a 32,768-slot cache split over two ranks walks
// 16,384 slots a row a rank.
//
// Design: blocks of 8 warps, one per (b, kv head, group of up to kGB
// query heads, chunk), so the query heads of a kv head share every K/V
// read; the body (16-byte vector loads by 8-lane groups, U keys in flight
// a lane, masked 32-slot windows skipped by ballot, per-group online
// softmax merged by shuffles) is decode_rows.cuh's, shared with the paged
// kernel.  Here slot s of row b is cache row (b * C + s) * Hkv + kvh and
// counts iff valid[b, s].  Each block first asks whether the row has any
// valid slot (C bytes from L2, 16 a load): a row with none reads every
// slot's V and no K, and gives the uniform mean of V, as the plain
// version and the JAX kernel do.  Rows wider than 128 are spread over 16
// lanes (decode_rows.cuh).
// A row's C slots are split into S chunks (decode_rows.cuh walk_chunk),
// the grid (Hkv, B, ceil(G / kGB) * S).  The wrapper picks S from the
// shapes (decode_splits): 1 where the rows and heads fill the SMs or C is
// at most 256 (the serving rings: each of a block's 8 warps takes one
// 32-slot window), else chunks of whole windows, at least 256 slots, for
// at most two blocks an SM.  A chunk with no valid slot in a row that has
// some reads no K or V.  Split (the kSplit instance), the chunks'
// statistics go to fp32 scratch and a second kernel merges each (b, kv
// head, group)'s chunks, o / l in T, or the merged statistics for the
// partial instance: a rank's share of a split cache is itself split over
// the card, and the ranks' merge (models/sharded.py) is unchanged.

#include <cstdint>

#include "decode_rows.cuh"

namespace {

using namespace attn;

constexpr int kWarps = 8;

// slots [begin, end) of a row: cache row (b * C + s) * Hkv + kvh,
// counted iff valid
struct DenseRows {
  const unsigned char* valid;  // the row's C bytes
  size_t row0;                 // b * C
  int first, last, Hkv, kvh;
  __device__ __forceinline__ int begin() const { return first; }
  __device__ __forceinline__ int end() const { return last; }
  __device__ __forceinline__ bool counts(int s) const { return valid[s]; }
  __device__ __forceinline__ size_t row(int s) const {
    return (row0 + s) * Hkv + kvh;
  }
};

// `out`: the (B,H,Dv) output in T, or for the partial instance the
// (B,H,Dv) o and (B,H) m and l, fp32 (decode_rows.cuh DecodeOut).
// kSplit: the grid's z holds S chunks of each head group (S > 1);
// without it a block walks its whole row, as before the split existed.
template <typename T, bool kVec, int kLanes, int kDims, int kGB, bool kSplit>
__global__ void __launch_bounds__(kWarps * kWarp)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const unsigned char* __restrict__ valid,
                        DecodeOut<T> out, Split split, int C, int H, int Hkv, int D,
                        int Dv, float scale, float soft_cap) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int groups = kSplit ? gridDim.z / split.S : gridDim.z;
  const int z = kSplit ? blockIdx.z % groups : blockIdx.z;
  const int c = kSplit ? blockIdx.z / groups : 0;
  const int G = H / Hkv;
  const int h0 = kvh * G + z * kGB;  // first query head
  const int ng = min(kGB, kvh * G + G - h0);
  float* qs = smem;             // (kGB, D), pre-scaled
  float* red = qs + kGB * D;    // (kWarps, kGB, 2 + Dv)

  const size_t row0 = static_cast<size_t>(b) * C;  // cache row of slot 0
  load_query(qs, q + (static_cast<size_t>(b) * H + h0) * D, ng * D, scale);
  const bool any = block_any(valid + row0, C);  // also publishes qs
  const Chunk ch = kSplit ? walk_chunk(0, C, c, split.S) : Chunk{0, C};
  const DenseRows rows{valid + row0, row0, ch.begin, ch.end, Hkv, kvh};
  const size_t r0 = static_cast<size_t>(b) * H + h0;  // the block's first row
  // split, the block's chunk writes its statistics; merge_chunks_kernel
  // merges them into `out`
  const DecodeOut<T> to = kSplit ? DecodeOut<T>{nullptr, split.chunk(c, r0, Dv)}
                                 : out.at(r0, Dv);
  decode_rows<T, kVec, kLanes, kDims, kGB, kWarps>(k, v, to, qs, red, rows, any, ng, D,
                                                   Dv, soft_cap);
}

template <typename T>
struct Launch {
  const void *q, *k, *v, *valid;
  DecodeOut<T> out;
  Split split;
  int B, H, Hkv, C, D, Dv;
  float soft_cap;
  cudaStream_t stream;

  template <typename U, bool kVec, int kLanes, int kDims, int kGB>
  int run() {
    return split.S > 1 ? go<U, kVec, kLanes, kDims, kGB, true>()
                       : go<U, kVec, kLanes, kDims, kGB, false>();
  }

  template <typename U, bool kVec, int kLanes, int kDims, int kGB, bool kSplit>
  int go() {
    constexpr auto kernel = &decode_attention_kernel<U, kVec, kLanes, kDims, kGB, kSplit>;
    const int groups = (H / Hkv + kGB - 1) / kGB;
    const size_t smem = decode_smem_bytes(kGB, kWarps, D, Dv);
    cudaError_t err = allow_smem<kernel>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch_split<U, kGB>(
        kernel, dim3(Hkv, B, groups * split.S), kWarps * kWarp, smem, stream, out, split,
        H, Hkv, Dv, static_cast<const U*>(q), static_cast<const U*>(k),
        static_cast<const U*>(v), static_cast<const unsigned char*>(valid), out, split, C,
        H, Hkv, D, Dv, 1.0f / sqrtf(static_cast<float>(D)), soft_cap);
  }
};

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid,
           DecodeOut<T> out, void* scratch, int B, int H, int Hkv, int C, int D, int Dv,
           int S, float soft_cap, void* stream) {
  if (S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const Split split{static_cast<float*>(scratch), S, static_cast<size_t>(B) * H};
  Launch<T> one{q, k, v, valid, out, split, B, H, Hkv, C, D, Dv, soft_cap,
                static_cast<cudaStream_t>(stream)};
  return decode_dispatch<T>(D, Dv, aligned(k) && aligned(v), H / Hkv, one);
}

}  // namespace

// Launch on `stream`; return cudaGetLastError() (0 when accepted).  The
// caller checks shapes: Hkv divides H, B and C >= 1, D and Dv in 1..256,
// `valid` one byte per (b, c), soft_cap 0 (none) or > 0.  S >= 1 chunks
// a row; with S > 1 `scratch` holds S * B * H * (Dv + 2) floats
// (decode_rows.cuh Split) and a second kernel merges the chunks.
extern "C" int decode_attention_f32(const void* q, const void* k, const void* v,
                                    const void* valid, void* out, void* scratch, int B,
                                    int H, int Hkv, int C, int D, int Dv, int S,
                                    float soft_cap, void* stream) {
  return launch<float>(q, k, v, valid, DecodeOut<float>{static_cast<float*>(out), {}},
                       scratch, B, H, Hkv, C, D, Dv, S, soft_cap, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* valid, void* out, void* scratch, int B,
                                     int H, int Hkv, int C, int D, int Dv, int S,
                                     float soft_cap, void* stream) {
  return launch<__nv_bfloat16>(
      q, k, v, valid, DecodeOut<__nv_bfloat16>{static_cast<__nv_bfloat16*>(out), {}},
      scratch, B, H, Hkv, C, D, Dv, S, soft_cap, stream);
}

// The partial instance over one share of a row's C slots: o (B,H,Dv), m
// (B,H) and l (B,H), fp32, whatever q's dtype (decode_rows.cuh).  Same
// caller checks.
extern "C" int decode_attention_partial_f32(const void* q, const void* k, const void* v,
                                            const void* valid, void* o, void* m, void* l,
                                            void* scratch, int B, int H, int Hkv, int C,
                                            int D, int Dv, int S, float soft_cap,
                                            void* stream) {
  const PartialOut part{static_cast<float*>(o), static_cast<float*>(m),
                        static_cast<float*>(l)};
  return launch<float>(q, k, v, valid, DecodeOut<float>{nullptr, part}, scratch, B, H,
                       Hkv, C, D, Dv, S, soft_cap, stream);
}

extern "C" int decode_attention_partial_bf16(const void* q, const void* k, const void* v,
                                             const void* valid, void* o, void* m,
                                             void* l, void* scratch, int B, int H,
                                             int Hkv, int C, int D, int Dv, int S,
                                             float soft_cap, void* stream) {
  const PartialOut part{static_cast<float*>(o), static_cast<float*>(m),
                        static_cast<float*>(l)};
  return launch<__nv_bfloat16>(q, k, v, valid, DecodeOut<__nv_bfloat16>{nullptr, part},
                               scratch, B, H, Hkv, C, D, Dv, S, soft_cap, stream);
}
