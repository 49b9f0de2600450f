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
// mask.  A row with no such token (lengths[b] = 0) gives the uniform
// mean of V over all Pseq * ps gathered slots, as the JAX kernel does
// (every score there is -1e30, so every weight is exp(0)).
//
// What bounds it on this card: bytes.  At the serving shape (B = 32,
// H = Hkv = 32, D = 64, bf16, 57 to 64 tokens a row) one call reads
// 16 MB of K and V for 16 MFLOP: 4.8 us at the HBM rate against 0.02 us
// at the bf16 tensor-core rate.
//
// Design: the body of the dense decode kernel (decode_rows.cuh: 8-lane
// groups reading K/V rows as 16-byte vectors straight into registers, U
// keys in flight a lane, per-group online softmax merged by shuffles),
// with a paged row-addressing policy.  One block per (b, kv head, group
// of up to kGB query heads, chunk):
// - Each block reads lengths[b] and works out the row's walk: the tokens
//   that can count, from max(0, len - window) to min(len, Pseq * ps) - 1,
//   in 32-token windows from the first one's window, or every Pseq * ps
//   slot for a row with no counted token, which reads every slot's V and
//   no K.
// - The walk is split into S chunks (decode_rows.cuh walk_chunk), the
//   grid (Hkv, B, ceil(G / kGB) * S); each block takes its chunk of its
//   own row's walk, so a short row gets short or empty chunks and a row
//   of length 0 is covered too.  The wrapper picks S from the shapes
//   (decode_splits): 1 where the rows and heads fill the SMs or the table
//   holds at most 256 slots (the serving tiers' 16 pages of 16), else
//   chunks of whole windows, at least 64 tokens (a window for each warp),
//   for at most two blocks an SM.  With a window the longest walk is
//   window + 31 tokens (it starts at a window's start), so S is sized
//   from min(round_up(window, 32) + 32, Pseq * ps).  Split (the kSplit
//   instance), the chunks' statistics go to fp32 scratch and a second
//   kernel merges each (b, kv head, group)'s chunks into o / l.
// - A block loads the block-table entries of its chunk's read tokens into
//   shared memory once; a lane group then computes one row address per
//   key, not per element, so the pages may lie anywhere in the pool and
//   ids past a row's last page are never read.
// - Two warps a block.  At the served 57 to 64 tokens a row has two
//   windows, so more warps would only hold registers idle, and at the
//   serving shape (1,024 blocks) two warps keep the grid one wave.
// - A compile-time variant loads one element at a time where rows are no
//   multiple of 16 bytes or a pointer is not 16-byte aligned.
// - Rows wider than 128 (gemma3's D 256) are spread over 16 lanes
//   (decode_rows.cuh).
// fp32 arithmetic, expf and tanhf without fast math; D, Dv <= 256.

#include <cstdint>

#include "decode_rows.cuh"

namespace {

using namespace attn;

constexpr int kWarps = 2;  // warps a block

// Tokens of row b walked by a block: [first, last), 32-aligned first;
// token t counts iff lo <= t < hi, and lies at cache row
// (table[t / ps] * ps + t % ps) * Hkv + kvh.
struct PagedRows {
  const int* table;  // the row's block table, staged in shared memory
  int ps, Hkv, kvh, lo, hi, first, last;
  __device__ __forceinline__ int begin() const { return first; }
  __device__ __forceinline__ int end() const { return last; }
  __device__ __forceinline__ bool counts(int t) const { return t >= lo && t < hi; }
  __device__ __forceinline__ size_t row(int t) const {
    const int p = t / ps;
    return (static_cast<size_t>(table[p]) * ps + (t - p * ps)) * Hkv + kvh;
  }
};

// kSplit: the grid's z holds S chunks of each head group (S > 1);
// without it a block walks its row's whole walk.
template <typename T, bool kVec, int kLanes, int kDims, int kGB, bool kSplit>
__global__ void __launch_bounds__(kWarps * kWarp)
paged_decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                              const T* __restrict__ v_pages,
                              const int* __restrict__ block_tables,
                              const int* __restrict__ lengths, T* __restrict__ out,
                              Split split, int H, int Hkv, int ps, int Pseq, int D,
                              int Dv, float scale, float soft_cap, int window) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int groups = kSplit ? gridDim.z / split.S : gridDim.z;
  const int z = kSplit ? blockIdx.z % groups : blockIdx.z;
  const int c = kSplit ? blockIdx.z / groups : 0;
  const int G = H / Hkv;
  const int h0 = kvh * G + z * kGB;  // first query head
  const int ng = min(kGB, kvh * G + G - h0);
  float* qs = smem;                                           // (kGB, D)
  float* red = qs + kGB * D;                                  // (kWarps, kGB, 2 + Dv)
  int* table = reinterpret_cast<int*>(red + kWarps * kGB * (2 + Dv));  // (Pseq,)

  const int len = lengths[b];
  const int slots = Pseq * ps;
  const int hi = min(len, slots);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const bool any = lo < hi;
  const int first = any ? lo & ~(kWarp - 1) : 0, last = any ? hi : slots;
  const Chunk ch = kSplit ? walk_chunk(first, last, c, split.S) : Chunk{first, last};
  // the table entries the chunk reads: its counted tokens' pages, or
  // every page of its tokens in a row with none counted
  const int t0 = any ? max(lo, ch.begin) : ch.begin;
  if (t0 < ch.end) {
    const int* bt = block_tables + static_cast<size_t>(b) * Pseq;
    for (int p = t0 / ps + threadIdx.x; p <= (ch.end - 1) / ps; p += blockDim.x)
      table[p] = bt[p];
  }
  load_query(qs, q + (static_cast<size_t>(b) * H + h0) * D, ng * D, scale);
  __syncthreads();
  const PagedRows rows{table, ps, Hkv, kvh, lo, hi, ch.begin, ch.end};
  const size_t r0 = static_cast<size_t>(b) * H + h0;  // the block's first row
  // split, the block's chunk writes its statistics; merge_chunks_kernel
  // merges them into `out`
  const DecodeOut<T> to = kSplit ? DecodeOut<T>{nullptr, split.chunk(c, r0, Dv)}
                                 : DecodeOut<T>{out + r0 * Dv, {}};
  decode_rows<T, kVec, kLanes, kDims, kGB, kWarps>(k_pages, v_pages, to, qs, red, rows,
                                                   any, ng, D, Dv, soft_cap);
}

struct Launch {
  const void *q, *k_pages, *v_pages, *block_tables, *lengths;
  void* out;
  Split split;
  int B, H, Hkv, ps, Pseq, D, Dv;
  float soft_cap;
  int window;
  cudaStream_t stream;

  template <typename T, bool kVec, int kLanes, int kDims, int kGB>
  int run() {
    return split.S > 1 ? go<T, kVec, kLanes, kDims, kGB, true>()
                       : go<T, kVec, kLanes, kDims, kGB, false>();
  }

  template <typename T, bool kVec, int kLanes, int kDims, int kGB, bool kSplit>
  int go() {
    constexpr auto kernel =
        &paged_decode_attention_kernel<T, kVec, kLanes, kDims, kGB, kSplit>;
    const int groups = (H / Hkv + kGB - 1) / kGB;
    const size_t smem = decode_smem_bytes(kGB, kWarps, D, Dv) + sizeof(int) * Pseq;
    cudaError_t err = allow_smem<kernel>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch_split<T, kGB>(
        kernel, dim3(Hkv, B, groups * split.S), kWarps * kWarp, smem, stream,
        DecodeOut<T>{static_cast<T*>(out), {}}, split, H, Hkv, Dv,
        static_cast<const T*>(q), static_cast<const T*>(k_pages),
        static_cast<const T*>(v_pages), static_cast<const int*>(block_tables),
        static_cast<const int*>(lengths), static_cast<T*>(out), split, H, Hkv, ps, Pseq,
        D, Dv, 1.0f / sqrtf(static_cast<float>(D)), soft_cap, window);
  }
};

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* block_tables, const void* lengths, void* out, void* scratch, int B,
           int H, int Hkv, int ps, int Pseq, int D, int Dv, int S, float soft_cap,
           int window, void* stream) {
  if (S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const Split split{static_cast<float*>(scratch), S, static_cast<size_t>(B) * H};
  Launch one{q, k_pages, v_pages, block_tables, lengths, out, split, B, H, Hkv, ps, Pseq,
             D, Dv, soft_cap, window, static_cast<cudaStream_t>(stream)};
  return decode_dispatch<T>(D, Dv, aligned(k_pages) && aligned(v_pages), H / Hkv, one);
}

}  // namespace

// Launch on `stream`; return cudaGetLastError() (0 when accepted).  The
// caller checks shapes: Hkv divides H, B >= 1, D and Dv in 1..256,
// window 0 (none) or >= 1, soft_cap 0 (none) or > 0; every page id of a row's first
// ceil(lengths[b] / ps) table entries (of every entry where lengths[b]
// is 0) lies in the pool.  S >= 1 chunks a row's walk; with S > 1
// `scratch` holds S * B * H * (Dv + 2) floats (decode_rows.cuh Split) and
// a second kernel merges the chunks.
extern "C" int paged_decode_attention_f32(const void* q, const void* k_pages,
                                          const void* v_pages, const void* block_tables,
                                          const void* lengths, void* out, void* scratch,
                                          int B, int H, int Hkv, int ps, int Pseq, int D,
                                          int Dv, int S, float soft_cap, int window,
                                          void* stream) {
  return launch<float>(q, k_pages, v_pages, block_tables, lengths, out, scratch, B, H,
                       Hkv, ps, Pseq, D, Dv, S, soft_cap, window, stream);
}

extern "C" int paged_decode_attention_bf16(const void* q, const void* k_pages,
                                           const void* v_pages, const void* block_tables,
                                           const void* lengths, void* out, void* scratch,
                                           int B, int H, int Hkv, int ps, int Pseq, int D,
                                           int Dv, int S, float soft_cap, int window,
                                           void* stream) {
  return launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables, lengths, out, scratch,
                               B, H, Hkv, ps, Pseq, D, Dv, S, soft_cap, window, stream);
}
