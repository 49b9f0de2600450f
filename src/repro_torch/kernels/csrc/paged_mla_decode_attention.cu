// paged_mla_decode_attention: absorbed multi-head latent attention (MLA,
// DeepSeek-V2) of one query token per sequence against a paged latent
// cache read through per-sequence block tables, written for NVIDIA Hopper
// (sm_90a).  The paged serving engine's decode step runs it once per
// layer of an MLA model.
//
// Replaces the TPU kernel src/repro/kernels/paged_decode_attention.py:
// paged_mla_decode_attention (its pallas_call is at
// paged_decode_attention.py:199).  Same function: q_c (B,H,R) queries
// already projected into latent space, q_rope (B,H,Dr), ckv_pages
// (P, ps, R), krope_pages (P, ps, Dr), block_tables (B, Pseq) int32,
// lengths (B,) int32 -> the latent context (B,H,R) in q_c's dtype (the
// caller applies w_uv).  The score of token t is
// (q_c . c_kv[t] + q_rope . k_rope[t]) * scale, with `scale` passed in
// (the full 1/sqrt(nope + rope), not 1/sqrt(R)); token t of row b lies at
// page block_tables[b, t / ps], slot t % ps, and counts iff
// t < lengths[b].  A row with lengths[b] = 0 gives zeros (the TPU kernel
// and the plain version then average every gathered latent; the serving
// path always passes pos + 1 >= 1).
//
// What bounds it on this card: bytes.  At the paged cloud tier's decode
// shape (B = 32, H = 16, R = 512, Dr = 64, ps = 16, bf16, 57 to 64 tokens
// a row) it moves up to 3.4 MB (2.4 MB of latents, the queries and the
// output) and does up to 71 MFLOP: 1.0 us at the HBM rate against 0.07 us
// at the bf16 tensor-core rate.
//
// Design (simple and right first): one block per (row b, group of up to 16
// query heads), one warp per head, so all of a row's heads share every
// latent the block stages and each page is read once per row.  The block
// stages the heads' query rows [q_c | q_rope] once and then, 16 tokens at
// a time, the tokens' [c_kv | k_rope] rows, gathered through the block
// table, as fp32 in shared memory (74 KB at 16 heads, R = 512, Dr = 64).
// A warp scores the 16 tokens with lane (half, j) taking token j and every
// other dim from `half`, joined by one shuffle; rows of stride
// 2 (mod 32) floats keep those reads free of bank conflicts.  The fold is
// an online softmax in fp32 with the R-wide value in registers: lane i
// holds dims i, i + 32, ... (16 a lane at R = 512), wider than the GQA
// kernels' fold_chunk takes.  Only a row's first ceil(lengths[b] / 16)
// token chunks are visited, and only table entries of tokens below
// lengths[b] are read.  expf without fast math.

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int kMaxRank = 512;                  // latent width R
constexpr int kRankChunks = kMaxRank / kWarp;  // value dims a lane holds
constexpr int kMaxHeads = 16;                  // query heads (warps) a block
constexpr int kTokens = kWarp / 2;             // tokens staged per chunk

// Row stride of a staged token: at least R + Dr floats and 2 (mod 32), so
// lane (half, j) reading dim 2i + half of token j hits bank 2j + half + 2i.
inline __host__ __device__ int token_stride(int W) {
  return (W + kWarp - 1) / kWarp * kWarp + 2;
}

template <typename T>
__global__ void __launch_bounds__(kMaxHeads * kWarp)
paged_mla_decode_kernel(const T* __restrict__ q_c, const T* __restrict__ q_rope,
                        const T* __restrict__ ckv_pages,
                        const T* __restrict__ krope_pages,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ lengths, T* __restrict__ out, int H,
                        int R, int Dr, int ps, int Pseq, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int h0 = blockIdx.y * kMaxHeads;
  const int nh = min(kMaxHeads, H - h0);
  const int warps = blockDim.x / kWarp;
  const int W = R + Dr;
  const int stride = token_stride(W);
  float* qs = smem;               // (warps, W): [q_c | q_rope] of each head
  float* ks = qs + warps * W;     // (kTokens, stride): [c_kv | k_rope]
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int j = lane % kTokens, half = lane / kTokens;
  const bool active = warp < nh;  // uniform across the warp

  for (int i = threadIdx.x; i < nh * W; i += blockDim.x) {
    const int g = i / W, d = i - g * W;
    const size_t row = static_cast<size_t>(b) * H + h0 + g;
    qs[i] = d < R ? to_float(q_c[row * R + d]) : to_float(q_rope[row * Dr + d - R]);
  }

  float m = kNegInf, l = 0.0f, acc[kRankChunks];
#pragma unroll
  for (int c = 0; c < kRankChunks; ++c) acc[c] = 0.0f;

  const int n_tok = min(lengths[b], Pseq * ps);
  const int* table = block_tables + static_cast<size_t>(b) * Pseq;
  for (int c0 = 0; c0 < n_tok; c0 += kTokens) {
    __syncthreads();  // the query rows are written, the last chunk is used
    for (int i = threadIdx.x; i < kTokens * W; i += blockDim.x) {
      const int jj = i / W, d = i - jj * W;
      const int t = c0 + jj;
      float v = 0.0f;  // tokens past the row: zeros, not garbage
      if (t < n_tok) {
        const size_t slot = static_cast<size_t>(table[t / ps]) * ps + t % ps;
        v = d < R ? to_float(ckv_pages[slot * R + d])
                  : to_float(krope_pages[slot * Dr + d - R]);
      }
      ks[jj * stride + d] = v;
    }
    __syncthreads();
    if (!active) continue;
    const float* qrow = qs + warp * W;
    const float* kr = ks + j * stride;
    float s = 0.0f;
    for (int d = half; d < W; d += 2) s = fmaf(qrow[d], kr[d], s);
    s += __shfl_xor_sync(kFull, s, kTokens);
    s *= scale;
    s = c0 + j < n_tok ? s : kNegInf;
    const float m_new = fmaxf(m, warp_max(s));
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);
    // both halves hold every token's weight: count each once
    l = l * alpha + warp_sum(half == 0 ? p : 0.0f);
#pragma unroll
    for (int c = 0; c < kRankChunks; ++c) acc[c] *= alpha;
    for (int jj = 0; jj < kTokens; ++jj) {
      const float pj = __shfl_sync(kFull, p, jj);
      const float* vr = ks + jj * stride;
#pragma unroll
      for (int c = 0; c < kRankChunks; ++c) {
        const int d = lane + c * kWarp;
        if (d < R) acc[c] = fmaf(pj, vr[d], acc[c]);
      }
    }
    m = m_new;
  }

  if (!active) return;
  const float inv = 1.0f / fmaxf(l, 1e-30f);
  T* o = out + (static_cast<size_t>(b) * H + h0 + warp) * R;
#pragma unroll
  for (int c = 0; c < kRankChunks; ++c) {
    const int d = lane + c * kWarp;
    if (d < R) o[d] = from_float<T>(acc[c] * inv);
  }
}

template <typename T>
int launch(const void* q_c, const void* q_rope, const void* ckv_pages,
           const void* krope_pages, const void* block_tables, const void* lengths,
           void* out, int B, int H, int R, int Dr, int ps, int Pseq, float scale,
           void* stream) {
  const int warps = H < kMaxHeads ? H : kMaxHeads;
  const int W = R + Dr;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(warps) * W + kTokens * token_stride(W));
  cudaError_t err = allow_smem<&paged_mla_decode_kernel<T>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, (H + kMaxHeads - 1) / kMaxHeads);
  paged_mla_decode_kernel<T><<<grid, warps * kWarp, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q_c), static_cast<const T*>(q_rope),
      static_cast<const T*>(ckv_pages), static_cast<const T*>(krope_pages),
      static_cast<const int*>(block_tables), static_cast<const int*>(lengths),
      static_cast<T*>(out), H, R, Dr, ps, Pseq, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; return cudaGetLastError() (0 when accepted).  The
// caller checks shapes: B, H >= 1, R in 1..512, Dr >= 0, R + Dr <= 1024;
// every page id of a row's first ceil(lengths[b] / ps) table entries lies
// in the pool.
extern "C" int paged_mla_decode_attention_f32(const void* q_c, const void* q_rope,
                                              const void* ckv_pages,
                                              const void* krope_pages,
                                              const void* block_tables,
                                              const void* lengths, void* out, int B,
                                              int H, int R, int Dr, int ps, int Pseq,
                                              float scale, void* stream) {
  return launch<float>(q_c, q_rope, ckv_pages, krope_pages, block_tables, lengths,
                       out, B, H, R, Dr, ps, Pseq, scale, stream);
}

extern "C" int paged_mla_decode_attention_bf16(const void* q_c, const void* q_rope,
                                               const void* ckv_pages,
                                               const void* krope_pages,
                                               const void* block_tables,
                                               const void* lengths, void* out, int B,
                                               int H, int R, int Dr, int ps, int Pseq,
                                               float scale, void* stream) {
  return launch<__nv_bfloat16>(q_c, q_rope, ckv_pages, krope_pages, block_tables,
                               lengths, out, B, H, R, Dr, ps, Pseq, scale, stream);
}
