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
// t < lengths[b].  A row with lengths[b] = 0 gives the uniform mean of
// the c_kv latents over all Pseq * ps gathered slots, as the JAX kernel
// does (every score there is -1e30, so every weight is exp(0)).
//
// What bounds it on this card: bytes.  At the paged cloud tier's decode
// shape (B = 32, H = 16, R = 512, Dr = 64, ps = 16, bf16, 57 to 64 tokens
// a row) it moves up to 3.5 MB (2.4 MB of latents, 1.1 MB of queries and
// output) and does up to 71 MFLOP: 1.0 us at the HBM rate, against 0.07
// us at the bf16 tensor-core rate but 1.06 us at the fp32 CUDA-core rate,
// so only the tensor cores leave the bytes as the bound.
//
// Two kernels:
// - paged_mla_decode_mma_kernel (bf16 whose R and Dr are multiples of 16,
//   R + Dr <= 640, 16-byte aligned pages): the tensor-core design.
//   * A block takes 16 query heads of one row: exactly the M of
//     mma.sync.m16n8k16 (wgmma needs 64 rows).  A row's tokens go in
//     16-token chunks through a ring of 4 stages of shared memory (3
//     chunks in flight), as bf16 [c_kv | k_rope] rows padded by 16 bytes
//     (conflict-free ldmatrix), filled by cp.async a row per warp.  The
//     block reads the row's length first, and copies its query rows
//     while it stages the table entries of its tokens.
//   * Scores: 8 warps, warp w takes 8 tokens (w & 1) and a quarter of the
//     R + Dr k-steps (w >> 1), both operands read by ldmatrix; the query
//     rows are copied to shared memory once, while the block reads the
//     row's length and table.  The four partial products meet in shared
//     memory.
//   * Softmax: every warp reads the chunk's 16 x 16 scores and keeps the
//     same online-softmax state; the weights P go to bf16 A fragments in
//     registers.
//   * Context P (16 x 16 tokens) . c_kv (16 x R): warp w owns the 16-column
//     pairs w, w + 8, ... of R (4 at R = 512), read by ldmatrix.trans.
//   * Split: 32 rows make only 32 blocks on an H100's 132 SMs, and a
//     block's chunks run one after another (about 2 us each), so a row's
//     chunks are split over a thread-block cluster of up to 4 blocks, as
//     many as keep the grid within half the card's SMs (measured at the
//     served 57 to 64 tokens: 4 fastest at B 1 and 4, 2 at B 32); each
//     keeps its partial (max, sum, context) in its own shared memory,
//     and after a cluster barrier block r merges a quarter of the
//     outputs, 4 columns a thread, reading the others' partials through
//     distributed shared memory.  One launch, no scratch in device
//     memory, no atomics.
// - paged_mla_decode_simple_kernel (fp32, and bf16 rows the first does
//   not take): CUDA-core arithmetic, which holds fp32 to 3e-5 (TF32 would
//   not).  One block per (row, 16 heads), one warp a head, the tokens'
//   rows staged 16 at a time as fp32 in shared memory, lane (half, j)
//   scoring token j on every other dim; the R-wide context in registers.
// Only the tokens of a row's first ceil(lengths[b] / 16) chunks are
// visited (every gathered slot where lengths[b] is 0), and only the table
// entries of those tokens are read.  expf without fast math.

#include <cooperative_groups.h>

#include <cstdint>

#include "attention_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace attn;

constexpr int kMaxRank = 512;  // latent width R

// ---------------------------------------------------------------------------
// CUDA-core kernel
// ---------------------------------------------------------------------------

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
paged_mla_decode_simple_kernel(const T* __restrict__ q_c, const T* __restrict__ q_rope,
                               const T* __restrict__ ckv_pages,
                               const T* __restrict__ krope_pages,
                               const int* __restrict__ block_tables,
                               const int* __restrict__ lengths, T* __restrict__ out,
                               int H, int R, int Dr, int ps, int Pseq, float scale) {
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

  // a row with no counted token walks every slot, all scores -1e30
  const int hi = min(lengths[b], Pseq * ps);
  const bool any = hi > 0;
  const int n_tok = any ? hi : Pseq * ps;
  const int* table = block_tables + static_cast<size_t>(b) * Pseq;
  for (int c0 = 0; c0 < n_tok; c0 += kTokens) {
    __syncthreads();  // the query rows are written, the last chunk is used
    for (int i = threadIdx.x; i < kTokens * W; i += blockDim.x) {
      const int jj = i / W, d = i - jj * W;
      const int t = c0 + jj;
      float v = 0.0f;  // tokens past the walk: zeros, not garbage
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
    // a token past the walk weighs nothing even in a row with none counted
    s = c0 + j < n_tok ? (any ? s : kNegInf) : -INFINITY;
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
int launch_simple(const void* q_c, const void* q_rope, const void* ckv_pages,
                  const void* krope_pages, const void* block_tables, const void* lengths,
                  void* out, int B, int H, int R, int Dr, int ps, int Pseq, float scale,
                  cudaStream_t stream) {
  const int warps = H < kMaxHeads ? H : kMaxHeads;
  const int W = R + Dr;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(warps) * W + kTokens * token_stride(W));
  cudaError_t err = allow_smem<&paged_mla_decode_simple_kernel<T>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, (H + kMaxHeads - 1) / kMaxHeads);
  paged_mla_decode_simple_kernel<T><<<grid, warps * kWarp, smem, stream>>>(
      static_cast<const T*>(q_c), static_cast<const T*>(q_rope),
      static_cast<const T*>(ckv_pages), static_cast<const T*>(krope_pages),
      static_cast<const int*>(block_tables), static_cast<const int*>(lengths),
      static_cast<T*>(out), H, R, Dr, ps, Pseq, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Tensor-core kernel (bf16)
// ---------------------------------------------------------------------------

constexpr int kM = 16;           // query heads a block: the M of m16n8k16
constexpr int kChunk = 16;       // tokens a chunk: one k-step of P.V
constexpr int kMmaWarps = 8;
constexpr int kStages = 4;       // chunks in shared memory (3 in flight)
constexpr int kMaxSplit = 4;     // blocks a row's chunks are split over
constexpr int kMmaMaxWidth = 640;                          // R + Dr
constexpr int kPairs = kMaxRank / 16 / kMmaWarps;          // 16-column pairs a warp owns
constexpr int kSpStride = kChunk;                          // floats a partial-score row

// bytes of one staged token row: 2 (R + Dr), padded by 16 so 8 rows read
// by one ldmatrix fall in 8 different 16-byte bank groups
__host__ __device__ inline int mma_row_bytes(int W) { return 2 * W + 16; }

inline size_t mma_smem_bytes(int W, int Pseq) {
  return static_cast<size_t>(kM + kStages * kChunk) * mma_row_bytes(W) +
         sizeof(float) * 4 * kM * kSpStride + sizeof(int) * Pseq;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when `bytes` is 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kN>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kN));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo
  return *reinterpret_cast<const unsigned*>(&v);
}

__global__ void __launch_bounds__(kMmaWarps * kWarp)
paged_mla_decode_mma_kernel(const __nv_bfloat16* __restrict__ q_c,
                            const __nv_bfloat16* __restrict__ q_rope,
                            const __nv_bfloat16* __restrict__ ckv_pages,
                            const __nv_bfloat16* __restrict__ krope_pages,
                            const int* __restrict__ block_tables,
                            const int* __restrict__ lengths,
                            __nv_bfloat16* __restrict__ out, int H, int R, int Dr,
                            int ps, int Pseq, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = R + Dr;
  const int row_bytes = mma_row_bytes(W);
  const int stage_bytes = kChunk * row_bytes;
  unsigned char* qs = smem_raw;                    // (16, row_bytes): [q_c | q_rope]
  unsigned char* stages = qs + kM * row_bytes;     // kStages chunks of 16 tokens
  float* sp = reinterpret_cast<float*>(stages + kStages * stage_bytes);  // (4, 16, 16)
  int* table = reinterpret_cast<int*>(sp + 4 * kM * kSpStride);            // (Pseq,)

  const int split = gridDim.x, rank = blockIdx.x;  // the cluster is the grid's x
  const int b = blockIdx.y, h0 = blockIdx.z * kM;
  const int nh = min(kM, H - h0);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int gid = lane / 4, tig = lane % 4;
  const int nt = warp & 1, kq = warp >> 1;  // score tile: 8 tokens, k-steps kq + 4i
  const int ksteps = W / 16;
  const int len = lengths[b];

  // Copies go a row per warp, 16 bytes a lane: a row of width W, `head`
  // (R wide) then `tail` (Dr wide), into the shared row `dst`,
  // zero-filled when `have` is false.
  const int pieces = W / 8, rpieces = R / 8;
  auto copy_row = [&](unsigned char* dst, const __nv_bfloat16* head,
                      const __nv_bfloat16* tail, bool have) {
    for (int pc = lane; pc < pieces; pc += kWarp) {
      const void* src = pc < rpieces ? static_cast<const void*>(head + pc * 8)
                                     : static_cast<const void*>(tail + (pc - rpieces) * 8);
      cp_async16(dst + pc * 16, have ? src : ckv_pages, have ? 16 : 0);
    }
  };
  // the block's query rows, in flight while the length and the table
  // are read (they join the first chunk's copy group); rows past the
  // block's heads are zeros
  for (int r = warp; r < kM; r += kMmaWarps) {
    const size_t row = static_cast<size_t>(b) * H + h0 + r;
    copy_row(qs + r * row_bytes, q_c + row * R, q_rope + row * Dr, r < nh);
  }

  // the walk: a counted row's tokens [0, hi), else every slot; this
  // block's share is chunks [c0, c1)
  const int slots = Pseq * ps;
  const int hi = min(len, slots);
  const bool any = hi > 0;
  const int walk = any ? hi : slots;
  const int chunks = (walk + kChunk - 1) / kChunk;
  const int per = (chunks + split - 1) / split;
  const int c0 = min(rank * per, chunks), c1 = min(c0 + per, chunks);
  const int mine = c1 - c0;
  const int t0 = c0 * kChunk, t1 = min(c1 * kChunk, walk);
  const int* bt = block_tables + static_cast<size_t>(b) * Pseq;
  if (t0 < t1)
    for (int p = t0 / ps + threadIdx.x; p <= (t1 - 1) / ps; p += blockDim.x)
      table[p] = bt[p];
  __syncthreads();

  // chunk c (of this block's) into stage s: 16 tokens x W/8 pieces of 16
  // bytes; tokens past the walk are zero-filled (a 0 * garbage would be
  // NaN)
  auto issue = [&](int c, int s) {
    unsigned char* dst = stages + s * stage_bytes;
    for (int tk = warp; tk < kChunk; tk += kMmaWarps) {
      const int t = (c0 + c) * kChunk + tk;
      size_t slot = 0;
      if (t < walk) {
        const int pg = t / ps;
        slot = static_cast<size_t>(table[pg]) * ps + (t - pg * ps);
      }
      copy_row(dst + tk * row_bytes, ckv_pages + slot * R, krope_pages + slot * Dr, t < walk);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < mine) issue(s, s);
    cp_async_commit();
  }

  // online-softmax state of rows gid and gid + 8 (the same in every
  // warp), l a per-lane partial; the context of this warp's column pairs
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[kPairs][2][4];
#pragma unroll
  for (int i = 0; i < kPairs; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][h][e] = 0.0f;

  for (int c = 0; c < mine; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c landed for every thread; chunk c - 1 is used
    if (c + kStages - 1 < mine) issue(c + kStages - 1, (c + kStages - 1) % kStages);
    cp_async_commit();
    const unsigned char* st = stages + (c % kStages) * stage_bytes;

    // partial scores of 8 tokens over this warp's k-steps
    {
      float sa[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
      const unsigned char* qrow = qs + (lane & 15) * row_bytes + (lane >> 4) * 16;
      const unsigned char* krow = st + (8 * nt + (lane & 7)) * row_bytes + ((lane >> 3) & 1) * 16;
      // two accumulators, so that consecutive products do not wait on
      // each other
      for (int ks = kq; ks < ksteps; ks += 8) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (ks + 4 * i < ksteps) {
            unsigned qa[4], kb[2];
            ldmatrix_x4(qa, qrow + (ks + 4 * i) * 32);
            ldmatrix_x2(kb, krow + (ks + 4 * i) * 32);
            mma_bf16(sa[i], qa, kb[0], kb[1]);
          }
        }
      }
      float* o = sp + kq * kM * kSpStride;
      const int col = 8 * nt + 2 * tig;
      *reinterpret_cast<float2*>(o + gid * kSpStride + col) =
          make_float2(sa[0][0] + sa[1][0], sa[0][1] + sa[1][1]);
      *reinterpret_cast<float2*>(o + (gid + 8) * kSpStride + col) =
          make_float2(sa[0][2] + sa[1][2], sa[0][3] + sa[1][3]);
    }
    __syncthreads();

    // scores of rows gid, gid + 8 at tokens 2 tig + {0, 1, 8, 9}
    const int tbase = (c0 + c) * kChunk;
    float s[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 2 * tig + (e & 1) + (e >> 1) * 8;
        const float* pr = sp + (gid + 8 * h) * kSpStride + col;
        const float v = ((pr[0] + pr[kM * kSpStride]) + pr[2 * kM * kSpStride]) +
                        pr[3 * kM * kSpStride];
        // a token past the walk weighs nothing even in a row with none counted
        s[h][e] = tbase + col < walk ? (any ? v * scale : kNegInf) : -INFINITY;
      }
    unsigned pa[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = fmaxf(fmaxf(s[h][0], s[h][1]), fmaxf(s[h][2], s[h][3]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float alpha = expf(m[h] - m_new);
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = expf(s[h][e] - m_new);
      l[h] = l[h] * alpha + ((p[0] + p[1]) + (p[2] + p[3]));
      m[h] = m_new;
#pragma unroll
      for (int i = 0; i < kPairs; ++i)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          acc[i][n][2 * h] *= alpha;
          acc[i][n][2 * h + 1] *= alpha;
        }
      pa[h] = pack_bf16(p[0], p[1]);      // tokens 2 tig, 2 tig + 1
      pa[h + 2] = pack_bf16(p[2], p[3]);  // tokens 2 tig + 8, + 9
    }

    // context: this warp's 16-column pairs
    const unsigned char* vrow = st + (lane & 15) * row_bytes + (lane >> 4) * 16;
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int pair = warp + kMmaWarps * i;
      if (16 * pair < R) {
        unsigned vb[4];
        ldmatrix_x4_trans(vb, vrow + pair * 32);
        mma_bf16(acc[i][0], pa, vb[0], vb[1]);
        mma_bf16(acc[i][1], pa, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
  }
  __nv_bfloat16* o = out + (static_cast<size_t>(b) * H + h0) * R;
  if (split == 1) {
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int pair = warp + kMmaWarps * i;
      if (16 * pair >= R) continue;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = 16 * pair + 8 * n + 2 * tig;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = gid + 8 * h;
          if (row >= nh) continue;
          const float inv = 1.0f / fmaxf(l[h], 1e-30f);
          *reinterpret_cast<__nv_bfloat162*>(o + static_cast<size_t>(row) * R + col) =
              __floats2bfloat162_rn(acc[i][n][2 * h] * inv, acc[i][n][2 * h + 1] * inv);
        }
      }
    }
    return;
  }

  // split: publish this block's partial (m, l, context) in its shared
  // memory, then each block of the cluster merges its share of outputs
  cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();  // every warp is done with the stages
  float* part = reinterpret_cast<float*>(stages);  // m (16), l (16), ctx (16, R)
  if (warp == 0 && tig == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      part[gid + 8 * h] = m[h];
      part[kM + gid + 8 * h] = l[h];
    }
  }
  float* ctx = part + 2 * kM;
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int pair = warp + kMmaWarps * i;
    if (16 * pair >= R) continue;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int col = 16 * pair + 8 * n + 2 * tig;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(ctx + (gid + 8 * h) * R + col) =
            make_float2(acc[i][n][2 * h], acc[i][n][2 * h + 1]);
    }
  }
  cluster.sync();
  const float* parts[kMaxSplit];
#pragma unroll
  for (int r = 0; r < kMaxSplit; ++r)
    parts[r] = cluster.map_shared_rank(part, r < split ? r : 0);
  // each partial's weight in a row, exp(m_r - max) / sum, once per row
  float* weight = sp;  // (kMaxSplit, 16)
  if (threadIdx.x < kM) {
    const int row = threadIdx.x;
    float mx = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r)
      if (r < split) mx = fmaxf(mx, parts[r][row]);
    float f[kMaxSplit], lsum = 0.0f;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      f[r] = r < split ? expf(parts[r][row] - mx) : 0.0f;
      if (r < split) lsum = fmaf(parts[r][kM + row], f[r], lsum);
    }
    const float inv = 1.0f / fmaxf(lsum, 1e-30f);
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) weight[r * kM + row] = f[r] * inv;
  }
  __syncthreads();
  // this block's share of the outputs, 4 columns at a time
  const int quads = R / 4;
  for (int i = rank * blockDim.x + threadIdx.x; i < nh * quads; i += split * blockDim.x) {
    const int row = i / quads, col = 4 * (i - row * quads);
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r)
      if (r < split) {
        const float w = weight[r * kM + row];
        const float4 v = *reinterpret_cast<const float4*>(parts[r] + 2 * kM + row * R + col);
        sum.x = fmaf(v.x, w, sum.x);
        sum.y = fmaf(v.y, w, sum.y);
        sum.z = fmaf(v.z, w, sum.z);
        sum.w = fmaf(v.w, w, sum.w);
      }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(sum.x, sum.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(sum.z, sum.w);
    uint2 packed;
    packed.x = *reinterpret_cast<const unsigned*>(&lo);
    packed.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(o + static_cast<size_t>(row) * R + col) = packed;
  }
  cluster.sync();  // no block leaves while the others read its partial
}

int launch_mma(const void* q_c, const void* q_rope, const void* ckv_pages,
               const void* krope_pages, const void* block_tables, const void* lengths,
               void* out, int B, int H, int R, int Dr, int ps, int Pseq, float scale,
               cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(R + Dr, Pseq);
  cudaError_t err = allow_smem<&paged_mla_decode_mma_kernel>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (H + kM - 1) / kM;
  // up to 4 blocks a row while the grid stays within half the SMs, and
  // no more than a full table has chunks
  const long long blocks = static_cast<long long>(B) * groups;
  const int chunks = (Pseq * ps + kChunk - 1) / kChunk;
  int split = kMaxSplit;
  while (split > 1 && (2 * blocks * split > multiprocessors() || split > chunks)) split /= 2;
  const dim3 grid(split, B, groups);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kMmaWarps * kWarp);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, paged_mla_decode_mma_kernel,
                           static_cast<const __nv_bfloat16*>(q_c),
                           static_cast<const __nv_bfloat16*>(q_rope),
                           static_cast<const __nv_bfloat16*>(ckv_pages),
                           static_cast<const __nv_bfloat16*>(krope_pages),
                           static_cast<const int*>(block_tables),
                           static_cast<const int*>(lengths),
                           static_cast<__nv_bfloat16*>(out), H, R, Dr, ps, Pseq, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bool mma_takes(const void* q_c, const void* q_rope, const void* ckv_pages,
               const void* krope_pages, void* out, int R, int Dr) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return R % 16 == 0 && Dr % 16 == 0 && R + Dr <= kMmaMaxWidth && aligned(q_c) &&
         aligned(q_rope) && aligned(ckv_pages) && aligned(krope_pages) && aligned(out);
}

}  // namespace

// Launch on `stream`; return cudaGetLastError() (0 when accepted).  The
// caller checks shapes: B, H >= 1, R in 1..512, Dr >= 0, R + Dr <= 1024;
// every page id of a row's first ceil(lengths[b] / ps) table
// entries (of every entry where lengths[b] is 0) lies in the pool.
extern "C" int paged_mla_decode_attention_f32(const void* q_c, const void* q_rope,
                                              const void* ckv_pages,
                                              const void* krope_pages,
                                              const void* block_tables,
                                              const void* lengths, void* out, int B,
                                              int H, int R, int Dr, int ps, int Pseq,
                                              float scale, void* stream) {
  return launch_simple<float>(q_c, q_rope, ckv_pages, krope_pages, block_tables, lengths,
                              out, B, H, R, Dr, ps, Pseq, scale,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int paged_mla_decode_attention_bf16(const void* q_c, const void* q_rope,
                                               const void* ckv_pages,
                                               const void* krope_pages,
                                               const void* block_tables,
                                               const void* lengths, void* out, int B,
                                               int H, int R, int Dr, int ps, int Pseq,
                                               float scale, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (mma_takes(q_c, q_rope, ckv_pages, krope_pages, out, R, Dr))
    return launch_mma(q_c, q_rope, ckv_pages, krope_pages, block_tables, lengths, out, B,
                      H, R, Dr, ps, Pseq, scale, s);
  return launch_simple<__nv_bfloat16>(q_c, q_rope, ckv_pages, krope_pages, block_tables,
                                      lengths, out, B, H, R, Dr, ps, Pseq, scale, s);
}
