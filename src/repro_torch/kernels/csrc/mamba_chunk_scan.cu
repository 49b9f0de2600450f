// mamba_chunk_scan: the chunked Mamba2 SSD scan (state space duality),
// written for NVIDIA Hopper (sm_90a).  Every Mamba2 layer of zamba2's
// full-sequence forward runs it once.
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan.py:mamba_chunk_scan
// (its pallas_call is at mamba_scan.py:83).  Same function: x (B,L,H,P),
// dt (B,L,H) after softplus, A (H,) negative, Bm and Cm (B,L,N) (ngroups
// 1), chunk Q dividing L -> y (B,L,H,P) in x's dtype and the final state
// (B,H,N,P) in fp32.  Per chunk and head, with u = x * dt:
//   y[i] = sum_{j<=i} (C_i . B_j) exp(seg(j, i]) u_j  +  exp(seg(-1, i]) C_i . S
//   S   <- exp(seg(-1, Q-1]) S + sum_j exp(seg(j, Q-1]) B_j (x) u_j
// where seg(j, i] is the sum of dt * A over tokens j+1..i and S starts at
// zero.  The decays are formed for j <= i only (where they are <= 1; the
// TPU kernel forms them for every pair and masks after, and for j > i they
// can overflow), and from segment sums, never as a difference of two
// prefix sums: in a 128-token chunk of zamba2 those reach several hundred,
// and their difference loses ~1e-5 of each decay.  Every dt * A has one
// sign, so a segment sum split in two parts (each summed from the split
// point outward) keeps its rounding relative to its own size; the plain
// version (models/ssm.py:_segsum) does the same.  The chunk only regroups
// the sum: the wrapper passes a chunk of at most 128 rows (half the
// caller's where that is 129 to 256), which changes nothing but the order
// of fp32 sums.
//
// What bounds it on this card: bytes, once the products are on the tensor
// cores.  At the zamba2-1.2b forward's shape (B 2, L 1024, H 64, P 64, N
// 64, Q 128, bf16) it must move 36.7 MB (11 us at 3.35 TB/s) and does 3.3
// GFLOP counted as fp32 work (49 us at 67 TFLOP/s on the CUDA cores, 3.3
// us at the 989 TFLOP/s of the bf16 tensor cores).
//
// Design: the SSD chunked algorithm (Dao & Gu, arXiv:2405.21060, sec. 6-7)
// in three kernels; only the second is sequential in the chunks, and it
// does one multiply-add per state element and chunk.
//  1. mamba_chunk_local_kernel, one block per (chunk, head), one warp per
//     16 state rows n: the chunk's end state from zero, local = B^T (w o
//     u) with w_j = exp(seg(j, Q-1]) folded into B, and its decay
//     exp(seg(-1, Q-1]).
//  2. mamba_chunk_pass_kernel, one thread per (batch, head, n, p): S <-
//     decay_c S + local_c over the chunks, writing the state entering each
//     chunk after the first and the final state.
//  3. mamba_chunk_outputs_kernel, one block per (chunk, 4 heads), one warp
//     per 16 query rows: C.B^T is computed once into registers and shared
//     by the block's heads (ngroups 1 makes it the same for every head);
//     per head y = exp(seg(-1, i]) C_i . S_enter + (C.B^T o exp(seg(j, i])
//     o dt_j) . x.  Each warp scans its own segment sums from its first
//     row back to the chunk's start, and a 16 x 16 table for the pairs
//     inside its rows.
// The wrapper allocates the scratch (local states, entering states,
// decays: 31.5 MB at the forward's shape); no kernel allocates, and no
// step synchronises with the host.  Rows are staged by cp.async in 16-byte
// pieces where the strides allow (the next head's rows in flight while a
// head is multiplied, where two slots fit).
//
// The bf16 instance (Q and N multiples of 16, P of 8) runs every product
// on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate, bf16
// fragments by ldmatrix).  C.B^T multiplies bf16 values as stored, so each
// product is exact.  Every other product has one operand that is bf16 as
// stored (x or C) and one in fp32 (B o w, the scores, the entering
// state), which enters as two bf16 terms, hi = bf16(v) and lo = bf16(v -
// hi), summed over two products: ~16 bits of the fp32 value, so the state
// stays within ~1e-5 of the fp32 plain version (a single bf16 rounding
// would be ~3e-3; tests/test_torch_ssm.py emulates both).  The pass
// writes the entering state as those two planes.  The output kernel's
// instance for P <= 64 is held to 128 registers: two blocks an SM, one
// head slot each.  fp32 inputs and other shapes
// take the same three kernels with fp32 FMAs on the CUDA cores in the
// same fragment layout (the convention of the fp32 entries: no TF32).

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "attention_common.cuh"

namespace {

using attn::from_float;
using attn::kFull;
using attn::kWarp;
using attn::to_float;

constexpr int kMaxQ = 128;             // rows of a chunk
constexpr int kMaxWarps = kMaxQ / 16;  // 16-row tiles: query rows, state rows
constexpr int kCbTiles = kMaxQ / 8;    // n8 tiles of a warp's C.B^T rows
constexpr int kHeadsPerBlock = 4;      // heads sharing one C.B^T
constexpr int kTileLd = 17;            // per-warp 16 x 16 tables
constexpr size_t kMaxSmem = 232448;    // a block's shared memory on Hopper

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kN>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kN));
}
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const unsigned*>(&v);
}
__device__ __forceinline__ float2 unpack(unsigned u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// (v0, v1) as bf16 pairs: hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split_pair(float v0, float v1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);  // .x = v0
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}

// The thread's A elements of one k16 step, in mma order ((g, 2t), (g,
// 2t+1), (g+8, 2t), (g+8, 2t+1), then the same at k + 8; g = lane / 4, t
// = lane % 4), as hi and lo bf16 terms.
__device__ __forceinline__ void split_a(const float (&av)[8], unsigned (&ah)[4],
                                        unsigned (&al)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) split_pair(av[2 * r], av[2 * r + 1], ah[r], al[r]);
}

// acc[nt] += (ah + al) . x[k0 .. k0 + 16, 8 nt .. 8 nt + 8] for every nt:
// x row-major bf16 in shared memory (row stride ld elements), its B
// fragments by ldmatrix.trans, two n8 tiles a load
template <int NT>
__device__ __forceinline__ void mma_split_a_x(float (&acc)[NT][4], const unsigned (&ah)[4],
                                              const unsigned (&al)[4],
                                              const __nv_bfloat16* xs, int ld, int k0,
                                              int lane) {
  const __nv_bfloat16* row = xs + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + (lane >> 4) * 8;
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    unsigned b[4];
    ldsm_x4_t(b, row + np * 16);
    mma_bf16(acc[2 * np], ah, b[0], b[1]);
    mma_bf16(acc[2 * np], al, b[0], b[1]);
    mma_bf16(acc[2 * np + 1], ah, b[2], b[3]);
    mma_bf16(acc[2 * np + 1], al, b[2], b[3]);
  }
}

// acc[nt] += a . (xh + xl)[k0 .. k0 + 16, 8 nt .. 8 nt + 8]: an A that is
// bf16 as stored against a B given as hi and lo bf16 planes (row-major,
// row stride ld), their fragments by ldmatrix.trans
template <int NT>
__device__ __forceinline__ void mma_a_split_x(float (&acc)[NT][4], const unsigned (&a)[4],
                                              const __nv_bfloat16* xh, const __nv_bfloat16* xl,
                                              int ld, int k0, int lane) {
  const int at = (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + (lane >> 4) * 8;
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    unsigned bh[4], bl[4];
    ldsm_x4_t(bh, xh + at + np * 16);
    ldsm_x4_t(bl, xl + at + np * 16);
    mma_bf16(acc[2 * np], a, bh[0], bh[1]);
    mma_bf16(acc[2 * np], a, bl[0], bl[1]);
    mma_bf16(acc[2 * np + 1], a, bh[2], bh[3]);
    mma_bf16(acc[2 * np + 1], a, bl[2], bl[3]);
  }
}

// acc (the warp's 16 rows x 8 NT cols, in the mma accumulator layout:
// rows g and g + 8, cols 8 nt + 2t and + 1) += A (16 x K) . B (K x cols)
// in fp32 FMAs on the CUDA cores; a(r, k) and b(k, col) read the
// operands (0 outside the data).
template <int NT, class FA, class FB>
__device__ __forceinline__ void ffma_product(float (&acc)[NT][4], int K, FA a, FB b, int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int k = 0; k < K; ++k) {
    const float a0 = a(g, k), a1 = a(g + 8, k);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = nt * 8 + 2 * t;
      const float b0 = b(k, col), b1 = b(k, col + 1);
      acc[nt][0] = fmaf(a0, b0, acc[nt][0]);
      acc[nt][1] = fmaf(a0, b1, acc[nt][1]);
      acc[nt][2] = fmaf(a1, b0, acc[nt][2]);
      acc[nt][3] = fmaf(a1, b1, acc[nt][3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
}

// out[j + 1] = sum of dt * a over (j, top] for j = top, top - 1, ..., -1
// (so out[top + 1] = 0 and out[0] sums tokens 0..top; top < 128), by one
// warp: lane l sums the tokens 4l .. 4l + 3 places below `top` outward,
// then a shuffle scan adds the lanes' totals.  All dt * a share one sign,
// so every partial sum's rounding is relative to its own size, in any
// order.
__device__ __forceinline__ void warp_suffix_sums(const float* d, float a, int top, float* out,
                                                 int lane) {
  float run[4];
  float sum = 0.0f;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int k = top - 4 * lane - m;
    sum += k >= 0 ? d[k] * a : 0.0f;
    run[m] = sum;
  }
  float incl = sum;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const float up = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += up;
  }
  const float prev = __shfl_up_sync(kFull, incl, 1);  // the lanes before this one
  const float base = lane == 0 ? 0.0f : prev;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int k = top - 4 * lane - m;  // out[k] = seg(k - 1, top]
    if (k >= 0) out[k] = base + run[m];
  }
  if (lane == 0) out[top + 1] = 0.0f;
}

// Copy rows x cols elements from src (row r at src + r * src_ld) to dst
// (row stride ld), by the whole block: cp.async in 16-byte pieces when
// `vec` (cols and both strides multiples of 16 bytes, src aligned; the
// caller commits and waits), else element by element.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src, size_t src_ld, int rows,
                                      int cols, bool vec) {
  constexpr int kPer = 16 / sizeof(T);
  if (vec) {
    const int pieces = cols / kPer;
    for (int i = threadIdx.x; i < rows * pieces; i += blockDim.x) {
      const int r = i / pieces, c = (i - r * pieces) * kPer;
      cp_async16(dst + r * ld + c, src + r * src_ld + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int r = i / cols, c = i - r * cols;
      dst[r * ld + c] = src[r * src_ld + c];
    }
  }
}

// dt of one head over Q tokens (stride H), by cp.async
__device__ __forceinline__ void stage_dt(float* dst, const float* src, int H, int Q) {
  for (int q = threadIdx.x; q < Q; q += blockDim.x)
    cp_async4(dst + q, src + static_cast<size_t>(q) * H);
}

__host__ __device__ constexpr size_t round16(size_t bytes) { return (bytes + 15) / 16 * 16; }

// Shared memory of the local-state kernel (mirrored by
// kernels/mamba_scan.py): B (Q x N) and one head's x (Q x XC, XC = 8 NTP
// >= P) of a chunk, its dt, then each warp's suffix sums and decay
// weights w o dt.  Rows are padded by 16 bytes.
template <typename T>
struct LocalLayout {
  int ldn, ldp;
  size_t b_bytes, x_bytes, total;
  __host__ __device__ LocalLayout(int Q, int N, int XC)
      : ldn(N + 16 / sizeof(T)),
        ldp(XC + 16 / sizeof(T)),
        b_bytes(round16(sizeof(T) * Q * ldn)),
        x_bytes(round16(sizeof(T) * Q * ldp)),
        total(b_bytes + x_bytes + round16(sizeof(float) * Q) +
              round16(sizeof(float) * ((N + 15) / 16) * (2 * Q + 1))) {}
};

// Shared memory of the output pass: B and C of the chunk (Q x N), each
// warp's suffix sums (Q + 1) and two 16 x 17 tables (segment sums of its
// diagonal tile; scores, CUDA cores); then one slot per head in flight
// (one, or two where they fit) of x (Q x XC, XC = 8 NTP >= P), the
// entering state (N x P fp32, or for bf16 its hi and lo planes, N x XC
// each) and dt.
template <typename T>
struct OutputsLayout {
  int ldn, ldp, lds, ldh, warps;
  size_t bc_bytes, x_bytes, s_bytes, fixed, slot;
  __host__ __device__ OutputsLayout(int Q, int N, int P, int XC)
      : ldn(N + 16 / sizeof(T)),
        ldp(XC + 16 / sizeof(T)),
        lds(P + 4),
        ldh(XC + 8),
        warps((Q + 15) / 16),
        bc_bytes(round16(sizeof(T) * Q * ldn)),
        x_bytes(round16(sizeof(T) * Q * ldp)),
        s_bytes(round16(std::is_same_v<T, float> ? sizeof(float) * N * lds : 2 * 2 * N * ldh)),
        fixed(2 * bc_bytes + round16(sizeof(float) * warps * (Q + 1 + 2 * 16 * kTileLd))),
        slot(x_bytes + s_bytes + round16(sizeof(float) * Q)) {}
  __host__ __device__ size_t total(int slots) const { return fixed + slots * slot; }
};

// ---------------------------------------------------------------------------
// 1. per (batch, chunk, head), the chunk's own end state, from zero:
//    local = B^T (w o u) with w_j = exp(seg(j, Q-1]), and its decay
//    exp(seg(-1, Q-1])
// ---------------------------------------------------------------------------

template <typename T, bool kTC, int NTP>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
mamba_chunk_local_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                         const float* __restrict__ A, const T* __restrict__ Bm,
                         float* __restrict__ local, float* __restrict__ decay, int L, int H,
                         int P, int N, int Q, bool vec_x, bool vec_b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const LocalLayout<T> lay(Q, N, NTP * 8);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane >> 2, t = lane & 3;
  T* Bs = reinterpret_cast<T*>(smem_raw);                 // (Q, ldn)
  T* Xs = reinterpret_cast<T*>(smem_raw + lay.b_bytes);  // (Q, ldp)
  float* ds = reinterpret_cast<float*>(smem_raw + lay.b_bytes + lay.x_bytes);  // (Q,) dt
  // each warp's own suffix sums from the chunk's end (Q + 1) and w_j dt_j (Q)
  float* wsum = ds + (Q + 3) / 4 * 4 + warp * (2 * Q + 1);
  float* wdt = wsum + Q + 1;

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int nc = L / Q;
  const int n0 = warp * 16;
  const size_t t0 = static_cast<size_t>(b) * L + static_cast<size_t>(c) * Q;
  stage(Bs, lay.ldn, Bm + t0 * N, N, Q, N, vec_b);
  stage(Xs, lay.ldp, x + (t0 * H + h) * P, static_cast<size_t>(H) * P, Q, P, vec_x);
  stage_dt(ds, dt + t0 * H + h, H, Q);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  warp_suffix_sums(ds, A[h], Q - 1, wsum, lane);
  __syncwarp();
  for (int q = lane; q < Q; q += kWarp) wdt[q] = expf(wsum[q + 1]) * ds[q];
  __syncwarp();

  // local = (B o w)^T . x over the chunk's tokens k
  float acc[NTP][4];
  zero(acc);
  if constexpr (kTC) {
    for (int k0 = 0; k0 < Q; k0 += 16) {
      // A[n][k] = B[k][n0 + n] w_k: ldmatrix.trans of B's rows k
      unsigned r[4];
      ldsm_x4_t(r, Bs + (k0 + ((lane >> 4) & 1) * 8 + (lane & 7)) * lay.ldn + n0 +
                       ((lane >> 3) & 1) * 8);
      const int k = k0 + 2 * t;
      const float w0 = wdt[k], w1 = wdt[k + 1], w8 = wdt[k + 8], w9 = wdt[k + 9];
      const float2 f0 = unpack(r[0]), f1 = unpack(r[1]), f2 = unpack(r[2]), f3 = unpack(r[3]);
      const float av[8] = {f0.x * w0, f0.y * w1, f1.x * w0, f1.y * w1,
                           f2.x * w8, f2.y * w9, f3.x * w8, f3.y * w9};
      unsigned ah[4], al[4];
      split_a(av, ah, al);
      mma_split_a_x(acc, ah, al, Xs, lay.ldp, k0, lane);
    }
  } else {
    ffma_product(
        acc, Q,
        [&](int r, int k) {
          return n0 + r < N ? to_float(Bs[k * lay.ldn + n0 + r]) * wdt[k] : 0.0f;
        },
        [&](int k, int p) { return p < P ? to_float(Xs[k * lay.ldp + p]) : 0.0f; }, lane);
  }
  const size_t at = (static_cast<size_t>(b) * nc + c) * H + h;
  float* dst = local + at * N * P;
#pragma unroll
  for (int nt = 0; nt < NTP; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + g + (e >> 1) * 8, p = nt * 8 + 2 * t + (e & 1);
      if (n < N && p < P) dst[n * P + p] = acc[nt][e];
    }
  }
  if (threadIdx.x == 0) decay[at] = expf(wsum[0]);
}

// ---------------------------------------------------------------------------
// 2. the state pass, sequential over the chunks and parallel over (batch,
//    head, n, p): S <- decay_c S + local_c, writing the state entering each
//    chunk after the first (fp32, or for the tensor-core instance as hi and
//    lo bf16 planes, N x P each) and the final state
// ---------------------------------------------------------------------------

template <bool kSplit>
__global__ void __launch_bounds__(256)
mamba_chunk_pass_kernel(const float* __restrict__ local, const float* __restrict__ decay,
                        float* __restrict__ enter, float* __restrict__ state, int B, int H,
                        int NP, int nc) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(B) * H * NP) return;
  const size_t bh = idx / NP;
  const int e = static_cast<int>(idx - bh * NP);
  const int b = static_cast<int>(bh / H), h = static_cast<int>(bh - static_cast<size_t>(b) * H);
  float S = 0.0f;
#pragma unroll 4
  for (int c = 0; c < nc; ++c) {
    const size_t at = (static_cast<size_t>(b) * nc + c) * H + h;
    if (c > 0) {
      const size_t slot = (static_cast<size_t>(b) * (nc - 1) + c - 1) * H + h;
      if constexpr (kSplit) {
        auto* planes = reinterpret_cast<__nv_bfloat16*>(enter) + slot * 2 * NP;
        const __nv_bfloat16 hi = __float2bfloat16_rn(S);
        planes[e] = hi;
        planes[NP + e] = __float2bfloat16_rn(S - __bfloat162float(hi));
      } else {
        enter[slot * NP + e] = S;
      }
    }
    S = decay[at] * S + local[at * NP + e];
  }
  state[bh * NP + e] = S;
}

// ---------------------------------------------------------------------------
// 3. the outputs: per (batch, chunk, 4 heads), y of every row
// ---------------------------------------------------------------------------

template <typename T, bool kTC, int NTP>
__global__ void __launch_bounds__(kMaxWarps * kWarp, kTC && NTP == 8 ? 2 : 1)
mamba_chunk_outputs_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                           const float* __restrict__ A, const T* __restrict__ Bm,
                           const T* __restrict__ Cm, const float* __restrict__ enter,
                           T* __restrict__ y, int L, int H, int P, int N, int Q, int slots,
                           bool vec_x, bool vec_b, bool vec_s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const OutputsLayout<T> lay(Q, N, P, NTP * 8);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane >> 2, t = lane & 3;
  T* Bs = reinterpret_cast<T*>(smem_raw);                  // (Q, ldn)
  T* Cs = reinterpret_cast<T*>(smem_raw + lay.bc_bytes);  // (Q, ldn)
  float* gs = reinterpret_cast<float*>(smem_raw + 2 * lay.bc_bytes) +
              warp * (Q + 1 + 2 * 16 * kTileLd);  // (Q + 1,) suffix sums from i0
  float* dg = gs + Q + 1;       // (16, kTileLd) seg(i0 + jj, i0 + r] for jj <= r
  float* sc = dg + 16 * kTileLd;  // (16, kTileLd) scores (CUDA cores)
  const auto slot = [&](int s) { return smem_raw + lay.fixed + s * lay.slot; };
  const auto Xs = [&](int s) { return reinterpret_cast<T*>(slot(s)); };
  // the entering state: fp32 (N, lds), or (tensor cores) hi and lo bf16 planes (N, ldh) each
  const auto Ss = [&](int s) { return reinterpret_cast<float*>(slot(s) + lay.x_bytes); };
  const auto Sh = [&](int s) { return reinterpret_cast<T*>(slot(s) + lay.x_bytes); };
  const auto Ds = [&](int s) {
    return reinterpret_cast<float*>(slot(s) + lay.x_bytes + lay.s_bytes);
  };

  const int h0 = blockIdx.x * kHeadsPerBlock, c = blockIdx.y, b = blockIdx.z;
  const int nc = L / Q;
  const int i0 = warp * 16;  // this warp's first query row
  const size_t t0 = static_cast<size_t>(b) * L + static_cast<size_t>(c) * Q;
  const int h_end = min(h0 + kHeadsPerBlock, H);
  const auto fetch = [&](int h, int s) {
    stage(Xs(s), lay.ldp, x + (t0 * H + h) * P, static_cast<size_t>(H) * P, Q, P, vec_x);
    if (c > 0) {
      const float* src = enter + ((static_cast<size_t>(b) * (nc - 1) + c - 1) * H + h) * N * P;
      if constexpr (kTC)  // hi plane rows then lo plane rows
        stage(Sh(s), lay.ldh, reinterpret_cast<const T*>(src), P, 2 * N, P, vec_s);
      else
        stage(Ss(s), lay.lds, src, P, N, P, vec_s);
    }
    stage_dt(Ds(s), dt + t0 * H + h, H, Q);
    cp_async_commit();
  };

  stage(Bs, lay.ldn, Bm + t0 * N, N, Q, N, vec_b);
  stage(Cs, lay.ldn, Cm + t0 * N, N, Q, N, vec_b);
  cp_async_commit();
  fetch(h0, 0);
  cp_async_wait<1>();
  __syncthreads();

  // C.B^T of this warp's rows against the chunk's keys, once for all heads
  float cb[kCbTiles][4];
  zero(cb);
  const auto c_row = [&](int r, int n) {
    return i0 + r < Q && n < N ? to_float(Cs[(i0 + r) * lay.ldn + n]) : 0.0f;
  };
  // the A fragments of C's rows i0.. by ldmatrix
  const T* c_frag = Cs + (i0 + (lane & 7) + ((lane >> 3) & 1) * 8) * lay.ldn + (lane >> 4) * 8;
  if constexpr (kTC) {
    for (int k0 = 0; k0 < N; k0 += 16) {
      unsigned a[4];
      ldsm_x4(a, c_frag + k0);
#pragma unroll
      for (int np = 0; np < kCbTiles / 2; ++np) {
        if (np * 16 < Q) {  // keys j: B's rows, its k (n) contiguous
          unsigned bb[4];
          ldsm_x4(bb, Bs + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * lay.ldn + k0 +
                          ((lane >> 3) & 1) * 8);
          mma_bf16(cb[2 * np], a, bb[0], bb[1]);
          mma_bf16(cb[2 * np + 1], a, bb[2], bb[3]);
        }
      }
    }
  } else {
    ffma_product(cb, N, c_row,
                 [&](int n, int j) { return j < Q && n < N ? to_float(Bs[j * lay.ldn + n]) : 0.0f; },
                 lane);
  }

  for (int h = h0; h < h_end; ++h) {
    const int s = slots == 2 ? (h - h0) & 1 : 0;
    if (slots == 2 && h + 1 < h_end) {  // the next head's rows fly meanwhile
      fetch(h + 1, s ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ds = Ds(s);
    const float* ss = Ss(s);
    const T* sh = Sh(s);
    const T* xs = Xs(s);
    const float a_h = A[h];
    warp_suffix_sums(ds, a_h, i0, gs, lane);  // gs[j + 1] = seg(j, i0]
    // dg[r][jj] = seg(i0 + jj, i0 + r], summed from i0 + jj outward (0
    // above the diagonal, where the pair is masked)
    if (lane < 16) {
      float sum = 0.0f;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        if (r > lane) sum += i0 + r < Q ? ds[i0 + r] * a_h : 0.0f;
        dg[r * kTileLd + lane] = sum;
      }
    }
    __syncwarp();
    // fw[0 / 1] = seg(i0, i] of rows i = i0 + g and i0 + g + 8
    const float fw[2] = {dg[g * kTileLd], dg[(g + 8) * kTileLd]};

    float acc[NTP][4];
    zero(acc);
    if (c > 0) {  // exp(seg(-1, i]) C_i . S: A = C (bf16 as stored), B = S (fp32)
      if constexpr (kTC) {
        for (int k0 = 0; k0 < N; k0 += 16) {
          unsigned a[4];
          ldsm_x4(a, c_frag + k0);
          mma_a_split_x(acc, a, sh, sh + N * lay.ldh, lay.ldh, k0, lane);
        }
      } else {
        ffma_product(acc, N, c_row,
                     [&](int n, int p) { return n < N && p < P ? ss[n * lay.lds + p] : 0.0f; },
                     lane);
      }
      const float w0 = expf(fw[0] + gs[0]), w1 = expf(fw[1] + gs[0]);
#pragma unroll
      for (int nt = 0; nt < NTP; ++nt) {
        acc[nt][0] *= w0;
        acc[nt][1] *= w0;
        acc[nt][2] *= w1;
        acc[nt][3] *= w1;
      }
    }

    // (C.B^T o exp(seg(j, i]) o dt_j) . x over the key tiles j0 <= i0
#pragma unroll
    for (int st = 0; st < kMaxWarps; ++st) {
      const int j0 = st * 16;
      if (j0 > i0) continue;
      float av[8];
      if (j0 < i0) {  // keys below the warp's rows: every pair counts, j <= i0
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          // mma order: tile 2 st then 2 st + 1; in each (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
          const int j = j0 + (e >= 4 ? 8 : 0) + 2 * t + (e & 1);
          av[e] = cb[2 * st + (e >> 2)][e & 3] * expf(fw[(e >> 1) & 1] + gs[j + 1]) * ds[j];
        }
      } else {  // the diagonal tile: segments within the warp's rows, j <= i
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int r = g + 8 * ((e >> 1) & 1);
          const int jj = (e >= 4 ? 8 : 0) + 2 * t + (e & 1);
          const bool in = jj <= r && i0 + r < Q;
          const float v = cb[2 * st + (e >> 2)][e & 3] * expf(dg[r * kTileLd + jj]) *
                          ds[in ? j0 + jj : 0];
          av[e] = in ? v : 0.0f;
        }
      }
      if constexpr (kTC) {
        unsigned ah[4], al[4];
        split_a(av, ah, al);
        mma_split_a_x(acc, ah, al, xs, lay.ldp, j0, lane);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          sc[(g + 8 * ((e >> 1) & 1)) * kTileLd + (e >= 4 ? 8 : 0) + 2 * t + (e & 1)] = av[e];
        __syncwarp();
        ffma_product(
            acc, min(16, Q - j0), [&](int r, int k) { return sc[r * kTileLd + k]; },
            [&](int k, int p) { return p < P ? to_float(xs[(j0 + k) * lay.ldp + p]) : 0.0f; },
            lane);
        __syncwarp();
      }
    }

#pragma unroll
    for (int nt = 0; nt < NTP; ++nt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + g + 8 * r, p = nt * 8 + 2 * t;
        T* out = y + ((t0 + i) * H + h) * P + p;
        if constexpr (kTC) {  // P a multiple of 8: both cols or neither
          if (i < Q && p < P)
            *reinterpret_cast<unsigned*>(out) =
                bits(__floats2bfloat162_rn(acc[nt][2 * r], acc[nt][2 * r + 1]));
        } else {
          if (i < Q && p < P) out[0] = from_float<T>(acc[nt][2 * r]);
          if (i < Q && p + 1 < P) out[1] = from_float<T>(acc[nt][2 * r + 1]);
        }
      }
    }
    __syncthreads();  // this head's slot is refilled next
    if (slots == 1 && h + 1 < h_end) fetch(h + 1, 0);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, bool kTC, int NTP>
int launch_as(const T* x, const float* dt, const float* A, const T* Bm, const T* Cm, T* y,
              float* state, float* scratch, int B, int L, int H, int P, int N, int Q,
              cudaStream_t stream) {
  constexpr int kPer = 16 / sizeof(T);
  const int nc = L / Q;
  // scratch: local states (B, nc, H, N, P), entering states (B, nc - 1, H,
  // N, P), decays (B, nc, H), all 4 bytes an element
  float* local = scratch;
  float* enter = local + static_cast<size_t>(B) * nc * H * N * P;
  float* decay = enter + static_cast<size_t>(B) * (nc - 1) * H * N * P;
  const bool vec_x = P % kPer == 0 && aligned16(x);
  const bool vec_b = N % kPer == 0 && aligned16(Bm) && aligned16(Cm);
  const bool vec_s = P % (kTC ? 8 : 4) == 0 && aligned16(enter);
  const size_t smem1 = LocalLayout<T>(Q, N, NTP * 8).total;
  const OutputsLayout<T> out(Q, N, P, NTP * 8);
  // two blocks an SM for the narrow tensor-core instance (one slot each),
  // else a second slot where it fits
  const int slots = !(kTC && NTP == 8) && out.total(2) <= kMaxSmem ? 2 : 1;
  const size_t smem3 = out.total(slots);
  cudaError_t err = attn::allow_smem<&mamba_chunk_local_kernel<T, kTC, NTP>>(smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = attn::allow_smem<&mamba_chunk_outputs_kernel<T, kTC, NTP>>(smem3);
  if (err != cudaSuccess) return static_cast<int>(err);
  mamba_chunk_local_kernel<T, kTC, NTP><<<dim3(H, nc, B), kWarp * ((N + 15) / 16), smem1,
                                          stream>>>(x, dt, A, Bm, local, decay, L, H, P, N, Q,
                                                    vec_x, vec_b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t elems = static_cast<size_t>(B) * H * N * P;
  mamba_chunk_pass_kernel<kTC><<<static_cast<unsigned>((elems + 255) / 256), 256, 0, stream>>>(
      local, decay, enter, state, B, H, N * P, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((H + kHeadsPerBlock - 1) / kHeadsPerBlock, nc, B);
  mamba_chunk_outputs_kernel<T, kTC, NTP><<<grid, kWarp * ((Q + 15) / 16), smem3, stream>>>(
      x, dt, A, Bm, Cm, enter, y, L, H, P, N, Q, slots, vec_x, vec_b, vec_s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           void* y, void* state, void* scratch, int B, int L, int H, int P, int N, int Q,
           void* stream) {
  const auto args = [&](auto tc, auto ntp) {
    return launch_as<T, decltype(tc)::value, decltype(ntp)::value>(
        static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
        static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<T*>(y),
        static_cast<float*>(state), static_cast<float*>(scratch), B, L, H, P, N, Q,
        static_cast<cudaStream_t>(stream));
  };
  using Narrow = std::integral_constant<int, 8>;  // P <= 64
  using Wide = std::integral_constant<int, 16>;   // P <= 128
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (Q % 16 == 0 && N % 16 == 0 && P % 8 == 0)
      return P <= 64 ? args(std::true_type{}, Narrow{}) : args(std::true_type{}, Wide{});
  }
  return P <= 64 ? args(std::false_type{}, Narrow{}) : args(std::false_type{}, Wide{});
}

}  // namespace

// Launch the three kernels on `stream`; return cudaGetLastError() (0 when
// accepted).  The caller checks shapes: B, L, H >= 1, Q divides L, Q <=
// 128, N and P in 1..128, the shared memory of each kernel (one head slot
// for the outputs) within the card's 227 KB; `scratch` holds (2 L/Q - 1)
// B H N P + B (L/Q) H floats.
extern "C" int mamba_chunk_scan_f32(const void* x, const void* dt, const void* A,
                                    const void* Bm, const void* Cm, void* y, void* state,
                                    void* scratch, int B, int L, int H, int P, int N, int Q,
                                    void* stream) {
  return launch<float>(x, dt, A, Bm, Cm, y, state, scratch, B, L, H, P, N, Q, stream);
}

extern "C" int mamba_chunk_scan_bf16(const void* x, const void* dt, const void* A,
                                     const void* Bm, const void* Cm, void* y, void* state,
                                     void* scratch, int B, int L, int H, int P, int N, int Q,
                                     void* stream) {
  return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, scratch, B, L, H, P, N, Q, stream);
}
