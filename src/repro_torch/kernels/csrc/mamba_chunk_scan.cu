// mamba_chunk_scan: the chunked Mamba2 SSD scan (state space duality),
// written for NVIDIA Hopper (sm_90a).  Every Mamba2 layer of zamba2's
// full-sequence forward runs it once.
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan.py:mamba_chunk_scan
// (its pallas_call is at mamba_scan.py:83).  Same function: x (B,L,H,P),
// dt (B,L,H) after softplus, A (H,) negative, Bm and Cm (B,L,N) (ngroups
// 1), chunk Q dividing L -> y (B,L,H,P) in x's dtype and the final state
// (B,H,N,P) in fp32.  All arithmetic is fp32.  Per chunk and head:
//   cum = cumsum(dt * A),  u = x * dt
//   y[i] = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) u_j  +  exp(cum_i) C_i . S
//   S   <- exp(cum_Q) S + sum_j exp(cum_Q - cum_j) B_j (x) u_j
// with S starting at zero.  The decays exp(cum_i - cum_j) and
// exp(cum_Q - cum_j) are formed for j <= i only (where they are <= 1; the
// TPU kernel forms them for every pair and masks after, and for j > i they
// can overflow), and from segment sums of dt * A over (j, i], never as a
// difference of two prefix sums: in a 128-token chunk of zamba2 those
// reach several hundred, and their difference loses ~1e-5 of each decay.
// Every dt * A has one sign, so a segment sum split in two parts (each a
// sum from the split point outward) keeps its rounding relative to its
// own size; the plain version (models/ssm.py:_segsum) does the same.
//
// What bounds it on this card: operations.  At the zamba2-1.2b forward's
// shape (B 2, L 1024, H 64, P 64, N 64, Q 128, bf16) it moves about 37 MB
// (11 us at the HBM rate) and does about 3.3 GFLOP of fp32 work (49 us at
// 67 TFLOP/s): per head and chunk the causal scores C.B^T and their
// product with u, C.S and the B (x) u update, each Q x N x P or Q^2/2 x N.
//
// Design (simple and right first): one block of 16 warps per (batch,
// head) -- 128 blocks at the full-width shape, one wave on 132 SMs --
// loops over the chunks in order, as the TPU kernel's fori_loop does, so
// nothing is carried between blocks.  The state S (N x P fp32) stays in
// shared memory.  Per chunk the block stages the chunk's B and C (rows
// padded to N + 1 floats, so lanes reading 32 consecutive rows hit 32
// banks), u and dt * A; one warp scans the prefix sums cum, another the
// suffix sums behind exp(cum_Q - cum_j).  Then the block walks the query
// rows in tiles of 64, each warp owning 4 rows: the warp scans the
// segment sums from its first row back to the chunk's start, computes its
// rows' causal scores (C_i . B_j times the decay) into shared memory, and
// then its rows of y, lanes over the head dim, from scores . u and C . S.
// Last, each warp updates N / 16 rows of S.  Every product is
// register-tiled (4 rows x up to 8 key columns, 4 rows x up to 4 head
// dims, up to 8 state rows x 4 head dims), with the operand shared by a
// warp read as a broadcast.  C.B^T is recomputed for every head (64 times
// at ngroups 1); sharing it across a head tile is later work.

#include <cmath>

#include "attention_common.cuh"

namespace {

using attn::from_float;
using attn::kFull;
using attn::kWarp;
using attn::to_float;

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * kWarp;
constexpr int kTile = 64;                     // query rows per score tile
constexpr int kRowsPerWarp = kTile / kWarps;  // rows a warp owns in a tile
constexpr int kMaxCols = 8;                   // Q <= 256: key columns per lane
constexpr int kMaxDims = 4;                   // P <= 128: head dims per lane
constexpr int kMaxStateRows = 8;              // N <= 128: state rows per warp

// out[j] = sum of la over (j, top] for j = top, top - 1, ..., 0, by one
// warp (lane l takes position top - 32 m - l; a shuffle scan over lanes
// adds the terms outward from `top`), exponentiated with `exp_out`.  All
// la share one sign, so every partial sum's rounding is relative to its
// own size.
__device__ __forceinline__ void warp_suffix_sums(const float* la, int top, float* out,
                                                 bool exp_out, int lane) {
  float carry = 0.0f;
  for (int hi = top; hi >= 0; hi -= kWarp) {
    const int j = hi - lane;
    float v = j >= 0 && j < top ? la[j + 1] : 0.0f;
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const float up = __shfl_up_sync(kFull, v, o);
      if (lane >= o) v += up;
    }
    v += carry;
    if (j >= 0) out[j] = exp_out ? expf(v) : v;
    carry = __shfl_sync(kFull, v, kWarp - 1);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mamba_chunk_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                        const float* __restrict__ A, const T* __restrict__ Bm,
                        const T* __restrict__ Cm, T* __restrict__ y,
                        float* __restrict__ state, int L, int H, int P, int N,
                        int Q) {
  extern __shared__ float smem[];
  const int NS = N + 1, QS = Q + 1;  // padded row strides
  float* Bs = smem;                  // (Q, NS)
  float* Cs = Bs + Q * NS;           // (Q, NS)
  float* us = Cs + Q * NS;           // (Q, P)
  float* Ss = us + Q * P;            // (N, P)
  float* sc = Ss + N * P;            // (kTile, QS)
  float* la = sc + kTile * QS;       // (Q,) dt * A
  float* cum = la + Q;               // (Q,) prefix sums of la
  float* wl = cum + Q;               // (Q,) exp(cum_Q - cum_j)
  float* seg = wl + Q;               // (kWarps, Q) each warp's segment sums

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const float a_h = A[h];
  const int ndims = (P + kWarp - 1) / kWarp;
  for (int i = threadIdx.x; i < N * P; i += kThreads) Ss[i] = 0.0f;

  for (int c = 0; c < L / Q; ++c) {
    const size_t t0 = static_cast<size_t>(b) * L + static_cast<size_t>(c) * Q;
    __syncthreads();  // the previous chunk is done with the staged rows
    for (int i = threadIdx.x; i < Q * N; i += kThreads) {
      const int q = i / N, n = i % N;
      Bs[q * NS + n] = to_float(Bm[(t0 + q) * N + n]);
      Cs[q * NS + n] = to_float(Cm[(t0 + q) * N + n]);
    }
    for (int i = threadIdx.x; i < Q * P; i += kThreads) {
      const int q = i / P, p = i % P;
      const size_t row = (t0 + q) * H + h;
      us[i] = to_float(x[row * P + p]) * dt[row];
    }
    for (int q = threadIdx.x; q < Q; q += kThreads) la[q] = dt[(t0 + q) * H + h] * a_h;
    __syncthreads();
    if (warp == 0) {  // inclusive prefix scan of la, 32 tokens at a time
      float carry = 0.0f;
      for (int q0 = 0; q0 < Q; q0 += kWarp) {
        const int q = q0 + lane;
        float v = q < Q ? la[q] : 0.0f;
#pragma unroll
        for (int o = 1; o < kWarp; o <<= 1) {
          const float up = __shfl_up_sync(kFull, v, o);
          if (lane >= o) v += up;
        }
        v += carry;
        if (q < Q) cum[q] = v;
        carry = __shfl_sync(kFull, v, kWarp - 1);
      }
    } else if (warp == 1) {
      warp_suffix_sums(la, Q - 1, wl, true, lane);
    }
    __syncthreads();
    const float cum_last = cum[Q - 1];

    for (int i0 = 0; i0 < Q; i0 += kTile) {
      const int rbase = i0 + warp * kRowsPerWarp;  // this warp's first row
      // causal scores of rows [i0, i0 + 64) against keys j < jend
      const int jend = min(i0 + kTile, Q);
      const int ncols = (jend + kWarp - 1) / kWarp;
      if (rbase < Q) {
        // segment sums split at rbase: sg[j] over (j, rbase] for j <= rbase,
        // fw[r] over (rbase, rbase + r] for this warp's rows
        float* sg = seg + warp * Q;
        warp_suffix_sums(la, rbase, sg, false, lane);
        __syncwarp();
        float fw[kRowsPerWarp];
        fw[0] = 0.0f;
#pragma unroll
        for (int r = 1; r < kRowsPerWarp; ++r)
          fw[r] = fw[r - 1] + (rbase + r < Q ? la[rbase + r] : 0.0f);
        float acc[kRowsPerWarp][kMaxCols];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
          for (int cc = 0; cc < kMaxCols; ++cc) acc[r][cc] = 0.0f;
        for (int n = 0; n < N; ++n) {
          float cv[kRowsPerWarp];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
            cv[r] = rbase + r < Q ? Cs[(rbase + r) * NS + n] : 0.0f;
#pragma unroll
          for (int cc = 0; cc < kMaxCols; ++cc) {
            if (cc < ncols) {
              const int j = lane + cc * kWarp;
              const float bv = j < Q ? Bs[j * NS + n] : 0.0f;
#pragma unroll
              for (int r = 0; r < kRowsPerWarp; ++r) acc[r][cc] += cv[r] * bv;
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int i = rbase + r;
#pragma unroll
          for (int cc = 0; cc < kMaxCols; ++cc) {
            const int j = lane + cc * kWarp;
            if (cc < ncols && i < Q && j < jend) {
              float decay = 0.0f;
              if (j <= rbase) {
                decay = expf(fw[r] + sg[j]);
              } else if (j <= i) {  // rbase < j <= i: both sums within 3 rows
                const int d = j - rbase;
                decay = expf(fw[r] - (d == 1 ? fw[1] : d == 2 ? fw[2] : fw[3]));
              }
              sc[(i - i0) * QS + j] = acc[r][cc] * decay;
            }
          }
        }
      }
      __syncthreads();
      // y of this warp's rows: scores . u (intra) and C . S (inter)
      {
        float ya[kRowsPerWarp][kMaxDims], yb[kRowsPerWarp][kMaxDims];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
          for (int pc = 0; pc < kMaxDims; ++pc) ya[r][pc] = yb[r][pc] = 0.0f;
        const int jmax = min(rbase + kRowsPerWarp, Q);
        for (int j = 0; j < jmax; ++j) {
          float s[kRowsPerWarp];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
            s[r] = rbase + r < Q ? sc[(rbase + r - i0) * QS + j] : 0.0f;
#pragma unroll
          for (int pc = 0; pc < kMaxDims; ++pc) {
            const int p = lane + pc * kWarp;
            if (pc < ndims) {
              const float uv = p < P ? us[j * P + p] : 0.0f;
#pragma unroll
              for (int r = 0; r < kRowsPerWarp; ++r) ya[r][pc] += s[r] * uv;
            }
          }
        }
        for (int n = 0; n < N; ++n) {
          float cv[kRowsPerWarp];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
            cv[r] = rbase + r < Q ? Cs[(rbase + r) * NS + n] : 0.0f;
#pragma unroll
          for (int pc = 0; pc < kMaxDims; ++pc) {
            const int p = lane + pc * kWarp;
            if (pc < ndims) {
              const float sv = p < P ? Ss[n * P + p] : 0.0f;
#pragma unroll
              for (int r = 0; r < kRowsPerWarp; ++r) yb[r][pc] += cv[r] * sv;
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int i = rbase + r;
          if (i >= Q) continue;
          const float w_in = expf(cum[i]);
          T* yrow = y + ((t0 + i) * H + h) * P;
#pragma unroll
          for (int pc = 0; pc < kMaxDims; ++pc) {
            const int p = lane + pc * kWarp;
            if (pc < ndims && p < P) yrow[p] = from_float<T>(ya[r][pc] + w_in * yb[r][pc]);
          }
        }
      }
      __syncthreads();  // the next tile rewrites the scores; S is read
    }

    // S <- exp(cum_Q) S + sum_j B_j (x) (wl_j u_j): warp rows n = warp + 8 r
    {
      float acc[kMaxStateRows][kMaxDims];
#pragma unroll
      for (int r = 0; r < kMaxStateRows; ++r)
#pragma unroll
        for (int pc = 0; pc < kMaxDims; ++pc) acc[r][pc] = 0.0f;
      for (int j = 0; j < Q; ++j) {
        float uv[kMaxDims];
#pragma unroll
        for (int pc = 0; pc < kMaxDims; ++pc) {
          const int p = lane + pc * kWarp;
          uv[pc] = pc < ndims && p < P ? us[j * P + p] * wl[j] : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < kMaxStateRows; ++r) {
          const int n = warp + r * kWarps;
          if (n < N) {
            const float bv = Bs[j * NS + n];
#pragma unroll
            for (int pc = 0; pc < kMaxDims; ++pc) acc[r][pc] += bv * uv[pc];
          }
        }
      }
      const float a_chunk = expf(cum_last);
#pragma unroll
      for (int r = 0; r < kMaxStateRows; ++r) {
        const int n = warp + r * kWarps;
#pragma unroll
        for (int pc = 0; pc < kMaxDims; ++pc) {
          const int p = lane + pc * kWarp;
          if (n < N && pc < ndims && p < P)
            Ss[n * P + p] = a_chunk * Ss[n * P + p] + acc[r][pc];
        }
      }
    }
  }
  __syncthreads();
  float* out = state + (static_cast<size_t>(b) * H + h) * N * P;
  for (int i = threadIdx.x; i < N * P; i += kThreads) out[i] = Ss[i];
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           void* y, void* state, int B, int L, int H, int P, int N, int Q, void* stream) {
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(Q) * (N + 1) +
                                       static_cast<size_t>(Q) * P + static_cast<size_t>(N) * P +
                                       kTile * static_cast<size_t>(Q + 1) +
                                       static_cast<size_t>(3 + kWarps) * Q);
  const cudaError_t err = attn::allow_smem<&mamba_chunk_scan_kernel<T>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mamba_chunk_scan_kernel<T><<<B * H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<T*>(y),
      static_cast<float*>(state), L, H, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; return cudaGetLastError() (0 when accepted).  The
// caller checks shapes: B, L, H >= 1, Q divides L, Q <= 256, N and P in
// 1..128, and the block's shared memory within the card's 227 KB.
extern "C" int mamba_chunk_scan_f32(const void* x, const void* dt, const void* A,
                                    const void* Bm, const void* Cm, void* y, void* state,
                                    int B, int L, int H, int P, int N, int Q, void* stream) {
  return launch<float>(x, dt, A, Bm, Cm, y, state, B, L, H, P, N, Q, stream);
}

extern "C" int mamba_chunk_scan_bf16(const void* x, const void* dt, const void* A,
                                     const void* Bm, const void* Cm, void* y, void* state,
                                     int B, int L, int H, int P, int N, int Q, void* stream) {
  return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, B, L, H, P, N, Q, stream);
}
