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
// H = Hkv = 32, C = 256 slots of which 57-64 are valid, D = 64, bf16) the
// valid keys are 2.1 MB of K and V for 2.1 MFLOP: 0.6 us at the HBM rate
// against 0.002 us at the bf16 tensor-core rate.  Reading each valid K/V
// row once, with enough bytes in flight to cover the memory latency, is
// the whole game; a launch costs more than either.
//
// Design: one block of 8 warps per (b, kv head, group of up to kGB query
// heads), so the query heads of a kv head share every K/V read.
// - Masked slots are not read.  The block first asks whether the row has
//   any valid slot (C bytes, from L2).  Each warp then takes 32-slot
//   windows in turn, reads the window's 32 `valid` bytes (one a lane) and
//   takes a ballot: a window, or a sub-chunk of it, with no valid slot is
//   skipped without touching K/V, and invalid slots inside a sub-chunk
//   are not loaded.  Skipping is exact, since a masked key adds
//   exp(-1e30 - m) = 0.  A row with no valid slot reads every slot's V
//   and no K: its scores are all -1e30, so the plain version and the JAX
//   kernel give the uniform mean of V, and so does this kernel.
// - A key row is spread over a group of 8 lanes, each holding D / 8 of
//   its elements: as one 16-byte vector load (8 bf16, or 4 fp32 twice)
//   at D 64, so one load instruction of the warp covers 4 keys.  Where
//   D * elt or Dv * elt is not a multiple of 16 (or a pointer is not
//   16-byte aligned) a compile-time variant of the same kernel loads one
//   element at a time.  The pre-scaled fp32 query sits in registers; a
//   score is the lane group's partial dot reduced with 3 shuffles, and
//   P.V accumulates each lane's own output dims.  No K/V staging copy in
//   shared memory.
// - Each lane issues the loads of U keys (U = 8 at D <= 64 in bf16: 16
//   vector loads of 16 bytes) before it uses the first, so a sub-chunk's
//   whole K and V are in flight at once.
// - Each lane group keeps its own online softmax (max, sum, output);
//   at the end the 4 groups of a warp are merged by shuffles and the
//   warps through shared memory, rescaled to their common max.
// The grid is (Hkv, B, ceil(G / kGB)); a row's keys are not split over
// blocks: the time is nearly flat from B = 1 to B = 8 (PERF.md), so a
// block's own latency, not the number of idle SMs, sets it, and a second
// combining pass would add a launch.
// fp32 arithmetic, expf without fast math; D, Dv <= 128.

#include <cstdint>

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int kWarps = 8;
constexpr int kGroupLanes = 8;                  // lanes a key row is spread over
constexpr int kGroups = kWarp / kGroupLanes;    // keys a warp loads at once

// kDims: elements of a row a lane holds (8 for D, Dv <= 64, 16 up to 128);
// kGB: query heads a block takes.
template <typename T, bool kVec, int kDims, int kGB>
__global__ void __launch_bounds__(kWarps * kWarp)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const unsigned char* __restrict__ valid,
                        T* __restrict__ out, int C, int H, int Hkv, int D, int Dv,
                        float scale) {
  using P = RowPiece<T, kVec>;
  constexpr int kEpl = P::kEpl;
  constexpr int kPieces = kDims / kEpl;                   // loads a lane makes a row
  constexpr int kRowRegs = kPieces * (sizeof(typename P::Raw) < 4
                                          ? 1 : sizeof(typename P::Raw) / 4);
  // keys per lane group per sub-chunk: about 32 registers each of K and V
  constexpr int kU = kRowRegs >= 32 ? 1 : (32 / kRowRegs > 8 ? 8 : 32 / kRowRegs);
  constexpr int kSub = kGroups * kU;                      // keys per sub-chunk

  extern __shared__ float smem[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / Hkv;
  const int h0 = kvh * G + blockIdx.z * kGB;  // first query head
  const int ng = min(kGB, kvh * G + G - h0);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int grp = lane / kGroupLanes, j = lane % kGroupLanes;
  float* qs = smem;                 // (kGB, D), pre-scaled
  float* red = qs + kGB * D;        // (kWarps, kGB, 2 + Dv)

  const size_t row0 = static_cast<size_t>(b) * C;  // cache row of slot 0
  for (int i = threadIdx.x; i < ng * D; i += blockDim.x)
    qs[i] = to_float(q[(static_cast<size_t>(b) * H + h0) * D + i]) * scale;
  int mine = 0;
  for (int c = threadIdx.x; c < C; c += blockDim.x) mine |= valid[row0 + c];
  const bool any = __syncthreads_or(mine);  // also publishes qs

  // element e of a lane's piece p: (p * 8 + j) * kEpl + e
  float qr[kGB][kDims];
#pragma unroll
  for (int g = 0; g < kGB; ++g)
#pragma unroll
    for (int p = 0; p < kPieces; ++p)
#pragma unroll
      for (int e = 0; e < kEpl; ++e) {
        const int d = (p * kGroupLanes + j) * kEpl + e;
        qr[g][p * kEpl + e] = g < ng && d < D ? qs[g * D + d] : 0.0f;
      }
  float m[kGB], l[kGB], acc[kGB][kDims];
#pragma unroll
  for (int g = 0; g < kGB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int i = 0; i < kDims; ++i) acc[g][i] = 0.0f;
  }

  for (int w0 = warp * kWarp; w0 < C; w0 += kWarps * kWarp) {
    const bool in = w0 + lane < C;
    const unsigned ok = __ballot_sync(kFull, in && valid[row0 + w0 + lane]);
    const unsigned inm = __ballot_sync(kFull, in);
    const unsigned take = any ? ok : inm;  // slots to read
    if (!take) continue;
#pragma unroll
    for (int s0 = 0; s0 < kWarp; s0 += kSub) {
      unsigned sub = take;
      if constexpr (kSub < kWarp) sub = (take >> s0) & ((1u << (kSub % kWarp)) - 1u);
      if (!sub) continue;
      typename P::Raw kr[kU][kPieces], vr[kU][kPieces];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int slot = s0 + u * kGroups + grp;  // within the window
        const bool t = (take >> slot) & 1u;
        const size_t row = (row0 + w0 + slot) * Hkv + kvh;
#pragma unroll
        for (int p = 0; p < kPieces; ++p) {
          const int d = (p * kGroupLanes + j) * kEpl;
          // a row with no valid slot needs no K: its scores are all -1e30
          kr[u][p] = t && any && d < D ? P::load(k + row * D + d) : P::zero();
          vr[u][p] = t && d < Dv ? P::load(v + row * Dv + d) : P::zero();
        }
      }
#pragma unroll
      for (int g = 0; g < kGB; ++g) {
        if (g >= ng) continue;
        float s[kU];
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          float part = 0.0f;
#pragma unroll
          for (int p = 0; p < kPieces; ++p)
#pragma unroll
            for (int e = 0; e < kEpl; ++e)
              part = fmaf(qr[g][p * kEpl + e], P::get(kr[u][p], e), part);
          const int slot = s0 + u * kGroups + grp;
          const float sc = group_sum<kGroupLanes>(part);
          // a slot past C weighs nothing even in a row with no valid slot
          s[u] = (ok >> slot) & 1u ? sc : ((inm >> slot) & 1u ? kNegInf : -INFINITY);
          mx = fmaxf(mx, s[u]);
        }
        const float alpha = expf(m[g] - mx);
        l[g] *= alpha;
#pragma unroll
        for (int i = 0; i < kDims; ++i) acc[g][i] *= alpha;
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const float pu = expf(s[u] - mx);
          l[g] += pu;
#pragma unroll
          for (int p = 0; p < kPieces; ++p)
#pragma unroll
            for (int e = 0; e < kEpl; ++e)
              acc[g][p * kEpl + e] = fmaf(pu, P::get(vr[u][p], e), acc[g][p * kEpl + e]);
        }
        m[g] = mx;
      }
    }
  }

  // merge the warp's 4 lane groups (same dims in lanes j, j + 8, ...),
  // then the warps through shared memory
#pragma unroll
  for (int g = 0; g < kGB; ++g) {
    if (g >= ng) continue;
    float mx = m[g];
#pragma unroll
    for (int o = kGroupLanes; o < kWarp; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    const float f = expf(m[g] - mx);
    float lsum = l[g] * f;
#pragma unroll
    for (int o = kGroupLanes; o < kWarp; o <<= 1) lsum += __shfl_xor_sync(kFull, lsum, o);
    float* e0 = red + (warp * kGB + g) * (2 + Dv);
    if (lane == 0) {
      e0[0] = mx;
      e0[1] = lsum;
    }
#pragma unroll
    for (int p = 0; p < kPieces; ++p)
#pragma unroll
      for (int e = 0; e < kEpl; ++e) {
        float a = acc[g][p * kEpl + e] * f;
#pragma unroll
        for (int o = kGroupLanes; o < kWarp; o <<= 1) a += __shfl_xor_sync(kFull, a, o);
        const int d = (p * kGroupLanes + j) * kEpl + e;
        if (grp == 0 && d < Dv) e0[2 + d] = a;
      }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng * Dv; i += blockDim.x) {
    const int g = i / Dv, d = i - g * Dv;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red[(w * kGB + g) * (2 + Dv)]);
    float lsum = 0.0f, o = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float* e0 = red + (w * kGB + g) * (2 + Dv);
      const float f = expf(e0[0] - mx);
      lsum = fmaf(e0[1], f, lsum);
      o = fmaf(e0[2 + d], f, o);
    }
    out[(static_cast<size_t>(b) * H + h0 + g) * Dv + d] = from_float<T>(o / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, bool kVec, int kDims, int kGB>
int launch_variant(const void* q, const void* k, const void* v, const void* valid,
                   void* out, int B, int H, int Hkv, int C, int D, int Dv,
                   cudaStream_t stream) {
  constexpr auto kernel = &decode_attention_kernel<T, kVec, kDims, kGB>;
  const size_t smem = sizeof(float) * (kGB * D + kWarps * kGB * (2 + Dv));
  cudaError_t err = allow_smem<kernel>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = H / Hkv;
  const dim3 grid(Hkv, B, (G + kGB - 1) / kGB);
  kernel<<<grid, kWarps * kWarp, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const unsigned char*>(valid), static_cast<T*>(out), C, H, Hkv, D, Dv,
      1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

// Heads a block takes: all G of a kv head up to 8 at D, Dv <= 64 (4 at
// wider rows, whose accumulators take twice the registers).
template <typename T, bool kVec, int kDims>
int launch_dims(const void* q, const void* k, const void* v, const void* valid, void* out,
                int B, int H, int Hkv, int C, int D, int Dv, cudaStream_t stream) {
  const int G = H / Hkv;
  if (G == 1)
    return launch_variant<T, kVec, kDims, 1>(q, k, v, valid, out, B, H, Hkv, C, D, Dv,
                                             stream);
  if constexpr (kDims == 8) {
    if (G > 4)
      return launch_variant<T, kVec, kDims, 8>(q, k, v, valid, out, B, H, Hkv, C, D, Dv,
                                               stream);
  }
  return launch_variant<T, kVec, kDims, 4>(q, k, v, valid, out, B, H, Hkv, C, D, Dv,
                                           stream);
}

template <typename T, bool kVec>
int launch_vec(const void* q, const void* k, const void* v, const void* valid, void* out,
               int B, int H, int Hkv, int C, int D, int Dv, cudaStream_t stream) {
  if (D <= 64 && Dv <= 64)
    return launch_dims<T, kVec, 8>(q, k, v, valid, out, B, H, Hkv, C, D, Dv, stream);
  return launch_dims<T, kVec, 16>(q, k, v, valid, out, B, H, Hkv, C, D, Dv, stream);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid, void* out,
           int B, int H, int Hkv, int C, int D, int Dv, void* stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = (D * sizeof(T)) % 16 == 0 && (Dv * sizeof(T)) % 16 == 0 &&
                   aligned(k) && aligned(v);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec) return launch_vec<T, true>(q, k, v, valid, out, B, H, Hkv, C, D, Dv, s);
  return launch_vec<T, false>(q, k, v, valid, out, B, H, Hkv, C, D, Dv, s);
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
