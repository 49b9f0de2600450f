// topk_router: the fused softmax and top-k expert choice of an MoE layer,
// written for NVIDIA Hopper (sm_90a).  Every MoE layer of the serving
// engines' prefill and decode runs it once, over all the layer's tokens.
//
// Replaces the TPU kernel src/repro/kernels/topk_router.py:topk_router
// (its pallas_call is at topk_router.py:39).  Same function: logits (T,E)
// fp32 -> weights (T,k) fp32 and idx (T,k) int32.  The softmax over E is
// taken in fp32 (max, expf, sum, divide), then k rounds each pick the
// largest probability, record it, and mask it to -1.  A tie goes to the
// lowest expert index, as jnp.argmax gives it; the rounds compare the
// divided probabilities, as the reference does, so two logits whose
// exponentials differ but whose probabilities round to one value tie.
// Unlike the TPU kernel, which asserts T % bt == 0, any T works.
//
// What bounds it on this card: a launch.  At the prefill shape (T = 64,
// E = 64, k = 6) it reads 16 KB and writes 3 KB, about 6 ns at the HBM
// rate, with some 40 operations per logit; a launch costs far more, and
// inside it a row is a chain of dependent warp reductions.
//
// Design: one warp per token row, 8 rows per block.  Rows of up to 256
// experts stay in registers (topk_router_kernel): lane l holds entries
// 128 m + 4 l .. + 3, loaded as one 16-byte vector each where the row is
// a multiple of 4 floats and aligned.  The max is one redux.sync over
// order-preserving unsigned keys of the logits, the sum a shuffle
// reduction, expf without fast math, all without branches.  Each round
// is two redux.sync: the largest key of the probabilities (all >= 0, or
// the -1 mask), then the lowest index among the lanes that hold it; the
// weight is the float behind that key, round j's pick waits in lane j,
// and the row's picks are stored together at the end.  A row with a NaN
// (or all -inf) has only NaN probabilities; it records -inf and index E
// every round.  Wider rows go
// through shared memory, a shuffle reduction of (value, index) pairs per
// round (topk_router_wide_kernel).  Rows never share memory, so no
// block-wide barrier is needed.

#include <cmath>
#include <cstdint>

#include "attention_common.cuh"

namespace {

using attn::kFull;
using attn::kWarp;

constexpr int kRows = 8;        // token rows (warps) per block
constexpr int kRegExperts = 256;  // rows up to this width stay in registers

// A float as an unsigned key with the same order (every negative value
// below every positive one); a NaN, of either sign, as 0: below every key
// of a number, so it is never picked.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  if (isnan(v)) return 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// kVec groups of 4 entries a lane: entry e = 128 m + 4 lane + r
template <int kVec>
__global__ void __launch_bounds__(kRows * kWarp)
topk_router_kernel(const float* __restrict__ logits, float* __restrict__ weights,
                   int* __restrict__ idx, int T, int E, int k, bool vec) {
  constexpr int kPer = 4 * kVec;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int t = blockIdx.x * kRows + warp;
  if (t >= T) return;  // the whole warp leaves; rows share nothing
  const float* x = logits + static_cast<size_t>(t) * E;

  float p[kPer];
#pragma unroll
  for (int m = 0; m < kVec; ++m) {
    const int e0 = 128 * m + 4 * lane;
    if (vec && e0 < E) {  // E % 4 == 0: the whole group is in the row
      const float4 v = __ldg(reinterpret_cast<const float4*>(x + e0));
      p[4 * m] = v.x;
      p[4 * m + 1] = v.y;
      p[4 * m + 2] = v.z;
      p[4 * m + 3] = v.w;
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) p[4 * m + r] = e0 + r < E ? x[e0 + r] : -INFINITY;
    }
  }
  const auto entry = [&](int i) { return 128 * (i / 4) + 4 * lane + i % 4; };

  unsigned kmax = 0u;
#pragma unroll
  for (int i = 0; i < kPer; ++i) kmax = max(kmax, entry(i) < E ? order_key(p[i]) : 0u);
  // a NaN logit leaves the max to the others; its own exp is NaN, and so
  // is the sum, so every probability of the row is NaN.  Entries past the
  // row hold -inf: exp gives them 0 (or NaN where the row is NaN anyway).
  const float mx = from_key(__reduce_max_sync(kFull, kmax));
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    p[i] = expf(p[i] - mx);
    s += p[i];
  }
  s = attn::warp_sum(s);
  unsigned key[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) key[i] = entry(i) < E ? order_key(p[i] / s) : 0u;

  // round j's pick stays in lane j % 32 until its group of 32 rounds is stored
  float w_out = 0.0f;
  int i_out = 0;
  for (int j = 0; j < k; ++j) {
    unsigned best = 0u;
#pragma unroll
    for (int i = 0; i < kPer; ++i) best = max(best, key[i]);
    best = __reduce_max_sync(kFull, best);
    // a lane's entries rise in index: its first holder of `best` is its lowest
    int cand = E;
#pragma unroll
    for (int i = kPer - 1; i >= 0; --i)
      if (best != 0u && key[i] == best) cand = entry(i);
    const int win = __reduce_min_sync(kFull, cand);
    // the winner's probability is the float behind its key; a row of NaN
    // probabilities has none to pick (key 0): -inf and index E
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if (best != 0u && entry(i) == win) key[i] = order_key(-1.0f);  // masked
    if (lane == (j & (kWarp - 1))) {
      w_out = best == 0u ? -INFINITY : from_key(best);
      i_out = win;
    }
    if ((j & (kWarp - 1)) == kWarp - 1 || j == k - 1) {
      const int base = j & ~(kWarp - 1);
      if (lane <= j - base) {
        weights[static_cast<size_t>(t) * k + base + lane] = w_out;
        idx[static_cast<size_t>(t) * k + base + lane] = i_out;
      }
    }
  }
}

// Rows wider than kRegExperts: through shared memory, E floats a warp.
__global__ void __launch_bounds__(kRows * kWarp)
topk_router_wide_kernel(const float* __restrict__ logits, float* __restrict__ weights,
                        int* __restrict__ idx, int T, int E, int k) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int t = blockIdx.x * kRows + warp;
  if (t >= T) return;  // the whole warp leaves; rows share nothing
  float* p = smem + static_cast<size_t>(warp) * E;
  const float* x = logits + static_cast<size_t>(t) * E;

  float m = -INFINITY;
  for (int e = lane; e < E; e += kWarp) {
    p[e] = x[e];
    m = fmaxf(m, p[e]);
  }
  m = attn::warp_max(m);
  float s = 0.0f;
  for (int e = lane; e < E; e += kWarp) {
    p[e] = expf(p[e] - m);
    s += p[e];
  }
  s = attn::warp_sum(s);
  for (int e = lane; e < E; e += kWarp) p[e] = p[e] / s;

  for (int j = 0; j < k; ++j) {
    // a lane's entries rise in index, so a strict > keeps the lowest
    float best = -INFINITY;
    int arg = E;
    for (int e = lane; e < E; e += kWarp)
      if (p[e] > best) {
        best = p[e];
        arg = e;
      }
#pragma unroll
    for (int o = kWarp / 2; o; o >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, o);
      const int oa = __shfl_xor_sync(kFull, arg, o);
      if (ob > best || (ob == best && oa < arg)) {
        best = ob;
        arg = oa;
      }
    }
    if (lane == 0) {
      weights[static_cast<size_t>(t) * k + j] = best;
      idx[static_cast<size_t>(t) * k + j] = arg;
    }
    // the owner masks the winner (arg == E only for a row of NaNs)
    if (arg < E && arg % kWarp == lane) p[arg] = -1.0f;
    __syncwarp();
  }
}

// An empty kernel launched as the router is, for the launch floor that
// chip_smoke.py times beside it.
__global__ void __launch_bounds__(kRows * kWarp) topk_router_floor_kernel() {}

}  // namespace

// Launch on `stream`; return cudaGetLastError() (0 when accepted).  The
// caller checks shapes: T >= 1, 1 <= k <= E, E small enough that 8 rows of
// E floats fit in shared memory.
extern "C" int topk_router_f32(const void* logits, void* weights, void* idx, int T,
                               int E, int k, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int blocks = (T + kRows - 1) / kRows;
  const auto* x = static_cast<const float*>(logits);
  auto* w = static_cast<float*>(weights);
  auto* i = static_cast<int*>(idx);
  if (E <= kRegExperts) {
    const bool vec = E % 4 == 0 && reinterpret_cast<uintptr_t>(logits) % 16 == 0;
    if (E <= 128)
      topk_router_kernel<1><<<blocks, kRows * kWarp, 0, s>>>(x, w, i, T, E, k, vec);
    else
      topk_router_kernel<2><<<blocks, kRows * kWarp, 0, s>>>(x, w, i, T, E, k, vec);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = sizeof(float) * kRows * static_cast<size_t>(E);
  const cudaError_t err = attn::allow_smem<&topk_router_wide_kernel>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_router_wide_kernel<<<blocks, kRows * kWarp, smem, s>>>(x, w, i, T, E, k);
  return static_cast<int>(cudaGetLastError());
}

// The empty kernel on the router's grid for T rows.
extern "C" int topk_router_floor(int T, void* stream) {
  topk_router_floor_kernel<<<(T + kRows - 1) / kRows, kRows * kWarp, 0,
                             static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
