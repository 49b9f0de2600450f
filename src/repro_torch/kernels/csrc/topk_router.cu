// topk_router: the fused softmax and top-k expert choice of an MoE layer,
// written for NVIDIA Hopper (sm_90a).  Every MoE layer of the serving
// engines' prefill and decode runs it once, over all the layer's tokens.
//
// Replaces the TPU kernel src/repro/kernels/topk_router.py:topk_router
// (its pallas_call is at topk_router.py:39).  Same function: logits (T,E)
// fp32 -> weights (T,k) fp32 and idx (T,k) int32.  The softmax over E is
// taken in fp32 (max, expf, sum, divide), then k rounds each pick the
// largest probability, record it, and mask it to -1.  A tie goes to the
// lowest expert index, as jnp.argmax gives it.  Unlike the TPU kernel,
// which asserts T % bt == 0, any T works.
//
// What bounds it on this card: a launch.  At the prefill shape (T = 64,
// E = 64, k = 6) it reads 16 KB and writes 3 KB, about 6 ns at the HBM
// rate, with some 40 operations per logit; a launch costs far more.
//
// Design (simple and right first): one warp per token row, 8 rows per
// block.  The warp copies its row into shared memory, lane i owning
// entries i, i + 32, ...; max and sum are warp shuffles, expf without
// fast math.  Each round, every lane scans its own entries for the best
// (value, lowest index), a shuffle reduction orders pairs by value and
// then by lower index, and the owning lane masks the winner.  Rows never
// share memory, so no block-wide barrier is needed.

#include <cmath>

#include "attention_common.cuh"

namespace {

using attn::kFull;
using attn::kWarp;

constexpr int kRows = 8;  // token rows (warps) per block

__global__ void __launch_bounds__(kRows * kWarp)
topk_router_kernel(const float* __restrict__ logits, float* __restrict__ weights,
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

}  // namespace

// Launch on `stream`; return cudaGetLastError() (0 when accepted).  The
// caller checks shapes: T >= 1, 1 <= k <= E, E small enough that 8 rows of
// E floats fit in shared memory.
extern "C" int topk_router_f32(const void* logits, void* weights, void* idx, int T,
                               int E, int k, void* stream) {
  const size_t smem = sizeof(float) * kRows * static_cast<size_t>(E);
  const cudaError_t err = attn::allow_smem<&topk_router_kernel>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_router_kernel<<<(T + kRows - 1) / kRows, kRows * kWarp, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<float*>(weights),
      static_cast<int*>(idx), T, E, k);
  return static_cast<int>(cudaGetLastError());
}
