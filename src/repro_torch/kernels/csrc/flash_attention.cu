// flash_attention: causal (optionally sliding-window) softmax attention
// with an online softmax, written for NVIDIA Hopper (sm_90a).  The
// prefill of both LM serving engines runs it, once per layer.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (its pallas_call is at flash_attention.py:84).  Same
// function: q (BH,T,D), k/v (BHkv,T,D|Dv) -> (BH,T,Dv) in q's dtype,
// scale 1/sqrt(D), window <= 0 meaning no window.  GQA: the kernel maps
// query row bh to kv row bh / G (G = BH / BHkv) through its offsets, so
// callers pass the kv heads once instead of repeating them G times; with
// BHkv = BH it is the JAX signature.  Unlike the TPU kernel, which
// asserts T % block == 0, any T works: rows and keys past T are masked.
//
// What bounds it on this card: at the serving shape (BH = 32, T = 64,
// D = 64, bf16) one call moves 1.0 MB (q, k, v in, out back) and does
// 17 MFLOP of causal QK^T and PV: 0.31 us at the HBM rate, 0.02 us at
// the bf16 tensor-core rate, so bytes bound it, and a launch costs more
// than either.  At the MLA prefill shape (deepseek-v2-lite: BH = 16,
// T = 64, D = 192, Dv = 128) it moves 1.3 MB and does 21 MFLOP: 0.39 us
// by bytes.
//
// Design (simple and right first, no tensor cores): one block of 4 warps
// per (bh, 32-row query tile).  The query tile, pre-scaled, sits in
// shared memory in fp32; 32-key tiles of K (rows padded to D + 1 floats,
// so lane j reads key j without bank conflicts) and V are staged through
// shared memory by the whole block.  Each warp owns 8 query rows and
// keeps their running max, sum and output (lane i holds dims i, i + 32,
// ...) in registers; lane j scores key j of the tile, the warp reduces
// max and sum with shuffles, and the PV product broadcasts each weight
// with a shuffle.  Key tiles wholly above the diagonal (causal) or
// wholly outside the window are skipped.  fp32 throughout, expf without
// fast math.  Only Dv sits in registers (kDimChunks accumulators a lane),
// so Dv <= 128; D is only looped over in shared memory and may reach 256
// (MLA prefill scores over nope + rope = 192 dims with Dv = 128: a
// 65.6 KB tile, past the 48 KB default, granted by allow_smem).

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int kRowsPerWarp = 8;
constexpr int kWarps = 4;
constexpr int kBlockRows = kRowsPerWarp * kWarps;  // query rows per block
constexpr int kKeys = kWarp;                        // keys per tile

template <typename T>
__global__ void __launch_bounds__(kWarps * kWarp)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int G, int T_,
                       int D, int Dv, int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                          // (kBlockRows, D), pre-scaled
  float* ks = qs + kBlockRows * D;           // (kKeys, D + 1)
  float* vs = ks + kKeys * (D + 1);          // (kKeys, Dv)
  const int bh = blockIdx.x;
  const int kvh = bh / G;
  const int q0 = blockIdx.y * kBlockRows;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const T* qb = q + static_cast<size_t>(bh) * T_ * D;
  const T* kb = k + static_cast<size_t>(kvh) * T_ * D;
  const T* vb = v + static_cast<size_t>(kvh) * T_ * Dv;

  for (int i = threadIdx.x; i < kBlockRows * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    qs[i] = q0 + r < T_ ? to_float(qb[static_cast<size_t>(q0 + r) * D + d]) * scale
                        : 0.0f;
  }

  RowState st[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) st[i].init();

  // keys any row of this tile can see: [k_lo, k_hi)
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(T_, q0 + kBlockRows) : T_;
  for (int kt = (k_lo / kKeys) * kKeys; kt < k_hi; kt += kKeys) {
    __syncthreads();  // previous tile fully used (and qs written)
    for (int i = threadIdx.x; i < kKeys * D; i += blockDim.x) {
      const int j = i / D, d = i - j * D;
      ks[j * (D + 1) + d] =
          kt + j < T_ ? to_float(kb[static_cast<size_t>(kt + j) * D + d]) : 0.0f;
    }
    for (int i = threadIdx.x; i < kKeys * Dv; i += blockDim.x) {
      const int j = i / Dv, d = i - j * Dv;
      vs[i] = kt + j < T_ ? to_float(vb[static_cast<size_t>(kt + j) * Dv + d]) : 0.0f;
    }
    __syncthreads();
    const int kpos = kt + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      const int qpos = q0 + r;
      if (qpos >= T_) continue;  // uniform across the warp
      const int dist = qpos - kpos;
      const bool ok = kpos < T_ && (!causal || dist >= 0) &&
                      (window <= 0 || dist < window);
      fold_chunk(st[i], qs + r * D, ks, vs, D, Dv, 1.0f, 0.0f, ok, lane);
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qpos = q0 + warp * kRowsPerWarp + i;
    if (qpos >= T_) continue;
    const float inv = 1.0f / fmaxf(st[i].l, 1e-30f);
    T* o = out + (static_cast<size_t>(bh) * T_ + qpos) * Dv;
#pragma unroll
    for (int c = 0; c < kDimChunks; ++c) {
      const int d = lane + c * kWarp;
      if (d < Dv) o[d] = from_float<T>(st[i].acc[c] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int BHkv,
           int T_, int D, int Dv, int causal, int window, void* stream) {
  const size_t smem =
      sizeof(float) * (kBlockRows * D + kKeys * (D + 1) + kKeys * Dv);
  cudaError_t err = allow_smem<&flash_attention_kernel<T>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (T_ + kBlockRows - 1) / kBlockRows);
  flash_attention_kernel<T><<<grid, kWarps * kWarp, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), BH / BHkv, T_, D, Dv, causal, window,
      1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; return cudaGetLastError() (0 when accepted).  The
// caller checks shapes: BHkv divides BH, T >= 1, D in 1..256, Dv in 1..128,
// window 0 (none) or in 1..T-1.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* out, int BH, int BHkv, int T, int D, int Dv,
                                   int causal, int window, void* stream) {
  return launch<float>(q, k, v, out, BH, BHkv, T, D, Dv, causal, window, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* out, int BH, int BHkv, int T, int D, int Dv,
                                    int causal, int window, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, BH, BHkv, T, D, Dv, causal, window,
                               stream);
}
