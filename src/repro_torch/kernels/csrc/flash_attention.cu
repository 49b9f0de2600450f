// flash_attention: causal (optionally sliding-window) softmax attention
// with an online softmax, written for NVIDIA Hopper (sm_90a).  The
// prefill of both LM serving engines and the hybrid's full-sequence
// forward run it, once per layer (or shared block).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (its pallas_call is at flash_attention.py:84).  Same
// function: q (BH,T,D), k/v (BHkv,T,D|Dv) -> (BH,T,Dv) in q's dtype,
// scale 1/sqrt(D), window <= 0 meaning no window.  GQA: the kernel maps
// query row bh to kv row bh / G (G = BH / BHkv) through its offsets, so
// callers pass the kv heads once instead of repeating them G times; with
// BHkv = BH it is the JAX signature.  Unlike the TPU kernel, which
// asserts T % block == 0, any T works: rows and keys past T are masked.
// Without the causal mask the keys may have a length of their own, Tk
// (k/v (BHkv,Tk,D|Dv), key j at position j): whisper's decoder
// cross-attends from its S tokens to the encoder's 1500 frames, and its
// encoder attends over the 1500 frames without the mask (1500 is no
// multiple of the 64-row tiles, so both tails are cut there).
//
// What bounds it on this card: at the stablelm prefill shape (BH = 32,
// T = 64, D = 64, bf16) one call moves 1.0 MB (q, k, v in, out back) and
// does 17 MFLOP of causal QK^T and PV: 0.31 us at the HBM rate, 0.02 us
// at the bf16 tensor-core rate, so bytes bound it, and a launch costs
// more than either.  At the MLA prefill shape (deepseek-v2-lite: BH = 16,
// T = 64, D = 192, Dv = 128) it moves 1.3 MB: 0.39 us by bytes.  At
// gemma3's long prefill (BH = 4, BHkv = 1, T = 1024, D = Dv = 256) it
// moves 5.2 MB (1.6 us) and does 1.6 GFLOP in a local layer's 512-key
// window, 2.2 GFLOP in a global layer (1.6 and 2.2 us on the tensor
// cores): both bounds are near.  At the
// zamba2 forward's shape (BH = 64, T = 1024, D = 64) it moves 33.6 MB
// (10.0 us) and does 8.6 GFLOP (8.7 us on the tensor cores): both
// bounds are near, and only the tensor cores keep the products under
// the bytes.
//
// bf16 entry (every serving path) -- wgmma on the tensor cores, tiles
// loaded asynchronously.  One warpgroup (4 warps, 16 query rows each)
// per (bh, 64-row query tile), the last (longest) query tiles launched
// first.  Q and the K/V tiles sit in shared memory in bf16 as stored, in
// the 128-byte swizzle that wgmma reads (64-column blocks of 64 rows x
// 128 bytes, 16-byte pieces permuted by XOR with the row, tiles on 1 KB
// boundaries).  K/V come in 64-key tiles through a 2-stage ring filled
// by cp.async.cg 16-byte copies (rows past T zero-filled by the copy
// itself; a thread's pieces step through the tile without an integer
// division each), so tile j + 1 loads while tile j computes.  S = Q.K^T
// is wgmma m64n64k16 with both operands from shared memory (K-major
// descriptors), fp32 accumulators in registers; the online softmax runs
// on the S fragment in registers (row max and sum over the 4 lanes that
// share a row, the scale folded into ex2.approx's argument); P, rounded
// to bf16 in registers, is the register A operand of O += P.V, wgmma
// m64n{64,128}k16 with V read MN-major through its descriptor.  The
// rounding of P adds ~2^-9 relative error per weight, well inside
// bf16's 3e-2.  Key tiles wholly above the diagonal or outside the
// window are never loaded, and only tiles that the diagonal, the window
// edge or T cuts are masked.  D and Dv are zero-padded (D to a multiple
// of 16, Dv to 64, 128 or 256) in shared memory (D, Dv <= 256; MLA
// prefill's D 192 / Dv 128 takes 105 KB, gemma3's D = Dv = 256 161 KB,
// granted by allow_smem).  At Dv 256 the O accumulator is 64 x 256 fp32
// a warpgroup, 128 registers a thread, and P.V is two m64n128k16
// products a 16-key step, one a half of V's columns; rows
// whose bytes are no multiple of 16 load element by element (a
// compile-time variant).  It beats an mma.sync m16n8k16 / ldmatrix
// kernel at every shape tried (PERF.md); at T 1024 it is still about
// 1.8x slower than PyTorch's SDPA: a warpgroup runs its S product,
// softmax and P.V product in sequence, and four warpgroups an SM (124
// registers) do not hide that.  Of the variants
// timed against it (PERF.md), issuing the next tile's S during the
// softmax (150 registers, 3 warpgroups an SM) and 128-key tiles were
// slower at T 1024, and two warpgroups a block sharing K/V were 2%
// faster there but up to 60% slower on small grids.
//
// fp32 entry (the fp32 parity cuts and sweeps only) -- CUDA cores,
// because the tensor cores would multiply fp32 in TF32
// (10-bit mantissa), which cannot hold the fp32 tolerance of 3e-5.  One
// block of 4 warps per (bh, 32-row query tile); the pre-scaled query
// tile and 32-key tiles of K (rows padded to D + 1 floats, so lane j
// reads key j without bank conflicts) and V are staged through shared
// memory in fp32; each warp owns 8 query rows, lane j scores key j of
// the tile, and the PV product broadcasts each weight with a shuffle.
// Only Dv sits in registers (kChunks accumulators a lane: 4 up to Dv
// 128, 8 up to 256); D is only looped over in shared memory and may
// reach 256 (MLA prefill: a 65.6 KB tile, gemma3's D = Dv = 256 98 KB,
// past the 48 KB default, granted by allow_smem).  expf without fast
// math.

#include <cstdint>

#include "attention_common.cuh"

namespace {

using namespace attn;

// ---------------------------------------------------------------------------
// fp32 entry: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kRowsPerWarp = 8;
constexpr int kWarps = 4;
constexpr int kBlockRows = kRowsPerWarp * kWarps;  // query rows per block
constexpr int kKeys = kWarp;                        // keys per tile

template <typename T, int kChunks>
__global__ void __launch_bounds__(kWarps * kWarp)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int G, int T_,
                       int Tk, int D, int Dv, int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                          // (kBlockRows, D), pre-scaled
  float* ks = qs + kBlockRows * D;           // (kKeys, D + 1)
  float* vs = ks + kKeys * (D + 1);          // (kKeys, Dv)
  const int bh = blockIdx.x;
  const int kvh = bh / G;
  const int q0 = blockIdx.y * kBlockRows;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const T* qb = q + static_cast<size_t>(bh) * T_ * D;
  const T* kb = k + static_cast<size_t>(kvh) * Tk * D;
  const T* vb = v + static_cast<size_t>(kvh) * Tk * Dv;

  for (int i = threadIdx.x; i < kBlockRows * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    qs[i] = q0 + r < T_ ? to_float(qb[static_cast<size_t>(q0 + r) * D + d]) * scale
                        : 0.0f;
  }

  RowState<kChunks> st[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) st[i].init();

  // keys any row of this tile can see: [k_lo, k_hi)
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Tk, q0 + kBlockRows) : Tk;
  for (int kt = (k_lo / kKeys) * kKeys; kt < k_hi; kt += kKeys) {
    __syncthreads();  // previous tile fully used (and qs written)
    for (int i = threadIdx.x; i < kKeys * D; i += blockDim.x) {
      const int j = i / D, d = i - j * D;
      ks[j * (D + 1) + d] =
          kt + j < Tk ? to_float(kb[static_cast<size_t>(kt + j) * D + d]) : 0.0f;
    }
    for (int i = threadIdx.x; i < kKeys * Dv; i += blockDim.x) {
      const int j = i / Dv, d = i - j * Dv;
      vs[i] = kt + j < Tk ? to_float(vb[static_cast<size_t>(kt + j) * Dv + d]) : 0.0f;
    }
    __syncthreads();
    const int kpos = kt + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      const int qpos = q0 + r;
      if (qpos >= T_) continue;  // uniform across the warp
      const int dist = qpos - kpos;
      const bool ok = kpos < Tk && (!causal || dist >= 0) &&
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
    for (int c = 0; c < kChunks; ++c) {
      const int d = lane + c * kWarp;
      if (d < Dv) o[d] = from_float<T>(st[i].acc[c] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 entry: tensor cores (wgmma)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;          // query rows per block, keys per K/V tile
constexpr int kGroup = 4 * kWarp;  // one warpgroup: 16 query rows a warp
constexpr int kSwz = 128;          // bytes of a swizzled row (64 bf16)
constexpr int kBlk = kTile * kSwz; // one 64-column block of a 64-row tile
constexpr int kStages = 2;         // K/V tiles in the ring

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; `fill` false writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(fill ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Byte offset of element (r, c) of a 64-row tile in the 128-byte swizzle
// that wgmma reads: 64-column blocks one after another, each 64 rows of
// 128 bytes whose 16-byte pieces are permuted by XOR with r % 8.  The
// tile must start on a 1024-byte boundary.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c / 64) * kBlk + r * kSwz + ((((c % 64) / 8) ^ (r % 8)) << 4) + (c % 8) * 2;
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 | static_cast<uint64_t>(sbo >> 4) << 32 |
         1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// floats [kOff, kOff + 64) of a thread's accumulator: the accumulator of
// an m64n128 product over 128 of its columns (4 floats a group of 8
// columns, so floats 64.. hold columns 128..)
template <int kOff, int N>
__device__ __forceinline__ float (&acc_slice(float (&d)[N]))[64] {
  static_assert(kOff % 64 == 0 && kOff + 64 <= N, "a whole 64-float slice");
  return *reinterpret_cast<float(*)[64]>(d + kOff);
}

// keep the compiler from moving accesses to an accumulator across the
// asynchronous products that write it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, fp32, in registers) (+)= A . B over k 16: SS takes A from
// shared memory (K-major), RS from registers (the mma.m16n8k16 A
// fragment of each warp's 16 rows); B is read through its descriptor.
// `accumulate` 0 overwrites D.
#define ACC8(i)                                                             \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
#undef ACC8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

__host__ __device__ __forceinline__ int round16(int x) { return (x + 15) / 16 * 16; }

// Rows [row0, row0 + kTile) of a (T, W) matrix into the swizzled tile at
// shared address `dst`; rows past T are zeros, columns past W untouched.
// A thread's 16-byte pieces are tid, tid + blockDim, ...: their (row,
// piece) steps are divided out once a call, not once a piece.
template <bool kVec>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, int row0, int T_,
                                          int W) {
  if constexpr (kVec) {
    const int per_row = W / 8;
    int r = threadIdx.x / per_row, c = threadIdx.x - r * per_row;
    const int dr = blockDim.x / per_row, dc = blockDim.x - dr * per_row;
    for (int i = threadIdx.x; i < kTile * per_row; i += blockDim.x) {
      const bool in = row0 + r < T_;
      const bf16* from = src + static_cast<size_t>(in ? row0 + r : 0) * W + c * 8;
      cp_async16(dst + swz(r, c * 8), from, in);
      r += dr;
      c += dc;
      if (c >= per_row) {
        c -= per_row;
        ++r;
      }
    }
  } else {
    for (int i = threadIdx.x; i < kTile * W; i += blockDim.x) {
      const int r = i / W, c = i - r * W;
      const bf16 x = row0 + r < T_ ? src[static_cast<size_t>(row0 + r) * W + c]
                                   : __float2bfloat16(0.0f);
      asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(dst + swz(r, c)),
                   "h"(*reinterpret_cast<const unsigned short*>(&x)));
    }
  }
}

// zero columns [c0, c1) of the 64-row tiles at `dst` (`tiles` of them,
// `stride` bytes apart)
__device__ __forceinline__ void zero_cols(uint32_t dst, int tiles, int stride, int c0,
                                          int c1) {
  const int w = c1 - c0;
  for (int i = threadIdx.x; i < tiles * kTile * w; i += blockDim.x) {
    const int r = i / w, c = c0 + i - r * w;
    asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(dst + (r / kTile) * stride +
                                                     swz(r % kTile, c)),
                 "h"(static_cast<unsigned short>(0)));
  }
}

__device__ __forceinline__ float fast_exp2(float x) {  // 2 ulp; exp2(-1e30) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// kNo: O's width in the P.V product (64: Dv <= 64, 128: Dv <= 128, 256:
// Dv <= 256);
// kVec: rows of q, k and v are whole 16-byte pieces.
template <int kNo, bool kVec>
__global__ void __launch_bounds__(kGroup)
flash_attention_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, bf16* __restrict__ out, int G,
                             int T_, int Tk, int D, int Dv, int causal, int window,
                             float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Dp = round16(D);
  const int q_bytes = (Dp + 63) / 64 * kBlk;  // one Q or K tile
  constexpr int v_bytes = kNo / 64 * kBlk;    // one V tile
  // tiles start on a 1024-byte boundary, as the swizzle needs
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t qs = base, ks = qs + q_bytes, vs = ks + kStages * q_bytes;
  const int bh = blockIdx.x, kvh = bh / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // longest tiles first
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const bf16* qb = q + static_cast<size_t>(bh) * T_ * D;
  const bf16* kb = k + static_cast<size_t>(kvh) * Tk * D;
  const bf16* vb = v + static_cast<size_t>(kvh) * Tk * Dv;

  // zero the padding columns [D, Dp) of Q and K and [Dv, kNo) of V once;
  // copies never write them
  if (Dp > D) zero_cols(qs, 1 + kStages, q_bytes, D, Dp);
  if (kNo > Dv) zero_cols(vs, kStages, v_bytes, Dv, kNo);

  // keys any row of the block can see: [k_lo, k_hi), in whole tiles
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Tk, q0 + kTile) : Tk;
  const int t_first = k_lo / kTile, t_end = (k_hi + kTile - 1) / kTile;
  const auto load_kv = [&](int t) {
    const int stage = (t - t_first) % kStages;
    load_tile<kVec>(ks + stage * q_bytes, kb, t * kTile, Tk, D);
    load_tile<kVec>(vs + stage * v_bytes, vb, t * kTile, Tk, Dv);
  };

  load_tile<kVec>(qs, qb, q0, T_, D);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {  // one commit group per tile, empty or not
    if (t_first + i < t_end) load_kv(t_first + i);
    cp_async_commit();
  }

  // this lane's rows of the S and O fragments: r_a and r_a + 8; m is in
  // raw score units, the scale is applied inside the exponent
  const int r_w = q0 + warp * 16;
  const int r_a = r_w + lane / 4;
  const int c_l = 2 * (lane % 4);  // first of the lane's two columns in an 8-key tile
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float o[kNo / 2];
#pragma unroll
  for (int i = 0; i < kNo / 2; ++i) o[i] = 0.0f;
  float s[32];

  for (int t = t_first; t < t_end; ++t) {
    // tile t + kStages - 1 loads while tile t computes
    if (t + kStages - 1 < t_end) load_kv(t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    // this thread's copies and stores, then everyone's, visible to wgmma
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    const int kt = t * kTile;
    const int stage = (t - t_first) % kStages;
    // S = Q . K^T over D in steps of 16 (K-major, both from shared memory)
    const uint32_t kst = ks + stage * q_bytes;
    wgmma_fence();
    for (int d0 = 0; d0 < Dp; d0 += 16) {
      const uint32_t off = (d0 / 64) * kBlk + (d0 % 64) * 2;
      wgmma_ss_n64(s, sw128_desc(qs + off, 16, 1024), sw128_desc(kst + off, 16, 1024), d0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    // online softmax on the fragment; s[n * 4 + e] is row r_a + (e / 2)
    // * 8, key n * 8 + c_l + e % 2 of the tile
    const bool need_mask = kt + kTile > Tk || (causal && kt + kTile - 1 > r_w) ||
                           (window > 0 && r_w + 15 - kt >= window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (need_mask) {
          const int r = r_a + (e / 2) * 8, c = kt + n * 8 + c_l + (e % 2);
          const bool ok = c < Tk && (!causal || r >= c) && (window <= 0 || r - c < window);
          s[n * 4 + e] = ok ? s[n * 4 + e] : kNegInf;
        }
        mx[e / 2] = fmaxf(mx[e / 2], s[n * 4 + e]);
      }
    float alpha[2], ms[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
      alpha[h] = fast_exp2((m[h] - mx[h]) * scale_log2);
      m[h] = mx[h];
      // a row that has seen only masked keys weighs them 0: mx * scale
      // would round, and the exponent of a masked score minus it need
      // not be exactly 0
      ms[h] = mx[h] == kNegInf ? 0.0f : mx[h] * scale_log2;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < kNo / 2; ++i) o[i] *= alpha[(i / 2) % 2];
    uint32_t p[4][4];  // P as the A operand, one 16-key step each
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float pe[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pe[e] = fast_exp2(fmaf(s[n * 4 + e], scale_log2, -ms[e / 2]));
      l[0] += pe[0] + pe[1];
      l[1] += pe[2] + pe[3];
      p[n / 2][(n % 2) * 2] = pack_bf16(pe[0], pe[1]);
      p[n / 2][(n % 2) * 2 + 1] = pack_bf16(pe[2], pe[3]);
    }

    // O += P . V over the tile's 64 keys in steps of 16 (V is MN-major:
    // 64-column blocks 8 KB apart, 8-key groups 1 KB apart)
    const uint32_t vst = vs + stage * v_bytes;
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t b = sw128_desc(vst + kk * 16 * kSwz, kBlk, 1024);
      if constexpr (kNo == 64) {
        wgmma_rs_n64(o, p[kk], b, 1);
      } else if constexpr (kNo == 128) {
        wgmma_rs_n128(o, p[kk], b, 1);
      } else {  // columns 128..255 start two 64-column blocks later
        wgmma_rs_n128(acc_slice<0>(o), p[kk], b, 1);
        wgmma_rs_n128(acc_slice<64>(o), p[kk],
                      sw128_desc(vst + 2 * kBlk + kk * 16 * kSwz, kBlk, 1024), 1);
      }
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(o);
    __syncthreads();  // tile t fully read before its stage is refilled
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_a + h * 8;
    if (r >= T_) continue;
    const float inv = 1.0f / fmaxf(l[h], 1e-30f);
    bf16* orow = out + (static_cast<size_t>(bh) * T_ + r) * Dv;
#pragma unroll
    for (int n = 0; n < kNo / 8; ++n) {
      const int c = n * 8 + c_l;
      if (c < Dv) orow[c] = __float2bfloat16(o[n * 4 + 2 * h] * inv);
      if (c + 1 < Dv) orow[c + 1] = __float2bfloat16(o[n * 4 + 2 * h + 1] * inv);
    }
  }
}

template <int kNo, bool kVec>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, int BH, int BHkv,
                 int T_, int Tk, int D, int Dv, int causal, int window,
                 cudaStream_t stream) {
  constexpr auto kernel = &flash_attention_wgmma_kernel<kNo, kVec>;
  // the Q tile, the K/V ring, and up to 1 KB to align the first tile
  const size_t smem = (1 + kStages) * ((round16(D) + 63) / 64 * kBlk) +
                      kStages * (kNo / 64 * kBlk) + 1024;
  cudaError_t err = allow_smem<kernel>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (T_ + kTile - 1) / kTile);
  kernel<<<grid, kGroup, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), BH / BHkv, T_, Tk, D, Dv, causal, window,
      1.4426950408889634f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int BH, int BHkv,
                int T_, int Tk, int D, int Dv, int causal, int window,
                cudaStream_t stream) {
  if (Dv <= 64)
    return launch_wgmma<64, kVec>(q, k, v, out, BH, BHkv, T_, Tk, D, Dv, causal, window,
                                  stream);
  if (Dv <= 128)
    return launch_wgmma<128, kVec>(q, k, v, out, BH, BHkv, T_, Tk, D, Dv, causal, window,
                                   stream);
  return launch_wgmma<256, kVec>(q, k, v, out, BH, BHkv, T_, Tk, D, Dv, causal, window,
                                 stream);
}

template <int kChunks>
int launch_f32(const void* q, const void* k, const void* v, void* out, int BH, int BHkv,
               int T_, int Tk, int D, int Dv, int causal, int window, void* stream) {
  using T = float;
  constexpr auto kernel = &flash_attention_kernel<T, kChunks>;
  const size_t smem =
      sizeof(float) * (kBlockRows * D + kKeys * (D + 1) + kKeys * Dv);
  cudaError_t err = allow_smem<kernel>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (T_ + kBlockRows - 1) / kBlockRows);
  kernel<<<grid, kWarps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), BH / BHkv, T_, Tk, D, Dv, causal, window,
      1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; return cudaGetLastError() (0 when accepted).  The
// caller checks shapes: BHkv divides BH, T >= 1, Tk >= 1 (Tk = T when
// causal), D and Dv in 1..256, window 0 (none) or in 1..T-1.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* out, int BH, int BHkv, int T, int Tk, int D,
                                   int Dv, int causal, int window, void* stream) {
  if (Dv <= 4 * kWarp)
    return launch_f32<4>(q, k, v, out, BH, BHkv, T, Tk, D, Dv, causal, window, stream);
  return launch_f32<8>(q, k, v, out, BH, BHkv, T, Tk, D, Dv, causal, window, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* out, int BH, int BHkv, int T, int Tk, int D,
                                    int Dv, int causal, int window, void* stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = D % 8 == 0 && Dv % 8 == 0 && aligned(q) && aligned(k) && aligned(v);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec) return launch_bf16<true>(q, k, v, out, BH, BHkv, T, Tk, D, Dv, causal, window, s);
  return launch_bf16<false>(q, k, v, out, BH, BHkv, T, Tk, D, Dv, causal, window, s);
}
