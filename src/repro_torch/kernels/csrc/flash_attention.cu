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
// bf16 entry, TMA instance (every main path: rows of whole 16-byte
// pieces, 16-byte aligned) -- a producer warp and two consumer warpgroups
// a block.  Warpgroup 0 gives up its registers (setmaxnreg 24) and one of
// its threads loads, by TMA, Q once and each 64-key K and V tile into
// rings of up to 4 stages (2 at D = Dv = 256; a full and an empty
// mbarrier a stage; K, V and Q as 3-D maps (D, rows, heads) built on the
// host per launch, so a box past Tk reads zeros and never the next head).
// TMA lands the tiles in the 128-byte swizzle the wgmma descriptors read
// (64-column boxes of 64 rows x 128 bytes, 16-byte pieces permuted by XOR
// with the row, tiles on 1 KB boundaries); columns past D or Dv come back
// as zeros.  Warpgroups 1 and 2 (setmaxnreg 240, or 104 at two blocks an
// SM) each own 64 query rows and share every K/V tile: under GQA with G
// even, the same rows of two query heads of one kv head (half the K/V
// reads of two blocks); else two row tiles of one head, 128 rows.  A
// consumer's tile step: S = Q.K^T as wgmma m64n64k16 from shared memory
// (fp32 in registers), the online softmax on the fragment (row max and
// sum over the 4 lanes that share a row, the scale folded into
// ex2.approx's argument, masks only on tiles the diagonal, the window
// edge or Tk cuts, a row with no visible key yet weighing masked keys 0),
// P rounded to bf16 as the register A operand of O += P.V (m64n{64,128}
// k16, V MN-major; Dv 256 = two m64n128 a 16-key step).  Each consumer
// warp releases a stage as soon as its products have read it; the main
// loop has no __syncthreads.  At one block an SM the two consumers take
// turns issuing their products (named barriers 1 and 2), so one's softmax
// runs under the other's products; at Dv <= 64 (D <= 128) two blocks fit
// an SM and the four consumers interleave without turns.
//
// Where those blocks leave SMs idle (the wrapper's flash_splits, from the
// shapes alone), each block's walk over the key tiles [t_first, t_end) is
// split into S chunks of ceil(walk / S) whole tiles, a block each (grid
// (S, units, row tiles), the longest walks first); a chunk block writes
// its rows' fp32 o, m (scaled scores) and l to the wrapper's scratch (an
// empty chunk, or a row that sees no key in its chunk, o = 0, m = -2e38,
// l = 0), and a second kernel, launched behind it by the same entry
// point, merges each row's chunks as ref.combine_partials does (one warp
// a row) into q's dtype.
//
// Measured against the one-warpgroup kernel this replaced (H100 80GB
// HBM3 at 700 W, CUDA-graph replay, warm L2, in turns with the parent's
// build; scripts/torch_flash_compare.py, PERF.md), ms: gemma3's
// global layer at T 1024 (S 4) 0.0604 -> 0.0214, under SDPA's 0.0291; its
// 512-key window (S 3) 0.0387 -> 0.0188; whisper's cross attention 64 ->
// 1500 (S 8) 0.0456 -> 0.0125, under SDPA's 0.0205; zamba2 (T 1024, D 64,
// S 1) 0.0624 -> 0.0462 and whisper's encoder (S 1) 0.1125 -> 0.0926,
// still 1.3x and 1.7x SDPA; the T 64 and T 256 prefills 3-21% faster.  At
// D 64 a consumer's tile step is ~3,800 cycles, ~2,200 of them its
// softmax (clock64 around each phase in a throwaway build): the exp2 and
// FP32 issue of four consumers an SM, not the products or the loads,
// bound it there.  Of the variants timed (PERF.md), issuing the next
// tile's S before this tile's softmax made ptxas serialize the products
// (C7515) and was slower at every shape; skipping the products of a tile
// a consumer never sees, and rescaling O only when the row max moved,
// slowed the loop more than they saved; turns at two blocks an SM and a
// clock read on every failed barrier try cost 5-12% and 2-6% at D 64.
//
// bf16 entry, one-warpgroup instance (rows that are no whole 16-byte
// pieces, or unaligned views; no main path) -- one warpgroup per (bh,
// 64-row query tile), grid (BH, ceil(T / 64)); each key tile is stored
// into the same swizzled layout element by element, then S, the softmax
// and P.V run in sequence (D, Dv <= 256; zero-padded to 16 and to 64,
// 128 or 256).  Never split.
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

#include <cuda.h>

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
// wait until at most kPending committed groups of products are in flight
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
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

__device__ __forceinline__ float fast_exp2(float x) {  // 2 ulp; exp2(-1e30) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S (64 x 64, fp32) = Q . K^T over D in steps of 16, both K-major from
// shared memory; issued, not waited for
__device__ __forceinline__ void s_products(float (&s)[32], uint32_t qs, uint32_t kst, int Dp) {
  for (int d0 = 0; d0 < Dp; d0 += 16) {
    const uint32_t off = (d0 / 64) * kBlk + (d0 % 64) * 2;
    wgmma_ss_n64(s, sw128_desc(qs + off, 16, 1024), sw128_desc(kst + off, 16, 1024), d0);
  }
}

// O += P . V over a tile's 64 keys in steps of 16 (V is MN-major: 64-column
// blocks 8 KB apart, 8-key groups 1 KB apart); issued, not waited for
template <int kNo>
__device__ __forceinline__ void pv_products(float (&o)[kNo / 2], const uint32_t (&p)[4][4],
                                            uint32_t vst) {
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
}

// One key tile of the online softmax on a warp's S fragment: s[n * 4 + e]
// is row r_a + (e / 2) * 8, key kt + n * 8 + c_l + e % 2 (r_w, the warp's
// first row).  Masks the tile only where the diagonal, the window edge or
// Tk cuts it, moves the running max m (raw score units; the scale is
// applied inside the exponent) and sum l, leaves the weights exp2((s - m)
// * scale_log2) in s, and returns in alpha the factors O's two rows are
// rescaled by.
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int r_w, int r_a, int c_l,
                                             int kt, int Tk, int causal, int window,
                                             float scale_log2) {
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
  float ms[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
    alpha[h] = fast_exp2((m[h] - mx[h]) * scale_log2);
    m[h] = mx[h];
    // a row that has seen only masked keys weighs them 0: mx * scale
    // would round, and the exponent of a masked score minus it need not
    // be exactly 0
    ms[h] = mx[h] == kNegInf ? 0.0f : mx[h] * scale_log2;
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n * 4 + e] = fast_exp2(fmaf(s[n * 4 + e], scale_log2, -ms[e / 2]));
    l[0] += s[n * 4] + s[n * 4 + 1];
    l[1] += s[n * 4 + 2] + s[n * 4 + 3];
  }
}

// the weights in s, rounded to bf16, as the register A operand of P.V (one
// 16-key step a row of p)
__device__ __forceinline__ void pack_p(uint32_t (&p)[4][4], const float (&s)[32]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    p[n / 2][(n % 2) * 2] = pack_bf16(s[n * 4], s[n * 4 + 1]);
    p[n / 2][(n % 2) * 2 + 1] = pack_bf16(s[n * 4 + 2], s[n * 4 + 3]);
  }
}

template <int N>
__device__ __forceinline__ void scale_rows(float (&o)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= alpha[(i / 2) % 2];
}

// the mask value of a split's statistics (ref.PARTIAL_NEG_INF): a chunk in
// which a row sees no key reports m = -2e38, o = 0, l = 0, never -inf, so
// that the merge's exp(m - max m) stays finite
constexpr float kPartialNegInf = -2.0e38f;

// The end of a warp's 16 rows [r_a, r_a + 8] (rows past T skipped): l summed
// over the 4 lanes that share a row, then either O / l rounded to bf16 into
// `out` (bh's rows), or, for chunk c of an S-chunk split, the unnormalised
// statistics into `work`: o (S, BH, T, Dv) fp32, then m (S, BH, T) in
// units of the scaled scores (m * scale), then l (S, BH, T).
template <int kNo>
__device__ __forceinline__ void store_rows(float (&o)[kNo / 2], const float (&m)[2], float (&l)[2],
                                           bf16* out, float* work, int S, int c, int bh,
                                           int BH, int T_, int Dv, int r_a, int c_l,
                                           float scale) {
  const int lane = threadIdx.x % kWarp;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
  }
  const size_t rows = static_cast<size_t>(BH) * T_;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_a + h * 8;
    if (r >= T_) continue;
    const size_t row = static_cast<size_t>(bh) * T_ + r;
    if (S == 1) {
      const float inv = 1.0f / fmaxf(l[h], 1e-30f);
      bf16* orow = out + row * Dv;
#pragma unroll
      for (int n = 0; n < kNo / 8; ++n) {
        const int col = n * 8 + c_l;  // even, and Dv is even: both columns or none
        if (col < Dv)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[n * 4 + 2 * h] * inv, o[n * 4 + 2 * h + 1] * inv);
      }
    } else {
      const size_t part = static_cast<size_t>(c) * rows + row;
      float* orow = work + part * Dv;
#pragma unroll
      for (int n = 0; n < kNo / 8; ++n) {
        const int col = n * 8 + c_l;
        if (col < Dv)
          *reinterpret_cast<float2*>(orow + col) =
              make_float2(o[n * 4 + 2 * h], o[n * 4 + 2 * h + 1]);
      }
      if (lane % 4 == 0) {
        float* mrow = work + static_cast<size_t>(S) * rows * Dv;
        mrow[part] = m[h] == kNegInf ? kPartialNegInf : m[h] * scale;
        mrow[static_cast<size_t>(S) * rows + part] = l[h];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// one-warpgroup instance: rows that are not whole 16-byte pieces or
// pointers not 16-byte aligned
// ---------------------------------------------------------------------------

// Rows [row0, row0 + kTile) of a (T, W) matrix into the swizzled tile at
// shared address `dst`, one element at a time; rows past T are zeros,
// columns past W untouched.
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, int row0, int T_,
                                          int W) {
  for (int i = threadIdx.x; i < kTile * W; i += blockDim.x) {
    const int r = i / W, c = i - r * W;
    const bf16 x = row0 + r < T_ ? src[static_cast<size_t>(row0 + r) * W + c]
                                 : __float2bfloat16(0.0f);
    asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(dst + swz(r, c)),
                 "h"(*reinterpret_cast<const unsigned short*>(&x)));
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

// kNo: O's width in the P.V product (64: Dv <= 64, 128: Dv <= 128, 256:
// Dv <= 256).  One warpgroup per (bh, 64-row query tile); each key tile is
// stored by the block, then S, the softmax and P.V run in sequence.
template <int kNo>
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
  const uint32_t qs = (smem_addr(smem_raw) + 1023) & ~1023u, ks = qs + q_bytes,
                 vs = ks + q_bytes;
  const int bh = blockIdx.x, kvh = bh / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // longest tiles first
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const bf16* kb = k + static_cast<size_t>(kvh) * Tk * D;
  const bf16* vb = v + static_cast<size_t>(kvh) * Tk * Dv;

  // zero the padding columns [D, Dp) of Q and K and [Dv, kNo) of V once;
  // the stores never write them
  if (Dp > D) zero_cols(qs, 2, q_bytes, D, Dp);
  if (kNo > Dv) zero_cols(vs, 1, v_bytes, Dv, kNo);
  load_tile(qs, q + static_cast<size_t>(bh) * T_ * D, q0, T_, D);

  // keys any row of the block can see: [k_lo, k_hi), in whole tiles
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Tk, q0 + kTile) : Tk;
  const int r_w = q0 + warp * 16, r_a = r_w + lane / 4;
  const int c_l = 2 * (lane % 4);  // first of the lane's two columns in an 8-key tile
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f}, alpha[2];
  float o[kNo / 2];
#pragma unroll
  for (int i = 0; i < kNo / 2; ++i) o[i] = 0.0f;
  float s[32];
  uint32_t p[4][4];

  for (int t = k_lo / kTile; t < (k_hi + kTile - 1) / kTile; ++t) {
    const int kt = t * kTile;
    __syncthreads();  // the previous tile fully read (and the zeros written)
    load_tile(ks, kb, kt, Tk, D);
    load_tile(vs, vb, kt, Tk, Dv);
    // this thread's stores, then everyone's, visible to wgmma
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    wgmma_fence();
    s_products(s, qs, ks, Dp);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile(s, m, l, alpha, r_w, r_a, c_l, kt, Tk, causal, window, scale_log2);
    scale_rows(o, alpha);
    pack_p(p, s);
    fence_regs(o);
    wgmma_fence();
    pv_products<kNo>(o, p, vs);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }
  store_rows<kNo>(o, m, l, out, nullptr, 1, 0, bh, gridDim.x, T_, Dv, r_a, c_l, 0.0f);
}

// ---------------------------------------------------------------------------
// TMA instance: a producer warp and two consumer warpgroups a block
// ---------------------------------------------------------------------------

constexpr int kTmaThreads = 3 * kGroup;  // the producer's warpgroup, two consumers
// blocks an SM: two at Dv <= 64 (consumers of 104 registers; the
// wrapper's flash_splits counts them), else one
__host__ __device__ constexpr int tma_blocks_per_sm(int kNo) { return kNo == 64 ? 2 : 1; }
constexpr int kMaxStages = 4;            // K/V tiles in each ring, at most
// dynamic shared memory a block may take (227 KB on sm_90, less a margin
// for the static barriers)
constexpr int kSmemLimit = 227 * 1024 - 1024;

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
// Wait until the phase of parity `parity` has completed.  A phase that has
// not completed after a second (a lost load) traps instead of hanging the
// card; the clock is read once every 1024 failed tries (reading it at each
// cost 2-6% of the whole kernel at head dim 64).
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  unsigned long long since = 0;
  for (uint32_t tries = 1;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries % 1024 == 0) {
      if (since == 0) {
        since = now_ns();
      } else if (now_ns() - since > 1000000000ull) {
        __trap();
      }
    }
  }
}
// box (c0, c1, c2) of a 3-D tensor map into shared memory, counted on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}
// the two consumers take turns issuing their products: named barriers 1
// and 2 (0 is __syncthreads), 256 threads each
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// kNo as above.  Block (c, unit, row tile): warpgroup 0 is the producer
// (one thread issues every TMA load), warpgroups 1 and 2 the consumers,
// each a 64-row query tile: under GQA with G even, the same tile of two
// query heads of one kv head (`unit` a pair of heads); else two tiles of
// one head (`unit` the head, 128 rows).  Both walk the key tiles any of the
// block's rows can see, chunk c of S of them, through rings of `stages` K
// and V tiles (full and empty mbarriers).
template <int kNo>
__global__ void __launch_bounds__(kTmaThreads, tma_blocks_per_sm(kNo))
flash_attention_tma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out,
                           float* __restrict__ work, int BH, int G, int T_, int Tk, int D,
                           int Dv, int causal, int window, int S, int stages,
                           float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // q_full, then k_full, k_empty, v_full, v_empty (kMaxStages each)
  __shared__ __align__(8) uint64_t bars[1 + 4 * kMaxStages];
  const int q_bytes = (D + 63) / 64 * kBlk;  // one Q or K tile: whole 64-column boxes
  constexpr int v_bytes = kNo / 64 * kBlk;   // one V tile
  const uint32_t qs = (smem_addr(smem_raw) + 1023) & ~1023u;  // 1 KB, as the swizzle needs
  const uint32_t ks = qs + 2 * q_bytes, vs = ks + stages * q_bytes;
  const uint32_t q_full = smem_addr(bars);
  const auto k_full = [&](int i) { return q_full + 8 * (1 + i); };
  const auto k_empty = [&](int i) { return q_full + 8 * (1 + kMaxStages + i); };
  const auto v_full = [&](int i) { return q_full + 8 * (1 + 2 * kMaxStages + i); };
  const auto v_empty = [&](int i) { return q_full + 8 * (1 + 3 * kMaxStages + i); };

  const bool paired = G % 2 == 0;
  const int c = blockIdx.x, unit = blockIdx.y;
  const int rows = paired ? kTile : 2 * kTile;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * rows;  // longest walks first
  const int r1 = min(T_, r0 + rows);
  const int nc = paired || r0 + kTile < T_ ? 2 : 1;  // consumers with rows
  const int kvh = (paired ? 2 * unit : unit) / G;
  // key tiles any row of the block can see, [t_first, t_end), and this
  // block's chunk of them: per = ceil(walk / S) tiles from t_first on
  // (ref.flash_walk, ref.flash_chunks)
  const int k_lo = window > 0 ? max(0, r0 - window + 1) : 0;
  const int k_hi = causal ? min(Tk, r1) : Tk;
  const int t_first = k_lo / kTile, t_end = (k_hi + kTile - 1) / kTile;
  const int per = (t_end - t_first + S - 1) / S;
  const int c_first = min(t_end, t_first + c * per);
  const int n = min(t_end, c_first + per) - c_first;  // tiles in the chunk
  const int wg = threadIdx.x / kGroup;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < stages; ++i) {
      mbar_init(k_full(i), 1);
      mbar_init(v_full(i), 1);
      mbar_init(k_empty(i), 4 * nc);  // each consumer warp releases a stage
      mbar_init(v_empty(i), 4 * nc);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int w = wg - 1;  // consumer index
  const int bh = paired ? 2 * unit + w : unit;
  const int q0 = paired ? r0 : r0 + w * kTile;
  const int warp = (threadIdx.x % kGroup) / kWarp, lane = threadIdx.x % kWarp;
  const int r_w = q0 + warp * 16, r_a = r_w + lane / 4;
  const int c_l = 2 * (lane % 4);
  const float scale = scale_log2 * 0.6931471805599453f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f}, alpha[2];
  float o[kNo / 2];
#pragma unroll
  for (int i = 0; i < kNo / 2; ++i) o[i] = 0.0f;

  if (n == 0) {  // an empty chunk of a split: o = 0, m = -2e38, l = 0
    if (wg > 0 && w < nc)
      store_rows<kNo>(o, m, l, out, work, S, c, bh, BH, T_, Dv, r_a, c_l, scale);
    return;
  }

  if (wg == 0) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x != 0) return;
    mbar_expect_tx(q_full, nc * q_bytes);
    for (int i = 0; i < nc; ++i)
      for (int b = 0; b * 64 < D; ++b)
        tma_load(qs + i * q_bytes + b * kBlk, &tm_q, b * 64, paired ? r0 : r0 + i * kTile,
                 paired ? 2 * unit + i : unit, q_full);
    int st = 0, ph = 0;
    for (int t = c_first; t < c_first + n; ++t) {
      mbar_wait(k_empty(st), ph ^ 1);
      mbar_expect_tx(k_full(st), q_bytes);
      for (int b = 0; b * 64 < D; ++b)
        tma_load(ks + st * q_bytes + b * kBlk, &tm_k, b * 64, t * kTile, kvh, k_full(st));
      mbar_wait(v_empty(st), ph ^ 1);
      mbar_expect_tx(v_full(st), v_bytes);
      // every box of V's kNo columns: boxes past Dv come back as zeros
#pragma unroll
      for (int b = 0; b < kNo / 64; ++b)
        tma_load(vs + st * v_bytes + b * kBlk, &tm_v, b * 64, t * kTile, kvh, v_full(st));
      if (++st == stages) {
        st = 0;
        ph ^= 1;
      }
    }
    return;
  }

  // the producer's registers to the consumers: 24 + 2 x 240 a thread of
  // a warpgroup fill the SM at one block; 24 + 2 x 104 at two
  if constexpr (tma_blocks_per_sm(kNo) == 2) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 104;\n" ::: "memory");
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  }
  if (w >= nc) return;
  const int Dp = round16(D);
  const uint32_t qw = qs + w * q_bytes;
  // with two consumers at one block an SM they take turns: each issues
  // its products when the other has issued its own, so one's softmax runs
  // under the other's products; consumer 0 goes first.  At two blocks an
  // SM (Dv <= 64) the four consumers interleave on their own, and turns
  // cost 5-12% there
  const bool turns = tma_blocks_per_sm(kNo) == 1 && nc == 2;
  if (turns && w == 1) turn_pass(1);
  float s[32];
  uint32_t p[4][4];
  int st = 0, ph = 0;
  mbar_wait(q_full, 0);

  // per key tile two turns: S = Q.K^T, then (after the softmax) P.V; the
  // last P.V of consumer 1 passes no turn (consumer 0 has nothing left)
  for (int j = 0; j < n; ++j) {
    const int kt = (c_first + j) * kTile;
    mbar_wait(k_full(st), ph);
    if (turns) turn_wait(1 + w);
    wgmma_fence();
    s_products(s, qw, ks + st * q_bytes, Dp);
    wgmma_commit();
    if (turns) turn_pass(2 - w);
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(k_empty(st));
    softmax_tile(s, m, l, alpha, r_w, r_a, c_l, kt, Tk, causal, window, scale_log2);
    scale_rows(o, alpha);
    pack_p(p, s);
    mbar_wait(v_full(st), ph);
    if (turns) turn_wait(1 + w);
    fence_regs(o);
    wgmma_fence();
    pv_products<kNo>(o, p, vs + st * v_bytes);
    wgmma_commit();
    if (turns && (w == 0 || j + 1 < n)) turn_pass(2 - w);
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(v_empty(st));
    if (++st == stages) {
      st = 0;
      ph ^= 1;
    }
  }
  store_rows<kNo>(o, m, l, out, work, S, c, bh, BH, T_, Dv, r_a, c_l, scale);
}

// The merge of an S-chunk split: one warp a row of the (BH * T) rows, the
// chunks' statistics as combine_partials (kernels/ref.py) merges them, o /
// l rounded to bf16 into `out`.  A chunk that weighs nothing is not read.
constexpr int kMergeWarps = 8;

__global__ void __launch_bounds__(kMergeWarps * kWarp)
flash_attention_merge_kernel(const float* __restrict__ work, bf16* __restrict__ out,
                             int rows, int Dv, int S) {
  const int row = blockIdx.x * kMergeWarps + threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  if (row >= rows) return;
  const size_t n = static_cast<size_t>(S) * rows;
  const float* m = work + n * Dv;
  const float* l = m + n;
  float top = kPartialNegInf;
  for (int c = lane; c < S; c += kWarp) top = fmaxf(top, m[static_cast<size_t>(c) * rows + row]);
  top = warp_max(top);
  float den = 0.0f;
  for (int c = lane; c < S; c += kWarp) {
    const size_t i = static_cast<size_t>(c) * rows + row;
    den += expf(m[i] - top) * l[i];
  }
  const float inv = 1.0f / fmaxf(warp_sum(den), 1e-30f);
  bf16* orow = out + static_cast<size_t>(row) * Dv;
  for (int col = lane * 4; col < Dv; col += 4 * kWarp) {  // Dv is a multiple of 8
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int c = 0; c < S; ++c) {
      const size_t i = static_cast<size_t>(c) * rows + row;
      const float wt = expf(m[i] - top);
      if (wt == 0.0f) continue;  // the same for every lane
      const float4 x = *reinterpret_cast<const float4*>(work + i * Dv + col);
      acc.x = fmaf(wt, x.x, acc.x);
      acc.y = fmaf(wt, x.y, acc.y);
      acc.z = fmaf(wt, x.z, acc.z);
      acc.w = fmaf(wt, x.w, acc.w);
    }
    __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x * inv, acc.y * inv),
                   hi = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(orow + col) = packed;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a libcuda entry point, found through the
// runtime so that the build links no -lcuda
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 tensor (heads, rows, W) as a 3-D map of 64-column, 64-row boxes of
// one head in the 128-byte swizzle; boxes past W, rows or heads read zeros
// (a 2-D map's tail box would read the next head).
bool tile_map(CUtensorMap* map, const void* base, int W, int rows, int heads) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(W) * sizeof(bf16),
                                 static_cast<cuuint64_t>(W) * rows * sizeof(bf16)};
  const cuuint32_t box[3] = {64, kTile, 1}, unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kNo>
int launch_tma(const void* q, const void* k, const void* v, void* out, void* work, int BH,
               int BHkv, int T_, int Tk, int D, int Dv, int causal, int window, int S,
               cudaStream_t stream) {
  constexpr auto kernel = &flash_attention_tma_kernel<kNo>;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!tile_map(&tm_q, q, D, T_, BH) || !tile_map(&tm_k, k, D, Tk, BHkv) ||
      !tile_map(&tm_v, v, Dv, Tk, BHkv))
    return static_cast<int>(cudaErrorInvalidValue);
  // two Q tiles, then as many K/V stages as fit (2 at D = Dv = 256), and up
  // to 1 KB to align the first tile
  const int q_bytes = (D + 63) / 64 * kBlk, v_bytes = kNo / 64 * kBlk;
  // at two blocks an SM each takes half the shared memory, if 2 stages
  // fit there
  const int half = (kSmemLimit - 1024) / 2 - 1024 - 2 * q_bytes;
  const int room = tma_blocks_per_sm(kNo) == 2 && half >= 2 * (q_bytes + v_bytes)
                       ? half
                       : kSmemLimit - 1024 - 2 * q_bytes;
  const int stages = min(kMaxStages, room / (q_bytes + v_bytes));
  const size_t smem = 1024 + 2 * q_bytes + static_cast<size_t>(stages) * (q_bytes + v_bytes);
  cudaError_t err = allow_smem<kernel>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = BH / BHkv;
  const bool paired = G % 2 == 0;
  const int rows = paired ? kTile : 2 * kTile;
  const dim3 grid(S, paired ? BH / 2 : BH, (T_ + rows - 1) / rows);
  kernel<<<grid, kTmaThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<bf16*>(out), static_cast<float*>(work), BH, G, T_, Tk, D,
      Dv, causal, window, S, stages, 1.4426950408889634f / sqrtf(static_cast<float>(D)));
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return static_cast<int>(err);
  const int n_rows = BH * T_;
  flash_attention_merge_kernel<<<(n_rows + kMergeWarps - 1) / kMergeWarps,
                                 kMergeWarps * kWarp, 0, stream>>>(
      static_cast<const float*>(work), static_cast<bf16*>(out), n_rows, Dv, S);
  return static_cast<int>(cudaGetLastError());
}

template <int kNo>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, int BH, int BHkv,
                 int T_, int Tk, int D, int Dv, int causal, int window,
                 cudaStream_t stream) {
  constexpr auto kernel = &flash_attention_wgmma_kernel<kNo>;
  // the Q tile, one K/V tile, and up to 1 KB to align the first tile
  const size_t smem = 2 * ((round16(D) + 63) / 64 * kBlk) + kNo / 64 * kBlk + 1024;
  cudaError_t err = allow_smem<kernel>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (T_ + kTile - 1) / kTile);
  kernel<<<grid, kGroup, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), BH / BHkv, T_, Tk, D, Dv, causal, window,
      1.4426950408889634f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
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
                                    void* out, void* work, int BH, int BHkv, int T, int Tk,
                                    int D, int Dv, int causal, int window, int S,
                                    void* stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool tma = D % 8 == 0 && Dv % 8 == 0 && aligned(q) && aligned(k) && aligned(v);
  if (S < 1 || (S > 1 && !tma)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (tma) {
    if (Dv <= 64)
      return launch_tma<64>(q, k, v, out, work, BH, BHkv, T, Tk, D, Dv, causal, window, S, s);
    if (Dv <= 128)
      return launch_tma<128>(q, k, v, out, work, BH, BHkv, T, Tk, D, Dv, causal, window, S, s);
    return launch_tma<256>(q, k, v, out, work, BH, BHkv, T, Tk, D, Dv, causal, window, S, s);
  }
  if (Dv <= 64)
    return launch_wgmma<64>(q, k, v, out, BH, BHkv, T, Tk, D, Dv, causal, window, s);
  if (Dv <= 128)
    return launch_wgmma<128>(q, k, v, out, BH, BHkv, T, Tk, D, Dv, causal, window, s);
  return launch_wgmma<256>(q, k, v, out, BH, BHkv, T, Tk, D, Dv, causal, window, s);
}
