// The body shared by the two GQA decode kernels, decode_attention.cu
// (a contiguous ring cache with a validity mask) and
// paged_decode_attention.cu (a paged cache read through block tables):
// one query token per sequence, the query heads of one kv head in one
// block.  The kernels differ only in where slot s of a row lies and
// whether it counts; each passes a row-addressing policy `Rows`:
//
//   rows.begin(), rows.end()  the slots the block walks, [begin, end);
//                             begin is a multiple of 32
//   rows.counts(s)            slot s < end counts (is not masked)
//   rows.row(s)               its K/V row: K at k + row * D, V at
//                             v + row * Dv
//
// `any` says whether some slot of the row counts.  When none does, every
// score is -1e30 in the plain versions and the JAX kernels, so their
// output is the uniform mean of V over the walked slots; the body then
// reads every walked slot's V and no K, and gives the same.
//
// A row's walk may be split into S chunks (walk_chunk), each walked by a
// block of its own: S blocks a (row, kv head, head group), so that a long
// row keeps many SMs busy where the rows and heads alone give few blocks.
// The host picks S from shapes only (kernels/decode_attention.py
// decode_splits); each block works out its own row's chunk on the device,
// round_up(ceil(walk / S), 32) slots of that row's walk.  With S = 1 a
// block writes its output directly (the kSplit = false instance, the code
// the kernels ran before the split).  With S > 1 each chunk writes its
// softmax statistics to fp32 scratch, and a second kernel,
// merge_chunks_kernel, launched behind it on the same stream, merges
// them: no host sync, safe in a CUDA graph.  Measured against a merge by
// the last chunk block to finish (a self-resetting counter, a fence and
// an atomic a block), the second launch was as fast or faster at every
// split shape on an H100 (PERF.md §6).
//
// The output is a `DecodeOut`: o / l in T, or with `part` set the
// statistics, all fp32: the unnormalised o = sum exp(s - m) . v, the row
// max m and the row sum l = sum exp(s - m), so that shares of a row's
// slots held by different ranks (models/sharded.py), or the chunks of a
// split walk, can be merged.  Where a block counted no slot, m is
// kPartialNegInf (-2e38, the plain version's mask): with no slot walked
// (an empty chunk, or a chunk with none counted in a row that has some,
// which reads no K or V) l = 0 and o = 0; in a row with no counted slot
// at all, l = the walked slots and o = the sum of their V.  A merge then
// gives such a part weight 0 beside a part with a counted slot, and the
// uniform mean of V where no part has one.  -2e38, not -inf: the merge
// takes exp(m - max m), which stays 1 where every m is -2e38.
//
// What bounds it on this card: bytes (each counted K/V row once).  The
// design is about keeping enough of them in flight:
// - A key row is spread over a group of 8 lanes, each holding D / 8 of
//   its elements: as one 16-byte vector load (8 bf16, or 4 fp32 twice)
//   at D 64, so one load instruction of the warp covers 4 keys.  Rows
//   wider than 128 (gemma3's D 256) are spread over 16 lanes instead, so
//   a lane still holds at most 16 elements of a row and 16 of its output:
//   at 8 lanes, 4 query heads a block would keep 32 query and 32
//   accumulator floats a head in each lane, 256 registers before a key
//   is loaded.  Where a row is no multiple of 16 bytes (or a pointer is
//   not 16-byte aligned) a compile-time variant (kVec false) loads one
//   element at a time.
//   The pre-scaled fp32 query sits in registers; a score is the lane
//   group's partial dot reduced with 3 (4) shuffles, and P.V accumulates each
//   lane's own output dims.  K/V go straight to registers, with no
//   staging copy in shared memory.
// - Each warp takes 32-slot windows in turn and takes a ballot of the
//   slots that count: a window, or a sub-chunk of it, with none is
//   skipped without touching K/V, and masked slots inside a sub-chunk
//   are not loaded.  Skipping is exact, since a masked key adds
//   exp(-1e30 - m) = 0 once an unmasked one is seen.
// - Each lane issues the loads of U keys (U = 8 at D <= 64 in bf16: 16
//   vector loads of 16 bytes) before it uses the first, so a sub-chunk's
//   whole K and V are in flight at once.
// - Each lane group keeps its own online softmax (max, sum, output); at
//   the end the groups of a warp are merged by shuffles and the warps
//   through shared memory, rescaled to their common max.
// fp32 arithmetic, expf and tanhf without fast math; D, Dv <= 256.
#pragma once

#include <cstdint>
#include <type_traits>

#include "attention_common.cuh"

namespace attn {

// Register-held row pieces: a lane loads kEpl consecutive elements of a
// K or V row at once, as one 16-byte vector (`uint4`, 8 bf16 or 4 fp32)
// when rows allow it, else one element.
template <typename T, bool kVec>
struct RowPiece {
  static constexpr int kEpl = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
  using Raw = typename std::conditional<kVec, uint4, T>::type;

  __device__ __forceinline__ static Raw load(const T* p) {
    if constexpr (kVec) {
      return __ldg(reinterpret_cast<const uint4*>(p));
    } else {
      return p[0];
    }
  }
  __device__ __forceinline__ static Raw zero() {
    if constexpr (kVec) {
      return make_uint4(0u, 0u, 0u, 0u);
    } else {
      return from_float<T>(0.0f);
    }
  }
  // element i < kEpl of the piece, widened to fp32
  __device__ __forceinline__ static float get(const Raw& r, int i) {
    if constexpr (!kVec) {
      return to_float(r);
    } else if constexpr (sizeof(T) == 4) {
      const unsigned w[4] = {r.x, r.y, r.z, r.w};
      return __uint_as_float(w[i]);
    } else {
      const unsigned w[4] = {r.x, r.y, r.z, r.w};
      const unsigned half = (i & 1) ? (w[i >> 1] >> 16) : (w[i >> 1] & 0xffffu);
      return __uint_as_float(half << 16);  // bf16 -> fp32 is a shift
    }
  }
};

// The partial instance's row max for a row with no counted slot: the
// plain version's mask value (kernels/ref.py PARTIAL_NEG_INF).
constexpr float kPartialNegInf = -2.0e38f;

// Where statistics go: o (rows, Dv), m (rows) and l (rows), fp32.
struct PartialOut {
  float *o, *m, *l;
  // the same arrays from row r on
  __device__ __forceinline__ PartialOut at(size_t r, int Dv) const {
    return {o + r * Dv, m + r, l + r};
  }
};

// Where a block writes its ng rows: o / l in T at `out` (ng, Dv), or,
// where part.o is set, the statistics there.
template <typename T>
struct DecodeOut {
  T* out;
  PartialOut part;
  __device__ __forceinline__ DecodeOut at(size_t r, int Dv) const {
    return {part.o ? out : out + r * Dv, part.o ? part.at(r, Dv) : part};
  }
};

// The chunks of a split walk: fp32 statistics (S, rows, Dv) o and
// (S, rows) m and l, `rows` = B * H; S = 1: none (a block writes its
// output).
struct Split {
  float* scratch;
  int S;
  size_t rows;
  // chunk c's statistics, from row r on
  __device__ __forceinline__ PartialOut chunk(int c, size_t r, int Dv) const {
    const size_t n = static_cast<size_t>(S) * rows;
    return PartialOut{scratch, scratch + n * Dv, scratch + n * Dv + n}.at(
        static_cast<size_t>(c) * rows + r, Dv);
  }
};

// Chunk c of S of a walk [first, last) (first a multiple of 32): each
// chunk round_up(ceil(walk / S), 32) slots, so every chunk starts on a
// 32-slot window and the S chunks cover the walk; trailing ones may be
// empty.
struct Chunk {
  int begin, end;
};
__device__ __forceinline__ Chunk walk_chunk(int first, int last, int c, int S) {
  const int size = ((last - first + S - 1) / S + kWarp - 1) & ~(kWarp - 1);
  const int begin = min(last, first + c * size);
  return {begin, min(last, begin + size)};
}

// Whether some byte of a row's `n` mask bytes is set, for the whole
// block (16 bytes a load where the row allows it; also a barrier).
__device__ __forceinline__ bool block_any(const unsigned char* mask, int n) {
  int mine = 0;
  if (n % 16 == 0 && reinterpret_cast<uintptr_t>(mask) % 16 == 0) {
    const uint4* m4 = reinterpret_cast<const uint4*>(mask);
    for (int i = threadIdx.x; i < n / 16; i += blockDim.x) {
      const uint4 w = __ldg(m4 + i);
      mine |= (w.x | w.y | w.z | w.w) != 0u;
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) mine |= mask[i];
  }
  return __syncthreads_or(mine);
}

// Sum over the `kLanes` consecutive lanes of a lane group (a power of 2).
template <int kLanes>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = kLanes / 2; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Shared memory of a decode block with `warps` warps taking kGB query
// heads: the pre-scaled query rows (kGB, D) and the cross-warp merge
// area (warps, kGB, 2 + Dv).
inline size_t decode_smem_bytes(int kGB, int warps, int D, int Dv) {
  return sizeof(float) * (static_cast<size_t>(kGB) * D +
                          static_cast<size_t>(warps) * kGB * (2 + Dv));
}

// Stage the block's ng query rows (ng * D elements from `q`) as fp32,
// multiplied by `scale`.  The caller synchronises.
template <typename T>
__device__ __forceinline__ void load_query(float* qs, const T* q, int n, float scale) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) qs[i] = to_float(q[i]) * scale;
}

// kLanes: lanes a row is spread over (8, or 16 for rows wider than
// 128); kDims: elements of a row a lane holds (8 for D, Dv <= 64, else
// 16); kGB: query heads a block takes, of which the first ng are real;
// kWarps: the block's warps, fixed at compile time (6-8% faster at the
// dense kernel's shapes than a count read at run time).
// `qs` holds the pre-scaled query rows (published by a barrier), `red`
// the merge area; `out` is at the block's first row.
template <typename T, bool kVec, int kLanes, int kDims, int kGB, int kWarps, class Rows>
__device__ __forceinline__ void decode_rows(const T* __restrict__ k,
                                            const T* __restrict__ v,
                                            const DecodeOut<T>& out, const float* qs,
                                            float* red, const Rows& rows, bool any,
                                            int ng, int D, int Dv, float soft_cap) {
  using P = RowPiece<T, kVec>;
  constexpr int kEpl = P::kEpl;
  constexpr int kPieces = kDims / kEpl;  // loads a lane makes a row
  constexpr int kRowRegs = kPieces * (sizeof(typename P::Raw) < 4
                                          ? 1 : sizeof(typename P::Raw) / 4);
  // keys per lane group per sub-chunk: about 32 registers each of K and V
  constexpr int kU = kRowRegs >= 32 ? 1 : (32 / kRowRegs > 8 ? 8 : 32 / kRowRegs);
  constexpr int kGroups = kWarp / kLanes;  // keys a warp loads at once
  constexpr int kSub = kGroups * kU;       // keys per sub-chunk

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int grp = lane / kLanes, j = lane % kLanes;

  // element e of a lane's piece p: (p * kLanes + j) * kEpl + e
  float qr[kGB][kDims];
#pragma unroll
  for (int g = 0; g < kGB; ++g)
#pragma unroll
    for (int p = 0; p < kPieces; ++p)
#pragma unroll
      for (int e = 0; e < kEpl; ++e) {
        const int d = (p * kLanes + j) * kEpl + e;
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

  const int end = rows.end();
  for (int w0 = rows.begin() + warp * kWarp; w0 < end; w0 += kWarps * kWarp) {
    const bool in = w0 + lane < end;
    const unsigned ok = __ballot_sync(kFull, in && rows.counts(w0 + lane));
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
        const size_t row = t ? rows.row(w0 + slot) : 0;
#pragma unroll
        for (int p = 0; p < kPieces; ++p) {
          const int d = (p * kLanes + j) * kEpl;
          // a row with no counted slot needs no K: its scores are all -1e30
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
          float sc = group_sum<kLanes>(part);
          if (soft_cap > 0.0f) sc = tanhf(sc / soft_cap) * soft_cap;
          // a slot past the walk weighs nothing even in a row with no
          // counted slot
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

  // merge the warp's lane groups (same dims in lanes j, j + kLanes,
  // ...), then the warps through shared memory
#pragma unroll
  for (int g = 0; g < kGB; ++g) {
    if (g >= ng) continue;
    float mx = m[g];
#pragma unroll
    for (int o = kLanes; o < kWarp; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    const float f = expf(m[g] - mx);
    float lsum = l[g] * f;
#pragma unroll
    for (int o = kLanes; o < kWarp; o <<= 1) lsum += __shfl_xor_sync(kFull, lsum, o);
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
        for (int o = kLanes; o < kWarp; o <<= 1) a += __shfl_xor_sync(kFull, a, o);
        const int d = (p * kLanes + j) * kEpl + e;
        if (grp == 0 && d < Dv) e0[2 + d] = a;
      }
  }
  __syncthreads();
  // unrolled over the warps, so that each thread's loads of the warps'
  // partials are in flight together
  for (int i = threadIdx.x; i < ng * Dv; i += blockDim.x) {
    const int g = i / Dv, d = i - g * Dv;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red[(w * kGB + g) * (2 + Dv)]);
    float lsum = 0.0f, o = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* e0 = red + (w * kGB + g) * (2 + Dv);
      const float f = expf(e0[0] - mx);
      lsum = fmaf(e0[1], f, lsum);
      o = fmaf(e0[2 + d], f, o);
    }
    if (out.part.o) {
      out.part.o[static_cast<size_t>(g) * Dv + d] = o;
      if (d == 0) {
        // a real score is far above -1e30: mx stays there only where no
        // slot counted
        out.part.m[g] = mx > kNegInf ? mx : kPartialNegInf;
        out.part.l[g] = lsum;
      }
    } else {
      out.out[static_cast<size_t>(g) * Dv + d] = from_float<T>(o / fmaxf(lsum, 1e-30f));
    }
  }
}

// Shared memory the merge of S chunks takes: (ng, S) row maxima (then
// weights) and sums, and (ng, 2) the merged max and sum.
inline size_t merge_smem_bytes(int kGB, int S) {
  return sizeof(float) * static_cast<size_t>(kGB) * (2 * S + 2);
}

// Merge the S chunks' statistics of the block's ng rows (from row r0 of
// `split`) into `out`: m* = max m, o = sum o e^(m - m*), l = sum l
// e^(m - m*), written as o / l in T, or as (o, m*, l).  The scratch is
// read once, with the loads of up to 8 chunks in flight together: a merge
// costs a few L2 round trips, not one a chunk.  A warp a row weighs the
// chunks.  `smem` holds merge_smem_bytes.
template <typename T>
__device__ __forceinline__ void merge_chunks(float* smem, const Split& split, size_t r0,
                                             int ng, int Dv, const DecodeOut<T>& out) {
  constexpr int kBatch = 8;  // chunks whose loads a thread issues at once
  const int S = split.S;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  float* w = smem;            // (ng, S): m, then the weights
  float* ls = w + ng * S;     // (ng, S): l
  float* ml = ls + ng * S;    // (ng, 2)
  for (int i = threadIdx.x; i < ng * S; i += blockDim.x) {
    const int g = i / S, c = i - g * S;
    const PartialOut p = split.chunk(c, r0 + g, Dv);
    w[i] = __ldg(p.m);
    ls[i] = __ldg(p.l);
  }
  __syncthreads();
  for (int g = warp; g < ng; g += blockDim.x / kWarp) {
    float mx = kPartialNegInf;
    for (int c = lane; c < S; c += kWarp) mx = fmaxf(mx, w[g * S + c]);
    mx = warp_max(mx);
    float l = 0.0f;
    for (int c = lane; c < S; c += kWarp) {
      const float f = expf(w[g * S + c] - mx);
      w[g * S + c] = f;
      l = fmaf(ls[g * S + c], f, l);
    }
    l = warp_sum(l);
    if (lane == 0) {
      ml[2 * g] = mx;
      ml[2 * g + 1] = l;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng * Dv; i += blockDim.x) {
    const int g = i / Dv, d = i - g * Dv;
    float o = 0.0f;
    for (int c0 = 0; c0 < S; c0 += kBatch) {
      float x[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        x[j] = c0 + j < S ? __ldg(split.chunk(c0 + j, r0 + g, Dv).o + d) : 0.0f;
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (c0 + j < S) o = fmaf(x[j], w[g * S + c0 + j], o);
    }
    if (out.part.o) {
      out.part.o[static_cast<size_t>(g) * Dv + d] = o;
      if (d == 0) {
        out.part.m[g] = ml[2 * g];
        out.part.l[g] = ml[2 * g + 1];
      }
    } else {
      out.out[static_cast<size_t>(g) * Dv + d] =
          from_float<T>(o / fmaxf(ml[2 * g + 1], 1e-30f));
    }
  }
}

// The second pass of a split walk: one block of kMergeThreads per (kv
// head, b, group of kGB query heads), the grid of the first pass without
// its chunks, merging the S chunks' statistics into `out`.
constexpr int kMergeThreads = 128;
template <typename T, int kGB>
__global__ void __launch_bounds__(kMergeThreads)
merge_chunks_kernel(DecodeOut<T> out, Split split, int H, int Hkv, int Dv) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / Hkv;
  const int h0 = kvh * G + blockIdx.z * kGB;  // first query head
  const int ng = min(kGB, kvh * G + G - h0);
  const size_t r0 = static_cast<size_t>(b) * H + h0;
  merge_chunks<T>(smem, split, r0, ng, Dv, out.at(r0, Dv));
}

// Launch the first pass `kernel` (grid (Hkv, B, groups * S)) with its
// arguments, then, where S > 1, the merge over (Hkv, B, groups); return
// the first non-zero cudaGetLastError() of the two.
template <typename T, int kGB, class Kernel, class... Args>
int launch_split(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                 const DecodeOut<T>& out, const Split& split, int H, int Hkv, int Dv,
                 Args... args) {
  kernel<<<grid, threads, smem, stream>>>(args...);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || split.S == 1) return static_cast<int>(err);
  merge_chunks_kernel<T, kGB><<<dim3(grid.x, grid.y, grid.z / split.S), kMergeThreads,
                                merge_smem_bytes(kGB, split.S), stream>>>(out, split, H,
                                                                          Hkv, Dv);
  return static_cast<int>(cudaGetLastError());
}

// Host side: pick the instance for the row widths and the group size.
// `launch_one<T, kVec, kLanes, kDims, kGB>()` launches one instance; a
// row of 16 bytes or more at every pointer takes the vector loads.  Heads
// a block takes: all G of a kv head up to 8 at D, Dv <= 64 (4 up to 128,
// whose accumulators take twice the registers), and one at wider rows.
// There a key costs a warp twice the instructions (2 keys a load, not
// 4), and a row of gemma3's ~60 cached tokens keeps only 2 of a block's
// warps busy: with its 4 heads in one block the kernel took 0.0247 ms at
// B 8 on an H100 at 700 W, against SDPA's 0.0176 (PERF.md), so the heads
// run in parallel blocks, each reading the kv head's rows (the later
// ones from L2).
template <typename T, bool kVec, int kLanes, int kDims, class Launch>
inline int decode_dispatch_group(int G, Launch& launch_one) {
  if constexpr (kLanes > 8) {
    return launch_one.template run<T, kVec, kLanes, kDims, 1>();
  } else {
    if (G == 1) return launch_one.template run<T, kVec, kLanes, kDims, 1>();
    if constexpr (kDims == 8) {
      if (G > 4) return launch_one.template run<T, kVec, kLanes, kDims, 8>();
    }
    return launch_one.template run<T, kVec, kLanes, kDims, 4>();
  }
}

// Lanes and elements a lane holds: 8 x 8 up to 64 dims, 8 x 16 up to
// 128, 16 x 16 up to 256.
template <typename T, bool kVec, class Launch>
inline int decode_dispatch_dims(int D, int Dv, int G, Launch& launch_one) {
  if (D <= 64 && Dv <= 64) return decode_dispatch_group<T, kVec, 8, 8>(G, launch_one);
  if (D <= 128 && Dv <= 128) return decode_dispatch_group<T, kVec, 8, 16>(G, launch_one);
  return decode_dispatch_group<T, kVec, 16, 16>(G, launch_one);
}

template <typename T, class Launch>
inline int decode_dispatch(int D, int Dv, bool aligned, int G, Launch& launch_one) {
  const bool vec = aligned && (D * sizeof(T)) % 16 == 0 && (Dv * sizeof(T)) % 16 == 0;
  if (vec) return decode_dispatch_dims<T, true>(D, Dv, G, launch_one);
  return decode_dispatch_dims<T, false>(D, Dv, G, launch_one);
}

}  // namespace attn
