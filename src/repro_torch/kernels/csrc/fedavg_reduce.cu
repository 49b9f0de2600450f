// fedavg_reduce: the weighted average of C model replicas, written for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fedavg_reduce.py:fedavg_reduce
// (its pallas_call is at fedavg_reduce.py:35).  Same function: stacked
// (C,N) replicas of a flattened parameter vector and weights (C,) give
// (N,) = (w/sum(w)) . stacked, summed in fp32 and returned in the input
// dtype (fp32 or bf16).
//
// What bounds it on this card: bytes.  It reads every replica once and
// does one multiply-add per element read, far below the ~20 FLOP per byte
// where fp32 arithmetic would start to matter.  The LM syncs average C 2
// replicas of N 792,797,824: 3.2 GB in bf16 (1.42 ms at 3.35 TB/s), 6.3
// GB in fp32 (2.84 ms).
//
// So the design keeps enough bytes in flight.  By Little's law, 3.35
// TB/s at ~0.6-0.8 us of DRAM latency needs 2-2.7 MB in flight across
// the 132 SMs, 15-20 KB an SM.  The first design of this kernel read
// one column a thread: a thread had C = 2 loads of 2 bytes in flight in
// bf16, an SM at most 8 KB, and every block of 256 columns summed and
// divided the weights before its first load (3.1 million blocks): 4.2x
// its bound in bf16.  Here:
//
// - a persistent grid (a few blocks an SM, from the SM count the wrapper
//   passes: launch_shape) walks N in tiles, so the weights are normalised once a block;
// - the vector instance gives each thread 16-byte chunks (4 fp32 or 8
//   bf16 columns) and issues the loads of all C rows for U chunks before
//   its first multiply-add, U chosen so a thread has >= 64 bytes in
//   flight: with 4 blocks of 256 threads, >= 64 KB an SM.  Loads and
//   stores carry the streaming hint (every byte is touched once).
//   It needs N * item % 16 == 0 and 16-byte aligned x and out, so that
//   every replica row starts on a 16-byte boundary: the LM syncs' N is a
//   multiple of 8;
// - the scalar instance serves everything else (the GRU's N = 148,737
//   is odd, so its rows 1.. are misaligned; views with a storage
//   offset): the same grid-stride tiles, of 256 columns, one element a
//   load;
// - counts C <= kStaticC are compile-time: the weights live in
//   registers (no shared memory, no barrier) and every load of a tile is
//   issued first.  Larger C loops at run time over weights in shared
//   memory, the block's only shared memory, so C * 4 bytes up to 48 KB
//   launch without an opt-in (C <= 12,288).
//
// The wrapper picks the instance from shape, dtype and pointer alignment
// alone (fedavg_reduce.instance); the grid only sets the speed, any grid
// >= 1 gives the same result.  The
// ragged end of N is masked in the kernel: no padding copy as on the TPU.
//
// Arithmetic, the same in every instance and in the first design, bit
// for bit: total = the serial fp32 sum of w[0..C-1]; wn[c] = w[c] / total
// (IEEE division); acc = fmaf(wn[c], x[c, n], acc) for c = 0..C-1 from
// acc = 0; one rounding to the output dtype (nearest even).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // vector instance: threads a block
constexpr int kStaticC = 8;    // compile-time counts 1..kStaticC

// The scalar instance's block: 256 columns a tile, as 64 threads of 4
// columns at compile-time counts and 256 threads of one column at run
// time, the fastest of a sweep of block shapes at the GRU's shapes (a
// tile of 256 columns puts ~4.4 blocks on each SM at N 148,737, against
// 2.2 at 512).
__host__ __device__ constexpr int scalar_threads(int C) {
  return C > 0 ? 64 : 256;
}
__host__ __device__ constexpr int scalar_columns(int C) {
  return C > 0 ? 4 : 1;
}
// rows a step of the scalar instance's run-time-count loop
constexpr int kScalarUnroll = 4;

// 16-byte chunks a thread a tile in the vector instance: >= 64 bytes of
// loads in flight (4 rows' chunks at run-time C, one row at a time)
__host__ __device__ constexpr int vec_unroll(int C) {
  return C == 0 ? 4 : (4 + C - 1) / C;
}

// Blocks an SM of the persistent grid: the vector instance is held to 64
// registers a thread, so 4 blocks of kThreads fit an SM; the scalar
// instance's blocks are smaller.
constexpr int kVecBlocksPerSM = 4;
constexpr int kScalarBlocksPerSM = 8;

// The template count of C replicas: C itself up to kStaticC, else 0 (a
// run-time count).
constexpr int static_count(int C) { return C <= kStaticC ? C : 0; }

struct Launch {
  int blocks, threads;
};

// The grid of an instance over C replicas of N items of `item` bytes on a
// card of `sms` SMs: one block a tile, up to a few blocks an SM; past
// that each block walks several tiles.  Any grid gives the same result.
Launch launch_shape(bool vec, int item, int C, long long N, int sms) {
  const int k = static_count(C);
  const int threads = vec ? kThreads : scalar_threads(k);
  const long long tile = vec ? 1LL * kThreads * vec_unroll(k) * (16 / item)
                             : 1LL * threads * scalar_columns(k);
  const long long most =
      1LL * (vec ? kVecBlocksPerSM : kScalarBlocksPerSM) * sms;
  const long long tiles = (N + tile - 1) / tile;
  return {static_cast<int>(tiles < most ? (tiles > 0 ? tiles : 1) : most),
          threads};
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// acc[0..V) += wn * the V columns of one 16-byte chunk
template <typename T>
__device__ __forceinline__ void fma_chunk(float wn, const uint4& v,
                                          float* acc) {
  const unsigned int u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      acc[i] = fmaf(wn, __uint_as_float(u[i]), acc[i]);
    } else {  // a bf16 is the high half of its float
      acc[2 * i] = fmaf(wn, __uint_as_float(u[i] << 16), acc[2 * i]);
      acc[2 * i + 1] =
          fmaf(wn, __uint_as_float(u[i] & 0xffff0000u), acc[2 * i + 1]);
    }
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack_chunk(const float* acc) {
  unsigned int u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      u[i] = __float_as_uint(acc[i]);
    } else {
      u[i] = static_cast<unsigned int>(
                 __bfloat16_as_ushort(__float2bfloat16(acc[2 * i]))) |
             (static_cast<unsigned int>(
                  __bfloat16_as_ushort(__float2bfloat16(acc[2 * i + 1])))
              << 16);
    }
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// The normalised weights of a compile-time count, in registers.
template <int kC>
__device__ __forceinline__ void normalise(const float* __restrict__ w,
                                          float (&wn)[kC]) {
  float total = 0.0f;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    wn[c] = __ldg(w + c);
    total += wn[c];
  }
#pragma unroll
  for (int c = 0; c < kC; ++c) wn[c] = wn[c] / total;
}

// The normalised weights of a run-time count, in shared memory.
__device__ __forceinline__ void normalise(const float* __restrict__ w,
                                          float* wn, int C) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) wn[c] = w[c];
  __syncthreads();
  float total = 0.0f;
  for (int c = 0; c < C; ++c) total += wn[c];
  __syncthreads();  // every thread has summed before wn is overwritten
  for (int c = threadIdx.x; c < C; c += blockDim.x) wn[c] = wn[c] / total;
  __syncthreads();
}

// x, out as 16-byte chunks; R = N / V chunks a replica row.  Tile t of a
// block covers chunks [t * kThreads * U, (t + 1) * kThreads * U): thread
// i takes chunks i, i + kThreads, ..., so a warp's load is 512
// contiguous bytes of one row.
template <typename T, int kC>
__global__ void __launch_bounds__(kThreads, kVecBlocksPerSM)
    fedavg_reduce_vec_kernel(const uint4* __restrict__ x,
                             const float* __restrict__ w,
                             uint4* __restrict__ out, int C, long long R) {
  constexpr int V = 16 / sizeof(T);
  constexpr int U = vec_unroll(kC);
  constexpr int kWn = kC > 0 ? kC : 1;
  extern __shared__ float wn_shared[];
  float wn[kWn];
  if constexpr (kC > 0) {
    normalise<kC>(w, wn);
  } else {
    normalise(w, wn_shared, C);
  }
  const long long tile = static_cast<long long>(kThreads) * U;
  for (long long base = blockIdx.x * tile + threadIdx.x; base < R;
       base += gridDim.x * tile) {
    float acc[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < V; ++i) acc[u][i] = 0.0f;
    if constexpr (kC > 0) {
      uint4 v[kC][U];
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const long long k = base + u * kThreads;
          v[c][u] = k < R ? __ldcs(x + c * R + k) : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int u = 0; u < U; ++u) fma_chunk<T>(wn[c], v[c][u], acc[u]);
    } else {
      for (int c = 0; c < C; ++c) {
        uint4 v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const long long k = base + u * kThreads;
          v[u] = k < R ? __ldcs(x + c * R + k) : make_uint4(0, 0, 0, 0);
        }
        const float wc = wn_shared[c];
#pragma unroll
        for (int u = 0; u < U; ++u) fma_chunk<T>(wc, v[u], acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long k = base + u * kThreads;
      if (k < R) __stcs(out + k, pack_chunk<T>(acc[u]));
    }
  }
}

// One element a load; tile t covers columns [t * kTh * kS, (t + 1) * kTh
// * kS): thread i takes columns i, i + kTh, ...
template <typename T, int kC>
__global__ void __launch_bounds__(scalar_threads(kC))
    fedavg_reduce_scalar_kernel(const T* __restrict__ x,
                                const float* __restrict__ w,
                                T* __restrict__ out, int C, long long N) {
  constexpr int kTh = scalar_threads(kC);
  constexpr int kS = scalar_columns(kC);
  constexpr int kWn = kC > 0 ? kC : 1;
  extern __shared__ float wn_shared[];
  float wn[kWn];
  if constexpr (kC > 0) {
    normalise<kC>(w, wn);
  } else {
    normalise(w, wn_shared, C);
  }
  const long long tile = static_cast<long long>(kTh) * kS;
  for (long long base = blockIdx.x * tile + threadIdx.x; base < N;
       base += gridDim.x * tile) {
    float acc[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) acc[s] = 0.0f;
    if constexpr (kC > 0) {
      T v[kC][kS];
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int s = 0; s < kS; ++s) {
          const long long n = base + s * kTh;
          v[c][s] = n < N ? x[c * N + n] : from_float<T>(0.0f);
        }
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int s = 0; s < kS; ++s)
          acc[s] = fmaf(wn[c], to_float(v[c][s]), acc[s]);
    } else {
#pragma unroll (kScalarUnroll)
      for (int c = 0; c < C; ++c) {
        const float wc = wn_shared[c];
#pragma unroll
        for (int s = 0; s < kS; ++s) {
          const long long n = base + s * kTh;
          if (n < N) acc[s] = fmaf(wc, to_float(x[c * N + n]), acc[s]);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const long long n = base + s * kTh;
      if (n < N) out[n] = from_float<T>(acc[s]);
    }
  }
}

// An empty kernel on an instance's grid (launch_shape): the launch floor
// that chip_smoke.py times beside the kernel (floor_ms).
__global__ void fedavg_reduce_floor_kernel() {}

template <typename T, int kC>
void launch_one(bool vec, const void* x, const void* w, void* out, int C,
                long long N, Launch shape, cudaStream_t stream) {
  const size_t smem = kC > 0 ? 0 : static_cast<size_t>(C) * sizeof(float);
  if (vec) {
    fedavg_reduce_vec_kernel<T, kC>
        <<<shape.blocks, shape.threads, smem, stream>>>(
        static_cast<const uint4*>(x), static_cast<const float*>(w),
        static_cast<uint4*>(out), C,
        N / static_cast<long long>(16 / sizeof(T)));
  } else {
    fedavg_reduce_scalar_kernel<T, kC>
        <<<shape.blocks, shape.threads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(w),
        static_cast<T*>(out), C, N);
  }
}

template <typename T>
int launch(bool vec, const void* x, const void* w, void* out, int C,
           long long N, int sms, void* stream_) {
  const auto stream = static_cast<cudaStream_t>(stream_);
  const Launch shape = launch_shape(vec, sizeof(T), C, N, sms);
  switch (C) {
#define FEDAVG_CASE(k)                                              \
  case k:                                                           \
    launch_one<T, k>(vec, x, w, out, C, N, shape, stream);          \
    break;
    FEDAVG_CASE(1) FEDAVG_CASE(2) FEDAVG_CASE(3) FEDAVG_CASE(4)
    FEDAVG_CASE(5) FEDAVG_CASE(6) FEDAVG_CASE(7) FEDAVG_CASE(8)
#undef FEDAVG_CASE
    default:
      launch_one<T, 0>(vec, x, w, out, C, N, shape, stream);
  }
  static_assert(kStaticC == 8, "the cases above list 1..kStaticC");
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` over the grid launch_shape gives for a card of `sms`
// SMs; return cudaGetLastError() (0 when the launch was accepted).  The
// caller checks shapes, guarantees C, N >= 1, and takes the vector
// entries only where N * item % 16 == 0 and x and out are 16-byte
// aligned.
extern "C" int fedavg_reduce_vector_f32(const void* x, const void* w,
                                        void* out, int C, long long N,
                                        int sms, void* stream) {
  return launch<float>(true, x, w, out, C, N, sms, stream);
}

extern "C" int fedavg_reduce_vector_bf16(const void* x, const void* w,
                                         void* out, int C, long long N,
                                         int sms, void* stream) {
  return launch<__nv_bfloat16>(true, x, w, out, C, N, sms, stream);
}

extern "C" int fedavg_reduce_scalar_f32(const void* x, const void* w,
                                        void* out, int C, long long N,
                                        int sms, void* stream) {
  return launch<float>(false, x, w, out, C, N, sms, stream);
}

extern "C" int fedavg_reduce_scalar_bf16(const void* x, const void* w,
                                         void* out, int C, long long N,
                                         int sms, void* stream) {
  return launch<__nv_bfloat16>(false, x, w, out, C, N, sms, stream);
}

// The blocks of the launch an entry above makes: the vector (vec 1) or
// scalar (vec 0) instance over items of `item` bytes.
extern "C" int fedavg_reduce_blocks(int vec, int item, int C, long long N,
                                    int sms) {
  return launch_shape(vec != 0, item, C, N, sms).blocks;
}

// The empty kernel on the grid of that launch.
extern "C" int fedavg_reduce_floor(int vec, int item, int C, long long N,
                                   int sms, void* stream) {
  const Launch shape = launch_shape(vec != 0, item, C, N, sms);
  fedavg_reduce_floor_kernel<<<shape.blocks, shape.threads, 0,
                               static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
