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
// where fp32 arithmetic would start to matter.  At C = 20 over the full
// traffic GRU (N = 148,737) it reads 11.9 MB: about 3.6 us at 3.35 TB/s.
//
// Design (simple and right first): a 1-D grid over N, one column per
// thread.  Each block sums the C weights once into shared memory and
// normalises them there; each thread then walks its column's C values,
// row by row, so a warp reads 32 neighbouring elements of one replica at a
// time (coalesced).  The ragged edge of N is masked in the kernel: no
// padding copy as on the TPU.  Every block sums the weights in the same
// order, so all columns see the same normalised weights.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

constexpr int kThreads = 256;

template <typename T>
__global__ void fedavg_reduce_kernel(const T* __restrict__ x,
                                     const float* __restrict__ w,
                                     T* __restrict__ out, int C,
                                     long long N) {
  extern __shared__ float wn[];  // (C,) normalised weights
  __shared__ float total;
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int c = 0; c < C; ++c) s += w[c];
    total = s;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) wn[c] = w[c] / total;
  __syncthreads();

  const long long n = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (n >= N) return;
  float acc = 0.0f;
  for (int c = 0; c < C; ++c) acc = fmaf(wn[c], to_float(x[c * N + n]), acc);
  out[n] = from_float<T>(acc);
}

template <typename T>
int launch(const void* x, const void* w, void* out, int C, long long N,
           void* stream) {
  const long long blocks = (N + kThreads - 1) / kThreads;
  fedavg_reduce_kernel<T>
      <<<static_cast<unsigned int>(blocks), kThreads, C * sizeof(float),
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<const float*>(w),
          static_cast<T*>(out), C, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; return cudaGetLastError() (0 when the launch was
// accepted).  The caller checks shapes and guarantees C, N >= 1.
extern "C" int fedavg_reduce_f32(const void* x, const void* w, void* out,
                                 int C, long long N, void* stream) {
  return launch<float>(x, w, out, C, N, stream);
}

extern "C" int fedavg_reduce_bf16(const void* x, const void* w, void* out,
                                  int C, long long N, void* stream) {
  return launch<__nv_bfloat16>(x, w, out, C, N, stream);
}
