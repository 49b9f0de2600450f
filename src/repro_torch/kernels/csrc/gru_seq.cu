// gru_seq: the GRU recurrence of the paper's traffic model, written for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/gru_cell.py:gru_seq (its
// pallas_call is at gru_cell.py:50).  Same function: xw (B,T,3h) is the
// input projection x@W_x+b computed outside the kernel, h0 (B,h), w_h
// (h,3h); the output is every hidden state (B,T,h), fp32 throughout.
//
// What bounds it on this card: at the serving shapes (B <= 16, T = 12,
// h = 128) one call moves about 0.6 MB and does about 19 MFLOP, well under
// a microsecond at the card's peak rates.  The recurrence is what costs:
// T dependent steps, each a matrix-vector product h@W_h, a block-wide
// barrier, the gates, and another barrier.  Nothing runs across time, so
// the kernel is bound by the latency of that chain, not by bytes or FLOPs.
//
// Design (simple and right first): one block per sequence.  The hidden
// state (h floats) and the step's h@W_h (3h floats) live in shared memory,
// so the state stays fp32 on chip for all T steps and h@W_h never reaches
// device memory.  Thread j owns gate columns j, j+blockDim.x, ... and walks
// W_h row by row: neighbouring threads read neighbouring addresses, and
// W_h (196,608 bytes at h = 128) is read by every block and every step, so
// it stays in the 50 MB L2.  After a barrier, thread i owns hidden units
// i, i+blockDim.x, ...: it forms r, z, n and the new h from xw[b,t,:] and
// h@W_h and writes it to shared memory and to out[b,t,:].  The loop over T
// runs inside the block.  expf/tanhf (no fast math) keep the result within
// 2e-5 of the fp32 reference.  Any B (one block each); h up to 3072, so
// that the 4h floats of shared memory fit the 48 KB a block gets without
// opting in.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void gru_seq_kernel(const float* __restrict__ xw,
                               const float* __restrict__ h0,
                               const float* __restrict__ w_h,
                               float* __restrict__ out, int T, int H) {
  extern __shared__ float smem[];
  float* hs = smem;      // (H,)  hidden state, fp32 for all T steps
  float* hw = smem + H;  // (3H,) this step's h @ W_h
  const int H3 = 3 * H;
  const size_t b = blockIdx.x;

  for (int i = threadIdx.x; i < H; i += blockDim.x) hs[i] = h0[b * H + i];
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    for (int j = threadIdx.x; j < H3; j += blockDim.x) {
      float acc = 0.0f;
#pragma unroll 8
      for (int k = 0; k < H; ++k) {
        acc = fmaf(hs[k], __ldg(w_h + static_cast<size_t>(k) * H3 + j), acc);
      }
      hw[j] = acc;
    }
    __syncthreads();  // h@W_h complete; nobody reads hs for this step now

    const float* x = xw + (b * T + t) * H3;
    float* o = out + (b * T + t) * H;
    for (int i = threadIdx.x; i < H; i += blockDim.x) {
      const float r = sigmoid(x[i] + hw[i]);
      const float z = sigmoid(x[H + i] + hw[H + i]);
      const float n = tanhf(x[2 * H + i] + r * hw[2 * H + i]);
      const float h_new = (1.0f - z) * n + z * hs[i];
      hs[i] = h_new;
      o[i] = h_new;
    }
    __syncthreads();  // new state visible before the next product
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 when the launch was
// accepted).  The caller checks shapes and guarantees B, T >= 1.
extern "C" int gru_seq_f32(const void* xw, const void* h0, const void* w_h,
                           void* out, int B, int T, int H, void* stream) {
  int threads = ((3 * H + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = 4 * static_cast<size_t>(H) * sizeof(float);
  gru_seq_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xw), static_cast<const float*>(h0),
      static_cast<const float*>(w_h), static_cast<float*>(out), T, H);
  return static_cast<int>(cudaGetLastError());
}
