// gru_seq: the GRU recurrence of the paper's traffic model, written for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/gru_cell.py:gru_seq (its
// pallas_call is at gru_cell.py:50).  Same function: xw (B,T,3h) is the
// input projection x@W_x+b computed outside the kernel, h0 (B,h), w_h
// (h,3h); the output is every hidden state (B,T,h), fp32 throughout:
//   r = sigmoid(x_r + (hW)_r), z = sigmoid(x_z + (hW)_z),
//   n = tanh(x_n + r * (hW)_n), h' = (1 - z) * n + z * h.
//
// What bounds it on this card: at the serving shapes (B <= 16, T = 12,
// h = 128) one call moves about 0.6 MB and does about 19 MFLOP, well under
// a microsecond at the card's peak rates.  The recurrence is what costs:
// T dependent steps, each a matrix-vector product h@W_h, the gates, and an
// exchange of the new state before the next step.  The kernel is bound by
// the latency of that chain, not by bytes or FLOPs.
//
// Two instances, chosen by the wrapper from h alone (kernels/gru_cell.py):
//
// The cluster instance (h <= 128): a thread-block cluster of S blocks runs
// bb batch rows; the grid is ceil(B / bb) clusters.  Block c of a cluster
// owns hidden units [c*U, (c+1)*U), U = ceil(h / S), and their r, z and n
// columns of W_h, so it forms r, z, n and h' for its units with no
// exchange inside a step.
//   - Each unit is 8 lanes (four units a warp).  Lane l holds W_h[k,
//     unit's 3 columns] for its KC rows k (KC = 2, 4, 8 or 16, the least
//     with 8 * KC >= h) in registers for all T steps: the block's columns
//     are copied once into shared memory (coalesced cp.async) and from
//     there into registers, so no load of W_h happens inside the step loop.
//   - The state h_t (bb rows, h wide, fp32) is double-buffered in every
//     block's shared memory.  A step: each lane forms bb x 3 partial dot
//     products over its KC rows k (3 * bb independent FMA chains of KC
//     links, the rows of h read as 8- or 16-byte broadcasts), then the 8
//     lanes fold them with shuffles, halving the rows a lane keeps at each
//     of the 3 rounds (xor 4, 2, 1), so that lane l ends with the three
//     sums of one row (with bb < 8, 8 / bb lanes hold each row).  That
//     lane forms the gates and h' and stores h' into the other buffer of
//     every block of the cluster through distributed shared memory (the
//     8 / bb lanes of a row share the S stores), then stores it to out.
//     Eight lanes a unit rather than 16 halve the warps that repeat the
//     gates, which shortens a step more than the longer FMA chains cost.
//   - The exchange: each remote store is an st.async that counts its 4
//     bytes on the receiving block's mbarrier of that buffer, and a step
//     begins by waiting for the mbarrier to have counted all bb x h floats
//     of h_t.  A cluster barrier (barrier.cluster.arrive.release / wait)
//     a step would also order the stores: its release compiles to
//     MEMBAR.ALL.GPU, which waits for the step's global stores and loads
//     as well, and so takes longer than the exchange itself.  The one
//     cluster barrier is at the start, when every block holds h0 and its
//     mbarriers.
//   - xw is staged with 4-byte cp.async into a per-thread ring of two
//     8-step chunks in shared memory, a chunk ahead, so inside the loop the
//     only accesses to device memory are the stores to out and the ring's
//     refills, and a thread waits for its copies once every 8 steps.
//   - expf/tanhf (no fast math) keep the result within 2e-5 of the fp32
//     reference.  At most 512 threads (64 units) a block, 128 registers a
//     thread, and bb <= 8.
//
// The general instance (128 < h <= 3072), the port's first kernel: one
// block per sequence, the state and h@W_h in shared memory, W_h read
// through L2 at every step by every block.  It is kept for widths whose
// W_h slice does not fit a cluster's registers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// --------------------------------------------------------------------------
// General instance: one block per sequence (h up to 3072, so that the 4h
// floats of shared memory fit the 48 KB a block gets without opting in).
// --------------------------------------------------------------------------

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

// --------------------------------------------------------------------------
// Cluster instance
// --------------------------------------------------------------------------

constexpr int kLanes = 8;         // lanes of one unit's dot products
constexpr int kChunk = 8;         // steps of xw staged at a time
constexpr int kMaxThreads = 512;  // 64 units a block
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kMaxHidden = 128;   // kLanes * 16 rows of W_h a lane

// arrival at the cluster barrier with no memory ordering: a release would
// compile to MEMBAR.ALL.GPU and wait for every outstanding global access
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the address of the same shared-memory location in block `rank` of the
// cluster
__device__ __forceinline__ unsigned cluster_addr(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// A 4-byte store into another block's shared memory that counts its bytes
// on that block's mbarrier `bar` when it lands: no fence is needed.
__device__ __forceinline__ void store_remote(unsigned addr, float v,
                                             unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr), "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

// this block's one arrival on `bar` for the next phase, which completes
// once `bytes` more have landed
__device__ __forceinline__ void mbar_expect(unsigned bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait for phase `parity` of `bar` to complete.  A phase that has not
// completed after a second (a lost store) traps instead of hanging the
// card.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  unsigned long long since = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (since == 0) {
      since = now_ns();
    } else if (now_ns() - since > 1000000000ull) {
      __trap();
    }
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// G consecutive floats (8 or 16 bytes) from shared memory
template <int G>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[G]) {
  if constexpr (G == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  }
}

// The row that lane l of a unit holds after fold(): each round that
// halves the rows keeps the upper half in the lanes whose mask bit is set.
template <int RB>
__device__ __forceinline__ int row_of(int l) {
  int row = 0;
#pragma unroll
  for (int m = kLanes / 2, r = RB; m > 0; m >>= 1) {
    if (r > 1) {
      r >>= 1;
      if (l & m) row += r;
    }
  }
  return row;
}

// c ? x : y without a branch.  Written as a plain ?: in fold(), the
// compiler may branch on the lane's mask bit instead, and the shuffles then
// run in divergent code, on their slow path, several times slower.
__device__ __forceinline__ float select(bool c, float x, float y) {
  float out;
  asm("{\n .reg .pred p;\n setp.ne.b32 p, %3, 0;\n selp.f32 %0, %1, %2, p;\n}\n"
      : "=f"(out) : "f"(x), "f"(y), "r"(static_cast<int>(c)));
  return out;
}

// Sum a[0..R)[3] over the 8 lanes of a unit, pairing lane l with l ^ M,
// then l ^ M/2, ... down to l ^ 1.  While a lane holds more than one row, a
// round halves them: the lane keeps one half and sends the other.  Every
// sum is the same tree of the 8 lanes' partials for every bb.
template <int R, int M, int RB>
__device__ __forceinline__ void fold(float (&a)[RB][3], int l) {
  if constexpr (M > 0) {
    if constexpr (R > 1) {
      constexpr int kHalf = R / 2;
      const bool up = (l & M) != 0;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          const float keep = select(up, a[i + kHalf][g], a[i][g]);
          const float send = select(up, a[i][g], a[i + kHalf][g]);
          a[i][g] = keep + __shfl_xor_sync(0xffffffffu, send, M);
        }
      }
      fold<kHalf, M / 2, RB>(a, l);
    } else {
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        a[0][g] += __shfl_xor_sync(0xffffffffu, a[0][g], M);
      }
      fold<1, M / 2, RB>(a, l);
    }
  }
}

// Shared memory of both cluster kernels, from its start `base`: two
// mbarriers (16 bytes, one a state buffer), the double-buffered state
// [2][RB][HP]; then, the recurrence only, the xw ring [2][kChunk][3][NT]
// and W_h's columns of the block's units [H][3U + 1].
constexpr int kBars = 16;  // bytes of the two mbarriers

// What a thread of either cluster kernel is: its unit, its row after the
// fold and where its rows lie in the batch.
template <int RB>
struct Place {
  static constexpr int kRep = kLanes / RB;  // lanes that hold one row
  unsigned base;  // shared address of the block's shared memory
  int S, tid, l, U, u_loc, u, r, rep, b;
  bool unit_ok, row_ok;

  __device__ __forceinline__ Place(int B, int H, unsigned base_) : base(base_) {
    cg::cluster_group cluster = cg::this_cluster();
    S = static_cast<int>(cluster.num_blocks());
    tid = threadIdx.x;
    l = tid & (kLanes - 1);
    U = (H + S - 1) / S;
    u_loc = tid / kLanes;
    u = static_cast<int>(cluster.block_rank()) * U + u_loc;
    unit_ok = u_loc < U && u < H;
    r = row_of<RB>(l);
    rep = l % kRep;
    b = (blockIdx.x / S) * RB + r;
    row_ok = b < B;
  }

  // h' of (row r, unit u) into state buffer `buf` of every block of the
  // cluster, counted on that block's mbarrier `buf`; the kRep lanes that
  // hold the row share the S stores.  Every block thus receives RB * H
  // floats a step.
  __device__ __forceinline__ void exchange(int buf, int HP, float v) const {
    if (!unit_ok) return;
    const unsigned off = kBars + 4 * ((buf * RB + r) * HP + u);
    for (int q = rep; q < S; q += kRep) {
      const unsigned peer = cluster_addr(base, q);  // block q's shared memory
      store_remote(peer + off, v, peer + 8 * buf);
    }
  }
};

// h0's rows into state buffer 0 by cp.async, in the caller's commit group
// (zeros without h0 and in rows past B), zeros into the padding columns
// (past H) of both buffers; thread 0 sets up the two mbarriers.  Buffer 1's
// columns below H are left to the remote stores of h_1, so no local store
// races with them.
template <int RB>
__device__ __forceinline__ void init_state(float* hb, unsigned base,
                                           const float* h0, int B, int H,
                                           int HP, int S) {
  const int row0 = (blockIdx.x / S) * RB;
  for (int i = threadIdx.x; i < RB * HP; i += blockDim.x) {
    const int rr = i / HP, k = i % HP;
    const int b = row0 + rr;
    if (h0 != nullptr && k < H && b < B) {
      cp_async4(hb + i, h0 + static_cast<size_t>(b) * H + k);
    } else {
      hb[i] = 0.0f;
    }
    if (k >= H) hb[RB * HP + i] = 0.0f;
  }
  if (threadIdx.x == 0) {
    mbar_init(base);
    mbar_init(base + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// The one cluster barrier, once every block has set up its mbarriers
// (fence.mbarrier_init orders that for the cluster) and its own threads
// see its state (__syncthreads): past it, every block has started and can
// take remote stores.  `between` runs after the arrival.
template <typename F>
__device__ __forceinline__ void start_barrier(F between) {
  __syncthreads();
  cluster_arrive_relaxed();
  between();
  cluster_wait();
}

// Step t's exchange protocol, before the step reads state buffer t & 1:
// thread 0 arms the other buffer's mbarrier for the RB * H floats of h_{t+1}
// (remote stores may land before it does: the byte count runs negative
// until then), and every thread waits for h_t to have landed (its phase
// (t - 1) / 2 of mbarrier t & 1).  A block writes h_{t+1} into a buffer
// only once it holds h_t from every block, and every block sends h_t only
// after its warps have read that buffer for h_{t-1}'s step, so no store
// overtakes a read.
__device__ __forceinline__ void step_barrier(unsigned base, int t, int T,
                                             int RB, int H) {
  const int cur = t & 1;
  if (t + 1 < T && threadIdx.x == 0) mbar_expect(base + 8 * (cur ^ 1), RB * H * 4);
  if (t >= 1) mbar_wait(base + 8 * cur, ((t - 1) >> 1) & 1);
}

template <int KC, int RB>
__global__ void __launch_bounds__(kMaxThreads, 1)
    gru_seq_cluster_kernel(const float* __restrict__ xw,
                           const float* __restrict__ h0,
                           const float* __restrict__ w_h,
                           float* __restrict__ out, int B, int T, int H) {
  constexpr int G = KC < 4 ? KC : 4;  // floats of one shared-memory read
  constexpr int HP = kLanes * KC;     // padded width of a state row
  extern __shared__ float4 cluster_smem[];
  const unsigned base = smem_addr(cluster_smem);
  const Place<RB> p(B, H, base);
  // W_h's slice rows are 3U + 1 floats apart: the 8 lanes of a unit read
  // rows 4 apart, in 8 different banks
  const int NT = blockDim.x, H3 = 3 * H, WS = 3 * p.U + 1;
  float* hb = reinterpret_cast<float*>(cluster_smem + 1);
  float* xring = hb + 2 * RB * HP;
  float* ws = xring + 2 * kChunk * 3 * NT;
  const bool ok = p.unit_ok && p.row_ok;

  // W_h's 3U columns of this block's units, coalesced: lane e of each warp
  // copies elements e, e + 32, ... of each row k that the warp takes
  {
    const int u0 = p.u - p.u_loc, lane = p.tid & 31;
    for (int e = lane; e < 3 * p.U; e += 32) {
      const int g = e / p.U, uu = e - g * p.U;
      if (u0 + uu >= H) continue;
      const float* src = w_h + g * H + u0 + uu;
      for (int k = p.tid >> 5; k < H; k += NT >> 5) {
        cp_async4(ws + k * WS + e, src + static_cast<size_t>(k) * H3);
      }
    }
  }
  // this thread's xw of chunk c (steps c * kChunk on) into ring half c % 2;
  // one commit group a chunk, empty past T
  const auto stage = [&](int c) {
    float* dst = xring + (c & 1) * kChunk * 3 * NT + p.tid;
    const float* src = xw + static_cast<size_t>(p.b) * T * H3 + p.u;
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const int t = c * kChunk + s;
      if (t < T && ok) {
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          cp_async4(dst + (s * 3 + g) * NT, src + static_cast<size_t>(t) * H3 + g * H);
        }
      }
    }
    cp_async_commit();
  };
  init_state<RB>(hb, base, h0, B, H, HP, p.S);
  cp_async_commit();
  stage(0);
  cp_async_wait<0>();  // this thread's copies of W_h, h0 and chunk 0 landed
  __syncthreads();     // and every thread's

  // W_h[k, {u, H + u, 2H + u}] for the lane's rows k = j*8*G + l*G + q
  float w[KC / G][G][3];
#pragma unroll
  for (int j = 0; j < KC / G; ++j) {
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int k = j * kLanes * G + p.l * G + q;
      const bool in = p.unit_ok && k < H;
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        w[j][q][g] = in ? ws[k * WS + g * p.U + p.u_loc] : 0.0f;
      }
    }
  }
  start_barrier([&] { stage(1); });

  const int uc = p.unit_ok ? p.u : 0;
  for (int t = 0; t < T; ++t) {
    const float* hc = hb + (t & 1) * RB * HP;
    if (t > 0 && t % kChunk == 0) cp_async_wait<1>();  // chunk t / kChunk
    step_barrier(base, t, T, RB, H);

    float a[RB][3];
#pragma unroll
    for (int i = 0; i < RB; ++i) a[i][0] = a[i][1] = a[i][2] = 0.0f;
#pragma unroll
    for (int j = 0; j < KC / G; ++j) {
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        float v[G];
        load_vec<G>(hc + i * HP + j * kLanes * G + p.l * G, v);
#pragma unroll
        for (int q = 0; q < G; ++q) {
#pragma unroll
          for (int g = 0; g < 3; ++g) a[i][g] = fmaf(v[q], w[j][q][g], a[i][g]);
        }
      }
    }
    // read before the fold: its shuffles order every lane's reads of this
    // buffer before any lane's stores of h_{t+1}
    const float h_old = hc[p.r * HP + uc];
    const float* xs = xring + (((t / kChunk) & 1) * kChunk + t % kChunk) * 3 * NT + p.tid;
    const float xr = ok ? xs[0] : 0.0f;
    const float xz = ok ? xs[NT] : 0.0f;
    const float xn = ok ? xs[2 * NT] : 0.0f;
    fold<RB, kLanes / 2, RB>(a, p.l);

    const float r = sigmoid(xr + a[0][0]);
    const float z = sigmoid(xz + a[0][1]);
    const float n = tanhf(xn + r * a[0][2]);
    const float h_new = (1.0f - z) * n + z * h_old;
    if (t + 1 < T) p.exchange((t & 1) ^ 1, HP, h_new);
    if (ok && p.rep == 0) {
      out[(static_cast<size_t>(p.b) * T + t) * H + p.u] = h_new;
    }
    // the chunk after next into the ring half this chunk used
    if ((t + 1) % kChunk == 0) stage((t + 1) / kChunk + 1);
  }
}

// The cluster instance's exchange alone, on its grid and cluster shape: T
// steps of the state's stores into every block and the waits for them, and
// the stores to out, with no W_h, no xw, no product and no gates.  Only
// chip_smoke.py's floor_ms launches it: the least time any body of the
// recurrence can take at this shape.
template <int RB>
__global__ void __launch_bounds__(kMaxThreads, 1)
    gru_seq_floor_kernel(float* __restrict__ out, int B, int T, int H, int HP) {
  extern __shared__ float4 cluster_smem[];
  const unsigned base = smem_addr(cluster_smem);
  float* hb = reinterpret_cast<float*>(cluster_smem + 1);
  const Place<RB> p(B, H, base);
  init_state<RB>(hb, base, nullptr, B, H, HP, p.S);
  start_barrier([] {});
  const int uc = p.unit_ok ? p.u : 0;
  for (int t = 0; t < T; ++t) {
    step_barrier(base, t, T, RB, H);
    const float h_new = hb[((t & 1) * RB + p.r) * HP + uc] + 1.0f;
    __syncwarp();
    if (t + 1 < T) p.exchange((t & 1) ^ 1, HP, h_new);
    if (p.unit_ok && p.row_ok && p.rep == 0) {
      out[(static_cast<size_t>(p.b) * T + t) * H + p.u] = h_new;
    }
  }
}

int kc_for(int H) {
  for (int kc = 2; kc <= 16; kc *= 2) {
    if (H <= kLanes * kc) return kc;
  }
  return 0;
}

int threads_for(int H, int S) {
  constexpr int kUnitsPerWarp = 32 / kLanes;
  const int U = (H + S - 1) / S;
  return 32 * ((U + kUnitsPerWarp - 1) / kUnitsPerWarp);  // whole warps
}

// Whether (S, bb) is a shape the cluster instance takes at hidden size H.
bool cluster_takes(int H, int S, int bb) {
  const int kc = kc_for(H);
  const bool pow2_s = S >= 1 && S <= kMaxCluster && (S & (S - 1)) == 0;
  const bool pow2_bb = bb >= 1 && bb <= kLanes && (bb & (bb - 1)) == 0;
  return H >= 1 && H <= kMaxHidden && kc > 0 && pow2_s && pow2_bb &&
         threads_for(H, S) <= kMaxThreads;
}

template <typename Kernel, typename... Args>
int launch_clusters(Kernel kernel, int S, int clusters, int threads,
                    size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S * clusters);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  // reading the error clears it, so a refused shape leaves no error behind
  // for the next launch's check
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

size_t state_bytes(int RB, int HP) {
  return kBars + 2 * static_cast<size_t>(RB) * HP * sizeof(float);
}

template <int KC, int RB>
int launch_cluster(const float* xw, const float* h0, const float* w_h,
                   float* out, int B, int T, int H, int S,
                   cudaStream_t stream) {
  const int threads = threads_for(H, S);
  const int U = (H + S - 1) / S;
  const size_t smem =
      state_bytes(RB, kLanes * KC) +
      (2 * kChunk * 3 * static_cast<size_t>(threads) +
       static_cast<size_t>(H) * (3 * U + 1)) * sizeof(float);
  // above 48 KB a block's dynamic shared memory needs opting in, once for
  // each size this instance is launched with
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        gru_seq_cluster_kernel<KC, RB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(cudaGetLastError());
    allowed = smem;
  }
  return launch_clusters(gru_seq_cluster_kernel<KC, RB>, S, (B + RB - 1) / RB,
                         threads, smem, stream, xw, h0, w_h, out, B, T, H);
}

template <int KC>
int launch_cluster_rb(const float* xw, const float* h0, const float* w_h,
                      float* out, int B, int T, int H, int S, int bb,
                      cudaStream_t stream) {
  switch (bb) {
    case 1: return launch_cluster<KC, 1>(xw, h0, w_h, out, B, T, H, S, stream);
    case 2: return launch_cluster<KC, 2>(xw, h0, w_h, out, B, T, H, S, stream);
    case 4: return launch_cluster<KC, 4>(xw, h0, w_h, out, B, T, H, S, stream);
    default: return launch_cluster<KC, 8>(xw, h0, w_h, out, B, T, H, S, stream);
  }
}

template <int RB>
int launch_floor(float* out, int B, int T, int H, int S, cudaStream_t stream) {
  const int HP = kLanes * kc_for(H);
  return launch_clusters(gru_seq_floor_kernel<RB>, S, (B + RB - 1) / RB,
                         threads_for(H, S), state_bytes(RB, HP), stream, out,
                         B, T, H, HP);
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

// The cluster instance with clusters of S blocks, bb rows each (powers of
// two, S <= 8, bb <= 8, at most 512 threads a block); returns
// cudaErrorInvalidValue for a shape it does not take.  B, T >= 1.
extern "C" int gru_seq_cluster_f32(const void* xw, const void* h0,
                                   const void* w_h, void* out, int B, int T,
                                   int H, int S, int bb, void* stream) {
  if (!cluster_takes(H, S, bb)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* x = static_cast<const float*>(xw);
  const auto* h = static_cast<const float*>(h0);
  const auto* w = static_cast<const float*>(w_h);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (kc_for(H)) {
    case 2: return launch_cluster_rb<2>(x, h, w, o, B, T, H, S, bb, s);
    case 4: return launch_cluster_rb<4>(x, h, w, o, B, T, H, S, bb, s);
    case 8: return launch_cluster_rb<8>(x, h, w, o, B, T, H, S, bb, s);
    default: return launch_cluster_rb<16>(x, h, w, o, B, T, H, S, bb, s);
  }
}

// The floor kernel on the cluster instance's grid for (B, T, H, S, bb).
extern "C" int gru_seq_floor(void* out, int B, int T, int H, int S, int bb,
                             void* stream) {
  if (!cluster_takes(H, S, bb)) return static_cast<int>(cudaErrorInvalidValue);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (bb) {
    case 1: return launch_floor<1>(o, B, T, H, S, s);
    case 2: return launch_floor<2>(o, B, T, H, S, s);
    case 4: return launch_floor<4>(o, B, T, H, S, s);
    default: return launch_floor<8>(o, B, T, H, S, s);
  }
}
