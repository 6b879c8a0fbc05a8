// Mamba-1 selective scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel selective_scan_pallas (_kernel) of
// src/repro/kernels/sscan/kernel.py. Held to the plain PyTorch version,
// src/repro_torch/kernels/sscan/ref.py, within rtol 1e-4 / atol 1e-5 (the
// bound of tests/test_sscan_kernel.py): this kernel runs the recurrence step
// by step, the plain version as a chunked associative scan, so the float32
// products and sums run in another order.
//
// Contract, per batch row b and channel d, over t = 0 .. S-1:
//   h[n]   = exp(dt[b,t,d] * A[d,n]) * h[n] + B[b,t,n] * (dt[b,t,d] * x[b,t,d])
//   y[b,t,d] = sum_n C[b,t,n] * h[n]
// starting from h0[b,d,:]; h_last[b,d,:] is h after the last step. h0 and
// h_last may be the same buffer (the serving cache is updated in place): each
// lane reads its own states before it writes them.
//
// Bound on the H100. Bytes: dt, x and y are (B,S,D) float32 and B, C are
// (B,S,N), plus A, h0 and h_last once. Operations: one exp per (b,t,d,n), on
// the SFU at 16 a clock an SM, and ~6 float32 operations besides. At decode
// (S = 1) the bytes of h0, A and h_last bound it (~2.9 us at falcon-mamba's
// (8, 1, 8192, 16)); at prefill length the exps do (~1 ms at S = 4096).
// The TPU kernel's point, that the (S, D, N) state expansion never reaches
// device memory, holds here too: the state lives in registers.
//
// Design:
//  * L lanes own one channel, 16 / L states each (N <= 16; states past N are
//    masked). A CTA owns 64 channels of one batch row, 64 L threads.
//  * Decode (S < kPrefill = 8): L = 4. h0, A and h_last move as one float4
//    a lane, so a warp reads and writes 8 channels' 512 contiguous bytes, and
//    the y sum over N is two xor-shuffles inside the lane quad. At the decode
//    shape that is 262144 threads, enough to fill the card.
//  * Prefill: L = 1. Every state a thread owns shares the step's dt, x and
//    B, C reads and there is no shuffle, so a step costs the fewest
//    instructions, and the SFU's exps come nearest to being the limit (on
//    the H100, L = 1 beat L = 2 and L = 4 at prefill length, L = 4 won at
//    decode).
//  * The stream is staged: dt and x of kStage steps of the CTA's channels
//    and the B and C rows of those steps are copied into shared memory with
//    cp.async (16 bytes a copy when rows and pointers allow), two stages
//    deep, so the sequential recurrence never waits on device memory.
//  * exp(dt A) is ex2.approx of dt * (A log2 e), with A log2 e taken once a
//    state, and the build contracts multiply-adds to FMA (no -fmad=false);
//    y's sum over the states runs in four partial sums. The float64 witness
//    in chip_smoke.py holds the kernel against a float64 recurrence beside
//    the plain version; with these choices the kernel came out the nearer
//    of the two (expf was slower and farther on h_last).
//  * No split of S across CTAs: a second pass would double the exp work.
// Known costs: two barriers a stage of kStage steps, and its copies; at
// prefill length the issue of ~6 instructions an exp beside the SFU's, with
// 16 warps an SM (65536 channels at the falcon-mamba shape), keeps it short
// of the SFU rate.

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int kMaxN = 16;     // states a channel
constexpr int kChan = 64;     // channels a CTA
constexpr int kStage = 16;    // steps a stage
constexpr int kPrefill = 8;   // from this many steps on, one lane a channel
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one stage, in floats: dt and x (kStage x kChan), then the
// B and C rows (kStage x kMaxN, zero past N).
constexpr int kStageWords = 2 * kStage * kChan + 2 * kStage * kMaxN;
constexpr size_t kSmemBytes = 2 * kStageWords * sizeof(float);

// Issue the copies of steps t0 .. t0 + kStage of batch row b into stage st
// and commit them as one group. Steps past s and channels past d are left
// alone (never read into a result); B and C past n are zero. kVec: d and n
// are multiples of 4 and the pointers 16-byte aligned, so four floats go in
// one copy.
template <int kThreads, bool kVec>
__device__ __forceinline__ void stage_in(float* st, const float* dt,
                                         const float* x, const float* bm,
                                         const float* cm, size_t row, int t0,
                                         int s, int ch0, int d, int n) {
  constexpr int V = kVec ? 4 : 1;  // floats a copy
  float* sdt = st;
  float* sx = st + kStage * kChan;
  float* sb = st + 2 * kStage * kChan;
  float* sc = sb + kStage * kMaxN;
  static_assert(kStage * kChan % (V * kThreads) == 0, "whole rounds");
#pragma unroll
  for (int u = 0; u < kStage * kChan / (V * kThreads); ++u) {
    const int i = (threadIdx.x + u * kThreads) * V;
    const int k = i / kChan, c = i % kChan;
    if (t0 + k < s && ch0 + c < d) {
      const size_t at = (row + t0 + k) * d + ch0 + c;
      cp_async<4 * V>(sdt + i, dt + at);
      cp_async<4 * V>(sx + i, x + at);
    }
  }
  for (int i = threadIdx.x * V; i < kStage * kMaxN; i += kThreads * V) {
    const int k = i / kMaxN, j = i % kMaxN;
    if (t0 + k < s) {
      const bool on = j < n;
      const size_t at = on ? (row + t0 + k) * n + j : 0;
      cp_async<4 * V>(sb + i, bm + at, on);
      cp_async<4 * V>(sc + i, cm + at, on);
    }
  }
  cp_async_commit();
}

// A lane's P states from p[first ..]: zero past n. kVec: float4 moves.
template <int P, bool kVec>
__device__ __forceinline__ void load_states(const float* p, int first, int n,
                                            float* v) {
#pragma unroll
  for (int i = 0; i < P; i += 4) {
    if (kVec) {
      const float4 q = first + i < n ? *(const float4*)(p + first + i)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
      v[i] = q.x;
      v[i + 1] = q.y;
      v[i + 2] = q.z;
      v[i + 3] = q.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[i + e] = first + i + e < n ? p[first + i + e] : 0.f;
    }
  }
}

template <int P, bool kVec>
__device__ __forceinline__ void store_states(float* p, int first, int n,
                                             const float* v) {
#pragma unroll
  for (int i = 0; i < P; i += 4) {
    if (kVec) {
      if (first + i < n)
        *(float4*)(p + first + i) =
            make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (first + i + e < n) p[first + i + e] = v[i + e];
    }
  }
}

// exp(dt A) = 2^(dt * A log2 e), on the SFU (ex2.approx: ~2 ulp; a result
// below 2^-126 flushes to zero, where its product with h is below float32's
// resolution of any h the recurrence carries). a2 holds A log2 e.
__device__ __forceinline__ float decay(float dtv, float a2) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(dtv * a2));
  return r;
}

// L lanes a channel, P = 16 / L states a lane; CTAs of 64 channels.
template <int L, bool kVec>
__global__ void __launch_bounds__(kChan * L)
    sscan_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                 const float* __restrict__ a, const float* __restrict__ bm,
                 const float* __restrict__ cm, const float* h0,
                 float* __restrict__ y, float* h_last, int s, int d, int n) {
  constexpr int kThreads = kChan * L;
  constexpr int P = kMaxN / L;
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int ch0 = blockIdx.x * kChan;
  const int c = threadIdx.x / L;  // channel in the CTA
  const int q = threadIdx.x % L;  // lane in the channel
  const int ch = ch0 + c;
  const bool live = ch < d;
  const int first = q * P;  // the lane's first state

  const size_t row = (size_t)b * s;
  const int nstages = (s + kStage - 1) / kStage;
  if (nstages > 0)
    stage_in<kThreads, kVec>(smem, dt, x, bm, cm, row, 0, s, ch0, d, n);

  float h[P], av[P];  // av: A, then A log2 e
  if (live) {
    load_states<P, kVec>(h0 + ((size_t)b * d + ch) * n, first, n, h);
    load_states<P, kVec>(a + (size_t)ch * n, first, n, av);
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) h[i] = av[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < P; ++i) av[i] *= kLog2e;

  for (int si = 0; si < nstages; ++si) {
    const int t0 = si * kStage;
    if (si + 1 < nstages) {
      stage_in<kThreads, kVec>(smem + ((si + 1) & 1) * kStageWords, dt, x,
                               bm, cm, row, t0 + kStage, s, ch0, d, n);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // stage si has landed, from every thread's copies
    const float* st = smem + (si & 1) * kStageWords;
    const float* sdt = st + c;
    const float* sx = st + kStage * kChan + c;
    const float* sb = st + 2 * kStage * kChan + first;
    const float* sc = sb + kStage * kMaxN;
    const int steps = min(kStage, s - t0);
    float* yrow = y + (row + t0) * d + ch;
    for (int k = 0; k < steps; ++k) {
      const float dtv = sdt[k * kChan];
      const float dtx = dtv * sx[k * kChan];
      // y's sum over the states in four partial sums (a shorter chain)
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < P; i += 4) {
        const float4 bq = *(const float4*)(sb + k * kMaxN + i);
        const float4 cq = *(const float4*)(sc + k * kMaxN + i);
        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
        const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          h[i + e] = decay(dtv, av[i + e]) * h[i + e] + bv[e] * dtx;
          acc[e] += cv[e] * h[i + e];
        }
      }
      float sum = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
      for (int m = 1; m < L; m *= 2) sum += __shfl_xor_sync(~0u, sum, m);
      if (q == 0 && live) yrow[(size_t)k * d] = sum;
    }
    __syncthreads();  // stage si is read before its buffer is refilled
  }
  if (live)
    store_states<P, kVec>(h_last + ((size_t)b * d + ch) * n, first, n, h);
}

bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

template <int L, bool kVec>
void launch(const float* dt, const float* x, const float* a, const float* bm,
            const float* cm, const float* h0, float* y, float* h_last,
            int bsz, int s, int d, int n, cudaStream_t stream) {
  const dim3 grid((unsigned)((d + kChan - 1) / kChan), (unsigned)bsz);
  sscan_kernel<L, kVec><<<grid, kChan * L, kSmemBytes, stream>>>(
      dt, x, a, bm, cm, h0, y, h_last, s, d, n);
}

}  // namespace

extern "C" {

int sscan_max_state() { return kMaxN; }

// dt, x, y: (bsz, s, d); a: (d, n); bm, cm: (bsz, s, n); h0, h_last:
// (bsz, d, n); all float32, contiguous, on the device. h0 may equal h_last.
int sscan_forward(const void* dt, const void* x, const void* a,
                  const void* bm, const void* cm, const void* h0, void* y,
                  void* h_last, int bsz, int s, int d, int n, void* stream) {
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  if (bsz == 0 || d == 0) return (int)cudaSuccess;
  const bool vec = n % 4 == 0 && d % 4 == 0 && aligned16(dt) &&
                   aligned16(x) && aligned16(a) && aligned16(bm) &&
                   aligned16(cm) && aligned16(h0) && aligned16(h_last);
  auto kern = s < kPrefill ? (vec ? launch<4, true> : launch<4, false>)
                            : (vec ? launch<1, true> : launch<1, false>);
  kern((const float*)dt, (const float*)x, (const float*)a, (const float*)bm,
       (const float*)cm, (const float*)h0, (float*)y, (float*)h_last, bsz, s,
       d, n, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

const char* sscan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
