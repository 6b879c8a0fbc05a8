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
                 float* __restrict__ y, float* h_last,
                 float* __restrict__ hs, int s, int d, int n) {
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
    // training: the state before the stage's first step, for the backward
    if (hs != nullptr && live)
      store_states<P, kVec>(hs + (((size_t)b * nstages + si) * d + ch) * n,
                            first, n, h);
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

// ---------------------------------------------------------------------------
// Backward (training). Replaces no TPU kernel: repro differentiates the XLA
// form of the scan (jax.grad of chunked_selective_scan), and its Pallas
// kernel has no backward. Given gy = dL/dy and gh = dL/dh_last (may be
// null: zero), with lam_t = dL/dh_t carried backwards,
//   lam_t  = gh (t = S-1) + gy_t C_t + decay_{t+1} lam_{t+1}
//   dx_t   = dt_t sum_n lam_t B_t
//   ddt_t  = sum_n lam_t (A decay_t h_{t-1} + B_t x_t)
//   dB_t   = sum_d lam_t dt_t x_t          dC_t = sum_d gy_t h_t
//   dA     = sum_{b,t} lam_t decay_t h_{t-1} dt_t
//   dh0    = decay_0 lam_0
// The forward saved h before every kStage-step stage (hs, (B, stages, D, N));
// the backward walks the stages in reverse. Bound on the H100: the bytes of
// dt, x, gy (read) and dx, ddt (written), (B, S, D) each, the saved states
// read once, B, C, dB, dC, A, dA and dh0 (811,597,824 bytes, 0.242 ms at
// falcon-mamba's training shape (8, 512, 8192, 16)); the exps (two a
// (b, t, d, n) here, ~0.26 ms on the SFU) come second. What holds this
// kernel is the issue of ~28 instructions a state a step and the latency of
// their chains, so its design:
//  * Four lanes a channel, four states a lane (as the forward at decode); a
//    warp holds 8 channels, a CTA 16 warps: 128 channels of one batch row,
//    one CTA an SM, 16 warps an SM at 128 registers a thread. The stage's
//    states stay in registers: the recompute runs its 16 steps forwards from
//    the saved state (the forward's ex2.approx decay) and keeps each step's
//    decayed state decay_t h_{t-1} (64 registers); the reverse pass takes
//    decay_t again (keeping it too would need 64 registers more, and 8 warps
//    an SM, which ran slower). Both passes are unrolled over the stage, two
//    steps a batch whose butterflies run side by side.
//  * The stream is staged: each stage's dt, x and gy of the CTA's channels
//    ([step][channel] planes, 16-byte copies where rows and pointers allow),
//    its B and C rows and the saved states are copied into shared memory by
//    cp.async while the stage before runs; steps past S, channels past D and
//    states past N are staged as zeros, which makes them identity steps, so
//    the unrolled passes carry no predicate. One CTA barrier a stage.
//  * dC_t is summed over channels in the recompute (which holds h_t), dB_t
//    in the reverse pass: each lane's 4 values by a transposing butterfly
//    over the warp's 8 channels (two transposing rounds, one plain). A lane
//    holds its states in an order that depends on its lane bits (slot i:
//    state first + (i ^ m)), so every lane keeps and sends the same slots
//    and no value is chosen by lane; the B and C rows are staged in the four
//    orders. dx and ddt sum over a channel's 4 lanes the same way. Each
//    warp's sums go to shared memory; once the next stage's barrier has
//    passed, the CTA adds its warps' sums in warp order and writes one
//    partial of dB and of dC a 128-channel CTA (67 MB written and read at
//    the training shape, a quarter of a partial a 32-channel warp).
//    sum_parts adds the partials in CTA order, and dA's per-(b, d) partials
//    over B. No atomics: every sum runs in a fixed order, so the gradient is
//    the same bit for bit from run to run.
//  * Values the loop does not need are made opaque to the compiler (opaque)
//    so that it recomputes them instead of holding them, at the register
//    limit, in spilled registers.

constexpr int kBwdWarps = 16;                  // warps a CTA of the backward
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdGroup = 8 * kBwdWarps;       // its channels: one partial
constexpr int kSums = kStage * kMaxN;          // a quantity's sums a stage
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory of the backward, in floats. A stage's buffer: dt, x and gy
// of the CTA's channels ([kStage][kBwdGroup] each), four copies of the B and
// of the C rows ([4][kStage][kMaxN]: copy m holds row[j ^ m] at j, the
// lanes' state orders, see sum_channels), and the saved states
// ([kBwdGroup][kMaxN]). Two such buffers, then two of the warps' sums
// ([2 quantities][kBwdWarps][kStage][kMaxN]).
constexpr int kPlane = kStage * kBwdGroup;
constexpr int kBwdStageWords = 3 * kPlane + 8 * kSums + kBwdGroup * kMaxN;
constexpr int kBwdRedWords = 2 * kBwdWarps * kSums;
constexpr size_t kBwdSmemBytes =
    (2 * kBwdStageWords + 2 * kBwdRedWords) * sizeof(float);

// v, as a value the compiler cannot carry across the stage loop: what is
// computed from it is computed where it is used, rather than held in a
// register through the loop (at 128 registers a thread, spilled).
__device__ __forceinline__ unsigned opaque(unsigned v) {
  asm volatile("mov.b32 %0, %0;" : "+r"(v));
  return v;
}

// Issue the copies of stage si into st and commit them as one group; steps
// past s, channels past d and states past n are zeros. vec_d: d is a
// multiple of 4 and dt, x, gy 16-byte aligned; vec_n: the same of n and hs.
// Every loop has a fixed trip count a thread; the index arithmetic is
// unsigned (shifts and masks).
__device__ __forceinline__ void bwd_stage_in(
    float* st, const float* dt, const float* x, const float* gy,
    const float* bm, const float* cm, const float* hs, int b, int si,
    int nst, int s, int ch0, int d, int n, bool vec_d, bool vec_n) {
  static_assert(kPlane % (4 * kBwdThreads) == 0 &&
                    4 * kSums % kBwdThreads == 0 &&
                    kBwdGroup * kMaxN % (4 * kBwdThreads) == 0,
                "whole rounds of copies");
  const unsigned tid = opaque(threadIdx.x);
  const unsigned t0 = si * kStage;
  const size_t row = (size_t)opaque(b) * s + t0;  // the stage's first row
  if (vec_d) {
#pragma unroll
    for (unsigned u = 0; u < kPlane / (4 * kBwdThreads); ++u) {
      const unsigned i = 4 * (tid + u * kBwdThreads);
      const unsigned k = i / kBwdGroup, c = i % kBwdGroup;
      const bool on = t0 + k < (unsigned)s && ch0 + c < (unsigned)d;
      const size_t at = on ? (row + k) * d + ch0 + c : 0;
      cp_async<16>(st + i, dt + at, on);
      cp_async<16>(st + kPlane + i, x + at, on);
      cp_async<16>(st + 2 * kPlane + i, gy + at, on);
    }
  } else {
#pragma unroll
    for (unsigned u = 0; u < kPlane / kBwdThreads; ++u) {
      const unsigned i = tid + u * kBwdThreads;
      const unsigned k = i / kBwdGroup, c = i % kBwdGroup;
      const bool on = t0 + k < (unsigned)s && ch0 + c < (unsigned)d;
      const size_t at = on ? (row + k) * d + ch0 + c : 0;
      cp_async<4>(st + i, dt + at, on);
      cp_async<4>(st + kPlane + i, x + at, on);
      cp_async<4>(st + 2 * kPlane + i, gy + at, on);
    }
  }
  float* sb = st + 3 * kPlane;
#pragma unroll
  for (unsigned u = 0; u < 4 * kSums / kBwdThreads; ++u) {
    const unsigned i = tid + u * kBwdThreads;
    const unsigned k = i / kMaxN % kStage, j = (i % kMaxN) ^ (i / kSums);
    const bool on = t0 + k < (unsigned)s && j < (unsigned)n;
    const size_t at = on ? (row + k) * n + j : 0;
    cp_async<4>(sb + i, bm + at, on);
    cp_async<4>(sb + 4 * kSums + i, cm + at, on);
  }
  float* sh = sb + 8 * kSums;
  const size_t hrow = ((size_t)opaque(b) * nst + si) * d + ch0;
  if (vec_n) {
#pragma unroll
    for (unsigned u = 0; u < kBwdGroup * kMaxN / (4 * kBwdThreads); ++u) {
      const unsigned i = 4 * (tid + u * kBwdThreads);
      const unsigned c = i / kMaxN, j = i % kMaxN;
      const bool on = ch0 + c < (unsigned)d && j < (unsigned)n;
      cp_async<16>(sh + i, hs + (on ? (hrow + c) * n + j : 0), on);
    }
  } else {
#pragma unroll
    for (unsigned u = 0; u < kBwdGroup * kMaxN / kBwdThreads; ++u) {
      const unsigned i = tid + u * kBwdThreads;
      const unsigned c = i / kMaxN, j = i % kMaxN;
      const bool on = ch0 + c < (unsigned)d && j < (unsigned)n;
      cp_async<4>(sh + i, hs + (on ? (hrow + c) * n + j : 0), on);
    }
  }
  cp_async_commit();
}

// The sum over the warp's 8 channels (lane bits 2-4) of each of a lane's 4
// states' values, by two transposing rounds and one plain. Lane l holds its
// states in the order i ^ m, m = l >> 3 & 3 (slot i: state first + (i ^ m)),
// so every lane keeps slots 0, 1 and sends 2, 3, then keeps 0 and sends 1,
// and no value is chosen by lane. Lane l returns the sum for its state
// first + m; lanes l and l ^ 4 return the same bits.
__device__ __forceinline__ float sum_channels(const float (&v)[4]) {
  const float w0 = v[0] + __shfl_xor_sync(~0u, v[2], 16);
  const float w1 = v[1] + __shfl_xor_sync(~0u, v[3], 16);
  const float w = w0 + __shfl_xor_sync(~0u, w1, 8);
  return w + __shfl_xor_sync(~0u, w, 4);
}

// The CTA's sums of stage si: each of dB (q = 0) and dC (q = 1) at each
// (step, state), its warps' sums added in warp order, written as the
// group's partial (B, groups, S, N).
__device__ __forceinline__ void bwd_group_sums(const float* red,
                                               float* db_part, float* dc_part,
                                               int si, int s, int n) {
  const size_t base =
      ((size_t)opaque(blockIdx.y) * gridDim.x + blockIdx.x) * s +
      (size_t)si * kStage;
  const unsigned tid = opaque(threadIdx.x);
  static_assert(2 * kSums % kBwdThreads == 0, "whole rounds of sums");
#pragma unroll
  for (unsigned u = 0; u < 2 * kSums / kBwdThreads; ++u) {
    const unsigned i = tid + u * kBwdThreads;
    const unsigned q = i / kSums, r = i % kSums;
    const float* p = red + q * kBwdWarps * kSums + r;
    float acc = p[0];
#pragma unroll
    for (int w = 1; w < kBwdWarps; ++w) acc += p[w * kSums];
    const unsigned k = r / kMaxN, j = r % kMaxN;
    if (si * kStage + k < (unsigned)s && j < (unsigned)n)
      (q ? dc_part : db_part)[(base + k) * n + j] = acc;
  }
}

// One CTA: kBwdGroup channels of one batch row, over every stage.
__global__ void __launch_bounds__(kBwdThreads, 1)
    sscan_bwd_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                     const float* __restrict__ a,
                     const float* __restrict__ bm,
                     const float* __restrict__ cm,
                     const float* __restrict__ hs,
                     const float* __restrict__ gy,
                     const float* __restrict__ gh, float* __restrict__ dx,
                     float* __restrict__ ddt, float* __restrict__ dh0,
                     float* __restrict__ db_part,
                     float* __restrict__ dc_part,
                     float* __restrict__ da_part, int s, int d, int n,
                     int vec_d, int vec_n) {
  constexpr int kBatch = 2;  // steps whose butterflies run side by side
  extern __shared__ __align__(16) float smem[];
  float* red0 = smem + 2 * kBwdStageWords;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = threadIdx.x >> 2;  // channel in the CTA
  const int first = 4 * (lane & 3);  // the lane's first state
  const int m = (lane >> 3) & 3;  // slot i holds state first + (i ^ m)
  const int ch0 = blockIdx.x * kBwdGroup, ch = ch0 + c;
  const bool live = ch < d;
  const int nst = (s + kStage - 1) / kStage;
  const bool writer = !(lane & 4);  // writes its channel sums (state first + m)
  const int red_at = warp * kSums + first + m;
  // lanes 0 and 2 of a channel write its dx and ddt
  const bool hi = lane & 2;
  const bool stores = live && !(lane & 1);

  if (nst > 0)
    bwd_stage_in(smem + ((nst - 1) & 1) * kBwdStageWords, dt, x, gy, bm, cm,
                 hs, b, nst - 1, nst, s, ch0, d, n, vec_d, vec_n);
  float a2[4], lam[4], da[4];  // by slot
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = first + (i ^ m);
    const bool on = live && j < n;
    a2[i] = on ? a[(size_t)ch * n + j] * kLog2e : 0.f;
    lam[i] = on && gh != nullptr ? gh[((size_t)b * d + ch) * n + j] : 0.f;
    da[i] = 0.f;
  }

  for (int si = nst - 1; si >= 0; --si) {
    const int t0 = si * kStage;
    cp_async_wait<0>();
    // stage si has landed; every warp is done with stage si + 1: its buffer
    // may be refilled and its sums added
    __syncthreads();
    if (si > 0)
      bwd_stage_in(smem + ((si - 1) & 1) * kBwdStageWords, dt, x, gy, bm, cm,
                   hs, b, si - 1, nst, s, ch0, d, n, vec_d, vec_n);
    if (si + 1 < nst)
      bwd_group_sums(red0 + ((si + 1) & 1) * kBwdRedWords, db_part, dc_part,
                     si + 1, s, n);
    const float* st = smem + (si & 1) * kBwdStageWords;
    const float* sdt = st + c;
    const float* sx = sdt + kPlane;
    const float* sgy = sx + kPlane;
    const float* sb = st + 3 * kPlane + m * kSums + first;
    const float* sc = sb + 4 * kSums;
    const float* sh = st + 3 * kPlane + 8 * kSums + c * kMaxN + first;
    float* red_b = red0 + (si & 1) * kBwdRedWords + red_at;
    float* red_c = red_b + kBwdWarps * kSums;
    float h[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = sh[i ^ m];
    float dec[kStage][4];  // decay_t h_{t-1}, by slot
#pragma unroll
    for (int k0 = 0; k0 < kStage; k0 += kBatch) {  // recompute, dC's sums
      float vc[kBatch][4];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int k = k0 + u;
        const float dtv = sdt[k * kBwdGroup];
        const float dtx = dtv * sx[k * kBwdGroup];
        const float gyv = sgy[k * kBwdGroup];
        const float4 bq = *(const float4*)(sb + k * kMaxN);
        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dec[k][i] = decay(dtv, a2[i]) * h[i];
          h[i] = fmaf(bv[i], dtx, dec[k][i]);
          vc[u][i] = gyv * h[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const float tot = sum_channels(vc[u]);
        if (writer) red_c[(k0 + u) * kMaxN] = tot;
      }
    }
    float* o = (hi ? ddt : dx) + ((size_t)b * s + t0) * d + ch;
    const int steps = s - t0;  // past kStage: a whole stage
#pragma unroll
    for (int k0 = kStage - 1; k0 >= 0; k0 -= kBatch) {  // backwards
      float vb[kBatch][4], p1[kBatch], p2[kBatch], dts[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int k = k0 - u;
        const float dtv = sdt[k * kBwdGroup];
        const float xv = sx[k * kBwdGroup];
        const float gyv = sgy[k * kBwdGroup];
        const float dtx = dtv * xv;
        dts[u] = dtv;
        const float4 bq = *(const float4*)(sb + k * kMaxN);
        const float4 cq = *(const float4*)(sc + k * kMaxN);
        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
        const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
        p1[u] = p2[u] = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float l = fmaf(gyv, cv[i], lam[i]);  // dL/dh_t
          vb[u][i] = l * dtx;
          p1[u] = fmaf(l, bv[i], p1[u]);
          const float gd = l * dec[k][i];
          p2[u] = fmaf(gd, a2[i], p2[u]);
          da[i] = fmaf(gd, dtv, da[i]);
          lam[i] = l * decay(dtv, a2[i]);  // dL/dh_{t-1} through this step
        }
        // ddt = ln 2 sum (gd A log2 e) + x sum lam B
        p2[u] = fmaf(xv, p1[u], p2[u] * kLn2);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int k = k0 - u;
        const float tot = sum_channels(vb[u]);
        if (writer) red_b[k * kMaxN] = tot;
        // dx = dt sum lam B: lanes 0, 1 of the channel sum p1, 2, 3 p2
        float w = (hi ? p2[u] : p1[u]) +
                  __shfl_xor_sync(~0u, hi ? p1[u] : p2[u], 2);
        w += __shfl_xor_sync(~0u, w, 1);
        const float scale = hi ? 1.f : dts[u];
        if (stores & (k < steps)) o[k * d] = w * scale;
      }
    }
  }
  __syncthreads();
  if (nst > 0)
    bwd_group_sums(red0, db_part, dc_part, 0, s, n);
  const unsigned tid = opaque(threadIdx.x);
  const int ech = blockIdx.x * kBwdGroup + (tid >> 2);
  if (ech < d) {
    const size_t at = ((size_t)opaque(b) * d + ech) * n;
    const int efirst = 4 * (tid & 3), em = (tid >> 3) & 3;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = efirst + (i ^ em);
      if (j < n) {
        dh0[at + j] = lam[i];
        da_part[at + j] = da[i];
      }
    }
  }
}

// out[o, j] = sum_q in[o, q, j] for q = 0, 1, .., k-1 in that order, for
// up to three (in, out) jobs in one launch (blockIdx.y a job).
struct SumJob {
  const float* in;
  float* out;
  int outer, k;
  size_t inner;
};
struct SumJobs {
  SumJob job[3];
};

__global__ void sum_parts_kernel(SumJobs jobs) {
  const SumJob job = blockIdx.y == 0   ? jobs.job[0]
                     : blockIdx.y == 1 ? jobs.job[1]
                                       : jobs.job[2];
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)job.outer * job.inner) return;
  const size_t o = i / job.inner, j = i % job.inner;
  const float* p = job.in + o * job.k * job.inner + j;
  float acc = 0.f;
  for (int q = 0; q < job.k; ++q) acc += p[(size_t)q * job.inner];
  job.out[i] = acc;
}

void sum_parts(const SumJobs& jobs, int njobs, cudaStream_t stream) {
  size_t most = 0;
  for (int i = 0; i < njobs; ++i) {
    const size_t total = (size_t)jobs.job[i].outer * jobs.job[i].inner;
    most = total > most ? total : most;
  }
  if (most == 0) return;
  constexpr int kThreads = 256;
  const dim3 grid((unsigned)((most + kThreads - 1) / kThreads),
                  (unsigned)njobs);
  sum_parts_kernel<<<grid, kThreads, 0, stream>>>(jobs);
}

bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

template <int L, bool kVec>
void launch(const float* dt, const float* x, const float* a, const float* bm,
            const float* cm, const float* h0, float* y, float* h_last,
            float* hs, int bsz, int s, int d, int n, cudaStream_t stream) {
  const dim3 grid((unsigned)((d + kChan - 1) / kChan), (unsigned)bsz);
  sscan_kernel<L, kVec><<<grid, kChan * L, kSmemBytes, stream>>>(
      dt, x, a, bm, cm, h0, y, h_last, hs, s, d, n);
}


}  // namespace

extern "C" {

int sscan_max_state() { return kMaxN; }

// Steps between the states the forward saves for the backward (hs).
int sscan_save_every() { return kStage; }

// Channels a partial of the backward's dB and dC: its scratch db_part and
// dc_part have ceil(d / sscan_bwd_channels()) groups.
int sscan_bwd_channels() { return kBwdGroup; }

// dt, x, y: (bsz, s, d); a: (d, n); bm, cm: (bsz, s, n); h0, h_last:
// (bsz, d, n); all float32, contiguous, on the device. h0 may equal h_last.
// hs: null, or (bsz, ceil(s / sscan_save_every()), d, n), which receives
// the state before each stage (the backward's checkpoints).
int sscan_forward(const void* dt, const void* x, const void* a,
                  const void* bm, const void* cm, const void* h0, void* y,
                  void* h_last, void* hs, int bsz, int s, int d, int n,
                  void* stream) {
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  if (bsz == 0 || d == 0) return (int)cudaSuccess;
  const bool vec = n % 4 == 0 && d % 4 == 0 && aligned16(dt) &&
                   aligned16(x) && aligned16(a) && aligned16(bm) &&
                   aligned16(cm) && aligned16(h0) && aligned16(h_last) &&
                   aligned16(hs);
  auto kern = s < kPrefill ? (vec ? launch<4, true> : launch<4, false>)
                            : (vec ? launch<1, true> : launch<1, false>);
  kern((const float*)dt, (const float*)x, (const float*)a, (const float*)bm,
       (const float*)cm, (const float*)h0, (float*)y, (float*)h_last,
       (float*)hs, bsz, s, d, n, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// Residency of the backward kernel on the current device: out[0] CTAs an
// SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), [1] threads a CTA,
// [2] dynamic shared memory bytes, [3] registers a thread, [4] static shared
// memory bytes, [5] local memory bytes a thread.
int sscan_bwd_occupancy(int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      sscan_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kBwdSmemBytes);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, sscan_bwd_kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, sscan_bwd_kernel, kBwdThreads, kBwdSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int vals[6] = {blocks, kBwdThreads, (int)kBwdSmemBytes, attr.numRegs,
                       (int)attr.sharedSizeBytes, (int)attr.localSizeBytes};
  for (int i = 0; i < 6; ++i) out[i] = vals[i];
  return (int)cudaSuccess;
}

// The gradients of sscan_forward's y and h_last. dt, x, gy, dx, ddt:
// (bsz, s, d); a, da: (d, n); bm, cm, db, dc: (bsz, s, n); hs as the
// forward wrote it; gh (null: zero), dh0: (bsz, d, n). Scratch, from the
// caller: db_part, dc_part (bsz, ceil(d / sscan_bwd_channels()), s, n)
// and da_part (bsz, d, n). Two launches: the scan, then the fixed-order
// sums of its partials.
int sscan_backward(const void* dt, const void* x, const void* a,
                   const void* bm, const void* cm, const void* hs,
                   const void* gy, const void* gh, void* dx, void* ddt,
                   void* da, void* db, void* dc, void* dh0, void* db_part,
                   void* dc_part, void* da_part, int bsz, int s, int d, int n,
                   void* stream) {
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int groups = (d + kBwdGroup - 1) / kBwdGroup;
  if (bsz > 0 && d > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        sscan_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kBwdSmemBytes);
    if (err != cudaSuccess) return (int)err;
    const int vec_d = d % 4 == 0 && aligned16(dt) && aligned16(x) &&
                      aligned16(gy);
    const int vec_n = n % 4 == 0 && aligned16(hs);
    sscan_bwd_kernel<<<dim3((unsigned)groups, (unsigned)bsz), kBwdThreads,
                       kBwdSmemBytes, st>>>(
        (const float*)dt, (const float*)x, (const float*)a, (const float*)bm,
        (const float*)cm, (const float*)hs, (const float*)gy,
        (const float*)gh, (float*)dx, (float*)ddt, (float*)dh0,
        (float*)db_part, (float*)dc_part, (float*)da_part, s, d, n, vec_d,
        vec_n);
  }
  SumJobs jobs = {{{(const float*)db_part, (float*)db, bsz, groups,
                    (size_t)s * n},
                   {(const float*)dc_part, (float*)dc, bsz, groups,
                    (size_t)s * n},
                   {(const float*)da_part, (float*)da, 1, bsz,
                    (size_t)d * n}}};
  sum_parts(jobs, 3, st);
  return (int)cudaGetLastError();
}

const char* sscan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
