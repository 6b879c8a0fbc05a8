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
//   h[n]   = expf(dt[b,t,d] * A[d,n]) * h[n] + (dt[b,t,d] * B[b,t,n]) * x[b,t,d]
//   y[b,t,d] = sum_n C[b,t,n] * h[n]
// starting from h0[b,d,:]; h_last[b,d,:] is h after the last step. h0 and
// h_last may be the same buffer (the serving cache is updated in place): each
// thread reads its own state before it writes it.
//
// Bound on the H100: bytes. dt, x and y are (B,S,D) float32 and B, C are
// (B,S,N): 12 bytes of traffic per (b,t,d) against about 8 float32
// operations (one of them an expf) per (b,t,d,n), i.e. ~10 operations a byte
// at N = 16, below the card's ~20 float32 operations a byte. The TPU kernel's
// point, that the (S, D, N) state expansion never reaches device memory,
// holds here too: the state lives in registers.
//
// Design (simple first): one thread per (b, d) channel keeps h[N] and A[d,:]
// in registers (N <= kMaxN). CTAs of kThreads channels of one batch row; the
// steps are taken kStage at a time, with B[b,t,:] and C[b,t,:] of those
// steps staged in shared memory once per CTA. dt and x are read directly:
// neighbouring threads read neighbouring d, so the loads are coalesced. Any S
// and any D (the last CTA masks its channels). expf, not __expf, and the
// build keeps -fmad=false.
// Known costs left for a later change: at decode (S = 1) the launch and one
// pass over A, h0 and h_last are all there is; at prefill length the expf
// per (b,t,d,n) is the arithmetic ceiling, and a CTA walks its steps alone
// (no split of S across CTAs with a second pass).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxN = 16;
constexpr int kStage = 32;

__global__ void __launch_bounds__(kThreads)
    sscan_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                 const float* __restrict__ a, const float* __restrict__ bm,
                 const float* __restrict__ cm, const float* h0,
                 float* __restrict__ y, float* h_last, int s, int d, int n) {
  __shared__ float sb[kStage * kMaxN];
  __shared__ float sc[kStage * kMaxN];
  const int b = blockIdx.y;
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  const bool live = ch < d;

  float h[kMaxN];
  float av[kMaxN];
#pragma unroll
  for (int i = 0; i < kMaxN; ++i) {
    const bool on = live && i < n;
    h[i] = on ? h0[((size_t)b * d + ch) * n + i] : 0.f;
    av[i] = on ? a[(size_t)ch * n + i] : 0.f;
  }

  const size_t row = (size_t)b * s;
  for (int t0 = 0; t0 < s; t0 += kStage) {
    const int steps = min(kStage, s - t0);
    __syncthreads();  // the previous stage's B and C are read
    for (int i = threadIdx.x; i < steps * n; i += kThreads) {
      const size_t off = (row + t0) * n + i;
      sb[i] = bm[off];
      sc[i] = cm[off];
    }
    __syncthreads();
    if (!live) continue;
    for (int k = 0; k < steps; ++k) {
      const size_t at = (row + t0 + k) * d + ch;
      const float dtv = dt[at];
      const float xv = x[at];
      const float* bk = sb + k * n;
      const float* ck = sc + k * n;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxN; ++i) {
        if (i < n) {
          const float decay = expf(dtv * av[i]);
          h[i] = decay * h[i] + dtv * bk[i] * xv;
          acc += ck[i] * h[i];
        }
      }
      y[at] = acc;
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < kMaxN; ++i)
      if (i < n) h_last[((size_t)b * d + ch) * n + i] = h[i];
  }
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
  const dim3 grid((unsigned)((d + kThreads - 1) / kThreads), (unsigned)bsz);
  sscan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)dt, (const float*)x, (const float*)a, (const float*)bm,
      (const float*)cm, (const float*)h0, (float*)y, (float*)h_last, s, d, n);
  return (int)cudaGetLastError();
}

const char* sscan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
