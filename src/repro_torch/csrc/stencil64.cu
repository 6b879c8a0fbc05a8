// 25-point acoustic-wave stencil in float64: single-step and ladder-rung
// kernels for Hopper (sm_90a), first form.
//
// The float64 instances of wave_step_pallas (_wave_kernel) and
// wave_multistep_pallas (_multistep_kernel), src/repro/kernels/stencil/
// kernel.py, whose outputs take p_cur's dtype. Bit for bit equal to the
// plain PyTorch version, src/repro_torch/kernels/stencil/ref.py (wave_step
// and ladder_steps) in float64: the build uses -fmad=false and every sum
// is taken in the reference's order, 3.0*C0*c first (3.0*C0 a double
// constant), then for k = 1..4 the six neighbours z+k, z-k, y+k, y-k, x+k,
// x-k left to right, times C[k], added to lap.
//
// Bound on the H100: bytes. A step does 33 float64 operations per point
// and moves 5 arrays of 8 bytes a point (p_prev, p_cur, vel2 in; p_next,
// lap out) for the single step, 4 for a rung (no lap): about 0.8
// operations a byte, below the 34 TFLOP/s / 3.35 TB/s = 10 the card needs
// to be bound by float64 arithmetic.
//
// Design (a simple kernel first; the float32 kernels of stencil.cu are the
// redesigned ones): one thread a (y, x) column of the output, walking z.
// The nine p_cur values of its own column, z - 4 .. z + 4, are a queue in
// registers, so each step loads one new value of the column; the 16 x- and
// y-neighbours of the centre plane come through the read-only cache, where
// a 32 x 8 CTA's neighbours in x and y are read by the CTA itself. No
// shared memory and no barrier. The rung (kStep false) reads interior
// (Z, Y, X) fields and takes a point outside them as +0.0, as the ladder
// re-pads every rung; the single step (kStep true) reads p_prev and p_cur
// padded, (Z+8, Y+8, X+8), their shell as data, and writes lap too.

#include <cuda_runtime.h>

namespace {

constexpr int kHalo = 4;
constexpr double kC3C0 = 3.0 * (-205.0 / 72.0);
__device__ __constant__ double kC[4] = {8.0 / 5.0, -1.0 / 5.0, 8.0 / 315.0,
                                        -1.0 / 560.0};
constexpr int kTX = 32, kTY = 8;  // threads a CTA: x fastest

// The source array of p_cur (and p_prev): interior (Z, Y, X) for the
// rung, padded (Z+8, Y+8, X+8) for the single step. at(z, y, x) takes
// interior coordinates.
template <bool kStep>
struct Field {
  const double* __restrict__ a;
  int Z, Y, X;  // interior extent

  __device__ __forceinline__ double at(int z, int y, int x) const {
    if constexpr (kStep) {
      return __ldg(a + ((long long)(z + kHalo) * (Y + 2 * kHalo) + y + kHalo) *
                           (X + 2 * kHalo) + x + kHalo);
    } else {
      if (z < 0 || z >= Z || y < 0 || y >= Y || x < 0 || x >= X) return 0.0;
      return __ldg(a + ((long long)z * Y + y) * X + x);
    }
  }
};

// One step over the thread's (y, x) column: pn (and lap_out for the single
// step) interior (Z, Y, X).
template <bool kStep>
__device__ __forceinline__ void column(const double* __restrict__ pp,
                                       const double* __restrict__ pc,
                                       const double* __restrict__ v2,
                                       double* __restrict__ pn,
                                       double* __restrict__ lap_out, int Z,
                                       int Y, int X) {
  const int x = blockIdx.x * kTX + threadIdx.x;
  const int y = blockIdx.y * kTY + threadIdx.y;
  if (x >= X || y >= Y) return;
  const Field<kStep> cur = {pc, Z, Y, X}, prev = {pp, Z, Y, X};
  // the queue: p_cur at z - 4 .. z + 4 of the column; the single step's
  // padded shell reaches z = -4 and Z + 3, the rung's is zero there
  double q[2 * kHalo + 1];
#pragma unroll
  for (int i = 0; i < 2 * kHalo; ++i) q[i + 1] = cur.at(i - kHalo, y, x);
  const long long plane = (long long)Y * X, col = (long long)y * X + x;
  for (int z = 0; z < Z; ++z) {
#pragma unroll
    for (int i = 0; i < 2 * kHalo; ++i) q[i] = q[i + 1];
    q[2 * kHalo] = cur.at(z + kHalo, y, x);
    const double c = q[kHalo];
    double lap = kC3C0 * c;
#pragma unroll
    for (int k = 1; k <= kHalo; ++k) {
      double sum = q[kHalo + k] + q[kHalo - k];
      sum = sum + cur.at(z, y + k, x);
      sum = sum + cur.at(z, y - k, x);
      sum = sum + cur.at(z, y, x + k);
      sum = sum + cur.at(z, y, x - k);
      lap = lap + kC[k - 1] * sum;
    }
    const long long i = z * plane + col;
    pn[i] = (2.0 * c - prev.at(z, y, x)) + __ldg(v2 + i) * lap;
    if constexpr (kStep) lap_out[i] = lap;
  }
}

// One step on padded (Z+8, Y+8, X+8) p_prev and p_cur: p_next and lap
// interior (Z, Y, X).
__global__ void __launch_bounds__(kTX * kTY)
    wave_step64_kernel(const double* __restrict__ pp,
                       const double* __restrict__ pc,
                       const double* __restrict__ v2, double* __restrict__ pn,
                       double* __restrict__ lap, int Z, int Y, int X) {
  column<true>(pp, pc, v2, pn, lap, Z, Y, X);
}

// Interior (Z, Y, X) fields: pn = one ladder step from (pp, pc).
__global__ void __launch_bounds__(kTX * kTY)
    wave_rung64_kernel(const double* __restrict__ pp,
                       const double* __restrict__ pc,
                       const double* __restrict__ v2, double* __restrict__ pn,
                       int Z, int Y, int X) {
  column<false>(pp, pc, v2, pn, nullptr, Z, Y, X);
}

dim3 grid_of(int Y, int X) {
  return dim3((X + kTX - 1) / kTX, (Y + kTY - 1) / kTY);
}

}  // namespace

extern "C" {

// One step on padded p_prev, p_cur and interior vel2: p_next and lap.
int stencil_wave_step_f64(const void* pp, const void* pc, const void* v2,
                          void* pn, void* lap, int Z, int Y, int X,
                          void* stream) {
  if (Z > 0 && Y > 0 && X > 0)
    wave_step64_kernel<<<grid_of(Y, X), dim3(kTX, kTY), 0,
                         (cudaStream_t)stream>>>(
        (const double*)pp, (const double*)pc, (const double*)v2, (double*)pn,
        (double*)lap, Z, Y, X);
  return (int)cudaGetLastError();
}

// One step of the ladder on interior (Z, Y, X) fields: pn from (pp, pc).
int stencil_wave_rung_f64(const void* pp, const void* pc, const void* v2,
                          void* pn, int Z, int Y, int X, void* stream) {
  if (Z > 0 && Y > 0 && X > 0)
    wave_rung64_kernel<<<grid_of(Y, X), dim3(kTX, kTY), 0,
                         (cudaStream_t)stream>>>(
        (const double*)pp, (const double*)pc, (const double*)v2, (double*)pn,
        Z, Y, X);
  return (int)cudaGetLastError();
}

const char* stencil64_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
