// 25-point acoustic-wave stencil: single-step and multistep kernels for
// Hopper (sm_90a).
//
// wave_step_kernel replaces wave_step_pallas (_wave_kernel) and
// wave_rung_kernel, launched once per rung by the multistep wrapper, replaces
// wave_multistep_pallas (_multistep_kernel), both in
// src/repro/kernels/stencil/kernel.py. Bit for bit equal to the plain
// PyTorch version, src/repro_torch/kernels/stencil/ref.py (wave_step and
// ladder_steps): the build uses -fmad=false and every sum is taken in the
// reference's order, 3*C0*c first, then for k = 1..4 the six neighbours
// z+k, z-k, y+k, y-k, x+k, x-k left to right, times C[k], added to lap.
//
// Bound on the H100: bytes. A step does 33 float32 operations per point
// and must move 5 arrays of 4 bytes a point (p_prev, p_cur, vel2 in;
// p_next, lap out), about 1.6 operations a byte, far below the 67 TFLOP/s
// / 3.35 TB/s = 20 the card needs to be bound by arithmetic. The multistep
// kernel at K rungs does 33 K operations per point against 5 arrays at
// best, so at K = 12 the two bounds meet.
//
// Design, simple and right first: one thread per output point reading its
// 25 neighbours straight from device memory (the warp's x-neighbours and the
// y/z planes hit in L1/L2), x fastest across the warp so loads coalesce.
// The multistep wrapper runs one rung kernel per step over ping-pong
// buffers; the rung applies the zero boundary by index, so none of the
// pad_bc copies of the ladder is made, and it does not write lap (the
// multistep contract returns only p_prev and p_cur). A 2.5-D z-streaming
// register queue and keeping rungs in shared memory are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kHalo = 4;
// float(3.0 * C0) folded in double as the reference does, then C[k].
constexpr float kC3C0 = (float)(3.0 * (-205.0 / 72.0));
__device__ __constant__ float kC[4] = {
    (float)(8.0 / 5.0), (float)(-1.0 / 5.0), (float)(8.0 / 315.0),
    (float)(-1.0 / 560.0)};

constexpr int kBX = 32, kBY = 8;

// p_prev, p_cur padded (Z+8, Y+8, X+8); vel2 and outputs interior (Z, Y, X).
__global__ void wave_step_kernel(const float* __restrict__ pp,
                                 const float* __restrict__ pc,
                                 const float* __restrict__ v2,
                                 float* __restrict__ pn,
                                 float* __restrict__ lap_out, int Z, int Y,
                                 int X) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  const int z = blockIdx.z;
  if (x >= X || y >= Y) return;
  const long long YP = Y + 2 * kHalo, XP = X + 2 * kHalo;
  const long long sz = YP * XP, sy = XP;
  const long long ctr = ((long long)(z + kHalo) * YP + (y + kHalo)) * XP +
                        (x + kHalo);
  const float c = pc[ctr];
  float lap = kC3C0 * c;
#pragma unroll
  for (int k = 1; k <= kHalo; ++k) {
    float s = pc[ctr + k * sz];
    s = s + pc[ctr - k * sz];
    s = s + pc[ctr + k * sy];
    s = s + pc[ctr - k * sy];
    s = s + pc[ctr + k];
    s = s + pc[ctr - k];
    lap = lap + kC[k - 1] * s;
  }
  const long long i = ((long long)z * Y + y) * X + x;
  pn[i] = (2.0f * c - pp[ctr]) + v2[i] * lap;
  lap_out[i] = lap;
}

// One rung of the ladder on interior (Z, Y, X) fields, zero outside.
__global__ void wave_rung_kernel(const float* __restrict__ pp,
                                 const float* __restrict__ pc,
                                 const float* __restrict__ v2,
                                 float* __restrict__ pn, int Z, int Y, int X) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  const int z = blockIdx.z;
  if (x >= X || y >= Y) return;
  const long long sz = (long long)Y * X, sy = X;
  const long long i = ((long long)z * Y + y) * X + x;
  const float c = pc[i];
  float lap = kC3C0 * c;
#pragma unroll
  for (int k = 1; k <= kHalo; ++k) {
    // the ghost value is +0.0f, added like the ladder adds its padding
    float s = z + k < Z ? pc[i + k * sz] : 0.0f;
    s = s + (z - k >= 0 ? pc[i - k * sz] : 0.0f);
    s = s + (y + k < Y ? pc[i + k * sy] : 0.0f);
    s = s + (y - k >= 0 ? pc[i - k * sy] : 0.0f);
    s = s + (x + k < X ? pc[i + k] : 0.0f);
    s = s + (x - k >= 0 ? pc[i - k] : 0.0f);
    lap = lap + kC[k - 1] * s;
  }
  pn[i] = (2.0f * c - pp[i]) + v2[i] * lap;
}

dim3 grid_of(int Z, int Y, int X) {
  return dim3((X + kBX - 1) / kBX, (Y + kBY - 1) / kBY, Z);
}

}  // namespace

extern "C" {

int stencil_wave_step(const void* pp, const void* pc, const void* v2, void* pn,
                      void* lap, int Z, int Y, int X, void* stream) {
  wave_step_kernel<<<grid_of(Z, Y, X), dim3(kBX, kBY), 0,
                     (cudaStream_t)stream>>>(
      (const float*)pp, (const float*)pc, (const float*)v2, (float*)pn,
      (float*)lap, Z, Y, X);
  return (int)cudaGetLastError();
}

int stencil_wave_rung(const void* pp, const void* pc, const void* v2, void* pn,
                      int Z, int Y, int X, void* stream) {
  wave_rung_kernel<<<grid_of(Z, Y, X), dim3(kBX, kBY), 0,
                     (cudaStream_t)stream>>>(
      (const float*)pp, (const float*)pc, (const float*)v2, (float*)pn, Z, Y,
      X);
  return (int)cudaGetLastError();
}

const char* stencil_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
