// 25-point acoustic-wave stencil in float64: single-step and ladder-rung
// kernels for Hopper (sm_90a).
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
// What held the first form back (one thread a (y, x) column walking all
// of Z, 32 x 8 CTAs, each of the 16 x- and y-neighbours a load through the
// read-only cache, the rung's under a 6-way bounds test): at the paper's
// block, (240, 1152, 1152), 2.0-2.5x its byte bound (rung 7.79 ms a launch
// against 3.04, single step 7.24-7.38 against 3.88); at the precision
// tier's (192, 96, 96) only 36 CTAs for 132 SMs, each thread walking 192
// planes in series, so 13-19x (rung 0.3209 ms against 0.0169, single step
// 0.2816 against 0.0230; device time a launch, tools/kernel_shapes.py, H100
// 80GB HBM3, 700 W).
//
// Design: the float32 kernels' 2.5-D z-streaming (stencil.cu) in 8-byte
// values, with a z-split for small volumes. A CTA of 256 threads owns a
// 16 x 32 output tile and walks a chunk of its planes in z; each thread
// owns a pair of points along x (a double2). p_cur's planes sit in shared
// memory as a ring of 7 on the tile grown by 4 on each side (53,760 bytes:
// the entry points opt in to more than 48 KB), brought in by cp.async two
// planes ahead, 16 bytes a copy when every row is 16-byte aligned (even X),
// else 8. The centre plane gives the x- and y-neighbours, the planes above
// it the z+ ones; the 4 planes below the centre are a queue in the
// thread's registers. Each quarter-warp reads 8 consecutive pairs of one
// row (128 contiguous bytes), so no row stride gives a bank conflict.
//
// The z-split: the host picks the chunk length (kernel.py z_chunk) so
// that tiles x chunks fill the CTAs the card holds at once
// (stencil64_ctas_per_sm x SMs) in one wave: one chunk at the paper's
// block (2592 tiles), 14 of 14 planes at (192, 96, 96) (18 tiles, 252
// CTAs of the 264 that 2 an SM give). A chunk's CTA reads its planes and
// the 4 + 4 around them. One wave matters: 15 chunks of 13 planes (270
// CTAs, 6 left for a second wave that runs a whole chunk alone) took
// 0.0325-0.0328 ms a rung against 0.0251-0.0252 at 14 planes.
//
// Where it stands (device time a launch, tools/kernel_shapes.py, H100
// 80GB HBM3, 700 W): the rung 3.68 ms at the block against its 3.04 ms
// byte bound and 0.025 ms at (192, 96, 96) against 0.0169; the single
// step 4.73-4.75 ms against 3.88 and 0.030-0.035 ms against 0.0230.
// 106-110 registers, no spill: 2 CTAs an SM.
//
// The rung (kStep false) reads interior (Z, Y, X) fields and takes a point
// outside them as +0.0, as the ladder re-pads every rung, so the queue
// starts at zero and the grown tile is zero-filled by index; the single
// step (kStep true) reads p_prev and p_cur padded, (Z+8, Y+8, X+8), their
// shell as data, and writes lap too.

#include <cuda_runtime.h>

#include <initializer_list>

#include "cp_async.cuh"

namespace {

constexpr int kHalo = 4;
constexpr double kC3C0 = 3.0 * (-205.0 / 72.0);
__device__ __constant__ double kC[4] = {8.0 / 5.0, -1.0 / 5.0, 8.0 / 315.0,
                                        -1.0 / 560.0};

constexpr int kThreads = 256;
constexpr int kTY = 16, kTX = 32;  // the output tile (kernel.py TILE64)
constexpr int kPW = kTX / 2;       // pairs a row
constexpr int kZq = 4;             // planes below the centre, in registers
constexpr int kRing = 7;           // p_cur planes in shared memory: t - 4 .. t + 2
constexpr int kW0 = kTX + 8, kR0 = kTY + 8, kA0 = kR0 * kW0;  // grown tile
constexpr int kSmem = kRing * kA0 * (int)sizeof(double);
static_assert(kTY * kPW == kThreads, "one pair a thread");
static_assert(kW0 % 2 == 0 && kA0 % 2 == 0, "rows of whole double2s");

__device__ __forceinline__ double comp(const double2& v, int j) {
  return j == 0 ? v.x : v.y;
}

// The pair at a[i], a[i + 1]; a point whose bit in `in` is clear is 0 and
// is not read.
__device__ __forceinline__ double2 load_pair(const double* __restrict__ a,
                                             long long i, unsigned in,
                                             bool vec) {
  if (vec && in == 0x3u) return __ldg((const double2*)(a + i));
  double v0 = 0.0, v1 = 0.0;
  if (in & 1u) v0 = __ldg(a + i);
  if (in & 2u) v1 = __ldg(a + i + 1);
  return make_double2(v0, v1);
}

// The extent of the array p_cur's grown tile is read from, and where the
// tile starts in it: the interior with the tile grown by 4 on each side
// (rung), or the padded array, whose shell is that growth (step).
struct Source {
  int zs, ys, xs;  // extent
  int gy0, gx0;    // the grown tile's first row and column
};

// Issue the copies of p_cur's source plane z (grown tile) into its ring
// slot and commit them as one group: zeros where the tile leaves the
// source, an empty group for the planes at or past zend (the CTA reads
// none of them).
__device__ __forceinline__ void load_plane(double* ring, int z, int zend,
                                           const double* __restrict__ pc,
                                           const Source& s, bool vec) {
  if (z < zend) {
    double* dst = ring + (z % kRing) * kA0;
    const bool zin = z < s.zs;
    const long long zo = (long long)z * s.ys * s.xs;
    if (vec) {
      for (int e = threadIdx.x; e < kA0 / 2; e += kThreads) {
        const int gy = s.gy0 + e / (kW0 / 2);
        const int gx = s.gx0 + 2 * (e % (kW0 / 2));
        const bool in = zin && gy >= 0 && gy < s.ys && gx >= 0 && gx < s.xs;
        cp_async<16>(dst + 2 * e,
                     in ? pc + zo + (long long)gy * s.xs + gx : pc, in);
      }
    } else {
      for (int e = threadIdx.x; e < kA0; e += kThreads) {
        const int gy = s.gy0 + e / kW0, gx = s.gx0 + e % kW0;
        const bool in = zin && gy >= 0 && gy < s.ys && gx >= 0 && gx < s.xs;
        cp_async<8>(dst + e, in ? pc + zo + (long long)gy * s.xs + gx : pc,
                    in);
      }
    }
  }
  cp_async_commit();
}

// One step over the CTA's column, output planes [z0, z0 + zlen) of Z. pp
// and pc: interior (Z, Y, X) fields (kStep false) or padded (Z+8, Y+8,
// X+8) (kStep true); v2, pn and lap_out interior. lap_out is written only
// by the step.
//
// Step t has p_cur's source plane t landed and works on the centre plane
// t - 4 (its output plane t - 4 - kOff). The walk starts at t0, the plane
// 4 below the chunk's first centre (the rung: at 0, the planes below it
// being the queue's zeros), so the queue holds the 4 centres below z0
// when z0's turn comes; a centre below t0 enters the queue as 0 and has
// left it by then.
template <bool kStep>
__device__ __forceinline__ void stream_column64(const double* __restrict__ pp,
                                                const double* __restrict__ pc,
                                                const double* __restrict__ v2,
                                                double* __restrict__ pn,
                                                double* __restrict__ lap_out,
                                                int Z, int Y, int X, int zlen,
                                                bool vec) {
  constexpr int kOff = kStep ? kHalo : 0;  // interior -> source index
  extern __shared__ double2 smem2[];
  double* ring = (double*)smem2;
  const int y0 = blockIdx.y * kTY, x0 = blockIdx.x * kTX;
  const int z0 = blockIdx.z * zlen, z1 = min(Z, z0 + zlen);
  const int ly = threadIdx.x / kPW, lx = 2 * (threadIdx.x % kPW);
  const int gy = y0 + ly, gx = x0 + lx;
  // the pair's points inside [0, Y) x [0, X)
  const unsigned in_yx = gy < Y ? (gx < X ? 1u : 0u) | (gx + 1 < X ? 2u : 0u)
                                : 0u;
  const Source src = {Z + 2 * kOff, Y + 2 * kOff, X + 2 * kOff,
                      y0 - kHalo + kOff, x0 - kHalo + kOff};
  const int t0 = max(z0 + kOff - kHalo, 0);
  const int tend = z1 + kOff + kHalo;  // past the last centre's z+4
  const long long col = (long long)gy * X + gx, plane = (long long)Y * X;
  // the pair in the source's planes, less the plane offset
  const long long scol = (long long)(gy + kOff) * src.xs + gx + kOff;
  const long long splane = (long long)src.ys * src.xs;
  const int ci = (ly + 4) * kW0 + lx + 4;  // the pair in a ring plane
  const double2 zero = make_double2(0.0, 0.0);
  double2 q[kZq];  // p_cur at the 4 centres below this step's (zeros first)
#pragma unroll
  for (int i = 0; i < kZq; ++i) q[i] = zero;

  load_plane(ring, t0, tend, pc, src, vec);
  load_plane(ring, t0 + 1, tend, pc, src, vec);
  int cs = ((t0 - 4) % kRing + kRing) % kRing;  // ring slot of plane t - 4
  for (int t = t0; t < tend; ++t) {
    const int zc = t - 4 - kOff;  // the output plane
    const unsigned in = zc >= z0 && zc < z1 ? in_yx : 0u;
    // this step's p_prev and vel2, loaded before the barrier
    const double2 prev =
        load_pair(pp, (long long)(zc + kOff) * splane + scol, in, vec);
    const double2 vel = load_pair(v2, (long long)zc * plane + col, in, vec);
    cp_async_wait<1>();
    __syncthreads();  // plane t landed; every thread is past step t - 1
    load_plane(ring, t + 2, tend, pc, src, vec);
    double2 c = zero;
    const double* s = ring + cs * kA0;
    if (in) {
      // the centre row from x - 4 to x + 5, then the sums in the
      // reference's order
      double xr[10];
      const double2* row = (const double2*)(s + ci - 4);
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const double2 r2 = row[i];
        xr[2 * i] = r2.x;
        xr[2 * i + 1] = r2.y;
      }
      c = make_double2(xr[4], xr[5]);
      double lap[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) lap[j] = kC3C0 * xr[4 + j];
#pragma unroll
      for (int k = 1; k <= kHalo; ++k) {
        const int up = cs + k < kRing ? cs + k : cs + k - kRing;
        const double2 zp = *(const double2*)(ring + up * kA0 + ci);
        const double2 yp = *(const double2*)(s + ci + k * kW0);
        const double2 ym = *(const double2*)(s + ci - k * kW0);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          double sum = comp(zp, j) + comp(q[kZq - k], j);
          sum = sum + comp(yp, j);
          sum = sum + comp(ym, j);
          sum = sum + xr[4 + j + k];
          sum = sum + xr[4 + j - k];
          lap[j] = lap[j] + kC[k - 1] * sum;
        }
      }
      double v[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        v[j] = (2.0 * xr[4 + j] - comp(prev, j)) + comp(vel, j) * lap[j];
      const long long i = zc * plane + col;
      if (vec && in == 0x3u) {
        *(double2*)(pn + i) = make_double2(v[0], v[1]);
        if constexpr (kStep)
          *(double2*)(lap_out + i) = make_double2(lap[0], lap[1]);
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (in >> j & 1u) {
            pn[i + j] = v[j];
            if constexpr (kStep) lap_out[i + j] = lap[j];
          }
      }
    } else if (t - 4 >= t0 && in_yx) {
      // a centre below the chunk's first output plane: the queue's only
      c = *(const double2*)(s + ci);
    }
#pragma unroll
    for (int i = 0; i < kZq - 1; ++i) q[i] = q[i + 1];
    q[kZq - 1] = c;
    cs = cs == kRing - 1 ? 0 : cs + 1;
  }
}

// One step on padded (Z+8, Y+8, X+8) p_prev and p_cur: p_next and lap
// interior (Z, Y, X).
__global__ void __launch_bounds__(kThreads, 2)
    wave_step64_kernel(const double* __restrict__ pp,
                       const double* __restrict__ pc,
                       const double* __restrict__ v2, double* __restrict__ pn,
                       double* __restrict__ lap, int Z, int Y, int X,
                       int zlen, bool vec) {
  stream_column64<true>(pp, pc, v2, pn, lap, Z, Y, X, zlen, vec);
}

// Interior (Z, Y, X) fields: pn = one ladder step from (pp, pc).
__global__ void __launch_bounds__(kThreads, 2)
    wave_rung64_kernel(const double* __restrict__ pp,
                       const double* __restrict__ pc,
                       const double* __restrict__ v2, double* __restrict__ pn,
                       int Z, int Y, int X, int zlen, bool vec) {
  stream_column64<false>(pp, pc, v2, pn, nullptr, Z, Y, X, zlen, vec);
}

// 16-byte copies and pairs: every row of every array starts 16-byte
// aligned (X % 2 == 0 makes padded rows, X + 8, and their interior offset
// of 4 doubles even too).
bool vectorizable(int X, std::initializer_list<const void*> arrays) {
  bool vec = X % 2 == 0;
  for (const void* p : arrays) vec &= (size_t)p % 16 == 0;
  return vec;
}

dim3 grid_of(int Z, int Y, int X, int zlen) {
  return dim3((X + kTX - 1) / kTX, (Y + kTY - 1) / kTY,
              (Z + zlen - 1) / zlen);
}

// Allow the kernel kSmem bytes of dynamic shared memory (above the 48 KB
// a launch gets without asking); a launch refused for it would not run.
cudaError_t allow_smem(const void* kernel) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) cudaGetLastError();  // not left for the next call
  return err;
}

}  // namespace

extern "C" {

// One step on padded p_prev, p_cur and interior vel2: p_next and lap;
// each CTA walks zlen output planes.
int stencil_wave_step_f64(const void* pp, const void* pc, const void* v2,
                          void* pn, void* lap, int Z, int Y, int X, int zlen,
                          void* stream) {
  if (zlen < 1) return (int)cudaErrorInvalidValue;
  if (Z > 0 && Y > 0 && X > 0) {
    const cudaError_t err = allow_smem((const void*)wave_step64_kernel);
    if (err != cudaSuccess) return (int)err;
    const bool vec = vectorizable(X, {pp, pc, v2, pn, lap});
    wave_step64_kernel<<<grid_of(Z, Y, X, zlen), kThreads, kSmem,
                         (cudaStream_t)stream>>>(
        (const double*)pp, (const double*)pc, (const double*)v2, (double*)pn,
        (double*)lap, Z, Y, X, zlen, vec);
  }
  return (int)cudaGetLastError();
}

// One step of the ladder on interior (Z, Y, X) fields: pn from (pp, pc);
// each CTA walks zlen output planes.
int stencil_wave_rung_f64(const void* pp, const void* pc, const void* v2,
                          void* pn, int Z, int Y, int X, int zlen,
                          void* stream) {
  if (zlen < 1) return (int)cudaErrorInvalidValue;
  if (Z > 0 && Y > 0 && X > 0) {
    const cudaError_t err = allow_smem((const void*)wave_rung64_kernel);
    if (err != cudaSuccess) return (int)err;
    const bool vec = vectorizable(X, {pp, pc, v2, pn});
    wave_rung64_kernel<<<grid_of(Z, Y, X, zlen), kThreads, kSmem,
                         (cudaStream_t)stream>>>(
        (const double*)pp, (const double*)pc, (const double*)v2, (double*)pn,
        Z, Y, X, zlen, vec);
  }
  return (int)cudaGetLastError();
}

// CTAs of the single step (step != 0) or of the rung that one SM holds at
// once, with their registers and shared memory: the host sizes the z-split
// to one wave of them. Negative: minus the CUDA error.
int stencil64_ctas_per_sm(int step) {
  const void* kernel = step ? (const void*)wave_step64_kernel
                            : (const void*)wave_rung64_kernel;
  cudaError_t err = allow_smem(kernel);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                        kSmem);
  return err == cudaSuccess ? n : -(int)err;
}

const char* stencil64_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
