// 25-point acoustic-wave stencil: single-step and multistep kernels for
// Hopper (sm_90a).
//
// wave_step_kernel replaces wave_step_pallas (_wave_kernel) and
// wave_rung_kernel replaces wave_multistep_pallas (_multistep_kernel),
// both in src/repro/kernels/stencil/kernel.py. Bit for bit equal to the plain
// PyTorch version, src/repro_torch/kernels/stencil/ref.py (wave_step and
// ladder_steps): the build uses -fmad=false and every sum is taken in the
// reference's order, 3*C0*c first, then for k = 1..4 the six neighbours
// z+k, z-k, y+k, y-k, x+k, x-k left to right, times C[k], added to lap.
//
// Bound on the H100: bytes. A step does 33 float32 operations per point
// and must move 5 arrays of 4 bytes a point (p_prev, p_cur, vel2 in;
// p_next, lap out), about 1.6 operations a byte, far below the 67 TFLOP/s
// / 3.35 TB/s = 20 the card needs to be bound by arithmetic. A multistep
// call of K steps must move 5 arrays once (3 in, 2 out) for 33 K operations
// a point, so at K = 12 the two bounds meet (1.90 ms at the paper's block).
//
// Both kernels are one 2.5-D z-streaming body (stream_column, below): a
// CTA walks its tile's column along z, the z-neighbours below the centre in
// a register queue and p_cur's planes in shared memory, brought in by
// cp.async two planes ahead.
//
// wave_step_kernel, the single step, reads p_prev and p_cur padded and their
// shell as data, and writes p_next and lap: 5 arrays. What held its first
// form back: one thread a point with 25 loads from device memory
// each, 5.52-5.98 ms at the (240, 1152, 1152) block against a 1.94 ms byte
// bound (events). Streaming, it takes 2.59 ms there and 0.212 ms at the
// shape the bt 1 engine launches it, (20, 1152, 1152) padded to
// (28, 1160, 1160), against 0.185 (device time a launch, was 0.480;
// tools/kernel_shapes.py; H100 80GB HBM3, 700 W).
//
// wave_rung_kernel, one launch a rung of the ladder, moves 4 arrays a rung
// (p_prev, p_cur, vel2 in, p_next out), so a 12-step call is bound by 48
// array passes where the TPU kernel's fused rungs need 5; on an H100 it runs
// at about 80% of the memory rate. Left: fused rungs (the TPU kernel's
// design, the intermediate rungs kept on chip). Two rungs a launch of this
// design did not beat one: rung 1's halo and both levels' queues leave one
// CTA an SM, held by its on-chip work, not by bytes.

#include <cuda_runtime.h>

#include <initializer_list>

#include "cp_async.cuh"

namespace {

constexpr int kHalo = 4;
// float(3.0 * C0) folded in double as the reference does, then C[k].
constexpr float kC3C0 = (float)(3.0 * (-205.0 / 72.0));
__device__ __constant__ float kC[4] = {
    (float)(8.0 / 5.0), (float)(-1.0 / 5.0), (float)(8.0 / 315.0),
    (float)(-1.0 / 560.0)};

// ---------------------------------------------------------------------------
// 2.5-D z-streaming with a register z-queue: one body, two kernels.
//
// A CTA owns a TY x TX output tile and walks z once; each thread owns one
// quad (4 points along x). p_cur's planes sit in shared memory as a ring on
// the tile grown by 4 (they arrive by cp.async two planes ahead): the centre
// plane gives the x- and y-neighbours, the planes above it the z+ ones. The
// 4 planes below the centre are a queue in the thread's registers, its own
// column only. So a quad is 15 float4 loads from shared memory (3 along x, 8
// along y, 4 above) and 4 from registers, where a ring of 9 planes in shared
// memory takes 19 and needs twice the shared memory. Each thread loads its
// quad's p_prev and vel2 before the step's barrier.
//
// The two kernels differ in what p_cur's grown tile is read from:
//  * the rung (kStep false): interior (Z, Y, X) fields; a point outside
//    [0, Z) x [0, Y) x [0, X) is +0.0f, as the ladder re-pads every rung, so
//    the queue starts at zero and the grown tile is zero-filled by index;
//  * the single step (kStep true): p_prev and p_cur padded (Z+8, Y+8, X+8),
//    their shell data, not zeros. The grown tile is a window of the padded
//    array (only its cut against the padded extent is masked, and feeds no
//    computed point), and the queue is filled from padded planes 0-3 before
//    the first output plane. The step also writes lap.
// In both, step t has the source plane t (padded or interior) landed and
// works on the centre plane t - 4 of that source; its output plane is
// t - 4 - kOff.

constexpr int kThreads = 128;
constexpr int kTY = 16, kTX = 32;  // the output tile: 5 CTAs an SM
constexpr int kQW = kTX / 4;       // quads a row
constexpr int kZq = 4;             // planes below the centre, in registers
constexpr int kRing = 7;           // p_cur planes in shared memory: t - 4 .. t + 2
constexpr int kW0 = kTX + 8, kR0 = kTY + 8, kA0 = kR0 * kW0;  // grown tile
constexpr int kSmem = kRing * kA0 * (int)sizeof(float);
static_assert(kTY * kQW == kThreads, "one quad a thread");
static_assert(kSmem <= 48 * 1024, "no opt-in to more shared memory");

__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// The quad at a[i .. i + 3]; a point whose bit in `in` is clear is 0 and is
// not read.
__device__ __forceinline__ float4 load_quad(const float* __restrict__ a,
                                            long long i, unsigned in,
                                            bool vec) {
  if (vec && in == 0xFu) return __ldg((const float4*)(a + i));
  float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (in >> j & 1u) v[j] = __ldg(a + i + j);
  return make_float4(v[0], v[1], v[2], v[3]);
}

// The extent of the array p_cur's grown tile is read from, and where the
// tile starts in it: the interior with the tile grown by 4 on each side
// (rung), or the padded array, whose shell is that growth (step).
struct Source {
  int zs, ys, xs;  // extent
  int gy0, gx0;    // the grown tile's first row and column
};

// Issue the copies of p_cur's source plane z (grown tile) into its ring slot
// and commit them as one group: zeros where the tile leaves the source, an
// empty group for the planes past the last the CTA reads (nplanes). 16
// bytes a copy when rows are 16-byte aligned, else 4.
__device__ __forceinline__ void load_plane(float* ring, int z, int nplanes,
                                           const float* __restrict__ pc,
                                           const Source& s, bool vec) {
  if (z < nplanes) {
    float* dst = ring + (z % kRing) * kA0;
    const bool zin = z < s.zs;
    const long long zo = (long long)z * s.ys * s.xs;
    if (vec) {
      for (int e = threadIdx.x; e < kA0 / 4; e += kThreads) {
        const int gy = s.gy0 + e / (kW0 / 4);
        const int gx = s.gx0 + 4 * (e % (kW0 / 4));
        const bool in = zin && gy >= 0 && gy < s.ys && gx >= 0 && gx < s.xs;
        cp_async<16>(dst + 4 * e,
                     in ? pc + zo + (long long)gy * s.xs + gx : pc, in);
      }
    } else {
      for (int e = threadIdx.x; e < kA0; e += kThreads) {
        const int gy = s.gy0 + e / kW0, gx = s.gx0 + e % kW0;
        const bool in = zin && gy >= 0 && gy < s.ys && gx >= 0 && gx < s.xs;
        cp_async<4>(dst + e, in ? pc + zo + (long long)gy * s.xs + gx : pc,
                    in);
      }
    }
  }
  cp_async_commit();
}

// One step over the CTA's column. pp and pc: interior (Z, Y, X) fields
// (kStep false) or padded (Z+8, Y+8, X+8) (kStep true); v2, pn and lap_out
// interior. lap_out is written only by the step.
template <bool kStep>
__device__ __forceinline__ void stream_column(const float* __restrict__ pp,
                                              const float* __restrict__ pc,
                                              const float* __restrict__ v2,
                                              float* __restrict__ pn,
                                              float* __restrict__ lap_out,
                                              int Z, int Y, int X, bool vec) {
  constexpr int kOff = kStep ? kHalo : 0;  // interior -> source index
  extern __shared__ float4 smem4[];
  float* ring = (float*)smem4;
  const int y0 = blockIdx.y * kTY, x0 = blockIdx.x * kTX;
  const int ly = threadIdx.x / kQW, lx = 4 * (threadIdx.x % kQW);
  const int gy = y0 + ly, gx = x0 + lx;
  unsigned in_yx = 0u;  // the quad's points inside [0, Y) x [0, X)
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (gy < Y && gx + j < X) in_yx |= 1u << j;
  const Source src = {Z + 2 * kOff, Y + 2 * kOff, X + 2 * kOff,
                      y0 - kHalo + kOff, x0 - kHalo + kOff};
  // source planes the CTA reads: the rung's Z and 4 zero planes above, the
  // step's padded Z + 8; the last output plane's centre is nplanes - 5
  const int nplanes = Z + kHalo + kOff;
  const long long col = (long long)gy * X + gx, plane = (long long)Y * X;
  // the quad in the source's planes, less the plane offset
  const long long scol = (long long)(gy + kOff) * src.xs + gx + kOff;
  const long long splane = (long long)src.ys * src.xs;
  const int ci = (ly + 4) * kW0 + lx + 4;  // the quad in a ring plane
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 q[kZq];  // p_cur at source planes t - 8 .. t - 5 (zeros below)
#pragma unroll
  for (int i = 0; i < kZq; ++i) q[i] = zero;

  load_plane(ring, 0, nplanes, pc, src, vec);
  load_plane(ring, 1, nplanes, pc, src, vec);
  int cs = kRing - 4;  // ring slot of source plane t - 4
  for (int t = 0; t < nplanes; ++t) {
    const int zc = t - 4 - kOff;  // the output plane
    const unsigned in = zc >= 0 && zc < Z ? in_yx : 0u;
    // this step's p_prev and vel2, loaded before the barrier
    const float4 prev = load_quad(pp, (zc + kOff) * splane + scol, in, vec);
    const float4 vel = load_quad(v2, zc * plane + col, in, vec);
    cp_async_wait<1>();
    __syncthreads();  // plane t landed; every thread is past step t - 1
    load_plane(ring, t + 2, nplanes, pc, src, vec);
    float4 c = zero;
    const float* s = ring + cs * kA0;
    if (in) {
      // the centre row from x - 4 to x + 7, then the sums in the
      // reference's order
      float xr[12];
      const float4* row = (const float4*)(s + ci - 4);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float4 r4 = row[i];
        xr[4 * i] = r4.x;
        xr[4 * i + 1] = r4.y;
        xr[4 * i + 2] = r4.z;
        xr[4 * i + 3] = r4.w;
      }
      c = make_float4(xr[4], xr[5], xr[6], xr[7]);
      float lap[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) lap[j] = kC3C0 * xr[4 + j];
#pragma unroll
      for (int k = 1; k <= kHalo; ++k) {
        const int up = cs + k < kRing ? cs + k : cs + k - kRing;
        const float4 zp = *(const float4*)(ring + up * kA0 + ci);
        const float4 yp = *(const float4*)(s + ci + k * kW0);
        const float4 ym = *(const float4*)(s + ci - k * kW0);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float sum = comp(zp, j) + comp(q[kZq - k], j);
          sum = sum + comp(yp, j);
          sum = sum + comp(ym, j);
          sum = sum + xr[4 + j + k];
          sum = sum + xr[4 + j - k];
          lap[j] = lap[j] + kC[k - 1] * sum;
        }
      }
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = (2.0f * xr[4 + j] - comp(prev, j)) + comp(vel, j) * lap[j];
      const long long i = zc * plane + col;
      if (vec && in == 0xFu) {
        *(float4*)(pn + i) = make_float4(v[0], v[1], v[2], v[3]);
        if constexpr (kStep)
          *(float4*)(lap_out + i) = make_float4(lap[0], lap[1], lap[2], lap[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (in >> j & 1u) {
            pn[i + j] = v[j];
            if constexpr (kStep) lap_out[i + j] = lap[j];
          }
      }
    } else if (kStep && t >= 4 && in_yx) {
      // a padded plane below the first output plane: the queue's only
      c = *(const float4*)(s + ci);
    }
#pragma unroll
    for (int i = 0; i < kZq - 1; ++i) q[i] = q[i + 1];
    q[kZq - 1] = c;
    cs = cs == kRing - 1 ? 0 : cs + 1;
  }
}

// One step on padded (Z+8, Y+8, X+8) p_prev and p_cur: p_next and lap
// interior (Z, Y, X).
__global__ void __launch_bounds__(kThreads, 5)
    wave_step_kernel(const float* __restrict__ pp,
                     const float* __restrict__ pc,
                     const float* __restrict__ v2, float* __restrict__ pn,
                     float* __restrict__ lap, int Z, int Y, int X, bool vec) {
  stream_column<true>(pp, pc, v2, pn, lap, Z, Y, X, vec);
}

// Interior (Z, Y, X) fields: pn = one ladder step from (pp, pc).
__global__ void __launch_bounds__(kThreads, 5)
    wave_rung_kernel(const float* __restrict__ pp,
                     const float* __restrict__ pc,
                     const float* __restrict__ v2, float* __restrict__ pn,
                     int Z, int Y, int X, bool vec) {
  stream_column<false>(pp, pc, v2, pn, nullptr, Z, Y, X, vec);
}

// 16-byte copies and quads: every row of every array starts 16-byte aligned
// (X % 4 == 0 makes padded rows, X + 8, and their interior offset of 4
// floats multiples of 4 too).
bool vectorizable(int X, std::initializer_list<const void*> arrays) {
  bool vec = X % 4 == 0;
  for (const void* p : arrays) vec &= (size_t)p % 16 == 0;
  return vec;
}

dim3 grid_of(int Y, int X) {
  return dim3((X + kTX - 1) / kTX, (Y + kTY - 1) / kTY);
}

}  // namespace

extern "C" {

// One step on padded p_prev, p_cur and interior vel2: p_next and lap.
int stencil_wave_step(const void* pp, const void* pc, const void* v2, void* pn,
                      void* lap, int Z, int Y, int X, void* stream) {
  const bool vec = vectorizable(X, {pp, pc, v2, pn, lap});
  wave_step_kernel<<<grid_of(Y, X), kThreads, kSmem, (cudaStream_t)stream>>>(
      (const float*)pp, (const float*)pc, (const float*)v2, (float*)pn,
      (float*)lap, Z, Y, X, vec);
  return (int)cudaGetLastError();
}

// One step of the ladder on interior (Z, Y, X) fields: pn from (pp, pc).
int stencil_wave_rung(const void* pp, const void* pc, const void* v2,
                      void* pn, int Z, int Y, int X, void* stream) {
  const bool vec = vectorizable(X, {pp, pc, v2, pn});
  wave_rung_kernel<<<grid_of(Y, X), kThreads, kSmem, (cudaStream_t)stream>>>(
      (const float*)pp, (const float*)pc, (const float*)v2, (float*)pn, Z, Y,
      X, vec);
  return (int)cudaGetLastError();
}

const char* stencil_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
