// Fixed-rate ZFP-style codec in float64: encode and decode kernels for
// Hopper (sm_90a).
//
// The float64 instances of the TPU kernels encode_pallas and decode_pallas
// (src/repro/kernels/zfp/kernel.py): the JAX package sends float64 to its
// plain version (src/repro/kernels/zfp/ops.py), whose function this is. Bit
// for bit equal to the plain PyTorch version,
// src/repro_torch/kernels/zfp/ref.py, for float64 (FRAC 55, int64 fixed
// point, 64-bit negabinary words, emax floored at -900).
//
// Bound on the H100: bytes. A 4^3 block is 512 bytes of float64 in and
// 4 W + 4 bytes out (W = 48 words at 24 planes, 64 at 32); the integer work
// per value (a 64-bit lift, a negabinary add, a mask, one bit of packing
// per kept plane through 32 x 32 bit transposes) comes close to the card's
// integer rate at 3.35 TB/s, so the design keeps it to what the kept
// planes need.
//
// Design: one thread per 4^d block with its 4^d coefficients in registers
// as long long, and each warp's 32 payload rows staged in shared memory at
// an odd row stride, as the float32 kernels of zfp.cu do.
//  * Coalesced payload traffic: the encoder packs each block into its own
//    row in shared memory, then the warp stores its contiguous run of
//    32 W words with coalesced writes; the decoder first copies that run in
//    with coalesced cp.async. One warp instruction moves 128 contiguous
//    bytes where the first form (each thread its own row, 4 W bytes apart)
//    touched 32 sectors.
//  * blockify's edge padding and unblockify's crop are folded into the
//    indexing: the encoder reads the unit clamping each coordinate to the
//    edge, the decoder writes only coordinates inside. When the rows are
//    16-byte aligned (d2 even, the pointer aligned), each whole 4-value row
//    of a block is two double2 loads or stores.
//  * A compile-time route on the planes that keep bits (kernel.f64_route).
//    Plane j is bit 63 - j of a 64-bit negabinary word: bit 31 - j of its
//    high half for j < 32, bit 63 - j of its low half after. Each half of
//    each 32 stream positions is a 32 x 32 bit matrix that zfp_common.cuh's
//    transpose32 turns into one word a plane; a route transposes only the
//    matrices that can hold kept bits:
//      route 0 (every kept plane below 32: 24/64 at every ndim) the high
//        halves only, one word a coefficient: the float32 stream of the
//        high halves, two transposes at ndim 3, one below;
//      route 1 (the planes past 32 keep only stream positions < 32: 32/64
//        at every ndim) route 0 plus the low halves of positions 0-31;
//      route 2 (ndim 3 at 33-64 planes) all four matrices.
//    The lift and the negabinary step stay in 64 bits, and the stream
//    order is zfp_common.cuh's compile-time permutation, so no index into
//    the block is known only at run time and nothing goes to local memory.
//  * The paper's rates at ndim 3 (24 planes on route 0, 32 on route 1)
//    are also compiled with their tables as constants (Rate<P>); the C
//    entries take those instances when the tables they are passed are
//    exactly these, and the run-time-table instances otherwise.
//  * Registers: the block is 128 of them as long long; every instance is
//    held to 168 (__launch_bounds__), which leaves 12 warps an SM.
//  * emax from the IEEE exponent bits: zeros and denormals map to -1022,
//    below the -900 floor, so the floor makes it equal to the frexp
//    exponent of the plain version for every finite value.
//  * Integer adds wrap explicitly (through unsigned long long), as the
//    plain version's int64 arithmetic does.
//  * The threads a CTA are the wrapper's (kernel.f64_threads): each warp
//    works alone on its 32 blocks, so small units take small CTAs and still
//    spread over every SM.
// The build uses -fmad=false; __dmul_rn and the _rn conversions round as
// the plain version does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "zfp_common.cuh"

namespace {

using zfpc::make_staging;
using zfpc::scatter_coeffs;
using zfpc::Staging;
using zfpc::staging_bytes;
using zfpc::stream_order_of;
using zfpc::stream_pos;
using zfpc::transpose32;
using zfpc::walk_rows;

constexpr unsigned long long kNbMask64 = 0xAAAAAAAAAAAAAAAAull;
constexpr int kFrac64 = 55;
constexpr int kEmaxFloor64 = -900;
constexpr int kMaxThreads = 128;  // the threads a CTA that kernels allow
// CTAs of kMaxThreads an SM that the registers must allow: at most 168 a
// thread, 12 warps an SM. One register more leaves room for 8 warps (a
// decoder at 170 registers ran a third slower at the paper's unit).
constexpr int kMinCtas = 3;

// Plane counts that route R can have at ndim ND: route 1 at ndim 3 is 28-32
// planes, so at most 32 + 5 (the subband offsets' largest); no other bound
// below the 64 planes of a word. The loops over planes stop there, so the
// rows of a plane that cannot exist are zeros the compiler folds.
template <int ND, int R>
__host__ __device__ constexpr int max_planes() {
  return R == 0 ? 32 : ND == 3 && R == 1 ? 37 : 64;
}

struct Tables64 {
  unsigned long long mask[64];  // keep-mask of each coefficient
  uint8_t counts[64];           // contributors to plane j: a prefix
  int nplanes;                  // planes that have contributors
  int nwords;                   // payload words per block
};

// The tables of the paper's rates at ndim 3, P = 24 and 32 planes (the
// subband order, ref.subband_planes): coefficient i keeps P + delta planes,
// delta by its subband level (5, 4, 2, 1, 0, -2, -3 for levels 0-6, which
// hold 1, 3, 9, 13, 18, 12 and 8 coefficients), P + 5 planes have
// contributors and a block is 2 P words.
__host__ __device__ constexpr int level_delta3(int lv) {
  return lv == 0 ? 5 : lv == 1 ? 4 : lv == 2 ? 2 : lv == 3 ? 1
         : lv == 4 ? 0 : lv == 5 ? -2 : -3;
}
__host__ __device__ constexpr int level_size3(int lv) {
  return lv == 0 ? 1 : lv == 1 ? 3 : lv == 2 ? 9 : lv == 3 ? 13
         : lv == 4 ? 18 : lv == 5 ? 12 : 8;
}
__host__ __device__ constexpr int fixed_count(int P, int j) {
  int n = 0;
  for (int lv = 0; lv < 7; ++lv)
    n += P + level_delta3(lv) > j ? level_size3(lv) : 0;
  return n;
}
__host__ __device__ constexpr unsigned long long fixed_mask(int P, int i) {
  return ~0ull << (64 - (P + level_delta3(zfpc::coeff_level(3, i))));
}

// A launch's tables as the kernels read them: those passed at run time
// (P = 0), or the compile-time tables of P planes (fixed_count, fixed_mask),
// whose plane counts, field offsets, masks and row width the compiler folds
// into the code: no table load, no plane guard, no shift known only at run
// time, and the rows of planes without contributors are zeros the
// transposes fold.
template <int P>
struct Rate {
  const Tables64& t;
  __device__ __forceinline__ int nplanes() const {
    if constexpr (P > 0) return P + 5; else return t.nplanes;
  }
  __device__ __forceinline__ int count(int j) const {
    if constexpr (P > 0) return fixed_count(P, j); else return t.counts[j];
  }
  __device__ __forceinline__ unsigned long long mask(int i) const {
    if constexpr (P > 0) return fixed_mask(P, i); else return t.mask[i];
  }
  __device__ __forceinline__ int nwords() const {
    if constexpr (P > 0) return 2 * P; else return t.nwords;
  }
};

struct Geometry {
  long long batch;  // leading axes folded into one
  int d0, d1, d2;   // spatial extents (unused axes are 1)
  int n0, n1, n2;   // blocks along each spatial axis
  long long nb;     // blocks in all
};

// Block b -> (batch, first z, first y, first x) of its 4^ND corner. In 32
// bits: a 64-bit division is a long sequence of instructions, and the entries
// refuse a unit of 2^32 blocks or more (at least 128 GB of float64).
template <int ND>
__device__ __forceinline__ void block_origin(const Geometry& g, unsigned b,
                                             long long* bb, int* z0, int* y0,
                                             int* x0) {
  const unsigned r = b / (unsigned)g.n2, rr = r / (unsigned)g.n1;
  const int b1 = (int)(r - rr * (unsigned)g.n1);
  const int b0 = (int)(rr % (unsigned)g.n0);
  *bb = (long long)(rr / (unsigned)g.n0);
  *z0 = ND >= 3 ? 4 * b0 : b0;
  *y0 = ND >= 2 ? 4 * b1 : b1;
  *x0 = 4 * (int)(b - r * (unsigned)g.n2);
}

__device__ __forceinline__ long long wadd(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}
__device__ __forceinline__ long long wsub(long long a, long long b) {
  return (long long)((unsigned long long)a - (unsigned long long)b);
}

template <int ND>
__device__ __forceinline__ constexpr int axis_stride(int a) {
  // axis a of the (4,)*ND coefficient block, slowest first
  return a == 0 ? (ND == 3 ? 16 : ND == 2 ? 4 : 1) : a == 1 ? (ND == 3 ? 4 : 1) : 1;
}

// The two-level Haar S-lift along each axis (ref._lift4_fwd), in int64.
template <int ND>
__device__ __forceinline__ void lift_fwd(long long* q) {
  constexpr int N = 1 << (2 * ND);
#pragma unroll
  for (int a = 0; a < ND; ++a) {
    const int s = axis_stride<ND>(a);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (((i / s) & 3) == 0) {
        const long long q0 = q[i], q1 = q[i + s], q2 = q[i + 2 * s],
                        q3 = q[i + 3 * s];
        const long long s0 = wadd(q0, q1) >> 1, d0 = wsub(q0, q1);
        const long long s1 = wadd(q2, q3) >> 1, d1 = wsub(q2, q3);
        q[i] = wadd(s0, s1) >> 1;
        q[i + s] = wsub(s0, s1);
        q[i + 2 * s] = d0;
        q[i + 3 * s] = d1;
      }
    }
  }
}

// Its inverse (ref._lift4_inv), the axes in the opposite order.
template <int ND>
__device__ __forceinline__ void lift_inv(long long* c) {
  constexpr int N = 1 << (2 * ND);
#pragma unroll
  for (int a = ND - 1; a >= 0; --a) {
    const int s = axis_stride<ND>(a);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (((i / s) & 3) == 0) {
        const long long ss = c[i], ds = c[i + s], d0 = c[i + 2 * s],
                        d1 = c[i + 3 * s];
        const long long s0 = wadd(ss, wadd(ds, 1) >> 1), s1 = wsub(s0, ds);
        const long long q0 = wadd(s0, wadd(d0, 1) >> 1), q1 = wsub(q0, d0);
        const long long q2 = wadd(s1, wadd(d1, 1) >> 1), q3 = wsub(q2, d1);
        c[i] = q0;
        c[i + s] = q1;
        c[i + 2 * s] = q2;
        c[i + 3 * s] = q3;
      }
    }
  }
}

// Coefficient I of the block from the transposed planes: the high half of
// its negabinary word at stream position p = stream_pos(I) (a compile-time
// index into h0 for p < 32, h1 after), and on routes 1 and 2 its low half
// (l0/l1; route 1 keeps none past position 31); negabinary undone in 64
// bits, wrapping, as the plain version.
template <int ND, bool kSub, int R, int I = 0>
__device__ __forceinline__ void gather64(const uint32_t* h0,
                                         const uint32_t* h1,
                                         const uint32_t* l0,
                                         const uint32_t* l1, long long* c) {
  if constexpr (I < (1 << (2 * ND))) {
    constexpr int p = stream_pos<ND, kSub>(I);
    uint32_t hi, lo = 0u;
    if constexpr (p < 32) {
      hi = h0[p];
      if constexpr (R >= 1) lo = l0[p];
    } else {
      hi = h1[p - 32];
      if constexpr (R == 2) lo = l1[p - 32];
    }
    const unsigned long long u = (unsigned long long)hi << 32 | lo;
    c[I] = (long long)((u ^ kNbMask64) - kNbMask64);
    gather64<ND, kSub, R, I + 1>(h0, h1, l0, l1, c);
  }
}

// Encode: one thread a 4^ND block of float64, kSub: the stream order, R:
// the route, P: the compile-time rate (0: the tables t). vec: the unit's
// rows are 16-byte aligned (d2 even).
template <int ND, bool kSub, int R, int P>
__global__ void __launch_bounds__(kMaxThreads, kMinCtas)
    encode64_kernel(const double* __restrict__ x,
                    uint32_t* __restrict__ payload, int* __restrict__ emax_out,
                    Geometry g, Tables64 t, Staging st_in, bool vec) {
  constexpr int N = 1 << (2 * ND);
  constexpr int E0 = ND >= 3 ? 4 : 1, E1 = ND >= 2 ? 4 : 1;
  constexpr bool kHi = ND == 3;  // 64 stream positions
  extern __shared__ uint32_t rows[];
  const Rate<P> rt{t};
  const Staging st = P > 0 ? make_staging(rt.nwords()) : st_in;
  const int lane = threadIdx.x & 31;
  const int w = rt.nwords();
  uint32_t* wrows = rows + (threadIdx.x - lane) * st.stride;
  const long long b0 =
      (long long)blockIdx.x * blockDim.x + (threadIdx.x - lane);
  if (b0 >= g.nb) return;  // the whole warp
  const long long b = b0 + lane;
  if (b < g.nb) {
    long long bb;
    int z0, y0, x0;
    block_origin<ND>(g, (unsigned)b, &bb, &z0, &y0, &x0);
    // the block, x fastest, each coordinate clamped to the edge
    const bool whole_x = vec && x0 + 4 <= g.d2;
    double v[N];
#pragma unroll
    for (int rw = 0; rw < E0 * E1; ++rw) {
      const int zi = min(z0 + rw / E1, g.d0 - 1);
      const int yi = min(y0 + rw % E1, g.d1 - 1);
      const double* row =
          x + ((bb * g.d0 + zi) * g.d1 + yi) * (long long)g.d2;
      if (whole_x) {
        const double2 a = __ldg((const double2*)(row + x0));
        const double2 c = __ldg((const double2*)(row + x0 + 2));
        v[4 * rw] = a.x;
        v[4 * rw + 1] = a.y;
        v[4 * rw + 2] = c.x;
        v[4 * rw + 3] = c.y;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[4 * rw + k] = __ldg(row + min(x0 + k, g.d2 - 1));
      }
    }

    int emax = -1022;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int raw = (int)((__double_as_longlong(v[i]) >> 52) & 0x7FF);
      emax = max(emax, raw == 0 ? -1022 : raw - 1022);
    }
    emax = max(emax, kEmaxFloor64);
    const double scale =
        __longlong_as_double((long long)(kFrac64 - emax + 1023) << 52);

    long long q[N];
#pragma unroll
    for (int i = 0; i < N; ++i) q[i] = __double2ll_rn(__dmul_rn(v[i], scale));
    lift_fwd<ND>(q);
    // the masked negabinary words' halves, natural order: the high halves
    // on every route, the low halves on routes 1 and 2 (route 1 uses those
    // at stream positions < 32 only; the others are dead code)
    uint32_t hw[N], lw[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const unsigned long long u =
          ((unsigned long long)q[i] + kNbMask64) ^ kNbMask64;
      hw[i] = (uint32_t)(u >> 32) & (uint32_t)(rt.mask(i) >> 32);
      if constexpr (R >= 1) lw[i] = (uint32_t)u & (uint32_t)rt.mask(i);
    }
    // word 31 - j of a transposed matrix is plane j's bit of its 32
    // positions (low halves: plane 32 + (31 - word)); the keep-masks clear
    // every position at or past counts[j], so each word is the plane's
    // field already cut to counts[j] bits
    uint32_t h0[32], h1[32], l0[32], l1[32];
    scatter_coeffs<ND, kSub>(hw, h0, h1);
    transpose32(h0);
    if constexpr (kHi) transpose32(h1);
    if constexpr (R >= 1) {
      scatter_coeffs<ND, kSub>(lw, l0, l1);
      transpose32(l0);
      if constexpr (R == 2) transpose32(l1);
    }
    uint32_t* out = wrows + lane * st.stride;
    unsigned long long acc = 0ull;  // bits not yet stored, nacc < 32
    int nacc = 0, wi = 0;
    const auto append = [&](uint32_t field, int k) {
      acc |= (unsigned long long)field << nacc;
      nacc += k;
      if (nacc >= 32) {
        out[wi++] = (uint32_t)acc;
        acc >>= 32;
        nacc -= 32;
      }
    };
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (j < rt.nplanes()) {
        const int k = rt.count(j);
        append(h0[31 - j], min(k, 32));
        if constexpr (kHi) {
          if (k > 32) append(h1[31 - j], k - 32);
        }
      }
    }
    if constexpr (R >= 1) {
#pragma unroll
      for (int j = 32; j < max_planes<ND, R>(); ++j) {
        if (j < rt.nplanes()) {
          const int k = rt.count(j);
          append(l0[63 - j], min(k, 32));
          if constexpr (R == 2) {
            if (k > 32) append(l1[63 - j], k - 32);
          }
        }
      }
    }
    if (nacc) out[wi] = (uint32_t)acc;
    emax_out[b] = emax;
  }
  __syncwarp();
  uint32_t* dst = payload + b0 * w;
  walk_rows(lane, (int)min(32LL, g.nb - b0) * w, w, st,
            [&](int i, int r, int c) { dst[i] = wrows[r * st.stride + c]; });
}

// Plane j's field of counts[j] <= 64 bits from the stream row `in` at bit
// `off` (funnel shifts; the bits past counts[j] belong to the next plane):
// its low 32 bits in *lo, the rest in *hi (only when kHi: more than 32
// positions). Zeros for a plane without contributors. May read two words
// past the row.
template <bool kHi, int P>
__device__ __forceinline__ void take_field(const uint32_t* in,
                                           const Rate<P>& rt, int j,
                                           int* off, uint32_t* lo,
                                           uint32_t* hi) {
  *lo = *hi = 0u;
  if (j < rt.nplanes()) {
    const int k = rt.count(j);
    const int wi = *off >> 5, sh = *off & 31;
    const uint32_t w1 = in[wi + 1];
    *lo = __funnelshift_r(in[wi], w1, sh);
    if constexpr (kHi) *hi = __funnelshift_r(w1, in[wi + 2], sh);
    if (k < 32) {
      *lo &= (1u << k) - 1u;
      *hi = 0u;
    } else if (k < 64) {
      *hi &= (1u << (k - 32)) - 1u;
    }
    *off += k;
  }
}

// Decode: one thread a 4^ND block; writes only the coordinates inside.
// vec: the output's rows are 16-byte aligned (d2 even), so each whole row
// of a whole block goes out as two double2.
template <int ND, bool kSub, int R, int P>
__global__ void __launch_bounds__(kMaxThreads, kMinCtas)
    decode64_kernel(const uint32_t* __restrict__ payload,
                    const int* __restrict__ emax_in, double* __restrict__ x,
                    Geometry g, Tables64 t, Staging st_in, bool vec) {
  constexpr int N = 1 << (2 * ND);
  constexpr int E0 = ND >= 3 ? 4 : 1, E1 = ND >= 2 ? 4 : 1;
  constexpr bool kHi = ND == 3;
  extern __shared__ uint32_t rows[];
  const Rate<P> rt{t};
  const Staging st = P > 0 ? make_staging(rt.nwords()) : st_in;
  const int lane = threadIdx.x & 31;
  const int w = rt.nwords();
  // the warp's 32 blocks: their payload rows are one contiguous run of
  // words, copied with coalesced loads into rows at an odd stride
  uint32_t* wrows = rows + (threadIdx.x - lane) * st.stride;
  const long long b0 =
      (long long)blockIdx.x * blockDim.x + (threadIdx.x - lane);
  if (b0 >= g.nb) return;  // the whole warp
  const uint32_t* src = payload + b0 * w;
  walk_rows(lane, (int)min(32LL, g.nb - b0) * w, w, st,
            [&](int i, int r, int c) {
              cp_async<4>(wrows + r * st.stride + c, src + i);
            });
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
  const long long b = b0 + lane;
  if (b >= g.nb) return;

  // field j becomes word 31 - j of the high halves' matrices (j < 32) or
  // 63 - j of the low halves' (j >= 32; route 1 keeps at most 32 positions
  // there, so only l0)
  const uint32_t* in = wrows + lane * st.stride;
  uint32_t h0[32], h1[32], l0[32], l1[32];
  int off = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j)
    take_field<kHi>(in, rt, j, &off, &h0[31 - j], &h1[31 - j]);
  transpose32(h0);
  if constexpr (kHi) transpose32(h1);
  if constexpr (R >= 1) {
#pragma unroll
    for (int j = 32; j < 64; ++j) {
      if (j < max_planes<ND, R>()) {
        take_field<R == 2>(in, rt, j, &off, &l0[63 - j], &l1[63 - j]);
      } else {
        l0[63 - j] = l1[63 - j] = 0u;
      }
    }
    transpose32(l0);
    if constexpr (R == 2) transpose32(l1);
  }
  long long c[N];
  gather64<ND, kSub, R>(h0, h1, l0, l1, c);
  lift_inv<ND>(c);

  const double scale =
      __longlong_as_double((long long)(emax_in[b] - kFrac64 + 1023) << 52);
  long long bb;
  int z0, y0, x0;
  block_origin<ND>(g, (unsigned)b, &bb, &z0, &y0, &x0);
  const bool whole = z0 + E0 <= g.d0 && y0 + E1 <= g.d1 && x0 + 4 <= g.d2;
#pragma unroll
  for (int rw = 0; rw < E0 * E1; ++rw) {
    const int zi = z0 + rw / E1, yi = y0 + rw % E1;
    double* out = x + ((bb * g.d0 + zi) * g.d1 + yi) * (long long)g.d2 + x0;
    double f[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      f[k] = __dmul_rn(__ll2double_rn(c[4 * rw + k]), scale);
    if (vec && whole) {
      *(double2*)out = make_double2(f[0], f[1]);
      *(double2*)(out + 2) = make_double2(f[2], f[3]);
    } else if (zi < g.d0 && yi < g.d1) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (x0 + k < g.d2) out[k] = f[k];
    }
  }
}

Geometry make_geometry(long long batch, int d0, int d1, int d2, int ndim) {
  Geometry g;
  g.batch = batch;
  g.d0 = d0;
  g.d1 = d1;
  g.d2 = d2;
  g.n0 = ndim >= 3 ? (d0 + 3) / 4 : d0;
  g.n1 = ndim >= 2 ? (d1 + 3) / 4 : d1;
  g.n2 = (d2 + 3) / 4;
  g.nb = batch * g.n0 * g.n1 * (long long)g.n2;
  return g;
}

int order_of(int ndim, const int* perm) {
  return ndim == 3   ? stream_order_of<3>(perm)
         : ndim == 2 ? stream_order_of<2>(perm)
                     : stream_order_of<1>(perm);
}

// The route that plane counts `counts` take (kernel.f64_route): 0 when no
// plane past 31 has contributors, 1 when none past 31 has more than 32
// (the counts fall with j), 2 otherwise.
int route_of(const int* counts, int nplanes) {
  return nplanes <= 32 ? 0 : counts[32] <= 32 ? 1 : 2;
}

int max_planes_of(int ndim, int route) {
  return route == 0 ? max_planes<3, 0>()
         : ndim == 3 && route == 1 ? max_planes<3, 1>()
                                   : max_planes<3, 2>();
}

// The tables of one launch, or false when they do not fit (more planes
// than 64 or than the route has, a perm table not in `order`, plane counts
// not of `route`).
bool make_tables(int ndim, const void* masks, const void* perm,
                 const void* counts, int nplanes, int nwords, int order,
                 int route, Tables64* t) {
  const int* cn = (const int*)counts;
  if (order < 0 || nplanes < 0 || nplanes > 64 ||
      order_of(ndim, (const int*)perm) != order ||
      route_of(cn, nplanes) != route || nplanes > max_planes_of(ndim, route))
    return false;
  *t = {};
  const int n = 1 << (2 * ndim);
  for (int i = 0; i < n; ++i) t->mask[i] = ((const unsigned long long*)masks)[i];
  for (int j = 0; j < nplanes; ++j) t->counts[j] = (uint8_t)cn[j];
  t->nplanes = nplanes;
  t->nwords = nwords;
  return true;
}

using Encode64 = void (*)(const double*, uint32_t*, int*, Geometry, Tables64,
                          Staging, bool);
using Decode64 = void (*)(const uint32_t*, const int*, double*, Geometry,
                          Tables64, Staging, bool);

struct Instance {
  Encode64 encode;
  Decode64 decode;
};

template <int ND, bool kSub, int R, int P = 0>
Instance instance() {
  return {encode64_kernel<ND, kSub, R, P>, decode64_kernel<ND, kSub, R, P>};
}

// Whether the tables are the compile-time ones of P planes at ndim 3.
template <int P>
bool is_fixed(const Tables64& t) {
  bool same = t.nplanes == P + 5 && t.nwords == 2 * P;
  for (int j = 0; same && j < t.nplanes; ++j)
    same = t.counts[j] == fixed_count(P, j);
  for (int i = 0; same && i < 64; ++i) same = t.mask[i] == fixed_mask(P, i);
  return same;
}

// The compiled instances: each (ndim, stream order, route) that
// kernel.stream_order and kernel.f64_route give for some plane count, and
// the paper's two rates at ndim 3 with their tables at compile time.
bool pick(int ndim, int order, int route, const Tables64& t, Instance* k) {
  const int key = ndim * 100 + order * 10 + route;
  switch (key) {
    case 310:  // 4-27 planes
      *k = is_fixed<24>(t) ? instance<3, true, 0, 24>()
                           : instance<3, true, 0>();
      return true;
    case 300: *k = instance<3, false, 0>(); return true;    // 1-3
    case 311:  // 28-32
      *k = is_fixed<32>(t) ? instance<3, true, 1, 32>()
                           : instance<3, true, 1>();
      return true;
    case 312: *k = instance<3, true, 2>(); return true;     // 33-59
    case 302: *k = instance<3, false, 2>(); return true;    // 60-64
    case 210: *k = instance<2, true, 0>(); return true;     // 4-29
    case 200: *k = instance<2, false, 0>(); return true;    // 1-3
    case 211: *k = instance<2, true, 1>(); return true;     // 30-59
    case 201: *k = instance<2, false, 1>(); return true;    // 60-64
    case 100: *k = instance<1, false, 0>(); return true;    // 1-30
    case 101: *k = instance<1, false, 1>(); return true;    // 31-64
    default: return false;
  }
}

// Check one launch and set it up: its tables, geometry (fewer than 2^32
// blocks), staging, kernel pair, grid and shared memory (opted in above
// 48 KB). Returns a CUDA error code; `*grid` is 0 when there is nothing to
// launch.
int prepare(int ndim, const void* masks, const void* perm, const void* counts,
            int nplanes, int nwords, int order, int route, int threads,
            long long batch, int d0, int d1, int d2, bool encode, Tables64* t,
            Geometry* g, Staging* st, Instance* k, unsigned* grid,
            size_t* smem) {
  *grid = 0;
  if (threads < 32 || threads > kMaxThreads || threads % 32 ||
      !make_tables(ndim, masks, perm, counts, nplanes, nwords, order, route,
                   t) ||
      !pick(ndim, order, route, *t, k))
    return (int)cudaErrorInvalidValue;
  *g = make_geometry(batch, d0, d1, d2, ndim);
  if (g->nb > 0xFFFFFFFFll) return (int)cudaErrorInvalidValue;
  if (g->nb == 0) return (int)cudaSuccess;
  *st = make_staging(nwords);
  *smem = staging_bytes(threads, nwords);
  if (*smem > 48 * 1024) {
    const void* fn = encode ? (const void*)k->encode : (const void*)k->decode;
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
    if (err != cudaSuccess) return (int)err;
  }
  *grid = (unsigned)((g->nb + threads - 1) / threads);
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// x: (batch, d0, d1, d2) float64, contiguous, on the device. For ndim 2
// pass d0 = 1, for ndim 1 d0 = d1 = 1. Table pointers are host memory:
// masks uint64 (natural order), perm and counts int32. Both entries take
// the stream order of their tables (1: the subband order, 0: the
// identity; kernel.stream_order picks it), their route (kernel.f64_route)
// and the threads a CTA (kernel.f64_threads: 32, 64 or 128), and refuse a
// launch whose perm table is not in that order, whose plane counts are not
// of that route, or whose threads are none of those.
int zfp_encode_f64(const void* x, void* payload, void* emax, long long batch,
                   int d0, int d1, int d2, int ndim, const void* masks,
                   const void* perm, const void* counts, int nplanes,
                   int nwords, int order, int route, int threads,
                   void* stream) {
  Tables64 t;
  Geometry g;
  Staging st;
  Instance k;
  unsigned grid;
  size_t smem;
  const int err = prepare(ndim, masks, perm, counts, nplanes, nwords, order,
                          route, threads, batch, d0, d1, d2, true, &t, &g,
                          &st, &k, &grid, &smem);
  if (err != (int)cudaSuccess || grid == 0) return err;
  const bool vec = d2 % 2 == 0 && ((size_t)x & 15) == 0;
  k.encode<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const double*)x, (uint32_t*)payload, (int*)emax, g, t, st, vec);
  return (int)cudaGetLastError();
}

int zfp_decode_f64(const void* payload, const void* emax, void* x,
                   long long batch, int d0, int d1, int d2, int ndim,
                   const void* masks, const void* perm, const void* counts,
                   int nplanes, int nwords, int order, int route, int threads,
                   void* stream) {
  Tables64 t;
  Geometry g;
  Staging st;
  Instance k;
  unsigned grid;
  size_t smem;
  const int err = prepare(ndim, masks, perm, counts, nplanes, nwords, order,
                          route, threads, batch, d0, d1, d2, false, &t, &g,
                          &st, &k, &grid, &smem);
  if (err != (int)cudaSuccess || grid == 0) return err;
  const bool vec = d2 % 2 == 0 && ((size_t)x & 15) == 0;
  k.decode<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)payload, (const int*)emax, (double*)x, g, t, st, vec);
  return (int)cudaGetLastError();
}

const char* zfp64_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
