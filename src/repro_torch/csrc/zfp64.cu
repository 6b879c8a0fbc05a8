// Fixed-rate ZFP-style codec in float64: encode and decode kernels for
// Hopper (sm_90a), first form.
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
// per kept plane through 32 x 32 bit transposes) is below the card's
// integer rate at 3.35 TB/s.
//
// Design (a simple kernel first; the float32 kernels of zfp.cu are the
// redesigned ones): one thread per 4^d block with its 4^d coefficients in
// registers as long long.
//  * blockify's edge padding and unblockify's crop are folded into the
//    indexing, as in zfp.cu: the encoder reads the unit clamping each
//    coordinate to the edge, the decoder writes only coordinates inside.
//  * emax from the IEEE exponent bits: zeros and denormals map to -1022,
//    below the -900 floor, so the floor makes it equal to the frexp
//    exponent of the plain version for every finite value.
//  * Integer adds wrap explicitly (through unsigned long long), as the
//    plain version's int64 arithmetic does.
//  * The stream is packed and unpacked in registers: a 64-bit word is two
//    32-bit halves, and plane j (bit 63 - j) is bit 31 - j of the high half
//    for j < 32 and bit 63 - j of the low half after. Each half of the 64
//    stream positions (two sets of 32) goes through zfp_common.cuh's 32 x
//    32 bit transpose, after which one word holds one plane's bit of 32
//    positions. The stream order is zfp_common.cuh's compile-time
//    permutation (the subband order holds for 4 <= planes <= 59 at width
//    64), so no index into the block is known only at run time.
//  * Each thread reads and writes its own payload row in device memory,
//    word by word (rows 4 W bytes apart across a warp): what the float32
//    kernels stage through shared memory, this first form does not.
// The build uses -fmad=false; __dmul_rn and the _rn conversions round as
// the plain version does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "zfp_common.cuh"

namespace {

using zfpc::stream_order_of;
using zfpc::stream_pos;
using zfpc::transpose32;

constexpr unsigned long long kNbMask64 = 0xAAAAAAAAAAAAAAAAull;
constexpr int kFrac64 = 55;
constexpr int kEmaxFloor64 = -900;
constexpr int kThreads = 128;

struct Tables64 {
  unsigned long long mask[64];  // keep-mask of each coefficient
  uint8_t counts[64];           // contributors to plane j: a prefix
  int nplanes;                  // planes that have contributors
  int nwords;                   // payload words per block
};

struct Geometry {
  long long batch;  // leading axes folded into one
  int d0, d1, d2;   // spatial extents (unused axes are 1)
  int n0, n1, n2;   // blocks along each spatial axis
  long long nb;     // blocks in all
};

// Block b -> (batch, first z, first y, first x) of its 4^ND corner.
template <int ND>
__device__ __forceinline__ void block_origin(const Geometry& g, long long b,
                                             long long* bb, int* z0, int* y0,
                                             int* x0) {
  const int b2 = (int)(b % g.n2);
  const int b1 = (int)((b / g.n2) % g.n1);
  const int b0 = (int)((b / ((long long)g.n2 * g.n1)) % g.n0);
  *bb = b / ((long long)g.n2 * g.n1 * g.n0);
  *z0 = ND >= 3 ? 4 * b0 : b0;
  *y0 = ND >= 2 ? 4 * b1 : b1;
  *x0 = 4 * b2;
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

// The block's 64-bit words in stream order, as four 32-word bit matrices:
// h0/l0 the high/low halves of stream positions 0-31, h1/l1 of 32-63
// (positions past the block are 0). u[I] goes to position stream_pos(I),
// a compile-time index.
template <int ND, bool kSub, int I = 0>
__device__ __forceinline__ void scatter64(const unsigned long long* u,
                                          uint32_t* h0, uint32_t* l0,
                                          uint32_t* h1, uint32_t* l1) {
  if constexpr (I == 0) {
#pragma unroll
    for (int p = 1 << (2 * ND); p < 32; ++p) h0[p] = l0[p] = 0u;
  }
  if constexpr (I < (1 << (2 * ND))) {
    constexpr int p = stream_pos<ND, kSub>(I);
    if constexpr (p < 32) {
      h0[p] = (uint32_t)(u[I] >> 32);
      l0[p] = (uint32_t)u[I];
    } else {
      h1[p - 32] = (uint32_t)(u[I] >> 32);
      l1[p - 32] = (uint32_t)u[I];
    }
    scatter64<ND, kSub, I + 1>(u, h0, l0, h1, l1);
  }
}

// The inverse of scatter64: coefficient I from stream position
// stream_pos(I), negabinary undone (wrapping, as the plain version).
template <int ND, bool kSub, int I = 0>
__device__ __forceinline__ void gather64(const uint32_t* h0,
                                         const uint32_t* l0,
                                         const uint32_t* h1,
                                         const uint32_t* l1, long long* c) {
  if constexpr (I < (1 << (2 * ND))) {
    constexpr int p = stream_pos<ND, kSub>(I);
    unsigned long long u;
    if constexpr (p < 32) {
      u = (unsigned long long)h0[p] << 32 | l0[p];
    } else {
      u = (unsigned long long)h1[p - 32] << 32 | l1[p - 32];
    }
    c[I] = (long long)((u ^ kNbMask64) - kNbMask64);
    gather64<ND, kSub, I + 1>(h0, l0, h1, l1, c);
  }
}

// Encode: one thread a 4^ND block of float64.
template <int ND, bool kSub>
__global__ void __launch_bounds__(kThreads)
    encode64_kernel(const double* __restrict__ x,
                    uint32_t* __restrict__ payload, int* __restrict__ emax_out,
                    Geometry g, Tables64 t) {
  constexpr int N = 1 << (2 * ND);
  constexpr int E0 = ND >= 3 ? 4 : 1, E1 = ND >= 2 ? 4 : 1;
  constexpr bool kHi = ND == 3;  // 64 stream positions
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (b >= g.nb) return;
  long long bb;
  int z0, y0, x0;
  block_origin<ND>(g, b, &bb, &z0, &y0, &x0);

  // the block, x fastest, each coordinate clamped to the edge
  double v[N];
#pragma unroll
  for (int rw = 0; rw < E0 * E1; ++rw) {
    const int zi = min(z0 + rw / E1, g.d0 - 1);
    const int yi = min(y0 + rw % E1, g.d1 - 1);
    const double* row = x + ((bb * g.d0 + zi) * g.d1 + yi) * (long long)g.d2;
#pragma unroll
    for (int k = 0; k < 4; ++k) v[4 * rw + k] = __ldg(row + min(x0 + k, g.d2 - 1));
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
  unsigned long long u[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
    u[i] = (((unsigned long long)q[i] + kNbMask64) ^ kNbMask64) & t.mask[i];

  uint32_t h0[32], l0[32], h1[32], l1[32];
  scatter64<ND, kSub>(u, h0, l0, h1, l1);
  transpose32(h0);
  transpose32(l0);
  if constexpr (kHi) {
    transpose32(h1);
    transpose32(l1);
  }
  // plane j's bits of positions 0-31 (lo) and 32-63 (hi): word 31 - j of
  // the high halves' matrices for j < 32, word 63 - j of the low halves'
  // after; the keep-masks clear every position at or past counts[j], so
  // each is the plane's field already cut to counts[j] bits
  uint32_t* out = payload + b * t.nwords;
  unsigned long long acc = 0ull;  // bits not yet stored, nacc < 32 of them
  int nacc = 0, w = 0;
  const auto append = [&](uint32_t field, int k) {
    acc |= (unsigned long long)field << nacc;
    nacc += k;
    if (nacc >= 32) {
      out[w++] = (uint32_t)acc;
      acc >>= 32;
      nacc -= 32;
    }
  };
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (j < t.nplanes) {
      const int k = t.counts[j];
      append(h0[31 - j], min(k, 32));
      if constexpr (kHi) {
        if (k > 32) append(h1[31 - j], k - 32);
      }
    }
  }
#pragma unroll
  for (int j = 32; j < 64; ++j) {
    if (j < t.nplanes) {
      const int k = t.counts[j];
      append(l0[63 - j], min(k, 32));
      if constexpr (kHi) {
        if (k > 32) append(l1[63 - j], k - 32);
      }
    }
  }
  if (nacc) out[w] = (uint32_t)acc;
  emax_out[b] = emax;
}

// Decode: one thread a 4^ND block; writes only the coordinates inside.
template <int ND, bool kSub>
__global__ void __launch_bounds__(kThreads)
    decode64_kernel(const uint32_t* __restrict__ payload,
                    const int* __restrict__ emax_in, double* __restrict__ x,
                    Geometry g, Tables64 t) {
  constexpr int N = 1 << (2 * ND);
  constexpr int E0 = ND >= 3 ? 4 : 1, E1 = ND >= 2 ? 4 : 1;
  constexpr bool kHi = ND == 3;
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (b >= g.nb) return;
  const uint32_t* in = payload + b * t.nwords;
  const int nw = t.nwords;
  // the row's word i, 0 past its end
  const auto word = [&](int i) { return i < nw ? __ldg(in + i) : 0u; };

  uint32_t h0[32], l0[32], h1[32], l1[32];
  int off = 0;
  // plane j's field of counts[j] bits at stream bit `off` (lo: positions
  // 0-31, hi: 32-63), zeros for a plane without contributors
  const auto field = [&](int j, uint32_t* lo, uint32_t* hi) {
    *lo = *hi = 0u;
    if (j < t.nplanes) {
      const int k = t.counts[j];
      const int wi = off >> 5, sh = off & 31;
      const uint32_t w1 = word(wi + 1);
      *lo = __funnelshift_r(word(wi), w1, sh);
      if (kHi) *hi = __funnelshift_r(w1, word(wi + 2), sh);
      // the bits past k belong to the next plane
      if (k < 32) {
        *lo &= (1u << k) - 1u;
        *hi = 0u;
      } else if (k < 64) {
        *hi &= (1u << (k - 32)) - 1u;
      }
      off += k;
    }
  };
#pragma unroll
  for (int j = 0; j < 32; ++j) field(j, &h0[31 - j], &h1[31 - j]);
#pragma unroll
  for (int j = 32; j < 64; ++j) field(j, &l0[63 - j], &l1[63 - j]);
  transpose32(h0);
  transpose32(l0);
  if constexpr (kHi) {
    transpose32(h1);
    transpose32(l1);
  }
  long long c[N];
  gather64<ND, kSub>(h0, l0, h1, l1, c);
  lift_inv<ND>(c);

  const double scale =
      __longlong_as_double((long long)(emax_in[b] - kFrac64 + 1023) << 52);
  long long bb;
  int z0, y0, x0;
  block_origin<ND>(g, b, &bb, &z0, &y0, &x0);
#pragma unroll
  for (int rw = 0; rw < E0 * E1; ++rw) {
    const int zi = z0 + rw / E1, yi = y0 + rw % E1;
    if (zi < g.d0 && yi < g.d1) {
      double* row = x + ((bb * g.d0 + zi) * g.d1 + yi) * (long long)g.d2;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (x0 + k < g.d2)
          row[x0 + k] = __dmul_rn(__ll2double_rn(c[4 * rw + k]), scale);
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

// The tables of one launch, or false when they do not fit (more planes
// than 64, a perm table not in `order`).
bool make_tables(int ndim, const void* masks, const void* perm,
                 const void* counts, int nplanes, int nwords, int order,
                 Tables64* t) {
  if (order < 0 || nplanes < 0 || nplanes > 64 ||
      order_of(ndim, (const int*)perm) != order)
    return false;
  *t = {};
  const int n = 1 << (2 * ndim);
  for (int i = 0; i < n; ++i) t->mask[i] = ((const unsigned long long*)masks)[i];
  for (int j = 0; j < nplanes; ++j) t->counts[j] = (uint8_t)((const int*)counts)[j];
  t->nplanes = nplanes;
  t->nwords = nwords;
  return true;
}

}  // namespace

extern "C" {

// x: (batch, d0, d1, d2) float64, contiguous, on the device. For ndim 2
// pass d0 = 1, for ndim 1 d0 = d1 = 1. Table pointers are host memory:
// masks uint64 (natural order), perm and counts int32. Both entries take
// the stream order of their tables (1: the subband order, 0: the
// identity; kernel.stream_order picks it) and refuse a launch whose perm
// table is not that order.
int zfp_encode_f64(const void* x, void* payload, void* emax, long long batch,
                   int d0, int d1, int d2, int ndim, const void* masks,
                   const void* perm, const void* counts, int nplanes,
                   int nwords, int order, void* stream) {
  Tables64 t;
  if (!make_tables(ndim, masks, perm, counts, nplanes, nwords, order, &t))
    return (int)cudaErrorInvalidValue;
  const Geometry g = make_geometry(batch, d0, d1, d2, ndim);
  if (g.nb == 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)((g.nb + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  const double* xd = (const double*)x;
  uint32_t* p = (uint32_t*)payload;
  int* e = (int*)emax;
  if (ndim == 3 && order)
    encode64_kernel<3, true><<<grid, kThreads, 0, s>>>(xd, p, e, g, t);
  else if (ndim == 3)
    encode64_kernel<3, false><<<grid, kThreads, 0, s>>>(xd, p, e, g, t);
  else if (ndim == 2 && order)
    encode64_kernel<2, true><<<grid, kThreads, 0, s>>>(xd, p, e, g, t);
  else if (ndim == 2)
    encode64_kernel<2, false><<<grid, kThreads, 0, s>>>(xd, p, e, g, t);
  else
    encode64_kernel<1, false><<<grid, kThreads, 0, s>>>(xd, p, e, g, t);
  return (int)cudaGetLastError();
}

int zfp_decode_f64(const void* payload, const void* emax, void* x,
                   long long batch, int d0, int d1, int d2, int ndim,
                   const void* masks, const void* perm, const void* counts,
                   int nplanes, int nwords, int order, void* stream) {
  Tables64 t;
  if (!make_tables(ndim, masks, perm, counts, nplanes, nwords, order, &t))
    return (int)cudaErrorInvalidValue;
  const Geometry g = make_geometry(batch, d0, d1, d2, ndim);
  if (g.nb == 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)((g.nb + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* p = (const uint32_t*)payload;
  const int* e = (const int*)emax;
  double* xd = (double*)x;
  if (ndim == 3 && order)
    decode64_kernel<3, true><<<grid, kThreads, 0, s>>>(p, e, xd, g, t);
  else if (ndim == 3)
    decode64_kernel<3, false><<<grid, kThreads, 0, s>>>(p, e, xd, g, t);
  else if (ndim == 2 && order)
    decode64_kernel<2, true><<<grid, kThreads, 0, s>>>(p, e, xd, g, t);
  else if (ndim == 2)
    decode64_kernel<2, false><<<grid, kThreads, 0, s>>>(p, e, xd, g, t);
  else
    decode64_kernel<1, false><<<grid, kThreads, 0, s>>>(p, e, xd, g, t);
  return (int)cudaGetLastError();
}

const char* zfp64_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
