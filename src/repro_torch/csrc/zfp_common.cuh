// Device code shared by the codec kernels (zfp.cu) and the fused
// ZFP-decode attention kernel (cdecode.cu): the static stream tables, the
// wrapping integer adds, the two-level Haar lift and its inverse, and the
// unpacking of one block's plane-major stream (a general loop, and a 2-D
// one that keeps the block in registers; both give the same bits). A value
// decoded inside the attention kernel is bit for bit the codec's decode.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace zfpc {

constexpr uint32_t kNbMask = 0xAAAAAAAAu;
constexpr int kFrac = 26;
constexpr int kEmaxFloor = -90;

struct Tables {
  uint32_t mask[64];   // keep-mask of each coefficient (natural order)
  uint8_t perm[64];    // coefficient at sorted stream position p
  uint8_t inv[64];     // stream position of coefficient i (perm's inverse)
  uint8_t counts[32];  // contributors to plane j: a prefix of perm
  int nplanes;         // planes that have contributors
  int nwords;          // payload words per block
};

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

template <int ND>
__device__ __forceinline__ constexpr int axis_stride(int a) {
  // axis a of the (4,)*ND coefficient block, slowest first
  return a == 0 ? (ND == 3 ? 16 : ND == 2 ? 4 : 1) : a == 1 ? (ND == 3 ? 4 : 1) : 1;
}

template <int ND>
__device__ __forceinline__ void lift_fwd(int* q) {
  constexpr int N = 1 << (2 * ND);
#pragma unroll
  for (int a = 0; a < ND; ++a) {
    const int s = axis_stride<ND>(a);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (((i / s) & 3) == 0) {
        int q0 = q[i], q1 = q[i + s], q2 = q[i + 2 * s], q3 = q[i + 3 * s];
        int s0 = wadd(q0, q1) >> 1, d0 = wsub(q0, q1);
        int s1 = wadd(q2, q3) >> 1, d1 = wsub(q2, q3);
        q[i] = wadd(s0, s1) >> 1;
        q[i + s] = wsub(s0, s1);
        q[i + 2 * s] = d0;
        q[i + 3 * s] = d1;
      }
    }
  }
}

template <int ND>
__device__ __forceinline__ void lift_inv(int* c) {
  constexpr int N = 1 << (2 * ND);
#pragma unroll
  for (int a = ND - 1; a >= 0; --a) {
    const int s = axis_stride<ND>(a);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (((i / s) & 3) == 0) {
        int ss = c[i], ds = c[i + s], d0 = c[i + 2 * s], d1 = c[i + 3 * s];
        int s0 = wadd(ss, wadd(ds, 1) >> 1), s1 = wsub(s0, ds);
        int q0 = wadd(s0, wadd(d0, 1) >> 1), q1 = wsub(q0, d0);
        int q2 = wadd(s1, wadd(d1, 1) >> 1), q3 = wsub(q2, d1);
        c[i] = q0;
        c[i + s] = q1;
        c[i + 2 * s] = q2;
        c[i + 3 * s] = q3;
      }
    }
  }
}

// One block's plane-major stream `in` -> its 4^ND transform coefficients
// (negabinary undone, two's complement, natural order). The stream walks the
// static level order; the coefficient it writes is a run-time index, so the
// word array lives in local memory.
template <int ND>
__device__ __forceinline__ void unpack_block(const uint32_t* __restrict__ in,
                                             const Tables& t, int* c) {
  constexpr int N = 1 << (2 * ND);
  uint32_t u[N];
#pragma unroll
  for (int i = 0; i < N; ++i) u[i] = 0u;
  uint32_t word = 0;
  int bit = 32, w = 0;
  for (int j = 0; j < t.nplanes; ++j) {
    const int k = t.counts[j];
    for (int p = 0; p < k; ++p) {
      if (bit == 32) {
        word = in[w++];
        bit = 0;
      }
      u[t.perm[p]] |= ((word >> bit) & 1u) << (31 - j);
      ++bit;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) c[i] = (int)((u[i] ^ kNbMask) - kNbMask);
}

// The same for a 2-D block, with the block in registers: plane j's
// contributors are the first counts[j] stream positions, so their bits are
// one field of the stream, and coefficient i takes bit inv[i] of it. No
// run-time index into the block, so no local memory and no per-bit loop.
__device__ __forceinline__ void unpack_block2(const uint32_t* __restrict__ in,
                                              const Tables& t, int* c) {
  int inv[16];
  uint32_t u[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    inv[i] = t.inv[i];
    u[i] = 0u;
  }
  int off = 0;
  for (int j = 0; j < t.nplanes; ++j) {
    const int k = t.counts[j];  // 1..16
    const int wi = off >> 5, sh = off & 31;
    uint32_t field = in[wi] >> sh;
    if (sh + k > 32) field |= in[wi + 1] << (32 - sh);
    field &= (1u << k) - 1u;  // the bits past k belong to the next plane
#pragma unroll
    for (int i = 0; i < 16; ++i) u[i] |= ((field >> inv[i]) & 1u) << (31 - j);
    off += k;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) c[i] = (int)((u[i] ^ kNbMask) - kNbMask);
}

// 2^(emax - kFrac), exact, from IEEE bits: the fixed-point -> float scale.
__device__ __forceinline__ float decode_scale(int emax) {
  return __int_as_float((emax - kFrac + 127) << 23);
}

inline Tables make_tables(int ndim, const uint32_t* masks, const int* perm,
                          const int* counts, int nplanes, int nwords) {
  Tables t = {};
  const int n = 1 << (2 * ndim);
  for (int i = 0; i < n; ++i) {
    t.mask[i] = masks[i];
    t.perm[i] = (uint8_t)perm[i];
    t.inv[perm[i]] = (uint8_t)i;
  }
  for (int j = 0; j < nplanes; ++j) t.counts[j] = (uint8_t)counts[j];
  t.nplanes = nplanes;
  t.nwords = nwords;
  return t;
}

}  // namespace zfpc
