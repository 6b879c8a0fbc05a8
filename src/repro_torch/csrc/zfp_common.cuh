// Device code shared by the codec kernels (zfp.cu, zfp64.cu) and the fused
// ZFP-decode attention kernel (cdecode.cu): the static stream tables, the
// wrapping integer adds, the two-level Haar lift and its inverse, the
// compile-time stream orders, the packing and unpacking of one block's
// plane-major stream in registers, and the staging of a warp's payload rows
// in shared memory (the float32 and float64 codecs). A value decoded inside
// the attention kernel is bit for bit the codec's decode.

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

// Subband level of coefficient i of a 4^ND block: the per-axis Haar levels
// [ss, ds, d0, d1] = [0, 1, 2, 2], summed over the axes (ref.coeff_levels).
__host__ __device__ constexpr int coeff_level(int nd, int i) {
  int lv = 0;
  for (int a = 0; a < nd; ++a) {
    const int r = (i >> (2 * a)) & 3;
    lv += r == 0 ? 0 : r == 1 ? 1 : 2;
  }
  return lv;
}

// Stream position of coefficient i (ref.level_order's inverse permutation).
// Two orders exist: the identity, and for kSub the subband order, sorted by
// level and then by index (the coefficients with more planes first), which
// ref.level_order yields for 4 <= planes <= 27 at ndim 2 and 3. At ndim 1
// the two are the same.
template <int ND, bool kSub>
__host__ __device__ constexpr int stream_pos(int i) {
  if (!kSub) return i;
  const int li = coeff_level(ND, i);
  int pos = 0;
  for (int k = 0; k < (1 << (2 * ND)); ++k) {
    const int lk = coeff_level(ND, k);
    pos += lk < li || (lk == li && k < i);
  }
  return pos;
}

// The order ref.level_order gives for `perm` (stream position -> coefficient):
// 0 for the identity, else 1 for the subband order, -1 for neither.
template <int ND>
int stream_order_of(const int* perm) {
  bool sub = true, ident = true;
  for (int i = 0; i < (1 << (2 * ND)); ++i) {
    sub &= perm[stream_pos<ND, true>(i)] == i;
    ident &= perm[i] == i;
  }
  return ident ? 0 : sub ? 1 : -1;
}

// One step of a 32 x 32 bit transpose (Hacker's Delight's transpose32):
// word k + S takes the bits of columns c + S of word k at columns c, word k
// takes those of word k + S the other way, for the k and c with bit S clear.
// After the steps S = 16, 8, 4, 2, 1, bit r of word c is bit c of the
// original word r. The 16- and 8-bit steps are byte permutes.
template <int S>
__device__ __forceinline__ void transpose32_step(uint32_t* a) {
  constexpr uint32_t M = S == 4 ? 0x0F0F0F0Fu
                         : S == 2 ? 0x33333333u
                                  : 0x55555555u;  // S == 1
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int k = (i / S) * 2 * S + i % S;
    const uint32_t x = a[k], y = a[k + S];
    if constexpr (S == 16) {
      a[k] = __byte_perm(x, y, 0x5410);
      a[k + S] = __byte_perm(x, y, 0x7632);
    } else if constexpr (S == 8) {
      a[k] = __byte_perm(x, y, 0x6240);
      a[k + S] = __byte_perm(x, y, 0x7351);
    } else {
      const uint32_t t = ((x >> S) ^ y) & M;
      a[k + S] = y ^ t;
      a[k] = x ^ (t << S);
    }
  }
}

__device__ __forceinline__ void transpose32(uint32_t* a) {
  transpose32_step<16>(a);
  transpose32_step<8>(a);
  transpose32_step<4>(a);
  transpose32_step<2>(a);
  transpose32_step<1>(a);
}

// c[I..] from the transposed planes: coefficient i is at stream position
// stream_pos(i), a compile-time index into lo (positions 0-31) or hi (32-63);
// negabinary undone.
template <int ND, bool kSub, int I = 0>
__device__ __forceinline__ void gather_coeffs(const uint32_t* lo,
                                              const uint32_t* hi, int* c) {
  if constexpr (I < (1 << (2 * ND))) {
    constexpr int p = stream_pos<ND, kSub>(I);
    uint32_t u;
    if constexpr (p < 32) {
      u = lo[p];
    } else {
      u = hi[p - 32];
    }
    c[I] = (int)((u ^ kNbMask) - kNbMask);
    gather_coeffs<ND, kSub, I + 1>(lo, hi, c);
  }
}

// One block's plane-major stream `in` -> its 4^ND transform coefficients
// (negabinary undone, two's complement, natural order), with the block in
// registers. Plane j's contributors are the first counts[j] stream
// positions, so their bits are one field of the stream (at most 64 bits,
// taken with funnel shifts), and position p takes bit p of it. Field j
// becomes row 31 - j of a planes x positions bit matrix (low and high 32
// positions apart); transposed, word p holds position p's bit of plane j at
// bit 31 - j, as the codec packs it. The stream order is a compile-time
// permutation, so no index into the block is known only at run time and
// nothing goes to local memory. `in` may be read up to two words past the
// block's last word (those bits are masked off).
template <int ND, bool kSub>
__device__ __forceinline__ void unpack_regs(const uint32_t* in,
                                            const Tables& t, int* c) {
  constexpr bool kHi = ND == 3;  // 64 positions: two 32-bit halves
  uint32_t lo[32], hi[32];
  int off = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    uint32_t flo = 0u, fhi = 0u;
    if (j < t.nplanes) {
      const int k = t.counts[j];
      const int wi = off >> 5, sh = off & 31;
      const uint32_t w1 = in[wi + 1];
      flo = __funnelshift_r(in[wi], w1, sh);
      if constexpr (kHi) fhi = __funnelshift_r(w1, in[wi + 2], sh);
      // the bits past k belong to the next plane
      if (k < 32) {
        flo &= (1u << k) - 1u;
        fhi = 0u;
      } else if (kHi && k < 64) {
        fhi &= (1u << (k - 32)) - 1u;
      }
      off += k;
    }
    lo[31 - j] = flo;
    if constexpr (kHi) hi[31 - j] = fhi;
  }
  transpose32(lo);
  if constexpr (kHi) transpose32(hi);
  gather_coeffs<ND, kSub>(lo, hi, c);
}

// lo/hi from the block's masked negabinary words u (natural order): word p
// (of lo for p < 32, of hi for p >= 32) is the coefficient at stream position
// p = stream_pos(i), a compile-time index; positions past the block are 0.
template <int ND, bool kSub, int I = 0>
__device__ __forceinline__ void scatter_coeffs(const uint32_t* u,
                                               uint32_t* lo, uint32_t* hi) {
  if constexpr (I == 0) {
#pragma unroll
    for (int p = 1 << (2 * ND); p < 32; ++p) lo[p] = 0u;
  }
  if constexpr (I < (1 << (2 * ND))) {
    constexpr int p = stream_pos<ND, kSub>(I);
    if constexpr (p < 32) {
      lo[p] = u[I];
    } else {
      hi[p - 32] = u[I];
    }
    scatter_coeffs<ND, kSub, I + 1>(u, lo, hi);
  }
}

// The inverse of unpack_regs: one block's masked negabinary words u (natural
// order) -> its plane-major stream, written word by word to out (payload
// words, the tail bits of the last one 0). u is put in stream order by the
// compile-time permutation and transposed, so word 31 - j holds plane j's
// bit of every position (low and high 32 positions apart). The keep-masks
// clear every position at or past counts[j] in plane j (the contributors of
// a plane are a prefix of the stream order), so that word, with its high
// half, is plane j's field already cut to counts[j] bits; the fields are
// appended in plane order. out's word offsets are known only at run time:
// it is meant to be shared memory.
template <int ND, bool kSub>
__device__ __forceinline__ void pack_regs(const uint32_t* u, const Tables& t,
                                          uint32_t* out) {
  constexpr bool kHi = ND == 3;  // 64 positions: two 32-bit halves
  uint32_t lo[32], hi[32];
  scatter_coeffs<ND, kSub>(u, lo, hi);
  transpose32(lo);
  if constexpr (kHi) transpose32(hi);
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
      append(lo[31 - j], min(k, 32));
      if constexpr (kHi) {
        if (k > 32) append(hi[31 - j], k - 32);
      }
    }
  }
  if (nacc) out[w] = (uint32_t)acc;
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
  }
  for (int j = 0; j < nplanes; ++j) t.counts[j] = (uint8_t)counts[j];
  t.nplanes = nplanes;
  t.nwords = nwords;
  return t;
}

// The staging geometry of a warp's payload rows in shared memory, shared by
// the float32 and float64 codecs: a block's row sits at `stride` words
// (nwords, made odd, so the 32 lanes touching word i of their own rows hit
// 32 banks), and lane l of a warp walks the warp's rows word by word,
// l + 32 m for m = 0, 1, ...: `dq` rows and `dr` words further each time
// (32 = dq * nwords + dr; for nwords > 32, dq = 0 and one wrap a step at
// most).
struct Staging {
  int stride, dq, dr;
};

__host__ __device__ inline Staging make_staging(int nwords) {
  Staging s;
  s.stride = nwords | 1;
  s.dq = 32 / nwords;
  s.dr = 32 - s.dq * nwords;
  return s;
}

// Word i of the warp's contiguous run of `total` payload words, for
// i = lane, lane + 32, ...: fn(global word i, its row, its word in the row).
template <typename Fn>
__device__ __forceinline__ void walk_rows(int lane, int total, int w,
                                          const Staging& st, Fn fn) {
  int r = lane / w, c = lane - (lane / w) * w;
  for (int i = lane; i < total; i += 32) {
    fn(i, r, c);
    r += st.dq;
    c += st.dr;
    if (c >= w) {
      c -= w;
      ++r;
    }
  }
}

// Dynamic shared memory of one codec CTA: its blocks' payload rows, and two
// words that unpack_regs may read past the last row.
inline size_t staging_bytes(int threads, int nwords) {
  return ((size_t)threads * make_staging(nwords).stride + 2) *
         sizeof(uint32_t);
}

}  // namespace zfpc
