// Fixed-rate ZFP-style codec: encode and decode kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels encode_pallas (_encode_kernel, _emax_tile) and
// decode_pallas (_decode_kernel) of src/repro/kernels/zfp/kernel.py. Bit
// for bit equal to the plain PyTorch version, src/repro_torch/kernels/zfp/ref.py.
//
// Bound on the H100: bytes. A 4^3 block is 256 bytes of float32 in and
// 4*W + 4 bytes out (W = 24 words at 12 planes, 32 at 16), and the integer
// work per value (a shift-add lift, a negabinary add, a mask, one bit of
// packing per kept plane) is far below the card's integer rate at 3.35 TB/s.
//
// Design: one thread per 4^d block with its 4^d values in registers.
//  * blockify, its edge padding and unblockify's crop are folded into the
//    indexing: the encoder reads the (batch, Z, Y, X) unit directly, clamping
//    each coordinate to the edge, and the decoder writes straight back to it,
//    dropping the padded coordinates. No (nb, 64) copy is made.
//  * emax comes from the IEEE exponent bits (as _emax_tile does): zeros and
//    denormals map to -126, below the -90 floor, so the floor makes this equal
//    to the frexp exponent of the plain version for every finite value.
//  * The lift, negabinary and truncation are unrolled over compile-time
//    indices, so the block stays in registers. Integer adds wrap explicitly
//    (through unsigned), matching the 32-bit wrap of the plain version.
//  * The plane-major stream walks the static level order, passed by value as
//    a small table; the coefficient it reads is a run-time index, so that one
//    array lives in local memory (per-thread interleaved, L1-cached).
// Known costs left for a later change: each thread writes W consecutive words
// (uncoalesced across the warp) and the stream loop is sequential per block.
// The build uses -fmad=false; no floating-point expression here could contract.
// The tables, the lift and the stream unpacking live in zfp_common.cuh, which
// the fused attention kernel (cdecode.cu) decodes through as well.

#include "zfp_common.cuh"

namespace {

using namespace zfpc;

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

template <int ND>
__global__ void encode_kernel(const float* __restrict__ x,
                              uint32_t* __restrict__ payload,
                              int* __restrict__ emax_out, Geometry g, Tables t) {
  constexpr int E0 = ND >= 3 ? 4 : 1, E1 = ND >= 2 ? 4 : 1, N = E0 * E1 * 4;
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= g.nb) return;
  long long bb;
  int z0, y0, x0;
  block_origin<ND>(g, b, &bb, &z0, &y0, &x0);

  float v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int zi = min(z0 + i / (E1 * 4), g.d0 - 1);
    const int yi = min(y0 + (i / 4) % E1, g.d1 - 1);
    const int xi = min(x0 + i % 4, g.d2 - 1);
    v[i] = x[((bb * g.d0 + zi) * g.d1 + yi) * (long long)g.d2 + xi];
  }

  int emax = -126;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int raw = (__float_as_int(v[i]) >> 23) & 0xFF;
    emax = max(emax, raw == 0 ? -126 : raw - 126);
  }
  emax = max(emax, kEmaxFloor);
  const float scale = __int_as_float((kFrac - emax + 127) << 23);

  int q[N];
#pragma unroll
  for (int i = 0; i < N; ++i) q[i] = __float2int_rn(__fmul_rn(v[i], scale));
  lift_fwd<ND>(q);

  uint32_t u[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
    u[i] = (((uint32_t)q[i] + kNbMask) ^ kNbMask) & t.mask[i];

  uint32_t* out = payload + b * t.nwords;
  uint32_t word = 0;
  int bit = 0, w = 0;
  for (int j = 0; j < t.nplanes; ++j) {
    const int k = t.counts[j];
    for (int p = 0; p < k; ++p) {
      word |= ((u[t.perm[p]] >> (31 - j)) & 1u) << bit;
      if (++bit == 32) {
        out[w++] = word;
        word = 0;
        bit = 0;
      }
    }
  }
  if (bit) out[w++] = word;
  emax_out[b] = emax;
}

template <int ND>
__global__ void decode_kernel(const uint32_t* __restrict__ payload,
                              const int* __restrict__ emax_in,
                              float* __restrict__ x, Geometry g, Tables t) {
  constexpr int E0 = ND >= 3 ? 4 : 1, E1 = ND >= 2 ? 4 : 1, N = E0 * E1 * 4;
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= g.nb) return;

  int c[N];
  unpack_block<ND>(payload + b * t.nwords, t, c);
  lift_inv<ND>(c);

  const int emax = emax_in[b];
  const float scale = decode_scale(emax);
  long long bb;
  int z0, y0, x0;
  block_origin<ND>(g, b, &bb, &z0, &y0, &x0);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int zi = z0 + i / (E1 * 4), yi = y0 + (i / 4) % E1, xi = x0 + i % 4;
    if (zi < g.d0 && yi < g.d1 && xi < g.d2)
      x[((bb * g.d0 + zi) * g.d1 + yi) * (long long)g.d2 + xi] =
          __fmul_rn(__int2float_rn(c[i]), scale);
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

constexpr int kThreads = 128;

}  // namespace

extern "C" {

// x: (batch, d0, d1, d2) float32, contiguous, on the device. For ndim 2
// pass d0 = 1, for ndim 1 d0 = d1 = 1. Table pointers are host memory.
int zfp_encode(const void* x, void* payload, void* emax, long long batch,
               int d0, int d1, int d2, int ndim, const void* masks,
               const void* perm, const void* counts, int nplanes, int nwords,
               void* stream) {
  const Geometry g = make_geometry(batch, d0, d1, d2, ndim);
  const Tables t = make_tables(ndim, (const uint32_t*)masks, (const int*)perm,
                               (const int*)counts, nplanes, nwords);
  const unsigned grid = (unsigned)((g.nb + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  uint32_t* p = (uint32_t*)payload;
  int* e = (int*)emax;
  if (ndim == 3)
    encode_kernel<3><<<grid, kThreads, 0, s>>>(xf, p, e, g, t);
  else if (ndim == 2)
    encode_kernel<2><<<grid, kThreads, 0, s>>>(xf, p, e, g, t);
  else
    encode_kernel<1><<<grid, kThreads, 0, s>>>(xf, p, e, g, t);
  return (int)cudaGetLastError();
}

int zfp_decode(const void* payload, const void* emax, void* x, long long batch,
               int d0, int d1, int d2, int ndim, const void* masks,
               const void* perm, const void* counts, int nplanes, int nwords,
               void* stream) {
  const Geometry g = make_geometry(batch, d0, d1, d2, ndim);
  const Tables t = make_tables(ndim, (const uint32_t*)masks, (const int*)perm,
                               (const int*)counts, nplanes, nwords);
  const unsigned grid = (unsigned)((g.nb + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* p = (const uint32_t*)payload;
  const int* e = (const int*)emax;
  float* xf = (float*)x;
  if (ndim == 3)
    decode_kernel<3><<<grid, kThreads, 0, s>>>(p, e, xf, g, t);
  else if (ndim == 2)
    decode_kernel<2><<<grid, kThreads, 0, s>>>(p, e, xf, g, t);
  else
    decode_kernel<1><<<grid, kThreads, 0, s>>>(p, e, xf, g, t);
  return (int)cudaGetLastError();
}

const char* zfp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
