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
// Design: one thread per 4^d block with its 4^d values in registers, and
// each warp's 32 payload rows staged in shared memory at an odd row stride
// (conflict-free when each lane touches word i of its own row), so that
// device memory sees one contiguous run of 32 W words a warp, moved with
// coalesced accesses.
//  * blockify, its edge padding and unblockify's crop are folded into the
//    indexing: the encoder reads the (batch, Z, Y, X) unit directly, clamping
//    each coordinate to the edge, and the decoder writes straight back to it,
//    dropping the padded coordinates. No (nb, 64) copy is made. When the
//    unit's rows are 16-byte aligned (d2 % 4 == 0), each row of 4 values of a
//    block is one float4: lane l of a warp takes x0 = 4 l, 512 contiguous
//    bytes a row for the warp.
//  * emax comes from the IEEE exponent bits (as _emax_tile does): zeros and
//    denormals map to -126, below the -90 floor, so the floor makes this equal
//    to the frexp exponent of the plain version for every finite value.
//  * The lift, negabinary and truncation are unrolled over compile-time
//    indices, so the block stays in registers. Integer adds wrap explicitly
//    (through unsigned), matching the 32-bit wrap of the plain version.
//  * The stream is packed and unpacked in registers (zfp_common.cuh's
//    pack_regs / unpack_regs): one <= 64-bit field a plane, a 32 x 32 bit
//    transpose per 32 stream positions, the stream order a compile-time
//    permutation, one of the two that ref.level_order yields, chosen per
//    launch. No index into the block is known only at run time.
//  * Encode: each thread appends its planes' fields to its own row in shared
//    memory (the word offsets, sums of the run-time plane counts, are fine
//    there), then the warp stores its rows with coalesced writes; emax is
//    one coalesced int32 store a lane. Decode: the warp copies its rows in
//    with coalesced cp.async first, and each thread stores each row of 4
//    values as one float4 when the rows are aligned and the block whole;
//    the cropped edge goes out value by value.
// What held the first encoder back: its stream loop read the
// masked coefficient at a run-time index, u[perm[p]], which put the block in
// local memory (a 256-byte stack frame at ndim 3), and each thread stored
// its W words alone, W words apart from its neighbours: 1.53 ms a launch at
// (96, 1152, 1152) and 12 planes against a 0.2115 ms byte bound. Packed in
// registers and stored through shared memory it takes 0.295-0.316 ms there
// (device time a launch; tools/kernel_shapes.py; H100 80GB HBM3, 700 W).
// At ndim <= 2 the transposes beat a direct compile-time gather of each
// plane's bits at the Qwen flush shape (0.0037 against 0.0048 ms).
// The build uses -fmad=false; no floating-point expression here could contract.
// The tables, the lift, the stream packing and unpacking and the staging of
// the payload rows live in zfp_common.cuh, which the fused attention kernel
// (cdecode.cu) and the float64 codec (zfp64.cu) share.

#include "cp_async.cuh"
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

// Block b's 4^ND values, x fastest (the (nb, 4^ND) layout of ref.blockify):
// each coordinate clamped to the edge (edge replication is part of the
// format). vec: rows of x are 16-byte aligned (d2 % 4 == 0, so x0 + 4 <= d2),
// and each of the block's rows is one float4 load.
template <int ND>
__device__ __forceinline__ void load_block(const float* __restrict__ x,
                                           const Geometry& g, long long bb,
                                           int z0, int y0, int x0, bool vec,
                                           float* v) {
  constexpr int E0 = ND >= 3 ? 4 : 1, E1 = ND >= 2 ? 4 : 1;
#pragma unroll
  for (int rw = 0; rw < E0 * E1; ++rw) {
    const int zi = min(z0 + rw / E1, g.d0 - 1);
    const int yi = min(y0 + rw % E1, g.d1 - 1);
    const float* row = x + ((bb * g.d0 + zi) * g.d1 + yi) * (long long)g.d2;
    if (vec) {
      const float4 f = __ldg((const float4*)(row + x0));
      v[4 * rw] = f.x;
      v[4 * rw + 1] = f.y;
      v[4 * rw + 2] = f.z;
      v[4 * rw + 3] = f.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[4 * rw + k] = __ldg(row + min(x0 + k, g.d2 - 1));
    }
  }
}

// 64 threads a CTA: the Qwen chunk flush (8192 blocks) fills 128 CTAs, one
// an SM, where 128 threads would leave half the card idle.
constexpr int kEncodeThreads = 64;

// One thread per 4^ND block, kSub: the stream order (stream_pos). The block
// is packed in registers (pack_regs) into its own row in shared memory; the
// warp's 32 rows, one contiguous run of 32 W words in the payload, then go
// out with coalesced stores.
template <int ND, bool kSub>
__global__ void __launch_bounds__(kEncodeThreads)
    encode_kernel(const float* __restrict__ x, uint32_t* __restrict__ payload,
                  int* __restrict__ emax_out, Geometry g, Tables t, Staging st,
                  bool vec) {
  constexpr int N = 1 << (2 * ND);
  extern __shared__ uint32_t rows[];
  const int lane = threadIdx.x & 31;
  const int w = t.nwords;
  uint32_t* wrows = rows + (threadIdx.x - lane) * st.stride;
  const long long b0 = (long long)blockIdx.x * kEncodeThreads +
                       (threadIdx.x - lane);
  if (b0 >= g.nb) return;  // the whole warp
  const long long b = b0 + lane;
  if (b < g.nb) {
    long long bb;
    int z0, y0, x0;
    block_origin<ND>(g, b, &bb, &z0, &y0, &x0);
    float v[N];
    load_block<ND>(x, g, bb, z0, y0, x0, vec, v);

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
    pack_regs<ND, kSub>(u, t, wrows + lane * st.stride);
    emax_out[b] = emax;
  }
  __syncwarp();
  uint32_t* dst = payload + b0 * w;
  walk_rows(lane, (int)min(32LL, g.nb - b0) * w, w, st,
            [&](int i, int r, int c) { dst[i] = wrows[r * st.stride + c]; });
}

constexpr int kDecodeThreads = 128;

// One thread per 4^ND block, kSub: the stream order (stream_pos). vec: the
// rows of the output are 16-byte aligned (d2 % 4 == 0), so a whole row of a
// block goes out as one float4.
template <int ND, bool kSub>
__global__ void __launch_bounds__(kDecodeThreads)
    decode_kernel(const uint32_t* __restrict__ payload,
                  const int* __restrict__ emax_in, float* __restrict__ x,
                  Geometry g, Tables t, Staging st, bool vec) {
  constexpr int E0 = ND >= 3 ? 4 : 1, E1 = ND >= 2 ? 4 : 1, N = E0 * E1 * 4;
  extern __shared__ uint32_t rows[];
  const int lane = threadIdx.x & 31;
  const int w = t.nwords;
  // the warp's 32 blocks: their payload rows are one contiguous run of
  // words, copied with coalesced loads into rows at an odd stride, so that
  // the 32 lanes reading word i of their own rows hit 32 banks
  uint32_t* wrows = rows + (threadIdx.x - lane) * st.stride;
  const long long b0 = (long long)blockIdx.x * kDecodeThreads +
                       (threadIdx.x - lane);
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

  int v[N];
  unpack_regs<ND, kSub>(wrows + lane * st.stride, t, v);
  lift_inv<ND>(v);

  const float scale = decode_scale(emax_in[b]);
  long long bb;
  int z0, y0, x0;
  block_origin<ND>(g, b, &bb, &z0, &y0, &x0);
  const bool whole = z0 + E0 <= g.d0 && y0 + E1 <= g.d1 && x0 + 4 <= g.d2;
#pragma unroll
  for (int rw = 0; rw < E0 * E1; ++rw) {
    const int zi = z0 + rw / E1, yi = y0 + rw % E1;
    float* out = x + ((bb * g.d0 + zi) * g.d1 + yi) * (long long)g.d2 + x0;
    float f[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      f[k] = __fmul_rn(__int2float_rn(v[4 * rw + k]), scale);
    if (vec && whole) {
      *(float4*)out = make_float4(f[0], f[1], f[2], f[3]);
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

// The order ref.level_order gives `perm` (stream_order_of), or -1.
int order_of(int ndim, const void* perm) {
  const int* pm = (const int*)perm;
  return ndim == 3   ? stream_order_of<3>(pm)
         : ndim == 2 ? stream_order_of<2>(pm)
                     : stream_order_of<1>(pm);
}

}  // namespace

extern "C" {

// x: (batch, d0, d1, d2) float32, contiguous, on the device. For ndim 2
// pass d0 = 1, for ndim 1 d0 = d1 = 1. Table pointers are host memory.
// Both entries take the stream order of their tables (1: the subband
// order, 0: the identity; kernel.stream_order picks it) and refuse a
// launch whose perm table is not that order.
int zfp_encode(const void* x, void* payload, void* emax, long long batch,
               int d0, int d1, int d2, int ndim, const void* masks,
               const void* perm, const void* counts, int nplanes, int nwords,
               int order, void* stream) {
  if (order < 0 || order_of(ndim, perm) != order)
    return (int)cudaErrorInvalidValue;
  const Geometry g = make_geometry(batch, d0, d1, d2, ndim);
  if (g.nb == 0) return (int)cudaSuccess;
  const Tables t = make_tables(ndim, (const uint32_t*)masks, (const int*)perm,
                               (const int*)counts, nplanes, nwords);
  const Staging st = make_staging(nwords);
  const size_t smem = staging_bytes(kEncodeThreads, nwords);
  const unsigned grid =
      (unsigned)((g.nb + kEncodeThreads - 1) / kEncodeThreads);
  const bool vec = d2 % 4 == 0 && ((size_t)x & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  uint32_t* p = (uint32_t*)payload;
  int* e = (int*)emax;
  if (ndim == 3 && order)
    encode_kernel<3, true><<<grid, kEncodeThreads, smem, s>>>(xf, p, e, g, t,
                                                              st, vec);
  else if (ndim == 3)
    encode_kernel<3, false><<<grid, kEncodeThreads, smem, s>>>(xf, p, e, g, t,
                                                               st, vec);
  else if (ndim == 2 && order)
    encode_kernel<2, true><<<grid, kEncodeThreads, smem, s>>>(xf, p, e, g, t,
                                                              st, vec);
  else if (ndim == 2)
    encode_kernel<2, false><<<grid, kEncodeThreads, smem, s>>>(xf, p, e, g, t,
                                                               st, vec);
  else
    encode_kernel<1, false><<<grid, kEncodeThreads, smem, s>>>(xf, p, e, g, t,
                                                               st, vec);
  return (int)cudaGetLastError();
}

int zfp_decode(const void* payload, const void* emax, void* x, long long batch,
               int d0, int d1, int d2, int ndim, const void* masks,
               const void* perm, const void* counts, int nplanes, int nwords,
               int order, void* stream) {
  if (order < 0 || order_of(ndim, perm) != order)
    return (int)cudaErrorInvalidValue;
  const Geometry g = make_geometry(batch, d0, d1, d2, ndim);
  if (g.nb == 0) return (int)cudaSuccess;
  const Tables t = make_tables(ndim, (const uint32_t*)masks, (const int*)perm,
                               (const int*)counts, nplanes, nwords);
  const Staging st = make_staging(nwords);
  const size_t smem = staging_bytes(kDecodeThreads, nwords);
  const unsigned grid =
      (unsigned)((g.nb + kDecodeThreads - 1) / kDecodeThreads);
  const bool vec = d2 % 4 == 0 && ((size_t)x & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* p = (const uint32_t*)payload;
  const int* e = (const int*)emax;
  float* xf = (float*)x;
  if (ndim == 3 && order)
    decode_kernel<3, true><<<grid, kDecodeThreads, smem, s>>>(p, e, xf, g, t,
                                                              st, vec);
  else if (ndim == 3)
    decode_kernel<3, false><<<grid, kDecodeThreads, smem, s>>>(p, e, xf, g, t,
                                                               st, vec);
  else if (ndim == 2 && order)
    decode_kernel<2, true><<<grid, kDecodeThreads, smem, s>>>(p, e, xf, g, t,
                                                              st, vec);
  else if (ndim == 2)
    decode_kernel<2, false><<<grid, kDecodeThreads, smem, s>>>(p, e, xf, g, t,
                                                               st, vec);
  else
    decode_kernel<1, false><<<grid, kDecodeThreads, smem, s>>>(p, e, xf, g, t,
                                                               st, vec);
  return (int)cudaGetLastError();
}

const char* zfp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
