// Fused ZFP-decode + flash-decode attention over a compressed KV cache, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel fused_cdecode_attention (_kernel, _decode_tile) of
// src/repro/kernels/cdecode/kernel.py. Held to the plain PyTorch version,
// src/repro_torch/kernels/cdecode/ref.py, within rtol = atol = 2e-5: the
// decoded K and V values are bit for bit the codec's (zfp_common.cuh's lift
// and scale, the explicit __int2float_rn / __fmul_rn below; cdecode_tiles
// writes them out for the check), only the order of the float32 sums
// differs. Built without -fmad=false: the dot products may contract to FMA.
//
// Contract: for each (batch x kv-head) row, the flash-decoding partials
// (m, l, acc) of the QPK pre-scaled queries over the first hist_len tokens of
// the compressed history, one set per split below. The ops wrapper merges
// the splits and the raw tail window in one step with the reference's guarded
// formulas; merged alone, the splits are the reference's whole-history
// partials.
//
// Bound on the H100: bytes. The only device memory traffic of the history is
// the compressed payload and its emax headers
// (tests/test_cdecode_kernel.py::test_fused_hbm_traffic_model); the decoded K
// and V never exist in device memory. Per 16-token band and row that is
// 2 * 4 * D/4 blocks of 4*W + 4 bytes against QPK * 16 * D * 2 multiply-adds,
// far below the card's float32 rate. What limits it in practice is the
// decode's integer work, a few hundred instructions per 4x4 block.
//
// Design:
//  * The split unit is a 16-token band: 4 block rows x D/4 blocks of K and
//    the same of V (128 + 128 at D = 128, one block per thread of 256). Grid
//    (rows, nsplit); each CTA owns a run of `per` bands, so that the 16 rows
//    of a serving batch still give 256 CTAs; the wrapper sizes the runs.
//  * A band's K and V payloads, and their emax, are contiguous in device
//    memory. They are staged into shared memory with cp.async, two stages
//    deep, so that band i + 1 loads while band i decodes; a block's words sit
//    at an odd stride, so that a warp reading word j of 32 blocks hits 32
//    banks.
//  * Each thread decodes one block from shared memory: per bit plane one
//    field of the stream, the planes x positions bit matrix transposed in
//    registers (16 x 16 in each half of a word); the stream order is a
//    compile-time permutation (two exist for 2-D blocks, chosen per launch),
//    so the block stays in registers. Then the codec's inverse lift, and
//    float4 stores into the K and V tiles.
//  * Logits: 8 lanes per (query, token) dot product with float4 reads and a
//    shuffle reduction; online softmax with one warp per query row (expf,
//    guarded as the reference: a row whose max is still -inf gets corr = 0);
//    acc = acc * corr + p V with one float4 of outputs per thread.
//  * Bands at or past hist_len / 16 contribute exactly nothing, so no CTA
//    visits them.
// Left: float32 dot products on the CUDA cores (tensor cores in TF32 or bf16
// would cost the 2e-5 bound); the decode's integer work.

#include <math.h>

#include "cp_async.cuh"
#include "zfp_common.cuh"

namespace {

using namespace zfpc;

constexpr int kBand = 16;  // tokens a split unit
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// CTAs an SM must hold: caps registers at 64 a thread, so that the 4 CTAs
// an SM that split_plan aims at all fit
constexpr int kMinBlocks = 4;

// jnp.isfinite: false for +-inf and NaN
__device__ __forceinline__ bool finite(float x) { return fabsf(x) < INFINITY; }

struct Shape {
  int nb;        // payload blocks per row (every band of max_len)
  int w;         // payload words per block
  int d;         // head_dim
  int qpk;       // queries per kv head
  int hist_len;  // compressed tokens valid
  int nsplit;    // CTAs per row
  int per;       // bands per CTA
};

// Shared memory of one CTA, in 4-byte words; every part 16-byte aligned.
struct Layout {
  int d, qpk;
  int nbb;    // blocks of K (and of V) in a band: 4 rows x D/4
  int ws;     // staged words per block (odd)
  int stage;  // words of one stage: K, V payload then K, V emax
  int ks;     // K tile row stride
  __host__ __device__ Layout(int d_, int w, int qpk_)
      : d(d_), qpk(qpk_), nbb(d_), ws(w | 1), stage(2 * d_ * ((w | 1) + 1)),
        ks(d_ + 4) {}
  // offsets: 2 stages, K tile, V tile, q, acc and its compensation, p,
  // then m, l, corr and l's compensation
  __host__ __device__ int k_tile() const { return 2 * stage; }
  __host__ __device__ int v_tile() const { return k_tile() + kBand * ks; }
  __host__ __device__ int q() const { return v_tile() + kBand * d; }
  __host__ __device__ int acc() const { return q() + qpk * d; }
  __host__ __device__ int err() const { return acc() + qpk * d; }
  __host__ __device__ int p() const { return err() + qpk * d; }
  __host__ __device__ int mlc() const { return p() + qpk * kBand; }
  __host__ __device__ int words() const { return mlc() + 4 * qpk; }
};

// x = x * c + y, compensated (Kahan): e carries what x's rounding lost,
// so that a history of ~2000 bands sums to the accuracy of one. Explicit
// roundings: no contraction may merge these steps.
__device__ __forceinline__ void comp_add(float& x, float& e, float c,
                                         float y) {
  const float xs = __fmul_rn(x, c);
  const float ys = __fsub_rn(y, __fmul_rn(e, c));
  const float t = __fadd_rn(xs, ys);
  e = __fsub_rn(__fsub_rn(t, xs), ys);
  x = t;
}

// Issue the copies of one band (blocks blk0 .. blk0 + nbb of a row) into a
// stage and commit them as one group.
__device__ __forceinline__ void stage_band(uint32_t* st,
                                           const uint32_t* __restrict__ pk,
                                           const int* __restrict__ ek,
                                           const uint32_t* __restrict__ pv,
                                           const int* __restrict__ ev,
                                           long long blk0, int w,
                                           const Layout& L) {
  const int n = L.nbb * w;
  const uint32_t* gk = pk + blk0 * w;
  const uint32_t* gv = pv + blk0 * w;
  uint32_t* sv = st + L.nbb * L.ws;
  // word i of the band is word j of block b; i steps by kThreads
  int b = threadIdx.x / w, j = threadIdx.x - b * w;
  const int db = kThreads / w, dj = kThreads - db * w;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    cp_async<4>(st + b * L.ws + j, gk + i);
    cp_async<4>(sv + b * L.ws + j, gv + i);
    b += db;
    j += dj;
    if (j >= w) {
      j -= w;
      ++b;
    }
  }
  uint32_t* se = st + 2 * L.nbb * L.ws;
  for (int i = threadIdx.x; i < L.nbb; i += kThreads) {
    cp_async<4>(se + i, ek + blk0 + i);
    cp_async<4>(se + L.nbb + i, ev + blk0 + i);
  }
  cp_async_commit();
}

// Stream position p -> coefficient of a 2-D block (ref.level_order): the
// subband order for 4 <= planes <= 27, the identity elsewhere.
template <bool kSub>
__host__ __device__ constexpr int perm2(int p) {
  if (!kSub) return p;
  return p == 2   ? 4
         : p == 3  ? 2
         : p == 4  ? 3
         : p == 6  ? 8
         : p == 7  ? 12
         : p == 8  ? 6
         : p == 9  ? 7
         : p == 10 ? 9
         : p == 11 ? 13
         : p == 12 ? 10
         : p == 13 ? 11
                   : p;
}

// One step of a 16 x 16 bit transpose done in both 16-bit halves at once
// (Hacker's Delight's transpose32, halved): pairs (k, k + S) swap the
// S x S sub-blocks selected by M.
template <int S, uint32_t M>
__device__ __forceinline__ void transpose_step(uint32_t* a) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = (i / S) * 2 * S + i % S;
    const uint32_t t = (a[k] ^ (a[k + S] >> S)) & M;
    a[k] ^= t;
    a[k + S] ^= t << S;
  }
}

// One 2-D block's plane-major stream -> its 16 transform coefficients, the
// same bits as zfp_common.cuh's unpack_regs<2>. Plane j's contributors are
// the first counts[j] stream positions, one field of the stream, and
// position p takes bit p of it: a bit matrix of planes x positions to
// transpose. Planes j and 16 + j share row j (low and high half); after the
// transpose row 15 - p holds position p's bits of plane j at bit 15 - j and
// of plane 16 + j at bit 31 - j, so swapping the halves puts plane j at
// bit 31 - j, as the codec does. About 5 operations per 32 bits moved, where
// a bit at a time takes 2 per bit.
template <bool kSub>
__device__ __forceinline__ void unpack_band_block(const uint32_t* in,
                                                  const Tables& t, int* c) {
  uint32_t r[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) r[i] = 0u;
  int off = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (j < t.nplanes) {
      const int k = t.counts[j];  // 1..16
      const int wi = off >> 5, sh = off & 31;
      uint32_t field = in[wi] >> sh;
      if (sh + k > 32) field |= in[wi + 1] << (32 - sh);
      field &= (1u << k) - 1u;  // the bits past k belong to the next plane
      r[j & 15] |= field << (16 * (j >> 4));
      off += k;
    }
  }
  transpose_step<8, 0x00FF00FFu>(r);
  transpose_step<4, 0x0F0F0F0Fu>(r);
  transpose_step<2, 0x33333333u>(r);
  transpose_step<1, 0x55555555u>(r);
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const uint32_t u = __funnelshift_l(r[15 - p], r[15 - p], 16);
    c[perm2<kSub>(p)] = (int)((u ^ kNbMask) - kNbMask);
  }
}

// Decode a staged band into the K (row stride ks) and V (stride D) tiles:
// 16 tokens x D each, laid out as ref.decode_tiles.
template <bool kSub>
__device__ __forceinline__ void decode_band(const uint32_t* st, float* k_tile,
                                            float* v_tile, int D,
                                            const Layout& L,
                                            const Tables& t) {
  const int db = D / 4;
  const int* se = (const int*)(st + 2 * L.nbb * L.ws);
  for (int j = threadIdx.x; j < 2 * L.nbb; j += kThreads) {
    const bool is_v = j >= L.nbb;
    const int bi = is_v ? j - L.nbb : j;
    int c[16];
    unpack_band_block<kSub>(st + j * L.ws, t, c);
    lift_inv<2>(c);
    const float scale = decode_scale(se[j]);
    float* tile = is_v ? v_tile : k_tile;
    const int stride = is_v ? D : L.ks;
    const int r0 = (bi / db) * 4, col0 = (bi % db) * 4;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *(float4*)(tile + (r0 + r) * stride + col0) =
          make_float4(__fmul_rn(__int2float_rn(c[4 * r]), scale),
                      __fmul_rn(__int2float_rn(c[4 * r + 1]), scale),
                      __fmul_rn(__int2float_rn(c[4 * r + 2]), scale),
                      __fmul_rn(__int2float_rn(c[4 * r + 3]), scale));
  }
}

template <bool kSub>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    cdecode_kernel(const uint32_t* __restrict__ pk, const int* __restrict__ ek,
                   const uint32_t* __restrict__ pv, const int* __restrict__ ev,
                   const float* __restrict__ q, float* __restrict__ m_out,
                   float* __restrict__ l_out, float* __restrict__ acc_out,
                   Shape s, Tables t) {
  extern __shared__ float4 smem4[];
  float* smem = (float*)smem4;
  const int D = s.d, QPK = s.qpk, D4 = D / 4;
  const Layout L(D, s.w, QPK);
  uint32_t* stages = (uint32_t*)smem;
  float* k_tile = smem + L.k_tile();
  float* v_tile = smem + L.v_tile();
  float* q_s = smem + L.q();
  float* acc_s = smem + L.acc();
  float* p_s = smem + L.p();  // QPK x kBand: logits, then p
  float* m_s = smem + L.mlc();
  float* l_s = m_s + QPK;
  float* c_s = l_s + QPK;     // this band's corr
  float* le_s = c_s + QPK;    // l's compensation
  float* err_s = smem + L.err();  // acc's compensation

  const int row = blockIdx.x, split = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int live = min(s.nb / L.nbb, (s.hist_len + kBand - 1) / kBand);
  const int b0 = split * s.per, b1 = min(b0 + s.per, live);
  const long long rowblk = (long long)row * s.nb;

  if (b0 < b1)
    stage_band(stages, pk, ek, pv, ev, rowblk + (long long)b0 * L.nbb, s.w,
               L);
  for (int e = tid; e < QPK * D; e += kThreads) {
    q_s[e] = q[(long long)row * QPK * D + e];
    acc_s[e] = 0.f;
    err_s[e] = 0.f;
  }
  for (int i = tid; i < QPK; i += kThreads) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
    le_s[i] = 0.f;
  }

  for (int b = b0; b < b1; ++b) {
    const int i = b - b0, tok0 = b * kBand;
    const uint32_t* cur = stages + (i & 1) * L.stage;
    if (b + 1 < b1) {
      stage_band(stages + ((i + 1) & 1) * L.stage, pk, ek, pv, ev,
                 rowblk + (long long)(b + 1) * L.nbb, s.w, L);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // band b staged; band b - 1's p V is done

    // 1. decode the band's K and V blocks into shared memory
    decode_band<kSub>(cur, k_tile, v_tile, D, L, t);
    __syncthreads();

    // 2. logits q . K^T, 8 lanes a dot product, masked by hist_len. QPK *
    // kBand is a multiple of 4, so the 4 teams of a warp run alike.
    for (int e = tid >> 3; e < QPK * kBand; e += kThreads / 8) {
      const int qi = e / kBand, tk = e % kBand;
      const float4* qr = (const float4*)(q_s + qi * D);
      const float4* kr = (const float4*)(k_tile + tk * L.ks);
      float sum = 0.f;
      for (int d4 = tid & 7; d4 < D4; d4 += 8) {
        const float4 a = qr[d4], k4 = kr[d4];
        sum += a.x * k4.x + a.y * k4.y + a.z * k4.z + a.w * k4.w;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if ((tid & 7) == 0) p_s[e] = tok0 + tk < s.hist_len ? sum : -INFINITY;
    }
    __syncthreads();

    // 3. online softmax, one warp per query row
    for (int qi = warp; qi < QPK; qi += kWarps) {
      float* pr = p_s + qi * kBand;
      const float x = lane < kBand ? pr[lane] : -INFINITY;
      float mx = x;
      for (int off = 16; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[qi];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = finite(m_new) ? m_new : 0.f;
      const float p =
          lane < kBand && tok0 + lane < s.hist_len ? expf(x - m_safe) : 0.f;
      if (lane < kBand) pr[lane] = p;
      float sum = p;
      for (int off = 16; off; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = finite(m_prev) ? expf(m_prev - m_safe) : 0.f;
      if (lane == 0) {
        m_s[qi] = m_new;
        comp_add(l_s[qi], le_s[qi], corr, sum);
        c_s[qi] = corr;
      }
    }
    __syncthreads();

    // 4. acc = acc * corr + p V, one float4 of outputs per thread
    for (int e = tid; e < QPK * D4; e += kThreads) {
      const int qi = e / D4, d4 = e % D4;
      const float* pr = p_s + qi * kBand;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int tk = 0; tk < kBand; ++tk) {
        const float pt = pr[tk];
        const float4 v4 = ((const float4*)(v_tile + tk * D))[d4];
        sum.x += pt * v4.x;
        sum.y += pt * v4.y;
        sum.z += pt * v4.z;
        sum.w += pt * v4.w;
      }
      const float c = c_s[qi];
      float4* a = (float4*)(acc_s + qi * D) + d4;
      float4* r = (float4*)(err_s + qi * D) + d4;
      float4 o = *a, oe = *r;
      comp_add(o.x, oe.x, c, sum.x);
      comp_add(o.y, oe.y, c, sum.y);
      comp_add(o.z, oe.z, c, sum.z);
      comp_add(o.w, oe.w, c, sum.w);
      *a = o;
      *r = oe;
    }
  }
  __syncthreads();

  const long long o = ((long long)row * s.nsplit + split) * QPK;
  for (int i = tid; i < QPK; i += kThreads) {
    m_out[o + i] = m_s[i];
    l_out[o + i] = l_s[i];
  }
  for (int e = tid; e < QPK * D; e += kThreads) acc_out[o * D + e] = acc_s[e];
}

// The decoded tiles of bands band0 .. band0 + gridDim.y of every row, as the
// attention kernel stages and decodes them: out_k, out_v (rows, nbands * 16,
// D). A check of the decode, not on the serving path.
template <bool kSub>
__global__ void __launch_bounds__(kThreads)
    cdecode_tiles_kernel(const uint32_t* __restrict__ pk,
                         const int* __restrict__ ek,
                         const uint32_t* __restrict__ pv,
                         const int* __restrict__ ev, float* __restrict__ out_k,
                         float* __restrict__ out_v, Shape s, Tables t,
                         int band0) {
  extern __shared__ float4 smem4[];
  float* smem = (float*)smem4;
  const int D = s.d;
  const Layout L(D, s.w, 1);
  float* k_tile = smem + L.k_tile();
  float* v_tile = smem + L.v_tile();
  const int row = blockIdx.x, band = band0 + blockIdx.y;
  stage_band((uint32_t*)smem, pk, ek, pv, ev,
             (long long)row * s.nb + (long long)band * L.nbb, s.w, L);
  cp_async_wait<0>();
  __syncthreads();
  decode_band<kSub>((const uint32_t*)smem, k_tile, v_tile, D, L, t);
  __syncthreads();
  const long long o =
      ((long long)row * gridDim.y + blockIdx.y) * kBand * (long long)D;
  for (int e = threadIdx.x; e < kBand * D; e += kThreads) {
    out_k[o + e] = k_tile[(e / D) * L.ks + e % D];
    out_v[o + e] = v_tile[e];
  }
}

// 1 for the subband stream order, 0 for the identity, -1 for another.
int stream_order(const int* perm) {
  bool sub = true, ident = true;
  for (int p = 0; p < 16; ++p) {
    sub &= perm[p] == perm2<true>(p);
    ident &= perm[p] == p;
  }
  return sub ? 1 : ident ? 0 : -1;
}

template <typename K>
int prepare(K kern, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for (head_dim, qpk, payload words),
// in bytes.
int cdecode_smem_bytes(int head_dim, int qpk, int w) {
  return Layout(head_dim, w, qpk).words() * (int)sizeof(float);
}

// pk, pv: (rows, nb, w) uint32; ek, ev: (rows, nb) int32; q: (rows, qpk, D)
// float32; m, l: (rows, nsplit, qpk) and acc: (rows, nsplit, qpk, D) float32,
// all contiguous on the device. Table pointers are host memory (ndim 2).
int cdecode_attention(const void* pk, const void* ek, const void* pv,
                      const void* ev, const void* q, void* m, void* l,
                      void* acc, int rows, int nb, int w, int head_dim,
                      int qpk, int hist_len, int nsplit, int per,
                      const void* masks, const void* perm, const void* counts,
                      int nplanes, void* stream) {
  const Shape s = {nb, w, head_dim, qpk, hist_len, nsplit, per};
  const Tables t = make_tables(2, (const uint32_t*)masks, (const int*)perm,
                               (const int*)counts, nplanes, w);
  const int order = stream_order((const int*)perm);
  if (order < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)cdecode_smem_bytes(head_dim, qpk, w);
  auto kern = order ? cdecode_kernel<true> : cdecode_kernel<false>;
  const int err = prepare(kern, smem);
  if (err) return err;
  const dim3 grid((unsigned)rows, (unsigned)nsplit);
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)pk, (const int*)ek, (const uint32_t*)pv, (const int*)ev,
      (const float*)q, (float*)m, (float*)l, (float*)acc, s, t);
  return (int)cudaGetLastError();
}

// The decoded K and V tiles of bands band0 .. band0 + nbands of every row:
// out_k, out_v (rows, nbands * 16, head_dim) float32.
int cdecode_tiles(const void* pk, const void* ek, const void* pv,
                  const void* ev, void* out_k, void* out_v, int rows, int nb,
                  int w, int head_dim, int band0, int nbands,
                  const void* masks, const void* perm, const void* counts,
                  int nplanes, void* stream) {
  const Shape s = {nb, w, head_dim, 1, 0, 1, 0};
  const Tables t = make_tables(2, (const uint32_t*)masks, (const int*)perm,
                               (const int*)counts, nplanes, w);
  const int order = stream_order((const int*)perm);
  if (order < 0 || nbands < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)cdecode_smem_bytes(head_dim, 1, w);
  auto kern = order ? cdecode_tiles_kernel<true> : cdecode_tiles_kernel<false>;
  const int err = prepare(kern, smem);
  if (err) return err;
  const dim3 grid((unsigned)rows, (unsigned)nbands);
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)pk, (const int*)ek, (const uint32_t*)pv, (const int*)ev,
      (float*)out_k, (float*)out_v, s, t, band0);
  return (int)cudaGetLastError();
}

const char* cdecode_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
