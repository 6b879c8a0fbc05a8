// Fused ZFP-decode + flash-decode attention over a compressed KV cache, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel fused_cdecode_attention (_kernel, _decode_tile) of
// src/repro/kernels/cdecode/kernel.py. Held to the plain PyTorch version,
// src/repro_torch/kernels/cdecode/ref.py, within rtol = atol = 2e-5: the
// decoded K and V values are bit for bit the codec's (zfp_common.cuh), only
// the order of the float32 sums differs.
//
// Contract: for each (batch x kv-head) row, the flash-decoding partials
// (m, l, acc) of the QPK pre-scaled queries over the first hist_len tokens of
// the compressed history, one set per split below. The ops wrapper merges
// the splits and the raw tail window in one step with the reference's guarded
// formulas; merged alone, the splits are the reference's whole-history
// partials.
//
// Bound on the H100: bytes. The point of the kernel is that the only device
// memory traffic of the history is the compressed payload and its emax
// headers (tests/test_cdecode_kernel.py::test_fused_hbm_traffic_model); the
// decoded K and V never exist in device memory. Per 64-token chunk and row
// that is 2 * (16 * D/4) blocks of 4*W + 4 bytes, against QPK * 64 * D * 4
// multiply-adds, far below the card's float32 rate.
//
// Design (simple first):
//  * Grid (rows, nsplit): each CTA owns a contiguous run of `per` chunks, so
//    the 16-32 rows of a decode batch still give every SM work; the wrapper
//    sizes nsplit from the row count.
//  * Per chunk, the 256 threads decode the K and V blocks (one thread per 4x4
//    block, kept in registers: one stream field per bit plane, then the
//    codec's inverse lift) into shared memory: 64 x D
//    float32 each, 64 KB for both at D = 128. The K rows are padded by one
//    float so that the logits loop reads them without bank conflicts.
//  * Then the QPK x 64 logits (masked by hist_len), the online softmax with
//    one warp per query row (expf, guarded as the reference: a row whose max
//    is still -inf gets corr = 0), and acc = acc * corr + p V for the QPK x D
//    outputs, each owned by one thread.
//  * Chunks at or past hist_len / 64 contribute exactly nothing, so no CTA
//    visits them.
// Known costs left for a later change: the decode's integer work, not the
// payload bytes, is the limit (PERF.md); each thread reads its block's words
// uncoalesced; the logits and p V loops are scalar float32 (no wgmma, TMA or
// bf16 path).
// Built with -fmad=false.

#include <math.h>

#include "zfp_common.cuh"

namespace {

using namespace zfpc;

constexpr int kChunk = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// jnp.isfinite: false for +-inf and NaN
__device__ __forceinline__ bool finite(float x) { return fabsf(x) < INFINITY; }

struct Shape {
  int nb;        // payload blocks per row (every chunk of max_len)
  int w;         // payload words per block
  int d;         // head_dim
  int qpk;       // queries per kv head
  int hist_len;  // compressed tokens valid
  int nsplit;    // CTAs per row
  int per;       // chunks per CTA
};

size_t smem_floats(int d, int qpk) {
  return (size_t)kChunk * (d + 1) + (size_t)kChunk * d + 2 * (size_t)qpk * d +
         (size_t)qpk * kChunk + 3 * (size_t)qpk;
}

__global__ void __launch_bounds__(kThreads)
    cdecode_kernel(const uint32_t* __restrict__ pk, const int* __restrict__ ek,
                   const uint32_t* __restrict__ pv, const int* __restrict__ ev,
                   const float* __restrict__ q, float* __restrict__ m_out,
                   float* __restrict__ l_out, float* __restrict__ acc_out,
                   Shape s, Tables t) {
  extern __shared__ float smem[];
  const int D = s.d, QPK = s.qpk, ks = D + 1;
  float* k_tile = smem;                  // kChunk x ks
  float* v_tile = k_tile + kChunk * ks;  // kChunk x D
  float* q_s = v_tile + kChunk * D;      // QPK x D
  float* acc_s = q_s + QPK * D;          // QPK x D
  float* p_s = acc_s + QPK * D;          // QPK x kChunk: logits, then p
  float* m_s = p_s + QPK * kChunk;       // QPK
  float* l_s = m_s + QPK;                // QPK
  float* c_s = l_s + QPK;                // QPK: this chunk's corr

  const int row = blockIdx.x, split = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int db = D / 4, nbc = (kChunk / 4) * db;
  const int live = min(s.nb / nbc, (s.hist_len + kChunk - 1) / kChunk);
  const int c0 = split * s.per, c1 = min(c0 + s.per, live);

  for (int e = tid; e < QPK * D; e += kThreads) {
    q_s[e] = q[(long long)row * QPK * D + e];
    acc_s[e] = 0.f;
  }
  for (int i = tid; i < QPK; i += kThreads) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }
  __syncthreads();

  for (int ci = c0; ci < c1; ++ci) {
    // 1. decode the chunk's K and V blocks into shared memory
    for (int j = tid; j < 2 * nbc; j += kThreads) {
      const bool is_v = j >= nbc;
      const int bi = is_v ? j - nbc : j;
      const long long blk = (long long)row * s.nb + (long long)ci * nbc + bi;
      int c[16];
      unpack_block2((is_v ? pv : pk) + blk * s.w, t, c);
      lift_inv<2>(c);
      const float scale = decode_scale((is_v ? ev : ek)[blk]);
      float* tile = is_v ? v_tile : k_tile;
      const int stride = is_v ? D : ks;
      const int r0 = (bi / db) * 4, col0 = (bi % db) * 4;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        tile[(r0 + i / 4) * stride + col0 + i % 4] =
            __fmul_rn(__int2float_rn(c[i]), scale);
    }
    __syncthreads();

    // 2. logits q . K^T, masked by hist_len
    for (int e = tid; e < QPK * kChunk; e += kThreads) {
      const int qi = e / kChunk, tk = e % kChunk;
      const float* qr = q_s + qi * D;
      const float* kr = k_tile + tk * ks;
      float sum = 0.f;
      for (int d = 0; d < D; ++d) sum += qr[d] * kr[d];
      p_s[e] = ci * kChunk + tk < s.hist_len ? sum : -INFINITY;
    }
    __syncthreads();

    // 3. online softmax, one warp per query row
    for (int qi = warp; qi < QPK; qi += kWarps) {
      float* pr = p_s + qi * kChunk;
      float mx = -INFINITY;
      for (int tk = lane; tk < kChunk; tk += 32) mx = fmaxf(mx, pr[tk]);
      for (int off = 16; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[qi];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = finite(m_new) ? m_new : 0.f;
      float sum = 0.f;
      for (int tk = lane; tk < kChunk; tk += 32) {
        const float p =
            ci * kChunk + tk < s.hist_len ? expf(pr[tk] - m_safe) : 0.f;
        pr[tk] = p;
        sum += p;
      }
      for (int off = 16; off; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = finite(m_prev) ? expf(m_prev - m_safe) : 0.f;
      __syncwarp();
      if (lane == 0) {
        m_s[qi] = m_new;
        l_s[qi] = l_s[qi] * corr + sum;
        c_s[qi] = corr;
      }
    }
    __syncthreads();

    // 4. acc = acc * corr + p V
    for (int e = tid; e < QPK * D; e += kThreads) {
      const int qi = e / D, d = e % D;
      const float* pr = p_s + qi * kChunk;
      float sum = 0.f;
      for (int tk = 0; tk < kChunk; ++tk) sum += pr[tk] * v_tile[tk * D + d];
      acc_s[e] = acc_s[e] * c_s[qi] + sum;
    }
    __syncthreads();
  }

  const long long o = ((long long)row * s.nsplit + split) * QPK;
  for (int i = tid; i < QPK; i += kThreads) {
    m_out[o + i] = m_s[i];
    l_out[o + i] = l_s[i];
  }
  for (int e = tid; e < QPK * D; e += kThreads) acc_out[o * D + e] = acc_s[e];
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for (head_dim, qpk), in bytes.
int cdecode_smem_bytes(int head_dim, int qpk) {
  return (int)(smem_floats(head_dim, qpk) * sizeof(float));
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
  const size_t smem = smem_floats(head_dim, qpk) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      cdecode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)rows, (unsigned)nsplit);
  cdecode_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)pk, (const int*)ek, (const uint32_t*)pv, (const int*)ev,
      (const float*)q, (float*)m, (float*)l, (float*)acc, s, t);
  return (int)cudaGetLastError();
}

const char* cdecode_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
