// cross_attention: softmax(scale * q k^T) v of image tokens onto a small
// static K/V (512 text tokens, 257 CLIP tokens; Lk <= 1024).
//
// Replaces the TPU kernel _cross_kernel
// (self_forcing_tpu/ops/pallas_attention.py, called through
// cross_attention_pallas).
//
// Function, per (batch b, head n, query row i), with the exact row max as
// in the TPU kernel's single pass:
//   s_j = scale * q_i . k_j (fp32), columns j >= Lk masked,
//   m = max_j s_j,  p_j = exp(s_j - m),  l = sum_j p_j,
//   out_i = (sum_j p_j v_j) / max(l, 1e-30)  -> bf16
// The TPU kernel forms p.v in fp32.  Here p is split into two bf16 parts
// (p = p_hi + p_lo to about 16 mantissa bits) and both are multiplied with
// the bf16 v on the tensor cores with fp32 accumulators, which keeps that
// precision at twice the P.V cost.
//
// Layouts: q and out are heads-packed [B, Lq, N*D]; k and v are
// [B, Lk, N, D].  D = 128.
//
// What bounds it on the H100: at the 1.3B shapes (Lq = 4680, Lk = 512,
// 12 heads) a call does ~15 GFLOP against ~30 MB, so it is bound by
// tensor-core operations.  Design: the TPU kernel holds all of K/V in one
// tile and takes the row max in one pass; shared memory cannot hold the
// [64, Lk] fp32 scores beside K and V, so this kernel keeps scores in
// registers and makes two passes over K: the first only takes the row
// max, the second recomputes q.k and accumulates exp(s - m) and p.v.  One
// CTA of 4 warps per (b*n, 64-query tile), 16 rows per warp, Q fragments
// in registers, K/V tiles of 64 keys double-buffered with cp.async,
// mma.sync m16n8k16 products (shared helpers in attention_common.cuh).
// In all it does twice the function's FLOPs (q.k twice, p.v twice for
// the hi/lo split).  Not yet: wgmma, TMA.

#include "attention_common.cuh"

using namespace sf_attn;

namespace {

constexpr int D = 128;
constexpr int BM = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per streamed tile
constexpr int WARPS = 4;      // each warp owns 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr int LK_MAX = 1024;
constexpr int LDH = D + 8;    // padded bf16 row stride
constexpr int TILE = BK * LDH;
constexpr size_t SMEM_BYTES = size_t(BM * LDH + 4 * TILE) * sizeof(bf16);

__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int valid) {
  load_rows<BK, D, LDH, THREADS>(dst, src, stride, valid);
}

__global__ void __launch_bounds__(THREADS, 2)
cross_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       int N, int Lq, int Lk, float scale) {
  // [Q | K0 | K1 | V0 | V1]
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sKV = sQ + BM * LDH;

  const int bn = blockIdx.y;
  const int b = bn / N;
  const int n = bn % N;
  const int q0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tg = lane % 4;
  const long long ld_tok = (long long)N * D;

  const bf16* kb = k + (long long)b * Lk * ld_tok + n * D;
  const bf16* vb = v + (long long)b * Lk * ld_tok + n * D;
  const int n_tiles = (Lk + BK - 1) / BK;

  load_tile(sQ, q + ((long long)b * Lq + q0) * ld_tok + n * D, ld_tok,
            min(BM, Lq - q0));
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[D / 16][4];
  load_a_frags<D / 16, LDH>(qf, sQ + warp * 16 * LDH, lane);

  // pass 1: row max of scale * q.k (rows g and g + 8 of the warp)
  float m0 = -1e30f, m1 = -1e30f;
  load_tile(sKV, kb, ld_tok, min(BK, Lk));
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t % 2;
    if (t + 1 < n_tiles) {
      load_tile(sKV + (buf ^ 1) * TILE, kb + (long long)(t + 1) * BK * ld_tok,
                ld_tok, min(BK, Lk - (t + 1) * BK));
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float s[BK / 8][4];
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    qk_tile<BK / 8, D / 16, LDH>(s, qf, sKV + buf * TILE, lane);
    const int valid = min(BK, Lk - t * BK);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (nt * 8 + 2 * tg + e < valid) {
          m0 = fmaxf(m0, s[nt][e] * scale);
          m1 = fmaxf(m1, s[nt][e + 2] * scale);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));

  // pass 2: p = exp(s - m), l = sum p, acc = p_hi.v + p_lo.v
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float l0 = 0.f, l1 = 0.f;
  load_tile(sKV, kb, ld_tok, min(BK, Lk));
  load_tile(sKV + 2 * TILE, vb, ld_tok, min(BK, Lk));
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t % 2;
    if (t + 1 < n_tiles) {
      const long long off = (long long)(t + 1) * BK * ld_tok;
      const int valid = min(BK, Lk - (t + 1) * BK);
      load_tile(sKV + (buf ^ 1) * TILE, kb + off, ld_tok, valid);
      load_tile(sKV + (2 + (buf ^ 1)) * TILE, vb + off, ld_tok, valid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float s[BK / 8][4];
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    qk_tile<BK / 8, D / 16, LDH>(s, qf, sKV + buf * TILE, lane);
    const int valid = min(BK, Lk - t * BK);
    const bf16* v_s = sKV + (2 + buf) * TILE;
    // per 16-key step: p of key tiles 2kk, 2kk+1 -> A fragments -> p.v
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ph[1][4], pl[1][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int nt = 2 * kk + h;
        float p[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool vis = nt * 8 + 2 * tg + e < valid;
          p[e] = vis ? __expf(s[nt][e] * scale - m0) : 0.f;
          p[e + 2] = vis ? __expf(s[nt][e + 2] * scale - m1) : 0.f;
        }
        l0 += p[0] + p[1];
        l1 += p[2] + p[3];
        float hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hi[e] = __bfloat162float(__float2bfloat16(p[e]));
          lo[e] = p[e] - hi[e];
        }
        ph[0][h * 2 + 0] = pack_bf16(hi[0], hi[1]);
        ph[0][h * 2 + 1] = pack_bf16(hi[2], hi[3]);
        pl[0][h * 2 + 0] = pack_bf16(lo[0], lo[1]);
        pl[0][h * 2 + 1] = pack_bf16(lo[2], lo[3]);
      }
      pv_tile<D / 8, 1, LDH>(o, ph, v_s + kk * 16 * LDH, lane);
      pv_tile<D / 8, 1, LDH>(o, pl, v_s + kk * 16 * LDH, lane);
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int r0 = q0 + warp * 16 + g;
  store_rows<D>(out + (long long)b * Lq * ld_tok + n * D, ld_tok, o, r0,
                r0 + 8, Lq, fmaxf(l0, 1e-30f), fmaxf(l1, 1e-30f), tg);
}

}  // namespace

// Launch on `stream`; returns the CUDA error code (0 on success).
// Requires 1 <= Lk <= 1024.
extern "C" int cross_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int N,
                                      int Lq, int Lk, float scale,
                                      void* stream) {
  if (Lk < 1 || Lk > LK_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      cross_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (Lq <= 0 || B * N <= 0) return 0;
  dim3 grid((Lq + BM - 1) / BM, B * N);
  cross_attention_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, N, Lq, Lk,
      scale);
  return (int)cudaGetLastError();
}
