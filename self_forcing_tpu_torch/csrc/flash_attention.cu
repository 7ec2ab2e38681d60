// Masked flash attention for training: the forward (flash_fwd) in the
// offset-free base-2 softmax ('free'), the bounded-offset softmax
// ('bounded', fixed_m0) and the online softmax, and its two backward
// kernels (flash_bwd_dq, flash_bwd_dkv), which serve every mode.
//
// Replaces the TPU kernels of self_forcing_tpu/ops/pallas_attention.py:
//   flash_fwd      <- _flash_kernel (free, bounded and online modes), via
//                     flash_attention_pallas -> _flash_fwd -> pallas_call
//   flash_bwd_dq   <- _flash_bwd_dq_kernel, via _flash_bwd -> pallas_call
//   flash_bwd_dkv  <- _flash_bwd_dkv_kernel, via _flash_bwd -> pallas_call
//
// Function.  q, k, v, out, dout, dq, dk, dv are [B, L, N, D] bf16 (token
// row stride N*D), D = 128.  Query row i sees key j iff j < Lk and
//   s1[i] <= j < e1[i]  or  s2[i] <= j < e2[i]
// (an IntervalMask; no mask is [0, Lk) for every row).  Forward:
//   s = q_i . k_j (fp32), on visible keys
//   free:    p = 2^min(s, 80), the caller's head_dim**-0.5 * log2(e)
//            folded into q (no running max),  lse_i = ln(l)
//   bounded: p = exp(scale * s - m0), m0 >= every score (read from
//            device memory),  lse_i = m0 + ln(l)
//   online:  p = exp(scale * s - m), m the running row max over the
//            64-key tiles (l and acc rescaled when it grows),
//            lse_i = m + ln(l)
//   l = sum p,  out_i = sum bf16(p) v_j / max(l, 1e-30) -> bf16, lse in
//   fp32 (0 where the row saw nothing).  bounded and online run base 2
//   (scores times scale * log2(e)); online rounds p to bf16 for P.V as
//   the others do (the Pallas kernel in interpret mode keeps it f32).
// Backward at `scale` (ln 2 in free mode, the forward's scale otherwise;
// exact against the base-e lse):
//   p = exp(scale * s - lse_i),  dp = do_i . v_j,  delta_i = rowsum(do*out)
//   ds = p * (dp - delta_i)
//   dq_i = scale * sum_j bf16(ds) k_j,  dk_j = scale * sum_i bf16(ds) q_i,
//   dv_j = sum_i bf16(p) do_i.
//
// Tiles.  The wrapper gives each kernel a table of tile states computed
// from the intervals (0 dead, 1 partial, 2 fully visible), as the Pallas
// wrapper's _tile_states does: dead tiles are never loaded, fully visible
// ones skip the per-element mask.  Per-row arrays (the four interval
// arrays, lse, delta) are padded to Lq_pad, a multiple of 128.
//
// What bounds it on the H100: at the training shape (B 1, L 32760, 12
// heads) the forward does 4 L^2 D N = 6.6 TFLOP against ~0.3 GB of q, k, v
// and out, the backward 5 to 7 products of that size: bound by
// tensor-core operations.  Design (FlashAttention-2 on mma.sync, each CTA
// loops over its own tiles and carries nothing to another CTA):
// - flash_fwd: one CTA of 4 warps per (b*n, 128-query tile), 32 query
//   rows a warp as two m-tiles, 64-key K/V tiles double-buffered with
//   cp.async; the scores stay in registers as P.V's A operand (the
//   decode kernel's design, csrc/decode_fresh.cu).
// - flash_bwd_dq: one CTA of 8 warps per (b*n, 128-query tile), q and dO
//   resident, K/V tiles streamed; s and dp in registers, ds packed to bf16
//   as the A operand of ds.K.
// - flash_bwd_dkv: one CTA of 4 warps per (b*n, 64-key tile), K and V
//   resident, 32-query tiles of q, dO and their row scalars streamed; the
//   products run transposed (keys as rows), so p^T and ds^T are the A
//   operands of p^T.dO and ds^T.Q.
// Not yet: wgmma, TMA, warp specialisation.

#include "attention_common.cuh"

using namespace sf_attn;

namespace {

constexpr int D = 128;         // head dim
constexpr int LDH = D + 8;     // padded bf16 row stride of a shared tile
constexpr int BK = 64;         // keys per K/V tile
constexpr int ROWS_PAD = 128;  // per-row arrays are padded to this
constexpr int MAX_TILES = 4096;  // tile-state row kept in shared memory
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

enum Mode { FREE = 0, BOUNDED = 1, ONLINE = 2 };

__device__ __forceinline__ bool visible(int j, int s1, int e1, int s2,
                                        int e2) {
  return (j >= s1 && j < e1) || (j >= s2 && j < e2);
}

// The next tile index >= t whose state is not dead; n when none is left.
__device__ __forceinline__ int next_live(const unsigned char* st, int t,
                                         int n) {
  while (t < n && st[t] == 0) ++t;
  return t;
}

// Copy this CTA's row of the tile-state table into shared memory.
template <int THREADS>
__device__ __forceinline__ void load_states(unsigned char* dst,
                                            const unsigned char* src,
                                            int n) {
  for (int i = threadIdx.x; i < n; i += THREADS) dst[i] = src[i];
}

// o [16 x 8*NT] += A (16 x D at a_s, row stride LDH) * B^T, B a shared
// [8*NT rows][LDH] tile.
template <int NT>
__device__ __forceinline__ void mm_abt(float (*o)[4], const bf16* a_s,
                                       const bf16* b_s, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    const int row = (lane % 8) + ((lane / 8) % 2) * 8;
    ldmatrix_x4(a, a_s + row * LDH + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      const int key = np * 16 + (lane % 8) + (lane / 16) * 8;
      ldmatrix_x4(b, b_s + key * LDH + kk * 16 + ((lane / 8) % 2) * 8);
      mma16816(o[2 * np], a, b[0], b[1]);
      mma16816(o[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// o [16 x D] += A (16 x 16, fragments a) * B, B the shared rows
// [k0, k0 + 16) of a [rows][LDH] tile read transposed.
__device__ __forceinline__ void mm_ab(float (*o)[4], const uint32_t* a,
                                      const bf16* b_s, int k0, int lane) {
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp) {
    uint32_t b[4];
    const int key = k0 + (lane % 8) + ((lane / 8) % 2) * 8;
    ldmatrix_x4_trans(b, b_s + key * LDH + dp * 16 + (lane / 16) * 8);
    mma16816(o[2 * dp], a, b[0], b[1]);
    mma16816(o[2 * dp + 1], a, b[2], b[3]);
  }
}

// Store accumulators (rows g and g+8 of a warp's 16, D columns) times
// `mul` as bf16 to rows r0 / r1 (< rows) of `out`.
__device__ __forceinline__ void store_scaled(bf16* out, long long stride,
                                             const float (*o)[4], int r0,
                                             int r1, int rows, float mul,
                                             int tg) {
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * tg;
    if (r0 < rows)
      *reinterpret_cast<uint32_t*>(out + r0 * stride + col) =
          pack_bf16(o[dt][0] * mul, o[dt][1] * mul);
    if (r1 < rows)
      *reinterpret_cast<uint32_t*>(out + r1 * stride + col) =
          pack_bf16(o[dt][2] * mul, o[dt][3] * mul);
  }
}

// =====================================================================
// forward
// =====================================================================

namespace fwd {
constexpr int MT = 2;      // 16-row m-tiles per warp
constexpr int WARPS = 4;
constexpr int BM = 16 * MT * WARPS;  // 128 query rows per CTA
constexpr int THREADS = WARPS * 32;
constexpr int TILE = BK * LDH;
constexpr size_t SMEM = size_t(BM * LDH + 4 * TILE) * sizeof(bf16) +
                        4 * BM * sizeof(int) + MAX_TILES;
}  // namespace fwd

// p for one 64-key tile and P.V into o; s holds the tile's scores, m the
// running row max (ONLINE, base 2), mul the scores' multiplier into base 2
// and off BOUNDED's base-2 offset.
template <bool MASKED, int MODE>
__device__ __forceinline__ void fwd_tile(float (&o)[fwd::MT][D / 8][4],
                                         float (&l)[fwd::MT][2],
                                         float (&m)[fwd::MT][2],
                                         float (&s)[fwd::MT][BK / 8][4],
                                         const bf16* v_s, const int* sIv,
                                         int row_base, int j0, int Lk,
                                         float mul, float off, int lane) {
  using namespace fwd;
  const int g = lane / 4, tg = lane % 4;
  // the scores in base-2 units, -inf on keys the row does not see
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = MODE == FREE ? s[mt][nt][e] : s[mt][nt][e] * mul;
        if (MASKED) {
          const int r = row_base + mt * 16 + g + 8 * (e >> 1);
          const int j = j0 + nt * 8 + 2 * tg + (e & 1);
          if (!(j < Lk && visible(j, sIv[r], sIv[BM + r], sIv[2 * BM + r],
                                  sIv[3 * BM + r])))
            x = -INFINITY;
        }
        s[mt][nt][e] = x;
      }
  float sub[MT][2];  // what p's exponent subtracts, per row
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      sub[mt][hr] = off;
      if (MODE == ONLINE) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt)
          mx = fmaxf(mx, fmaxf(s[mt][nt][2 * hr], s[mt][nt][2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mt][hr], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float corr = fast_exp2(m[mt][hr] - m_use);
        l[mt][hr] *= corr;
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          o[mt][i][2 * hr] *= corr;
          o[mt][i][2 * hr + 1] *= corr;
        }
        m[mt][hr] = m_new;
        sub[mt][hr] = m_use;
      }
    }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t pa[MT][4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int nt = 2 * kk + hh;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // exp2(-inf) = 0 on the keys the row does not see
          p[e] = MODE == FREE ? fast_exp2(fminf(s[mt][nt][e], 80.f))
                              : fast_exp2(s[mt][nt][e] - sub[mt][e >> 1]);
        }
        l[mt][0] += p[0] + p[1];
        l[mt][1] += p[2] + p[3];
        pa[mt][hh * 2 + 0] = pack_bf16(p[0], p[1]);
        pa[mt][hh * 2 + 1] = pack_bf16(p[2], p[3]);
      }
    }
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t vb[4];
      const int key = kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
      ldmatrix_x4_trans(vb, v_s + key * LDH + dp * 16 + (lane / 16) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma16816(o[mt][2 * dp], pa[mt], vb[0], vb[1]);
        mma16816(o[mt][2 * dp + 1], pa[mt], vb[2], vb[3]);
      }
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(fwd::THREADS, 2)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ m0,
                 bf16* __restrict__ out, float* __restrict__ lse,
                 const int* __restrict__ iv,
                 const unsigned char* __restrict__ states, int N, int Lq,
                 int Lk, int Lq_pad, float scale) {
  using namespace fwd;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sKV = sQ + BM * LDH;  // [K0 | K1 | V0 | V1]
  int* sIv = reinterpret_cast<int*>(sKV + 4 * TILE);  // [4][BM]
  unsigned char* sSt = reinterpret_cast<unsigned char*>(sIv + 4 * BM);

  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  const int q0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const long long ld = (long long)N * D;
  const bf16* kb = k + (long long)b * Lk * ld + n * D;
  const bf16* vb = v + (long long)b * Lk * ld + n * D;
  const int nkt = (Lk + BK - 1) / BK;

  load_rows<BM, D, LDH, THREADS>(
      sQ, q + ((long long)b * Lq + q0) * ld + n * D, ld, min(BM, Lq - q0));
  cp_async_commit();
  for (int i = threadIdx.x; i < 4 * BM; i += THREADS)
    sIv[i] = iv[(i / BM) * Lq_pad + q0 + i % BM];
  load_states<THREADS>(sSt, states + (long long)blockIdx.x * nkt, nkt);
  __syncthreads();
  const bf16* qw = sQ + warp * 16 * MT * LDH;

  float o[MT][D / 8][4];
  float l[MT][2];
  float m[MT][2];  // ONLINE: running max (base 2) of rows g and g + 8
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    l[mt][0] = l[mt][1] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      o[mt][i][0] = o[mt][i][1] = o[mt][i][2] = o[mt][i][3] = 0.f;
  }
  const float mul = scale * LOG2E;
  const float m0v = MODE == BOUNDED ? __ldg(m0) : 0.f;
  const float off = m0v * LOG2E;

  auto fetch = [&](int t, int buf) {
    const int j0 = t * BK;
    const int valid = min(BK, Lk - j0);
    load_rows<BK, D, LDH, THREADS>(sKV + buf * TILE, kb + j0 * ld, ld,
                                   valid);
    load_rows<BK, D, LDH, THREADS>(sKV + (2 + buf) * TILE, vb + j0 * ld,
                                   ld, valid);
  };

  int t = next_live(sSt, 0, nkt);
  if (t < nkt) fetch(t, 0);
  cp_async_commit();
  int buf = 0;
  while (t < nkt) {
    const int tn = next_live(sSt, t + 1, nkt);
    if (tn < nkt) fetch(tn, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const bf16* k_s = sKV + buf * TILE;
    const bf16* v_s = sKV + (2 + buf) * TILE;
    float s[MT][BK / 8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
        s[mt][i][0] = s[mt][i][1] = s[mt][i][2] = s[mt][i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int row = mt * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
        ldmatrix_x4(a[mt], qw + row * LDH + kk * 16 + (lane / 16) * 8);
      }
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t kf[4];
        const int key = np * 16 + (lane % 8) + (lane / 16) * 8;
        ldmatrix_x4(kf, k_s + key * LDH + kk * 16 + ((lane / 8) % 2) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(s[mt][2 * np], a[mt], kf[0], kf[1]);
          mma16816(s[mt][2 * np + 1], a[mt], kf[2], kf[3]);
        }
      }
    }
    if (sSt[t] == 2)
      fwd_tile<false, MODE>(o, l, m, s, v_s, sIv, warp * 16 * MT, t * BK,
                            Lk, mul, off, lane);
    else
      fwd_tile<true, MODE>(o, l, m, s, v_s, sIv, warp * 16 * MT, t * BK, Lk,
                           mul, off, lane);
    __syncthreads();
    buf ^= 1;
    t = tn;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float l0 = l[mt][0], l1 = l[mt][1];
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const int r0 = q0 + warp * 16 * MT + mt * 16 + g, r1 = r0 + 8;
    store_rows<D>(out + (long long)b * Lq * ld + n * D, ld, o[mt], r0, r1,
                  Lq, fmaxf(l0, 1e-30f), fmaxf(l1, 1e-30f), tg);
    if (tg == 0) {
      // the offset the p's were taken against, base e
      const float a0 = MODE == FREE ? 0.f : MODE == BOUNDED ? m0v
                                                            : m[mt][0] * LN2;
      const float a1 = MODE == FREE ? 0.f : MODE == BOUNDED ? m0v
                                                            : m[mt][1] * LN2;
      float* lrow = lse + (long long)bn * Lq_pad;
      if (r0 < Lq) lrow[r0] = l0 > 0.f ? a0 + logf(l0) : 0.f;
      if (r1 < Lq) lrow[r1] = l1 > 0.f ? a1 + logf(l1) : 0.f;
    }
  }
}

// =====================================================================
// backward: dq
// =====================================================================

namespace bdq {
constexpr int WARPS = 8;
constexpr int BM = 16 * WARPS;  // 128 query rows per CTA, 16 a warp
constexpr int THREADS = WARPS * 32;
constexpr int TILE = BK * LDH;
constexpr size_t SMEM = size_t(2 * BM * LDH + 4 * TILE) * sizeof(bf16) +
                        4 * BM * sizeof(int) + MAX_TILES;
}  // namespace bdq

// ds for one 64-key tile, then acc += bf16(ds) . K
template <bool MASKED>
__device__ __forceinline__ void dq_tile(float (&acc)[D / 8][4],
                                        const float (&s)[BK / 8][4],
                                        const float (&dp)[BK / 8][4],
                                        const bf16* k_s, const int* sIv,
                                        const float (&lse2)[2],
                                        const float (&dl)[2], float cs,
                                        int row_base, int j0, int Lk,
                                        int lane) {
  using namespace bdq;
  const int g = lane / 4, tg = lane % 4;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t da[4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int nt = 2 * kk + hh;
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float p = fast_exp2(fmaf(s[nt][e], cs, -lse2[h]));
        if (MASKED) {
          const int r = row_base + g + 8 * h;
          const int j = j0 + nt * 8 + 2 * tg + (e & 1);
          if (!(j < Lk && visible(j, sIv[r], sIv[BM + r], sIv[2 * BM + r],
                                  sIv[3 * BM + r])))
            p = 0.f;
        }
        ds[e] = p * (dp[nt][e] - dl[h]);
      }
      da[hh * 2 + 0] = pack_bf16(ds[0], ds[1]);
      da[hh * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    mm_ab(acc, da, k_s, kk * 16, lane);
  }
}

__global__ void __launch_bounds__(bdq::THREADS, 1)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    const int* __restrict__ iv,
                    const unsigned char* __restrict__ states, int N, int Lq,
                    int Lk, int Lq_pad, float scale) {
  using namespace bdq;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sDO = sQ + BM * LDH;
  bf16* sKV = sDO + BM * LDH;  // [K0 | K1 | V0 | V1]
  int* sIv = reinterpret_cast<int*>(sKV + 4 * TILE);
  unsigned char* sSt = reinterpret_cast<unsigned char*>(sIv + 4 * BM);

  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  const int q0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const long long ld = (long long)N * D;
  const bf16* kb = k + (long long)b * Lk * ld + n * D;
  const bf16* vb = v + (long long)b * Lk * ld + n * D;
  const int nkt = (Lk + BK - 1) / BK;
  const long long qoff = ((long long)b * Lq + q0) * ld + n * D;

  load_rows<BM, D, LDH, THREADS>(sQ, q + qoff, ld, min(BM, Lq - q0));
  load_rows<BM, D, LDH, THREADS>(sDO, dout + qoff, ld, min(BM, Lq - q0));
  cp_async_commit();
  for (int i = threadIdx.x; i < 4 * BM; i += THREADS)
    sIv[i] = iv[(i / BM) * Lq_pad + q0 + i % BM];
  load_states<THREADS>(sSt, states + (long long)blockIdx.x * nkt, nkt);
  __syncthreads();

  const int row_base = warp * 16;
  const float* lrow = lse + (long long)bn * Lq_pad + q0 + row_base + g;
  const float* drow = delta + (long long)bn * Lq_pad + q0 + row_base + g;
  const float lse2[2] = {lrow[0] * LOG2E, lrow[8] * LOG2E};
  const float dl[2] = {drow[0], drow[8]};
  const float cs = scale * LOG2E;
  const bf16* qw = sQ + row_base * LDH;
  const bf16* dow = sDO + row_base * LDH;

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  auto fetch = [&](int t, int buf) {
    const int j0 = t * BK;
    const int valid = min(BK, Lk - j0);
    load_rows<BK, D, LDH, THREADS>(sKV + buf * TILE, kb + j0 * ld, ld,
                                   valid);
    load_rows<BK, D, LDH, THREADS>(sKV + (2 + buf) * TILE, vb + j0 * ld,
                                   ld, valid);
  };

  int t = next_live(sSt, 0, nkt);
  if (t < nkt) fetch(t, 0);
  cp_async_commit();
  int buf = 0;
  while (t < nkt) {
    const int tn = next_live(sSt, t + 1, nkt);
    if (tn < nkt) fetch(tn, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const bf16* k_s = sKV + buf * TILE;
    const bf16* v_s = sKV + (2 + buf) * TILE;
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
    mm_abt<BK / 8>(s, qw, k_s, lane);
    mm_abt<BK / 8>(dp, dow, v_s, lane);
    if (sSt[t] == 2)
      dq_tile<false>(acc, s, dp, k_s, sIv, lse2, dl, cs, row_base, t * BK,
                     Lk, lane);
    else
      dq_tile<true>(acc, s, dp, k_s, sIv, lse2, dl, cs, row_base, t * BK,
                    Lk, lane);
    __syncthreads();
    buf ^= 1;
    t = tn;
  }
  cp_async_wait<0>();

  const int r0 = q0 + row_base + g;
  store_scaled(dq + (long long)b * Lq * ld + n * D, ld, acc, r0, r0 + 8, Lq,
               scale, tg);
}

// =====================================================================
// backward: dk, dv
// =====================================================================

namespace bdkv {
constexpr int WARPS = 4;
constexpr int BN_K = 16 * WARPS;  // 64 keys per CTA, 16 a warp
constexpr int BQ = 32;            // queries per streamed tile
constexpr int THREADS = WARPS * 32;
constexpr int QTILE = BQ * LDH;
constexpr int NROW = 6;           // s1, e1, s2, e2, lse, delta
constexpr size_t SMEM = size_t(2 * BN_K * LDH + 4 * QTILE) * sizeof(bf16) +
                        2 * NROW * BQ * 4 + MAX_TILES;
}  // namespace bdkv

// one 32-query tile: p^T, ds^T, then dv += bf16(p^T) . dO and
// dk += bf16(ds^T) . Q
template <bool MASKED>
__device__ __forceinline__ void dkv_tile(float (&dk)[D / 8][4],
                                         float (&dv)[D / 8][4],
                                         const float (&s)[bdkv::BQ / 8][4],
                                         const float (&dp)[bdkv::BQ / 8][4],
                                         const bf16* q_s, const bf16* do_s,
                                         const int* sRow, float cs,
                                         int key0, int q0, int Lq, int Lk,
                                         int lane) {
  using namespace bdkv;
  const int g = lane / 4, tg = lane % 4;
  const float* lse_s = reinterpret_cast<const float*>(sRow + 4 * BQ);
  const float* dl_s = reinterpret_cast<const float*>(sRow + 5 * BQ);
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk) {
    uint32_t pa[4], da[4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int nt = 2 * kk + hh;
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * tg + (e & 1);  // query within the tile
        float x = fast_exp2(fmaf(s[nt][e], cs, -lse_s[c] * LOG2E));
        if (MASKED) {
          const int j = key0 + g + 8 * (e >> 1);
          if (!(q0 + c < Lq && j < Lk &&
                visible(j, sRow[c], sRow[BQ + c], sRow[2 * BQ + c],
                        sRow[3 * BQ + c])))
            x = 0.f;
        }
        p[e] = x;
        ds[e] = x * (dp[nt][e] - dl_s[c]);
      }
      pa[hh * 2 + 0] = pack_bf16(p[0], p[1]);
      pa[hh * 2 + 1] = pack_bf16(p[2], p[3]);
      da[hh * 2 + 0] = pack_bf16(ds[0], ds[1]);
      da[hh * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    mm_ab(dv, pa, do_s, kk * 16, lane);
    mm_ab(dk, da, q_s, kk * 16, lane);
  }
}

__global__ void __launch_bounds__(bdkv::THREADS, 2)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, const int* __restrict__ iv,
                     const unsigned char* __restrict__ states, int N,
                     int Lq, int Lk, int Lq_pad, float scale) {
  using namespace bdkv;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BN_K * LDH;
  bf16* sQ = sV + BN_K * LDH;     // [Q0 | Q1]
  bf16* sDO = sQ + 2 * QTILE;     // [dO0 | dO1]
  int* sRow = reinterpret_cast<int*>(sDO + 2 * QTILE);  // [2][NROW][BQ]
  unsigned char* sSt = reinterpret_cast<unsigned char*>(sRow + 2 * NROW * BQ);

  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  const int k0 = blockIdx.x * BN_K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const long long ld = (long long)N * D;
  const int nqt = (Lq + BQ - 1) / BQ;
  const long long koff = ((long long)b * Lk + k0) * ld + n * D;

  load_rows<BN_K, D, LDH, THREADS>(sK, k + koff, ld, min(BN_K, Lk - k0));
  load_rows<BN_K, D, LDH, THREADS>(sV, v + koff, ld, min(BN_K, Lk - k0));
  cp_async_commit();
  load_states<THREADS>(sSt, states + (long long)blockIdx.x * nqt, nqt);
  __syncthreads();

  const float cs = scale * LOG2E;
  const bf16* kw = sK + warp * 16 * LDH;
  const bf16* vw = sV + warp * 16 * LDH;
  const bf16* qb = q + (long long)b * Lq * ld + n * D;
  const bf16* dob = dout + (long long)b * Lq * ld + n * D;

  float dkacc[D / 8][4], dvacc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dkacc[i][0] = dkacc[i][1] = dkacc[i][2] = dkacc[i][3] = 0.f;
    dvacc[i][0] = dvacc[i][1] = dvacc[i][2] = dvacc[i][3] = 0.f;
  }

  auto fetch = [&](int t, int buf) {
    const int q0 = t * BQ;
    const int valid = min(BQ, Lq - q0);
    load_rows<BQ, D, LDH, THREADS>(sQ + buf * QTILE, qb + q0 * ld, ld,
                                   valid);
    load_rows<BQ, D, LDH, THREADS>(sDO + buf * QTILE, dob + q0 * ld, ld,
                                   valid);
    // the tile's row scalars: 6 arrays of 32 values, 8 x 16 bytes each
    if (threadIdx.x < NROW * BQ / 4) {
      const int a = threadIdx.x / (BQ / 4), c = (threadIdx.x % (BQ / 4)) * 4;
      const void* src =
          a < 4 ? static_cast<const void*>(iv + a * Lq_pad + q0 + c)
          : a == 4 ? static_cast<const void*>(lse + (long long)bn * Lq_pad +
                                              q0 + c)
                   : static_cast<const void*>(delta + (long long)bn * Lq_pad +
                                              q0 + c);
      cp_async16(sRow + (buf * NROW + a) * BQ + c, src, 16);
    }
  };

  int t = next_live(sSt, 0, nqt);
  if (t < nqt) fetch(t, 0);
  cp_async_commit();
  int buf = 0;
  while (t < nqt) {
    const int tn = next_live(sSt, t + 1, nqt);
    if (tn < nqt) fetch(tn, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const bf16* q_s = sQ + buf * QTILE;
    const bf16* do_s = sDO + buf * QTILE;
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
    mm_abt<BQ / 8>(s, kw, q_s, lane);    // s^T: keys x queries
    mm_abt<BQ / 8>(dp, vw, do_s, lane);  // dp^T
    const int* rows = sRow + buf * NROW * BQ;
    if (sSt[t] == 2)
      dkv_tile<false>(dkacc, dvacc, s, dp, q_s, do_s, rows, cs,
                      k0 + warp * 16, t * BQ, Lq, Lk, lane);
    else
      dkv_tile<true>(dkacc, dvacc, s, dp, q_s, do_s, rows, cs,
                     k0 + warp * 16, t * BQ, Lq, Lk, lane);
    __syncthreads();
    buf ^= 1;
    t = tn;
  }
  cp_async_wait<0>();

  const int r0 = k0 + warp * 16 + g;
  const long long obase = (long long)b * Lk * ld + n * D;
  store_scaled(dk + obase, ld, dkacc, r0, r0 + 8, Lk, scale, tg);
  store_scaled(dv + obase, ld, dvacc, r0, r0 + 8, Lk, 1.f, tg);
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool shapes_ok(int B, int N, int Lq, int Lk, int Lq_pad) {
  return B > 0 && N > 0 && Lq > 0 && Lk > 0 && Lq_pad % ROWS_PAD == 0 &&
         Lq_pad >= Lq && (Lk + BK - 1) / BK <= MAX_TILES &&
         (Lq + bdkv::BQ - 1) / bdkv::BQ <= MAX_TILES;
}

}  // namespace

// All launchers run on `stream` and return the CUDA error code (0 on
// success; cudaErrorInvalidValue for shapes the kernels do not take).
// iv: [4, Lq_pad] int32 (s1, e1, s2, e2); lse, delta: [B*N, Lq_pad] fp32;
// states: the tile-state tables (uint8), [Lq_pad / 128, ceil(Lk / 64)] for
// flash_fwd and flash_bwd_dq, [ceil(Lk / 64), ceil(Lq / 32)] for
// flash_bwd_dkv.

// mode: 0 free, 1 bounded (m0 points at one float), 2 online; scale is
// the scores' (unused in free mode).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                const void* m0, void* out, void* lse,
                                const void* iv, const void* states, int B,
                                int N, int Lq, int Lk, int Lq_pad, int mode,
                                float scale, void* stream) {
  if (!shapes_ok(B, N, Lq, Lk, Lq_pad) || mode < FREE || mode > ONLINE ||
      (mode == BOUNDED && m0 == nullptr))
    return (int)cudaErrorInvalidValue;
  auto kernel = mode == FREE      ? flash_fwd_kernel<FREE>
                : mode == BOUNDED ? flash_fwd_kernel<BOUNDED>
                                  : flash_fwd_kernel<ONLINE>;
  int err = set_smem(kernel, fwd::SMEM);
  if (err) return err;
  dim3 grid((Lq + fwd::BM - 1) / fwd::BM, B * N);
  kernel<<<grid, fwd::THREADS, fwd::SMEM, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)m0,
      (bf16*)out, (float*)lse, (const int*)iv, (const unsigned char*)states,
      N, Lq, Lk, Lq_pad, scale);
  return (int)cudaGetLastError();
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, const void* iv,
                                   const void* states, int B, int N, int Lq,
                                   int Lk, int Lq_pad, float scale,
                                   void* stream) {
  if (!shapes_ok(B, N, Lq, Lk, Lq_pad)) return (int)cudaErrorInvalidValue;
  int err = set_smem(flash_bwd_dq_kernel, bdq::SMEM);
  if (err) return err;
  dim3 grid((Lq + bdq::BM - 1) / bdq::BM, B * N);
  flash_bwd_dq_kernel<<<grid, bdq::THREADS, bdq::SMEM,
                        (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, (const int*)iv,
      (const unsigned char*)states, N, Lq, Lk, Lq_pad, scale);
  return (int)cudaGetLastError();
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, const void* iv,
                                    const void* states, int B, int N, int Lq,
                                    int Lk, int Lq_pad, float scale,
                                    void* stream) {
  if (!shapes_ok(B, N, Lq, Lk, Lq_pad)) return (int)cudaErrorInvalidValue;
  int err = set_smem(flash_bwd_dkv_kernel, bdkv::SMEM);
  if (err) return err;
  dim3 grid((Lk + bdkv::BN_K - 1) / bdkv::BN_K, B * N);
  flash_bwd_dkv_kernel<<<grid, bdkv::THREADS, bdkv::SMEM,
                         (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv,
      (const int*)iv, (const unsigned char*)states, N, Lq, Lk, Lq_pad,
      scale);
  return (int)cudaGetLastError();
}
