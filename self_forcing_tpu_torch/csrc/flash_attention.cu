// Masked flash attention for training: the forward (flash_fwd) in the
// offset-free base-2 softmax ('free'), the bounded-offset softmax
// ('bounded', fixed_m0) and the online softmax.  Its backward, which
// serves every mode, is csrc/flash_bwd.cu.
//
// Replaces the TPU kernel of self_forcing_tpu/ops/pallas_attention.py:
//   flash_fwd      <- _flash_kernel (free, bounded and online modes), via
//                     flash_attention_pallas -> _flash_fwd -> pallas_call
//
// Function.  q, k, v, out are [B, L, N, D] bf16 (token row stride N*D),
// D = 128.  Query row i sees key j iff j < Lk and
//   s1[i] <= j < e1[i]  or  s2[i] <= j < e2[i]
// (an IntervalMask; no mask is [0, Lk) for every row).
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
// The backward reads lse (base e) and recomputes p = exp(scale' * s -
// lse) at scale' = ln 2 in free mode, the forward's scale otherwise.
//
// Tiles.  The wrapper gives the kernel a table of tile states computed
// from the intervals (0 dead, 1 partial, 2 fully visible), as the Pallas
// wrapper's _tile_states does: dead tiles are never loaded, fully visible
// ones skip the per-element mask.  Per-row arrays (the four interval
// arrays, lse) are padded to Lq_pad, a multiple of 128.
//
// What bounds it on the H100: at the training shape (B 1, L 32760, 12
// heads) the forward does 4 L^2 D N = 6.6 TFLOP against ~0.3 GB of q, k, v
// and out: bound by tensor-core operations.  Design (FlashAttention-2 on
// mma.sync, each CTA loops over its own tiles and carries nothing to
// another CTA): one CTA of 4 warps per (b*n, 128-query tile), 32 query
// rows a warp as two m-tiles, 64-key K/V tiles double-buffered with
// cp.async; the scores stay in registers as P.V's A operand.
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

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool shapes_ok(int B, int N, int Lq, int Lk, int Lq_pad) {
  return B > 0 && N > 0 && Lq > 0 && Lk > 0 && Lq_pad % ROWS_PAD == 0 &&
         Lq_pad >= Lq && (Lk + BK - 1) / BK <= MAX_TILES;
}

}  // namespace

// The launcher runs on `stream` and returns the CUDA error code (0 on
// success; cudaErrorInvalidValue for shapes the kernel does not take).
// iv: [4, Lq_pad] int32 (s1, e1, s2, e2); lse: [B*N, Lq_pad] fp32;
// states: the tile-state table (uint8), [Lq_pad / 128, ceil(Lk / 64)].
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
