// decode_fresh: decode self-attention of one block's queries onto a
// read-only KV cache window plus the block's own fresh (not yet cached)
// K/V, in one of four softmax modes.
//
// Replaces the TPU kernel _decode_fresh_kernel in its bf16 modes
// (self_forcing_tpu/ops/pallas_attention.py, called through
// decode_attention_fresh_pallas): 'free' and 'free_noclamp'
// (softmax='free' / 'free_noclamp'), 'bounded' (fixed_m0) and online
// (neither).  decode_window_launch replaces _decode_kernel (through
// decode_attention_pallas): the online mode with no fresh keys and the
// window bounds read on the device (bf16), and a float32 kernel of its
// own (3xTF32 products; see decode_window_f32_kernel).
//
// Function, per (batch b, head n, query row i):
//   visible cache columns j: j < cache_lim and
//       (j < sink_end or kv_start <= j < kv_end)
//   every fresh column is visible
//   s = q_i . k_j (fp32)
//   FREE:         p = exp2(min(scale * s, 80))   (the caller folded
//                 head_dim**-0.5 * log2(e) into q; no running max:
//                 qk-normed scores stay far inside exp2's range)
//   FREE_NOCLAMP: p = exp2(scale * s)
//   BOUNDED:      p = exp(scale * s - m0), m0 >= every score (the
//                 caller's Cauchy-Schwarz bound, read from device memory)
//   ONLINE:       p = exp(scale * s - m), m the running row max over the
//                 64-key tiles seen so far; l and acc are rescaled by
//                 exp(m_prev - m) when it grows
//   l = sum p (fp32),  acc = sum bf16(p) * v_j (fp32)
//   out_i = acc / max(l, 1e-30)  -> bf16
// The exponentials run base 2 (ex2.approx): scale * log2(e) multiplies
// the scores of BOUNDED and ONLINE.  ONLINE rounds p to bf16 for P.V, as
// the other modes do (the Pallas kernel in interpret mode keeps it f32).
//
// Layouts: q, k_new, v_new and out are heads-packed [B, L, N*D]; the cache
// is one layer [B*N, S, D] of the stacked [layers, B*N, S, D] buffer (the
// wrapper passes the layer's base pointer).  D = 128.
//
// What bounds it on the H100: at the 1.3B shapes (Lq = Lf = 4680, up to
// 32760 visible keys, 12 heads) a call does up to ~0.9 TFLOP against
// ~0.2 GB of K/V, so it is bound by tensor-core operations.  Design
// (FlashAttention-2 shape on mma.sync): one CTA of 4 warps per
// (b*n, 128-query tile), each warp owning 32 query rows as two 16-row
// m-tiles, so every K/V fragment read from shared memory feeds two
// products.  K/V tiles of 64 keys stream through a double-buffered shared
// ring with cp.async, so the next tile's load overlaps this tile's math.
// Scores stay in registers: the m16n8k16 accumulator layout of two
// adjacent key tiles is exactly the A-operand layout of the P.V product,
// so p goes from exp2 to bf16 to the tensor cores without touching shared
// memory.  The free and bounded modes need no running max, so their
// output accumulators are never rescaled; ONLINE pays a row max (two
// shuffles) and a rescale of its 64 accumulators a tile.  Tiles wholly
// outside the visible window are never loaded.  Not yet: wgmma, TMA,
// warp specialisation.

#include "attention_common.cuh"

using namespace sf_attn;

namespace {

constexpr int D = 128;        // head dim
constexpr int MT = 2;         // 16-row m-tiles per warp
constexpr int WARPS = 4;      // each warp owns 16 * MT query rows
constexpr int BM = 16 * MT * WARPS;  // query rows per CTA
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = WARPS * 32;
constexpr int LDH = D + 8;    // padded bf16 row stride: ldmatrix rows hit
                              // distinct banks
constexpr int TILE = BK * LDH;  // elements of one K or V tile
constexpr size_t SMEM_BYTES = size_t(BM * LDH + 4 * TILE) * sizeof(bf16);
constexpr float LOG2E = 1.4426950408889634f;

enum Mode { FREE = 0, FREE_NOCLAMP = 1, BOUNDED = 2, ONLINE = 3 };

__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int valid) {
  load_rows<BK, D, LDH, THREADS>(dst, src, stride, valid);
}

// WINDOW: the cache window alone (decode_window_launch): kv_start / kv_end
// are read from device memory (`bounds`, clamped to [0, S]), no sink, no
// fresh tiles, and the fresh operands are never read.
template <int MODE, bool WINDOW>
__global__ void __launch_bounds__(THREADS, 2)
decode_fresh_kernel(const bf16* __restrict__ q,
                    const bf16* __restrict__ k_cache,
                    const bf16* __restrict__ v_cache,
                    const bf16* __restrict__ k_new,
                    const bf16* __restrict__ v_new,
                    const float* __restrict__ m0, bf16* __restrict__ out,
                    int N, int Lq, int Lf, int S, int kv_start, int kv_end,
                    int sink_end, int cache_lim, float scale,
                    const int* __restrict__ bounds) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  if (WINDOW) {
    kv_start = max(__ldg(bounds), 0);
    kv_end = min(__ldg(bounds + 1), S);
    sink_end = 0;
    cache_lim = S;
    Lf = 0;
  }
  // [Q | K0 | K1 | V0 | V1]
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sKV = sQ + BM * LDH;

  const int bn = blockIdx.y;
  const int b = bn / N;
  const int n = bn % N;
  const int q0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // accumulator row within the warp's 16
  const int tg = lane % 4;  // accumulator column pair
  const long long ld_tok = (long long)N * D;  // packed token row stride

  const bf16* kcb = k_cache + (long long)bn * S * D;
  const bf16* vcb = v_cache + (long long)bn * S * D;
  const bf16* knb =
      WINDOW ? k_new : k_new + (long long)b * Lf * ld_tok + n * D;
  const bf16* vnb =
      WINDOW ? v_new : v_new + (long long)b * Lf * ld_tok + n * D;

  // Q tile stays in shared memory; each warp reads its 16 * MT rows
  load_rows<BM, D, LDH, THREADS>(
      sQ, q + ((long long)b * Lq + q0) * ld_tok + n * D, ld_tok,
      min(BM, Lq - q0));
  cp_async_commit();
  const bf16* qw = sQ + warp * 16 * MT * LDH;

  float o[MT][D / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      o[mt][i][0] = o[mt][i][1] = o[mt][i][2] = o[mt][i][3] = 0.f;
  float l[MT][2];  // partial row sums of rows g and g + 8 of each m-tile
  float m[MT][2];  // ONLINE: running max (base 2) of rows g and g + 8
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    l[mt][0] = l[mt][1] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
  }
  // the scores' multiplier into base-2 units, and BOUNDED's offset
  const float mul = (MODE == BOUNDED || MODE == ONLINE) ? scale * LOG2E
                                                        : scale;
  const float off = MODE == BOUNDED ? __ldg(m0) * LOG2E : 0.f;

  const int n_cache = (cache_lim + BK - 1) / BK;
  const int n_total = n_cache + (Lf + BK - 1) / BK;

  auto fetch = [&](int t, int buf) {
    if (t < n_cache) {
      const int j0 = t * BK;
      const int valid = min(BK, cache_lim - j0);
      load_tile(sKV + buf * TILE, kcb + (long long)j0 * D, D, valid);
      load_tile(sKV + (2 + buf) * TILE, vcb + (long long)j0 * D, D, valid);
    } else if (!WINDOW) {
      const int j0 = (t - n_cache) * BK;
      const int valid = min(BK, Lf - j0);
      load_tile(sKV + buf * TILE, knb + (long long)j0 * ld_tok, ld_tok,
                valid);
      load_tile(sKV + (2 + buf) * TILE, vnb + (long long)j0 * ld_tok, ld_tok,
                valid);
    }
  };

  int t = next_live<BK>(0, n_cache, n_total, kv_start, kv_end, sink_end);
  if (t < n_total) fetch(t, 0);
  cp_async_commit();
  int buf = 0;
  while (t < n_total) {
    const int tn =
        next_live<BK>(t + 1, n_cache, n_total, kv_start, kv_end, sink_end);
    if (tn < n_total) fetch(tn, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // Q and tile t have landed
    __syncthreads();

    const bf16* k_s = sKV + buf * TILE;
    const bf16* v_s = sKV + (2 + buf) * TILE;

    // s = q . k^T for this warp's 16 * MT rows x 64 keys; each K fragment
    // serves all MT m-tiles
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
        uint32_t kb[4];
        const int key = np * 16 + (lane % 8) + (lane / 16) * 8;
        ldmatrix_x4(kb, k_s + key * LDH + kk * 16 + ((lane / 8) % 2) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(s[mt][2 * np], a[mt], kb[0], kb[1]);
          mma16816(s[mt][2 * np + 1], a[mt], kb[2], kb[3]);
        }
      }
    }

    // the scores in base-2 units, -inf on columns that are not visible
    const bool is_cache = t < n_cache;
    const int j0 = is_cache ? t * BK : (t - n_cache) * BK;
    const int valid = is_cache ? min(BK, cache_lim - j0) : min(BK, Lf - j0);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nt * 8 + 2 * tg + e;
        const int j = j0 + col;
        const bool vis = col < valid && (!is_cache || j < sink_end ||
                                         (j >= kv_start && j < kv_end));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          s[mt][nt][e] = vis ? s[mt][nt][e] * mul : -INFINITY;
          s[mt][nt][e + 2] = vis ? s[mt][nt][e + 2] * mul : -INFINITY;
        }
      }
    // ONLINE: the new row max, and the rescale of l and acc to it
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

    // per 16-key step: p from the base-2 scores, packed to bf16 A
    // fragments, then acc += bf16(p) . v
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int nt = 2 * kk + h;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = s[mt][nt][e];
            // exp2(-inf) = 0 on the columns that are not visible
            p[e] = MODE == FREE ? fast_exp2(fminf(x, 80.f))
                                : fast_exp2(x - sub[mt][e >> 1]);
          }
          l[mt][0] += p[0] + p[1];
          l[mt][1] += p[2] + p[3];
          // accumulator layout of n-tiles 2kk, 2kk+1 == A layout of step kk
          pa[mt][h * 2 + 0] = pack_bf16(p[0], p[1]);
          pa[mt][h * 2 + 1] = pack_bf16(p[2], p[3]);
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
    __syncthreads();  // every warp is done with this buffer
    buf ^= 1;
    t = tn;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float l0 = l[mt][0], l1 = l[mt][1];
    // row sums over the 4 threads that share a row
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const int r0 = q0 + warp * 16 * MT + mt * 16 + g;
    store_rows<D>(out + (long long)b * Lq * ld_tok + n * D, ld_tok, o[mt],
                  r0, r0 + 8, Lq, fmaxf(l0, 1e-30f), fmaxf(l1, 1e-30f), tg);
  }
}

template <int MODE, bool WINDOW>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* k_new, const void* v_new, const void* m0, void* out,
           int B, int N, int Lq, int Lf, int S, int kv_start, int kv_end,
           int sink_end, int cache_lim, float scale, const int* bounds,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decode_fresh_kernel<MODE, WINDOW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (Lq <= 0 || B * N <= 0) return 0;
  dim3 grid((Lq + BM - 1) / BM, B * N);
  decode_fresh_kernel<MODE, WINDOW><<<grid, THREADS, SMEM_BYTES, stream>>>(
      (const bf16*)q, (const bf16*)k_cache, (const bf16*)v_cache,
      (const bf16*)k_new, (const bf16*)v_new, (const float*)m0, (bf16*)out,
      N, Lq, Lf, S, kv_start, kv_end, sink_end, cache_lim, scale, bounds);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// decode_window_f32: the cache-window attention in float32 (the TPU
// kernel's f32 mode).  Products in 3xTF32: each f32 operand x is split
// into big = tf32(x) and small = tf32(x - big), and a . b is summed as
// small_a * big_b + big_a * small_b + big_a * big_b in f32 on
// mma.sync.m16n8k8 (the dropped small * small term and the residual of the
// split are ~2^-22 of |a||b|: float32 accuracy at 3x the TF32 work).  The
// tensor cores' f32 accumulation truncates, and its error grows with the
// running sum, so each k-step's (QK^T) or key tile's (P.V) products go to
// a zeroed accumulator that is added to the running sum with one rounded
// f32 add (one running accumulator over 28080 keys read 2e-4 off).
// CTA: 4 warps of 16 query rows; K / V tiles of 32 keys double-buffered;
// the online softmax in base e (expf) on the accumulator layout; p goes
// through a per-warp shared tile to become the A operand of P.V.
// ---------------------------------------------------------------------

constexpr int WF_BM = 64, WF_BK = 32, WF_THREADS = 128;
constexpr int LDQ = D + 4;       // A (g, t) reads of Q / B reads of K:
constexpr int LDV = D + 8;       // conflict-free; B (t, g) reads of V
constexpr int LDP = WF_BK + 4;   // the per-warp P tile
constexpr size_t WF_SMEM = sizeof(float) * (size_t)(
    WF_BM * LDQ + 2 * WF_BK * LDQ + 2 * WF_BK * LDV + 4 * 16 * LDP);

// c += a . b in 3xTF32 from the four f32 A values and two f32 B values
__device__ __forceinline__ void mma_3xtf32(float* c, const float* a,
                                           const float* b) {
  uint32_t ab[4], as[4], bb[2], bs[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ab[i], as[i]);
#pragma unroll
  for (int i = 0; i < 2; ++i) split_tf32(b[i], bb[i], bs[i]);
  mma_tf32(c, as, bb);
  mma_tf32(c, ab, bs);
  mma_tf32(c, ab, bb);
}

template <int ROWS, int LD>
__device__ __forceinline__ void load_f32_rows(float* dst, const float* src,
                                              long long stride, int valid) {
  for (int i = threadIdx.x; i < ROWS * (D / 4); i += WF_THREADS) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const bool ok = r < valid;
    cp_async16(dst + r * LD + c, ok ? src + r * stride + c : src,
               ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(WF_THREADS, 2)
decode_window_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k_cache,
                         const float* __restrict__ v_cache,
                         float* __restrict__ out, int N, int Lq, int S,
                         float scale, const int* __restrict__ bounds) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + WF_BM * LDQ;          // 2 buffers of WF_BK x LDQ
  float* sV = sK + 2 * WF_BK * LDQ;      // 2 buffers of WF_BK x LDV
  float* sP = sV + 2 * WF_BK * LDV;      // 4 warps x 16 x LDP
  const int kv_start = max(__ldg(bounds), 0);
  const int kv_end = min(__ldg(bounds + 1), S);
  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  const int q0 = blockIdx.x * WF_BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const long long ld_tok = (long long)N * D;
  const float* kcb = k_cache + (long long)bn * S * D;
  const float* vcb = v_cache + (long long)bn * S * D;
  float* pw = sP + warp * 16 * LDP;

  load_f32_rows<WF_BM, LDQ>(sQ, q + ((long long)b * Lq + q0) * ld_tok + n * D,
                            ld_tok, min(WF_BM, Lq - q0));
  cp_async_commit();
  const float* qw = sQ + warp * 16 * LDQ;

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float l[2] = {0.f, 0.f}, m[2] = {-INFINITY, -INFINITY};

  const int n_tiles = (S + WF_BK - 1) / WF_BK;
  auto fetch = [&](int t, int buf) {
    const int j0 = t * WF_BK, valid = min(WF_BK, S - j0);
    load_f32_rows<WF_BK, LDQ>(sK + buf * WF_BK * LDQ, kcb + (long long)j0 * D,
                              D, valid);
    load_f32_rows<WF_BK, LDV>(sV + buf * WF_BK * LDV, vcb + (long long)j0 * D,
                              D, valid);
  };
  int t = next_live<WF_BK>(0, n_tiles, n_tiles, kv_start, kv_end, 0);
  if (t < n_tiles) fetch(t, 0);
  cp_async_commit();
  int buf = 0;
  while (t < n_tiles) {
    const int tn = next_live<WF_BK>(t + 1, n_tiles, n_tiles, kv_start,
                                    kv_end, 0);
    if (tn < n_tiles) fetch(tn, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* k_s = sK + buf * WF_BK * LDQ;
    const float* v_s = sV + buf * WF_BK * LDV;

    float s[WF_BK / 8][4];
#pragma unroll
    for (int i = 0; i < WF_BK / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D / 8; ++kk) {
      const int c = kk * 8 + t4;
      const float a[4] = {qw[g * LDQ + c], qw[(g + 8) * LDQ + c],
                          qw[g * LDQ + c + 4], qw[(g + 8) * LDQ + c + 4]};
#pragma unroll
      for (int nt = 0; nt < WF_BK / 8; ++nt) {
        const float* kr = k_s + (nt * 8 + g) * LDQ + c;
        const float bv[2] = {kr[0], kr[4]};
        float t[4] = {0.f, 0.f, 0.f, 0.f};
        mma_3xtf32(t, a, bv);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] += t[e];
      }
    }
    // visibility, the new row maxima, the rescale of l and o
    const int j0 = t * WF_BK;
#pragma unroll
    for (int nt = 0; nt < WF_BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + nt * 8 + 2 * t4 + (e & 1);
        const bool vis = j < S && j >= kv_start && j < kv_end;
        s[nt][e] = vis ? s[nt][e] * scale : -INFINITY;
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < WF_BK / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * hr], s[nt][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[hr] - m_use);
      l[hr] *= corr;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[i][2 * hr] *= corr;
        o[i][2 * hr + 1] *= corr;
      }
      m[hr] = m_new;
#pragma unroll
      for (int nt = 0; nt < WF_BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(s[nt][2 * hr + e] - m_use);
          l[hr] += p;
          pw[(g + 8 * hr) * LDP + nt * 8 + 2 * t4 + e] = p;
        }
    }
    __syncwarp();
    // o += P . V: the tile's product in its own accumulator, then one
    // round-to-nearest add into o
    float pa[WF_BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < WF_BK / 8; ++kk) {
      const int c = kk * 8 + t4;
      pa[kk][0] = pw[g * LDP + c];
      pa[kk][1] = pw[(g + 8) * LDP + c];
      pa[kk][2] = pw[g * LDP + c + 4];
      pa[kk][3] = pw[(g + 8) * LDP + c + 4];
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < WF_BK / 8; ++kk) {
        const int c = kk * 8 + t4;
        const float bv[2] = {v_s[c * LDV + dt * 8 + g],
                             v_s[(c + 4) * LDV + dt * 8 + g]};
        mma_3xtf32(acc, pa[kk], bv);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] += acc[e];
    }
    __syncthreads();  // every warp is done with this buffer and its P
    buf ^= 1;
    t = tn;
  }
  cp_async_wait<0>();

  float l0 = l[0], l1 = l[1];
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  float* ob = out + (long long)b * Lq * ld_tok + n * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t4;
    if (r0 < Lq)
      *reinterpret_cast<float2*>(ob + r0 * ld_tok + col) =
          make_float2(o[dt][0] / d0, o[dt][1] / d0);
    if (r1 < Lq)
      *reinterpret_cast<float2*>(ob + r1 * ld_tok + col) =
          make_float2(o[dt][2] / d1, o[dt][3] / d1);
  }
}

}  // namespace

// Launch on `stream`.  k_cache / v_cache point at the chosen layer
// [B*N, S, D]; cache_lim = min(S, static_hi, max(sink_end, kv_end)) bounds
// the cache tiles visited; mode is one of Mode; m0 points at one float
// (BOUNDED only; may be null otherwise).  Returns the CUDA error code (0
// on success; cudaErrorInvalidValue for an unknown mode).
extern "C" int decode_fresh_launch(const void* q, const void* k_cache,
                                   const void* v_cache, const void* k_new,
                                   const void* v_new, const void* m0,
                                   void* out, int B, int N, int Lq, int Lf,
                                   int S, int kv_start, int kv_end,
                                   int sink_end, int cache_lim, int mode,
                                   float scale, void* stream) {
  auto st = (cudaStream_t)stream;
#define SF_ARGS q, k_cache, v_cache, k_new, v_new, m0, out, B, N, Lq, Lf, S, \
    kv_start, kv_end, sink_end, cache_lim, scale, nullptr, st
  switch (mode) {
    case FREE: return launch<FREE, false>(SF_ARGS);
    case FREE_NOCLAMP: return launch<FREE_NOCLAMP, false>(SF_ARGS);
    case BOUNDED:
      if (m0 == nullptr) return (int)cudaErrorInvalidValue;
      return launch<BOUNDED, false>(SF_ARGS);
    case ONLINE: return launch<ONLINE, false>(SF_ARGS);
  }
#undef SF_ARGS
  return (int)cudaErrorInvalidValue;
}

// The cache-window attention of decode_attention (the TPU kernel
// _decode_kernel): every query of q [B, Lq, N*D] (heads-packed; the folded
// [B*N, Lq, D] layout is N = 1) attends the keys [lo, hi) of one layer's
// cache [B*N, S, D], lo / hi the two int32 at `bounds` on the device (an
// empty window gives 0), online softmax at `scale`; out like q.  bf16
// (f32 = 0: the online mode of decode_fresh_kernel with no fresh tiles,
// p rounded to bf16 for P.V) or float32 (f32 = 1: 3xTF32 products).
extern "C" int decode_window_launch(const void* q, const void* k_cache,
                                    const void* v_cache, const void* bounds,
                                    void* out, int B, int N, int Lq, int S,
                                    float scale, int f32, void* stream) {
  if (bounds == nullptr || S <= 0) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  if (!f32)
    return launch<ONLINE, true>(q, k_cache, v_cache, nullptr, nullptr,
                                nullptr, out, B, N, Lq, 0, S, 0, 0, 0, S,
                                scale, (const int*)bounds, st);
  cudaError_t err = cudaFuncSetAttribute(
      decode_window_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)WF_SMEM);
  if (err != cudaSuccess) return (int)err;
  if (Lq <= 0 || B * N <= 0) return 0;
  dim3 grid((Lq + WF_BM - 1) / WF_BM, B * N);
  decode_window_f32_kernel<<<grid, WF_THREADS, WF_SMEM, st>>>(
      (const float*)q, (const float*)k_cache, (const float*)v_cache,
      (float*)out, N, Lq, S, scale, (const int*)bounds);
  return (int)cudaGetLastError();
}
