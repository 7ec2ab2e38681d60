// decode_fresh_int8qk: decode self-attention of one block's queries onto
// a read-only KV cache window plus the block's own fresh (not yet cached)
// K/V, with QK^T in int8 (per-tile scales), P.V in bf16 and the
// offset-free base-2 softmax.
//
// Replaces the TPU kernel _decode_fresh_int8_kernel in 'free_qk' mode
// (self_forcing_tpu/ops/pallas_attention.py, decode_attention_fresh_pallas
// with softmax='free', quant='int8qk'):
//   int8qk_quantize_launch <- its tile quantization (_quantize_q_tile,
//                             _quantize_cache_tile, _quantize_fresh_tile)
//   int8qk_attend_launch   <- its free_qk _accumulate and _finalize
//
// Function.  The scales are per Pallas tile, so the tiles are the Pallas
// kernel's (tq query rows, tk cache rows, tf fresh rows; see
// ops/attention.py::decode_tiles):
//   q scale, per (b, head, q tile):  qs = max(max|q|, 1e-8) / 127
//   k scale, per (b*head, cache tile meeting the window, or fresh tile):
//       ks = max(max|k| / 127, 1e-8), the max over ALL rows of the tile
//       (rows the mask hides count too; rows past the length count as 0)
//   q8 = rint(q / qs), k8 = rint(k / ks)   (true division, half to even)
//   s = float(q8 . k8) * (qs * ks)  [* scale when scale != 1]; -inf where
//       masked: cache column j is visible iff j < cache_lim and
//       (j < sink_end or kv_start <= j < kv_end); every fresh column is
//   p = exp2(min(s, 80)); l = sum p (f32); acc = sum bf16(p) * v (f32,
//   V as stored in bf16, not quantized); out = acc / max(l, 1e-30) -> bf16
//
// Layouts: q, k_new, v_new and out are heads-packed [B, L, N*D]; the cache
// is one layer [B*N, S, D] of the stacked buffer.  The pre-pass writes
// int8 q, cache K and fresh K folded [B*N, tiles * tile, D] (zero rows
// past each length; the rows of a cache tile outside the window are not
// written and its scale is 0) and f32 scales [B*N, tiles].  D = 128.
//
// What bounds it on the H100: at the Wan-1.3B shapes (4680 queries, up to
// 32760 keys, 12 heads) the attention does ~0.47 T int8 operations for
// QK^T and ~0.47 T bf16 FLOP for P.V against ~0.2 GB of K/V, so it is
// bound by tensor-core operations (0.71 ms at 1979 TOP/s int8 plus 989
// TFLOP/s bf16).  The pre-pass moves ~0.2 GB and is bound by memory.
// Design, simple first: the pre-pass is one CTA of 1024 threads per
// (b*head, tile), a max over the tile and then the quantization of the
// same rows, read again.  The attention has decode_fresh.cu's shape: one
// CTA of 4 warps per (b*head, 128 queries), two 16-row m-tiles a warp,
// 64-key tiles double-buffered with cp.async, tiles with no visible
// column skipped.
// QK^T runs mma.sync m16n8k32 s8 on the int8 K rows (k-contiguous already,
// as the B operand wants); its int32 accumulators have the m16n8k16
// layout, so the scores become bf16 P fragments of the P.V product in
// registers.  A 64-key tile meets at most two Pallas tiles (the wrapper
// takes tk, tf >= 64), so each row has two dequantization factors a tile,
// qs * ks of each.  The int32 scores become floats by an exact
// integer-add / float-subtract pair, off the quarter-rate I2F pipe that
// exp2 also uses.
// Not yet: wgmma, TMA, warp specialisation.

#include "attention_common.cuh"

using namespace sf_attn;

namespace {

typedef int8_t i8;

constexpr int D = 128;        // head dim
constexpr int MT = 2;         // 16-row m-tiles per warp
constexpr int WARPS = 4;      // each warp owns 16 * MT query rows
constexpr int BM = 16 * MT * WARPS;  // query rows per CTA
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = WARPS * 32;
constexpr int LDB = D + 16;   // int8 row stride in bytes: the 8 rows an
                              // ldmatrix reads hit distinct bank groups
constexpr int LDH = D + 8;    // bf16 row stride (elements)
constexpr int KT8 = BK * LDB;   // bytes of one int8 K tile
constexpr int VT = BK * LDH;    // elements of one bf16 V tile
constexpr size_t SMEM_BYTES = size_t(BM * LDB) + 2 * KT8 +
                              2 * VT * sizeof(bf16);

constexpr int QTHREADS = 1024;  // pre-pass CTA, 2 a SM: loads in flight
constexpr float FLOOR = 1e-8f;  // scale floor of q and k

// int8 rows of the attention's Q and K tiles
template <int ROWS>
__device__ __forceinline__ void load_rows8(unsigned char* dst, const i8* src,
                                           int valid) {
  load_bytes<ROWS, D, LDB, THREADS>(dst, src, D, valid);
}

// ---------------------------------------------------------------------
// pre-pass: per-tile scales and int8 q / K
// ---------------------------------------------------------------------

// One operand cut into tiles: matrix m = b * N + n starts at
// src + b * b_stride + n * n_stride (elements), rows of D bf16 at
// row_stride; `rows` real rows in `n_tiles` tiles of `tile` rows.
struct Seg {
  const bf16* src;
  long long b_stride, n_stride, row_stride;
  int rows, tile, n_tiles;
  i8* dst;       // [B*N, n_tiles * tile, D]
  float* scale;  // [B*N, n_tiles]
};


// One CTA per (matrix, tile) of q, then of the cache, then of k_new.
__global__ void __launch_bounds__(QTHREADS, 2)
int8qk_quantize_kernel(Seg sq, Seg skc, Seg skn, int BN, int N,
                       int kv_start, int kv_end, int sink_end) {
  __shared__ float red[QTHREADS / 32];
  int idx = blockIdx.x;
  const int nq = BN * sq.n_tiles, nc = BN * skc.n_tiles;
  Seg sg = sq;
  bool k_scale = true, cache = false;
  if (idx < nq) {
    k_scale = false;
  } else if (idx < nq + nc) {
    sg = skc;
    idx -= nq;
    cache = true;
  } else {
    sg = skn;
    idx -= nq + nc;
  }
  const int m = idx / sg.n_tiles, t = idx % sg.n_tiles;
  const int r0 = t * sg.tile;
  float* scale = sg.scale + (long long)m * sg.n_tiles + t;
  if (cache && !(r0 < sink_end || (r0 < kv_end && r0 + sg.tile > kv_start))) {
    if (threadIdx.x == 0) *scale = 0.f;  // never visited
    return;
  }
  const bf16* src = sg.src + (long long)(m / N) * sg.b_stride +
                    (long long)(m % N) * sg.n_stride;
  const int nrows = min(sg.tile, sg.rows - r0);
  constexpr int CH = D / 8;  // 16-byte chunks of a row

  float amax = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < nrows * CH; i += QTHREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const uint4 v = *reinterpret_cast<const uint4*>(
        src + (long long)(r0 + r) * sg.row_stride + c);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      amax = fmaxf(amax, fmaxf(fabsf(bf16_lo(w[j])), fabsf(bf16_hi(w[j]))));
  }
  amax = block_max<QTHREADS>(amax, red);
  // q: max(amax, floor) / 127; k: max(amax / 127, floor), as the TPU kernel
  const float s = k_scale ? fmaxf(__fdiv_rn(amax, 127.f), FLOOR)
                          : __fdiv_rn(fmaxf(amax, FLOOR), 127.f);
  if (threadIdx.x == 0) *scale = s;

  i8* dst = sg.dst + ((long long)m * sg.n_tiles * sg.tile + r0) * D;
#pragma unroll 4
  for (int i = threadIdx.x; i < sg.tile * CH; i += QTHREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    uint2 o = make_uint2(0u, 0u);
    if (r < nrows) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          src + (long long)(r0 + r) * sg.row_stride + c);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      int q[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        q[2 * j] = quant1(bf16_lo(w[j]), s);
        q[2 * j + 1] = quant1(bf16_hi(w[j]), s);
      }
      o = make_uint2(pack4(q[0], q[1], q[2], q[3]),
                     pack4(q[4], q[5], q[6], q[7]));
    }
    *reinterpret_cast<uint2*>(dst + (long long)r * D + c) = o;
  }
}

// ---------------------------------------------------------------------
// attention: int8 QK^T, bf16 P.V
// ---------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 2)
int8qk_attend_kernel(const i8* __restrict__ q8, const float* __restrict__ qs,
                     const i8* __restrict__ kc8,
                     const float* __restrict__ ksc,
                     const i8* __restrict__ kn8,
                     const float* __restrict__ ksf,
                     const bf16* __restrict__ v_cache,
                     const bf16* __restrict__ v_new, bf16* __restrict__ out,
                     int N, int Lq, int Lf, int S, int kv_start, int kv_end,
                     int sink_end, int cache_lim, int tq, int tk, int tf,
                     int qt, int ntc, int ntf, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // [Q8 | K8 0 | K8 1 | V 0 | V 1]
  unsigned char* sQ = smem_raw;
  unsigned char* sK = sQ + BM * LDB;
  bf16* sV = reinterpret_cast<bf16*>(sK + 2 * KT8);

  const int bn = blockIdx.y;
  const int b = bn / N;
  const int n = bn % N;
  const int q0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // accumulator row within the warp's 16
  const int tg = lane % 4;  // accumulator column pair
  const long long ld_tok = (long long)N * D;  // packed token row stride

  const i8* kcb = kc8 + (long long)bn * ntc * tk * D;
  const i8* knb = kn8 + (long long)bn * ntf * tf * D;
  const bf16* vcb = v_cache + (long long)bn * S * D;
  const bf16* vnb = v_new + (long long)b * Lf * ld_tok + n * D;
  const float* ksc_b = ksc + (long long)bn * ntc;
  const float* ksf_b = ksf + (long long)bn * ntf;

  // the int8 Q tile stays in shared memory; each warp reads its 16 * MT rows
  load_rows8<BM>(sQ, q8 + ((long long)bn * qt * tq + q0) * D,
                 min(BM, Lq - q0));
  cp_async_commit();
  const unsigned char* qw = sQ + warp * 16 * MT * LDB;

  // q scale of rows g and g + 8 of each m-tile (their Pallas q tile)
  float qsr[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = q0 + warp * 16 * MT + mt * 16 + g + 8 * h;
      qsr[mt][h] = r < Lq ? qs[(long long)bn * qt + r / tq] : 0.f;
    }

  float o[MT][D / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      o[mt][i][0] = o[mt][i][1] = o[mt][i][2] = o[mt][i][3] = 0.f;
  float l[MT][2];  // partial row sums of rows g and g + 8 of each m-tile
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) l[mt][0] = l[mt][1] = 0.f;

  const int n_cache = (cache_lim + BK - 1) / BK;
  const int n_total = n_cache + (Lf + BK - 1) / BK;

  // K8 and V rows of tile t
  auto fetch = [&](int t, int buf) {
    if (t < n_cache) {
      const int j0 = t * BK;
      const int valid = min(BK, cache_lim - j0);
      load_rows8<BK>(sK + buf * KT8, kcb + (long long)j0 * D, valid);
      load_rows<BK, D, LDH, THREADS>(sV + buf * VT, vcb + (long long)j0 * D,
                                     D, valid);
    } else {
      const int j0 = (t - n_cache) * BK;
      const int valid = min(BK, Lf - j0);
      load_rows8<BK>(sK + buf * KT8, knb + (long long)j0 * D, valid);
      load_rows<BK, D, LDH, THREADS>(sV + buf * VT,
                                     vnb + (long long)j0 * ld_tok, ld_tok,
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

    const unsigned char* k_s = sK + buf * KT8;
    const bf16* v_s = sV + buf * VT;

    // s = q8 . k8^T (int32) for this warp's 16 * MT rows x 64 keys; each
    // K fragment serves all MT m-tiles
    int s[MT][BK / 8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
        s[mt][i][0] = s[mt][i][1] = s[mt][i][2] = s[mt][i][3] = 0;
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int row = mt * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
        ldsm_x4(a[mt], qw + row * LDB + kk * 32 + (lane / 16) * 16);
      }
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t kb[4];
        const int key = np * 16 + (lane % 8) + (lane / 16) * 8;
        ldsm_x4(kb, k_s + key * LDB + kk * 32 + ((lane / 8) % 2) * 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_s8(s[mt][2 * np], a[mt], kb[0], kb[1]);
          mma_s8(s[mt][2 * np + 1], a[mt], kb[2], kb[3]);
        }
      }
    }

    // The tile's columns below `bnd` lie in Pallas tile kt0, the rest in
    // kt0 + 1 (tiles of T >= BK rows); a = qs * ks [* scale] of each row
    // for both.
    const bool is_cache = t < n_cache;
    const int j0 = is_cache ? t * BK : (t - n_cache) * BK;
    const int valid = is_cache ? min(BK, cache_lim - j0) : min(BK, Lf - j0);
    const int T = is_cache ? tk : tf;
    const float* sc = is_cache ? ksc_b : ksf_b;
    const int kt0 = j0 / T;
    const int bnd = (kt0 + 1) * T - j0;
    const float ks_lo = sc[kt0];
    const float ks_hi = bnd < valid ? sc[kt0 + 1] : ks_lo;
    float a_lo[MT][2], a_hi[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        a_lo[mt][hr] = qsr[mt][hr] * ks_lo;
        a_hi[mt][hr] = qsr[mt][hr] * ks_hi;
        if (scale != 1.f) {
          a_lo[mt][hr] *= scale;
          a_hi[mt][hr] *= scale;
        }
      }

    // per 16-key step: s = float(s32) * a, p = 2^min(s, 80) on visible
    // columns, packed to bf16 A fragments, then acc += bf16(p) . v
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int nt = 2 * kk + h;
        bool vis[2], lo[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = nt * 8 + 2 * tg + e;
          const int j = j0 + col;
          vis[e] = col < valid && (!is_cache || j < sink_end ||
                                   (j >= kv_start && j < kv_end));
          lo[e] = col < bnd;
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {  // rows g, g + 8
              const float a = lo[e] ? a_lo[mt][hr] : a_hi[mt][hr];
              p[e + 2 * hr] =
                  vis[e] ? fast_exp2(fminf(
                               int_to_float(s[mt][nt][e + 2 * hr]) * a, 80.f))
                         : 0.f;
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

int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// Quantize q, the cache tiles of layer `k_cache` ([B*N, S, D]) that meet
// the window [0, sink_end) + [kv_start, kv_end) below cache_lim, and
// k_new, each over its Pallas tiles (tq, tk, tf rows).  Launch on
// `stream`; returns the CUDA error code (0 on success).
extern "C" int int8qk_quantize_launch(const void* q, const void* k_cache,
                                      const void* k_new, void* q8, void* qs,
                                      void* kc8, void* ksc, void* kn8,
                                      void* ksf, int B, int N, int Lq, int Lf,
                                      int S, int kv_start, int kv_end,
                                      int sink_end, int cache_lim, int tq,
                                      int tk, int tf, void* stream) {
  const long long tok = (long long)N * D;
  const Seg sq{(const bf16*)q, (long long)Lq * tok, D, tok, Lq, tq,
               cdiv(Lq, tq), (i8*)q8, (float*)qs};
  const Seg skc{(const bf16*)k_cache, (long long)N * S * D, (long long)S * D,
                D, S, tk, cdiv(cache_lim, tk), (i8*)kc8, (float*)ksc};
  const Seg skn{(const bf16*)k_new, (long long)Lf * tok, D, tok, Lf, tf,
                cdiv(Lf, tf), (i8*)kn8, (float*)ksf};
  const int tiles = sq.n_tiles + skc.n_tiles + skn.n_tiles;
  if (B * N <= 0 || tiles <= 0) return 0;
  int8qk_quantize_kernel<<<B * N * tiles, QTHREADS, 0,
                           (cudaStream_t)stream>>>(sq, skc, skn, B * N, N,
                                                   kv_start, kv_end,
                                                   sink_end);
  return (int)cudaGetLastError();
}

// Attention of the pre-pass's int8 q onto its int8 K with the bf16 V of
// layer `v_cache` ([B*N, S, D]) and v_new; cache_lim = min(S, static_hi,
// max(sink_end, kv_end)) bounds the cache tiles visited.  Launch on
// `stream`; returns the CUDA error code (0 on success).
extern "C" int int8qk_attend_launch(const void* q8, const void* qs,
                                    const void* kc8, const void* ksc,
                                    const void* kn8, const void* ksf,
                                    const void* v_cache, const void* v_new,
                                    void* out, int B, int N, int Lq, int Lf,
                                    int S, int kv_start, int kv_end,
                                    int sink_end, int cache_lim, int tq,
                                    int tk, int tf, float scale,
                                    void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      int8qk_attend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (Lq <= 0 || B * N <= 0) return 0;
  dim3 grid((Lq + BM - 1) / BM, B * N);
  int8qk_attend_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const i8*)q8, (const float*)qs, (const i8*)kc8, (const float*)ksc,
      (const i8*)kn8, (const float*)ksf, (const bf16*)v_cache,
      (const bf16*)v_new, (bf16*)out, N, Lq, Lf, S, kv_start, kv_end,
      sink_end, cache_lim, tq, tk, tf, cdiv(Lq, tq), cdiv(cache_lim, tk),
      cdiv(Lf, tf), scale);
  return (int)cudaGetLastError();
}
