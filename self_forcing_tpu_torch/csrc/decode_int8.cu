// decode_fresh_int8: decode self-attention of one block's queries onto a
// read-only KV cache window plus the block's own fresh (not yet cached)
// K/V, with both products in int8: int8 QK^T and int8 P.V.
//
// Replaces the TPU kernel _decode_fresh_int8_kernel in its 'tile',
// 'global' and online modes (self_forcing_tpu/ops/pallas_attention.py,
// decode_attention_fresh_pallas with quant='int8': fixed_m0 with
// int8_bound 'tile' or 'global', or no bound):
//   int8_quantize_v_launch <- the V half of its tile quantization
//                             (_quantize_cache_tile, _quantize_fresh_tile;
//                             q and K come from decode_int8qk.cu's
//                             int8qk_quantize, the same function)
//   int8_attend_launch     <- its 'tile' / 'global' / online _accumulate
//                             and _finalize
//
// Function.  Every scale is per Pallas tile (tq query rows, tk cache rows,
// tf fresh rows; ops/attention.py::decode_tiles): q8, qs, k8, ks as in
// decode_int8qk.cu, and V alike: vs = max(max|v| / 127, 1e-8) over all
// rows of the tile, v8 = rint(v / vs).  Per row and Pallas tile (the
// cache tiles that the window meets, then the fresh tiles), with
//   s = float(q8 . k8) * (qs * (ks * scale)), masked columns excluded:
//   TILE:   m_t = the row's max in the tile, p = exp(s - (m_t - ln 127)),
//           w = exp(m_t - m0); l += sum(p) * w,
//           acc += float(round(p) . v8) * (vs * w)
//   GLOBAL: p = min(exp(s + ln 127 - m0), 127); l += sum(p),
//           acc += float(round(p) . v8) * vs
//   ONLINE: m = max(m, m_t) once a tile, l and acc scaled by
//           exp(m_prev - m), p = exp(s - (m - ln 127)), then as GLOBAL
//   out = acc / max(l, 1e-30) -> bf16.
// p lies in [0, 127] and round(p) is its int8; l sums the unrounded p,
// and the 127 cancels in acc / l.  m0 (TILE, GLOBAL) is the caller's bound
// on every score, read from device memory.
//
// The row maxima are the Pallas tile's, not a 64-key tile's: the kernel
// walks each Pallas tile in 64-key sub-tiles twice, first for the row max
// of its scores (TILE, ONLINE), then for p and P.V, so p quantizes against
// the same max as on the TPU.  Sub-tiles start at the Pallas tile's first
// key (tk = 1560 is not a multiple of 64) and the last is partial.  The
// int32 P.V sums of a Pallas tile convert to float once, as the TPU
// kernel's int32 dot does.
//
// P.V on mma.sync m16n8k32 s8 with P in registers: the int32 score
// accumulators of a row hold keys {2t, 2t+1, 8+2t, 9+2t} of each 16-key
// group in lane t, where the A fragment wants k slots 4t..4t+3.  So the
// pre-pass stores V^T (K-major, as the B operand wants: ldmatrix .trans
// takes only 16-bit elements) with the keys of every 16-key group in that
// order (slot k holds key 2(k/4) + k%2 + 8((k%4)/2)), and the product
// contracts each key with itself.  The V^T tiles are padded to 64 keys,
// so every sub-tile's rows start 16-byte aligned.
//
// Layouts: q8 [B*N, qt*tq, D], k8 [B*N, tiles*tile, D] (int8qk_quantize);
// V^T [B*N, tiles, D, tile padded to 64] int8; scales [B*N, tiles] f32 (a
// cache tile that the window does not meet: scale 0, never read); out
// heads-packed [B, Lq, N*D] bf16.  D = 128.
//
// What bounds it on the H100: at the Wan-1.3B shapes (4680 queries, up to
// 32760 keys, 12 heads) the attention does ~0.47 T int8 operations for
// each product (QK^T twice where the row max is needed) against ~0.1 GB
// of int8 K/V: bound by tensor-core operations (0.48 ms for the two
// products at 1979 TOP/s).  Design, simple first: one CTA of 4 warps per
// (b*head, 64 queries), one 16-row m-tile a warp (two would need 128 more
// registers for the int32 P.V accumulators), 64-key sub-tiles of int8 K
// and V^T double-buffered with cp.async, sub-tiles with no visible column
// skipped.  The pre-pass is one CTA of 1024 threads per (b*head, tile).
// Not yet: wgmma, TMA, warp specialisation, one pass for 'global'-like
// maxima.

#include "attention_common.cuh"

using namespace sf_attn;

namespace {

typedef int8_t i8;

constexpr int D = 128;        // head dim
constexpr int WARPS = 4;      // each warp owns 16 query rows
constexpr int BM = 16 * WARPS;  // query rows per CTA
constexpr int BK = 64;        // keys of a sub-tile
constexpr int THREADS = WARPS * 32;
constexpr int LDB = D + 16;   // int8 Q / K row stride in bytes
constexpr int LDV = BK + 16;  // int8 V^T row stride in bytes: the 8 rows an
                              // ldmatrix reads hit distinct banks
constexpr int KT8 = BK * LDB;   // bytes of one K sub-tile
constexpr int VT8 = D * LDV;    // bytes of one V^T sub-tile
constexpr size_t SMEM_BYTES = size_t(BM * LDB) + 2 * KT8 + 2 * VT8;
constexpr int VPAD = 64;        // V^T tiles are padded to this many keys

constexpr int QTHREADS = 1024;  // pre-pass CTA
constexpr float FLOOR = 1e-8f;  // scale floor
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN127 = 4.844187086458591f;  // ln(127)

enum Mode { TILE = 0, GLOBAL = 1, ONLINE = 2 };

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// slot k of a 16-key group of V^T holds key key_of_slot(k)
__device__ __forceinline__ int key_of_slot(int k) {
  return 2 * (k / 4) + (k % 2) + 8 * ((k % 4) / 2);
}

// ---------------------------------------------------------------------
// pre-pass: per-tile scales and K-major int8 V
// ---------------------------------------------------------------------

// V cut into tiles: matrix m = b * N + n starts at
// src + b * b_stride + n * n_stride (elements), rows of D bf16 at
// row_stride; `rows` real rows in `n_tiles` tiles of `tile` rows.
struct VSeg {
  const bf16* src;
  long long b_stride, n_stride, row_stride;
  int rows, tile, n_tiles, tpad;
  i8* dst;       // [B*N, n_tiles, D, tpad]
  float* scale;  // [B*N, n_tiles]
};

// One CTA per (matrix, tile) of the cache, then of v_new.
__global__ void __launch_bounds__(QTHREADS, 2)
int8_quantize_v_kernel(VSeg svc, VSeg svn, int BN, int N, int kv_start,
                       int kv_end, int sink_end) {
  __shared__ float red[QTHREADS / 32];
  int idx = blockIdx.x;
  const bool cache = idx < BN * svc.n_tiles;
  const VSeg sg = cache ? svc : svn;
  if (!cache) idx -= BN * svc.n_tiles;
  const int m = idx / sg.n_tiles, t = idx % sg.n_tiles;
  const int r0 = t * sg.tile;
  float* scale = sg.scale + (long long)m * sg.n_tiles + t;
  if (cache && !(r0 < sink_end || (r0 < kv_end && r0 + sg.tile > kv_start))) {
    if (threadIdx.x == 0) *scale = 0.f;  // never visited
    return;
  }
  const bf16* src = sg.src + (long long)(m / N) * sg.b_stride +
                    (long long)(m % N) * sg.n_stride +
                    (long long)r0 * sg.row_stride;
  const int nrows = min(sg.tile, sg.rows - r0);
  constexpr int CH = D / 8;  // 16-byte chunks of a row

  float amax = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < nrows * CH; i += QTHREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const uint4 v = *reinterpret_cast<const uint4*>(
        src + (long long)r * sg.row_stride + c);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      amax = fmaxf(amax, fmaxf(fabsf(bf16_lo(w[j])), fabsf(bf16_hi(w[j]))));
  }
  amax = block_max<QTHREADS>(amax, red);
  const float s = fmaxf(__fdiv_rn(amax, 127.f), FLOOR);  // as K's
  if (threadIdx.x == 0) *scale = s;

  // one 16-key group of one column d a step: 16 reads of consecutive d
  // across the warp, one 16-byte store
  i8* dst = sg.dst + ((long long)m * sg.n_tiles + t) * D * sg.tpad;
  for (int i = threadIdx.x; i < D * (sg.tpad / 16); i += QTHREADS) {
    const int d = i % D, grp = i / D;
    int q[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int key = grp * 16 + key_of_slot(k);
      q[k] = key < nrows
                 ? quant1(__bfloat162float(
                              src[(long long)key * sg.row_stride + d]),
                          s)
                 : 0;
    }
    *reinterpret_cast<uint4*>(dst + (long long)d * sg.tpad + grp * 16) =
        make_uint4(pack4(q[0], q[1], q[2], q[3]),
                   pack4(q[4], q[5], q[6], q[7]),
                   pack4(q[8], q[9], q[10], q[11]),
                   pack4(q[12], q[13], q[14], q[15]));
  }
}

// ---------------------------------------------------------------------
// attention: int8 QK^T, int8 P.V
// ---------------------------------------------------------------------

template <int MODE>
__global__ void __launch_bounds__(THREADS, 2)
int8_attend_kernel(const i8* __restrict__ q8, const float* __restrict__ qs,
                   const i8* __restrict__ kc8, const float* __restrict__ ksc,
                   const i8* __restrict__ kn8, const float* __restrict__ ksf,
                   const i8* __restrict__ vc8, const float* __restrict__ vsc,
                   const i8* __restrict__ vn8, const float* __restrict__ vsf,
                   const float* __restrict__ m0, bf16* __restrict__ out,
                   int N, int Lq, int Lf, int kv_start, int kv_end,
                   int sink_end, int cache_lim, int tq, int tk, int tf,
                   int qt, int ntc, int ntf, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // [Q8 | K8 0 | K8 1 | V^T 0 | V^T 1]
  unsigned char* sQ = smem_raw;
  unsigned char* sK = sQ + BM * LDB;
  unsigned char* sV = sK + 2 * KT8;

  const int bn = blockIdx.y;
  const int b = bn / N;
  const int n = bn % N;
  const int q0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // accumulator row within the warp's 16
  const int tg = lane % 4;  // accumulator column pair
  const long long ld_tok = (long long)N * D;  // packed token row stride

  // the int8 Q tile stays in shared memory; each warp reads its 16 rows
  load_bytes<BM, D, LDB, THREADS>(sQ, q8 + ((long long)bn * qt * tq + q0) * D,
                                  D, min(BM, Lq - q0));
  cp_async_commit();
  const unsigned char* qw = sQ + warp * 16 * LDB;

  float qsr[2];  // q scales of rows g and g + 8 (their Pallas q tile)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + warp * 16 + g + 8 * h;
    qsr[h] = r < Lq ? qs[(long long)bn * qt + r / tq] : 0.f;
  }
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float l[2] = {0.f, 0.f};               // partial row sums
  float m[2] = {-INFINITY, -INFINITY};   // ONLINE: running row max
  const float m0v = MODE == ONLINE ? 0.f : __ldg(m0);

  for (int tt = 0; tt < ntc + ntf; ++tt) {
    const bool fresh = tt >= ntc;
    const int t = fresh ? tt - ntc : tt;
    const int tile = fresh ? tf : tk;
    const int T0 = t * tile;
    const int Tlen = min(tile, (fresh ? Lf : cache_lim) - T0);
    const int nU = cdiv(Tlen, BK);
    // sub-tile u has a visible column (the mask is the same for all rows)
    auto live = [&](int u) {
      if (fresh) return true;
      const int j0 = T0 + u * BK, j1 = T0 + min(Tlen, u * BK + BK);
      return j0 < sink_end || (j0 < kv_end && j1 > kv_start);
    };
    auto next_u = [&](int u) {
      while (u < nU && !live(u)) ++u;
      return u;
    };
    if (next_u(0) >= nU) continue;  // no visible column: adds nothing
    const int tp = cdiv(tile, VPAD) * VPAD;
    const long long nt_all = fresh ? ntf : ntc;
    const i8* kb = (fresh ? kn8 : kc8) + ((long long)bn * nt_all * tile + T0) * D;
    const i8* vb = (fresh ? vn8 : vc8) + ((long long)bn * nt_all + t) * D * tp;
    const float ks = (fresh ? ksf : ksc)[bn * nt_all + t];
    const float vs = (fresh ? vsf : vsc)[bn * nt_all + t];
    const float a[2] = {qsr[0] * (ks * scale), qsr[1] * (ks * scale)};

    // every live sub-tile of this Pallas tile through the double-buffered
    // ring (K only, or K and V^T), body(u, buf) once each
    auto run = [&](bool with_v, auto&& body) {
      auto fetch = [&](int u, int buf) {
        load_bytes<BK, D, LDB, THREADS>(sK + buf * KT8,
                                        kb + (long long)u * BK * D, D,
                                        min(BK, Tlen - u * BK));
        if (with_v)
          load_bytes<D, BK, LDV, THREADS>(sV + buf * VT8, vb + u * BK, tp,
                                          D);
      };
      int u = next_u(0);
      fetch(u, 0);
      cp_async_commit();
      int buf = 0;
      while (u < nU) {
        const int un = next_u(u + 1);
        if (un < nU) fetch(un, buf ^ 1);
        cp_async_commit();
        cp_async_wait<1>();  // Q and sub-tile u have landed
        __syncthreads();
        body(u, buf);
        __syncthreads();  // every warp is done with this buffer
        buf ^= 1;
        u = un;
      }
      cp_async_wait<0>();
    };
    // int32 scores of this warp's 16 rows x 64 keys of buffer buf
    auto scores = [&](int buf, int (&s)[BK / 8][4]) {
      const unsigned char* k_s = sK + buf * KT8;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0;
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk) {
        uint32_t af[4];
        ldsm_x4(af, qw + ((lane % 8) + ((lane / 8) % 2) * 8) * LDB + kk * 32 +
                        (lane / 16) * 16);
#pragma unroll
        for (int np = 0; np < BK / 16; ++np) {
          uint32_t kf[4];
          const int key = np * 16 + (lane % 8) + (lane / 16) * 8;
          ldsm_x4(kf, k_s + key * LDB + kk * 32 + ((lane / 8) % 2) * 16);
          mma_s8(s[2 * np], af, kf[0], kf[1]);
          mma_s8(s[2 * np + 1], af, kf[2], kf[3]);
        }
      }
    };
    auto visible = [&](int u, int col) {
      const int c = u * BK + col;
      const int j = T0 + c;
      return c < Tlen && (fresh || j < sink_end || (j >= kv_start && j < kv_end));
    };

    // pass 1: the rows' max over the tile's visible scores
    float shift[2], w[2] = {1.f, 1.f};
    if (MODE == GLOBAL) {
      shift[0] = shift[1] = (m0v - LN127) * LOG2E;
    } else {
      float mx[2] = {-INFINITY, -INFINITY};
      run(false, [&](int u, int buf) {
        int s[BK / 8][4];
        scores(buf, s);
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (visible(u, nt * 8 + 2 * tg + (e & 1)))
              mx[e >> 1] = fmaxf(mx[e >> 1], int_to_float(s[nt][e]) * a[e >> 1]);
      });
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        if (MODE == TILE) {
          w[h] = fast_exp2((mx[h] - m0v) * LOG2E);
          shift[h] = (mx[h] - LN127) * LOG2E;
        } else {
          const float m_new = fmaxf(m[h], mx[h]);
          const float corr = fast_exp2((m[h] - m_new) * LOG2E);
          l[h] *= corr;
#pragma unroll
          for (int i = 0; i < D / 8; ++i) {
            o[i][2 * h] *= corr;
            o[i][2 * h + 1] *= corr;
          }
          m[h] = m_new;
          shift[h] = (m_new - LN127) * LOG2E;
        }
      }
    }

    // pass 2: p, its int8, and the int32 P.V of the whole Pallas tile
    int acc[D / 8][4];
#pragma unroll
    for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0;
    float ls[2] = {0.f, 0.f};
    run(true, [&](int u, int buf) {
      int s[BK / 8][4];
      scores(buf, s);
      const unsigned char* v_s = sV + buf * VT8;
#pragma unroll
      for (int ks32 = 0; ks32 < BK / 32; ++ks32) {
        int pq[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int nt = 4 * ks32 + j;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = 0.f;
            if (visible(u, nt * 8 + 2 * tg + (e & 1))) {
              p = fast_exp2(int_to_float(s[nt][e]) * a[e >> 1] * LOG2E -
                            shift[e >> 1]);
              if (MODE == GLOBAL) p = fminf(p, 127.f);
            }
            ls[e >> 1] += p;
            pq[j][e] = __float2int_rn(p);
          }
        }
        // keys {2t, 2t+1, 8+2t, 9+2t} of each 16-key group: the A slots
        // 4t..4t+3 that the V^T slot order gives them
        uint32_t pa[4];
        pa[0] = pack4(pq[0][0], pq[0][1], pq[1][0], pq[1][1]);
        pa[1] = pack4(pq[0][2], pq[0][3], pq[1][2], pq[1][3]);
        pa[2] = pack4(pq[2][0], pq[2][1], pq[3][0], pq[3][1]);
        pa[3] = pack4(pq[2][2], pq[2][3], pq[3][2], pq[3][3]);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t vf[4];
          const int d = dp * 16 + (lane % 8) + (lane / 16) * 8;
          ldsm_x4(vf, v_s + d * LDV + ks32 * 32 + ((lane / 8) % 2) * 16);
          mma_s8(acc[2 * dp], pa, vf[0], vf[1]);
          mma_s8(acc[2 * dp + 1], pa, vf[2], vf[3]);
        }
      }
    });
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] += ls[h] * w[h];
    const float dq[2] = {vs * w[0], vs * w[1]};
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[i][e] += __int2float_rn(acc[i][e]) * dq[e >> 1];
  }

  float l0 = l[0], l1 = l[1];
  // row sums over the 4 threads that share a row
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int r0 = q0 + warp * 16 + g;
  store_rows<D>(out + (long long)b * Lq * ld_tok + n * D, ld_tok, o, r0,
                r0 + 8, Lq, fmaxf(l0, 1e-30f), fmaxf(l1, 1e-30f), tg);
}

template <int MODE>
int launch_attend(const void* const* ops, const void* m0, void* out, int B,
                  int N, int Lq, int Lf, int kv_start, int kv_end,
                  int sink_end, int cache_lim, int tq, int tk, int tf,
                  float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      int8_attend_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(cdiv(Lq, BM), B * N);
  int8_attend_kernel<MODE><<<grid, THREADS, SMEM_BYTES, stream>>>(
      (const i8*)ops[0], (const float*)ops[1], (const i8*)ops[2],
      (const float*)ops[3], (const i8*)ops[4], (const float*)ops[5],
      (const i8*)ops[6], (const float*)ops[7], (const i8*)ops[8],
      (const float*)ops[9], (const float*)m0, (bf16*)out, N, Lq, Lf,
      kv_start, kv_end, sink_end, cache_lim, tq, tk, tf, cdiv(Lq, tq),
      cdiv(cache_lim, tk), cdiv(Lf, tf), scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Quantize the V tiles of layer `v_cache` ([B*N, S, D]) that meet the
// window [0, sink_end) + [kv_start, kv_end) below cache_lim, and v_new
// ([B, Lf, N*D]), each over its Pallas tile (tk, tf rows), into K-major
// int8 V^T.  Launch on `stream`; returns the CUDA error code (0 on
// success).
extern "C" int int8_quantize_v_launch(const void* v_cache, const void* v_new,
                                      void* vc8, void* vsc, void* vn8,
                                      void* vsf, int B, int N, int Lf, int S,
                                      int kv_start, int kv_end, int sink_end,
                                      int cache_lim, int tk, int tf,
                                      void* stream) {
  const long long tok = (long long)N * D;
  const VSeg svc{(const bf16*)v_cache, (long long)N * S * D, (long long)S * D,
                 D, S, tk, cdiv(cache_lim, tk), cdiv(tk, VPAD) * VPAD,
                 (i8*)vc8, (float*)vsc};
  const VSeg svn{(const bf16*)v_new, (long long)Lf * tok, D, tok, Lf, tf,
                 cdiv(Lf, tf), cdiv(tf, VPAD) * VPAD, (i8*)vn8, (float*)vsf};
  const int tiles = svc.n_tiles + svn.n_tiles;
  if (B * N <= 0 || tiles <= 0) return 0;
  int8_quantize_v_kernel<<<B * N * tiles, QTHREADS, 0,
                           (cudaStream_t)stream>>>(svc, svn, B * N, N,
                                                   kv_start, kv_end,
                                                   sink_end);
  return (int)cudaGetLastError();
}

// The attention of the pre-passes' int8 q, K (int8qk_quantize) and V^T
// (int8_quantize_v) in `mode` (one of Mode); m0 points at one float (TILE,
// GLOBAL; may be null for ONLINE).  Launch on `stream`; returns the CUDA
// error code (0 on success; cudaErrorInvalidValue for an unknown mode).
extern "C" int int8_attend_launch(const void* q8, const void* qs,
                                  const void* kc8, const void* ksc,
                                  const void* kn8, const void* ksf,
                                  const void* vc8, const void* vsc,
                                  const void* vn8, const void* vsf,
                                  const void* m0, void* out, int B, int N,
                                  int Lq, int Lf, int kv_start, int kv_end,
                                  int sink_end, int cache_lim, int tq,
                                  int tk, int tf, int mode, float scale,
                                  void* stream) {
  if (Lq <= 0 || B * N <= 0) return 0;
  const void* ops[10] = {q8, qs, kc8, ksc, kn8, ksf, vc8, vsc, vn8, vsf};
  auto st = (cudaStream_t)stream;
#define SF_ARGS ops, m0, out, B, N, Lq, Lf, kv_start, kv_end, sink_end, \
    cache_lim, tq, tk, tf, scale, st
  switch (mode) {
    case TILE:
      if (m0 == nullptr) return (int)cudaErrorInvalidValue;
      return launch_attend<TILE>(SF_ARGS);
    case GLOBAL:
      if (m0 == nullptr) return (int)cudaErrorInvalidValue;
      return launch_attend<GLOBAL>(SF_ARGS);
    case ONLINE: return launch_attend<ONLINE>(SF_ARGS);
  }
#undef SF_ARGS
  return (int)cudaErrorInvalidValue;
}
