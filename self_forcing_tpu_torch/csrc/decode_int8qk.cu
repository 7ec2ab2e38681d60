// int8qk_quantize: the pre-pass of the int8-QK decode attention (the
// decode self-attention of one block's queries onto a read-only KV cache
// window plus the block's own fresh K/V, with QK^T in int8 at per-tile
// scales, P.V in bf16 and the offset-free base-2 softmax).
//
// Replaces the tile quantization of the TPU kernel
// _decode_fresh_int8_kernel in 'free_qk' mode
// (self_forcing_tpu/ops/pallas_attention.py, decode_attention_fresh_pallas
// with softmax='free', quant='int8qk': _quantize_q_tile,
// _quantize_cache_tile, _quantize_fresh_tile).  The attention itself (its
// free_qk _accumulate and _finalize) is decode_fresh.cu's INT8QK mode
// (int8qk_attend_launch), which reads what this pass writes.
//
// Function.  The scales are per Pallas tile, so the tiles are the Pallas
// kernel's (tq query rows, tk cache rows, tf fresh rows; see
// ops/attention.py::decode_tiles):
//   q scale, per (b, head, q tile):  qs = max(max|q|, 1e-8) / 127
//   k scale, per (b*head, cache tile meeting the window, or fresh tile):
//       ks = max(max|k| / 127, 1e-8), the max over ALL rows of the tile
//       (rows the mask hides count too; rows past the length count as 0)
//   q8 = rint(q / qs), k8 = rint(k / ks)   (true division, half to even)
//
// Layouts: q and k_new are heads-packed [B, L, N*D]; the cache is one
// layer [B*N, S, D] of the stacked buffer.  The pass writes int8 q, cache
// K and fresh K folded [B*N, tiles * tile, D] (zero rows past each length;
// the rows of a cache tile outside the window are not written and its
// scale is 0) and f32 scales [B*N, tiles].  D = 128.
//
// What bounds it on the H100: at the Wan-1.3B shapes (4680 queries, up to
// 32760 keys, 12 heads) it moves ~0.17 GB (a bf16 read and an int8 write
// of every element) and is bound by memory.  A tile's scale needs the max
// over the whole tile before the first element can be quantized, and a
// tile is large (up to 2048 rows, 512 KB), so one CTA would read it twice
// (the max, then the values) or hold it in more shared memory than it
// has.  Design: a cluster of 8 CTAs takes one tile, each CTA a share of
// its rows (up to 256 at the 1.3B tiles, 64 KB): it copies them once from
// device memory into shared memory (16-byte cp.async, all in flight at
// once, 3 CTAs an SM) and takes their max there; the 8 partial maxima
// meet through distributed shared memory (each CTA stores its max into
// every partner's slot, one cluster barrier); then each CTA quantizes its
// rows from shared memory (the division as a reciprocal and two FMAs,
// exact; the rounding and the int8 bits from one FADD) and writes them as
// 16-byte int8 stores.  Only the live cache
// tiles get a cluster.

#include "attention_common.cuh"
#include "hopper.cuh"

using namespace sf_attn;
using namespace sf_hopper;

namespace {

typedef int8_t i8;

constexpr int D = 128;          // head dim
constexpr int CL = 8;           // CTAs a cluster: one tile's rows 8 ways
constexpr int QTHREADS = 512;   // 3 CTAs an SM: up to 192 KB in flight
constexpr int CH = D / 8;       // 16-byte bf16 chunks of a row
constexpr float FLOOR = 1e-8f;  // scale floor of q and k
// the shared memory a block may use, less the static arrays: a CTA's
// share of a tile is at most this many rows
constexpr int MAX_SHARE = (232448 - 1024) / (D * 2);

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

// One cluster of CL CTAs per (matrix, tile) of q, then of the live cache
// tiles, then of k_new; CTA `rank` takes rows [rank * share, (rank + 1) *
// share) of the tile (share = ceil(tile / CL); a CTA past the tile's rows
// takes none and brings the max 0).  The live cache tiles are [0, a1)
// and [b2, c2) (the tiles the window [0, sink_end) + [kv_start, kv_end)
// meets); the cluster of each matrix's first q tile writes scale 0 for
// the others, whose rows are never written.
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(QTHREADS, 3)
int8qk_quantize_kernel(Seg sq, Seg skc, Seg skn, int BN, int N, int a1,
                       int b2, int c2) {
  extern __shared__ uint4 rows[];   // this CTA's rows of the tile, bf16
  __shared__ float red[QTHREADS / 32];
  __shared__ float part[CL];        // each CTA's max |x| over its rows
  int idx = blockIdx.x / CL;
  const int rank = (int)cluster_rank();
  const int n_live = a1 + max(c2 - b2, 0);   // live cache tiles a matrix
  const int nq = BN * sq.n_tiles, nc = BN * n_live;
  Seg sg = sq;
  bool k_scale = true;
  int m, t;
  if (idx < nq) {
    k_scale = false;
    m = idx / sq.n_tiles, t = idx % sq.n_tiles;
    if (t == 0 && rank == 0)   // the dead cache tiles' scales
      for (int x = threadIdx.x; x < skc.n_tiles; x += QTHREADS)
        if (x >= a1 && !(x >= b2 && x < c2))
          skc.scale[(long long)m * skc.n_tiles + x] = 0.f;
  } else if (idx < nq + nc) {
    sg = skc;
    idx -= nq;
    m = idx / n_live, t = idx % n_live;
    t = t < a1 ? t : b2 + (t - a1);
  } else {
    sg = skn;
    idx -= nq + nc;
    m = idx / sg.n_tiles, t = idx % sg.n_tiles;
  }
  const int r0 = t * sg.tile;
  cluster_arrive_relaxed();
  const int share = (sg.tile + CL - 1) / CL;
  const int lo = min(rank * share, sg.tile);
  const int n_rows = min(share, sg.tile - lo);   // rows this CTA writes
  // of which hold data (rows past the length are zeros)
  const int n_read = max(0, min(n_rows, sg.rows - r0 - lo));
  const bf16* src = sg.src + (long long)(m / N) * sg.b_stride +
                    (long long)(m % N) * sg.n_stride +
                    (long long)(r0 + lo) * sg.row_stride;

  // 1. each element read once, straight into shared memory (every copy
  // in flight at once, no register staging), then its max
  const int n_ch = n_read * CH;
  for (int i = threadIdx.x; i < n_ch; i += QTHREADS)
    cp_async16(&rows[i], src + (long long)(i / CH) * sg.row_stride +
                             (i % CH) * 8, 16);
  cp_async_commit();
  cp_async_wait<0>();
  // the max over the chunks this thread copied, a bf16 pair at a time
  __nv_bfloat162 m2 = __float2bfloat162_rn(0.f);
  for (int i = threadIdx.x; i < n_ch; i += QTHREADS) {
    const uint4 v = rows[i];
    m2 = abs_max2(abs_max2(abs_max2(abs_max2(m2, v.x), v.y), v.z), v.w);
  }
  float amax = fmaxf(__low2float(m2), __high2float(m2));
  amax = block_max<QTHREADS>(amax, red);   // its barrier publishes rows[]

  // 2. the tile's max: every CTA's into every partner's part[rank]
  cluster_wait();
  if (threadIdx.x < CL)
    st_cluster_f32(map_rank(smem_u32(&part[rank]), threadIdx.x), amax);
  cluster_arrive();
  cluster_wait();
  float tmax = part[0];
#pragma unroll
  for (int j = 1; j < CL; ++j) tmax = fmaxf(tmax, part[j]);
  // q: max(amax, floor) / 127; k: max(amax / 127, floor), as the TPU kernel
  const float s = k_scale ? fmaxf(__fdiv_rn(tmax, 127.f), FLOOR)
                          : __fdiv_rn(fmaxf(tmax, FLOOR), 127.f);
  const float rc = __frcp_rn(s);
  if (rank == 0 && threadIdx.x == 0)
    sg.scale[(long long)m * sg.n_tiles + t] = s;

  // 3. the rows from shared memory, 16 int8 a store
  i8* dst = sg.dst + ((long long)m * sg.n_tiles * sg.tile + r0 + lo) * D;
  for (int i = threadIdx.x; i < n_rows * (D / 16); i += QTHREADS) {
    const int r = i / (D / 16), c = i % (D / 16);
    uint4 o = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_read) {
      const uint4 a = rows[r * CH + 2 * c], b = rows[r * CH + 2 * c + 1];
      o = make_uint4(quant_pairs(a.x, a.y, s, rc),
                     quant_pairs(a.z, a.w, s, rc),
                     quant_pairs(b.x, b.y, s, rc),
                     quant_pairs(b.z, b.w, s, rc));
    }
    reinterpret_cast<uint4*>(dst + (long long)r * D)[c] = o;
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// Quantize q, the cache tiles of layer `k_cache` ([B*N, S, D]) that meet
// the window [0, sink_end) + [kv_start, kv_end) below cache_lim, and
// k_new, each over its Pallas tiles (tq, tk, tf rows; at most 8 *
// MAX_SHARE = 7232 rows).  Launch on `stream`; returns the CUDA error
// code (0 on success; cudaErrorInvalidValue for a larger tile).
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
  int share = 0;   // the largest share of a tile's rows, in shared memory
  const Seg* segs[3] = {&sq, &skc, &skn};
  for (const Seg* sg : segs)
    if (sg->n_tiles > 0) share = max(share, cdiv(sg->tile, CL));
  if (share > MAX_SHARE) return (int)cudaErrorInvalidValue;
  int a1, b2, c2;   // the live cache tiles: [0, a1) and [b2, c2)
  live_ranges(skc.n_tiles, tk, kv_start, kv_end, sink_end, &a1, &b2, &c2);
  const int smem = share * D * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      int8qk_quantize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int live = sq.n_tiles + a1 + (c2 - b2) + skn.n_tiles;
  int8qk_quantize_kernel<<<CL * B * N * live, QTHREADS, smem,
                           (cudaStream_t)stream>>>(sq, skc, skn, B * N, N,
                                                   a1, b2, c2);
  return (int)cudaGetLastError();
}
