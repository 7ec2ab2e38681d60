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
// 32760 keys, 12 heads) it moves ~0.2 GB and is bound by memory.  Design,
// simple first: one CTA of 1024 threads per (b*head, tile), a max over
// the tile and then the quantization of the same rows, read again.

#include "attention_common.cuh"

using namespace sf_attn;

namespace {

typedef int8_t i8;

constexpr int D = 128;        // head dim
constexpr int QTHREADS = 1024;  // pre-pass CTA, 2 a SM: loads in flight
constexpr float FLOOR = 1e-8f;  // scale floor of q and k

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
