// flash_bwd: the backward of the masked flash attention (every softmax
// mode of flash_fwd) in one pass: dq, dk and dv from the same recomputed
// scores.
//
// Replaces both TPU kernels of the backward in
// self_forcing_tpu/ops/pallas_attention.py (_flash_bwd -> pallas_call):
//   _flash_bwd_dq_kernel   (dq; grid over query tiles, keys innermost)
//   _flash_bwd_dkv_kernel  (dk, dv; grid over key tiles, queries innermost)
//
// Function.  q, k, v, dout, dq, dk, dv are [B, L, N, D] bf16 (token row
// stride N*D), D = 128.  Query row i sees key j iff j < Lk and
//   s1[i] <= j < e1[i]  or  s2[i] <= j < e2[i]
// (an IntervalMask; no mask is [0, Lk) for every row).  At `scale` (ln 2
// in free mode, the forward's scale otherwise), against the forward's
// base-e lse and delta_i = rowsum(dout * out) (both [B*N, Lq_pad] fp32):
//   p = exp(scale * q_i . k_j - lse_i) on visible pairs, else 0
//   dp = dout_i . v_j,  ds = p * (dp - delta_i)
//   dq_i = scale * sum_j bf16(ds) k_j,  dk_j = scale * sum_i bf16(ds) q_i,
//   dv_j = sum_i bf16(p) dout_i.
// The exponentials run base 2 (ex2.approx): the scores are multiplied by
// scale * log2(e) and lse by log2(e).
//
// What bounds it on the H100: at the training shape (B 1, L 32760, 12
// heads, no mask) the five products (s, dp, p^T.dout, ds^T.q, ds.k) are
// 16.5 TFLOP against ~0.5 GB of operands: tensor-core operations, 16.7 ms
// at the 989 TFLOP/s bf16 peak.  Design (FlashAttention-3's backward, on
// the warp-specialised shape of hopper.cuh): one CTA per (b*n, 128-key
// tile) keeps K and V resident (TMA, 2 x 32 KB) and streams every live
// 64-query tile (Q, dout and the tile's lse, delta and four interval
// rows, 33.5 KB) through a 2-stage ring filled by one thread of a
// producer warpgroup (full / empty mbarriers); dead tiles are never
// loaded (the tile-state table), fully visible tiles skip the per-element
// mask.  Two consumer warpgroups each own 64 of the keys and run them as
// rows, so every product is a wgmma:
//   S^T = K.Q^T, dP^T = V.dout^T   (m64n64k16, both from shared memory)
//   P^T = exp2(S^T * c - lse) (while dP^T runs),
//   dS^T = P^T * (dP^T - delta)   (registers)
//   bf16(dS^T) to shared memory (stmatrix);
//   dV += bf16(P^T).dout   (m64n128k16, A from the registers, B MN-major);
//   a named barrier between the two warpgroups, dQ = dS.K for one half of
//   D each (m64n64k16, A = dS^T MN-major, B = K MN-major), then
//   dK += bf16(dS^T).Q (as dV), which runs while the dQ partial is
//   staged.
// dK and dV stay in registers (64 + 64 fp32 a thread) for the CTA's life;
// each dQ partial (64 queries x 64 columns fp32) is staged in shared
// memory (128-byte swizzle), and a second warp of the producer
// warpgroup (the dQ writer) adds it into the fp32 accumulator dq_acc
// [B*N, Lq_pad, D] with two TMA reduce-adds (dq_full / dq_free
// mbarriers), which run while the next tile is computed.  A small kernel
// then writes dq = bf16(scale * dq_acc).  Registers: dK, dV, S^T and
// dP^T are live at once (192 a thread), then dK, dV, both bf16 operands
// and dQ (192), and ptxas uses nearly all of a consumer's 240, so the
// producer warpgroup lowers its registers to 24 and the consumers raise
// theirs to 240 (setmaxnreg).  Shared memory: K, V 64 KB, the ring
// 67 KB, dS^T 2 x 16 KB, the dQ staging 2 x 16 KB (200 KB of the 227 KB
// a block may use).
// dS^T is double-buffered: a warpgroup writing tile i's buffer has passed
// tile i - 1's named barrier, so the other has finished tile i - 2's dQ,
// the last reader of that buffer.
//
// Determinism: dk and dv have one owner each and are summed in a fixed
// order, so they are the same bits run after run; dq is a sum of Lk / 128
// partials whose order across CTAs changes from run to run (fp32
// reductions in L2), so its last bits may differ between runs.

#include <cstring>

#include "attention_common.cuh"
#include "hopper.cuh"

using namespace sf_attn;
using namespace sf_hopper;

namespace {

constexpr int D = 128;                  // head dim
constexpr int BK = 128;                 // keys a CTA
constexpr int BQ = 64;                  // queries a streamed tile
constexpr int STAGES = 2;               // Q / dout ring depth
constexpr int CONSUMERS = 2;            // consumer warpgroups, 64 keys each
constexpr int THREADS = 128 * (CONSUMERS + 1);   // + the producer
constexpr int KV_BOX = BK * 128;        // bytes of a 64-column K or V box
constexpr int KV_TILE = 2 * KV_BOX;
constexpr int Q_BOX = BQ * 128;         // bytes of a 64-column Q / dout box
constexpr int Q_TILE = 2 * Q_BOX;
constexpr int DS_TILE = BK * BQ * 2;    // bf16 dS^T: 128 key rows of 64
constexpr int DQ_BOX = BQ * 128;        // fp32 dQ partial: 64 rows of 32
constexpr int DQ_TILE = 2 * DQ_BOX;     // a consumer's 64 columns
constexpr int NROW = 6;                 // s1, e1, s2, e2, lse, delta
constexpr int ROW_BYTES = BQ * 4;
constexpr int STAGE_TX = 2 * Q_TILE + NROW * ROW_BYTES;
constexpr int MAX_TILES = 4096;         // tile-state row in shared memory
constexpr int N_BARS = 1 + 2 * STAGES + 2 * CONSUMERS;
constexpr size_t SMEM_BYTES =
    1024 + 2 * KV_TILE + 2 * STAGES * Q_TILE + 2 * DS_TILE +
    CONSUMERS * DQ_TILE + STAGES * NROW * ROW_BYTES + MAX_TILES +
    N_BARS * sizeof(uint64_t);
constexpr float LOG2E = 1.4426950408889634f;

struct Maps {
  CUtensorMap q;     // (D, N, Lq, B), box (64, 1, BQ, 1)
  CUtensorMap dout;
  CUtensorMap k;     // (D, N, Lk, B), box (64, 1, BK, 1)
  CUtensorMap v;
  CUtensorMap dq;    // fp32 (D, Lq_pad, B*N), box (32, BQ, 1)
};

__device__ __forceinline__ bool visible(int j, int s1, int e1, int s2,
                                        int e2) {
  return (j >= s1 && j < e1) || (j >= s2 && j < e2);
}

// The next query tile >= t whose state is not dead; n when none is left.
__device__ __forceinline__ int next_tile(const unsigned char* st, int t,
                                         int n) {
  while (t < n && st[t] == 0) ++t;
  return t;
}

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_kernel(const __grid_constant__ Maps maps,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const int* __restrict__ iv,
                 const unsigned char* __restrict__ states,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int N,
                 int Lq, int Lk, int Lq_pad, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // [K | V | Q: STAGES | dout: STAGES | dS^T: 2 | dQ: CONSUMERS |
  //  row scalars: STAGES | tile states | barriers]
  unsigned char* sK = base;
  unsigned char* sV = sK + KV_TILE;
  unsigned char* sQ = sV + KV_TILE;
  unsigned char* sDO = sQ + STAGES * Q_TILE;
  unsigned char* sDS = sDO + STAGES * Q_TILE;
  unsigned char* sDQ = sDS + 2 * DS_TILE;
  unsigned char* sRow = sDQ + CONSUMERS * DQ_TILE;
  unsigned char* sSt = sRow + STAGES * NROW * ROW_BYTES;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sSt + MAX_TILES);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  uint64_t* dq_full = empty + STAGES;   // [c]: consumer c's dQ staged
  uint64_t* dq_free = dq_full + CONSUMERS;   // [c]: its staging read

  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  const int k0 = blockIdx.x * BK;
  const int nqt = (Lq + BQ - 1) / BQ;
  const int wg = threadIdx.x / 128;

  for (int i = threadIdx.x; i < nqt; i += THREADS)
    sSt[i] = states[(long long)blockIdx.x * nqt + i];
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    for (int c = 0; c < CONSUMERS; ++c) {
      mbar_init(&dq_full[c], 128);
      mbar_init(&dq_free[c], 1);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: one thread loads K and V once, then every live query
    // tile into the ring; its registers go to the consumers ----
    regs_dealloc<24>();
    if (threadIdx.x == 128 * CONSUMERS + 32) {
      // ---- the dQ writer: each tile's two staged partials added into
      // dq_acc by TMA reductions, each staging tile handed back once the
      // reduction has read it ----
      int i = 0;
      for (int t = next_tile(sSt, 0, nqt); t < nqt;
           t = next_tile(sSt, t + 1, nqt), ++i) {
        for (int c = 0; c < CONSUMERS; ++c) {
          unsigned char* dq_s = sDQ + c * DQ_TILE;
          mbar_wait(&dq_full[c], i & 1);
          tma_reduce_add_3d(&maps.dq, dq_s, 64 * c, t * BQ, bn);
          tma_reduce_add_3d(&maps.dq, dq_s + DQ_BOX, 64 * c + 32, t * BQ,
                            bn);
          bulk_commit();
        }
        bulk_wait_read<1>();
        mbar_arrive(&dq_free[0]);
        bulk_wait_read<0>();
        mbar_arrive(&dq_free[1]);
      }
      bulk_wait<0>();
      return;
    }
    if (threadIdx.x != 128 * CONSUMERS) return;
    mbar_expect_tx(kv_full, 2 * KV_TILE);
    tma_load_4d(sK, &maps.k, kv_full, 0, n, k0, b);
    tma_load_4d(sK + KV_BOX, &maps.k, kv_full, 64, n, k0, b);
    tma_load_4d(sV, &maps.v, kv_full, 0, n, k0, b);
    tma_load_4d(sV + KV_BOX, &maps.v, kv_full, 64, n, k0, b);
    const float* lrow = lse + (long long)bn * Lq_pad;
    const float* drow = delta + (long long)bn * Lq_pad;
    int i = 0;   // tiles loaded so far: the ring position
    for (int t = next_tile(sSt, 0, nqt); t < nqt;
         t = next_tile(sSt, t + 1, nqt), ++i) {
      const int st = i % STAGES;
      const int q0 = t * BQ;
      mbar_wait(&empty[st], ((i / STAGES) & 1) ^ 1);
      mbar_expect_tx(&full[st], STAGE_TX);
      unsigned char* q_s = sQ + st * Q_TILE;
      unsigned char* do_s = sDO + st * Q_TILE;
      tma_load_4d(q_s, &maps.q, &full[st], 0, n, q0, b);
      tma_load_4d(q_s + Q_BOX, &maps.q, &full[st], 64, n, q0, b);
      tma_load_4d(do_s, &maps.dout, &full[st], 0, n, q0, b);
      tma_load_4d(do_s + Q_BOX, &maps.dout, &full[st], 64, n, q0, b);
      unsigned char* rows = sRow + st * NROW * ROW_BYTES;
      for (int a = 0; a < 4; ++a)
        bulk_load(rows + a * ROW_BYTES, iv + (long long)a * Lq_pad + q0,
                  ROW_BYTES, &full[st]);
      bulk_load(rows + 4 * ROW_BYTES, lrow + q0, ROW_BYTES, &full[st]);
      bulk_load(rows + 5 * ROW_BYTES, drow + q0, ROW_BYTES, &full[st]);
    }
    return;
  }

  // ---- consumers: warpgroup c owns keys k0 + 64 c .. + 63 ----
  regs_alloc<240>();
  const int c = wg;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const bool leader = threadIdx.x % 128 == 0;
  const float cs = scale * LOG2E;
  unsigned char* dq_s = sDQ + c * DQ_TILE;
  const int key_r = c * 64 + warp * 16 + g;   // rows of d[0, 1], + 8: d[2, 3]
  auto desc = [](uint32_t addr, uint32_t lbo) {
    return desc_sw128(addr, lbo, 1024);
  };

  float dka[64], dva[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) dka[e] = dva[e] = 0.f;
  mbar_wait(kv_full, 0);

  int i = 0;   // tiles consumed so far: the ring position
  for (int t = next_tile(sSt, 0, nqt); t < nqt;
       t = next_tile(sSt, t + 1, nqt), ++i) {
    const int st = i % STAGES;
    const int q0 = t * BQ;
    const unsigned char* rows = sRow + st * NROW * ROW_BYTES;
    const int* ivs = reinterpret_cast<const int*>(rows);
    const float* lse_s = reinterpret_cast<const float*>(rows + 4 * ROW_BYTES);
    const float* dl_s = reinterpret_cast<const float*>(rows + 5 * ROW_BYTES);
    // Operand addresses.  A of S^T / dP^T: this warpgroup's 64 key rows
    // of K / V (K-major); B of S^T / dP^T: the stage's Q / dout tile
    // (K-major), and of dK / dV the same tiles MN-major (the next 64
    // columns one box on); A of dQ: the buffer's dS^T (MN-major); B of dQ:
    // this warpgroup's 64 columns of K (MN-major).
    const uint32_t a_k = smem_u32(sK + c * 64 * 128), a_v = a_k + KV_TILE;
    const uint32_t a_kd = smem_u32(sK + c * KV_BOX);
    const uint32_t a_q = smem_u32(sQ + st * Q_TILE);
    const uint32_t a_do = a_q + STAGES * Q_TILE;
    const uint32_t a_ds = smem_u32(sDS + (i & 1) * DS_TILE);
    mbar_wait(&full[st], (i / STAGES) & 1);

    // S^T and dP^T, one commit group each
    float s[32], dp[32];
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16_ss<0, 0>(
          s, desc(a_k + (kk / 4) * KV_BOX + (kk % 4) * 32, 16),
          desc(a_q + (kk / 4) * Q_BOX + (kk % 4) * 32, 16), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16_ss<0, 0>(
          dp, desc(a_v + (kk / 4) * KV_BOX + (kk % 4) * 32, 16),
          desc(a_do + (kk / 4) * Q_BOX + (kk % 4) * 32, 16), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    // P^T in place of S^T, while dP^T runs: column (query) 8 e8 + 2 tq +
    // (e & 1), row (key) key_r + 8 (e >> 1).  A partial tile zeroes the
    // pairs that are not visible.
    const bool partial = sSt[t] == 1;
#pragma unroll
    for (int e8 = 0; e8 < 8; ++e8) {
      const int col = 8 * e8 + 2 * tq;
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * e8 + e] = fast_exp2(
            fmaf(s[4 * e8 + e], cs, -((e & 1) ? l2.y : l2.x) * LOG2E));
      if (partial) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int cq = col + h;
          const int s1 = ivs[cq], e1 = ivs[BQ + cq];
          const int s2 = ivs[2 * BQ + cq], e2 = ivs[3 * BQ + cq];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int j = k0 + key_r + 8 * r;
            if (!(q0 + cq < Lq && j < Lk && visible(j, s1, e1, s2, e2)))
              s[4 * e8 + 2 * r + h] = 0.f;
          }
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);

    // dS^T in place of dP^T
#pragma unroll
    for (int e8 = 0; e8 < 8; ++e8) {
      const float2 d2 =
          *reinterpret_cast<const float2*>(dl_s + 8 * e8 + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * e8 + e] =
            s[4 * e8 + e] * (dp[4 * e8 + e] - ((e & 1) ? d2.y : d2.x));
    }
    // bf16(P^T) and bf16(dS^T) as register A operands (accumulator
    // columns 16 kk .. 16 kk + 15 are k-step kk); dS^T also to shared
    // memory (the dS^T buffer i & 1) with stmatrix for dQ: k-step kk's
    // four 8x8 blocks are key rows 0-7 / 8-15 of the warp's 16 by queries
    // 16 kk + 0-7 / 8-15; lane l addresses row l % 8 of block l / 8
    // (128-byte swizzle: row % 8 = l % 8)
    uint32_t pa[16], da[16];
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      pa[x] = pack_bf16(s[2 * x], s[2 * x + 1]);
      da[x] = pack_bf16(dp[2 * x], dp[2 * x + 1]);
    }
    unsigned char* ds_s = sDS + (i & 1) * DS_TILE;
    const int m_row = c * 64 + warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      stmatrix_x4(ds_s + m_row * 128 +
                      (((2 * kk + (lane >> 4)) ^ (lane & 7)) << 4),
                  da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3]);
    fence_async_smem();

    // dV += bf16(P^T).dout (A from registers; B: the stage's dout
    // MN-major); once both warpgroups' dS^T rows are in shared memory,
    // dQ = dS.K over all 128 keys for this warpgroup's 64 columns (A:
    // dS^T MN-major; B: K MN-major); then dK += bf16(dS^T).Q, which runs
    // while the dQ partial is staged.  Three commit groups.
    fence_regs(pa);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_m64n128k16_rs<1>(dva, pa + 4 * kk,
                             desc(a_do + kk * 16 * 128, Q_BOX));
    wgmma_commit();
    named_sync(1, 256);
    float dq[32];
    fence_regs(dq);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n64k16_ss<1, 1>(dq, desc(a_ds + kk * 16 * 128, DS_TILE),
                               desc(a_kd + kk * 16 * 128, KV_BOX), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_m64n128k16_rs<1>(dka, da + 4 * kk,
                             desc(a_q + kk * 16 * 128, Q_BOX));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(dq);
    // stage the dQ partial (query rows 16 warp + g, + 8; columns 8 e8 +
    // 2 tq, + 1 of box e8 / 4) once the writer has handed the staging
    // tile back; the writer adds it into dq_acc
    mbar_wait(&dq_free[c], (i & 1) ^ 1);
#pragma unroll
    for (int e8 = 0; e8 < 8; ++e8)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = warp * 16 + g + 8 * h;
        const int chunk = (2 * (e8 % 4) + (tq >> 1)) ^ g;
        *reinterpret_cast<float2*>(dq_s + (e8 / 4) * DQ_BOX + row * 128 +
                                   chunk * 16 + 8 * (tq & 1)) =
            make_float2(dq[4 * e8 + 2 * h], dq[4 * e8 + 2 * h + 1]);
      }
    fence_async_smem();
    mbar_arrive(&dq_full[c]);
    wgmma_wait<0>();
    fence_regs(dka);
    fence_regs(dva);
    fence_regs(pa);
    fence_regs(da);
    if (leader) mbar_arrive(&empty[st]);

  }

  // dK (times scale) and dV of this warpgroup's keys; rows past Lk are
  // not written
  const long long ld = (long long)N * D;
  const int r0 = k0 + key_r;
  const long long off = ((long long)b * Lk + r0) * ld + n * D + 2 * tq;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    if (r0 < Lk) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * e) =
          pack_bf16(dka[4 * e] * scale, dka[4 * e + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * e) =
          pack_bf16(dva[4 * e], dva[4 * e + 1]);
    }
    if (r0 + 8 < Lk) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * ld + 8 * e) =
          pack_bf16(dka[4 * e + 2] * scale, dka[4 * e + 3] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * ld + 8 * e) =
          pack_bf16(dva[4 * e + 2], dva[4 * e + 3]);
    }
  }
}

// dq [B, Lq, N, D] = bf16(scale * dq_acc [B*N, Lq_pad, D]); 8 columns a
// thread
__global__ void dq_convert_kernel(const float* __restrict__ acc,
                                  bf16* __restrict__ dq, int N, int Lq,
                                  int Lq_pad, long long rows, float scale) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = idx / (D / 8);   // (b * Lq + i) * N + n
  if (row >= rows) return;
  const int c8 = (int)(idx % (D / 8)) * 8;
  const int n = (int)(row % N);
  const long long bi = row / N;
  const long long b = bi / Lq, i = bi % Lq;
  const float* src = acc + ((b * N + n) * Lq_pad + i) * D + c8;
  const float4 x0 = *reinterpret_cast<const float4*>(src);
  const float4 x1 = *reinterpret_cast<const float4*>(src + 4);
  uint4 o;
  o.x = pack_bf16(x0.x * scale, x0.y * scale);
  o.y = pack_bf16(x0.z * scale, x0.w * scale);
  o.z = pack_bf16(x1.x * scale, x1.y * scale);
  o.w = pack_bf16(x1.z * scale, x1.w * scale);
  *reinterpret_cast<uint4*>(dq + row * D + c8) = o;
}

}  // namespace

// The whole backward on `stream`: the main kernel adds into dq_acc
// ([B*N, Lq_pad, D] fp32, zero on entry), then dq = bf16(scale * dq_acc).
// lse, delta: [B*N, Lq_pad] fp32; iv: [4, Lq_pad] int32 (s1, e1, s2, e2);
// states: [ceil(Lk / 128), ceil(Lq / 64)] uint8 tile states (0 dead, 1
// partial, 2 fully visible, rows past Lq making a tile partial).  Returns
// the CUDA error code (0 on success; cudaErrorInvalidValue for shapes the
// kernel does not take).
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq_acc, void* dq,
                                void* dk, void* dv, const void* iv,
                                const void* states, int B, int N, int Lq,
                                int Lk, int Lq_pad, float scale,
                                void* stream) {
  if (B <= 0 || N <= 0 || Lq <= 0 || Lk <= 0 || Lq_pad % BQ != 0 ||
      Lq_pad < Lq || (Lq + BQ - 1) / BQ > MAX_TILES)
    return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  const uint64_t row = D * sizeof(bf16);   // bytes of one head's row
  {
    const uint64_t dims[4] = {D, (uint64_t)N, (uint64_t)Lq, (uint64_t)B};
    const uint64_t strides[3] = {row, row * N, row * N * Lq};
    const uint32_t box[4] = {64, 1, BQ, 1};
    if (int e = bf16_map(&maps.q, q, 4, dims, strides, box)) return e;
    if (int e = bf16_map(&maps.dout, dout, 4, dims, strides, box)) return e;
  }
  {
    const uint64_t dims[4] = {D, (uint64_t)N, (uint64_t)Lk, (uint64_t)B};
    const uint64_t strides[3] = {row, row * N, row * N * Lk};
    const uint32_t box[4] = {64, 1, BK, 1};
    if (int e = bf16_map(&maps.k, k, 4, dims, strides, box)) return e;
    if (int e = bf16_map(&maps.v, v, 4, dims, strides, box)) return e;
  }
  {
    const uint64_t frow = D * sizeof(float);
    const uint64_t dims[3] = {D, (uint64_t)Lq_pad, (uint64_t)B * N};
    const uint64_t strides[2] = {frow, frow * Lq_pad};
    const uint32_t box[3] = {32, BQ, 1};
    if (int e = f32_map(&maps.dq, dq_acc, 3, dims, strides, box)) return e;
  }
  dim3 grid((Lk + BK - 1) / BK, B * N);
  flash_bwd_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
      maps, (const float*)lse, (const float*)delta, (const int*)iv,
      (const unsigned char*)states, (bf16*)dk, (bf16*)dv, N, Lq, Lk, Lq_pad,
      scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long rows = (long long)B * Lq * N;
  const long long threads = rows * (D / 8);
  dq_convert_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
      (const float*)dq_acc, (bf16*)dq, N, Lq, Lq_pad, rows, scale);
  return (int)cudaGetLastError();
}
