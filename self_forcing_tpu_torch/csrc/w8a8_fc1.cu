// w8a8_fc1: the W8A8 products of the port on one int8 wgmma mainloop, in
// three epilogues: the FFN's fc1 (dequantize, bias, gelu, int8 per group
// of the hidden's columns), a linear (dequantize, bias, bf16) and the
// FFN's fc2 (each group's int32 partial folded into f32 with its scale,
// then scale, bias, bf16).
//
// Replaces the TPU kernels of self_forcing_tpu/ops/pallas_matmul.py:
//   w8a8_ffn1_xq_launch    <- _ffn1_kernel       (w8a8_ffn with s_x)
//                          <- _ffn1_kernel_bf16x (w8a8_ffn, s_x=None,
//                             after quantize_rows_launch of csrc/w8a8.cu)
//   w8a8_linear_xq_launch  <- _kernel            (w8a8_matmul)
//                          <- _kernel_bf16x      (w8a8_matmul_bf16x,
//                             after quantize_rows_launch)
//   w8a8_ffn2_launch       <- _ffn2_kernel       (w8a8_ffn)
// The raw-x modes of the TPU quantize x per token inside the kernel; here
// ops/cuda_matmul.py runs quantize_rows first (the same function: floor
// 1e-8, true division by 127, half to even), so one int8 mainloop serves
// every entry point.
//
// Functions (f32, every product and sum rounded on its own, in the TPU
// kernels' order; no FMA contraction):
//   fc1:     h = gelu_tanh(float(x_q . w_q) * s_x * w_scale + b), then h
//            quantized per (token, group of TG columns): s = max(absmax,
//            1e-6) / 127, q = clip(rint(h / s), -127, 127) -> int8 h_q
//            [M, H] and f32 h_s [M, H / TG]
//   linear:  out = bf16(float(x_q . w_q) * s_x * w_scale + b)
//   fc2:     acc = sum over the groups g of TG hidden columns, in order,
//            of float(h_q[:, g] . w2_q[g, :]) * h_s[m, g];
//            out = bf16(acc * w2_scale + b2)
// The int32 sums are exact in any order of K.
//
// What bounds them on the H100: at the Wan-1.3B FFN (M 4680, K 1536, H
// 8960) fc1 does 129 G int8 operations against ~63 MB, and fc2 the same
// 129 G against ~70 MB: 0.065 ms each at the 1979 TOP/s int8 peak, bound
// by the tensor cores (14B: K 5120, H 13824, 662 G, 0.335 ms each).
// Design: a work item is 128 rows x BN columns; persistent CTAs (as many
// as the card holds) walk the items; one producer thread streams 128-byte
// K steps of x (128 rows) and of w (BN rows) into a ring of stages by TMA
// (128-byte swizzle; a box past M or K reads zeros), full / empty
// mbarriers, running on into the next item while the consumers finish
// this one; two consumer warpgroups of 64 rows run int8 wgmma m64nBNk32
// (4 a stage) with both operands in shared memory and hold the int32 tile
// in registers (BN / 2 a thread; setmaxnreg 24 / 240).  The first wgmma
// of an item (fc2: of a group) runs with the scale-d predicate off, which
// zeroes the tile.  fc1 needs each row's maximum over all TG columns of
// its group before any int8 of the group is written, and 128 x TG int32
// (TG up to 896) do not fit one CTA's registers: the group's columns are
// split over a cluster of 4 CTAs (BN = TG / 4), which take the same
// items.  Each thread turns its accumulators into gelu values in place,
// the quad reduces each row's maximum, and its owner stores it into every
// CTA of the cluster (st.async, counted on that CTA's mbarrier for the
// item's parity); once all four partials have landed each CTA quantizes
// (the division by the group scale as a reciprocal and one FMA
// correction, which gives the correctly rounded quotient) into a staged
// tile, which the consumers copy out in 16-byte pieces of rows (2-byte
// stores from the accumulator layout cost more than the products here).
// Items run through every row tile of a group before the next group, so
// the clusters at work read one group's w slice and keep x in L2 (W1 is
// 71 MB at 14B, more than L2).  The linear needs no maximum: a cluster of
// 1, BN = tn / 4 (64 where tn / 4 would leave SMs without an item), the
// output staged as bf16 rows.  fc2 is the linear's tile with a second, f32 tile
// beside the int32 one (BN / 2 registers each a thread, so BN <= 192):
// after a group's last K step (TG / 128 of them) the consumers drain the
// wgmma queue and fold the int32 tile into the f32 one with the two rows'
// scales of that group (read one group ahead), so the tensor cores idle
// for one fold every TG / 128 steps.  The widest tile buys more than
// hiding that idle would: a second int32 tile, to fold one group while
// the next one's products run, measured no faster at BN 128.  The
// epilogues (fc1's gelu, tanhf, quantization; the stores) do not overlap
// the products, as the tiles fill the consumers' registers (the bring-up
// steps: PERF.md, Findings).

#include <cstring>

#include "hopper.cuh"

using namespace sf_hopper;

namespace {

typedef __nv_bfloat16 bf16;

constexpr float HIDDEN_FLOOR = 1e-6f;  // gelu hidden: rows can be ~0
constexpr int BM = 128;                // rows a CTA
constexpr int BK = 128;                // bytes of K a stage (a swizzled row)
constexpr int CONSUMERS = 2;           // warpgroups of 64 rows
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer
constexpr int A_BYTES = BM * BK;
constexpr int CLUSTER = 4;             // CTAs sharing one fc1 group
constexpr int SMEM_MAX = 232448;       // shared memory a CTA may use
enum Mode { FFN1 = 0, LINEAR = 1, FC2 = 2 };

template <int BN, int MODE>
struct Tile {
  static constexpr int STAGE = A_BYTES + BN * BK;
  // the staged output tile: int8 (fc1) or bf16 (linear, fc2) rows, padded
  // by 16 bytes (rows then fall on different banks)
  static constexpr int LD = (MODE == FFN1 ? BN : 2 * BN) + 16;
  // fc1's partial row maxima
  static constexpr int RED = MODE == FFN1 ? 2 * CLUSTER * BM * 4 : 0;
  static constexpr int FIT =
      (SMEM_MAX - 1024 - BM * LD - RED - 18 * 8) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  // ring | staged tile | red | full, empty, red_full barriers
  static constexpr int SMEM =
      1024 + STAGES * STAGE + BM * LD + RED + (2 * STAGES + 2) * 8;
};

struct Maps {
  CUtensorMap x;   // int8 (K, M), box (BK, BM)
  CUtensorMap w;   // int8 (K, N), box (BK, BN)
};

// clip(rint(v / s), -127, 127) with v / s correctly rounded (true
// division) from rc = RN(1 / s): q0 = RN(v rc) is within an ulp of v / s,
// the residual v - s q0 is exact by FMA, and q0 + residual * rc rounds to
// RN(v / s) (Markstein's theorem; |v| <= 127 s and s >= 1e-6 / 127 keep
// every step normal where the rounding decides anything)
__device__ __forceinline__ int quant1(float v, float s, float rc) {
  const float q0 = __fmul_rn(v, rc);
  const float q = __fmaf_rn(__fmaf_rn(-q0, s, v), rc, q0);
  return __float2int_rn(fminf(fmaxf(rintf(q), -127.f), 127.f));
}

__device__ __forceinline__ uint16_t pack2(int a, int b) {
  return (uint16_t)((a & 0xff) | ((b & 0xff) << 8));
}

// gelu with the tanh approximation, in the order of jax.nn.gelu
__device__ __forceinline__ float gelu_tanh(float x) {
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner =
      __fmul_rn(0.7978845834732056f, __fadd_rn(x, __fmul_rn(0.044715f, x3)));
  return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.f, tanhf(inner))));
}

// The consumers copy a staged tile of BM rows of BYTES bytes (row pitch
// LD in shared memory) to global rows m0.. (those below M) of pitch
// `pitch` bytes at byte column c0, 16 bytes a thread a step.
template <int BYTES, int LD>
__device__ __forceinline__ void store_rows(const unsigned char* stage,
                                           unsigned char* dst, int m0, int M,
                                           long long pitch, int c0) {
  constexpr int CH = BYTES / 16;
  for (int q = threadIdx.x; q < BM * CH; q += 128 * CONSUMERS) {
    const int r = q / CH, k = q % CH;
    if (m0 + r < M)
      *reinterpret_cast<uint4*>(dst + (m0 + r) * pitch + c0 + 16 * k) =
          *reinterpret_cast<const uint4*>(stage + r * LD + 16 * k);
  }
}

// y * w_scale + b, rounded step by step
__device__ __forceinline__ float scale_bias(float y, float w, float b) {
  return __fadd_rn(__fmul_rn(y, w), b);
}

// float(acc) * s_x * w_scale + b, rounded step by step
__device__ __forceinline__ float dequant(int acc, float sx, float w,
                                         float b) {
  return scale_bias(__fmul_rn(__int2float_rn(acc), sx), w, b);
}

// Persistent: the CTAs of cluster c (CL of them; CL = 4 for fc1, 1
// otherwise) walk the work items c, c + clusters, ...; item i is the row
// tile i % mtiles of group (fc1) or column tile (linear, fc2) i / mtiles.
// N is H (fc1) or the output width; K is H for fc2, whose s_x is h_s
// [M, K / tg]; tg the group width (fc1, fc2).
template <int BN, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    fc1_kernel(const __grid_constant__ Maps maps,
               const float* __restrict__ s_x,
               const float* __restrict__ w_scale,
               const float* __restrict__ bias, int8_t* __restrict__ hq,
               float* __restrict__ hs, bf16* __restrict__ out, int M, int K,
               int N, int tg, int mtiles, int items) {
  using T = Tile<BN, MODE>;
  constexpr int CL = MODE == FFN1 ? CLUSTER : 1;
  static_assert(MODE != FC2 || BN <= 192, "fc2 keeps two tiles of BN / 2");
  constexpr uint32_t RED_TX = CL * BM * 4;   // a cluster's partial maxima
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* stage = ring + T::STAGES * T::STAGE;   // the output tile
  // red[b][p][r]: CTA p's maximum of row r over its columns, for the
  // items of parity b
  float* red = reinterpret_cast<float*>(stage + BM * T::LD);
  uint64_t* full = reinterpret_cast<uint64_t*>(stage + BM * T::LD + T::RED);
  uint64_t* empty = full + T::STAGES;
  uint64_t* red_full = empty + T::STAGES;   // [b]: all CL partials landed

  const int rank = CL > 1 ? (int)cluster_rank() : 0;
  const int cid = blockIdx.x / CL, ncl = gridDim.x / CL;
  const int nk = (K + BK - 1) / BK;
  // K steps of one int32 partial: a group of fc2, else the whole K
  const int spg = MODE == FC2 ? tg / BK : nk;
  const int wg = threadIdx.x / 128;
  auto row0_of = [&](int item) { return (item % mtiles) * BM; };
  auto col0 = [&](int item) {
    return MODE == FFN1 ? (item / mtiles) * tg + rank * BN
                        : (item / mtiles) * BN;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init(&red_full[0], 1);
    mbar_init(&red_full[1], 1);
    fence_barrier_init();
    if (MODE == FFN1) {
      mbar_expect_tx(&red_full[0], RED_TX);
      mbar_expect_tx(&red_full[1], RED_TX);
    }
  }
  __syncthreads();
  if (CL > 1) {   // every CTA's barriers are ready before a partner writes
    cluster_arrive();
    cluster_wait();
  }

  if (wg == CONSUMERS) {
    // ---- producer: one thread streams the K steps of x and w, item
    // after item, through one ring ----
    regs_dealloc<24>();
    if (threadIdx.x == 128 * CONSUMERS) {
      int it = 0;
      for (int item = cid; item < items; item += ncl) {
        const int m0 = row0_of(item), n0 = col0(item);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int st = it % T::STAGES;
          unsigned char* a = ring + st * T::STAGE;
          mbar_wait(&empty[st], ((it / T::STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[st], T::STAGE);
          tma_load_2d(a, &maps.x, &full[st], kt * BK, m0);
          tma_load_2d(a + A_BYTES, &maps.w, &full[st], kt * BK, n0);
        }
      }
    }
    __syncwarp();
    if (CL > 1) {   // no CTA leaves while a partner may write to it
      cluster_arrive();
      cluster_wait();
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64 wg .. + 63 of each item ----
  regs_alloc<240>();
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bool leader = threadIdx.x % 128 == 0;
  // accumulator d[4 i + e]: row rl (e < 2) or rl + 8, column 8 i + 2 t +
  // (e & 1) of the tile
  const int rl = wg * 64 + warp * 16 + g;

  int acc[BN / 2];
  // fc2's f32 tile (the sum of the folded groups) and the two rows' scales
  // of the group being multiplied
  float facc[MODE == FC2 ? BN / 2 : 1];
  float hs0 = 0.f, hs1 = 0.f;
  const int ng = MODE == FC2 ? K / tg : 1;
  int it = 0, j = 0;
  for (int item = cid; item < items; item += ncl, ++j) {
    const int m0 = row0_of(item), n0 = col0(item);
    const int row0 = m0 + rl, row1 = row0 + 8;
    const float* hs_row0 = s_x + (long long)row0 * ng;
    const float* hs_row1 = s_x + (long long)row1 * ng;
    if constexpr (MODE == FC2) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) facc[i] = 0.f;
      hs0 = row0 < M ? __ldg(hs_row0) : 0.f;
      hs1 = row1 < M ? __ldg(hs_row1) : 0.f;
    }
    int gs = 0, grp = 0;   // K step in the group, group
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int st = it % T::STAGES;
      const uint32_t a = smem_u32(ring + st * T::STAGE + wg * 64 * BK);
      const uint32_t b = smem_u32(ring + st * T::STAGE + A_BYTES);
      mbar_wait(&full[st], (it / T::STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        WgmmaS8<BN>::run(acc, desc_sw128(a + 32 * kk, 16, 1024),
                         desc_sw128(b + 32 * kk, 16, 1024), kk > 0 || gs > 0);
      wgmma_commit();
      // the previous step's products are done: hand its stage back
      wgmma_wait<1>();
      fence_regs(acc);
      if (kt > 0 && leader) mbar_arrive(&empty[(it - 1) % T::STAGES]);
      if (++gs == spg) {
        gs = 0;
        if constexpr (MODE == FC2) {
          // the group's int32 partial times its scales into the f32 tile
          wgmma_wait<0>();
          fence_regs(acc);
#pragma unroll
          for (int i = 0; i < BN / 2; ++i)
            facc[i] = __fadd_rn(facc[i], __fmul_rn(__int2float_rn(acc[i]),
                                                   (i & 2) ? hs1 : hs0));
          if (++grp < ng) {
            hs0 = row0 < M ? __ldg(hs_row0 + grp) : 0.f;
            hs1 = row1 < M ? __ldg(hs_row1 + grp) : 0.f;
          }
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (leader) mbar_arrive(&empty[(it - 1) % T::STAGES]);

    const float* ws = w_scale + n0;
    const float* bs = bias + n0;

    if constexpr (MODE != FFN1) {
      const float sx0 = MODE == LINEAR && row0 < M ? s_x[row0] : 0.f;
      const float sx1 = MODE == LINEAR && row1 < M ? s_x[row1] : 0.f;
      named_sync(1, 128 * CONSUMERS);   // the last item's copy is out
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int c = 8 * i + 2 * t;
        const float2 w = __ldg(reinterpret_cast<const float2*>(ws + c));
        const float2 b = __ldg(reinterpret_cast<const float2*>(bs + c));
        float y[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (MODE == FC2)
            y[e] = facc[4 * i + e];
          else
            y[e] = __fmul_rn(__int2float_rn(acc[4 * i + e]),
                             e < 2 ? sx0 : sx1);
        }
        unsigned char* at = stage + rl * T::LD + 2 * c;
        *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(
            scale_bias(y[0], w.x, b.x), scale_bias(y[1], w.y, b.y));
        *reinterpret_cast<__nv_bfloat162*>(at + 8 * T::LD) =
            __floats2bfloat162_rn(scale_bias(y[2], w.x, b.x),
                                  scale_bias(y[3], w.y, b.y));
      }
      named_sync(1, 128 * CONSUMERS);
      store_rows<2 * BN, T::LD>(stage,
                                reinterpret_cast<unsigned char*>(out), m0,
                                M, 2LL * N, 2 * n0);
    } else {
      const float sx0 = row0 < M ? s_x[row0] : 0.f;
      const float sx1 = row1 < M ? s_x[row1] : 0.f;
      // gelu in place (as f32 bits) and the rows' maxima over this CTA's
      // BN columns (the quad holds them all)
      float mx0 = 0.f, mx1 = 0.f;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int c = 8 * i + 2 * t;
        const float2 w = __ldg(reinterpret_cast<const float2*>(ws + c));
        const float2 b = __ldg(reinterpret_cast<const float2*>(bs + c));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float h = gelu_tanh(dequant(acc[4 * i + e],
                                            e < 2 ? sx0 : sx1,
                                            (e & 1) ? w.y : w.x,
                                            (e & 1) ? b.y : b.x));
          if (e < 2)
            mx0 = fmaxf(mx0, fabsf(h));
          else
            mx1 = fmaxf(mx1, fabsf(h));
          acc[4 * i + e] = __float_as_int(h);
        }
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
      }
      // this CTA's partial maxima into red[b][rank] of every CTA of the
      // cluster; the group's maxima once all CL partials have landed here
      const int bsel = j & 1;
      float* mine = red + (bsel * CL + rank) * BM;
      if (t == 0) {
#pragma unroll
        for (int p = 0; p < CL; ++p) {
          const uint32_t bar = map_rank(smem_u32(&red_full[bsel]), p);
          st_async_f32(map_rank(smem_u32(mine + rl), p), mx0, bar);
          st_async_f32(map_rank(smem_u32(mine + rl + 8), p), mx1, bar);
        }
      }
      mbar_wait(&red_full[bsel], (j >> 1) & 1);
      // re-arm for item j + 2: no partner sends it before every thread
      // here has sent item j + 1, so after these reads
      if (threadIdx.x == 0) mbar_expect_tx(&red_full[bsel], RED_TX);
      const float* part = red + bsel * CL * BM;
#pragma unroll
      for (int p = 0; p < CL; ++p) {
        mx0 = fmaxf(mx0, part[p * BM + rl]);
        mx1 = fmaxf(mx1, part[p * BM + rl + 8]);
      }
      const float s0 = __fdiv_rn(fmaxf(mx0, HIDDEN_FLOOR), 127.f);
      const float s1 = __fdiv_rn(fmaxf(mx1, HIDDEN_FLOOR), 127.f);
      const float r0 = __frcp_rn(s0), r1 = __frcp_rn(s1);
      const int ng = N / tg, grp = item / mtiles;
      if (rank == 0 && t == 0) {
        if (row0 < M) hs[(long long)row0 * ng + grp] = s0;
        if (row1 < M) hs[(long long)row1 * ng + grp] = s1;
      }
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        unsigned char* at = stage + rl * T::LD + 8 * i + 2 * t;
        *reinterpret_cast<uint16_t*>(at) =
            pack2(quant1(__int_as_float(acc[4 * i]), s0, r0),
                  quant1(__int_as_float(acc[4 * i + 1]), s0, r0));
        *reinterpret_cast<uint16_t*>(at + 8 * T::LD) =
            pack2(quant1(__int_as_float(acc[4 * i + 2]), s1, r1),
                  quant1(__int_as_float(acc[4 * i + 3]), s1, r1));
      }
      named_sync(1, 128 * CONSUMERS);
      store_rows<BN, T::LD>(stage, reinterpret_cast<unsigned char*>(hq), m0,
                            M, (long long)N, n0);
    }
  }
  if (CL > 1) {
    cluster_arrive();
    cluster_wait();
  }
}

template <int BN, int MODE>
int launch(const void* xq, const float* sx, const void* w, const float* ws,
           const float* b, int8_t* hq, float* hs, bf16* out, int M, int K,
           int N, int tg, cudaStream_t stream) {
  using T = Tile<BN, MODE>;
  constexpr int CL = MODE == FFN1 ? CLUSTER : 1;
  auto kernel = fc1_kernel<BN, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  {
    const uint64_t dims[2] = {(uint64_t)K, (uint64_t)M};
    const uint64_t strides[1] = {(uint64_t)K};
    const uint32_t box[2] = {BK, BM};
    if (int e = u8_map(&maps.x, xq, 2, dims, strides, box)) return e;
  }
  {
    const uint64_t dims[2] = {(uint64_t)K, (uint64_t)N};
    const uint64_t strides[1] = {(uint64_t)K};
    const uint32_t box[2] = {BK, BN};
    if (int e = u8_map(&maps.w, w, 2, dims, strides, box)) return e;
  }
  cudaLaunchConfig_t cfg;
  memset(&cfg, 0, sizeof(cfg));
  const int mtiles = (M + BM - 1) / BM;
  const int items = mtiles * (MODE == FFN1 ? N / tg : N / BN);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // as many clusters as the card holds at once (asked once)
  static int resident = 0;
  if (resident == 0) {
    cfg.gridDim = dim3(CL * 132);
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    resident = n > 0 ? n : 1;
  }
  cfg.gridDim = dim3(CL * (items < resident ? items : resident));
  err = cudaLaunchKernelEx(&cfg, kernel, maps, sx, ws, b, hq, hs, out, M, K,
                           N, tg, mtiles, items);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The instantiation of tile width bn = (group or column tile) / 4, in
// {32, 64, ..., 224}.
template <int MODE>
int launch_bn(int bn, const void* xq, const float* sx, const void* w,
              const float* ws, const float* b, int8_t* hq, float* hs,
              bf16* out, int M, int K, int N, int tg, cudaStream_t st) {
  switch (bn) {
#define SF_BN(V) \
  case V:      \
    return launch<V, MODE>(xq, sx, w, ws, b, hq, hs, out, M, K, N, tg, st);
    SF_BN(32) SF_BN(64) SF_BN(96) SF_BN(128) SF_BN(160) SF_BN(192)
    SF_BN(224)
#undef SF_BN
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x_q [M, K] int8 with s_x [M] f32, w1_t [H, K] int8, w_scale / b [H] f32
// -> h_q [M, H] int8, h_s [M, H / tg] f32.  K % 16 == 0, tg in {128, 256,
// ..., 896}, H % tg == 0.  Returns the CUDA error code (0 on success).
extern "C" int w8a8_ffn1_xq_launch(const void* xq, const void* sx,
                                   const void* w1t, const void* ws,
                                   const void* b, void* hq, void* hs, int M,
                                   int K, int H, int tg, void* stream) {
  if (M < 0 || K <= 0 || K % 16 || tg % 128 || tg < 128 || tg > 896 ||
      H % tg)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  return launch_bn<FFN1>(tg / CLUSTER, xq, (const float*)sx, w1t,
                         (const float*)ws, (const float*)b, (int8_t*)hq,
                         (float*)hs, nullptr, M, K, H, tg,
                         (cudaStream_t)stream);
}

// x_q [M, K] int8 with s_x [M] f32, w_t [N, K] int8, w_scale / b [N] f32
// -> out [M, N] bf16, in column tiles of tn / 4 (tn in {128, ..., 896},
// N % tn == 0), or of 64 where those give fewer items than the card has
// SMs (the cross k / v of 512 context tokens).  K % 16 == 0.
extern "C" int w8a8_linear_xq_launch(const void* xq, const void* sx,
                                     const void* wt, const void* ws,
                                     const void* b, void* out, int M, int N,
                                     int K, int tn, void* stream) {
  if (M < 0 || K <= 0 || K % 16 || tn % 128 || tn < 128 || tn > 896 ||
      N % tn)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const bool few = (M + BM - 1) / BM * (N / (tn / 4)) < sms;
  return launch_bn<LINEAR>(few ? 64 : tn / 4, xq, (const float*)sx, wt,
                           (const float*)ws, (const float*)b, nullptr,
                           nullptr, (bf16*)out, M, K, N, tn,
                           (cudaStream_t)stream);
}

// h_q [M, H] int8 with its group scales h_s [M, H / tg] f32, w2_t [N, H]
// int8, w_scale / b [N] f32 -> out [M, N] bf16, in column tiles of 192,
// 160 or 128 (the widest that divides N).  tg in {128, 256, ..., 896},
// H % tg == 0, N % 128 == 0.
extern "C" int w8a8_ffn2_launch(const void* hq, const void* hs,
                                const void* w2t, const void* ws,
                                const void* b, void* out, int M, int N,
                                int H, int tg, void* stream) {
  if (M < 0 || N <= 0 || N % 128 || tg % 128 || tg < 128 || tg > 896 ||
      H % tg)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  // the widest tile whose two register tiles fit the consumers' 240
  // registers: 96 + 96 a thread at 192
  const float* s = (const float*)hs;
  const float* w = (const float*)ws;
  bf16* o = (bf16*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (N % 192 == 0)
    return launch<192, FC2>(hq, s, w2t, w, (const float*)b, nullptr, nullptr,
                            o, M, H, N, tg, st);
  if (N % 160 == 0)
    return launch<160, FC2>(hq, s, w2t, w, (const float*)b, nullptr, nullptr,
                            o, M, H, N, tg, st);
  return launch<128, FC2>(hq, s, w2t, w, (const float*)b, nullptr, nullptr,
                          o, M, H, N, tg, st);
}
