// Causal 3x3x3 convolutions of the Wan VAE as one implicit GEMM, with an
// optional RMS-norm + SiLU prologue and an optional residual epilogue.
//
// Replaces the TPU kernels of self_forcing_tpu/ops/pallas_conv.py (all four
// launch conv3d_launch; ops/cuda_conv.py counts each by its entry point;
// float32 inputs of _conv3d_kernel and _conv2d_kernel launch
// conv3d_f32_launch, counted as conv3d_f32):
//   taps_t 3                    <- _conv3d_kernel    (_conv3d_fused)
//   taps_t 1, frame offset tau  <- _conv2d_kernel    (_conv2d_9tap, the
//                                   split route of causal_conv3d_pallas)
//   taps_t 3                    <- _conv3d_v2_kernel (causal_conv3d_pallas_v2)
//   taps_t 3, NORM (+ RES)      <- _nsc3d_kernel     (norm_silu_conv3d_pallas)
//   rms_inv_launch: the nsc prologue's per-pixel inverse norm, a pre-pass.
//
// Function (f32 accumulation, one rounding to bf16 at the store):
//   out[b, t, h, w, n] = bias[n] (+ res[b, t, h, w, n])
//     + sum over taps (kt < taps_t, di, dj < 3) and channels c of
//       A[b, t + tau0 + kt, h + di - 1, w + dj - 1, c] * W[n, kt, di, dj, c]
// where timeline frame f < 2 is cache[b, f] and f >= 2 is x[b, f - 2] (two
// pointers, no concatenation), and A is zero outside the frame.  With NORM
// A = bf16(u * sigmoid(u)), u = x * inv * gscale * gamma[c] in f32, inv =
// rsqrt(sum_c x^2 + eps) of the raw pixel (pixels outside the frame stay
// zero: silu(norm(0)) is 0 as in the TPU kernel).
//
// What bounds it on the H100: the VAE's convs do 2*27*C*Cout products a
// pixel (96-384 channels: 0.5-8 MFLOP) against 2*(C + Cout) bytes, far
// above the card's ~295 FLOP/byte: bound by the tensor cores.
//
// Two routes, chosen by shape up front (ops/cuda_conv.py::conv_plan
// decides, conv3d_launch checks its plan; never a fallback):
//
// WIDE (C % 8 == 0: every conv of the 'pallas' and 'fused' paths but the
// RGB input), wgmma + TMA on halo tiles.  A tile is TR = 4 image rows x
// TW = 64 columns of one frame (256 output pixels) by bn output channels
// (192, 128, 96, 64 or 32; ops/cuda_conv.py::conv_plan picks it, a tile
// past Cout computing zeros that are not stored).  Its A operand for one
// temporal tap and 32 channels is ONE halo box of (4 + 2) x (64 + 2)
// pixels of the timeline frame, loaded by TMA from the x or the cache
// tensor map (whichever holds the frame) at (h0 - 1, w0 - 1): TMA's zero
// fill past the frame's edges is the conv's padding.  The box lands
// unswizzled as [8-channel group][pixel][16 bytes] (4 TMA boxes of 8
// channels, each 128-byte aligned), wgmma's no-swizzle K-major layout, in
// which a 64-pixel run of an image row is 8 core matrices 128 bytes
// apart: the 9 spatial taps read the same box, tap (di, dj) starting
// (di * 66 + dj) pixels later, so each staged pixel is loaded once for 9
// products.  B is the weights' K-major copy [Cout, 27, Cp]
// (ops/cuda_conv.py::kernel_weight), one 64-byte-swizzled TMA box of bn
// rows x 32 channels a tap.  One producer thread feeds two rings (3 halo
// and 8 tap stages, 2 and 6 at bn 192; full / empty mbarriers); two
// consumer warpgroups (setmaxnreg 240) each own 2 of the tile's rows (two
// m64nBNk16 accumulators: 192 registers at bn 192, where ptxas reports
// 120-136 bytes of spill) and release a tap's stage once its
// products retire; the 9 taps of a K step are unrolled, their descriptors
// constant offsets of one (the consumers' few instructions between
// wgmma batches are the critical path: the PERF.md bring-up table).  The
// grid is persistent (one CTA an SM walking the items); the output is
// staged in padded shared rows and stored 16 bytes at a time (2 where
// Cout % 8 != 0: the RGB head).  NORM: the consumers activate each staged
// halo box once, in place, before its 9 taps read it (pixels past the
// frame stay zero).  Split-K for convs of few tiles and many K steps (the
// encoder head, 384 -> 32 at 60x104; never with NORM): the item list is
// (tile, channel tile, split), each split a run of the K steps (temporal
// tap x 32 channels), written as f32 partials [splits, M, Cout];
// conv_igemm_reduce sums them in split order, adds bias and rounds once,
// so a run is deterministic.  Columns of a 64-wide tile past
// W (W = 104: 24 of the second tile) are computed on zeros and not
// stored.
//
// NARROW (the RGB input, C <= 3: its 6-byte pixels are no TMA stride):
// wgmma with A from registers over K packed as 27 taps x C (96), one
// output row of 64 pixels an item, its halo loaded by one TMA box a
// temporal tap (the section below).  No NORM, no split.
//
// FLOAT32 (conv3d_f32_launch: float32 x, C % 4 == 0): the wide route's
// halo tiles, persistent grid and K split in 3xTF32 on tf32 wgmma (the
// last section).

#include <cstring>

#include "attention_common.cuh"
#include "hopper.cuh"

using sf_attn::bf16;
using sf_attn::split_tf32;
using namespace sf_hopper;

namespace {

constexpr int NCACHE = 2;       // cache frames before x on the timeline

__device__ __forceinline__ float silu(float u) {
  return __fdividef(u, 1.f + __expf(-u));
}

// =====================================================================
// WIDE route: wgmma + TMA on halo tiles
// =====================================================================

constexpr int TW = 64;                   // output columns of a tile
constexpr int TR = 4;                    // output rows of a tile
constexpr int HC = TW + 2;               // halo columns
constexpr int HR = TR + 2;               // halo rows
constexpr int HPIX = HR * HC;            // halo pixels (396)
constexpr int CK = 32;                   // channels of a K step
constexpr int G8 = CK / 8;               // 8-channel groups of a step
constexpr int A_BOX = HPIX * 16;         // one 8-channel TMA box (6336)
constexpr int A_BYTES = G8 * A_BOX;      // a K step's halo (25344)
constexpr int A_LBO = 6400;              // bytes between channel groups
                                         // (TMA boxes start 128-aligned)
constexpr int A_STRIDE = G8 * A_LBO;     // a ring stage, 1024-aligned
constexpr int WTHREADS = 384;            // 2 consumer warpgroups + producer
static_assert(G8 * 64 == 256, "NORM: 64 consumer threads a channel group");

template <int BN>
struct Wide {
  // ring depths: 3 halo and 8 tap stages, 2 and 6 at BN 192
  static constexpr int A_STAGES = BN > 128 ? 2 : 3;
  static constexpr int B_STAGES = BN > 128 ? 6 : 8;
  static constexpr int B_BYTES = BN * CK * 2;        // a tap's weights
  static constexpr int LD = 2 * BN + 16;             // a staged output row
  static constexpr int OUT_BYTES = 2 * 2 * TW * LD;  // both warpgroups
  static constexpr int SMEM = 1024 + A_STAGES * A_STRIDE +
                              B_STAGES * B_BYTES + OUT_BYTES +
                              2 * (A_STAGES + B_STAGES) * 8;
  static_assert(SMEM <= 232448, "shared memory");
  static_assert(A_LBO % 128 == 0 && A_LBO >= A_BOX && A_STRIDE % 1024 == 0,
                "halo box alignment");
};

struct WideMaps {
  CUtensorMap x;      // bf16 (C, W, H, B*T), box (8, HC, HR, 1)
  CUtensorMap cache;  // bf16 (C, W, H, B*2), box (8, HC, HR, 1)
  CUtensorMap w;      // bf16 (Cp, 27, Cout), box (CK, 1, BN), 64B swizzle
};

struct WideArgs {
  const float* bias;   // [Cout] or null
  const bf16* res;     // [B, T, H, W, Cout] or null
  const float* inv;    // [B, 2 + T, H, W] (NORM)
  const float* gamma;  // [C] (NORM)
  bf16* out;           // [B, T, H, W, Cout]
  float* ws;           // [splits, B*T*H*W, Cout] f32 partials (splits > 1)
  int B, T, H, W, C, Cout, taps_t, tau0, splits;
  int mt, wt, nt, nch, items;   // row tiles, column tiles, n tiles,
                                // 32-channel steps a temporal tap, items
  float gscale;
};

// One work item: rows h0.. and columns w0.. of frame t of batch b, output
// channels n0.., K steps [k0, k1) (a K step is temporal tap k / nch,
// channels 32 (k % nch)..), split s.  Items run split-fastest, then n
// tile, column tile, row tile, frame.
struct Item {
  int b, t, h0, w0, n0, k0, k1, s;
};

template <int BN, class Args>
__device__ __forceinline__ Item decode_item(const Args& a, int i) {
  Item it;
  it.s = i % a.splits;
  i /= a.splits;
  it.n0 = (i % a.nt) * BN;
  i /= a.nt;
  it.w0 = (i % a.wt) * TW;
  i /= a.wt;
  it.h0 = (i % a.mt) * TR;
  i /= a.mt;
  it.b = i / a.T;
  it.t = i % a.T;
  const int ks = a.taps_t * a.nch;
  it.k0 = (int)((long long)it.s * ks / a.splits);
  it.k1 = (int)((long long)(it.s + 1) * ks / a.splits);
  return it;
}

// Descriptor of an unswizzled K-major operand: 8-row x 16-byte core
// matrices of 128 contiguous bytes; lbo the bytes to the next core matrix
// along K, sbo along M / N.  The start needs only 16-byte alignment, so a
// shifted tap is a shifted start.
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}
// Descriptor of a 64-byte-swizzled K-major operand (rows of 32 bf16, 8
// rows 512 bytes); a 16-wide k-step starts 32 bytes into the row.
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(512 >> 4) << 32) | (2ull << 62);
}

// d += A . B, m64nBNk16 bf16 -> f32, both K-major from shared memory
template <int BN>
struct Mma;
template <>
struct Mma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
        ", %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
};
template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    wgmma_m64n64k16_ss<0, 0>(d, da, db, 1);
  }
};
template <>
struct Mma<192> {
  static __device__ __forceinline__ void run(float (&d)[96], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}"
        ", %96, %97, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(da), "l"(db), "r"(1));
  }
};
template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    wgmma_m64n128k16_ss(d, da, db, 1);
  }
};
template <>
struct Mma<96> {
  static __device__ __forceinline__ void run(float (&d)[48], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}"
        ", %48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <int BN, bool NORM, bool RES>
__global__ void __launch_bounds__(WTHREADS, 1)
    conv_igemm_wgmma(const __grid_constant__ WideMaps maps,
                     const WideArgs a) {
  using L = Wide<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* As = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Bs = As + L::A_STAGES * A_STRIDE;
  unsigned char* Os = Bs + L::B_STAGES * L::B_BYTES;
  uint64_t* a_full = reinterpret_cast<uint64_t*>(Os + L::OUT_BYTES);
  uint64_t* a_empty = a_full + L::A_STAGES;
  uint64_t* b_full = a_empty + L::A_STAGES;
  uint64_t* b_empty = b_full + L::B_STAGES;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::A_STAGES; ++s) {
      mbar_init(&a_full[s], 1);
      mbar_init(&a_empty[s], 2);
    }
    for (int s = 0; s < L::B_STAGES; ++s) {
      mbar_init(&b_full[s], 1);
      mbar_init(&b_empty[s], 2);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread streams each item's halo boxes and taps
    regs_dealloc<24>();
    if (threadIdx.x == 256) {
      int sa = 0, sb = 0;
      uint32_t aph = 1, bph = 1;   // empty waits start at parity 1
      for (int i = blockIdx.x; i < a.items; i += gridDim.x) {
        const Item it = decode_item<BN>(a, i);
        for (int k = it.k0; k < it.k1; ++k) {
          const int kt = k / a.nch, c0 = (k % a.nch) * CK;
          const int f = it.t + a.tau0 + kt;
          unsigned char* dst = As + sa * A_STRIDE;
          mbar_wait(&a_empty[sa], aph);
          mbar_expect_tx(&a_full[sa], A_BYTES);
          const CUtensorMap* m = f < NCACHE ? &maps.cache : &maps.x;
          const int fr = f < NCACHE ? it.b * NCACHE + f
                                    : it.b * a.T + f - NCACHE;
#pragma unroll
          for (int g = 0; g < G8; ++g)
            tma_load_4d(dst + g * A_LBO, m, &a_full[sa], c0 + 8 * g,
                        it.w0 - 1, it.h0 - 1, fr);
          if (++sa == L::A_STAGES) sa = 0, aph ^= 1;
          const int tap0 = 9 * (kt + a.tau0);
          for (int s = 0; s < 9; ++s) {
            mbar_wait(&b_empty[sb], bph);
            mbar_expect_tx(&b_full[sb], L::B_BYTES);
            tma_load_3d(Bs + sb * L::B_BYTES, &maps.w, &b_full[sb], c0,
                        tap0 + s, it.n0);
            if (++sb == L::B_STAGES) sb = 0, bph ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 2 wg, 2 wg + 1 of each tile
  regs_alloc<240>();
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const bool leader = threadIdx.x % 128 == 0;
  const uint32_t a_base = smem_u32(As) + 2 * wg * HC * 16;
  const uint32_t b_base = smem_u32(Bs);
  unsigned char* os = Os + wg * 2 * TW * L::LD;
  const long long M = (long long)a.B * a.T * a.H * a.W;

  float acc0[BN / 2], acc1[BN / 2];
  // NORM: this thread's halo pixels' inverse norms, of temporal tap iv_kt
  constexpr int IVS = (HPIX + 63) / 64;
  float iv[NORM ? IVS : 1];
  // ring positions: the next halo and tap stages and their phase parities,
  // and the last ones taken (released once their products retire)
  int sa = 0, sb = 0, psa = 0, psb = 0;
  uint32_t aph = 0, bph = 0;
  for (int i = blockIdx.x; i < a.items; i += gridDim.x) {
    const Item it = decode_item<BN>(a, i);
    int iv_kt = -1;
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc0[j] = acc1[j] = 0.f;
    for (int k = it.k0; k < it.k1; ++k) {
      mbar_wait(&a_full[sa], aph);
      if constexpr (NORM) {
        // activate the staged box in place, once, before its 9 taps read
        // it: thread (grp, l) takes channel group grp of halo pixels l,
        // l + 64, ..; the pixels' inverse norms stay in registers for the
        // K steps of one temporal tap (zero past the frame, where the box
        // holds zeros: silu(0) = 0)
        const int kt = k / a.nch, c = (k % a.nch) * CK + 8 * (threadIdx.x / 64);
        const int l = threadIdx.x % 64;
        if (kt != iv_kt) {
          iv_kt = kt;
          const float* inv = a.inv + (long long)(it.b * (NCACHE + a.T) + it.t +
                                                 a.tau0 + kt) * a.H * a.W;
#pragma unroll
          for (int j = 0; j < IVS; ++j) {
            const int p = l + 64 * j;
            const int hh = it.h0 - 1 + p / HC, ww = it.w0 - 1 + p % HC;
            iv[j] = p < HPIX && hh >= 0 && hh < a.H && ww >= 0 && ww < a.W
                        ? __ldg(inv + hh * a.W + ww) : 0.f;
          }
        }
        if (c < a.C) {
          const float4 ga = __ldg(reinterpret_cast<const float4*>(a.gamma + c));
          const float4 gb =
              __ldg(reinterpret_cast<const float4*>(a.gamma + c + 4));
          const float gm[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
          unsigned char* st =
              As + sa * A_STRIDE + (threadIdx.x / 64) * A_LBO + l * 16;
#pragma unroll
          for (int j = 0; j < IVS; ++j) {
            if (l + 64 * j >= HPIX) continue;
            uint4* ptr = reinterpret_cast<uint4*>(st + 64 * 16 * j);
            uint4 raw = *ptr;
            bf16* v = reinterpret_cast<bf16*>(&raw);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float u =
                  __bfloat162float(v[e]) * iv[j] * a.gscale * gm[e];
              v[e] = __float2bfloat16(silu(u));
            }
            *ptr = raw;
          }
        }
        fence_async_smem();
        named_sync(1, 256);
      }
      // descriptors of this warpgroup's first row at tap (0, 0); a tap,
      // a row, a 16-channel k-step each add a constant (in 16-byte units)
      const uint64_t da = desc_plain(a_base + sa * A_STRIDE, A_LBO, 128);
#pragma unroll
      for (int s = 0; s < 9; ++s) {
        constexpr uint32_t ROW = HC, KSTEP = 2 * A_LBO / 16;
        const uint32_t tap = (s / 3) * HC + s % 3;
        const uint64_t db = desc_sw64(b_base + sb * L::B_BYTES);
        mbar_wait(&b_full[sb], bph);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          Mma<BN>::run(acc0, da + tap + kk * KSTEP, db + 2 * kk);
          Mma<BN>::run(acc1, da + tap + ROW + kk * KSTEP, db + 2 * kk);
        }
        wgmma_commit();
        // the previous tap's products are done: hand back its stage (and
        // its halo box after a K step's last tap)
        wgmma_wait<1>();
        fence_regs(acc0);
        fence_regs(acc1);
        if (leader && (s > 0 || k > it.k0)) {
          mbar_arrive(&b_empty[psb]);
          if (s == 0) mbar_arrive(&a_empty[psa]);
        }
        psb = sb;
        if (++sb == L::B_STAGES) sb = 0, bph ^= 1;
      }
      psa = sa;
      if (++sa == L::A_STAGES) sa = 0, aph ^= 1;
    }
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);
    if (leader) {
      mbar_arrive(&b_empty[psb]);
      mbar_arrive(&a_empty[psa]);
    }

    // ---- epilogue.  Accumulator d[4 j + e] of row r: tile column
    // 16 warp + g (+ 8 for e >= 2), channel n0 + 8 j + 2 t4 + (e & 1)
    const long long frame = (long long)(it.b * a.T + it.t) * a.H;
    if (a.splits == 1) {
      named_sync(2 + wg, 128);   // the last item's rows are copied out
      auto stage_row = [&](const float(&acc)[BN / 2], int r) {
        const int h = it.h0 + 2 * wg + r;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int col = warp * 16 + g + 8 * half;
          const int w = it.w0 + col;
          const bool live = h < a.H && w < a.W;
          const long long pix = (frame + h) * a.W + w;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int c = 8 * j + 2 * t4, n = it.n0 + c;
            float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
            if (a.bias != nullptr) {   // channels past Cout are not stored
              v0 += n < a.Cout ? __ldg(a.bias + n) : 0.f;
              v1 += n + 1 < a.Cout ? __ldg(a.bias + n + 1) : 0.f;
            }
            if (RES && live) {   // NORM convs have Cout % BN == 0
              const __nv_bfloat162 rr = *reinterpret_cast<
                  const __nv_bfloat162*>(a.res + pix * a.Cout + it.n0 + c);
              v0 += __low2float(rr);
              v1 += __high2float(rr);
            }
            *reinterpret_cast<__nv_bfloat162*>(os + (r * TW + col) * L::LD +
                                               2 * c) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      };
      stage_row(acc0, 0);
      stage_row(acc1, 1);
      named_sync(2 + wg, 128);
      constexpr int CH = 2 * BN / 16;   // 16-byte pieces of a row
      // 16-byte stores where Cout % 8 == 0, else (the RGB head) 2-byte
      // ones; channels past Cout are not stored
      const bool vec = a.Cout % 8 == 0;
      for (int q = threadIdx.x % 128; q < 2 * TW * CH; q += 128) {
        const int row = q / CH, piece = q % CH;
        const int h = it.h0 + 2 * wg + row / TW, w = it.w0 + row % TW;
        const int n = it.n0 + 8 * piece;
        if (h >= a.H || w >= a.W || n >= a.Cout) continue;
        bf16* dst = a.out + ((frame + h) * a.W + w) * a.Cout + n;
        const unsigned char* src = os + row * L::LD + 16 * piece;
        if (vec) {
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(src);
        } else {
          const bf16* v = reinterpret_cast<const bf16*>(src);
          for (int e = 0; e < 8 && n + e < a.Cout; ++e) dst[e] = v[e];
        }
      }
    } else {
      // split-K: this split's f32 partial
      float* wsp = a.ws + (long long)it.s * M * a.Cout + it.n0 + 2 * t4;
      auto store_row = [&](const float(&acc)[BN / 2], int r) {
        const int h = it.h0 + 2 * wg + r;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int w = it.w0 + warp * 16 + g + 8 * half;
          if (h >= a.H || w >= a.W) continue;
          float* dst = wsp + ((frame + h) * a.W + w) * a.Cout;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
            *reinterpret_cast<float2*>(dst + 8 * j) =
                make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
        }
      };
      store_row(acc0, 0);
      store_row(acc1, 1);
    }
  }
}

// out = sum_s ws[s] (in split order) + bias, rounded to bf16 once (F32:
// kept float32); 8 channels a thread (Cout % 8 == 0)
template <bool F32>
__global__ void conv_igemm_reduce(const float* __restrict__ ws, int splits,
                                  long long MN, int Cout,
                                  const float* __restrict__ bias,
                                  void* __restrict__ out) {
  const long long i =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (i >= MN) return;
  float v[8];
  {
    const float4 p = *reinterpret_cast<const float4*>(ws + i);
    const float4 q = *reinterpret_cast<const float4*>(ws + i + 4);
    v[0] = p.x, v[1] = p.y, v[2] = p.z, v[3] = p.w;
    v[4] = q.x, v[5] = q.y, v[6] = q.z, v[7] = q.w;
  }
  for (int s = 1; s < splits; ++s) {
    const float4 p = *reinterpret_cast<const float4*>(ws + s * MN + i);
    const float4 q = *reinterpret_cast<const float4*>(ws + s * MN + i + 4);
    v[0] += p.x, v[1] += p.y, v[2] += p.z, v[3] += p.w;
    v[4] += q.x, v[5] += q.y, v[6] += q.z, v[7] += q.w;
  }
  const int n = (int)(i % Cout);
  if (bias != nullptr)
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += bias[n + e];
  if constexpr (F32) {
    float* o = reinterpret_cast<float*>(out) + i;
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(o + 4) = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    __align__(16) __nv_bfloat162 o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(out) + i) =
        *reinterpret_cast<const uint4*>(o);
  }
}

template <int BN, bool NORM, bool RES>
int launch_wide(const void* x, const void* cache, const void* w, int Cp,
                WideArgs a, int grid, cudaStream_t st) {
  using L = Wide<BN>;
  auto kern = conv_igemm_wgmma<BN, NORM, RES>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return (int)err;
  WideMaps maps;
  memset(&maps, 0, sizeof(maps));
  const uint64_t px = 2ull * a.C;   // bytes a pixel
  {
    uint64_t dims[4] = {(uint64_t)a.C, (uint64_t)a.W, (uint64_t)a.H,
                        (uint64_t)a.B * a.T};
    const uint64_t strides[3] = {px, px * a.W, px * a.W * a.H};
    const uint32_t box[4] = {8, HC, HR, 1};
    if (int e = bf16_map(&maps.x, x, 4, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_NONE))
      return e;
    dims[3] = (uint64_t)a.B * NCACHE;
    if (int e = bf16_map(&maps.cache, cache, 4, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_NONE))
      return e;
  }
  {
    // rows past Cout (a tile wider than a narrow Cout) read zeros
    const uint64_t dims[3] = {(uint64_t)Cp, 27, (uint64_t)a.Cout};
    const uint64_t strides[2] = {2ull * Cp, 2ull * 27 * Cp};
    const uint32_t box[3] = {CK, 1, BN};
    if (int e = bf16_map(&maps.w, w, 3, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_64B))
      return e;
  }
  kern<<<grid, WTHREADS, L::SMEM, st>>>(maps, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return (int)err;
  const long long MN = (long long)a.B * a.T * a.H * a.W * a.Cout;
  const int threads = 256;
  conv_igemm_reduce<false><<<(unsigned)((MN / 8 + threads - 1) / threads),
                             threads, 0, st>>>(a.ws, a.splits, MN, a.Cout,
                                               a.bias, a.out);
  return (int)cudaGetLastError();
}

template <bool NORM, bool RES>
int launch_wide_bn(int bn, const void* x, const void* cache, const void* w,
                   int Cp, WideArgs a, int grid, cudaStream_t st) {
  switch (bn) {
    case 192:
      return launch_wide<192, NORM, RES>(x, cache, w, Cp, a, grid, st);
    case 128:
      return launch_wide<128, NORM, RES>(x, cache, w, Cp, a, grid, st);
    case 96:
      return launch_wide<96, NORM, RES>(x, cache, w, Cp, a, grid, st);
    case 64:
      return launch_wide<64, NORM, RES>(x, cache, w, Cp, a, grid, st);
    case 32:
      return launch_wide<32, NORM, RES>(x, cache, w, Cp, a, grid, st);
  }
  return (int)cudaErrorInvalidValue;
}

// =====================================================================
// NARROW route: the RGB input (C <= 3) on wgmma with A from registers
// =====================================================================
//
// A pixel of the RGB input is 6 bytes, no stride the wide route's
// per-pixel TMA boxes take, and its K is tiny: 27 taps x 3 channels = 81
// products a pixel and output channel.  So K is packed, not padded per
// tap: k = ((kt * 3 + di) * 3 + dj) * C + c, 96 in all (6 k16 steps;
// ops/cuda_conv.py::rgb_weight makes that copy of the weights).  Seen as
// rows of W * C bf16, the 3 C values of k = (kt, di, *, *) for output
// pixel w are the contiguous run [C (w - 1), C (w + 2)) of timeline frame
// t + tau0 + kt, image row h + di - 1.  An item is one output row of 64
// pixels by BN output channels: its halo is 3 rows of each temporal tap,
// (64 + 2) C bf16 each, one TMA box a tap (3 rows x boxe values of the
// frame seen as [H, W C], the rows' pitch a multiple of 8 values: the
// wrapper pads a row of W C % 8 != 0) from the 16-byte boundary at or
// before the halo's first value, so the halo starts `shift` = -C mod 8
// values into each box row; TMA's zero fill past the frame's rows and
// past [0, W C) is the conv's padding.  Each thread builds its wgmma A
// fragments (pixels 16 warp + g and + 8, 24 k pairs) straight from the
// staged boxes with 2-byte loads at offsets fixed for the kernel's life:
// C pixel + kt RTAP + di boxe + shift + k % 3C ((kt, di) = divmod(k /
// 3C, 3)), or a zero row for k past 27 C (taps_t 1: 9 C).  The
// packed weights (a CTA's every channel tile), the bias and the staged
// output stay in shared memory; one warpgroup a CTA, several CTAs an SM,
// persistent; the accumulators start at the bias, and the output is
// staged and stored in 16-byte pieces.  What bounds it: the output write
// (2 Cout bytes a pixel against 2 C read), ~0.1 ms at [1, 4, 480, 832,
// 3] -> 96.  Boxes of one halo row each, starting at the halo's first
// value (6-byte aligned) and, for rows past the frame, wholly past the
// tensor, stopped the card with an illegal instruction on their first
// launch; these boxes start on 16-byte boundaries and always meet the
// frame.

constexpr int RK = 96;                  // packed K (27 C <= 81, padded)
constexpr int RKS = RK / 16;            // k16 steps
constexpr int RMAX_C = 3;               // the widest input of the route
constexpr int RTW = 64;                 // output pixels an item
constexpr int RBOX = 208;               // values of a box row at most:
                                        // (RTW + 2) C + shift, to 8
constexpr int RTAP = 640;               // values a tap's box takes (3
                                        // rows, to 128 bytes)
constexpr int RZERO = 3 * RTAP;         // value offset of the zero row
constexpr int RSTAGE = 2 * RZERO + 512; // bytes of a ring stage
constexpr int RSTAGES = 4;
constexpr int RTHREADS = 128;
static_assert((RTW + 2) * RMAX_C + 7 <= RBOX && 3 * RBOX <= RTAP &&
              RTAP % 64 == 0, "a tap's box in its slot");

struct RgbMaps {
  CUtensorMap x;      // bf16 (W C, H, B*T), rows padded to 8 values;
                      // box (boxe, 3, 1)
  CUtensorMap cache;  // bf16 (W C, H, B*2), the same box
};

struct RgbArgs {
  const bf16* w;       // packed [Cout, RK]
  const float* bias;   // [Cout] or null
  bf16* out;           // [B, T, H, W, Cout]
  int B, T, H, W, C, Cout, taps_t, tau0;
  int wt, nt, items;   // column tiles, channel tiles, items
  int boxe, shift;     // values of a box row; the halo's offset in it
};

// d += A . B, m64nBNk16 bf16 -> f32, A from registers (the m16n8k16
// layout of each warp's 16 rows), B K-major from shared memory
template <int BN>
struct MmaRS;
template <>
struct MmaRS<32> {
  static __device__ __forceinline__ void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
        ", {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <>
struct MmaRS<96> {
  static __device__ __forceinline__ void run(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}"
        ", {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

// An item: output row h of frame t of batch b, pixels w0.., channels n0..
// (channel tile fastest, then column tile, row, frame).
struct RgbItem {
  int b, t, h, w0, n0;
};
__device__ __forceinline__ RgbItem rgb_item(const RgbArgs& a, int i,
                                            int BN) {
  RgbItem it;
  it.n0 = (i % a.nt) * BN;
  i /= a.nt;
  it.w0 = (i % a.wt) * RTW;
  i /= a.wt;
  it.h = i % a.H;
  i /= a.H;
  it.t = i % a.T;
  it.b = i / a.T;
  return it;
}

// bytes of dynamic shared memory: the ring, the weights, the bias, the
// staged output, the barriers
constexpr int rgb_smem(int BN, int nt) {
  return 128 + RSTAGES * RSTAGE + nt * BN * (RK * 2 + 4) +
         RTW * (2 * BN + 16) + RSTAGES * 8;
}

template <int BN>
__global__ void __launch_bounds__(RTHREADS, 4)
    conv_igemm_rgb(const __grid_constant__ RgbMaps maps,
                   const __grid_constant__ RgbArgs a) {
  constexpr int LD = 2 * BN + 16;   // bytes a staged output row
  extern __shared__ __align__(128) unsigned char rgb_smem_raw[];
  // TMA writes 128-byte aligned boxes
  unsigned char* ring =
      rgb_smem_raw + ((128 - (smem_u32(rgb_smem_raw) & 127)) & 127);
  unsigned char* Bs = ring + RSTAGES * RSTAGE;
  float* bias_s = reinterpret_cast<float*>(Bs + a.nt * BN * RK * 2);
  unsigned char* Os = reinterpret_cast<unsigned char*>(bias_s + a.nt * BN);
  uint64_t* full = reinterpret_cast<uint64_t*>(Os + RTW * LD);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int C = a.C;

  if (tid == 0) {
    for (int s = 0; s < RSTAGES; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  // each stage's zero row; the weights in wgmma's no-swizzle K-major
  // layout (8-row x 16-byte core matrices, 128 bytes apart along K, RK / 8
  // * 128 along N), from k = 9 C tau0 of the packed copy, zero past the
  // taps used and past Cout; the bias, zero past Cout
  for (int i = tid; i < RSTAGES * 32; i += RTHREADS)
    reinterpret_cast<uint4*>(ring + (i / 32) * RSTAGE + 2 * RZERO)[i % 32] =
        make_uint4(0u, 0u, 0u, 0u);
  const int k0 = 9 * C * a.tau0, kreal = 9 * C * a.taps_t;
  for (int i = tid; i < a.nt * BN * (RK / 8); i += RTHREADS) {
    const int n = i / (RK / 8), c8 = i % (RK / 8);
    __align__(16) bf16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = 8 * c8 + e;
      v[e] = n < a.Cout && k < kreal ? a.w[(long long)n * RK + k0 + k]
                                     : __float2bfloat16(0.f);
    }
    *reinterpret_cast<uint4*>(Bs + (n / 8) * (RK / 8) * 128 + c8 * 128 +
                              (n % 8) * 16) =
        *reinterpret_cast<const uint4*>(v);
  }
  for (int i = tid; i < a.nt * BN; i += RTHREADS)
    bias_s[i] = a.bias != nullptr && i < a.Cout ? a.bias[i] : 0.f;
  fence_async_smem();   // the weights are read by wgmma
  __syncthreads();

  // the TMA loads of this CTA's j-th item into stage j % RSTAGES
  auto issue = [&](int j) {
    const int i = blockIdx.x + j * gridDim.x;
    if (i >= a.items) return;
    const RgbItem it = rgb_item(a, i, BN);
    unsigned char* st = ring + (j % RSTAGES) * RSTAGE;
    uint64_t* bar = &full[j % RSTAGES];
    mbar_expect_tx(bar, a.taps_t * 3 * a.boxe * 2);
    for (int kt = 0; kt < a.taps_t; ++kt) {
      const int f = it.t + a.tau0 + kt;
      const bool cached = f < NCACHE;
      tma_load_3d(st + kt * RTAP * 2, cached ? &maps.cache : &maps.x, bar,
                  (it.w0 - 1) * C - a.shift, it.h - 1,
                  cached ? it.b * NCACHE + f : it.b * a.T + f - NCACHE);
    }
  };
  if (tid == 0)
    for (int j = 0; j < RSTAGES; ++j) issue(j);

  // this thread's A slots: k = 16 ks + 8 hk + 2 t4 + e, as an element
  // offset from its pixel's first halo element
  int koff[RKS][2][2];
#pragma unroll
  for (int ks = 0; ks < RKS; ++ks)
#pragma unroll
    for (int hk = 0; hk < 2; ++hk)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 16 * ks + 8 * hk + 2 * t4 + e;
        const int r = k / (3 * C);
        koff[ks][hk][e] = k < kreal ? (r / 3) * RTAP + (r % 3) * a.boxe +
                                          a.shift + k % (3 * C)
                                    : RZERO;
      }
  const int pix = C * (16 * warp + g);   // and pix + 8 C

  int j = 0;
  for (int i = blockIdx.x; i < a.items; i += gridDim.x, ++j) {
    const RgbItem it = rgb_item(a, i, BN);
    unsigned char* st = ring + (j % RSTAGES) * RSTAGE;
    mbar_wait(&full[j % RSTAGES], (j / RSTAGES) & 1);
    // A fragments: a[0] pixel g, k 2 t4 and 2 t4 + 1; a[1] pixel g + 8;
    // a[2], a[3] the same at k + 8
    const unsigned short* sp =
        reinterpret_cast<const unsigned short*>(st) + pix;
    uint32_t af[RKS][4];
#pragma unroll
    for (int ks = 0; ks < RKS; ++ks)
#pragma unroll
      for (int hk = 0; hk < 2; ++hk)
#pragma unroll
        for (int px = 0; px < 2; ++px)
          af[ks][2 * hk + px] =
              (uint32_t)sp[koff[ks][hk][0] + 8 * C * px] |
              ((uint32_t)sp[koff[ks][hk][1] + 8 * C * px] << 16);
    // the accumulators start at the bias: d[4 j + e] is channel n0 + 8 j
    // + 2 t4 + e % 2 of pixel 16 warp + g + 8 (e / 2)
    float acc[BN / 2];
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      const float2 bb =
          *reinterpret_cast<const float2*>(bias_s + it.n0 + 8 * jj + 2 * t4);
      acc[4 * jj] = acc[4 * jj + 2] = bb.x;
      acc[4 * jj + 1] = acc[4 * jj + 3] = bb.y;
    }
    __syncthreads();   // the stage is read, the last item copied out
    if (tid == 0) issue(j + RSTAGES);
    const uint32_t b0 = smem_u32(Bs) + (it.n0 / 8) * (RK / 8) * 128;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < RKS; ++ks)
      MmaRS<BN>::run(acc, af[ks],
                     desc_plain(b0 + ks * 256, 128, (RK / 8) * 128));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    // ---- epilogue: stage the row as bf16, store 16 bytes at a time (2
    // where Cout % 8 != 0); pixels past W and channels past Cout are not
    // stored
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<__nv_bfloat162*>(
            Os + (16 * warp + g + 8 * half) * LD + 2 * (8 * jj + 2 * t4)) =
            __floats2bfloat162_rn(acc[4 * jj + 2 * half],
                                  acc[4 * jj + 2 * half + 1]);
    __syncthreads();
    const long long row0 =
        ((long long)(it.b * a.T + it.t) * a.H + it.h) * a.W + it.w0;
    const int nv = a.Cout - it.n0, pv = min(RTW, a.W - it.w0);
    if (a.Cout % 8 == 0) {
      for (int q = tid; q < RTW * (BN / 8); q += RTHREADS) {
        const int p = q / (BN / 8), piece = q % (BN / 8);
        if (p < pv && 8 * piece < nv)
          *reinterpret_cast<uint4*>(a.out + (row0 + p) * a.Cout + it.n0 +
                                    8 * piece) =
              *reinterpret_cast<const uint4*>(Os + p * LD + 16 * piece);
      }
    } else {
      for (int q = tid; q < RTW * BN; q += RTHREADS) {
        const int p = q / BN, c = q % BN;
        if (p < pv && c < nv)
          a.out[(row0 + p) * a.Cout + it.n0 + c] =
              reinterpret_cast<const bf16*>(Os + p * LD)[c];
      }
    }
  }
}

template <int BN>
int launch_rgb(const void* x, const void* cache, RgbArgs a,
               cudaStream_t st) {
  auto kern = conv_igemm_rgb<BN>;
  const int smem = rgb_smem(BN, a.nt);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, dev = 0, sms = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, RTHREADS, smem)) != cudaSuccess ||
      (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  RgbMaps maps;
  memset(&maps, 0, sizeof(maps));
  const uint64_t pitch = 2ull * ((a.W * a.C + 7) / 8 * 8);   // row bytes
  const uint64_t strides[2] = {pitch, pitch * a.H};
  const uint32_t box[3] = {(uint32_t)a.boxe, 3, 1};
  uint64_t dims[3] = {(uint64_t)a.W * a.C, (uint64_t)a.H,
                      (uint64_t)a.B * a.T};
  if (int e = bf16_map(&maps.x, x, 3, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_NONE))
    return e;
  dims[2] = (uint64_t)a.B * NCACHE;
  if (int e = bf16_map(&maps.cache, cache, 3, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_NONE))
    return e;
  const int grid = min(a.items, max(per_sm, 1) * sms);
  kern<<<grid, RTHREADS, smem, st>>>(maps, a);
  return (int)cudaGetLastError();
}

// One warp a timeline pixel: inv = rsqrt(sum_c x^2 + eps) in f32.
__global__ void conv_igemm_rms_inv(const bf16* x, const bf16* cache,
                                   float* inv, int B, int T, int HW, int C,
                                   float eps) {
  const long long pix =
      (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (pix >= (long long)B * (NCACHE + T) * HW) return;
  const int p = (int)(pix % HW);
  const long long bf = pix / HW;
  const int f = (int)(bf % (NCACHE + T)), b = (int)(bf / (NCACHE + T));
  const bf16* src =
      f < NCACHE ? cache + ((long long)(b * NCACHE + f) * HW + p) * C
                 : x + (((long long)b * T + f - NCACHE) * HW + p) * C;
  float s = 0.f;
  for (int c = lane * 8; c < C; c += 256) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src + c);
    const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float xf = __bfloat162float(v[e]);
      s += xf * xf;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) inv[pix] = rsqrtf(s + eps);
}

// =====================================================================
// FLOAT32 route: the wide route's halo tiles in 3xTF32 on tf32 wgmma
// =====================================================================
//
// float32 inputs (the TPU kernels' f32 mode: f32 products, f32 sums).
// Every product in 3xTF32: an operand x is split into big = tf32(x) and
// small = tf32(x - big) (rounded to nearest: split_tf32) and a . b is
// summed as small_a big_b + big_a small_b + big_a big_b (the dropped terms
// are ~2^-22 of |a||b|: float32 accuracy; one TF32 pass leaves ~5e-4).
// What bounds it: 2 * 27 * C * Cout products a pixel at 495 / 3 TFLOP/s
// (4.8 ms at [1, 4, 480, 832, 96] -> 96).  The wide route's plan with
// f32 operands: a tile of 4 x 64 pixels by bn (96, 64 or 32) channels,
// K steps of one temporal tap x 16 channels (64 bytes a pixel, so a halo
// box of 4 channels lands as the bf16 route's 8-channel one: the same
// unswizzled core matrices and shifted tap descriptors; the weights' box
// of 16 channels the same 64-byte swizzle), persistent CTAs, the same
// deterministic K split.  The weights are split once per parameter on
// the host (ops/cuda_conv.py::f32_weight: big and small [Cout, 27, Cp]
// copies, one TMA box each a tap); a halo box is split once where it is
// staged, by three warps of the producer warpgroup (big in place, small
// beside it) while the consumers run the stage before, so every one of
// the 9 taps' 3 products reads both operands from shared memory (N = bn:
// 15 KB read for 144 clocks of products at bn 96).  Accumulation: the
// tensor cores' f32 accumulation truncates, with an error that grows with
// the chain, so each K step's products (9 taps x 2 k-steps x 3 = 54 wgmma
// a row) form one chain that is added to the running sum with one
// rounded f32 add (the running sums and the chains: 4 x bn / 2
// registers).  The output is stored as f32 pairs from the accumulator
// layout.  No norm prologue or residual (the fused norm + SiLU kernel
// takes bf16 only, as its TPU rule declines float32).

constexpr int FCK = 16;                  // channels of an f32 K step
constexpr int F_GROUPS = FCK / 4;        // 4-channel TMA boxes of a step
constexpr int F_PART = F_GROUPS * A_LBO; // a halo part (big or small)
constexpr int F_A_STRIDE = 2 * F_PART;   // a halo stage: big, then small
constexpr int F_A_BYTES = F_GROUPS * A_BOX;   // TMA bytes of a stage
constexpr int F_SPLITTERS = 96;          // producer threads that split
static_assert(F_A_STRIDE % 1024 == 0, "halo stage alignment");

template <int BN>
struct WideF {
  // ring depths: 2 halo and 10 tap stages (3 and 6, 2 and 8 measured
  // 8% and 2% slower at [1, 4, 480, 832, 96] -> 96: PERF.md)
  static constexpr int A_STAGES = 2;
  static constexpr int B_STAGES = 10;
  static constexpr int B_PART = BN * FCK * 4;   // a tap's weights, one part
  static constexpr int B_BYTES = 2 * B_PART;
  static constexpr int SMEM = 1024 + A_STAGES * F_A_STRIDE +
                              B_STAGES * B_BYTES +
                              (3 * A_STAGES + 2 * B_STAGES) * 8;
  static_assert(SMEM <= 232448, "shared memory");
  static_assert(B_PART % 512 == 0, "64-byte swizzle alignment");
};

struct WideMapsF {
  CUtensorMap x;      // f32 (C, W, H, B*T), box (4, HC, HR, 1)
  CUtensorMap cache;  // f32 (C, W, H, B*2), box (4, HC, HR, 1)
  CUtensorMap wb;     // f32 (Cp, 27, Cout), box (FCK, 1, BN), 64B swizzle:
  CUtensorMap ws;     //   the weights' big and small parts
};

struct WideArgsF {
  const float* bias;   // [Cout] or null
  float* out;          // [B, T, H, W, Cout]
  float* part;         // [splits, B*T*H*W, Cout] f32 partials (splits > 1)
  int B, T, H, W, C, Cout, taps_t, tau0, splits;
  int mt, wt, nt, nch, items;   // as WideArgs (nch: 16-channel steps)
};

// d (+)= small_a big_b + big_a small_b + big_a big_b (accumulate 0 starts
// the chain)
template <int BN>
__device__ __forceinline__ void mma3(float (&d)[BN / 2], uint64_t a_big,
                                     uint64_t a_small, uint64_t b_big,
                                     uint64_t b_small, int accumulate) {
  WgmmaTf32<BN>::ss(d, a_small, b_big, accumulate);
  WgmmaTf32<BN>::ss(d, a_big, b_small, 1);
  WgmmaTf32<BN>::ss(d, a_big, b_big, 1);
}

template <int BN>
__global__ void __launch_bounds__(WTHREADS, 1)
    conv_igemm_f32(const __grid_constant__ WideMapsF maps,
                   const WideArgsF a) {
  using L = WideF<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* As = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Bs = As + L::A_STAGES * F_A_STRIDE;
  uint64_t* a_full = reinterpret_cast<uint64_t*>(Bs + L::B_STAGES * L::B_BYTES);
  uint64_t* a_split = a_full + L::A_STAGES;
  uint64_t* a_empty = a_split + L::A_STAGES;
  uint64_t* b_full = a_empty + L::A_STAGES;
  uint64_t* b_empty = b_full + L::B_STAGES;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::A_STAGES; ++s) {
      mbar_init(&a_full[s], 1);
      mbar_init(&a_split[s], F_SPLITTERS / 32);
      mbar_init(&a_empty[s], 2);
    }
    for (int s = 0; s < L::B_STAGES; ++s) {
      mbar_init(&b_full[s], 1);
      mbar_init(&b_empty[s], 2);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    regs_dealloc<40>();
    if (threadIdx.x == 256) {
      // ---- producer: each item's raw halo boxes and both weight parts
      int sa = 0, sb = 0;
      uint32_t aph = 1, bph = 1;   // empty waits start at parity 1
      for (int i = blockIdx.x; i < a.items; i += gridDim.x) {
        const Item it = decode_item<BN>(a, i);
        for (int k = it.k0; k < it.k1; ++k) {
          const int kt = k / a.nch, c0 = (k % a.nch) * FCK;
          const int f = it.t + a.tau0 + kt;
          unsigned char* dst = As + sa * F_A_STRIDE;
          mbar_wait(&a_empty[sa], aph);
          mbar_expect_tx(&a_full[sa], F_A_BYTES);
          const CUtensorMap* m = f < NCACHE ? &maps.cache : &maps.x;
          const int fr = f < NCACHE ? it.b * NCACHE + f
                                    : it.b * a.T + f - NCACHE;
#pragma unroll
          for (int g = 0; g < F_GROUPS; ++g)
            tma_load_4d(dst + g * A_LBO, m, &a_full[sa], c0 + 4 * g,
                        it.w0 - 1, it.h0 - 1, fr);
          if (++sa == L::A_STAGES) sa = 0, aph ^= 1;
          const int tap0 = 9 * (kt + a.tau0);
          for (int s = 0; s < 9; ++s) {
            unsigned char* bd = Bs + sb * L::B_BYTES;
            mbar_wait(&b_empty[sb], bph);
            mbar_expect_tx(&b_full[sb], L::B_BYTES);
            tma_load_3d(bd, &maps.wb, &b_full[sb], c0, tap0 + s, it.n0);
            tma_load_3d(bd + L::B_PART, &maps.ws, &b_full[sb], c0, tap0 + s,
                        it.n0);
            if (++sb == L::B_STAGES) sb = 0, bph ^= 1;
          }
        }
      }
    } else if (threadIdx.x >= 256 + 32) {
      // ---- splitters (warps 1-3): each landed halo box into its big
      // part, in place, and its small part beside it
      const int u0 = threadIdx.x - (256 + 32);
      int sa = 0;
      uint32_t ph = 0;
      for (int i = blockIdx.x; i < a.items; i += gridDim.x) {
        const Item it = decode_item<BN>(a, i);
        for (int k = it.k0; k < it.k1; ++k) {
          mbar_wait(&a_full[sa], ph);
          unsigned char* st = As + sa * F_A_STRIDE;
          for (int u = u0; u < F_GROUPS * HPIX; u += F_SPLITTERS) {
            unsigned char* p = st + (u / HPIX) * A_LBO + (u % HPIX) * 16;
            float4 big, small;
            split_tf32(*reinterpret_cast<const float4*>(p), big, small);
            *reinterpret_cast<float4*>(p) = big;
            *reinterpret_cast<float4*>(p + F_PART) = small;
          }
          fence_async_smem();
          __syncwarp();
          if (threadIdx.x % 32 == 0) mbar_arrive(&a_split[sa]);
          if (++sa == L::A_STAGES) sa = 0, ph ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 2 wg, 2 wg + 1 of each tile
  regs_alloc<232>();
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const bool leader = threadIdx.x % 128 == 0;
  const uint32_t a_base = smem_u32(As) + 2 * wg * HC * 16;
  const uint32_t b_base = smem_u32(Bs);
  const long long M = (long long)a.B * a.T * a.H * a.W;

  float acc0[BN / 2], acc1[BN / 2];   // a K step's chains (rows 0, 1)
  float run0[BN / 2], run1[BN / 2];   // the running sums
  int sa = 0, sb = 0, psb = 0;
  uint32_t aph = 0, bph = 0;
  for (int i = blockIdx.x; i < a.items; i += gridDim.x) {
    const Item it = decode_item<BN>(a, i);
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) run0[j] = run1[j] = 0.f;
    for (int k = it.k0; k < it.k1; ++k) {
      mbar_wait(&a_split[sa], aph);
      // descriptors of this warpgroup's first row at tap (0, 0), big
      // part; a tap, a row, an 8-channel k-step and the small part each
      // add a constant (in 16-byte units)
      const uint64_t da = desc_plain(a_base + sa * F_A_STRIDE, A_LBO, 128);
#pragma unroll
      for (int s = 0; s < 9; ++s) {
        constexpr uint32_t ROW = HC, KSTEP = 2 * A_LBO / 16;
        constexpr uint32_t SMALL_A = F_PART / 16, SMALL_B = L::B_PART / 16;
        const uint32_t tap = (s / 3) * HC + s % 3;
        const uint64_t db = desc_sw64(b_base + sb * L::B_BYTES);
        mbar_wait(&b_full[sb], bph);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint64_t a0 = da + tap + kk * KSTEP, a1 = a0 + ROW;
          const int more = s > 0 || kk > 0;   // 0: the chain's first product
          mma3<BN>(acc0, a0, a0 + SMALL_A, db + 2 * kk,
                   db + SMALL_B + 2 * kk, more);
          mma3<BN>(acc1, a1, a1 + SMALL_A, db + 2 * kk,
                   db + SMALL_B + 2 * kk, more);
        }
        wgmma_commit();
        // the previous tap's products are done: hand back its stage
        wgmma_wait<1>();
        fence_regs(acc0);
        fence_regs(acc1);
        if (leader && s > 0) mbar_arrive(&b_empty[psb]);
        psb = sb;
        if (++sb == L::B_STAGES) sb = 0, bph ^= 1;
      }
      wgmma_wait<0>();
      fence_regs(acc0);
      fence_regs(acc1);
      if (leader) {
        mbar_arrive(&b_empty[psb]);
        mbar_arrive(&a_empty[sa]);
      }
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) {
        run0[j] += acc0[j];
        run1[j] += acc1[j];
      }
      if (++sa == L::A_STAGES) sa = 0, aph ^= 1;
    }

    // ---- epilogue.  Running sum d[4 j + e] of row r: tile column
    // 16 warp + g (+ 8 for e >= 2), channel n0 + 8 j + 2 t4 + (e & 1);
    // + bias (no split) or this split's partial; channels past Cout are
    // not stored
    const long long frame = (long long)(it.b * a.T + it.t) * a.H;
    const bool pair = a.Cout % 2 == 0;
    float* dst0 = a.splits == 1 ? a.out : a.part + (long long)it.s * M * a.Cout;
    auto store_row = [&](const float(&r)[BN / 2], int rr) {
      const int h = it.h0 + 2 * wg + rr;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int w = it.w0 + warp * 16 + g + 8 * half;
        if (h < a.H && w < a.W) {
          float* dst = dst0 + ((frame + h) * a.W + w) * a.Cout;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int n = it.n0 + 8 * j + 2 * t4;
            float v0 = r[4 * j + 2 * half], v1 = r[4 * j + 2 * half + 1];
            if (a.splits == 1 && a.bias != nullptr) {
              v0 += n < a.Cout ? __ldg(a.bias + n) : 0.f;
              v1 += n + 1 < a.Cout ? __ldg(a.bias + n + 1) : 0.f;
            }
            if (pair && n < a.Cout) {
              *reinterpret_cast<float2*>(dst + n) = make_float2(v0, v1);
            } else {
              if (n < a.Cout) dst[n] = v0;
              if (n + 1 < a.Cout) dst[n + 1] = v1;
            }
          }
        }
      }
    };
    store_row(run0, 0);
    store_row(run1, 1);
  }
}

template <int BN>
int launch_f32(const void* x, const void* cache, const void* wb,
               const void* ws, int Cp, WideArgsF a, int grid,
               cudaStream_t st) {
  using L = WideF<BN>;
  auto kern = conv_igemm_f32<BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return (int)err;
  WideMapsF maps;
  memset(&maps, 0, sizeof(maps));
  const uint64_t px = 4ull * a.C;   // bytes a pixel
  {
    uint64_t dims[4] = {(uint64_t)a.C, (uint64_t)a.W, (uint64_t)a.H,
                        (uint64_t)a.B * a.T};
    const uint64_t strides[3] = {px, px * a.W, px * a.W * a.H};
    const uint32_t box[4] = {4, HC, HR, 1};
    if (int e = tile_map(&maps.x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, 4,
                         dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE))
      return e;
    dims[3] = (uint64_t)a.B * NCACHE;
    if (int e = tile_map(&maps.cache, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, cache,
                         4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE))
      return e;
  }
  {
    // rows past Cout (a tile wider than a narrow Cout) read zeros
    const uint64_t dims[3] = {(uint64_t)Cp, 27, (uint64_t)a.Cout};
    const uint64_t strides[2] = {4ull * Cp, 4ull * 27 * Cp};
    const uint32_t box[3] = {FCK, 1, BN};
    if (int e = tile_map(&maps.wb, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, wb, 3,
                         dims, strides, box, CU_TENSOR_MAP_SWIZZLE_64B))
      return e;
    if (int e = tile_map(&maps.ws, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ws, 3,
                         dims, strides, box, CU_TENSOR_MAP_SWIZZLE_64B))
      return e;
  }
  kern<<<grid, WTHREADS, L::SMEM, st>>>(maps, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return (int)err;
  const long long MN = (long long)a.B * a.T * a.H * a.W * a.Cout;
  const int threads = 256;
  conv_igemm_reduce<true><<<(unsigned)((MN / 8 + threads - 1) / threads),
                            threads, 0, st>>>(a.part, a.splits, MN, a.Cout,
                                              a.bias, a.out);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, T, H, W, C] and cache [B, 2, H, W, C] bf16; w the K-contiguous
// weight copy [Cout, 27, Cp] (taps in (kt, di, dj) order, Cp = C rounded
// up to 8); bias f32 [Cout] or null; res bf16 [B, T, H, W, Cout] or null;
// inv f32 [B, 2 + T, H, W] and gamma f32 [C] for the norm prologue (both
// null without it); out bf16 [B, T, H, W, Cout]; taps_t 3 (tau0 0) or 1
// (temporal tap tau0 alone).  C % 8 == 0 takes the WIDE route in tiles
// of bn output channels (32, 64, 96, 128 or 192; the last tile masked where
// bn does not divide Cout) with `splits` K splits (1, or up to taps_t *
// ceil(C / 32) where bn divides Cout, Cout % 8 == 0 and there is no norm;
// partials in ws f32 [splits, B*T*H*W, Cout]) on a persistent grid of
// `grid` CTAs (1 to the item count); the norm prologue needs bn to divide
// Cout.  C <= 3 takes the NARROW route (bn 0, splits 1, grid 0, no norm;
// the launcher sizes its persistent grid) with w the packed copy [Cout,
// Cp = 96] (k = tap * C + c; ops/cuda_conv.py::rgb_weight).  Other C are
// refused.  ops/cuda_conv.py::conv_plan picks the route, bn, splits and
// grid.  Returns the CUDA error code (0 on success).
extern "C" int conv3d_launch(const void* x, const void* cache, const void* w,
                             const void* bias, const void* res,
                             const void* inv, const void* gamma, void* out,
                             void* ws, int B, int T, int H, int W, int C,
                             int Cp, int Cout, int taps_t, int tau0, int bn,
                             int splits, int grid, float gscale,
                             void* stream) {
  const bool norm = inv != nullptr;
  const bool wide = C % 8 == 0;
  if (!wide && (C > RMAX_C || Cp != RK)) return (int)cudaErrorInvalidValue;
  const bool even = bn > 0 && Cout % bn == 0;   // no masked channel tile
  const int nch = (C + CK - 1) / CK;
  if (B <= 0 || T <= 0 || H <= 0 || W <= 0 || C <= 0 || Cout <= 0 ||
      (wide && (Cp % 8 || Cp < C)) || (taps_t != 1 && taps_t != 3) ||
      tau0 < 0 ||
      tau0 + taps_t > 3 || (taps_t == 3 && tau0 != 0) ||
      (wide ? (bn != 32 && bn != 64 && bn != 96 && bn != 128 && bn != 192)
            : bn != 0) ||
      (norm && (gamma == nullptr || !even)) || (res != nullptr && !norm) ||
      splits < 1 || (splits > 1 && (norm || !even || Cout % 8 ||
                                     ws == nullptr || splits > taps_t * nch)) ||
      (wide ? grid < 1 : grid != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (wide) {
    WideArgs a{(const float*)bias, (const bf16*)res, (const float*)inv,
               (const float*)gamma, (bf16*)out, (float*)ws, B, T, H, W, C,
               Cout, taps_t, tau0, splits, (H + TR - 1) / TR,
               (W + TW - 1) / TW, (Cout + bn - 1) / bn, nch, 0, gscale};
    const long long items =
        (long long)B * T * a.mt * a.wt * a.nt * splits;
    if (items > 0x7fffffff || grid > items) return (int)cudaErrorInvalidValue;
    a.items = (int)items;
    if (norm && res != nullptr)
      return launch_wide_bn<true, true>(bn, x, cache, w, Cp, a, grid, st);
    if (norm)
      return launch_wide_bn<true, false>(bn, x, cache, w, Cp, a, grid, st);
    return launch_wide_bn<false, false>(bn, x, cache, w, Cp, a, grid, st);
  }
  const int bn_rgb = Cout <= 32 ? 32 : 96;
  const int wt = (W + RTW - 1) / RTW, nt = (Cout + bn_rgb - 1) / bn_rgb;
  const long long items = (long long)B * T * H * wt * nt;
  if ((long long)W * C > 0x7fffffff || items > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int shift = (8 - C % 8) % 8;   // (w0 - 1) C mod 8, w0 % 64 == 0
  const RgbArgs a{(const bf16*)w, (const float*)bias, (bf16*)out, B, T, H,
                  W, C, Cout, taps_t, tau0, wt, nt, (int)items,
                  ((RTW + 2) * C + shift + 7) / 8 * 8, shift};
  return bn_rgb == 32 ? launch_rgb<32>(x, cache, a, st)
                      : launch_rgb<96>(x, cache, a, st);
}

// inv [B, 2 + T, H, W] f32 of the raw timeline [cache | x]; C % 8 == 0.
extern "C" int rms_inv_launch(const void* x, const void* cache, void* inv,
                              int B, int T, int H, int W, int C, float eps,
                              void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 8)
    return (int)cudaErrorInvalidValue;
  const long long pixels = (long long)B * (NCACHE + T) * H * W;
  const int per_block = 8;
  conv_igemm_rms_inv<<<(unsigned)((pixels + per_block - 1) / per_block),
                       per_block * 32, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)cache, (float*)inv, B, T, H * W, C, eps);
  return (int)cudaGetLastError();
}

// The float32 conv (3xTF32 products on tf32 wgmma): x [B, T, H, W, C] and
// cache [B, 2, H, W, C] f32 with C % 4 == 0 (ops/cuda_conv.py pads other
// C); w_big and w_small the big and small tf32 parts of the f32 weight
// copy [Cout, 27, Cp] (Cp = C rounded up to 4; ops/cuda_conv.py::
// f32_weight); bias f32 [Cout] or null; out f32 [B, T, H, W, Cout];
// taps_t 3 (tau0 0) or 1 (temporal tap tau0 alone).  Tiles of bn output
// channels (32, 64 or 96; the last tile masked where bn does not divide
// Cout) with `splits` K splits (1, or up to taps_t * ceil(C / 16) where bn
// divides Cout and Cout % 8 == 0; partials in ws f32 [splits, B*T*H*W,
// Cout]) on a persistent grid of `grid` CTAs (1 to the item count);
// ops/cuda_conv.py::conv_plan(f32=True) picks them.  Returns the CUDA
// error code (0 on success).
extern "C" int conv3d_f32_launch(const void* x, const void* cache,
                                 const void* w_big, const void* w_small,
                                 const void* bias, void* out, void* ws,
                                 int B, int T, int H, int W, int C, int Cp,
                                 int Cout, int taps_t, int tau0, int bn,
                                 int splits, int grid, void* stream) {
  const bool even = bn > 0 && Cout % bn == 0;
  const int nch = (C + FCK - 1) / FCK;
  if (B <= 0 || T <= 0 || H <= 0 || W <= 0 || C <= 0 || Cout <= 0 ||
      C % 4 || Cp % 4 || Cp < C || (taps_t != 1 && taps_t != 3) ||
      tau0 < 0 || tau0 + taps_t > 3 || (taps_t == 3 && tau0 != 0) ||
      (bn != 32 && bn != 64 && bn != 96) || splits < 1 ||
      (splits > 1 && (!even || Cout % 8 || ws == nullptr ||
                      splits > taps_t * nch)) ||
      grid < 1)
    return (int)cudaErrorInvalidValue;
  WideArgsF a{(const float*)bias, (float*)out, (float*)ws, B, T, H, W, C,
              Cout, taps_t, tau0, splits, (H + TR - 1) / TR,
              (W + TW - 1) / TW, (Cout + bn - 1) / bn, nch, 0};
  const long long items = (long long)B * T * a.mt * a.wt * a.nt * splits;
  if (items > 0x7fffffff || grid > items) return (int)cudaErrorInvalidValue;
  a.items = (int)items;
  cudaStream_t st = (cudaStream_t)stream;
  switch (bn) {
    case 96: return launch_f32<96>(x, cache, w_big, w_small, Cp, a, grid, st);
    case 64: return launch_f32<64>(x, cache, w_big, w_small, Cp, a, grid, st);
  }
  return launch_f32<32>(x, cache, w_big, w_small, Cp, a, grid, st);
}
