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
// rsqrt(sum_c x^2 + eps) of the raw pixel (masked taps read no pixel, so
// they stay zero: silu(norm(0)) is 0 as in the TPU kernel).
//
// GEMM view: M = output pixels (B*T*H*W, row-major over b, t, h, w), N =
// Cout, K = channels x taps; one K step is one tap and BK = 32 channels, so
// each of a tile's rows reads one pixel's 64 contiguous bytes (channels-last
// storage, no copy).  Weights are the K-contiguous copy W [Cout, 27, Cp]
// (Cp = C rounded up to 8, zero padded; made once per parameter by
// ops/cuda_conv.py), so ldmatrix gives mma.sync's col-major B directly.
//
// What bounds it on the H100: the VAE's convs do 2*27*C*Cout products a
// pixel (96-384 channels: 0.5-8 MFLOP) against 2*(C + Cout) bytes, far
// above the card's ~295 FLOP/byte: bound by the tensor cores.  Design,
// simple first: mma.sync m16n8k16 bf16 -> f32, 128 x BN x 32 tiles, 8 warps,
// 3-stage cp.async (16-byte zero-filled gathers of the tap's shifted
// pixels), rows padded to 80 bytes so ldmatrix is conflict-free.  Tiles
// narrower than Cout's 128 (BN 32 / 64) for the RGB head and the 16- and
// 32-channel convs; C % 8 != 0 (the RGB input) loads A with scalar reads.
// The NORM prologue rewrites each staged A chunk in place (the thread that
// copied it, after its cp.async wait).  Not yet: wgmma, TMA, a persistent
// schedule, reuse of a strip's pixels across the 9 spatial taps.

#include "attention_common.cuh"

using sf_attn::bf16;
using sf_attn::cp_async16;
using sf_attn::cp_async_commit;
using sf_attn::cp_async_wait;
using sf_attn::ldmatrix_x4;
using sf_attn::mma16816;
using sf_attn::mma_tf32;
using sf_attn::split_tf32;

namespace {

constexpr int BM = 128;         // output pixels of a tile
constexpr int BK = 32;          // channels of one K step
constexpr int LDS = BK + 8;     // shared row stride (80 bytes)
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int NCACHE = 2;       // cache frames before x on the timeline
constexpr int CHUNKS = BK / 8;              // 16-byte chunks of a row
constexpr int A_PASS = THREADS / CHUNKS;    // A rows loaded in one pass
constexpr int A_ITERS = BM / A_PASS;        // A rows of each thread

struct ConvArgs {
  const bf16* x;       // [B, T, H, W, C]
  const bf16* cache;   // [B, 2, H, W, C]
  const bf16* w;       // [Cout, ., Cp] at the first tap used, row w_stride
  const float* bias;   // [Cout] or null
  const bf16* res;     // [B, T, H, W, Cout] or null
  const float* inv;    // [B, 2 + T, H, W] (NORM)
  const float* gamma;  // [C] (NORM)
  bf16* out;           // [B, T, H, W, Cout]
  int B, T, H, W, C, Cp, Cout;
  int taps_t, tau0, w_stride;
  float gscale;
};

// 16-byte async copy through L1 (the tap gathers re-read their
// neighbours' pixels); bytes == 0 zero-fills the destination
__device__ __forceinline__ void cp_async16_ca(void* dst, const void* src,
                                              int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   sf_attn::smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ float silu(float u) {
  return u * (1.f / (1.f + __expf(-u)));
}

// The shifted source pixel of output pixel (b, t, h, w) for temporal tap
// kt and spatial tap (di, dj); null where it lies outside the frame.
__device__ __forceinline__ const bf16* tap_pixel(const ConvArgs& a, int b,
                                                 int t, int h, int w, int kt,
                                                 int di, int dj, int* frame,
                                                 int* pix) {
  const int hh = h + di - 1, ww = w + dj - 1;
  if (hh < 0 || hh >= a.H || ww < 0 || ww >= a.W) return nullptr;
  const int f = t + a.tau0 + kt;
  const long long p = (long long)hh * a.W + ww;
  *frame = f;
  *pix = (int)p;
  const long long HW = (long long)a.H * a.W;
  if (f < NCACHE) return a.cache + ((b * NCACHE + f) * HW + p) * a.C;
  return a.x + (((long long)b * a.T + f - NCACHE) * HW + p) * a.C;
}

template <int BN, int WARPS_M, bool VEC, bool NORM, bool RES>
__global__ void __launch_bounds__(THREADS)
    conv_igemm(const ConvArgs a) {
  constexpr int WARPS_N = 8 / WARPS_M;
  constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;
  constexpr int MT = WTM / 16, NT = WTN / 8;
  static_assert(NT % 2 == 0 && MT >= 1, "warp tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);   // [STAGES][BM][LDS]
  bf16* Bs = As + STAGES * BM * LDS;              // [STAGES][BN][LDS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const long long M = (long long)a.B * a.T * a.H * a.W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // this thread's A rows (tid / CHUNKS + A_PASS * i) and 16-byte chunk
  const int aj = tid % CHUNKS;
  int pb[A_ITERS], pt[A_ITERS], ph[A_ITERS], pw[A_ITERS];
  bool pv[A_ITERS];
#pragma unroll
  for (int i = 0; i < A_ITERS; ++i) {
    const long long m = m0 + tid / CHUNKS + A_PASS * i;
    pv[i] = m < M;
    long long r = pv[i] ? m : 0;
    pw[i] = (int)(r % a.W);
    r /= a.W;
    ph[i] = (int)(r % a.H);
    r /= a.H;
    pt[i] = (int)(r % a.T);
    pb[i] = (int)(r / a.T);
  }
  // K steps channel-chunk-major: the taps of one chunk follow each other,
  // so neighbouring taps' gathers of the same pixels hit L1
  const int taps = a.taps_t * 9;
  const int ksteps = taps * ((a.Cp + BK - 1) / BK);

  auto load_stage = [&](int stage, int kk) {
    const int tap = kk % taps, c0 = (kk / taps) * BK;
    const int kt = tap / 9, di = (tap % 9) / 3, dj = tap % 3;
    bf16* as = As + stage * BM * LDS;
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const int row = tid / CHUNKS + A_PASS * i, c = c0 + aj * 8;
      int f, p;
      const bf16* src = pv[i] ? tap_pixel(a, pb[i], pt[i], ph[i], pw[i], kt,
                                          di, dj, &f, &p)
                              : nullptr;
      bf16* dst = as + row * LDS + aj * 8;
      if (VEC) {
        const bool ok = src != nullptr && c < a.C;
        cp_async16_ca(dst, ok ? src + c : a.x, ok ? 16 : 0);
      } else {
        __align__(16) bf16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = (src != nullptr && c + e < a.C) ? src[c + e]
                                                 : __float2bfloat16(0.f);
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
      }
    }
    bf16* bs = Bs + stage * BN * LDS;
    const bf16* wt = a.w + (long long)tap * a.Cp;
    for (int idx = tid; idx < BN * CHUNKS; idx += THREADS) {
      const int r = idx / CHUNKS, j = idx % CHUNKS, c = c0 + j * 8;
      const int n = n0 + r;
      const bool ok = n < a.Cout && c < a.Cp;
      cp_async16(bs + r * LDS + j * 8,
                 ok ? wt + (long long)n * a.w_stride + c : a.w, ok ? 16 : 0);
    }
  };

  // NORM: activate this thread's own staged A chunks of step kk in place
  auto activate = [&](int stage, int kk) {
    const int tap = kk % taps, c0 = (kk / taps) * BK;
    const int kt = tap / 9, di = (tap % 9) / 3, dj = tap % 3;
    bf16* as = As + stage * BM * LDS;
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const int row = tid / CHUNKS + A_PASS * i, c = c0 + aj * 8;
      int f, p;
      const bf16* src = pv[i] ? tap_pixel(a, pb[i], pt[i], ph[i], pw[i], kt,
                                          di, dj, &f, &p)
                              : nullptr;
      if (src == nullptr || c >= a.C) continue;
      const float inv =
          a.inv[((long long)pb[i] * (NCACHE + a.T) + f) * a.H * a.W + p];
      uint4* q = reinterpret_cast<uint4*>(as + row * LDS + aj * 8);
      uint4 raw = *q;
      bf16* v = reinterpret_cast<bf16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float u =
            __bfloat162float(v[e]) * inv * a.gscale * a.gamma[c + e];
        v[e] = __float2bfloat16(silu(u));
      }
      *q = raw;
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ksteps) load_stage(s, s);
    cp_async_commit();
  }
  for (int kk = 0; kk < ksteps; ++kk) {
    const int stage = kk % STAGES;
    cp_async_wait<STAGES - 2>();
    if (NORM) activate(stage, kk);
    __syncthreads();
    if (kk + STAGES - 1 < ksteps)
      load_stage((kk + STAGES - 1) % STAGES, kk + STAGES - 1);
    cp_async_commit();

    const bf16* as = As + stage * BM * LDS;
    const bf16* bs = Bs + stage * BN * LDS;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int row = wm * WTM + mt * 16 + (lane & 15);
        ldmatrix_x4(af[mt], as + row * LDS + ks * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bfr[4];
        const int n = wn * WTN + np * 16 + (lane & 7) + (lane >> 4) * 8;
        ldmatrix_x4(bfr, bs + n * LDS + ks * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(acc[mt][2 * np], af[mt], bfr[0], bfr[1]);
          mma16816(acc[mt][2 * np + 1], af[mt], bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: + bias (+ residual) in f32, one rounding to bf16
  const int g = lane >> 2, t4 = lane & 3;
  const bool pairs = (a.Cout & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm * WTM + mt * 16 + g + 8 * half;
      if (m >= M) continue;
      bf16* orow = a.out + m * a.Cout;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = n0 + wn * WTN + nt * 8 + 2 * t4;
        float v[2] = {acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (n + e >= a.Cout) continue;
          if (a.bias != nullptr) v[e] += a.bias[n + e];
          if (RES) v[e] += __bfloat162float(a.res[m * a.Cout + n + e]);
        }
        if (pairs && n < a.Cout) {
          *reinterpret_cast<__nv_bfloat162*>(orow + n) =
              __floats2bfloat162_rn(v[0], v[1]);
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (n + e < a.Cout) orow[n + e] = __float2bfloat16(v[e]);
        }
      }
    }
  }
}

template <int BN, int WARPS_M, bool VEC, bool NORM, bool RES>
int launch(const ConvArgs& a, cudaStream_t st) {
  auto kern = conv_igemm<BN, WARPS_M, VEC, NORM, RES>;
  const int smem = STAGES * (BM + BN) * LDS * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long M = (long long)a.B * a.T * a.H * a.W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (a.Cout + BN - 1) / BN);
  kern<<<grid, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <bool VEC>
int launch_plain(const ConvArgs& a, cudaStream_t st) {
  if (a.Cout <= 32) return launch<32, 8, VEC, false, false>(a, st);
  if (a.Cout <= 64) return launch<64, 4, VEC, false, false>(a, st);
  return launch<128, 2, VEC, false, false>(a, st);
}

// One warp a timeline pixel: inv = rsqrt(sum_c x^2 + eps) in f32.
__global__ void rms_inv_kernel(const bf16* x, const bf16* cache, float* inv,
                               int B, int T, int HW, int C, float eps) {
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

// ---------------------------------------------------------------------
// float32 inputs (the TPU kernels' f32 mode: f32 products, f32 sums).  The
// same implicit GEMM with BK = 16 channels a step (64 bytes a row, as the
// bf16 kernel's 32), on mma.sync.m16n8k8 in 3xTF32: each operand x is
// split into big = tf32(x) and small = tf32(x - big) and a . b is summed
// as small_a * big_b + big_a * small_b + big_a * big_b (the dropped terms
// are ~2^-22 of |a||b|, float32 accuracy; one TF32 pass would leave
// ~5e-4).  Each 8-channel step's three products go to a zeroed
// accumulator added to the running sum with one rounded f32 add: the
// tensor cores' f32 accumulation truncates, with an error that grows with
// the running sum over the 27 * C terms.  Rows padded to 20 floats: the (g, t) scalar fragment reads hit
// 32 distinct banks.  Weights: the f32 K-contiguous copy [Cout, 27, Cp]
// (Cp = C rounded up to 4).  No norm prologue or residual (the fused
// norm + SiLU kernel takes bf16 only, as its TPU rule declines float32).
// ---------------------------------------------------------------------

constexpr int BKF = 16;              // channels of one f32 K step
constexpr int LDF = BKF + 4;         // shared row stride (80 bytes)
constexpr int F_CHUNKS = BKF / 4;    // 16-byte chunks of a row
constexpr int F_PASS = THREADS / F_CHUNKS;
constexpr int F_ITERS = BM / F_PASS;

struct ConvArgsF {
  const float* x;      // [B, T, H, W, C]
  const float* cache;  // [B, 2, H, W, C]
  const float* w;      // [Cout, ., Cp] at the first tap used, row w_stride
  const float* bias;   // [Cout] or null
  float* out;          // [B, T, H, W, Cout]
  int B, T, H, W, C, Cp, Cout;
  int taps_t, tau0, w_stride;
};

__device__ __forceinline__ const float* tap_pixel_f(const ConvArgsF& a,
                                                    int b, int t, int h,
                                                    int w, int kt, int di,
                                                    int dj) {
  const int hh = h + di - 1, ww = w + dj - 1;
  if (hh < 0 || hh >= a.H || ww < 0 || ww >= a.W) return nullptr;
  const int f = t + a.tau0 + kt;
  const long long p = (long long)hh * a.W + ww;
  const long long HW = (long long)a.H * a.W;
  if (f < NCACHE) return a.cache + ((b * NCACHE + f) * HW + p) * a.C;
  return a.x + (((long long)b * a.T + f - NCACHE) * HW + p) * a.C;
}

template <int BN, int WARPS_M, bool VEC>
__global__ void __launch_bounds__(THREADS)
    conv_igemm_f32(const ConvArgsF a) {
  constexpr int WARPS_N = 8 / WARPS_M;
  constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;
  constexpr int MT = WTM / 16, NT = WTN / 8;
  static_assert(MT >= 1 && NT >= 1, "warp tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);   // [STAGES][BM][LDF]
  float* Bs = As + STAGES * BM * LDF;               // [STAGES][BN][LDF]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int g = lane >> 2, t4 = lane & 3;
  const long long M = (long long)a.B * a.T * a.H * a.W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  const int aj = tid % F_CHUNKS;
  int pb[F_ITERS], pt[F_ITERS], ph[F_ITERS], pw[F_ITERS];
  bool pv[F_ITERS];
#pragma unroll
  for (int i = 0; i < F_ITERS; ++i) {
    const long long m = m0 + tid / F_CHUNKS + F_PASS * i;
    pv[i] = m < M;
    long long r = pv[i] ? m : 0;
    pw[i] = (int)(r % a.W);
    r /= a.W;
    ph[i] = (int)(r % a.H);
    r /= a.H;
    pt[i] = (int)(r % a.T);
    pb[i] = (int)(r / a.T);
  }
  const int taps = a.taps_t * 9;
  const int ksteps = taps * ((a.Cp + BKF - 1) / BKF);

  auto load_stage = [&](int stage, int kk) {
    const int tap = kk % taps, c0 = (kk / taps) * BKF;
    const int kt = tap / 9, di = (tap % 9) / 3, dj = tap % 3;
    float* as = As + stage * BM * LDF;
#pragma unroll
    for (int i = 0; i < F_ITERS; ++i) {
      const int row = tid / F_CHUNKS + F_PASS * i, c = c0 + aj * 4;
      const float* src = pv[i] ? tap_pixel_f(a, pb[i], pt[i], ph[i], pw[i],
                                             kt, di, dj)
                               : nullptr;
      float* dst = as + row * LDF + aj * 4;
      if (VEC) {
        const bool ok = src != nullptr && c < a.C;
        cp_async16_ca(dst, ok ? src + c : a.x, ok ? 16 : 0);
      } else {
        __align__(16) float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = (src != nullptr && c + e < a.C) ? src[c + e] : 0.f;
        *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(v);
      }
    }
    float* bs = Bs + stage * BN * LDF;
    const float* wt = a.w + (long long)tap * a.Cp;
    for (int idx = tid; idx < BN * F_CHUNKS; idx += THREADS) {
      const int r = idx / F_CHUNKS, j = idx % F_CHUNKS, c = c0 + j * 4;
      const int n = n0 + r;
      const bool ok = n < a.Cout && c < a.Cp;
      cp_async16(bs + r * LDF + j * 4,
                 ok ? wt + (long long)n * a.w_stride + c : a.w, ok ? 16 : 0);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ksteps) load_stage(s, s);
    cp_async_commit();
  }
  for (int kk = 0; kk < ksteps; ++kk) {
    const int stage = kk % STAGES;
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kk + STAGES - 1 < ksteps)
      load_stage((kk + STAGES - 1) % STAGES, kk + STAGES - 1);
    cp_async_commit();

    const float* as = As + stage * BM * LDF;
    const float* bs = Bs + stage * BN * LDF;
#pragma unroll
    for (int ks = 0; ks < BKF / 8; ++ks) {
      const int c = ks * 8 + t4;
      uint32_t ab[MT][4], asm_[MT][4], bb[NT][2], bsm[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* r = as + (wm * WTM + mt * 16 + g) * LDF + c;
        split_tf32(r[0], ab[mt][0], asm_[mt][0]);
        split_tf32(r[8 * LDF], ab[mt][1], asm_[mt][1]);
        split_tf32(r[4], ab[mt][2], asm_[mt][2]);
        split_tf32(r[8 * LDF + 4], ab[mt][3], asm_[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* r = bs + (wn * WTN + nt * 8 + g) * LDF + c;
        split_tf32(r[0], bb[nt][0], bsm[nt][0]);
        split_tf32(r[4], bb[nt][1], bsm[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float t[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(t, asm_[mt], bb[nt]);
          mma_tf32(t, ab[mt], bsm[nt]);
          mma_tf32(t, ab[mt], bb[nt]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += t[e];
        }
    }
  }
  cp_async_wait<0>();

  // epilogue: + bias in f32
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm * WTM + mt * 16 + g + 8 * half;
      if (m >= M) continue;
      float* orow = a.out + m * a.Cout;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = n0 + wn * WTN + nt * 8 + 2 * t4;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (n + e >= a.Cout) continue;
          float v = acc[mt][nt][2 * half + e];
          if (a.bias != nullptr) v += a.bias[n + e];
          orow[n + e] = v;
        }
      }
    }
  }
}

template <int BN, int WARPS_M, bool VEC>
int launch_f32(const ConvArgsF& a, cudaStream_t st) {
  auto kern = conv_igemm_f32<BN, WARPS_M, VEC>;
  const int smem = STAGES * (BM + BN) * LDF * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long M = (long long)a.B * a.T * a.H * a.W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (a.Cout + BN - 1) / BN);
  kern<<<grid, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <bool VEC>
int launch_plain_f32(const ConvArgsF& a, cudaStream_t st) {
  if (a.Cout <= 32) return launch_f32<32, 8, VEC>(a, st);
  if (a.Cout <= 64) return launch_f32<64, 4, VEC>(a, st);
  return launch_f32<128, 2, VEC>(a, st);
}

}  // namespace

// x [B, T, H, W, C] and cache [B, 2, H, W, C] bf16; w the K-contiguous
// weight copy at its first used tap (row stride w_stride elements, taps of
// Cp channels); bias f32 [Cout] or null; res bf16 [B, T, H, W, Cout] or
// null; inv f32 [B, 2 + T, H, W] and gamma f32 [C] for the norm prologue
// (both null without it); out bf16 [B, T, H, W, Cout].
extern "C" int conv3d_launch(const void* x, const void* cache, const void* w,
                             const void* bias, const void* res,
                             const void* inv, const void* gamma, void* out,
                             int B, int T, int H, int W, int C, int Cp,
                             int Cout, int taps_t, int tau0, int w_stride,
                             float gscale, void* stream) {
  const bool norm = inv != nullptr;
  if (B <= 0 || T <= 0 || H <= 0 || W <= 0 || C <= 0 || Cout <= 0 ||
      Cp % 8 || Cp < C || (taps_t != 1 && taps_t != 3) || tau0 < 0 ||
      tau0 + taps_t > 3 || w_stride < taps_t * 9 * Cp ||
      (norm && (gamma == nullptr || C % 8)) || (res != nullptr && !norm))
    return (int)cudaErrorInvalidValue;
  ConvArgs a{(const bf16*)x,   (const bf16*)cache, (const bf16*)w,
             (const float*)bias, (const bf16*)res, (const float*)inv,
             (const float*)gamma, (bf16*)out,      B, T, H, W, C, Cp, Cout,
             taps_t, tau0, w_stride, gscale};
  cudaStream_t st = (cudaStream_t)stream;
  if (norm) {
    if (res != nullptr) return launch<128, 2, true, true, true>(a, st);
    return launch<128, 2, true, true, false>(a, st);
  }
  return C % 8 == 0 ? launch_plain<true>(a, st) : launch_plain<false>(a, st);
}

// inv [B, 2 + T, H, W] f32 of the raw timeline [cache | x]; C % 8 == 0.
extern "C" int rms_inv_launch(const void* x, const void* cache, void* inv,
                              int B, int T, int H, int W, int C, float eps,
                              void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 8)
    return (int)cudaErrorInvalidValue;
  const long long pixels = (long long)B * (NCACHE + T) * H * W;
  const int per_block = 8;
  rms_inv_kernel<<<(unsigned)((pixels + per_block - 1) / per_block),
                   per_block * 32, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)cache, (float*)inv, B, T, H * W, C, eps);
  return (int)cudaGetLastError();
}

// The float32 conv (3xTF32 products): x [B, T, H, W, C] and cache
// [B, 2, H, W, C] f32; w the f32 K-contiguous weight copy at its first used
// tap (row stride w_stride elements, taps of Cp channels, Cp % 4 == 0);
// bias f32 [Cout] or null; out f32 [B, T, H, W, Cout].
extern "C" int conv3d_f32_launch(const void* x, const void* cache,
                                 const void* w, const void* bias, void* out,
                                 int B, int T, int H, int W, int C, int Cp,
                                 int Cout, int taps_t, int tau0, int w_stride,
                                 void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || W <= 0 || C <= 0 || Cout <= 0 ||
      Cp % 4 || Cp < C || (taps_t != 1 && taps_t != 3) || tau0 < 0 ||
      tau0 + taps_t > 3 || w_stride < taps_t * 9 * Cp)
    return (int)cudaErrorInvalidValue;
  ConvArgsF a{(const float*)x, (const float*)cache, (const float*)w,
              (const float*)bias, (float*)out, B, T, H, W, C, Cp, Cout,
              taps_t, tau0, w_stride};
  cudaStream_t st = (cudaStream_t)stream;
  return C % 4 == 0 ? launch_plain_f32<true>(a, st)
                    : launch_plain_f32<false>(a, st);
}
