// W8A8 int8 linears of the demo configuration: per-token int8
// quantization, the int8 GEMM with its dequantizing epilogue, and the two
// halves of the fused int8 FFN.
//
// Replaces the TPU kernels of self_forcing_tpu/ops/pallas_matmul.py:
//   quantize_rows_launch  <- _quantize_rows_kernel (quantize_rows_pallas)
//   w8a8_matmul_launch    <- _kernel               (w8a8_matmul)
//   w8a8_ffn1_launch      <- _ffn1_kernel_bf16x    (w8a8_ffn, s_x=None)
//   w8a8_ffn1_xq_launch   <- _ffn1_kernel          (w8a8_ffn with s_x: K
//                                                   over one tile, Wan-14B)
//   w8a8_matmul_bf16x_launch <- _kernel_bf16x      (w8a8_matmul_bf16x)
//   w8a8_ffn2_launch      <- _ffn2_kernel          (w8a8_ffn)
//
// Functions (f32 unless stated; every product and sum is rounded on its
// own, in the TPU kernels' order, so the plain PyTorch versions of
// ops/cuda_matmul.py give the same bits):
//   quantize:  s = max(absmax(row), floor) / 127,
//              q = clip(rint(x / s), -127, 127)          (half to even)
//   matmul:    out = bf16(float(x_q . w_q) * s_x[m] * w_scale[n] + b[n])
//   ffn1:      x quantized per token (floor 1e-8), or int8 x_q with its
//              s_x given, h = gelu_tanh(
//              float(x_q . w1_q) * s_x * w1_scale + b1), then h quantized
//              per (token, group of TG columns) with floor 1e-6 -> int8
//              h_q [M, H] and f32 scales h_s [M, H / TG]
//   bf16x:     x quantized per token (floor 1e-8), then the matmul's
//              epilogue
//   ffn2:      acc = sum over groups g (in order) of
//              float(h_q[:, g] . w2_q[g, :]) * h_s[m, g];
//              out = bf16(acc * w2_scale[n] + b2[n])
//
// Layouts: activations row-major [M, K]; weights as the K-contiguous
// copy [N, K] (w_qa_t, made once when the parameters are quantized:
// mma.sync wants B K-contiguous per column and ldmatrix cannot transpose
// bytes); scales and biases f32.
//
// What bounds them on the H100: at the Wan-1.3B shapes (M = 4680 tokens,
// dim 1536, ffn 8960) the three GEMMs do 66-257 G int8 operations against
// 10-55 MB, so they are bound by the tensor cores (1979 TOP/s int8);
// quantize_rows moves 22 MB and is bound by memory: one warp a row, the
// row read once into registers with every load in flight.  Design of the
// GEMMs, simple first:
// mma.sync m16n8k32 s8 with ldmatrix fragments from XOR-swizzled shared
// tiles (conflict-free), cp.async 3-stage loads, the epilogues in
// registers.  GEMM tiles 128 x 128 x 128 bytes, 8 warps of 64 x 32.  fc1
// from raw x keeps one CTA's 32 quantized x rows whole in shared memory
// (K <= 1536), streams W1 in 3 stages of 64 bytes, and owns a whole
// TG-column group, so the group's row max is taken across the warps'
// accumulators in shared memory before any element is written: the gelu
// hidden never leaves registers in f32; its 16 warps of 16 rows keep 56
// accumulators a thread.  fc1 from int8 x (Wan-14B: K = 5120, where 32
// whole rows and the W1 ring would need 311 KB) stages the x tile with
// W1 in the same 64-byte K steps (the int32 sum over K is exact, so the
// steps' order does not matter) and reads s_x in the epilogue.  bf16x is
// the raw-x fc1 with the GEMM's epilogue (its re-quantization of x is
// repeated for each of the N / tn column tiles, as the TPU kernel
// re-quantizes the resident tile at each n step).
// fc2 folds each group's int32 partial into an f32 accumulator with that
// group's scale.
// Not yet: wgmma, TMA, warp specialisation.

#include "attention_common.cuh"

using sf_attn::cp_async16;
using sf_attn::cp_async_commit;
using sf_attn::cp_async_wait;

namespace {

typedef __nv_bfloat16 bf16;

constexpr float ACT_FLOOR = 1e-8f;     // per-token activation scale floor
constexpr float HIDDEN_FLOOR = 1e-6f;  // gelu hidden: rows can be ~0
constexpr int BK = 128;                // bytes of K per staged GEMM tile
constexpr int FBK = 64;                // bytes of K per staged fc1 B tile
constexpr int THREADS = 256;

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  sf_attn::ldmatrix_x4(r, reinterpret_cast<const bf16*>(p));
}

// Byte offset of 16-byte chunk c of row r in a shared tile of RB-byte
// rows (RB = 128 or 64), XOR-swizzled so that the 8 rows an ldmatrix
// reads at one chunk land on 8 different bank groups (no padding).
template <int RB>
__device__ __forceinline__ int swz(int r, int c) {
  return r * RB + ((RB == 128 ? c ^ (r & 7) : c ^ ((r >> 1) & 3)) << 4);
}

// c += a (16x32 s8, row) * b (32x8 s8, col), s32 accumulate.  Fragments:
// a0 (g, 4t..4t+3) a1 (g+8, 4t..) a2 (g, 16+4t..) a3 (g+8, 16+4t..);
// b0 (k 4t..4t+3, n g) b1 (k 16+4t.., n g); c as for m16n8k16.
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int quant1(float v, float s) {
  const float r = rintf(__fdiv_rn(v, s));
  return __float2int_rn(fminf(fmaxf(r, -127.f), 127.f));
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) |
         ((uint32_t)(c & 0xff) << 16) | ((uint32_t)(d & 0xff) << 24);
}

// The two floats of a packed bf16 pair (exact).
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// One warp quantizes one bf16 row of K <= 256 * CH elements (K a multiple
// of 8, rows 16-byte aligned) into dst and returns its scale.  The row is
// read once, every load in flight together, and kept in registers between
// the max and the quantization.  Shared by quantize_rows and fc1's
// prologue.
template <int CH>
__device__ float warp_quantize_row(const bf16* __restrict__ src, int K,
                                   int8_t* dst) {
  const int lane = threadIdx.x & 31;
  uint4 v[CH];
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = lane * 8 + i * 256;
    v[i] = c < K ? *reinterpret_cast<const uint4*>(src + c)
                 : make_uint4(0, 0, 0, 0);
  }
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const uint32_t w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      amax = fmaxf(amax, fmaxf(fabsf(bf16_lo(w[j])), fabsf(bf16_hi(w[j]))));
  }
#pragma unroll
  for (int o = 16; o; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = __fdiv_rn(fmaxf(amax, ACT_FLOOR), 127.f);
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = lane * 8 + i * 256;
    if (c >= K) continue;
    const uint32_t w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
    int q[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      q[2 * j] = quant1(bf16_lo(w[j]), s);
      q[2 * j + 1] = quant1(bf16_hi(w[j]), s);
    }
    *reinterpret_cast<uint2*>(dst + c) =
        make_uint2(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]));
  }
  return s;
}

// gelu with the tanh approximation, in the order of jax.nn.gelu
__device__ __forceinline__ float gelu_tanh(float x) {
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner =
      __fmul_rn(0.7978845834732056f, __fadd_rn(x, __fmul_rn(0.044715f, x3)));
  return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.f, tanhf(inner))));
}

// ---------------------------------------------------------------------
// quantize_rows: one warp per row
// ---------------------------------------------------------------------

template <int CH>
__global__ void __launch_bounds__(THREADS)
    quantize_rows_kernel(const bf16* __restrict__ x, int8_t* __restrict__ q,
                         float* __restrict__ s, int M, int K) {
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (row >= M) return;
  const float sc = warp_quantize_row<CH>(x + (long long)row * K, K,
                                         q + (long long)row * K);
  if ((threadIdx.x & 31) == 0) s[row] = sc;
}

template <int CH>
int launch_quantize_rows(const bf16* x, int8_t* q, float* s, int M, int K,
                         cudaStream_t stream) {
  if constexpr (CH < 16) {  // K <= 4096
    if (K > 256 * CH)
      return launch_quantize_rows<CH + 1>(x, q, s, M, K, stream);
  }
  const int rows = THREADS / 32;
  quantize_rows_kernel<CH><<<(M + rows - 1) / rows, THREADS, 0, stream>>>(
      x, q, s, M, K);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// int8 GEMM out[M, N] = A[M, K] . B[N, K]^T with a dequantizing epilogue.
// GROUPED (fc2): a_scale is [M, K / group] and each group's int32 partial
// is folded into an f32 accumulator; otherwise a_scale is [M].
// ---------------------------------------------------------------------

constexpr int BM = 128, BN = 128, STAGES = 3;
constexpr int STAGE_BYTES = (BM + BN) * BK;
constexpr int GEMM_SMEM = STAGES * STAGE_BYTES;  // 98304

template <bool GROUPED>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_s8_kernel(const int8_t* __restrict__ A,
                   const float* __restrict__ a_scale,
                   const int8_t* __restrict__ B,
                   const float* __restrict__ w_scale,
                   const float* __restrict__ bias, bf16* __restrict__ out,
                   int M, int N, int K, int group) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = K / BK;

  auto load_stage = [&](int stage, int kt) {
    unsigned char* sa = smem + stage * STAGE_BYTES;
    unsigned char* sb = sa + BM * BK;
    const long long k0 = (long long)kt * BK;
    for (int i = tid; i < BM * (BK / 16); i += THREADS) {
      const int r = i >> 3, c = i & 7;
      const bool ok = m0 + r < M;
      cp_async16(sa + swz<BK>(r, c),
                 ok ? A + (long long)(m0 + r) * K + k0 + c * 16 : A,
                 ok ? 16 : 0);
    }
    for (int i = tid; i < BN * (BK / 16); i += THREADS) {
      const int r = i >> 3, c = i & 7;
      cp_async16(sb + swz<BK>(r, c),
                 B + (long long)(n0 + r) * K + k0 + c * 16, 16);
    }
  };

  int acc[4][4][4];
  float facc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[a][b][c] = 0;
        facc[a][b][c] = 0.f;
      }
  const int ng = GROUPED ? K / group : 1;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    {
      const int nt = kt + STAGES - 1;
      if (nt < nk) load_stage(nt % STAGES, nt);
      cp_async_commit();
    }
    const unsigned char* sa = smem + (kt % STAGES) * STAGE_BYTES;
    const unsigned char* sb = sa + BM * BK;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ks += 2) {  // 32 bytes of K a step
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4(af[mt], sa + swz<BK>(wm * 64 + mt * 16 + (lane & 15),
                                     ks + (lane >> 4)));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t t[4];
        ldsm_x4(t, sb + swz<BK>(wn * 32 + np * 16 + (lane >> 4) * 8 + (lane & 7),
                                ks + ((lane >> 3) & 1)));
        bfr[2 * np][0] = t[0];
        bfr[2 * np][1] = t[1];
        bfr[2 * np + 1][0] = t[2];
        bfr[2 * np + 1][1] = t[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_s8(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
    }
    if (GROUPED && ((kt + 1) * BK) % group == 0) {
      const int g = (kt + 1) * BK / group - 1;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r0 = m0 + wm * 64 + mt * 16 + (lane >> 2);
        const float s0 = r0 < M ? a_scale[(long long)r0 * ng + g] : 0.f;
        const float s1 = r0 + 8 < M ? a_scale[(long long)(r0 + 8) * ng + g] : 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            facc[mt][nt][i] = __fadd_rn(
                facc[mt][nt][i],
                __fmul_rn(__int2float_rn(acc[mt][nt][i]), i < 2 ? s0 : s1));
            acc[mt][nt][i] = 0;
          }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 64 + mt * 16 + (lane >> 2) + half * 8;
      if (row >= M) continue;
      const float sx = GROUPED ? 1.f : a_scale[row];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn * 32 + nt * 8 + (lane & 3) * 2;
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = half * 2 + j;
          const float y = GROUPED
                              ? facc[mt][nt][i]
                              : __fmul_rn(__int2float_rn(acc[mt][nt][i]), sx);
          v[j] = __fadd_rn(__fmul_rn(y, w_scale[col + j]), bias[col + j]);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * N + col) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
    }
  }
}

// ---------------------------------------------------------------------
// fc1 and the raw-x GEMM: one CTA owns FM = 32 rows x TG columns (16 warps
// of 16 x TG/8; 56 accumulators a thread at TG 896, so 16 warps fit the
// register file and hide the latency that 8 warps of 32 x TG/8 could
// not).  Three modes:
//   FFN_RAW     raw bf16 x [M, K <= 1536], quantized per token in the
//               prologue into a whole-K shared tile; epilogue: dequant +
//               bias -> gelu -> int8 per (token, TG-column group)
//   FFN_XQ      int8 x [M, K] (any K % 64 == 0) and its per-token s_x,
//               staged with W in K steps of 64 bytes; the same epilogue
//   LINEAR_RAW  raw x as FFN_RAW; epilogue: bf16(acc * s_x * w_scale + b)
// ---------------------------------------------------------------------

constexpr int FM = 32;
constexpr int F_THREADS = 512;
constexpr int FSTAGES = 3;  // B stages of TG x 64 bytes: 168 KB at TG 896
enum FMode { FFN_RAW = 0, FFN_XQ = 1, LINEAR_RAW = 2 };

__host__ __device__ constexpr int ffn1_smem(int K, int TG, int MODE) {
  return (MODE == FFN_XQ ? FSTAGES * FM * FBK : FM * (K + 16)) + FM * 4 +
         8 * FM * 4 + FSTAGES * TG * FBK;
}

template <int TG, int MODE>
__global__ void __launch_bounds__(F_THREADS, 1)
    ffn1_kernel(const void* __restrict__ xin, const float* __restrict__ s_x,
                const int8_t* __restrict__ W,
                const float* __restrict__ w_scale,
                const float* __restrict__ bias, int8_t* __restrict__ hq,
                float* __restrict__ hs, bf16* __restrict__ out, int M, int K,
                int H) {
  constexpr int NT = TG / 64;  // 8-column tiles per warp
  constexpr bool RAW = MODE != FFN_XQ;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 3, wn = warp & 7;  // 2 x 8 warps of 16 x TG/8
  const int lda = K + 16;
  // RAW: FM x lda int8 (whole K); XQ: FSTAGES swizzled FM x 64-byte tiles
  unsigned char* sa = smem;
  float* sx = reinterpret_cast<float*>(
      smem + (RAW ? FM * lda : FSTAGES * FM * FBK));  // FM scales
  float* red = sx + FM;                  // 8 column warps x FM maxima
  unsigned char* sb = reinterpret_cast<unsigned char*>(red + 8 * FM);
  const int m0 = blockIdx.x * FM, g = blockIdx.y, n0 = g * TG;
  const int nk = K / FBK;
  const int8_t* xq = reinterpret_cast<const int8_t*>(xin);

  auto load_stage = [&](int stage, int kt) {
    unsigned char* dst = sb + stage * TG * FBK;
    const long long k0 = (long long)kt * FBK;
    for (int i = tid; i < TG * (FBK / 16); i += F_THREADS) {
      const int r = i >> 2, c = i & 3;
      cp_async16(dst + swz<FBK>(r, c),
                 W + (long long)(n0 + r) * K + k0 + c * 16, 16);
    }
    if (!RAW && tid < FM * (FBK / 16)) {
      const int r = tid >> 2, c = tid & 3;
      const bool ok = m0 + r < M;
      cp_async16(sa + stage * FM * FBK + swz<FBK>(r, c),
                 ok ? xq + (long long)(m0 + r) * K + k0 + c * 16 : xq,
                 ok ? 16 : 0);
    }
  };

#pragma unroll
  for (int st = 0; st < FSTAGES - 1; ++st) {
    if (st < nk) load_stage(st, st);
    cp_async_commit();
  }
  if (RAW) {
    // prologue: warp w quantizes rows w, w + 16 (zeros past M)
    const bf16* x = reinterpret_cast<const bf16*>(xin);
    for (int r = warp; r < FM; r += F_THREADS / 32) {
      int8_t* dst = reinterpret_cast<int8_t*>(sa + r * lda);
      if (m0 + r < M) {
        const float s = warp_quantize_row<6>(x + (long long)(m0 + r) * K, K,
                                             dst);
        if (lane == 0) sx[r] = s;
      } else {
        for (int c = lane * 16; c < K; c += 512)
          *reinterpret_cast<uint4*>(dst + c) = make_uint4(0, 0, 0, 0);
        if (lane == 0) sx[r] = 0.f;
      }
    }
  } else if (tid < FM) {
    sx[tid] = m0 + tid < M ? s_x[m0 + tid] : 0.f;
  }

  int acc[NT][4];
#pragma unroll
  for (int b = 0; b < NT; ++b)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[b][c] = 0;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<FSTAGES - 2>();
    __syncthreads();
    if (kt + FSTAGES - 1 < nk)
      load_stage((kt + FSTAGES - 1) % FSTAGES, kt + FSTAGES - 1);
    cp_async_commit();
    const unsigned char* b = sb + (kt % FSTAGES) * TG * FBK;
    const unsigned char* a = sa + (kt % FSTAGES) * FM * FBK;
#pragma unroll
    for (int ks = 0; ks < FBK / 16; ks += 2) {  // 32 bytes of K a step
      uint32_t af[4];
      const int ar = wm * 16 + (lane & 15), ac = ks + (lane >> 4);
      if (RAW)
        ldsm_x4(af, sa + ar * lda + kt * FBK + ac * 16);
      else
        ldsm_x4(af, a + swz<FBK>(ar, ac));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t t[4];
        ldsm_x4(t, b + swz<FBK>(wn * (TG / 8) + np * 16 + (lane >> 4) * 8 +
                                    (lane & 7),
                                ks + ((lane >> 3) & 1)));
        mma_s8(acc[2 * np], af, t[0], t[1]);
        mma_s8(acc[2 * np + 1], af, t[2], t[3]);
      }
    }
  }
  cp_async_wait<0>();

  if (MODE == LINEAR_RAW) {
    // the GEMM epilogue: bf16(float(acc) * s_x * w_scale + b)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rl = wm * 16 + (lane >> 2) + half * 8, row = m0 + rl;
      if (row >= M) continue;
      const float s = sx[rl];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = n0 + wn * (TG / 8) + nt * 8 + (lane & 3) * 2;
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          v[j] = __fadd_rn(
              __fmul_rn(__fmul_rn(__int2float_rn(acc[nt][half * 2 + j]), s),
                        w_scale[col + j]),
              bias[col + j]);
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * H + col) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
    }
    return;
  }

  // epilogue 1: dequant + bias + gelu in place (as f32 bits), row maxima
  float rmax[2] = {0.f, 0.f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float s = sx[wm * 16 + (lane >> 2) + half * 8];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = n0 + wn * (TG / 8) + nt * 8 + (lane & 3) * 2 + j;
        const int i = half * 2 + j;
        const float y = __fadd_rn(
            __fmul_rn(__fmul_rn(__int2float_rn(acc[nt][i]), s), w_scale[col]),
            bias[col]);
        const float h = gelu_tanh(y);
        rmax[half] = fmaxf(rmax[half], fabsf(h));
        acc[nt][i] = __float_as_int(h);
      }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float m = rmax[half];
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    if ((lane & 3) == 0) red[wn * FM + wm * 16 + (lane >> 2) + half * 8] = m;
  }
  __syncthreads();

  // epilogue 2: the group scale of each row, then int8 out
  const int ng = H / TG;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rl = wm * 16 + (lane >> 2) + half * 8;
    float m = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) m = fmaxf(m, red[w * FM + rl]);
    const float s = __fdiv_rn(fmaxf(m, HIDDEN_FLOOR), 127.f);
    const int row = m0 + rl;
    if (row >= M) continue;
    if (wn == 0 && (lane & 3) == 0) hs[(long long)row * ng + g] = s;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = n0 + wn * (TG / 8) + nt * 8 + (lane & 3) * 2;
      const int q0 = quant1(__int_as_float(acc[nt][half * 2]), s);
      const int q1 = quant1(__int_as_float(acc[nt][half * 2 + 1]), s);
      *reinterpret_cast<uint16_t*>(hq + (long long)row * H + col) =
          (uint16_t)((q0 & 0xff) | ((q1 & 0xff) << 8));
    }
  }
}

template <int TG, int MODE>
int launch_ffn1(const void* x, const float* sx, const int8_t* w,
                const float* ws, const float* b, int8_t* hq, float* hs,
                bf16* out, int M, int K, int H, cudaStream_t stream) {
  const int smem = ffn1_smem(K, TG, MODE);
  cudaError_t err = cudaFuncSetAttribute(
      ffn1_kernel<TG, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + FM - 1) / FM, H / TG);
  ffn1_kernel<TG, MODE><<<grid, F_THREADS, smem, stream>>>(
      x, sx, w, ws, b, hq, hs, out, M, K, H);
  return (int)cudaGetLastError();
}

// The instantiation of group (column tile) width tg in {128, ..., 896}.
template <int MODE>
int launch_ffn1_tg(int tg, const void* x, const float* sx, const int8_t* w,
                   const float* ws, const float* b, int8_t* hq, float* hs,
                   bf16* out, int M, int K, int H, cudaStream_t st) {
  switch (tg) {
#define SF_TG(T) \
  case T: return launch_ffn1<T, MODE>(x, sx, w, ws, b, hq, hs, out, M, K, H, st);
    SF_TG(128) SF_TG(256) SF_TG(384) SF_TG(512) SF_TG(640) SF_TG(768)
    SF_TG(896)
#undef SF_TG
  }
  return (int)cudaErrorInvalidValue;
}

template <bool GROUPED>
int launch_gemm(const int8_t* a, const float* as, const int8_t* w,
                const float* ws, const float* b, bf16* out, int M, int N,
                int K, int group, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_s8_kernel<GROUPED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      GEMM_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N / BN, (M + BM - 1) / BM);
  gemm_s8_kernel<GROUPED><<<grid, THREADS, GEMM_SMEM, stream>>>(
      a, as, w, ws, b, out, M, N, K, group);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int quantize_rows_launch(const void* x, void* q, void* s, int M,
                                    int K, void* stream) {
  if (M < 0 || K <= 0 || K % 8 || K > 4096) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  return launch_quantize_rows<1>((const bf16*)x, (int8_t*)q, (float*)s, M, K,
                                 (cudaStream_t)stream);
}

// x_q [M, K] int8, s_x [M] f32, w_t [N, K] int8, w_scale / b [N] f32,
// out [M, N] bf16.  K % 128 == 0, N % 128 == 0.
extern "C" int w8a8_matmul_launch(const void* xq, const void* sx,
                                  const void* wt, const void* ws,
                                  const void* b, void* out, int M, int N,
                                  int K, void* stream) {
  if (M < 0 || K <= 0 || K % BK || N <= 0 || N % BN)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  return launch_gemm<false>((const int8_t*)xq, (const float*)sx,
                            (const int8_t*)wt, (const float*)ws,
                            (const float*)b, (bf16*)out, M, N, K, K,
                            (cudaStream_t)stream);
}

// x [M, K] bf16, w1_t [H, K] int8, w_scale / b [H] f32 -> h_q [M, H] int8,
// h_s [M, H / tg] f32.  K % 64 == 0, K <= 1536, tg in {128, ..., 896}.
extern "C" int w8a8_ffn1_launch(const void* x, const void* w1t,
                                const void* ws, const void* b, void* hq,
                                void* hs, int M, int K, int H, int tg,
                                void* stream) {
  if (M < 0 || K <= 0 || K % FBK || K > 1536 || tg % 128 || tg < 128 ||
      tg > 896 || H % tg)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  return launch_ffn1_tg<FFN_RAW>(tg, x, nullptr, (const int8_t*)w1t,
                                 (const float*)ws, (const float*)b,
                                 (int8_t*)hq, (float*)hs, nullptr, M, K, H,
                                 (cudaStream_t)stream);
}

// x_q [M, K] int8 with s_x [M] f32, w1_t [H, K] int8, w_scale / b [H] f32
// -> h_q [M, H] int8, h_s [M, H / tg] f32.  K % 64 == 0 (any K), tg in
// {128, ..., 896}.
extern "C" int w8a8_ffn1_xq_launch(const void* xq, const void* sx,
                                   const void* w1t, const void* ws,
                                   const void* b, void* hq, void* hs, int M,
                                   int K, int H, int tg, void* stream) {
  if (M < 0 || K <= 0 || K % FBK || tg % 128 || tg < 128 || tg > 896 ||
      H % tg)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  return launch_ffn1_tg<FFN_XQ>(tg, xq, (const float*)sx,
                                (const int8_t*)w1t, (const float*)ws,
                                (const float*)b, (int8_t*)hq, (float*)hs,
                                nullptr, M, K, H, (cudaStream_t)stream);
}

// x [M, K] bf16, w_t [N, K] int8, w_scale / b [N] f32 -> out [M, N] bf16
// through column tiles of tn in {128, ..., 896} (N % tn == 0).  K % 64 ==
// 0, K <= 1536.
extern "C" int w8a8_matmul_bf16x_launch(const void* x, const void* wt,
                                        const void* ws, const void* b,
                                        void* out, int M, int N, int K,
                                        int tn, void* stream) {
  if (M < 0 || K <= 0 || K % FBK || K > 1536 || tn % 128 || tn < 128 ||
      tn > 896 || N % tn)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  return launch_ffn1_tg<LINEAR_RAW>(tn, x, nullptr, (const int8_t*)wt,
                                    (const float*)ws, (const float*)b,
                                    nullptr, nullptr, (bf16*)out, M, K, N,
                                    (cudaStream_t)stream);
}

// h_q [M, H] int8, h_s [M, H / tg] f32, w2_t [N, H] int8, w_scale / b [N]
// f32 -> out [M, N] bf16.  tg % 128 == 0, N % 128 == 0.
extern "C" int w8a8_ffn2_launch(const void* hq, const void* hs,
                                const void* w2t, const void* ws,
                                const void* b, void* out, int M, int N,
                                int H, int tg, void* stream) {
  if (M < 0 || tg <= 0 || tg % BK || H % tg || N <= 0 || N % BN)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  return launch_gemm<true>((const int8_t*)hq, (const float*)hs,
                           (const int8_t*)w2t, (const float*)ws,
                           (const float*)b, (bf16*)out, M, N, H, tg,
                           (cudaStream_t)stream);
}
