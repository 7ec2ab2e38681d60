// W8A8 int8 linears of the demo configuration: per-token int8
// quantization, the int8 GEMM with its dequantizing epilogue, and the
// second half of the fused int8 FFN.  The first half (fc1) and the GEMM
// from raw bf16 x are csrc/w8a8_fc1.cu, which runs after this file's
// quantize_rows_launch where x comes raw.
//
// Replaces the TPU kernels of self_forcing_tpu/ops/pallas_matmul.py:
//   quantize_rows_launch  <- _quantize_rows_kernel (quantize_rows_pallas)
//   w8a8_matmul_launch    <- _kernel               (w8a8_matmul)
//   w8a8_ffn2_launch      <- _ffn2_kernel          (w8a8_ffn)
//
// Functions (f32 unless stated; every product and sum is rounded on its
// own, in the TPU kernels' order, so the plain PyTorch versions of
// ops/cuda_matmul.py give the same bits):
//   quantize:  s = max(absmax(row), floor) / 127,
//              q = clip(rint(x / s), -127, 127)          (half to even)
//   matmul:    out = bf16(float(x_q . w_q) * s_x[m] * w_scale[n] + b[n])
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
// dim 1536, ffn 8960) the GEMMs do 66-129 G int8 operations against
// 10-55 MB, so they are bound by the tensor cores (1979 TOP/s int8);
// quantize_rows moves 22 MB and is bound by memory: one warp a row, the
// row read once into registers with every load in flight.  Design of the
// GEMMs, simple first:
// mma.sync m16n8k32 s8 with ldmatrix fragments from XOR-swizzled shared
// tiles (conflict-free), cp.async 3-stage loads, the epilogues in
// registers.  GEMM tiles 128 x 128 x 128 bytes, 8 warps of 64 x 32.
// fc2 folds each group's int32 partial into an f32 accumulator with that
// group's scale.
// Not yet: wgmma, TMA, warp specialisation (w8a8_fc1.cu has them).

#include "attention_common.cuh"

using sf_attn::cp_async16;
using sf_attn::cp_async_commit;
using sf_attn::cp_async_wait;

namespace {

typedef __nv_bfloat16 bf16;

constexpr float ACT_FLOOR = 1e-8f;     // per-token activation scale floor
constexpr int BK = 128;                // bytes of K per staged GEMM tile
constexpr int THREADS = 256;

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  sf_attn::ldmatrix_x4(r, reinterpret_cast<const bf16*>(p));
}

// Byte offset of 16-byte chunk c of row r in a shared tile of 128-byte
// rows, XOR-swizzled so that the 8 rows an ldmatrix reads at one chunk
// land on 8 different bank groups (no padding).
__device__ __forceinline__ int swz(int r, int c) {
  return r * BK + ((c ^ (r & 7)) << 4);
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
// the max and the quantization.
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
      cp_async16(sa + swz(r, c),
                 ok ? A + (long long)(m0 + r) * K + k0 + c * 16 : A,
                 ok ? 16 : 0);
    }
    for (int i = tid; i < BN * (BK / 16); i += THREADS) {
      const int r = i >> 3, c = i & 7;
      cp_async16(sb + swz(r, c),
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
        ldsm_x4(af[mt], sa + swz(wm * 64 + mt * 16 + (lane & 15),
                                     ks + (lane >> 4)));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t t[4];
        ldsm_x4(t, sb + swz(wn * 32 + np * 16 + (lane >> 4) * 8 + (lane & 7),
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
