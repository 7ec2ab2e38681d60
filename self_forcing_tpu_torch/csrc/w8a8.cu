// quantize_rows: per-token int8 quantization of the W8A8 linears' bf16
// activations.  It is the only kernel of this file: every W8A8 product
// (fc1, fc2 and the linears, from int8 x) is csrc/w8a8_fc1.cu, which runs
// after quantize_rows_launch where x comes raw.
//
// Replaces the TPU kernel of self_forcing_tpu/ops/pallas_matmul.py:
//   quantize_rows_launch  <- _quantize_rows_kernel (quantize_rows_pallas)
//
// Function (f32; the division rounded on its own, so the plain PyTorch
// version of ops/cuda_matmul.py gives the same bits):
//   s = max(absmax(row), 1e-8) / 127,  q = clip(rint(x / s), -127, 127)
//   (half to even)
//
// What bounds it on the H100: at the Wan-1.3B shape (M = 4680 tokens, K
// 1536) it moves 22 MB and is bound by memory (6.4 us at 3.35 TB/s).  One
// warp a row, 8 rows a CTA: at M 4680 all 585 CTAs are resident at once
// (no tail wave), and each lane holds its 16-element chunks of the row in
// registers (every load in flight together) between the max and the
// quantization.  The per-element work is a few instructions, so the
// arithmetic hides under the loads: the max over bf16 pairs (exact), the
// correctly rounded quotient from the row's reciprocal and two FMAs, its
// rounding and int8 bits from one FADD (the clip never binds), bytes
// packed by PRMT and stored 16 at a time (8 where K % 16 != 0 leaves rows
// 8-byte aligned).

#include <cstring>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float ACT_FLOOR = 1e-8f;     // per-token activation scale floor
constexpr int THREADS = 256;

// The two floats of a packed bf16 pair (exact).
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// rint(v / s) as the low byte of the returned bits, with v / s correctly
// rounded (true division) from rc = RN(1 / s): q0 = RN(v rc) is within an
// ulp of v / s, the residual v - s q0 is exact by FMA, and q0 + residual *
// rc rounds to RN(v / s) (Markstein's theorem; |v| <= 127 s and s >= 1e-8
// / 127 keep every step normal where the rounding decides anything).
// Adding 1.5 * 2^23 then rounds the quotient half to even into the float's
// last mantissa bits, whose low byte is the int8 in two's complement.  The
// clip to [-127, 127] never binds: every |v| of a row is at most its max
// a <= 127 s (1 + 2^-24), so |v / s| rounds to at most 127.
__device__ __forceinline__ uint32_t q8_bits(float v, float s, float rc) {
  const float q0 = __fmul_rn(v, rc);
  const float q = __fmaf_rn(__fmaf_rn(-q0, s, v), rc, q0);
  return __float_as_uint(__fadd_rn(q, 12582912.f));
}

// the int8 of four bf16 (two packed pairs) at scale s, packed
__device__ __forceinline__ uint32_t quant_pairs(uint32_t a, uint32_t b,
                                                float s, float rc) {
  const uint32_t lo = __byte_perm(q8_bits(bf16_lo(a), s, rc),
                                  q8_bits(bf16_hi(a), s, rc), 0x0040);
  const uint32_t hi = __byte_perm(q8_bits(bf16_lo(b), s, rc),
                                  q8_bits(bf16_hi(b), s, rc), 0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

// the larger |x| of each half of a bf16 pair, kept as a pair (exact)
__device__ __forceinline__ __nv_bfloat162 abs_max2(__nv_bfloat162 m,
                                                   uint32_t w) {
  __nv_bfloat162 x;
  memcpy(&x, &w, 4);
  return __hmax2(m, __habs2(x));
}

// One warp a row of K <= 512 * CH elements (K % 8 == 0): lane l holds the
// 16-element chunks l, l + 32, ... (a half chunk at the end where K % 16
// != 0).  ALIGNED: K % 16 == 0, so every chunk's int8 store is 16-byte
// aligned.
template <int CH, bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
    quantize_rows_kernel(const bf16* __restrict__ x, int8_t* __restrict__ q,
                         float* __restrict__ s, int M, int K) {
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (row >= M) return;
  const int lane = threadIdx.x & 31;
  const bf16* src = x + (long long)row * K;
  uint4 v[2 * CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int c = 16 * (lane + 32 * j);
    v[2 * j] = c < K ? *reinterpret_cast<const uint4*>(src + c)
                     : make_uint4(0u, 0u, 0u, 0u);
    v[2 * j + 1] = c + 8 < K
                       ? *reinterpret_cast<const uint4*>(src + c + 8)
                       : make_uint4(0u, 0u, 0u, 0u);
  }
  __nv_bfloat162 m2 = __float2bfloat162_rn(0.f);
#pragma unroll
  for (int j = 0; j < 2 * CH; ++j)
    m2 = abs_max2(abs_max2(abs_max2(abs_max2(m2, v[j].x), v[j].y), v[j].z),
                  v[j].w);
  float amax = fmaxf(__low2float(m2), __high2float(m2));
#pragma unroll
  for (int o = 16; o; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float sc = __fdiv_rn(fmaxf(amax, ACT_FLOOR), 127.f);
  const float rc = __frcp_rn(sc);
  int8_t* dst = q + (long long)row * K;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int c = 16 * (lane + 32 * j);
    if (c >= K) continue;
    const uint32_t w0 = quant_pairs(v[2 * j].x, v[2 * j].y, sc, rc);
    const uint32_t w1 = quant_pairs(v[2 * j].z, v[2 * j].w, sc, rc);
    if (c + 8 < K) {
      const uint32_t w2 = quant_pairs(v[2 * j + 1].x, v[2 * j + 1].y, sc, rc);
      const uint32_t w3 = quant_pairs(v[2 * j + 1].z, v[2 * j + 1].w, sc, rc);
      if (ALIGNED) {
        *reinterpret_cast<uint4*>(dst + c) = make_uint4(w0, w1, w2, w3);
      } else {
        *reinterpret_cast<uint2*>(dst + c) = make_uint2(w0, w1);
        *reinterpret_cast<uint2*>(dst + c + 8) = make_uint2(w2, w3);
      }
    } else {
      *reinterpret_cast<uint2*>(dst + c) = make_uint2(w0, w1);
    }
  }
  if (lane == 0) s[row] = sc;
}

template <int CH>
int launch_quantize_rows(const bf16* x, int8_t* q, float* s, int M, int K,
                         cudaStream_t stream) {
  if constexpr (CH < 8) {  // K <= 4096
    if (K > 512 * CH)
      return launch_quantize_rows<CH + 1>(x, q, s, M, K, stream);
  }
  const int rows = THREADS / 32;
  const unsigned grid = (unsigned)((M + rows - 1) / rows);
  if (K % 16 == 0)
    quantize_rows_kernel<CH, true><<<grid, THREADS, 0, stream>>>(x, q, s, M,
                                                                 K);
  else
    quantize_rows_kernel<CH, false><<<grid, THREADS, 0, stream>>>(x, q, s, M,
                                                                  K);
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
