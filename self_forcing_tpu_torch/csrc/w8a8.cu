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
// 1536) it moves 22 MB and is bound by memory: one warp a row, the row
// read once into registers with every load in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float ACT_FLOOR = 1e-8f;     // per-token activation scale floor
constexpr int THREADS = 256;

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

}  // namespace

extern "C" int quantize_rows_launch(const void* x, void* q, void* s, int M,
                                    int K, void* stream) {
  if (M < 0 || K <= 0 || K % 8 || K > 4096) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  return launch_quantize_rows<1>((const bf16*)x, (int8_t*)q, (float*)s, M, K,
                                 (cudaStream_t)stream);
}
