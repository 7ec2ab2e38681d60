// Device helpers shared by the attention kernels: cp.async tile loads,
// the live-tile walk, small conversions, the 3xTF32 split of the float32
// kernels (decode_window_f32, conv3d_f32) and the int8 helpers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace sf_attn {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; bytes == 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The next tile index >= t (tiles of BK columns: cache tiles first, then
// fresh tiles, which are all visible) that has a visible column, the
// cache's visible columns being [0, sink_end) and [kv_start, kv_end);
// n_total when none is left.
template <int BK>
__device__ __forceinline__ int next_live(int t, int n_cache, int n_total,
                                         int kv_start, int kv_end,
                                         int sink_end) {
  while (t < n_cache) {
    const int j0 = t * BK;
    if (j0 < sink_end || (j0 < kv_end && j0 + BK > kv_start)) return t;
    if (j0 >= sink_end && j0 + BK <= kv_start) {
      t = max(t + 1, kv_start / BK);  // jump over the dead gap
    } else {
      ++t;
    }
  }
  return min(t, n_total);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------
// 3xTF32 helpers (the float32 kernels: decode_window_f32, conv3d_f32)
// ---------------------------------------------------------------------

// x = big + small with both parts rounded to TF32 (round to nearest, ties
// away: cvt.rna), small = tf32(x - big); the residual of the split is
// ~2^-22 of |x|.  a . b is then small_a big_b + big_a small_b + big_a big_b
// (3xTF32; ops/cuda_conv.py::split_tf32 splits the conv weights alike).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float r = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(r));
}

// split_tf32 of each of four values
__device__ __forceinline__ void split_tf32(float4 x, float4& big,
                                           float4& small) {
  uint32_t b[4], s[4];
  split_tf32(x.x, b[0], s[0]);
  split_tf32(x.y, b[1], s[1]);
  split_tf32(x.z, b[2], s[2]);
  split_tf32(x.w, b[3], s[3]);
  big = make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]),
                    __uint_as_float(b[2]), __uint_as_float(b[3]));
  small = make_float4(__uint_as_float(s[0]), __uint_as_float(s[1]),
                      __uint_as_float(s[2]), __uint_as_float(s[3]));
}

// ---------------------------------------------------------------------
// int8 helpers (the int8 decode attention kernels)
// ---------------------------------------------------------------------

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
// keep every step normal where the rounding decides anything).  Adding
// 1.5 * 2^23 then rounds the quotient half to even into the float's last
// mantissa bits, whose low byte is the int8 in two's complement.  The
// clip to [-127, 127] never binds: every |v| of a tile is at most its max
// a <= 127 s (1 + 2^-24), so |v / s| rounds to at most 127.
__device__ __forceinline__ uint32_t q8_bits(float v, float s, float rc) {
  const float q0 = __fmul_rn(v, rc);
  const float q = __fmaf_rn(__fmaf_rn(-q0, s, v), rc, q0);
  return __float_as_uint(__fadd_rn(q, 12582912.f));
}

// the low bytes of four q8_bits words, packed (a in the lowest byte)
__device__ __forceinline__ uint32_t low_bytes(uint32_t a, uint32_t b,
                                              uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// the int8 of four bf16 (two packed pairs) at scale s, packed
__device__ __forceinline__ uint32_t quant_pairs(uint32_t a, uint32_t b,
                                                float s, float rc) {
  return low_bytes(q8_bits(bf16_lo(a), s, rc), q8_bits(bf16_hi(a), s, rc),
                   q8_bits(bf16_lo(b), s, rc), q8_bits(bf16_hi(b), s, rc));
}

// the larger |x| of each half of a bf16 pair, kept as a pair (exact)
__device__ __forceinline__ __nv_bfloat162 abs_max2(__nv_bfloat162 m,
                                                   uint32_t w) {
  __nv_bfloat162 x;
  memcpy(&x, &w, 4);
  return __hmax2(m, __habs2(x));
}

// The cache tiles of `tk` rows, ntc of them, that the window [0,
// sink_end) + [kv_start, kv_end) meets: [0, a1) and [b2, c2)
// (ops/cuda_attention.py::live_cache_tiles).
inline void live_ranges(int ntc, int tk, int kv_start, int kv_end,
                        int sink_end, int* a1, int* b2, int* c2) {
  *a1 = min(ntc, (max(sink_end, 0) + tk - 1) / tk);
  *b2 = max(*a1, max(kv_start, 0) / tk);
  *c2 = max(*b2, min(ntc, (max(kv_end, 0) + tk - 1) / tk));
}

// The maximum of a non-negative value over a CTA of THREADS, in every
// thread (`red` holds THREADS / 32 floats of shared memory).
template <int THREADS>
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x % 32;
  if (lane == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  v = lane < THREADS / 32 ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace sf_attn
