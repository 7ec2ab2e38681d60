// Device helpers shared by the attention kernels: cp.async tile loads,
// ldmatrix, the m16n8k16 bf16 tensor-core product and small conversions;
// the 3xTF32 split and m16n8k8 TF32 product of the float32 kernels.
//
// Register layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row-major) a0: (g, 2t..2t+1)   a1: (g+8, 2t..)
//                        a2: (g, 2t+8..)     a3: (g+8, 2t+8..)
//   B (16x8, col)        b0: (k 2t..2t+1, n g)  b1: (k 2t+8.., n g)
//   C (16x8, f32)        c0,c1: (g, 2t..2t+1)   c2,c3: (g+8, 2t..)
// so the accumulators of two adjacent 8-wide key tiles, packed to bf16
// pairs, are the A operand of the next product over those 16 keys.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// Divide the accumulators o (rows g and g+8 of the warp's 16, D columns)
// by d0 / d1 and store them as bf16 to rows r0 / r1 (< rows) of `out`
// (row stride `stride` elements).
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, long long stride,
                                           const float (*o)[4], int r0,
                                           int r1, int rows, float d0,
                                           float d1, int tg) {
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * tg;
    if (r0 < rows) {
      *reinterpret_cast<uint32_t*>(out + r0 * stride + col) =
          pack_bf16(o[dt][0] / d0, o[dt][1] / d0);
    }
    if (r1 < rows) {
      *reinterpret_cast<uint32_t*>(out + r1 * stride + col) =
          pack_bf16(o[dt][2] / d1, o[dt][3] / d1);
    }
  }
}

// ---------------------------------------------------------------------
// 3xTF32 helpers (the float32 kernels: decode_window_f32, conv3d_f32)
// ---------------------------------------------------------------------

// x = big + small with both parts rounded to TF32 (the residual of the
// split is ~2^-22 of |x|)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float r = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(r));
}

// c += a (16x8, row) * b (8x8, col), tf32 in, f32 accumulate.  a0 (g, t)
// a1 (g+8, t) a2 (g, t+4) a3 (g+8, t+4); b0 (k t, n g) b1 (k t+4, n g).
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------------
// int8 helpers (the int8 decode attention kernels)
// ---------------------------------------------------------------------

// Asynchronously copy ROWS rows of BYTES bytes (global row stride
// `stride` bytes) into a shared tile of row stride LDB bytes; rows >=
// valid are zero-filled.  Every thread of the CTA (THREADS) takes part.
template <int ROWS, int BYTES, int LDB, int THREADS>
__device__ __forceinline__ void load_bytes(unsigned char* dst,
                                           const int8_t* src,
                                           long long stride, int valid) {
  for (int i = threadIdx.x; i < ROWS * (BYTES / 16); i += THREADS) {
    const int r = i / (BYTES / 16);
    const int c = (i % (BYTES / 16)) * 16;
    const bool ok = r < valid;
    cp_async16(dst + r * LDB + c, ok ? src + r * stride + c : src,
               ok ? 16 : 0);
  }
}

// float(i) for |i| < 2^22, exactly, without the quarter-rate I2F: the
// bits of 1.5 * 2^23 plus i are the float 1.5 * 2^23 + i.
__device__ __forceinline__ float int_to_float(int i) {
  return __int_as_float(0x4B400000 + i) - 12582912.f;
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  ldmatrix_x4(r, reinterpret_cast<const bf16*>(p));
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

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// rint(v / s) in [-127, 127], the division exact (as the TPU kernels')
__device__ __forceinline__ int quant1(float v, float s) {
  const float r = rintf(__fdiv_rn(v, s));
  return __float2int_rn(fminf(fmaxf(r, -127.f), 127.f));
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) |
         ((uint32_t)(c & 0xff) << 16) | ((uint32_t)(d & 0xff) << 24);
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
