// Hopper (sm_90a) building blocks of the port's warp-specialised kernels:
// mbarriers, TMA tile loads, wgmma descriptors and products,
// register hand-over (setmaxnreg), named barriers, and the host-side
// encoding of TMA tensor maps.  Inline PTX only (no CuTe), so a source
// that includes this header builds in seconds.
//
// The usual shape (decode_fresh.cu): one producer warp (one elected
// thread) issues TMA loads of K / V tiles into a ring of shared stages,
// each stage guarded by a `full` mbarrier (the TMA's bytes land; the
// consumers wait on it) and an `empty` mbarrier (each consumer
// warpgroup arrives once when it is done with the stage; the producer
// waits on it before reusing it); consumer warpgroups run wgmma on the
// stages.  Phase parity: a barrier starts in phase 0; wait(bar, p)
// returns once the phase of parity p has completed, and wait(bar, 1) on a
// fresh barrier returns at once, so a producer starts its `empty` waits
// at parity 1 and a consumer its `full` waits at parity 0, and each flips
// its parity whenever its stage index wraps.
//
// Shared-memory tiles are bf16 with 128-byte swizzle: a TMA box whose
// inner dimension is 64 bf16 (128 bytes) lands as rows of 128 bytes in
// which 16-byte chunk c of row r sits at chunk c ^ (r % 8); every box
// starts at a 1024-byte-aligned address.  A 128-wide head dim is two such
// boxes (columns 0..63, then 64..127), each ROWS * 128 bytes.  An fp32
// box (a reduction's source) has 32 inner elements, the same 128 bytes.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sf_hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------
// mbarriers (64-bit, in shared memory)
// ---------------------------------------------------------------------

// One thread initialises a barrier that completes a phase after `count`
// arrivals (plus the transaction bytes announced by expect_tx); then
// fence_barrier_init() and a CTA barrier before any thread uses it.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}
// one arrival that also announces `bytes` of TMA transactions: the phase
// completes when they have landed (the producer's call before its loads)
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// spin until the phase of parity `parity` has completed; a wait that
// outlasts 2^26 tries (seconds) traps, so a protocol fault ends the
// kernel with an error instead of hanging the card.  The loop is one
// PTX block: written as a C++ loop around __trap(), its exit path made
// ptxas serialise the wgmmas of a kernel that waits between products
// (C7512) and spill.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\nmov.u32 n, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.ne.u32 p, n, 67108864;\n"
      "@p bra WAIT;\n"
      "trap;\n"
      "DONE:\n}\n"
      ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

// ---------------------------------------------------------------------
// TMA (cp.async.bulk.tensor): one thread moves a whole box.  `map` is the
// address of a __grid_constant__ CUtensorMap kernel parameter; the
// coordinates are elements, innermost first; a box that reaches past a
// dimension's extent reads zeros there (and still counts its full size
// in transaction bytes).
// ---------------------------------------------------------------------

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2) : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}
// `bytes` (a multiple of 16; both addresses 16-byte aligned) of contiguous
// global memory into shared memory, counted in `bar`'s transaction bytes
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Shared memory written by ordinary stores and then read by the async
// proxy (wgmma operands, TMA stores and reductions): after the stores,
// before the barrier that hands the tile over.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// TMA reduction: the box at `src` (shared, laid out as the map's box)
// added element-wise into global memory through `map` (fp32 add).  One
// thread issues it; bulk_commit() closes the issued reductions into a
// group, bulk_wait_read<N>() returns once at most N groups may still read
// their shared source (so it may be rewritten), bulk_wait<N>() once at
// most N groups are still writing.
__device__ __forceinline__ void tma_reduce_add_3d(const CUtensorMap* map,
                                                  const void* src, int c0,
                                                  int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
      "r"(c1), "r"(c2) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------
// wgmma: a warpgroup (4 warps, 128 threads) multiplies a 64-row tile.
// ---------------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled bf16 tile (at a
// pointer, or at a shared-memory address).
//   K-major (A or B with the reduction dim contiguous, e.g. Q and K stored
//   [row][d]): `p` is the first row's address plus 32 bytes per 16-wide
//   k-step inside the 64-wide box; sbo = 1024 (8 rows of 128 bytes); lbo
//   is unused (16).
//   MN-major (B with the output dim contiguous, e.g. V stored [key][d],
//   read with TRANS_B = 1; or A with its rows contiguous, TRANS_A = 1):
//   `p` is the first key row of the k-step (128 bytes a key); sbo = 1024
//   (the next 8 keys), lbo = the distance to the box of the next 64
//   output columns (unread when the tile has 64).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return desc_sw128(smem_u32(p), lbo, sbo);
}

// Before the first wgmma of a batch, and whenever the accumulators or the
// register A operand were written by ordinary instructions since the last.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
// close the wgmmas issued since the last commit into one group
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are still running; their
// accumulators (and register A operands) may be touched only after this
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of accumulators across a
// wgmma_wait (the asm above does not name them)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Four 8x8 bf16 matrices from registers to shared memory: lane l gives
// the address of row l % 8 of matrix l / 8 (16 bytes); r[j] is this
// thread's pair of matrix j in the mma layout (row lane / 4, columns
// 2 (lane % 4), + 1), which is the wgmma accumulator layout of each 8x8
// block, packed to bf16.
__device__ __forceinline__ void stmatrix_x4(void* row, uint32_t r0,
                                            uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
      ::"r"(smem_u32(row)), "r"(r0), "r"(r1), "r"(r2), "r"(r3) : "memory");
}

// the same for packed bf16 register A operands: keeps the registers of a
// wgmma's A live (unreused) until the wait that retires it
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (+)= A . B, m64n64k16 bf16 -> f32 (32 accumulators a thread), A and B
// from shared memory; TRANS_A / TRANS_B 0 read them K-major, 1 MN-major;
// accumulate = 0 overwrites d.
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31} "
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_A), "n"(TRANS_B));
}

// d (+)= A . B, m64n128k16 bf16 -> f32 (64 accumulators a thread), A and
// B read from shared memory through their descriptors (both K-major);
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                    uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63} "
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}


// d += A . B, m64n128k16 bf16 -> f32 (64 accumulators a thread), A from
// registers, B from shared memory (TRANS_B 1: B MN-major, e.g. V stored
// [key][d]).  Thread (warp w of the warpgroup, lane l) holds A rows
// 16 w + l / 4 (a[0], a[2]) and + 8 (a[1], a[3]), columns 2 (l % 4)
// (a[0], a[1]) and + 8 (a[2], a[3]), two bf16 each: the m16n8k16 A
// layout.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t* a,
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63} "
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TRANS_B));
}


// Accumulator layout of an m64nN f32 wgmma (thread: warp w of the
// warpgroup, lane l, g = l / 4, t = l % 4): d[4 i + e] is row 16 w + g
// (e < 2) or 16 w + g + 8 (e >= 2), column 8 i + 2 t + (e & 1).  Columns
// 16 k .. 16 k + 15 of it, packed to bf16 pairs, are the register A
// operand of a k-step over those 16 columns (keys): a[0..3] =
// (d[8k], d[8k+1]), (d[8k+2], d[8k+3]), (d[8k+4], d[8k+5]),
// (d[8k+6], d[8k+7]).

// ---------------------------------------------------------------------
// warp specialisation
// ---------------------------------------------------------------------

// Hand registers between warpgroups: every warp of a warpgroup executes
// the same call; a producer lowers its limit, the consumers raise theirs
// (the total must fit the 64 K registers the CTA was launched with).
template <int REGS>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
// Named barriers 1..15 over `threads` threads (barrier 0 is
// __syncthreads): sync waits for `threads` arrivals counting its own
// warp's; arrive adds its warp's and goes on.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------
// host: TMA tensor maps
// ---------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime's entry-point
// query (so the library needs no -lcuda); null if the driver lacks it.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map of `rank` dims (extents `dims`, innermost first;
// `strides` the byte strides of dims 1..rank-1, multiples of 16) read or
// reduced in boxes `box` whose inner extent is 128 bytes (128-byte
// swizzle); reads past an extent give zeros and reductions past it are
// dropped.  Returns a CUDA error code (0 on success).
inline int tile_map(CUtensorMap* map, CUtensorMapDataType type,
                    const void* base, int rank, const uint64_t* dims,
                    const uint64_t* strides, const uint32_t* box) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i + 1 < rank) s[i] = strides[i];
  }
  CUresult r = fn(map, type, (cuuint32_t)rank, const_cast<void*>(base), d,
                  s, b, e, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}
// bf16 boxes of 64 inner elements; fp32 boxes of 32
inline int bf16_map(CUtensorMap* map, const void* base, int rank,
                    const uint64_t* dims, const uint64_t* strides,
                    const uint32_t* box) {
  return tile_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rank, dims,
                  strides, box);
}
inline int f32_map(CUtensorMap* map, const void* base, int rank,
                   const uint64_t* dims, const uint64_t* strides,
                   const uint32_t* box) {
  return tile_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, rank, dims,
                  strides, box);
}

}  // namespace sf_hopper
