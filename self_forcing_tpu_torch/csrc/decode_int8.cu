// decode_fresh_int8: decode self-attention of one block's queries onto a
// read-only KV cache window plus the block's own fresh (not yet cached)
// K/V, with both products in int8: int8 QK^T and int8 P.V.
//
// Replaces the TPU kernel _decode_fresh_int8_kernel in its 'tile',
// 'global' and online modes (self_forcing_tpu/ops/pallas_attention.py,
// decode_attention_fresh_pallas with quant='int8': fixed_m0 with
// int8_bound 'tile' or 'global', or no bound):
//   int8_quantize_v_launch <- the V half of its tile quantization
//                             (_quantize_cache_tile, _quantize_fresh_tile;
//                             q and K come from decode_int8qk.cu's
//                             int8qk_quantize, the same function)
//   int8_attend_launch     <- its 'tile' / 'global' / online _accumulate
//                             and _finalize
//
// Function.  Every scale is per Pallas tile (tq query rows, tk cache rows,
// tf fresh rows; ops/attention.py::decode_tiles): q8, qs, k8, ks as in
// decode_int8qk.cu, and V alike: vs = max(max|v| / 127, 1e-8) over all
// rows of the tile, v8 = rint(v / vs).  Per row and Pallas tile (the
// cache tiles that the window meets, then the fresh tiles), with
//   a = qs * (ks * scale),  s = float(q8 . k8) * a, masked columns excluded:
//   TILE:   m_t = the row's max in the tile, p = exp(s - (m_t - ln 127)),
//           w = exp(m_t - m0); l += sum(p) * w,
//           acc += float(round(p) . v8) * (vs * w)
//   GLOBAL: p = min(exp(s + ln 127 - m0), 127); l += sum(p),
//           acc += float(round(p) . v8) * vs
//   ONLINE: m = max(m, m_t) once a tile, l and acc scaled by
//           exp(m_prev - m), p = exp(s - (m - ln 127)), then as GLOBAL
//   out = acc / max(l, 1e-30) -> bf16.
// p lies in [0, 127] and round(p) is its int8; l sums the unrounded p,
// and the 127 cancels in acc / l.  m0 (TILE, GLOBAL) is the caller's bound
// on every score, read from device memory.  A tile with no visible column
// adds nothing.
//
// The row max without float work: within one Pallas tile and one row, a
// is a positive constant, float(s32) is exact (|s32| <= 127^2 * 128 <
// 2^24) and a product by a positive float is monotone, so m_t =
// float(max s32) * a bit for bit.  The max pass (TILE, ONLINE) is the int8
// Q.K^T and one integer max a score.
//
// Layouts: q8 [B*N, qt*tq, D], k8 [B*N, tiles*tile, D] (int8qk_quantize);
// V^T [B*N, tiles, D, tile padded to 64] int8, the keys of every 16-key
// group in the P fragment's order (below); scales [B*N, tiles] f32 (a
// cache tile that the window does not meet: scale 0, never read); out
// heads-packed [B, Lq, N*D] bf16.  D = 128.
//
// What bounds it on the H100: at the Wan-1.3B shapes (4680 queries, up to
// 32760 keys, 12 heads) each product is ~0.47 T int8 operations against
// ~0.1 GB of int8 K/V: bound by tensor-core operations (0.48 ms for the
// two products at 1979 TOP/s; 0.71 ms for the three this design runs
// where the row max is needed), and, as closely, by the exponentials: one
// a score on the 16-a-clock MUFU units, as long as a product.
//
// Design (hopper.cuh's warp-specialised shape): persistent CTAs walk the
// work items (b*n, 128 queries) in a b*n-major stride; two consumer
// warpgroups own 64 query rows each, one thread of the producer
// warpgroup issues the TMA loads: the item's int8 Q (one 128-byte box,
// double-buffered across items), then, for every Pallas tile, its K
// stages (the max pass) and its K and V^T stages (the p pass) into rings
// of 128-key stages.  Stages never cross a Pallas tile: each tile is
// walked in tile-relative stages from its first key, the last one
// partial, so ks, vs and the row max are constants of a stage; stages
// with no visible column and tiles the window does not meet are never
// loaded.  S = Q8.K8^T is 4 k-steps of wgmma.m64n128k32.s32.s8.s8 (both
// K-major, as the pre-pass writes them).  The s32 accumulator gives a
// thread keys {2t, 2t+1, 8+2t, 9+2t} of each 16-key group, which are
// the slots 4t..4t+3 of the register A fragment of the same instruction
// when V^T stores its keys in that order (slot k holds key 2(k/4) + k%2 +
// 8((k%4)/2); int8_quantize_v does), so p is rounded (a float add of
// 1.5 * 2^23: its low byte is rint(p)), packed with byte permutes and
// multiplied by V^T from shared memory (K-major; boxes past the padded
// tile length read zeros) into int32 sums that fold into the f32 output
// once a tile.  Each p-pass step issues the stage's Q.K^T and the
// previous stage's P.V together and waits once; the two consumers take
// turns at issuing (named barriers, "ping-pong").  A stage that straddles
// sink_end, kv_start, kv_end or the tile's end masks its columns (an
// integer minimum in the max pass, p = 0 in the p pass).  Registers: S
// and P.V (int32, 64 each) and P (16); the f32 output sums live in shared
// memory (each thread's own 64, folded once a Pallas tile), which leaves
// the unrolled softmax room for its temporaries.  The output is staged
// there as bf16 (stmatrix) and stored in 16-byte pieces.
//
// Measured (scripts/int8_attend_ab.py, PERF.md): the softmax bounds it,
// ~7 instructions and one MUFU.EX2 a score; with products at the int8
// rate a warpgroup's softmax outlasts the other's products, so the two
// softmaxes overlap each other more than the tensor cores.  Q in
// registers, 64-key S halves in a software pipeline, a magic-number int
// to float and a deeper K ring were each no faster.
//
// The V pre-pass (int8_quantize_v_kernel) moves a bf16 read and an int8
// write of every V element of the live tiles: bound by memory (~0.15 GB,
// 0.046 ms, at the global demo window).  A tile's scale needs its max
// before its first element is quantized, so, as int8qk_quantize does for
// K, a cluster of 8 CTAs takes one tile, each CTA a share of whole 16-key
// groups (a group's slots mix its keys) staged in shared memory once, and
// the partial maxima meet through distributed shared memory; each V
// element is read from device memory once.

#include <climits>
#include <cstring>
#include <initializer_list>
#include <type_traits>

#include "attention_common.cuh"
#include "hopper.cuh"

using namespace sf_attn;
using namespace sf_hopper;

namespace {

typedef int8_t i8;

constexpr int D = 128;                 // head dim
constexpr int BK = 128;                // keys a stage
constexpr int CONSUMERS = 2;           // consumer warpgroups a CTA
constexpr int BM = 64 * CONSUMERS;     // query rows an item
constexpr int THREADS = 128 * (CONSUMERS + 1);   // + the producer
constexpr int BOX = 128 * 128;         // bytes of an int8 Q, K or V^T box
constexpr int KST = 4;                 // K ring stages
constexpr int VST = 4;                 // V^T ring stages
constexpr int ACC = 64 * D * 4;        // bytes of a consumer's f32 output
                                       // sums (and, at an item's end, its
                                       // staged bf16 output)
constexpr int LDO = 2 * D + 16;        // bytes a staged output row
constexpr int N_BARS = 4 + 2 * KST + 2 * VST;
constexpr int PP = 3;                  // named barriers PP, PP + 1: the
                                       // consumers' turns (1, 2: staging)
constexpr size_t SMEM = 1024 + (2 + KST + VST) * BOX + CONSUMERS * ACC +
                        N_BARS * sizeof(uint64_t);
static_assert(64 * LDO <= ACC, "the staged output fits the sums' room");
constexpr int VPAD = 64;        // V^T tiles are padded to this many keys

// the V pre-pass: a cluster of VCL CTAs of VTHREADS a tile; a CTA's share
// of a tile is whole 16-key groups, at most V_SHARE rows in the shared
// memory a block may use (less the static arrays)
constexpr int VCL = 8;
constexpr int VTHREADS = 512;
constexpr int V_SHARE = (232448 - 1024) / (D * 2) / 16 * 16;
constexpr float FLOOR = 1e-8f;  // scale floor
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN127 = 4.844187086458591f;  // ln(127)
constexpr float ROUND = 12582912.f;   // 1.5 * 2^23: x + ROUND holds rint(x)
                                      // in its low bits for |x| < 2^22

enum Mode { TILE = 0, GLOBAL = 1, ONLINE = 2 };

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// slot k of a 16-key group of V^T holds key key_of_slot(k)
__device__ __forceinline__ int key_of_slot(int k) {
  return 2 * (k / 4) + (k % 2) + 8 * ((k % 4) / 2);
}

// ---------------------------------------------------------------------
// pre-pass: per-tile scales and K-major int8 V
// ---------------------------------------------------------------------

// V cut into tiles: matrix m = b * N + n starts at
// src + b * b_stride + n * n_stride (elements), rows of D bf16 at
// row_stride; `rows` real rows in `n_tiles` tiles of `tile` rows, each
// stored K-major padded to `tpad` keys.
struct VSeg {
  const bf16* src;
  long long b_stride, n_stride, row_stride;
  int rows, tile, n_tiles, tpad;
  i8* dst;       // [B*N, n_tiles, D, tpad]
  float* scale;  // [B*N, n_tiles]
};

// One cluster of VCL CTAs per (matrix, tile) of v_new, then of the live
// cache tiles [0, a1) and [b2, c2).  CTA `rank` takes the 16-key groups
// [rank * share, (rank + 1) * share) of the tile's tpad / 16 (share =
// ceil(groups / VCL)): it copies the rows of its groups that hold data
// into shared memory once (16-byte cp.async) and takes their max there;
// the VCL partial maxima meet through distributed shared memory; then
// each lane takes one group and 4 columns, quantizes the group's 16 keys
// and stores each column's 16 slots as one 16-byte word of V^T: the 16
// lanes of a half-warp take 16 neighbouring groups, so a column's words
// leave as 256 contiguous bytes.  Their 8-byte reads of 16 rows 16 keys
// apart would meet in one bank: a staged row's 16-byte chunk c sits at c
// ^ (group % 16).  Keys past the data (the tile's end, the padding to
// tpad) store zeros.  The cluster of each matrix's first tile writes scale 0 for the
// cache tiles the window does not meet, whose data is never written.
__global__ void __cluster_dims__(VCL, 1, 1) __launch_bounds__(VTHREADS, 3)
int8_quantize_v_kernel(VSeg svc, VSeg svn, int BN, int N, int a1, int b2,
                       int c2) {
  extern __shared__ uint4 vrows[];   // this CTA's rows of the tile, bf16
  __shared__ float red[VTHREADS / 32];
  __shared__ float part[VCL];        // each CTA's max |v| over its rows
  int idx = blockIdx.x / VCL;
  const int rank = (int)cluster_rank();
  const int n_live = a1 + max(c2 - b2, 0);   // live cache tiles a matrix
  VSeg sg = svn;
  int m, t;
  bool first;
  if (idx < BN * svn.n_tiles) {
    m = idx / svn.n_tiles, t = idx % svn.n_tiles;
    first = t == 0;
  } else {
    sg = svc;
    idx -= BN * svn.n_tiles;
    m = idx / n_live, t = idx % n_live;
    first = svn.n_tiles == 0 && t == 0;
    t = t < a1 ? t : b2 + (t - a1);
  }
  if (first && rank == 0)   // the dead cache tiles' scales
    for (int x = threadIdx.x; x < svc.n_tiles; x += VTHREADS)
      if (x >= a1 && !(x >= b2 && x < c2))
        svc.scale[(long long)m * svc.n_tiles + x] = 0.f;
  cluster_arrive_relaxed();
  const int r0 = t * sg.tile;
  const int groups = sg.tpad / 16, share = cdiv(groups, VCL);
  const int g0 = min(rank * share, groups);
  const int n_grp = min(share, groups - g0);   // groups this CTA writes
  // rows of those groups that hold data
  const int n_read = max(0, min(16 * n_grp, min(sg.tile, sg.rows - r0) -
                                                16 * g0));
  const bf16* src = sg.src + (long long)(m / N) * sg.b_stride +
                    (long long)(m % N) * sg.n_stride +
                    (long long)(r0 + 16 * g0) * sg.row_stride;

  // 1. each element read once, straight into shared memory, then its max
  constexpr int CH = D / 8;   // 16-byte chunks of a row
  const int n_ch = n_read * CH;
  for (int i = threadIdx.x; i < n_ch; i += VTHREADS) {
    const int r = i / CH, c = i % CH;
    cp_async16(&vrows[r * CH + (c ^ ((r / 16) % 16))],
               src + (long long)r * sg.row_stride + c * 8, 16);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __nv_bfloat162 m2 = __float2bfloat162_rn(0.f);
  for (int i = threadIdx.x; i < n_ch; i += VTHREADS) {
    const uint4 v = vrows[i];
    m2 = abs_max2(abs_max2(abs_max2(abs_max2(m2, v.x), v.y), v.z), v.w);
  }
  float amax = fmaxf(__low2float(m2), __high2float(m2));
  amax = block_max<VTHREADS>(amax, red);   // its barrier publishes vrows[]

  // 2. the tile's max: every CTA's into every partner's part[rank]
  cluster_wait();
  if (threadIdx.x < VCL)
    st_cluster_f32(map_rank(smem_u32(&part[rank]), threadIdx.x), amax);
  cluster_arrive();
  cluster_wait();
  float tmax = part[0];
#pragma unroll
  for (int j = 1; j < VCL; ++j) tmax = fmaxf(tmax, part[j]);
  const float s = fmaxf(__fdiv_rn(tmax, 127.f), FLOOR);   // as K's
  const float rc = __frcp_rn(s);
  if (rank == 0 && threadIdx.x == 0)
    sg.scale[(long long)m * sg.n_tiles + t] = s;

  // 3. V^T: word w of column d's 16 bytes holds slots 4 w .. 4 w + 3.
  // Task (16-group block, chunk c): lane l takes group 16 block + l % 16,
  // columns 8 c + 4 (l / 16) .. + 3.
  i8* dst = sg.dst + ((long long)m * sg.n_tiles + t) * D * sg.tpad +
            16 * g0;
  const uint2* rows2 = reinterpret_cast<const uint2*>(vrows);
  const int lane = threadIdx.x % 32;
  const int tasks = CH * ((n_grp + 15) / 16);
  for (int task = threadIdx.x / 32; task < tasks; task += VTHREADS / 32) {
    const int gi = 16 * (task / CH) + lane % 16, c = task % CH;
    if (gi >= n_grp) continue;
    const int l = 2 * c + lane / 16;   // columns 4 l .. 4 l + 3
    uint32_t col[4][4];   // [column 4 l + j][word]
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      uint32_t q[4][4];   // [slot 4 w + i][column 4 l + j]
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 16 * gi + key_of_slot(4 * w + i);
        const uint2 v =
            r < n_read ? rows2[r * (D / 4) + 2 * (c ^ (gi % 16)) + lane / 16]
                       : make_uint2(0u, 0u);
        q[i][0] = q8_bits(bf16_lo(v.x), s, rc);
        q[i][1] = q8_bits(bf16_hi(v.x), s, rc);
        q[i][2] = q8_bits(bf16_lo(v.y), s, rc);
        q[i][3] = q8_bits(bf16_hi(v.y), s, rc);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        col[j][w] = low_bytes(q[0][j], q[1][j], q[2][j], q[3][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint4*>(dst + (long long)(4 * l + j) * sg.tpad +
                                16 * gi) =
          make_uint4(col[j][0], col[j][1], col[j][2], col[j][3]);
  }
}

// ---------------------------------------------------------------------
// attention: int8 QK^T, int8 P.V on wgmma
// ---------------------------------------------------------------------

struct Maps {
  CUtensorMap q;    // q8 (D, qt * tq, B*N), box (128, BM, 1)
  CUtensorMap kc;   // kc8 (D, ntc * tk, B*N), box (128, BK, 1)
  CUtensorMap kn;   // kn8 (D, ntf * tf, B*N)
  CUtensorMap vc;   // cache V^T (tpc, D, B*N * ntc), box (BK, D, 1)
  CUtensorMap vn;   // fresh V^T (tpf, D, B*N * ntf)
};

// The scales ([B*N, tiles]; qs [B*N, qt]), the bound and the output.
struct Ops {
  const float* qs;
  const float* ksc;
  const float* ksf;
  const float* vsc;
  const float* vsf;
  const float* m0;
  bf16* out;
};

// The Pallas tiles: ntc cache tiles of tk rows (columns below cache_lim;
// visible: [0, sink_end) and [kv_start, kv_end)), then ntf fresh tiles of
// tf rows (below Lf; all visible).
struct Geo {
  int ntc, ntf, tk, tf, Lf, cache_lim, kv_start, kv_end, sink_end;
};

// Pallas tile tt (cache tiles first): its index among its kind, first
// key, valid length and number of 128-key stages.
struct Tile {
  bool fresh;
  int t, j0, len, n;
};

__device__ __forceinline__ Tile tile_at(const Geo& g, int tt) {
  Tile x;
  x.fresh = tt >= g.ntc;
  x.t = x.fresh ? tt - g.ntc : tt;
  const int T = x.fresh ? g.tf : g.tk;
  x.j0 = x.t * T;
  x.len = min(T, (x.fresh ? g.Lf : g.cache_lim) - x.j0);
  x.n = cdiv(x.len, BK);
  return x;
}

// The first stage >= u of tile x with a visible column; x.n when none.
__device__ __forceinline__ int next_stage(const Geo& g, const Tile& x,
                                          int u) {
  if (x.fresh) return u;
  while (u < x.n) {
    const int j0 = x.j0 + u * BK, j1 = x.j0 + min(x.len, u * BK + BK);
    if (j0 < g.sink_end || (j0 < g.kv_end && j1 > g.kv_start)) return u;
    if (j0 >= g.kv_end) return x.n;   // past the sink and the window
    u = max(u + 1, (g.kv_start - x.j0) / BK);   // over the dead gap
  }
  return x.n;
}

__device__ __forceinline__ bool straddles(int j0, int b) {
  return j0 < b && b < j0 + BK;
}

// Does stage u of tile x hold a column that is not visible?  (A stage
// that no bound cuts is visible throughout once it is live.)
__device__ __forceinline__ bool edge(const Geo& g, const Tile& x, int u) {
  if (u * BK + BK > x.len) return true;
  const int j0 = x.j0 + u * BK;
  return !x.fresh && (straddles(j0, g.sink_end) ||
                      straddles(j0, g.kv_start) || straddles(j0, g.kv_end));
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
int8_attend_kernel(const __grid_constant__ Maps maps, const Ops ops,
                   const Geo geo, int BN, int N, int Lq, int tq, int qt,
                   float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // [Q: 2 buffers | K: KST stages | V^T: VST stages | each consumer's
  //  output sums | barriers]
  unsigned char* sQ = base;
  unsigned char* sK = sQ + 2 * BOX;
  unsigned char* sV = sK + KST * BOX;
  unsigned char* sA = sV + VST * BOX;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sA + CONSUMERS * ACC);
  uint64_t* q_empty = q_full + 2;
  uint64_t* full_k = q_empty + 2;
  uint64_t* empty_k = full_k + KST;
  uint64_t* full_v = empty_k + KST;
  uint64_t* empty_v = full_v + VST;

  const int n_qt = cdiv(Lq, BM);
  const int n_work = n_qt * BN;
  const int n_tiles = geo.ntc + geo.ntf;
  const int wg = threadIdx.x / 128;   // consumer warpgroup, or CONSUMERS
  // this CTA's k-th item: a static stride over (b*n, query tile), b*n-major
  auto slot = [&](int k) -> int {
    return k * (int)gridDim.x + (int)blockIdx.x;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], CONSUMERS);
    }
    for (int s = 0; s < KST; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&empty_k[s], CONSUMERS);
    }
    for (int s = 0; s < VST; ++s) {
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_v[s], CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: one thread issues every TMA load in the consumers'
    // order; its warpgroup's registers go to the consumers ----
    regs_dealloc<24>();
    if (threadIdx.x != 128 * CONSUMERS) return;
    int ik = 0, iv = 0;   // K / V^T stages loaded so far
    for (int k = 0, w; (w = slot(k)) < n_work; ++k) {
      const int bn = w / n_qt;
      const int qb = k & 1;
      mbar_wait(&q_empty[qb], ((k >> 1) & 1) ^ 1);
      mbar_expect_tx(&q_full[qb], BOX);
      tma_load_3d(sQ + qb * BOX, &maps.q, &q_full[qb], 0, (w % n_qt) * BM,
                  bn);
      for (int tt = 0; tt < n_tiles; ++tt) {
        const Tile x = tile_at(geo, tt);
        const int u0 = next_stage(geo, x, 0);
        const CUtensorMap* km = x.fresh ? &maps.kn : &maps.kc;
        auto load_k = [&](int u) {
          const int st = ik % KST;
          mbar_wait(&empty_k[st], ((ik / KST) & 1) ^ 1);
          mbar_expect_tx(&full_k[st], BOX);
          tma_load_3d(sK + st * BOX, km, &full_k[st], 0, x.j0 + u * BK, bn);
          ++ik;
        };
        if (MODE != GLOBAL)   // the max pass: K alone
          for (int u = u0; u < x.n; u = next_stage(geo, x, u + 1)) load_k(u);
        const CUtensorMap* vm = x.fresh ? &maps.vn : &maps.vc;
        const int vt = bn * (x.fresh ? geo.ntf : geo.ntc) + x.t;
        for (int u = u0; u < x.n; u = next_stage(geo, x, u + 1)) {
          load_k(u);
          const int sv = iv % VST;
          mbar_wait(&empty_v[sv], ((iv / VST) & 1) ^ 1);
          mbar_expect_tx(&full_v[sv], BOX);
          tma_load_3d(sV + sv * BOX, vm, &full_v[sv], u * BK, 0, vt);
          ++iv;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup c owns query rows q0 + 64 c .. + 63 ----
  regs_alloc<240>();
  const int c = wg;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const bool leader = threadIdx.x % 128 == 0;
  const float m0v = MODE == ONLINE ? 0.f : __ldg(ops.m0);
  // descriptors of k-step 0: this warpgroup's Q rows in buffer 0, K and
  // V^T of stage 0 (a row of 128 int8 is one 128-byte swizzle row)
  const uint64_t dq0 = desc_sw128(sQ + c * 64 * 128, 16, 1024);
  const uint64_t dk = desc_sw128(sK, 16, 1024);
  const uint64_t dv = desc_sw128(sV, 16, 1024);
  // this thread's f32 output sums in shared memory (a Pallas tile's
  // int32 P.V folds into them once; in registers they would leave the
  // softmax no room): element 4 q + j (accumulator layout) at acc4[128 q].j
  unsigned char* so = sA + c * ACC;
  float4* acc4 = reinterpret_cast<float4*>(so) + threadIdx.x % 128;

  // the turn at the tensor cores ("ping-pong"): warpgroup c waits on
  // named barrier PP + c, which the other one arrives at once it has
  // issued its products; both issue the same batches, 1 lets 0 go first
  // and 0 takes 1's last hand-over at the end
  auto take_turn = [&]() { named_sync(PP + c, 256); };
  auto pass_turn = [&]() { named_arrive(PP + 1 - c, 256); };
  if (c == 1) pass_turn();

  int s[BK / 2];       // int32 scores of rows g, g + 8 (accumulator layout)
  int pv[D / 2];       // the Pallas tile's int32 P.V
  uint32_t pa[BK / 32][4];   // int8 p, the register A of P.V k-step kk
  int ik = 0, iv = 0;  // K / V^T stages consumed so far

  for (int k = 0, w; (w = slot(k)) < n_work; ++k) {
    const int qti = w % n_qt, bn = w / n_qt;
    const int r0 = qti * BM + c * 64 + warp * 16 + g;
    float qsr[2];   // qs of rows g, g + 8 (their Pallas q tile)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;   // rows past Lq are not written
      qsr[h] = r < Lq ? __ldg(ops.qs + (long long)bn * qt + r / tq) : 0.f;
    }
    bool none = true;   // no tile folded into the sums yet: they are 0
    float l[2] = {0.f, 0.f};              // partial row sums
    float m[2] = {-INFINITY, -INFINITY};  // ONLINE: running row max
    const uint64_t dq = dq0 + (((k & 1) * BOX) >> 4);
    mbar_wait(&q_full[k & 1], (k >> 1) & 1);

    // S = Q8.K8^T of K stage st
    auto qk = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk)
        WgmmaS8<BK>::run(s, dq + ((kk * 32) >> 4),
                         dk + ((st * BOX + kk * 32) >> 4), kk > 0);
    };
    // the tile's P.V += P . V^T of V^T stage sv (first: overwrite)
    auto pvm = [&](int sv, bool first) {
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmma_m64n128k32_s8_rs(pv, pa[kk], dv + ((sv * BOX + kk * 32) >> 4),
                               !first || kk > 0);
    };

    for (int tt = 0; tt < n_tiles; ++tt) {
      const Tile x = tile_at(geo, tt);
      const int u0 = next_stage(geo, x, 0);
      if (u0 >= x.n) continue;   // no visible column: adds nothing
      const long long ti = (long long)bn * (x.fresh ? geo.ntf : geo.ntc) +
                           x.t;
      const float ks = __ldg((x.fresh ? ops.ksf : ops.ksc) + ti);
      const float vs = __ldg((x.fresh ? ops.vsf : ops.vsc) + ti);
      const float kss = ks * scale;
      const float a[2] = {qsr[0] * kss, qsr[1] * kss};
      // column e of stage u is visible
      auto visible = [&](int u, int e) {
        const int cc = u * BK + 8 * (e >> 2) + 2 * t4 + (e & 1);
        const int j = x.j0 + cc;
        return cc < x.len &&
               (x.fresh || j < geo.sink_end ||
                (j >= geo.kv_start && j < geo.kv_end));
      };
      // p = 2^(s log2(e) - sub): the tile's offset, per row
      float sub[2];
      float corr[2] = {1.f, 1.f};   // ONLINE: rescale of l and acc
      float wt[2] = {1.f, 1.f};     // TILE: the tile's weight exp(m_t - m0)
      if constexpr (MODE == GLOBAL) {
        sub[0] = sub[1] = (m0v - LN127) * LOG2E;
      } else {
        // the max pass: the integer row max over the visible scores
        int mx[2] = {INT_MIN, INT_MIN};
        for (int u = u0; u < x.n; u = next_stage(geo, x, u + 1)) {
          const int st = ik % KST;
          mbar_wait(&full_k[st], (ik / KST) & 1);
          take_turn();
          wgmma_fence();
          qk(st);
          wgmma_commit();
          pass_turn();
          wgmma_wait<0>();
          fence_regs(s);
          if (leader) mbar_arrive(&empty_k[st]);
          ++ik;
          auto rowmax = [&](auto masked) {
#pragma unroll
            for (int e = 0; e < BK / 2; ++e) {
              const int h = (e >> 1) & 1;
              if constexpr (decltype(masked)::value)
                mx[h] = max(mx[h], visible(u, e) ? s[e] : INT_MIN);
              else
                mx[h] = max(mx[h], s[e]);
            }
          };
          if (edge(geo, x, u))
            rowmax(std::true_type{});
          else
            rowmax(std::false_type{});
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = max(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = max(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float mt = __int2float_rn(mx[h]) * a[h];   // exact
          if constexpr (MODE == TILE) {
            wt[h] = fast_exp2((mt - m0v) * LOG2E);
            sub[h] = (mt - LN127) * LOG2E;
          } else {
            const float mn = fmaxf(m[h], mt);
            corr[h] = fast_exp2((m[h] - mn) * LOG2E);
            m[h] = mn;
            sub[h] = (mn - LN127) * LOG2E;
          }
        }
      }

      // the p pass: p from S of stage u (s as the plain version computes
      // it), its row sums, and its int8 packed as P.V's register A
      float ls[2] = {0.f, 0.f};
      auto softmax = [&](int u) {
        auto body = [&](auto masked) {
#pragma unroll
          for (int kk = 0; kk < BK / 32; ++kk) {
            const int o = 16 * kk;
#pragma unroll
            for (int e = o; e < o + 16; ++e) {
              const int h = (e >> 1) & 1;
              const float sc = __int2float_rn(s[e]) * a[h];
              float p = fast_exp2(fmaf(sc, LOG2E, -sub[h]));
              if constexpr (MODE == GLOBAL) p = fminf(p, 127.f);
              if constexpr (decltype(masked)::value)
                p = visible(u, e) ? p : 0.f;
              ls[h] += p;
              s[e] = __float_as_int(__fadd_rn(p, ROUND));
            }
            // keys 2t, 2t+1, 8+2t, 9+2t of each 16-key group of the
            // k-step: its A slots 4t..4t+3 (rows g, g + 8)
            pa[kk][0] = low_bytes(s[o], s[o + 1], s[o + 4], s[o + 5]);
            pa[kk][1] = low_bytes(s[o + 2], s[o + 3], s[o + 6], s[o + 7]);
            pa[kk][2] = low_bytes(s[o + 8], s[o + 9], s[o + 12], s[o + 13]);
            pa[kk][3] = low_bytes(s[o + 10], s[o + 11], s[o + 14], s[o + 15]);
          }
        };
        if (edge(geo, x, u))
          body(std::true_type{});
        else
          body(std::false_type{});
      };
      {   // the tile's first stage: S alone
        const int st = ik % KST;
        mbar_wait(&full_k[st], (ik / KST) & 1);
        take_turn();
        wgmma_fence();
        qk(st);
        wgmma_commit();
        pass_turn();
        wgmma_wait<0>();
        fence_regs(s);
        if (leader) mbar_arrive(&empty_k[st]);
        ++ik;
        softmax(u0);
      }
      // each later stage: its S with the previous stage's P.V, one wait
      bool first = true;
      for (int u = next_stage(geo, x, u0 + 1); u < x.n;
           u = next_stage(geo, x, u + 1)) {
        const int st = ik % KST, sv = iv % VST;
        mbar_wait(&full_k[st], (ik / KST) & 1);
        mbar_wait(&full_v[sv], (iv / VST) & 1);
        take_turn();
        wgmma_fence();
        qk(st);
        pvm(sv, first);
        wgmma_commit();
        pass_turn();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(pv);
        if (leader) {
          mbar_arrive(&empty_k[st]);
          mbar_arrive(&empty_v[sv]);
        }
        ++ik;
        ++iv;
        first = false;
        softmax(u);
      }
      {   // the last stage's P.V
        const int sv = iv % VST;
        mbar_wait(&full_v[sv], (iv / VST) & 1);
        take_turn();
        wgmma_fence();
        pvm(sv, first);
        wgmma_commit();
        pass_turn();
        wgmma_wait<0>();
        fence_regs(pv);
        if (leader) mbar_arrive(&empty_v[sv]);
        ++iv;
      }
      // fold the tile's int32 P.V into the f32 sums, once
      const float f[2] = {vs * wt[0], vs * wt[1]};
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + ls[h] * wt[h];
#pragma unroll
      for (int q = 0; q < D / 8; ++q) {
        float4 v = none ? make_float4(0.f, 0.f, 0.f, 0.f) : acc4[128 * q];
        v.x = fmaf(v.x, corr[0], __int2float_rn(pv[4 * q]) * f[0]);
        v.y = fmaf(v.y, corr[0], __int2float_rn(pv[4 * q + 1]) * f[0]);
        v.z = fmaf(v.z, corr[1], __int2float_rn(pv[4 * q + 2]) * f[1]);
        v.w = fmaf(v.w, corr[1], __int2float_rn(pv[4 * q + 3]) * f[1]);
        acc4[128 * q] = v;
      }
      none = false;
    }
    if (leader) mbar_arrive(&q_empty[k & 1]);   // every Q.K^T has read Q

    // out = acc / max(l, 1e-30): staged as bf16 (stmatrix from the
    // accumulator layout) in the sums' room, then stored in 16-byte pieces
    float acc[D / 2];
#pragma unroll
    for (int q = 0; q < D / 8; ++q) {
      const float4 v = none ? make_float4(0.f, 0.f, 0.f, 0.f) : acc4[128 * q];
      acc[4 * q] = v.x;
      acc[4 * q + 1] = v.y;
      acc[4 * q + 2] = v.z;
      acc[4 * q + 3] = v.w;
    }
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x = l[h];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      inv[h] = 1.f / fmaxf(x, 1e-30f);
    }
    named_sync(1 + c, 128);   // every thread holds its sums
    {
      const int j = lane / 8;   // this lane's matrix, and its row in it
      unsigned char* row = so + (warp * 16 + lane % 8 + 8 * (j & 1)) * LDO +
                           16 * (j >> 1);
#pragma unroll
      for (int e = 0; e < D / 8; e += 2)
        stmatrix_x4(row + 16 * e,
                    pack_bf16(acc[4 * e] * inv[0], acc[4 * e + 1] * inv[0]),
                    pack_bf16(acc[4 * e + 2] * inv[1],
                              acc[4 * e + 3] * inv[1]),
                    pack_bf16(acc[4 * e + 4] * inv[0],
                              acc[4 * e + 5] * inv[0]),
                    pack_bf16(acc[4 * e + 6] * inv[1],
                              acc[4 * e + 7] * inv[1]));
    }
    named_sync(1 + c, 128);
    const int b = bn / N, n = bn % N;
    const long long ld = (long long)N * D;
    for (int i = threadIdx.x % 128; i < 64 * (2 * D / 16); i += 128) {
      const int rr = i / (2 * D / 16), ch = i % (2 * D / 16);
      const int r = qti * BM + c * 64 + rr;
      if (r < Lq)
        *reinterpret_cast<uint4*>(ops.out + ((long long)b * Lq + r) * ld +
                                  n * D + ch * 8) =
            *reinterpret_cast<const uint4*>(so + rr * LDO + ch * 16);
    }
    named_sync(1 + c, 128);   // the staged tile is stored: sums again
  }
  if (c == 0) take_turn();
}

template <int MODE>
int run(const Maps& maps, const Ops& ops, const Geo& geo, int B, int N,
        int Lq, int tq, float scale, cudaStream_t stream) {
  auto kernel = int8_attend_kernel<MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  static int sms = 0;   // the persistent grid: one CTA an SM
  if (sms == 0) {
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = min(cdiv(Lq, BM) * B * N, sms);
  kernel<<<grid, THREADS, SMEM, stream>>>(maps, ops, geo, B * N, N, Lq, tq,
                                          cdiv(Lq, tq), scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Quantize the V tiles of layer `v_cache` ([B*N, S, D]) that meet the
// window [0, sink_end) + [kv_start, kv_end) below cache_lim, and v_new
// ([B, Lf, N*D]), each over its Pallas tile (tk, tf rows, padded to 64
// keys; at most VCL * V_SHARE = 7168 padded keys), into K-major int8 V^T.
// Launch on `stream`; returns the CUDA error code (0 on success;
// cudaErrorInvalidValue for a larger tile).
extern "C" int int8_quantize_v_launch(const void* v_cache, const void* v_new,
                                      void* vc8, void* vsc, void* vn8,
                                      void* vsf, int B, int N, int Lf, int S,
                                      int kv_start, int kv_end, int sink_end,
                                      int cache_lim, int tk, int tf,
                                      void* stream) {
  const long long tok = (long long)N * D;
  const VSeg svc{(const bf16*)v_cache, (long long)N * S * D, (long long)S * D,
                 D, S, tk, cdiv(cache_lim, tk), cdiv(tk, VPAD) * VPAD,
                 (i8*)vc8, (float*)vsc};
  const VSeg svn{(const bf16*)v_new, (long long)Lf * tok, D, tok, Lf, tf,
                 cdiv(Lf, tf), cdiv(tf, VPAD) * VPAD, (i8*)vn8, (float*)vsf};
  if (B * N <= 0 || svc.n_tiles + svn.n_tiles <= 0) return 0;
  int share = 0;   // the largest share of a tile's rows, in shared memory
  for (const VSeg* sg : {&svc, &svn})
    if (sg->n_tiles > 0) share = max(share, 16 * cdiv(sg->tpad / 16, VCL));
  if (share > V_SHARE) return (int)cudaErrorInvalidValue;
  int a1, b2, c2;   // the live cache tiles: [0, a1) and [b2, c2)
  live_ranges(svc.n_tiles, tk, kv_start, kv_end, sink_end, &a1, &b2, &c2);
  const int live = a1 + (c2 - b2) + svn.n_tiles;
  auto st = (cudaStream_t)stream;
  if (live == 0)   // no cluster to write the dead tiles' scales
    return (int)cudaMemsetAsync(vsc, 0, sizeof(float) * B * N * svc.n_tiles,
                                st);
  const int smem = share * D * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      int8_quantize_v_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  int8_quantize_v_kernel<<<VCL * B * N * live, VTHREADS, smem, st>>>(
      svc, svn, B * N, N, a1, b2, c2);
  return (int)cudaGetLastError();
}

// The attention of the pre-passes' int8 q, K (int8qk_quantize) and V^T
// (int8_quantize_v) in `mode` (one of Mode); m0 points at one float (TILE,
// GLOBAL; may be null for ONLINE).  Launch on `stream`; returns the CUDA
// error code (0 on success; cudaErrorInvalidValue for an unknown mode).
extern "C" int int8_attend_launch(const void* q8, const void* qs,
                                  const void* kc8, const void* ksc,
                                  const void* kn8, const void* ksf,
                                  const void* vc8, const void* vsc,
                                  const void* vn8, const void* vsf,
                                  const void* m0, void* out, int B, int N,
                                  int Lq, int Lf, int kv_start, int kv_end,
                                  int sink_end, int cache_lim, int tq,
                                  int tk, int tf, int mode, float scale,
                                  void* stream) {
  if (mode != TILE && mode != GLOBAL && mode != ONLINE)
    return (int)cudaErrorInvalidValue;
  if (mode != ONLINE && m0 == nullptr) return (int)cudaErrorInvalidValue;
  if (tq < 1 || tk < 1 || tf < 1) return (int)cudaErrorInvalidValue;
  if (Lq <= 0 || B * N <= 0) return 0;
  const Geo geo{cdiv(cache_lim, tk), cdiv(Lf, tf), tk, tf, Lf, cache_lim,
                kv_start, kv_end, sink_end};
  const int qt = cdiv(Lq, tq);
  const uint64_t BN = (uint64_t)B * N;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  // int8 rows of 128 bytes, folded [B*N, rows, D]: boxes of one 128-byte
  // swizzle row by BM or BK rows
  auto rows_map = [&](CUtensorMap* m, const void* p, int rows, int box_rows) {
    const uint64_t dims[3] = {D, (uint64_t)rows, BN};
    const uint64_t strides[2] = {D, (uint64_t)D * rows};
    const uint32_t box[3] = {D, (uint32_t)box_rows, 1};
    return u8_map(m, p, 3, dims, strides, box);
  };
  // V^T tiles [B*N * tiles, D, tp]: boxes of BK keys (one 128-byte swizzle
  // row; past tp zeros) by the D rows
  auto vt_map = [&](CUtensorMap* m, const void* p, int tile, int tiles) {
    const uint64_t tp = (uint64_t)cdiv(tile, VPAD) * VPAD;
    const uint64_t dims[3] = {tp, D, BN * tiles};
    const uint64_t strides[2] = {tp, tp * D};
    const uint32_t box[3] = {BK, D, 1};
    return u8_map(m, p, 3, dims, strides, box);
  };
  if (int e = rows_map(&maps.q, q8, qt * tq, BM)) return e;
  if (geo.ntc > 0) {
    if (int e = rows_map(&maps.kc, kc8, geo.ntc * tk, BK)) return e;
    if (int e = vt_map(&maps.vc, vc8, tk, geo.ntc)) return e;
  }
  if (geo.ntf > 0) {
    if (int e = rows_map(&maps.kn, kn8, geo.ntf * tf, BK)) return e;
    if (int e = vt_map(&maps.vn, vn8, tf, geo.ntf)) return e;
  }
  const Ops ops{(const float*)qs, (const float*)ksc, (const float*)ksf,
                (const float*)vsc, (const float*)vsf, (const float*)m0,
                (bf16*)out};
  auto st = (cudaStream_t)stream;
  switch (mode) {
    case TILE: return run<TILE>(maps, ops, geo, B, N, Lq, tq, scale, st);
    case GLOBAL: return run<GLOBAL>(maps, ops, geo, B, N, Lq, tq, scale, st);
    default: return run<ONLINE>(maps, ops, geo, B, N, Lq, tq, scale, st);
  }
}
