// decode_fresh: decode self-attention of one block's queries onto a
// read-only KV cache window plus the block's own fresh (not yet cached)
// K/V, in one of five modes; the same kernel serves the cache window
// alone (decode_window), the cross attention onto a small static K/V
// (cross_attention), the int8-QK attention (int8qk_attend) and the
// training path's masked flash attention forward (flash_fwd).
//
// Replaces the TPU kernel _decode_fresh_kernel in its bf16 modes
// (self_forcing_tpu/ops/pallas_attention.py, called through
// decode_attention_fresh_pallas): 'free' and 'free_noclamp'
// (softmax='free' / 'free_noclamp'), 'bounded' (fixed_m0) and online
// (neither).  decode_window_launch replaces _decode_kernel (through
// decode_attention_pallas): the online mode with no fresh keys and the
// window bounds read on the device (bf16), and a float32 kernel of its
// own (decode_window_f32_launch: 3xTF32 products on tf32 wgmma; see
// decode_window_f32_kernel).
// cross_attention_launch replaces _cross_kernel (cross_attention_pallas):
// the online mode with no cache and the text / CLIP K/V as the fresh keys.
// int8qk_attend_launch replaces the attention of _decode_fresh_int8_kernel
// in 'free_qk' mode (softmax='free', quant='int8qk'; its _accumulate and
// _finalize): mode INT8QK, on the int8 q and K of the pre-pass
// (decode_int8qk.cu's int8qk_quantize_launch).  flash_fwd_launch replaces
// _flash_kernel (flash_attention_pallas -> _flash_fwd -> pallas_call) in
// its free, bounded and online modes: keys FLASH (below).
//
// Function, per (batch b, head n, query row i):
//   visible cache columns j: j < cache_lim and
//       (j < sink_end or kv_start <= j < kv_end)
//   every fresh column is visible
//   s = q_i . k_j (fp32)
//   FREE:         p = exp2(min(scale * s, 80))   (the caller folded
//                 head_dim**-0.5 * log2(e) into q; no running max:
//                 qk-normed scores stay far inside exp2's range)
//   FREE_NOCLAMP: p = exp2(scale * s)
//   BOUNDED:      p = exp(scale * s - m0), m0 >= every score (the
//                 caller's Cauchy-Schwarz bound, read from device memory)
//   ONLINE:       p = exp(scale * s - m), m the running row max over the
//                 128-key tiles seen so far; l and acc are rescaled by
//                 exp(m_prev - m) when it grows
//   l = sum p (fp32),  acc = sum bf16(p) * v_j (fp32)
//   INT8QK:       s = float(q8_i . k8_j) * (qs_i * ks_j) [* scale], then
//                 FREE's p = exp2(min(s, 80)); q8 / k8 the pre-pass's int8
//                 rows, qs the scale of row i's Pallas q tile, ks that of
//                 column j's Pallas k tile (tq / tk / tf rows)
//   out_i = acc / max(l, 1e-30)  -> bf16 (as acc * (1 / max(l, 1e-30)):
//                 one division a row, within an f32 ulp before bf16)
// The exponentials run base 2 (ex2.approx): scale * log2(e) multiplies
// the scores of BOUNDED and ONLINE.  ONLINE rounds p to bf16 for P.V, as
// the other modes do (the Pallas kernel in interpret mode keeps it f32);
// the cross attention (HILO) instead multiplies p as two bf16 parts,
// p = hi + lo to ~16 mantissa bits, each with the bf16 V into the same
// f32 accumulators, which keeps the TPU kernel's f32 P.V to ~2^-17.  Its
// row max is the running one, which moves the result only by f32
// rounding against the TPU kernel's exact max.
//
// Layouts: q, k_new, v_new and out are heads-packed [B, L, N*D] (the
// cross K/V [B, Lk, N, D] is that layout); the cache is one layer
// [B*N, S, D] of the stacked [layers, B*N, S, D] buffer (the wrapper
// passes the layer's base pointer).  D = 128.
//
// What bounds it on the H100: at the 1.3B shapes (Lq = Lf = 4680, up to
// 32760 visible keys, 12 heads) a call does up to ~0.9 TFLOP against
// ~0.2 GB of K/V, so it is bound by tensor-core operations, and the
// 1.8e9 exponentials of a call take about half the tensor-core time on
// the MUFU units unless they run under the products.  Design (the
// warp-specialised shape of hopper.cuh): one CTA of two consumer
// warpgroups (64 query rows each, BM = 128) and a producer warpgroup,
// one thread of which issues the TMA loads: each work item's Q (two
// 64-column boxes, double-buffered across items), then every live key
// tile (128 keys; K and V each two boxes, 32 KB) into a 2-stage ring with
// separate full / empty mbarriers for K and V, so a K stage is handed
// back as soon as Q.K^T has read it.  The tensor maps clip every tile to
// its own head: the cache is mapped (D, S, B*N) and the heads-packed
// operands (D, N, L, B), so rows past S, Lf or Lq read zeros, never the
// next head's, layer's or batch's rows.  A consumer computes S = Q.K^T
// with 8 wgmma.m64n128k16 (Q and K from shared memory), scales and masks
// it in registers, takes exp2 and packs p to bf16 in the register A
// layout, and issues O += P.V as 8 register-A wgmma.m64n128k16 with V
// read MN-major.  Each iteration issues this tile's Q.K^T and the
// previous tile's P.V together, so the softmax of tile t runs while the
// tensor cores work on P.V of t - 1, and the two consumers take turns at
// issuing (named barriers 1 and 2, "ping-pong"), so one warpgroup's
// exponentials run under the other's products.  That keeps o, s and p
// live at once: 64 + 64 + 32 registers (HILO + 32), which fit because
// the producer warpgroup lowers its registers to 24 and the consumers
// raise theirs to 240 (setmaxnreg; the 384-thread CTA is launched with
// 168 a thread).  Only a tile that straddles sink_end, kv_start, kv_end,
// cache_lim (cache tiles) or Lf (the last fresh tile) applies the -inf
// mask; tiles wholly outside the visible window are never loaded
// (next_live).  The grid is persistent: one CTA an SM walks the work
// items (b*n, 128-query tile) in a static b*n-major stride as one stream
// of key tiles, Q double-buffered, an item's first Q.K^T issued with the
// previous item's last P.V and that item's output written while the new
// softmax runs (every item has the same keys, so the 3.36 waves of the
// 1.3B shapes, 444 items on 132 SMs, stay).  Three consumers (BM = 192)
// do not fit: beside a 24-register producer they get at most 160
// registers a thread, what o, s and p alone take.  The tensor maps are
// encoded on the host at every launch (a few microseconds).
//
// INT8QK: the same CTA on int8 operands for S.  Q and K arrive as int8
// boxes (one 128-byte swizzle row a query or key: 16 KB a 128-key K
// stage, so the ring has 3 stages), S = Q8.K8^T runs as 4 k-steps of
// wgmma.m64n128k32.s32.s8.s8 (both K-major, the pre-pass's layout), and
// the int32 scores are dequantized in registers (I2FP, an ALU
// instruction on sm_90: the integer-add / float-subtract pair of the
// mma.sync kernel measured 2.7% slower) times qs * ks.  The scales are
// per Pallas tile, and Pallas tiles do not line up with the 64-row
// consumer tiles or the 128-key stages (a stage can meet several k tiles
// of any size), so each accumulator row carries its own qs (read when the
// item's Q is taken) and each column its own ks: a second warp of the
// producer warpgroup writes the stage's 128 per-key scales into shared
// memory beside K and arrives on the stage's full barrier with them; a
// consumer reads its 32 into registers while its Q.K^T runs and hands the
// K stage back after the softmax.  P.V is FREE's.  Cache tiles the window
// does not meet were not written by the pre-pass (scale 0, any int8
// values): a stage that straddles one reads finite scores there and masks
// them.  What bounds it: QK^T at the int8 rate plus P.V at the bf16 rate,
// 0.75 of FREE's tensor time; but the softmax, ~6 instructions a score to
// FREE's ~4, is the longer half of each step, so the consumers do not
// take turns at the tensor cores (ping-pong measured 4.7% slower here:
// with little tensor work to hide behind, it only delays a warpgroup's
// issue).
//
// FLASH (flash_fwd_launch): q, k, v, out [B, L, N, D] (the heads-packed
// layout), one K/V of Lk keys read through the fresh-key maps (no cache),
// and a per-row mask: row i sees key j iff j < Lk and (s1[i] <= j < e1[i]
// or s2[i] <= j < e2[i]) (an IntervalMask; the four int32 arrays
// [4, lq_pad]).  The modes are FREE (the caller folded head_dim**-0.5 *
// log2(e) into q; scale 1), BOUNDED and ONLINE, and the kernel also writes
// the base-e lse [B*N, lq_pad] fp32 that flash_bwd reads: ln l (FREE),
// m0 + ln l (BOUNDED), m ln 2 + ln l (ONLINE), 0 for a row that saw
// nothing (its out is 0).  At the training shape (B 1, L 32760, 12 heads,
// no mask) a call does 4 L^2 D N = 6.6 TFLOP against 0.3 GB: bound by
// tensor-core operations, 6.67 ms at the bf16 peak.  The wrapper's tile
// table (128 queries x 128 keys: dead, partial, fully visible) reaches
// the kernel as one list a query tile: its live key tiles in order, each
// 2 t + (partial), so dead tiles are never loaded and nothing scans for
// the next live one; a query tile that sees no key gets tile 0 as
// partial, whose mask hides every key.  Only a partial tile applies the
// mask, per element, with the four bounds of the thread's two rows
// (read once an item).  The items (b*n, query tile) differ in cost under
// a mask (a block-causal query tile sees 1 to 7 blocks), so the wrapper
// orders the query tiles by live-tile count, most first; the items walk
// each run of query tiles with equal counts head by head (b*n-major, so
// the items in flight at once read few heads' K/V and find it in L2: a
// head-innermost order measured 5-6% slower with no mask), and CTA x
// takes items x, 2G - 1 - x, 2G + x, ... of a grid of G (a snake over the
// sorted list: each round's heaviest items go to the CTAs that got the
// lightest ones in the round before).

#include <cstring>
#include <type_traits>

#include "attention_common.cuh"
#include "hopper.cuh"

using namespace sf_attn;
using namespace sf_hopper;

namespace {

constexpr int D = 128;                    // head dim
constexpr int BK = 128;                   // keys a tile
constexpr int STAGES = 2;                 // K / V ring depth
constexpr int CONSUMERS = 2;              // consumer warpgroups a CTA
constexpr int BM = 64 * CONSUMERS;        // query rows a CTA
constexpr int THREADS = 128 * (CONSUMERS + 1);   // + the producer
constexpr int BOX = BK * 128;             // bytes of a 64-column K/V box
constexpr int KV_TILE = 2 * BOX;          // bytes of a K or V tile
constexpr int Q_BOX = BM * 128;
constexpr int Q_TILE = 2 * Q_BOX;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

enum Mode { FREE = 0, FREE_NOCLAMP = 1, BOUNDED = 2, ONLINE = 3, INT8QK = 4 };

// Where the keys come from: the cache window and the block's fresh keys
// (decode_fresh, cross_attention, int8qk_attend); the cache window alone,
// its bounds read from device memory (decode_window); or one K/V under a
// per-row interval mask (flash_fwd).
enum Keys { CACHE = 0, WINDOW = 1, FLASH = 2 };

// The shared-memory plan of a mode: the bf16 modes hold Q and K as two
// 64-column boxes a tile; INT8QK as one 128-byte int8 box (half the bytes),
// which buys a third stage, plus the stages' per-key scales.
template <int MODE>
struct Plan {
  static constexpr bool I8 = MODE == INT8QK;
  static constexpr int ST = I8 ? 3 : STAGES;      // K / V ring depth
  static constexpr int QT = I8 ? BM * 128 : Q_TILE;   // bytes a Q buffer
  static constexpr int KT = I8 ? BK * 128 : KV_TILE;  // bytes a K stage
  static constexpr int KS = I8 ? ST * BK : 0;         // per-key scales
  static constexpr int N_BARS = 4 + 4 * ST;
  static constexpr size_t SMEM = 1024 + 2 * QT + ST * (KT + KV_TILE) +
                                 KS * sizeof(float) +
                                 N_BARS * sizeof(uint64_t);
};

// INT8QK's scales: qs [B*N, qt] per Pallas q tile of tq rows, ksc
// [B*N, ntc] per cache tile of tk rows, ksf [B*N, ntf] per fresh tile of
// tf rows (the pre-pass's)
struct Scales {
  const float* qs;
  const float* ksc;
  const float* ksf;
  int tq, tk, tf, qt, ntc, ntf;
};

// FLASH: the mask and its tile lists (the wrapper's flash_geometry), and
// where the lse goes
struct Flash {
  const int* iv;      // [4, lq_pad]: s1, e1, s2, e2 of every query row
  const int* tiles;   // [n_qt, n_kt]: each query tile's live key tiles in
                      // order, 2 t + (1 if the tile is partial)
  const int* count;   // [n_qt]: how many (at least 1)
  const int* order;   // [n_qt]: the query tiles, most live tiles first
  const int* run;     // [2, n_qt]: for each position of `order`, the
                      // first position and the length of its run of
                      // query tiles with equal counts
  float* lse;         // [B*N, lq_pad]
  int lq_pad, n_kt;
};

__device__ __forceinline__ float as_f(float x) { return x; }
__device__ __forceinline__ float as_f(int x) { return __int_as_float(x); }

struct Maps {
  CUtensorMap q;    // (D, N, Lq, B), box (64, 1, BM, 1); INT8QK: the
                    // int8 q8 (D, qt * tq, B*N), box (128, BM, 1)
  CUtensorMap kc;   // (D, S, B*N), box (64, BK, 1): the layer's cache;
                    // INT8QK: kc8 (D, ntc * tk, B*N), box (128, BK, 1)
  CUtensorMap vc;
  CUtensorMap kn;   // (D, N, Lf, B), box (64, 1, BK, 1); INT8QK: kn8
                    // (D, ntf * tf, B*N), box (128, BK, 1)
  CUtensorMap vn;
};

__device__ __forceinline__ bool straddles(int j0, int x) {
  return j0 < x && x < j0 + BK;
}

// KEYS (Keys): CACHE, WINDOW (kv_start / kv_end read from device memory,
// `bounds`, clamped to [0, S]; no sink, no fresh tiles) or FLASH (no
// cache; k_new / v_new are the K/V, Lf = Lk; `fl` the mask).  HILO: P.V
// from the bf16 hi and lo parts of p (the cross attention).
template <int MODE, int KEYS, bool HILO>
__global__ void __launch_bounds__(THREADS, 1)
decode_fresh_kernel(const __grid_constant__ Maps maps,
                    const float* __restrict__ m0, bf16* __restrict__ out,
                    int B, int N, int Lq, int Lf, int S, int kv_start,
                    int kv_end, int sink_end, int cache_lim, float scale,
                    const int* __restrict__ bounds, const Scales sc,
                    const Flash fl) {
  static_assert(!HILO || MODE == ONLINE, "HILO is the online softmax");
  static_assert(KEYS != FLASH || MODE == FREE || MODE == BOUNDED ||
                    MODE == ONLINE, "flash modes: free, bounded, online");
  constexpr bool FL = KEYS == FLASH;
  using P = Plan<MODE>;
  constexpr bool I8 = P::I8;
  constexpr int ST = P::ST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // [Q: 2 buffers | K: ST stages | V: ST stages | INT8QK: the stages'
  //  per-key scales | barriers]
  unsigned char* sQ = base;
  unsigned char* sK = sQ + 2 * P::QT;
  unsigned char* sV = sK + ST * P::KT;
  float* sKS = reinterpret_cast<float*>(sV + ST * KV_TILE);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sKS + P::KS);
  uint64_t* q_empty = q_full + 2;
  uint64_t* full_k = q_empty + 2;
  uint64_t* full_v = full_k + ST;
  uint64_t* empty_k = full_v + ST;
  uint64_t* empty_v = empty_k + ST;

  if (KEYS == WINDOW) {
    kv_start = max(__ldg(bounds), 0);
    kv_end = min(__ldg(bounds + 1), S);
    sink_end = 0;
    cache_lim = S;
    Lf = 0;
  }
  // work items (b*n, query tile); the k-th item of this CTA is item
  // slot(k): a static b*n-major stride where every item walks the same key
  // tiles, FLASH's snake over its sorted items otherwise
  const int BN = B * N;
  const int n_qt = (Lq + BM - 1) / BM;
  const int n_work = n_qt * BN;
  const int wg = threadIdx.x / 128;   // consumer warpgroup, or CONSUMERS
  const int n_cache = (cache_lim + BK - 1) / BK;
  const int n_total = n_cache + (Lf + BK - 1) / BK;
  const int first = next_live<BK>(0, n_cache, n_total, kv_start, kv_end,
                                  sink_end);
  auto slot = [&](int k) -> int {
    const int x = FL && (k & 1) ? (int)gridDim.x - 1 - (int)blockIdx.x
                                : (int)blockIdx.x;
    return k * (int)gridDim.x + x;
  };
  // item w's (query tile, b*n); FLASH: the items of a run of len query
  // tiles from position s of `order` are w = BN s .. BN (s + len) - 1,
  // b*n-major
  auto item = [&](int w) -> int2 {
    if constexpr (FL) {
      const int p = w / BN;
      const int s = __ldg(fl.run + p), len = __ldg(fl.run + n_qt + p);
      const int o = w - BN * s;
      return make_int2(__ldg(fl.order + s + o % len), o / len);
    }
    return make_int2(w % n_qt, w / n_qt);
  };
  // an item's key tiles: the cursor runs from start() while < its end; the
  // tile at cursor t is code(t): its index (FLASH: 2 index + partial)
  const int* lst = nullptr;   // FLASH: the item's tile list
  int t_end = n_total;        // FLASH: its length
  auto begin = [&](int w) {
    if constexpr (FL) {
      const int qt = item(w).x;
      lst = fl.tiles + (long long)qt * fl.n_kt;
      t_end = __ldg(fl.count + qt);
    }
  };
  auto start = [&]() -> int { return FL ? 0 : first; };
  auto nxt = [&](int t) -> int {
    return FL ? t + 1
              : next_live<BK>(t + 1, n_cache, n_total, kv_start, kv_end,
                              sink_end);
  };
  auto code = [&](int t) -> int { return FL ? __ldg(lst + t) : t; };
  auto end = [&]() -> int { return FL ? t_end : n_total; };
  // this CTA's k-th item is its last
  auto last = [&](int k) -> bool { return slot(k + 1) >= n_work; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], CONSUMERS);
    }
    for (int s = 0; s < ST; ++s) {
      // INT8QK: the K stage also waits for the scale warp's 32 lanes, and
      // every consumer warp hands it back (after reading the scales)
      mbar_init(&full_k[s], I8 ? 1 + 32 : 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], I8 ? 4 * CONSUMERS : CONSUMERS);
      mbar_init(&empty_v[s], CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: one thread of the last warpgroup issues every TMA
    // load (INT8QK: a second warp writes the per-key scales); its
    // registers go to the consumers ----
    regs_dealloc<24>();
    const int pw = (threadIdx.x / 32) % 4;
    if (I8 && pw == 1) {
      // the scale warp: lane l writes the scales of keys 4 l .. 4 l + 3
      // of every stage, in the producer's order
      const int lane = threadIdx.x % 32;
      int i = 0;
      for (int k = 0, w; (w = slot(k)) < n_work; ++k) {
        const int bn = item(w).y;
        for (int t = first; t < n_total;
             t = next_live<BK>(t + 1, n_cache, n_total, kv_start, kv_end,
                               sink_end), ++i) {
          const int st = i % ST;
          const bool cache = t < n_cache;
          const int j0 = (cache ? t : t - n_cache) * BK + 4 * lane;
          const int T = cache ? sc.tk : sc.tf;
          const int nt = cache ? sc.ntc : sc.ntf;
          const float* ks = (cache ? sc.ksc : sc.ksf) + (long long)bn * nt;
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kt = (j0 + e) / T;   // past the last tile: masked
            v[e] = kt < nt ? __ldg(ks + kt) : 0.f;
          }
          mbar_wait(&empty_k[st], ((i / ST) & 1) ^ 1);
          *reinterpret_cast<float4*>(sKS + st * BK + 4 * lane) =
              make_float4(v[0], v[1], v[2], v[3]);
          mbar_arrive(&full_k[st]);
        }
      }
      return;
    }
    if (threadIdx.x != 128 * CONSUMERS) return;
    int i = 0;   // key tiles loaded so far: the ring position
    for (int k = 0, w; (w = slot(k)) < n_work; ++k) {
      const int2 it = item(w);
      const int bn = it.y, b = bn / N, n = bn % N;
      const int q0 = it.x * BM;
      begin(w);
      // Q double-buffered: item k's loads while item k - 1 runs
      const int qb = k & 1;
      unsigned char* dq = sQ + qb * P::QT;
      mbar_wait(&q_empty[qb], ((k >> 1) & 1) ^ 1);
      mbar_expect_tx(&q_full[qb], P::QT);
      if (I8) {
        tma_load_3d(dq, &maps.q, &q_full[qb], 0, q0, bn);
      } else {
        tma_load_4d(dq, &maps.q, &q_full[qb], 0, n, q0, b);
        tma_load_4d(dq + Q_BOX, &maps.q, &q_full[qb], 64, n, q0, b);
      }
      for (int t = start(); t < end(); t = nxt(t), ++i) {
        const int tile = FL ? code(t) >> 1 : t;
        const int st = i % ST;
        const uint32_t ph = (i / ST) & 1;
        const bool cache = tile < n_cache;
        const int j0 = (cache ? tile : tile - n_cache) * BK;
        for (int kv = 0; kv < 2; ++kv) {
          uint64_t* full = kv ? &full_v[st] : &full_k[st];
          mbar_wait(kv ? &empty_v[st] : &empty_k[st], ph ^ 1);
          if (I8 && !kv) {   // int8 K: one box, folded [B*N, rows, D]
            mbar_expect_tx(full, P::KT);
            tma_load_3d(sK + st * P::KT, cache ? &maps.kc : &maps.kn, full,
                        0, j0, bn);
            continue;
          }
          unsigned char* dst = (kv ? sV + st * KV_TILE : sK + st * P::KT);
          mbar_expect_tx(full, KV_TILE);
          if (cache) {
            const CUtensorMap* m = kv ? &maps.vc : &maps.kc;
            tma_load_3d(dst, m, full, 0, j0, bn);
            tma_load_3d(dst + BOX, m, full, 64, j0, bn);
          } else {
            const CUtensorMap* m = kv ? &maps.vn : &maps.kn;
            tma_load_4d(dst, m, full, 0, n, j0, b);
            tma_load_4d(dst + BOX, m, full, 64, n, j0, b);
          }
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
  const int tq = lane % 4;
  const bool leader = threadIdx.x % 128 == 0;
  // (FLASH's free mode takes q pre-scaled: its multiplier is the
  // constant 1, which the compiler folds out of every score)
  const float mul = (MODE == BOUNDED || MODE == ONLINE) ? scale * LOG2E
                    : FL                                 ? 1.f
                                                         : scale;
  const float m0v = MODE == BOUNDED ? __ldg(m0) : 0.f;
  const float off = m0v * LOG2E;
  // descriptors of k-step 0: Q rows of this warpgroup in buffer 0, K and
  // V of stage 0 (an int8 Q / K row is 128 bytes, as a bf16 box row)
  const uint64_t dq0 = desc_sw128(sQ + c * 64 * 128, 16, 1024);
  const uint64_t dk = desc_sw128(sK, 16, 1024);
  const uint64_t dv = desc_sw128(sV, BOX, 1024);

  float o[64];
  // scores, then p, of the current tile (INT8QK: the int32 scores, then
  // the bits of the float p in the same registers)
  typename std::conditional<I8, int, float>::type s[BK / 2];
  uint32_t pa[BK / 16][4];        // bf16(p) (HILO: its hi part)
  uint32_t pl[HILO ? BK / 16 : 1][4];   // HILO: bf16(p - hi)
  float l[2] = {0.f, 0.f};   // partial row sums of rows g, g + 8
  float m[2];      // ONLINE: running max (base 2)
  float corr[2] = {1.f, 1.f};   // ONLINE: rescale of l and O to the new max
  float qsr[2] = {0.f, 0.f};    // INT8QK: qs * scale of rows g, g + 8
  float2 ksr[I8 ? BK / 8 : 1];  // INT8QK: ks of columns 8 i + 2 tq, + 1
  int ivr[FL ? 2 : 1][4] = {};  // FLASH: s1, e1, s2, e2 of rows g, g + 8

  uint64_t dq = dq0;   // this item's Q buffer
  // S = Q.K^T of the tile in stage `st`
  auto qk = [&](int st) {
    if constexpr (I8) {
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk)
        WgmmaS8<BK>::run(s, dq + ((kk * 32) >> 4),
                         dk + ((st * P::KT + kk * 32) >> 4), kk > 0);
    } else {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n128k16_ss(
            s, dq + (((kk / 4) * Q_BOX + (kk % 4) * 32) >> 4),
            dk + ((st * P::KT + (kk / 4) * BOX + (kk % 4) * 32) >> 4),
            kk > 0);
    }
  };
  // O += P.V of the tile in stage `st`
  auto pv = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t d = dv + ((st * KV_TILE + kk * 16 * 128) >> 4);
      wgmma_m64n128k16_rs<1>(o, pa[kk], d);
      if constexpr (HILO) wgmma_m64n128k16_rs<1>(o, pl[kk], d);
    }
  };
  // the scores of tile `tc` (code(t); stage st) in base-2 units (-inf
  // where not visible), then p in place, the row sums, and (ONLINE) the
  // new running max and corr
  auto softmax = [&](int tc, int st) {
    const bool cache = !FL && tc < n_cache;
    const int j0 = FL ? (tc >> 1) * BK : (cache ? tc : tc - n_cache) * BK;
    const bool edge =
        FL ? (tc & 1) != 0
           : cache ? (straddles(j0, sink_end) || straddles(j0, kv_start) ||
                      straddles(j0, kv_end) || straddles(j0, cache_lim))
                   : Lf - j0 < BK;
    auto visible = [&](int e) {
      const int j = j0 + 8 * (e / 4) + 2 * tq + (e & 1);
      if constexpr (FL) {
        const int h = (e >> 1) & 1;   // row g or g + 8
        return !edge ||
               (j < Lf && ((j >= ivr[h][0] && j < ivr[h][1]) ||
                           (j >= ivr[h][2] && j < ivr[h][3])));
      }
      return !edge || (cache ? j < cache_lim &&
                                   (j < sink_end ||
                                    (j >= kv_start && j < kv_end))
                             : j < Lf);
    };
    if constexpr (I8) {
      // s = float(acc) * (qs * ks), p = 2^min(s, 80); interior tiles
      // skip the mask
      float ls[2] = {0.f, 0.f};
      auto dequant = [&](auto masked) {
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) {
          const float2 kp = ksr[i];
#pragma unroll
          for (int u = 0; u < 4; ++u) {   // columns 8 i + 2 tq + (u & 1)
            const int e = 4 * i + u;
            float x = __int2float_rn(s[e]) *
                      (qsr[u >> 1] * ((u & 1) ? kp.y : kp.x));
            if constexpr (decltype(masked)::value)
              x = visible(e) ? x : -INFINITY;
            const float p = fast_exp2(fminf(x, 80.f));
            ls[u >> 1] += p;
            s[e] = __float_as_int(p);
          }
        }
      };
      if (edge)
        dequant(std::true_type{});
      else
        dequant(std::false_type{});
      l[0] += ls[0];
      l[1] += ls[1];
    } else {
      // the multiplier still to apply: interior tiles fold it into the
      // exponent's FMA (and, as mul > 0, into the row max)
      float k = mul;
      if (edge || !(mul > 0.f)) {
#pragma unroll
        for (int e = 0; e < BK / 2; ++e)
          s[e] = visible(e) ? s[e] * mul : -INFINITY;
        k = 1.f;
      }
      float sub[2] = {off, off};   // what p's exponent subtracts, per row
      if (MODE == ONLINE) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = -INFINITY;
#pragma unroll
          for (int e = 0; e < BK / 8; ++e)
            mx = fmaxf(mx, fmaxf(s[4 * e + 2 * h], s[4 * e + 2 * h + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[h], mx * k);
          sub[h] = m_new == -INFINITY ? 0.f : m_new;
          corr[h] = fast_exp2(m[h] - sub[h]);
          m[h] = m_new;
        }
      }
      float ls[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        // exp2(-inf) = 0 on the columns that are not visible
        const float x = s[e];
        s[e] = MODE == FREE ? fast_exp2(fminf(x * k, 80.f))
                            : fast_exp2(fmaf(x, k, -sub[(e >> 1) & 1]));
        ls[(e >> 1) & 1] += s[e];
      }
      l[0] = l[0] * corr[0] + ls[0];
      l[1] = l[1] * corr[1] + ls[1];
    }
  };
  // p as the register A operand of the next P.V (accumulator columns
  // 16 kk .. 16 kk + 15 are k-step kk)
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = as_f(s[8 * kk + 2 * r]);
        const float bb = as_f(s[8 * kk + 2 * r + 1]);
        pa[kk][r] = pack_bf16(a, bb);
        if constexpr (HILO)
          pl[kk][r] = pack_bf16(a - bf16_lo(pa[kk][r]),
                                bb - bf16_hi(pa[kk][r]));
      }
    }
  };
  // the turn at the tensor cores (ping-pong; not in INT8QK): warpgroup c
  // waits on named barrier 1 + c, which the other one arrives at once it
  // has issued its products; warpgroup 1 lets 0 go first and skips its
  // last hand-over, so both barriers see as many arrivals as waits
  auto take_turn = [&]() {
    if constexpr (!I8) named_sync(1 + c, 256);
  };
  auto pass_turn = [&](bool last) {
    if constexpr (!I8)
      if (!(c == 1 && last)) named_arrive(2 - c, 256);
  };
  // after item k's last Q.K^T: its Q buffer may take item k + 2's
  auto release_q = [&](int k) {
    if (leader) mbar_arrive(&q_empty[k & 1]);
  };
  // wait for item k (item w) of this CTA's Q and point the Q descriptor
  // at its buffer; INT8QK: read its rows' q scales; FLASH: its rows'
  // intervals
  auto take_q = [&](int k, int w) {
    dq = dq0 + (((k & 1) * P::QT) >> 4);
    const int2 it = item(w);
    const int r0 = it.x * BM + c * 64 + warp * 16 + g;
    if constexpr (I8) {
      const int bn = it.y;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;   // rows past Lq are not written
        qsr[h] = r < Lq ? __ldg(sc.qs + (long long)bn * sc.qt + r / sc.tq) *
                              scale
                        : 0.f;
      }
    }
    if constexpr (FL) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int a = 0; a < 4; ++a)   // rows past Lq: zeros, see nothing
          ivr[h][a] = __ldg(fl.iv + a * fl.lq_pad + r0 + 8 * h);
    }
    mbar_wait(&q_full[k & 1], (k >> 1) & 1);
  };
  // INT8QK: this thread's per-key scales of stage st into registers,
  // issued before the wait for Q.K^T so that their latency hides there
  auto load_ks = [&](int st) {
    if constexpr (I8) {
      const float* ks = sKS + st * BK + 2 * tq;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
        ksr[i] = *reinterpret_cast<const float2*>(ks + 8 * i);
    }
  };
  // K stage st back to the producer: at once after Q.K^T has read it, or
  // (INT8QK) after every warp's softmax has read its per-key scales
  auto release_k = [&](int st) {
    if constexpr (I8) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty_k[st]);
    } else {
      if (leader) mbar_arrive(&empty_k[st]);
    }
  };
  // out = O * (1 / l) of item w, from the partial row sums `ls` (rows g
  // and g + 8 of this warp's 16; rows past Lq are not written); FLASH also
  // the rows' lse from their running max `ms` (ONLINE)
  auto store = [&](int w, const float (&ls)[2], const float (&ms)[2]) {
    const int2 it = item(w);
    const int bn = it.y, b = bn / N, n = bn % N;
    const int r0 = it.x * BM + c * 64 + warp * 16 + g;
    float sum[2], inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x = ls[h];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      sum[h] = x;
      inv[h] = 1.f / fmaxf(x, 1e-30f);
    }
    if constexpr (FL) {
      if (tq == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // the offset the p's were taken against, base e
          const float a = MODE == ONLINE ? ms[h] * LN2 : m0v;
          if (r0 + 8 * h < Lq)
            fl.lse[(long long)bn * fl.lq_pad + r0 + 8 * h] =
                sum[h] > 0.f ? a + logf(sum[h]) : 0.f;
        }
      }
    }
    const long long ld_tok = (long long)N * D;
    bf16* ob = out + ((long long)b * Lq + r0) * ld_tok + n * D + 2 * tq;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      if (r0 < Lq)
        *reinterpret_cast<uint32_t*>(ob + 8 * e) =
            pack_bf16(o[4 * e] * inv[0], o[4 * e + 1] * inv[0]);
      if (r0 + 8 < Lq)
        *reinterpret_cast<uint32_t*>(ob + 8 * ld_tok + 8 * e) =
            pack_bf16(o[4 * e + 2] * inv[1], o[4 * e + 3] * inv[1]);
    }
  };

#pragma unroll
  for (int e = 0; e < 64; ++e) o[e] = 0.f;
  if (first >= n_total) {   // no visible key: every output row is 0
    const float zero[2] = {0.f, 0.f};
    for (int k = 0, w; (w = slot(k)) < n_work; ++k) {
      take_q(k, w);
      release_q(k);
      store(w, zero, zero);
    }
    return;
  }
  int k = 0, w = slot(0);
  if (w >= n_work) return;

  // One stream of key tiles over this CTA's items: (item w, its tile t).
  // Each step issues the tile's Q.K^T and the previous tile's P.V
  // together; the softmax runs while P.V does.  An item's first tile goes
  // with the previous item's last P.V, whose output is written once that
  // P.V is done, so no item starts or ends with the tensor cores idle.
  // The stream's first tile and last P.V stand outside `step`: a wgmma
  // under a branch makes ptxas serialise every wgmma of the kernel.
  begin(w);
  int t = start();
  int tn = nxt(t);
  // last(k) of the current item, kept in a register by the bf16 modes; the
  // int8 mode works it out each time (measured: the register costs the
  // int8 mode 1.5% and saves the bf16 modes 1%)
  bool last_item = last(k);
  auto is_last = [&]() -> bool { return I8 ? last(k) : last_item; };
  l[0] = l[1] = 0.f;
  m[0] = m[1] = -INFINITY;
  if (!I8 && c == 1) named_arrive(1, 256);
  take_q(k, w);
  const int tc0 = code(t);
  const bool fin0 = tn >= end() && is_last();
  mbar_wait(&full_k[0], 0);
  take_turn();
  wgmma_fence();
  qk(0);
  wgmma_commit();
  pass_turn(fin0);
  load_ks(0);
  wgmma_wait<0>();
  fence_regs(s);
  if (!I8) release_k(0);
  if (tn >= end()) release_q(k);
  softmax(tc0, 0);
  if (I8) release_k(0);
  pack();
  int i = 1;   // key tiles consumed so far: the ring position
  // issue tile t's Q.K^T (stage i) and the previous tile's P.V, and take
  // the softmax of t while P.V runs; returns with P.V done
  auto step = [&](bool fresh_item) {
    const int st = i % ST;
    const int sp = (i - 1) % ST;
    const int tc = code(t);
    // the stream's last tile?  Settled before the turn, so that handing
    // the tensor cores over waits for nothing
    const bool fin = tn >= end() && is_last();
    mbar_wait(&full_k[st], (i / ST) & 1);
    mbar_wait(&full_v[sp], ((i - 1) / ST) & 1);
    take_turn();
    wgmma_fence();
    qk(st);
    wgmma_commit();
    pv(sp);
    wgmma_commit();
    pass_turn(fin);
    load_ks(st);
    wgmma_wait<1>();
    fence_regs(s);
    if (!I8) release_k(st);
    if (tn >= end()) release_q(k);
    const float l_prev[2] = {l[0], l[1]};
    const float m_prev[2] = {m[0], m[1]};
    if (fresh_item) {   // the new item's softmax starts afresh
      l[0] = l[1] = 0.f;
      m[0] = m[1] = -INFINITY;
    }
    softmax(tc, st);
    if (I8) release_k(st);
    wgmma_wait<0>();
    fence_regs(o);
    if (leader) mbar_arrive(&empty_v[sp]);
    if (fresh_item) {   // the previous item is done: write it, restart O
      store(slot(k - 1), l_prev, m_prev);
#pragma unroll
      for (int e = 0; e < 64; ++e) o[e] = 0.f;
    } else if (MODE == ONLINE &&
               !__all_sync(0xffffffffu, corr[0] == 1.f && corr[1] == 1.f)) {
      // rescale O to the new max unless no row of the warp raised it
#pragma unroll
      for (int e = 0; e < 64; ++e) o[e] *= corr[(e >> 1) & 1];
    }
    pack();
    ++i;
  };
  while (true) {
    for (t = tn; t < end(); t = tn) {   // the item's later tiles
      tn = nxt(t);
      step(false);
    }
    if (is_last()) break;
    w = slot(++k);   // the next item's first tile
    last_item = last(k);
    begin(w);
    t = start();
    tn = nxt(t);
    take_q(k, w);
    step(true);
  }
  // P.V of the last tile, and the last item's output
  const int sp = (i - 1) % ST;
  mbar_wait(&full_v[sp], ((i - 1) / ST) & 1);
  wgmma_fence();
  pv(sp);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  store(w, l, m);
}

// Launch on `stream` with the tensor maps encoded; the persistent grid.
template <int MODE, int KEYS, bool HILO>
int run(const Maps& maps, const void* m0, void* out, int B, int N, int Lq,
        int Lf, int S, int kv_start, int kv_end, int sink_end, int cache_lim,
        float scale, const int* bounds, const Scales& sc, const Flash& fl,
        cudaStream_t stream) {
  auto kernel = decode_fresh_kernel<MODE, KEYS, HILO>;
  const int smem = (int)Plan<MODE>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  static int sms = 0;   // the persistent grid: one CTA an SM
  if (sms == 0) {
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = min((Lq + BM - 1) / BM * B * N, sms);
  kernel<<<grid, THREADS, smem, stream>>>(
      maps, (const float*)m0, (bf16*)out, B, N, Lq, Lf, S, kv_start, kv_end,
      sink_end, cache_lim, scale, bounds, sc, fl);
  return (int)cudaGetLastError();
}

// The bf16 V maps: the layer's cache (D, S, B*N) and the heads-packed
// fresh V (D, N, Lf, B), boxes of 64 columns and BK keys
int v_maps(Maps& maps, const void* v_cache, const void* v_new, int B, int N,
           int Lf, int S) {
  const uint64_t row = D * sizeof(bf16);   // bytes of one head's row
  if (v_cache != nullptr && S > 0) {
    const uint64_t dims[3] = {D, (uint64_t)S, (uint64_t)B * N};
    const uint64_t strides[2] = {row, row * S};
    const uint32_t box[3] = {64, BK, 1};
    if (int e = bf16_map(&maps.vc, v_cache, 3, dims, strides, box)) return e;
  }
  if (Lf > 0) {
    const uint64_t dims[4] = {D, (uint64_t)N, (uint64_t)Lf, (uint64_t)B};
    const uint64_t strides[3] = {row, row * N, row * N * Lf};
    const uint32_t box[4] = {64, 1, BK, 1};
    if (int e = bf16_map(&maps.vn, v_new, 4, dims, strides, box)) return e;
  }
  return 0;
}

// Encode the bf16 tensor maps and launch on `stream`; k_cache / v_cache
// may be null (no cache: cache_lim = 0) and Lf may be 0 (no fresh keys).
template <int MODE, int KEYS, bool HILO>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* k_new, const void* v_new, const void* m0, void* out,
           int B, int N, int Lq, int Lf, int S, int kv_start, int kv_end,
           int sink_end, int cache_lim, float scale, const int* bounds,
           cudaStream_t stream, const Flash& fl = Flash{}) {
  if (Lq <= 0 || B * N <= 0) return 0;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  const uint64_t row = D * sizeof(bf16);   // bytes of one head's row
  {
    const uint64_t dims[4] = {D, (uint64_t)N, (uint64_t)Lq, (uint64_t)B};
    const uint64_t strides[3] = {row, row * N, row * N * Lq};
    const uint32_t box[4] = {64, 1, BM, 1};
    if (int e = bf16_map(&maps.q, q, 4, dims, strides, box)) return e;
  }
  if (k_cache != nullptr && S > 0) {
    const uint64_t dims[3] = {D, (uint64_t)S, (uint64_t)B * N};
    const uint64_t strides[2] = {row, row * S};
    const uint32_t box[3] = {64, BK, 1};
    if (int e = bf16_map(&maps.kc, k_cache, 3, dims, strides, box)) return e;
  }
  if (Lf > 0) {
    const uint64_t dims[4] = {D, (uint64_t)N, (uint64_t)Lf, (uint64_t)B};
    const uint64_t strides[3] = {row, row * N, row * N * Lf};
    const uint32_t box[4] = {64, 1, BK, 1};
    if (int e = bf16_map(&maps.kn, k_new, 4, dims, strides, box)) return e;
  }
  if (int e = v_maps(maps, v_cache, v_new, B, N, Lf, S)) return e;
  const Scales none{};
  return run<MODE, KEYS, HILO>(maps, m0, out, B, N, Lq, Lf, S, kv_start,
                               kv_end, sink_end, cache_lim, scale, bounds,
                               none, fl, stream);
}

// ---------------------------------------------------------------------
// decode_window_f32: the cache-window attention in float32 (the TPU
// kernel's f32 mode), every product in 3xTF32 on tf32 wgmma: each f32
// operand x is split into big = tf32(x) and small = tf32(x - big) (both
// rounded to nearest, split_tf32) and a . b is summed as small_a big_b +
// big_a small_b + big_a big_b (the dropped small * small term and the
// split's residual are ~2^-22 of |a||b|: float32 accuracy at 3x the TF32
// work).  The online softmax runs base 2 on scores times scale * log2(e).
//
// What bounds it on the H100: 4 Lq D keys N products (0.81 TFLOP at 4680
// queries onto 28080 keys, 12 heads) at 495 / 3 TFLOP/s, 4.9 ms; a tf32
// wgmma m64nNk8 reads 2 KB of A and 32 N bytes of B from shared memory
// for 1024 N flops, so at the SM's ~128 B and ~2048 TF32 flops a clock
// shared memory is as scarce as the tensor cores, and the design keeps
// operands out of it:
//  - a pre-pass (window_split_f32) splits the window's K into big and
//    small parts [B*N, S, D] and writes V^T's parts [B*N, D, S_pad], each
//    group of 8 keys stored in the order 0, 2, 4, 6, 1, 3, 5, 7: tf32
//    wgmma reads B K-major only, and in that order a thread's P
//    accumulators (columns 2 t, 2 t + 1 of each 8) are the register A
//    fragment of P.V as they stand (k-columns t, t + 4);
//  - Q's big part lives in registers (the A operand of two of the three
//    Q.K^T products), its small part in shared memory (the consumers
//    split the TMA'd Q tile in place once an item), and P.V takes P from
//    registers: per 32-key stage a consumer warpgroup reads 80 KB for
//    Q.K^T and 48 KB for P.V against 1536 clocks of products.
// CTA: two consumer warpgroups (64 query rows each, BM = 128) and a
// producer thread; stages of 32 keys, K and V^T each in two parts (32 KB
// a stage: Q's small part, 3 K stages and 2 V stages fill 224 KB), with
// separate K / V rings, so a K stage goes back once Q.K^T has read it.
// Each step issues stage t's Q.K^T (48 wgmma m64n32k8) and stage t - 1's
// P.V (12 wgmma m64n128k8) together and runs t's softmax under P.V (the
// two warpgroups taking turns at issuing, as decode_fresh_kernel does,
// measured no faster: PERF.md).  Accumulation: the tensor cores' f32
// accumulation truncates, with an error that grows with the chain (one
// chain over the 28080 keys of phase 2 read 1.97e-4 off), so an O chain
// sums FLUSH stages (384 wgmma; 7.9e-6) and is then folded into the
// output rows in device memory with one rounded FMA each, out = out *
// 2^(m_fold - m) + O (the first fold writes O); the last fold divides by
// l.  An S tile is its own chain of 48 wgmma.  The grid is persistent:
// one CTA an SM walks the (query tile, b*n) items.
// ---------------------------------------------------------------------

namespace wf {

constexpr int BM = 128;                  // query rows a CTA
constexpr int BK = 32;                   // keys a stage
constexpr int KST = 3, VST = 2;          // K and V ring depths
constexpr int FLUSH = 32;                // stages an O chain sums
constexpr int Q_BOX = BM * 128;          // 32 columns of the Q tile (16 KB)
constexpr int Q_BYTES = 4 * Q_BOX;
constexpr int K_BOX = BK * 128;          // 32 columns of a stage's keys
constexpr int PART = 4 * K_BOX;          // a K or V^T part of a stage (16 KB)
constexpr int STAGE = 2 * PART;          // big part, then small part
constexpr int N_BARS = 2 + 2 * KST + 2 * VST;
constexpr size_t SMEM = 1024 + Q_BYTES + (KST + VST) * STAGE + N_BARS * 8;
static_assert(D * 128 == PART, "a V^T part: 32 keys of D rows");
static_assert(SMEM <= 232448, "shared memory");

struct Maps {
  CUtensorMap q;    // f32 (D, N, Lq, B), box (32, 1, BM, 1)
  CUtensorMap kb;   // f32 (D, S, B*N), box (32, BK, 1): K's big part
  CUtensorMap ks;   //   and its small part
  CUtensorMap vb;   // f32 (S_pad, D, B*N), box (BK, D, 1): V^T's big part
  CUtensorMap vs;   //   and its small part
};

// The pre-pass: one CTA a (32-key stage, b*n) that the window [lo, hi)
// meets; keys outside it as zeros (so the masked columns of an edge
// stage multiply finite values).  Bound by its bytes (each window
// element read once, written twice as K parts and twice as V^T parts).
__global__ void __launch_bounds__(256)
window_split_f32(const float* __restrict__ k, const float* __restrict__ v,
                 float* __restrict__ kb, float* __restrict__ ks,
                 float* __restrict__ vb, float* __restrict__ vs, int S,
                 int S_pad, const int* __restrict__ bounds) {
  __shared__ __align__(16) float tile[BK][D + 4];
  const int lo = max(__ldg(bounds), 0), hi = min(__ldg(bounds + 1), S);
  const int j0 = blockIdx.x * BK;
  if (lo >= hi || j0 >= hi || j0 + BK <= lo) return;
  const long long bn = blockIdx.y;
  for (int u = threadIdx.x; u < BK * D / 4; u += 256) {
    const int r = u / (D / 4), c = 4 * (u % (D / 4)), j = j0 + r;
    const bool in = j >= lo && j < hi;
    const long long off = (bn * S + j) * D + c;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 big, small;
    split_tf32(in ? __ldg(reinterpret_cast<const float4*>(k + off)) : zero,
               big, small);
    if (j < S) {
      *reinterpret_cast<float4*>(kb + off) = big;
      *reinterpret_cast<float4*>(ks + off) = small;
    }
    *reinterpret_cast<float4*>(&tile[r][c]) =
        in ? __ldg(reinterpret_cast<const float4*>(v + off)) : zero;
  }
  __syncthreads();
  // V^T row d, positions 4 q .. 4 q + 3 of the stage: keys key0 + 0, 2,
  // 4, 6 of group q / 2 (key0 = 8 (q / 2) + q % 2)
  for (int u = threadIdx.x; u < D * BK / 4; u += 256) {
    const int d = u / (BK / 4), q = u % (BK / 4);
    const int key0 = 8 * (q / 2) + q % 2;
    float4 big, small;
    split_tf32(make_float4(tile[key0][d], tile[key0 + 2][d],
                           tile[key0 + 4][d], tile[key0 + 6][d]),
               big, small);
    const long long off = (bn * D + d) * S_pad + j0 + 4 * q;
    *reinterpret_cast<float4*>(vb + off) = big;
    *reinterpret_cast<float4*>(vs + off) = small;
  }
}

}  // namespace wf

__global__ void __launch_bounds__(THREADS, 1)
decode_window_f32_kernel(const __grid_constant__ wf::Maps maps,
                         float* __restrict__ out, int B, int N, int Lq, int S,
                         float scale, const int* __restrict__ bounds) {
  constexpr int BM = wf::BM, BK = wf::BK, KST = wf::KST, VST = wf::VST;
  constexpr int Q_BOX = wf::Q_BOX, Q_BYTES = wf::Q_BYTES, K_BOX = wf::K_BOX;
  constexpr int PART = wf::PART, STAGE = wf::STAGE, FLUSH = wf::FLUSH;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // [Q: its small part, in place | K: KST stages | V^T: VST stages |
  //  barriers]
  unsigned char* sQ = base;
  unsigned char* sK = sQ + Q_BYTES;
  unsigned char* sV = sK + KST * STAGE;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + VST * STAGE);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;
  uint64_t* k_empty = k_full + KST;
  uint64_t* v_full = k_empty + KST;
  uint64_t* v_empty = v_full + VST;

  const int lo = max(__ldg(bounds), 0), hi = min(__ldg(bounds + 1), S);
  const int t0 = lo / BK;                             // the window's stages
  const int n_st = lo < hi ? (hi + BK - 1) / BK - t0 : 0;
  const int BN = B * N, n_qt = (Lq + BM - 1) / BM, n_work = n_qt * BN;
  const long long ld_tok = (long long)N * D;
  const int wg = threadIdx.x / 128;
  if (n_st == 0) {   // an empty window: every output row is 0
    for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
      const int bn = w / n_qt, r0 = (w % n_qt) * BM;
      float* ob = out + ((long long)(bn / N) * Lq + r0) * ld_tok + bn % N * D;
      for (int e = threadIdx.x; e < BM * D / 4; e += THREADS)
        if (r0 + e / (D / 4) < Lq)
          *reinterpret_cast<float4*>(ob + e / (D / 4) * ld_tok +
                                     4 * (e % (D / 4))) =
              make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMERS);
    for (int s = 0; s < KST; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&k_empty[s], CONSUMERS);
    }
    for (int s = 0; s < VST; ++s) {
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: one thread loads each item's Q (one buffer: the
    // next item's waits until both warpgroups' last Q.K^T), then its
    // stages' K and V^T parts ----
    regs_dealloc<24>();
    if (threadIdx.x != 128 * CONSUMERS) return;
    int i = 0;   // stages loaded so far: the ring position
    for (int k = 0, w = blockIdx.x; w < n_work; ++k, w += gridDim.x) {
      const int qt = w % n_qt, bn = w / n_qt, b = bn / N, n = bn % N;
      mbar_wait(q_empty, (k & 1) ^ 1);
      mbar_expect_tx(q_full, Q_BYTES);
      for (int j = 0; j < 4; ++j)
        tma_load_4d(sQ + j * Q_BOX, &maps.q, q_full, 32 * j, n, qt * BM, b);
      for (int t = t0; t < t0 + n_st; ++t, ++i) {
        const int sk = i % KST, sv = i % VST;
        unsigned char* dk = sK + sk * STAGE;
        mbar_wait(&k_empty[sk], ((i / KST) & 1) ^ 1);
        mbar_expect_tx(&k_full[sk], STAGE);
        for (int j = 0; j < 4; ++j) {
          tma_load_3d(dk + j * K_BOX, &maps.kb, &k_full[sk], 32 * j, t * BK,
                      bn);
          tma_load_3d(dk + PART + j * K_BOX, &maps.ks, &k_full[sk], 32 * j,
                      t * BK, bn);
        }
        unsigned char* dv = sV + sv * STAGE;
        mbar_wait(&v_empty[sv], ((i / VST) & 1) ^ 1);
        mbar_expect_tx(&v_full[sv], STAGE);
        tma_load_3d(dv, &maps.vb, &v_full[sv], t * BK, 0, bn);
        tma_load_3d(dv + PART, &maps.vs, &v_full[sv], t * BK, 0, bn);
      }
    }
    return;
  }

  // ---- consumers: warpgroup c owns rows 64 c .. 64 c + 63 of the tile
  regs_alloc<240>();
  const int c = wg;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const bool leader = threadIdx.x % 128 == 0;
  const int rt = c * 64 + 16 * warp + g;   // rows rt, rt + 8 of the tile
  const float mul = scale * LOG2E;
  const uint64_t dqs = desc_sw128(sQ + c * 64 * 128, 16, 1024);
  const uint64_t dk0 = desc_sw128(sK, 16, 1024);
  const uint64_t dv0 = desc_sw128(sV, 16, 1024);

  uint32_t qb[D / 8][4];          // Q's big part: A of k-step kk
  float o[64];                    // the O chain
  float s[BK / 2];                // S of the stage, then p
  uint32_t pb[BK / 8][4], ps[BK / 8][4];   // p's parts: A of P.V
  // rows rt, rt + 8: the running max, sum, out's max (mf), the rescale
  float m[2] = {}, l[2] = {}, mf[2] = {}, corr[2] = {};

  // S = Q.K^T of K stage sk: small_q big_k + big_q small_k + big_q big_k
  auto qk = [&](int sk) {
    const uint64_t db = dk0 + ((sk * STAGE) >> 4);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint32_t ko = ((kk / 4) * K_BOX + (kk % 4) * 32) >> 4;
      WgmmaTf32<BK>::ss(
          s, dqs + (((kk / 4) * Q_BOX + (kk % 4) * 32) >> 4), db + ko,
          kk > 0);
      WgmmaTf32<BK>::rs(s, qb[kk], db + (PART >> 4) + ko, 1);
      WgmmaTf32<BK>::rs(s, qb[kk], db + ko, 1);
    }
  };
  // O (+)= P.V of V stage sv (accumulate 0 starts a chain)
  auto pv = [&](int sv, int accumulate) {
    const uint64_t db = dv0 + ((sv * STAGE) >> 4);
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      WgmmaTf32<D>::rs(o, ps[kk], db + 2 * kk, kk > 0 || accumulate);
      WgmmaTf32<D>::rs(o, pb[kk], db + (PART >> 4) + 2 * kk, 1);
      WgmmaTf32<D>::rs(o, pb[kk], db + 2 * kk, 1);
    }
  };
  // p = 2^(s mul - m) of stage t in place, -inf outside [lo, hi) on an
  // edge stage; the new running max, corr and l
  auto softmax = [&](int t) {
    const int j0 = t * BK;
    if (j0 < lo || j0 + BK > hi) {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const int j = j0 + 8 * (e / 4) + 2 * tq + (e & 1);
        if (j < lo || j >= hi) s[e] = -INFINITY;
      }
    }
    float sub[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < BK / 8; ++e)
        mx = fmaxf(mx, fmaxf(s[4 * e + 2 * h], s[4 * e + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx * mul);
      sub[h] = m_new == -INFINITY ? 0.f : m_new;
      corr[h] = fast_exp2(m[h] - sub[h]);
      m[h] = m_new;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      s[e] = fast_exp2(fmaf(s[e], mul, -sub[(e >> 1) & 1]));
      ls[(e >> 1) & 1] += s[e];
    }
    l[0] = l[0] * corr[0] + ls[0];
    l[1] = l[1] * corr[1] + ls[1];
  };
  // p's parts as the A fragments of P.V: k-columns tq and tq + 4 of step
  // kk are keys 8 kk + 2 tq and + 1 (the pre-pass's V^T order)
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const float v[4] = {s[4 * kk], s[4 * kk + 2], s[4 * kk + 1],
                          s[4 * kk + 3]};
#pragma unroll
      for (int r = 0; r < 4; ++r) split_tf32(v[r], pb[kk][r], ps[kk][r]);
    }
  };
  // out = out * cf + O * inv on item w's rows (out read when `read`, a
  // row's 16 loads issued before its stores: one latency, not 16; rows
  // past Lq are not touched)
  auto fold = [&](int w, bool read, const float (&cf)[2],
                  const float (&inv)[2]) {
    const int bn = w / n_qt, r0 = (w % n_qt) * BM + rt;
    float* ob = out + ((long long)(bn / N) * Lq + r0) * ld_tok +
                bn % N * D + 2 * tq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (r0 + 8 * h < Lq) {
        float* row = ob + 8 * h * ld_tok;
        float2 x[D / 8];
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          x[j] = read ? *reinterpret_cast<const float2*>(row + 8 * j)
                      : make_float2(0.f, 0.f);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<float2*>(row + 8 * j) = make_float2(
              fmaf(x[j].x, cf[h], o[4 * j + 2 * h]) * inv[h],
              fmaf(x[j].y, cf[h], o[4 * j + 2 * h + 1]) * inv[h]);
      }
    }
  };
  // item k's Q: its big part into registers, its small part back in place
  // (this warpgroup's rows; the swizzled box layout of hopper.cuh)
  auto take_q = [&](int k) {
    mbar_wait(q_full, k & 1);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = rt + 8 * (r & 1), cc = 8 * (kk % 4) + tq + 4 * (r >> 1);
        float* p = reinterpret_cast<float*>(
            sQ + (kk / 4) * Q_BOX + row * 128 + ((cc / 4) ^ (row % 8)) * 16 +
            (cc % 4) * 4);
        uint32_t small;
        split_tf32(*p, qb[kk][r], small);
        *p = __uint_as_float(small);
      }
    fence_async_smem();
    named_sync(1 + c, 128);
  };
  const float one[2] = {1.f, 1.f};

  int i = 0;   // stages consumed so far: the ring position
  for (int k = 0, w = blockIdx.x; w < n_work; ++k, w += gridDim.x) {
    take_q(k);
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
    bool folded = false;   // out holds this item's earlier chains
    int since = 0;         // stages in the O chain
    int accumulate = 0;    // the next P.V adds to the chain
    {   // the first stage: Q.K^T alone
      const int sk = i % KST;
      mbar_wait(&k_full[sk], (i / KST) & 1);
      wgmma_fence();
      qk(sk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      if (leader) {
        mbar_arrive(&k_empty[sk]);
        if (n_st == 1) mbar_arrive(q_empty);
      }
      softmax(t0);
      pack();
      ++i;
    }
    for (int t = t0 + 1; t < t0 + n_st; ++t, ++i) {
      const int sk = i % KST, sv = (i - 1) % VST;
      mbar_wait(&k_full[sk], (i / KST) & 1);
      mbar_wait(&v_full[sv], ((i - 1) / VST) & 1);
      wgmma_fence();
      qk(sk);
      wgmma_commit();
      pv(sv, accumulate);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);
      if (leader) {
        mbar_arrive(&k_empty[sk]);
        if (t == t0 + n_st - 1) mbar_arrive(q_empty);
      }
      softmax(t);
      wgmma_wait<0>();
      fence_regs(o);
      if (leader) mbar_arrive(&v_empty[sv]);
      accumulate = 1;
      // O to the new max unless no row of the warp raised it
      if (!__all_sync(0xffffffffu, corr[0] == 1.f && corr[1] == 1.f)) {
#pragma unroll
        for (int e = 0; e < 64; ++e) o[e] *= corr[(e >> 1) & 1];
      }
      if (++since == FLUSH) {   // fold the chain into out; start a new one
        const float cf[2] = {folded ? fast_exp2(mf[0] - m[0]) : 0.f,
                             folded ? fast_exp2(mf[1] - m[1]) : 0.f};
        fold(w, folded, cf, one);
        mf[0] = m[0];
        mf[1] = m[1];
        folded = true;
        since = 0;
        accumulate = 0;
      }
      pack();
    }
    {   // the last stage's P.V, then out = (out 2^(mf - m) + O) / l
      const int sv = (i - 1) % VST;
      mbar_wait(&v_full[sv], ((i - 1) / VST) & 1);
      wgmma_fence();
      pv(sv, accumulate);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (leader) mbar_arrive(&v_empty[sv]);
    }
    float cf[2], inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x = l[h];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      inv[h] = 1.f / fmaxf(x, 1e-30f);
      cf[h] = folded ? fast_exp2(mf[h] - m[h]) : 0.f;
    }
    fold(w, folded, cf, inv);
  }
}

// The float32 window attention: the pre-pass, then the kernel (tensor
// maps encoded on the host at every launch); kb / ks [B*N, S, D] and vb /
// vs [B*N, D, S_pad] (S_pad = S rounded up to 32) are its workspace.
int window_f32(const float* q, const float* k, const float* v,
               const int* bounds, float* out, float* kb, float* ks,
               float* vb, float* vs, int B, int N, int Lq, int S,
               float scale, cudaStream_t st) {
  constexpr int BK = wf::BK;
  const int BN = B * N, S_pad = (S + BK - 1) / BK * BK;
  wf::window_split_f32<<<dim3(S_pad / BK, BN), 256, 0, st>>>(
      k, v, kb, ks, vb, vs, S, S_pad, bounds);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wf::Maps maps;
  memset(&maps, 0, sizeof(maps));
  const uint64_t row = D * sizeof(float);
  {
    const uint64_t dims[4] = {D, (uint64_t)N, (uint64_t)Lq, (uint64_t)B};
    const uint64_t strides[3] = {row, row * N, row * N * Lq};
    const uint32_t box[4] = {32, 1, wf::BM, 1};
    if (int e = f32_map(&maps.q, q, 4, dims, strides, box)) return e;
  }
  {
    const uint64_t dims[3] = {D, (uint64_t)S, (uint64_t)BN};
    const uint64_t strides[2] = {row, row * S};
    const uint32_t box[3] = {32, BK, 1};
    if (int e = f32_map(&maps.kb, kb, 3, dims, strides, box)) return e;
    if (int e = f32_map(&maps.ks, ks, 3, dims, strides, box)) return e;
  }
  {
    const uint64_t dims[3] = {(uint64_t)S_pad, D, (uint64_t)BN};
    const uint64_t strides[2] = {(uint64_t)S_pad * 4, (uint64_t)S_pad * 4 * D};
    const uint32_t box[3] = {BK, D, 1};
    if (int e = f32_map(&maps.vb, vb, 3, dims, strides, box)) return e;
    if (int e = f32_map(&maps.vs, vs, 3, dims, strides, box)) return e;
  }
  err = cudaFuncSetAttribute(decode_window_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)wf::SMEM);
  if (err != cudaSuccess) return (int)err;
  static int sms = 0;   // the persistent grid: one CTA an SM
  if (sms == 0) {
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = min((Lq + wf::BM - 1) / wf::BM * BN, sms);
  decode_window_f32_kernel<<<grid, THREADS, wf::SMEM, st>>>(
      maps, out, B, N, Lq, S, scale, bounds);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`.  k_cache / v_cache point at the chosen layer
// [B*N, S, D]; cache_lim = min(S, static_hi, max(sink_end, kv_end)) bounds
// the cache tiles visited; mode is one of Mode; m0 points at one float
// (BOUNDED only; may be null otherwise).  Returns the CUDA error code (0
// on success; cudaErrorInvalidValue for an unknown mode).
extern "C" int decode_fresh_launch(const void* q, const void* k_cache,
                                   const void* v_cache, const void* k_new,
                                   const void* v_new, const void* m0,
                                   void* out, int B, int N, int Lq, int Lf,
                                   int S, int kv_start, int kv_end,
                                   int sink_end, int cache_lim, int mode,
                                   float scale, void* stream) {
  auto st = (cudaStream_t)stream;
#define SF_ARGS q, k_cache, v_cache, k_new, v_new, m0, out, B, N, Lq, Lf, S, \
    kv_start, kv_end, sink_end, cache_lim, scale, nullptr, st
  switch (mode) {
    case FREE: return launch<FREE, CACHE, false>(SF_ARGS);
    case FREE_NOCLAMP: return launch<FREE_NOCLAMP, CACHE, false>(SF_ARGS);
    case BOUNDED:
      if (m0 == nullptr) return (int)cudaErrorInvalidValue;
      return launch<BOUNDED, CACHE, false>(SF_ARGS);
    case ONLINE: return launch<ONLINE, CACHE, false>(SF_ARGS);
  }
#undef SF_ARGS
  return (int)cudaErrorInvalidValue;
}

// The cache-window attention of decode_attention (the TPU kernel
// _decode_kernel) in bf16: every query of q [B, Lq, N*D] (heads-packed;
// the folded [B*N, Lq, D] layout is N = 1) attends the keys [lo, hi) of
// one layer's cache [B*N, S, D], lo / hi the two int32 at `bounds` on the
// device (an empty window gives 0), online softmax at `scale`; out like
// q.  The online mode of decode_fresh_kernel with no fresh tiles, p
// rounded to bf16 for P.V.
extern "C" int decode_window_launch(const void* q, const void* k_cache,
                                    const void* v_cache, const void* bounds,
                                    void* out, int B, int N, int Lq, int S,
                                    float scale, void* stream) {
  if (bounds == nullptr || S <= 0) return (int)cudaErrorInvalidValue;
  return launch<ONLINE, WINDOW, false>(q, k_cache, v_cache, nullptr, nullptr,
                                       nullptr, out, B, N, Lq, 0, S, 0, 0, 0,
                                       S, scale, (const int*)bounds,
                                       (cudaStream_t)stream);
}

// The same in float32 (3xTF32 products; decode_window_f32_kernel): q, the
// cache and out float32, 16-byte aligned; kb, ks [B*N, S, D] and vb, vs
// [B*N, D, S_pad] float32 (S_pad = S rounded up to 32) the workspace of
// its pre-pass.  Returns the CUDA error code (0 on success).
extern "C" int decode_window_f32_launch(const void* q, const void* k_cache,
                                        const void* v_cache,
                                        const void* bounds, void* out,
                                        void* kb, void* ks, void* vb,
                                        void* vs, int B, int N, int Lq,
                                        int S, float scale, void* stream) {
  if (bounds == nullptr || S <= 0 || kb == nullptr || ks == nullptr ||
      vb == nullptr || vs == nullptr)
    return (int)cudaErrorInvalidValue;
  if (Lq <= 0 || B * N <= 0) return 0;
  return window_f32((const float*)q, (const float*)k_cache,
                    (const float*)v_cache, (const int*)bounds, (float*)out,
                    (float*)kb, (float*)ks, (float*)vb, (float*)vs, B, N, Lq,
                    S, scale, (cudaStream_t)stream);
}

// The cross attention (the TPU kernel _cross_kernel): softmax(scale *
// q k^T) v of q [B, Lq, N*D] onto k / v [B, Lk, N, D], 1 <= Lk <= 1024;
// out like q.  The online mode with no cache tiles and k / v as the fresh
// keys, P.V from the hi and lo bf16 parts of p.  Returns the CUDA error
// code (0 on success).
extern "C" int cross_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int N,
                                      int Lq, int Lk, float scale,
                                      void* stream) {
  if (Lk < 1 || Lk > 1024) return (int)cudaErrorInvalidValue;
  return launch<ONLINE, CACHE, true>(q, nullptr, nullptr, k, v, nullptr, out,
                                     B, N, Lq, Lk, 0, 0, 0, 0, 0, scale,
                                     nullptr, (cudaStream_t)stream);
}

// The int8-QK attention (the attention of the TPU kernel
// _decode_fresh_int8_kernel in 'free_qk' mode): the pre-pass's int8 q8
// [B*N, qt * tq, D] onto its int8 cache K kc8 [B*N, ntc * tk, D] and fresh
// K kn8 [B*N, ntf * tf, D] (decode_int8qk.cu's int8qk_quantize_launch;
// qt, ntc, ntf = ceil(Lq / tq), ceil(cache_lim / tk), ceil(Lf / tf)),
// scores dequantized with the tile scales qs [B*N, qt], ksc [B*N, ntc],
// ksf [B*N, ntf] times `scale`, the free softmax, bf16 P.V with V of layer
// `v_cache` ([B*N, S, D]) and v_new (heads-packed [B, Lf, N*D]); out like
// v_new with Lq rows.  cache_lim = min(S, static_hi, max(sink_end,
// kv_end)) bounds the cache tiles visited.  Returns the CUDA error code.
extern "C" int int8qk_attend_launch(const void* q8, const void* qs,
                                    const void* kc8, const void* ksc,
                                    const void* kn8, const void* ksf,
                                    const void* v_cache, const void* v_new,
                                    void* out, int B, int N, int Lq, int Lf,
                                    int S, int kv_start, int kv_end,
                                    int sink_end, int cache_lim, int tq,
                                    int tk, int tf, float scale,
                                    void* stream) {
  if (tq < 1 || tk < 1 || tf < 1) return (int)cudaErrorInvalidValue;
  if (Lq <= 0 || B * N <= 0) return 0;
  auto cdiv = [](int a, int b) { return (a + b - 1) / b; };
  const Scales sc{(const float*)qs, (const float*)ksc, (const float*)ksf,
                  tq, tk, tf, cdiv(Lq, tq), cdiv(cache_lim, tk),
                  cdiv(Lf, tf)};
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  const uint64_t BN = (uint64_t)B * N;
  // int8 rows of 128 bytes, folded [B*N, rows, D]: boxes of one row of
  // 128 int8 (a 128-byte swizzle row) by BM or BK rows
  auto i8_map = [&](CUtensorMap* m, const void* p, int rows, int box_rows) {
    const uint64_t dims[3] = {D, (uint64_t)rows, BN};
    const uint64_t strides[2] = {D, (uint64_t)D * rows};
    const uint32_t box[3] = {D, (uint32_t)box_rows, 1};
    return u8_map(m, p, 3, dims, strides, box);
  };
  if (int e = i8_map(&maps.q, q8, sc.qt * tq, BM)) return e;
  if (sc.ntc > 0)
    if (int e = i8_map(&maps.kc, kc8, sc.ntc * tk, BK)) return e;
  if (sc.ntf > 0)
    if (int e = i8_map(&maps.kn, kn8, sc.ntf * tf, BK)) return e;
  if (int e = v_maps(maps, cache_lim > 0 ? v_cache : nullptr, v_new, B, N,
                     Lf, S))
    return e;
  return run<INT8QK, CACHE, false>(maps, nullptr, out, B, N, Lq, Lf, S,
                                   kv_start, kv_end, sink_end, cache_lim,
                                   scale, nullptr, sc, Flash{},
                                   (cudaStream_t)stream);
}

// The masked flash attention forward (the TPU kernel _flash_kernel): q
// [B, Lq, N, D] onto k, v [B, Lk, N, D] (bf16), out like q, lse [B*N,
// lq_pad] fp32 (base e); iv [4, lq_pad] int32 (s1, e1, s2, e2 of every
// query row), tiles [ceil(Lq / 128), n_kt] / count / order / run int32
// (the wrapper's flash_geometry: each 128-query tile's live 128-key tiles
// as 2 t + partial, how many, the query tiles most live tiles first, the
// runs of equal counts in that order); n_kt = ceil(Lk / 128).  mode: 0 free (q carries the scale; `scale` unused), 1
// bounded (m0 points at one float), 2 online.  Returns the CUDA error
// code (0 on success; cudaErrorInvalidValue for what it does not take).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                const void* m0, void* out, void* lse,
                                const void* iv, const void* tiles,
                                const void* count, const void* order,
                                const void* run, int B, int N, int Lq,
                                int Lk, int lq_pad, int n_kt, int mode,
                                float scale, void* stream) {
  if (B <= 0 || N <= 0 || Lq <= 0 || Lk <= 0 || lq_pad % BM ||
      lq_pad < Lq || n_kt != (Lk + BK - 1) / BK ||
      (mode == 1 && m0 == nullptr))
    return (int)cudaErrorInvalidValue;
  const Flash fl{(const int*)iv, (const int*)tiles, (const int*)count,
                 (const int*)order, (const int*)run, (float*)lse, lq_pad,
                 n_kt};
  auto st = (cudaStream_t)stream;
#define SF_ARGS q, nullptr, nullptr, k, v, m0, out, B, N, Lq, Lk, 0, 0, 0, \
    0, 0
  switch (mode) {
    case 0: return launch<FREE, FLASH, false>(SF_ARGS, 1.f, nullptr, st, fl);
    case 1:
      return launch<BOUNDED, FLASH, false>(SF_ARGS, scale, nullptr, st, fl);
    case 2:
      return launch<ONLINE, FLASH, false>(SF_ARGS, scale, nullptr, st, fl);
  }
#undef SF_ARGS
  return (int)cudaErrorInvalidValue;
}
