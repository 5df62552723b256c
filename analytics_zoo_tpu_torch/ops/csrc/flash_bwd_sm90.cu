// Flash-attention backward redesigned for Hopper (sm_90a) at bf16 and f32:
// TMA rings and warp-specialised wgmma, two kernels and no atomics.
//
// Replaces the Pallas TPU kernels `_flash_bwd_dq_kernel` and
// `_flash_bwd_dkv_kernel` (analytics_zoo_tpu/ops/attention.py:214 and
// :265, launched by `_flash_core_bwd`) for every call that TMA and wgmma
// take: rows of 16-byte multiples, 16-byte-aligned bases, head dim up to
// 128 at bf16 and up to 64 at f32 (ops/_kernels.py `bwd_design`).
// flash_bwd.cu, the mma.sync design, takes the rest.  It computes exactly
// what flash_bwd.cu states, replaying the forward's softmax from its
// saved row logsumexp:
//   p  = exp(s * scale - lse)             (masked pairs -> exactly 0)
//   dp = do . v^T
//   ds = p * (dp - delta) * scale         delta = rowsum(do * o), f32,
//                                         computed by the caller
//   dq = ds . k        (flash_bwd_dq_sm90,  a block per query tile)
//   dv = p^T . do      (flash_bwd_dkv_sm90, a block per key tile)
//   dk = ds^T . q
// with the forward's masking: causal alignment q_pos = i + (sk - sq),
// per-(batch*head) valid key counts `lens` (f32 in [1, sk] or null), rows
// past sq with p = 0; the dq block walks key tiles up to its causal
// diagonal and ceil(len / walked rows), the dkv block query tiles from
// the first that reaches it causally, and a key tile wholly at or past
// `len` writes dk = dv = 0 without walking.  bf16: p is rounded to bf16
// before p^T.do, ds before ds.k and ds^T.q; every sum is f32.  f32: every
// product runs as 3xTF32 (a.b ~= a_hi.b_hi + a_hi.b_lo + a_lo.b_hi, about
// 2^-20 relative, as flash_bwd.cu's).
//
// What bounds it on the H100: operations.  Per valid (query, key) pair,
// dq runs 3 products and dk/dv 4, 2*d FLOP each.  bf16 at 989 TFLOP/s: at
// (48, 2048, 64) causal 39 and 52 GFLOP, 0.039 and 0.052 ms, against
// ~0.05 GB of operands (0.015 ms at 3.35 TB/s).  f32, three TF32 products
// each at 495 TFLOP/s: at (96, 2048, 64) causal 0.469 and 0.625 ms.
//
// Design (sm90.cuh holds the barrier, TMA, descriptor, wgmma and TF32
// conversion helpers):
// - A block is one producer warpgroup and one or two consumer warpgroups,
//   each owning 64 rows of the block's own tile (queries in dq, keys in
//   dkv; two where bh * ceil(s / 128) blocks fill the SMs and d <= 64,
//   as the forward chooses, and at f32 in dq only).  The producer brings
//   the own tiles by TMA once (Q and dO; K and V), then walked tiles (K
//   and V; Q and dO: 64 rows at bf16, 32 at f32) into a ring of stages
//   with full and empty mbarriers.  TMA's zero fill past the last row and
//   past d replaces the edge masking of the loads.  dkv's walked tiles
//   carry their rows' lse (times log2 e) and delta: (bh, sq) f32 rows that
//   a 2-d TMA map would take only where sq * 4 is a multiple of 16, so
//   the producer loads them with plain loads into the stage (at bf16 its
//   first warp, arriving on the full barrier beside the TMA thread's
//   transaction count; at f32 the converting warps below).
// - Tiles lie in shared memory as 128-byte swizzled atoms, the head dim
//   along the row, so S = Q.K^T and dP = dO.V^T (dq), S^T = K.Q^T and
//   dP^T = V.dO^T (dkv) are shared-by-shared wgmma, both operands K-major.
//   p and ds are formed in those accumulators' fragments (dq_p_ds and
//   dkv_p_ds, the same at both dtypes) and go to the output products
//   dQ += dS.K, dV += P^T.dO and dK += dS^T.Q as their A operand from
//   registers.  dkv reads lse and delta per column from the stage.
// - bf16: p and ds are packed to bf16 (their rounding) as the A fragments
//   as they stand; the descriptor reads the B tiles (K; dO and Q)
//   MN-major.
// - f32: TF32 wgmma reads its shared-memory operands K-major only, so the
//   output products' B tiles have to be transposed (K^T; dO^T and Q^T),
//   and 3xTF32 wants every operand's hi and lo parts.  wgmma reads a TF32
//   operand's top 19 bits, so a raw f32 tile is its own hi part (on the
//   H100 the errors equal an explicit split's to every digit).  TMA lands
//   each walked tile into its stage; converting warps of the producer
//   (three in dq, seven in dkv, whose stages hold twice the transposes)
//   write the transposes, hi and lo, with each group of 8 walked rows in
//   the order 0 2 4 6 1 3 5 7 (the forward's V^T: p's and ds's fragments
//   are then the A fragment as they stand), and the landed tiles' lo
//   parts; the stage's full barrier counts their arrivals.  Each consumer
//   writes its own rows' lo parts once.  A stage of 32 walked rows is 48
//   KB in dq (K, V, their lo parts, K^T hi and lo) and 64 KB in dkv (Q,
//   dO, lo parts, Q^T and dO^T hi and lo): dq holds two stages beside two
//   consumers' own tiles (or three beside one's), dkv two beside one
//   consumer's, and no f32 stage fits past d = 64.  Each tile's output products go into a fresh
//   accumulator added to dq, dk and dv with rounded adds: summed into them
//   directly, the tensor core's cut sums bias a long walk (flash_bwd.cu).
// - Per tile, as the forward: no runtime branch between two wgmmas (it
//   serialises them); the mask test only on tiles that cross a causal,
//   length or sequence edge; exp2 with log2 e folded into the scale and
//   lse.  dq's long causal rows start first (query blocks last-first);
//   dkv's key blocks with the longest walks (the first) start first.
// - bf16's output sums run in the accumulators across the walk (as the
//   mma.sync design's bf16 path): at bf16 the rounding of p and ds to bf16
//   is some 2^15 times the tensor core's truncation of a sum, and a fresh
//   accumulator a tile would take dkv past the registers of two consumer
//   warpgroups (dK, dV, S^T and dP^T are 32 registers each at d = 64).
// - No split over the walk: each output row is summed by one warpgroup in
//   one order, so two launches give the same bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;

// tensor maps of the call's q, k, v and do
struct Maps {
  CUtensorMap q, k, v, dout;
};

// One kernel's tiles at padded head dim DP with NC consumer warpgroups.
template <int DP, int NC>
struct Bwd {
  static constexpr int BO = 64 * NC;  // own rows: 64 a consumer
  static constexpr int BW = 64;       // walked rows a stage
  static constexpr int STAGES = DP > 64 ? 2 : 3;
  static constexpr int OWN_BYTES = BO * DP * 2;  // one own tile (bf16)
  static constexpr int T_BYTES = BW * DP * 2;    // one walked tile
  static constexpr int STAGE_BYTES = 2 * T_BYTES;
  // dkv: a stage's lse and delta rows, after the tiles
  static constexpr int STATS_AT = 2 * OWN_BYTES + STAGES * STAGE_BYTES;
  static constexpr int BARS_AT = STATS_AT + STAGES * 2 * BW * 4;
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr size_t SMEM =
      1024 + (size_t)BARS_AT + (2 * STAGES + 1) * sizeof(uint64_t);
};

// c = A.B^T over the padded head dim (columns past d are TMA's zeros),
// both operands K-major: A the warpgroup's 64 rows of an own tile at Aw
// (atom a at a * 64 * NC * 128), B a walked tile at Bt (atom a at a * 64 *
// 128).  Issued, not waited for.
template <int DP, int NC>
__device__ __forceinline__ void abt(float (&c)[32], const unsigned char* Aw,
                                    const unsigned char* Bt) {
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks)
    wgmma_ss_bf16_n64(c, sw128(Aw + (ks / 4) * 64 * NC * 128 + (ks % 4) * 32),
                      sw128(Bt + (ks / 4) * 64 * 128 + (ks % 4) * 32), ks > 0);
}

// The fragments of a 64 x 64 accumulator packed to bf16: chunks 2kb and
// 2kb + 1 of 8 columns are the A fragment of depth kb as they stand.
__device__ __forceinline__ void pack(uint32_t (&a)[4][4],
                                     const float (&x)[32]) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kb][r] = flash::pack_bf16(x[8 * kb + 2 * r], x[8 * kb + 2 * r + 1]);
}

// c += A.B over one walked tile: A packed fragments (64 own rows x 64
// walked), B the walked tile at Bt read MN-major (atom a of the head dim
// at a * 64 * 128, 16 walked rows 2048 bytes apart).  Issued, not waited
// for.
template <int DP>
__device__ __forceinline__ void pb(float (&c)[DP / 2],
                                   const uint32_t (&a)[4][4],
                                   const unsigned char* Bt) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
#pragma unroll
    for (int at = 0; at < DP / 64; ++at)
      wgmma_rs_bf16_n64(*reinterpret_cast<float(*)[32]>(c + 32 * at), a[kb],
                        sw128(Bt + at * 64 * 128 + kb * 2048), 1);
}

// a 64-row by DP accumulator's rows row0 (lanes' g) and row0 + 8 of this
// warp, to a row-major (n_rows, d) output; d is even
template <int DP, typename T>
__device__ __forceinline__ void store_rows(T* out, const float (&c)[DP / 2],
                                           int row0, int n_rows, int d) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int jn = 0; jn < DP / 8; ++jn) {
    const int col = 8 * jn + 2 * t;
    if (col >= d) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row < n_rows)
        store2(out + (size_t)row * d + col, c[4 * jn + 2 * h],
               c[4 * jn + 2 * h + 1]);
    }
  }
}

// barriers after `at`: full[STAGES], empty[STAGES], own
__device__ __forceinline__ uint64_t* bars(unsigned char* base, int at) {
  return reinterpret_cast<uint64_t*>(base + at);
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  // tiles on 1024-byte boundaries, where the swizzle's pattern starts
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// ---- p and ds, both dtypes, W walked rows a tile --------------------------

// dq: p and ds of one tile, formed in place in the S and dP accumulators'
// fragments (element 4 jj + e: row row0 + g + 8 (e >> 1), key k0 + 8 jj +
// 2t + (e & 1)); lse2 and dlt are rows g and g + 8's lse * log2 e and
// delta.  The mask is tested only on a tile that crosses an edge.
template <int W>
__device__ __forceinline__ void dq_p_ds(float (&sc)[W / 2],
                                        float (&dp)[W / 2],
                                        const float (&lse2)[2],
                                        const float (&dlt)[2], int row0,
                                        int k0, int g, int t, int sq, int sk,
                                        int causal, const float* lens,
                                        float len, float scale,
                                        float scale2) {
#pragma unroll
  for (int i = 0; i < W / 2; ++i)
    sc[i] = flash::exp2_ftz(fmaf(sc[i], scale2, -lse2[(i >> 1) & 1]));
  if (!flash::tile_unmasked(row0, 16, k0, W, sq, sk, causal, lens, len)) {
#pragma unroll
    for (int jj = 0; jj < W / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!flash::pair_valid(row0 + g + 8 * (e >> 1),
                               k0 + 8 * jj + 2 * t + (e & 1), sq, sk, causal,
                               lens, len))
          sc[4 * jj + e] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < W / 2; ++i)
    dp[i] = sc[i] * (dp[i] - dlt[(i >> 1) & 1]) * scale;
}

// dk/dv: p^T and ds^T of one tile, formed in place in the S^T and dP^T
// accumulators' fragments (element 4 jj + e: key key0 + g + 8 (e >> 1),
// query q0 + 8 jj + 2t + (e & 1)); the tile's rows' lse * log2 e at L and
// delta at D, in the stage.  The mask is tested only on a tile that crosses
// an edge.
template <int W>
__device__ __forceinline__ void dkv_p_ds(float (&st)[W / 2],
                                         float (&dpt)[W / 2], const float* L,
                                         const float* D, int q0, int key0,
                                         int g, int t, int sq, int sk,
                                         int causal, const float* lens,
                                         float len, float scale,
                                         float scale2) {
#pragma unroll
  for (int jj = 0; jj < W / 8; ++jj) {
    const float2 l = *reinterpret_cast<const float2*>(L + 8 * jj + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      st[4 * jj + e] = flash::exp2_ftz(
          fmaf(st[4 * jj + e], scale2, (e & 1) ? -l.y : -l.x));
  }
  if (!flash::tile_unmasked(q0, W, key0, 16, sq, sk, causal, lens, len)) {
#pragma unroll
    for (int jj = 0; jj < W / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!flash::pair_valid(q0 + 8 * jj + 2 * t + (e & 1),
                               key0 + g + 8 * (e >> 1), sq, sk, causal, lens,
                               len))
          st[4 * jj + e] = 0.f;
  }
#pragma unroll
  for (int jj = 0; jj < W / 8; ++jj) {
    const float2 dl = *reinterpret_cast<const float2*>(D + 8 * jj + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dpt[4 * jj + e] =
          st[4 * jj + e] * (dpt[4 * jj + e] - ((e & 1) ? dl.y : dl.x)) * scale;
  }
}

// ---- f32: 3xTF32 on wgmma ---------------------------------------------------

// One f32 kernel's tiles at padded head dim 64 with NC consumer warpgroups
// (DKV: the dk/dv kernel).  An f32 tile as TMA landed it is its own TF32 hi
// part (wgmma reads a TF32 operand's top 19 bits, the hi part flash::split
// cuts), and its lo parts lie after it: an own tile's OWN_BYTES after, a
// walked one's 2 T_BYTES after.  A stage holds the walked tiles as they
// lie (dq: K, V; dkv: Q, dO), their lo parts, and the transposes the
// output products read (dq: K^T; dkv: Q^T, dO^T), hi then lo.
template <int NC, bool DKV>
struct F32Bwd {
  static constexpr int DP = 64;
  static constexpr int BO = 64 * NC;  // own rows: 64 a consumer
  static constexpr int BW = 32;       // walked rows a stage
  // shared memory holds two stages beside two consumers' own tiles or
  // dkv's eight tiles a stage, three beside dq's one consumer
  static constexpr int STAGES = DKV || NC == 2 ? 2 : 3;
  static constexpr int OWN_BYTES = BO * DP * 4;  // one own tile
  static constexpr int T_BYTES = BW * DP * 4;    // one walked tile's
  static constexpr int STAGE_BYTES = (DKV ? 8 : 6) * T_BYTES;
  // dkv: a stage's lse and delta rows, after the tiles
  static constexpr int STATS_AT = 4 * OWN_BYTES + STAGES * STAGE_BYTES;
  static constexpr int BARS_AT = STATS_AT + (DKV ? STAGES * 2 * BW * 4 : 0);
  // the converting threads: the producer warpgroup's last three warps, and
  // in dkv, whose stages take twice dq's transposes for one consumer's
  // products, a warpgroup more
  static constexpr int CONV = CONVERTERS + (DKV ? 128 : 0);
  static constexpr int THREADS = 128 * (NC + 1) + CONV - CONVERTERS;
  // full, empty and landed a stage, own
  static constexpr size_t SMEM =
      1024 + (size_t)BARS_AT + (3 * STAGES + 1) * sizeof(uint64_t);
};

// One kernel's tiles: Bwd at bf16, F32Bwd at f32
template <typename T, int DP, int NC, bool DKV>
using Tiles =
    std::conditional_t<flash::is_f32<T>, F32Bwd<NC, DKV>, Bwd<DP, NC>>;

// The TF32 lo parts of the raw f32 tile of `bytes` at `x`, to `lo` (an
// elementwise map keeps the swizzle); 16-byte chunks i0, i0 + step, ...
__device__ __forceinline__ void split_lo(const unsigned char* x,
                                         unsigned char* lo, int bytes,
                                         int i0, int step) {
#pragma unroll 4
  for (int i = i0; i < bytes / 16; i += step) {
    const uint4 v = reinterpret_cast<const uint4*>(x)[i];
    uint4 h, l;
    flash::split(__uint_as_float(v.x), h.x, l.x);
    flash::split(__uint_as_float(v.y), h.y, l.y);
    flash::split(__uint_as_float(v.z), h.z, l.z);
    flash::split(__uint_as_float(v.w), h.w, l.w);
    reinterpret_cast<uint4*>(lo)[i] = l;
  }
}

// the lo parts of this consumer warpgroup's 64 rows of the own tiles at x0
// and x1 (atom a at a * BO * 128), made visible to the tensor core
template <class C>
__device__ __forceinline__ void split_own(unsigned char* x0,
                                          unsigned char* x1, int wg,
                                          int tid) {
#pragma unroll
  for (int a = 0; a < C::DP / 32; ++a) {
    unsigned char* r0 = x0 + a * C::BO * 128 + wg * 64 * 128;
    unsigned char* r1 = x1 + a * C::BO * 128 + wg * 64 * 128;
    split_lo(r0, r0 + C::OWN_BYTES, 64 * 128, tid, 128);
    split_lo(r1, r1 + C::OWN_BYTES, 64 * 128, tid, 128);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  warpgroup_sync(1 + wg);
}

// What the products read of a stage's two walked tiles, landed raw at `st`
// (T_BYTES apart): the transposes of the first NT (hi and lo, from 4
// T_BYTES on; the NT tiles' chunks in one loop, for the loads in flight)
// and both tiles' lo parts (2 T_BYTES after).  Thread ct of C::CONV; the
// writes are made visible to the tensor core.
template <class C, int NT>
__device__ __forceinline__ void convert_stage(unsigned char* st, int ct) {
  constexpr int T = C::T_BYTES;
#pragma unroll 2
  for (int i = ct; i < C::DP * C::BW / 4; i += C::CONV)
#pragma unroll
    for (int k = 0; k < NT; ++k)
      transpose_chunk<C::DP, C::BW>(st + (4 + 2 * k) * T,
                                    st + (5 + 2 * k) * T, st + k * T, i);
  split_lo(st, st + 2 * T, 2 * T, ct, C::CONV);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// c = A.B^T over the padded head dim in 3xTF32, both operands K-major: A
// this warpgroup's 64 rows of an own tile at Aw (atom a at a * BO * 128),
// B a walked tile at Bt (atom a at a * BW * 128).  Each depth step's cross
// terms go first, hi.hi last.  Issued, not waited for.
template <class C>
__device__ __forceinline__ void abt3(float (&c)[C::BW / 2],
                                     const unsigned char* Aw,
                                     const unsigned char* Bt) {
#pragma unroll
  for (int ks = 0; ks < C::DP / 8; ++ks) {
    const uint64_t da = sw128(Aw + (ks / 4) * C::BO * 128 + (ks % 4) * 32);
    const uint64_t db = sw128(Bt + (ks / 4) * C::BW * 128 + (ks % 4) * 32);
    wgmma_ss_tf32_n32(c, da + (C::OWN_BYTES >> 4), db, ks > 0);
    wgmma_ss_tf32_n32(c, da, db + ((2 * C::T_BYTES) >> 4), 1);
    wgmma_ss_tf32_n32(c, da, db, 1);
  }
}

// A fragment of depth kb: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3
// (g + 8, t + 4) take x's (g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8,
// 2t + 1), the walked rows the transposes put at those columns; each
// split into TF32 hi and lo parts
template <class C>
__device__ __forceinline__ void split_frags(uint32_t (&ah)[C::BW / 8][4],
                                            uint32_t (&al)[C::BW / 8][4],
                                            const float (&x)[C::BW / 2]) {
#pragma unroll
  for (int kb = 0; kb < C::BW / 8; ++kb) {
    flash::split(x[4 * kb + 0], ah[kb][0], al[kb][0]);
    flash::split(x[4 * kb + 2], ah[kb][1], al[kb][1]);
    flash::split(x[4 * kb + 1], ah[kb][2], al[kb][2]);
    flash::split(x[4 * kb + 3], ah[kb][3], al[kb][3]);
  }
}

// c = A.B over one walked tile in 3xTF32, into a fresh accumulator: A the
// split fragments, B a transpose at Bt (DP rows of BW walked columns, its
// lo parts T_BYTES after).  Issued, not waited for.
template <class C>
__device__ __forceinline__ void pb3(float (&c)[C::DP / 2],
                                    const uint32_t (&ah)[C::BW / 8][4],
                                    const uint32_t (&al)[C::BW / 8][4],
                                    const unsigned char* Bt) {
#pragma unroll
  for (int kb = 0; kb < C::BW / 8; ++kb) {
    const uint64_t db = sw128(Bt + (kb / 4) * C::DP * 128 + (kb % 4) * 32);
    wgmma_rs_tf32_n64(c, al[kb], db, kb > 0);
    wgmma_rs_tf32_n64(c, ah[kb], db + (C::T_BYTES >> 4), 1);
    wgmma_rs_tf32_n64(c, ah[kb], db, 1);
  }
}

// c = pb3's product, issued and waited for, then added to acc with rounded
// adds
template <class C>
__device__ __forceinline__ void add_pb3(float (&acc)[C::DP / 2],
                                        uint32_t (&ah)[C::BW / 8][4],
                                        uint32_t (&al)[C::BW / 8][4],
                                        const unsigned char* Bt) {
  float c[C::DP / 2];
  fence_regs(ah);
  fence_regs(al);
  fence_regs(c);
  wg_fence();
  pb3<C>(c, ah, al, Bt);
  wg_commit();
  wg_wait();
  fence_regs(ah);
  fence_regs(al);
  fence_regs(c);
#pragma unroll
  for (int i = 0; i < C::DP / 2; ++i) acc[i] += c[i];
}

// dq at f32: as the bf16 kernel's walk, on F32Bwd's tiles
template <int NC>
__device__ __forceinline__ void dq_f32(const Maps& maps,
                                       const float* __restrict__ lse,
                                       const float* __restrict__ delta,
                                       const float* __restrict__ lens,
                                       float* __restrict__ dq, int sq,
                                       int sk, int d, float scale,
                                       int causal) {
  using C = F32Bwd<NC, false>;
  constexpr int BQ = C::BO, BK = C::BW, T = C::T_BYTES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* Qs = aligned_smem(smem_raw);
  unsigned char* dOs = Qs + 2 * C::OWN_BYTES;
  // [STAGES][K, V, K lo, V lo, K^T, K^T lo]
  unsigned char* KV = Qs + 4 * C::OWN_BYTES;
  uint64_t* full = bars(Qs, C::BARS_AT);
  uint64_t* empty = full + C::STAGES;
  uint64_t* landed = empty + C::STAGES;
  uint64_t* own = landed + C::STAGES;

  const int bh = blockIdx.x;
  // query blocks last-first: the long causal rows start early
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const float len = lens ? lens[bh] : (float)sk;
  int n = (sk + BK - 1) / BK;
  if (causal) n = min(n, (min(q0 + BQ, sq) - 1 + (sk - sq)) / BK + 1);
  if (lens) n = min(n, (int)ceilf(len / BK));

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], C::CONV);  // the converting threads
      mbar_init(&empty[s], 4 * NC);  // a warp of each consumer
      mbar_init(&landed[s], 1);      // the TMA thread's arrival
    }
    mbar_init(own, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NC) {
    // ---- producer warpgroup: one thread issues the TMA loads, the last
    // three warps convert each stage
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    const int pt = threadIdx.x - 128 * NC;
    if (pt == 0) {
      mbar_expect_tx(own, 2 * C::OWN_BYTES);
#pragma unroll
      for (int a = 0; a < C::DP / 32; ++a) {
        tma_load(Qs + a * BQ * 128, &maps.q, own, a * 32, q0, bh);
        tma_load(dOs + a * BQ * 128, &maps.dout, own, a * 32, q0, bh);
      }
      for (int j = 0; j < n; ++j) {
        const int s = j % C::STAGES;
        mbar_wait(&empty[s], ((j / C::STAGES) & 1) ^ 1);
        unsigned char* st = KV + s * C::STAGE_BYTES;
        mbar_expect_tx(&landed[s], 2 * T);
#pragma unroll
        for (int a = 0; a < C::DP / 32; ++a) {
          tma_load(st + a * BK * 128, &maps.k, &landed[s], a * 32, j * BK,
                   bh);
          tma_load(st + T + a * BK * 128, &maps.v, &landed[s], a * 32,
                   j * BK, bh);
        }
      }
    } else if (pt >= 32) {
      for (int j = 0; j < n; ++j) {
        const int s = j % C::STAGES;
        mbar_wait(&landed[s], (j / C::STAGES) & 1);
        convert_stage<C, 1>(KV + s * C::STAGE_BYTES, pt - 32);
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: query rows q0 + 64 wg on
  if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wrow0 = q0 + 64 * wg, row0 = wrow0 + 16 * warp;
  const bool live = wrow0 < sq;
  // the last key position any row of this warpgroup may see
  const int last_key = causal ? min(wrow0 + 64, sq) - 1 + (sk - sq) : sk - 1;
  const unsigned char* Qw = Qs + wg * 64 * 128;
  const unsigned char* dOw = dOs + wg * 64 * 128;
  // rows g and g + 8: lse in base 2 and delta (0 past sq, where p is
  // masked)
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    lse2[h] = row < sq ? lse[(size_t)bh * sq + row] * flash::LOG2E : 0.f;
    dlt[h] = row < sq ? delta[(size_t)bh * sq + row] : 0.f;
  }
  const float scale2 = scale * flash::LOG2E;
  if (live) {
    mbar_wait(own, 0);
    split_own<C>(Qs, dOs, wg, tid);
  }

  float acc[C::DP / 2];
#pragma unroll
  for (int i = 0; i < C::DP / 2; ++i) acc[i] = 0.f;
  for (int j = 0; j < n; ++j) {
    const int s = j % C::STAGES;
    mbar_wait(&full[s], (j / C::STAGES) & 1);
    const unsigned char* Kt = KV + s * C::STAGE_BYTES;
    const int k0 = j * BK;
    if (live && k0 <= last_key) {
      float sc[BK / 2], dp[BK / 2];
      fence_regs(sc);
      fence_regs(dp);
      wg_fence();
      abt3<C>(sc, Qw, Kt);
      abt3<C>(dp, dOw, Kt + T);
      wg_commit();
      wg_wait();
      fence_regs(sc);
      fence_regs(dp);
      dq_p_ds<BK>(sc, dp, lse2, dlt, row0, k0, g, t, sq, sk, causal, lens,
                  len, scale, scale2);
      uint32_t ah[BK / 8][4], al[BK / 8][4];
      split_frags<C>(ah, al, dp);
      add_pb3<C>(acc, ah, al, Kt + 4 * T);
    }
    // this warp is done with the stage: the producer may refill it
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  if (live)
    store_rows<C::DP>(dq + (size_t)bh * sq * d, acc, row0 + g, sq, d);
}

// dk/dv at f32: as the bf16 kernel's walk, on F32Bwd's tiles, one
// consumer warpgroup (a stage's eight tiles leave shared memory for one
// own tile) and seven converting warps
__device__ __forceinline__ void dkv_f32(const Maps& maps,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta,
                                        const float* __restrict__ lens,
                                        float* __restrict__ dk,
                                        float* __restrict__ dv, int sq,
                                        int sk, int d, float scale,
                                        int causal) {
  using C = F32Bwd<1, true>;
  constexpr int BK = C::BO, BQ = C::BW, T = C::T_BYTES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* Ks = aligned_smem(smem_raw);
  unsigned char* Vs = Ks + 2 * C::OWN_BYTES;
  // [STAGES][Q, dO, Q lo, dO lo, Q^T, Q^T lo, dO^T, dO^T lo]
  unsigned char* QD = Ks + 4 * C::OWN_BYTES;
  // [STAGES][lse * log2 e of BQ rows, delta of BQ rows]
  float* stats = reinterpret_cast<float*>(Ks + C::STATS_AT);
  uint64_t* full = bars(Ks, C::BARS_AT);
  uint64_t* empty = full + C::STAGES;
  uint64_t* landed = empty + C::STAGES;
  uint64_t* own = landed + C::STAGES;

  const int bh = blockIdx.x, k0 = blockIdx.y * BK;
  const float len = lens ? lens[bh] : (float)sk;
  // first query tile whose last row reaches this key tile causally
  const int start = causal ? max(0, (k0 - (sk - sq)) / BQ) : 0;
  int end = (sq + BQ - 1) / BQ;
  if (lens && (float)k0 >= len) end = start;  // dk = dv = 0, no walk
  const int n = end - start;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], C::CONV);  // the converting threads
      mbar_init(&empty[s], 4);       // a warp of the consumer
      mbar_init(&landed[s], 1);      // the TMA thread's arrival
    }
    mbar_init(own, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer warpgroups: one thread issues the TMA loads, the seven
    // warps after the first convert each stage and load its lse and delta
    // rows
    const int pt = threadIdx.x - 128;
    if (pt == 0 && n > 0) {
      mbar_expect_tx(own, 2 * C::OWN_BYTES);
#pragma unroll
      for (int a = 0; a < C::DP / 32; ++a) {
        tma_load(Ks + a * BK * 128, &maps.k, own, a * 32, k0, bh);
        tma_load(Vs + a * BK * 128, &maps.v, own, a * 32, k0, bh);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % C::STAGES, qr0 = (start + i) * BQ;
        mbar_wait(&empty[s], ((i / C::STAGES) & 1) ^ 1);
        unsigned char* st = QD + s * C::STAGE_BYTES;
        mbar_expect_tx(&landed[s], 2 * T);
#pragma unroll
        for (int a = 0; a < C::DP / 32; ++a) {
          tma_load(st + a * BQ * 128, &maps.q, &landed[s], a * 32, qr0, bh);
          tma_load(st + T + a * BQ * 128, &maps.dout, &landed[s], a * 32,
                   qr0, bh);
        }
      }
    } else if (pt >= 32) {
      const int ct = pt - 32;
      for (int i = 0; i < n; ++i) {
        const int s = i % C::STAGES, row = (start + i) * BQ + ct;
        // the stage's lse and delta rows, loaded while its tiles land and
        // convert
        const bool in = ct < BQ && row < sq;
        const float l = in ? lse[(size_t)bh * sq + row] * flash::LOG2E : 0.f;
        const float dl = in ? delta[(size_t)bh * sq + row] : 0.f;
        mbar_wait(&landed[s], (i / C::STAGES) & 1);
        convert_stage<C, 2>(QD + s * C::STAGE_BYTES, ct);
        if (ct < BQ) {
          float* L = stats + s * 2 * BQ;
          L[ct] = l;
          L[BQ + ct] = dl;
        }
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- the consumer warpgroup: keys k0 on
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = k0 + 16 * warp;
  // keys at or past every length get dk = dv = 0 without products
  const bool live = k0 < sk && !(lens && (float)k0 >= len);
  const float scale2 = scale * flash::LOG2E;
  if (live && n > 0) {
    mbar_wait(own, 0);
    split_own<C>(Ks, Vs, 0, tid);
  }

  float dk_acc[C::DP / 2], dv_acc[C::DP / 2];
#pragma unroll
  for (int i = 0; i < C::DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  for (int i = 0; i < n; ++i) {
    const int s = i % C::STAGES;
    mbar_wait(&full[s], (i / C::STAGES) & 1);
    const unsigned char* Qt = QD + s * C::STAGE_BYTES;
    const float* L = stats + s * 2 * BQ;
    const float* D = L + BQ;
    const int q0 = (start + i) * BQ;
    // the tile's last row reaches these keys causally
    if (live && (!causal || min(q0 + BQ, sq) - 1 + (sk - sq) >= k0)) {
      float st[BQ / 2], dpt[BQ / 2];
      fence_regs(st);
      fence_regs(dpt);
      wg_fence();
      abt3<C>(st, Ks, Qt);
      abt3<C>(dpt, Vs, Qt + T);
      wg_commit();
      wg_wait();
      fence_regs(st);
      fence_regs(dpt);
      dkv_p_ds<BQ>(st, dpt, L, D, q0, key0, g, t, sq, sk, causal, lens, len,
                   scale, scale2);
      uint32_t ah[BQ / 8][4], al[BQ / 8][4];
      split_frags<C>(ah, al, st);
      add_pb3<C>(dv_acc, ah, al, Qt + 6 * T);
      split_frags<C>(ah, al, dpt);
      add_pb3<C>(dk_acc, ah, al, Qt + 4 * T);
    }
    // this warp is done with the stage (its tiles, lse and delta)
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  // every row < sk is written, the zero rows of a skipped tile included
  const size_t base = (size_t)blockIdx.x * sk * d;
  store_rows<C::DP>(dk + base, dk_acc, key0 + g, sk, d);
  store_rows<C::DP>(dv + base, dv_acc, key0 + g, sk, d);
}

// ---- dq: grid (bh, ceil(sq / BQ)) ------------------------------------------

template <typename T, int DP, int NC>
__global__ void __launch_bounds__(Bwd<DP, NC>::THREADS, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ Maps maps,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const float* __restrict__ lens,
                             T* __restrict__ dq, int sq, int sk, int d,
                             float scale, int causal) {
  if constexpr (flash::is_f32<T>) {
    dq_f32<NC>(maps, lse, delta, lens, dq, sq, sk, d, scale, causal);
  } else {
    using C = Bwd<DP, NC>;
    constexpr int BQ = C::BO, BK = C::BW;
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    unsigned char* Qs = aligned_smem(smem_raw);
    unsigned char* dOs = Qs + C::OWN_BYTES;
    unsigned char* KV = dOs + C::OWN_BYTES;  // [STAGES][K, V]
    uint64_t* full = bars(Qs, C::BARS_AT);
    uint64_t* empty = full + C::STAGES;
    uint64_t* own = empty + C::STAGES;

    const int bh = blockIdx.x;
    // query blocks last-first: the long causal rows start early
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
    const float len = lens ? lens[bh] : (float)sk;
    int n = (sk + BK - 1) / BK;
    if (causal) n = min(n, (min(q0 + BQ, sq) - 1 + (sk - sq)) / BK + 1);
    if (lens) n = min(n, (int)ceilf(len / BK));

    if (threadIdx.x == 0) {
      for (int s = 0; s < C::STAGES; ++s) {
        mbar_init(&full[s], 1);        // the TMA thread's arrival
        mbar_init(&empty[s], 4 * NC);  // a warp of each consumer
      }
      mbar_init(own, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == NC) {
      // ---- producer warpgroup: one thread issues the TMA loads
      if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
      if (threadIdx.x == 128 * NC) {
        mbar_expect_tx(own, 2 * C::OWN_BYTES);
#pragma unroll
        for (int a = 0; a < DP / 64; ++a) {
          tma_load(Qs + a * BQ * 128, &maps.q, own, a * 64, q0, bh);
          tma_load(dOs + a * BQ * 128, &maps.dout, own, a * 64, q0, bh);
        }
        for (int j = 0; j < n; ++j) {
          const int s = j % C::STAGES;
          mbar_wait(&empty[s], ((j / C::STAGES) & 1) ^ 1);
          unsigned char* st = KV + s * C::STAGE_BYTES;
          mbar_expect_tx(&full[s], C::STAGE_BYTES);
#pragma unroll
          for (int a = 0; a < DP / 64; ++a) {
            tma_load(st + a * BK * 128, &maps.k, &full[s], a * 64, j * BK, bh);
            tma_load(st + C::T_BYTES + a * BK * 128, &maps.v, &full[s], a * 64,
                     j * BK, bh);
          }
        }
      }
      return;
    }

    // ---- consumer warpgroup wg: query rows q0 + 64 wg on
    if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int wrow0 = q0 + 64 * wg, row0 = wrow0 + 16 * warp;
    const bool live = wrow0 < sq;
    // the last key position any row of this warpgroup may see
    const int last_key = causal ? min(wrow0 + 64, sq) - 1 + (sk - sq) : sk - 1;
    const unsigned char* Qw = Qs + wg * 64 * 128;
    const unsigned char* dOw = dOs + wg * 64 * 128;
    // rows g and g + 8: lse in base 2 and delta (0 past sq, where p is
    // masked)
    float lse2[2], dlt[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + g + 8 * h;
      lse2[h] = row < sq ? lse[(size_t)bh * sq + row] * flash::LOG2E : 0.f;
      dlt[h] = row < sq ? delta[(size_t)bh * sq + row] : 0.f;
    }
    const float scale2 = scale * flash::LOG2E;
    if (live) mbar_wait(own, 0);

    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    for (int j = 0; j < n; ++j) {
      const int s = j % C::STAGES;
      mbar_wait(&full[s], (j / C::STAGES) & 1);
      const unsigned char* Kt = KV + s * C::STAGE_BYTES;
      const unsigned char* Vt = Kt + C::T_BYTES;
      const int k0 = j * BK;
      if (live && k0 <= last_key) {
        float sc[32], dp[32];
        fence_regs(sc);
        fence_regs(dp);
        wg_fence();
        abt<DP, NC>(sc, Qw, Kt);
        abt<DP, NC>(dp, dOw, Vt);
        wg_commit();
        wg_wait();
        fence_regs(sc);
        fence_regs(dp);
        dq_p_ds<BK>(sc, dp, lse2, dlt, row0, k0, g, t, sq, sk, causal, lens,
                    len, scale, scale2);
        uint32_t a[4][4];
        pack(a, dp);
        fence_regs(a);
        fence_regs(acc);
        wg_fence();
        pb<DP>(acc, a, Kt);
        wg_commit();
        wg_wait();
        fence_regs(a);
        fence_regs(acc);
      }
      // this warp is done with the stage: the producer may refill it
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    if (live)
      store_rows<DP>(dq + (size_t)bh * sq * d, acc, row0 + g, sq, d);
  }
}

// ---- dk/dv: grid (bh, ceil(sk / BK)) ---------------------------------------

template <typename T, int DP, int NC>
__global__ void __launch_bounds__(Tiles<T, DP, NC, true>::THREADS, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ Maps maps,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              const float* __restrict__ lens,
                              T* __restrict__ dk, T* __restrict__ dv, int sq,
                              int sk, int d, float scale, int causal) {
  if constexpr (flash::is_f32<T>) {
    dkv_f32(maps, lse, delta, lens, dk, dv, sq, sk, d, scale, causal);
  } else {
    using C = Bwd<DP, NC>;
    constexpr int BK = C::BO, BQ = C::BW;
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    unsigned char* Ks = aligned_smem(smem_raw);
    unsigned char* Vs = Ks + C::OWN_BYTES;
    unsigned char* QD = Vs + C::OWN_BYTES;  // [STAGES][Q, dO]
    // [STAGES][lse * log2 e of BQ rows, delta of BQ rows]
    float* stats = reinterpret_cast<float*>(Ks + C::STATS_AT);
    uint64_t* full = bars(Ks, C::BARS_AT);
    uint64_t* empty = full + C::STAGES;
    uint64_t* own = empty + C::STAGES;

    const int bh = blockIdx.x, k0 = blockIdx.y * BK;
    const float len = lens ? lens[bh] : (float)sk;
    // first query tile whose last row reaches this key tile causally
    const int start = causal ? max(0, (k0 - (sk - sq)) / BQ) : 0;
    int end = (sq + BQ - 1) / BQ;
    if (lens && (float)k0 >= len) end = start;  // dk = dv = 0, no walk
    const int n = end - start;

    if (threadIdx.x == 0) {
      for (int s = 0; s < C::STAGES; ++s) {
        // the producer's first warp (lse and delta) and its TMA thread's
        // transaction count
        mbar_init(&full[s], 33);
        mbar_init(&empty[s], 4 * NC);
      }
      mbar_init(own, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == NC) {
      // ---- producer warpgroup: its first warp fills the stages, lane 0
      // issuing the TMA loads
      if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
      const int pt = threadIdx.x - 128 * NC;
      if (pt < 32) {
        if (pt == 0 && n > 0) {
          mbar_expect_tx(own, 2 * C::OWN_BYTES);
#pragma unroll
          for (int a = 0; a < DP / 64; ++a) {
            tma_load(Ks + a * BK * 128, &maps.k, own, a * 64, k0, bh);
            tma_load(Vs + a * BK * 128, &maps.v, own, a * 64, k0, bh);
          }
        }
        for (int i = 0; i < n; ++i) {
          const int s = i % C::STAGES, qr0 = (start + i) * BQ;
          mbar_wait(&empty[s], ((i / C::STAGES) & 1) ^ 1);
          float* L = stats + s * 2 * BQ;
          for (int r = pt; r < BQ; r += 32) {
            const int row = qr0 + r;
            const bool in = row < sq;
            L[r] = in ? lse[(size_t)bh * sq + row] * flash::LOG2E : 0.f;
            L[BQ + r] = in ? delta[(size_t)bh * sq + row] : 0.f;
          }
          if (pt == 0) {
            unsigned char* st = QD + s * C::STAGE_BYTES;
            mbar_expect_tx(&full[s], C::STAGE_BYTES);
#pragma unroll
            for (int a = 0; a < DP / 64; ++a) {
              tma_load(st + a * BQ * 128, &maps.q, &full[s], a * 64, qr0, bh);
              tma_load(st + C::T_BYTES + a * BQ * 128, &maps.dout, &full[s],
                       a * 64, qr0, bh);
            }
          }
          mbar_arrive(&full[s]);
        }
      }
      return;
    }

    // ---- consumer warpgroup wg: keys k0 + 64 wg on
    if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int wk0 = k0 + 64 * wg, key0 = wk0 + 16 * warp;
    // keys at or past every length get dk = dv = 0 without products
    const bool live = wk0 < sk && !(lens && (float)wk0 >= len);
    const unsigned char* Kw = Ks + wg * 64 * 128;
    const unsigned char* Vw = Vs + wg * 64 * 128;
    const float scale2 = scale * flash::LOG2E;
    if (live && n > 0) mbar_wait(own, 0);

    float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    for (int i = 0; i < n; ++i) {
      const int s = i % C::STAGES;
      mbar_wait(&full[s], (i / C::STAGES) & 1);
      const unsigned char* Qt = QD + s * C::STAGE_BYTES;
      const unsigned char* dOt = Qt + C::T_BYTES;
      const float* L = stats + s * 2 * BQ;
      const float* D = L + BQ;
      const int q0 = (start + i) * BQ;
      // the tile's last row reaches this warpgroup's keys causally
      if (live && (!causal || min(q0 + BQ, sq) - 1 + (sk - sq) >= wk0)) {
        float st[32], dpt[32];
        fence_regs(st);
        fence_regs(dpt);
        wg_fence();
        abt<DP, NC>(st, Kw, Qt);
        abt<DP, NC>(dpt, Vw, dOt);
        wg_commit();
        wg_wait();
        fence_regs(st);
        fence_regs(dpt);
        dkv_p_ds<BQ>(st, dpt, L, D, q0, key0, g, t, sq, sk, causal, lens, len,
                     scale, scale2);
        uint32_t ap[4][4], ads[4][4];
        pack(ap, st);
        pack(ads, dpt);
        fence_regs(ap);
        fence_regs(ads);
        fence_regs(dk_acc);
        fence_regs(dv_acc);
        wg_fence();
        pb<DP>(dv_acc, ap, dOt);
        pb<DP>(dk_acc, ads, Qt);
        wg_commit();
        wg_wait();
        fence_regs(ap);
        fence_regs(ads);
        fence_regs(dk_acc);
        fence_regs(dv_acc);
      }
      // this warp is done with the stage (its tiles, lse and delta)
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // every row < sk is written, the zero rows of a skipped tile included
    const size_t base = (size_t)blockIdx.x * sk * d;
    store_rows<DP>(dk + base, dk_acc, key0 + g, sk, d);
    store_rows<DP>(dv + base, dv_acc, key0 + g, sk, d);
  }
}

// ---- host side --------------------------------------------------------------

using bf16 = __nv_bfloat16;

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *lens;
  void *out0, *out1;
  int bh, sq, sk, d;
  float scale;
  int causal;
  cudaStream_t stream;
};

// at d <= 64, two consumer warpgroups where the blocks of 128 own rows
// fill the SMs (at d = 128 two would not keep their sums in registers)
bool two_consumers(int bh, int own_rows) {
  return (size_t)bh * ((own_rows + 127) / 128) >= (size_t)sm_count();
}

// the maps of q, k, v and do: boxes of one swizzle atom's columns (64 bf16
// or 32 f32), of the own tile's rows (64 * nc) for the own tensors and of
// the walked tile's rows for the walked ones
cudaError_t encode_maps(Maps* m, const Args& a, int q_rows, int kv_rows,
                        bool f32) {
  const int at = f32 ? 32 : 64;
  cudaError_t err = encode(&m->q, f32, a.q, a.d, a.sq, a.bh, at, q_rows);
  if (err == cudaSuccess)
    err = encode(&m->dout, f32, a.dout, a.d, a.sq, a.bh, at, q_rows);
  if (err == cudaSuccess)
    err = encode(&m->k, f32, a.k, a.d, a.sk, a.bh, at, kv_rows);
  if (err == cudaSuccess)
    err = encode(&m->v, f32, a.v, a.d, a.sk, a.bh, at, kv_rows);
  return err;
}

template <typename T, int DP, int NC>
cudaError_t launch_dq(const Args& a) {
  using C = Tiles<T, DP, NC, false>;
  Maps maps;
  cudaError_t err =
      encode_maps(&maps, a, C::BO, C::BW, flash::is_f32<T>);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_sm90_kernel<T, DP, NC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.sq + C::BO - 1) / C::BO);
  flash_bwd_dq_sm90_kernel<T, DP, NC><<<grid, C::THREADS, C::SMEM,
                                        a.stream>>>(
      maps, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const float*>(a.lens),
      static_cast<T*>(a.out0), a.sq, a.sk, a.d, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int DP, int NC>
cudaError_t launch_dkv(const Args& a) {
  using C = Tiles<T, DP, NC, true>;
  Maps maps;
  cudaError_t err =
      encode_maps(&maps, a, C::BW, C::BO, flash::is_f32<T>);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_sm90_kernel<T, DP, NC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.sk + C::BO - 1) / C::BO);
  flash_bwd_dkv_sm90_kernel<T, DP, NC><<<grid, C::THREADS, C::SMEM,
                                         a.stream>>>(
      maps, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const float*>(a.lens),
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.sq, a.sk, a.d,
      a.scale, a.causal);
  return cudaGetLastError();
}

// what the kernels take: bf16 with d a multiple of 8 up to 128, or f32
// with d a multiple of 4 up to 64 (shared memory holds no f32 stage past
// that); 16-byte aligned tensors (TMA's rows and bases), grid rows in
// range
bool refused(const Args& a, int dtype) {
  const bool f32 = dtype == 0;
  return (dtype != 0 && dtype != 1) || a.bh < 1 || a.sq < 1 || a.sk < 1 ||
         a.d < 1 || a.d > (f32 ? 64 : 128) || a.d % (f32 ? 4 : 8) ||
         a.sq > 65535 * 64 || a.sk > 65535 * 64 || !aligned16(a.q) ||
         !aligned16(a.k) || !aligned16(a.v) || !aligned16(a.dout);
}

}  // namespace

// dtype: 0 = float32 (d a multiple of 4 up to 64), 1 = bfloat16 (d a
// multiple of 8 up to 128).  q/dout (bh, sq, d), k/v (bh, sk, d)
// contiguous at that dtype, 16-byte aligned; lse and delta (bh, sq) f32;
// lens (bh,) f32 or null.  Writes dq (bh, sq, d) at the input dtype.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* lens,
                                 void* dq, int bh, int sq, int sk, int d,
                                 float scale, int causal, int dtype,
                                 void* stream) {
  const Args a{q,  k,  v,  dout, lse,   delta,  lens,
               dq, nullptr, bh, sq, sk, d, scale, causal,
               static_cast<cudaStream_t>(stream)};
  if (refused(a, dtype)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return two_consumers(bh, sq) ? (int)launch_dq<float, 64, 2>(a)
                                 : (int)launch_dq<float, 64, 1>(a);
  if (d > 64) return (int)launch_dq<bf16, 128, 1>(a);
  return two_consumers(bh, sq) ? (int)launch_dq<bf16, 64, 2>(a)
                               : (int)launch_dq<bf16, 64, 1>(a);
}

// As flash_bwd_dq_sm90; writes dk and dv (bh, sk, d) at the input dtype,
// every row (zeros past `lens`).
extern "C" int flash_bwd_dkv_sm90(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  const void* lens, void* dk, void* dv,
                                  int bh, int sq, int sk, int d, float scale,
                                  int causal, int dtype, void* stream) {
  const Args a{q,  k,  v,  dout, lse, delta, lens,
               dk, dv, bh, sq, sk, d,   scale, causal,
               static_cast<cudaStream_t>(stream)};
  if (refused(a, dtype)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch_dkv<float, 64, 1>(a);
  if (d > 64) return (int)launch_dkv<bf16, 128, 1>(a);
  return two_consumers(bh, sk) ? (int)launch_dkv<bf16, 64, 2>(a)
                               : (int)launch_dkv<bf16, 64, 1>(a);
}
