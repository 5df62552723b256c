// Flash-attention forward redesigned for Hopper (sm_90a): TMA ring,
// warp-specialised wgmma; f32 and bf16 inputs.
//
// Replaces the Pallas TPU kernel `_flash_fwd_kernel`
// (analytics_zoo_tpu/ops/attention.py:149, launched by `_flash_fwd_call`)
// for every shape that TMA and wgmma take: rows of 16-byte multiples,
// 16-byte-aligned bases, head dim up to 128 (ops/_kernels.py
// `fwd_design`).  flash_fwd.cu, the mma.sync design, takes the rest.  It
// computes exactly what flash_fwd.cu states: for each (batch*head, query
// row) an online softmax over key tiles (running max m, denominator l,
// f32 accumulator), then
//   o   = acc / max(l, 1e-30)       at the input dtype, (bh, sq, d)
//   lse = m + log(max(l, 1e-30))    in f32,              (bh, sq)
// with the finite sentinel NEG_INF = -1e30, causal alignment q_pos = i +
// (sk - sq), per-(batch*head) valid key counts `lens` (f32, clamped to
// [1, sk] by the caller), the key tiles past the causal diagonal and past
// ceil(len / BK) not visited, bf16 p rounded before the p.v product and
// l summing the unrounded p.
//
// What bounds it on the H100: operations.  Two products per valid (query,
// key) pair, 2*d FLOP each: at (96, 2048, 64) causal 51 GFLOP against
// ~0.1 GB of q, k, v and o.  bf16 runs both products at 989 TFLOP/s, 0.05
// ms (0.026 ms at 48 heads); f32 runs them as 3xTF32 (three TF32 products
// each, within ~2^-20 of an f32 product; one TF32 pass would miss the f32
// tolerances) at 495 TFLOP/s, 0.31 ms.
//
// Design:
// - A block is one producer warpgroup and one or two consumer warpgroups
//   of 64 query rows each (BQ = 64 or 128; two where bh * ceil(sq / 128)
//   blocks fill the SMs, one at the serving shapes, whose few heads and
//   short prompts would leave most SMs idle).  One thread of the producer
//   issues TMA loads: the Q tile once, then K and V tiles into a ring of
//   stages (three at bf16, two at f32), each with a full and an empty
//   mbarrier.  Tensor maps go by value as __grid_constant__ kernel
//   parameters; the encoder is taken from the driver through
//   cudaGetDriverEntryPoint (the library is not linked against libcuda).
//   TMA's zero fill past the last row and past d replaces the edge
//   masking of the loads.  setmaxnreg moves registers from the producer
//   to two consumers (40 and 232); ptxas still fits the consumers in the
//   launch bound's 168, so the walk is not software-pipelined (S of one
//   tile issued beside P.V of the last), which needs more and spilled.
// - Tiles lie in shared memory as 128-byte swizzled atoms (8 rows of 128
//   bytes, 1024-byte aligned), the layout wgmma's descriptors read: Q and
//   K K-major (the head dim along the row; d = 64 is one atom at bf16, two
//   32-column atoms at f32), so S = Q.K^T is a shared-by-shared wgmma.
//   The online softmax runs on S's accumulator fragments, which hold rows
//   g and g + 8 of a warp's 16 (a row max is a reduction over the 4 lanes
//   of a quad).  O += P.V takes P from registers.
// - bf16: P's fragments, packed to bf16, are the A operand as they stand;
//   V is read MN-major (transposed by the descriptor, as 16-bit types
//   allow).
// - f32: TF32 wgmma takes its shared-memory operands K-major only, and V
//   is not K-major for P.V; 3xTF32 also wants K's hi and lo parts there.
//   So TMA lands the raw K and V tiles in a buffer of their own, and the
//   producer warpgroup's other three warps (idle otherwise) turn each
//   into a stage: K's TF32 hi and lo parts, and V transposed, hi and lo,
//   with each group of 8 keys in the order 0 2 4 6 1 3 5 7 (P's A
//   fragment holds columns t and t + 4 where S's accumulator holds 2t and
//   2t + 1, so P goes to the tensor core without moving between lanes);
//   the stage's full barrier counts their arrivals.  Each query block
//   redoes the conversion of the tiles it walks; a copy made once a call
//   by a second kernel cost its launch, scratch of twice K and V, and
//   more time on the card.  Q is split once in shared memory.  S's two cross
//   terms are summed apart from hi.hi and added once (as flash_mma.cuh's
//   mma_abt_ldsm), which keeps the lse within 1e-5.
// - The softmax, not the tensor cores, is most of a tile's time at d = 64:
//   the mask is evaluated only on tiles that cross a causal, length or
//   sequence edge, the rows' max and sum are trees (two warps share a
//   scheduler, too few to hide chains of dependent operations), and the
//   scale is folded into the exponent's FMA.
// - Each tile's P.V goes into a fresh accumulator (scale-d 0) and is added
//   to O with rounded f32 adds, O = O * corr + PV: the tensor core cuts
//   every sum it writes back towards zero, and summed into O over a long
//   walk those cuts bias it (flash_mma.cuh's mma_pb).
// - No split over keys: each output row is summed by one warp in one
//   order, so two launches give the same bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr float NEG_INF = -1e30f;

// ---- wgmma forms only the forward takes ------------------------------------

// wgmma.mma_async m64n128k16 (bf16), f32 accumulators, as sm90.cuh's
// bf16 forms: ss takes A and B from shared memory.  The operand lists are
// written out.
__device__ __forceinline__ void wgmma_ss_bf16_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---- the forward ------------------------------------------------------------

// tensor maps of the call's q, k and v
struct Maps {
  CUtensorMap q, k, v;
};

template <typename T, int DP, int NC>
struct Sm90 {
  static constexpr bool F32 = flash::is_f32<T>;
  static constexpr int ES = sizeof(T);
  static constexpr int BQ = 64 * NC;  // query rows: 64 a consumer
  // keys a stage (chosen for the registers and shared memory a block has)
  static constexpr int BK = F32 ? (DP > 64 ? 32 : 64) : (DP > 64 ? 64 : 128);
  // ring stages: three where shared memory holds them
  static constexpr int STAGES = F32 ? 2 : 3;
  static constexpr int AT = 128 / ES;       // columns of a swizzle atom
  static constexpr int DATOMS = DP / AT;    // atoms across the head dim
  static constexpr int KSTEPS = DP / (32 / ES);  // 32-byte MMA depths
  static constexpr int Q_BYTES = BQ * DP * ES;
  static constexpr int T_BYTES = BK * DP * ES;      // one K or V tile
  static constexpr int Q_TILES = F32 ? 2 : 1;       // f32: hi and lo
  static constexpr int KV_TILES = F32 ? 4 : 2;      // f32: K, K lo, V^T, V^T lo
  static constexpr int STAGE_BYTES = KV_TILES * T_BYTES;
  // f32: the raw K and V tiles TMA lands, which the converting warps turn
  // into a stage
  static constexpr int RAW_BYTES = F32 ? 2 * T_BYTES : 0;
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr size_t SMEM = 1024 + (size_t)Q_TILES * Q_BYTES +
                                 (size_t)STAGES * STAGE_BYTES + RAW_BYTES +
                                 (2 * STAGES + 3) * sizeof(uint64_t);
};

// S = Q.K^T over the padded head dim (columns past d are TMA's zeros;
// a depth loop that stopped at d would branch between the wgmmas, which
// serialises them): Q's 64 rows of this warpgroup at Qw (atom a at a * BQ
// * 128), K's tile at Kt (atom a at a * BK * 128).  f32: hi.hi into s,
// the cross terms (Q lo Q_BYTES after Qw, K lo T_BYTES after Kt) into sx.
template <typename T, int DP, int NC>
__device__ __forceinline__ void qk(float (&s)[Sm90<T, DP, NC>::BK / 2],
                                   float (&sx)[Sm90<T, DP, NC>::BK / 2],
                                   const unsigned char* Qw,
                                   const unsigned char* Kt) {
  using C = Sm90<T, DP, NC>;
#pragma unroll
  for (int ks = 0; ks < C::KSTEPS; ++ks) {
    const uint64_t da = sw128(Qw + (ks / 4) * C::BQ * 128 + (ks % 4) * 32);
    const uint64_t db = sw128(Kt + (ks / 4) * C::BK * 128 + (ks % 4) * 32);
    if constexpr (C::F32) {
      const uint64_t dal = da + (C::Q_BYTES >> 4);
      const uint64_t dbl = db + (C::T_BYTES >> 4);
      if constexpr (C::BK == 64) {
        wgmma_ss_tf32_n64(s, da, db, ks > 0);
        wgmma_ss_tf32_n64(sx, dal, db, ks > 0);
        wgmma_ss_tf32_n64(sx, da, dbl, 1);
      } else {
        wgmma_ss_tf32_n32(s, da, db, ks > 0);
        wgmma_ss_tf32_n32(sx, dal, db, ks > 0);
        wgmma_ss_tf32_n32(sx, da, dbl, 1);
      }
    } else if constexpr (C::BK == 128) {
      wgmma_ss_bf16_n128(s, da, db, ks > 0);
    } else {
      wgmma_ss_bf16_n64(s, da, db, ks > 0);
    }
  }
}

// pv = P.V for one tile, issued and waited for.  P is the softmax's tile
// in S's accumulator layout; V's tile at Vt (bf16: keys along the rows,
// atom a of the head dim at a * BK * 128; f32: the transposed hi tile,
// atom a of keys at a * DP * 128, its lo tile T_BYTES after).
template <typename T, int DP, int NC>
__device__ __forceinline__ void pv_product(
    float (&pv)[DP / 2], const float (&p)[Sm90<T, DP, NC>::BK / 2],
    const unsigned char* Vt) {
  using C = Sm90<T, DP, NC>;
  constexpr int BK = C::BK;
  if constexpr (C::F32) {
    // A fragment of depth kb: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
    // a3 (g + 8, t + 4) take S's (g, 2t), (g + 8, 2t), (g, 2t + 1),
    // (g + 8, 2t + 1): the keys the transposed copy put at those columns
    uint32_t ah[BK / 8][4], al[BK / 8][4];
#pragma unroll
    for (int kb = 0; kb < BK / 8; ++kb) {
      flash::split(p[4 * kb + 0], ah[kb][0], al[kb][0]);
      flash::split(p[4 * kb + 2], ah[kb][1], al[kb][1]);
      flash::split(p[4 * kb + 1], ah[kb][2], al[kb][2]);
      flash::split(p[4 * kb + 3], ah[kb][3], al[kb][3]);
    }
    fence_regs(ah);
    fence_regs(al);
    fence_regs(pv);
    wg_fence();
#pragma unroll
    for (int kb = 0; kb < BK / 8; ++kb) {
      const uint64_t dv = sw128(Vt + (kb / 4) * DP * 128 + (kb % 4) * 32);
      const uint64_t dvl = dv + (C::T_BYTES >> 4);
      if constexpr (DP == 64) {
        wgmma_rs_tf32_n64(pv, al[kb], dv, kb > 0);
        wgmma_rs_tf32_n64(pv, ah[kb], dvl, 1);
        wgmma_rs_tf32_n64(pv, ah[kb], dv, 1);
      } else {
        wgmma_rs_tf32_n128(pv, al[kb], dv, kb > 0);
        wgmma_rs_tf32_n128(pv, ah[kb], dvl, 1);
        wgmma_rs_tf32_n128(pv, ah[kb], dv, 1);
      }
    }
    wg_commit();
    wg_wait();
    fence_regs(ah);
    fence_regs(al);
  } else {
    // the fragments of 8-key chunks 2kb and 2kb + 1, packed to bf16 (the
    // rounding of p), are the A fragment of depth kb as they stand
    uint32_t a[BK / 16][4];
#pragma unroll
    for (int kb = 0; kb < BK / 16; ++kb)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[kb][r] = flash::pack_bf16(p[8 * kb + 2 * r], p[8 * kb + 2 * r + 1]);
    fence_regs(a);
    fence_regs(pv);
    wg_fence();
#pragma unroll
    for (int kb = 0; kb < BK / 16; ++kb)
#pragma unroll
      for (int at = 0; at < DP / 64; ++at)
        wgmma_rs_bf16_n64(*reinterpret_cast<float(*)[32]>(pv + 32 * at),
                          a[kb], sw128(Vt + at * BK * 128 + kb * 2048),
                          kb > 0);
    wg_commit();
    wg_wait();
    fence_regs(a);
  }
  fence_regs(pv);
}

// r[0] = op over r[0 .. 2W), pairing halves: a tree, every index known
// at compile time (a loop halving a runtime width would put r in local
// memory)
template <int W, int N, typename Op>
__device__ __forceinline__ void tree(float (&r)[N], Op op) {
  if constexpr (W >= 1) {
#pragma unroll
    for (int j = 0; j < W; ++j) r[j] = op(r[j], r[j + W]);
    tree<W / 2>(r, op);
  }
}

// op over this lane's entries of row half h (rows g and g + 8) of an
// S-layout tile
template <int BK, typename Op>
__device__ __forceinline__ float row_tree(const float (&v)[BK / 2], int h,
                                          Op op) {
  float r[BK / 4];
#pragma unroll
  for (int j = 0; j < BK / 4; ++j) r[j] = v[4 * (j / 2) + 2 * h + (j & 1)];
  tree<BK / 8>(r, op);
  return r[0];
}

template <typename T, int DP, int NC>
__global__ void __launch_bounds__(Sm90<T, DP, NC>::THREADS, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ Maps maps,
                          const float* __restrict__ lens, T* __restrict__ o,
                          float* __restrict__ lse, int sq, int sk, int d,
                          float scale, int causal) {
  using C = Sm90<T, DP, NC>;
  constexpr int BQ = C::BQ, BK = C::BK;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // tiles on 1024-byte boundaries, where the swizzle's pattern starts
  unsigned char* Qs =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* KV = Qs + C::Q_TILES * C::Q_BYTES;  // [STAGES][KV_TILES]
  unsigned char* raw = KV + C::STAGES * C::STAGE_BYTES;  // f32: K, V
  uint64_t* full = reinterpret_cast<uint64_t*>(raw + C::RAW_BYTES);
  uint64_t* empty = full + C::STAGES;
  uint64_t* qbar = empty + C::STAGES;
  uint64_t* raw_full = qbar + 1;  // f32 only
  uint64_t* raw_empty = raw_full + 1;

  const int bh = blockIdx.x;
  // query blocks last-first: the long causal rows start early
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const float len = lens ? lens[bh] : (float)sk;
  int n = (sk + BK - 1) / BK;
  if (causal) n = min(n, (min(q0 + BQ, sq) - 1 + (sk - sq)) / BK + 1);
  if (lens) n = min(n, (int)ceilf(len / BK));

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      // bf16: the TMA thread's arrival; f32: the converting threads'
      mbar_init(&full[s], C::F32 ? CONVERTERS : 1);
      mbar_init(&empty[s], 4 * NC);  // a warp of each consumer
    }
    mbar_init(qbar, 1);
    mbar_init(raw_full, 1);
    mbar_init(raw_empty, CONVERTERS);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NC) {
    // ---- producer warpgroup: one thread issues the TMA loads; at f32
    // its last three warps convert each raw K/V tile into a stage
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    const int pt = threadIdx.x - 128 * NC;
    if (pt == 0) {
      mbar_expect_tx(qbar, C::Q_BYTES);
#pragma unroll
      for (int a = 0; a < C::DATOMS; ++a)
        tma_load(Qs + a * BQ * 128, &maps.q, qbar, a * C::AT, q0, bh);
      for (int j = 0; j < n; ++j) {
        const int k0 = j * BK;
        if constexpr (C::F32) {
          mbar_wait(raw_empty, (j & 1) ^ 1);
          mbar_expect_tx(raw_full, C::RAW_BYTES);
#pragma unroll
          for (int a = 0; a < C::DATOMS; ++a) {
            tma_load(raw + a * BK * 128, &maps.k, raw_full, a * C::AT, k0,
                     bh);
            tma_load(raw + C::T_BYTES + a * BK * 128, &maps.v, raw_full,
                     a * C::AT, k0, bh);
          }
        } else {
          const int s = j % C::STAGES;
          mbar_wait(&empty[s], ((j / C::STAGES) & 1) ^ 1);
          unsigned char* st = KV + s * C::STAGE_BYTES;
          mbar_expect_tx(&full[s], C::STAGE_BYTES);
#pragma unroll
          for (int a = 0; a < C::DATOMS; ++a) {
            tma_load(st + a * BK * 128, &maps.k, &full[s], a * C::AT, k0,
                     bh);
            tma_load(st + C::T_BYTES + a * BK * 128, &maps.v, &full[s],
                     a * C::AT, k0, bh);
          }
        }
      }
    } else if constexpr (C::F32) {
      if (pt >= 32) {
        const int ct = pt - 32;  // of CONVERTERS
        for (int j = 0; j < n; ++j) {
          const int s = j % C::STAGES;
          mbar_wait(raw_full, j & 1);
          mbar_wait(&empty[s], ((j / C::STAGES) & 1) ^ 1);
          convert_tile<DP, C::BK>(KV + s * C::STAGE_BYTES, raw, ct);
          // the stage's writes, made visible to the tensor core's reads
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          mbar_arrive(raw_empty);
          mbar_arrive(&full[s]);
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
  unsigned char* Qw = Qs + wg * 64 * 128;
  if (live) {
    mbar_wait(qbar, 0);
    if constexpr (C::F32) {
      // split this warpgroup's rows in place into their TF32 hi parts,
      // the lo parts to the tile after (an elementwise map keeps the
      // swizzle), then make the writes visible to the tensor core
#pragma unroll
      for (int a = 0; a < C::DATOMS; ++a)
        for (int i = tid; i < 64 * 128 / 16; i += 128) {
          uint4* hi = reinterpret_cast<uint4*>(Qw + a * BQ * 128) + i;
          uint4 x = *hi, lo;
          flash::split(__uint_as_float(x.x), x.x, lo.x);
          flash::split(__uint_as_float(x.y), x.y, lo.y);
          flash::split(__uint_as_float(x.z), x.z, lo.z);
          flash::split(__uint_as_float(x.w), x.w, lo.w);
          *hi = x;
          *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(hi) +
                                    C::Q_BYTES) = lo;
        }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      warpgroup_sync(1 + wg);
    }
  }

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  // rows g and g + 8: running max and this lane's part of the row sums.
  // A row past sq starts at m = 0, so that its p = 2^(NEG_INF) = 0 and no
  // infinity arises in it; every other row's m is finite after its first
  // tile, which holds key 0.
  float m[2], l[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) m[h] = row0 + g + 8 * h < sq ? NEG_INF : 0.f;

  for (int j = 0; j < n; ++j) {
    const int s = j % C::STAGES;
    mbar_wait(&full[s], (j / C::STAGES) & 1);
    const unsigned char* st = KV + s * C::STAGE_BYTES;
    const int k0 = j * BK;
    const bool work = live && k0 <= last_key;
    float corr[2] = {1.f, 1.f};
    float pv[DP / 2];
    if (work) {
      float sc[BK / 2], sx[BK / 2];
      fence_regs(sc);
      if constexpr (C::F32) fence_regs(sx);
      wg_fence();
      qk<T, DP, NC>(sc, sx, Qw, st);
      wg_commit();
      wg_wait();
      fence_regs(sc);
      if constexpr (C::F32) {
        fence_regs(sx);
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] += sx[i];
      }
      // p = 2^(s * scale * log2 e - m * log2 e), m the rows' max of s *
      // scale (scale > 0: the max of the unscaled scores, scaled, is that
      // max exactly); masked pairs get s = NEG_INF, so p = 0
      if (!flash::tile_unmasked(row0, 16, k0, BK, sq, sk, causal, lens,
                                len)) {
#pragma unroll
        for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!flash::pair_valid(row0 + g + 8 * (e >> 1),
                                   k0 + 8 * jj + 2 * t + (e & 1), sq, sk,
                                   causal, lens, len))
              sc[4 * jj + e] = NEG_INF;
      }
      const auto max_op = [](float a, float b) { return fmaxf(a, b); };
      const auto sum_op = [](float a, float b) { return a + b; };
      float m2[2];  // the new max in base 2
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mx = fmaxf(
            m[h], flash::quad_max(row_tree<BK>(sc, h, max_op)) * scale);
        corr[h] = flash::exp2_ftz((m[h] - mx) * flash::LOG2E);
        m[h] = mx;
        m2[h] = mx * flash::LOG2E;
      }
      const float scale2 = scale * flash::LOG2E;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        sc[i] = flash::exp2_ftz(fmaf(sc[i], scale2, -m2[(i >> 1) & 1]));
#pragma unroll
      for (int h = 0; h < 2; ++h)
        l[h] = fmaf(l[h], corr[h], row_tree<BK>(sc, h, sum_op));
      pv_product<T, DP, NC>(pv, sc, st + (C::F32 ? 2 : 1) * C::T_BYTES);
    }
    // this warp is done with the stage: the producer may refill it
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (work) {
#pragma unroll
      for (int i = 0; i < DP / 2; ++i)
        acc[i] = fmaf(acc[i], corr[(i >> 1) & 1], pv[i]);
    }
  }
  if (!live) return;

  float l_safe[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_safe[h] = fmaxf(flash::quad_sum(l[h]), 1e-30f);
    const int row = row0 + g + 8 * h;
    if (t == 0 && row < sq)
      lse[(size_t)bh * sq + row] = m[h] + logf(l_safe[h]);
  }
  T* ob = o + (size_t)bh * sq * d;
#pragma unroll
  for (int jn = 0; jn < DP / 8; ++jn) {
    const int col = 8 * jn + 2 * t;  // d is even: a pair is in or out
    if (col >= d) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + g + 8 * h;
      if (row < sq)
        store2(ob + (size_t)row * d + col, acc[4 * jn + 2 * h] / l_safe[h],
               acc[4 * jn + 2 * h + 1] / l_safe[h]);
    }
  }
}

// ---- host side --------------------------------------------------------------

template <typename T, int DP, int NC>
cudaError_t launch(const Maps& maps, const void* lens, void* o, void* lse,
                   int bh, int sq, int sk, int d, float scale, int causal,
                   cudaStream_t stream) {
  using C = Sm90<T, DP, NC>;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<T, DP, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (sq + C::BQ - 1) / C::BQ);
  flash_fwd_sm90_kernel<T, DP, NC><<<grid, C::THREADS, C::SMEM, stream>>>(
      maps, static_cast<const float*>(lens), static_cast<T*>(o),
      static_cast<float*>(lse), sq, sk, d, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v,
                const void* lens, void* o, void* lse, int bh, int sq, int sk,
                int d, float scale, int causal, cudaStream_t stream) {
  constexpr bool F32 = flash::is_f32<T>;
  constexpr int AT = 128 / sizeof(T);
  const int dp = d <= 64 ? 64 : 128;
  // two consumers (BQ 128) where the blocks fill the SMs; f32 at DP 128
  // has shared memory for one
  const int nc = (F32 && dp > 64) || (size_t)bh * ((sq + 127) / 128) <
                                         (size_t)sm_count()
                     ? 1
                     : 2;
  const int bq = 64 * nc;
  const int bk = F32 ? (dp > 64 ? 32 : 64) : (dp > 64 ? 64 : 128);
  Maps maps;
  cudaError_t err = encode(&maps.q, F32, q, d, sq, bh, AT, bq);
  if (err == cudaSuccess) err = encode(&maps.k, F32, k, d, sk, bh, AT, bk);
  if (err == cudaSuccess) err = encode(&maps.v, F32, v, d, sk, bh, AT, bk);
  if (err != cudaSuccess) return err;
  if (dp == 64)
    return nc == 2 ? launch<T, 64, 2>(maps, lens, o, lse, bh, sq, sk, d,
                                      scale, causal, stream)
                   : launch<T, 64, 1>(maps, lens, o, lse, bh, sq, sk, d,
                                      scale, causal, stream);
  if constexpr (!F32) {
    if (nc == 2)
      return launch<T, 128, 2>(maps, lens, o, lse, bh, sq, sk, d, scale,
                               causal, stream);
  }
  return launch<T, 128, 1>(maps, lens, o, lse, bh, sq, sk, d, scale, causal,
                           stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q (bh, sq, d), k/v (bh, sk, d), o
// (bh, sq, d) contiguous at the input dtype, 16-byte aligned, rows of
// 16-byte multiples, d <= 128; lse (bh, sq) f32; lens (bh,) f32 or null.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_fwd_sm90(const void* q, const void* k, const void* v,
                              const void* lens, void* o, void* lse, int bh,
                              int sq, int sk, int d, float scale, int causal,
                              int dtype, void* stream) {
  const int es = dtype == 0 ? 4 : 2;
  if (bh < 1 || sq < 1 || sk < 1 || d < 1 || d > 128 || (d * es) % 16 ||
      sq > 65535 * 64 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(o))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run<float>(q, k, v, lens, o, lse, bh, sq, sk, d, scale,
                           causal, s);
  if (dtype == 1)
    return (int)run<__nv_bfloat16>(q, k, v, lens, o, lse, bh, sq, sk, d,
                                   scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
