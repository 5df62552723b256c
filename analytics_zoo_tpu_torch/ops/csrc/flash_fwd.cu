// Flash-attention forward for Hopper (sm_90a), f32 and bf16 inputs.
//
// Replaces the Pallas TPU kernel `_flash_fwd_kernel`
// (analytics_zoo_tpu/ops/attention.py, launched by `_flash_fwd_call`).
// Same function: for each (batch*head, query row) an online softmax over
// key tiles (running max m, denominator l, f32 accumulator), then
//   o   = acc / max(l, 1e-30)       at the input dtype, (bh, sq, d)
//   lse = m + log(max(l, 1e-30))    in f32,              (bh, sq)
// The lse is the residual the backward kernels replay the softmax from.
// Masking uses the finite sentinel NEG_INF = -1e30, causal alignment
// q_pos = i + (sk - sq), and per-(batch*head) valid key counts `lens`
// (f32, already clamped to [1, sk] by the caller).  Key tiles past the
// causal diagonal and past ceil(len / BK) are not visited, as on the TPU;
// a row's first visited tile holds key 0, which is always valid, so m is
// finite from then on.  bf16 inputs round p to bf16 before the p.v
// product, as the TPU kernel does (`p.astype(v_blk.dtype)`); l sums the
// unrounded p.
//
// What bounds it on the H100: operations.  Two products per valid (query,
// key) pair, 2*d FLOP each; at the training shape (96, 2048, 64) causal
// that is 51 GFLOP against ~0.1 GB of q, k, v and o.  f32 inputs run both
// products as 3xTF32 on the tensor cores (three TF32 MMAs a product,
// within ~2^-20 relative of an f32 product; one TF32 pass would miss the
// f32 tolerance): 3 x ops at 495 TFLOP/s, 0.31 ms.  bf16 inputs run one
// bf16 MMA a product at 989 TFLOP/s, 0.05 ms, near the bytes' 0.03 ms.
//
// Design (flash_mma.cuh holds the MMA, split, reduction and staging
// helpers):
// - Each warp owns 16 rows of the block's query tile (8 warps, 128 rows;
//   4 warps at f32 DP = 256) and computes S = Q.K^T for its rows with
//   warp-level mma.sync (m16n8k8 tf32, m16n8k16 bf16) from fragments that
//   ldmatrix loads (mma_abt_ldsm), K read as it lies (head dim along the
//   row).  The online softmax runs on the S fragments: a lane holds rows g
//   and g+8, so a row max is a reduction over the 4 lanes of a quad; l is
//   summed per lane and reduced over the quad at the end.  p stays in the
//   fragments and is the A operand of O += P.V (mma_pb); the f32
//   accumulator O stays in registers for the whole key walk, and is
//   rescaled only on tiles where a row's max moved.  Each tile's P.V is
//   summed apart and added to O with rounded adds (mma_pb says why: the
//   tensor core's cut sums would bias O over a long walk).
// - f32: Q is split once into its TF32 hi and lo parts in shared memory
//   (split_tile), so that the key walk splits only K, V and p.  Hoisting
//   Q's fragments into registers instead would take 64 registers a lane
//   at d = 64, where 128 keep 16 warps an SM in flight: like the
//   backward, the kernel is held back by latency more than by the tensor
//   cores.  S's two small cross terms are summed apart from hi.hi (see
//   mma_abt_ldsm), which keeps the lse within 1e-5 up to d = 256.
// - Q is staged once, and K and V tiles go through a two-stage ring, by
//   16-byte cp.async with one barrier a tile: tile j+1 loads while tile j
//   computes.  Rows past the end are zero-filled by the copy; the head dim
//   is zero-padded in shared memory up to the template width DP (32, 64,
//   128 or 256), and only ceil(d / depth) MMA depths and ceil(d / 8)
//   output column tiles run.  A head dim whose rows are not 16-byte
//   multiples, or unaligned inputs, stage with plain loads instead.
// - The masks are evaluated only on a warp's tiles that cross a causal,
//   length or sequence edge; a warp whose rows all precede the tile's keys
//   causally (or lie past sq) skips the tile.  Query tiles are issued
//   last-first so that the long causal rows start early.  m is kept in the
//   reference's natural units, so that lse = m + log(l) takes no change of
//   base; p = 2^(s * scale * log2(e) - m * log2(e)) on the SFU.
// - Not wgmma yet: TF32 wgmma takes its shared-memory operands K-major
//   only, which V (the head dim along its rows) is not for P.V; that
//   product would need a transposed copy of each V tile.

#include <math.h>

#include "flash_mma.cuh"

namespace {

using flash::rows_of;
using flash::tile_ld;

constexpr int DMAX = 256;
constexpr int STAGES = 2;
constexpr float NEG_INF = -1e30f;

// The block's query rows (16 a warp), the keys per stage of the walk, and
// the blocks per SM that the registers are held to, per input type and
// padded head dim (chosen by timing on the H100 at the paths' shapes).
// Eight warps share each K/V tile.  At f32 the split Q (hi and lo) takes
// twice Q's shared memory, so f32 walks 32-key tiles: 104 KB a block at
// d <= 64, two blocks an SM; at DP = 256 the block holds 64 rows and walks
// 16 keys.
template <typename T, int DP>
struct Fwd {
  static constexpr bool F32 = flash::is_f32<T>;
  static constexpr int BQ = F32 && DP > 128 ? 64 : 128;
  static constexpr int NT = 2 * BQ;  // a warp per 16 rows
  static constexpr int BK = F32 ? (DP > 128 ? 16 : 32) : (DP > 128 ? 32 : 64);
  static constexpr int BLOCKS = DP > 64 ? 1 : 2;
  static constexpr int LD = tile_ld<T, DP>();
  static constexpr int QTILES = F32 ? 2 : 1;  // f32: Q's hi and lo parts
  static constexpr size_t bytes =
      sizeof(T) * (size_t)(QTILES * BQ * LD + STAGES * 2 * BK * LD);
};

template <typename T, int DP>
__global__ void __launch_bounds__(Fwd<T, DP>::NT, Fwd<T, DP>::BLOCKS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ lens,
                     T* __restrict__ o, float* __restrict__ lse, int sq,
                     int sk, int d, float scale, int causal, int vec) {
  using C = Fwd<T, DP>;
  constexpr int BQ = C::BQ, NT = C::NT, BK = C::BK, LD = C::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);  // [QTILES][BQ][LD]
  T* Ks = Qs + C::QTILES * BQ * LD;    // [STAGES][BK][LD]
  T* Vs = Ks + STAGES * BK * LD;       // [STAGES][BK][LD]

  const int warp = threadIdx.x / flash::WARP;
  const int lane = threadIdx.x % flash::WARP, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const T* kb = rows_of(k, bh, sk, d);
  const T* vb = rows_of(v, bh, sk, d);

  const float len = lens ? lens[bh] : (float)sk;
  int n = (sk + BK - 1) / BK;
  if (causal) {
    const int last_q = min(q0 + BQ, sq) - 1 + (sk - sq);
    n = min(n, last_q / BK + 1);
  }
  if (lens) n = min(n, (int)ceilf(len / BK));
  const int ksteps = (d + flash::Elem<T>::KSTEP - 1) / flash::Elem<T>::KSTEP;
  const int ntiles = (d + 7) / 8;

  auto stage = [&](int s, int j) {
    flash::load_tile<T, BK, LD, NT>(Ks + s * BK * LD, kb, j * BK, sk, d, vec);
    flash::load_tile<T, BK, LD, NT>(Vs + s * BK * LD, vb, j * BK, sk, d, vec);
  };

  flash::zero_pad<T, C::QTILES * BQ + 2 * STAGES * BK, DP, LD, NT>(Qs, d);
  flash::load_tile<T, BQ, LD, NT>(Qs, rows_of(q, bh, sq, d), q0, sq, d, vec);
  flash::cp_async_commit();
  stage(0, 0);
  flash::cp_async_commit();
  if constexpr (C::F32) {
    flash::cp_async_wait<1>();  // Q landed
    __syncthreads();
    flash::split_tile<BQ, DP, LD, NT>(Qs, Qs + BQ * LD);
  }

  // this warp's rows, and the last key position any of them may see
  const int row0 = q0 + 16 * warp;
  const T* Qw = Qs + 16 * warp * LD;
  const int last_key = causal ? min(row0 + 16, sq) - 1 + (sk - sq) : sk - 1;
  float acc[DP / 8][4] = {};
  // rows g and g + 8: running max and this lane's part of the row sums.
  // A row past sq starts at m = 0, so that its p = 2^(NEG_INF) = 0 and no
  // infinity arises in it; every other row's m is finite after its first
  // tile, which holds key 0.
  float m[2], l[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) m[h] = row0 + g + 8 * h < sq ? NEG_INF : 0.f;

  for (int j = 0; j < n; ++j) {
    flash::cp_async_wait<0>();  // tile j (and Q) landed
    // one barrier a tile: every warp sees tile j, and is done with tile
    // j - 1, whose stage then takes tile j + 1 while tile j computes
    __syncthreads();
    if (j + 1 < n) stage((j + 1) % STAGES, j + 1);
    flash::cp_async_commit();
    const int k0 = j * BK;
    const T* K = Ks + j % STAGES * BK * LD;
    const T* V = Vs + j % STAGES * BK * LD;
    if (row0 >= sq || k0 > last_key) continue;

    float sc[BK / 8][4] = {};
    flash::mma_abt_ldsm<T, BK, DP, LD, LD>(sc, Qw, Qw + BQ * LD, K, ksteps);
    const bool masked =
        !flash::tile_unmasked(row0, 16, k0, BK, sq, sk, causal, lens, len);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float x = sc[jj][e] * scale;
        if (masked && !flash::pair_valid(row0 + g + 8 * h,
                                         k0 + 8 * jj + 2 * t + (e & 1), sq,
                                         sk, causal, lens, len))
          x = NEG_INF;
        sc[jj][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    float corr[2], m2[2];  // m2: the new max in base 2
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = flash::quad_max(mx[h]);
      corr[h] = flash::exp2_ftz((m[h] - mx[h]) * flash::LOG2E);
      m[h] = mx[h];
      m2[h] = mx[h] * flash::LOG2E;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            flash::exp2_ftz(fmaf(sc[jj][e], flash::LOG2E, -m2[e >> 1]));
        l[e >> 1] += p;
        sc[jj][e] = p;
      }
    // the max of a row moves on few tiles after the first ones
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int n8 = 0; n8 < DP / 8; ++n8)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n8][e] *= corr[e >> 1];
    }
    flash::mma_pb<T, BK, DP, LD>(acc, sc, V, ntiles);
  }

  float l_safe[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_safe[h] = fmaxf(flash::quad_sum(l[h]), 1e-30f);
    const int row = row0 + g + 8 * h;
    if (t == 0 && row < sq)
      lse[(size_t)bh * sq + row] = m[h] + logf(l_safe[h]);
  }
#pragma unroll
  for (int n8 = 0; n8 < DP / 8; ++n8)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n8][e] /= l_safe[e >> 1];
  flash::store_rows<T, DP / 8>(o + (size_t)bh * sq * d, acc, row0, sq, d, 0);
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lens, void* o, void* lse, int bh, int sq,
                   int sk, int d, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem = Fwd<T, DP>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (sq + Fwd<T, DP>::BQ - 1) / Fwd<T, DP>::BQ);
  flash_fwd_kernel<T, DP><<<grid, Fwd<T, DP>::NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(lens),
      static_cast<T*>(o), static_cast<float*>(lse), sq, sk, d, scale, causal,
      flash::vec_ok<T>(d, q, k, v));
  return cudaGetLastError();
}

// head_dim picks the padded width DP = 32, 64, 128 or 256
template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const void* lens, void* o, void* lse, int bh, int sq,
                       int sk, int d, float scale, int causal,
                       cudaStream_t stream) {
  if (d <= 32)
    return launch<T, 32>(q, k, v, lens, o, lse, bh, sq, sk, d, scale, causal,
                         stream);
  if (d <= 64)
    return launch<T, 64>(q, k, v, lens, o, lse, bh, sq, sk, d, scale, causal,
                         stream);
  if (d <= 128)
    return launch<T, 128>(q, k, v, lens, o, lse, bh, sq, sk, d, scale,
                          causal, stream);
  return launch<T, DMAX>(q, k, v, lens, o, lse, bh, sq, sk, d, scale, causal,
                         stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q (bh, sq, d), k/v (bh, sk, d), o
// (bh, sq, d) contiguous at the input dtype; lse (bh, sq) f32; lens (bh,)
// f32 or null.  Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* lens, void* o, void* lse, int bh, int sq,
                         int sk, int d, float scale, int causal, int dtype,
                         void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || d < 1 || d > DMAX || sq > 65535 * 64)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(q, k, v, lens, o, lse, bh, sq, sk, d,
                                  scale, causal, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, lens, o, lse, bh, sq, sk,
                                          d, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
