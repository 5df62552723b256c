// Flash-attention backward for Hopper (sm_90a), f32 and bf16 inputs, on
// mma.sync: two kernels, as on the TPU, so that dq needs no atomics and is
// deterministic.
//
// Replaces the Pallas TPU kernels `_flash_bwd_dq_kernel` and
// `_flash_bwd_dkv_kernel` (analytics_zoo_tpu/ops/attention.py, launched by
// `_flash_core_bwd`).  Both replay the forward's softmax from its saved
// row logsumexp instead of re-running the online reduction:
//   p  = exp(s * scale - lse)             (masked pairs -> exactly 0)
//   dp = do . v^T
//   ds = p * (dp - delta) * scale         delta = rowsum(do * o), f32,
//                                         computed by the caller
//   dq = ds . k        (flash_bwd_dq,  one block per 64-row query tile)
//   dv = p^T . do      (flash_bwd_dkv, one block per 64-row key tile)
//   dk = ds^T . q
// Masking is the forward's: the finite sentinel, causal alignment
// q_pos = i + (sk - sq), per-(batch*head) valid key counts `lens` (f32 in
// [1, sk] or null).  The skips are the forward's too: the dq block walks
// key tiles up to its causal diagonal and ceil(len / BK); the dkv block
// walks query tiles from the first whose last row reaches it causally,
// and a key tile wholly at or past `len` writes zeros without looping.
// Rows past sq get p = 0.  bf16 keeps the TPU kernels' rounding points:
// ds is rounded to the input dtype before ds.k and ds^T.q, p before
// p^T.do; sums are f32.  At f32 each walked tile's products are summed
// apart and added to dq, dk and dv with rounded adds (flash_mma.cuh
// mma_pb): summed into them directly, the tensor core's cut sums bias a
// long walk, and dk's sum over keys, exactly 0, by ~5e-3 of dk.
//
// What bounds it on the H100: operations.  Per valid (query, key) pair
// and head-dim element, dq does 3 products and dk/dv 4, at 2 FLOP each;
// at the training shape (96, 2048, 64) causal that is 77 and 103 GFLOP
// against ~0.2 GB of operands.  f32 inputs run every product as 3xTF32
// on the tensor cores: three TF32 MMAs per product, within ~2^-20
// relative of an f32 product, which holds the exact f32 reference to
// 1e-4 where one TF32 pass misses it.  That is 3 x ops at 495 TFLOP/s,
// 0.47 and 0.62 ms.  bf16 inputs run one bf16 MMA per product at 989
// TFLOP/s: 0.08 and 0.10 ms.
//
// Design (flash_mma.cuh holds the MMA, split and staging helpers):
// - 128 threads; each of the 4 warps owns 16 rows of the block's own
//   64-row tile (keys in dkv, queries in dq) and computes its rows of
//   every product with warp-level mma.sync (m16n8k8 tf32, m16n8k16 bf16),
//   f32 sums in registers: S and dP as (own rows) x (walked tile), then p
//   and ds in place, then the outputs (16 rows x head dim) with p and ds
//   as A operands straight from the accumulators, never through shared
//   memory (flash_mma.cuh mma_pb says how the fragment layouts meet).
// - The own tile (K and V in dkv; Q and dO in dq) is staged once; the
//   walked tiles (Q, dO, lse and delta; K and V) go through a two-stage
//   ring filled by 16-byte cp.async, so that tile i+1 loads while tile i
//   computes.  Rows past the end are zero-filled by the copy; the head dim
//   is zero-padded in shared memory up to the template width DP (32, 64,
//   128 or 256), and only ceil(d / depth) MMA depths and ceil(d / 8)
//   output column tiles run.  A head dim whose rows are not 16-byte
//   multiples, or unaligned inputs, stage with plain loads instead.
// - At DP = 256, f32 walks 16-row tiles (two stages of 32 rows do not fit
//   in shared memory), and dk/dv splits its output columns into halves
//   over a third grid dimension: each block replays S and dP in full and
//   sums 128 columns of dk and dv, as many registers as at DP = 128.
// - The kernels are held back by latency more than by the tensor cores,
//   so occupancy matters: 32-row walked tiles and per-kernel register
//   budgets (Walk) keep 3 to 4 blocks on an SM at head_dim <= 64 without
//   spills.  p uses exp2 with log2(e) folded into the scale and lse; the
//   masks are evaluated only on tiles that cross a causal, length or
//   sequence edge.
// - The baseline: flash_bwd_sm90.cu runs both kernels on TMA and wgmma
//   for every call that design takes (bf16 to d = 128, f32 to d = 64, its
//   producer writing the transposed TF32 tiles TMA cannot), this file the
//   rest.

#include <math.h>

#include "flash_mma.cuh"

namespace {

using flash::rows_of;
using flash::tile_ld;

constexpr int NT = 128;  // 4 warps
constexpr int DMAX = 256;
constexpr int STAGES = 2;

// Rows of the walked tile per stage, and the blocks per SM that each
// kernel's registers are held to, per input type and padded head dim
// (chosen by timing on the H100 at the training shape).  f32 at DP = 256
// walks 16 rows, so that two stages fit in shared memory.
template <typename T, int DP>
struct Walk {
  static constexpr int ROWS = DP > 128 && flash::is_f32<T> ? 16 : 32;
  static constexpr int DQ_BLOCKS = DP > 64 ? 1 : flash::is_f32<T> ? 4 : 5;
  static constexpr int DKV_BLOCKS = DP > 64 ? 1 : flash::is_f32<T> ? 3 : 4;
};

// ---- dk/dv: grid (bh, ceil(sk / 64), ceil(d / DO)) ------------------------

template <typename T, int DP>
struct Dkv {
  static constexpr int BK = 64;                  // own keys, 16 per warp
  static constexpr int BQ = Walk<T, DP>::ROWS;   // walked queries per stage
  // output columns per block: at DP = 256 the dk and dv sums of all 256
  // would take 256 registers a thread, so each block sums a 128-column
  // half and replays S and dP in full for it
  static constexpr int DO = DP > 128 ? 128 : DP;
  static constexpr int LD = tile_ld<T, DP>();
  static constexpr size_t bytes =
      sizeof(T) * (size_t)(2 * BK * LD + STAGES * 2 * BQ * LD) +
      sizeof(float) * STAGES * 2 * BQ;
};

template <typename T, int DP>
__global__ void __launch_bounds__(NT, Walk<T, DP>::DKV_BLOCKS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ lens, T* __restrict__ dk,
                         T* __restrict__ dv, int sq, int sk, int d,
                         float scale, int causal, int vec) {
  using C = Dkv<T, DP>;
  constexpr int BK = C::BK, BQ = C::BQ, DO = C::DO, LD = C::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + BK * LD;
  T* Qs = Vs + BK * LD;            // [STAGES][BQ][LD]
  T* dOs = Qs + STAGES * BQ * LD;  // [STAGES][BQ][LD]
  float* Ls = reinterpret_cast<float*>(dOs + STAGES * BQ * LD);
  float* Ds = Ls + STAGES * BQ;    // Ls, Ds: [STAGES][BQ]

  const int warp = threadIdx.x / flash::WARP;
  const int lane = threadIdx.x % flash::WARP, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, k0 = blockIdx.y * BK;
  const T* qb = rows_of(q, bh, sq, d);
  const T* ob = rows_of(dout, bh, sq, d);
  const float* lb = lse + (size_t)bh * sq;
  const float* db = delta + (size_t)bh * sq;

  const float len = lens ? lens[bh] : (float)sk;
  // first query tile whose last row reaches this key tile causally
  const int start = causal ? max(0, (k0 - (sk - sq)) / BQ) : 0;
  int end = (sq + BQ - 1) / BQ;
  if (lens && (float)k0 >= len) end = start;  // dk = dv = 0, no loop
  const int n = end - start;
  const int ksteps = (d + flash::Elem<T>::KSTEP - 1) / flash::Elem<T>::KSTEP;
  const int c0 = blockIdx.z * DO;  // this block's first output column
  const int ntiles = min(DO / 8, (d - c0 + 7) / 8);
  const float scale2 = scale * flash::LOG2E;

  auto stage = [&](int s, int qi) {
    const int q0 = qi * BQ;
    flash::load_tile<T, BQ, LD, NT>(Qs + s * BQ * LD, qb, q0, sq, d, vec);
    flash::load_tile<T, BQ, LD, NT>(dOs + s * BQ * LD, ob, q0, sq, d, vec);
    flash::load_vec<BQ, NT>(Ls + s * BQ, lb, q0, sq);
    flash::load_vec<BQ, NT>(Ds + s * BQ, db, q0, sq);
  };

  float dk_acc[DO / 8][4] = {}, dv_acc[DO / 8][4] = {};
  if (n > 0) {
    flash::zero_pad<T, 2 * BK + 2 * STAGES * BQ, DP, LD, NT>(Ks, d);
    flash::load_tile<T, BK, LD, NT>(Ks, rows_of(k, bh, sk, d), k0, sk, d,
                                    vec);
    flash::load_tile<T, BK, LD, NT>(Vs, rows_of(v, bh, sk, d), k0, sk, d,
                                    vec);
    stage(0, start);
    flash::cp_async_commit();
    if (n > 1) stage(1, start + 1);
    flash::cp_async_commit();

    const T* Kw = Ks + 16 * warp * LD;
    const T* Vw = Vs + 16 * warp * LD;
    for (int i = 0; i < n; ++i) {
      flash::cp_async_wait<STAGES - 1>();  // tile i (and K, V) landed
      __syncthreads();
      const int s = i % STAGES, q0 = (start + i) * BQ;
      const T* Q = Qs + s * BQ * LD;
      const T* dO = dOs + s * BQ * LD;
      const float* L = Ls + s * BQ;
      const float* D = Ds + s * BQ;

      // transposed tiles: rows are this warp's keys, columns the queries
      float st[BQ / 8][4] = {}, dpt[BQ / 8][4] = {};
      flash::mma_abt<T, BQ, DP, LD, LD>(st, Kw, Q, ksteps);
      flash::mma_abt<T, BQ, DP, LD, LD>(dpt, Vw, dO, ksteps);
      const bool masked =
          !flash::tile_unmasked(q0, BQ, k0, BK, sq, sk, causal, lens, len);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 16 * warp + g + 8 * (e >> 1);
          const int col = 8 * j + 2 * t + (e & 1);
          float p = exp2f(fmaf(st[j][e], scale2, -L[col] * flash::LOG2E));
          if (masked &&
              !flash::pair_valid(q0 + col, key, sq, sk, causal, lens, len))
            p = 0.f;
          dpt[j][e] = p * (dpt[j][e] - D[col]) * scale;
          st[j][e] = p;
        }
      flash::mma_pb<T, BQ, DO, LD>(dv_acc, st, dO + c0, ntiles);
      flash::mma_pb<T, BQ, DO, LD>(dk_acc, dpt, Q + c0, ntiles);

      __syncthreads();  // every warp is done with stage s
      if (i + STAGES < n) stage(s, start + i + STAGES);
      flash::cp_async_commit();
    }
    flash::cp_async_wait<0>();
  }

  // every row < sk is written, the zero rows of a skipped tile included
  const int row0 = k0 + 16 * warp;
  flash::store_rows<T, DO / 8>(dk + (size_t)bh * sk * d, dk_acc, row0, sk, d,
                               c0);
  flash::store_rows<T, DO / 8>(dv + (size_t)bh * sk * d, dv_acc, row0, sk, d,
                               c0);
}

// ---- dq: grid (bh, ceil(sq / 64)) -----------------------------------------

template <typename T, int DP>
struct Dq {
  static constexpr int BQ = 64;                  // own queries, 16 per warp
  static constexpr int BK = Walk<T, DP>::ROWS;   // walked keys per stage
  static constexpr int LD = tile_ld<T, DP>();
  static constexpr size_t bytes =
      sizeof(T) * (size_t)(2 * BQ * LD + STAGES * 2 * BK * LD);
};

template <typename T, int DP>
__global__ void __launch_bounds__(NT, Walk<T, DP>::DQ_BLOCKS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ lens, T* __restrict__ dq,
                        int sq, int sk, int d, float scale, int causal,
                        int vec) {
  using C = Dq<T, DP>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + BQ * LD;
  T* Ks = dOs + BQ * LD;           // [STAGES][BK][LD]
  T* Vs = Ks + STAGES * BK * LD;   // [STAGES][BK][LD]

  const int warp = threadIdx.x / flash::WARP;
  const int lane = threadIdx.x % flash::WARP, g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  // long causal rows first, as in the forward
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const T* kb = rows_of(k, bh, sk, d);
  const T* vb = rows_of(v, bh, sk, d);

  // this lane's two query rows, g and g + 8 of its warp's 16
  const int row0 = q0 + 16 * warp;
  float row_lse2[2], row_delta[2];  // lse in base 2
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    row_lse2[h] = row < sq ? lse[(size_t)bh * sq + row] * flash::LOG2E : 0.f;
    row_delta[h] = row < sq ? delta[(size_t)bh * sq + row] : 0.f;
  }
  const float scale2 = scale * flash::LOG2E;

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

  float acc[DP / 8][4] = {};
  if (n > 0) {
    flash::zero_pad<T, 2 * BQ + 2 * STAGES * BK, DP, LD, NT>(Qs, d);
    flash::load_tile<T, BQ, LD, NT>(Qs, rows_of(q, bh, sq, d), q0, sq, d,
                                    vec);
    flash::load_tile<T, BQ, LD, NT>(dOs, rows_of(dout, bh, sq, d), q0, sq, d,
                                    vec);
    stage(0, 0);
    flash::cp_async_commit();
    if (n > 1) stage(1, 1);
    flash::cp_async_commit();

    const T* Qw = Qs + 16 * warp * LD;
    const T* dOw = dOs + 16 * warp * LD;
    for (int j = 0; j < n; ++j) {
      flash::cp_async_wait<STAGES - 1>();  // tile j (and Q, dO) landed
      __syncthreads();
      const int s = j % STAGES, k0 = j * BK;
      const T* K = Ks + s * BK * LD;
      const T* V = Vs + s * BK * LD;

      float sc[BK / 8][4] = {}, dp[BK / 8][4] = {};
      flash::mma_abt<T, BK, DP, LD, LD>(sc, Qw, K, ksteps);
      flash::mma_abt<T, BK, DP, LD, LD>(dp, dOw, V, ksteps);
      const bool masked =
          !flash::tile_unmasked(q0, BQ, k0, BK, sq, sk, causal, lens, len);
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int key = k0 + 8 * jj + 2 * t + (e & 1);
          float p = exp2f(fmaf(sc[jj][e], scale2, -row_lse2[h]));
          if (masked && !flash::pair_valid(row0 + g + 8 * h, key, sq, sk,
                                           causal, lens, len))
            p = 0.f;
          dp[jj][e] = p * (dp[jj][e] - row_delta[h]) * scale;
        }
      flash::mma_pb<T, BK, DP, LD>(acc, dp, K, ntiles);

      __syncthreads();  // every warp is done with stage s
      if (j + STAGES < n) stage(s, j + STAGES);
      flash::cp_async_commit();
    }
    flash::cp_async_wait<0>();
  }

  flash::store_rows<T, DP / 8>(dq + (size_t)bh * sq * d, acc, row0, sq, d, 0);
}

// ---- launch ---------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *lens;
  void *out0, *out1;
  int bh, sq, sk, d;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T>
int vec_ok(const Args& a) {
  return flash::vec_ok<T>(a.d, a.q, a.k, a.v, a.dout);
}

template <typename T, int DP>
cudaError_t launch_dq(const Args& a) {
  const size_t smem = Dq<T, DP>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.sq + Dq<T, DP>::BQ - 1) / Dq<T, DP>::BQ);
  flash_bwd_dq_kernel<T, DP><<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const float*>(a.lens), static_cast<T*>(a.out0), a.sq, a.sk,
      a.d, a.scale, a.causal, vec_ok<T>(a));
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dkv(const Args& a) {
  const size_t smem = Dkv<T, DP>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int DO = Dkv<T, DP>::DO;
  const dim3 grid(a.bh, (a.sk + Dkv<T, DP>::BK - 1) / Dkv<T, DP>::BK,
                  (a.d + DO - 1) / DO);
  flash_bwd_dkv_kernel<T, DP><<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const float*>(a.lens), static_cast<T*>(a.out0),
      static_cast<T*>(a.out1), a.sq, a.sk, a.d, a.scale, a.causal,
      vec_ok<T>(a));
  return cudaGetLastError();
}

// head_dim picks the padded width DP = 32, 64, 128 or 256
template <typename T>
cudaError_t dq_by_d(const Args& a) {
  if (a.d <= 32) return launch_dq<T, 32>(a);
  if (a.d <= 64) return launch_dq<T, 64>(a);
  if (a.d <= 128) return launch_dq<T, 128>(a);
  return launch_dq<T, DMAX>(a);
}

template <typename T>
cudaError_t dkv_by_d(const Args& a) {
  if (a.d <= 32) return launch_dkv<T, 32>(a);
  if (a.d <= 64) return launch_dkv<T, 64>(a);
  if (a.d <= 128) return launch_dkv<T, 128>(a);
  return launch_dkv<T, DMAX>(a);
}

bool bad_shape(int bh, int sq, int sk, int d) {
  return bh < 1 || sq < 1 || sk < 1 || d < 1 || d > DMAX ||
         sq > 65535 * 64 || sk > 65535 * 64;
}

}  // namespace

// q/dout (bh, sq, d), k/v (bh, sk, d) contiguous at one dtype (0 = float32,
// 1 = bfloat16); lse and delta (bh, sq) f32; lens (bh,) f32 or null.
// Writes dq (bh, sq, d) at the input dtype.  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, const void* lens, void* dq,
                            int bh, int sq, int sk, int d, float scale,
                            int causal, int dtype, void* stream) {
  if (bad_shape(bh, sq, sk, d)) return (int)cudaErrorInvalidValue;
  const Args a{q,  k,  v,  dout, lse,   delta,  lens,
               dq, nullptr, bh, sq, sk, d, scale, causal,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)dq_by_d<float>(a);
  if (dtype == 1) return (int)dq_by_d<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}

// As flash_bwd_dq; writes dk and dv (bh, sk, d) at the input dtype.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, const void* lens, void* dk,
                             void* dv, int bh, int sq, int sk, int d,
                             float scale, int causal, int dtype,
                             void* stream) {
  if (bad_shape(bh, sq, sk, d)) return (int)cudaErrorInvalidValue;
  const Args a{q,  k,  v,  dout, lse, delta, lens,
               dk, dv, bh, sq, sk, d,   scale, causal,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)dkv_by_d<float>(a);
  if (dtype == 1) return (int)dkv_by_d<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}
