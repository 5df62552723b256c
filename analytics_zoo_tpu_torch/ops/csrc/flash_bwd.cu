// Flash-attention backward for Hopper (sm_90a), f32 and bf16 inputs: two
// kernels, as on the TPU, so that dq needs no atomics and is deterministic.
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
// bf16 keeps the TPU kernels' rounding points: ds is rounded to the
// input dtype before ds.k and ds^T.q, p before p^T.do; sums are f32.
//
// What bounds it on the H100: the model trains in f32, which has no
// tensor-core path at "highest" precision, so the work is 3*d (dq) and
// 4*d (dkv) FMAs per valid (query, key) pair on the CUDA cores (67
// TFLOP/s); at the training shape (96, 2048, 64) causal that is 7.8 and
// 10.4 GFLOP against ~0.2 GB of operands: operation-bound.
//
// Design, the forward's (flash_fwd.cu): 256 threads as 16 x 16, 64 x 64
// tiles staged through shared memory as f32, with the ragged query and
// key edges masked inside.  Thread (ty, tx) owns rows 4*ty..4*ty+3 of its
// block's own tile and columns tx + 16*j of the other operand's tile (and
// of the head dim for the outputs).  The tile read along the head dim
// by all 16 threads of a half-warp is stored transposed with a padded
// leading dimension, so that both of its reads are free of bank
// conflicts.  Rows past sq are staged as zeros and their p is forced to
// 0, not left to exp(0 - lse) of a row that does not exist.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int TX = 16;
constexpr int TY = 16;
constexpr int NT = TX * TY;
constexpr int RPT = 64 / TY;  // own rows per thread
constexpr int CPT = 64 / TX;  // other-tile columns per thread
constexpr int DMAX = 128;
constexpr int LD = 64 + 1;    // leading dimension of a transposed tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ float round_like(float x, float) { return x; }
__device__ __forceinline__ float round_like(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ bool pair_valid(int q_row, int k_row, int sq,
                                           int sk, int causal,
                                           const float* lens, float len) {
  bool valid = q_row < sq && k_row < sk;
  if (causal) valid = valid && q_row + (sk - sq) >= k_row;
  if (lens) valid = valid && (float)k_row < len;
  return valid;
}

// ---- dq: grid (bh, ceil(sq / BQ)) ----------------------------------------

size_t dq_smem_bytes(int d) {
  // Qs, dOs [BQ][d+1]; Kt, Vt [d][LD]; DS [BQ][LD]; lse, delta [BQ]
  return sizeof(float) *
         (size_t)(2 * BQ * (d + 1) + 2 * d * LD + BQ * LD + 2 * BQ);
}

template <typename T, int DC>
__global__ void __launch_bounds__(NT)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ lens, T* __restrict__ dq,
                        int sq, int sk, int d, float scale, int causal) {
  extern __shared__ float smem[];
  const int q_ld = d + 1;
  float* Qs = smem;
  float* dOs = Qs + BQ * q_ld;
  float* Kt = dOs + BQ * q_ld;
  float* Vt = Kt + d * LD;
  float* DS = Vt + d * LD;
  float* Ls = DS + BQ * LD;
  float* Ds = Ls + BQ;

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int bh = blockIdx.x;
  // long causal rows first, as in the forward
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const T* qb = q + (size_t)bh * sq * d;
  const T* ob = dout + (size_t)bh * sq * d;
  const T* kb = k + (size_t)bh * sk * d;
  const T* vb = v + (size_t)bh * sk * d;

  for (int idx = tid; idx < BQ * d; idx += NT) {
    const int r = idx / d, c = idx % d;
    const bool in = q0 + r < sq;
    const size_t g = (size_t)(q0 + r) * d + c;
    Qs[r * q_ld + c] = in ? to_f32(qb[g]) : 0.f;
    dOs[r * q_ld + c] = in ? to_f32(ob[g]) : 0.f;
  }
  for (int r = tid; r < BQ; r += NT) {
    const bool in = q0 + r < sq;
    Ls[r] = in ? lse[(size_t)bh * sq + q0 + r] : 0.f;
    Ds[r] = in ? delta[(size_t)bh * sq + q0 + r] : 0.f;
  }

  const float len = lens ? lens[bh] : (float)sk;
  int n_iter = (sk + BK - 1) / BK;
  if (causal) {
    const int last_q = min(q0 + BQ, sq) - 1 + (sk - sq);
    n_iter = min(n_iter, last_q / BK + 1);
  }
  if (lens) n_iter = min(n_iter, (int)ceilf(len / BK));

  float acc[RPT][DC];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  for (int j = 0; j < n_iter; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // Q/dO staged; the last tile's K/V/DS consumed
    for (int idx = tid; idx < BK * d; idx += NT) {
      const int r = idx / d, c = idx % d;
      const bool in = k0 + r < sk;
      const size_t g = (size_t)(k0 + r) * d + c;
      Kt[c * LD + r] = in ? to_f32(kb[g]) : 0.f;
      Vt[c * LD + r] = in ? to_f32(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) s[i][jj] = dp[i][jj] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[RPT], ov[RPT], kv[CPT], vv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qv[i] = Qs[(ty * RPT + i) * q_ld + c];
        ov[i] = dOs[(ty * RPT + i) * q_ld + c];
      }
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) {
        kv[jj] = Kt[c * LD + tx + TX * jj];
        vv[jj] = Vt[c * LD + tx + TX * jj];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int jj = 0; jj < CPT; ++jj) {
          s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
          dp[i][jj] = fmaf(ov[i], vv[jj], dp[i][jj]);
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = ty * RPT + i;
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) {
        const int col = tx + TX * jj;
        const bool valid =
            pair_valid(q0 + row, k0 + col, sq, sk, causal, lens, len);
        const float p = valid ? expf(s[i][jj] * scale - Ls[row]) : 0.f;
        const float ds = p * (dp[i][jj] - Ds[row]) * scale;
        DS[row * LD + col] = round_like(ds, T());
      }
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float dsv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dsv[i] = DS[(ty * RPT + i) * LD + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + TX * c;
        const float kv = col < d ? Kt[col * LD + kk] : 0.f;
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    if (row >= sq) continue;
    T* out = dq + ((size_t)bh * sq + row) * d;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + TX * c;
      if (col < d) store(out + col, acc[i][c]);
    }
  }
}

// ---- dk/dv: grid (bh, ceil(sk / BK)) -------------------------------------

size_t dkv_smem_bytes(int d) {
  // Ks, Vs [BK][d+1]; Qt, dOt [d][LD]; P, DS [BK][LD]; lse, delta [BQ]
  return sizeof(float) *
         (size_t)(2 * BK * (d + 1) + 2 * d * LD + 2 * BK * LD + 2 * BQ);
}

template <typename T, int DC>
__global__ void __launch_bounds__(NT)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ lens, T* __restrict__ dk,
                         T* __restrict__ dv, int sq, int sk, int d,
                         float scale, int causal) {
  extern __shared__ float smem[];
  const int k_ld = d + 1;
  float* Ks = smem;
  float* Vs = Ks + BK * k_ld;
  float* Qt = Vs + BK * k_ld;
  float* dOt = Qt + d * LD;
  float* P = dOt + d * LD;
  float* DS = P + BK * LD;
  float* Ls = DS + BK * LD;
  float* Ds = Ls + BQ;

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const T* qb = q + (size_t)bh * sq * d;
  const T* ob = dout + (size_t)bh * sq * d;
  const T* kb = k + (size_t)bh * sk * d;
  const T* vb = v + (size_t)bh * sk * d;

  for (int idx = tid; idx < BK * d; idx += NT) {
    const int r = idx / d, c = idx % d;
    const bool in = k0 + r < sk;
    const size_t g = (size_t)(k0 + r) * d + c;
    Ks[r * k_ld + c] = in ? to_f32(kb[g]) : 0.f;
    Vs[r * k_ld + c] = in ? to_f32(vb[g]) : 0.f;
  }

  const float len = lens ? lens[bh] : (float)sk;
  // first query tile whose last row reaches this key tile causally
  const int start = causal ? max(0, (k0 - (sk - sq)) / BQ) : 0;
  int end = (sq + BQ - 1) / BQ;
  if (lens && (float)k0 >= len) end = start;  // dk = dv = 0, no loop

  float dk_acc[RPT][DC], dv_acc[RPT][DC];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int qi = start; qi < end; ++qi) {
    const int q0 = qi * BQ;
    __syncthreads();  // K/V staged; the last tile's Q/dO/P/DS consumed
    for (int idx = tid; idx < BQ * d; idx += NT) {
      const int r = idx / d, c = idx % d;
      const bool in = q0 + r < sq;
      const size_t g = (size_t)(q0 + r) * d + c;
      Qt[c * LD + r] = in ? to_f32(qb[g]) : 0.f;
      dOt[c * LD + r] = in ? to_f32(ob[g]) : 0.f;
    }
    for (int r = tid; r < BQ; r += NT) {
      const bool in = q0 + r < sq;
      Ls[r] = in ? lse[(size_t)bh * sq + q0 + r] : 0.f;
      Ds[r] = in ? delta[(size_t)bh * sq + q0 + r] : 0.f;
    }
    __syncthreads();

    // transposed tiles: rows are this block's keys, columns queries
    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) s[i][jj] = dp[i][jj] = 0.f;
    for (int c = 0; c < d; ++c) {
      float kv[RPT], vv[RPT], qv[CPT], ov[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        kv[i] = Ks[(ty * RPT + i) * k_ld + c];
        vv[i] = Vs[(ty * RPT + i) * k_ld + c];
      }
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) {
        qv[jj] = Qt[c * LD + tx + TX * jj];
        ov[jj] = dOt[c * LD + tx + TX * jj];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int jj = 0; jj < CPT; ++jj) {
          s[i][jj] = fmaf(kv[i], qv[jj], s[i][jj]);
          dp[i][jj] = fmaf(vv[i], ov[jj], dp[i][jj]);
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = ty * RPT + i;
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) {
        const int col = tx + TX * jj;
        const bool valid =
            pair_valid(q0 + col, k0 + row, sq, sk, causal, lens, len);
        const float p = valid ? expf(s[i][jj] * scale - Ls[col]) : 0.f;
        const float ds = p * (dp[i][jj] - Ds[col]) * scale;
        P[row * LD + col] = round_like(p, T());
        DS[row * LD + col] = round_like(ds, T());
      }
    }
    __syncthreads();

    for (int qq = 0; qq < BQ; ++qq) {
      float pv[RPT], dsv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        pv[i] = P[(ty * RPT + i) * LD + qq];
        dsv[i] = DS[(ty * RPT + i) * LD + qq];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + TX * c;
        const float ov = col < d ? dOt[col * LD + qq] : 0.f;
        const float qv = col < d ? Qt[col * LD + qq] : 0.f;
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          dv_acc[i][c] = fmaf(pv[i], ov, dv_acc[i][c]);
          dk_acc[i][c] = fmaf(dsv[i], qv, dk_acc[i][c]);
        }
      }
    }
  }

  // every row < sk is written, the zero rows of a skipped tile included
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = k0 + ty * RPT + i;
    if (row >= sk) continue;
    T* dk_row = dk + ((size_t)bh * sk + row) * d;
    T* dv_row = dv + ((size_t)bh * sk + row) * d;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + TX * c;
      if (col < d) {
        store(dk_row + col, dk_acc[i][c]);
        store(dv_row + col, dv_acc[i][c]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *lens;
  void *out0, *out1;
  int bh, sq, sk, d;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int DC>
cudaError_t launch_dq(const Args& a) {
  const size_t smem = dq_smem_bytes(a.d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, DC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.sq + BQ - 1) / BQ);
  flash_bwd_dq_kernel<T, DC><<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const float*>(a.lens), static_cast<T*>(a.out0), a.sq, a.sk,
      a.d, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int DC>
cudaError_t launch_dkv(const Args& a) {
  const size_t smem = dkv_smem_bytes(a.d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, DC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.sk + BK - 1) / BK);
  flash_bwd_dkv_kernel<T, DC><<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const float*>(a.lens), static_cast<T*>(a.out0),
      static_cast<T*>(a.out1), a.sq, a.sk, a.d, a.scale, a.causal);
  return cudaGetLastError();
}

// head_dim picks the per-thread output columns: DC = 2, 4 or 8 (16 * DC
// >= d)
template <typename T>
cudaError_t dq_by_d(const Args& a) {
  if (a.d <= 32) return launch_dq<T, 2>(a);
  if (a.d <= 64) return launch_dq<T, 4>(a);
  return launch_dq<T, DMAX / TX>(a);
}

template <typename T>
cudaError_t dkv_by_d(const Args& a) {
  if (a.d <= 32) return launch_dkv<T, 2>(a);
  if (a.d <= 64) return launch_dkv<T, 4>(a);
  return launch_dkv<T, DMAX / TX>(a);
}

bool bad_shape(int bh, int sq, int sk, int d) {
  return bh < 1 || sq < 1 || sk < 1 || d < 1 || d > DMAX ||
         sq > 65535 * BQ || sk > 65535 * BK;
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
