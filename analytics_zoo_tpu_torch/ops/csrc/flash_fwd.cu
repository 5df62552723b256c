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
// causal diagonal and past ceil(len / BK) are skipped, as on the TPU.
// bf16 inputs round p to bf16 before the p*v product, as the TPU kernel
// does (`p.astype(v_blk.dtype)`); l sums the unrounded p.
//
// What bounds it on the H100: the model runs in f32, and f32 has no
// tensor-core path at "highest" precision, so the work is 4*d FMAs per
// (query, key) pair on the CUDA cores (67 TFLOP/s peak); at the prefill
// shape (96, 512, 64) that is ~3.2 GFLOP against ~50 MB of q/k/v/o, i.e.
// operation-bound.  In bf16 the same work would be byte-bound, which this
// kernel does not exploit (no wgmma/TMA yet).
//
// Design: the TPU ran one large (256 x 1024) block pair in VMEM; here a
// block owns a 64-row query tile and walks 64-key tiles staged through
// shared memory as f32 (Q once; K transposed so that reading a key column
// is conflict-free; V row-major; P for the second product).  256 threads
// as 16 x 16: thread (ty, tx) owns query rows 4*ty..4*ty+3, key columns
// tx + 16*j of the score tile and output columns tx + 16*j.  The 16
// threads that share a row are one half-warp, so the row max and sum are
// shuffle reductions.  Ragged query/key edges are masked inside.  Query
// tiles are issued last-first so the long causal rows start early.  The
// head dim runs from 1 to 256: the accumulator holds DC = 2, 4, 8 or 16
// output columns a thread, and at d = 256 the staged tiles take 214.5 KB
// of the 227 KB of shared memory a block may have.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int TX = 16;
constexpr int TY = 16;
constexpr int NT = TX * TY;
constexpr int RPT = BQ / TY;  // query rows per thread
constexpr int CPT = BK / TX;  // key columns per thread
constexpr int DMAX = 256;
constexpr float NEG_INF = -1e30f;

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

size_t smem_bytes(int d) {
  // Qs [BQ][d+1], Kt [d][BK+1], Vs [BK][d], Ps [BQ][BK+1]
  return sizeof(float) *
         (size_t)(BQ * (d + 1) + d * (BK + 1) + BK * d + BQ * (BK + 1));
}

template <typename T, int DC>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ lens,
                     T* __restrict__ o, float* __restrict__ lse, int sq,
                     int sk, int d, float scale, int causal) {
  extern __shared__ float smem[];
  const int qs_ld = d + 1, kt_ld = BK + 1, ps_ld = BK + 1;
  float* Qs = smem;
  float* Kt = Qs + BQ * qs_ld;
  float* Vs = Kt + d * kt_ld;
  float* Ps = Vs + BK * d;

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const T* qb = q + (size_t)bh * sq * d;
  const T* kb = k + (size_t)bh * sk * d;
  const T* vb = v + (size_t)bh * sk * d;

  for (int idx = tid; idx < BQ * d; idx += NT) {
    const int r = idx / d, c = idx % d;
    Qs[r * qs_ld + c] =
        (q0 + r < sq) ? to_f32(qb[(size_t)(q0 + r) * d + c]) : 0.f;
  }

  const float len = lens ? lens[bh] : (float)sk;
  int n_iter = (sk + BK - 1) / BK;
  if (causal) {
    const int last_q = min(q0 + BQ, sq) - 1 + (sk - sq);
    n_iter = min(n_iter, last_q / BK + 1);
  }
  if (lens) n_iter = min(n_iter, (int)ceilf(len / BK));

  float m[RPT], l[RPT], acc[RPT][DC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int j = 0; j < n_iter; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // Q is staged; the last tile's K/V/P are consumed
    for (int idx = tid; idx < BK * d; idx += NT) {
      const int r = idx / d, c = idx % d;
      const bool in = k0 + r < sk;
      const size_t g = (size_t)(k0 + r) * d + c;
      Kt[c * kt_ld + r] = in ? to_f32(kb[g]) : 0.f;
      Vs[r * d + c] = in ? to_f32(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) s[i][jj] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(ty * RPT + i) * qs_ld + c];
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) kv[jj] = Kt[c * kt_ld + tx + TX * jj];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int jj = 0; jj < CPT; ++jj)
          s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = ty * RPT + i;
      const int q_pos = q0 + row + (sk - sq);
      float mb = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) {
        const int k_pos = k0 + tx + TX * jj;
        bool valid = k_pos < sk;
        if (causal) valid = valid && q_pos >= k_pos;
        if (lens) valid = valid && (float)k_pos < len;
        s[i][jj] = valid ? s[i][jj] * scale : NEG_INF;
        mb = fmaxf(mb, s[i][jj]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
      const float m_new = fmaxf(m[i], mb);
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) {
        const float p = expf(s[i][jj] - m_new);
        ps += p;
        Ps[row * ps_ld + tx + TX * jj] = round_like(p, T());
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(ty * RPT + i) * ps_ld + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + TX * c;
        const float vv = col < d ? Vs[kk * d + col] : 0.f;
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    if (row >= sq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    T* orow = o + ((size_t)bh * sq + row) * d;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + TX * c;
      if (col < d) store(orow + col, acc[i][c] / l_safe);
    }
    if (tx == 0) lse[(size_t)bh * sq + row] = m[i] + logf(l_safe);
  }
}

template <typename T, int DC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lens, void* o, void* lse, int bh, int sq,
                   int sk, int d, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
  flash_fwd_kernel<T, DC><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(lens),
      static_cast<T*>(o), static_cast<float*>(lse), sq, sk, d, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const void* lens, void* o, void* lse, int bh, int sq,
                       int sk, int d, float scale, int causal,
                       cudaStream_t stream) {
  if (d <= 32)
    return launch<T, 2>(q, k, v, lens, o, lse, bh, sq, sk, d, scale, causal,
                        stream);
  if (d <= 64)
    return launch<T, 4>(q, k, v, lens, o, lse, bh, sq, sk, d, scale, causal,
                        stream);
  if (d <= 128)
    return launch<T, 8>(q, k, v, lens, o, lse, bh, sq, sk, d, scale, causal,
                        stream);
  return launch<T, DMAX / TX>(q, k, v, lens, o, lse, bh, sq, sk, d, scale,
                              causal, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q (bh, sq, d), k/v (bh, sk, d), o
// (bh, sq, d) contiguous at the input dtype; lse (bh, sq) f32; lens (bh,)
// f32 or null.  Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* lens, void* o, void* lse, int bh, int sq,
                         int sk, int d, float scale, int causal, int dtype,
                         void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || d < 1 || d > DMAX || sq > 65535 * BQ)
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
