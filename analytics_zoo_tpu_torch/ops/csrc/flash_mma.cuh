// Warp-level tensor-core and staging helpers of the flash kernels (sm_90a).
//
// Products run on mma.sync with f32 sums: f32 inputs as 3xTF32 (each
// operand split into two TF32 parts, hi and lo, and a.b ~= a_hi.b_hi +
// a_hi.b_lo + a_lo.b_hi, about 2^-20 relative per product), bf16 inputs
// natively.  Tiles are staged into shared memory by
// 16-byte cp.async, zero-filled past the last row.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32 and mma.m16n8k16 .bf16),
// with g = lane / 4 and t = lane % 4:
//   C (16 x 8, both):  c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
//   A tf32 (16 x 8):   a0 (g, t)   a1 (g+8, t)   a2 (g, t+4)   a3 (g+8, t+4)
//   B tf32 (8 x 8):    b0 (t, g)   b1 (t+4, g)
//   A bf16 (16 x 16):  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)
//                      a3 (g+8, 2t+8..)
//   B bf16 (16 x 8):   b0 (2t..2t+1, g)  b1 (2t+8..2t+9, g)
// A tile's leading dimension is its width plus 16 bytes' worth of
// padding (4 f32 or 8 bf16), so that a row is a whole number of 16-byte
// chunks and starts 4 banks after the one before it: every fragment read
// below is then free of bank conflicts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

constexpr int WARP = 32;

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int KSTEP = 8;  // MMA depth
  static constexpr int PAD = 4;    // columns of padding per shared row
  static __device__ __forceinline__ float zero() { return 0.f; }
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int KSTEP = 16;
  static constexpr int PAD = 8;
  static __device__ __forceinline__ __nv_bfloat16 zero() {
    return __float2bfloat16(0.f);
  }
};

template <typename T>
constexpr bool is_f32 = std::is_same<T, float>::value;

// leading dimension of a shared tile DP columns wide
template <typename T, int DP>
constexpr int tile_ld() {
  return DP + Elem<T>::PAD;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ bool pair_valid(int q_row, int k_row, int sq,
                                           int sk, int causal,
                                           const float* lens, float len) {
  bool valid = q_row < sq && k_row < sk;
  if (causal) valid = valid && q_row + (sk - sq) >= k_row;
  if (lens) valid = valid && (float)k_row < len;
  return valid;
}

// every pair of query rows [q0, q0 + nq) and keys [k0, k0 + nk) is valid
__device__ __forceinline__ bool tile_unmasked(int q0, int nq, int k0, int nk,
                                              int sq, int sk, int causal,
                                              const float* lens, float len) {
  return q0 + nq <= sq && k0 + nk <= sk &&
         (!causal || q0 + (sk - sq) >= k0 + nk - 1) &&
         (!lens || (float)(k0 + nk - 1) < len);
}

// max and sum over the 4 lanes of a quad (one g): the lanes that hold a
// row of a C fragment
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^x on the SFU: ex2.approx.ftz, within 2 ulp; results under 2^-126
// are flushed to 0 (a p that small adds nothing to an f32 row sum)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- tensor-core products ------------------------------------------------

// x = hi + lo exactly: hi is x cut to TF32 (its low 13 significand bits
// cleared), lo = x - hi, |lo| < 2^-10 |x|.  The MMA reads lo's TF32 part,
// which drops a further 2^-11 |lo|.  Two ALU instructions, where a split
// by cvt.rna.tf32 costs several more.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[j] += a.b[j] over n-tiles j < `live` in 3xTF32: the two small cross
// terms first, then hi.hi; lo.lo (under 2^-20 relative) is dropped.  Each of
// the three passes runs over every n-tile before the next, so that the
// MMAs on one accumulator are M apart rather than back to back.
template <int M>
__device__ __forceinline__ void mma_3xtf32(float (*c)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           const uint32_t (&bhi)[M][2],
                                           const uint32_t (&blo)[M][2],
                                           int live) {
#pragma unroll
  for (int j = 0; j < M; ++j)
    if (j < live) mma_tf32(c[j], alo, bhi[j]);
#pragma unroll
  for (int j = 0; j < M; ++j)
    if (j < live) mma_tf32(c[j], ahi, blo[j]);
#pragma unroll
  for (int j = 0; j < M; ++j)
    if (j < live) mma_tf32(c[j], ahi, bhi[j]);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// four 8 x 8 b16 matrices (8 rows of 16 bytes each; lanes 8i..8i+7 give
// matrix i's row addresses): lane (g, t) receives the 32 bits at row g,
// bytes 4t..4t+3 of each.  At f32 a matrix is 8 rows x 4 floats and lane
// (g, t) gets element (g, t): a tf32 A or B fragment register.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Split a ROWS-row f32 shared tile (DP columns, leading dimension LD) in
// place into its TF32 hi parts, and write the lo parts to the tile of the
// same shape at `lo`: an operand that many products read is then split
// once (mma_abt_ldsm).
template <int ROWS, int DP, int LD, int NT>
__device__ __forceinline__ void split_tile(float* hi, float* lo) {
  constexpr int C4 = DP / 4;  // float4 chunks a row
  for (int i = threadIdx.x; i < ROWS * C4; i += NT) {
    const int at = (i / C4) * LD + (i % C4) * 4;
    const float4 x = *reinterpret_cast<const float4*>(hi + at);
    const float xs[4] = {x.x, x.y, x.z, x.w};
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split(xs[e], h[e], l[e]);
    *reinterpret_cast<uint4*>(hi + at) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + at) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// c[j] += A . Bt_j^T: the warp's 16 x N product over the first `ksteps`
// MMA depths of the head dim (columns past d are zero in shared memory).
// A is 16 rows of a shared tile (leading dimension LDA), Bt is N rows
// (LDB), both with the head dim along the row; n-tile j of the result is
// Bt's rows 8j..8j+7.
template <typename T, int N, int DP, int LDA, int LDB>
__device__ __forceinline__ void mma_abt(float (&c)[N / 8][4], const T* A,
                                        const T* Bt, int ksteps) {
  const int lane = threadIdx.x % WARP, g = lane >> 2, t = lane & 3;
  if constexpr (is_f32<T>) {
#pragma unroll
    for (int ks = 0; ks < DP / 8; ++ks) {
      if (ks >= ksteps) break;
      const float* a = A + g * LDA + 8 * ks + t;
      uint32_t ah[4], al[4];
      split(a[0], ah[0], al[0]);
      split(a[8 * LDA], ah[1], al[1]);
      split(a[4], ah[2], al[2]);
      split(a[8 * LDA + 4], ah[3], al[3]);
      uint32_t bh[N / 8][2], bl[N / 8][2];
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const float* b = Bt + (8 * j + g) * LDB + 8 * ks + t;
        split(b[0], bh[j][0], bl[j][0]);
        split(b[4], bh[j][1], bl[j][1]);
      }
      mma_3xtf32<N / 8>(c, ah, al, bh, bl, N / 8);
    }
  } else {
    // depth rolled: unrolled, bf16 dk/dv spills at its register budget
#pragma unroll 1
    for (int ks = 0; ks < DP / 16; ++ks) {
      if (ks >= ksteps) break;
      const T* a = A + g * LDA + 16 * ks + 2 * t;
      const uint32_t af[4] = {ld32(a), ld32(a + 8 * LDA), ld32(a + 8),
                              ld32(a + 8 * LDA + 8)};
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const T* b = Bt + (8 * j + g) * LDB + 16 * ks + 2 * t;
        const uint32_t bf[2] = {ld32(b), ld32(b + 8)};
        mma_bf16(c[j], af, bf);
      }
    }
  }
}

// mma_abt with its fragments loaded by ldmatrix (one instruction gives A's
// four registers of a depth step, or two n-tiles of Bt).  f32: A comes
// pre-split (split_tile: its TF32 hi parts at A, lo parts at Alo), so that
// only Bt is split here, and the two cross terms are summed into an
// accumulator of their own.  The tensor core cuts every sum it writes back
// to f32 towards zero; summed apart, the small terms no longer cost c a
// cut each, which keeps c's bias over a long head dim at a third (one cut
// a depth step instead of three).  N is a multiple of 16.
template <typename T, int N, int DP, int LDA, int LDB>
__device__ __forceinline__ void mma_abt_ldsm(float (&c)[N / 8][4], const T* A,
                                             const T* Alo, const T* Bt,
                                             int ksteps) {
  constexpr int KS = Elem<T>::KSTEP, E16 = 16 / sizeof(T);
  const int lane = threadIdx.x % WARP, i = lane >> 3, r = lane & 7;
  // this lane's row address of matrix i: A's rows r (+8 for i odd), the
  // depth step's half i / 2; Bt's rows r (+8 for i >= 2), half i % 2
  const int a_at = (r + 8 * (i & 1)) * LDA + E16 * (i >> 1);
  const int b_at = (r + 8 * (i >> 1)) * LDB + E16 * (i & 1);
  [[maybe_unused]] float cx[N / 8][4] = {};  // f32: the cross terms
#pragma unroll
  for (int ks = 0; ks < DP / KS; ++ks) {
    if (ks >= ksteps) break;
    uint32_t ah[4], b[N / 8][2];
    ldmatrix_x4(ah, A + a_at + KS * ks);
#pragma unroll
    for (int j = 0; j < N / 8; j += 2) {
      uint32_t rb[4];
      ldmatrix_x4(rb, Bt + b_at + 8 * j * LDB + KS * ks);
      b[j][0] = rb[0];
      b[j][1] = rb[1];
      b[j + 1][0] = rb[2];
      b[j + 1][1] = rb[3];
    }
    if constexpr (is_f32<T>) {
      uint32_t al[4], bh[N / 8][2], bl[N / 8][2];
      ldmatrix_x4(al, Alo + a_at + KS * ks);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        split(__uint_as_float(b[j][0]), bh[j][0], bl[j][0]);
        split(__uint_as_float(b[j][1]), bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int j = 0; j < N / 8; ++j) mma_tf32(cx[j], al, bh[j]);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) mma_tf32(cx[j], ah, bl[j]);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) mma_tf32(c[j], ah, bh[j]);
    } else {
#pragma unroll
      for (int j = 0; j < N / 8; ++j) mma_bf16(c[j], ah, b[j]);
    }
  }
  if constexpr (is_f32<T>) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][e] += cx[j][e];
  }
}

// c[n] += P . B: P is the warp's 16 x N product in C fragments (as
// mma_abt leaves it), B is N rows of a shared tile (LDB) whose columns
// 8n..8n+7 make n-tile n of the result; n-tiles from `ntiles` on are
// skipped.
//
// f32: c sums over a whole walk (O over every key tile, dq, dk and dv
// over every walked tile), and the tensor core cuts every sum it writes
// back towards zero: three cuts a depth step, which over a long walk of
// terms of one sign (values or keys with a large mean over the sequence)
// bias c by ~3e-5 of its size at 2,048 keys and throw the backward's
// delta = rowsum(do * o) off the replayed p.dp.  So this call's N rows
// are summed into accumulators of their own, n-chunk by n-chunk, and
// added to c with one rounded add each.
//
// f32: P's C fragment holds columns 2t and 2t+1 where the A fragment wants
// t and t+4.  Instead of moving P between lanes, the contraction index is
// permuted: A's column t is P's column 2t, A's column t+4 is P's 2t+1, and
// B's rows are read in the same order, 2t and 2t+1.
// bf16: the C fragments of n-tiles 2k and 2k+1, packed to bf16, are the A
// fragment of depth step k as they stand; the packing is the rounding of
// p and ds to the input dtype.  B comes transposed out of its row-major
// tile through ldmatrix.
template <typename T, int N, int DP, int LDB>
__device__ __forceinline__ void mma_pb(float (&c)[DP / 8][4],
                                       const float (&p)[N / 8][4],
                                       const T* B, int ntiles) {
  const int lane = threadIdx.x % WARP, g = lane >> 2, t = lane & 3;
  if constexpr (is_f32<T>) {
    // n-tiles in chunks of at most 8, for the registers of B's parts and
    // of the chunk's own sums
    constexpr int CH = DP / 8 < 8 ? DP / 8 : 8;
#pragma unroll
    for (int n0 = 0; n0 < DP / 8; n0 += CH) {
      if (n0 >= ntiles) break;
      float sum[CH][4] = {};
#pragma unroll
      for (int kb = 0; kb < N / 8; ++kb) {
        uint32_t ah[4], al[4];
        split(p[kb][0], ah[0], al[0]);
        split(p[kb][2], ah[1], al[1]);
        split(p[kb][1], ah[2], al[2]);
        split(p[kb][3], ah[3], al[3]);
        const float* b = B + (8 * kb + 2 * t) * LDB + g;
        uint32_t bh[CH][2], bl[CH][2];
#pragma unroll
        for (int n = 0; n < CH; ++n) {
          split(b[8 * (n0 + n)], bh[n][0], bl[n][0]);
          split(b[LDB + 8 * (n0 + n)], bh[n][1], bl[n][1]);
        }
        mma_3xtf32<CH>(sum, ah, al, bh, bl, ntiles - n0);
      }
#pragma unroll
      for (int n = 0; n < CH; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[n0 + n][e] += sum[n][e];
    }
  } else {
    // lanes 0-7 address rows 0-7 of the depth step, 8-15 rows 8-15, at
    // n-tile n; lanes 16-31 the same rows at n-tile n+1
    const T* rows = B + (lane & 15) * LDB + (lane >> 4) * 8;
#pragma unroll
    for (int kb = 0; kb < N / 16; ++kb) {
      const uint32_t a[4] = {pack_bf16(p[2 * kb][0], p[2 * kb][1]),
                             pack_bf16(p[2 * kb][2], p[2 * kb][3]),
                             pack_bf16(p[2 * kb + 1][0], p[2 * kb + 1][1]),
                             pack_bf16(p[2 * kb + 1][2], p[2 * kb + 1][3])};
#pragma unroll
      for (int n = 0; n < DP / 8; n += 2) {
        if (n >= ntiles) break;
        uint32_t r[4];
        ldmatrix_x4_trans(r, rows + 16 * kb * LDB + 8 * n);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_bf16(c[n], a, b0);
        mma_bf16(c[n + 1], a, b1);
      }
    }
  }
}

// The warp's 16 x (8 * NT8) C fragments to rows row0 (lanes' g) and
// row0 + 8, columns c0 on, of a row-major (n_rows, d) output; columns
// from d on are not written.
template <typename T, int NT8>
__device__ __forceinline__ void store_rows(T* out, const float (&c)[NT8][4],
                                           int row0, int n_rows, int d,
                                           int c0) {
  const int lane = threadIdx.x % WARP, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + 8 * (e >> 1);
      const int col = c0 + 8 * n + 2 * t + (e & 1);
      if (row < n_rows && col < d) store(out + (size_t)row * d + col, c[n][e]);
    }
}

// ---- staging --------------------------------------------------------------

// one (batch*head) row block of a (bh, s, d) tensor
template <typename T>
__device__ __forceinline__ const T* rows_of(const T* x, int bh, int s, int d) {
  return x + (size_t)bh * s * d;
}

// 16-byte cp.async staging (load_tile's `vec`) takes rows of whole
// 16-byte chunks and 16-byte aligned tensors
template <typename T, typename... P>
inline bool vec_ok(int d, const P*... tensors) {
  return (d * sizeof(T)) % 16 == 0 &&
         ((reinterpret_cast<uintptr_t>(tensors) % 16 == 0) && ...);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// Rows [r0, r0 + ROWS) of a row-major (n, d) tensor into a shared tile
// (leading dimension LD); rows at or past n become zeros, columns from d
// on are left as they are.  vec: 16-byte cp.async, which needs d *
// sizeof(T) and `src` 16-byte aligned; otherwise plain loads and stores.
template <typename T, int ROWS, int LD, int NT>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int r0,
                                          int n, int d, bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int chunks = d / E;
    for (int i = threadIdx.x; i < ROWS * chunks; i += NT) {
      const int r = i / chunks, c = (i - r * chunks) * E;
      const bool in = r0 + r < n;
      cp_async16(dst + r * LD + c, in ? src + (size_t)(r0 + r) * d + c : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * d; i += NT) {
      const int r = i / d, c = i - r * d;
      dst[r * LD + c] =
          r0 + r < n ? src[(size_t)(r0 + r) * d + c] : Elem<T>::zero();
    }
  }
}

// entries [r0, r0 + ROWS) of an f32 vector of length n, zeros past n
template <int ROWS, int NT>
__device__ __forceinline__ void load_vec(float* dst, const float* src, int r0,
                                         int n) {
  for (int i = threadIdx.x; i < ROWS; i += NT) {
    const bool in = r0 + i < n;
    cp_async4(dst + i, in ? src + r0 + i : src, in ? 4 : 0);
  }
}

// zero columns [d, DP) of a ROWS-row shared tile: the MMA reads them as
// head-dim padding
template <typename T, int ROWS, int DP, int LD, int NT>
__device__ __forceinline__ void zero_pad(T* dst, int d) {
  const int w = DP - d;
  for (int i = threadIdx.x; i < ROWS * w; i += NT) {
    const int r = i / w;
    dst[r * LD + d + (i - r * w)] = Elem<T>::zero();
  }
}

}  // namespace flash
