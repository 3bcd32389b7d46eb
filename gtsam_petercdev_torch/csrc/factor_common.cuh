// Device code shared by the partial-Cholesky kernels (K1, K3 / K4) and the
// Schur-complement stage: the warp-level factor of a d x d diagonal block,
// and the two pieces of inline PTX (FP64 tensor-core product, cp.async).
//
// The PTX pieces are small device functions so that tools/cuda_emulate.py,
// which compiles these sources with g++, can supply its own versions of
// them (it defines GTSAM_EMULATE); the CUDA build never defines it.

#pragma once

namespace gtsam_cuda {

constexpr int kMaxD = 16;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ inline float sqrt_t(float x) { return sqrtf(x); }
__device__ inline double sqrt_t(double x) { return sqrt(x); }

// One warp factors a d x d SPD block (d <= KD <= kMaxD <= 32) and inverts
// the factor. On entry lane r < d holds row r of the block's lower triangle
// in row[0..r] (zeros elsewhere; lanes r >= d hold zeros). On exit lane
// r < d holds row r of the lower Cholesky factor in row[], and lane c < d
// holds column c of the factor's inverse in inv[]. Returns the number of
// pivots <= eps, each clamped to eps (the plain version's rule, in the same
// order), the same on every lane. Every lane of the warp must call it. KD is
// the unrolled size: `warp_factor_diag_any` picks the smallest that holds d.
//
// The arithmetic is the plain version's, in the same order for every
// element: column k is divided by its pivot, then the rank-1 update of the
// trailing rows; the inverse is forward substitution, column by column.
// Elements move between lanes by __shfl_sync only.
template <int KD, typename T>
__device__ inline int warp_factor_diag(T (&row)[kMaxD], T (&inv)[kMaxD], int d, T eps,
                                       int lane) {
  int nbad = 0;
#pragma unroll
  for (int k = 0; k < KD; ++k) {
    if (k < d) {
      T p = __shfl_sync(kFullMask, row[k], k);  // pivot A[k][k], from lane k
      if (p <= eps) {  // clamp-and-count, eps = 1e-10 in both types
        ++nbad;
        p = eps;
      }
      const T piv = sqrt_t(p);
      if (lane == k) row[k] = piv;
      else if (lane > k) row[k] = row[k] / piv;
#pragma unroll
      for (int c = k + 1; c < KD; ++c) {
        if (c < d) {
          const T lck = __shfl_sync(kFullMask, row[k], c);  // L[c][k]
          if (lane >= c) row[c] -= row[k] * lck;
        }
      }
    }
  }
  // column `lane` of L^-1 by forward substitution
#pragma unroll
  for (int r = 0; r < KD; ++r) {
    if (r < d) {
      const T lrr = __shfl_sync(kFullMask, row[r], r);
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < r; ++k) {
        const T lrk = __shfl_sync(kFullMask, row[k], r);  // L[r][k]
        if (k >= lane) acc += lrk * inv[k];
      }
      inv[r] = r < lane ? T(0) : (r == lane ? T(1) / lrr : -acc / lrr);
    }
  }
  return nbad;
}

template <typename T>
__device__ inline int warp_factor_diag_any(T (&row)[kMaxD], T (&inv)[kMaxD], int d, T eps,
                                           int lane) {
  if (d <= 6) return warp_factor_diag<6>(row, inv, d, eps, lane);
  if (d <= 9) return warp_factor_diag<9>(row, inv, d, eps, lane);
  return warp_factor_diag<kMaxD>(row, inv, d, eps, lane);
}

#ifndef GTSAM_EMULATE
// D = A B + C for one 8 x 8 x 4 f64 product on the FP64 tensor cores
// (DMMA). Fragments as the PTX ISA lays out mma.m8n8k4 .f64 (g = lane / 4,
// t = lane % 4): a = A[g][t], b = B[t][g], (c0, c1) = C[g][2t], C[g][2t+1].
__device__ inline void dmma_8x8x4(double& c0, double& c1, double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(c0), "+d"(c1)
      : "d"(a), "d"(b));
}

// asynchronous global -> shared copy of one 4- or 8-byte element
template <typename T>
__device__ inline void cp_async_elem(T* smem, const T* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem),
               "n"(sizeof(T)));
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
#endif

// wait until at most n (0 .. 7, a uniform value) of this thread's cp.async
// groups are still in flight: the depth of a ring chosen at run time
__device__ inline void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

}  // namespace gtsam_cuda
