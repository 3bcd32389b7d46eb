// K3 and K4: per-clique partial Cholesky with the clique's working copy in
// shared memory (sm_90a).
//
// K3 replaces the Pallas TPU kernel gtsam_petercdev_tpu/ops/cholesky.py
// `partial_cholesky` (`_kernel`, one grid program per clique, working copy in
// VMEM); K4 replaces `partial_cholesky_blocks` (`_kernel_blocks`), which
// reads the elimination block pool directly and writes the Schur complement
// in block layout. Both compute, for each clique b of a bucket with frontal
// matrix F [m, m] (m = fd + sd, fd = nf*d, sd = ns*d) and right-hand side g:
//   L    [fd, fd]    lower Cholesky factor of F11 (by d x d block columns)
//   Linv [nf, d, d]  inverses of L's diagonal blocks
//   W    [fd, sd]    = L^-1 F12,     y  [fd] = L^-1 g1
//   U    [sd, sd]    = F22 - W^T W,  ug [sd] = g2 - W^T y
//   bad              pivots <= eps, each clamped to eps (choleskyCareful);
//                    LM rejects a trial on this count, so the rule matches
//                    inference/kernels.py exactly.
// The two share one body (as `_kernel` and `_kernel_blocks` share `col_step`)
// and differ in how F is read and U / ug are written:
//   K3 (kBlocks = false): F [B, m, m] dense; this kernel stops after W and y,
//       and U [B, sd, sd], ug [B, sd] come from schur_update.cu, a second
//       launch with grid (B, 64 x 64 tiles of U's lower triangle);
//   K4 (kBlocks = true):  F as the pool slice [B * mb * mb, d, d] of row-major
//       d x d blocks (mb = nf + ns), g [B, mb, d]; U as [B, ns * ns, d, d]
//       blocks, ug [B, ns, d], formed here. No [B, m, m] tensor exists for
//       its buckets.
//
// Design. Grid = B, one CTA per clique. Dynamic shared memory holds the
// working copy S = [F11 | F12 | g1] (fd x (m+1), row-major), the current
// panel P (fd x d), the diagonal block's factor and its inverse (d x d each)
// and the bad-pivot counter: (fd (m+1) + fd d + 2 d^2) elements + 16 bytes,
// up to the card's 227 KB per CTA (the launcher raises the kernel's dynamic
// limit above 48 KB). The wrapper's `fits_smem` is the same formula; a
// clique that does not fit is refused there. Each F element of the first fd
// rows is read from global memory once; nothing but the outputs is written.
// Per block column j, separated by __syncthreads():
//   (1) threads stride over the panel P = A[below, j] Linv_j^T (to L and to
//       shared memory) and over the RHS columns, y_j = Linv_j R_j;
//   (2) warp 0 applies the SYRK update to the next diagonal block and
//       factors it with the clamped pivot rule, inverting it by forward
//       substitution, lane r holding row r and exchanging by shuffles
//       (factor_common.cuh), while the other warps stride over the RHS
//       update R -= P y_j and the rest of the trailing SYRK A -= P P^T
//       (lower triangle), all operands in shared memory.
// Block 0's diagonal block is factored before the loop (one block of
// lookahead: the d-step chain of each diagonal factor hides behind (2)).
// Then W, y leave the working copy (and, in K4, U and ug are formed).
//
// What bounds it on an H100. K4: bytes. The bundle-adjustment leaf bucket
// (50,000 cliques, nf = 1, ns = 4, d = 9) moves 16 KB (f64) of pool in and
// 13 KB out per clique for ~0.02 MFLOP; a leaf clique needs 3.4 KB of shared
// memory and 64 threads, so ~32 cliques share an SM. K3: bytes too, but its
// buckets are small (the BA plan's 123 K3 buckets hold 792 cliques, 51 of
// them with B = 1), so one CTA per clique left most SMs idle while one
// thread factored each diagonal block and the same CTA formed U
// (fd sd^2 FMA, the bulk of the flops) with scalar FMAs. The block-column
// chain stays on one CTA per clique; the diagonal block is now a warp's,
// overlapped with the update, its loops unrolled for d = 6 and 9 (template
// KD), and K3's U is spread over the card by schur_update.cu.

#include <cuda_runtime.h>

#include "factor_common.cuh"

namespace {

using namespace gtsam_cuda;

// shared-memory elements of type T one clique needs (then 16 bytes more)
__host__ __device__ inline size_t smem_elems(int nf, int ns, int d) {
  const size_t fd = (size_t)nf * d, m = (size_t)(nf + ns) * d;
  return fd * (m + 1) + fd * d + 2 * (size_t)d * d;
}

// Warp 0: the diagonal block at rows / cols t0 .. t0 + d of the working
// copy. With a panel P (rows t0.. final) it first applies the pending SYRK
// update S -= P P^T to the block, in registers; then it factors and inverts
// the block (factor_common.cuh) into sD (lower, zeros above) and sLinv, and
// counts clamped pivots into *sBad.
template <typename T>
__device__ inline void factor_diag(const T* S, int ld, int t0, const T* P, int d, T eps, T* sD,
                                   T* sLinv, int* sBad, int lane) {
  T row[kMaxD], inv[kMaxD];
#pragma unroll
  for (int c = 0; c < kMaxD; ++c) {
    row[c] = T(0);
    if (lane < d && c <= lane) {
      T v = S[(size_t)(t0 + lane) * ld + t0 + c];
      if (P != nullptr) {
        T acc = T(0);
        for (int q = 0; q < d; ++q) acc += P[(size_t)(t0 + lane) * d + q] * P[(size_t)(t0 + c) * d + q];
        v -= acc;
      }
      row[c] = v;
    }
  }
  const int nbad = warp_factor_diag_any(row, inv, d, eps, lane);
  if (lane < d) {
#pragma unroll
    for (int c = 0; c < kMaxD; ++c) {
      if (c < d) {
        sD[lane * d + c] = c <= lane ? row[c] : T(0);
        sLinv[c * d + lane] = inv[c];
      }
    }
  }
  if (lane == 0) *sBad += nbad;
}

// KD: the block size d where the launcher specialises it (6, 9), so the
// loops over a block unroll with constant trip counts; kMaxD for any d.
template <typename T, bool kBlocks, int KD>
__global__ void __launch_bounds__(1024) partial_cholesky_smem_kernel(
    const T* __restrict__ F, const T* __restrict__ g, T* __restrict__ L,
    T* __restrict__ Linv, T* __restrict__ W, T* __restrict__ y,
    T* __restrict__ U, T* __restrict__ ug, int* __restrict__ bad, int nf,
    int ns, int d, T eps) {
  if (KD < kMaxD) d = KD;
  const int mb = nf + ns, fd = nf * d, sd = ns * d, m = fd + sd, ld = m + 1;
  const int dd = d * d;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  // F is [B, m, m] (dense) or [B, mb * mb, d, d] (blocks): m * m per clique
  const T* Fb = F + b * (size_t)m * m;
  const T* gb = g + b * (size_t)m;
  T* Lb = L + b * (size_t)fd * fd;
  T* Linvb = Linv + b * (size_t)nf * dd;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);  // [fd, ld] working copy
  T* sP = S + (size_t)fd * ld;            // [fd, d] current panel
  T* sD = sP + (size_t)fd * d;            // diagonal block -> its factor
  T* sLinv = sD + dd;                     // inverse of the factor
  int* sBad = reinterpret_cast<int*>(sLinv + dd);

  // working copy: S[i, c] = F[i, c] (c < m), S[i, m] = g[i], rows i < fd
  if (kBlocks) {
    // the first nf block rows of the clique are contiguous in the pool
    for (int e = tid; e < nf * mb * dd; e += nt) {
      const int blk = e / dd, r = (e - blk * dd) / d, c = e - blk * dd - r * d;
      const int bi = blk / mb, bj = blk - bi * mb;
      S[(size_t)(bi * d + r) * ld + bj * d + c] = Fb[e];
    }
  } else {
    for (int e = tid; e < fd * m; e += nt) {
      const int i = e / m, c = e - i * m;
      S[(size_t)i * ld + c] = Fb[e];
    }
  }
  for (int i = tid; i < fd; i += nt) S[(size_t)i * ld + m] = gb[i];
  if (tid == 0) *sBad = 0;
  __syncthreads();

  if (tid < 32) factor_diag(S, ld, 0, static_cast<const T*>(nullptr), d, eps, sD, sLinv, sBad, tid);
  __syncthreads();

  // Block column j, its diagonal block already factored into sD / sLinv
  // (lookahead: warp 0 factors block j + 1 during step (2) of block j)
  for (int j = 0; j < nf; ++j) {
    const int jd = j * d;

    // (1) L's block column j: zeros above, the factor, the panel below
    for (int e = tid; e < fd * d; e += nt) {
      const int i = e / d, c = e - i * d;
      T v = T(0);
      if (i >= jd + d) {  // P[i, c] = sum_k A[i, jd+k] Linv[c, k]
        const T* Si = S + (size_t)i * ld + jd;
        for (int k = 0; k <= c; ++k) v += Si[k] * sLinv[c * d + k];
        sP[e] = v;
      } else if (i >= jd && c <= i - jd) {
        v = sD[(i - jd) * d + c];
      }
      Lb[(size_t)i * fd + jd + c] = v;
    }
    for (int e = tid; e < dd; e += nt) Linvb[(size_t)j * dd + e] = sLinv[e];
    // y_j = Linv_j R_j: one thread per RHS column (F12 columns and g1)
    for (int col = fd + tid; col <= m; col += nt) {
      T r[kMaxD];
      for (int k = 0; k < d; ++k) r[k] = S[(size_t)(jd + k) * ld + col];
      for (int q = 0; q < d; ++q) {
        T acc = T(0);
        for (int k = 0; k <= q; ++k) acc += sLinv[q * d + k] * r[k];
        S[(size_t)(jd + q) * ld + col] = acc;
      }
    }
    __syncthreads();

    // (2) warp 0 updates and factors the next diagonal block (sD / sLinv
    // are not read in this step); the other warps apply the RHS update to
    // the rows below the block and the trailing SYRK to the rows below the
    // next one
    const int t0 = jd + d, nrow = fd - t0, ncol = sd + 1;
    if (tid < 32) {
      if (j + 1 < nf) factor_diag(S, ld, t0, sP, d, eps, sD, sLinv, sBad, tid);
    } else {
      for (int e = tid - 32; e < nrow * ncol; e += nt - 32) {
        const int i = t0 + e / ncol, col = fd + e % ncol;
        const T* Pi = sP + (size_t)i * d;
        T acc = T(0);
        for (int k = 0; k < d; ++k) acc += Pi[k] * S[(size_t)(jd + k) * ld + col];
        S[(size_t)i * ld + col] -= acc;
      }
      for (int e = tid - 32; e < (nrow - d) * nrow; e += nt - 32) {
        const int ii = d + e / nrow, kk = e % nrow;
        if (kk > ii) continue;  // lower triangle only
        const T* Pi = sP + (size_t)(t0 + ii) * d;
        const T* Pk = sP + (size_t)(t0 + kk) * d;
        T acc = T(0);
        for (int q = 0; q < d; ++q) acc += Pi[q] * Pk[q];
        S[(size_t)(t0 + ii) * ld + t0 + kk] -= acc;
      }
    }
    __syncthreads();
  }

  // W, y out of the working copy
  T* Wb = W + b * (size_t)fd * sd;
  T* yb = y + b * (size_t)fd;
  for (int e = tid; e < fd * sd; e += nt) {
    const int i = e / sd, s = e - i * sd;
    Wb[e] = S[(size_t)i * ld + fd + s];
  }
  for (int i = tid; i < fd; i += nt) yb[i] = S[(size_t)i * ld + m];

  if constexpr (kBlocks) {
    // K4's Schur complement U = F22 - W^T W, block by block in the output's
    // memory order, F22 read straight from the pool
    T* Ub = U + b * (size_t)sd * sd;
    for (int e = tid; e < sd * sd; e += nt) {
      const int blk = e / dd, r = (e - blk * dd) / d, cc = e - blk * dd - r * d;
      const int ab = blk / ns, cb = blk - ab * ns;
      const int a = ab * d + r, c = cb * d + cc;
      const size_t src = ((size_t)(nf + ab) * mb + nf + cb) * dd + r * d + cc;
      const T* Wa = S + fd + a;
      const T* Wc = S + fd + c;
      T acc = T(0);
      for (int f = 0; f < fd; ++f) acc += Wa[(size_t)f * ld] * Wc[(size_t)f * ld];
      Ub[e] = Fb[src] - acc;
    }
    // ug = g2 - W^T y ([ns, d] is [sd]'s memory order)
    T* ugb = ug + b * (size_t)sd;
    for (int a = tid; a < sd; a += nt) {
      T acc = T(0);
      for (int f = 0; f < fd; ++f)
        acc += S[(size_t)f * ld + fd + a] * S[(size_t)f * ld + m];
      ugb[a] = gb[fd + a] - acc;
    }
  }
  if (tid == 0) bad[b] = *sBad;
}

template <typename T, bool kBlocks>
int launch(const void* F, const void* g, void* L, void* Linv, void* W, void* y,
           void* U, void* ug, void* bad, int B, int nf, int ns, int d, T eps,
           void* stream) {
  if (B <= 0) return 0;
  if (d <= 0 || d > kMaxD || nf <= 0 || ns < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_elems(nf, ns, d) * sizeof(T) + 16;
  auto kern = d == 6 ? partial_cholesky_smem_kernel<T, kBlocks, 6>
                     : (d == 9 ? partial_cholesky_smem_kernel<T, kBlocks, 9>
                               : partial_cholesky_smem_kernel<T, kBlocks, kMaxD>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // tiny cliques (the leaves) take 64 threads, large fronts a full CTA
  const int m = (nf + ns) * d;
  const int nt = nf * d * (m + 1) <= 1024 ? 64 : (m >= 192 ? 1024 : 256);
  kern<<<B, nt, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(F), static_cast<const T*>(g), static_cast<T*>(L),
      static_cast<T*>(Linv), static_cast<T*>(W), static_cast<T*>(y),
      static_cast<T*>(U), static_cast<T*>(ug), static_cast<int*>(bad), nf, ns,
      d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define GTSAM_EXPORT(NAME, T, BLOCKS)                                          \
  extern "C" int NAME(const void* F, const void* g, void* L, void* Linv,       \
                      void* W, void* y, void* U, void* ug, void* bad, int B,   \
                      int nf, int ns, int d, T eps, void* stream) {            \
    return launch<T, BLOCKS>(F, g, L, Linv, W, y, U, ug, bad, B, nf, ns, d,    \
                             eps, stream);                                     \
  }

GTSAM_EXPORT(gtsam_partial_cholesky_smem_f32, float, false)
GTSAM_EXPORT(gtsam_partial_cholesky_smem_f64, double, false)
GTSAM_EXPORT(gtsam_partial_cholesky_blocks_f32, float, true)
GTSAM_EXPORT(gtsam_partial_cholesky_blocks_f64, double, true)
