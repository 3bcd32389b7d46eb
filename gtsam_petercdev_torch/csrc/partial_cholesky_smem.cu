// K3 and K4: per-clique partial Cholesky with the clique's working copy in
// shared memory, one CTA per clique (sm_90a).
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
//   K3 (kBlocks = false): F [B, m, m] dense, U [B, sd, sd], ug [B, sd];
//   K4 (kBlocks = true):  F as the pool slice [B * mb * mb, d, d] of row-major
//       d x d blocks (mb = nf + ns), g [B, mb, d]; U as [B, ns * ns, d, d]
//       blocks, ug [B, ns, d]. No [B, m, m] tensor exists for its buckets.
//
// Design (correctness first). Grid = B, one CTA per clique. Dynamic shared
// memory holds the working copy S = [F11 | F12 | g1] (fd x (m+1), row-major),
// the current panel P (fd x d), the diagonal block's factor and its inverse
// (d x d each) and the bad-pivot counter: (fd (m+1) + fd d + 2 d^2) elements
// + 16 bytes, up to the card's 227 KB per CTA (the launcher raises the
// kernel's dynamic limit above 48 KB). The wrapper's `fits_smem` is the same
// formula; a clique that does not fit is refused there. Each F element of the
// first fd rows is read from global memory once, the F22 part once more when
// U is formed; nothing but the outputs is written. Per block column j,
// separated by __syncthreads():
//   (a) one thread factors the d x d diagonal block with the clamped pivot
//       rule and inverts it by forward substitution;
//   (b) threads stride over the panel P = A[below, j] Linv_j^T (to L and to
//       shared memory) and over the RHS columns, y_j = Linv_j R_j;
//   (c) threads stride over the RHS update R -= P y_j and the trailing SYRK
//       A -= P P^T (lower triangle), all operands in shared memory.
// Then W, y leave the working copy and U, ug are formed from it.
//
// What bounds it on an H100: bytes. The bundle-adjustment leaf bucket
// (50,000 cliques, nf = 1, ns = 4, d = 9) moves 16 KB (f64) of pool in and
// 13 KB out per clique for ~0.02 MFLOP, far below the card's balance point.
// The kernel reads and writes each byte once, so its distance from the
// floor is occupancy and latency: a leaf clique needs 3.4 KB of shared
// memory and 64 threads, so ~32 cliques share an SM.
//
// First things to improve: several tiny cliques per CTA (one warp each), the
// diagonal block factored by a warp instead of one thread, and tensor-core
// products for the large K3 fronts.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxD = 16;

__device__ inline float sqrt_t(float x) { return sqrtf(x); }
__device__ inline double sqrt_t(double x) { return sqrt(x); }

// shared-memory elements of type T one clique needs (then 16 bytes more)
__host__ __device__ inline size_t smem_elems(int nf, int ns, int d) {
  const size_t fd = (size_t)nf * d, m = (size_t)(nf + ns) * d;
  return fd * (m + 1) + fd * d + 2 * (size_t)d * d;
}

template <typename T, bool kBlocks>
__global__ void __launch_bounds__(1024) partial_cholesky_smem_kernel(
    const T* __restrict__ F, const T* __restrict__ g, T* __restrict__ L,
    T* __restrict__ Linv, T* __restrict__ W, T* __restrict__ y,
    T* __restrict__ U, T* __restrict__ ug, int* __restrict__ bad, int nf,
    int ns, int d, T eps) {
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

  for (int j = 0; j < nf; ++j) {
    const int jd = j * d;

    // (a) factor + invert the diagonal block (d <= 16: one thread)
    if (tid == 0) {
      for (int r = 0; r < d; ++r)
        for (int c = 0; c <= r; ++c)
          sD[r * d + c] = S[(size_t)(jd + r) * ld + jd + c];
      int nbad = 0;
      for (int k = 0; k < d; ++k) {
        T p = sD[k * d + k];
        if (p <= eps) {  // clamp-and-count, eps = 1e-10 in both types
          ++nbad;
          p = eps;
        }
        const T piv = sqrt_t(p);
        sD[k * d + k] = piv;
        for (int i = k + 1; i < d; ++i) sD[i * d + k] = sD[i * d + k] / piv;
        for (int i = k + 1; i < d; ++i)
          for (int c = k + 1; c <= i; ++c)
            sD[i * d + c] -= sD[i * d + k] * sD[c * d + k];
      }
      for (int c = 0; c < d; ++c) {  // L^-1 by forward substitution
        for (int r = 0; r < c; ++r) sLinv[r * d + c] = T(0);
        sLinv[c * d + c] = T(1) / sD[c * d + c];
        for (int r = c + 1; r < d; ++r) {
          T acc = T(0);
          for (int k = c; k < r; ++k) acc += sD[r * d + k] * sLinv[k * d + c];
          sLinv[r * d + c] = -acc / sD[r * d + r];
        }
      }
      *sBad += nbad;
    }
    __syncthreads();

    // (b) L's block column j: zeros above, the factor, the panel below
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

    // (c) RHS update and trailing SYRK on rows below the block
    const int t0 = jd + d, nrow = fd - t0, ncol = sd + 1;
    for (int e = tid; e < nrow * ncol; e += nt) {
      const int i = t0 + e / ncol, col = fd + e % ncol;
      const T* Pi = sP + (size_t)i * d;
      T acc = T(0);
      for (int k = 0; k < d; ++k) acc += Pi[k] * S[(size_t)(jd + k) * ld + col];
      S[(size_t)i * ld + col] -= acc;
    }
    for (int e = tid; e < nrow * nrow; e += nt) {
      const int ii = e / nrow, kk = e - ii * nrow;
      if (kk > ii) continue;  // lower triangle only
      const T* Pi = sP + (size_t)(t0 + ii) * d;
      const T* Pk = sP + (size_t)(t0 + kk) * d;
      T acc = T(0);
      for (int q = 0; q < d; ++q) acc += Pi[q] * Pk[q];
      S[(size_t)(t0 + ii) * ld + t0 + kk] -= acc;
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

  // Schur complement U = F22 - W^T W; e runs in the OUTPUT's memory order
  // (dense rows, or block by block), and F22 is read straight from F
  T* Ub = U + b * (size_t)sd * sd;
  for (int e = tid; e < sd * sd; e += nt) {
    int a, c;
    size_t src;
    if (kBlocks) {
      const int blk = e / dd, r = (e - blk * dd) / d, cc = e - blk * dd - r * d;
      const int ab = blk / ns, cb = blk - ab * ns;
      a = ab * d + r;
      c = cb * d + cc;
      src = ((size_t)(nf + ab) * mb + nf + cb) * dd + r * d + cc;
    } else {
      a = e / sd;
      c = e - a * sd;
      src = (size_t)(fd + a) * m + fd + c;
    }
    const T* Wa = S + fd + a;
    const T* Wc = S + fd + c;
    T acc = T(0);
    for (int f = 0; f < fd; ++f) acc += Wa[(size_t)f * ld] * Wc[(size_t)f * ld];
    Ub[e] = Fb[src] - acc;
  }
  // ug = g2 - W^T y ([sd] and [ns, d] are the same memory order)
  T* ugb = ug + b * (size_t)sd;
  for (int a = tid; a < sd; a += nt) {
    T acc = T(0);
    for (int f = 0; f < fd; ++f)
      acc += S[(size_t)f * ld + fd + a] * S[(size_t)f * ld + m];
    ugb[a] = gb[fd + a] - acc;
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
  auto kern = partial_cholesky_smem_kernel<T, kBlocks>;
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
