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
// Both run one block-column chain per clique (`factor_chain`, as `_kernel`
// and `_kernel_blocks` share `col_step`) on a working copy S = [F11 | F12 |
// g1] (fd x (m+1), row-major) in dynamic shared memory, with the current
// panel P (fd x d) and the diagonal block's factor and inverse (d x d each):
// (fd (m+1) + fd d + 2 d^2) elements a clique, up to 227 KB (`fits_smem`
// in ops/cholesky.py is the same formula). Per block column j, separated by
// the team's barrier: (1) the team strides over the panel P = A[below, j]
// Linv_j^T and the RHS columns, y_j = Linv_j R_j; (2) the team's first warp
// applies the SYRK update to the next diagonal block and factors it with
// the clamped pivot rule (factor_common.cuh, lane r holding row r), one
// block of lookahead, while the rest of the team applies R -= P y_j and
// the trailing SYRK A -= P P^T. Loops over a block are unrolled for d = 6
// and 9 (template KD).
//
// K3: F [B, m, m] dense, grid = B, the CTA is the clique's team. It stops
// after W and y; U [B, sd, sd] and ug come from schur_update.cu, a second
// launch over 64 x 64 tiles of U's lower triangle. Bound by bytes, but its
// buckets are small, so what it pays is the chain's latency.
//
// K4: F as the pool slice [B * mb * mb, d, d] of row-major d x d blocks (mb
// = nf + ns), g [B, mb, d]; U out as [B, ns * ns, d, d] blocks, ug [B, ns,
// d]. It takes the leaf buckets, and on an H100 it is bound by bytes: the
// bundle-adjustment leaf (50,000 cliques, nf = 1, ns = 4, d = 9) moves
// 16.6 KB in and 14.6 KB out a clique in f64 for ~0.02 MFLOP. One small
// clique per CTA, with one warp factoring while the other waited and
// loads of a few elements a thread, kept too few bytes in flight. Design
// (`k4_plan` in ops/cholesky.py, by shape): G cliques a CTA (G = 8 for
// small leaves; G = 1, the CTA as the team, for a clique too large to
// share one). (a) The whole CTA copies each clique's first nf block rows
// of the pool (contiguous) and g1 into its working copy by cp.async, all
// of them in flight at once; 8-byte (4-byte) copies, since a pool slice
// starts wherever the bucket's blocks start. F21 is never read. (b) A warp
// runs each clique's chain and writes L, Linv, W, y. (c) The whole CTA
// forms U = F22 - W^T W and ug = g2 - W^T y in the output's memory order,
// F22 read straight from the pool, one item (clique, block row, column) a
// thread, the column's first d entries of W held in registers and the row
// entries read from shared memory (a warp's threads share the row: a
// broadcast).

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

// The clique team's barrier: a warp's (K4 with several cliques a CTA) or
// the CTA's.
template <bool kWarpTeam>
__device__ inline void team_sync() {
  if constexpr (kWarpTeam) __syncwarp();
  else __syncthreads();
}

// The block-column chain of one clique, by a team of nt threads (t = 0 ..
// nt - 1; a warp, or the whole CTA). On entry S [fd, ld] holds the working
// copy [F11 | F12 | g1] and *sBad = 0; on exit L's block columns and Linv
// are written, S's columns fd .. m hold W and y, and *sBad counts the
// clamped pivots. The team's first warp factors each diagonal block; the
// rest of the team (all of it when the team is one warp) applies the panel.
template <typename T, bool kWarpTeam>
__device__ inline void factor_chain(T* S, T* sP, T* sD, T* sLinv, int* sBad, T* Lb, T* Linvb,
                                    int nf, int ns, int d, T eps, int t, int nt) {
  const int fd = nf * d, sd = ns * d, m = fd + sd, ld = m + 1, dd = d * d;
  if (t < 32) factor_diag(S, ld, 0, static_cast<const T*>(nullptr), d, eps, sD, sLinv, sBad, t);
  team_sync<kWarpTeam>();

  // Block column j, its diagonal block already factored into sD / sLinv
  // (lookahead: the first warp factors block j + 1 during step (2) of block j)
  for (int j = 0; j < nf; ++j) {
    const int jd = j * d;

    // (1) L's block column j: zeros above, the factor, the panel below
    for (int e = t; e < fd * d; e += nt) {
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
    for (int e = t; e < dd; e += nt) Linvb[(size_t)j * dd + e] = sLinv[e];
    // y_j = Linv_j R_j: one thread per RHS column (F12 columns and g1)
    for (int col = fd + t; col <= m; col += nt) {
      T r[kMaxD];
      for (int k = 0; k < d; ++k) r[k] = S[(size_t)(jd + k) * ld + col];
      for (int q = 0; q < d; ++q) {
        T acc = T(0);
        for (int k = 0; k <= q; ++k) acc += sLinv[q * d + k] * r[k];
        S[(size_t)(jd + q) * ld + col] = acc;
      }
    }
    team_sync<kWarpTeam>();

    // (2) the first warp updates and factors the next diagonal block (sD /
    // sLinv are not read in this step); the rest of the team applies the RHS
    // update to the rows below the block and the trailing SYRK to the rows
    // below the next one
    const int t0 = jd + d, nrow = fd - t0, ncol = sd + 1;
    if (t < 32 && j + 1 < nf) factor_diag(S, ld, t0, sP, d, eps, sD, sLinv, sBad, t);
    const int r0 = kWarpTeam ? t : t - 32, rs = kWarpTeam ? nt : nt - 32;
    if (r0 >= 0) {
      for (int e = r0; e < nrow * ncol; e += rs) {
        const int i = t0 + e / ncol, col = fd + e % ncol;
        const T* Pi = sP + (size_t)i * d;
        T acc = T(0);
        for (int k = 0; k < d; ++k) acc += Pi[k] * S[(size_t)(jd + k) * ld + col];
        S[(size_t)i * ld + col] -= acc;
      }
      for (int e = r0; e < (nrow - d) * nrow; e += rs) {
        const int ii = d + e / nrow, kk = e % nrow;
        if (kk > ii) continue;  // lower triangle only
        const T* Pi = sP + (size_t)(t0 + ii) * d;
        const T* Pk = sP + (size_t)(t0 + kk) * d;
        T acc = T(0);
        for (int q = 0; q < d; ++q) acc += Pi[q] * Pk[q];
        S[(size_t)(t0 + ii) * ld + t0 + kk] -= acc;
      }
    }
    team_sync<kWarpTeam>();
  }
}

// K3. KD: the block size d where the launcher specialises it (6, 9), so the
// loops over a block unroll with constant trip counts; kMaxD for any d.
template <typename T, int KD>
__global__ void __launch_bounds__(1024) partial_cholesky_smem_kernel(
    const T* __restrict__ F, const T* __restrict__ g, T* __restrict__ L,
    T* __restrict__ Linv, T* __restrict__ W, T* __restrict__ y, int* __restrict__ bad, int nf,
    int ns, int d, T eps) {
  if (KD < kMaxD) d = KD;
  const int fd = nf * d, sd = ns * d, m = fd + sd, ld = m + 1;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const T* Fb = F + b * (size_t)m * m;
  const T* gb = g + b * (size_t)m;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);  // [fd, ld] working copy
  T* sP = S + (size_t)fd * ld;            // [fd, d] current panel
  T* sD = sP + (size_t)fd * d;            // diagonal block -> its factor
  T* sLinv = sD + d * d;                  // inverse of the factor
  int* sBad = reinterpret_cast<int*>(sLinv + d * d);

  // working copy: S[i, c] = F[i, c] (c < m), S[i, m] = g[i], rows i < fd
  for (int e = tid; e < fd * m; e += nt) {
    const int i = e / m, c = e - i * m;
    S[(size_t)i * ld + c] = Fb[e];
  }
  for (int i = tid; i < fd; i += nt) S[(size_t)i * ld + m] = gb[i];
  if (tid == 0) *sBad = 0;
  __syncthreads();

  factor_chain<T, false>(S, sP, sD, sLinv, sBad, L + b * (size_t)fd * fd,
                         Linv + b * (size_t)nf * d * d, nf, ns, d, eps, tid, nt);

  // W, y out of the working copy; U and ug come from schur_update.cu
  T* Wb = W + b * (size_t)fd * sd;
  T* yb = y + b * (size_t)fd;
  for (int e = tid; e < fd * sd; e += nt) {
    const int i = e / sd, s = e - i * sd;
    Wb[e] = S[(size_t)i * ld + fd + s];
  }
  for (int i = tid; i < fd; i += nt) yb[i] = S[(size_t)i * ld + m];
  if (tid == 0) bad[b] = *sBad;
}

// K4's register budget with a warp a clique: at most 8 warps, and two CTAs
// an SM in f64 (128 registers a thread), three in f32 (85); the 64 of a
// 1024-thread bound spilled the f64 U loop
constexpr int kK4WarpTeamThreads = 256;
template <typename T>
constexpr int k4_warp_team_min_ctas() {
  return sizeof(T) == 8 ? 2 : 3;
}

// K4: G cliques a CTA (CTA blockIdx.x takes cliques G * blockIdx.x ..), each
// with its working copy in shared memory (smem_elems apart), then G bad-pivot
// counters. kWarpTeam: each clique's chain is one warp's (G > 1), else the
// CTA's (G = 1).
template <typename T, int KD, bool kWarpTeam>
__global__ void __launch_bounds__(kWarpTeam ? kK4WarpTeamThreads : 1024,
                                  kWarpTeam ? k4_warp_team_min_ctas<T>() : 1)
    partial_cholesky_blocks_kernel(
    const T* __restrict__ F, const T* __restrict__ g, T* __restrict__ L,
    T* __restrict__ Linv, T* __restrict__ W, T* __restrict__ y, T* __restrict__ U,
    T* __restrict__ ug, int* __restrict__ bad, int B, int nf, int ns, int d, int G, T eps) {
  if (KD < kMaxD) d = KD;
  const int mb = nf + ns, fd = nf * d, sd = ns * d, m = fd + sd, ld = m + 1, dd = d * d;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t b0 = (size_t)blockIdx.x * G;
  const int nc = B - static_cast<int>(b0) < G ? B - static_cast<int>(b0) : G;
  const size_t per = smem_elems(nf, ns, d);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* base = reinterpret_cast<T*>(smem_raw);
  int* sBad = reinterpret_cast<int*>(base + G * per);

  // (a) copies, the whole CTA: each clique's first nf block rows of the pool
  // (contiguous) and g1 into its working copy, by cp.async; F21 and F22 stay
  // in device memory
  const int nblk = nf * mb * dd;
  for (int c = 0; c < nc; ++c) {
    const T* Fb = F + (b0 + c) * (size_t)m * m;
    T* S = base + c * per;
    for (int e = tid; e < nblk; e += nt) {
      const int blk = e / dd, rem = e - blk * dd, r = rem / d, cc = rem - r * d;
      const int bi = nf == 1 ? 0 : blk / mb, bj = blk - bi * mb;
      cp_async_elem(S + (size_t)(bi * d + r) * ld + bj * d + cc, Fb + e);
    }
    const T* gb = g + (b0 + c) * (size_t)m;
    for (int i = tid; i < fd; i += nt) cp_async_elem(S + (size_t)i * ld + m, gb + i);
  }
  cp_async_commit();
  if (tid < nc) sBad[tid] = 0;
  cp_async_wait<0>();
  __syncthreads();

  // (b) each clique's chain by its team, then its W and y out
  const int tn = kWarpTeam ? 32 : nt, tt = tid % tn;
  for (int c = tid / tn; c < nc; c += nt / tn) {
    T* S = base + c * per;
    T* sP = S + (size_t)fd * ld;
    T* sD = sP + (size_t)fd * d;
    T* sLinv = sD + dd;
    const size_t b = b0 + c;
    factor_chain<T, kWarpTeam>(S, sP, sD, sLinv, sBad + c, L + b * fd * fd,
                               Linv + b * nf * dd, nf, ns, d, eps, tt, tn);
    T* Wb = W + b * fd * sd;
    for (int i = 0; i < fd; ++i)
      for (int s = tt; s < sd; s += tn) Wb[(size_t)i * sd + s] = S[(size_t)i * ld + fd + s];
    for (int i = tt; i < fd; i += tn) y[b * fd + i] = S[(size_t)i * ld + m];
  }
  __syncthreads();

  // (c) U = F22 - W^T W and ug = g2 - W^T y, the whole CTA, in the output's
  // memory order: item (clique, block row ab, column) writes rows ab*d ..
  // of that column, F22 read straight from the pool; the column's first d
  // entries of W in registers
  for (int idx = tid; idx < nc * ns * sd; idx += nt) {
    const int c = idx / (ns * sd), rem = idx - c * ns * sd, ab = rem / sd, col = rem - ab * sd;
    const int cb = col / d, cc = col - cb * d;
    const size_t b = b0 + c;
    const T* S = base + c * per;
    const T* Wc = S + fd + col;
    T wc[kMaxD];
#pragma unroll
    for (int q = 0; q < kMaxD; ++q) wc[q] = q < d ? Wc[(size_t)q * ld] : T(0);
    // this item's d entries of F22, all loads in flight before the sums
    const T* F22 = F + b * (size_t)m * m + ((size_t)(nf + ab) * mb + nf + cb) * dd + cc;
    T f22[kMaxD];
#pragma unroll
    for (int r = 0; r < kMaxD; ++r) f22[r] = r < d ? F22[r * d] : T(0);
    T* Ub = U + b * (size_t)sd * sd + ((size_t)ab * ns + cb) * dd + cc;
#pragma unroll
    for (int r = 0; r < kMaxD; ++r) {
      if (r < d) {
        const T* Wa = S + fd + ab * d + r;
        T acc = T(0);
#pragma unroll
        for (int q = 0; q < kMaxD; ++q)
          if (q < d) acc += Wa[(size_t)q * ld] * wc[q];
        for (int f = d; f < fd; ++f) acc += Wa[(size_t)f * ld] * Wc[(size_t)f * ld];
        Ub[r * d] = f22[r] - acc;
      }
    }
    if (ab == 0) {  // ug = g2 - W^T y, [ns, d] is [sd]'s memory order
      T acc = T(0);
      for (int f = 0; f < fd; ++f) acc += Wc[(size_t)f * ld] * S[(size_t)f * ld + m];
      ug[b * sd + col] = g[b * (size_t)m + fd + col] - acc;
    }
  }
  if (tid < nc) bad[b0 + tid] = sBad[tid];
}

template <typename T>
int launch_smem(const void* F, const void* g, void* L, void* Linv, void* W, void* y,
                void* bad, int B, int nf, int ns, int d, T eps, void* stream) {
  if (B <= 0) return 0;
  if (d <= 0 || d > kMaxD || nf <= 0 || ns < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_elems(nf, ns, d) * sizeof(T) + 16;
  auto kern = d == 6 ? partial_cholesky_smem_kernel<T, 6>
                     : (d == 9 ? partial_cholesky_smem_kernel<T, 9>
                               : partial_cholesky_smem_kernel<T, kMaxD>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // tiny cliques take 64 threads, large fronts a full CTA
  const int m = (nf + ns) * d;
  const int nt = nf * d * (m + 1) <= 1024 ? 64 : (m >= 192 ? 1024 : 256);
  kern<<<B, nt, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(F), static_cast<const T*>(g), static_cast<T*>(L),
      static_cast<T*>(Linv), static_cast<T*>(W), static_cast<T*>(y), static_cast<int*>(bad),
      nf, ns, d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kWarpTeam>
auto blocks_kernel_for(int d) {
  return d == 6 ? partial_cholesky_blocks_kernel<T, 6, kWarpTeam>
                : (d == 9 ? partial_cholesky_blocks_kernel<T, 9, kWarpTeam>
                          : partial_cholesky_blocks_kernel<T, kMaxD, kWarpTeam>);
}

// G, threads and smem from ops/cholesky.py k4_plan
template <typename T>
int launch_blocks(const void* F, const void* g, void* L, void* Linv, void* W, void* y,
                  void* U, void* ug, void* bad, int B, int nf, int ns, int d, T eps, int G,
                  int threads, int smem, void* stream) {
  if (B <= 0) return 0;
  if (d <= 0 || d > kMaxD || nf <= 0 || ns < 0 || G < 1 || threads % 32 ||
      (G > 1 && threads < 32 * G))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = G > 1 ? blocks_kernel_for<T, true>(d) : blocks_kernel_for<T, false>(d);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<(B + G - 1) / G, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(F), static_cast<const T*>(g), static_cast<T*>(L),
      static_cast<T*>(Linv), static_cast<T*>(W), static_cast<T*>(y), static_cast<T*>(U),
      static_cast<T*>(ug), static_cast<int*>(bad), B, nf, ns, d, G, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gtsam_partial_cholesky_smem_f32(const void* F, const void* g, void* L,
                                               void* Linv, void* W, void* y, void* bad, int B,
                                               int nf, int ns, int d, float eps, void* stream) {
  return launch_smem<float>(F, g, L, Linv, W, y, bad, B, nf, ns, d, eps, stream);
}
extern "C" int gtsam_partial_cholesky_smem_f64(const void* F, const void* g, void* L,
                                               void* Linv, void* W, void* y, void* bad, int B,
                                               int nf, int ns, int d, double eps, void* stream) {
  return launch_smem<double>(F, g, L, Linv, W, y, bad, B, nf, ns, d, eps, stream);
}

#define GTSAM_EXPORT_BLOCKS(NAME, T)                                                         \
  extern "C" int NAME(const void* F, const void* g, void* L, void* Linv, void* W, void* y,   \
                      void* U, void* ug, void* bad, int B, int nf, int ns, int d, T eps,     \
                      int G, int threads, int smem, void* stream) {                          \
    return launch_blocks<T>(F, g, L, Linv, W, y, U, ug, bad, B, nf, ns, d, eps, G, threads,  \
                            smem, stream);                                                   \
  }

GTSAM_EXPORT_BLOCKS(gtsam_partial_cholesky_blocks_f32, float)
GTSAM_EXPORT_BLOCKS(gtsam_partial_cholesky_blocks_f64, double)
