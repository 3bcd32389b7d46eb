// K1: whole-bucket partial Cholesky for fronts too large for K3 (sm_90a).
//
// Replaces the Pallas TPU kernel gtsam_petercdev_tpu/ops/cholesky_v2.py
// `partial_cholesky` (`_kernel`, pallas_call in `_build`). For each clique b
// of a bucket, with frontal matrix F [m, m] (m = fd + sd, fd = nf*d,
// sd = ns*d) and right-hand side g [m], it computes
//   L    [fd, fd]    lower Cholesky factor of F11 (by d x d block columns)
//   Linv [nf, d, d]  inverses of L's diagonal blocks
//   W    [fd, sd]    = L^-1 F12,     y  [fd] = L^-1 g1
//   U    [sd, sd]    = F22 - W^T W,  ug [sd] = g2 - W^T y
//   bad              pivots <= eps, each clamped to eps (choleskyCareful);
//                    LM rejects a trial on this count, so the rule matches
//                    inference/kernels.py exactly.
//
// What bounds it on an H100. The buckets routed here are few and large: the
// 2,500-pose sphere plan sends 11 buckets of 1 or 2 cliques (fd = 72 .. 192,
// sd up to 576) and the bundle-adjustment plan the (1, 12, 24) front and the
// root. By operations the root (fd = 192, sd = 576) is ~70 M FMA, dominated
// by U (fd sd^2); by bytes it moves F and the outputs once. Either way it is
// microseconds of the card's time, if the work is spread over the card: the
// bucket has one or two cliques, so a kernel of one CTA per clique uses 1 or
// 2 of the 132 SMs for all of it, and the chain of nf diagonal factors, each
// d steps long, is sequential.
//
// Design: three launches per bucket on the current stream, no host sync.
//   (a) factor_kernel, grid B: F11 = L L^T, Linv, bad. One CTA per clique
//       (the block-column chain is sequential). F11's lower triangle is held
//       PACKED in dynamic shared memory (fd (fd + 1) / 2 elements: 148 KB at
//       fd = 192 in f64, 188 KB at the BA root fd = 216). Per block column:
//       threads form the panel rows; then warp 0 applies the SYRK update to
//       the NEXT diagonal block and factors and inverts it (factor_common.cuh,
//       shuffles) while the other warps apply the trailing SYRK to the rows
//       below it, so the d-step chain of each diagonal factor hides behind
//       the update (one block of lookahead; two barriers a block column).
//       The loops over a block unroll for d = 6 and 9 (template KD), which
//       keeps the warp's rows in registers. A front whose packed F11 does
//       not fit 227 KB (fd > 240 in f64, fd > 340 in f32) runs the same loop
//       on a global scratch copy [B, fd, fd] instead (kPacked = false): the
//       branch is chosen by shape in ops/cholesky_v2.py `k1_plan`.
//   (b) solve_kernel, grid (B, slabs): [W | y] = L^-1 [F12 | g1], column
//       slabs of kSlab = 32 of the sd + 1 columns, independent of each
//       other, so the root's 577 columns spread over 19 SMs. A CTA keeps its
//       slab in shared memory and walks L's nf block columns by blocks,
//       y_j = Linv_j X_j, then X_i -= L_ij y_j; block column j + 1 of L is
//       staged into shared memory by cp.async while column j is applied.
//       A front whose slab and two staged block columns do not fit 227 KB
//       ((fd (kSlab + 2 d) + ...) * sizeof(T): fd > 572 at d = 9 in f64; of
//       the planner's fronts, nf = 32 with d >= 15) runs the same walk on
//       its columns in place in W and y, reading L from global memory
//       (kStaged = false), again chosen by shape in `k1_plan`. With both
//       branches, K1 takes a front of any size, as the one-CTA kernel did.
//   (c) schur_update.cu, grid (B, tiles): U, ug on the FP64 tensor cores
//       (f32: register-tiled FFMA), tiles of 64 x 64 over the card.
// The wrapper allocates every output and the scratch with torch.empty and
// checks cudaGetLastError after each launch.

#include <cuda_runtime.h>

#include "factor_common.cuh"

namespace {

using namespace gtsam_cuda;

constexpr int kSlab = 32;            // columns of [F12 | g1] per solve CTA (ops SLAB)
constexpr int kSolveThreads = 512;   // 16 warps; lane = column of the slab
constexpr int kFactorThreads = 512;  // most threads of a factor CTA

// element (i, k), k <= i, of F11's working copy: packed lower triangle in
// shared memory, or the dense [fd, fd] global scratch
template <bool kPacked>
__device__ inline size_t at(int i, int k, int fd) {
  return kPacked ? (size_t)i * (i + 1) / 2 + k : (size_t)i * fd + k;
}

// Warp 0: the diagonal block at rows / cols t0 .. t0 + d. With `jd` >= 0 it
// first applies block column jd's pending SYRK update to the block (the
// panel rows t0.. are final), in registers; then it factors and inverts the
// block (factor_common.cuh), writes the factor in place and the inverse to
// sLinv, and counts clamped pivots into *sBad.
template <typename T, bool kPacked>
__device__ inline void factor_block(T* A, int fd, int t0, int jd, int d, T eps, T* sLinv,
                                    int* sBad, int lane) {
  T row[kMaxD], inv[kMaxD];
#pragma unroll
  for (int c = 0; c < kMaxD; ++c) {
    row[c] = T(0);
    if (lane < d && c <= lane) {
      T v = A[at<kPacked>(t0 + lane, t0 + c, fd)];
      if (jd >= 0) {
        T acc = T(0);
        for (int q = 0; q < d; ++q)
          acc += A[at<kPacked>(t0 + lane, jd + q, fd)] * A[at<kPacked>(t0 + c, jd + q, fd)];
        v -= acc;
      }
      row[c] = v;
    }
  }
  const int nbad = warp_factor_diag_any(row, inv, d, eps, lane);
  if (lane < d) {
#pragma unroll
    for (int c = 0; c < kMaxD; ++c) {
      if (c <= lane) A[at<kPacked>(t0 + lane, t0 + c, fd)] = row[c];
      if (c < d) sLinv[c * d + lane] = inv[c];
    }
  }
  if (lane == 0) *sBad += nbad;
}

// KD: the block size d where the launcher specialises it (6, 9), so the
// loops over a block unroll with constant trip counts; kMaxD for any d.
template <typename T, bool kPacked, int KD>
__global__ void __launch_bounds__(kFactorThreads) factor_kernel(
    const T* __restrict__ F, T* __restrict__ scratch, T* __restrict__ L,
    T* __restrict__ Linv, int* __restrict__ bad, int nf, int m, int d, T eps) {
  if (KD < kMaxD) d = KD;
  const int fd = nf * d, dd = d * d;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid % 32, w = tid / 32;
  const T* Fb = F + b * (size_t)m * m;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sLinv = reinterpret_cast<T*>(smem_raw);           // [2][d, d] inverses, by parity of j
  int* sBad = reinterpret_cast<int*>(sLinv + 2 * dd);  // (16 bytes)
  T* A = kPacked ? reinterpret_cast<T*>(smem_raw + 2 * dd * sizeof(T) + 16)
                 : scratch + b * (size_t)fd * fd;

  // working copy: F11's lower triangle
  for (int e = tid; e < fd * fd; e += nt) {
    const int i = e / fd, k = e - i * fd;
    if (k <= i) A[at<kPacked>(i, k, fd)] = Fb[(size_t)i * m + k];
  }
  if (tid == 0) *sBad = 0;
  __syncthreads();
  if (w == 0) factor_block<T, kPacked>(A, fd, 0, -1, d, eps, sLinv, sBad, lane);
  __syncthreads();

  // Block column j, its diagonal block already factored (lookahead):
  //   (1) the panel below it, in place, and Linv_j out;
  //   (2) warp 0 updates and factors the next diagonal block while the other
  //       warps apply the trailing SYRK A -= P P^T to the rows below it.
  for (int j = 0; j < nf; ++j) {
    const int jd = j * d, t0 = jd + d;
    const T* cur = sLinv + (j & 1) * dd;
    // (1) P[i, c] = sum_k A[i, jd+k] Linv[c, k]
    for (int i = t0 + tid; i < fd; i += nt) {
      T a[kMaxD];
#pragma unroll
      for (int k = 0; k < kMaxD; ++k) a[k] = k < d ? A[at<kPacked>(i, jd + k, fd)] : T(0);
#pragma unroll
      for (int c = 0; c < kMaxD; ++c) {
        if (c < d) {
          T v = T(0);
#pragma unroll
          for (int k = 0; k <= c; ++k) v += a[k] * cur[c * d + k];
          A[at<kPacked>(i, jd + c, fd)] = v;
        }
      }
    }
    for (int e = tid; e < dd; e += nt) Linv[(b * nf + j) * dd + e] = cur[e];
    __syncthreads();

    // (2) rows t0 + d .. fd by warps 1.., a warp per row (its panel row in
    // registers), lanes along the columns t0 .. i
    if (w == 0) {
      if (j + 1 < nf)
        factor_block<T, kPacked>(A, fd, t0, jd, d, eps, sLinv + ((j + 1) & 1) * dd, sBad, lane);
    } else {
      for (int i = t0 + d + w - 1; i < fd; i += nt / 32 - 1) {
        T pi[kMaxD];
#pragma unroll
        for (int q = 0; q < kMaxD; ++q) pi[q] = q < d ? A[at<kPacked>(i, jd + q, fd)] : T(0);
        for (int k = t0 + lane; k <= i; k += 32) {
          T acc = T(0);
#pragma unroll
          for (int q = 0; q < kMaxD; ++q)
            if (q < d) acc += pi[q] * A[at<kPacked>(k, jd + q, fd)];
          A[at<kPacked>(i, k, fd)] -= acc;
        }
      }
    }
    __syncthreads();
  }

  T* Lb = L + b * (size_t)fd * fd;
  for (int e = tid; e < fd * fd; e += nt) {
    const int i = e / fd, k = e - i * fd;
    Lb[e] = k <= i ? A[at<kPacked>(i, k, fd)] : T(0);
  }
  if (tid == 0) bad[b] = *sBad;
}

// stage block column j of L (rows jd .. fd, its d columns) and Linv_j into
// shared memory, asynchronously
template <typename T>
__device__ inline void stage_column(T* sP, T* sLinv, const T* Lb, const T* Linvj, int fd, int jd,
                                    int d, int tid) {
  for (int e = tid; e < (fd - jd) * d; e += kSolveThreads)
    cp_async_elem(sP + e, Lb + (size_t)(jd + e / d) * fd + jd + e % d);
  for (int e = tid; e < d * d; e += kSolveThreads) cp_async_elem(sLinv + e, Linvj + e);
  cp_async_commit();
}

// kStaged: the slab [fd, kSlab] and two of L's block columns live in shared
// memory; else (a front too large for that) each lane works on its column in
// place in W or y and reads L and Linv straight from global memory
template <typename T, bool kStaged>
__global__ void __launch_bounds__(kSolveThreads) solve_kernel(
    const T* __restrict__ F, const T* __restrict__ g, const T* __restrict__ L,
    const T* __restrict__ Linv, T* __restrict__ W, T* __restrict__ y, int nf, int m, int d) {
  const int fd = nf * d, sd = m - fd, dd = d * d;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32, nw = kSolveThreads / 32;
  const int col = blockIdx.y * kSlab + lane;  // column of [F12 | g1]
  const bool live = col <= sd;                // lanes past the last column idle
  const T* Fb = F + b * (size_t)m * m;
  const T* Lb = L + b * (size_t)fd * fd;
  const T* Linvb = Linv + b * (size_t)nf * dd;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sY = reinterpret_cast<T*>(smem_raw);  // [d, kSlab] y_j
  T* X = sY + (size_t)d * kSlab;           // kStaged: [fd, kSlab] the slab
  T* sP = X + (size_t)fd * kSlab;          // kStaged: [2][fd, d] L's block column j, rows jd..
  T* sLinv = sP + 2 * (size_t)fd * d;      // kStaged: [2][d, d]
  // this lane's column, element i at xc[i * xs]
  T* xc = kStaged ? X + lane : (col < sd ? W + b * (size_t)fd * sd + col : y + b * (size_t)fd);
  const size_t xs = kStaged ? kSlab : (col < sd ? sd : 1);

  if (live)
    for (int i = w; i < fd; i += nw)
      xc[i * xs] = col < sd ? Fb[(size_t)i * m + fd + col] : g[b * (size_t)m + i];
  if (kStaged) stage_column(sP, sLinv, Lb, Linvb, fd, 0, d, tid);

  // per block column j (two barriers): y_j = Linv_j X_j, then X_j = y_j and
  // X_i -= L_ij y_j below; column j + 1 loads meanwhile
  for (int j = 0; j < nf; ++j) {
    const int jd = j * d, cur = j & 1;
    if (kStaged) cp_async_wait<0>();
    __syncthreads();  // column j staged; X final up to row jd + d; buffer cur ^ 1 free
    if (kStaged && j + 1 < nf)
      stage_column(sP + (cur ^ 1) * (size_t)fd * d, sLinv + (cur ^ 1) * dd, Lb,
                   Linvb + (j + 1) * dd, fd, jd + d, d, tid);
    const T* Li = kStaged ? sLinv + cur * dd : Linvb + (size_t)j * dd;
    if (live)
      for (int q = w; q < d; q += nw) {
        T acc = T(0);
        for (int k = 0; k <= q; ++k) acc += Li[q * d + k] * xc[(jd + k) * xs];
        sY[q * kSlab + lane] = acc;
      }
    __syncthreads();
    if (live)
      for (int i = jd + w; i < fd; i += nw) {
        if (i < jd + d) {
          xc[i * xs] = sY[(i - jd) * kSlab + lane];
        } else {
          const T* Pi = kStaged ? sP + cur * (size_t)fd * d + (size_t)(i - jd) * d
                                : Lb + (size_t)i * fd + jd;
          T acc = T(0);
          for (int k = 0; k < d; ++k) acc += Pi[k] * sY[k * kSlab + lane];
          xc[i * xs] -= acc;
        }
      }
  }

  if (kStaged) {
    __syncthreads();
    if (live)
      for (int i = w; i < fd; i += nw) {
        if (col < sd) W[(b * fd + i) * (size_t)sd + col] = X[i * kSlab + lane];
        else y[b * fd + i] = X[i * kSlab + lane];
      }
  }
}

template <typename T, bool kPacked>
auto pick_factor(int d) {
  return d == 6 ? factor_kernel<T, kPacked, 6>
                : (d == 9 ? factor_kernel<T, kPacked, 9> : factor_kernel<T, kPacked, kMaxD>);
}

template <typename T>
int launch_factor(const void* F, void* scratch, void* L, void* Linv, void* bad, int B,
                  int nf, int m, int d, T eps, int packed, int threads, int smem,
                  void* stream) {
  if (B <= 0) return 0;
  if (d <= 0 || d > kMaxD || nf <= 0 || threads % 32 || threads < 64 || threads > kFactorThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = packed ? pick_factor<T, true>(d) : pick_factor<T, false>(d);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(F), static_cast<T*>(scratch), static_cast<T*>(L),
      static_cast<T*>(Linv), static_cast<int*>(bad), nf, m, d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_solve(const void* F, const void* g, const void* L, const void* Linv, void* W,
                 void* y, int B, int nf, int m, int d, int slabs, int staged, int smem,
                 void* stream) {
  if (B <= 0) return 0;
  const int sd = m - nf * d;
  if (d <= 0 || d > kMaxD || nf <= 0 || slabs != (sd + kSlab) / kSlab)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = staged ? solve_kernel<T, true> : solve_kernel<T, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B, slabs);
  kern<<<grid, kSolveThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(F), static_cast<const T*>(g), static_cast<const T*>(L),
      static_cast<const T*>(Linv), static_cast<T*>(W), static_cast<T*>(y), nf, m, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// stage (a): F, scratch (kPacked = false only), L, Linv, bad, B, nf, m, d,
// eps, packed, threads, dynamic shared-memory bytes, stream
#define GTSAM_K1_FACTOR(NAME, T)                                                       \
  extern "C" int NAME(const void* F, void* scratch, void* L, void* Linv, void* bad,    \
                      int B, int nf, int m, int d, T eps, int packed, int threads,     \
                      int smem, void* stream) {                                        \
    return launch_factor<T>(F, scratch, L, Linv, bad, B, nf, m, d, eps, packed,       \
                            threads, smem, stream);                                    \
  }
// stage (b): F, g, L, Linv, W, y, B, nf, m, d, slabs, staged, shared-memory
// bytes, stream
#define GTSAM_K1_SOLVE(NAME, T)                                                        \
  extern "C" int NAME(const void* F, const void* g, const void* L, const void* Linv,  \
                      void* W, void* y, int B, int nf, int m, int d, int slabs,        \
                      int staged, int smem, void* stream) {                            \
    return launch_solve<T>(F, g, L, Linv, W, y, B, nf, m, d, slabs, staged, smem,     \
                           stream);                                                    \
  }

GTSAM_K1_FACTOR(gtsam_k1_factor_f32, float)
GTSAM_K1_FACTOR(gtsam_k1_factor_f64, double)
GTSAM_K1_SOLVE(gtsam_k1_solve_f32, float)
GTSAM_K1_SOLVE(gtsam_k1_solve_f64, double)
