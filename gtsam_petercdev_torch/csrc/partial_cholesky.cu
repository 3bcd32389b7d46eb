// K1: whole-bucket partial Cholesky, one CTA per clique (sm_90a).
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
// Design (correctness first). Grid = B, one CTA per clique: 1024 threads for
// fronts of m >= 192, else 256. The per-clique working copy [F11 | F12 | g1] (fd x (m+1), row-major) lives in a
// scratch tensor the wrapper allocates; only its lower F11 triangle is kept
// current. Per block column j, separated by __syncthreads():
//   (a) one thread factors the d x d diagonal block in shared memory with the
//       clamped pivot rule and inverts it by forward substitution (exact for a
//       triangular factor, like the plain version's Newton iteration; the two
//       agree to rounding);
//   (b) threads stride over the panel P = A[below, j] Linv_j^T (written to L),
//       and over the RHS columns, y_j = Linv_j R_j;
//   (c) threads stride over the RHS update R -= P y_j and the trailing SYRK
//       A -= P P^T (lower triangle).
// Then U = F22 - W^T W is formed tile by tile (64 x 64 or 32 x 32 outputs,
// 2 x 2 per thread) with W staged through shared memory, and ug from the
// scratch rows. Nothing is sized to shared
// memory but the d x d tiles, so every bucket runs here, the m = 768 root
// front of the 2,500-pose sphere plan included.
//
// What bounds it on an H100: the bucket's bytes. The many small buckets
// (m = 30 at B = 1150 on the sphere plan) do ~0.6 flop per byte moved, far
// below the card's balance point, so the floor is F, g in and L, W, U out at
// 3.35 TB/s; the working copy round-trips through L2. The kernel does not
// reach that floor: the block-column loop is a chain of nf dependent steps,
// three barriers each, with one thread factoring each diagonal block, and the
// RHS and trailing updates read their operands from L2.
//
// First thing to improve: the root buckets (B = 1) and every large front run
// on ONE SM of 132. Split a large clique over several CTAs (U tiles and RHS
// column blocks), use tensor-core DMMA for f64 / wgmma for f32, and keep the
// panel P and y_j in shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxD = 16;
constexpr int kMaxThreads = 1024;
constexpr int kTile = 32;   // threads per U-tile edge at 1024 threads (16 at 256)
constexpr int kChunk = 16;  // rows of W staged per step of the U product

__device__ inline float sqrt_t(float x) { return sqrtf(x); }
__device__ inline double sqrt_t(double x) { return sqrt(x); }

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) partial_cholesky_kernel(
    const T* __restrict__ F, const T* __restrict__ g, T* __restrict__ S,
    T* __restrict__ L, T* __restrict__ Linv, T* __restrict__ W,
    T* __restrict__ y, T* __restrict__ U, T* __restrict__ ug,
    int* __restrict__ bad, int nf, int ns, int d, T eps) {
  const int fd = nf * d, sd = ns * d, m = fd + sd, ldS = m + 1;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const T* Fb = F + b * m * m;
  const T* gb = g + b * m;
  T* Sb = S + b * fd * ldS;
  T* Lb = L + b * fd * fd;
  T* Linvb = Linv + b * nf * d * d;

  __shared__ T sD[kMaxD * kMaxD];     // diagonal block -> its factor (lower)
  __shared__ T sLinv[kMaxD * kMaxD];  // inverse of the factor (lower)
  __shared__ int sBad;

  // working copy: S[i, c] = F[i, c] (c < m), S[i, m] = g[i], rows i < fd
  for (int e = tid; e < fd * ldS; e += nt) {
    const int i = e / ldS, c = e - i * ldS;
    Sb[e] = (c < m) ? Fb[(size_t)i * m + c] : gb[i];
  }
  if (tid == 0) sBad = 0;
  __syncthreads();

  for (int j = 0; j < nf; ++j) {
    const int jd = j * d;

    // (a) factor + invert the diagonal block (d <= 16: one thread)
    if (tid == 0) {
      for (int r = 0; r < d; ++r)
        for (int c = 0; c <= r; ++c)
          sD[r * d + c] = Sb[(size_t)(jd + r) * ldS + jd + c];
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
      sBad += nbad;
    }
    __syncthreads();

    // (b) L's block column j: zeros above, the factor, the panel below
    for (int e = tid; e < fd * d; e += nt) {
      const int i = e / d, c = e - i * d;
      T v = T(0);
      if (i >= jd + d) {  // P[i, c] = sum_k A[i, jd+k] Linv[c, k]
        const T* Si = Sb + (size_t)i * ldS + jd;
        for (int k = 0; k <= c; ++k) v += Si[k] * sLinv[c * d + k];
      } else if (i >= jd && c <= i - jd) {
        v = sD[(i - jd) * d + c];
      }
      Lb[(size_t)i * fd + jd + c] = v;
    }
    for (int e = tid; e < d * d; e += nt) Linvb[(size_t)j * d * d + e] = sLinv[e];
    // y_j = Linv_j R_j: one thread per RHS column (F12 columns and g1)
    for (int col = fd + tid; col <= m; col += nt) {
      T r[kMaxD];
      for (int k = 0; k < d; ++k) r[k] = Sb[(size_t)(jd + k) * ldS + col];
      for (int q = 0; q < d; ++q) {
        T acc = T(0);
        for (int k = 0; k <= q; ++k) acc += sLinv[q * d + k] * r[k];
        Sb[(size_t)(jd + q) * ldS + col] = acc;
      }
    }
    __syncthreads();

    // (c) RHS update and trailing SYRK on rows below the block
    const int t0 = jd + d, nrow = fd - t0, ncol = sd + 1;
    for (int e = tid; e < nrow * ncol; e += nt) {
      const int i = t0 + e / ncol, col = fd + e % ncol;
      const T* Pi = Lb + (size_t)i * fd + jd;
      T acc = T(0);
      for (int k = 0; k < d; ++k) acc += Pi[k] * Sb[(size_t)(jd + k) * ldS + col];
      Sb[(size_t)i * ldS + col] -= acc;
    }
    for (int e = tid; e < nrow * nrow; e += nt) {
      const int ii = e / nrow, kk = e - ii * nrow;
      if (kk > ii) continue;  // lower triangle only
      const T* Pi = Lb + (size_t)(t0 + ii) * fd + jd;
      const T* Pk = Lb + (size_t)(t0 + kk) * fd + jd;
      T acc = T(0);
      for (int q = 0; q < d; ++q) acc += Pi[q] * Pk[q];
      Sb[(size_t)(t0 + ii) * ldS + t0 + kk] -= acc;
    }
    __syncthreads();
  }

  // W, y out of the working copy; Schur complement U and ug
  T* Wb = W + b * fd * sd;
  T* yb = y + b * fd;
  T* Ub = U + b * sd * sd;
  T* ugb = ug + b * sd;
  for (int e = tid; e < fd * sd; e += nt) {
    const int i = e / sd, s = e - i * sd;
    Wb[e] = Sb[(size_t)i * ldS + fd + s];
  }
  for (int i = tid; i < fd; i += nt) yb[i] = Sb[(size_t)i * ldS + m];
  // U = F22 - W^T W: (2 tu) x (2 tu) output tiles, 2 x 2 outputs per thread
  // (nt == tu * tu), W staged through shared memory kChunk rows at a time
  __shared__ T sWa[kChunk * 2 * kTile];
  __shared__ T sWc[kChunk * 2 * kTile];
  const int tu = nt >= kTile * kTile ? kTile : kTile / 2;
  const int w = 2 * tu;
  const int ta = tid / tu, tc = tid - (tid / tu) * tu;
  for (int a0 = 0; a0 < sd; a0 += w) {
    for (int c0 = 0; c0 < sd; c0 += w) {
      T acc00 = T(0), acc01 = T(0), acc10 = T(0), acc11 = T(0);
      for (int f0 = 0; f0 < fd; f0 += kChunk) {
        for (int e = tid; e < kChunk * w; e += nt) {
          const int k = e / w, q = e - k * w, f = f0 + k;
          const T* Wf = Sb + (size_t)f * ldS + fd;
          sWa[e] = (f < fd && a0 + q < sd) ? Wf[a0 + q] : T(0);
          sWc[e] = (f < fd && c0 + q < sd) ? Wf[c0 + q] : T(0);
        }
        __syncthreads();
        for (int k = 0; k < kChunk; ++k) {
          const T wa0 = sWa[k * w + ta], wa1 = sWa[k * w + ta + tu];
          const T wc0 = sWc[k * w + tc], wc1 = sWc[k * w + tc + tu];
          acc00 += wa0 * wc0;
          acc01 += wa0 * wc1;
          acc10 += wa1 * wc0;
          acc11 += wa1 * wc1;
        }
        __syncthreads();
      }
      const T accs[2][2] = {{acc00, acc01}, {acc10, acc11}};
      for (int i = 0; i < 2; ++i) {
        for (int k = 0; k < 2; ++k) {
          const int a = a0 + ta + i * tu, c = c0 + tc + k * tu;
          if (a < sd && c < sd)
            Ub[(size_t)a * sd + c] = Fb[(size_t)(fd + a) * m + fd + c] - accs[i][k];
        }
      }
    }
  }
  for (int a = tid; a < sd; a += nt) {
    T acc = T(0);
    for (int f = 0; f < fd; ++f)
      acc += Sb[(size_t)f * ldS + fd + a] * Sb[(size_t)f * ldS + m];
    ugb[a] = gb[fd + a] - acc;
  }
  if (tid == 0) bad[b] = sBad;
}

template <typename T>
int launch(const void* F, const void* g, void* S, void* L, void* Linv, void* W,
           void* y, void* U, void* ug, void* bad, int B, int nf, int ns, int d,
           T eps, void* stream) {
  if (B <= 0) return 0;
  // large fronts take a full 1024-thread CTA (32 x 32 U tiles), the rest 256
  const int nt = (nf + ns) * d >= 192 ? kMaxThreads : (kTile / 2) * (kTile / 2);
  partial_cholesky_kernel<T><<<B, nt, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(F), static_cast<const T*>(g), static_cast<T*>(S),
      static_cast<T*>(L), static_cast<T*>(Linv), static_cast<T*>(W),
      static_cast<T*>(y), static_cast<T*>(U), static_cast<T*>(ug),
      static_cast<int*>(bad), nf, ns, d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gtsam_partial_cholesky_f32(
    const void* F, const void* g, void* S, void* L, void* Linv, void* W,
    void* y, void* U, void* ug, void* bad, int B, int nf, int ns, int d,
    float eps, void* stream) {
  return launch<float>(F, g, S, L, Linv, W, y, U, ug, bad, B, nf, ns, d, eps, stream);
}

extern "C" int gtsam_partial_cholesky_f64(
    const void* F, const void* g, void* S, void* L, void* Linv, void* W,
    void* y, void* U, void* ug, void* bad, int B, int nf, int ns, int d,
    double eps, void* stream) {
  return launch<double>(F, g, S, L, Linv, W, y, U, ug, bad, B, nf, ns, d, eps, stream);
}
