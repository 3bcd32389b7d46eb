// Schur-complement stage of K1 and K3: U = F22 - W^T W, ug = g2 - W^T y
// (sm_90a).
//
// Part of the ports of gtsam_petercdev_tpu/ops/cholesky_v2.py
// `partial_cholesky` (K1) and gtsam_petercdev_tpu/ops/cholesky.py
// `partial_cholesky` (K3): both Pallas kernels form U and ug inside the
// per-clique program. Here the factor stages (partial_cholesky.cu,
// partial_cholesky_smem.cu) leave W [B, fd, sd] and y [B, fd] in device
// memory, and this kernel forms, for each clique b of the bucket,
//   U  [sd, sd] = F22 - W^T W     (F22 read straight from F [B, m, m])
//   ug [sd]     = g2 - W^T y
//
// What bounds it on an H100: operations at the large fronts (fd sd^2 FMA:
// the sphere root fd = 192, sd = 576 is 64 M FMA, 4.7x the bytes' time at
// 67 TFLOP/s), bytes at the small ones. The factor kernels formed U with
// one CTA per clique and scalar FMAs; a bucket of one or two cliques then
// ran on one or two of the card's 132 SMs.
//
// Design. Grid = (B, tiles): one CTA of 128 threads per 64 x 64 tile of the
// lower triangle of U (tiles = nt (nt + 1) / 2, nt = ceil(sd / 64), the
// order of ops/schur_update.py `tiles`), so one clique spreads over up to
// 45 SMs (sd = 576). Each output element is computed by exactly one thread;
// an off-diagonal tile writes U[a][c] and its mirror U[c][a], a diagonal
// tile its lower half and the mirror, so U is exactly symmetric; no atomics.
// The tile's two operands are 16-row slabs of W (W[f, a0:a0+64] and
// W[f, c0:c0+64]), staged into shared memory by cp.async, double-buffered:
// the next slab loads while the current one is multiplied.
//   f64: the FP64 tensor cores. Each warp owns a 32 x 32 quarter of the
//        tile as 4 x 4 DMMA tiles (mma.sync m8n8k4, 32 accumulators a lane).
//   f32: register-tiled FFMA, 8 x 4 outputs a thread (TF32 stays off; the
//        port holds float32 products in full precision).
// The diagonal tiles' CTAs also form ug for their 64 rows.

#include <cuda_runtime.h>

#include "factor_common.cuh"

namespace {

using namespace gtsam_cuda;

constexpr int kTile = 64;     // U tile edge (ops/schur_update.py TILE)
constexpr int kThreads = 128;  // ops/schur_update.py THREADS
constexpr int kChunk = 16;    // rows of W per staged slab
constexpr int kLd = kTile + 4;  // padded row of a staged slab

template <typename T>
struct Slabs {
  T a[2][kChunk][kLd];  // W[f0 + k, a0 + q]
  T c[2][kChunk][kLd];  // W[f0 + k, c0 + q]
};

// stage slab rows f0 .. f0 + kChunk of both operands into buffer s
template <typename T>
__device__ inline void load_slab(Slabs<T>& sm, int s, const T* Wb, int f0, int fd, int sd,
                                 int a0, int c0, int tid) {
  for (int e = tid; e < kChunk * kTile; e += kThreads) {
    const int k = e / kTile, q = e - k * kTile, f = f0 + k;
    if (f < fd && a0 + q < sd) cp_async_elem(&sm.a[s][k][q], Wb + (size_t)f * sd + a0 + q);
    else sm.a[s][k][q] = T(0);
    if (f < fd && c0 + q < sd) cp_async_elem(&sm.c[s][k][q], Wb + (size_t)f * sd + c0 + q);
    else sm.c[s][k][q] = T(0);
  }
  cp_async_commit();
}

// one output element of the tile: U[a][c] = F22[a][c] - acc, mirrored
template <typename T>
__device__ inline void store_u(const T* Fb, T* Ub, int fd, int sd, int a, int c, bool diag,
                               T acc) {
  if (a >= sd || c >= sd || (diag && c > a)) return;
  const size_t m = (size_t)fd + sd;
  const T u = Fb[(fd + a) * m + fd + c] - acc;
  Ub[(size_t)a * sd + c] = u;
  if (a != c) Ub[(size_t)c * sd + a] = u;
}

// f64: DMMA. Warp w owns rows 32 (w / 2) .. + 32, cols 32 (w % 2) .. + 32.
struct TileF64 {
  double acc[4][4][2] = {};
  __device__ void mul(const Slabs<double>& sm, int s, int tid) {
    const int w = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    const int ra = (w / 2) * 32 + g, rc = (w % 2) * 32 + g;
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 4) {
      double fa[4], fb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        fa[i] = sm.a[s][kk + t4][ra + i * 8];  // A[g][t4] = W[f][a]
        fb[i] = sm.c[s][kk + t4][rc + i * 8];  // B[t4][g] = W[f][c]
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dmma_8x8x4(acc[i][j][0], acc[i][j][1], fa[i], fb[j]);
    }
  }
  __device__ void store(const double* Fb, double* Ub, int fd, int sd, int a0, int c0,
                        bool diag, int tid) const {
    const int w = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)  // D[g][2 t4 + h]
          store_u(Fb, Ub, fd, sd, a0 + (w / 2) * 32 + i * 8 + g,
                  c0 + (w % 2) * 32 + j * 8 + 2 * t4 + h, diag, acc[i][j][h]);
  }
};

// f32: FFMA. Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 8 i,
// cols tx + 16 j (strided, so a warp's shared-memory reads do not conflict)
struct TileF32 {
  float acc[8][4] = {};
  __device__ void mul(const Slabs<float>& sm, int s, int tid) {
    const int ty = tid / 16, tx = tid % 16;
#pragma unroll 4
    for (int k = 0; k < kChunk; ++k) {
      float wa[8], wc[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) wa[i] = sm.a[s][k][ty + 8 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) wc[j] = sm.c[s][k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += wa[i] * wc[j];
    }
  }
  __device__ void store(const float* Fb, float* Ub, int fd, int sd, int a0, int c0, bool diag,
                        int tid) const {
    const int ty = tid / 16, tx = tid % 16;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        store_u(Fb, Ub, fd, sd, a0 + ty + 8 * i, c0 + tx + 16 * j, diag, acc[i][j]);
  }
};

template <typename T> struct TileOf;
template <> struct TileOf<double> { using type = TileF64; };
template <> struct TileOf<float> { using type = TileF32; };

template <typename T>
__global__ void __launch_bounds__(kThreads) schur_update_kernel(
    const T* __restrict__ F, const T* __restrict__ g, const T* __restrict__ W,
    const T* __restrict__ y, T* __restrict__ U, T* __restrict__ ug, int fd, int sd) {
  const size_t b = blockIdx.x;
  const int t = blockIdx.y, tid = threadIdx.x;
  // tile t of the lower triangle, row by row: (0,0), (1,0), (1,1), (2,0), ...
  int ti = static_cast<int>((sqrt(8.0 * t + 1.0) - 1.0) * 0.5);
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  while (ti * (ti + 1) / 2 > t) --ti;
  const int tj = t - ti * (ti + 1) / 2;
  const int a0 = ti * kTile, c0 = tj * kTile, m = fd + sd;
  const T* Fb = F + b * (size_t)m * m;
  const T* Wb = W + b * (size_t)fd * sd;

  __shared__ __align__(16) Slabs<T> sm;
  typename TileOf<T>::type tile;
  const int nchunk = (fd + kChunk - 1) / kChunk;
  load_slab(sm, 0, Wb, 0, fd, sd, a0, c0, tid);
  for (int ch = 0; ch < nchunk; ++ch) {
    if (ch + 1 < nchunk) {
      load_slab(sm, (ch + 1) & 1, Wb, (ch + 1) * kChunk, fd, sd, a0, c0, tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    tile.mul(sm, ch & 1, tid);
    __syncthreads();
  }
  tile.store(Fb, U + b * (size_t)sd * sd, fd, sd, a0, c0, ti == tj, tid);

  if (ti == tj && tid < kTile && a0 + tid < sd) {
    const int a = a0 + tid;
    const T* yb = y + b * (size_t)fd;
    T acc = T(0);
    for (int f = 0; f < fd; ++f) acc += Wb[(size_t)f * sd + a] * yb[f];
    ug[b * (size_t)sd + a] = g[b * (size_t)m + fd + a] - acc;
  }
}

template <typename T>
int launch(const void* F, const void* g, const void* W, const void* y, void* U, void* ug,
           int B, int fd, int sd, int tiles, void* stream) {
  if (B <= 0 || sd <= 0) return 0;
  const int nt = (sd + kTile - 1) / kTile;
  if (fd <= 0 || tiles != nt * (nt + 1) / 2) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B, tiles);
  schur_update_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(F), static_cast<const T*>(g), static_cast<const T*>(W),
      static_cast<const T*>(y), static_cast<T*>(U), static_cast<T*>(ug), fd, sd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gtsam_schur_update_f32(const void* F, const void* g, const void* W,
                                      const void* y, void* U, void* ug, int B, int fd,
                                      int sd, int tiles, void* stream) {
  return launch<float>(F, g, W, y, U, ug, B, fd, sd, tiles, stream);
}

extern "C" int gtsam_schur_update_f64(const void* F, const void* g, const void* W,
                                      const void* y, void* U, void* ug, int B, int fd,
                                      int sd, int tiles, void* stream) {
  return launch<double>(F, g, W, y, U, ug, B, fd, sd, tiles, stream);
}
