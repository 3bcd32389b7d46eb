// K2: fused separator subtract + top-down block backsolve, one CTA per clique
// (sm_90a).
//
// Replaces the Pallas TPU kernel gtsam_petercdev_tpu/ops/cholesky_v2.py
// `backsolve_bucket` (`_backsolve_kernel`, pallas_call in `_build_backsolve`).
// For each clique b of a bucket it solves L^T x = y - W xs, where L [fd, fd]
// and Linv [nf, d, d] come from K1, W [fd, sd], y [fd], and xs [sd] is the
// separator solution gathered by the caller (sd may be 0 at the roots).
//
// Design (correctness first). Grid = B, one CTA of 256 threads per clique;
// each dot product is split over a group of 32 threads whose partial sums
// meet in shared memory:
//   r = y - W xs   one group per row (lanes over the separator);
//   for j = nf-1 .. 0 (top-down, __syncthreads() between steps):
//     r_j = r[j] - L[:, j]^T x    one group per column of block j, over the
//                                 solved rows only
//     x_j = Linv_j^T r_j          d threads
// x lives in shared memory (fd <= kMaxFd) and is written out at the end.
//
// What bounds it on an H100: bytes. It reads the strictly lower part of L,
// W, y, xs and Linv once and does ~2 flops per element read, so the floor is
// those bytes at 3.35 TB/s. The nf-step dependent chain, three barriers a
// step with only d groups busy, keeps it well above that floor at the large
// fronts.
//
// First thing to improve: the root buckets (B = 1) run on ONE SM of 132;
// split the large fronts over several CTAs (or a cluster), and reduce with
// warp shuffles instead of shared-memory partials.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxD = 16;
constexpr int kMaxFd = 512;  // nf <= 32 (max supernode) times d <= 16
constexpr int kThreads = 256;
constexpr int kLanes = 32;

template <typename T>
__global__ void __launch_bounds__(kThreads) backsolve_kernel(
    const T* __restrict__ L, const T* __restrict__ Linv,
    const T* __restrict__ W, const T* __restrict__ y,
    const T* __restrict__ xs, T* __restrict__ x, int nf, int ns, int d) {
  const int fd = nf * d, sd = ns * d;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const T* Lb = L + b * fd * fd;
  const T* Linvb = Linv + b * nf * d * d;
  const T* Wb = W + b * fd * sd;
  const T* yb = y + b * fd;
  const T* xsb = xs + b * sd;

  __shared__ T r[kMaxFd];
  __shared__ T xsh[kMaxFd];
  __shared__ T rj[kMaxD];
  __shared__ T red[kThreads];
  // groups of kLanes threads share one dot product; partial sums meet in red[]
  const int lane = tid % kLanes, grp = tid / kLanes, ngrp = nt / kLanes;

  // r = y - W xs: one group per row, its lanes over the separator
  for (int f0 = 0; f0 < fd; f0 += ngrp) {
    const int f = f0 + grp;
    T acc = T(0);
    if (f < fd)
      for (int s = lane; s < sd; s += kLanes) acc += Wb[(size_t)f * sd + s] * xsb[s];
    red[tid] = acc;
    __syncthreads();
    if (lane == 0 && f < fd) {
      T sum = T(0);
      for (int l = 0; l < kLanes; ++l) sum += red[tid + l];
      r[f] = yb[f] - sum;
      xsh[f] = T(0);
    }
    __syncthreads();
  }

  for (int j = nf - 1; j >= 0; --j) {
    const int jd = j * d;
    // r_j = r[j] - L[:, j]^T x over the solved rows below block j: one
    // group per column of the block
    for (int c0 = 0; c0 < d; c0 += ngrp) {
      const int c = c0 + grp;
      T acc = T(0);
      if (c < d)
        for (int f = jd + d + lane; f < fd; f += kLanes)
          acc += Lb[(size_t)f * fd + jd + c] * xsh[f];
      red[tid] = acc;
      __syncthreads();
      if (lane == 0 && c < d) {
        T sum = T(0);
        for (int l = 0; l < kLanes; ++l) sum += red[tid + l];
        rj[c] = r[jd + c] - sum;
      }
      __syncthreads();
    }
    if (tid < d) {  // x_j = Linv_j^T r_j
      T acc = T(0);
      for (int c = 0; c < d; ++c) acc += Linvb[(size_t)j * d * d + c * d + tid] * rj[c];
      xsh[jd + tid] = acc;
    }
    __syncthreads();
  }

  for (int f = tid; f < fd; f += nt) x[b * fd + f] = xsh[f];
}

template <typename T>
int launch(const void* L, const void* Linv, const void* W, const void* y,
           const void* xs, void* x, int B, int nf, int ns, int d, void* stream) {
  if (B <= 0) return 0;
  backsolve_kernel<T><<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(L), static_cast<const T*>(Linv),
      static_cast<const T*>(W), static_cast<const T*>(y),
      static_cast<const T*>(xs), static_cast<T*>(x), nf, ns, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gtsam_backsolve_f32(const void* L, const void* Linv, const void* W,
                                   const void* y, const void* xs, void* x, int B,
                                   int nf, int ns, int d, void* stream) {
  return launch<float>(L, Linv, W, y, xs, x, B, nf, ns, d, stream);
}

extern "C" int gtsam_backsolve_f64(const void* L, const void* Linv, const void* W,
                                   const void* y, const void* xs, void* x, int B,
                                   int nf, int ns, int d, void* stream) {
  return launch<double>(L, Linv, W, y, xs, x, B, nf, ns, d, stream);
}
