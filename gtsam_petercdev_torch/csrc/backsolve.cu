// K2: fused separator subtract + top-down block backsolve (sm_90a).
//
// Replaces the Pallas TPU kernel gtsam_petercdev_tpu/ops/cholesky_v2.py
// `backsolve_bucket` (`_backsolve_kernel`, pallas_call in `_build_backsolve`).
// For each clique b of a bucket it solves L^T x = y - W xs, where L [fd, fd]
// and Linv [nf, d, d] come from the factor kernels, W [fd, sd], y [fd], and
// xs [sd] is the separator solution gathered by the caller (sd may be 0).
//
// The chain is right-looking: r = y - W xs; for j = nf-1 .. 0, the diagonal
// step x_j = Linv_j^T r_j, then every row i above the block is updated,
// r_i -= sum_q L[jd + q, i] x_j[q]. That update reads L's block row j, which
// is contiguous in row-major L, so neighbouring threads (rows i) read
// neighbouring addresses. Each thread owns one row of r and x and loads its
// own column of Linv_j once, at the start.
//
// What bounds it on an H100. At the leaves, bytes: the bundle-adjustment
// leaf (50,000 cliques, fd = 9, sd = 36) carries almost all of the bucket
// sweep's bytes (W, at ~2 flops an element). At the fronts, latency: a
// clique's nf-step chain is sequential, and a root bucket has one clique.
// The plan (ops/cholesky_v2.py `k2_plan`, by shape alone) picks one of two
// modes, both one launch per bucket:
//   warp mode (fd <= 32, unless a bucket of few cliques has a separator
//     wider than 6 fd, whose long rows of W cluster mode's warps share): a
//     warp per clique, up to eight cliques a CTA. Lane f owns row f. W
//     and xs stream into shared memory by cp.async in 32-column chunks
//     through a ring per warp (two stages where many cliques share the
//     card, up to eight where a few cliques have a wide separator), so a
//     warp keeps the ring's bytes in flight; lane f then sums its row from
//     shared memory. The chain moves r_j and x_j between
//     lanes by __shfl_sync: no barrier and no shared-memory partials.
//   cluster mode (the rest): a thread-block cluster of c CTAs per clique
//     (c = 1 is a plain CTA; c > 1 where a bucket has few cliques and a
//     large W). The CTAs split W's rows, a warp per row with its lanes over
//     the separator and a shuffle reduction, so a large front's W streams
//     through c SMs. Rank 0 gathers the slices of r from its peers' shared
//     memory (distributed shared memory) and runs the chain, one thread per
//     row, two barriers a block step; each thread loads its part of the
//     next block row of L into registers during the current step. (Two
//     alternatives measured slower on an H100: one warp running the chain
//     alone, with no barrier, about twice as slow at the roots; L's block
//     rows through a cp.async ring in shared memory, ~19% slower in f64.)
// Sums are in a fixed order: no atomics.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "factor_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace gtsam_cuda;

constexpr int kChunk = 32;  // W columns per ring stage (warp mode)
constexpr int kWarpMaxFd = 32;  // warp mode: one row per lane
constexpr int kMaxFd = 512;  // cluster mode: one thread per row on rank 0

// Warp mode. Warp w of CTA blockIdx.x solves clique blockIdx.x * warps + w.
// Each warp's shared memory: a ring of `stages` (2 .. 8) stages of
// [fd, kChunk + 1] W and [kChunk] xs, `stages - 1` chunks in flight ahead
// of the one being summed.
template <typename T, int KD>
__global__ void __launch_bounds__(256) backsolve_warp_kernel(
    const T* __restrict__ L, const T* __restrict__ Linv, const T* __restrict__ W,
    const T* __restrict__ y, const T* __restrict__ xs, T* __restrict__ x, int B, int nf,
    int ns, int d, int stages) {
  if (KD < kMaxD) d = KD;
  const int fd = nf * d, sd = ns * d, dd = d * d;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const size_t b = (size_t)blockIdx.x * (blockDim.x / 32) + warp;
  if (b >= (size_t)B) return;  // no CTA-wide barrier below
  const int ldw = kChunk + 1, stage = fd * ldw + kChunk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw) + (size_t)warp * stages * stage;
  const T* Wb = W + b * fd * sd;
  const T* xsb = xs + b * sd;

  // chunk k of [W | xs] into ring stage k % stages, one column per lane;
  // one commit group per chunk (empty past the last)
  auto issue = [&](int k) {
    const int s = k * kChunk + lane;
    T* st = ring + (k % stages) * stage;
    if (s < sd) {
      for (int f = 0; f < fd; ++f) cp_async_elem(st + f * ldw + lane, Wb + (size_t)f * sd + s);
      cp_async_elem(st + fd * ldw + lane, xsb + s);
    }
    cp_async_commit();
  };
  const int nchunk = (sd + kChunk - 1) / kChunk;
  for (int k = 0; k < stages; ++k) issue(k);

  // meanwhile: this lane's row of y and its column of Linv_{block}
  const int jf = lane / d, q = lane - jf * d;
  T r = T(0), linv[kMaxD];
#pragma unroll
  for (int c = 0; c < kMaxD; ++c) linv[c] = T(0);
  if (lane < fd) {
    r = y[b * fd + lane];
#pragma unroll
    for (int c = 0; c < kMaxD; ++c)
      if (c < d) linv[c] = Linv[(b * nf + jf) * dd + c * d + q];
  }

  // r = y - W xs, chunk by chunk, four running sums a lane (short chains)
  T acc[4] = {T(0), T(0), T(0), T(0)};
  for (int k = 0; k < nchunk; ++k) {
    cp_async_wait_upto(stages - 1);  // chunk k has landed
    __syncwarp();
    const T* wr = ring + (k % stages) * stage + lane * ldw;
    const T* xr = ring + (k % stages) * stage + fd * ldw;
    const int nc = min(kChunk, sd - k * kChunk);
    if (lane < fd) {
      int c = 0;
      for (; c + 4 <= nc; c += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[u] += wr[c + u] * xr[c + u];
      }
      for (; c < nc; ++c) acc[0] += wr[c] * xr[c];
    }
    __syncwarp();  // the stage is free again
    issue(k + stages);
  }
  cp_async_wait<0>();
  r -= (acc[0] + acc[1]) + (acc[2] + acc[3]);

  // the chain: x_j = Linv_j^T r_j (lanes of block j), then rows above it
  const T* Lb = L + b * fd * fd;
  T xv = T(0);
  for (int j = nf - 1; j >= 0; --j) {
    const int jd = j * d;
    T xj = T(0);
#pragma unroll
    for (int c = 0; c < kMaxD; ++c) {
      if (c < d) {
        const T rc = __shfl_sync(kFullMask, r, jd + c);
        xj += linv[c] * rc;
      }
    }
    if (jf == j) xv = xj;
#pragma unroll
    for (int c = 0; c < kMaxD; ++c) {
      if (c < d) {
        const T xq = __shfl_sync(kFullMask, xv, jd + c);
        if (lane < jd) r -= Lb[(size_t)(jd + c) * fd + lane] * xq;
      }
    }
  }
  if (lane < fd) x[b * fd + lane] = xv;
}

// Cluster mode. Clique blockIdx.x / c; CTA rank rk of its cluster sums rows
// [rk * rows, (rk + 1) * rows) of r = y - W xs; rank 0 runs the chain.
// Shared memory: this rank's rows of r, then (rank 0) r [fd] and x [fd].
template <typename T, int KD>
__global__ void __launch_bounds__(kMaxFd) backsolve_cluster_kernel(
    const T* __restrict__ L, const T* __restrict__ Linv, const T* __restrict__ W,
    const T* __restrict__ y, const T* __restrict__ xs, T* __restrict__ x, int nf, int ns,
    int d, int rows) {
  if (KD < kMaxD) d = KD;
  const int fd = nf * d, sd = ns * d, dd = d * d;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int rk = static_cast<int>(cluster.block_rank());
  const size_t b = blockIdx.x / c;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid % 32, warp = tid / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* rloc = reinterpret_cast<T*>(smem_raw);  // [rows]
  T* rsh = rloc + rows;                      // [fd], rank 0
  T* xsh = rsh + fd;                         // [fd], rank 0
  const T* Wb = W + b * fd * sd;
  const T* xsb = xs + b * sd;
  const T* Lb = L + b * fd * fd;

  // rank 0's thread f: its column of Linv_{block of f}, loaded while W streams
  const int f = tid, jf = f / d, q = f - jf * d;
  T linv[kMaxD];
#pragma unroll
  for (int cc = 0; cc < kMaxD; ++cc)
    linv[cc] = (rk == 0 && f < fd && cc < d) ? Linv[(b * nf + jf) * dd + cc * d + q] : T(0);

  // this rank's rows of r, a warp per row, lanes over the separator
  const int f0 = rk * rows, f1 = min(fd, f0 + rows);
  for (int i = f0 + warp; i < f1; i += nt / 32) {
    const T* Wi = Wb + (size_t)i * sd;
    T acc = T(0);
#pragma unroll 4
    for (int s = lane; s < sd; s += 32) acc += Wi[s] * xsb[s];
#pragma unroll
    for (int o = 16; o > 0; o /= 2) acc += __shfl_xor_sync(kFullMask, acc, o);
    if (lane == 0) rloc[i - f0] = y[b * fd + i] - acc;
  }
  cluster.sync();  // every rank's slice is written
  if (rk == 0)
    for (int i = tid; i < fd; i += nt) rsh[i] = *cluster.map_shared_rank(rloc + i % rows, i / rows);
  cluster.sync();  // rank 0 has read its peers' slices; they may exit
  if (rk != 0) return;

  // the chain, thread f owning row f; cur / nxt: L's block row j / j - 1 at
  // column f, the next one loaded during this step
  T rv = f < fd ? rsh[f] : T(0), cur[kMaxD], nxt[kMaxD];
  const int top = (nf - 1) * d;
#pragma unroll
  for (int cc = 0; cc < kMaxD; ++cc)
    cur[cc] = (cc < d && f < top) ? Lb[(size_t)(top + cc) * fd + f] : T(0);
  for (int j = nf - 1; j >= 0; --j) {
    const int jd = j * d, pd = jd - d;
#pragma unroll
    for (int cc = 0; cc < kMaxD; ++cc)
      nxt[cc] = (cc < d && f < pd) ? Lb[(size_t)(pd + cc) * fd + f] : T(0);
    if (jf == j && f < fd) {  // x_j = Linv_j^T r_j
      T xj = T(0);
#pragma unroll
      for (int cc = 0; cc < kMaxD; ++cc)
        if (cc < d) xj += linv[cc] * rsh[jd + cc];
      xsh[f] = xj;
    }
    __syncthreads();
    if (f < jd) {  // rows above block j
#pragma unroll
      for (int cc = 0; cc < kMaxD; ++cc)
        if (cc < d) rv -= cur[cc] * xsh[jd + cc];
      rsh[f] = rv;
    }
    __syncthreads();
#pragma unroll
    for (int cc = 0; cc < kMaxD; ++cc) cur[cc] = nxt[cc];
  }
  if (f < fd) x[b * fd + f] = xsh[f];
}

// Each mode's kernel is specialised for d = 6 and 9 (the loops over a block
// unroll), else takes any d <= kMaxD.
template <typename T>
int launch(const void* L, const void* Linv, const void* W, const void* y, const void* xs,
           void* x, int B, int nf, int ns, int d, int warp_mode, int grid, int threads,
           int cluster, int rows, int stages, int smem, void* stream) {
  if (B <= 0) return 0;
  if (d <= 0 || d > kMaxD || nf <= 0 || ns < 0 || threads % 32 || cluster < 1 || cluster > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T *pL = static_cast<const T*>(L), *pLinv = static_cast<const T*>(Linv),
          *pW = static_cast<const T*>(W), *py = static_cast<const T*>(y),
          *pxs = static_cast<const T*>(xs);
  T* px = static_cast<T*>(x);
  if (warp_mode) {
    if (nf * d > kWarpMaxFd || stages < 2 || stages > 8)
      return static_cast<int>(cudaErrorInvalidValue);
    auto kern = d == 6 ? backsolve_warp_kernel<T, 6>
                       : (d == 9 ? backsolve_warp_kernel<T, 9> : backsolve_warp_kernel<T, kMaxD>);
    if (smem > 48 * 1024) {
      const cudaError_t err =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kern<<<grid, threads, smem, st>>>(pL, pLinv, pW, py, pxs, px, B, nf, ns, d, stages);
    return static_cast<int>(cudaGetLastError());
  }
  if (nf * d > kMaxFd || threads < nf * d || grid != B * cluster)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = d == 6 ? backsolve_cluster_kernel<T, 6>
                     : (d == 9 ? backsolve_cluster_kernel<T, 9> : backsolve_cluster_kernel<T, kMaxD>);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;  // smem: (rows + 2 fd) elements, under 48 KB at fd <= 512
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kern, pL, pLinv, pW, py, pxs, px, nf, ns, d, rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define GTSAM_EXPORT(NAME, T)                                                              \
  extern "C" int NAME(const void* L, const void* Linv, const void* W, const void* y,       \
                      const void* xs, void* x, int B, int nf, int ns, int d, int warp_mode, \
                      int grid, int threads, int cluster, int rows, int stages, int smem,   \
                      void* stream) {                                                      \
    return launch<T>(L, Linv, W, y, xs, x, B, nf, ns, d, warp_mode, grid, threads, cluster,  \
                     rows, stages, smem, stream);                                          \
  }

GTSAM_EXPORT(gtsam_backsolve_f32, float)
GTSAM_EXPORT(gtsam_backsolve_f64, double)
