#!/usr/bin/env python3
"""Run the port's CUDA kernels on the CPU, for checking their logic where
there is no GPU and no nvcc.

    python3 tools/cuda_emulate.py

Each source in gtsam_petercdev_torch/csrc/ is compiled with g++ (C++20)
against a small header that emulates what the kernels use: blocks run one
after another, a block's threads run as std::threads, __syncthreads() is a
std::barrier, __shared__ arrays are statics and dynamic shared memory is a
per-CTA buffer of the size the launch asks for, grids may be 2-D, and a
source may launch several kernels. A cluster launch (cudaLaunchKernelEx
with a cluster dimension) runs the cluster's CTAs together, so
cluster.sync() is a barrier over all their threads and map_shared_rank
returns the peer CTA's buffer. Each warp of 32 threads has its own
barrier and exchange slots: __syncwarp() and __shfl_sync() go through them,
and so does the FP64 tensor-core product (`dmma_8x8x4` in
csrc/factor_common.cuh), which the emulator computes from the 32 lanes'
fragments laid out as the PTX ISA gives mma.m8n8k4 .f64 (lane 4g + t holds
A[g][t] and B[t][g]; its accumulators are C[g][2t], C[g][2t+1]), so a kernel
that assumed another layout fails here. cp.async copies at once. The
extern "C" entry points are then called through ctypes on numpy arrays,
with the launch plans of the Python wrappers (ops/cholesky_v2.py k1_plan,
ops/schur_update.py n_tiles), and their outputs held against the plain
PyTorch versions (inference/kernels.py, ops/cholesky.py) at a set of bucket
shapes with d = 3, 6, 9 and 16, in float64 and float32 (the sphere root, the
iSAM2 path's d = 3 levels, a
front whose packed F11 exceeds shared memory and the largest front the
planner forms, whose solve stage exceeds it too, among them); K1 runs each
shape twice, as planned and with both of its global-memory branches forced
(they are the same code as the card takes past shared memory), K2 in its
planned mode and in each mode forced (warp mode where fd <= 32, clusters of
one and of three CTAs), K4 at its planned G and at G = 1 and G = 4 (ragged
last groups), plus indefinite
buckets with the bad pivot in the first and in a later diagonal block
(equal bad-pivot counts). This checks indexing, phases, barriers and
fragment layouts; it says nothing about speed or about what nvcc accepts.
"""

import ctypes
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from gtsam_petercdev_torch.inference import kernels  # noqa: E402
from gtsam_petercdev_torch.ops import build, cholesky, cholesky_v2, schur_update  # noqa: E402

FAKE_CUDA = r"""
#pragma once
#define GTSAM_EMULATE 1
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __restrict__
#define __shared__ static
#define __launch_bounds__(...)
#define __align__(n)
using std::sqrt;
inline float sqrtf(float x) { return std::sqrt(x); }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr int cudaSuccess = 0, cudaErrorInvalidValue = 1;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
inline int cudaGetLastError() { return 0; }
template <class K> int cudaFuncSetAttribute(K, int, int) { return 0; }

// a CTA: its threads are std::threads, __syncthreads() a barrier over all of
// them, and each warp of 32 has its own barrier and exchange slots, through
// which __syncwarp, __shfl_sync and the DMMA product move values. The CTAs of
// a cluster run together, each with its own barrier, warps and dynamic
// shared memory, so cluster.sync() is a barrier over all their threads and
// map_shared_rank reaches a peer CTA's buffer.
struct EmuWarp {
  std::barrier<> bar{32};
  alignas(8) unsigned char x[32][8];
  double a[32], b[32];
};
struct EmuCta {
  std::barrier<> bar;
  std::vector<EmuWarp> warps;
  std::vector<std::max_align_t> dyn;
  EmuCta(int nt, size_t smem) : bar(nt), warps(nt / 32), dyn(smem / sizeof(std::max_align_t) + 1) {}
};
struct EmuCluster {
  std::barrier<> bar;
  std::vector<unsigned char*> smem;
  explicit EmuCluster(int n) : bar(n) {}
};
inline thread_local std::barrier<>* t_bar = nullptr;
inline thread_local EmuWarp* t_warp = nullptr;
inline thread_local int t_lane = 0;
inline thread_local EmuCluster* t_cluster = nullptr;
inline thread_local unsigned t_rank = 0;
inline thread_local unsigned char* g_dyn_smem = nullptr;
inline void __syncthreads() { t_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { t_warp->bar.arrive_and_wait(); }
template <class T>
T __shfl_sync(unsigned, T v, int src) {
  std::memcpy(t_warp->x[t_lane], &v, sizeof(T));
  __syncwarp();
  T r;
  std::memcpy(&r, t_warp->x[src & 31], sizeof(T));
  __syncwarp();
  return r;
}
template <class T>
T __shfl_xor_sync(unsigned m, T v, int mask) { return __shfl_sync(m, v, t_lane ^ mask); }
using std::max;
using std::min;
// mma.sync.aligned.m8n8k4.row.col.f64 with the PTX ISA's fragment layout
// (g = lane / 4, t = lane % 4): lane holds A[g][t] and B[t][g], and its
// accumulators are C[g][2t] and C[g][2t+1]. So A[r][k] is lane 4r+k's a,
// B[k][n] is lane 4n+k's b.
inline void dmma_8x8x4(double& c0, double& c1, double a, double b) {
  t_warp->a[t_lane] = a;
  t_warp->b[t_lane] = b;
  __syncwarp();
  const int g = t_lane / 4, t = t_lane % 4;
  for (int k = 0; k < 4; ++k) {
    const double ark = t_warp->a[4 * g + k];
    c0 += ark * t_warp->b[4 * (2 * t) + k];
    c1 += ark * t_warp->b[4 * (2 * t + 1) + k];
  }
  __syncwarp();
}
template <class T>
void cp_async_elem(T* smem, const T* gmem) { *smem = *gmem; }
inline void cp_async_commit() {}
template <int N>
void cp_async_wait() {}

namespace cooperative_groups {
struct cluster_group {
  void sync() const { t_cluster->bar.arrive_and_wait(); }
  unsigned block_rank() const { return t_rank; }
  unsigned num_blocks() const { return static_cast<unsigned>(t_cluster->smem.size()); }
  template <class T>
  T* map_shared_rank(T* p, unsigned rank) const {
    return reinterpret_cast<T*>(t_cluster->smem[rank] +
                                (reinterpret_cast<unsigned char*>(p) - g_dyn_smem));
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups

// grid, blockDim.x threads, dynamic shared memory, cluster of c CTAs along x
template <class F>
void emu_launch_cluster(dim3 grid, int nt, size_t smem, unsigned c, F body) {
  if (nt % 32) throw "block size is not a whole number of warps";
  if (grid.x % c) throw "grid is not a whole number of clusters";
  blockDim = dim3(nt);
  gridDim = grid;
  for (unsigned by = 0; by < grid.y; ++by) {
    for (unsigned bx0 = 0; bx0 < grid.x; bx0 += c) {
      EmuCluster cl(static_cast<int>(c) * nt);
      std::vector<std::unique_ptr<EmuCta>> ctas;
      for (unsigned r = 0; r < c; ++r) {
        ctas.push_back(std::make_unique<EmuCta>(nt, smem));
        cl.smem.push_back(reinterpret_cast<unsigned char*>(ctas.back()->dyn.data()));
      }
      std::vector<std::thread> ts;
      for (unsigned r = 0; r < c; ++r)
        for (int t = 0; t < nt; ++t)
          ts.emplace_back([&, bx0, by, r, t]() {
            blockIdx = dim3(bx0 + r, by);
            threadIdx = dim3(t);
            t_bar = &ctas[r]->bar;
            t_warp = &ctas[r]->warps[t / 32];
            t_lane = t % 32;
            t_cluster = &cl;
            t_rank = r;
            g_dyn_smem = cl.smem[r];
            body();
          });
      for (auto& th : ts) th.join();
    }
  }
}
template <class F>
void emu_launch(dim3 grid, int nt, size_t smem, F body) { emu_launch_cluster(grid, nt, smem, 1, body); }

struct cudaLaunchAttribute {
  int id;
  struct {
    struct {
      unsigned x, y, z;
    } clusterDim;
  } val;
};
constexpr int cudaLaunchAttributeClusterDimension = 4;
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <class... E, class... A>
int cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(E...), A&&... args) {
  unsigned c = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension) c = cfg->attrs[i].val.clusterDim.x;
  if (c < 1 || c > 8 || cfg->gridDim.x % c) return cudaErrorInvalidValue;
  emu_launch_cluster(cfg->gridDim, static_cast<int>(cfg->blockDim.x), cfg->dynamicSmemBytes, c,
                     [&]() { kernel(args...); });
  return 0;
}
"""

# (B, nf, ns, d): leaves (ns = 0), 64-, 256- and 1024-thread CTAs, d = 3, 6,
# 9 (the bundle-adjustment block size) and 16
SHAPES = [(3, 2, 1, 6), (4, 1, 0, 6), (2, 4, 3, 6), (5, 3, 2, 3), (2, 12, 16, 6),
          (1, 8, 24, 6), (2, 4, 40, 6), (1, 32, 0, 6), (2, 3, 9, 16),
          (6, 1, 4, 9), (3, 1, 0, 9), (2, 2, 3, 9), (1, 6, 6, 9),
          # leaf buckets whose last K4 group is ragged (G = 8), K2's warp mode
          # over four and nine W chunks
          (11, 1, 4, 9), (9, 1, 4, 6), (3, 2, 12, 9), (2, 1, 48, 6),
          # K1: the sphere root (19 solve slabs, 45 U tiles), a front whose
          # packed F11 exceeds shared memory in float64, and nf = 32 at d = 16,
          # whose solve stage exceeds it too (both global branches)
          (1, 32, 96, 6), (1, 30, 8, 9), (1, 32, 8, 16),
          # the iSAM2 path at d = 3: a leaf level, a mid-tree level, K4's
          # largest front that fits shared memory and K1's past it
          (37, 1, 2, 3), (3, 4, 8, 3), (1, 32, 64, 3), (1, 32, 128, 3)]
TOL = {np.float64: 1e-12, np.float32: 1e-5}


def compile_emulated(workdir):
    """g++-compile each kernel source against the emulation header."""
    with open(os.path.join(workdir, "fake_cuda.h"), "w") as f:
        f.write(FAKE_CUDA)
    libs = {}
    for name, src in build.SOURCES.items():
        with open(os.path.join(build.CSRC, src)) as f:
            code = f.read().replace("#include <cuda_runtime.h>", '#include "fake_cuda.h"')
        code = code.replace("#include <cooperative_groups.h>", "")
        # dynamic shared memory: the per-CTA buffer emu_launch allocates
        code = re.sub(r"extern\s+__shared__[^;]*?(\w+)\[\];",
                      r"unsigned char* \1 = g_dyn_smem;", code)
        # every kernel<<<grid, block, smem, stream>>>(args); -> emu_launch(...)
        launch = re.compile(r"(\w+(?:<[^<>]*>)?)<<<([^,]+),\s*([^,]+),\s*([^,]+),.*?>>>\(", re.S)
        while (m := launch.search(code)) is not None:
            end = code.index(");", m.end())
            code = (code[: m.start()] + f"emu_launch({m.group(2)}, {m.group(3)}, {m.group(4)}, "
                    f"[&]() {{ {m.group(1)}(" + code[m.end():end] + "); });" + code[end + 2:])
        cpp = os.path.join(workdir, f"{name}.cpp")
        with open(cpp, "w") as f:
            f.write(code)
        so = os.path.join(workdir, f"lib{name}.so")
        subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC", "-Wall",
                        "-Wno-unknown-pragmas", "-I", workdir, "-I", build.CSRC, "-o", so, cpp], check=True)
        libs[name] = build.declare(ctypes.CDLL(so), name)
    return libs


def _ptr(a):
    return a.ctypes.data if a is not None and a.size else None


def _sfx(dt):
    return "f64" if dt == np.float64 else "f32"


def emulated_schur(lib, F, g, W, y, U, ug):
    """The Schur-complement stage on K1's or K3's W and y (grid per
    ops/schur_update.py)."""
    B, fd, sd = W.shape
    if B and sd:
        fn = getattr(lib, "gtsam_schur_update_" + _sfx(W.dtype))
        assert fn(*map(_ptr, (F, g, W, y, U, ug)), B, fd, sd, schur_update.n_tiles(sd),
                  None) == 0


def _outputs(B, nf, ns, d, dt, u_shape, ug_shape):
    fd, sd = nf * d, ns * d
    return dict(L=np.empty((B, fd, fd), dt), Linv=np.empty((B, nf, d, d), dt),
                W=np.empty((B, fd, sd), dt), y=np.empty((B, fd), dt),
                U=np.empty(u_shape, dt), ug=np.empty(ug_shape, dt))


def emulated_partial_cholesky(libs, Fm, gm, nf, d, force_global=False):
    """K1's three launches, planned by ops/cholesky_v2.py k1_plan; with
    force_global, stages (a) and (b) take their global-memory branches."""
    B, m, _ = Fm.shape
    fd, dt = nf * d, Fm.dtype
    ns = (m - fd) // d
    plan = cholesky_v2.k1_plan(B, nf, ns, d, Fm.itemsize)
    if force_global:
        plan = plan._replace(packed=False, factor_smem=2 * d * d * Fm.itemsize + 16,
                             solve_staged=False, solve_smem=d * cholesky_v2.SLAB * Fm.itemsize)
    out = _outputs(B, nf, ns, d, dt, (B, ns * d, ns * d), (B, ns * d))
    scratch = None if plan.packed else np.empty((B, fd, fd), dt)
    bad = np.empty(B, np.int32)
    lib = libs["partial_cholesky"]
    assert getattr(lib, "gtsam_k1_factor_" + _sfx(dt))(
        _ptr(Fm), _ptr(scratch), _ptr(out["L"]), _ptr(out["Linv"]), _ptr(bad), B, nf, m, d,
        1e-10, int(plan.packed), plan.factor_threads, plan.factor_smem, None) == 0
    assert getattr(lib, "gtsam_k1_solve_" + _sfx(dt))(
        _ptr(Fm), _ptr(gm), *(_ptr(out[k]) for k in ("L", "Linv", "W", "y")), B, nf, m, d,
        plan.solve_grid[1], int(plan.solve_staged), plan.solve_smem, None) == 0
    emulated_schur(libs["schur_update"], Fm, gm, out["W"], out["y"], out["U"], out["ug"])
    out["bad"] = int(bad.sum())
    out["branch"] = (f"F11 {'packed in shared memory' if plan.packed else 'in global scratch'}, "
                     f"solve {'staged' if plan.solve_staged else 'in place'}")
    return out


def k4_variants(B, nf, ns, d, itemsize):
    """K4's plan for the shape, then G = 1 and G = 4 forced (G = 4 leaves a
    ragged last group wherever B is not a multiple of it)."""
    plan = cholesky.k4_plan(B, nf, ns, d, itemsize)
    per = cholesky.smem_bytes(nf, ns, d, itemsize) - 16
    out = [("planned", plan)]
    for G in (1, 4):
        if G != plan.cliques_per_cta and (G == 1 or nf * d <= cholesky.K4_WARP_MAX_FD):
            threads = cholesky.k4_plan(1, nf, ns, d, itemsize).threads if G == 1 else 32 * G
            out.append((f"G={G}", plan._replace(cliques_per_cta=G, grid=-(-B // G),
                                                threads=threads, smem=G * per + 16 * -(-G // 4))))
    return out


def emulated_smem(libs, entry, F, g, nf, ns, d, u_shape, ug_shape, plan=None):
    """K3 (entry "smem": F [B, m, m], then the Schur stage) or K4 (entry
    "blocks": F as blocks, U in the same launch, launched by `plan`)."""
    B, dt = g.shape[0], F.dtype
    out = _outputs(B, nf, ns, d, dt, u_shape, ug_shape)
    bad = np.empty(B, np.int32)
    fn = getattr(libs["partial_cholesky_smem"], f"gtsam_partial_cholesky_{entry}_" + _sfx(dt))
    if entry == "smem":
        err = fn(_ptr(F), _ptr(g), *(_ptr(out[k]) for k in ("L", "Linv", "W", "y")),
                 _ptr(bad), B, nf, ns, d, 1e-10, None)
    else:
        err = fn(_ptr(F), _ptr(g), *(_ptr(out[k]) for k in ("L", "Linv", "W", "y", "U", "ug")),
                 _ptr(bad), B, nf, ns, d, 1e-10, plan.cliques_per_cta, plan.threads, plan.smem,
                 None)
    assert err == 0
    if entry == "smem":
        emulated_schur(libs["schur_update"], F, g, out["W"], out["y"], out["U"], out["ug"])
    out["bad"] = int(bad.sum())
    return out


def _err(got, ref, keys=("L", "Linv", "W", "y", "U", "ug")):
    return max([0.0] + [float(np.abs(got[k] - np.asarray(ref[k])).max())
                        for k in keys if got[k].size])


def check_smem_kernels(libs, Fm, gm, nf, ns, d, tol):
    """K3 and K4 against their plain versions; max error over both, and
    the bad-pivot count."""
    B, mb, sd = Fm.shape[0], nf + ns, ns * d
    tF, tg = torch.tensor(Fm), torch.tensor(gm)
    ref3 = cholesky.partial_cholesky_plain(tF, tg, nf, d)
    got3 = emulated_smem(libs, "smem", Fm, gm, nf, ns, d, (B, sd, sd), (B, sd))
    Fb = np.ascontiguousarray(cholesky.blocks_from_dense(tF, mb, d).numpy())
    gb = gm.reshape(B, mb, d)
    ref4 = cholesky.partial_cholesky_blocks_plain(torch.tensor(Fb), torch.tensor(gb), nf, ns, d)
    ref4["U"], ref4["ug"] = ref4["U_blocks"], ref4["ug_blocks"]
    assert got3["bad"] == int(ref3["bad"]), (got3["bad"], int(ref3["bad"]))
    err = _err(got3, ref3) if tol < np.inf else np.nan
    for G, plan in k4_variants(B, nf, ns, d, Fm.itemsize):
        got4 = emulated_smem(libs, "blocks", Fb.reshape(-1, d, d), gb, nf, ns, d,
                             (B, ns * ns, d, d), (B, ns, d), plan)
        assert got4["bad"] == int(ref4["bad"]), (G, got4["bad"], int(ref4["bad"]))
        if tol < np.inf:
            e4 = _err(got4, ref4)
            assert e4 < tol, (B, nf, ns, d, G, e4)
            err = max(err, e4)
    assert not err >= tol, (B, nf, ns, d, err)
    assert np.array_equal(got3["U"], got3["U"].transpose(0, 2, 1), equal_nan=True), \
        "K3's U is not symmetric"
    return err, got3["bad"]


def k2_variants(B, nf, ns, d, itemsize):
    """K2's plan for the shape, then each mode forced: warp mode where the
    front allows it (fd <= 32), cluster mode with one CTA a clique and with
    a cluster of three (ragged row slices)."""
    plan = cholesky_v2.k2_plan(B, nf, ns, d, itemsize)
    out = [("planned", plan)]
    if nf * d <= cholesky_v2.K2_WARP_MAX_FD and not plan.warp:
        out.append(("warp", cholesky_v2.k2_warp_plan(B, nf, ns, d, itemsize)))
    for c in (1, 3):
        if plan.warp or plan.cluster != c:
            out.append((f"cluster {c}", cholesky_v2.k2_cluster_plan(B, nf, ns, d, itemsize, c)))
    return out


def emulated_backsolve(lib, L, Linv, W, y, xs, nf, d, plan):
    B, fd, _ = L.shape
    x = np.empty((B, fd), L.dtype)
    fn = getattr(lib, "gtsam_backsolve_" + _sfx(L.dtype))
    assert fn(_ptr(L), _ptr(Linv), _ptr(W), _ptr(y), _ptr(xs), _ptr(x), B, nf,
              W.shape[2] // d, d, int(plan.warp), plan.grid, plan.threads, plan.cluster,
              plan.rows, plan.stages, plan.smem, None) == 0
    return x


def indefinite(rng, B, nf, ns, d, row, dt):
    """A bucket whose diagonal entry `row` of clique 0 is -5: the pivot
    there (and any that follow from it) is clamped and counted."""
    m = (nf + ns) * d
    A = rng.standard_normal((B, m, m))
    Fm = A @ A.transpose(0, 2, 1)
    Fm[0, row, row] = -5.0
    return np.ascontiguousarray(Fm.astype(dt)), rng.standard_normal((B, m)).astype(dt)


def main():
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as workdir:
        libs = compile_emulated(workdir)
        for dt in (np.float64, np.float32):
            for B, nf, ns, d in SHAPES:
                m = (nf + ns) * d
                A = rng.standard_normal((B, m, m))
                Fm = np.ascontiguousarray((A @ A.transpose(0, 2, 1) / m + np.eye(m)).astype(dt))
                gm = rng.standard_normal((B, m)).astype(dt)
                ref = kernels.partial_cholesky(torch.tensor(Fm), torch.tensor(gm), nf, d)
                got = emulated_partial_cholesky(libs, Fm, gm, nf, d)
                e1 = _err(got, ref)
                assert got["bad"] == int(ref["bad"]) and e1 < TOL[dt], (B, nf, ns, d, e1)
                assert np.array_equal(got["U"], got["U"].transpose(0, 2, 1)), "K1's U"
                glob = emulated_partial_cholesky(libs, Fm, gm, nf, d, force_global=True)
                e1g = _err(glob, ref)
                assert glob["bad"] == int(ref["bad"]) and e1g < TOL[dt], (B, nf, ns, d, e1g)
                args = [np.ascontiguousarray(ref[k].numpy()) for k in ("L", "Linv", "W", "y")]
                xs = rng.standard_normal((B, ns * d)).astype(dt)
                x_ref = cholesky_v2.backsolve_plain(*map(torch.tensor, args), torch.tensor(xs), nf, d)
                e2, modes = 0.0, []
                for mode, plan in k2_variants(B, nf, ns, d, np.dtype(dt).itemsize):
                    x = emulated_backsolve(libs["backsolve"], *args, xs, nf, d, plan)
                    e = float(np.abs(x - x_ref.numpy()).max())
                    assert e < TOL[dt], (B, nf, ns, d, mode, e)
                    e2 = max(e2, e)
                    modes.append(mode if mode != "planned" else
                                 ("warp" if plan.warp else f"cluster {plan.cluster}") + " (planned)")
                e34 = "does not fit shared memory"
                if cholesky.fits_smem(nf, ns, d, np.dtype(dt).itemsize):
                    e34 = "max err %.2e" % check_smem_kernels(libs, Fm, gm, nf, ns, d, TOL[dt])[0]
                print(f"{np.dtype(dt).name} B={B} nf={nf} ns={ns} d={d}: K1 ({got['branch']}) "
                      f"max err {e1:.2e}, both global branches {e1g:.2e}, K2 ({', '.join(modes)}) max err "
                      f"{e2:.2e}, "
                      f"K3/K4 (K4 at G = planned, 1, 4) {e34}", flush=True)
            # indefinite buckets: the bad pivot in the first diagonal block,
            # then in a later one; plain, K1, K3 and K4 count the same
            for B, nf, ns, d, row in ((2, 2, 1, 3, 0), (2, 3, 1, 3, 4), (1, 3, 2, 9, 10)):
                Fm, gm = indefinite(rng, B, nf, ns, d, row, dt)
                nb_ref = int(kernels.partial_cholesky(torch.tensor(Fm), torch.tensor(gm), nf,
                                                      d)["bad"])
                nb = emulated_partial_cholesky(libs, Fm, gm, nf, d)["bad"]
                nbg = emulated_partial_cholesky(libs, Fm, gm, nf, d, force_global=True)["bad"]
                _, nb34 = check_smem_kernels(libs, Fm, gm, nf, ns, d, np.inf)
                assert nb == nbg == nb34 == nb_ref >= 1, (nb, nbg, nb34, nb_ref)
                print(f"{np.dtype(dt).name} indefinite bucket, -5 on diagonal entry {row} "
                      f"(block {row // d}): {nb} clamped pivots in K1, K3 and K4, as the plain "
                      f"version", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
