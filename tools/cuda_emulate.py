#!/usr/bin/env python3
"""Run the port's CUDA kernels on the CPU, for checking their logic where
there is no GPU and no nvcc.

    python3 tools/cuda_emulate.py

Each source in gtsam_petercdev_torch/csrc/ is compiled with g++ (C++20)
against a small header that emulates what the kernels use: blocks run one
after another, a block's threads run as std::threads, __syncthreads() is a
std::barrier, __shared__ arrays are statics and dynamic shared memory is a
per-CTA buffer of the size the launch asks for. The extern "C" entry points
are then called through ctypes on numpy arrays and their outputs held
against the plain PyTorch versions (inference/kernels.py, ops/cholesky.py)
at a set of bucket shapes with d = 3, 6, 9 and 16, in float64 and float32,
plus an indefinite bucket (equal bad-pivot counts). This checks indexing,
phases and barriers; it says nothing about speed or about what nvcc accepts.
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
from gtsam_petercdev_torch.ops import build, cholesky, cholesky_v2  # noqa: E402

FAKE_CUDA = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
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
struct dim3_ { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3_ threadIdx, blockIdx;
inline dim3_ blockDim, gridDim;
typedef void* cudaStream_t;
inline std::barrier<>* g_bar = nullptr;
inline void __syncthreads() { g_bar->arrive_and_wait(); }
typedef int cudaError_t;
constexpr int cudaSuccess = 0, cudaErrorInvalidValue = 1;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
inline int cudaGetLastError() { return 0; }
template <class K> int cudaFuncSetAttribute(K, int, int) { return 0; }
inline unsigned char* g_dyn_smem = nullptr;
template <class F>
void emu_launch(int B, int nt, size_t smem, F body) {
  blockDim.x = nt; gridDim.x = B;
  for (int b = 0; b < B; ++b) {
    std::barrier<> bar(nt);
    g_bar = &bar;
    std::vector<std::max_align_t> dyn(smem / sizeof(std::max_align_t) + 1);
    g_dyn_smem = reinterpret_cast<unsigned char*>(dyn.data());
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; ++t)
      ts.emplace_back([&, b, t]() { blockIdx.x = b; threadIdx.x = t; body(); });
    for (auto& th : ts) th.join();
  }
}
"""

# (B, nf, ns, d): leaves (ns = 0), 64-, 256- and 1024-thread CTAs, d = 3, 6,
# 9 (the bundle-adjustment block size) and 16
SHAPES = [(3, 2, 1, 6), (4, 1, 0, 6), (2, 4, 3, 6), (5, 3, 2, 3), (2, 12, 16, 6),
          (1, 8, 24, 6), (2, 4, 40, 6), (1, 32, 0, 6), (2, 3, 9, 16),
          (6, 1, 4, 9), (3, 1, 0, 9), (2, 2, 3, 9), (1, 6, 6, 9)]
TOL = {np.float64: 1e-12, np.float32: 1e-5}


def compile_emulated(workdir):
    """g++-compile each kernel source against the emulation header."""
    with open(os.path.join(workdir, "fake_cuda.h"), "w") as f:
        f.write(FAKE_CUDA)
    libs = {}
    for name, src in build.SOURCES.items():
        with open(os.path.join(build.CSRC, src)) as f:
            code = f.read().replace("#include <cuda_runtime.h>", '#include "fake_cuda.h"')
        # dynamic shared memory: the per-CTA buffer emu_launch allocates
        code = re.sub(r"extern\s+__shared__[^;]*?(\w+)\[\];",
                      r"unsigned char* \1 = g_dyn_smem;", code)
        # kernel<<<grid, block, smem, stream>>>(args); -> emu_launch(...)
        m = re.search(r"(\w+(?:<[^<>]*>)?)<<<([^,]+),\s*([^,]+),\s*([^,]+),.*?>>>\(", code, re.S)
        end = code.index(");", m.end())
        code = (code[: m.start()] + f"emu_launch({m.group(2)}, {m.group(3)}, {m.group(4)}, "
                f"[&]() {{ {m.group(1)}(" + code[m.end():end] + "); });" + code[end + 2:])
        cpp = os.path.join(workdir, f"{name}.cpp")
        with open(cpp, "w") as f:
            f.write(code)
        so = os.path.join(workdir, f"lib{name}.so")
        subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC", "-Wall",
                        "-o", so, cpp], check=True)
        libs[name] = build.declare(ctypes.CDLL(so), name)
    return libs


def _ptr(a):
    return a.ctypes.data if a.size else None


def emulated_partial_cholesky(lib, Fm, gm, nf, d):
    B, m, _ = Fm.shape
    fd, dt = nf * d, Fm.dtype
    sd = m - fd
    out = dict(L=np.empty((B, fd, fd), dt), Linv=np.empty((B, nf, d, d), dt),
               W=np.empty((B, fd, sd), dt), y=np.empty((B, fd), dt),
               U=np.empty((B, sd, sd), dt), ug=np.empty((B, sd), dt))
    S, bad = np.empty((B, fd, m + 1), dt), np.empty(B, np.int32)
    fn = getattr(lib, "gtsam_partial_cholesky_" + ("f64" if dt == np.float64 else "f32"))
    err = fn(_ptr(Fm), _ptr(gm), _ptr(S), *(_ptr(out[k]) for k in ("L", "Linv", "W", "y", "U", "ug")),
             _ptr(bad), B, nf, sd // d, d, 1e-10, None)
    assert err == 0
    out["bad"] = int(bad.sum())
    return out


def emulated_smem(lib, entry, F, g, nf, ns, d, u_shape, ug_shape):
    """K3 (entry "smem": F [B, m, m]) or K4 (entry "blocks": F as blocks)."""
    B, dt = g.shape[0], F.dtype
    fd, sd = nf * d, ns * d
    out = dict(L=np.empty((B, fd, fd), dt), Linv=np.empty((B, nf, d, d), dt),
               W=np.empty((B, fd, sd), dt), y=np.empty((B, fd), dt),
               U=np.empty(u_shape, dt), ug=np.empty(ug_shape, dt))
    bad = np.empty(B, np.int32)
    fn = getattr(lib, f"gtsam_partial_cholesky_{entry}_" + ("f64" if dt == np.float64 else "f32"))
    err = fn(_ptr(F), _ptr(g), *(_ptr(out[k]) for k in ("L", "Linv", "W", "y", "U", "ug")),
             _ptr(bad), B, nf, ns, d, 1e-10, None)
    assert err == 0
    out["bad"] = int(bad.sum())
    return out


def check_smem_kernels(lib, Fm, gm, nf, ns, d, tol):
    """K3 and K4 against their plain versions; max error over both."""
    B, mb, sd = Fm.shape[0], nf + ns, ns * d
    tF, tg = torch.tensor(Fm), torch.tensor(gm)
    ref3 = cholesky.partial_cholesky_plain(tF, tg, nf, d)
    got3 = emulated_smem(lib, "smem", Fm, gm, nf, ns, d, (B, sd, sd), (B, sd))
    Fb = np.ascontiguousarray(cholesky.blocks_from_dense(tF, mb, d).numpy())
    gb = gm.reshape(B, mb, d)
    ref4 = cholesky.partial_cholesky_blocks_plain(torch.tensor(Fb), torch.tensor(gb), nf, ns, d)
    got4 = emulated_smem(lib, "blocks", Fb.reshape(-1, d, d), gb, nf, ns, d,
                         (B, ns * ns, d, d), (B, ns, d))
    ref4["U"], ref4["ug"] = ref4["U_blocks"], ref4["ug_blocks"]
    err = 0.0
    for got, ref in ((got3, ref3), (got4, ref4)):
        assert got["bad"] == int(ref["bad"]), (got["bad"], int(ref["bad"]))
        err = max([err] + [float(np.abs(got[k] - ref[k].numpy()).max())
                           for k in ("L", "Linv", "W", "y", "U", "ug") if got[k].size])
    assert err < tol, (B, nf, ns, d, err)
    return err, got3["bad"]


def emulated_backsolve(lib, L, Linv, W, y, xs, nf, d):
    B, fd, _ = L.shape
    x = np.empty((B, fd), L.dtype)
    fn = getattr(lib, "gtsam_backsolve_" + ("f64" if L.dtype == np.float64 else "f32"))
    assert fn(_ptr(L), _ptr(Linv), _ptr(W), _ptr(y), _ptr(xs), _ptr(x), B, nf,
              W.shape[2] // d, d, None) == 0
    return x


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
                got = emulated_partial_cholesky(libs["partial_cholesky"], Fm, gm, nf, d)
                e1 = max(float(np.abs(got[k] - ref[k].numpy()).max())
                         for k in ("L", "Linv", "W", "y", "U", "ug") if got[k].size)
                assert got["bad"] == int(ref["bad"]) and e1 < TOL[dt], (B, nf, ns, d, e1)
                args = [np.ascontiguousarray(ref[k].numpy()) for k in ("L", "Linv", "W", "y")]
                xs = rng.standard_normal((B, ns * d)).astype(dt)
                x_ref = cholesky_v2.backsolve_plain(*map(torch.tensor, args), torch.tensor(xs), nf, d)
                x = emulated_backsolve(libs["backsolve"], *args, xs, nf, d)
                e2 = float(np.abs(x - x_ref.numpy()).max())
                assert e2 < TOL[dt], (B, nf, ns, d, e2)
                e34 = "does not fit shared memory"
                if cholesky.fits_smem(nf, ns, d, np.dtype(dt).itemsize):
                    e34 = "max err %.2e" % check_smem_kernels(
                        libs["partial_cholesky_smem"], Fm, gm, nf, ns, d, TOL[dt])[0]
                print(f"{np.dtype(dt).name} B={B} nf={nf} ns={ns} d={d}: "
                      f"K1 max err {e1:.2e}, K2 max err {e2:.2e}, K3/K4 {e34}")
        B, nf, ns, d = 2, 2, 1, 3
        m = (nf + ns) * d
        A = rng.standard_normal((B, m, m))
        Fm = np.ascontiguousarray(A @ A.transpose(0, 2, 1))
        Fm[0, 0, 0] = -5.0
        gm = rng.standard_normal((B, m))
        nb = emulated_partial_cholesky(libs["partial_cholesky"], Fm, gm, nf, d)["bad"]
        nb_ref = int(kernels.partial_cholesky(torch.tensor(Fm), torch.tensor(gm), nf, d)["bad"])
        assert nb == nb_ref >= 1, (nb, nb_ref)
        _, nb34 = check_smem_kernels(libs["partial_cholesky_smem"], Fm, gm, nf, ns, d, np.inf)
        assert nb34 == nb_ref, (nb34, nb_ref)
        print(f"indefinite bucket: {nb} clamped pivots in K1, K3 and K4, as the plain version")
    return 0


if __name__ == "__main__":
    sys.exit(main())
