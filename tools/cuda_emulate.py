#!/usr/bin/env python3
"""Run the port's CUDA kernels on the CPU, for checking their logic where
there is no GPU and no nvcc.

    python3 tools/cuda_emulate.py

Each source in gtsam_petercdev_torch/csrc/ is compiled with g++ (C++20)
against a small header that emulates what the kernels use: blocks run one
after another, a block's threads run as std::threads, __syncthreads() is a
std::barrier, __shared__ arrays are statics. The extern "C" entry points
are then called through ctypes on numpy arrays and their outputs held
against the plain PyTorch versions (inference/kernels.py) at a set of
bucket shapes, in float64 and float32, plus an indefinite bucket (equal
bad-pivot counts). This checks indexing, phases and barriers; it says
nothing about speed or about what nvcc accepts.
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
from gtsam_petercdev_torch.ops import build, cholesky_v2  # noqa: E402

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
using std::sqrt;
inline float sqrtf(float x) { return std::sqrt(x); }
struct dim3_ { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3_ threadIdx, blockIdx;
inline dim3_ blockDim, gridDim;
typedef void* cudaStream_t;
inline std::barrier<>* g_bar = nullptr;
inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline int cudaGetLastError() { return 0; }
template <class F>
void emu_launch(int B, int nt, F body) {
  blockDim.x = nt; gridDim.x = B;
  for (int b = 0; b < B; ++b) {
    std::barrier<> bar(nt);
    g_bar = &bar;
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; ++t)
      ts.emplace_back([&, b, t]() { blockIdx.x = b; threadIdx.x = t; body(); });
    for (auto& th : ts) th.join();
  }
}
"""

# (B, nf, ns, d): leaves (ns = 0), 256- and 1024-thread CTAs, d = 3 and 16
SHAPES = [(3, 2, 1, 6), (4, 1, 0, 6), (2, 4, 3, 6), (5, 3, 2, 3), (2, 12, 16, 6),
          (1, 8, 24, 6), (2, 4, 40, 6), (1, 32, 0, 6), (2, 3, 9, 16)]
TOL = {np.float64: 1e-12, np.float32: 1e-5}


def compile_emulated(workdir):
    """g++-compile each kernel source against the emulation header."""
    with open(os.path.join(workdir, "fake_cuda.h"), "w") as f:
        f.write(FAKE_CUDA)
    libs = {}
    for name, src in build.SOURCES.items():
        with open(os.path.join(build.CSRC, src)) as f:
            code = f.read().replace("#include <cuda_runtime.h>", '#include "fake_cuda.h"')
        # kernel<T><<<grid, block, smem, stream>>>(args); -> emu_launch(...)
        m = re.search(r"(\w+<T>)<<<([^,]+),\s*([^,]+),.*?>>>\(", code, re.S)
        end = code.index(");", m.end())
        code = (code[: m.start()] + f"emu_launch({m.group(2)}, {m.group(3)}, [&]() {{ "
                f"{m.group(1)}(" + code[m.end():end] + "); });" + code[end + 2:])
        cpp = os.path.join(workdir, f"{name}.cpp")
        with open(cpp, "w") as f:
            f.write(code)
        so = os.path.join(workdir, f"lib{name}.so")
        subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC", "-Wall",
                        "-o", so, cpp], check=True)
        libs[name] = ctypes.CDLL(so)
        for sfx, T in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
            fn = getattr(libs[name], f"gtsam_{name}_{sfx}")
            fn.argtypes = build._SIGNATURES[name](T)
            fn.restype = ctypes.c_int
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
                print(f"{np.dtype(dt).name} B={B} nf={nf} ns={ns} d={d}: "
                      f"K1 max err {e1:.2e}, K2 max err {e2:.2e}")
        B, nf, ns, d = 2, 2, 1, 3
        m = (nf + ns) * d
        A = rng.standard_normal((B, m, m))
        Fm = np.ascontiguousarray(A @ A.transpose(0, 2, 1))
        Fm[0, 0, 0] = -5.0
        gm = rng.standard_normal((B, m))
        nb = emulated_partial_cholesky(libs["partial_cholesky"], Fm, gm, nf, d)["bad"]
        nb_ref = int(kernels.partial_cholesky(torch.tensor(Fm), torch.tensor(gm), nf, d)["bad"])
        assert nb == nb_ref >= 1, (nb, nb_ref)
        print(f"indefinite bucket: {nb} clamped pivots, as the plain version")
    return 0


if __name__ == "__main__":
    sys.exit(main())
