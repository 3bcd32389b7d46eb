"""Bucket partial Cholesky (K1) and fused backsolve (K2): CUDA wrappers.

Port of gtsam_petercdev_tpu/ops/cholesky_v2.py (`partial_cholesky`,
`backsolve_bucket`). The kernels are hand-written CUDA C++ for sm_90a in
`csrc/partial_cholesky.cu` and `csrc/backsolve.cu`, one CTA per clique
(the source notes say what bounds them).

Dispatch is by the tensor's device alone: a CPU tensor takes the plain
PyTorch version (`inference/kernels.py`), a CUDA tensor launches the kernel
or raises. There is no fallback and no switch; on the card every bucket,
the largest front included, goes through the kernel.

Each wrapper counts its launches in `<wrapper>.launches`.
"""

from __future__ import annotations

import torch

from gtsam_petercdev_torch.inference import kernels
from gtsam_petercdev_torch.ops import build

MAX_D = 16  # block size the kernels' shared-memory tiles hold
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check_cuda(name: str, *tensors: torch.Tensor) -> str:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}; the kernel takes CUDA tensors")
    dtype = tensors[0].dtype
    if dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {dtype} not supported (float32/float64)")
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: mixed devices or dtypes")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return _SUFFIX[dtype]


def _ptr(t: torch.Tensor):
    return t.data_ptr() if t.numel() else None


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def partial_cholesky(Fm: torch.Tensor, gm: torch.Tensor, nf: int, d: int, eps=1e-10):
    """Whole-bucket partial Cholesky; same contract as
    kernels.partial_cholesky (dict of L, Linv, W, y, U, ug, bad)."""
    if Fm.device.type == "cpu":
        return kernels.partial_cholesky(Fm, gm, nf, d, eps)
    B, m, _ = Fm.shape
    fd = nf * d
    sd = m - fd
    if not (0 < d <= MAX_D) or sd < 0 or sd % d or gm.shape != (B, m):
        raise ValueError(f"partial_cholesky: bad shapes Fm {tuple(Fm.shape)} gm "
                         f"{tuple(gm.shape)} nf={nf} d={d}")
    Fm, gm = Fm.contiguous(), gm.contiguous()
    sfx = _check_cuda("partial_cholesky", Fm, gm)
    new = lambda *shape: torch.empty(shape, dtype=Fm.dtype, device=Fm.device)
    L, Linv, W, y = new(B, fd, fd), new(B, nf, d, d), new(B, fd, sd), new(B, fd)
    U, ug = new(B, sd, sd), new(B, sd)
    scratch = new(B, fd, m + 1)  # per-clique working copy [F11 | F12 | g1]
    bad = torch.empty((B,), dtype=torch.int32, device=Fm.device)
    if B:
        fn = getattr(build.load("partial_cholesky"), f"gtsam_partial_cholesky_{sfx}")
        with torch.cuda.device(Fm.device):
            err = fn(
                _ptr(Fm), _ptr(gm), _ptr(scratch), _ptr(L), _ptr(Linv), _ptr(W),
                _ptr(y), _ptr(U), _ptr(ug), _ptr(bad), B, nf, sd // d, d, float(eps),
                torch.cuda.current_stream().cuda_stream,
            )
        _raise_on(err, "partial_cholesky")
        partial_cholesky.launches += 1
    return dict(L=L, Linv=Linv, W=W, y=y, U=U, ug=ug,
                bad=torch.sum(bad).to(torch.int32))


partial_cholesky.launches = 0


def backsolve_plain(L, Linv, W, y, xs, nf: int, d: int):
    """Plain version of the fused backsolve: L^T x = y - W xs."""
    rhs = y - torch.einsum("bfs,bs->bf", W, xs) if W.shape[2] else y
    return kernels.backsolve_bucket(L, Linv, rhs, nf, d)


def backsolve_bucket(L, Linv, W, y, xs, nf: int, d: int):
    """Fused top-down back-substitution for one bucket: solves
    L^T x = y - W @ xs. W / xs may be zero-width (root buckets)."""
    if L.device.type == "cpu":
        return backsolve_plain(L, Linv, W, y, xs, nf, d)
    B, fd, _ = L.shape
    sd = W.shape[2]
    if not (0 < d <= MAX_D) or fd != nf * d or sd % d or xs.shape != (B, sd) \
            or y.shape != (B, fd) or Linv.shape != (B, nf, d, d):
        raise ValueError("backsolve_bucket: bad shapes")
    L, Linv, W, y, xs = (t.contiguous() for t in (L, Linv, W, y, xs))
    sfx = _check_cuda("backsolve_bucket", L, Linv, W, y, xs)
    x = torch.empty((B, fd), dtype=L.dtype, device=L.device)
    if B:
        fn = getattr(build.load("backsolve"), f"gtsam_backsolve_{sfx}")
        with torch.cuda.device(L.device):
            err = fn(
                _ptr(L), _ptr(Linv), _ptr(W), _ptr(y), _ptr(xs), _ptr(x),
                B, nf, sd // d, d, torch.cuda.current_stream().cuda_stream,
            )
        _raise_on(err, "backsolve_bucket")
        backsolve_bucket.launches += 1
    return x


backsolve_bucket.launches = 0


def reset_launch_counts() -> None:
    partial_cholesky.launches = 0
    backsolve_bucket.launches = 0
