"""Per-clique partial Cholesky in shared memory (K3) and its block-pool
variant (K4): CUDA wrappers and plain versions.

Port of gtsam_petercdev_tpu/ops/cholesky.py (`partial_cholesky`,
`partial_cholesky_blocks`). Both kernels are hand-written CUDA for sm_90a in
one source, `csrc/partial_cholesky_smem.cu`, each clique's working copy
[F11 | F12 | g1] resident in shared memory as it was resident in VMEM on the
TPU (the source notes say what bounds them). K3 is one CTA per clique and
stops after W and y; U and ug come from a second launch over 64 x 64 tiles
of U (`ops/schur_update.py`). K4 is one launch with G cliques a CTA
(`k4_plan`): a warp runs each clique's chain, the CTA copies the pool
slice in and forms U and ug.

  partial_cholesky         F [B, m, m], g [B, m]  ->  L, Linv, W, y, U, ug, bad
  partial_cholesky_blocks  F as the elimination pool slice [B*mb*mb, d, d]
                           (row-major d x d blocks), g [B, mb, d]  ->
                           L, Linv, W, y, U_blocks [B, ns*ns, d, d],
                           ug_blocks [B, ns, d], bad

`fits_smem(nf, ns, d, itemsize)` says whether a clique's working copy fits
the card's 227 KB of shared memory per CTA. The wrappers dispatch by the
tensor's device alone: a CPU tensor takes the plain PyTorch version, a CUDA
tensor launches the kernel or raises — a clique that does not fit raises
too; nothing is handed to another kernel or to the plain version.

Each wrapper counts its calls that launch in `<wrapper>.launches` and the
CUDA launches they make in `<wrapper>.cuda_launches`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from gtsam_petercdev_torch.inference import kernels
from gtsam_petercdev_torch.ops import build, cholesky_v2, schur_update
from gtsam_petercdev_torch.ops.cholesky_v2 import (MAX_D, SMEM_LIMIT, _check_cuda, _ptr,
                                                   _raise_on)


def smem_bytes(nf: int, ns: int, d: int, itemsize: int) -> int:
    """Dynamic shared memory of one clique in `partial_cholesky_smem.cu`:
    the working copy fd x (m + 1), the panel fd x d, two d x d tiles, and
    16 bytes for the bad-pivot counter."""
    fd, m = nf * d, (nf + ns) * d
    return (fd * (m + 1) + fd * d + 2 * d * d) * itemsize + 16


def fits_smem(nf: int, ns: int, d: int, itemsize: int) -> bool:
    """True when one clique of shape (nf, ns, d) fits K3 / K4."""
    return 0 < d <= MAX_D and smem_bytes(nf, ns, d, itemsize) <= SMEM_LIMIT


K4_MAX_G = 8  # cliques per CTA
K4_WARP_MAX_FD = 32  # a clique this small is one warp's (G > 1)


class K4Plan(NamedTuple):
    """The one launch of K4 for one bucket."""
    cliques_per_cta: int  # G; each clique's chain is a warp's when G > 1, else the CTA's
    grid: int
    threads: int
    smem: int


@functools.lru_cache(maxsize=None)
def k4_plan(B: int, nf: int, ns: int, d: int, itemsize: int) -> K4Plan:
    """Cliques per CTA, grid and shared memory of K4, by shape alone. A
    clique of fd <= K4_WARP_MAX_FD shares its CTA with up to K4_MAX_G - 1
    others, as many as leave room for four such CTAs on an SM; a larger one
    has a CTA to itself (K3's thread count). Shared memory: G working copies
    (`smem_bytes` less its 16-byte counter), then G int counters rounded up
    to 16 bytes."""
    fd, m = nf * d, (nf + ns) * d
    per = smem_bytes(nf, ns, d, itemsize) - 16
    G = 1
    if fd <= K4_WARP_MAX_FD:
        G = max(1, min(K4_MAX_G, B, SMEM_LIMIT // (4 * per)))
    threads = 32 * G if G > 1 else (64 if fd * (m + 1) <= 1024 else (1024 if m >= 192 else 256))
    return K4Plan(cliques_per_cta=G, grid=-(-B // G), threads=threads,
                  smem=G * per + 16 * -(-G // 4))


def _outputs(F, B, nf, ns, d, u_shape, ug_shape):
    new = lambda *shape: torch.empty(shape, dtype=F.dtype, device=F.device)
    fd, sd = nf * d, ns * d
    return (new(B, fd, fd), new(B, nf, d, d), new(B, fd, sd), new(B, fd), new(*u_shape),
            new(*ug_shape), torch.empty((B,), dtype=torch.int32, device=F.device))


def _refuse_large(name, nf, ns, d, itemsize):
    if not fits_smem(nf, ns, d, itemsize):
        raise ValueError(
            f"{name}: clique nf={nf} ns={ns} d={d} needs {smem_bytes(nf, ns, d, itemsize)} "
            f"bytes of shared memory, the card has {SMEM_LIMIT} per CTA")


# --- K3: dense frontal matrices ---------------------------------------------


def partial_cholesky_plain(Fm, gm, nf: int, d: int, eps=1e-10):
    """Plain version of K3: the batched block algorithm of
    inference/kernels.py."""
    return kernels.partial_cholesky(Fm, gm, nf, d, eps)


def partial_cholesky(Fm: torch.Tensor, gm: torch.Tensor, nf: int, d: int, eps=1e-10):
    """Per-clique partial Cholesky; same contract as
    kernels.partial_cholesky (dict of L, Linv, W, y, U, ug, bad)."""
    if Fm.device.type == "cpu":
        return partial_cholesky_plain(Fm, gm, nf, d, eps)
    B, m, _ = Fm.shape
    sd = m - nf * d
    if d <= 0 or nf <= 0 or sd < 0 or sd % d or gm.shape != (B, m):
        raise ValueError(f"partial_cholesky: bad shapes Fm {tuple(Fm.shape)} gm "
                         f"{tuple(gm.shape)} nf={nf} d={d}")
    _refuse_large("partial_cholesky", nf, sd // d, d, Fm.element_size())
    Fm, gm = Fm.contiguous(), gm.contiguous()
    sfx = _check_cuda("partial_cholesky", Fm, gm)
    L, Linv, W, y, U, ug, bad = _outputs(Fm, B, nf, sd // d, d, (B, sd, sd), (B, sd))
    if B:
        fn = getattr(build.load("partial_cholesky_smem"), f"gtsam_partial_cholesky_smem_{sfx}")
        with torch.cuda.device(Fm.device):
            _raise_on(fn(_ptr(Fm), _ptr(gm), _ptr(L), _ptr(Linv), _ptr(W), _ptr(y), _ptr(bad),
                         B, nf, sd // d, d, float(eps), torch.cuda.current_stream().cuda_stream),
                      "partial_cholesky")
            n = 1 + schur_update.launch(Fm, gm, W, y, U, ug, sfx)
        partial_cholesky.launches += 1
        partial_cholesky.cuda_launches += n
    return dict(L=L, Linv=Linv, W=W, y=y, U=U, ug=ug, bad=torch.sum(bad).to(torch.int32))


partial_cholesky.launches = 0
partial_cholesky.cuda_launches = 0


# --- K4: block-pool layout -----------------------------------------------------


def blocks_from_dense(Fm: torch.Tensor, nb: int, d: int) -> torch.Tensor:
    """[B, nb*d, nb*d] -> [B, nb*nb, d, d] row-major blocks."""
    B = Fm.shape[0]
    return Fm.reshape(B, nb, d, nb, d).permute(0, 1, 3, 2, 4).reshape(B, nb * nb, d, d)


def dense_from_blocks(Fb: torch.Tensor, B: int, nb: int, d: int) -> torch.Tensor:
    """[B*nb*nb, d, d] (or [B, nb*nb, d, d]) blocks -> [B, nb*d, nb*d]."""
    return Fb.reshape(B, nb, nb, d, d).permute(0, 1, 3, 2, 4).reshape(B, nb * d, nb * d)


def partial_cholesky_blocks_plain(Fblocks, gblocks, nf: int, ns: int, d: int, eps=1e-10):
    """Plain version of K4: relayout the blocks to dense frontal matrices,
    run the plain partial Cholesky, block U and ug."""
    B, mb = gblocks.shape[0], nf + ns
    out = kernels.partial_cholesky(
        dense_from_blocks(Fblocks, B, mb, d), gblocks.reshape(B, mb * d), nf, d, eps)
    U, ug = out.pop("U"), out.pop("ug")
    out["U_blocks"] = blocks_from_dense(U, ns, d)
    out["ug_blocks"] = ug.reshape(B, ns, d)
    return out


def partial_cholesky_blocks(Fblocks: torch.Tensor, gblocks: torch.Tensor, nf: int, ns: int,
                            d: int, eps=1e-10):
    """Block-pool-native partial Cholesky.

    Fblocks: [B*mb*mb, d, d] row-major clique blocks (a pool slice, or any
    view of that many elements); gblocks: [B, mb, d]. Returns dict of L,
    Linv, W, y, bad and U_blocks [B, ns*ns, d, d], ug_blocks [B, ns, d] in
    block layout for the parent's extend-add."""
    if Fblocks.device.type == "cpu":
        return partial_cholesky_blocks_plain(Fblocks, gblocks, nf, ns, d, eps)
    B, mb = gblocks.shape[0], nf + ns
    if d <= 0 or nf <= 0 or ns < 0 or gblocks.shape != (B, mb, d) \
            or Fblocks.numel() != B * mb * mb * d * d:
        raise ValueError(f"partial_cholesky_blocks: bad shapes Fblocks {tuple(Fblocks.shape)} "
                         f"gblocks {tuple(gblocks.shape)} nf={nf} ns={ns} d={d}")
    itemsize = Fblocks.element_size()
    _refuse_large("partial_cholesky_blocks", nf, ns, d, itemsize)
    Fblocks, gblocks = Fblocks.contiguous(), gblocks.contiguous()
    sfx = _check_cuda("partial_cholesky_blocks", Fblocks, gblocks)
    plan = k4_plan(B, nf, ns, d, itemsize)
    L, Linv, W, y, U, ug, bad = _outputs(Fblocks, B, nf, ns, d, (B, ns * ns, d, d), (B, ns, d))
    if B:
        fn = getattr(build.load("partial_cholesky_smem"), f"gtsam_partial_cholesky_blocks_{sfx}")
        with torch.cuda.device(Fblocks.device):
            _raise_on(fn(_ptr(Fblocks), _ptr(gblocks), _ptr(L), _ptr(Linv), _ptr(W), _ptr(y),
                         _ptr(U), _ptr(ug), _ptr(bad), B, nf, ns, d, float(eps),
                         plan.cliques_per_cta, plan.threads, plan.smem,
                         torch.cuda.current_stream().cuda_stream), "partial_cholesky_blocks")
        partial_cholesky_blocks.launches += 1
        partial_cholesky_blocks.cuda_launches += 1
    return dict(L=L, Linv=Linv, W=W, y=y, U_blocks=U, ug_blocks=ug,
                bad=torch.sum(bad).to(torch.int32))


partial_cholesky_blocks.launches = 0
partial_cholesky_blocks.cuda_launches = 0


_WRAPPERS = {
    "partial_cholesky": lambda: cholesky_v2.partial_cholesky,
    "backsolve_bucket": lambda: cholesky_v2.backsolve_bucket,
    "partial_cholesky_smem": lambda: partial_cholesky,
    "partial_cholesky_blocks": lambda: partial_cholesky_blocks,
}


def launch_counts() -> dict:
    """Wrapper calls that launched, per bucket kernel, since the last reset."""
    return {k: fn().launches for k, fn in _WRAPPERS.items()}


def cuda_launch_counts() -> dict:
    """CUDA launches those calls made (K1: 3 a bucket, K3: 2; 1 fewer
    where the bucket has no separator)."""
    return {k: fn().cuda_launches for k, fn in _WRAPPERS.items()}


reset_launch_counts = cholesky_v2.reset_launch_counts
