"""Per-clique partial Cholesky in shared memory (K3) and its block-pool
variant (K4): CUDA wrappers and plain versions.

Port of gtsam_petercdev_tpu/ops/cholesky.py (`partial_cholesky`,
`partial_cholesky_blocks`). Both kernels are one hand-written CUDA source
for sm_90a, `csrc/partial_cholesky_smem.cu`: one CTA per clique, the
clique's working copy [F11 | F12 | g1] resident in shared memory as it was
resident in VMEM on the TPU (the source notes say what bounds them). K4
forms U in that CTA; K3 stops after W and y and forms U and ug in a second
launch over 64 x 64 tiles of U (`ops/schur_update.py`).

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


def _launch(wrapper, entry, F, g, B, nf, ns, d, eps, u_shape, ug_shape, schur):
    """Allocate the outputs and launch one entry point of the library for
    `wrapper` (then, with `schur`, the Schur-complement stage for U and
    ug), counting the call and its CUDA launches on it."""
    name = wrapper.__name__
    if not fits_smem(nf, ns, d, F.element_size()):
        raise ValueError(
            f"{name}: clique nf={nf} ns={ns} d={d} needs "
            f"{smem_bytes(nf, ns, d, F.element_size())} bytes of shared memory, "
            f"the card has {SMEM_LIMIT} per CTA"
        )
    sfx = _check_cuda(name, F, g)
    fd, sd = nf * d, ns * d
    new = lambda *shape: torch.empty(shape, dtype=F.dtype, device=F.device)
    L, Linv, W, y = new(B, fd, fd), new(B, nf, d, d), new(B, fd, sd), new(B, fd)
    U, ug = new(*u_shape), new(*ug_shape)
    bad = torch.empty((B,), dtype=torch.int32, device=F.device)
    if B:
        fn = getattr(build.load("partial_cholesky_smem"), f"{entry}_{sfx}")
        with torch.cuda.device(F.device):
            err = fn(
                _ptr(F), _ptr(g), _ptr(L), _ptr(Linv), _ptr(W), _ptr(y), _ptr(U),
                _ptr(ug), _ptr(bad), B, nf, ns, d, float(eps),
                torch.cuda.current_stream().cuda_stream,
            )
            _raise_on(err, name)
            n = 1 + (schur_update.launch(F, g, W, y, U, ug, sfx) if schur else 0)
        wrapper.launches += 1
        wrapper.cuda_launches += n
    return L, Linv, W, y, U, ug, torch.sum(bad).to(torch.int32)


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
    L, Linv, W, y, U, ug, bad = _launch(
        partial_cholesky, "gtsam_partial_cholesky_smem", Fm.contiguous(), gm.contiguous(),
        B, nf, sd // d, d, eps, (B, sd, sd), (B, sd), schur=True)
    return dict(L=L, Linv=Linv, W=W, y=y, U=U, ug=ug, bad=bad)


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
    L, Linv, W, y, U, ug, bad = _launch(
        partial_cholesky_blocks, "gtsam_partial_cholesky_blocks", Fblocks.contiguous(),
        gblocks.contiguous(), B, nf, ns, d, eps, (B, ns * ns, d, d), (B, ns, d), schur=False)
    return dict(L=L, Linv=Linv, W=W, y=y, U_blocks=U, ug_blocks=ug, bad=bad)


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
