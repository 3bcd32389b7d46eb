"""Schur-complement stage of K1 and K3: U = F22 - W^T W, ug = g2 - W^T y.

The wrapper of `csrc/schur_update.cu`, which `ops/cholesky_v2.py`
(K1) and `ops/cholesky.py` (K3) launch after their factor stages. It is
not a TPU kernel of its own: the Pallas kernels formed U inside the
per-clique program. Its plain version is the tail of
`inference/kernels.partial_cholesky`.

Launch plan: grid (B, tiles), one CTA of `THREADS` threads per `TILE` x
`TILE` tile of U's lower triangle, in the order `tiles(sd)` gives; each
tile writes its part of the lower triangle and the mirror.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from gtsam_petercdev_torch.ops import build

TILE = 64  # csrc/schur_update.cu kTile
THREADS = 128  # csrc/schur_update.cu kThreads


def n_tiles(sd: int) -> int:
    """CTAs along the grid's y axis: the lower triangle of U's
    ceil(sd / TILE)^2 tiles."""
    nt = -(-sd // TILE)
    return nt * (nt + 1) // 2


def tiles(sd: int) -> List[Tuple[int, int]]:
    """(tile row, tile column) of each of the n_tiles(sd) CTAs, in grid
    order: row by row."""
    nt = -(-sd // TILE)
    return [(ti, tj) for ti in range(nt) for tj in range(ti + 1)]


def launch(F, g, W, y, U, ug, sfx: str) -> int:
    """Launch the stage on the current stream for dense F [B, m, m], g
    [B, m], W [B, fd, sd], y [B, fd] into U [B, sd, sd], ug [B, sd]
    (contiguous CUDA tensors of one dtype); returns the CUDA launches made
    (0 when there is no separator)."""
    B, fd, sd = W.shape
    if not (B and sd):
        return 0
    fn = getattr(build.load("schur_update"), f"gtsam_schur_update_{sfx}")
    err = fn(F.data_ptr(), g.data_ptr(), W.data_ptr(), y.data_ptr(), U.data_ptr(),
             ug.data_ptr(), B, fd, sd, n_tiles(sd), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"schur_update: CUDA launch failed with cudaError {err}")
    return 1
