"""Batched block partial-Cholesky kernels — plain PyTorch versions.

Port of gtsam_petercdev_tpu/inference/kernels.py. A whole shape bucket of
cliques [B, m, m] is factored by one Python loop over d x d block columns
whose body is a handful of batched products. These are the plain versions
of the CUDA kernels in `ops/cholesky_v2.py` and `ops/cholesky.py`: CPU
tensors run them, and `chip_smoke.py` holds each CUDA kernel against them on
the card.

Numerical-failure surfacing (choleskyCareful semantics): a pivot <= eps
(eps = 1e-10 in both dtypes) is clamped to eps and COUNTED; callers get the
bad-pivot count so LM can tell "indefinite at this lambda" from success.

`forward_solve_bucket` / `tri_lower_inv` come with the subgraph and
marginal slices.
"""

from __future__ import annotations

import math

import torch


def _chol_block(D: torch.Tensor, eps: float):
    """Unrolled dense Cholesky of one [B, d, d] SPD block.

    Returns (L lower [B, d, d], Linv [B, d, d], bad pivot count [B]).
    The triangular inverse is a Newton iteration X <- X(2I - M X), exact
    after ceil(log2(d)) steps for unit-lower-triangular M (the error
    E0 = N^2 is nilpotent and contracts as E -> E^2)."""
    B, d, _ = D.shape
    dtype, dev = D.dtype, D.device
    idx = torch.arange(d, device=dev)
    eye = torch.eye(d, dtype=dtype, device=dev)
    cols, pivs = [], []
    bad = torch.zeros((B,), dtype=torch.int32, device=dev)
    W = D
    for j in range(d):
        colW = W[:, :, j]  # [B, d]
        pivot = colW[:, j]
        bad = bad + (pivot <= eps).to(torch.int32)
        piv = torch.sqrt(torch.clamp(pivot, min=eps))
        ej = (idx == j).to(dtype)
        col = torch.where(idx > j, colW / piv[:, None], ej * piv[:, None])
        cols.append(col)
        pivs.append(piv)
        W = W - col[:, :, None] * col[:, None, :]
    L = torch.stack(cols, dim=2)  # [B, d, d] lower triangular
    piv = torch.stack(pivs, dim=1)  # [B, d] diagonal of L

    # L = Lc diag(piv) with Lc unit lower  =>  L^-1 = diag(1/piv) Lc^-1
    inv_piv = 1.0 / piv
    Lc = L * inv_piv[:, None, :]
    X = 2.0 * eye - Lc
    for _ in range(max(0, int(math.ceil(math.log2(d))) - 1)):
        X = X @ (2.0 * eye - Lc @ X)
    Linv = X * inv_piv[:, :, None]
    return L, Linv, bad


def partial_cholesky(Fm: torch.Tensor, gm: torch.Tensor, nf: int, d: int, eps=1e-10):
    """Partial block Cholesky of a clique bucket.

    Fm: [B, m, m] symmetric frontal matrices (m = (nf + ns) * d),
    gm: [B, m] right-hand sides. The first fd = nf*d rows/cols are frontal.

    Returns dict with:
      L    [B, fd, fd]   lower Cholesky factor of F11
      Linv [B, nf, d, d] inverses of L's diagonal blocks
      W    [B, fd, sd]   = L^-1 F12
      y    [B, fd]       = L^-1 g1
      U    [B, sd, sd]   Schur downdate F22 - W^T W
      ug   [B, sd]       g2 - W^T y
      bad  []            int32 count of clamped pivots in this bucket
    """
    B, m, _ = Fm.shape
    fd = nf * d
    sd = m - fd
    dtype, dev = Fm.dtype, Fm.device

    F = Fm[:, :fd, :fd]
    # RHS carries [F12 | g1]: forward-substituted in-loop so W and y pop out
    R = torch.cat([Fm[:, :fd, fd:], gm[:, :fd, None]], dim=2)
    L = torch.zeros((B, fd, fd), dtype=dtype, device=dev)
    Linv = torch.zeros((B, nf, d, d), dtype=dtype, device=dev)
    row_ids = torch.arange(fd, device=dev)[None, :, None]
    bad = torch.zeros((), dtype=torch.int32, device=dev)
    for j in range(nf):
        jd = j * d
        Lj, Linv_j, badj = _chol_block(F[:, jd : jd + d, jd : jd + d], eps)
        # panel below the diagonal block: L[i>j, j] = F[i, j] Linv_j^T
        P = F[:, :, jd : jd + d] @ Linv_j.transpose(1, 2)
        P = torch.where(row_ids >= jd + d, P, torch.zeros_like(P))
        L[:, :, jd : jd + d] = P
        L[:, jd : jd + d, jd : jd + d] = Lj
        Linv[:, j] = Linv_j
        # forward substitution on [F12 | g1]
        yj = Linv_j @ R[:, jd : jd + d, :]
        R[:, jd : jd + d, :] = yj
        R = R - P @ yj
        # SYRK trailing update (P is zero on factored rows)
        F = F - P @ P.transpose(1, 2)
        bad = bad + torch.sum(badj).to(torch.int32)

    W = R[:, :, :sd]
    y = R[:, :, sd]
    if sd > 0:
        U = Fm[:, fd:, fd:] - W.transpose(1, 2) @ W
        ug = gm[:, fd:] - torch.einsum("bkf,bk->bf", W, y)
    else:
        U = torch.zeros((B, 0, 0), dtype=dtype, device=dev)
        ug = torch.zeros((B, 0), dtype=dtype, device=dev)
    return dict(L=L, Linv=Linv, W=W, y=y, U=U, ug=ug, bad=bad)


def backsolve_bucket(L: torch.Tensor, Linv: torch.Tensor, rhs: torch.Tensor, nf: int, d: int):
    """Solve L^T x = rhs for one bucket, top-down by d x d blocks.

    L [B, fd, fd] lower (from partial_cholesky), Linv its diagonal-block
    inverses [B, nf, d, d], rhs [B, fd]."""
    x = torch.zeros_like(rhs)
    for jj in range(nf):
        j = nf - 1 - jj
        jd = j * d
        # subtract the already-solved entries (x is still zero on rows <= jd+d)
        rj = rhs[:, jd : jd + d] - torch.einsum("bfk,bf->bk", L[:, :, jd : jd + d], x)
        x[:, jd : jd + d] = torch.einsum("bkj,bk->bj", Linv[:, j], rj)  # Linv_j^T rj
    return x
