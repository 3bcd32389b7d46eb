"""Linear solvers over a LinearizedGraph.

Port of gtsam_petercdev_tpu/linear/solve.py:
  * `gradient` / `hvp`: matrix-free J^T b and (J^T J) v, one batched
    product per factor batch plus an `index_add_` per slot.
  * `assemble_dense` / `dense_solve`: the exact dense Cholesky solve — the
    oracle the sparse multifrontal path is checked against.
`pcg_solve` (block-Jacobi PCG) comes with a later slice.

Delta vectors are VectorValues: {type_name: [N_t, dim_t]}.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from gtsam_petercdev_torch.core import manifold
from gtsam_petercdev_torch.nonlinear.factor_graph import LinearBatch, LinearizedGraph

VectorValues = Dict[str, torch.Tensor]


def _tdim(t: str) -> int:
    return manifold.get(t).dim


def _rows(lb: LinearBatch, k: int) -> torch.Tensor:
    if lb.rows_dev:
        return lb.rows_dev[k]
    return torch.as_tensor(lb.rows[k], dtype=torch.int64).to(lb.b.device)


def zero_delta(lg: LinearizedGraph, dtype, device) -> VectorValues:
    return {
        t: torch.zeros((n, _tdim(t)), dtype=dtype, device=device)
        for t, n in lg.type_counts.items()
    }


def gradient(lg: LinearizedGraph) -> VectorValues:
    """g = J^T b (= -J^T r, the negative gradient of 0.5||r||^2)."""
    b0 = lg.batches[0].b
    g = zero_delta(lg, b0.dtype, b0.device)
    for lb in lg.batches:
        for k, t in enumerate(lb.var_types):
            contrib = lb.sign * torch.einsum("ndk,nd->nk", lb.A[k], lb.b)
            g[t].index_add_(0, _rows(lb, k), contrib)
    return g


def hvp(lg: LinearizedGraph, v: VectorValues) -> VectorValues:
    """(J^T J) v, matrix-free."""
    out = {t: torch.zeros_like(x) for t, x in v.items()}
    for lb in lg.batches:
        u = None
        for k, t in enumerate(lb.var_types):
            uk = torch.einsum("ndk,nk->nd", lb.A[k], v[t][_rows(lb, k)])
            u = uk if u is None else u + uk
        for k, t in enumerate(lb.var_types):
            contrib = lb.sign * torch.einsum("ndk,nd->nk", lb.A[k], u)
            out[t].index_add_(0, _rows(lb, k), contrib)
    return out


def linearized_decrease(lg: LinearizedGraph, delta: VectorValues) -> torch.Tensor:
    """Cost decrease of the UNdamped linear model for a step, LM's rho
    denominator: 0.5||r||^2 - 0.5||r - J d||^2 = g.d - 0.5 d^T H d."""
    g = gradient(lg)
    Hd = hvp(lg, delta)
    return sum(
        torch.vdot(g[t].reshape(-1), delta[t].reshape(-1))
        - 0.5 * torch.vdot(delta[t].reshape(-1), Hd[t].reshape(-1))
        for t in delta
    )


# --- global offsets ---------------------------------------------------------


def offsets(lg: LinearizedGraph) -> Tuple[Dict[str, int], int]:
    """Global flat offsets per type (variables grouped by type, sorted)."""
    off = {}
    d = 0
    for t in sorted(lg.type_counts.keys()):
        off[t] = d
        d += lg.type_counts[t] * _tdim(t)
    return off, d


def flatten_delta(lg: LinearizedGraph, v: VectorValues) -> torch.Tensor:
    return torch.cat([v[t].reshape(-1) for t in sorted(lg.type_counts.keys())])


def unflatten_delta(lg: LinearizedGraph, x: torch.Tensor) -> VectorValues:
    out = {}
    start = 0
    for t in sorted(lg.type_counts.keys()):
        n, dim = lg.type_counts[t], _tdim(t)
        out[t] = x[start : start + n * dim].reshape(n, dim)
        start += n * dim
    return out


# --- dense exact solve --------------------------------------------------------


def assemble_dense(lg: LinearizedGraph):
    """Accumulate all block outer products into dense (H, g).

    H = J^T J [D, D], g = J^T b [D]: one global scatter-add."""
    off, D = offsets(lg)
    b0 = lg.batches[0].b
    H = torch.zeros((D, D), dtype=b0.dtype, device=b0.device)
    g = torch.zeros((D,), dtype=b0.dtype, device=b0.device)
    for lb in lg.batches:
        gidx = []
        for k, t in enumerate(lb.var_types):
            dk = _tdim(t)
            base = off[t] + _rows(lb, k) * dk
            gidx.append(base[:, None] + torch.arange(dk, device=base.device)[None, :])
        for k in range(len(lb.var_types)):
            g.index_put_(
                (gidx[k],),
                lb.sign * torch.einsum("ndk,nd->nk", lb.A[k], lb.b),
                accumulate=True,
            )
            for l in range(len(lb.var_types)):
                blk = lb.sign * torch.einsum("ndi,ndj->nij", lb.A[k], lb.A[l])
                H.index_put_(
                    (gidx[k][:, :, None], gidx[l][:, None, :]), blk, accumulate=True
                )
    return H, g


def dense_solve(H: torch.Tensor, g: torch.Tensor, lam=0.0, diagonal_damping: bool = False):
    """Solve (H + lam * D) delta = g with D = I or diag(H)."""
    if diagonal_damping:
        damp = torch.diag(torch.diagonal(H))
    else:
        damp = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    L = torch.linalg.cholesky(H + lam * damp)
    return torch.cholesky_solve(g[:, None], L)[:, 0]
