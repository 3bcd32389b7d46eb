"""Linear solvers over a LinearizedGraph.

Port of gtsam_petercdev_tpu/linear/solve.py:
  * `gradient` / `hvp`: matrix-free J^T b and (J^T J) v, one batched
    product per factor batch plus an `index_add_` per slot.
  * `hessian_block_diagonal`: per-variable D x D blocks (hessianDiagonal),
    the block-Jacobi preconditioner.
  * `assemble_dense` / `dense_solve`: the exact dense Cholesky solve — the
    oracle the sparse multifrontal path is checked against.
  * `pcg_solve`: block-Jacobi preconditioned CG (PCGSolver), matrix-free;
    `pcg`: the same iteration with any operator and preconditioner. JAX's
    `lax.while_loop` is a host loop here, its stopping rule unchanged:
    each test of it is one device -> host read (`_cg_continues`).

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


def hessian_block_diagonal(lg: LinearizedGraph) -> Dict[str, torch.Tensor]:
    """Per-variable diagonal blocks of J^T J: {t: [N_t, d, d]}."""
    b0 = lg.batches[0].b
    out = {
        t: torch.zeros((n, _tdim(t), _tdim(t)), dtype=b0.dtype, device=b0.device)
        for t, n in lg.type_counts.items()
    }
    for lb in lg.batches:
        for k, t in enumerate(lb.var_types):
            blk = lb.sign * torch.einsum("ndi,ndj->nij", lb.A[k], lb.A[k])
            out[t].index_add_(0, _rows(lb, k), blk)
    return out


def error(lg: LinearizedGraph, delta: VectorValues) -> torch.Tensor:
    """0.5 || A delta - b ||^2 (linear model cost at delta)."""
    b0 = lg.batches[0].b
    total = torch.zeros((), dtype=b0.dtype, device=b0.device)
    for lb in lg.batches:
        u = -lb.b
        for k, t in enumerate(lb.var_types):
            u = u + torch.einsum("ndk,nk->nd", lb.A[k], delta[t][_rows(lb, k)])
        total = total + lb.sign * 0.5 * torch.sum(u * u)
    return total


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
    """Solve (H + lam * D) delta = g with D = I or diag(H). Where the
    Cholesky factorization fails (not positive definite), delta is NaN, as
    the JAX package's cho_factor leaves it, and the caller's error test
    rejects the step; the check stays on the device (no host read)."""
    if diagonal_damping:
        damp = torch.diag(torch.diagonal(H))
    else:
        damp = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    L, info = torch.linalg.cholesky_ex(H + lam * damp)
    x = torch.cholesky_solve(g[:, None], L)[:, 0]
    return torch.where(info == 0, x, torch.full_like(x, float("nan")))


# --- preconditioned conjugate gradients ---------------------------------------


def _vdot(a: VectorValues, b: VectorValues) -> torch.Tensor:
    return sum(torch.vdot(a[t].reshape(-1), b[t].reshape(-1)) for t in a)


def _cg_continues(it: int, max_iters: int, rr: torch.Tensor, limit: torch.Tensor) -> bool:
    """The CG loop's test: it < max_iters and r.r > limit (one device -> host
    read of the comparison)."""
    return it < max_iters and bool(rr > limit)


def _block_inv(blocks: torch.Tensor, jitter: float = 1e-8) -> torch.Tensor:
    eye = torch.eye(blocks.shape[-1], dtype=blocks.dtype, device=blocks.device)
    return torch.linalg.solve(blocks + jitter * eye, eye.expand(blocks.shape))


def pcg(A, g: VectorValues, Minv, tol: float = 1e-8, max_iters: int = 500) -> VectorValues:
    """Generic preconditioned CG over VectorValues (PCGSolver's iterative
    core with a pluggable Preconditioner): A v -> A v (matrix-free
    operator), g the right-hand side, Minv r -> M^-1 r. From x = 0, JAX's
    stopping rule: iterate while it < max_iters and r.r > tol^2 g.g."""
    x = {t: torch.zeros_like(v) for t, v in g.items()}
    r = g
    z = Minv(r)
    p = z
    rz = _vdot(r, z)
    limit = tol * tol * _vdot(g, g)
    it = 0
    while _cg_continues(it, max_iters, _vdot(r, r), limit):
        Ap = A(p)
        alpha = rz / torch.clamp(_vdot(p, Ap), min=1e-30)
        x = {t: x[t] + alpha * p[t] for t in x}
        r = {t: r[t] - alpha * Ap[t] for t in r}
        z = Minv(r)
        rz_new = _vdot(r, z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = {t: z[t] + beta * p[t] for t in p}
        rz = rz_new
        it += 1
    return x


def pcg_solve(
    lg: LinearizedGraph,
    lam=0.0,
    diagonal_damping: bool = False,
    tol: float = 1e-10,
    max_iters: int = 500,
) -> VectorValues:
    """Block-Jacobi preconditioned CG on (J^T J + lam*D) delta = J^T b,
    matrix-free (PCGSolver with BlockJacobiPreconditioner)."""
    g = gradient(lg)
    blocks = hessian_block_diagonal(lg)
    if diagonal_damping:
        damp = {t: torch.diag_embed(torch.diagonal(b, dim1=-2, dim2=-1)) for t, b in blocks.items()}
    else:
        damp = {
            t: torch.eye(b.shape[-1], dtype=b.dtype, device=b.device).expand(b.shape)
            for t, b in blocks.items()
        }
    Minv = {t: _block_inv(blocks[t] + lam * damp[t]) for t in blocks}

    def A(v):
        base = hvp(lg, v)
        return {t: base[t] + lam * torch.einsum("nij,nj->ni", damp[t], v[t]) for t in base}

    def apply_Minv(r):
        return {t: torch.einsum("nij,nj->ni", Minv[t], r[t]) for t in r}

    return pcg(A, g, apply_Minv, tol, max_iters)
