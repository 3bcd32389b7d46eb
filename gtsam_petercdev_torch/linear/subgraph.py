"""Spanning-tree subgraph preconditioning.

Port of gtsam_petercdev_tpu/linear/subgraph.py, the analog of the
reference's subgraph preconditioned conjugate gradient stack:
`SubgraphBuilder` (gtsam/linear/SubgraphBuilder.h:109-170) selects a
spanning tree / subgraph of the factor graph, `SubgraphPreconditioner`
(gtsam/linear/SubgraphPreconditioner.h) solves the tree part exactly, and
`SubgraphSolver` (gtsam/linear/SubgraphSolver.h:88) runs PCG on the full
system with that preconditioner.

The tree subsystem is factored ONCE per solve through the same supernodal
multifrontal engine as the full solver (`elimination.multifrontal_factor`:
its buckets go to K4 / K3 / K1 on the card), and each PCG step applies it
(`multifrontal_apply`: the forward solve, then K2, a level at a time). The
tree is ordered by nested dissection: AMD orders a tree without fill but
with a level per step of its depth (165 levels against nested dissection's
20 on the 2,500-pose sphere's tree at its chordal estimate), and an
apply's launches grow with the levels. The spanning tree comes from Kruskal over the binary-factor
skeleton (gtsam/base/kruskal.h) on a DSF union-find, its edges ranked on
the host by a stable sort of -sum(b^2).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from gtsam_petercdev_torch.core import manifold
from gtsam_petercdev_torch.inference import elimination, symbolic
from gtsam_petercdev_torch.linear import solve as linsolve
from gtsam_petercdev_torch.nonlinear.factor_graph import LinearizedGraph
from gtsam_petercdev_torch.utils.dsf import DSFVector


def kruskal_max_spanning_tree(
    n: int, u: np.ndarray, v: np.ndarray, weights: Optional[np.ndarray] = None
) -> np.ndarray:
    """Indices of edges forming a maximum-weight spanning forest.

    The analog of gtsam/base/kruskal.h (utils::kruskal): sort edges by
    descending weight (stable), greedily add those joining distinct
    components."""
    u = np.asarray(u, dtype=np.int64).ravel()
    v = np.asarray(v, dtype=np.int64).ravel()
    if weights is None:
        order = np.arange(u.shape[0])
    else:
        order = np.argsort(-np.asarray(weights), kind="stable")
    dsf = DSFVector(n)
    picked = []
    for e in order.tolist():
        if dsf.union(int(u[e]), int(v[e])):
            picked.append(e)
            if len(picked) == n - 1:
                break
    return np.asarray(picked, dtype=np.int64)


@dataclass
class SubgraphBuilderParams:
    """Mirrors SubgraphBuilderParameters (SubgraphBuilder.h:65-107): the
    skeleton is the Kruskal spanning tree; `augmentation_factor` adds that
    fraction of the strongest off-tree edges back into the subgraph."""

    augmentation_factor: float = 0.0


def build_subgraph(
    lg: LinearizedGraph, params: SubgraphBuilderParams = SubgraphBuilderParams()
) -> List[np.ndarray]:
    """Per linear batch, boolean mask of factors kept in the subgraph.

    Unary factors are always kept (they anchor the tree system); binary
    factors are kept iff on the spanning tree (+ augmentation)."""
    t = _single_type(lg)
    n = lg.type_counts[t]
    if any(lb.sign != 1.0 for lb in lg.batches):
        raise NotImplementedError(
            "subgraph preconditioner does not support sign=-1 (AntiFactor) "
            "batches; use the dense or multifrontal solver"
        )
    masks = [np.full(lb.rows[0].shape[0], len(lb.var_types) == 1) for lb in lg.batches]
    binary = [bi for bi, lb in enumerate(lg.batches) if len(lb.var_types) == 2]
    if binary:
        # every edge's strength proxy sum(b^2), computed once, one copy to the host
        ww = torch.cat([torch.sum(lg.batches[bi].b ** 2, dim=-1) for bi in binary]).cpu().numpy()
        bsel = np.concatenate([np.full(lg.batches[bi].rows[0].shape[0], bi) for bi in binary])
        rsel = np.concatenate([np.arange(lg.batches[bi].rows[0].shape[0]) for bi in binary])
        uu = np.concatenate([np.asarray(lg.batches[bi].rows[0]) for bi in binary])
        vv = np.concatenate([np.asarray(lg.batches[bi].rows[1]) for bi in binary])
        tree = kruskal_max_spanning_tree(n, uu, vv, ww)
        if params.augmentation_factor > 0:
            off = np.setdiff1d(np.arange(len(ww)), tree)
            off = off[np.argsort(-ww[off], kind="stable")]
            extra = int(params.augmentation_factor * len(tree))
            tree = np.concatenate([tree, off[:extra]])
        for bi in binary:
            sel = tree[bsel[tree] == bi]
            masks[bi][rsel[sel]] = True
    return masks


def _single_type(lg: LinearizedGraph) -> str:
    types = sorted(lg.type_counts.keys())
    if len(types) != 1:
        raise NotImplementedError("subgraph preconditioner: one variable type")
    return types[0]


def _masked_subgraph_arrays(lg: LinearizedGraph, masks) -> Tuple[list, list]:
    """Compact (rows, (A, b)) per batch keeping only masked factors."""
    struct, Ab = [], []
    for lb, m in zip(lg.batches, masks):
        idx = np.flatnonzero(m)
        if idx.size == 0:
            continue
        rows = tuple(np.asarray(r)[idx] for r in lb.rows)
        struct.append((rows, lb.var_types[0]))
        idx_d = torch.as_tensor(idx, device=lb.b.device)
        Ab.append((tuple(a[idx_d] for a in lb.A), lb.b[idx_d]))
    return struct, Ab


class SubgraphSolver:
    """PCG on the full linearized system, preconditioned by an exact solve of
    the spanning-tree subsystem (SubgraphSolver.h:88); on the linearized
    graph's device.

    Usage: sol = SubgraphSolver(lg); x = sol.solve(lam) -> VectorValues."""

    def __init__(
        self,
        lg: LinearizedGraph,
        params: SubgraphBuilderParams = SubgraphBuilderParams(),
    ):
        self.lg = lg
        self.t = _single_type(lg)
        self.d = manifold.get(self.t).dim
        n = lg.type_counts[self.t]
        self.masks = build_subgraph(lg, params)
        struct, self.tree_Ab = _masked_subgraph_arrays(lg, self.masks)
        bstruct = [
            elimination.BatchStructure(
                (self.d,) * len(rows), tuple(np.asarray(r, np.int64) for r in rows), 1.0
            )
            for rows, _ in struct
        ]
        edges = [np.stack(rows, axis=1) for rows, _ in struct if len(rows) == 2]
        ordering = (symbolic.nested_dissection_ordering(n, np.concatenate(edges))
                    if edges else None)
        plan = elimination.build_plan_for_graph(bstruct, n, self.d, ordering=ordering)
        self.maps = elimination.build_numeric_maps(plan, bstruct)

    def factor(self, lam=0.0):
        """The tree system's factor (J_T^T J_T + lam I), kept per bucket."""
        return elimination.multifrontal_factor(self.maps, self.tree_Ab, lam)

    def solve(self, lam=0.0, tol: float = 1e-8, max_iters: int = 500):
        chol = self.factor(lam)
        t = self.t

        def Minv(r):
            return {t: elimination.multifrontal_apply(self.maps, chol, r[t])}

        g = linsolve.gradient(self.lg)

        def A(v):
            base = linsolve.hvp(self.lg, v)
            return {t: base[t] + lam * v[t]}

        return linsolve.pcg(A, g, Minv, tol=tol, max_iters=max_iters)
