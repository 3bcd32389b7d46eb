"""Bayes-tree marginal covariances: a top-down sweep batched by depth and
shape class.

Port of gtsam_petercdev_tpu/inference/treemarg.py. Reference:
gtsam/inference/BayesTreeCliqueBase.h:172-203 (cached shortcut marginals)
and nonlinear/Marginals.h:37-128. Instead of a recursive shortcut per
query, ONE top-down sweep computes the joint covariance of every clique's
(frontal + separator) scope, one batched step per (depth, shape class), as
the elimination sweeps the tree bottom-up; every per-variable marginal is
then a read.

With the clique's cached partial Cholesky L = chol(H_FF), W = L^-1 H_FS and
the parent's Sigma_SS (the separator's joint covariance, known because
parents are swept first):

    X        = L^-T W                  (= H_FF^-1 H_FS)
    Sigma_FF = L^-T L^-1 + X Sigma_SS X^T
    Sigma_FS = -X Sigma_SS

The joints live in one flat store G [n_blocks + 1, d, d] of d x d blocks,
each clique's (nf + ns)^2 blocks from its own base, so a child gathers its
Sigma_SS from a parent of any shape class with one index_select. The last
block is a zero block: the padded separator slots of a clique's class
gather it. Buckets keep their real clique counts (the engine's pools have
no trash row) and every scatter destination is a clique's own block, so
the writes are plain index_copy_. Plain PyTorch on the engine's device, as
the JAX package's sweep is plain jnp.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gtsam_petercdev_torch.inference import kernels
from gtsam_petercdev_torch.inference.incremental import IncrementalEngine


def _marg_level(G, L, Linv, W, gather, scatter, nf: int, ns: int, d: int) -> None:
    """One (depth, class) bucket of B cliques: gather each parent's
    Sigma_SS from G, propagate, write the clique's joint into G."""
    B = L.shape[0]
    mb = nf + ns
    Lfi = kernels.tri_lower_inv(L, Linv, nf, d)  # [B, fd, fd]
    Ainv = torch.einsum("bkf,bkg->bfg", Lfi, Lfi)
    if ns > 0:
        Sss = (G.index_select(0, gather.reshape(-1)).reshape(B, ns, ns, d, d)
               .transpose(2, 3).reshape(B, ns * d, ns * d))
        X = torch.einsum("bkf,bks->bfs", Lfi, W)  # [B, fd, sd]
        XS = torch.bmm(X, Sss)
        Sfs = -XS
        J = torch.cat([torch.cat([Ainv + torch.einsum("bft,bgt->bfg", XS, X), Sfs], dim=2),
                       torch.cat([Sfs.transpose(1, 2), Sss], dim=2)], dim=1)
    else:
        J = Ainv
    G.index_copy_(0, scatter.reshape(-1),
                  J.reshape(B, mb, d, mb, d).transpose(2, 3).reshape(B * mb * mb, d, d))


class TreeMarginals:
    """Every variable's marginal covariance over an IncrementalEngine's
    tree, on the engine's device. `n_steps` counts the batched steps of
    the sweep (one per (depth, class) bucket)."""

    def __init__(self, engine: IncrementalEngine):
        self.engine = engine
        d = engine.d
        live = [c for c in engine.cliques if c is not None and c.alive]
        depth: Dict[int, int] = {}
        for c in live:  # depth along parent chains, roots 0
            chain, cid = [], c.cid
            while cid >= 0 and cid not in depth:
                chain.append(cid)
                cid = engine.cliques[cid].parent
            base = depth[cid] + 1 if cid >= 0 else 0
            for i, x in enumerate(reversed(chain)):
                depth[x] = base + i

        self._base: Dict[int, int] = {}
        off = 0
        for c in live:
            self._base[c.cid] = off
            off += (c.cls[0] + c.cls[1]) ** 2
        zero = off  # the zero block padded separator slots gather
        G = torch.zeros((off + 1, d, d), dtype=engine.dtype, device=engine.device)

        by_dc: Dict[Tuple[int, Tuple[int, int]], List] = {}
        for c in live:
            by_dc.setdefault((depth[c.cid], c.cls), []).append(c)
        self.n_steps = 0
        for (_, (nf, ns)), group in sorted(by_dc.items(), key=lambda kv: kv[0]):
            mb = nf + ns
            B = len(group)
            # one upload: pool rows [B], gather [B, ns, ns], scatter [B, mb, mb]
            idx = np.full(B * (1 + ns * ns + mb * mb), zero, dtype=np.int64)
            rows = idx[:B]
            gather = idx[B : B + B * ns * ns].reshape(B, ns, ns)
            scatter = idx[B + B * ns * ns :].reshape(B, mb, mb)
            ar = np.arange(mb)
            for i, c in enumerate(group):
                rows[i] = c.row
                scatter[i] = self._base[c.cid] + ar[:, None] * mb + ar[None, :]
                if c.parent >= 0 and c.separator:
                    p = engine.cliques[c.parent]
                    ppos = np.asarray(_positions(p, c.separator), dtype=np.int64)
                    nr, mb_p = len(ppos), p.cls[0] + p.cls[1]
                    gather[i, :nr, :nr] = (self._base[p.cid] + ppos[:, None] * mb_p
                                           + ppos[None, :])
            dev = engine._upload(idx)
            L, Linv, W = engine.clique_factors((nf, ns), group, dev[:B])
            _marg_level(G, L, Linv, W, dev[B : B + B * ns * ns], dev[B + B * ns * ns :],
                        nf, ns, d)
            self.n_steps += 1
        self._G = G

    def covariance_gid(self, gid: int) -> torch.Tensor:
        """[d, d] tangent-space marginal covariance of one variable (padded
        dims included; callers slice to the manifold dim)."""
        c = self.engine.cliques[self.engine.var_clique[gid]]
        pos = c.frontal.index(gid)
        return self._G[self._base[c.cid] + pos * (c.cls[0] + c.cls[1]) + pos]

    def joint_gids(self, gids: List[int]) -> Optional[torch.Tensor]:
        """Joint covariance [k d, k d] where all gids share the scope of the
        first one's clique, else None (cross-clique joints: the dense path)."""
        eng = self.engine
        cid = eng.var_clique.get(gids[0])
        if cid is None:
            return None
        c = eng.cliques[cid]
        pos = _positions(c, gids)
        if pos is None:
            return None
        mb = c.cls[0] + c.cls[1]
        pos = np.asarray(pos, dtype=np.int64)
        idx = self._base[cid] + pos[:, None] * mb + pos[None, :]
        k, d = len(gids), eng.d
        blocks = self._G.index_select(0, eng._upload(idx.reshape(-1))).reshape(k, k, d, d)
        return blocks.transpose(1, 2).reshape(k * d, k * d)


def _positions(c, gids) -> Optional[List[int]]:
    """Block positions of gids in clique c's scope (frontal, then the
    separator from slot nf of its class), None if one is not in it."""
    fpos = {v: j for j, v in enumerate(c.frontal)}
    spos = {v: c.cls[0] + j for j, v in enumerate(c.separator)}
    out = []
    for g in gids:
        p = fpos.get(g, spos.get(g))
        if p is None:
            return None
        out.append(p)
    return out
