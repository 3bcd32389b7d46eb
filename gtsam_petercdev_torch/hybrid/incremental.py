"""Incremental hybrid inference with hypothesis pruning.

Port of gtsam_petercdev_tpu/hybrid/incremental.py. Reference:
gtsam/hybrid/HybridSmoother.{h,cpp} (update = add factors, re-eliminate,
prune to maxNrLeaves) and gtsam/hybrid/HybridGaussianISAM.h (the ISAM-style
wrapper over the same machinery).

The LIVE hypothesis set (<= max_leaves pruned assignments) is the batch
axis: each update expands the set with any new discrete keys' cards, runs
ONE batched elimination over all hypotheses (dense up to `dense_dim_limit`
continuous dims, else `hybrid.eliminate_sparse` with the hypotheses folded
into each bucket), renormalizes, and prunes back. The hypothesis set is
host numpy; the systems live on the smoother's device.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from gtsam_petercdev_torch.device import DeviceLike
from gtsam_petercdev_torch.hybrid.hybrid import (
    HybridBayesNet,
    HybridGaussianFactorGraph,
    eliminate_sparse,
)


class HybridSmoother:
    """Incremental hybrid smoother with bounded hypothesis count, on
    `device` (default "cuda"; the slices it takes must live there too)."""

    def __init__(self, max_leaves: int = 8, dense_dim_limit: int = 96, *,
                 device: DeviceLike = "cuda", dtype=None):
        # beyond dense_dim_limit total continuous dims, each hypothesis's
        # solve routes through the sparse multifrontal engine
        self.dense_dim_limit = int(dense_dim_limit)
        self.max_leaves = int(max_leaves)
        self.graph = HybridGaussianFactorGraph(device=device, dtype=dtype)
        self._hyp: Optional[np.ndarray] = None  # [K, n_disc] over sorted keys
        self._dkeys: List[int] = []
        self.bayes_net: Optional[HybridBayesNet] = None

    def update(self, new_graph: HybridGaussianFactorGraph) -> HybridBayesNet:
        """Add the new slice's factors, re-eliminate over the (expanded)
        live hypotheses, prune (HybridSmoother::update)."""
        if new_graph.device != self.graph.device:
            raise ValueError(f"slice is on {new_graph.device}, the smoother on {self.graph.device}")
        self.graph.gaussians.extend(new_graph.gaussians)
        self.graph.discrete.extend(new_graph.discrete)
        self.graph.cont_dims.update(new_graph.cont_dims)
        new_keys = [k for k in new_graph.disc_cards if k not in self.graph.disc_cards]
        self.graph.disc_cards.update(new_graph.disc_cards)

        dkeys = sorted(self.graph.disc_cards.keys())
        if self._hyp is None or not self._dkeys:
            hyp = None  # first update: full grid over whatever exists
        else:
            # expand the kept hypotheses (over self._dkeys) by the new keys'
            # grid: [K, G, n_disc] by broadcasting
            old_pos = {k: i for i, k in enumerate(self._dkeys)}
            new_pos = {k: i for i, k in enumerate(new_keys)}
            grids = [np.arange(self.graph.disc_cards[k], dtype=np.int64) for k in new_keys]
            if grids:
                mesh = np.stack(np.meshgrid(*grids, indexing="ij"), axis=-1).reshape(-1, len(new_keys))
            else:
                mesh = np.zeros((1, 0), dtype=np.int64)
            K, G = self._hyp.shape[0], mesh.shape[0]
            hyp = np.empty((K, G, len(dkeys)), dtype=np.int64)
            for j, k in enumerate(dkeys):
                if k in old_pos:
                    hyp[:, :, j] = self._hyp[:, old_pos[k]][:, None]
                else:
                    hyp[:, :, j] = mesh[:, new_pos[k]][None, :]
            hyp = hyp.reshape(K * G, len(dkeys))

        _, D = self.graph._cont_offsets()
        if D > self.dense_dim_limit:
            bn = eliminate_sparse(self.graph, assignments=hyp)
        else:
            bn = self.graph.eliminate(assignments=hyp)
        bn = bn.prune(self.max_leaves)
        self._hyp = bn.assignments
        self._dkeys = list(dkeys)
        self.bayes_net = bn
        return bn

    def optimize(self):
        return self.bayes_net.optimize()

    def discrete_marginal(self, key: int):
        return self.bayes_net.discrete_marginal(key)


class HybridGaussianISAM(HybridSmoother):
    """ISAM-style alias: same pruned-hypothesis incremental machinery
    (HybridGaussianISAM.h exposes update(newFactors) like ISAM)."""
