"""Marginal covariances (reference: gtsam/nonlinear/Marginals.h:37-128).

Port of gtsam_petercdev_tpu/nonlinear/marginals.py. method="dense"
factorizes the dense Hessian H = J^T J once (one Cholesky on the device)
and answers each query Sigma_kk = (H^-1)_kk by a solve on the key's
columns; method="tree" builds a Bayes tree through ISAM2 and reads the
top-down covariance sweep (inference/treemarg.py), the reference's
clique-shortcut scheme, right for large sparse graphs.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from gtsam_petercdev_torch.core import manifold
from gtsam_petercdev_torch.device import DeviceLike
from gtsam_petercdev_torch.linear import solve as linsolve
from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph
from gtsam_petercdev_torch.nonlinear.optimizers import _check_device
from gtsam_petercdev_torch.nonlinear.values import Values


class Marginals:
    """Marginals of `graph` linearized at `values`, on `device` (default
    "cuda"; graph and values must live there)."""

    def __init__(self, graph: NonlinearFactorGraph, values: Values, method: str = "dense",
                 *, device: DeviceLike = "cuda"):
        _check_device(graph, values, device)
        graph._materialize()
        values._materialize()
        self._values = values
        self._tree = None
        if method == "tree":
            from gtsam_petercdev_torch.nonlinear.isam2 import ISAM2, ISAM2Params

            self._tree = ISAM2(ISAM2Params(enable_relinearization=False, wildfire_threshold=0.0,
                                           device=graph.device, dtype=graph.dtype))
            self._tree.update(graph, values)
            return
        if method != "dense":
            raise ValueError(f"unknown method {method!r}")
        lg = graph.linearize(values)
        self._off, self._D = linsolve.offsets(lg)
        H, _ = linsolve.assemble_dense(lg)
        # a tiny jitter guards rank-deficient gauge directions, as
        # choleskyCareful's underconstrained handling (base/cholesky.cpp:30-73)
        self._L = torch.linalg.cholesky(
            H + 1e-10 * torch.eye(self._D, dtype=H.dtype, device=H.device))

    def _slice(self, key: int):
        t = self._values.type_of(key)
        d = manifold.get(t).dim
        return self._off[t] + self._values.row_of(key) * d, d

    def _index(self, keys: Sequence[int]) -> torch.Tensor:
        return torch.as_tensor(np.concatenate([np.arange(s, s + d) for s, d in map(self._slice, keys)]),
                               device=self._L.device)

    def _inv_columns(self, idx: torch.Tensor) -> torch.Tensor:
        """Columns idx of H^-1: solve H X = E_idx."""
        E = torch.zeros((self._D, idx.shape[0]), dtype=self._L.dtype, device=self._L.device)
        E[idx, torch.arange(idx.shape[0], device=idx.device)] = 1.0
        return torch.cholesky_solve(E, self._L)

    def marginal_covariance(self, key: int) -> torch.Tensor:
        """Sigma_kk in the tangent space at the linearization point."""
        if self._tree is not None:
            return self._tree.marginal_covariance(key)
        return self.joint_marginal_covariance([key])

    def marginal_information(self, key: int) -> torch.Tensor:
        return torch.linalg.inv(self.marginal_covariance(key))

    def joint_marginal_covariance(self, keys: Sequence[int]) -> torch.Tensor:
        """Joint covariance over the concatenated tangents of `keys`
        (reference JointMarginal, Marginals.h:96). Dense only: under
        method="tree", ISAM2.joint_marginal_covariance answers keys that
        share a clique."""
        idx = self._index(keys)
        return self._inv_columns(idx)[idx, :]

    def joint_marginal_information(self, keys: Sequence[int]) -> torch.Tensor:
        return torch.linalg.inv(self.joint_marginal_covariance(keys))

    def batch_marginal_covariances(self, keys: Sequence[int]) -> List[torch.Tensor]:
        """All requested marginals from ONE batched solve."""
        if self._tree is not None:
            return [self._tree.marginal_covariance(k) for k in keys]
        slices = [self._slice(k) for k in keys]
        X = self._inv_columns(self._index(keys))
        out, col = [], 0
        for s, d in slices:
            out.append(X[s : s + d, col : col + d])
            col += d
        return out
