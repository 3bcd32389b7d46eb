"""Fixed-lag smoothing with true marginalization.

Port of gtsam_petercdev_tpu/nonlinear/fixed_lag.py. Reference:
gtsam/nonlinear/BatchFixedLagSmoother.{h,cpp}:37 — keep a sliding window:
each update adds factors and values, runs LM, then marginalizes every
variable whose timestamp fell out of the lag. Marginalization follows
BatchFixedLagSmoother::marginalize: linearize the factors touching the
dropped keys, Schur-complement the dropped blocks out of that sub-system,
and re-insert the result as a linear factor on the boundary keys anchored
at the current linearization point (LinearContainerFactor.h).

The Schur complement is one dense solve over the small dropped + boundary
sub-problem; the marginal enters the graph as a regular FactorType whose
residual is sqrtH * local(x0, x) - rhs, so batched linearization and every
solver apply unchanged. IncrementalFixedLagSmoother does the same on the
Bayes-tree engine through ISAM2.marginalize_leaves.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gtsam_petercdev_torch.core import manifold
from gtsam_petercdev_torch.core.tree import tree_map
from gtsam_petercdev_torch.device import DeviceLike, check_graph_values
from gtsam_petercdev_torch.linear import solve as linsolve
from gtsam_petercdev_torch.nonlinear import optimizers
from gtsam_petercdev_torch.nonlinear.factor_graph import FactorType, NonlinearFactorGraph
from gtsam_petercdev_torch.nonlinear.isam2 import ISAM2, ISAM2Params
from gtsam_petercdev_torch.nonlinear.values import Values


@lru_cache(maxsize=None)
def linear_container_factor(var_types: Tuple[str, ...], total_dim: int) -> FactorType:
    """A Gaussian factor frozen in the tangent space at anchor values x0
    (LinearContainerFactor.h): residual = sqrtH @ concat(local(x0_k, x_k)) -
    rhs. params = (x0s tuple, sqrtH [D, D], rhs [D]), batched over a leading
    axis. One FactorType object per (var_types, total_dim)."""
    locals_ = [manifold.get(t).local for t in var_types]

    def residual(xs, params):
        x0s, sqrtH, rhs = params
        dx = torch.cat([loc(x0, x) for loc, x0, x in zip(locals_, x0s, xs)], dim=-1)
        return (sqrtH @ dx[..., None])[..., 0] - rhs

    return FactorType(
        name=f"LinearContainer[{','.join(var_types)}]{total_dim}",
        var_types=tuple(var_types),
        resid_dim=total_dim,
        residual=residual,
    )


def _add_rows(graph: NonlinearFactorGraph, b, rows: np.ndarray) -> None:
    """Add the rows `rows` (host indices) of factor batch b to graph."""
    idx = torch.as_tensor(rows, device=b.sqrt_info.device)
    graph.add_batch(b.ftype, b.keys[rows], tree_map(lambda a: a[idx], b.params),
                    b.sqrt_info[idx], b.robust, b.sign,
                    constrained_mask=None if b.constrained_mask is None else b.constrained_mask[rows])


def marginalize_keys(
    graph: NonlinearFactorGraph,
    values: Values,
    drop_keys: Sequence[int],
    *,
    device: DeviceLike = "cuda",
) -> Tuple[NonlinearFactorGraph, Values]:
    """(new_graph, new_values) with `drop_keys` marginalized out, on
    `device` (graph and values must live there).

    As BatchFixedLagSmoother::marginalize: only factors touching a dropped
    key are removed; their information is Schur-complemented onto the
    boundary keys and re-added as one linear container factor."""
    check_graph_values(graph, values, device)
    graph._materialize()
    values._materialize()
    drop = set(int(k) for k in drop_keys)
    dev, dt = graph.device, graph.dtype

    keep_graph = NonlinearFactorGraph(device=dev, dtype=dt)
    removed: List[Tuple] = []  # (batch, rows)
    for b in graph.batches:
        touches = np.array([any(int(k) in drop for k in row) for row in b.keys], dtype=bool)
        if not touches.any():
            keep_graph.batches.append(b)
            continue
        if (~touches).any():
            _add_rows(keep_graph, b, np.where(~touches)[0])
        removed.append((b, np.where(touches)[0]))

    # boundary keys: the kept keys of removed factors, in order of appearance
    boundary: List[int] = []
    seen = set(drop)
    for b, rows in removed:
        for r in rows:
            for k in b.keys[r]:
                k = int(k)
                if k not in seen:
                    seen.add(k)
                    boundary.append(k)

    # the removed sub-graph over (dropped + boundary), linearized
    sub = NonlinearFactorGraph(device=dev, dtype=dt)
    for b, rows in removed:
        _add_rows(sub, b, rows)
    sub_values = Values(device=dev, dtype=dt)
    for k in sorted(drop) + boundary:
        sub_values.insert(k, values.type_of(k), values.at(k))
    lg = sub.linearize(sub_values)
    H, g = linsolve.assemble_dense(lg)
    off, _ = linsolve.offsets(lg)

    def span(key):
        d = manifold.get(sub_values.type_of(key)).dim
        s = off[sub_values.type_of(key)] + sub_values.row_of(key) * d
        return np.arange(s, s + d)

    drop_idx = np.concatenate([span(k) for k in sorted(drop)]) if drop else np.zeros(0, int)
    H, g = H.cpu().numpy(), g.cpu().numpy()
    if boundary:
        bnd_idx = np.concatenate([span(k) for k in boundary])
        Hoo = H[np.ix_(drop_idx, drop_idx)] + 1e-9 * np.eye(len(drop_idx))
        Hob = H[np.ix_(drop_idx, bnd_idx)]
        Hoo_inv_Hob = np.linalg.solve(Hoo, Hob)
        H_marg = H[np.ix_(bnd_idx, bnd_idx)] - Hob.T @ Hoo_inv_Hob
        g_marg = g[bnd_idx] - Hoo_inv_Hob.T @ g[drop_idx]
        # square-root form: residual = sqrtH d - rhs, H = sqrtH^T sqrtH,
        # g = sqrtH^T rhs (pinv handles the PSD null space)
        w, V = np.linalg.eigh(0.5 * (H_marg + H_marg.T))
        sqrtH = (V * np.sqrt(np.clip(w, 0.0, None))).T
        rhs = np.linalg.pinv(sqrtH.T) @ g_marg
        Db = len(bnd_idx)
        keep_graph.add(linear_container_factor(tuple(values.type_of(k) for k in boundary), Db),
                       boundary, (tuple(values.at(k) for k in boundary), sqrtH, rhs), np.eye(Db))
    keep_graph._materialize()

    new_values = Values(device=dev, dtype=dt)
    for k in values.keys():
        if int(k) not in drop:
            new_values.insert(k, values.type_of(k), values.at(k))
    return keep_graph, new_values


@dataclass
class FixedLagSmootherResult:
    values: Values
    error: float
    iterations: int
    marginalized: List[int] = field(default_factory=list)


def _expired(timestamps: Dict[int, float], lag: float) -> List[int]:
    """Keys whose timestamp fell more than `lag` behind the latest one."""
    current = max(timestamps.values()) if timestamps else 0.0
    return [k for k, t in timestamps.items() if t < current - lag]


class BatchFixedLagSmoother:
    """Sliding-window smoother (BatchFixedLagSmoother.h:37) on `device`."""

    def __init__(self, lag: float, lm_params: Optional[optimizers.LMParams] = None,
                 *, device: DeviceLike = "cuda"):
        self.lag = float(lag)
        self.lm_params = lm_params or optimizers.LMParams(max_iterations=10)
        self.graph = NonlinearFactorGraph(device=device)
        self.device = self.graph.device
        self.values = Values(device=self.device)
        self.timestamps: Dict[int, float] = {}

    def update(
        self,
        new_factors: Optional[NonlinearFactorGraph] = None,
        new_values: Optional[Values] = None,
        timestamps: Optional[Dict[int, float]] = None,
    ) -> FixedLagSmootherResult:
        if new_values is not None:
            for k in new_values.keys():
                self.values.insert(k, new_values.type_of(k), new_values.at(k))
        if timestamps:
            self.timestamps.update({int(k): float(t) for k, t in timestamps.items()})
        if new_factors is not None:
            new_factors._materialize()
            self.graph.batches.extend(new_factors.batches)

        res = optimizers.levenberg_marquardt(self.graph, self.values, self.lm_params,
                                             device=self.device)
        self.values = res.values
        old = _expired(self.timestamps, self.lag)
        if old:
            self.graph, self.values = marginalize_keys(self.graph, self.values, old,
                                                       device=self.device)
            for k in old:
                self.timestamps.pop(k, None)
        return FixedLagSmootherResult(self.values, res.error, res.iterations, old)

    def calculate_estimate(self) -> Values:
        return self.values


class IncrementalFixedLagSmoother:
    """Fixed-lag smoothing on the incremental Bayes-tree engine
    (gtsam_unstable/nonlinear/IncrementalFixedLagSmoother.{h,cpp}:42): an
    ISAM2 whose out-of-lag variables are marginalized out of the tree each
    update, through ISAM2.marginalize_leaves, instead of a batch re-solve of
    the window. Where a key is not leaf-pure this round (a new loop closure
    straddles the boundary), the keys are retried one by one and the ones
    that still fail are deferred to the next update. The ISAM2 runs on
    `device` (default "cuda"), whatever `isam_params.device` says; with
    `isam_params.engine_backend="numpy"` it is the host engine, which needs
    device="cpu" (any other raises ValueError)."""

    def __init__(self, lag: float, isam_params: Optional[ISAM2Params] = None,
                 *, device: DeviceLike = "cuda"):
        self.lag = float(lag)
        self.isam = ISAM2(dataclasses.replace(isam_params or ISAM2Params(), device=device))
        self.timestamps: Dict[int, float] = {}
        self._deferred: List[int] = []  # keys that were not leaf-pure

    def update(
        self,
        new_factors: Optional[NonlinearFactorGraph] = None,
        new_values: Optional[Values] = None,
        timestamps: Optional[Dict[int, float]] = None,
    ) -> FixedLagSmootherResult:
        if timestamps:
            self.timestamps.update({int(k): float(t) for k, t in timestamps.items()})
        self.isam.update(new_factors, new_values)
        old = sorted(_expired(self.timestamps, self.lag))
        old = self._deferred + [k for k in old if k not in self._deferred]
        marginalized: List[int] = []
        if old:
            try:
                self.isam.marginalize_leaves(old)
                marginalized = old
                self._deferred = []
            except RuntimeError:
                self._deferred = []
                for k in old:
                    try:
                        self.isam.marginalize_leaves([k])
                        marginalized.append(k)
                    except RuntimeError:
                        self._deferred.append(k)
            for k in marginalized:
                self.timestamps.pop(k, None)
        return FixedLagSmootherResult(self.isam.calculate_estimate(), -1.0, 1, marginalized)

    def calculate_estimate(self) -> Values:
        return self.isam.calculate_estimate()
