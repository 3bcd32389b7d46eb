"""NonlinearISAM: the naive incremental wrapper with periodic reordering.

Port of gtsam_petercdev_tpu/nonlinear/nonlinear_isam.py. Reference:
gtsam/nonlinear/NonlinearISAM.{h,cpp}: factors linearized at stored
linearization points, a full relinearization every `reorder_interval`
updates. Between reorderings an update re-solves the linear system with
the linearization points frozen (the reference relinearizes only at
reorder time); the reorder is one Gauss-Newton pass from the current best
estimate.
"""

from __future__ import annotations

from typing import Optional

from gtsam_petercdev_torch.device import DeviceLike
from gtsam_petercdev_torch.linear import solve as linsolve
from gtsam_petercdev_torch.nonlinear import optimizers
from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph
from gtsam_petercdev_torch.nonlinear.values import Values, VectorValues


class NonlinearISAM:
    """On `device` (default "cuda"); graphs and values passed to `update`
    must live there."""

    def __init__(self, reorder_interval: int = 1, *, device: DeviceLike = "cuda"):
        self.reorder_interval = max(1, reorder_interval)
        self.factors = NonlinearFactorGraph(device=device)
        self.device = self.factors.device
        self.linearization_point = Values(device=self.device)
        self._delta: Optional[VectorValues] = None
        self._count = 0

    def update(self, new_factors: NonlinearFactorGraph, new_values: Values):
        new_factors._materialize()
        self.factors.batches.extend(new_factors.batches)
        # the current best estimate of the existing variables, taken while
        # _delta still matches them: the reference relinearizes around
        # linPoint + delta, not the stale linearization point
        # (NonlinearISAM.cpp reorder_relinearize)
        est = self.linearization_point
        if self._delta is not None:
            est = self.linearization_point.retract(self._delta)
        for key in new_values.keys():
            t, v = new_values.type_of(key), new_values.at(key)
            if est is not self.linearization_point:
                est.insert(key, t, v)
            self.linearization_point.insert(key, t, v)
        self._count += 1
        self._delta = None
        if self._count % self.reorder_interval == 0:
            self.reorder_relinearize(est)
        else:  # a linear update at the frozen linearization point
            lg = self.factors.linearize(self.linearization_point)
            H, g = linsolve.assemble_dense(lg)
            self._delta = linsolve.unflatten_delta(lg, linsolve.dense_solve(H, g, 1e-9))

    def reorder_relinearize(self, seed: Optional[Values] = None):
        """Full relinearization: one GN pass that re-centres the
        linearization point, from the current best estimate."""
        res = optimizers.gauss_newton(self.factors, seed if seed is not None else self.estimate(),
                                      optimizers.OptimizerParams(max_iterations=1),
                                      device=self.device)
        self.linearization_point = res.values
        self._delta = None

    def estimate(self) -> Values:
        if self._delta is None:
            return self.linearization_point
        return self.linearization_point.retract(self._delta)
