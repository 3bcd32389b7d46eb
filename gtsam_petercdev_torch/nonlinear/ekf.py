"""Extended Kalman filter over manifolds.

Port of gtsam_petercdev_tpu/nonlinear/ekf.py. Reference:
gtsam/nonlinear/ExtendedKalmanFilter-inl.h — predict / update by one-step
factor-graph elimination on the linearized motion / measurement models.
Here the Jacobians come from `torch.func.jacfwd` of the user's motion and
measurement functions THROUGH the manifold chart (retract), so the filter
works for any registered manifold type (Pose2 / Pose3 / NavState / ...), and
the covariance lives in the tangent space at the current estimate. It runs
on the belief's device.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from gtsam_petercdev_torch.core import manifold
from gtsam_petercdev_torch.device import as_float


class ManifoldBelief(NamedTuple):
    value: Any  # manifold point (tensor layout)
    cov: torch.Tensor  # [d, d] tangent covariance at `value`


def _zero_tangent(belief: ManifoldBelief, d: int) -> torch.Tensor:
    return torch.zeros((d,), dtype=belief.cov.dtype, device=belief.cov.device)


def predict(
    belief: ManifoldBelief,
    type_name: str,
    motion: Callable[[Any], Any],  # x -> x' (on the manifold)
    Q: torch.Tensor,  # [d, d] process noise in the tangent at x'
) -> ManifoldBelief:
    m = manifold.get(type_name)
    x_new = motion(belief.value)

    def chart(xi):
        # tangent at x mapped through motion into the tangent at x_new
        return m.local(x_new, motion(m.retract(belief.value, xi)))

    F = torch.func.jacfwd(chart)(_zero_tangent(belief, m.dim))
    P = F @ belief.cov @ F.T + as_float(Q, belief.cov)
    return ManifoldBelief(x_new, P)


def update(
    belief: ManifoldBelief,
    type_name: str,
    h: Callable[[Any], torch.Tensor],  # measurement model
    z: torch.Tensor,
    R: torch.Tensor,
) -> ManifoldBelief:
    m = manifold.get(type_name)

    def h_chart(xi):
        return h(m.retract(belief.value, xi))

    H = torch.func.jacfwd(h_chart)(_zero_tangent(belief, m.dim))
    R = as_float(R, belief.cov)
    y = as_float(z, belief.cov) - h(belief.value)
    S = H @ belief.cov @ H.T + R
    K = torch.linalg.solve(S.T, (belief.cov @ H.T).T).T
    x_new = m.retract(belief.value, K @ y)
    A = torch.eye(m.dim, dtype=belief.cov.dtype, device=belief.cov.device) - K @ H
    P = A @ belief.cov @ A.T + K @ R @ K.T
    return ManifoldBelief(x_new, P)
