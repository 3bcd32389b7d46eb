"""Kalman filtering (reference: gtsam/linear/KalmanFilter.h:40-207).

Port of gtsam_petercdev_tpu/linear/kalman.py. The reference implements
predict / update as factor-graph elimination steps; here they keep the same
API semantics on dense (mean, covariance) state: each step is a handful of
small batched matmuls over leading batch dimensions, so one call advances a
whole bank of filters on the tensors' device. The RTS smoother's `lax.scan`
is a loop over the steps, each step batched over the tracks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gtsam_petercdev_torch.device import as_float


class GaussianState(NamedTuple):
    mean: torch.Tensor  # [..., n]
    cov: torch.Tensor  # [..., n, n]


def _t(x):
    return torch.swapaxes(x, -1, -2)


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _sandwich(A, P):
    """A P A^T."""
    return A @ P @ _t(A)


def init(x0, P0) -> GaussianState:
    x0 = as_float(x0)
    return GaussianState(x0, as_float(P0, x0))


def predict(state: GaussianState, F, B=None, u=None, Q=None) -> GaussianState:
    """x' = F x + B u + w, w ~ N(0, Q) (KalmanFilter::predict)."""
    F = as_float(F, state.mean)
    x = _mv(F, state.mean)
    if B is not None and u is not None:
        x = x + _mv(as_float(B, x), as_float(u, x))
    P = _sandwich(F, state.cov)
    if Q is not None:
        P = P + as_float(Q, P)
    return GaussianState(x, P)


def update(state: GaussianState, H, z, R) -> GaussianState:
    """Measurement z = H x + v, v ~ N(0, R) (KalmanFilter::update).

    Joseph-form covariance update for numerical symmetry."""
    H, z, R = (as_float(a, state.mean) for a in (H, z, R))
    y = z - _mv(H, state.mean)
    S = _sandwich(H, state.cov) + R
    PHt = state.cov @ _t(H)
    K = _t(torch.linalg.solve(_t(S), _t(PHt)))  # [..., n, m]
    x = state.mean + _mv(K, y)
    n = state.mean.shape[-1]
    A = torch.eye(n, dtype=state.cov.dtype, device=state.cov.device) - K @ H
    P = _sandwich(A, state.cov) + _sandwich(K, R)
    return GaussianState(x, P)


def smooth_rts(states_filt: GaussianState, states_pred: GaussianState, F) -> GaussianState:
    """Rauch-Tung-Striebel smoother over T steps, each batched over the
    leading batch dimensions after the step axis.

    states_filt: filtered (x_t|t, P_t|t) stacked [T, ...];
    states_pred: predicted (x_t|t-1, P_t|t-1) stacked [T, ...] (entry 0
    is the prior prediction into step 0); F: [T, ..., n, n], F[t]
    transitions step t-1 -> t (entry 0 unused).

    Recursion (t = T-2..0): C_t = P_t|t F_{t+1}^T P_{t+1|t}^{-1};
    x_t|T = x_t|t + C_t (x_{t+1|T} - x_{t+1|t})."""
    F = as_float(F, states_filt.mean)
    T = states_filt.mean.shape[0]
    xs, Ps = states_filt.mean[-1], states_filt.cov[-1]
    means, covs = [xs], [Ps]
    for t in range(T - 2, -1, -1):
        Pf, F_next = states_filt.cov[t], F[t + 1]
        C = _t(torch.linalg.solve(_t(states_pred.cov[t + 1]), _t(Pf @ _t(F_next))))
        xs = states_filt.mean[t] + _mv(C, xs - states_pred.mean[t + 1])
        Ps = Pf + C @ (Ps - states_pred.cov[t + 1]) @ _t(C)
        means.append(xs)
        covs.append(Ps)
    return GaussianState(torch.stack(means[::-1]), torch.stack(covs[::-1]))
