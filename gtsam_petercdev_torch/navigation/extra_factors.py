"""Attitude / magnetometer / barometric / constant-velocity factors.

Port of gtsam_petercdev_tpu/navigation/extra_factors.py. Reference semantics:
  Rot3AttitudeFactor / Pose3AttitudeFactor (navigation/AttitudeFactor.h):
    2D error of the measured nav-frame direction vs the body reference
    rotated into nav: e = Unit3::error(nZ, nRb * bRef).
  MagFactor / MagPoseFactor (navigation/MagFactor.h, MagPoseFactor.h):
    measured body-frame field = scale * bRn * direction + bias.
  BarometricFactor (navigation/BarometricFactor.h): altitude measurement
    z(pose) + bias - h, with a 1D bias state.
  ConstantVelocityFactor (navigation/ConstantVelocityFactor.h): NavState
    pair constrained by constant-velocity propagation over dt.
Residuals are written over a leading batch of factors; a scalar parameter
(scale, dt) is [N] there and enters as [N, 1].
"""

from __future__ import annotations

from functools import lru_cache

import torch

from gtsam_petercdev_torch.device import as_float
from gtsam_petercdev_torch.geometry import so3, unit3
from gtsam_petercdev_torch.navigation.navstate import NavState, local as nav_local
from gtsam_petercdev_torch.nonlinear.factor_graph import FactorType


@lru_cache(maxsize=None)
def rot3_attitude_factor() -> FactorType:
    """Var Rot3 (nRb); params {'nZ': [3] measured nav direction,
    'bRef': [3] body reference direction}, both unit."""

    def residual(xs, params):
        (nRb,) = xs
        pred = so3.rotate(nRb, unit3.normalize(params["bRef"]))
        return unit3.local(unit3.normalize(params["nZ"]), pred)

    return FactorType(
        name="Rot3AttitudeFactor", var_types=("Rot3",), resid_dim=2,
        residual=residual,
    )


@lru_cache(maxsize=None)
def pose3_attitude_factor() -> FactorType:
    def residual(xs, params):
        (pose,) = xs
        pred = so3.rotate(pose.R, unit3.normalize(params["bRef"]))
        return unit3.local(unit3.normalize(params["nZ"]), pred)

    return FactorType(
        name="Pose3AttitudeFactor", var_types=("Pose3",), resid_dim=2,
        residual=residual,
    )


def _mag_prediction(R, params):
    scale = as_float(params["scale"], R)[..., None]
    return scale * so3.unrotate(R, unit3.normalize(params["direction"])) + params["bias"]


@lru_cache(maxsize=None)
def mag_factor() -> FactorType:
    """Var Rot3 (nRb); params {'measured': [3] body-frame field,
    'scale': [], 'direction': [3] nav-frame unit field, 'bias': [3]}.
    r = scale * bRn @ direction + bias - measured (MagFactor1)."""

    def residual(xs, params):
        (nRb,) = xs
        return _mag_prediction(nRb, params) - params["measured"]

    return FactorType(
        name="MagFactor", var_types=("Rot3",), resid_dim=3, residual=residual
    )


@lru_cache(maxsize=None)
def mag_pose_factor() -> FactorType:
    """Same measurement model on the rotation of a Pose3 (MagPoseFactor<Pose3>)."""

    def residual(xs, params):
        (pose,) = xs
        return _mag_prediction(pose.R, params) - params["measured"]

    return FactorType(
        name="MagPoseFactor", var_types=("Pose3",), resid_dim=3, residual=residual
    )


@lru_cache(maxsize=None)
def mag_factor_calibration() -> FactorType:
    """Unknown scale+bias, known attitude (MagFactor2/3 family): vars
    (Vector1 scale, Vector3 bias); params {'measured', 'nRb': Rot3 matrix,
    'direction'}."""

    def residual(xs, params):
        scale, bias = xs
        pred = scale[..., 0:1] * so3.unrotate(
            params["nRb"], unit3.normalize(params["direction"])
        ) + bias
        return pred - params["measured"]

    return FactorType(
        name="MagFactorCalib", var_types=("Vector1", "Vector3"), resid_dim=3,
        residual=residual,
    )


@lru_cache(maxsize=None)
def barometric_factor() -> FactorType:
    """Vars (Pose3, Vector1 bias); params = measured altitude [1].
    r = z(pose) + bias - h (navigation/BarometricFactor.h)."""

    def residual(xs, params):
        pose, bias = xs
        return pose.t[..., 2:3] + bias[..., 0:1] - params[..., 0:1]

    return FactorType(
        name="BarometricFactor", var_types=("Pose3", "Vector1"), resid_dim=1,
        residual=residual,
    )


@lru_cache(maxsize=None)
def constant_velocity_factor() -> FactorType:
    """Vars (NavState_i, NavState_j); params = {'dt': []}.
    r = Local(predict(x1, dt), x2), predict = constant nav-frame velocity
    (navigation/ConstantVelocityFactor.h)."""

    def residual(xs, params):
        x1, x2 = xs
        dt = as_float(params["dt"], x1.t)[..., None]
        pred = NavState(x1.R, x1.t + x1.v * dt, x1.v)
        return nav_local(pred, x2)

    return FactorType(
        name="ConstantVelocityFactor", var_types=("NavState", "NavState"),
        resid_dim=9, residual=residual,
    )
