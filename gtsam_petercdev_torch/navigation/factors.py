"""Navigation factors: ImuFactor, CombinedImuFactor, GPS, velocity priors.

Port of gtsam_petercdev_tpu/navigation/factors.py. Reference semantics:
  ImuFactor (navigation/ImuFactor.h:170): 5-way (Xi, Vi, Xj, Vj, B);
    whitened by the 9x9 preintegration covariance.
  CombinedImuFactor (CombinedImuFactor.h:209): 6-way (Xi, Vi, Xj, Vj, Bi, Bj);
    15-dim error appending the bias random-walk residual b_j - b_i; whitened
    by a 15x15 covariance.
  GPSFactor (navigation/GPSFactor.h): position-only prior on Pose3.

The PIM rides in the factor params as {"pim": PIM, "n_gravity": [3]};
`NonlinearFactorGraph.add` stacks it leafwise, so a batch of N IMU factors
holds PIM fields [N, ...] and linearizes in one forward-mode pass.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from gtsam_petercdev_torch.navigation import preintegration as pre
from gtsam_petercdev_torch.navigation.navstate import NavState  # registers ConstantBias
from gtsam_petercdev_torch.nonlinear.factor_graph import FactorType


def _imu_error(pose_i, vel_i, pose_j, vel_j, bias, params):
    p = pre.PreintegrationParams(
        accel_cov=None, gyro_cov=None, integration_cov=None,
        n_gravity=params["n_gravity"],
    )
    return pre.compute_error(
        params["pim"], p, NavState(pose_i.R, pose_i.t, vel_i),
        NavState(pose_j.R, pose_j.t, vel_j), bias,
    )


@lru_cache(maxsize=None)
def imu_factor() -> FactorType:
    """Vars (Pose3, Vector3, Pose3, Vector3, ConstantBias); params
    {'pim': PIM, 'n_gravity': [3]}."""

    def residual(xs, params):
        pose_i, vel_i, pose_j, vel_j, bias = xs
        return _imu_error(pose_i, vel_i, pose_j, vel_j, bias, params)

    return FactorType(
        name="ImuFactor",
        var_types=("Pose3", "Vector3", "Pose3", "Vector3", "ConstantBias"),
        resid_dim=9,
        residual=residual,
    )


@lru_cache(maxsize=None)
def combined_imu_factor() -> FactorType:
    """Vars (..., ConstantBias_i, ConstantBias_j); 15-dim residual."""

    def residual(xs, params):
        pose_i, vel_i, pose_j, vel_j, bias_i, bias_j = xs
        e_imu = _imu_error(pose_i, vel_i, pose_j, vel_j, bias_i, params)
        return torch.cat([e_imu, bias_j - bias_i], dim=-1)

    return FactorType(
        name="CombinedImuFactor",
        var_types=("Pose3", "Vector3", "Pose3", "Vector3", "ConstantBias", "ConstantBias"),
        resid_dim=15,
        residual=residual,
    )


def combined_covariance(pim: pre.PIM, params: pre.PreintegrationParams):
    """15x15 whitening covariance [..., 15, 15] for CombinedImuFactor:
    preintegration block + bias random walk over deltaT + initial bias
    uncertainty (the JAX package's simplified block-diagonal form of
    CombinedImuFactor.h's propagation)."""
    dT = pim.deltaT[..., None, None]
    Z3 = torch.zeros_like(pim.cov[..., :3, :3])
    walk = torch.cat([
        torch.cat([params.bias_acc_cov * dT, Z3], dim=-1),
        torch.cat([Z3, params.bias_omega_cov * dT], dim=-1),
    ], dim=-2)
    Z96 = torch.zeros_like(pim.cov[..., :, :6])
    return torch.cat([
        torch.cat([pim.cov, Z96], dim=-1),
        torch.cat([Z96.transpose(-1, -2), walk + params.bias_acc_omega_init], dim=-1),
    ], dim=-2)


@lru_cache(maxsize=None)
def gps_factor() -> FactorType:
    """GPSFactor: r = t(pose) - measured (navigation/GPSFactor.h)."""

    def residual(xs, params):
        (pose,) = xs
        return pose.t - params

    return FactorType(
        name="GPSFactor", var_types=("Pose3",), resid_dim=3, residual=residual
    )


@lru_cache(maxsize=None)
def velocity_prior() -> FactorType:
    """r = v - measured. Named "PriorVector3" as in the JAX package, the name
    of slam.factors.prior_factor("Vector3") too, whose residual is the same:
    a graph stages both under one batch."""

    def residual(xs, params):
        (v,) = xs
        return v - params

    return FactorType(
        name="PriorVector3", var_types=("Vector3",), resid_dim=3, residual=residual
    )
