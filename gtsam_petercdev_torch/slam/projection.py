"""Projection factor families for bundle adjustment and visual SLAM.

Port of gtsam_petercdev_tpu/slam/projection.py. Reference factor semantics:
  GeneralSFMFactor<CAMERA, LANDMARK> (slam/GeneralSFMFactor.h): r =
    camera.project(point) - measured, camera a product manifold (pose+cal).
  GenericProjectionFactor<Pose3, Point3, CAL> (slam/ProjectionFactor.h):
    fixed calibration K (per-factor parameter here).

Cheirality: the reference throws CheiralityException and treats the factor
as zero (ProjectionFactor.h handleCheirality); here depth <= 0 masks the
residual to zero with `torch.where` — the same effect on the normal
equations. Jacobians come from the batched `torch.func.jacfwd` path of
nonlinear/factor_graph.py.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from gtsam_petercdev_torch.geometry import cameras
from gtsam_petercdev_torch.geometry.pose3 import Pose3
from gtsam_petercdev_torch.nonlinear.factor_graph import FactorType
from gtsam_petercdev_torch.sfm import bal  # noqa: F401  (registers SfmCamera)


def _masked(r, depth):
    return torch.where((depth > 0)[..., None], r, torch.zeros_like(r))


@lru_cache(maxsize=None)
def general_sfm_factor() -> FactorType:
    """Vars: (SfmCamera, Point3); params: {'uv': [2]}."""

    def residual(xs, params):
        cam, point = xs
        uv, depth = cameras.project_bundler(Pose3(cam.R, cam.t), point, cam.cal)
        return _masked(uv - params["uv"], depth)

    return FactorType(
        name="GeneralSFMFactor",
        var_types=("SfmCamera", "Point3"),
        resid_dim=2,
        residual=residual,
    )


@lru_cache(maxsize=None)
def projection_factor_s2() -> FactorType:
    """GenericProjectionFactor with fixed Cal3_S2.

    Vars: (Pose3, Point3); params: {'uv': [2], 'K': [5]}.
    """

    def residual(xs, params):
        pose, point = xs
        uv, depth = cameras.project_s2(pose, point, params["K"])
        return _masked(uv - params["uv"], depth)

    return FactorType(
        name="ProjectionFactorCal3_S2",
        var_types=("Pose3", "Point3"),
        resid_dim=2,
        residual=residual,
    )


@lru_cache(maxsize=None)
def projection_factor_bundler_fixed() -> FactorType:
    """Projection with fixed Cal3Bundler; vars (Pose3, Point3)."""

    def residual(xs, params):
        pose, point = xs
        uv, depth = cameras.project_bundler(pose, point, params["K"])
        return _masked(uv - params["uv"], depth)

    return FactorType(
        name="ProjectionFactorCal3Bundler",
        var_types=("Pose3", "Point3"),
        resid_dim=2,
        residual=residual,
    )


@lru_cache(maxsize=None)
def stereo_factor() -> FactorType:
    """GenericStereoFactor (slam/StereoFactor.h): vars (Pose3, Point3);
    params {'uv': [3] (uL,uR,v), 'K': [6] (fx fy s u0 v0 b)}."""

    def residual(xs, params):
        pose, point = xs
        z, depth = cameras.stereo_project(pose, point, params["K"])
        return _masked(z - params["uv"], depth)

    return FactorType(
        name="GenericStereoFactor",
        var_types=("Pose3", "Point3"),
        resid_dim=3,
        residual=residual,
    )
