"""sam factors: bearing / range / bearing-range measurements.

Port of gtsam_petercdev_tpu/sam/factors.py (reference: gtsam/sam/
{BearingFactor,RangeFactor,BearingRangeFactor}.h). Plain FactorTypes, their
residuals written over a factor batch, their Jacobians from the graph's
forward-mode pass. The formulas are the JAX package's, singular points
included: a range is sqrt of a sum of squares (its derivative at zero
distance is NaN, as in JAX), and a bearing is wrapped by atan2(sin, cos).
"""

from __future__ import annotations

from functools import lru_cache

import torch

from gtsam_petercdev_torch.geometry import pose3, unit3
from gtsam_petercdev_torch.nonlinear.factor_graph import FactorType


def _wrap(theta):
    return torch.atan2(torch.sin(theta), torch.cos(theta))


def _scalar(params, like):
    """A scalar measurement [...] (or [..., 1]) in the shape of `like`."""
    return params.reshape(like.shape)


@lru_cache(maxsize=None)
def range_factor(pose_type: str = "Pose2", point_type: str = "Point2") -> FactorType:
    """||translation(pose) - point|| - measured (RangeFactor.h)."""

    if pose_type == "Pose2":
        def trans(x):
            return x[..., :2]
    else:
        def trans(x):
            return x.t

    def residual(xs, params):
        x, p = xs
        diff = trans(x) - p
        d = torch.sqrt(torch.sum(diff * diff, dim=-1))
        return (d - _scalar(params, d))[..., None]

    return FactorType(
        name=f"Range{pose_type}{point_type}",
        var_types=(pose_type, point_type),
        resid_dim=1,
        residual=residual,
    )


def _body_frame(x, p):
    """The point in the Pose2's frame, and the offset (dx, dy) in the world."""
    c, s = torch.cos(x[..., 2]), torch.sin(x[..., 2])
    dx, dy = p[..., 0] - x[..., 0], p[..., 1] - x[..., 1]
    return c * dx + s * dy, -s * dx + c * dy, dx, dy


@lru_cache(maxsize=None)
def bearing_factor_2d() -> FactorType:
    """Pose2 -> Point2 bearing (BearingFactor.h, BearingRange2D):
    residual = wrap(atan2 of the point in the body frame - measured)."""

    def residual(xs, params):
        local_x, local_y, _, _ = _body_frame(*xs)
        b = torch.atan2(local_y, local_x)
        return _wrap(b - _scalar(params, b))[..., None]

    return FactorType(
        name="BearingPose2Point2",
        var_types=("Pose2", "Point2"),
        resid_dim=1,
        residual=residual,
    )


@lru_cache(maxsize=None)
def bearing_range_factor_2d() -> FactorType:
    """[bearing; range] stacked (BearingRangeFactor.h); params [..., 2]."""

    def residual(xs, params):
        local_x, local_y, dx, dy = _body_frame(*xs)
        b = _wrap(torch.atan2(local_y, local_x) - params[..., 0])
        r = torch.sqrt(dx * dx + dy * dy) - params[..., 1]
        return torch.stack([b, r], dim=-1)

    return FactorType(
        name="BearingRangePose2Point2",
        var_types=("Pose2", "Point2"),
        resid_dim=2,
        residual=residual,
    )


@lru_cache(maxsize=None)
def bearing_factor_3d() -> FactorType:
    """Pose3 -> Point3 bearing as a Unit3 2D residual (BearingRange3D):
    residual = Unit3::localCoordinates(measured, observed direction)."""

    def residual(xs, params):
        x, p = xs
        return unit3.local(params, unit3.normalize(pose3.transform_to(x, p)))

    return FactorType(
        name="BearingPose3Point3",
        var_types=("Pose3", "Point3"),
        resid_dim=2,
        residual=residual,
    )
