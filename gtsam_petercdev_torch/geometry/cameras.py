"""Camera models: projection with masked cheirality status.

Port of gtsam_petercdev_tpu/geometry/cameras.py. Reference:
gtsam/geometry/{CalibratedCamera,PinholeCamera,PinholePose}.h. Exceptions
(CheiralityException) become status masks: every projection returns the
depth beside the image point and the caller masks depth <= 0.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gtsam_petercdev_torch.geometry import cal3, pose3
from gtsam_petercdev_torch.geometry.pose3 import Pose3

CHEIRALITY_EPS = 1e-8


def _safe_depth(z):
    return torch.where(z.abs() < CHEIRALITY_EPS, torch.full_like(z, CHEIRALITY_EPS), z)


def project_to_normalized(pose: Pose3, point) -> Tuple[torch.Tensor, torch.Tensor]:
    """World point -> normalized image coords (x/z, y/z) in the camera frame.

    Returns (p_n [...,2], depth [...]). Caller masks depth <= 0 (cheirality).
    Reference: CalibratedCamera::Project (geometry/CalibratedCamera.h).
    """
    q = pose3.transform_to(pose, point)
    z = q[..., 2]
    return q[..., :2] / _safe_depth(z)[..., None], z


def project_bundler(pose: Pose3, point, cal) -> Tuple[torch.Tensor, torch.Tensor]:
    """PinholeCamera<Cal3Bundler>::project2. Returns (uv, depth)."""
    pn, z = project_to_normalized(pose, point)
    return cal3.cal3_bundler_uncalibrate(cal, pn), z


def project_s2(pose: Pose3, point, cal) -> Tuple[torch.Tensor, torch.Tensor]:
    """PinholeCamera<Cal3_S2>::project2."""
    pn, z = project_to_normalized(pose, point)
    return cal3.cal3_s2_uncalibrate(cal, pn), z


def backproject_s2(pose: Pose3, cal, uv, depth):
    """Pixel + depth -> world point (PinholeCamera::backproject)."""
    pn = cal3.cal3_s2_calibrate(cal, uv)
    pc = torch.cat([pn * depth[..., None], depth[..., None]], dim=-1)
    return pose3.transform_from(pose, pc)


def stereo_project(pose: Pose3, point, K):
    """StereoCamera::project (geometry/StereoCamera.h). K = [fx fy s u0 v0 b].

    Returns (uL, uR, v) stereo measurement and depth.
    """
    q = pose3.transform_to(pose, point)
    z = q[..., 2]
    zs = _safe_depth(z)
    fx, fy, u0, v0, b = K[..., 0], K[..., 1], K[..., 3], K[..., 4], K[..., 5]
    uL = u0 + fx * q[..., 0] / zs
    uR = u0 + fx * (q[..., 0] - b) / zs
    v = v0 + fy * q[..., 1] / zs
    return torch.stack([uL, uR, v], dim=-1), z
