"""SE(3): rigid transforms.

Representation: a NamedTuple Pose3(R=[...,3,3], t=[...,3]). Tangent
xi = (omega, v), rotation first. Retract is the full exponential map.

Port of gtsam_petercdev_tpu/geometry/pose3.py.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gtsam_petercdev_torch.device import resolve_device
from gtsam_petercdev_torch.geometry import so3


class Pose3(NamedTuple):
    R: torch.Tensor  # [..., 3, 3]
    t: torch.Tensor  # [..., 3]


DIM = 6


def identity(dtype=torch.float64, device="cuda"):
    dev = resolve_device(device)
    return Pose3(
        torch.eye(3, dtype=dtype, device=dev), torch.zeros(3, dtype=dtype, device=dev)
    )


def compose(p1: Pose3, p2: Pose3) -> Pose3:
    return Pose3(p1.R @ p2.R, so3.rotate(p1.R, p2.t) + p1.t)


def inverse(p: Pose3) -> Pose3:
    Rinv = so3.inverse(p.R)
    return Pose3(Rinv, -so3.rotate(Rinv, p.t))


def between(p1: Pose3, p2: Pose3) -> Pose3:
    """p1^{-1} p2."""
    R1inv = so3.inverse(p1.R)
    return Pose3(R1inv @ p2.R, so3.rotate(R1inv, p2.t - p1.t))


def expmap(xi) -> Pose3:
    """xi [...,6] = (omega, v) -> Pose3, t = Jl(omega) v."""
    w, v = xi[..., :3], xi[..., 3:]
    R = so3.expmap(w)
    t = (so3.left_jacobian(w) @ v[..., None])[..., 0]
    return Pose3(R, t)


def logmap(p: Pose3):
    """Pose3 -> xi [...,6] = (omega, v)."""
    w = so3.logmap(p.R)
    v = (so3.left_jacobian_inverse(w) @ p.t[..., None])[..., 0]
    return torch.cat([w, v], dim=-1)


def retract(p: Pose3, xi) -> Pose3:
    return compose(p, expmap(xi))


def local(p1: Pose3, p2: Pose3):
    return logmap(between(p1, p2))


def adjoint_map(p: Pose3):
    """6x6 Adjoint: Ad_T = [[R, 0], [hat(t) R, R]]."""
    zero = torch.zeros_like(p.R)
    top = torch.cat([p.R, zero], dim=-1)
    bot = torch.cat([so3.hat(p.t) @ p.R, p.R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def transform_from(p: Pose3, point):
    """Map a point from the pose frame to world: R p + t."""
    return so3.rotate(p.R, point) + p.t


def transform_to(p: Pose3, point):
    """Map a world point into the pose frame: R^T (p - t)."""
    return so3.unrotate(p.R, point - p.t)


def stack(poses):
    """Stack a python list of Pose3 into one batched Pose3."""
    return Pose3(
        torch.stack([p.R for p in poses], dim=0),
        torch.stack([p.t for p in poses], dim=0),
    )


def index(p: Pose3, i) -> Pose3:
    return Pose3(p.R[i], p.t[i])


def matrix(p: Pose3):
    """Homogeneous 4x4 matrix."""
    batch = p.t.shape[:-1]
    bottom = torch.tensor(
        [0.0, 0.0, 0.0, 1.0], dtype=p.t.dtype, device=p.t.device
    ).expand(*batch, 1, 4)
    top = torch.cat([p.R, p.t[..., None]], dim=-1)
    return torch.cat([top, bottom], dim=-2)
