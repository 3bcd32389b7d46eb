"""SE(2): planar rigid transforms.

Representation: flat tensor [..., 3] = (x, y, theta). Tangent xi = (vx, vy,
w), translation first. Two charts, as in the JAX package:
  - retract/local: full exponential map
  - retract_first_order/local_first_order: the default chart
    (Retract(v) = Pose2(v), Local(p) = (x, y, theta)), which the manifold
    registry and the factors use.

Port of gtsam_petercdev_tpu/geometry/pose2.py.
"""

from __future__ import annotations

import torch

from gtsam_petercdev_torch.device import resolve_device

DIM = 3
_EPS2 = 1e-14


def identity(dtype=torch.float64, device="cuda"):
    return torch.zeros(3, dtype=dtype, device=resolve_device(device))


def wrap_angle(theta):
    """Wrap to (-pi, pi]."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))


def make(x, y, theta):
    return torch.stack([x, y, theta], dim=-1)


def rot(p):
    """[...,2,2] rotation matrix of the pose."""
    c, s = torch.cos(p[..., 2]), torch.sin(p[..., 2])
    return torch.stack(
        [torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2
    )


def compose(p1, p2):
    c, s = torch.cos(p1[..., 2]), torch.sin(p1[..., 2])
    x = p1[..., 0] + c * p2[..., 0] - s * p2[..., 1]
    y = p1[..., 1] + s * p2[..., 0] + c * p2[..., 1]
    return make(x, y, wrap_angle(p1[..., 2] + p2[..., 2]))


def inverse(p):
    c, s = torch.cos(p[..., 2]), torch.sin(p[..., 2])
    x = -(c * p[..., 0] + s * p[..., 1])
    y = -(-s * p[..., 0] + c * p[..., 1])
    return make(x, y, -p[..., 2])


def between(p1, p2):
    """p1^{-1} p2."""
    c, s = torch.cos(p1[..., 2]), torch.sin(p1[..., 2])
    dx = p2[..., 0] - p1[..., 0]
    dy = p2[..., 1] - p1[..., 1]
    return make(
        c * dx + s * dy, -s * dx + c * dy, wrap_angle(p2[..., 2] - p1[..., 2])
    )


def _sinc_coeffs(w):
    """(A, B) = (sin w / w, (1 - cos w) / w), Taylor-safe and autodiff-safe."""
    w2 = w * w
    small = w2 < _EPS2
    wg = torch.where(small, torch.ones_like(w), w)
    A_exact = torch.sin(wg) / wg
    B_exact = (1.0 - torch.cos(wg)) / wg
    A = torch.where(small, 1.0 - w2 / 6.0, A_exact)
    B = torch.where(small, w * 0.5 * (1.0 - w2 / 12.0), B_exact)
    return A, B


def expmap(xi):
    """xi [...,3] = (vx, vy, w) -> Pose2 (full SE(2) exp)."""
    vx, vy, w = xi[..., 0], xi[..., 1], xi[..., 2]
    A, B = _sinc_coeffs(w)
    return make(A * vx - B * vy, B * vx + A * vy, wrap_angle(w))


def logmap(p):
    """Pose2 -> xi [...,3]."""
    x, y, w = p[..., 0], p[..., 1], p[..., 2]
    A, B = _sinc_coeffs(w)
    det = A * A + B * B
    det = torch.where(det < 1e-12, torch.ones_like(det), det)
    vx = (A * x + B * y) / det
    vy = (-B * x + A * y) / det
    return make(vx, vy, w)


def retract(p, xi):
    return compose(p, expmap(xi))


def local(p1, p2):
    return logmap(between(p1, p2))


def retract_first_order(p, xi):
    """Default chart: compose(p, Pose2(xi))."""
    return compose(p, xi)


def local_first_order(p1, p2):
    """Default chart: coordinates of between(p1, p2)."""
    return between(p1, p2)


def adjoint_map(p):
    """[[R, J t],[0, 1]] with J = [[0,1],[-1,0]]; Ad for xi=(v,w) order."""
    c, s = torch.cos(p[..., 2]), torch.sin(p[..., 2])
    x, y = p[..., 0], p[..., 1]
    z = torch.zeros_like(c)
    one = torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([c, -s, y], dim=-1),
            torch.stack([s, c, -x], dim=-1),
            torch.stack([z, z, one], dim=-1),
        ],
        dim=-2,
    )


def transform_from(p, point):
    """Pose frame -> world: R q + t. point [...,2]."""
    c, s = torch.cos(p[..., 2]), torch.sin(p[..., 2])
    qx, qy = point[..., 0], point[..., 1]
    return torch.stack(
        [p[..., 0] + c * qx - s * qy, p[..., 1] + s * qx + c * qy], dim=-1
    )


def transform_to(p, point):
    """World -> pose frame: R^T (q - t)."""
    c, s = torch.cos(p[..., 2]), torch.sin(p[..., 2])
    dx = point[..., 0] - p[..., 0]
    dy = point[..., 1] - p[..., 1]
    return torch.stack([c * dx + s * dy, -s * dx + c * dy], dim=-1)


def bearing(p, point):
    """Bearing angle to a world point, in the pose frame (Rot2 as angle)."""
    d = transform_to(p, point)
    return torch.atan2(d[..., 1], d[..., 0])


def range_to(p, point):
    d = transform_to(p, point)
    return torch.linalg.norm(d, dim=-1)
