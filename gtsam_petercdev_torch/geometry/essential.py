"""EssentialMatrix, OrientedPlane3 and Line3 manifolds.

Port of gtsam_petercdev_tpu/geometry/essential.py (reference: gtsam/
geometry/EssentialMatrix.{h,cpp}: E = [t]x R, 5 dof, rotation 3 + direction
2; OrientedPlane3.{h,cpp}: unit normal + distance, 3 dof; Line3.{h,cpp}:
rotation + 2 offsets, 4 dof). Every function is batched over leading dims;
the scalar fields (OrientedPlane3.d, Line3.a / b) are [...] tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gtsam_petercdev_torch.device import resolve_device
from gtsam_petercdev_torch.geometry import so3, unit3

# --- EssentialMatrix ---------------------------------------------------------


class EssentialMatrix(NamedTuple):
    R: torch.Tensor  # [..., 3, 3] rotation 1R2
    t: torch.Tensor  # [..., 3] unit translation direction


E_DIM = 5


def essential_from_pose(R, t):
    """From a relative pose; t normalized (EssentialMatrix::FromPose3)."""
    return EssentialMatrix(R, unit3.normalize(t))


def essential_matrix(E: EssentialMatrix):
    """E = [t]x R (EssentialMatrix::matrix)."""
    return so3.hat(E.t) @ E.R


def essential_retract(E: EssentialMatrix, xi):
    """First 3 = rotation tangent, last 2 = direction tangent
    (EssentialMatrix::retract)."""
    return EssentialMatrix(so3.retract(E.R, xi[..., :3]), unit3.retract(E.t, xi[..., 3:]))


def essential_local(a: EssentialMatrix, b: EssentialMatrix):
    return torch.cat([so3.local(a.R, b.R), unit3.local(a.t, b.t)], dim=-1)


def epipolar_error(E: EssentialMatrix, pA, pB):
    """Algebraic epipolar residual pA_h^T E pB_h (EssentialMatrix::error);
    pA, pB [..., 2] normalized (calibrated) image points."""
    ones = torch.ones(pA.shape[:-1] + (1,), dtype=pA.dtype, device=pA.device)
    va = torch.cat([pA, ones], dim=-1)
    vb = torch.cat([pB, ones], dim=-1)
    return torch.einsum("...i,...ij,...j->...", va, essential_matrix(E), vb)


def essential_identity(dtype=torch.float64, device="cuda"):
    return EssentialMatrix(so3.identity(dtype, device), unit3.identity(dtype, device))


# --- OrientedPlane3 ----------------------------------------------------------


class OrientedPlane3(NamedTuple):
    n: torch.Tensor  # [..., 3] unit normal
    d: torch.Tensor  # [...] distance from the origin


P_DIM = 3


def plane_from_coeffs(a, b, c, d):
    """ax + by + cz + d = 0 normalized (OrientedPlane3 ctor); tensors."""
    n = torch.stack([a, b, c], dim=-1)
    norm = torch.linalg.norm(n, dim=-1)
    return OrientedPlane3(n / norm[..., None], d / norm)


def plane_retract(p: OrientedPlane3, xi):
    return OrientedPlane3(unit3.retract(p.n, xi[..., :2]), p.d + xi[..., 2])


def plane_local(a: OrientedPlane3, b: OrientedPlane3):
    return torch.cat([unit3.local(a.n, b.n), (b.d - a.d)[..., None]], dim=-1)


def plane_transform(p: OrientedPlane3, pose_R, pose_t):
    """The plane in the frame of a pose (OrientedPlane3::transform): with
    x = R y + t, n.x + d = (R^T n).y + (d + n.t), so n' = R^T n,
    d' = d + n . t."""
    return OrientedPlane3(so3.unrotate(pose_R, p.n), p.d + torch.sum(p.n * pose_t, dim=-1))


def plane_distance(p: OrientedPlane3, point):
    return torch.sum(p.n * point, dim=-1) + p.d


def plane_identity(dtype=torch.float64, device="cuda"):
    return OrientedPlane3(unit3.identity(dtype, device),
                          torch.zeros((), dtype=dtype, device=resolve_device(device)))


# --- Line3 -------------------------------------------------------------------


class Line3(NamedTuple):
    """A line as a rotation R (direction R e_z) and offsets (a, b) in the
    rotated xy-plane (Line3.h)."""

    R: torch.Tensor  # [..., 3, 3]
    a: torch.Tensor  # [...]
    b: torch.Tensor  # [...]


L_DIM = 4


def line_retract(l: Line3, xi):
    """Tangent (w1, w2, da, db): rotation about x and y only (z is gauge) and
    offset increments (Line3::retract)."""
    w = torch.stack([xi[..., 0], xi[..., 1], torch.zeros_like(xi[..., 0])], dim=-1)
    return Line3(l.R @ so3.expmap(w), l.a + xi[..., 2], l.b + xi[..., 3])


def line_local(x: Line3, y: Line3):
    w = so3.logmap(so3.inverse(x.R) @ y.R)
    return torch.stack([w[..., 0], w[..., 1], y.a - x.a, y.b - x.b], dim=-1)


def line_point(l: Line3, lam):
    """The point R (a, b, lam) on the line at parameter lam."""
    lam = torch.as_tensor(lam, dtype=l.R.dtype, device=l.R.device)
    v = torch.stack(torch.broadcast_tensors(l.a, l.b, lam), dim=-1)
    return so3.rotate(l.R, v)


def line_identity(dtype=torch.float64, device="cuda"):
    dev = resolve_device(device)
    zero = torch.zeros((), dtype=dtype, device=dev)
    return Line3(torch.eye(3, dtype=dtype, device=dev), zero, zero.clone())
