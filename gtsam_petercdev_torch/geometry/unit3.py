"""Unit3: directions on S^2 with a 2D tangent chart.

Port of gtsam_petercdev_tpu/geometry/unit3.py (reference: gtsam/geometry/
Unit3.{h,cpp}): unit vectors [..., 3] with a deterministic orthonormal basis
B(p) [..., 3, 2] and the sphere exponential retract (Unit3::retract, EXPMAP
mode). Branch-free: the reference's axis selection is an argmin and every
singular point a `torch.where`, so a whole batch goes through one call and
`torch.func.jacfwd` stays finite.
"""

from __future__ import annotations

import torch

from gtsam_petercdev_torch.device import resolve_device

DIM = 2
_EPS = 1e-12


def normalize(p):
    return p / torch.linalg.norm(p, dim=-1, keepdim=True)


def basis(p):
    """Deterministic orthonormal basis B [..., 3, 2] of the tangent plane
    (Unit3::basis: cross with the axis most orthogonal to p). On a tie the
    first smallest |p_k| wins, as jnp.argmin picks it."""
    k = torch.argmin(torch.abs(p), dim=-1)
    e = torch.eye(3, dtype=p.dtype, device=p.device)[k]
    b1 = torch.linalg.cross(p, e, dim=-1)
    b1 = b1 / torch.linalg.norm(b1, dim=-1, keepdim=True)
    b2 = torch.linalg.cross(p, b1, dim=-1)
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True)
    return torch.stack([b1, b2], dim=-1)


def retract(p, xi):
    """Sphere expmap: cos(|xi|) p + sin(|xi|) (B xi)/|xi| (Unit3::retract)."""
    d = torch.einsum("...ij,...j->...i", basis(p), xi)
    th = torch.linalg.norm(xi, dim=-1, keepdim=True)
    th_safe = torch.where(th < _EPS, torch.full_like(th, _EPS), th)
    sinc = torch.sin(th_safe) / th_safe
    out = torch.cos(th) * p + sinc * d
    return normalize(out)


def local(p, q):
    """Inverse retract (Unit3::localCoordinates): log map on the sphere. The
    double `where` keeps forward-mode tangents finite at sin_t = 0."""
    B = basis(p)
    cos_t = torch.clamp(torch.sum(p * q, dim=-1, keepdim=True), -1.0, 1.0)
    # component of q orthogonal to p
    perp = q - cos_t * p
    sin_t = torch.linalg.norm(perp, dim=-1, keepdim=True)
    th = torch.atan2(sin_t, cos_t)
    small = sin_t < _EPS
    one = torch.ones_like(sin_t)
    scale = torch.where(small, one, th / torch.where(small, one, sin_t))
    v = scale * perp
    return torch.einsum("...ij,...i->...j", B, v)


def identity(dtype=torch.float64, device="cuda"):
    return torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=resolve_device(device))
