"""SO(3) / SE(3) in plain PyTorch: tangent (omega, v), rotation first.

Exp / Log with Taylor branches where the angle is small, so the maps are
exact to rounding from the identity outwards."""

from __future__ import annotations

import math

import torch


def _small(dtype) -> float:
    return 1e-10 if dtype == torch.float64 else 1e-6


def hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _coeffs(theta2):
    """sin t / t, (1 - cos t) / t^2, (t - sin t) / t^3."""
    small = theta2 < _small(theta2.dtype)
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    t = torch.sqrt(t2)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(t) / t)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(t)) / t2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (t - torch.sin(t)) / (t2 * t))
    return A, B, C


def so3_exp(w):
    A, B, _ = _coeffs((w * w).sum(-1))
    W = hat(w)
    return torch.eye(3, dtype=w.dtype, device=w.device) + A[..., None, None] * W \
        + B[..., None, None] * (W @ W)


def so3_log(R):
    """Rotation vector of R: the generic formula, its Taylor form near the
    identity, and near pi the axis from the symmetric part."""
    cos_t = ((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) * 0.5).clamp(-1.0, 1.0)
    s = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)  # 2 sin(t) axis
    sin_t = 0.5 * torch.linalg.norm(s, dim=-1)
    theta = torch.atan2(sin_t, cos_t)
    small = sin_t * sin_t < _small(R.dtype)
    near_pi = small & (cos_t < 0)
    ratio = torch.where(small, 0.5 + sin_t * sin_t / 12.0,
                        theta / (2.0 * torch.where(small, torch.ones_like(sin_t), sin_t)))
    w = ratio[..., None] * s
    if bool(near_pi.any()):
        S = 0.5 * (R + R.transpose(-1, -2)) + torch.eye(3, dtype=R.dtype, device=R.device)
        k = torch.argmax(torch.diagonal(S, dim1=-2, dim2=-1), dim=-1)
        col = torch.gather(S, -1, k[..., None, None].expand(*k.shape, 3, 1))[..., 0]
        axis = col / torch.linalg.norm(col, dim=-1, keepdim=True)
        w = torch.where(near_pi[..., None], (math.pi - sin_t)[..., None] * axis, w)
    return w


def _jl(w):
    A, B, C = _coeffs((w * w).sum(-1))
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + B[..., None, None] * W + C[..., None, None] * (W @ W)


def _jl_inv(w):
    theta2 = (w * w).sum(-1)
    small = theta2 < _small(w.dtype)
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    t = torch.sqrt(t2)
    D = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    1.0 / t2 - (1.0 + torch.cos(t)) / (2.0 * t * torch.sin(t)))
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye - 0.5 * W + D[..., None, None] * (W @ W)


def se3_exp(xi):
    w, v = xi[..., :3], xi[..., 3:]
    return so3_exp(w), (_jl(w) @ v[..., None])[..., 0]


def se3_log(R, t):
    w = so3_log(R)
    return torch.cat([w, (_jl_inv(w) @ t[..., None])[..., 0]], -1)


def compose(R1, t1, R2, t2):
    return R1 @ R2, (R1 @ t2[..., None])[..., 0] + t1


def between(R1, t1, R2, t2):
    """(R1, t1)^-1 (R2, t2)."""
    R1t = R1.transpose(-1, -2)
    return R1t @ R2, (R1t @ (t2 - t1)[..., None])[..., 0]


def retract(R, t, xi):
    """(R, t) Exp(xi)."""
    dR, dt = se3_exp(xi)
    return compose(R, t, dR, dt)


def adjoint(R, t):
    """6 x 6 Ad of (R, t) for (omega, v) tangents: [[R, 0], [hat(t) R, R]]."""
    top = torch.cat([R, torch.zeros_like(R)], -1)
    return torch.cat([top, torch.cat([hat(t) @ R, R], -1)], -2)
