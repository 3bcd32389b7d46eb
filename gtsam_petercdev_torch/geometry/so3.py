"""SO(3): rotation matrices with exp/log maps and derivatives.

Representation: rotation matrix, tensor [..., 3, 3]. Tangent: axis-angle
vector omega [..., 3]. All functions are pure, batched over leading dims and
differentiable everywhere: every Taylor fallback is selected with
`torch.where` after the exact branch was evaluated at a safe value, so
`torch.func.jacfwd` / `vmap` stay NaN-free at the singular points.

Port of gtsam_petercdev_tpu/geometry/so3.py.
"""

from __future__ import annotations

import math

import torch

from gtsam_petercdev_torch.device import resolve_device

_EPS2 = 1e-10  # theta^2 threshold below which Taylor expansions are used


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def hat(w):
    """omega [...,3] -> skew-symmetric matrix [...,3,3] (SO3::Hat)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W):
    """Inverse of hat: [...,3,3] -> [...,3]."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _trig_coeffs(theta2):
    """(A, B, C) = (sin t/t, (1-cos t)/t^2, (1 - A)/t^2), Taylor-safe.

    The exact branch is evaluated at the safe value t2 = 1 where `small`
    holds, so its derivative never divides by zero."""
    small = theta2 < _EPS2
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    t = torch.sqrt(t2)
    A_exact = torch.sin(t) / t
    B_exact = (1.0 - torch.cos(t)) / t2
    C_exact = (1.0 - A_exact) / t2
    A_taylor = 1.0 - theta2 / 6.0 * (1.0 - theta2 / 20.0)
    B_taylor = 0.5 - theta2 / 24.0 * (1.0 - theta2 / 30.0)
    C_taylor = 1.0 / 6.0 - theta2 / 120.0 * (1.0 - theta2 / 42.0)
    A = torch.where(small, A_taylor, A_exact)
    B = torch.where(small, B_taylor, B_exact)
    C = torch.where(small, C_taylor, C_exact)
    return A, B, C


def expmap(w):
    """Exponential map: omega [...,3] -> R [...,3,3] (Rodrigues)."""
    theta2 = torch.sum(w * w, dim=-1)
    A, B, _ = _trig_coeffs(theta2)
    W = hat(w)
    W2 = W @ W
    return _eye3(w) + A[..., None, None] * W + B[..., None, None] * W2


def logmap(R):
    """Log map: R [...,3,3] -> omega [...,3].

    Small-angle, generic and near-pi regimes, branchless with safe selects
    (the same three regimes as SO3::Logmap)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    w_vee = vee(R - R.transpose(-1, -2))  # = 2 sin(theta) * axis

    # |sin(theta)| via a gradient-safe norm; `tiny` guards the sqrt's
    # derivative at exactly 0
    s2 = torch.sum(w_vee * w_vee, dim=-1)  # = 4 sin^2(theta)
    tiny = s2 < (100.0 * torch.finfo(R.dtype).eps) ** 2
    one = torch.ones_like(s2)
    sin_t = 0.5 * torch.sqrt(torch.where(tiny, one, s2))
    sin_safe = torch.where(tiny, torch.zeros_like(sin_t), sin_t)
    theta = torch.atan2(sin_safe, cos_t)

    near_pi = cos_t < -1.0 + 1e-6
    small = torch.logical_and(s2 < 4.0 * _EPS2, cos_t > 0.0)
    theta2 = s2 / 4.0  # ~ theta^2 in the small regime

    # generic / small-angle branch: omega = theta / (2 sin theta) * vee
    denom = torch.where(small, one, 2.0 * torch.where(tiny, one, sin_t))
    gen_scale_exact = theta / denom
    gen_scale_taylor = 0.5 + theta2 / 12.0 + 7.0 * theta2 * theta2 / 720.0
    gen_scale = torch.where(small, gen_scale_taylor, gen_scale_exact)
    w_gen = gen_scale[..., None] * w_vee

    # near-pi branch: a a^T = ((R+R^T)/2 - cos(t) I) / (1 - cos(t)), angle
    # t = pi - arcsin(|sin t|) (well conditioned where arccos is not)
    theta_pi = math.pi - torch.asin(torch.clamp(sin_safe, 0.0, 1.0))
    one_minus_cos = torch.where(near_pi, 1.0 - cos_t, one)[..., None, None]
    M = (
        0.5 * (R + R.transpose(-1, -2)) - cos_t[..., None, None] * _eye3(R)
    ) / one_minus_cos
    diag = torch.stack([M[..., 0, 0], M[..., 1, 1], M[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    idx = k[..., None, None].expand(*k.shape, 3, 1)
    col = torch.gather(M, -1, idx)[..., 0]
    col_norm = torch.linalg.norm(col, dim=-1, keepdim=True)
    axis = col / torch.where(col_norm < 1e-12, torch.ones_like(col_norm), col_norm)
    # sign of the axis from the skew part (zero exactly at pi, where both
    # signs are valid)
    sign = torch.sign(torch.sum(axis * w_vee, dim=-1, keepdim=True))
    sign = torch.where(sign == 0.0, torch.ones_like(sign), sign)
    w_pi = theta_pi[..., None] * axis * sign

    return torch.where(near_pi[..., None], w_pi, w_gen)


def expmap_derivative(w):
    """Right Jacobian Jr = I - B*W + C*W^2 (SO3::ExpmapDerivative)."""
    theta2 = torch.sum(w * w, dim=-1)
    _, B, C = _trig_coeffs(theta2)
    W = hat(w)
    W2 = W @ W
    return _eye3(w) - B[..., None, None] * W + C[..., None, None] * W2


def logmap_derivative(w):
    """Inverse right Jacobian Jr^{-1} = I + W/2 + D*W^2 (SO3::LogmapDerivative),
    D = 1/t^2 - (1+cos t)/(2 t sin t)."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < _EPS2
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    t = torch.sqrt(t2)
    D_exact = 1.0 / t2 - (1.0 + torch.cos(t)) / (2.0 * t * torch.sin(t))
    D_taylor = 1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0
    D = torch.where(small, D_taylor, D_exact)
    W = hat(w)
    W2 = W @ W
    return _eye3(w) + 0.5 * W + D[..., None, None] * W2


def left_jacobian(w):
    """Left Jacobian Jl(w) = Jr(-w), used by the SE(3) exp translation."""
    return expmap_derivative(-w)


def left_jacobian_inverse(w):
    return logmap_derivative(-w)


def compose(R1, R2):
    return R1 @ R2


def inverse(R):
    return R.transpose(-1, -2)


def between(R1, R2):
    """R1^{-1} R2."""
    return inverse(R1) @ R2


def rotate(R, p):
    """Apply rotation to points: [...,3,3] x [...,3] -> [...,3]."""
    return (R @ p[..., None])[..., 0]


def unrotate(R, p):
    return (R.transpose(-1, -2) @ p[..., None])[..., 0]


def identity(dtype=torch.float64, device="cuda"):
    return torch.eye(3, dtype=dtype, device=resolve_device(device))


def retract(R, w):
    """Expmap-based retract (the default chart for Rot3)."""
    return R @ expmap(w)


def local(R1, R2):
    """Tangent of R2 in the chart at R1: Log(R1^{-1} R2)."""
    return logmap(between(R1, R2))


def rpy(R):
    """Roll-pitch-yaw (xyz) extraction — for reporting only."""
    return torch.stack(
        [
            torch.atan2(R[..., 2, 1], R[..., 2, 2]),
            -torch.asin(torch.clamp(R[..., 2, 0], -1.0, 1.0)),
            torch.atan2(R[..., 1, 0], R[..., 0, 0]),
        ],
        dim=-1,
    )


def from_quaternion(q):
    """Quaternion [...,4] (w,x,y,z) -> rotation matrix (for g2o I/O)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
                         2 * (qx * qz + qw * qy)], dim=-1),
            torch.stack([2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
                         2 * (qy * qz - qw * qx)], dim=-1),
            torch.stack([2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
                         1 - 2 * (qx * qx + qy * qy)], dim=-1),
        ],
        dim=-2,
    )


def to_quaternion(R):
    """Rotation matrix -> quaternion [...,4] (w,x,y,z), Shepperd's method:
    of four formulations, the one with the largest pivot."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    s0 = safe_sqrt(1 + tr)
    q0 = torch.stack([s0 / 2, (m21 - m12) / (2 * s0), (m02 - m20) / (2 * s0),
                      (m10 - m01) / (2 * s0)], dim=-1)
    s1 = 2 * safe_sqrt(1 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / s1, s1 / 4, (m01 + m10) / s1, (m02 + m20) / s1], dim=-1)
    s2 = 2 * safe_sqrt(1 - m00 + m11 - m22)
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, s2 / 4, (m12 + m21) / s2], dim=-1)
    s3 = 2 * safe_sqrt(1 - m00 - m11 + m22)
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, s3 / 4], dim=-1)

    k = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)
    q = torch.gather(qs, -2, k[..., None, None].expand(*k.shape, 1, 4))[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)
