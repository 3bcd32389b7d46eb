"""Calibration models (reference: gtsam/geometry/Cal3*.{h,cpp}).

Port of gtsam_petercdev_tpu/geometry/cal3.py. Each model is a flat
parameter vector + pure batched calibrate/uncalibrate maps. Implemented:
Cal3_S2 (5: fx fy s u0 v0), Cal3Bundler (3: f k1 k2, fixed center), Cal3DS2
(9: fx fy s u0 v0 k1 k2 p1 p2), Cal3Fisheye, Cal3Unified, Cal3_S2Stereo.
uncalibrate: intrinsic (normalized) -> image coords; calibrate: inverse.

Constructors return tensors on `device` (default "cuda", raising without a
card unless device="cpu").
"""

from __future__ import annotations

import torch

from gtsam_petercdev_torch.device import resolve_device


def _vec(vals, dtype, device):
    return torch.tensor([float(v) for v in vals], dtype=dtype, device=resolve_device(device))


# --- Cal3_S2: [fx, fy, s, u0, v0] -------------------------------------------

CAL3_S2_DIM = 5


def cal3_s2(fx, fy, s, u0, v0, dtype=torch.float64, device="cuda"):
    return _vec([fx, fy, s, u0, v0], dtype, device)


def cal3_s2_uncalibrate(k, p):
    fx, fy, s, u0, v0 = (k[..., i] for i in range(5))
    x, y = p[..., 0], p[..., 1]
    return torch.stack([fx * x + s * y + u0, fy * y + v0], dim=-1)


def cal3_s2_calibrate(k, pi):
    fx, fy, s, u0, v0 = (k[..., i] for i in range(5))
    u, v = pi[..., 0], pi[..., 1]
    y = (v - v0) / fy
    x = (u - u0 - s * y) / fx
    return torch.stack([x, y], dim=-1)


# --- Cal3Bundler: [f, k1, k2] (u0=v0=0 fixed) --------------------------------

CAL3_BUNDLER_DIM = 3


def cal3_bundler(f, k1, k2, dtype=torch.float64, device="cuda"):
    return _vec([f, k1, k2], dtype, device)


def cal3_bundler_uncalibrate(k, p):
    """(Cal3Bundler.cpp:64-90): pi = f * (1 + k1 r + k2 r^2) * p, r = |p|^2."""
    f, k1, k2 = k[..., 0], k[..., 1], k[..., 2]
    x, y = p[..., 0], p[..., 1]
    r = x * x + y * y
    g = 1.0 + (k1 + k2 * r) * r
    return torch.stack([f * g * x, f * g * y], dim=-1)


def cal3_bundler_calibrate(k, pi, iterations: int = 10):
    """Invert the distortion by fixed-point iteration (Cal3Bundler.cpp:93)."""
    f, k1, k2 = k[..., 0], k[..., 1], k[..., 2]
    px, py = pi[..., 0] / f, pi[..., 1] / f
    x, y = px, py
    for _ in range(iterations):
        r = x * x + y * y
        g = 1.0 + (k1 + k2 * r) * r
        x, y = px / g, py / g
    return torch.stack([x, y], dim=-1)


# --- Cal3DS2: [fx, fy, s, u0, v0, k1, k2, p1, p2] ----------------------------

CAL3_DS2_DIM = 9


def cal3_ds2_uncalibrate(k, p):
    """Radial-tangential distortion (Cal3DS2_Base.cpp)."""
    fx, fy, s, u0, v0 = (k[..., i] for i in range(5))
    k1, k2, p1, p2 = (k[..., i] for i in range(5, 9))
    x, y = p[..., 0], p[..., 1]
    xy = x * y
    xx, yy = x * x, y * y
    r2 = xx + yy
    g = 1.0 + k1 * r2 + k2 * r2 * r2
    dx = 2.0 * p1 * xy + p2 * (r2 + 2.0 * xx)
    dy = 2.0 * p2 * xy + p1 * (r2 + 2.0 * yy)
    xd, yd = g * x + dx, g * y + dy
    return torch.stack([fx * xd + s * yd + u0, fy * yd + v0], dim=-1)


def _newton_calibrate(uncalibrate, k, pi, iterations):
    """Invert a single point's `uncalibrate(k, .)` by Newton steps on the
    2 x 2 forward-mode Jacobian (k [dim], pi [2]; vmap for batches)."""
    fx, fy, s, u0, v0 = (k[..., i] for i in range(5))
    yg = (pi[..., 1] - v0) / fy
    xg = (pi[..., 0] - u0 - s * yg) / fx
    pn = torch.stack([xg, yg], dim=-1)
    for _ in range(iterations):
        uv = uncalibrate(k, pn)
        J = torch.func.jacfwd(lambda q: uncalibrate(k, q))(pn)
        pn = pn + torch.linalg.solve(J, pi - uv)
    return pn


def cal3_ds2_calibrate(k, pi, iterations: int = 10):
    """Inverse radial-tangential distortion by Newton iteration
    (Cal3DS2_Base::calibrate)."""
    return _newton_calibrate(cal3_ds2_uncalibrate, k, pi, iterations)


# --- Cal3Fisheye (equidistant fisheye) --------------------------------------
# Reference: gtsam/geometry/Cal3Fisheye.{h,cpp}:47-95 — vector
# [fx, fy, s, u0, v0, k1, k2, k3, k4]; Jacobians come from autodiff.


def cal3_fisheye(fx, fy, s, u0, v0, k1=0.0, k2=0.0, k3=0.0, k4=0.0,
                 dtype=torch.float64, device="cuda"):
    return _vec([fx, fy, s, u0, v0, k1, k2, k3, k4], dtype, device)


def cal3_fisheye_uncalibrate(k, p):
    fx, fy, s, u0, v0 = (k[..., i] for i in range(5))
    k1, k2, k3, k4 = (k[..., i] for i in range(5, 9))
    x, y = p[..., 0], p[..., 1]
    r2 = x * x + y * y
    # double-where: keep the sqrt branch differentiable at r == 0
    small = r2 < 1e-10
    r2_safe = torch.where(small, torch.ones_like(r2), r2)
    r = torch.sqrt(r2_safe)
    t = torch.where(small, torch.zeros_like(r), torch.atan(r))
    t2 = t * t
    poly = 1.0 + k1 * t2 + k2 * t2**2 + k3 * t2**3 + k4 * t2**4
    # Scaling(r) = atan(r)/r with Taylor fallback near 0 (Cal3Fisheye.cpp:36)
    scaling = torch.where(small, 1.0 - r2 / 3 + r2 * r2 / 5, torch.atan(r) / r)
    sc = scaling * poly
    xd, yd = sc * x, sc * y
    return torch.stack([fx * xd + s * yd + u0, fy * yd + v0], dim=-1)


def cal3_fisheye_calibrate(k, pi, iterations: int = 10):
    """Inverse distortion by fixed-point Gauss-Newton (Cal3Fisheye::calibrate)."""
    return _newton_calibrate(cal3_fisheye_uncalibrate, k, pi, iterations)


# --- Cal3Unified (omnidirectional / Mei model) ------------------------------
# Reference: gtsam/geometry/Cal3Unified.{h,cpp}:56-122 — Cal3DS2 vector plus
# the mirror parameter xi: [fx, fy, s, u0, v0, k1, k2, p1, p2, xi].


def cal3_unified(fx, fy, s, u0, v0, k1=0.0, k2=0.0, p1=0.0, p2=0.0, xi=0.0,
                 dtype=torch.float64, device="cuda"):
    return _vec([fx, fy, s, u0, v0, k1, k2, p1, p2, xi], dtype, device)


def cal3_unified_uncalibrate(k, p):
    xi = k[..., 9]
    xs, ys = p[..., 0], p[..., 1]
    sqrt_nx = torch.sqrt(xs * xs + ys * ys + 1.0)
    f = 1.0 / (1.0 + xi * sqrt_nx)
    m = torch.stack([xs * f, ys * f], dim=-1)
    return cal3_ds2_uncalibrate(k[..., :9], m)


def cal3_unified_space_from_nplane(k, p):
    """nPlaneToSpace (Cal3Unified.cpp:116-122)."""
    xi = k[..., 9]
    x, y = p[..., 0], p[..., 1]
    xy2 = x * x + y * y
    sq = (xi + torch.sqrt(1.0 + (1.0 - xi * xi) * xy2)) / (xy2 + 1.0)
    return torch.stack([sq * x / (sq - xi), sq * y / (sq - xi)], dim=-1)


def cal3_unified_calibrate(k, pi, iterations: int = 10):
    """Pixel -> unit-depth space point (Cal3Unified::calibrate)."""
    pn = cal3_ds2_calibrate(k[..., :9], pi, iterations)
    return cal3_unified_space_from_nplane(k, pn)


# --- Cal3_S2Stereo ----------------------------------------------------------
# Reference: gtsam/geometry/Cal3_S2Stereo.h — Cal3_S2 plus baseline b:
# [fx, fy, s, u0, v0, b]; used by StereoCamera.project -> (uL, uR, v).


def cal3_s2_stereo(fx, fy, s, u0, v0, b, dtype=torch.float64, device="cuda"):
    return _vec([fx, fy, s, u0, v0, b], dtype, device)


def stereo_uncalibrate(k, p):
    """Normalized camera point (x, y, inv_depth d=1/z) -> (uL, uR, v).

    Matches StereoCamera::project (gtsam/geometry/StereoCamera.cpp:44):
    uL = fx x + s y + u0; uR = uL - fx b / z; v = fy y + v0."""
    fx, fy, s, u0, v0, b = (k[..., i] for i in range(6))
    x, y, invz = p[..., 0], p[..., 1], p[..., 2]
    uL = fx * x + s * y + u0
    uR = uL - fx * b * invz
    v = fy * y + v0
    return torch.stack([uL, uR, v], dim=-1)
