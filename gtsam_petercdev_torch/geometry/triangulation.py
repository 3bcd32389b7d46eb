"""Multi-view triangulation: DLT, LOST, nonlinear refinement, triangulateSafe.

Port of gtsam_petercdev_tpu/geometry/triangulation.py. Reference:
gtsam/geometry/triangulation.h — triangulateDLT (:88), triangulateLOST
(:111), triangulateNonlinear (:191), triangulatePoint3 (:425),
triangulateSafe -> TriangulationResult (:644-674).

Every function works on a FIXED number of views M per track with a boolean
validity mask, batched over any leading dims: Pose3 leaves [..., M, ...],
measurements [..., M, 2], mask [..., M]. One call triangulates every track
of a batch (the JAX package vmaps the single-track functions). The
reference's exceptions become integer status codes: a degenerate or
behind-camera track gets its code, nothing raises. The nonlinear refinement
takes its 3-column Jacobian analytically.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gtsam_petercdev_torch.geometry import so3
from gtsam_petercdev_torch.geometry.pose3 import Pose3

# TriangulationResult status codes (triangulation.h:644-674)
VALID = 0
DEGENERATE = 1
BEHIND_CAMERA = 2
OUTLIER = 3
FAR_POINT = 4


class TriangulationResult(NamedTuple):
    point: torch.Tensor  # [..., 3]
    status: torch.Tensor  # [...] int32, one of the codes above


class TriangulationParameters(NamedTuple):
    """triangulation.h TriangulationParameters."""

    rank_tolerance: float = 1e-9
    landmark_distance_threshold: float = -1.0  # <0: disabled
    dynamic_outlier_rejection_threshold: float = -1.0  # <0: disabled
    enable_epi: bool = False  # (reserved)


EIGH_CHUNK = 16384  # cuSOLVER's batched syev refuses batches of 32,767 and more (H100, CUDA 12.8)


def eigh_batched(a: torch.Tensor):
    """torch.linalg.eigh over a batch [..., n, n] in chunks of EIGH_CHUNK
    matrices, on either device (the card's batched solver has a batch
    limit; one chunk is one call)."""
    flat = a.reshape(-1, *a.shape[-2:])
    parts = [torch.linalg.eigh(c) for c in flat.split(EIGH_CHUNK)]
    w = torch.cat([p[0] for p in parts]).reshape(*a.shape[:-1])
    v = torch.cat([p[1] for p in parts]).reshape(a.shape)
    return w, v


def _mask(measured, mask):
    if mask is None:
        return torch.ones(measured.shape[:-1], dtype=torch.bool, device=measured.device)
    return mask


def _to_camera(poses: Pose3, p):
    """p [..., 3] in every view's camera frame: R^T (p - t), [..., M, 3]."""
    return so3.unrotate(poses.R, p[..., None, :] - poses.t)


def _safe_z(z):
    return torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)


def triangulate_dlt(poses: Pose3, measured_normalized, mask=None, rank_tol=1e-9):
    """Linear DLT from normalized (calibrated) measurements.

    Each view contributes two rows of A p_h = 0 built from the projection
    matrix P = [R^T | -R^T t] (world->cam); the null vector of A is the
    eigenvector of the smallest eigenvalue of the 4x4 A^T A. Returns
    (point [..., 3], second-smallest singular value [...]) — the caller
    thresholds rank_tol. The eigenvector's sign is free; the dehomogenised
    point is not."""
    dtype = measured_normalized.dtype
    mask = _mask(measured_normalized, mask)
    Rt = poses.R.transpose(-1, -2)  # [..., M, 3, 3] world->cam rotation
    tc = -(Rt @ poses.t[..., None])  # [..., M, 3, 1]
    P = torch.cat([Rt, tc], dim=-1)  # [..., M, 3, 4]
    x = measured_normalized[..., 0, None]
    y = measured_normalized[..., 1, None]
    w = mask.to(dtype)[..., None]
    rows1 = (x * P[..., 2, :] - P[..., 0, :]) * w  # [..., M, 4]
    rows2 = (y * P[..., 2, :] - P[..., 1, :]) * w
    A = torch.cat([rows1, rows2], dim=-2)  # [..., 2M, 4]
    evals, evecs = eigh_batched(A.transpose(-1, -2) @ A)
    v = evecs[..., :, 0]
    sv_second = torch.sqrt(torch.clamp(evals[..., 1], min=0.0))
    wh = torch.where(v[..., 3].abs() < 1e-12, torch.full_like(v[..., 3], 1e-12), v[..., 3])
    return v[..., :3] / wh[..., None], sv_second


def triangulate_lost(poses: Pose3, measured_normalized, mask=None, sigma_noise=1e-3):
    """LOST triangulation (Henry & Christian 2022; triangulation.h:111).

    Each view contributes rows (1 / sigma d_i) [u_i]_x (p - t_i) = 0, u_i the
    world-frame bearing and d_i the distance from the DLT point, solved as a
    3x3 normal system."""
    dtype = measured_normalized.dtype
    mask = _mask(measured_normalized, mask)
    ones = torch.ones_like(measured_normalized[..., :1])
    bearings_cam = torch.cat([measured_normalized, ones], dim=-1)
    bearings_cam = bearings_cam / torch.linalg.norm(bearings_cam, dim=-1, keepdim=True)
    u = so3.rotate(poses.R, bearings_cam)  # world bearings [..., M, 3]
    t = poses.t

    p0, _ = triangulate_dlt(poses, measured_normalized, mask)
    d = torch.linalg.norm(p0[..., None, :] - t, dim=-1)
    w = (mask.to(dtype) / torch.clamp(sigma_noise * d, min=1e-12))[..., None, None]
    A = w * so3.hat(u)  # [..., M, 3, 3] stacked cross operators
    b = (A @ t[..., None])[..., 0]
    AtA = torch.einsum("...mij,...mik->...jk", A, A)
    Atb = torch.einsum("...mij,...mi->...j", A, b)
    eye = torch.eye(3, dtype=dtype, device=A.device)
    return torch.linalg.solve(AtA + 1e-12 * eye, Atb)


def triangulate_nonlinear(poses: Pose3, measured_normalized, point_init, mask=None,
                          iterations: int = 5):
    """Gauss-Newton refinement on the reprojection residuals
    (triangulation.h:191): a fixed number of steps, each a 3x3 solve."""
    dtype = measured_normalized.dtype
    mf = _mask(measured_normalized, mask).to(dtype)[..., None]
    Rt = poses.R.transpose(-1, -2)
    eye = torch.eye(3, dtype=dtype, device=Rt.device)
    p = point_init
    for _ in range(iterations):
        q = _to_camera(poses, p)  # [..., M, 3]
        z = q[..., 2]
        small = z.abs() < 1e-9  # the clamped depth is a constant: no d/dz
        zs = _safe_z(z)
        r = (q[..., :2] / zs[..., None] - measured_normalized) * mf
        # d(q_xy / z)/dq, then dq/dp = R^T
        dz = torch.where(small, torch.zeros_like(z), -1.0 / (zs * zs))
        zero = torch.zeros_like(z)
        Dq = torch.stack([torch.stack([1.0 / zs, zero, q[..., 0] * dz], -1),
                          torch.stack([zero, 1.0 / zs, q[..., 1] * dz], -1)], -2)
        J = (Dq @ Rt) * mf[..., None]  # [..., M, 2, 3]
        H = torch.einsum("...mdi,...mdj->...ij", J, J) + 1e-9 * eye
        p = p - torch.linalg.solve(H, torch.einsum("...mdi,...md->...i", J, r))
    return p


def triangulate_point3(poses: Pose3, measured_normalized, mask=None, rank_tol: float = 1e-9,
                       optimize: bool = False, use_lost: bool = False):
    """Front-door triangulation (triangulation.h:425 triangulatePoint3).

    Returns (point [..., 3], rank_ok bool [...]). Cheirality is the caller's
    check (triangulate_safe)."""
    if use_lost:
        p = triangulate_lost(poses, measured_normalized, mask)
        ok = torch.ones(p.shape[:-1], dtype=torch.bool, device=p.device)
    else:
        p, sv = triangulate_dlt(poses, measured_normalized, mask, rank_tol)
        ok = sv >= rank_tol
    if optimize:
        p = triangulate_nonlinear(poses, measured_normalized, p, mask)
    return p, ok


def triangulate_safe(poses: Pose3, measured_normalized, mask=None,
                     params: Optional[TriangulationParameters] = None,
                     optimize: bool = True) -> TriangulationResult:
    """triangulateSafe (triangulation.h:644): status-coded triangulation.

    Checks, in the reference's order: enough views (>= 2) and rank, else
    DEGENERATE; cheirality (all depths > 0) else BEHIND_CAMERA; landmark
    distance threshold else FAR_POINT; max reprojection error else OUTLIER.
    Never raises."""
    params = params or TriangulationParameters()
    mask = _mask(measured_normalized, mask)
    n_views = mask.to(torch.int32).sum(-1)

    p, rank_ok = triangulate_point3(poses, measured_normalized, mask,
                                    rank_tol=params.rank_tolerance, optimize=optimize)
    q = _to_camera(poses, p)
    depths = q[..., 2]
    cheiral_ok = torch.all(torch.where(mask, depths > 0, True), dim=-1)

    if params.landmark_distance_threshold > 0:
        dists = torch.linalg.norm(p[..., None, :] - poses.t, dim=-1)
        far = torch.any(mask & (dists > params.landmark_distance_threshold), dim=-1)
    else:
        far = torch.zeros_like(cheiral_ok)

    if params.dynamic_outlier_rejection_threshold > 0:
        reproj = q[..., :2] / _safe_z(depths)[..., None] - measured_normalized
        err = torch.where(mask, torch.linalg.norm(reproj, dim=-1), torch.zeros_like(depths))
        outlier = err.amax(dim=-1) > params.dynamic_outlier_rejection_threshold
    else:
        outlier = torch.zeros_like(cheiral_ok)

    code = lambda c: torch.full_like(n_views, c)
    status = torch.where(
        (n_views < 2) | ~rank_ok,
        code(DEGENERATE),
        torch.where(~cheiral_ok, code(BEHIND_CAMERA),
                    torch.where(far, code(FAR_POINT),
                                torch.where(outlier, code(OUTLIER), code(VALID)))),
    )
    return TriangulationResult(p, status)


def triangulate_batch(poses_per_track: Pose3, measured_normalized, mask,
                      params: Optional[TriangulationParameters] = None,
                      optimize: bool = True) -> TriangulationResult:
    """triangulate_safe over T tracks: Pose3 leaves [T, M, ...], measured
    [T, M, 2], mask [T, M]."""
    return triangulate_safe(poses_per_track, measured_normalized, mask, params, optimize)
