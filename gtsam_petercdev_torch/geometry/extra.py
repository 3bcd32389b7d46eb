"""Geometry breadth: SphericalCamera, FundamentalMatrix, Similarity2, SO(n).

Port of gtsam_petercdev_tpu/geometry/extra.py. References:
  gtsam/geometry/SphericalCamera.h:36 — a camera with Unit3 bearing
  measurements (project returns a unit bearing; the error lives in the
  bearing's 2D tangent basis).
  gtsam/geometry/FundamentalMatrix.{h,cpp} — rank-2 F = U diag(1, s, 0) V^T
  on SO(3) x R x SO(3) (dim 7), and F from calibrations + essential matrix.
  gtsam/geometry/Similarity2.h — 2D similarity (R, t, s), dim 4.
  gtsam/geometry/SOn.h / SO4.h — SO(n) with vec / expmap. expmap is
  `torch.linalg.matrix_exp` (the JAX package's is jax.scipy.linalg.expm, a
  different algorithm: they agree to rounding, not bit for bit); logmap is
  the JAX package's inverse scaling-and-squaring (8 Denman-Beavers square
  roots of 12 inverse pairs each, then 12 Taylor terms), kept as it is.

Every function is batched over leading dims where its JAX counterpart takes
one element.
"""

from __future__ import annotations

import torch

from gtsam_petercdev_torch.device import resolve_device
from gtsam_petercdev_torch.geometry import pose3, rot2, so3, unit3

# --- SphericalCamera --------------------------------------------------------


def spherical_project(pose: "pose3.Pose3", point):
    """World point -> unit bearing in the camera frame
    (SphericalCamera::project2)."""
    q = pose3.transform_to(pose, point)
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    return q / torch.where(n < 1e-12, torch.ones_like(n), n)


def spherical_reprojection_error(pose: "pose3.Pose3", point, measured_bearing):
    """2D error in the measured bearing's tangent basis
    (SphericalCamera::reprojectionError -> Unit3::errorVector)."""
    return unit3.local(measured_bearing, spherical_project(pose, point))


def spherical_backproject(pose: "pose3.Pose3", bearing, depth):
    depth = torch.as_tensor(depth, dtype=bearing.dtype, device=bearing.device)
    return pose3.transform_from(pose, bearing * depth[..., None])


# --- FundamentalMatrix ------------------------------------------------------


def _t(M):
    return M.transpose(-1, -2)


def fundamental_from_essential(K1, E, K2):
    """F = K2^-T E K1^-1 (FundamentalMatrix(K1, E, K2) ctor)."""
    return torch.linalg.solve(_t(K2), E) @ torch.linalg.inv(K1)


def fundamental_params(F):
    """Decompose a rank-2 F into (U in SO(3), s, V in SO(3)) with
    F ~ U diag(1, s, 0) V^T (FundamentalMatrix.cpp initialize). Singular
    vectors are defined up to sign, so U and V may differ from another SVD's;
    the F they rebuild does not."""
    Uf, S, Vt = torch.linalg.svd(F)
    # fix the determinants into SO(3): the third column times det
    du = torch.linalg.det(Uf)[..., None, None]
    dv = torch.linalg.det(Vt)[..., None, None]
    keep = torch.tensor([1.0, 1.0, 0.0], dtype=F.dtype, device=F.device)
    last = torch.tensor([0.0, 0.0, 1.0], dtype=F.dtype, device=F.device)
    U = Uf * keep + Uf * last * du
    V = _t(Vt) * keep + _t(Vt) * last * dv
    return U, S[..., 1] / S[..., 0], V


def fundamental_matrix(U, s, V):
    """F = U diag(1, s, 0) V^T."""
    d = torch.stack([torch.ones_like(s), s, torch.zeros_like(s)], dim=-1)
    return (U * d[..., None, :]) @ _t(V)


def fundamental_retract(U, s, V, xi):
    """Manifold retract on SO(3) x R x SO(3): xi = [wU (3), ds, wV (3)]."""
    return U @ so3.expmap(xi[..., :3]), s + xi[..., 3], V @ so3.expmap(xi[..., 4:7])


def epipolar_error(F, p1, p2):
    """Algebraic epipolar error p2^T F p1 of pixel points [u, v]
    (the FundamentalMatrix tests' convention)."""
    h1 = torch.cat([p1, torch.ones_like(p1[..., :1])], dim=-1)
    h2 = torch.cat([p2, torch.ones_like(p2[..., :1])], dim=-1)
    return torch.einsum("...i,...ij,...j->...", h2, F, h1)


# --- Similarity2 ------------------------------------------------------------


def sim2(theta, t, s, dtype=torch.float64, device="cuda"):
    """Similarity2 as (R [2, 2], t [2], s) — Similarity2.h:40."""
    dev = resolve_device(device)

    def conv(x):
        return torch.as_tensor(x, dtype=dtype).to(dev)

    return rot2.matrix(conv(theta)), conv(t), conv(s)


def sim2_transform_from(g, p):
    R, t, s = g
    return s[..., None] * (R @ p[..., None])[..., 0] + t


def sim2_compose(a, b):
    Ra, ta, sa = a
    Rb, tb, sb = b
    return Ra @ Rb, sa[..., None] * (Ra @ tb[..., None])[..., 0] + ta, sa * sb


def sim2_inverse(g):
    R, t, s = g
    Rt = _t(R)
    return Rt, -(Rt @ t[..., None])[..., 0] / s[..., None], 1.0 / s


def sim2_identity(dtype=torch.float64, device="cuda"):
    dev = resolve_device(device)
    return (torch.eye(2, dtype=dtype, device=dev), torch.zeros(2, dtype=dtype, device=dev),
            torch.ones((), dtype=dtype, device=dev))


# --- SO(n) ------------------------------------------------------------------


def son_dim(n: int) -> int:
    return n * (n - 1) // 2


def _son_sign_index(n: int):
    """(row, col, sign, vec-slot) quadruples of gtsam SOn::Hat's recursion
    (SOn.cpp:25-49): level m fills row / col m-1 from xi[D - m(m-1)/2 ...],
    starting with sign (-1)^(m(m-1)/2) and alternating along the row."""
    D = n * (n - 1) // 2
    out = []
    for m in range(n, 1, -1):
        off = D - m * (m - 1) // 2
        sign = (-1.0) ** (m * (m - 1) // 2)
        for i in range(m - 1):
            out.append((m - 1, m - 2 - i, sign, off + i))
            sign = -sign
    return out


def son_hat(xi, n: int):
    """vec [..., n(n-1)/2] -> skew [..., n, n]; gtsam SOn::Hat's layout."""
    zero = torch.zeros_like(xi[..., 0])
    rows = [[zero] * n for _ in range(n)]
    for (r, c, sign, k) in _son_sign_index(n):
        rows[r][c] = -sign * xi[..., k]
        rows[c][r] = sign * xi[..., k]
    return torch.stack([torch.stack(row, dim=-1) for row in rows], dim=-2)


def son_vee(X, n: int):
    out = [None] * son_dim(n)
    for (r, c, sign, k) in _son_sign_index(n):
        out[k] = -sign * X[..., r, c]
    return torch.stack(out, dim=-1)


def son_expmap(xi, n: int):
    return torch.linalg.matrix_exp(son_hat(xi, n))


def _logm_rot(R, sqrt_iters: int = 8, taylor_terms: int = 12):
    """Matrix log of a rotation by inverse scaling-and-squaring: repeated
    principal square roots (Denman-Beavers) then a Taylor log."""
    eye = torch.eye(R.shape[-1], dtype=R.dtype, device=R.device)
    Y = R
    for _ in range(sqrt_iters):
        M, Z = Y, eye.expand(Y.shape)
        for _ in range(12):
            M, Z = 0.5 * (M + torch.linalg.inv(Z)), 0.5 * (Z + torch.linalg.inv(M))
        Y = M
    A = Y - eye
    out = torch.zeros_like(Y)
    term = A
    for k in range(1, taylor_terms + 1):
        out = out + ((-1.0) ** (k + 1)) / k * term
        term = term @ A
    return out * (2.0 ** sqrt_iters)


def son_logmap(R, n: int):
    X = _logm_rot(R)
    return son_vee(0.5 * (X - _t(X)), n)  # projected to skew


def son_retract(R, xi, n: int):
    return R @ son_expmap(xi, n)


def son_local(R1, R2, n: int):
    return son_logmap(_t(R1) @ R2, n)
