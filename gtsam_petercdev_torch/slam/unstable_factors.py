"""Research-grade factors from gtsam_unstable/slam.

Port of gtsam_petercdev_tpu/slam/unstable_factors.py:
  * ProjectionFactorRollingShutter (ProjectionFactorRollingShutter.h:43):
    the landmark is projected through the pose INTERPOLATED between two
    consecutive keyframes at the pixel row's exposure time
    alpha = (t_p - t_A)/(t_B - t_A).
  * BetweenFactorEM (BetweenFactorEM.h:34): per-factor EM data association —
    the whitened residual is the inlier/outlier responsibility-weighted
    stack, the responsibilities computed from the current estimate and held
    constant through linearization (`.detach()`, the EM E-step: under
    `torch.func.jacfwd` it cuts the tangent as JAX's stop_gradient does).
  * InvDepthFactor3 (InvDepthFactor3.h, InvDepthCamera3.h:75): visual
    measurement of a landmark parameterized as an anchor ray
    (x, y, z, theta, phi) plus a separate inverse depth variable.

Residuals are written over leading batch dimensions; Jacobians come from
the batched forward-mode path of nonlinear/factor_graph.py. Cheirality
(depth <= 0) masks a residual to zero with `torch.where`.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from gtsam_petercdev_torch.core import manifold
from gtsam_petercdev_torch.geometry import cameras, pose3
from gtsam_petercdev_torch.geometry.pose3 import Pose3
from gtsam_petercdev_torch.nonlinear.factor_graph import FactorType
from gtsam_petercdev_torch.slam.projection import _masked

# anchor-ray part of the split inverse-depth landmark (InvDepthFactor3.h:10:
# "(x,y,z,theta,phi), (inv_depth) to make it easy to add a prior on inverse
# depth alone")
if "InvDepthRay5" not in manifold.registered():
    manifold.register(manifold.vector_space("InvDepthRay5", 5))


def interpolate_pose3(a: Pose3, b: Pose3, alpha) -> Pose3:
    """gtsam::interpolate<Pose3>: a * Expmap(alpha * Logmap(a^-1 b));
    alpha a scalar or one per leading batch entry."""
    xi = pose3.logmap(pose3.between(a, b))
    alpha = torch.as_tensor(alpha, dtype=xi.dtype, device=xi.device)
    return pose3.compose(a, pose3.expmap(alpha[..., None] * xi))


@lru_cache(maxsize=None)
def projection_factor_rolling_shutter() -> FactorType:
    """Vars: (Pose3 A, Pose3 B, Point3); params: {'uv': [2], 'K': [5],
    'alpha': []} (ProjectionFactorRollingShutter.h:43)."""

    def residual(xs, params):
        pa, pb, point = xs
        pose = interpolate_pose3(pa, pb, params["alpha"])
        uv, depth = cameras.project_s2(pose, point, params["K"])
        return _masked(uv - params["uv"], depth)

    return FactorType(
        name="ProjectionFactorRollingShutter",
        var_types=("Pose3", "Pose3", "Point3"),
        resid_dim=2,
        residual=residual,
    )


def _whiten(R, r):
    return (R @ r[..., None])[..., 0]


@lru_cache(maxsize=None)
def between_factor_em(type_name: str) -> FactorType:
    """EM inlier/outlier between factor (BetweenFactorEM.h:34).

    Params: {'measured': value, 'R_in'/'R_out': [d, d] whitening factors of
    the two hypothesis noise models, 'prior_in'/'prior_out': scalars}.
    Residual (dim 2d) = [sqrt(p_in) R_in r ; sqrt(p_out) R_out r] with
    responsibilities p ~ prior * |R| exp(-0.5 |R r|^2), normalized, and
    detached (BetweenFactorEM.h:147-246). Use a UNIT outer noise model — the
    factor whitens internally."""
    m = manifold.get(type_name)

    def residual(xs, params):
        x1, x2 = xs
        r = m.local(params["measured"], m.between(x1, x2))
        r_in = _whiten(params["R_in"], r)
        r_out = _whiten(params["R_out"], r)
        p_in = (params["prior_in"] * torch.abs(torch.linalg.det(params["R_in"]))
                * torch.exp(-0.5 * torch.sum(r_in * r_in, dim=-1)))
        p_out = (params["prior_out"] * torch.abs(torch.linalg.det(params["R_out"]))
                 * torch.exp(-0.5 * torch.sum(r_out * r_out, dim=-1)))
        s = p_in + p_out
        w_in = torch.sqrt(p_in / s).detach()
        w_out = torch.sqrt(p_out / s).detach()
        return torch.cat([w_in[..., None] * r_in, w_out[..., None] * r_out], dim=-1)

    return FactorType(
        name=f"BetweenFactorEM{type_name}",
        var_types=(type_name, type_name),
        resid_dim=2 * m.dim,
        residual=residual,
    )


def inv_depth_to_point(ray5, rho):
    """InvDepthCamera3::invDepthTo3D (InvDepthCamera3.h:75): world point =
    base + unit(theta, phi) / rho."""
    theta, phi = ray5[..., 3], ray5[..., 4]
    mvec = torch.stack(
        [torch.cos(theta) * torch.cos(phi), torch.sin(theta) * torch.cos(phi), torch.sin(phi)],
        dim=-1,
    )
    return ray5[..., :3] + mvec / rho[..., None]


def inv_depth_backproject(pose: Pose3, K, uv, depth):
    """InvDepthCamera3::backproject: pixel + depth -> (ray5, inv depth)."""
    depth = torch.as_tensor(depth, dtype=pose.t.dtype, device=pose.t.device)
    pt = cameras.backproject_s2(pose, K, uv, depth)
    ray = pt - pose.t
    theta = torch.atan2(ray[..., 1], ray[..., 0])
    phi = torch.atan2(ray[..., 2], torch.linalg.norm(ray[..., :2], dim=-1))
    ray5 = torch.cat([pose.t, theta[..., None], phi[..., None]], dim=-1)
    return ray5, 1.0 / torch.linalg.norm(ray, dim=-1)


@lru_cache(maxsize=None)
def inv_depth_factor3() -> FactorType:
    """Vars: (Pose3, InvDepthRay5, Vector1); params: {'uv': [2], 'K': [5]}
    (InvDepthFactor3.h:88)."""

    def residual(xs, params):
        pose, ray5, rho = xs
        point = inv_depth_to_point(ray5, rho[..., 0])
        uv, depth = cameras.project_s2(pose, point, params["K"])
        return _masked(uv - params["uv"], depth)

    return FactorType(
        name="InvDepthFactor3",
        var_types=("Pose3", "InvDepthRay5", "Vector1"),
        resid_dim=2,
        residual=residual,
    )
