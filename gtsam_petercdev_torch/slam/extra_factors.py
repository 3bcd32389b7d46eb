"""Additional SLAM factors from gtsam/slam/.

Port of gtsam_petercdev_tpu/slam/extra_factors.py: FrobeniusFactor /
FrobeniusBetweenFactor (FrobeniusFactor.h), KarcherMeanFactor
(KarcherMeanFactor.h), PoseRotationPrior / PoseTranslationPrior,
RotateFactor / RotateDirectionsFactor (RotateFactor.h), EssentialMatrixFactor
(EssentialMatrixFactor.h), EssentialMatrixConstraint, OrientedPlane3Factor
and its direction prior (OrientedPlane3Factor.h), ReferenceFrameFactor,
AntiFactor (AntiFactor.h) and PlanarProjectionFactor
(PlanarProjectionFactor.h). Each residual is written over a factor batch
(leading dims), its Jacobians from the graph's forward-mode pass.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from gtsam_petercdev_torch.geometry import essential as ess
from gtsam_petercdev_torch.geometry import pose3, so3, unit3
from gtsam_petercdev_torch.nonlinear.factor_graph import FactorType


@lru_cache(maxsize=None)
def frobenius_factor() -> FactorType:
    """||R1 - R2||_F as a 9-vector residual (FrobeniusFactor.h:87)."""

    def residual(xs, params):
        R1, R2 = xs
        return (R2 - R1).flatten(-2)

    return FactorType(name="FrobeniusFactor", var_types=("Rot3", "Rot3"), resid_dim=9,
                      residual=residual)


@lru_cache(maxsize=None)
def frobenius_between_factor() -> FactorType:
    """vec(R1 R12_measured - R2) (FrobeniusBetweenFactor, FrobeniusFactor.h:121)."""

    def residual(xs, params):
        R1, R2 = xs
        return (R1 @ params - R2).flatten(-2)

    return FactorType(name="FrobeniusBetweenFactor", var_types=("Rot3", "Rot3"),
                      resid_dim=9, residual=residual)


@lru_cache(maxsize=None)
def karcher_mean_factor(n: int) -> FactorType:
    """Karcher-mean gauge factor: the sum of the log-maps of n rotations is 0
    (slam/KarcherMeanFactor-inl.h: removes the global rotation gauge of
    rotation averaging)."""

    def residual(xs, params):
        acc = so3.logmap(xs[0])
        for R in xs[1:]:
            acc = acc + so3.logmap(R)
        return acc

    return FactorType(name=f"KarcherMeanFactor{n}", var_types=("Rot3",) * n, resid_dim=3,
                      residual=residual)


@lru_cache(maxsize=None)
def pose_rotation_prior() -> FactorType:
    """Prior on the rotation part of a Pose3 only (PoseRotationPrior.h)."""

    def residual(xs, params):
        (p,) = xs
        return so3.logmap(so3.between(params, p.R))

    return FactorType(name="PoseRotationPrior", var_types=("Pose3",), resid_dim=3,
                      residual=residual)


@lru_cache(maxsize=None)
def pose_translation_prior() -> FactorType:
    """Prior on the translation part of a Pose3 only (PoseTranslationPrior.h)."""

    def residual(xs, params):
        (p,) = xs
        return p.t - params

    return FactorType(name="PoseTranslationPrior", var_types=("Pose3",), resid_dim=3,
                      residual=residual)


@lru_cache(maxsize=None)
def rotate_factor() -> FactorType:
    """An unknown rotation R relating two angular-velocity-like
    measurements, linearized as p - R z (RotateFactor.h).
    params = {'p': [..., 3] nav frame, 'z': [..., 3] body frame}."""

    def residual(xs, params):
        (R,) = xs
        return params["p"] - so3.rotate(R, params["z"])

    return FactorType(name="RotateFactor", var_types=("Rot3",), resid_dim=3, residual=residual)


@lru_cache(maxsize=None)
def rotate_directions_factor() -> FactorType:
    """The same with directions (RotateDirectionsFactor): 2D Unit3 error."""

    def residual(xs, params):
        (R,) = xs
        pred = so3.rotate(R, unit3.normalize(params["z"]))
        return unit3.local(unit3.normalize(params["p"]), pred)

    return FactorType(name="RotateDirectionsFactor", var_types=("Rot3",), resid_dim=2,
                      residual=residual)


@lru_cache(maxsize=None)
def essential_matrix_factor() -> FactorType:
    """The epipolar constraint on an EssentialMatrix from one calibrated point
    pair (EssentialMatrixFactor.h:45): r = pA^T E pB (algebraic).
    params = {'pA': [..., 2], 'pB': [..., 2]}."""

    def residual(xs, params):
        (E,) = xs
        return ess.epipolar_error(E, params["pA"], params["pB"])[..., None]

    return FactorType(name="EssentialMatrixFactor", var_types=("EssentialMatrix",),
                      resid_dim=1, residual=residual)


@lru_cache(maxsize=None)
def essential_matrix_constraint() -> FactorType:
    """A between-pose measurement expressed as an essential matrix
    (EssentialMatrixConstraint.h): the 5D error between the measured E and
    E(pose1.between(pose2))."""

    def residual(xs, params):
        rel = pose3.between(*xs)
        return ess.essential_local(params, ess.essential_from_pose(rel.R, rel.t))

    return FactorType(name="EssentialMatrixConstraint", var_types=("Pose3", "Pose3"),
                      resid_dim=5, residual=residual)


@lru_cache(maxsize=None)
def oriented_plane3_factor() -> FactorType:
    """A plane landmark measured from a pose (OrientedPlane3Factor.h):
    r = Local(measured plane, Transform(plane, pose))."""

    def residual(xs, params):
        pose, plane = xs
        return ess.plane_local(params, ess.plane_transform(plane, pose.R, pose.t))

    return FactorType(name="OrientedPlane3Factor", var_types=("Pose3", "OrientedPlane3"),
                      resid_dim=3, residual=residual)


@lru_cache(maxsize=None)
def oriented_plane3_direction_prior() -> FactorType:
    """A prior on a plane's direction and distance
    (OrientedPlane3DirectionPrior)."""

    def residual(xs, params):
        (plane,) = xs
        return ess.plane_local(params, plane)

    return FactorType(name="OrientedPlane3DirectionPrior", var_types=("OrientedPlane3",),
                      resid_dim=3, residual=residual)


@lru_cache(maxsize=None)
def reference_frame_factor(point_type: str = "Point3") -> FactorType:
    """The transform relating one landmark in two frames
    (ReferenceFrameFactor.h): r = T.transform_from(local) - global.
    Vars (global point, Pose3 transform, local point)."""

    def residual(xs, params):
        g, T, l = xs
        return pose3.transform_from(T, l) - g

    return FactorType(name="ReferenceFrameFactor", var_types=(point_type, "Pose3", point_type),
                      resid_dim=3, residual=residual)


def anti_factor(base: FactorType) -> FactorType:
    """AntiFactor (slam/AntiFactor.h): subtracts a factor's information.

    Usage: graph.add(anti_factor(ft), keys, params, sqrt_info, sign=-1.0).
    The sign rides on the batch into every assembly (the dense (H, g), the
    multifrontal pool), so the anti-factor with the same measurement cancels
    the original factor exactly. It keeps the base's closed-form Jacobians
    where it has them, so the two linearize alike to the last bit."""
    return FactorType(
        name=f"Anti{base.name}",
        var_types=base.var_types,
        resid_dim=base.resid_dim,
        residual=base.residual,
        linearize_residual=base.linearize_residual,
        analytic=base.analytic,
    )


@lru_cache(maxsize=None)
def planar_projection_factor() -> FactorType:
    """PlanarProjectionFactor1 (slam/PlanarProjectionFactor.h): a robot on the
    SE(2) plane observing known 3D landmarks through a fixed camera.
    Var Pose2; params {'landmark': [..., 3], 'measured': [..., 2], 'cal':
    [..., 5] fx fy s u0 v0, 'body_P_cam_R': [..., 3, 3], 'body_P_cam_t':
    [..., 3]}."""

    def residual(xs, params):
        (wTb,) = xs
        # lift SE(2) -> SE(3): a rotation about z, a translation in the plane
        th = wTb[..., 2]
        c, s = torch.cos(th), torch.sin(th)
        z, one = torch.zeros_like(th), torch.ones_like(th)
        R3 = torch.stack([torch.stack([c, -s, z], dim=-1), torch.stack([s, c, z], dim=-1),
                          torch.stack([z, z, one], dim=-1)], dim=-2)
        t3 = torch.stack([wTb[..., 0], wTb[..., 1], z], dim=-1)
        # world -> body -> camera
        Rc = R3 @ params["body_P_cam_R"]
        tc = t3 + so3.rotate(R3, params["body_P_cam_t"])
        pc = so3.unrotate(Rc, params["landmark"] - tc)
        u = pc[..., 0] / pc[..., 2]
        v = pc[..., 1] / pc[..., 2]
        k = params["cal"]
        uv = torch.stack([k[..., 0] * u + k[..., 2] * v + k[..., 3], k[..., 1] * v + k[..., 4]],
                         dim=-1)
        return uv - params["measured"]

    return FactorType(name="PlanarProjectionFactor", var_types=("Pose2",), resid_dim=2,
                      residual=residual)
