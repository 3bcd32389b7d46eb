"""Build the port's Values and NonlinearFactorGraph from numpy arrays.

The carry-across format is plain numpy, so the same arrays can feed the JAX
package and the port (the JAX side keeps its factor data as numpy already):

  values:  {type_name: (keys [N], params)}           params: [N, dim] for
           vector-like types, (R [N,3,3], t [N,3]) for Pose3,
           (R [N,3,3], t [N,3], cal [N,3]) for SfmCamera, (R [N,3,3],
           t [N,3], v [N,3]) for NavState
  factors: [(factor_type_name, keys [N, K], params, sqrt_info [N, d, d])]
           factor_type_name is "Prior<Type>", "Between<Type>" (params: a
           value of <Type> in the layout above), a projection factor's
           name, "GeneralSFMFactor" etc. (params: a dict, {"uv": [N, 2]}),
           or "LinearContainer[T1,...]<D>", a fixed-lag marginal factor
           (params: (x0s, sqrtH [N, D, D], rhs [N, D]), x0s one value per
           variable in the layout of its type), or a navigation factor's
           name: "ImuFactor" / "CombinedImuFactor" (params: {"pim": a PIM
           tuple of arrays [N, ...] in navigation.preintegration.PIM's field
           order, "n_gravity": [N, 3]}), "AHRSFactor" (params: a
           PreintegratedRotation tuple of arrays), "GPSFactor" ([N, 3]),
           "BarometricFactor" ([N, 1]), the attitude, mag and
           constant-velocity factors (dicts of arrays, as their docstrings
           in navigation/extra_factors.py name them), or an unstable
           factor's: "ProjectionFactorRollingShutter" ({"uv", "K",
           "alpha"}), "BetweenFactorEM<Type>" ({"measured": a value of
           <Type>, "R_in", "R_out", "prior_in", "prior_out"}),
           "InvDepthFactor3" ({"uv", "K"}); the value types InvDepthRay5 and
           Vector9 are [N, 5] and [N, 9]; or the robust / global front
           end's: "LinearContainer<T1>_<T2>_<d>", the JAX package's custom
           linear container (nonlinear/custom.py; params: {"A": tuple of
           [N, d, dim_k], "b": [N, d], "x0": tuple of values, each in the
           layout of its type}), "Shonan<p>" ([N, 3, 3] measured rotations)
           and "ShonanGauge<p>" ([N, p, 3]) on the value type "SOn<p>"
           ([N, p, p], registered on first use), "TranslationDirection"
           ([N, 3] unit directions) and "TranslationPrior" ([N, 3]); or
           the extended geometry's: the value types Sim3 ((R [N,3,3], t
           [N,3], s [N])), Unit3 ([N, 3]), EssentialMatrix ((R, t [N,3])),
           OrientedPlane3 ((n [N,3], d [N])), Line3 ((R, a [N], b [N])) and
           "Vector<N>" (a basis fit's coefficients, registered on first
           use); the sam factors "Range<Pose><Point>" ([N] ranges),
           "BearingPose2Point2" ([N]), "BearingRangePose2Point2" ([N, 2]),
           "BearingPose3Point3" ([N, 3] unit directions); the factors of
           slam/extra_factors.py under their names ("PoseRotationPrior"
           [N, 3, 3], "EssentialMatrixConstraint" an EssentialMatrix,
           "OrientedPlane3Factor" / "OrientedPlane3DirectionPrior" an
           OrientedPlane3, "KarcherMeanFactor<n>" and "ReferenceFrameFactor"
           None, the rest arrays or dicts of arrays as their docstrings name
           them), "Anti<name>" (the params of <name>), and
           "BasisEval<N>_<weight function>" ({"x": [N], "y": [N]})

Discrete and hybrid graphs have converters of their own
(`discrete_graph_from_arrays`, `hybrid_graph_from_arrays`): their tables,
cards, terms and noise normalizers as numpy arrays.

This is the one place that carries state across: a JAX `Values` / graph,
or a smart-factor batch, read out as numpy, becomes the port's here.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from gtsam_petercdev_torch import basis
from gtsam_petercdev_torch.basis import fit as basis_fit
from gtsam_petercdev_torch.device import DeviceLike, resolve_device, resolve_dtype
from gtsam_petercdev_torch.geometry.essential import EssentialMatrix, Line3, OrientedPlane3
from gtsam_petercdev_torch.geometry.pose3 import Pose3
from gtsam_petercdev_torch.geometry.sim3 import Sim3
from gtsam_petercdev_torch.navigation import ahrs, extra_factors
from gtsam_petercdev_torch.navigation import factors as nav_factors
from gtsam_petercdev_torch.navigation.navstate import NavState
from gtsam_petercdev_torch.navigation.preintegration import PIM
from gtsam_petercdev_torch.nonlinear import custom
from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph, row_block
from gtsam_petercdev_torch.nonlinear.fixed_lag import linear_container_factor
from gtsam_petercdev_torch.nonlinear.values import Values
from gtsam_petercdev_torch.sam import factors as sam_factors
from gtsam_petercdev_torch.sfm import shonan, translation
from gtsam_petercdev_torch.sfm.bal import SfmCamera
from gtsam_petercdev_torch.slam import extra_factors as slam_extra
from gtsam_petercdev_torch.slam import factors, projection, smart, unstable_factors
from gtsam_petercdev_torch.slam import initialize  # noqa: F401  (registers Vector9)

_LAYOUTS = {"Pose3": Pose3, "SfmCamera": SfmCamera, "NavState": NavState, "Sim3": Sim3,
            "EssentialMatrix": EssentialMatrix, "OrientedPlane3": OrientedPlane3,
            "Line3": Line3}
_NAVIGATION = {
    make().name: make
    for make in (
        nav_factors.imu_factor,
        nav_factors.combined_imu_factor,
        nav_factors.gps_factor,
        ahrs.ahrs_factor,
        extra_factors.rot3_attitude_factor,
        extra_factors.pose3_attitude_factor,
        extra_factors.mag_factor,
        extra_factors.mag_pose_factor,
        extra_factors.mag_factor_calibration,
        extra_factors.barometric_factor,
        extra_factors.constant_velocity_factor,
    )
}
# factor params carried as tuples that the port holds as NamedTuples
_PARAM_LAYOUTS = {
    "ImuFactor": lambda p: dict(p, pim=PIM(*p["pim"])),
    "CombinedImuFactor": lambda p: dict(p, pim=PIM(*p["pim"])),
    "AHRSFactor": lambda p: ahrs.PreintegratedRotation(*p),
    "EssentialMatrixConstraint": lambda p: EssentialMatrix(*p),
    "OrientedPlane3Factor": lambda p: OrientedPlane3(*p),
    "OrientedPlane3DirectionPrior": lambda p: OrientedPlane3(*p),
}
# the extended geometry's factors (params arrays, dicts of arrays or None, as
# they are, except the layouts above)
_EXTRA = {
    make().name: make
    for make in (
        sam_factors.bearing_factor_2d,
        sam_factors.bearing_range_factor_2d,
        sam_factors.bearing_factor_3d,
        slam_extra.frobenius_factor,
        slam_extra.frobenius_between_factor,
        slam_extra.pose_rotation_prior,
        slam_extra.pose_translation_prior,
        slam_extra.rotate_factor,
        slam_extra.rotate_directions_factor,
        slam_extra.essential_matrix_factor,
        slam_extra.essential_matrix_constraint,
        slam_extra.oriented_plane3_factor,
        slam_extra.oriented_plane3_direction_prior,
        slam_extra.reference_frame_factor,
        slam_extra.planar_projection_factor,
    )
}
_KARCHER, _ANTI, _BASIS = "KarcherMeanFactor", "Anti", "BasisEval"
_POSES = ("Pose2", "Pose3")
_PROJECTION = {
    make().name: make
    for make in (
        projection.general_sfm_factor,
        projection.projection_factor_s2,
        projection.projection_factor_bundler_fixed,
        projection.stereo_factor,
        unstable_factors.projection_factor_rolling_shutter,
        unstable_factors.inv_depth_factor3,
    )
}
_EM = "BetweenFactorEM"
_CUSTOM_CONTAINER = "LinearContainer"  # "LinearContainer[" is the fixed-lag form
_SFM = {"TranslationDirection": translation._translation_factor,
        "TranslationPrior": translation._translation_prior}


def _layout(type_name: str, params):
    """Value params of a manifold type in the port's layout."""
    return _LAYOUTS[type_name](*params) if type_name in _LAYOUTS else params


def _register_son(type_name: str) -> None:
    """Register an "SOn<p>" value type (SO(p), sfm/shonan.py) or a
    "Vector<N>" (basis/fit.py) on first use."""
    if type_name.startswith("SOn") and type_name[3:].isdigit():
        shonan.register_son(int(type_name[3:]))
    elif type_name.startswith("Vector") and type_name[6:].isdigit():
        basis_fit._coeff_type(int(type_name[6:]))


def _extended_factor(name: str):
    """FactorType of the extended geometry's factors from its name, or None."""
    if name in _EXTRA:
        return _EXTRA[name]()
    if name.startswith("Range") and name[5:10] in _POSES:
        return sam_factors.range_factor(name[5:10], name[10:])
    if name.startswith(_KARCHER) and name[len(_KARCHER):].isdigit():
        return slam_extra.karcher_mean_factor(int(name[len(_KARCHER):]))
    if name.startswith(_ANTI):
        return slam_extra.anti_factor(factor_type(name[len(_ANTI):]))
    if name.startswith(_BASIS):
        n, fn = name[len(_BASIS):].split("_", 1)
        return basis_fit.evaluation_factor(int(n), getattr(basis, fn))
    return None


def factor_type(name: str):
    """FactorType from its name (see the module docstring; "<name>@rows<a>:<b>"
    is factor_graph.row_block of <name>'s type)."""
    if "@rows" in name:
        base, rows = name.rsplit("@rows", 1)
        start, stop = (int(x) for x in rows.split(":"))
        return row_block(factor_type(base), start, stop)
    if name in _PROJECTION:
        return _PROJECTION[name]()
    if name.startswith(_EM):
        return unstable_factors.between_factor_em(name[len(_EM):])
    if name in _NAVIGATION:
        return _NAVIGATION[name]()
    if name.startswith("LinearContainer["):
        inner, dim = name[len("LinearContainer["):].rsplit("]", 1)
        return linear_container_factor(tuple(inner.split(",")), int(dim))
    if name.startswith(_CUSTOM_CONTAINER):
        inner, dim = name[len(_CUSTOM_CONTAINER):].rsplit("_", 1)
        return custom.linear_container_factor(tuple(inner.split("_")), int(dim))
    for prefix, make in (("ShonanGauge", shonan._gauge_factor), ("Shonan", shonan._shonan_factor)):
        if name.startswith(prefix) and name[len(prefix):].isdigit():
            return make(int(name[len(prefix):]))
    if name in _SFM:
        return _SFM[name]()
    ft = _extended_factor(name)
    return ft if ft is not None else factors.factor_type(name)


def values_from_arrays(
    arrays: Dict[str, Tuple[np.ndarray, object]], *, device: DeviceLike = "cuda", dtype=None
) -> Values:
    """Values on `device` in `dtype` (default float64) from numpy arrays."""
    values = Values(device=device, dtype=dtype)
    for t, (keys, params) in arrays.items():
        _register_son(t)
        values.insert_batch(np.asarray(keys), t, _layout(t, params))
    return values


def graph_from_arrays(
    factors: Sequence[Tuple[str, np.ndarray, object, np.ndarray]],
    *,
    device: DeviceLike = "cuda",
    dtype=None,
) -> NonlinearFactorGraph:
    """NonlinearFactorGraph on `device` in `dtype` from numpy factor batches."""
    graph = NonlinearFactorGraph(device=device, dtype=dtype)
    for name, keys, params, sqrt_info in factors:
        ft = factor_type(name)
        graph.add_batch(ft, keys, _factor_params(name, ft, params), sqrt_info)
    return graph


def _factor_params(name: str, ft, params):
    """A factor batch's numpy params in the port's layout."""
    if name.startswith(_ANTI):
        return _factor_params(name[len(_ANTI):], ft, params)
    if name.startswith("LinearContainer["):
        x0s, sqrtH, rhs = params
        return (tuple(_layout(t, x0) for t, x0 in zip(ft.var_types, x0s)), sqrtH, rhs)
    if name.startswith(_CUSTOM_CONTAINER):
        return {"A": tuple(params["A"]), "b": params["b"],
                "x0": tuple(_layout(t, x0) for t, x0 in zip(ft.var_types, params["x0"]))}
    if name in _PARAM_LAYOUTS:
        return _PARAM_LAYOUTS[name](params)
    if name.startswith(_EM):
        return dict(params, measured=_layout(ft.var_types[0], params["measured"]))
    if name in _NAVIGATION or _extended_factor(name) is not None:
        return params  # arrays, dicts of arrays or None, as they are
    if not isinstance(params, dict):  # Prior / Between: a manifold value
        return _layout(ft.var_types[0], params)
    return params



def smart_batch_from_arrays(
    cam_rows: np.ndarray,
    mask: np.ndarray,
    measured: np.ndarray,
    cal: np.ndarray,
    cal_rows=None,
    stereo: bool = False,
    params=None,
    *,
    device: DeviceLike = "cuda",
    dtype=None,
):
    """The port's SmartProjectionFactorBatch from the numpy arrays of a
    batch (a JAX `SmartProjectionFactorBatch`'s fields read out with
    `np.asarray`): cam_rows / mask / cal_rows [T, M], measured [T, M, 2|3],
    cal [C, 5|6]; measured and cal go to `device` in `dtype` (default
    float64). params: the port's SmartProjectionParams (default ones)."""
    dev, dt = resolve_device(device), resolve_dtype(dtype)
    return smart.SmartProjectionFactorBatch(
        np.asarray(cam_rows, dtype=np.int32), np.asarray(mask, dtype=bool),
        torch.as_tensor(np.asarray(measured, dtype=np.float64)).to(dev, dt),
        torch.as_tensor(np.asarray(cal, dtype=np.float64)).to(dev, dt),
        params or smart.SmartProjectionParams(),
        None if cal_rows is None else np.asarray(cal_rows, dtype=np.int32),
        stereo=stereo)


def shonan_measurements(i, j, R, kappa, *, device: DeviceLike = "cuda", dtype=None):
    """The port's ShonanMeasurements from numpy arrays (edges i, j [E], R
    [E, 3, 3], kappa [E]); R and kappa go to `device` in `dtype` (default
    float64)."""
    dev, dt = resolve_device(device), resolve_dtype(dtype)
    return shonan.ShonanMeasurements(
        np.asarray(i, dtype=np.int64), np.asarray(j, dtype=np.int64),
        torch.as_tensor(np.asarray(R, dtype=np.float64)).to(dev, dt),
        torch.as_tensor(np.asarray(kappa, dtype=np.float64)).to(dev, dt))


def gnc_known_inliers(masks: Dict[int, np.ndarray]) -> Dict[int, np.ndarray]:
    """GncParams.known_inliers from numpy masks: batch index -> bool [N]
    (the batch order is the graph's staging order, as in the JAX package)."""
    return {int(i): np.asarray(m, dtype=bool) for i, m in masks.items()}


def gnc_weights(weights, *, device: DeviceLike = "cuda", dtype=None):
    """GNC weights (one [N] array per factor batch, a JAX GncResult's
    `weights` read out with np.asarray) as tensors on `device` in `dtype`
    (default float64)."""
    dev, dt = resolve_device(device), resolve_dtype(dtype)
    return [torch.as_tensor(np.asarray(w, dtype=np.float64)).to(dev, dt) for w in weights]


def discrete_graph_from_arrays(factors, *, device: DeviceLike = "cuda", dtype=None):
    """The port's DiscreteFactorGraph on `device` in `dtype` (default
    float64) from numpy factors [(keys_cards [(key, card), ...], table
    [*cards])]: a JAX DiscreteFactorGraph's factors read out as
    ([(k, graph.cards[k]) for k in f.keys], np.asarray(f.table))."""
    from gtsam_petercdev_torch.discrete.discrete import DiscreteFactorGraph

    g = DiscreteFactorGraph(device=device, dtype=dtype)
    for keys_cards, table in factors:
        g.add(keys_cards, np.asarray(table, dtype=np.float64))
    return g


def hybrid_graph_from_arrays(cont_dims, disc_cards, terms, discrete, *,
                             device: DeviceLike = "cuda", dtype=None):
    """The port's HybridGaussianFactorGraph on `device` in `dtype` (default
    float64) from numpy arrays: cont_dims {key: dim}, disc_cards {key:
    card}, terms [(cont_keys, A blocks (numpy, [*cards, r, dim_k] for a
    hybrid term), b, disc_keys, log_norm)] and discrete [(keys, table)] — a
    JAX HybridGaussianFactorGraph's fields (`gaussians` term by term,
    `discrete`) read out with np.asarray, in their order."""
    from gtsam_petercdev_torch.hybrid.hybrid import HybridGaussianFactorGraph

    g = HybridGaussianFactorGraph(device=device, dtype=dtype)
    for ck, A, b, dk, ln in terms:
        ckd = [(k, cont_dims[k]) for k in ck]
        if dk:
            g.add_hybrid(ckd, [(k, disc_cards[k]) for k in dk], A, b, log_norm=ln)
        else:
            g.add_continuous(ckd, A, b, log_norm=ln)
    for keys, table in discrete:
        g.add_discrete([(k, disc_cards[k]) for k in keys], table)
    return g
