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
           Vector9 are [N, 5] and [N, 9]

This is the one place that carries state across: a JAX `Values` / graph,
or a smart-factor batch, read out as numpy, becomes the port's here.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from gtsam_petercdev_torch.device import DeviceLike, resolve_device, resolve_dtype
from gtsam_petercdev_torch.geometry.pose3 import Pose3
from gtsam_petercdev_torch.navigation import ahrs, extra_factors
from gtsam_petercdev_torch.navigation import factors as nav_factors
from gtsam_petercdev_torch.navigation.navstate import NavState
from gtsam_petercdev_torch.navigation.preintegration import PIM
from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph, row_block
from gtsam_petercdev_torch.nonlinear.fixed_lag import linear_container_factor
from gtsam_petercdev_torch.nonlinear.values import Values
from gtsam_petercdev_torch.sfm.bal import SfmCamera
from gtsam_petercdev_torch.slam import factors, projection, smart, unstable_factors
from gtsam_petercdev_torch.slam import initialize  # noqa: F401  (registers Vector9)

_LAYOUTS = {"Pose3": Pose3, "SfmCamera": SfmCamera, "NavState": NavState}
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
}
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


def _layout(type_name: str, params):
    """Value params of a manifold type in the port's layout."""
    return _LAYOUTS[type_name](*params) if type_name in _LAYOUTS else params


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
    return factors.factor_type(name)


def values_from_arrays(
    arrays: Dict[str, Tuple[np.ndarray, object]], *, device: DeviceLike = "cuda", dtype=None
) -> Values:
    """Values on `device` in `dtype` (default float64) from numpy arrays."""
    values = Values(device=device, dtype=dtype)
    for t, (keys, params) in arrays.items():
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
        if name.startswith("LinearContainer["):
            x0s, sqrtH, rhs = params
            params = (tuple(_layout(t, x0) for t, x0 in zip(ft.var_types, x0s)), sqrtH, rhs)
        elif name in _PARAM_LAYOUTS:
            params = _PARAM_LAYOUTS[name](params)
        elif name.startswith(_EM):
            params = dict(params, measured=_layout(ft.var_types[0], params["measured"]))
        elif name in _NAVIGATION:  # arrays or dicts of arrays, as they are
            pass
        elif not isinstance(params, dict):  # Prior / Between: a manifold value
            params = _layout(ft.var_types[0], params)
        graph.add_batch(ft, keys, params, sqrt_info)
    return graph



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
