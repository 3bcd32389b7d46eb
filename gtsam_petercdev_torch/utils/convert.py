"""Build the port's Values and NonlinearFactorGraph from numpy arrays.

The carry-across format is plain numpy, so the same arrays can feed the JAX
package and the port (the JAX side keeps its factor data as numpy already):

  values:  {type_name: (keys [N], params)}           params: [N, dim] for
           vector-like types, (R [N,3,3], t [N,3]) for Pose3,
           (R [N,3,3], t [N,3], cal [N,3]) for SfmCamera
  factors: [(factor_type_name, keys [N, K], params, sqrt_info [N, d, d])]
           factor_type_name is "Prior<Type>", "Between<Type>" (params: a
           value of <Type> in the layout above) or a projection factor's
           name, "GeneralSFMFactor" etc. (params: a dict, {"uv": [N, 2]})

This is the one place that carries state across: a JAX `Values` / graph,
read out as numpy, becomes the port's here.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from gtsam_petercdev_torch.device import DeviceLike
from gtsam_petercdev_torch.geometry.pose3 import Pose3
from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph
from gtsam_petercdev_torch.nonlinear.values import Values
from gtsam_petercdev_torch.sfm.bal import SfmCamera
from gtsam_petercdev_torch.slam import factors, projection

_LAYOUTS = {"Pose3": Pose3, "SfmCamera": SfmCamera}
_PROJECTION = {
    make().name: make
    for make in (
        projection.general_sfm_factor,
        projection.projection_factor_s2,
        projection.projection_factor_bundler_fixed,
        projection.stereo_factor,
    )
}


def _layout(type_name: str, params):
    """Value params of a manifold type in the port's layout."""
    return _LAYOUTS[type_name](*params) if type_name in _LAYOUTS else params


def factor_type(name: str):
    """FactorType from its name (see the module docstring)."""
    if name in _PROJECTION:
        return _PROJECTION[name]()
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
        if not isinstance(params, dict):  # Prior / Between: a manifold value
            params = _layout(ft.var_types[0], params)
        graph.add_batch(ft, keys, params, sqrt_info)
    return graph

