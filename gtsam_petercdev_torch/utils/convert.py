"""Build the port's Values and NonlinearFactorGraph from numpy arrays.

The carry-across format is plain numpy, so the same arrays can feed the JAX
package and the port (the JAX side keeps its factor data as numpy already):

  values:  {type_name: (keys [N], params)}           params: [N, dim] for
           vector-like types, (R [N,3,3], t [N,3]) for Pose3
  factors: [(factor_type_name, keys [N, K], params, sqrt_info [N, d, d])]
           factor_type_name is "Prior<Type>" or "Between<Type>"
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from gtsam_petercdev_torch.device import DeviceLike
from gtsam_petercdev_torch.geometry.pose3 import Pose3
from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph
from gtsam_petercdev_torch.nonlinear.values import Values
from gtsam_petercdev_torch.slam.factors import factor_type


def _layout(type_name: str, params):
    return Pose3(*params) if type_name == "Pose3" else params


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
        graph.add_batch(ft, keys, _layout(ft.var_types[0], params), sqrt_info)
    return graph

