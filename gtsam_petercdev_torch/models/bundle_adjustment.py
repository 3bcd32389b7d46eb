"""Flagship bundle-adjustment pipeline (reference: examples/SFMExample_bal.cpp).

Port of gtsam_petercdev_tpu/models/bundle_adjustment.py. build_ba_graph
replicates the reference recipe exactly: one GeneralSFMFactor per
observation with Isotropic(2, 1.0) pixel noise, an Isotropic(9, 0.1) prior
on the first camera and Isotropic(3, 0.1) on the first landmark
(SFMExample_bal.cpp:53-69).

`ba_arrays` gives the same problem as numpy arrays in the `utils/convert.py`
format, so it can be carried to another package; `build_ba_graph` is
`convert` applied to them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from gtsam_petercdev_torch.core.keys import symbol
from gtsam_petercdev_torch.device import DeviceLike
from gtsam_petercdev_torch.linear import noise
from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph
from gtsam_petercdev_torch.nonlinear.optimizers import (
    LMParams,
    OptimizerResult,
    levenberg_marquardt,
)
from gtsam_petercdev_torch.nonlinear.values import Values
from gtsam_petercdev_torch.sfm.bal import SfmData
from gtsam_petercdev_torch.utils import convert


def C(i: int) -> int:
    return symbol("c", i)


def P(j: int) -> int:
    return symbol("p", j)


def ba_arrays(data: SfmData, pixel_sigma: float = 1.0):
    """(values_arrays, factor_arrays) of the BA problem, float64 numpy."""
    n_cams, n_pts = data.n_cameras, data.n_tracks
    cam_keys = np.asarray([C(i) for i in range(n_cams)], dtype=np.uint64)
    pt_keys = np.asarray([P(j) for j in range(n_pts)], dtype=np.uint64)
    f64 = lambda a: np.asarray(a, dtype=np.float64)
    cams = tuple(
        np.stack([f64(getattr(c, leaf)) for c in data.cameras]) for leaf in ("R", "t", "cal")
    )
    points = np.stack([f64(tr.point) for tr in data.tracks])
    values = {"SfmCamera": (cam_keys, cams), "Point3": (pt_keys, points)}

    obs_cam = np.concatenate([np.asarray(tr.cam_idx, dtype=np.int64) for tr in data.tracks])
    obs_pt = np.repeat(np.arange(n_pts), [len(tr.cam_idx) for tr in data.tracks])
    uvs = np.concatenate([f64(tr.uv).reshape(-1, 2) for tr in data.tracks])
    keys = np.stack([cam_keys[obs_cam], pt_keys[obs_pt]], axis=1)
    n_obs = len(obs_cam)
    iso = lambda dim, sigma, n: np.broadcast_to(
        noise.isotropic(dim, sigma, np.float64), (n, dim, dim)
    ).copy()
    factors = [
        ("GeneralSFMFactor", keys, {"uv": uvs}, iso(2, pixel_sigma, n_obs)),
        ("PriorSfmCamera", cam_keys[:1, None], tuple(a[:1] for a in cams), iso(9, 0.1, 1)),
        ("PriorPoint3", pt_keys[:1, None], points[:1], iso(3, 0.1, 1)),
    ]
    return values, factors


def build_ba_graph(
    data: SfmData,
    pixel_sigma: float = 1.0,
    dtype=None,
    *,
    device: DeviceLike = "cuda",
) -> Tuple[NonlinearFactorGraph, Values]:
    """Graph and initial Values on `device` in `dtype` (default float64)."""
    values_arrays, factor_arrays = ba_arrays(data, pixel_sigma)
    graph = convert.graph_from_arrays(factor_arrays, device=device, dtype=dtype)
    values = convert.values_from_arrays(values_arrays, device=device, dtype=dtype)
    return graph, values


def optimize_ba(
    data: SfmData,
    params: Optional[LMParams] = None,
    dtype=None,
    *,
    device: DeviceLike = "cuda",
) -> OptimizerResult:
    graph, values = build_ba_graph(data, dtype=dtype, device=device)
    return levenberg_marquardt(graph, values, params or LMParams(), device=device)
