"""Synthetic Pose3 graphs with the topology of the sphere benchmark.

`sphere_rings(n_rings, n_per_ring)` places n_rings x n_per_ring poses on
latitude rings of a sphere, facing along each ring. Factors:
  - one prior on pose 0;
  - odometry i -> i+1 along the whole sequence (n - 1 factors, ring to ring);
  - one between-factor from each pose to the same pose on the previous ring
    ((n_rings - 1) * n_per_ring factors).
At 50 x 50 that is 2,500 poses and 2,499 + 2,450 = 4,949 between factors,
the size and factor count of sphere2500. Measurements are the true relative
poses perturbed by Exp(noise); initial values are the truth perturbed the
same way (pose 0 exact). Everything comes from one numpy seed and is
returned as numpy arrays in the `utils/convert.py` format, so the JAX
package and the port can be fed the same data.
"""

from __future__ import annotations

import numpy as np
import torch

from gtsam_petercdev_torch.geometry import pose3


def _exp_np(xi: np.ndarray):
    p = pose3.expmap(torch.from_numpy(xi))
    return p.R.numpy(), p.t.numpy()


def _compose_np(a, b):
    p = pose3.compose(pose3.Pose3(*map(torch.from_numpy, a)), pose3.Pose3(*map(torch.from_numpy, b)))
    return p.R.numpy(), p.t.numpy()


def _between_np(a, b):
    p = pose3.between(pose3.Pose3(*map(torch.from_numpy, a)), pose3.Pose3(*map(torch.from_numpy, b)))
    return p.R.numpy(), p.t.numpy()


def sphere_rings(
    n_rings: int = 50,
    n_per_ring: int = 50,
    seed: int = 0,
    rot_sigma: float = 0.01,
    trans_sigma: float = 0.05,
    init_rot_sigma: float = 0.05,
    init_trans_sigma: float = 0.1,
):
    """Returns (values_arrays, factor_arrays) in float64 numpy."""
    rng = np.random.default_rng(seed)
    n = n_rings * n_per_ring
    radius = n_per_ring / (2.0 * np.pi)
    r_idx, k_idx = np.divmod(np.arange(n), n_per_ring)
    lat = -0.5 * np.pi + np.pi * (r_idx + 1) / (n_rings + 1)
    lon = 2.0 * np.pi * k_idx / n_per_ring
    pos = radius * np.stack(
        [np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)], axis=1
    )
    # frame: x along the ring, z outward, y = z x x
    x_ax = np.stack([-np.sin(lon), np.cos(lon), np.zeros(n)], axis=1)
    z_ax = pos / radius
    y_ax = np.cross(z_ax, x_ax)
    gt = (np.stack([x_ax, y_ax, z_ax], axis=2), pos)

    sigmas = np.array([rot_sigma] * 3 + [trans_sigma] * 3)
    a = np.concatenate([np.arange(n - 1), np.arange(n - n_per_ring)])
    b = np.concatenate([np.arange(1, n), np.arange(n_per_ring, n)])
    meas = _between_np((gt[0][a], gt[1][a]), (gt[0][b], gt[1][b]))
    meas = _compose_np(meas, _exp_np(rng.normal(size=(len(a), 6)) * sigmas))

    init_sig = np.array([init_rot_sigma] * 3 + [init_trans_sigma] * 3)
    xi0 = rng.normal(size=(n, 6)) * init_sig
    xi0[0] = 0.0
    init = _compose_np(gt, _exp_np(xi0))

    keys = np.arange(n, dtype=np.int64)
    info = np.broadcast_to(np.diag(1.0 / sigmas), (len(a), 6, 6)).copy()
    prior_info = np.diag([1e3] * 3 + [1e2] * 3)[None].copy()
    values = {"Pose3": (keys, init)}
    factors = [
        ("PriorPose3", keys[:1, None], (gt[0][:1], gt[1][:1]), prior_info),
        ("BetweenPose3", np.stack([a, b], axis=1), meas, info),
    ]
    return values, factors
