"""Synthetic graphs: Pose3 rings with the topology of the sphere benchmark,
and a City10000-like Pose2 stream (`city_stream`).

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


def pose2_compose_np(a, b):
    """Pose2 a * b on numpy (x, y, theta)."""
    c, s = np.cos(a[2]), np.sin(a[2])
    th = a[2] + b[2]
    return np.array([a[0] + c * b[0] - s * b[1], a[1] + s * b[0] + c * b[1],
                     np.arctan2(np.sin(th), np.cos(th))])


def pose2_between_np(a, b):
    """Pose2 a^-1 * b on numpy (x, y, theta)."""
    c, s = np.cos(a[2]), np.sin(a[2])
    dx, dy = b[0] - a[0], b[1] - a[1]
    th = b[2] - a[2]
    return np.array([c * dx + s * dy, -s * dx + c * dy, np.arctan2(np.sin(th), np.cos(th))])


CITY_SIGMAS = (1.0 / 30.0, 1.0 / 30.0, 1.0 / 100.0)  # the City10000 harness's odometry


def city_stream(n_poses: int, seed: int = 0, side: int = 48, p_turn: float = 0.3):
    """A synthetic City10000-like Pose2 stream: a Manhattan-world walk on a
    unit grid of `side` x `side` cells, from one numpy seed.

    Each step moves one cell along the heading, after turning left or right
    with probability `p_turn` (never back; forced to turn at the grid's
    edge). Pose i's odometry line is the true relative pose from pose i - 1,
    perturbed by N(0, diag(CITY_SIGMAS^2)); whenever the walker reaches a
    cell it has visited before, a loop-closure line to the most recent
    earlier pose in that cell follows, perturbed the same way. At the
    defaults with seed 0, 3,687 poses give 5,714 lines of which 2,028 are
    loop closures: City10000's density (2,000 loops in the first 5,686
    lines, 3,687 poses; CITY10000.md).

    Returns (lines, gt): the lines in the City10000 EDGE2 format that
    `models/city10000.parse_city10000` reads (`EDGE2 keyS 1 keyT 1 1 x y
    theta`; odometry has keyT = keyS + 1), and the true poses [n_poses, 3],
    pose 0 at the origin as the harness's prior puts it."""
    rng = np.random.default_rng(seed)
    heads = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]])
    cell = np.array([side // 2, side // 2])
    h = 0
    gt = [np.array([float(cell[0]), float(cell[1]), 0.0])]
    last_at = {tuple(cell): 0}
    lines = []

    def line(a, b, rel):
        meas = rel + rng.normal(size=3) * CITY_SIGMAS
        meas[2] = np.arctan2(np.sin(meas[2]), np.cos(meas[2]))
        lines.append(f"EDGE2 {a} 1 {b} 1 1 {meas[0]:.9f} {meas[1]:.9f} {meas[2]:.9f}")

    for i in range(1, n_poses):
        u = rng.random()
        turn = -1 if u < p_turn / 2 else (1 if u < p_turn else 0)
        options = [(h + turn) % 4, (h + 1) % 4, (h + 3) % 4]
        for nh in options:
            nxt = cell + heads[nh]
            if 0 <= nxt[0] < side and 0 <= nxt[1] < side:
                h, cell = nh, nxt
                break
        pose = np.array([float(cell[0]), float(cell[1]), np.arctan2(heads[h][1], heads[h][0])])
        line(i - 1, i, pose2_between_np(gt[-1], pose))
        gt.append(pose)
        j = last_at.get(tuple(cell))
        if j is not None:
            line(j, i, pose2_between_np(gt[j], pose))
        last_at[tuple(cell)] = i
    gt = np.stack(gt)
    gt[:, :2] -= gt[0, :2]  # the harness starts at the origin
    return lines, gt
