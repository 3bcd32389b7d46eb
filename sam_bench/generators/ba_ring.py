"""A BAL-model bundle adjustment rig: cameras on a ring, points inside it,
at the counts of a named BAL problem.

`rig` is a frozen copy of the port's `models/ba_synth.make_synthetic_ba` (float64)
and `models/bundle_adjustment.ba_arrays`: the same numpy draws in the same
order, so a seed gives the port's own rig. Cameras are SfmCamera
(PinholeCamera<Cal3Bundler>: camera-to-world R, centre t, f / k1 / k2), one
GeneralSFMFactor per observation with Isotropic(2, pixel_sigma), an
Isotropic(9, 0.1) prior on camera 0 and Isotropic(3, 0.1) on point 0
(SFMExample_bal.cpp's recipe). `sam_bench/tests` holds the copy equal to
the port's generator.

`make` takes the counts from the configuration: n_cameras, n_points and
n_observations. Every point is seen by obs_per_point = n_observations //
n_points consecutive cameras of a random arc, and n_observations mod
n_points of them, drawn from the data seed, by the next camera too: the
rig is drawn with one view more, and the others drop their last.
"""

from __future__ import annotations

import numpy as np

from sam_bench.generators.problem import Problem

RING_RADIUS = 20.0
HEIGHT_AMPLITUDE = 2.0
POINT_HALF_WIDTH = 8.0
FOCAL = 500.0
POINT_INIT_SIGMA = 0.05
_INDEX_BITS = 56  # gtsam::Symbol: the character above 56 index bits


def symbol(c: str, j) -> np.ndarray:
    return (np.uint64(ord(c)) << np.uint64(_INDEX_BITS)) | np.asarray(j, dtype=np.uint64)


def rig(n_cams: int, n_points: int, obs_per_point: int, pixel_noise: float, seed: int):
    """(R [C, 3, 3], centres [C, 3], cal [C, 3], start points [P, 3],
    cam_idx [P, M], uv [P, M, 2]), float64, from numpy's default_rng(seed)."""
    rng = np.random.default_rng(seed)
    thetas = 2 * np.pi * np.arange(n_cams) / n_cams
    centers = np.stack([RING_RADIUS * np.cos(thetas), RING_RADIUS * np.sin(thetas),
                        HEIGHT_AMPLITUDE * np.sin(5 * thetas)], axis=1)
    # camera-to-world rotation: z towards the origin, x right, y down-ish
    z = -centers / np.linalg.norm(centers, axis=1, keepdims=True)
    up = np.broadcast_to(np.array([0.0, 0.0, -1.0]), z.shape)
    x = np.cross(up, z)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=2)
    cal = np.broadcast_to(np.array([FOCAL, 0.0, 0.0]), (n_cams, 3)).copy()

    pts = rng.uniform(-POINT_HALF_WIDTH, POINT_HALF_WIDTH, size=(n_points, 3))
    start = rng.integers(0, n_cams, size=n_points)
    cam_idx = (start[:, None] + np.arange(obs_per_point)[None, :]) % n_cams
    pc = np.einsum("pmij,pmi->pmj", R[cam_idx], pts[:, None, :] - centers[cam_idx])
    if not (pc[..., 2] > 0).all():
        raise ValueError("ba_ring: a point lies behind a camera")
    uv = pc[..., :2] / pc[..., 2:3] * FOCAL
    uv += rng.normal(scale=pixel_noise, size=uv.shape)
    init = pts + rng.normal(scale=POINT_INIT_SIGMA, size=(n_points, 3))
    return R, centers, cal, init, cam_idx.astype(np.int64), uv


def track_lengths(n_points: int, n_observations: int, seed: int) -> np.ndarray:
    """Views of each rig point: obs_per_point, and one more for
    n_observations mod n_points points drawn from `seed`."""
    base, extra = divmod(int(n_observations), int(n_points))
    if base < 2:
        raise ValueError("ba_ring: every point needs two views")
    lengths = np.full(n_points, base, dtype=np.int64)
    lengths[np.random.default_rng([int(seed), 1]).permutation(n_points)[:extra]] += 1
    return lengths


def make(config: dict, seed: int) -> Problem:
    """The rig of `config["data_seed"]` with its points relabelled by a
    permutation drawn from `seed`: every seed gives the same problem, so the
    same LM work (its trials per iteration follow the data), in another
    order. The point prior stays on the rig's point 0, wherever it lands.
    Observations are listed point by point, each point's in ring order."""
    n_cams, n_pts = int(config["n_cameras"]), int(config["n_points"])
    lengths = track_lengths(n_pts, config["n_observations"], config["data_seed"])
    R, t, cal, points, cam_idx, uv = rig(n_cams, n_pts, int(lengths.max()),
                                         config["pixel_noise"], config["data_seed"])
    seen = np.arange(cam_idx.shape[1])[None, :] < lengths[:, None]
    perm = np.random.default_rng(seed).permutation(n_pts)  # new point j = rig point perm[j]
    points, cam_idx, uv, seen = points[perm], cam_idx[perm], uv[perm], seen[perm]
    pp = int(np.argsort(perm)[0])
    sigma = float(config["pixel_sigma"])
    prior_sigma = float(config["prior_sigma"])
    cam_keys = symbol("c", np.arange(n_cams))
    pt_keys = symbol("p", np.arange(n_pts))
    obs_cam = cam_idx[seen]
    obs_pt = np.repeat(np.arange(n_pts), seen.sum(1))
    uvs = uv[seen]
    n_obs = len(obs_cam)
    iso = lambda dim, s, n: np.broadcast_to(np.eye(dim) / s, (n, dim, dim)).copy()
    values = {"SfmCamera": (cam_keys, (R, t, cal)), "Point3": (pt_keys, points)}
    factors = [
        ("GeneralSFMFactor", np.stack([cam_keys[obs_cam], pt_keys[obs_pt]], axis=1),
         {"uv": uvs}, iso(2, sigma, n_obs)),
        ("PriorSfmCamera", cam_keys[:1, None], (R[:1], t[:1], cal[:1]), iso(9, prior_sigma, 1)),
        ("PriorPoint3", pt_keys[pp:pp + 1, None], points[pp:pp + 1], iso(3, prior_sigma, 1)),
    ]
    arrays = dict(R=R, t=t, cal=cal, points=points, obs_cam=obs_cam, obs_pt=obs_pt, uv=uvs,
                  prior_point=np.int64(pp), pixel_sigma=np.float64(sigma),
                  prior_sigma=np.float64(prior_sigma))
    return Problem(values, factors, arrays)
