"""Synthetic BAL-scale bundle-adjustment problems.

Port of gtsam_petercdev_tpu/models/ba_synth.py. The reference ships only
3-camera BAL fixtures, so throughput numbers measured on them are pure
dispatch latency. This generator builds a production-scale rig — cameras
on a ring looking inward, points in the interior, each observed by several
nearby cameras — in the exact SfmData layout of sfm/bal.py, for
benchmarking the Schur and multifrontal LM paths (reference harness:
timing/timeSFMBAL*.cpp, CameraSet Schur kernels
gtsam/geometry/CameraSet.h:175-241).

The generator is numpy with `default_rng(seed)` and draws in the JAX
package's order, so the same arguments give bit-identical arrays.
`smart_scene` and `smart_rig` give the smart-factor (structureless) form
of such a rig.
"""

from __future__ import annotations

import numpy as np
import torch

from gtsam_petercdev_torch.geometry import pose3
from gtsam_petercdev_torch.geometry.pose3 import Pose3
from gtsam_petercdev_torch.sfm.bal import SfmCamera, SfmData, SfmTrack


def make_synthetic_ba(
    n_cams: int = 1000,
    n_points: int = 100_000,
    obs_per_point: int = 5,
    pixel_noise: float = 1.0,
    seed: int = 0,
    dtype=np.float32,
) -> SfmData:
    """Cameras on a ring of radius 20 at mixed heights, looking at the
    origin; points uniform in a radius-8 ball; each point observed by
    `obs_per_point` consecutive cameras of a random arc (locality makes the
    camera graph sparse, like a real survey)."""
    dtype = np.dtype(dtype)
    rng = np.random.default_rng(seed)
    thetas = 2 * np.pi * np.arange(n_cams) / n_cams
    centers = np.stack(
        [20 * np.cos(thetas), 20 * np.sin(thetas), 2 * np.sin(5 * thetas)],
        axis=1,
    )
    # camera-to-world rotation: z-axis towards origin (gtsam convention:
    # camera looks along +z), x right, y down-ish
    z = -centers / np.linalg.norm(centers, axis=1, keepdims=True)
    up = np.broadcast_to(np.array([0.0, 0.0, -1.0]), z.shape)
    x = np.cross(up, z)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=2)  # columns are camera axes in world

    f, k1, k2 = 500.0, 0.0, 0.0
    cal = np.asarray([f, k1, k2], dtype=dtype)
    cameras = [
        SfmCamera(R[i].astype(dtype), centers[i].astype(dtype), cal.copy())
        for i in range(n_cams)
    ]

    pts = rng.uniform(-8, 8, size=(n_points, 3))
    # vectorized projection of each (point, camera) pair
    start = rng.integers(0, n_cams, size=n_points)
    cam_idx = (start[:, None] + np.arange(obs_per_point)[None, :]) % n_cams
    Rc = R[cam_idx]  # [P, M, 3, 3]
    cc = centers[cam_idx]
    # world -> camera: p_c = R^T (p - c)
    rel = pts[:, None, :] - cc
    pc = np.einsum("pmij,pmi->pmj", Rc, rel)
    uv = pc[..., :2] / pc[..., 2:3] * f
    uv += rng.normal(scale=pixel_noise, size=uv.shape)
    assert (pc[..., 2] > 0).all(), "point behind camera in synthetic rig"

    # perturbed initial points: one draw of 3 per track, in track order
    init = pts + rng.normal(scale=0.05, size=(n_points, 3))
    uv = uv.astype(dtype)
    tracks = [
        SfmTrack(point=init[j], cam_idx=cam_idx[j].astype(np.int64), uv=uv[j])
        for j in range(n_points)
    ]
    return SfmData(cameras=cameras, tracks=tracks)


SMART_CAL = (500.0, 500.0, 0.0, 0.0, 0.0)  # Cal3_S2 of the rig: f = 500, k1 = k2 = 0


def smart_scene(data: SfmData, seed: int = 1, pose_sigma: float = 0.01):
    """A `make_synthetic_ba` problem in smart-factor form, as numpy.

    Its camera looks along +z with f = 500 and no distortion, so its
    observations are exactly those of Cal3_S2 `SMART_CAL`; each track is
    (cam_idx, uv) of one point. Cameras 2 onward start from their pose
    retracted by xi ~ N(0, pose_sigma^2) per component (one draw of
    [n_cams, 6] from `default_rng(seed)`, rows 0 and 1 unused: those two
    cameras get priors at their true poses).

    Returns dict(cam_rows [T, M] int32, measured [T, M, 2], R / t [n_cams, 3, 3]
    / [n_cams, 3] the true poses, R0 / t0 the initial poses), float64."""
    R = np.stack([np.asarray(c.R, dtype=np.float64) for c in data.cameras])
    t = np.stack([np.asarray(c.t, dtype=np.float64) for c in data.cameras])
    xi = np.random.default_rng(seed).normal(scale=pose_sigma, size=(len(R), 6))
    xi[:2] = 0.0
    p0 = pose3.retract(Pose3(torch.as_tensor(R), torch.as_tensor(t)), torch.as_tensor(xi))
    return dict(
        cam_rows=np.stack([np.asarray(tr.cam_idx) for tr in data.tracks]).astype(np.int32),
        measured=np.stack([np.asarray(tr.uv, dtype=np.float64) for tr in data.tracks]),
        R=R, t=t, R0=p0.R.numpy(), t0=p0.t.numpy())


def smart_rig(n_cams: int = 20, n_tracks: int = 500, seed: int = 0):
    """A small ragged smart-factor rig: the ring of `make_synthetic_ba`
    (n_cams cameras, f = 500), tracks of 2-6 consecutive views with
    1-pixel noise, plus one track behind cameras 0 and 1 (its two rays
    meet behind them: BEHIND_CAMERA) and one track of a single view
    (DEGENERATE). Returns dict(cam_rows, mask, measured, R, t, R0, t0) as
    `smart_scene` does, views past a track's count masked."""
    data = make_synthetic_ba(n_cams, 1, 2, seed=seed, dtype=np.float64)
    R = np.stack([c.R for c in data.cameras])
    t = np.stack([c.t for c in data.cameras])
    rng = np.random.default_rng(seed)
    f, M = SMART_CAL[0], 6
    T = n_tracks + 2
    cam_rows = np.zeros((T, M), dtype=np.int32)
    mask = np.zeros((T, M), dtype=bool)
    measured = np.zeros((T, M, 2))

    def observe(j, point, cams, noise):
        pc = np.einsum("mij,mi->mj", R[cams], point - t[cams])
        cam_rows[j, : len(cams)] = cams
        mask[j, : len(cams)] = True
        measured[j, : len(cams)] = pc[:, :2] / pc[:, 2:3] * f + noise * rng.normal(
            size=(len(cams), 2))

    for j in range(n_tracks):
        k = int(rng.integers(2, M + 1))
        observe(j, rng.uniform(-8, 8, size=3), (int(rng.integers(n_cams)) + np.arange(k)) % n_cams,
                1.0)
    observe(n_tracks, 1.5 * t[0], np.array([0, 1]), 0.0)  # behind both cameras
    observe(n_tracks + 1, np.zeros(3), np.array([3]), 1.0)  # one view
    xi = rng.normal(scale=0.01, size=(n_cams, 6))
    xi[:2] = 0.0
    p0 = pose3.retract(Pose3(torch.as_tensor(R), torch.as_tensor(t)), torch.as_tensor(xi))
    return dict(cam_rows=cam_rows, mask=mask, measured=measured, R=R, t=t,
                R0=p0.R.numpy(), t0=p0.t.numpy())
