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
"""

from __future__ import annotations

import numpy as np

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
