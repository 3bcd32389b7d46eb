"""BAL (Bundle Adjustment in the Large) dataset I/O + the SfmCamera manifold.

Port of gtsam_petercdev_tpu/sfm/bal.py. Mirrors gtsam/sfm/SfmData.{h,cpp}:
  - observations stored per track with v NEGATED (SfmData.cpp:209)
  - camera rotations are BAL/OpenGL Rodrigues vectors, converted to
    camera-to-world poses via openGL2gtsam (SfmData.cpp:79-85):
    wRc = R^T * diag(1,-1,-1), wtc = R^T * (-t)
  - calibration Cal3Bundler (f, k1, k2)

SfmCamera = PinholeCamera<Cal3Bundler>: a 9-dim product manifold
(pose expmap chart on the first 6 coords, vector calibration on the last 3),
registered in the manifold registry when this module is imported.

An `SfmData` is a host-side dataset: its cameras and tracks hold numpy
arrays. `models/bundle_adjustment.build_ba_graph` stacks them and moves them
to the device in one copy per leaf. The file reader is plain Python; the
JAX package's optional C++ tokenizer is not used.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from gtsam_petercdev_torch.core import manifold
from gtsam_petercdev_torch.device import resolve_device
from gtsam_petercdev_torch.geometry import pose3
from gtsam_petercdev_torch.geometry.pose3 import Pose3


class SfmCamera(NamedTuple):
    R: object  # [..., 3, 3] camera-to-world rotation
    t: object  # [..., 3]    camera center in world
    cal: object  # [..., 3]  Cal3Bundler (f, k1, k2)


def _sfm_retract(c: SfmCamera, xi) -> SfmCamera:
    p = pose3.retract(Pose3(c.R, c.t), xi[..., :6])
    return SfmCamera(p.R, p.t, c.cal + xi[..., 6:])


def _sfm_local(a: SfmCamera, b: SfmCamera):
    xi = pose3.local(Pose3(a.R, a.t), Pose3(b.R, b.t))
    return torch.cat([xi, b.cal - a.cal], dim=-1)


def _sfm_identity(dtype=torch.float64, device="cuda"):
    dev = resolve_device(device)
    return SfmCamera(
        torch.eye(3, dtype=dtype, device=dev),
        torch.zeros(3, dtype=dtype, device=dev),
        torch.zeros(3, dtype=dtype, device=dev),
    )


SFM_CAMERA = manifold.register(
    manifold.ManifoldType(
        name="SfmCamera",
        dim=9,
        retract=_sfm_retract,
        local=_sfm_local,
        identity=_sfm_identity,
    )
)


class SfmTrack(NamedTuple):
    point: np.ndarray  # [3]
    cam_idx: np.ndarray  # [M] camera indices
    uv: np.ndarray  # [M, 2] measurements (v negated per reference)


class SfmData(NamedTuple):
    cameras: List[SfmCamera]  # numpy leaves
    tracks: List[SfmTrack]

    @property
    def n_cameras(self):
        return len(self.cameras)

    @property
    def n_tracks(self):
        return len(self.tracks)


def _np_rodrigues(w: np.ndarray) -> np.ndarray:
    """Pure-numpy SO(3) exp (host-side)."""
    th = np.linalg.norm(w)
    if th < 1e-12:
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        return np.eye(3) + K
    a = w / th
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _opengl_to_gtsam(w: np.ndarray, t: np.ndarray, dtype):
    """openGL2gtsam (SfmData.cpp:79-85)."""
    R = _np_rodrigues(np.asarray(w, dtype=np.float64))
    R90 = np.diag([1.0, -1.0, -1.0])
    wRc = R.T @ R90
    wtc = R.T @ (-t)
    return wRc.astype(dtype), wtc.astype(dtype)


def read_bal(path: str, dtype=np.float64) -> SfmData:
    """SfmData::FromBalFile (SfmData.cpp:189)."""
    dtype = np.dtype(dtype)
    with open(path) as f:
        it = iter(f.read().split())

    n_cams, n_pts, n_obs = int(next(it)), int(next(it)), int(next(it))
    obs_cam = [[] for _ in range(n_pts)]
    obs_uv = [[] for _ in range(n_pts)]
    for _ in range(n_obs):
        i, j = int(next(it)), int(next(it))
        u, v = float(next(it)), float(next(it))
        obs_cam[j].append(i)
        obs_uv[j].append((u, -v))  # negate v (SfmData.cpp:209)

    cameras = []
    for _ in range(n_cams):
        p9 = np.array([float(next(it)) for _ in range(9)])
        R, c = _opengl_to_gtsam(p9[:3], p9[3:6], dtype)
        cameras.append(SfmCamera(R, c, p9[6:9].astype(dtype)))

    tracks = []
    for j in range(n_pts):
        p = np.array([float(next(it)) for _ in range(3)], dtype=dtype)
        tracks.append(
            SfmTrack(
                point=p,
                cam_idx=np.asarray(obs_cam[j], dtype=np.int64),
                uv=np.asarray(obs_uv[j], dtype=dtype).reshape(-1, 2),
            )
        )
    return SfmData(cameras=cameras, tracks=tracks)
