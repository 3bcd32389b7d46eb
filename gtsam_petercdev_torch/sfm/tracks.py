"""DsfTrackGenerator: feature tracks from pairwise matches via union-find.

Reference: gtsam/sfm/DsfTrackGenerator.{h,cpp}:72 — merge (image, keypoint)
measurements connected by pairwise matches with a DSF, emit one track per
component, and DROP tracks that are inconsistent (two different keypoints
from the same image in one component — triangulation would be ill-posed).

Host-side numpy: track generation is data plumbing that runs once per
dataset, feeding the smart-factor / BA batches. Port of
gtsam_petercdev_tpu/sfm/tracks.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from gtsam_petercdev_torch.utils.dsf import DSFVector


@dataclass
class SfmTrack2d:
    """One track: measurements [(camera index, uv [2])] (SfmTrack2d.h)."""

    measurements: List[Tuple[int, np.ndarray]]

    @property
    def n_measurements(self) -> int:
        return len(self.measurements)


def tracks_from_pairwise_matches(
    keypoints: Sequence[np.ndarray],
    matches: Dict[Tuple[int, int], np.ndarray],
    verbose: bool = False,
) -> List[SfmTrack2d]:
    """keypoints[i]: [Ni, 2] per image; matches[(i, j)]: [M, 2] index pairs
    (k_i, k_j). Returns consistent tracks with >= 2 views."""
    # global id per (image, keypoint)
    offsets = np.cumsum([0] + [kp.shape[0] for kp in keypoints])

    def gid(img, k):
        return int(offsets[img] + k)

    dsf = DSFVector(int(offsets[-1]))
    for (i, j), m in matches.items():
        for (ki, kj) in np.asarray(m, dtype=np.int64):
            dsf.union(gid(i, int(ki)), gid(j, int(kj)))

    comps: Dict[int, List[Tuple[int, int]]] = {}
    for img in range(len(keypoints)):
        for k in range(keypoints[img].shape[0]):
            g = gid(img, k)
            root = dsf.find(g)
            comps.setdefault(root, []).append((img, k))

    tracks: List[SfmTrack2d] = []
    n_dropped = 0
    for members in comps.values():
        if len(members) < 2:
            continue
        imgs = [im for (im, _) in members]
        if len(set(imgs)) != len(imgs):
            n_dropped += 1  # inconsistent: duplicate image in one track
            continue
        tracks.append(
            SfmTrack2d(
                [(im, np.asarray(keypoints[im][k])) for (im, k) in members]
            )
        )
    if verbose and n_dropped:
        print(f"DsfTrackGenerator: dropped {n_dropped} inconsistent tracks")
    return tracks
