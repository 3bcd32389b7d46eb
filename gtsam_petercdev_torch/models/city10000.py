"""City10000 incremental SLAM harness — the reference's headline iSAM2
benchmark (examples/ISAM2_City10000.cpp:60-160, examples/City10000.h:37-98).

Port of gtsam_petercdev_tpu/models/city10000.py. Per dataset line
`EDGE2 keyS _ keyT _ numMeas x y rad [...]`:
  * keyT == keyS+1: odometry — insert the new pose initialized from the
    current estimate of keyS composed with the measurement, add a
    BetweenFactor, and run one ISAM2 update.
  * otherwise: loop closure — add the BetweenFactor, run one update.

Reference semantics mirrored exactly (ISAM2_City10000.cpp:100-130,
City10000.h:30-35):
  * prior sigmas 1e-4; ODOMETRY sigmas (1/30, 1/30, 1/100);
  * LOOP-CLOSURE factors use sigmas (10, 10, 10) — the harness's
    non-ambiguity branch always takes the weak-noise model;
  * `max_loops` counts LOOP lines only (reference maxLoopCount, default
    2000 at ISAM2_City10000.cpp:49);
  * wildfire_threshold 0.0 = ISAM2GaussNewtonParams(0.0).

The whole loop runs on `device` (default "cuda"): the pose prediction is a
device gather and compose, so an odometry step reads nothing back but what
the engine reads. Engine checkpoints (`checkpoint_path`) wait for
utils/serialization.py (ROADMAP.md) and raise.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from gtsam_petercdev_torch.device import DeviceLike, resolve_device
from gtsam_petercdev_torch.geometry import pose2
from gtsam_petercdev_torch.linear import noise
from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph
from gtsam_petercdev_torch.nonlinear.isam2 import ISAM2, ISAM2Params, ISAM2Result
from gtsam_petercdev_torch.nonlinear.values import Values
from gtsam_petercdev_torch.slam.factors import between_factor, prior_factor


def parse_city10000(path: str, max_lines: Optional[int] = None):
    """-> list of (keyS, keyT, [measurements (x, y, theta)])."""
    out = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0] != "EDGE2":
                continue
            keyS, keyT = int(parts[1]), int(parts[3])
            n_meas = int(parts[5])
            meas = [(float(parts[6 + 3 * i]), float(parts[7 + 3 * i]), float(parts[8 + 3 * i]))
                    for i in range(n_meas)]
            out.append((keyS, keyT, meas))
            if max_lines is not None and len(out) >= max_lines:
                break
    return out


@dataclass
class CityResult:
    estimate: np.ndarray  # [n_poses, 3]
    step_times: List[float] = field(default_factory=list)
    n_poses: int = 0
    n_loop_closures: int = 0
    total_time: float = 0.0
    updates: List[ISAM2Result] = field(default_factory=list)  # one per line

    def ate_rmse(self, gt: np.ndarray) -> float:
        n = min(self.n_poses, gt.shape[0])
        d = self.estimate[:n, :2] - gt[:n, :2]
        return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))


def run_city10000(
    path: str,
    max_steps: Optional[int] = None,
    max_loops: Optional[int] = None,
    wildfire_threshold: float = 0.0,
    relinearize_threshold: float = 0.01,
    relinearize_skip: int = 1,
    dtype=torch.float64,
    device: DeviceLike = "cuda",
    progress_every: int = 0,
    partial_cb: Optional[Callable[[CityResult], None]] = None,
    checkpoint_path: Optional[str] = None,
    step_cb: Optional[Callable[[int, ISAM2], None]] = None,
) -> CityResult:
    """Run the harness over the file's lines. partial_cb gets a CityResult
    every `progress_every` updates; step_cb(k, isam) runs just before the
    k-th line's update (k from 0; a profiler window's hook)."""
    if checkpoint_path is not None:
        raise NotImplementedError(
            "run_city10000(checkpoint_path=...): engine checkpoints wait for "
            "utils/serialization.py (ROADMAP.md)")
    dev = resolve_device(device)
    # noise models uploaded once (an upload per factor would wait for the card)
    sig = lambda s: torch.tensor(noise.diagonal_sigmas(np.asarray(s)), dtype=dtype).to(dev)
    prior_sig = sig([1e-4, 1e-4, 1e-4])
    pose_sig = sig([1.0 / 30.0, 1.0 / 30.0, 1.0 / 100.0])
    # loop closures always take the reference harness's weak-noise branch
    # (ISAM2_City10000.cpp:118-124, isWithAmbiguity=false)
    loop_sig = sig([10.0] * 3)

    isam = ISAM2(ISAM2Params(relinearize_threshold=relinearize_threshold,
                             relinearize_skip=relinearize_skip,
                             wildfire_threshold=wildfire_threshold, device=dev, dtype=dtype))
    new = lambda: (NonlinearFactorGraph(device=dev, dtype=dtype), Values(device=dev, dtype=dtype))
    nf, nv = new()
    origin = torch.zeros(3, dtype=dtype, device=dev)
    nv.insert(0, "Pose2", origin)
    nf.add(prior_factor("Pose2"), [0], origin, prior_sig)
    isam.update(nf, nv)

    lines = parse_city10000(path, max_steps)
    res = CityResult(estimate=None, n_poses=1)
    t_start = time.perf_counter()
    for (keyS, keyT, meas) in lines:
        if max_loops is not None and res.n_loop_closures >= max_loops:
            break
        odom = torch.tensor(meas[0], dtype=dtype).to(dev, non_blocking=True)
        nf, nv = new()
        if keyS == keyT - 1:  # new pose
            nv.insert(keyT, "Pose2", pose2.compose(isam.calculate_estimate_key(keyS), odom))
            nf.add(between_factor("Pose2"), [keyS, keyT], odom, pose_sig)
            res.n_poses += 1
        else:  # loop closure
            nf.add(between_factor("Pose2"), [keyS, keyT], odom, loop_sig)
            res.n_loop_closures += 1
        if step_cb is not None:
            step_cb(len(res.step_times), isam)
        t0 = time.perf_counter()
        upd = isam.update(nf, nv)
        res.step_times.append(time.perf_counter() - t0)
        res.updates.append(upd)
        if progress_every and len(res.step_times) % progress_every == 0:
            k = len(res.step_times)
            seg = res.updates[-progress_every:]
            mem = (f" peak device memory {torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB"
                   if dev.type == "cuda" else "")
            print(f"step {k}: poses={res.n_poses} loops={res.n_loop_closures} avg "
                  f"{np.mean(res.step_times[-progress_every:]) * 1e3:.1f} ms/step reelim mean "
                  f"{np.mean([u.n_reeliminated for u in seg]):.0f} max "
                  f"{max(u.n_reeliminated for u in seg)}{mem}", flush=True)
            if partial_cb is not None:
                res.estimate = _poses(isam, res.n_poses)
                res.total_time = time.perf_counter() - t_start
                partial_cb(res)
    res.total_time = time.perf_counter() - t_start
    res.estimate = _poses(isam, res.n_poses)
    return res


def _poses(isam: ISAM2, n_poses: int) -> np.ndarray:
    """The current estimate of poses 0 .. n_poses - 1 as numpy [n, 3]."""
    est = isam.calculate_estimate()
    rows = np.asarray([est.row_of(i) for i in range(n_poses)], dtype=np.int64)
    return est.params("Pose2").cpu().numpy()[rows]


def load_city_gt(path: str) -> np.ndarray:
    """ISAM2_GT_city10000.txt: x y theta per line."""
    return np.loadtxt(path)
