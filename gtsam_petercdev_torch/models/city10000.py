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
the engine reads. `checkpoint_path` saves the whole ISAM2 at every progress
tick (utils/serialization.save_isam2, as the JAX harness does);
`resume_from` continues a run from such a file.

`run_city10000_fixed_lag` feeds the same lines to an
IncrementalFixedLagSmoother (timestamps = pose index): the windowed use of
the stream, in which a loop closure to a pose already marginalized is
dropped before its update (ISAM2 refuses a factor on a marginalized key).
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
from gtsam_petercdev_torch.nonlinear.fixed_lag import IncrementalFixedLagSmoother
from gtsam_petercdev_torch.nonlinear.isam2 import (
    ISAM2, ISAM2Params, ISAM2Result, check_engine_backend)
from gtsam_petercdev_torch.nonlinear.values import Values
from gtsam_petercdev_torch.slam.factors import between_factor, prior_factor
from gtsam_petercdev_torch.utils import serialization


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
    resume_from: Optional[str] = None,
    engine_backend: str = "torch",
) -> CityResult:
    """Run the harness over the file's lines. partial_cb gets a CityResult
    every `progress_every` updates, and the ISAM2 is saved to
    `checkpoint_path` then; step_cb(k, isam) runs just before the k-th
    line's update (k from 0; a profiler window's hook). `resume_from`: an
    ISAM2 checkpoint of a run of the same file, loaded onto `device`; the
    run continues after the lines it holds (its updates, less the prior's),
    with the other arguments as that run had them. `engine_backend`: as
    ISAM2Params' ("numpy", the host engine, needs device="cpu" and float64,
    else ValueError)."""
    check_engine_backend(engine_backend, device, dtype)
    dev = resolve_device(device)
    sigs = _noise_models(dtype, dev)
    new = lambda: (NonlinearFactorGraph(device=dev, dtype=dtype), Values(device=dev, dtype=dtype))
    lines = parse_city10000(path, max_steps)
    res = CityResult(estimate=None, n_poses=1)
    if resume_from is not None:
        isam = serialization.load_isam2(resume_from, device=dev)
        done = isam._update_count - 1  # lines in the checkpoint
        res.n_poses = len(isam._gid_key)
        res.n_loop_closures = done - (res.n_poses - 1)
        lines = lines[done:]
    else:
        isam = ISAM2(ISAM2Params(relinearize_threshold=relinearize_threshold,
                                 relinearize_skip=relinearize_skip,
                                 wildfire_threshold=wildfire_threshold, device=dev, dtype=dtype,
                                 engine_backend=engine_backend))
        isam.update(*_prior(new(), sigs[0]))

    t_start = time.perf_counter()
    for (keyS, keyT, meas) in lines:
        if max_loops is not None and res.n_loop_closures >= max_loops:
            break
        nf, nv, pose = _line_factors(keyS, keyT, meas, isam.calculate_estimate_key, sigs, new)
        if pose is not None:
            res.n_poses += 1
        else:
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
            if checkpoint_path is not None:
                serialization.save_isam2(checkpoint_path, isam)
            if partial_cb is not None:
                res.estimate = _poses(isam, res.n_poses)
                res.total_time = time.perf_counter() - t_start
                partial_cb(res)
    res.total_time = time.perf_counter() - t_start
    res.estimate = _poses(isam, res.n_poses)
    return res


def _noise_models(dtype, dev):
    """(prior, odometry, loop closure) square-root informations on the
    device, uploaded once (an upload per factor would wait for the card).
    Loop closures always take the reference harness's weak-noise branch
    (ISAM2_City10000.cpp:118-124, isWithAmbiguity=false)."""
    sig = lambda s: torch.tensor(noise.diagonal_sigmas(np.asarray(s)), dtype=dtype).to(dev)
    return sig([1e-4] * 3), sig([1.0 / 30.0, 1.0 / 30.0, 1.0 / 100.0]), sig([10.0] * 3)


def _prior(graph_values, prior_sig):
    """The first update's (graph, values): pose 0 at the origin and its
    prior, as the reference harness starts."""
    nf, nv = graph_values
    origin = torch.zeros(3, dtype=prior_sig.dtype, device=prior_sig.device)
    nv.insert(0, "Pose2", origin)
    nf.add(prior_factor("Pose2"), [0], origin, prior_sig)
    return nf, nv


def _line_factors(keyS, keyT, meas, estimate_key, sigs, new):
    """One line's (graph, values, new pose key or None). Odometry
    (keyT == keyS + 1) inserts keyT at estimate_key(keyS) composed with the
    measurement under the odometry noise; any other line is a loop closure
    under the weak loop noise."""
    _, pose_sig, loop_sig = sigs
    nf, nv = new()
    odom = torch.tensor(meas[0], dtype=pose_sig.dtype).to(pose_sig.device, non_blocking=True)
    if keyS == keyT - 1:
        nv.insert(keyT, "Pose2", pose2.compose(estimate_key(keyS), odom))
        nf.add(between_factor("Pose2"), [keyS, keyT], odom, pose_sig)
        return nf, nv, keyT
    nf.add(between_factor("Pose2"), [keyS, keyT], odom, loop_sig)
    return nf, nv, None


@dataclass
class FixedLagCityResult:
    keys: List[int]  # the window's pose keys at the end
    estimate: np.ndarray  # [len(keys), 3]
    applied: List[int] = field(default_factory=list)  # indices of the lines fed
    n_poses: int = 0
    n_loop_closures: int = 0  # loop closures fed
    n_dropped: int = 0  # loop closures to a marginalized pose, dropped
    # per update: wall time, keys marginalized, keys deferred, live cliques
    step_times: List[float] = field(default_factory=list)
    marginalized: List[List[int]] = field(default_factory=list)
    deferred: List[List[int]] = field(default_factory=list)
    live_cliques: List[int] = field(default_factory=list)


def run_city10000_fixed_lag(
    path: str,
    lag: float,
    device: DeviceLike = "cuda",
    step_cb: Optional[Callable[[int, IncrementalFixedLagSmoother], None]] = None,
    engine_backend: str = "torch",
) -> FixedLagCityResult:
    """The file's lines through an IncrementalFixedLagSmoother of `lag`
    poses at City10000's parameters (float64, run_city10000's defaults), on
    `device` (default "cuda"). Each update (smoother.update: the ISAM2
    update, then marginalize_leaves of the poses out of the lag) is timed;
    step_cb(k, smoother) runs just before the k-th update fed. `engine_backend`:
    as run_city10000's."""
    check_engine_backend(engine_backend, device)
    dev = resolve_device(device)
    dtype = torch.float64
    sigs = _noise_models(dtype, dev)
    sm = IncrementalFixedLagSmoother(lag, ISAM2Params(
        relinearize_threshold=0.01, relinearize_skip=1, wildfire_threshold=0.0, dtype=dtype,
        engine_backend=engine_backend),
        device=dev)
    new = lambda: (NonlinearFactorGraph(device=dev, dtype=dtype), Values(device=dev, dtype=dtype))
    sm.update(*_prior(new(), sigs[0]), {0: 0.0})

    res = FixedLagCityResult(keys=[], estimate=None, n_poses=1)
    for i, (keyS, keyT, meas) in enumerate(parse_city10000(path)):
        if keyS != keyT - 1 and min(keyS, keyT) in sm.isam._marginalized:
            res.n_dropped += 1
            continue
        nf, nv, pose = _line_factors(keyS, keyT, meas, sm.isam.calculate_estimate_key, sigs, new)
        if pose is not None:
            res.n_poses += 1
        else:
            res.n_loop_closures += 1
        if step_cb is not None:
            step_cb(len(res.step_times), sm)
        t0 = time.perf_counter()
        r = sm.update(nf, nv, None if pose is None else {pose: float(pose)})
        res.step_times.append(time.perf_counter() - t0)
        res.applied.append(i)
        res.marginalized.append(list(r.marginalized))
        res.deferred.append(list(sm._deferred))
        res.live_cliques.append(sm.isam.engine.n_live)
    est = sm.calculate_estimate()
    res.keys = sorted(int(k) for k in est.keys())
    rows = np.asarray([est.row_of(k) for k in res.keys], dtype=np.int64)
    res.estimate = est.params("Pose2").cpu().numpy()[rows]
    return res


def _poses(isam: ISAM2, n_poses: int) -> np.ndarray:
    """The current estimate of poses 0 .. n_poses - 1 as numpy [n, 3]."""
    est = isam.calculate_estimate()
    rows = np.asarray([est.row_of(i) for i in range(n_poses)], dtype=np.int64)
    return est.params("Pose2").cpu().numpy()[rows]


def load_city_gt(path: str) -> np.ndarray:
    """ISAM2_GT_city10000.txt: x y theta per line."""
    return np.loadtxt(path)
