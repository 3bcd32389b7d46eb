"""Hybrid_City10000 harness — reference semantics on per-hypothesis ISAM2.

Port of gtsam_petercdev_tpu/models/hybrid_city.py. Reference:
examples/Hybrid_City10000.cpp + City10000.h. Semantics mirrored:
  * EVERY loop-closure line becomes a BINARY hybrid factor: component 0 is
    the between measurement under the open-loop model (sigmas 10), component
    1 the same measurement under the pose model (1/30,1/30,1/100)
    (`hybridLoopClosureFactor`, Hybrid_City10000.cpp:71-89); the component
    log-normalizers (negLogConstant, City10000.h:28,35) weight the modes.
  * multi-measurement ODOMETRY lines become hybrid odometry factors: one
    component per measurement candidate under the pose model
    (`hybridOdometryFactor`, :91-104).
  * the smoother carries at most maxNrHypotheses=10 joint hypotheses
    (pruned by posterior), default parameters :52-64.

Each live hypothesis IS a full port ISAM2 (relinearize threshold 0.01, skip
1, wildfire 0.0) holding its own selected measurements, linearization
points and Bayes tree. Hypothesis forks go through the checkpoint
serializer (utils/serialization.isam2_to_bytes / isam2_from_bytes): an
exact state fork. The hypothesis posterior is the Laplace weight the
reference's hybrid elimination computes per leaf:

    log w = log_phi (component normalizers) - E(x*) - 1/2 log det H

with E the nonlinear error at the hypothesis's own estimate and log det H
read off the engine's clique Cholesky diagonals (`_engine_logdet`).

Everything runs on `device` (default "cuda"); `engine_backend="numpy"`
runs each ISAM2 on the host engine (device "cpu").

    python -m gtsam_petercdev_torch.models.hybrid_city --data FILE --steps 2000
"""

from __future__ import annotations

import argparse
import math
import time
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from gtsam_petercdev_torch.device import DeviceLike, resolve_device
from gtsam_petercdev_torch.models.city10000 import parse_city10000


def _neg_log_constant(sigmas: np.ndarray) -> float:
    """noiseModel::Gaussian::negLogConstant: -log(normalizer) =
    0.5*d*log(2*pi) + sum(log sigma)."""
    d = len(sigmas)
    return 0.5 * d * math.log(2.0 * math.pi) + float(np.sum(np.log(sigmas)))


@dataclass
class _Hypothesis:
    isam: object
    log_phi: float = 0.0  # -sum of selected-component negLogConstants
    choices: List[int] = field(default_factory=list)


def _engine_logdet(isam) -> float:
    """2 * sum(log diag(L)) over live cliques (log det of the full Hessian
    at the current linearization point; padded frontal slots hold identity
    pivots and add 0). The card engine's payloads are rows of its class
    pools: each class's live rows are gathered and reduced on the device and
    the classes summed there, one read in all. The host engine's are numpy
    arrays per clique."""
    eng = isam.engine
    if eng._np:
        dg = np.concatenate([np.diagonal(p.L) for p in eng.payloads.values()])
        return 2.0 * float(np.sum(np.log(np.maximum(dg, 1e-300))))
    rows = {}
    for c in eng.cliques:
        if c is not None:
            rows.setdefault(c.cls, []).append(c.row)
    parts = []
    for cls, r in rows.items():
        L = eng.pools[cls].arrays.L
        dg = torch.diagonal(L[torch.as_tensor(r, device=L.device)], dim1=1, dim2=2)
        parts.append(torch.log(torch.clamp(dg, min=1e-300)).sum())
    return 2.0 * float(torch.stack(parts).sum())


def run_hybrid_city(
    path: str,
    max_steps: int = 2000,
    max_hypotheses: int = 10,
    prune_every: int = 1,
    progress: int = 200,
    device: DeviceLike = "cuda",
    engine_backend: str = "torch",
):
    """The harness over the file's first `max_steps` lines. Returns a dict
    of counts, the final posterior, the best hypothesis's choices (per
    hybrid line: the candidate for odometry, 0 open loop / 1 accept for a
    loop closure), per-line wall times, and its trajectory `traj` [poses,
    3]. `updates_per_line`: ISAM2 updates a line, over the run (one per live
    hypothesis); `forks`: hypotheses forked through the serializer."""
    from gtsam_petercdev_torch.geometry import pose2
    from gtsam_petercdev_torch.linear import noise
    from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph
    from gtsam_petercdev_torch.nonlinear.isam2 import ISAM2, ISAM2Params, check_engine_backend
    from gtsam_petercdev_torch.nonlinear.values import Values
    from gtsam_petercdev_torch.slam.factors import between_factor, prior_factor
    from gtsam_petercdev_torch.utils import serialization as ser

    check_engine_backend(engine_backend, device)
    dev = resolve_device(device)
    dt = torch.float64
    tens = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64)).to(dev)
    pose_sigmas = np.asarray([1 / 30.0, 1 / 30.0, 1 / 100.0])
    open_sigmas = np.asarray([10.0, 10.0, 10.0])
    prior_sig = tens(noise.diagonal_sigmas(np.asarray([1e-4] * 3)))
    pose_sig = tens(noise.diagonal_sigmas(pose_sigmas))
    open_sig = tens(noise.diagonal_sigmas(open_sigmas))
    c_pose = _neg_log_constant(pose_sigmas)
    c_open = _neg_log_constant(open_sigmas)
    new = lambda: (NonlinearFactorGraph(device=dev, dtype=dt), Values(device=dev, dtype=dt))
    counts = {"updates": 0, "forks": 0}

    def fresh() -> _Hypothesis:
        isam = ISAM2(ISAM2Params(relinearize_threshold=0.01, relinearize_skip=1,
                                 wildfire_threshold=0.0, device=dev, dtype=dt,
                                 engine_backend=engine_backend))
        nf, nv = new()
        origin = torch.zeros(3, dtype=dt, device=dev)
        nv.insert(0, "Pose2", origin)
        nf.add(prior_factor("Pose2"), [0], origin, prior_sig)
        isam.update(nf, nv)
        return _Hypothesis(isam=isam)

    def fork(h: _Hypothesis) -> _Hypothesis:
        counts["forks"] += 1
        return _Hypothesis(isam=ser.isam2_from_bytes(ser.isam2_to_bytes(h.isam), device=dev),
                           log_phi=h.log_phi, choices=list(h.choices))

    def apply(h: _Hypothesis, keyS, keyT, meas, sig, logc, new_pose: bool):
        nf, nv = new()
        meas = tens(meas)
        if new_pose:
            nv.insert(keyT, "Pose2", pose2.compose(h.isam.calculate_estimate_key(keyS), meas))
        nf.add(between_factor("Pose2"), [keyS, keyT], meas, sig)
        h.isam.update(nf, nv)
        counts["updates"] += 1
        h.log_phi -= logc

    def weights(hyps: List[_Hypothesis]) -> np.ndarray:
        lw = np.asarray([h.log_phi - h.isam.error() - 0.5 * _engine_logdet(h.isam) for h in hyps])
        return lw - (np.log(np.sum(np.exp(lw - lw.max()))) + lw.max())

    lines = parse_city10000(path, max_steps)
    hyps = [fresh()]
    n_modes = 0
    n_poses = 1
    step_times: List[float] = []
    t_all = time.perf_counter()
    for si, (keyS, keyT, meas) in enumerate(lines):
        t0 = time.perf_counter()
        if keyT == keyS + 1:  # odometry
            n_poses += 1
            if len(meas) > 1:  # hybrid odometry: fork per candidate
                n_modes += 1
                children = []
                for h in hyps:
                    kids = [h] + [fork(h) for _ in meas[1:]]
                    for c_i, (kid, m) in enumerate(zip(kids, meas)):
                        apply(kid, keyS, keyT, m, pose_sig, c_pose, True)
                        kid.choices.append(c_i)
                    children.extend(kids)
                hyps = children
            else:
                for h in hyps:
                    apply(h, keyS, keyT, meas[0], pose_sig, c_pose, True)
        else:  # loop closure: ALWAYS binary hybrid (open-loop vs accept)
            n_modes += 1
            children = []
            for h in hyps:
                kid = fork(h)
                apply(h, keyS, keyT, meas[0], open_sig, c_open, False)
                h.choices.append(0)
                apply(kid, keyS, keyT, meas[0], pose_sig, c_pose, False)
                kid.choices.append(1)
                children.extend([h, kid])
            hyps = children
        if len(hyps) > max_hypotheses and (si % prune_every == 0):
            lw = weights(hyps)
            hyps = [hyps[i] for i in np.argsort(-lw)[:max_hypotheses]]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        step_times.append(time.perf_counter() - t0)
        if progress and (si + 1) % progress == 0:
            seg = np.asarray(step_times[-progress:]) * 1e3
            print(f"line {si+1}: poses={n_poses} modes={n_modes} hyps={len(hyps)} seg mean "
                  f"{seg.mean():.0f} ms p50 {np.percentile(seg, 50):.0f} ms", flush=True)
    lw = weights(hyps)
    best = hyps[int(np.argmax(lw))]
    est = best.isam.calculate_estimate()
    rows = np.asarray([est.row_of(k) for k in range(n_poses)], dtype=np.int64)
    traj = est.params("Pose2").cpu().numpy()[rows]
    st = np.asarray(step_times) * 1e3
    accept_frac = float(np.mean(np.asarray(best.choices) == 1)) if best.choices else 1.0
    return {
        "lines": len(lines),
        "poses": n_poses,
        "modes": n_modes,
        "live_hypotheses": len(hyps),
        "posterior": np.exp(lw).tolist(),
        "choices": list(best.choices),
        "best_loop_accept_frac": accept_frac,
        "step_ms": st.tolist(),
        "step_ms_p50": float(np.percentile(st, 50)),
        "step_ms_p90": float(np.percentile(st, 90)),
        "step_ms_mean": float(st.mean()),
        "updates_per_line": counts["updates"] / max(1, len(lines)),
        "forks": counts["forks"],
        "total_s": time.perf_counter() - t_all,
        "traj": traj,
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True, help="a City10000-format EDGE2 file")
    ap.add_argument("--gt", default=None, help="ground truth, x y theta a line")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--max-hypotheses", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = run_hybrid_city(args.data, args.steps, max_hypotheses=args.max_hypotheses,
                          device=args.device)
    traj = out.pop("traj")
    out.pop("step_ms")
    if args.gt:
        gt = np.loadtxt(args.gt)
        n = min(len(traj), len(gt))
        d2 = traj[:n, :2] - gt[:n, :2]
        out["ate_rmse_m"] = float(np.sqrt(np.mean(np.sum(d2 * d2, 1))))
    print(out)
