"""IMU + GPS incremental navigation harness: the loop of the reference's
IMUKittiExampleGPS (examples/IMUKittiExampleGPS.cpp), over a drive in the
numpy format of `utils/synthetic.imu_gps_drive`.

Per keyframe k, one ISAM2 update that adds X_k (Pose3), V_k (Vector3) and
B_k (ConstantBias), the CombinedImuFactor from keyframe k - 1 and the GPS
fix at k (keyframe 0: its priors and fix, at the drive's start values). As
in the example, the new state starts from the IMU prediction off the
current estimate: X_k, V_k = predict(PIM_{k-1}, estimate of X_{k-1},
V_{k-1}, B_{k-1}) and B_k = the estimate of B_{k-1}; the prediction is a
device computation, so a step reads back nothing but what ISAM2 reads.

The JAX package has no harness for this example; this one drives the
port's navigation modules and ISAM2 as a user's loop would.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from gtsam_petercdev_torch.device import DeviceLike, resolve_device, resolve_dtype
from gtsam_petercdev_torch.geometry.pose3 import Pose3
from gtsam_petercdev_torch.navigation import preintegration as pre
from gtsam_petercdev_torch.navigation.navstate import NavState
from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph
from gtsam_petercdev_torch.nonlinear.isam2 import ISAM2, ISAM2Params, ISAM2Result
from gtsam_petercdev_torch.nonlinear.values import Values
from gtsam_petercdev_torch.utils import convert


def keyframe_rows(factors, k: int):
    """The drive's factor rows that keyframe k adds (convert's format)."""
    by_name = {f[0]: f for f in factors}
    rows = ([by_name[n] for n in ("PriorPose3", "PriorVector3", "PriorConstantBias")] if k == 0
            else [])
    if k > 0:
        name, keys, p, info = by_name["CombinedImuFactor"]
        rows.append((name, keys[k - 1:k], {"pim": tuple(f[k - 1:k] for f in p["pim"]),
                                           "n_gravity": p["n_gravity"][k - 1:k]}, info[k - 1:k]))
    name, keys, p, info = by_name["GPSFactor"]
    rows.append((name, keys[k:k + 1], p[k:k + 1], info[k:k + 1]))
    return rows


def drive_rows(factors, n: int):
    """The drive's factor rows on its first n keyframes (convert's format),
    a batch a factor type: the priors, the first n - 1 CombinedImuFactors
    and the first n GPS fixes."""
    out = []
    for name, keys, p, info in factors:
        m = {"CombinedImuFactor": n - 1, "GPSFactor": n}.get(name, len(keys))
        if m == 0:
            continue
        cut = lambda a: np.asarray(a)[:m]
        if name == "CombinedImuFactor":
            p = {"pim": tuple(cut(f) for f in p["pim"]), "n_gravity": cut(p["n_gravity"])}
        elif name == "GPSFactor":
            p = cut(p)
        out.append((name, keys[:m], p, info[:m]))
    return out


def start_values(values, n: int, device: DeviceLike = "cuda") -> Values:
    """The drive's start Values (convert's format) cut to its first n
    keyframes."""
    cut = {t: (k[:n], tuple(a[:n] for a in p) if isinstance(p, tuple) else p[:n])
           for t, (k, p) in values.items()}
    return convert.values_from_arrays(cut, device=device)


@dataclass
class ImuGpsResult:
    isam: ISAM2
    graph: NonlinearFactorGraph  # every factor the run added, a batch a factor type
    updates: List[ISAM2Result] = field(default_factory=list)
    update_ms: List[float] = field(default_factory=list)  # host clock around ISAM2.update

    def estimate(self) -> Values:
        return self.isam.calculate_estimate()


def run_imu_gps_isam2(values, factors, truth, n_keyframes: Optional[int] = None,
                      params: Optional[ISAM2Params] = None, device: DeviceLike = "cuda",
                      step_cb: Optional[Callable[[int, ISAM2, ISAM2Result], None]] = None
                      ) -> ImuGpsResult:
    """Run the drive's first `n_keyframes` keyframes (default all) through
    ISAM2 (`params`, default ISAM2Params() on `device`: relinearize threshold
    0.1, skip 10, wildfire 0.001, block_dim unset: d = 6, the 15-row
    CombinedImuFactor in row blocks). The update's time is taken with the
    device synchronized after it. `step_cb(k, isam, result)` after each."""
    dev = resolve_device(device)
    params = params or ISAM2Params(device=dev)
    if torch.device(params.device).type != dev.type:
        raise ValueError(f"ISAM2Params.device is {params.device}, the run asked for {dev}")
    xk, vk, bk = (truth["keys"][c] for c in "xvb")
    n = len(xk) if n_keyframes is None else int(n_keyframes)
    isam = ISAM2(params)
    dtype = resolve_dtype(params.dtype)
    imu = next(f for f in factors if f[0] == "CombinedImuFactor")
    pim = pre.PIM(*(torch.as_tensor(np.asarray(f)).to(dev, dtype) for f in imu[2]["pim"]))
    gravity = pre.PreintegrationParams(None, None, None, torch.as_tensor(
        np.asarray(imu[2]["n_gravity"][0])).to(dev, dtype))
    out = ImuGpsResult(isam, convert.graph_from_arrays(drive_rows(factors, n), device=dev,
                                                       dtype=dtype))
    for k in range(n):
        new = Values(device=dev, dtype=dtype)
        if k == 0:
            R0, t0 = values["Pose3"][1]
            new.insert(xk[0], "Pose3", Pose3(torch.as_tensor(R0[0]), torch.as_tensor(t0[0])))
            new.insert(vk[0], "Vector3", torch.as_tensor(values["Vector3"][1][0]))
            new.insert(bk[0], "ConstantBias", torch.as_tensor(values["ConstantBias"][1][0]))
        else:
            x, v, b = (isam.calculate_estimate_key(key[k - 1]) for key in (xk, vk, bk))
            p = pre.PIM(*(f[k - 1] for f in pim))
            s = pre.predict(p, gravity, NavState(x.R, x.t, v), b)
            new.insert(xk[k], "Pose3", Pose3(s.R, s.t))
            new.insert(vk[k], "Vector3", s.v)
            new.insert(bk[k], "ConstantBias", b)
        g = convert.graph_from_arrays(keyframe_rows(factors, k), device=dev, dtype=dtype)
        t0 = time.perf_counter()
        res = isam.update(g, new)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out.update_ms.append((time.perf_counter() - t0) * 1e3)
        out.updates.append(res)
        if step_cb is not None:
            step_cb(k, isam, res)
    return out


def ate(values: Values, truth, n: Optional[int] = None) -> float:
    """RMS position error of the keyframes' poses against the truth."""
    xk = truth["keys"]["x"][:n]
    rows = torch.as_tensor(values.rows(xk, "Pose3"), dtype=torch.int64)
    est = values.params("Pose3").t[rows.to(values.device)].cpu().numpy()
    return float(np.sqrt(np.mean(np.sum((est - truth["t"][: len(xk)]) ** 2, axis=-1))))
