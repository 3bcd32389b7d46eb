#!/usr/bin/env python3
"""The port's ISAM2 and the JAX package's on IMUKittiExampleGPS's loop, on the CPU.

    python3 tools/imu_isam2_reference.py
        chip_smoke.py phase 12 c)'s loop: the 1,000-keyframe drive at 200 Hz
        (seed 0), ISAM2 over its first 300 keyframes; writes
        tests/data/imu_isam2_reference.json (about 10 minutes, ~2 GB)
    python3 tools/imu_isam2_reference.py --drive 20 --keyframes 20 --rate 50 \\
        [--default-bias-walk] [--out PATH]
        another drive; prints, and writes only where --out is given

Both packages run the same synthetic drive (`utils/synthetic.imu_gps_drive`
made on the CPU) one update a keyframe at ISAM2Params() defaults, each new
state predicted by the IMU off the current estimate (`models/imu_gps.py`'s
loop, written out again here for the JAX package). The port runs at d = 6
with the 15-row CombinedImuFactor in row blocks; the JAX package's ISAM2
takes no factor wider than its block, so it runs at block_dim 15. Each
package orders its Bayes tree its own way (the port AMD, the JAX package
CCOLAMD); the wildfire's stopping (threshold 0.001) depends on the tree, so
the two final errors part once the trees do (rel 1.9e-4 at 300 keyframes).
The tool runs both again with their trees ordered by the same proxy COLAMD
(the JAX package's native CCOLAMD off, the port's `ccolamd_ordering` the
proxy), as tests/test_torch_isam2.py pins them, where they agree to ~1e-11.

The batch optimum of the final graph: the port's LM from the drive's start
(at most 200 iterations, tolerances 1e-14), then the JAX package's dense
Gauss-Newton from the LM's values until it stops descending. How far iSAM2
stays above the optimum is the algorithm's (relinearize threshold 0.1, skip
10): the reference holds the JAX ISAM2's ratio, which phase 12 c) gates the
card's against. `--default-bias-walk` makes the drive with `default_params`'
bias random walk (1e-3 variances) in place of the KITTI calibration's.
"""

import argparse
import contextlib
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from gtsam_petercdev_torch.inference import incremental as t_inc  # noqa: E402
from gtsam_petercdev_torch.inference import symbolic as t_sym  # noqa: E402
from gtsam_petercdev_torch.models import imu_gps  # noqa: E402
from gtsam_petercdev_torch.nonlinear.optimizers import LMParams, levenberg_marquardt  # noqa: E402
from gtsam_petercdev_torch.utils import synthetic  # noqa: E402
from gtsam_petercdev_tpu.geometry import pose3 as j_pose3  # noqa: E402
from gtsam_petercdev_tpu.navigation import factors as j_navf  # noqa: E402
from gtsam_petercdev_tpu.navigation import navstate as j_ns  # noqa: E402
from gtsam_petercdev_tpu.native import build as j_native  # noqa: E402
from gtsam_petercdev_tpu.navigation import preintegration as j_pre  # noqa: E402
from gtsam_petercdev_tpu.nonlinear.factor_graph import NonlinearFactorGraph  # noqa: E402
from gtsam_petercdev_tpu.nonlinear.isam2 import ISAM2, ISAM2Params  # noqa: E402
from gtsam_petercdev_tpu.nonlinear.optimizers import OptimizerParams, gauss_newton  # noqa: E402
from gtsam_petercdev_tpu.nonlinear.values import Values  # noqa: E402
from gtsam_petercdev_tpu.slam.factors import prior_factor  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data", "imu_isam2_reference.json")


def jax_graph(rows):
    """The JAX package's graph of factor rows (convert's format)."""
    g = NonlinearFactorGraph()
    for name, keys, p, info in rows:
        p = jax.tree_util.tree_map(jnp.asarray, p)
        if name == "CombinedImuFactor":
            ft, p = j_navf.combined_imu_factor(), dict(p, pim=j_pre.PIM(*p["pim"]))
        elif name == "GPSFactor":
            ft = j_navf.gps_factor()
        else:
            ft = prior_factor(name[len("Prior"):])
            p = j_pose3.Pose3(*p) if name == "PriorPose3" else p
        g.add_batch(ft, np.asarray(keys), p, np.asarray(info))
    return g


def jax_values(values):
    """The JAX package's Values of the port's (on the CPU)."""
    v = Values()
    for t in values.types():
        p = values.params(t)
        p = j_pose3.Pose3(jnp.asarray(p.R.numpy()), jnp.asarray(p.t.numpy())) if t == "Pose3" \
            else jnp.asarray(p.numpy())
        v.insert_batch([int(k) for k in values.type_keys(t)], t, p)
    return v


def jax_run(va, fa, truth, n):
    """The JAX package's ISAM2 (block_dim 15) over the drive's first n
    keyframes, IMUKittiExampleGPS's loop: its final estimate."""
    xk, vk, bk = (truth["keys"][c] for c in "xvb")
    imu = next(f for f in fa if f[0] == "CombinedImuFactor")
    pim = j_pre.PIM(*map(jnp.asarray, imu[2]["pim"]))
    gravity = j_pre.PreintegrationParams(None, None, None, jnp.asarray(imu[2]["n_gravity"][0]))
    isam = ISAM2(ISAM2Params(block_dim=15))
    predict = jax.jit(j_pre.predict)
    for k in range(n):
        new = Values()
        if k == 0:
            R0, t0 = va["Pose3"][1]
            new.insert(int(xk[0]), "Pose3", j_pose3.Pose3(jnp.asarray(R0[0]), jnp.asarray(t0[0])))
            new.insert(int(vk[0]), "Vector3", jnp.asarray(va["Vector3"][1][0]))
            new.insert(int(bk[0]), "ConstantBias", jnp.asarray(va["ConstantBias"][1][0]))
        else:
            x, v, b = (isam.calculate_estimate_key(int(key[k - 1])) for key in (xk, vk, bk))
            s = predict(jax.tree_util.tree_map(lambda a: a[k - 1], pim), gravity,
                        j_ns.NavState(x.R, x.t, v), b)
            new.insert(int(xk[k]), "Pose3", j_pose3.Pose3(s.R, s.t))
            new.insert(int(vk[k]), "Vector3", s.v)
            new.insert(int(bk[k]), "ConstantBias", b)
        isam.update(jax_graph(imu_gps.keyframe_rows(fa, k)), new)
    return isam.calculate_estimate()


@contextlib.contextmanager
def proxy_ordering():
    """Both packages' Bayes trees ordered by the proxy COLAMD while inside."""
    saved = [(m, n, getattr(m, n)) for m, n in ((j_native, "load_ccolamd"),
                                                  (t_inc, "ccolamd_ordering"),
                                                  (t_sym, "ccolamd_ordering"))]
    j_native.load_ccolamd = lambda *a, **k: None
    t_inc.ccolamd_ordering = t_sym.ccolamd_ordering = t_sym.colamd_ordering
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def isam2_errors(va, fa, truth, n):
    """Final errors of the port's ISAM2 (on the CPU) and the JAX package's
    over the drive's first n keyframes, and the port's run."""
    port = imu_gps.run_imu_gps_isam2(va, fa, truth, n, device="cpu")
    e_jax = float(jax_graph(imu_gps.drive_rows(fa, n)).error(jax_run(va, fa, truth, n)))
    return float(port.graph.error(port.estimate())), e_jax, port


def batch_optimum(port_graph, va, fa, n):
    """The final graph's optimum: the port's LM from the drive's start, then
    the JAX package's dense GN from the LM's values."""
    lm = levenberg_marquardt(port_graph, imu_gps.start_values(va, n, "cpu"), LMParams(
        solver="multifrontal", max_iterations=200, relative_error_tol=1e-14,
        absolute_error_tol=1e-14), device="cpu")
    gn = gauss_newton(jax_graph(imu_gps.drive_rows(fa, n)), jax_values(lm.values), OptimizerParams(
        solver="dense", max_iterations=10, relative_error_tol=1e-15, absolute_error_tol=1e-15))
    hist = [float(e) for e in gn.error_history]
    return min(lm.error, min(hist)), lm, hist


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--drive", type=int, default=1000, help="the drive's keyframes")
    ap.add_argument("--keyframes", type=int, default=300, help="ISAM2 over the first N")
    ap.add_argument("--rate", type=int, default=200, help="IMU Hz")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--default-bias-walk", action="store_true")
    ap.add_argument("--out", default=None, help=f"JSON file (default {OUT} at the defaults)")
    a = ap.parse_args()
    defaults = (a.drive, a.keyframes, a.rate, a.seed, a.default_bias_walk) == (1000, 300, 200, 0, False)
    out = a.out or (OUT if defaults else None)
    torch.set_num_threads(1)
    n = a.keyframes
    walk = None if a.default_bias_walk else synthetic.DRIVE_BIAS_WALK
    va, fa, truth = synthetic.imu_gps_drive(a.drive, a.rate, seed=a.seed, device="cpu",
                                            bias_walk=walk)
    t0 = time.perf_counter()
    e_port, e_jax, port = isam2_errors(va, fa, truth, n)
    t1 = time.perf_counter()
    with proxy_ordering():
        e_port_px, e_jax_px, _ = isam2_errors(va, fa, truth, n)
    t2 = time.perf_counter()
    opt, lm, gn_hist = batch_optimum(port.graph, va, fa, n)
    t3 = time.perf_counter()
    rel = lambda x, y: abs(x - y) / abs(y)
    rec = {
        "drive_keyframes": a.drive, "isam2_keyframes": n, "rate_hz": a.rate, "seed": a.seed,
        "bias_walk": None if walk is None else list(walk),
        "port_cpu_isam2_error": e_port, "jax_isam2_error": e_jax,
        "port_rel_jax": rel(e_port, e_jax),
        "proxy_ordering": {"port_cpu_isam2_error": e_port_px, "jax_isam2_error": e_jax_px,
                           "port_rel_jax": rel(e_port_px, e_jax_px),
                           "port_rel_port_own_ordering": rel(e_port_px, e_port)},
        "optimum": opt, "optimum_lm_iterations": lm.iterations, "optimum_lm_error": lm.error,
        "optimum_gn_history": gn_hist,
        "optimum_how": "the port's LM from the drive's start (<= 200 iterations, tolerances "
                       "1e-14), then the JAX package's dense GN from its values (the least)",
        "jax_isam2_over_optimum": e_jax / opt,
        "jax_isam2_proxy_over_optimum": e_jax_px / opt,
        "seconds": {"isam2_runs": t1 - t0, "isam2_runs_proxy": t2 - t1, "optimum": t3 - t2},
    }
    print(json.dumps(rec, indent=1))
    print(f"{n} of {a.drive} keyframes at {a.rate} Hz: final error, the port's ISAM2 (d = 6, "
          f"row blocks, AMD) {e_port:.15e}, the JAX package's (block_dim 15, CCOLAMD) "
          f"{e_jax:.15e}, rel {rec['port_rel_jax']:.3e}; both on the proxy ordering "
          f"{e_port_px:.15e} / {e_jax_px:.15e}, rel {rec['proxy_ordering']['port_rel_jax']:.3e}; "
          f"the batch optimum {opt:.15e}; the JAX ISAM2 over the optimum {e_jax / opt:.6f} "
          f"({e_jax_px / opt:.6f} on the proxy ordering)")
    if out:
        with open(out, "w") as f:
            json.dump(rec, f, indent=1)
            f.write("\n")
        print("wrote", out)


if __name__ == "__main__":
    main()
