#!/usr/bin/env python3
"""What LM does at each level of the Shonan staircase, on the CPU.

    python3 tools/shonan_staircase.py [--rings 50 --per-ring 50] [--routes multifrontal pcg]
        [--out PATH]

The port's `shonan_averaging` on `utils/synthetic.sphere_rings`' rotations
(`measurements_from_between_graph`), p 3..6, made to climb every level
(optimality_threshold +inf), as chip_smoke.py phase 14 b) runs it on the
card: LM at most 60 iterations a level, through the multifrontal route
(the bucket kernels' plain versions here) and through the default PCG
route (block-Jacobi, at most 500 CG steps to tol 1e-10). For each route
and level it prints LM's iterations, its trials (with bad pivots: the
kernels' clamp of a pivot <= 1e-10; rejected: the cost rose or the model
fidelity fell below 1e-3), the lambda of each trial, the cost and the
certificate's lambda_min: counts, no time (a CPU run says nothing of the
card's). torch runs on one thread. The full sphere takes ~10 minutes.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from gtsam_petercdev_torch.nonlinear.optimizers import LMParams  # noqa: E402
from gtsam_petercdev_torch.ops import cholesky as v1  # noqa: E402
from gtsam_petercdev_torch.sfm import shonan  # noqa: E402
from gtsam_petercdev_torch.utils import convert, synthetic  # noqa: E402

ROUTES = {
    "multifrontal": LMParams(solver="multifrontal", max_iterations=60),
    "pcg": LMParams(solver="pcg", max_iterations=60, pcg_max_iters=500, pcg_tol=1e-10),
}


def staircase(m, route):
    """Per level of the forced staircase: LM's counts and the certificate."""
    certs = []
    orig = shonan.certificate_min_eigenvalue

    def cert(m_, Y, iters=300, seed=0):
        certs.append(orig(m_, Y, iters, seed))
        return certs[-1]

    shonan.certificate_min_eigenvalue = cert
    try:
        t0 = time.perf_counter()
        with chip_smoke.LMRecorder(v1, lambda: None) as rec:
            res = shonan.shonan_averaging(m, 3, 6, optimality_threshold=float("inf"),
                                          lm_params=ROUTES[route], seed=0)
        wall = time.perf_counter() - t0
    finally:
        shonan.certificate_min_eigenvalue = orig
    levels = []
    for p, call, lam in zip(range(3, 7), rec.calls, certs):
        r = call["result"]
        levels.append(dict(p=p, iterations=r.iterations, trials=call["trials"],
                           bad_pivot_trials=call["bad_pivot_trials"],
                           rejected_trials=call["rejected_trials"], lambdas=call["lambdas"],
                           error=[r.error_history[0], r.error], lam_min=lam))
    return dict(route=route, p_final=res.p_final, cpu_s=wall, levels=levels)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rings", type=int, default=50)
    ap.add_argument("--per-ring", type=int, default=50)
    ap.add_argument("--routes", nargs="+", default=["multifrontal", "pcg"], choices=list(ROUTES))
    ap.add_argument("--out")
    a = ap.parse_args()
    torch.set_num_threads(1)
    _, fa = synthetic.sphere_rings(a.rings, a.per_ring, seed=0)
    m = shonan.measurements_from_between_graph(convert.graph_from_arrays(fa, device="cpu"))
    out = dict(shape=[a.rings, a.per_ring], nodes=m.num_nodes, edges=m.num_edges, runs=[])
    for route in a.routes:
        run = staircase(m, route)
        out["runs"].append(run)
        for lv in run["levels"]:
            print(f"{route} SO({lv['p']}): {lv['iterations']} iterations, {lv['trials']} trials "
                  f"({lv['bad_pivot_trials']} bad pivots, {lv['rejected_trials']} rejected), "
                  f"lambda {lv['lambdas'][0]:.1e} .. {min(lv['lambdas']):.1e}, cost "
                  f"{lv['error'][0]:.6e} -> {lv['error'][1]:.6e}, lambda_min {lv['lam_min']:.6e}",
                  flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(chip_smoke.finite_json(out), f, indent=1)


if __name__ == "__main__":
    main()
