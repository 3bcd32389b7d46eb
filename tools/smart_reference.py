#!/usr/bin/env python3
"""Record the JAX package's smart-factor LM on the synthetic BA scene to
tests/data/smart_ba_reference.json.

    python3 tools/smart_reference.py                       the BA cell's size
    python3 tools/smart_reference.py --shape 200 10000 4   a smaller ba_synth

The scene is `ba_synth.smart_scene(make_synthetic_ba(n_cams, n_points,
n_obs, seed=0))`: the rig's tracks as smart factors with Cal3_S2(500, 500,
0, 0, 0), cameras 2 onward perturbed (xi ~ N(0, 0.01^2), default_rng(1)),
Pose3 priors of sigma 1e-4 on cameras 0 and 1 at their true poses (as
tests/test_smart_marginals_gnc.py builds its smart-factor problem). The
JAX package's `smart_levenberg_marquardt` takes ITERS iterations (default
LMParams) on the CPU in float64 and in float32 (x64 off), each run a
subprocess of its own. Recorded per run: the error history and, for each
of its entries, the number of tracks `triangulate_safe` found VALID at
those poses (read by wrapping `smart.total_error` in a debug callback).
`chip_smoke.py` phase 7 holds the card's run against this file.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "smart_ba_reference.json")
SHAPE = (1000, 50_000, 4)
SEED = 0
SCENE_SEED = 1
PRIOR_SIGMA = 1e-4
ITERS = 4
RUNS = ("jax_float64", "jax_float32")


def run_one(run, shape):
    """One LM run: error history, valid tracks per history entry, seconds."""
    sys.path.insert(0, REPO)
    import numpy as np

    dtype = run.split("_")[1]
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", dtype == "float64")
    import jax.numpy as jnp

    from gtsam_petercdev_torch.models import ba_synth
    from gtsam_petercdev_tpu.geometry.pose3 import Pose3
    from gtsam_petercdev_tpu.linear import noise
    from gtsam_petercdev_tpu.nonlinear.factor_graph import NonlinearFactorGraph
    from gtsam_petercdev_tpu.nonlinear.optimizers import LMParams
    from gtsam_petercdev_tpu.nonlinear.values import Values
    from gtsam_petercdev_tpu.slam import smart
    from gtsam_petercdev_tpu.slam.factors import prior_factor

    dt = getattr(jnp, dtype)
    s = ba_synth.smart_scene(ba_synth.make_synthetic_ba(*shape, seed=SEED, dtype=np.float64),
                             seed=SCENE_SEED)
    T, M = s["cam_rows"].shape
    batch = smart.SmartProjectionFactorBatch(
        s["cam_rows"], np.ones((T, M), bool), jnp.asarray(s["measured"], dt),
        jnp.asarray(np.array([ba_synth.SMART_CAL]), dt))
    values = Values()
    values.insert_batch(np.arange(len(s["R0"])), "Pose3",
                        Pose3(jnp.asarray(s["R0"], dt), jnp.asarray(s["t0"], dt)))
    graph = NonlinearFactorGraph()
    for i in (0, 1):
        graph.add(prior_factor("Pose3"), [i], Pose3(jnp.asarray(s["R"][i], dt),
                                                   jnp.asarray(s["t"][i], dt)),
                  noise.isotropic(6, PRIOR_SIGMA, dt))

    calls = {"smart": [], "graph": []}
    orig_total, orig_graph_error = smart.total_error, graph.error

    def total_error(b, poses):
        _, _, bw, valid = smart._track_terms(b, poses)
        e = 0.5 * jnp.sum((bw * valid.astype(bw.dtype)[:, None, None]) ** 2)
        jax.debug.callback(lambda e_, n_: calls["smart"].append((e_, int(n_))), e,
                           jnp.sum(valid.astype(jnp.int32)), ordered=True)
        return e

    def graph_error(v):
        e = orig_graph_error(v)
        jax.debug.callback(lambda e_: calls["graph"].append(e_), e, ordered=True)
        return e

    smart.total_error, graph.error = total_error, graph_error
    t0 = time.perf_counter()
    try:
        res = smart.smart_levenberg_marquardt(graph, batch, values,
                                              LMParams(max_iterations=ITERS))
    finally:
        smart.total_error = orig_total
    seconds = time.perf_counter() - t0
    # each err_fn evaluation made one smart and one graph callback, in order;
    # the history's entries are the evaluations of the accepted poses
    evals = [(float(np.asarray(es + eg, dtype=dtype)), n)
             for (es, n), eg in zip(calls["smart"], calls["graph"])]
    same = lambda a, b: a == b or (np.isnan(a) and np.isnan(b))
    valid, k = [], 0
    for h in res.error_history:
        while not same(evals[k][0], float(h)):
            k += 1
        valid.append(evals[k][1])
    return {"error_history": [float(e) for e in res.error_history], "valid_tracks": valid,
            "iterations": int(res.iterations), "n_tracks": int(T), "seconds": seconds}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", type=int, nargs=3, default=list(SHAPE),
                    metavar=("CAMS", "POINTS", "OBS"))
    ap.add_argument("--run", choices=RUNS, help=argparse.SUPPRESS)  # one run, JSON to stdout
    args = ap.parse_args()
    shape = tuple(args.shape)
    if args.run:
        print(json.dumps(run_one(args.run, shape)), flush=True)
        return 0
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    runs = {}
    for run in RUNS:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--run", run,
                              "--shape", *map(str, shape)],
                             env=env, check=True, capture_output=True, text=True).stdout
        runs[run] = json.loads(out.strip().splitlines()[-1])
        print(run, runs[run], flush=True)
    rec = {"shape": list(shape), "seed": SEED, "scene_seed": SCENE_SEED,
           "prior_sigma": PRIOR_SIGMA, "iterations": ITERS, "runs": runs}
    with open(OUT, "w") as f:
        json.dump(rec, f, indent=1)
    print("wrote", OUT)
    return 0


if __name__ == "__main__":
    sys.exit(main())
