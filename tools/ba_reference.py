#!/usr/bin/env python3
"""Record reference LM error histories of the synthetic bundle adjustment
to tests/data/ba_synth_lm_reference.json.

    python3 tools/ba_reference.py                       SHAPE below
    python3 tools/ba_reference.py --shape 1000 50000 4  the BA cell's size

From the same start, `make_synthetic_ba(n_cams, n_points, n_obs, seed=0)`
built as `build_ba_graph` builds it, each run takes ITERS iterations of
Levenberg-Marquardt with solver="multifrontal" (default LMParams) on the
CPU:
  jax_float32, jax_float64   the JAX package (its planner, CCOLAMD ordering)
  port_float32               the PyTorch port, device="cpu" (the kernels'
                             plain versions; the port's own ordering)
Each run is a subprocess of its own (JAX's float32 run with x64 off), so
one run's memory is freed before the next starts. `chip_smoke.py` phase 5
runs the same LM on the card at the recorded shape and prints its
histories beside these.

SHAPE is a fifth of the BA cell (200 cameras, 10,000 points): the JAX
package's float64 run peaks at 7.8 GB of host memory at 100 x 5,000 and
13.0 GB at 200 x 10,000 (66 s), so the cell's 1000 x 50,000 would need
about 60 GB.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "ba_synth_lm_reference.json")
SHAPE = (200, 10_000, 4)
SEED = 0
ITERS = 4
RUNS = ("jax_float32", "jax_float64", "port_float32")


def run_one(run, shape):
    """One LM run; returns its error history, iterations and seconds."""
    sys.path.insert(0, REPO)
    import numpy as np

    pkg, dtype = run.split("_")
    t0 = time.perf_counter()
    if pkg == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", dtype == "float64")
        import jax.numpy as jnp

        from gtsam_petercdev_tpu.models.ba_synth import make_synthetic_ba
        from gtsam_petercdev_tpu.models.bundle_adjustment import build_ba_graph
        from gtsam_petercdev_tpu.nonlinear.optimizers import LMParams, levenberg_marquardt

        data = make_synthetic_ba(*shape, seed=SEED, dtype=np.dtype(dtype))
        graph, values = build_ba_graph(data, dtype=getattr(jnp, dtype))
        res = levenberg_marquardt(graph, values,
                                  LMParams(solver="multifrontal", max_iterations=ITERS))
    else:
        import torch

        from gtsam_petercdev_torch.models.ba_synth import make_synthetic_ba
        from gtsam_petercdev_torch.models.bundle_adjustment import build_ba_graph
        from gtsam_petercdev_torch.nonlinear.optimizers import LMParams, levenberg_marquardt

        torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
        data = make_synthetic_ba(*shape, seed=SEED, dtype=np.dtype(dtype))
        graph, values = build_ba_graph(data, dtype=getattr(torch, dtype), device="cpu")
        res = levenberg_marquardt(graph, values,
                                  LMParams(solver="multifrontal", max_iterations=ITERS),
                                  device="cpu")
    return {"error_history": [float(e) for e in res.error_history],
            "iterations": int(res.iterations), "seconds": time.perf_counter() - t0}


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
    rec = {"shape": list(shape), "seed": SEED, "iterations": ITERS,
           "solver": "multifrontal", "runs": runs}
    with open(OUT, "w") as f:
        json.dump(rec, f, indent=1)
    print("wrote", OUT)
    return 0


if __name__ == "__main__":
    sys.exit(main())
