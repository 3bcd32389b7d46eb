"""Time the port's batch paths of one checkout on the card, by chip_smoke.py's
protocols, so that two checkouts can be compared on one card.

    python3 tools/batch_pair.py --root DIR [--label NAME] [--out FILE]

DIR holds the checkout's `gtsam_petercdev_torch/` (its kernels build into
its own `_build/`). Each checkout plans with its own `best_ordering`.
Measured: the 2,500-pose sphere's GN iteration (phase 4: linearize and the
multifrontal solve on the bench plan of 4 buckets a level, 10 chained, one
synchronize, median of 3) in float64 and float32; mixed-precision GN ms per
iteration over 20 iterations (phase 8, host planning taken out); the
1000-camera BA cell's LM step (phase 5: linearize, damped multifrontal
solve on its bench plan, retract; 4 chained, median of 3) in float32 and
float64. Each with its device time (torch.profiler, the busier of two
profiled steps), its bucket-kernel launches, its plan's buckets and the
peak device memory. Prints one JSON line after "batch_pair: " and, with
--out, appends it to FILE.

Two checkouts on one card: run them alternately in one command (A, B, B,
A) and compare within it, never across machines.
"""

import argparse
import json
import os
import sys
import time


def chained_ms(torch, step, values, n_chain):
    cur = step(step(values))
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        cur = values
        t0 = time.perf_counter()
        for _ in range(n_chain):
            cur = step(cur)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / n_chain)
    return sorted(times)[1]


def device_ms(torch, step, values):
    """(device busy ms, CUDA kernel launches) of one step: the busier of two
    profiled steps (the profiler can drop a share of the events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    best = (0.0, 0)
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            step(values)
            torch.cuda.synchronize()
        k = [e for e in p.key_averages() if e.device_type == DeviceType.CUDA]
        got = (sum(e.self_device_time_total for e in k) / 1e3, sum(e.count for e in k))
        best = max(best, got, key=lambda r: r[1])
    return best


def timed(torch, v1, step, values, n_chain):
    v1.reset_launch_counts()
    step(values)
    launches = v1.launch_counts()
    torch.cuda.reset_peak_memory_stats()
    ms = chained_ms(torch, step, values, n_chain)
    busy, n_cuda = device_ms(torch, step, values)
    return dict(ms=ms, device_ms=busy, cuda_launches=n_cuda, launches=launches,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("batch_pair: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from gtsam_petercdev_torch.inference import elimination, symbolic
    from gtsam_petercdev_torch.models.ba_synth import make_synthetic_ba
    from gtsam_petercdev_torch.models.bundle_adjustment import build_ba_graph
    from gtsam_petercdev_torch.nonlinear.optimizers import (
        OptimizerParams, gauss_newton_mixed_precision)
    from gtsam_petercdev_torch.ops import build, cholesky as v1
    from gtsam_petercdev_torch.utils import convert, synthetic

    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    build.build_all()
    res = dict(label=args.label, root=os.path.abspath(args.root),
               card=torch.cuda.get_device_name(0), build_s=time.perf_counter() - t_start)

    # the sphere (phase 4), mixed-precision GN (phase 8)
    va, fa = synthetic.sphere_rings(50, 50, seed=0)
    g = {n: convert.graph_from_arrays(fa, device="cuda", dtype=dt)
         for n, dt in (("float64", torch.float64), ("float32", torch.float32))}
    v = {n: convert.values_from_arrays(va, device="cuda", dtype=dt)
         for n, dt in (("float64", torch.float64), ("float32", torch.float32))}
    t0 = time.perf_counter()
    structure = elimination.graph_structure(g["float64"], v["float64"])
    plan = elimination.build_plan_for_graph(structure, len(v["float64"]), 6,
                                            max_buckets_per_level=4)
    maps = elimination.build_numeric_maps(plan, structure)
    res["sphere"] = dict(plan_s=time.perf_counter() - t0, buckets=len(maps.buckets),
                         levels=plan.stats()["n_levels"])

    def gn_step(graph):
        def step(values):
            lg = graph.linearize(values)
            x = elimination.multifrontal_solve(maps, tuple((lb.A, lb.b) for lb in lg.batches),
                                               1e-5)
            return values.retract({"Pose3": x})
        return step

    for n in ("float64", "float32"):
        res["sphere"][n] = timed(torch, v1, gn_step(g[n]), v[n], 10)
    gh = convert.graph_from_arrays(fa, device="cpu")
    vh = convert.values_from_arrays(va, device="cpu")
    gauss_newton_mixed_precision(g["float32"], gh, vh, OptimizerParams(max_iterations=1),
                                 device="cuda")
    plan_s = [0.0]
    saved = [(n, getattr(elimination, n)) for n in ("build_plan_for_graph", "build_numeric_maps")]

    def host_timed(fn):
        def wrapped(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            plan_s[0] += time.perf_counter() - t
            return out
        return wrapped

    for n, fn in saved:
        setattr(elimination, n, host_timed(fn))
    v1.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        mx = gauss_newton_mixed_precision(g["float32"], gh, vh,
                                          OptimizerParams(max_iterations=20), device="cuda")
        torch.cuda.synchronize()
    finally:
        for n, fn in saved:
            setattr(elimination, n, fn)
    wall = time.perf_counter() - t0 - plan_s[0]
    res["mixed_gn"] = dict(iterations=mx.iterations, ms=wall * 1e3 / max(mx.iterations, 1),
                           launches=v1.launch_counts(), error=float(mx.error))
    del g, v, gh, vh

    # the BA cell (phase 5)
    ba = {}
    for n, dt, npdt in (("float32", torch.float32, np.float32),
                        ("float64", torch.float64, np.float64)):
        ba[n] = build_ba_graph(make_synthetic_ba(1000, 50_000, 4, seed=0, dtype=npdt),
                               dtype=dt, device="cuda")
    bg, bv = ba["float64"]
    t0 = time.perf_counter()
    ba_struct = elimination.graph_structure(bg, bv)
    lg0 = bg.linearize(bv)
    types = sorted(lg0.type_counts)
    offs = elimination.type_offsets(lg0.type_counts)
    n_vars = sum(lg0.type_counts.values())
    var_dims = np.full(n_vars, 9, dtype=np.int64)
    var_dims[offs["Point3"]: offs["Point3"] + 50_000] = 3
    perm = symbolic.best_ordering(n_vars, np.stack(ba_struct[0].gids, axis=1))
    t_order = time.perf_counter() - t0
    bplan = elimination.build_plan_for_graph(ba_struct, n_vars, 9, ordering=perm,
                                             max_buckets_per_level=4)
    bmaps = elimination.build_numeric_maps(bplan, ba_struct, var_dims=var_dims)
    res["ba"] = dict(plan_s=time.perf_counter() - t0, ordering_s=t_order,
                     buckets=len(bmaps.buckets), levels=bplan.stats()["n_levels"],
                     F_entries=bplan.stats()["F_entries"])

    def ba_step(graph):
        def step(values):
            lg = graph.linearize(values)
            x = elimination.multifrontal_solve(bmaps, tuple((lb.A, lb.b) for lb in lg.batches),
                                               1e-4)
            return values.retract({t: x[offs[t]: offs[t] + lg0.type_counts[t],
                                        : (3 if t == "Point3" else 9)] for t in types})
        return step

    for n in ("float32", "float64"):
        r = res["ba"][n] = timed(torch, v1, ba_step(ba[n][0]), ba[n][1], 4)
        r["lm_iterations_per_s"] = 1e3 / r["ms"]
    res["total_s"] = time.perf_counter() - t_start
    line = json.dumps(res)
    print("batch_pair: " + line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
