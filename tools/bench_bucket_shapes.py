#!/usr/bin/env python3
"""Write the bucket shapes of the two bench plans, with the kernel each
bucket is routed to, to tests/data/bench_bucket_shapes.json, and those of
the iSAM2 path to tests/data/isam2_bucket_shapes.json.

    python3 tools/bench_bucket_shapes.py              both files
    python3 tools/bench_bucket_shapes.py --isam2-only the iSAM2 file

The plans are the ones `chip_smoke.py` builds: the 2,500-pose sphere
(`synthetic.sphere_rings(50, 50, seed=0)`, d = 6) and the synthetic bundle
adjustment (`make_synthetic_ba(1000, 50_000, 4, seed=0)`, d = 9), both at
four buckets per level as bench.py plans them. Beside each it records
the plan of the runner-up ordering among best_ordering's candidates on the
same graph ("sphere_nd": nested dissection; "ba_degree": degree-ascending),
which the planner picks on other graphs of these kinds, so the kernels'
launch plans are checked at their shapes too. A plan depends on the
graph's structure alone, so this runs on the CPU (a few minutes, most of
it the BA ordering). The CPU tests (tests/test_torch_kernel_split.py) read
the file.

The iSAM2 path's shapes come from running the port's `run_city10000` on the
CPU over the stream `chip_smoke.py` phase 6 runs on the card (`city_stream`
at CITY_POSES poses and seed SEED, cut at CITY_LINES lines; several
minutes): every (B, nf, ns) the level step hands K4 or K1 and every one a
wildfire round hands K2, d = 3, counted. The file keeps the ISAM2_KEEP most
frequent of each, plus the largest front, with the level buckets' routes
(`incremental.level_route`) in float64 and float32. Relinearization
decisions follow the deltas, so the card's run can differ from this one in
a few buckets; phase 3 checks and times the recorded shapes.
"""

import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from gtsam_petercdev_torch.inference import elimination, symbolic  # noqa: E402
from gtsam_petercdev_torch.models.ba_synth import make_synthetic_ba  # noqa: E402
from gtsam_petercdev_torch.models.bundle_adjustment import build_ba_graph  # noqa: E402
from gtsam_petercdev_torch.utils import convert, synthetic  # noqa: E402

OUT = os.path.join(REPO, "tests", "data", "bench_bucket_shapes.json")
ISAM2_OUT = os.path.join(REPO, "tests", "data", "isam2_bucket_shapes.json")
ISAM2_KEEP = 40


def buckets(maps, d):
    """[(B, nf, ns, route in float64, route in float32)] in plan order."""
    return [(bm.B, bm.nf, bm.ns, elimination.bucket_route(bm, d, 8),
             elimination.bucket_route(bm, d, 4)) for bm in maps.buckets]


def keep(counts):
    """The ISAM2_KEEP most frequent shapes, then the largest front if it is
    not among them: [(B, nf, ns, count)]."""
    ranked = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    kept = ranked[:ISAM2_KEEP]
    largest = max(counts, key=lambda c: (c[1] + c[2], c[1], c[0]))
    if largest not in dict(kept):
        kept.append((largest, counts[largest]))
    return [list(k) + [n] for k, n in kept]


def isam2_shapes():
    """Record the iSAM2 path's level and wildfire buckets on the CPU."""
    from collections import Counter

    from chip_smoke import CITY_LINES, CITY_POSES, SEED
    from gtsam_petercdev_torch.inference import incremental
    from gtsam_petercdev_torch.models.city10000 import run_city10000

    lines, _ = synthetic.city_stream(CITY_POSES, seed=SEED)
    path = os.path.join(REPO, "gtsam_petercdev_torch", "_build", f"city_stream_{CITY_LINES}.txt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines[:CITY_LINES]) + "\n")
    level, wild = Counter(), Counter()
    level_fn, wild_fn = incremental._level, incremental._wild

    def rec_level(pool, gp, boff, goff, B, nf, ns, d, ext, extg):
        level[B, nf, ns] += 1
        return level_fn(pool, gp, boff, goff, B, nf, ns, d, ext, extg)

    def rec_wild(pc, rows, sep_idx, fro_idx, x, nf, ns, d):
        wild[rows.shape[0], nf, ns] += 1
        return wild_fn(pc, rows, sep_idx, fro_idx, x, nf, ns, d)

    incremental._level, incremental._wild = rec_level, rec_wild
    try:
        res = run_city10000(path, device="cpu", progress_every=250)
    finally:
        incremental._level, incremental._wild = level_fn, wild_fn
    lv = [b[:3] + [incremental.level_route(b[1], b[2], 3, 8),
                   incremental.level_route(b[1], b[2], 3, 4), b[3]] for b in keep(level)]
    with open(ISAM2_OUT, "w") as f:
        json.dump({"note": "written by tools/bench_bucket_shapes.py: the iSAM2 path's d = 3 "
                           "buckets, level [B, nf, ns, route f64, route f32, count] and wildfire "
                           "[B, nf, ns, count], most frequent first, plus the largest front",
                   "stream": {"poses": CITY_POSES, "lines": CITY_LINES, "seed": SEED,
                              "loops": res.n_loop_closures},
                   "d": 3, "level_distinct": len(level), "wildfire_distinct": len(wild),
                   "level_calls": sum(level.values()), "wildfire_calls": sum(wild.values()),
                   "level": lv, "wildfire": keep(wild)}, f, indent=None)
        f.write("\n")
    print("iSAM2", len(level), "level shapes,", len(wild), "wildfire shapes;",
          sum(level.values()), "level calls,", sum(wild.values()), "wildfire calls")


def main():
    isam2_shapes()
    if "--isam2-only" in sys.argv[1:]:
        return 0
    va, fa = synthetic.sphere_rings(50, 50, seed=0)
    g = convert.graph_from_arrays(fa, device="cpu")
    v = convert.values_from_arrays(va, device="cpu")
    structure = elimination.graph_structure(g, v)
    plan = elimination.build_plan_for_graph(structure, len(v), 6, max_buckets_per_level=4)
    sphere = buckets(elimination.build_numeric_maps(plan, structure), 6)
    edges = np.concatenate([np.stack(s.gids, axis=1) for s in structure if len(s.gids) == 2])
    plan = elimination.build_plan_for_graph(
        structure, len(v), 6, ordering=symbolic.nested_dissection_ordering(len(v), edges),
        max_buckets_per_level=4)
    sphere_nd = buckets(elimination.build_numeric_maps(plan, structure), 6)

    n_cams, n_pts = 1000, 50_000
    bg, bv = build_ba_graph(make_synthetic_ba(n_cams, n_pts, 4, seed=0, dtype=np.float64),
                            dtype=torch.float64, device="cpu")
    struct = elimination.graph_structure(bg, bv)
    counts = bg.linearize(bv).type_counts
    offs = elimination.type_offsets(counts)
    n_vars = sum(counts.values())
    var_dims = np.full(n_vars, 9, dtype=np.int64)
    var_dims[offs["Point3"] : offs["Point3"] + n_pts] = 3
    edges = np.stack(struct[0].gids, axis=1)
    ba_plans = {}
    for name, perm in (("ba", symbolic.best_ordering(n_vars, edges)),
                       ("ba_degree", symbolic.degree_ascending_ordering(n_vars, edges))):
        plan = elimination.build_plan_for_graph(struct, n_vars, 9, ordering=perm,
                                                max_buckets_per_level=4)
        ba_plans[name] = buckets(elimination.build_numeric_maps(plan, struct, var_dims=var_dims), 9)
    ba, ba_degree = ba_plans["ba"], ba_plans["ba_degree"]

    with open(OUT, "w") as f:
        json.dump({"note": "written by tools/bench_bucket_shapes.py: [B, nf, ns, route f64, "
                           "route f32] per bucket of the bench plans, in plan order; "
                           "sphere_nd / ba_degree: the same graphs on the runner-up ordering",
                   "sphere": {"d": 6, "buckets": sphere}, "ba": {"d": 9, "buckets": ba},
                   "sphere_nd": {"d": 6, "buckets": sphere_nd},
                   "ba_degree": {"d": 9, "buckets": ba_degree}},
                  f, indent=None)
        f.write("\n")
    for name, bs in (("sphere", sphere), ("ba", ba), ("sphere_nd", sphere_nd),
                     ("ba_degree", ba_degree)):
        print(name, len(bs), "buckets;", {r: sum(b[3] == r for b in bs)
                                          for r in ("blocks", "smem", "global")})
    return 0


if __name__ == "__main__":
    sys.exit(main())
