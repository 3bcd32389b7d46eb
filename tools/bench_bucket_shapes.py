#!/usr/bin/env python3
"""Write the bucket shapes of the two bench plans, with the kernel each
bucket is routed to, to tests/data/bench_bucket_shapes.json.

    python3 tools/bench_bucket_shapes.py

The plans are the ones `chip_smoke.py` builds: the 2,500-pose sphere
(`synthetic.sphere_rings(50, 50, seed=0)`, d = 6) and the synthetic bundle
adjustment (`make_synthetic_ba(1000, 50_000, 4, seed=0)`, d = 9), both at
four buckets per level as bench.py plans them. A plan depends on the
graph's structure alone, so this runs on the CPU (about a minute, most of
it the BA ordering). The CPU tests (tests/test_torch_kernel_split.py) read
the file.
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


def buckets(maps, d):
    """[(B, nf, ns, route in float64, route in float32)] in plan order."""
    return [(bm.B, bm.nf, bm.ns, elimination.bucket_route(bm, d, 8),
             elimination.bucket_route(bm, d, 4)) for bm in maps.buckets]


def main():
    va, fa = synthetic.sphere_rings(50, 50, seed=0)
    g = convert.graph_from_arrays(fa, device="cpu")
    v = convert.values_from_arrays(va, device="cpu")
    structure = elimination.graph_structure(g, v)
    plan = elimination.build_plan_for_graph(structure, len(v), 6, max_buckets_per_level=4)
    sphere = buckets(elimination.build_numeric_maps(plan, structure), 6)

    n_cams, n_pts = 1000, 50_000
    bg, bv = build_ba_graph(make_synthetic_ba(n_cams, n_pts, 4, seed=0, dtype=np.float64),
                            dtype=torch.float64, device="cpu")
    struct = elimination.graph_structure(bg, bv)
    counts = bg.linearize(bv).type_counts
    offs = elimination.type_offsets(counts)
    n_vars = sum(counts.values())
    var_dims = np.full(n_vars, 9, dtype=np.int64)
    var_dims[offs["Point3"] : offs["Point3"] + n_pts] = 3
    perm = symbolic.best_ordering(n_vars, np.stack(struct[0].gids, axis=1))
    plan = elimination.build_plan_for_graph(struct, n_vars, 9, ordering=perm,
                                            max_buckets_per_level=4)
    ba = buckets(elimination.build_numeric_maps(plan, struct, var_dims=var_dims), 9)

    with open(OUT, "w") as f:
        json.dump({"note": "written by tools/bench_bucket_shapes.py: [B, nf, ns, route f64, "
                           "route f32] per bucket of the bench plans, in plan order",
                   "sphere": {"d": 6, "buckets": sphere}, "ba": {"d": 9, "buckets": ba}},
                  f, indent=None)
        f.write("\n")
    for name, bs in (("sphere", sphere), ("ba", ba)):
        print(name, len(bs), "buckets;", {r: sum(b[3] == r for b in bs)
                                          for r in ("blocks", "smem", "global")})
    return 0


if __name__ == "__main__":
    sys.exit(main())
