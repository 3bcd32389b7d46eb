#!/usr/bin/env python3
"""Write tests/data/ordering_reference.json: the JAX package's orderings on
the graphs `chip_smoke.py` plans, the reference of its fill gate.

    python3 tools/ordering_reference.py            (several minutes, CPU)

For each graph, the JAX package's real CCOLAMD (`ccolamd_ordering`, through
its prebuilt binding) and its SuperLU COLAMD proxy (`colamd_ordering`), each
planned by the JAX `symbolic_eliminate(n, [edges], d, ordering=perm)` at its
defaults: F_size (padded frontal entries), cliques and levels. The graphs,
with the variable numbering `chip_smoke.py` plans them in:

- sphere: `synthetic.sphere_rings(50, 50, seed=0)`, its 4,949 between
  factors, d = 6;
- ba: `make_synthetic_ba(1000, 50_000, 4, seed=0)` through the port's
  `build_ba_graph` and `graph_structure` (points first, as the type names
  sort), d = 9;
- city: `synthetic.city_stream(3687, seed=0)` cut at 1,500 lines, one edge
  per line, d = 3.

It also records the fault the port's ordering closes (ROADMAP A4): the JAX
iSAM2 engine (its "numpy" backend on this CPU, `run_city10000` at City10000's
parameters) over the same 1,500 lines, once with CCOLAMD and once on the
proxy (the binding hidden), as counts: cliques re-eliminated and solved by
the wildfire sweep per update, the final tree, and its widest separator.
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import conftest  # noqa: E402,F401  (JAX on the CPU, float64)
import torch  # noqa: E402

from gtsam_petercdev_torch.inference import elimination  # noqa: E402
from gtsam_petercdev_torch.models.ba_synth import make_synthetic_ba  # noqa: E402
from gtsam_petercdev_torch.models.bundle_adjustment import build_ba_graph  # noqa: E402
from gtsam_petercdev_torch.utils import synthetic  # noqa: E402
from gtsam_petercdev_tpu.inference import symbolic as j_sym  # noqa: E402
from gtsam_petercdev_tpu.models import city10000 as j_city  # noqa: E402
from gtsam_petercdev_tpu.native import build as j_native  # noqa: E402
from gtsam_petercdev_tpu.nonlinear import isam2 as j_isam2  # noqa: E402

OUT = os.path.join(REPO, "tests", "data", "ordering_reference.json")
CITY_POSES, CITY_LINES, SEED = 3687, 1500, 0


def city_lines():
    lines, _ = synthetic.city_stream(CITY_POSES, seed=SEED)
    return lines[:CITY_LINES]


def graphs():
    """name -> (n, edges [E, 2], d)."""
    _, factors = synthetic.sphere_rings(50, 50, seed=SEED)
    out = {"sphere": (2500, np.asarray(factors[1][1], dtype=np.int64), 6)}
    bg, bv = build_ba_graph(make_synthetic_ba(1000, 50_000, 4, seed=SEED, dtype=np.float64),
                            dtype=torch.float64, device="cpu")
    struct = elimination.graph_structure(bg, bv)
    out["ba"] = (len(bv), np.stack(struct[0].gids, axis=1), 9)
    e = np.array([[int(ln.split()[1]), int(ln.split()[3])] for ln in city_lines()])
    out["city"] = (int(e.max()) + 1, e, 3)
    return out


def plan_facts(n, edges, d, perm):
    plan = j_sym.symbolic_eliminate(n, [edges], d, ordering=perm)
    return {"F_size": int(plan.F_size), "cliques": len(plan.cliques), "levels": len(plan.levels)}


def isam2_counts(proxy: bool):
    """The JAX engine over the City lines: per-update counters, summarized."""
    path = os.path.join(REPO, "gtsam_petercdev_torch", "_build", f"city_stream_{CITY_LINES}.txt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(city_lines()) + "\n")
    ups, widest, update = [], [0], j_isam2.ISAM2.update

    def recorded(self, *a, **k):
        ups.append(update(self, *a, **k))
        live = [c for c in self._engine.cliques if c is not None and c.alive]
        widest[0] = max([widest[0]] + [len(c.separator) for c in live])
        return ups[-1]

    load = j_native.load_ccolamd
    j_isam2.ISAM2.update = recorded
    if proxy:
        j_native.load_ccolamd = lambda *a, **k: None
    try:
        res = j_city.run_city10000(path)
    finally:
        j_isam2.ISAM2.update, j_native.load_ccolamd = update, load
    ups = ups[1:]  # the prior's update
    re = np.asarray([u.n_reeliminated for u in ups])
    wf = np.asarray([u.wildfire_rounds for u in ups])
    return {"updates": len(ups), "reeliminated_total": int(re.sum()),
            "reeliminated_mean": float(re.mean()), "reeliminated_p99": float(np.percentile(re, 99)),
            "reeliminated_max": int(re.max()), "wildfire_cliques_total": int(wf.sum()),
            "wildfire_cliques_p99": float(np.percentile(wf, 99)),
            "final_cliques": int(ups[-1].n_cliques), "widest_separator": int(widest[0]),
            "poses": int(res.n_poses), "loop_closures": int(res.n_loop_closures)}


def main():
    assert j_native.load_ccolamd() is not None, "the JAX package's CCOLAMD binding does not load"
    out = {"note": "written by tools/ordering_reference.py: JAX symbolic_eliminate(n, [edges], d, "
                   "ordering) at its defaults on the JAX CCOLAMD and SuperLU COLAMD proxy "
                   "orderings of chip_smoke.py's graphs; isam2: the JAX engine's counts over "
                   f"the City stream's first {CITY_LINES} lines", "graphs": {}}
    for name, (n, e, d) in graphs().items():
        t0 = time.perf_counter()
        ent = {"n": n, "edges": len(e), "d": d,
               "ccolamd": plan_facts(n, e, d, j_sym.ccolamd_ordering(n, e)),
               "proxy": plan_facts(n, e, d, j_sym.colamd_ordering(n, e))}
        out["graphs"][name] = ent
        print(name, ent, f"{time.perf_counter() - t0:.1f} s", flush=True)
    out["isam2"] = {}
    for name, proxy in (("ccolamd", False), ("proxy", True)):
        t0 = time.perf_counter()
        out["isam2"][name] = isam2_counts(proxy)
        print("isam2", name, out["isam2"][name], f"{time.perf_counter() - t0:.1f} s", flush=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
