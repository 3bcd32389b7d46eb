"""SolverComparer — batch / incremental / compare / perturb driver.

Port of gtsam_petercdev_tpu/utils/solver_comparer.py, the analog of the
reference's benchmark workhorse (examples/SolverComparer.cpp:12-143): one
CLI that runs a g2o dataset through the batch optimizer or the incremental
ISAM2 engine, writes the solution, perturbs saved solutions, and compares
two solutions — printing the hierarchical per-phase timing tree
(utils/timing.py) at the end. The solves run on `--device` (default
"cuda"; the JAX package's `--cpu` switch chose its platform).

    python -m gtsam_petercdev_torch.utils.solver_comparer \
        --incremental -d graph.g2o -o incr.npz
    python -m gtsam_petercdev_torch.utils.solver_comparer \
        --batch -d graph.g2o -o batch.npz
    python -m gtsam_petercdev_torch.utils.solver_comparer \
        --compare incr.npz batch.npz

`-d` takes a path to a g2o file, or a name `dataset.find_example_data`
finds in this checkout's tests/data.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def _load(dataset_name: str, is3D: bool, device="cuda"):
    """(graph, values) of the dataset on `device`, with a prior on pose 0."""
    import torch

    from gtsam_petercdev_torch.geometry import pose3
    from gtsam_petercdev_torch.linear import noise
    from gtsam_petercdev_torch.slam.factors import prior_factor
    from gtsam_petercdev_torch.utils import dataset as ds

    path = dataset_name if os.path.isfile(dataset_name) else ds.find_example_data(dataset_name)
    graph, values = ds.read_g2o(path, is3D=is3D, dtype=np.float64, device=device)
    if is3D:
        graph.add(prior_factor("Pose3"), [0], pose3.identity(torch.float64, graph.device),
                  noise.diagonal_precisions(np.asarray([1e6] * 3 + [1e4] * 3)))
    else:
        graph.add(prior_factor("Pose2"), [0], np.zeros(3),
                  noise.diagonal_precisions(np.asarray([1e6, 1e6, 1e8])))
    return graph, values


def _solution_array(values, ptype):
    rows = [values.row_of(k) for k in sorted(values.keys())]
    if ptype == "Pose3":
        p = values.params("Pose3")
        flat = np.concatenate([p.R.cpu().numpy().reshape(len(rows), -1), p.t.cpu().numpy()],
                              axis=1)
    else:
        flat = values.params("Pose2").cpu().numpy()
    return flat[rows]


def run_batch(args):
    from gtsam_petercdev_torch.nonlinear import optimizers
    from gtsam_petercdev_torch.utils import timing

    graph, values = _load(args.dataset, args.is3D, args.device)
    ptype = "Pose3" if args.is3D else "Pose2"
    timing.enable()  # the tree shows LM's spans too: plan, linearize, the solves
    try:
        with timing.tic("batch"):
            with timing.tic("optimize"):
                res = optimizers.levenberg_marquardt(
                    graph, values,
                    optimizers.LMParams(solver=args.solver, max_iterations=args.iterations),
                    device=args.device)
    finally:
        timing.disable()
    print(f"batch: final error {float(res.error):.4f} ({res.iterations} iterations)")
    if args.output:
        np.savez(args.output, sol=_solution_array(res.values, ptype), ptype=ptype)
    timing.tictoc_print()
    return res


def run_incremental(args):
    from gtsam_petercdev_torch.core.tree import tree_map
    from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph
    from gtsam_petercdev_torch.nonlinear.isam2 import ISAM2, ISAM2Params
    from gtsam_petercdev_torch.nonlinear.values import Values
    from gtsam_petercdev_torch.utils import timing

    graph, values = _load(args.dataset, args.is3D, args.device)
    graph._materialize()
    dev = graph.device
    ptype = "Pose3" if args.is3D else "Pose2"

    # stream factors in key order like SolverComparer's incremental mode
    ent = []
    for bi, b in enumerate(graph.batches):
        for r in range(b.size):
            ent.append((int(b.keys[r].max()), bi, r))
    ent.sort()
    isam = ISAM2(ISAM2Params(relinearize_skip=args.relinearize_skip, device=dev))
    inserted = set()
    step_t = []
    with timing.tic("incremental"):
        for (_kmax, bi, r) in ent:
            b = graph.batches[bi]
            nf = NonlinearFactorGraph(device=dev)
            nf.add_batch(b.ftype, b.keys[r : r + 1], tree_map(lambda a: a[r : r + 1], b.params),
                         b.sqrt_info[r : r + 1], b.robust, b.sign)
            nv = Values(device=dev)
            for k in b.keys[r]:
                k = int(k)
                if k not in inserted:
                    inserted.add(k)
                    nv.insert(k, ptype, values.at(k))
            t0 = time.perf_counter()
            with timing.tic("update"):
                isam.update(nf, nv if len(nv) else None)
            step_t.append(time.perf_counter() - t0)
    est = isam.calculate_estimate()
    st = np.asarray(step_t) * 1e3
    print(f"incremental: {len(step_t)} updates, step ms p50={np.percentile(st, 50):.1f} "
          f"p99={np.percentile(st, 99):.1f} mean={st.mean():.1f}")
    if args.output:
        np.savez(args.output, sol=_solution_array(est, ptype), ptype=ptype)
    timing.tictoc_print()
    return est


def run_compare(args):
    a = np.load(args.compare[0], allow_pickle=True)
    b = np.load(args.compare[1], allow_pickle=True)
    sa, sb = a["sol"], b["sol"]
    n = min(len(sa), len(sb))
    d = np.linalg.norm(sa[:n, -2:] - sb[:n, -2:], axis=1)  # translation tail
    print(f"compare: {n} poses, translation diff mean={d.mean():.6f} max={d.max():.6f}")
    return d


def run_perturb(args):
    rng = np.random.default_rng(42)
    a = np.load(args.perturb, allow_pickle=True)
    sol = a["sol"] + rng.normal(scale=args.perturb_sigma, size=a["sol"].shape)
    np.savez(args.output or args.perturb, sol=sol, ptype=a["ptype"])
    print(f"perturbed {len(sol)} poses by sigma={args.perturb_sigma}")
    return sol


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--batch", action="store_true")
    mode.add_argument("--incremental", action="store_true")
    mode.add_argument("--compare", nargs=2, metavar=("A", "B"))
    mode.add_argument("--perturb", metavar="SOL")
    ap.add_argument("-d", "--dataset", default="sphere2500.txt")
    ap.add_argument("--is3D", action="store_true", default=None)
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--solver", default="multifrontal")
    ap.add_argument("--iterations", type=int, default=15)
    ap.add_argument("--relinearize-skip", type=int, default=10)
    ap.add_argument("--perturb-sigma", type=float, default=0.01)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.is3D is None:
        args.is3D = "sphere" in args.dataset or "pose3" in args.dataset.lower()
    if args.batch:
        return run_batch(args)
    if args.incremental:
        return run_incremental(args)
    if args.compare:
        return run_compare(args)
    return run_perturb(args)


if __name__ == "__main__":
    main()
