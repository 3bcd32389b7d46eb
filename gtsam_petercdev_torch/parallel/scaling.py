"""Scaling harness for the partitioned solver on one device.

Port of gtsam_petercdev_tpu/parallel/scaling.py. The JAX harness starts
one worker process per mesh size over a virtual CPU mesh, a part per
device; here one device holds all P parts, folded (parallel/partition.py:
a level of the P parts is one kernel launch), so one process measures
every P:

  * the synthetic 2,500-pose Pose3 sphere (`utils/synthetic.sphere_rings`,
    50 rings of 50) at P = 1, 2, 4, 8, damped at lambda 1e-5;
  * the 48-camera / 1,600-point `ba_synth` rig (3 views a point) through
    uniform d = 3 sub-blocks (`split_structure_to_blocks`) at P = 1, 2, 4,
    damped at lambda 1e-3;

each P against `multifrontal_solve` of the same damped system. Per row: the
separator size S, the levels, solve ms and the multifrontal solve's ms
(host clock around a synchronized solve; `reps` rounds of multifrontal,
partitioned, partitioned, multifrontal, so the two share the card's state;
medians) and the median of the rounds' ratios, padded GFLOP per part and
of the separator (`plan_padded_flops`), the bucket kernels' launches of one
solve (0 on the CPU, where the plain versions run) and the largest
difference from the multifrontal solution beside the largest entry.

    python -m gtsam_petercdev_torch.parallel.scaling

A CPU rehearsal calls `sphere_rows` / `ba_rows` with device="cpu" and a
small `shape`.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from gtsam_petercdev_torch.device import DeviceLike, resolve_device
from gtsam_petercdev_torch.inference import elimination
from gtsam_petercdev_torch.ops import cholesky
from gtsam_petercdev_torch.parallel import partition

SPHERE = (50, 50)  # rings, poses a ring
BA = (48, 1600, 3)  # cameras, points, views a point
PARTS = (1, 2, 4, 8)
BA_PARTS = (1, 2, 4)
SPHERE_LAM = 1e-5
BA_LAM = 1e-3


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ms(fn: Callable, dev: torch.device):
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return 1e3 * (time.perf_counter() - t0), out


def partitioned_rows(label: str, Ab, structure: Sequence[Dict], n: int, d: int,
                     ref_solve: Callable[[], torch.Tensor], lam: float, parts: Sequence[int],
                     to_ref: Optional[Callable] = None, reps: int = 4) -> List[Dict]:
    """Plan and solve the damped system Ab at each P in `parts`, on Ab's
    device. ref_solve() solves it the multifrontal way (x_ref), timed in
    alternation with the partitioned solve. to_ref maps a solution to
    x_ref's layout (sub-blocks merged). Each row: P, S, levels, ms,
    multifrontal_ms, ratio (the median over rounds of partitioned over
    multifrontal), GFLOP, launches (reset just before the first solve,
    read just after), the buckets' shapes (Bt, nf, ns, d), max_abs_diff /
    max_abs_x against x_ref, and whether every later solve was bitwise
    equal to the first."""
    dev = Ab[0][1].device
    to_ref = to_ref or (lambda x: x)
    x_ref = ref_solve()
    rows = []
    for P in parts:
        t0 = time.perf_counter()
        plan = partition.build_partitioned_plan(structure, n, d, P)
        solver = partition.PartitionedSolver(plan, device=dev)
        plan_s = time.perf_counter() - t0
        cholesky.reset_launch_counts()
        x = solver.solve(Ab, lam)
        _sync(dev)
        launches = cholesky.launch_counts()
        ts, ts_ref, ratios, bitwise = [], [], [], True
        for _ in range(reps):
            r0 = _ms(ref_solve, dev)[0]
            (t1, x1), (t2, x2) = (_ms(lambda: solver.solve(Ab, lam), dev) for _ in range(2))
            r1 = _ms(ref_solve, dev)[0]
            ts += [t1, t2]
            ts_ref += [r0, r1]
            ratios.append((t1 + t2) / (r0 + r1))
            bitwise = bitwise and torch.equal(x1, x) and torch.equal(x2, x)
        xr = to_ref(x)
        fl = partition.plan_padded_flops(plan)
        rows.append(dict(
            problem=label, parts=P, S=plan.S, levels=len(plan.levels),
            plan_s=plan_s, ms=float(np.median(ts)), multifrontal_ms=float(np.median(ts_ref)),
            ratio=float(np.median(ratios)),
            gflop_per_part=fl["interior_gflops_per_device"],
            gflop_separator=fl["separator_gflops_replicated"], launches=launches,
            shapes=[(lv.Bt, lv.nf, lv.ns, d) for lv in solver.folded.levels],
            max_abs_diff=(xr - x_ref).abs().max().item(), max_abs_x=x_ref.abs().max().item(),
            bitwise_repeat=bitwise))
    return rows


def sphere_rows(device: DeviceLike = "cuda", parts=PARTS, shape=SPHERE, dtype=torch.float64, reps=4):
    """The sphere's rows (partitioned_rows), its multifrontal solve on the
    optimizer's plan as the reference."""
    from gtsam_petercdev_torch.utils import convert, synthetic

    device = resolve_device(device)
    va, fa = synthetic.sphere_rings(*shape, seed=0)
    graph = convert.graph_from_arrays(fa, device=device, dtype=dtype)
    values = convert.values_from_arrays(va, device=device, dtype=dtype)
    lg = graph.linearize(values)
    Ab = tuple((lb.A, lb.b) for lb in lg.batches)
    _, maps = elimination._graph_plan(graph, lg)
    ref = lambda: elimination.multifrontal_solve(maps, Ab, SPHERE_LAM)
    structure, _ = partition.linearized_structure(lg)
    return partitioned_rows("sphere", Ab, structure, len(values), 6, ref, SPHERE_LAM, parts,
                            reps=reps)


def ba_rows(device: DeviceLike = "cuda", parts=BA_PARTS, shape=BA, dtype=torch.float64, reps=4):
    """The sub-block BA's rows against the mixed 9/3 multifrontal solve."""
    from gtsam_petercdev_torch.models.ba_synth import make_synthetic_ba
    from gtsam_petercdev_torch.models.bundle_adjustment import build_ba_graph

    device = resolve_device(device)
    graph, values = build_ba_graph(make_synthetic_ba(*shape, seed=0, dtype=np.float64),
                                   dtype=dtype, device=device)
    lg = graph.linearize(values)
    Ab = tuple((lb.A, lb.b) for lb in lg.batches)
    _, maps = elimination._graph_plan(graph, lg)
    ref = lambda: elimination.multifrontal_solve(maps, Ab, BA_LAM)
    structure, var_dims = partition.linearized_structure(lg)
    sub, base, n_sub = partition.split_structure_to_blocks(structure, var_dims, 3)
    return partitioned_rows(
        "ba", partition.split_Ab_to_blocks(Ab, structure, 3), sub, n_sub, 3, ref, BA_LAM, parts,
        to_ref=lambda x: partition.merge_block_solution(x, base, var_dims, 3), reps=reps)


def run(parts=PARTS, ba_parts=BA_PARTS, *, device: DeviceLike = "cuda", reps: int = 4) -> List[Dict]:
    """Every row of the sphere at `parts` and the BA rig at `ba_parts`."""
    dev = resolve_device(device)
    rows = []
    if parts:
        rows += sphere_rows(dev, parts, reps=reps)
    if ba_parts:
        rows += ba_rows(dev, ba_parts, reps=reps)
    return rows


def table(rows: List[Dict]) -> List[str]:
    """The rows as a markdown table."""
    out = ["| problem | P | S | levels | solve ms | multifrontal ms | ratio | padded GFLOP a part "
           "(+ separator) | launches K4/K3/K1/K2 | max abs diff (max abs x) | bitwise repeat |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        la = r["launches"]
        out.append(
            f"| {r['problem']} | {r['parts']} | {r['S']} | {r['levels']} | {r['ms']:.2f} | "
            f"{r['multifrontal_ms']:.2f} | {r['ratio']:.3f} | {r['gflop_per_part']:.3f} (+{r['gflop_separator']:.3f}) "
            f"| {la['partial_cholesky_blocks']}/{la['partial_cholesky_smem']}/"
            f"{la['partial_cholesky']}/{la['backsolve_bucket']} | {r['max_abs_diff']:.2e} "
            f"({r['max_abs_x']:.2e}) | {r['bitwise_repeat']} |")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    for line in table(run(device=args.device)):
        print(line, flush=True)


if __name__ == "__main__":
    main()
