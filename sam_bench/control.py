"""The control of the correctness check: the port's own float32 path (the
precision below the configuration's float64; TF32 off), run as a cell's
timed path runs, and compared with the float64 reference by the cell's own
numbers. It has to come out not correct; its smallest readings over seeds
are the upper readings the limits are set below.

    python3 -m sam_bench.control --workload <cell> --seeds <n> [<n> ...]

prints one JSON line a seed: the compared numbers of the control and, with
--program 1, of one port solve in the configuration's precision too (its
lower readings, no window). Runs on the cell's own sizes on the card; it is
not part of a benchmark run."""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

LOWER = {"float64": "float32"}  # the precision a control runs in


def port_solve(cell, seed: int, device: str, dtype: str):
    """One port solve of the cell's problem in `dtype`, as the window runs
    it: (the context holding its history and final values, freed of the
    port's state)."""
    import torch

    from sam_bench import harness, spec
    from sam_bench.runners import lm_solves

    cell = dataclasses.replace(cell, config=dict(cell.config, dtype=dtype))
    ctx = harness.Context(torch, torch.device(device), cell, seed)
    ctx.problem = spec.module("generators", cell.config["generator"]).make(cell.config, seed)
    ctx.reference = spec.module("reference", cell.config["reference"])
    lm_solves.setup(ctx)
    lm_solves._record(ctx, lm_solves._solve(ctx), None, 1)
    lm_solves.release(ctx)
    return ctx


def readings(cell, seed: int, device: str, program: bool = False) -> dict:
    from sam_bench.runners import lm_solves

    out = {"workload": cell.name, "seed": seed}
    if program:
        ctx = port_solve(cell, seed, device, cell.config["dtype"])
    low = port_solve(cell, seed, device, LOWER[cell.config["dtype"]])
    t0 = time.perf_counter()
    ref_history, ref_state = lm_solves.reference(low)
    out["reference_s"] = time.perf_counter() - t0
    if program:
        out["program"] = lm_solves.gaps(ctx.histories, ctx.states, ref_history, ref_state)
    out["control"] = lm_solves.gaps(low.histories, low.states, ref_history, ref_state)
    out["histories"] = {"reference": ref_history, "control": low.histories[0]}
    lim = cell.limits
    out["control_correct"] = all(out["control"][k] <= lim[k] for k in lim)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from sam_bench import run, spec

    run._cache_dirs(spec.ROOT)
    import torch

    cell = spec.cell(spec.benchmark(), args.workload)
    if not torch.cuda.is_available():
        print("sam_bench.control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, "cuda", bool(args.program))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
