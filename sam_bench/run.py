"""Run one cell of the benchmark once and print its result line.

    python3 -m sam_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With --trace 0 the line holds the cell's end-to-end metrics, with --trace 1
its per-layer metrics (a profiled run). The last line of standard output is
one JSON object; the last lines of standard error give each compared number
beside its limit. The run exits non-zero, and prints no result, without
enough CUDA devices, when the port cannot be imported, or when JAX or the
JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "gtsam_petercdev_tpu")


def _cache_dirs(root: str) -> None:
    """Keep every build and kernel cache inside the checkout, at fixed paths
    (the port builds its kernels into gtsam_petercdev_torch/_build)."""
    cache = os.path.join(root, ".sam_bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from sam_bench import spec

    _cache_dirs(spec.ROOT)
    import torch

    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"sam_bench: {args.workload} needs {cell.chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2

    from sam_bench import harness

    out = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"sam_bench: loaded {bad}; the port's run may load no JAX", file=sys.stderr)
        return 3
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
