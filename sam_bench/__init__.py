"""The benchmark of the PyTorch and CUDA port (`gtsam_petercdev_torch`).

One command runs one cell once:

    python3 -m sam_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

`BENCHMARK.json` at the repository root lists the cells and metrics. The
harness is driven by data: a cell names a configuration (a JSON file under
`configs/`, which names its generator under `generators/` and its plain
reference under `reference/`) and a traffic mix (a JSON file under
`traffic/`, which names its runner under `runners/`); each per-layer metric
is a reader of its own under `metrics/`; each cell's correctness limits are
a JSON file under `limits/`. A later cell, configuration or metric is new
files plus new `BENCHMARK.json` entries.

Nothing here imports JAX or the JAX package; the reference imports nothing
of the port.
"""
