#!/usr/bin/env python3
"""Record how far float32 partitioned solves land from the float64 solve
of chip_smoke.py phase 11's system, to tests/data/partitioned_f32_reference.json.

    python3 tools/partitioned_f32_reference.py     (~2 minutes, ~4.5 GB)

The system: `utils/synthetic.sphere_rings(50, 50, seed=0)` (phase 4's
sphere), linearized at its initial values, damped by lambda 1e-5, in P = 4
parts. The reference is the port's float64 multifrontal solve on the CPU.
Each entry is max|x - x_f64| / max|x_f64| of one float32 solve of the same
float32 linearization, on the CPU:
  jax_partitioned_float32     the JAX package's PartitionedSolver, one part
                              per device of a virtual 4-device CPU mesh
  port_partitioned_float32    the port's PartitionedSolver, device="cpu"
                              (the bucket kernels' plain versions)
  port_partitioned_float32_separator_float64
                              the same, with only the dense separator
                              Cholesky and its solve taken in float64
  port_multifrontal_float32   the port's multifrontal solve
`chip_smoke.py` phase 11 b) holds the card's float32 partitioned solve to
the JAX package's reading: the port may not be further from float64 than
the reference implementation is on the same system.
"""

import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4").strip()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "partitioned_f32_reference.json")
SHAPE = (50, 50)
SEED = 0
LAM = 1e-5
PARTS = 4


class _SeparatorInFloat64:
    """While open, torch.linalg.cholesky_ex and torch.cholesky_solve (in
    the partitioned solver, only its separator system calls them) work in
    float64 and hand back the caller's dtype."""

    def __enter__(self):
        import torch

        self.torch, self.saved = torch, (torch.linalg.cholesky_ex, torch.cholesky_solve)
        chol, solve = self.saved

        def cholesky_ex(a, *args, **kw):
            L, info = chol(a.double(), *args, **kw)
            self.dtype = a.dtype
            return L, info

        torch.linalg.cholesky_ex = cholesky_ex
        torch.cholesky_solve = lambda b, L, *a, **k: solve(b.double(), L, *a, **k).to(self.dtype)
        return self

    def __exit__(self, *exc):
        self.torch.linalg.cholesky_ex, self.torch.cholesky_solve = self.saved


def main():
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch
    from jax.sharding import Mesh

    from gtsam_petercdev_torch.inference import elimination
    from gtsam_petercdev_torch.parallel import partition
    from gtsam_petercdev_torch.utils import convert, synthetic
    from gtsam_petercdev_tpu.parallel import partition as j_partition

    t0 = time.perf_counter()
    va, fa = synthetic.sphere_rings(*SHAPE, seed=SEED)
    lin = {}
    for dt in (torch.float64, torch.float32):
        g = convert.graph_from_arrays(fa, device="cpu", dtype=dt)
        v = convert.values_from_arrays(va, device="cpu", dtype=dt)
        lin[dt] = (g, v, g.linearize(v))
    g64, v64, lg64 = lin[torch.float64]
    Ab64 = tuple((lb.A, lb.b) for lb in lg64.batches)
    Ab32 = tuple((lb.A, lb.b) for lb in lin[torch.float32][2].batches)
    _, maps = elimination._graph_plan(g64, lg64)
    x64 = elimination.multifrontal_solve(maps, Ab64, LAM)
    scale = x64.abs().max().item()

    def rel(x):
        return float((torch.as_tensor(np.asarray(x)).double() - x64).abs().max().item() / scale)

    structure, _ = partition.linearized_structure(lg64)
    n = len(v64)
    out = {"port_multifrontal_float32": rel(elimination.multifrontal_solve(maps, Ab32, LAM))}
    solver = partition.PartitionedSolver(partition.build_partitioned_plan(structure, n, 6, PARTS),
                                         device="cpu")
    out["port_partitioned_float32"] = rel(solver.solve(Ab32, LAM))
    with _SeparatorInFloat64():
        out["port_partitioned_float32_separator_float64"] = rel(solver.solve(Ab32, LAM))
    del solver
    jplan = j_partition.build_partitioned_plan(structure, n, 6, PARTS)
    mesh = Mesh(np.array(jax.devices()[:PARTS]), ("parts",))
    jAb = tuple((tuple(jnp.asarray(a.numpy()) for a in A), jnp.asarray(b.numpy())) for A, b in Ab32)
    out["jax_partitioned_float32"] = rel(j_partition.PartitionedSolver(jplan, mesh).solve(jAb, LAM))
    rec = dict(shape=list(SHAPE), seed=SEED, lam=LAM, parts=PARTS, max_abs_x=scale,
               rel_to_float64=out, seconds=round(time.perf_counter() - t0, 1))
    with open(OUT, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
