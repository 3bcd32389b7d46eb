"""gtsam_petercdev_torch — the PyTorch/CUDA port of gtsam_petercdev_tpu.

The JAX package `gtsam_petercdev_tpu/` is the reference; this package mirrors
its module paths and public names. Plain tensor code is PyTorch; the Pallas
TPU kernels on the ported path are hand-written CUDA kernels for Hopper
(`csrc/`, built by `ops/build.py`), each with a plain PyTorch version beside
it that CPU tensors take.

Device rule: every public entry point takes `device=` and defaults to
"cuda"; without a CUDA device it raises unless the caller passes
`device="cpu"` (see `device.py`).

The port mirrors every module of the JAX package but its native/ loader
(the port loads no shared library of the JAX package); the root re-exports
Symbol, symbol, symbol_chr and symbol_index from core/keys.py, as the JAX
package's root does:
  core/       manifold registry, keys / symbols
  geometry/   so3, rot2, pose2, pose3, calibrations, cameras
  linear/     noise models, dense solve and matrix-free products
  nonlinear/  Values, NonlinearFactorGraph, GN / LM, ISAM2
  slam/       prior / between factors (analytic Pose3 Jacobians),
              projection factors
  sfm/        SfmCamera manifold, BAL reader, landmark Schur solver
  models/     synthetic BA rigs, the bundle-adjustment pipeline, the
              City10000 harness
  inference/  symbolic planner, plain bucket kernels, multifrontal solver,
              the incremental Bayes-tree engine
  ops/        the four CUDA bucket kernels: partial Cholesky (global-memory
              and shared-memory working copy, dense and block-pool input)
              and the fused backsolve
  utils/      numpy -> port conversion, synthetic Pose3 ring graphs and a
              City10000-like Pose2 stream (and its Hybrid City variant),
              g2o / TORO I/O, the solver comparer, timers, debug flags,
              DOT export
  discrete/   dense-table discrete factor graphs, exact k-best search
  hybrid/     hybrid Gaussian factor graphs (dense, and every hypothesis
              folded into the multifrontal kernels' buckets), the
              HybridSmoother; models/hybrid_city.py the Hybrid_City10000
              harness
"""

__version__ = "0.1.0"

from gtsam_petercdev_torch.core.keys import Symbol, symbol, symbol_chr, symbol_index
