"""gtsam_petercdev_torch — the PyTorch/CUDA port of gtsam_petercdev_tpu.

The JAX package `gtsam_petercdev_tpu/` is the reference; this package mirrors
its module paths and public names. Plain tensor code is PyTorch; the Pallas
TPU kernels on the ported path are hand-written CUDA kernels for Hopper
(`csrc/`, built by `ops/build.py`), each with a plain PyTorch version beside
it that CPU tensors take.

Device rule: every public entry point takes `device=` and defaults to
"cuda"; without a CUDA device it raises unless the caller passes
`device="cpu"` (see `device.py`).

Ported so far (the batch Pose3 solve and bundle adjustment):
  core/       manifold registry, keys / symbols
  geometry/   so3, rot2, pose2, pose3, calibrations, cameras
  linear/     noise models, dense solve and matrix-free products
  nonlinear/  Values, NonlinearFactorGraph, GN / LM
  slam/       prior / between factors (analytic Pose3 Jacobians),
              projection factors
  sfm/        SfmCamera manifold, BAL reader, landmark Schur solver
  models/     synthetic BA rigs, the bundle-adjustment pipeline
  inference/  symbolic planner, plain bucket kernels, multifrontal solver
  ops/        the four CUDA bucket kernels: partial Cholesky (global-memory
              and shared-memory working copy, dense and block-pool input)
              and the fused backsolve
  utils/      numpy -> port conversion, synthetic Pose3 ring graphs
"""

__version__ = "0.1.0"
