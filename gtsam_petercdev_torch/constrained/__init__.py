"""Constrained optimization (port of gtsam_petercdev_tpu/constrained;
reference: gtsam/constrained/ — NonlinearEqualityConstraint.h,
NonlinearInequalityConstraint.h, the penalty building blocks)."""

from gtsam_petercdev_torch.constrained.constrained import (  # noqa: F401
    EqualityConstraint,
    InequalityConstraint,
    PenaltyParams,
    augmented_lagrangian_optimize,
    penalty_optimize,
)
