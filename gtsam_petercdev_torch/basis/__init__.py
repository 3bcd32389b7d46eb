"""Function bases (port of gtsam_petercdev_tpu/basis; reference: gtsam/
basis/ — Chebyshev2.h, FourierBasis, FitBasis.h). Every basis is a dense
weight-row generator, so evaluating or differentiating a fitted function is
one product."""

from gtsam_petercdev_torch.basis.chebyshev import (  # noqa: F401
    chebyshev1_weights,
    chebyshev2_derivative_weights,
    chebyshev2_differentiation_matrix,
    chebyshev2_integration_weights,
    chebyshev2_points,
    chebyshev2_weights,
)
from gtsam_petercdev_torch.basis.fit import FitBasis, evaluation_factor  # noqa: F401
from gtsam_petercdev_torch.basis.fourier import (  # noqa: F401
    fourier_derivative_weights,
    fourier_weights,
)
