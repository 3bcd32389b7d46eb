"""FitBasis: least-squares fit of basis coefficients to samples.

Port of gtsam_petercdev_tpu/basis/fit.py (reference: gtsam/basis/
FitBasis.h:52, which builds EvaluationFactors from samples and solves the
linear graph). Here the normal equations (W^T W + 1e-12 I) c = W^T y are
two products and one `torch.linalg.solve`; `evaluation_factor` is the same
measurement as a FactorType for any nonlinear graph.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from gtsam_petercdev_torch.core import manifold
from gtsam_petercdev_torch.device import DeviceLike, resolve_device
from gtsam_petercdev_torch.nonlinear.factor_graph import FactorType


def _coeff_type(N: int) -> str:
    """The value type "Vector<N>" of N coefficients, registered on first use."""
    name = f"Vector{N}"
    try:
        manifold.get(name)
    except KeyError:
        manifold.register(manifold.vector_space(name, N))
    return name


def evaluation_factor(N: int, weight_fn: Callable) -> FactorType:
    """A factor on a coefficient vector: r = W(x) @ c - y
    (gtsam/basis/BasisFactors.h EvaluationFactor). params = {"x": sample
    point, "y": measurement}, [...] each over a batch; weight_fn(N, x) ->
    [..., N] (e.g. chebyshev2_weights). Named "BasisEval<N>_<weight_fn>"."""
    tname = _coeff_type(N)

    def residual(xs, params):
        (c,) = xs
        w = weight_fn(N, params["x"])
        return (torch.sum(w * c, dim=-1) - params["y"])[..., None]

    return FactorType(
        name=f"BasisEval{N}_{getattr(weight_fn, '__name__', 'w')}",
        var_types=(tname,),
        resid_dim=1,
        residual=residual,
    )


class FitBasis:
    """Least-squares basis fit on `device`; .coefficients [N] (or [N, k] for
    k-column samples) ready for W(x) @ c."""

    def __init__(self, xs, ys, N: int, weight_fn: Callable, *, device: DeviceLike = "cuda"):
        dev = resolve_device(device)

        def conv(a):
            a = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a, dtype=np.float64))
            return a.to(dev)

        xs, ys = conv(xs), conv(ys)
        W = weight_fn(N, xs)  # [M, N]
        WtW = W.T @ W
        Wty = W.T @ ys
        self.N = N
        self.weight_fn = weight_fn
        self.coefficients = torch.linalg.solve(
            WtW + 1e-12 * torch.eye(N, dtype=WtW.dtype, device=dev), Wty)

    def __call__(self, x):
        c = self.coefficients
        x = x.to(c.device) if torch.is_tensor(x) else torch.as_tensor(
            np.asarray(x, dtype=np.float64)).to(c.device)
        return self.weight_fn(self.N, x) @ c
