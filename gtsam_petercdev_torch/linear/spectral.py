"""Power iteration eigensolvers (matrix-free).

Port of gtsam_petercdev_tpu/linear/spectral.py, the analog of the
reference's `PowerMethod` / `AcceleratedPowerMethod`
(gtsam/linear/PowerMethod.h, AcceleratedPowerMethod.h) used by Shonan
averaging's optimality certificate. The operator is a matvec closure, so it
runs matrix-free over factor-graph Laplacians, on the vectors' device.
JAX's `lax.while_loop` is a Python loop here with the same stopping test:
each test is one device -> host read of a comparison.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class PowerResult(NamedTuple):
    eigenvalue: torch.Tensor
    eigenvector: torch.Tensor
    iterations: int
    converged: bool


def _normalized(w: torch.Tensor) -> torch.Tensor:
    return w / torch.clamp(torch.linalg.norm(w), min=1e-300)


def _rayleigh(matvec, v):
    return torch.sum(v * matvec(v))


def _iterate(step, v0, tol, max_iters):
    """v <- step(v, v_prev) until it moves less than tol or max_iters."""
    v, prev, it, done = v0, v0, 0, False
    while it < max_iters and not done:
        w = _normalized(step(v, prev))
        done = bool(torch.linalg.norm(w - v) < tol)
        v, prev, it = w, v, it + 1
    return v, it, done


def power_method(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    v0: torch.Tensor,
    tol: float = 1e-9,
    max_iters: int = 1000,
) -> PowerResult:
    """Dominant eigenpair of the symmetric operator `matvec`.

    Mirrors PowerMethod::compute (gtsam/linear/PowerMethod.h:96-160): iterate
    v <- A v / ||A v||, Rayleigh quotient for the eigenvalue, stop when the
    iterate moves less than tol."""
    v, it, done = _iterate(lambda v, _prev: matvec(v), v0 / torch.linalg.norm(v0), tol,
                           max_iters)
    return PowerResult(_rayleigh(matvec, v), v, it, done)


def accelerated_power_method(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    v0: torch.Tensor,
    beta: Optional[float] = None,
    tol: float = 1e-9,
    max_iters: int = 1000,
) -> PowerResult:
    """Chebyshev-accelerated power iteration
    (gtsam/linear/AcceleratedPowerMethod.h:33-130):

        v_{k+1} = A v_k - beta * v_{k-1},  renormalized.

    With beta ~ (lambda_2 / 2)^2 the convergence rate improves from
    O(lambda_2/lambda_1) to O(sqrt(.)). If beta is None, estimate it with a
    few plain power iterations (the reference's estimateBeta)."""
    v0 = v0 / torch.linalg.norm(v0)
    if beta is None:
        # estimateBeta: Rayleigh quotient after a short burn-in
        v = v0
        for _ in range(8):
            v = _normalized(matvec(v))
        lam_est = _rayleigh(matvec, v)
        beta_val = lam_est * lam_est / 4.0
    else:
        beta_val = torch.as_tensor(beta, dtype=v0.dtype, device=v0.device)
    v, it, done = _iterate(lambda v, prev: matvec(v) - beta_val * prev, v0, tol, max_iters)
    return PowerResult(_rayleigh(matvec, v), v, it, done)


def min_eigenvalue_shifted(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    dim: int,
    v0: torch.Tensor,
    tol: float = 1e-7,
    max_iters: int = 2000,
) -> PowerResult:
    """Minimum eigenvalue of a symmetric PSD-ish operator via the spectral
    shift trick the reference uses for the Shonan certificate
    (sfm/ShonanAveraging.cpp computeMinEigenValue): first find lambda_max of
    A, then the dominant eigenpair of (lambda_max I - A) gives lambda_min."""
    top = power_method(matvec, v0, tol=tol, max_iters=max_iters)
    lam_max = torch.clamp(top.eigenvalue, min=0.0) * 1.01 + 1e-6

    def shifted(v):
        return lam_max * v - matvec(v)

    bottom = accelerated_power_method(shifted, v0, tol=tol, max_iters=max_iters)
    return PowerResult(lam_max - bottom.eigenvalue, bottom.eigenvector, bottom.iterations,
                       bottom.converged)
