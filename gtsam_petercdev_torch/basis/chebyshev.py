"""Chebyshev pseudospectral bases.

Port of gtsam_petercdev_tpu/basis/chebyshev.py (reference: gtsam/basis/
Chebyshev2.h:67-105: second-kind points, barycentric interpolation weights,
the differentiation matrix, Clenshaw-Curtis weights; gtsam/basis/
Chebyshev.h: the first-kind polynomial basis). The point, barycentric and
quadrature tables are computed in numpy on the host, as in the JAX package;
the weights at x are tensors on x's device (a non-tensor x goes to
`device`).
"""

from __future__ import annotations

import numpy as np
import torch

from gtsam_petercdev_torch.device import DeviceLike, resolve_device


def _as_tensor(x, device: DeviceLike):
    """x as a floating tensor: a tensor stays where it is, anything else
    goes to `device` in float64."""
    if torch.is_tensor(x):
        return x if x.is_floating_point() else x.to(torch.float64)
    return torch.as_tensor(np.asarray(x, dtype=np.float64)).to(resolve_device(device))


def _table(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype).to(like.device)


def chebyshev2_points(N: int, a: float = -1.0, b: float = 1.0) -> np.ndarray:
    """N Chebyshev points of the second kind on [a, b] (Chebyshev2::Points):
    x_j = cos(j pi / (N-1)), j = N-1..0, mapped ascending onto [a, b]."""
    if N == 1:
        return np.array([(a + b) / 2.0])
    j = np.arange(N)
    x = np.cos(j * np.pi / (N - 1))[::-1]  # ascending in [-1, 1]
    return (a + b) / 2.0 + (b - a) / 2.0 * x


def _bary_sign_weights(N: int) -> np.ndarray:
    """Barycentric weights of the Chebyshev-2 points: (-1)^j, halved ends."""
    w = np.ones(N)
    w[1::2] = -1.0
    w[0] *= 0.5
    w[-1] *= 0.5
    # the points are ascending = reversed cos order: flip the sign pattern
    return w[::-1].copy()


def chebyshev2_weights(N: int, x, a: float = -1.0, b: float = 1.0, *,
                       device: DeviceLike = "cuda"):
    """Interpolation row W(x) [..., N] with f(x) = W(x) @ f(points), in the
    barycentric form (Chebyshev2::CalculateWeights); an exact hit on a point
    is a mask, not a branch."""
    x = _as_tensor(x, device)
    pts = _table(chebyshev2_points(N, a, b), x)
    sw = _table(_bary_sign_weights(N), x)
    d = x[..., None] - pts
    hit = torch.abs(d) < 1e-12
    any_hit = torch.any(hit, dim=-1, keepdim=True)
    frac = sw / torch.where(hit, torch.ones_like(d), d)
    w_off = frac / torch.sum(frac, dim=-1, keepdim=True)
    return torch.where(any_hit, hit.to(w_off.dtype), w_off)


def chebyshev2_differentiation_matrix(N: int, a: float = -1.0, b: float = 1.0) -> np.ndarray:
    """D [N, N] with f'(points) = D @ f(points) (Chebyshev2::
    DifferentiationMatrix): the collocation matrix, negative-sum diagonal."""
    if N == 1:
        return np.zeros((1, 1))
    pts = chebyshev2_points(N, a, b)
    w = _bary_sign_weights(N)
    X = pts[:, None] - pts[None, :]
    np.fill_diagonal(X, 1.0)
    D = (w[None, :] / w[:, None]) / X
    np.fill_diagonal(D, 0.0)
    np.fill_diagonal(D, -D.sum(axis=1))
    return D


def chebyshev2_derivative_weights(N: int, x, a: float = -1.0, b: float = 1.0, *,
                                  device: DeviceLike = "cuda"):
    """Row W'(x) with f'(x) ~= W'(x) @ f(points): W(x) @ D."""
    W = chebyshev2_weights(N, x, a, b, device=device)
    return W @ _table(chebyshev2_differentiation_matrix(N, a, b), W)


def chebyshev2_integration_weights(N: int, a: float = -1.0, b: float = 1.0) -> np.ndarray:
    """Clenshaw-Curtis quadrature weights (Chebyshev2::IntegrationWeights)."""
    if N == 1:
        return np.array([b - a])
    n = N - 1
    theta = np.arange(N) * np.pi / n
    w = np.zeros(N)
    for j in range(N):
        s = 0.0
        for k in range(1, n // 2 + 1):
            term = 2.0 if 2 * k < n else 1.0
            s += term * np.cos(2 * k * theta[j]) / (4.0 * k * k - 1.0)
        w[j] = 1.0 - s
    w = w * 2.0 / n
    w[0] /= 2.0
    w[-1] /= 2.0
    return (w[::-1] * (b - a) / 2.0).copy()


def chebyshev1_weights(N: int, x, a: float = -1.0, b: float = 1.0, *,
                       device: DeviceLike = "cuda"):
    """First-kind polynomial row [T_0(t) .. T_{N-1}(t)] at t, the affine map
    of x to [-1, 1] (Chebyshev1Basis): T_k(t) = cos(k arccos t)."""
    x = _as_tensor(x, device)
    t = torch.clamp((2.0 * x - (a + b)) / (b - a), -1.0, 1.0)
    k = torch.arange(N, dtype=x.dtype, device=x.device)
    return torch.cos(k * torch.arccos(t)[..., None])
