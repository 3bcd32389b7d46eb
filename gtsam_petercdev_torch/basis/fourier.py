"""Fourier basis (port of gtsam_petercdev_tpu/basis/fourier.py; reference:
gtsam/basis/Fourier.h FourierBasis). For N coefficients the row is
[1, cos x, sin x, cos 2x, sin 2x, ...] cut to N entries, so a fitted
function is f(x) = W(x) @ c; the derivative rows are exact too. Rows are
tensors on x's device (a non-tensor x goes to `device`)."""

from __future__ import annotations

import torch

from gtsam_petercdev_torch.basis.chebyshev import _as_tensor
from gtsam_petercdev_torch.device import DeviceLike


def fourier_weights(N: int, x, *, device: DeviceLike = "cuda"):
    """Evaluation row [..., N]: 1, cos x, sin x, cos 2x, sin 2x, ..."""
    x = _as_tensor(x, device)
    cols = [torch.ones_like(x)]
    k = 1
    while len(cols) < N:
        cols.append(torch.cos(k * x))
        if len(cols) < N:
            cols.append(torch.sin(k * x))
        k += 1
    return torch.stack(cols, dim=-1)


def fourier_derivative_weights(N: int, x, *, device: DeviceLike = "cuda"):
    """d/dx of fourier_weights: 0, -k sin kx, k cos kx, ..."""
    x = _as_tensor(x, device)
    cols = [torch.zeros_like(x)]
    k = 1
    while len(cols) < N:
        cols.append(-k * torch.sin(k * x))
        if len(cols) < N:
            cols.append(k * torch.cos(k * x))
        k += 1
    return torch.stack(cols, dim=-1)
