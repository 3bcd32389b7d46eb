"""Noise models and robust loss functions.

Port of gtsam_petercdev_tpu/linear/noise.py. Every noise model is one dense
square-root information matrix `sqrt_info [..., d, d]` with
whitened = sqrt_info @ raw and Sigma^{-1} = sqrt_info^T sqrt_info;
Diagonal/Isotropic/Unit are constructors that fill the dense form.

The constructors return host numpy arrays, as in the JAX package: they are
factor data, and `NonlinearFactorGraph` moves them to its device and dtype.

Constrained rows (sigma == 0): `diagonal_sigmas` applies a large-but-finite
weight mu; `constrained_sigmas` / `constrained_all` flag the rows for an
exact constrained solve (linear/qr.py, the dense solver's constrained
branch).

Robust m-estimators are weight functions w(||r||) applied as IRLS row
scaling at linearization time.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

DEFAULT_CONSTRAINED_MU = 1e4  # sqrt weight for sigma==0 rows


def isotropic(dim: int, sigma: float, dtype=np.float32) -> np.ndarray:
    """Isotropic(sigma): sqrt_info = I / sigma."""
    return np.eye(dim, dtype=dtype) / sigma


def unit(dim: int, dtype=np.float32) -> np.ndarray:
    return np.eye(dim, dtype=dtype)


def diagonal_sigmas(sigmas, mu: float = DEFAULT_CONSTRAINED_MU) -> np.ndarray:
    """Diagonal::Sigmas; sigma==0 rows become hard-ish constraints (weight mu)."""
    sigmas = np.asarray(sigmas)
    w = np.where(sigmas == 0.0, mu, 1.0 / np.where(sigmas == 0.0, 1.0, sigmas))
    d = sigmas.shape[-1]
    return w[..., :, None] * np.eye(d, dtype=sigmas.dtype)


def constrained_sigmas(sigmas):
    """Diagonal::Sigmas with EXACT sigma==0 constraints.

    Returns (sqrt_info, constrained_mask): constrained rows carry weight 1
    and the mask flags them for the exact constrained solve."""
    sigmas = np.asarray(sigmas)
    mask = sigmas == 0.0
    w = np.where(mask, 1.0, 1.0 / np.where(mask, 1.0, sigmas))
    d = sigmas.shape[-1]
    return w[..., :, None] * np.eye(d, dtype=sigmas.dtype), mask


def constrained_all(dim: int, dtype=np.float64):
    """Constrained::All — every row an exact equality."""
    return np.eye(dim, dtype=dtype), np.ones(dim, dtype=bool)


def diagonal_precisions(precisions) -> np.ndarray:
    p = np.asarray(precisions)
    d = p.shape[-1]
    return np.sqrt(p)[..., :, None] * np.eye(d, dtype=p.dtype)


def gaussian_information(info) -> np.ndarray:
    """Gaussian::Information — sqrt_info = chol(Info)^T so that R^T R = Info."""
    info = np.asarray(info)
    dtype = info.dtype if info.dtype in (np.float32, np.float64) else np.float64
    info = 0.5 * (info + np.swapaxes(info, -1, -2))
    # tolerate PSD-with-zeros information (partial information blocks)
    d = info.shape[-1]
    jitter = (1e-12 if dtype == np.float64 else 1e-6) * np.eye(d, dtype=dtype)
    L = np.linalg.cholesky((info + jitter).astype(dtype))
    return np.swapaxes(L, -1, -2)


def gaussian_covariance(cov) -> np.ndarray:
    return gaussian_information(np.linalg.inv(np.asarray(cov)))


# --- robust losses ------------------------------------------------------------
# Each loss is (loss(e), weight(e)) of the residual norm e = ||whitened r||.
# weight is the IRLS factor applied to rows: sqrt(w) scaling of (A, b).


@dataclass(frozen=True)
class RobustLoss:
    name: str
    k: float = 1.0

    def weight(self, e: torch.Tensor) -> torch.Tensor:
        k = self.k
        ae = torch.abs(e)
        safe = torch.where(ae < 1e-12, torch.full_like(ae, 1e-12), ae)
        one = torch.ones_like(e)
        if self.name == "huber":
            return torch.where(ae <= k, one, k / safe)
        if self.name == "cauchy":
            return k * k / (k * k + e * e)
        if self.name == "tukey":
            u = 1.0 - (e / k) ** 2
            return torch.where(ae <= k, u * u, torch.zeros_like(e))
        if self.name == "geman_mcclure":
            return (k**4) / (k * k + e * e) ** 2
        if self.name == "welsch":
            return torch.exp(-(e * e) / (k * k))
        if self.name == "fair":
            return 1.0 / (1.0 + safe / k)
        if self.name == "dcs":
            # dynamic covariance scaling: w = min(1, 2k/(k+e^2))
            return torch.minimum(one, 2.0 * k / (k + e * e))
        if self.name == "l2":
            return one
        raise ValueError(f"unknown robust loss {self.name}")

    def loss(self, e: torch.Tensor) -> torch.Tensor:
        """rho(e) with rho'(e)/e = weight; used for graph error reporting."""
        k = self.k
        ae = torch.abs(e)
        if self.name == "huber":
            return torch.where(ae <= k, 0.5 * e * e, k * (ae - 0.5 * k))
        if self.name == "cauchy":
            return 0.5 * k * k * torch.log1p(e * e / (k * k))
        if self.name == "tukey":
            u = 1.0 - (e / k) ** 2
            inside = (k * k / 6.0) * (1.0 - u**3)
            return torch.where(ae <= k, inside, torch.full_like(e, k * k / 6.0))
        if self.name == "geman_mcclure":
            return 0.5 * (k * k * e * e) / (k * k + e * e)
        if self.name == "welsch":
            return 0.5 * k * k * (1.0 - torch.exp(-(e * e) / (k * k)))
        if self.name == "fair":
            return k * k * (ae / k - torch.log1p(ae / k))
        if self.name == "dcs":
            w = torch.minimum(torch.ones_like(e), 2.0 * k / (k + e * e))
            return 0.5 * w * e * e  # Agarwal'13 scaled form
        if self.name == "l2":
            return 0.5 * e * e
        raise ValueError(f"unknown robust loss {self.name}")


def huber(k: float = 1.345) -> RobustLoss:
    return RobustLoss("huber", k)


def cauchy(k: float = 0.1) -> RobustLoss:
    return RobustLoss("cauchy", k)


def tukey(k: float = 4.6851) -> RobustLoss:
    return RobustLoss("tukey", k)


def geman_mcclure(k: float = 1.0) -> RobustLoss:
    return RobustLoss("geman_mcclure", k)


def welsch(k: float = 2.9846) -> RobustLoss:
    return RobustLoss("welsch", k)


def fair(k: float = 1.3998) -> RobustLoss:
    return RobustLoss("fair", k)


def dcs(k: float = 1.0) -> RobustLoss:
    return RobustLoss("dcs", k)
