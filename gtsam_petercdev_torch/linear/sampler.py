"""Sampler: draw Gaussian samples consistent with a noise model.

Port of gtsam_petercdev_tpu/linear/sampler.py. Reference:
gtsam/linear/Sampler.{h,cpp} — samples eps with cov(eps) = Sigma for a
Diagonal model (sigmas * N(0, I)) and, generally, solves R eps = z for a
full sqrt-information model. A `torch.Generator` on the tensors' device
replaces the reference's mutable std::mt19937 state (JAX: a PRNG key); the
draws differ from JAX's, their distribution does not.
"""

from __future__ import annotations

import torch

from gtsam_petercdev_torch.device import as_float


def sample_diagonal(generator: torch.Generator, sigmas, shape=()):
    """eps ~ N(0, diag(sigmas^2)); shape prepends batch dims
    (Sampler::sampleDiagonal)."""
    sigmas = as_float(sigmas)
    z = torch.randn(tuple(shape) + tuple(sigmas.shape), generator=generator,
                    dtype=sigmas.dtype, device=sigmas.device)
    return z * sigmas


def sqrt_info_transform(sqrt_info, z):
    """eps with sqrt_info @ eps = z, for standard normal draws z [..., d]: one
    solve with every draw as a right-hand side."""
    R = as_float(sqrt_info, z)
    d = R.shape[-1]
    if R.ndim == 2:
        return torch.linalg.solve(R, z.reshape(-1, d).T).T.reshape(z.shape)
    return torch.linalg.solve(R.expand(z.shape[:-1] + (d, d)), z[..., None])[..., 0]


def sample_sqrt_info(generator: torch.Generator, sqrt_info, shape=()):
    """eps with sqrt_info @ eps ~ N(0, I): solve R eps = z (general Gaussian
    noise model; Sampler::sample on a non-diagonal model)."""
    R = as_float(sqrt_info)
    z = torch.randn(tuple(shape) + (R.shape[-1],), generator=generator, dtype=R.dtype,
                    device=R.device)
    return sqrt_info_transform(R, z)
