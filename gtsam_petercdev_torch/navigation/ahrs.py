"""AHRS: preintegrated rotation-only measurements + AHRSFactor.

Port of gtsam_petercdev_tpu/navigation/ahrs.py (reference: navigation/
PreintegratedRotation.{h,cpp}: deltaRij, 3x3 rotation covariance, bias
Jacobian delRdelBiasOmega; navigation/AHRSFactor.h: a 3-way factor on Rot_i,
Rot_j, gyro bias). `preintegrate_rotation` loops over the samples with each
step batched over K intervals, as preintegration.preintegrate does.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from gtsam_petercdev_torch.device import as_float, resolve_device
from gtsam_petercdev_torch.geometry import so3
from gtsam_petercdev_torch.nonlinear.factor_graph import FactorType


class PreintegratedRotation(NamedTuple):
    deltaR: torch.Tensor  # [..., 3, 3]
    delRdelBiasOmega: torch.Tensor  # [..., 3, 3]
    cov: torch.Tensor  # [..., 3, 3] rotation covariance
    bias_hat: torch.Tensor  # [..., 3] gyro bias used during integration
    deltaT: torch.Tensor  # [...]


def rotation_init(bias_hat=None, dtype=torch.float64, device="cuda",
                  batch_shape=()) -> PreintegratedRotation:
    """Empty PreintegratedRotation of `batch_shape` intervals (or bias_hat's
    leading dims)."""
    dev = resolve_device(device)
    if bias_hat is not None:
        bias_hat = as_float(bias_hat).to(device=dev, dtype=dtype)
        batch_shape = tuple(bias_hat.shape[:-1])
    batch_shape = tuple(batch_shape)
    z = lambda *s: torch.zeros(batch_shape + s, dtype=dtype, device=dev)
    return PreintegratedRotation(
        deltaR=torch.eye(3, dtype=dtype, device=dev).expand(batch_shape + (3, 3)).clone(),
        delRdelBiasOmega=z(3, 3),
        cov=z(3, 3),
        bias_hat=z(3) if bias_hat is None else bias_hat,
        deltaT=z(),
    )


def integrate_rotation(pre: PreintegratedRotation, gyro_cov, omega, dt) -> PreintegratedRotation:
    """One gyro sample per interval (PreintegratedRotation::
    integrateGyroMeasurement): omega [..., 3], dt [...] (or a number), dt > 0."""
    dt = torch.as_tensor(dt, dtype=pre.cov.dtype, device=pre.cov.device)
    dtv, dtm = dt[..., None], dt[..., None, None]
    w = omega - pre.bias_hat
    wdt = w * dtv
    incrR = so3.expmap(wdt)
    Jr = so3.expmap_derivative(wdt)
    incrRT = incrR.transpose(-1, -2)
    new_H = incrRT @ pre.delRdelBiasOmega - Jr * dtm
    Jdt = Jr * dtm
    cov = incrRT @ pre.cov @ incrR + Jdt @ (gyro_cov / dtm) @ Jdt.transpose(-1, -2)
    return PreintegratedRotation(
        deltaR=pre.deltaR @ incrR,
        delRdelBiasOmega=new_H,
        cov=cov,
        bias_hat=pre.bias_hat,
        deltaT=pre.deltaT + dt,
    )


def preintegrate_rotation(gyro_cov, omegas, dts, bias_hat=None) -> PreintegratedRotation:
    """One stream (omegas [S, 3], dts [S]: the JAX signature) or K intervals
    at once (omegas [K, S, 3], dts [K, S]): a loop of S steps, each batched
    over the intervals. Every interval has S samples, each dt > 0."""
    omegas = as_float(omegas)
    dts = as_float(dts, omegas)
    single = omegas.ndim == 2
    if single:
        omegas, dts = omegas[None], dts[None]
    K = omegas.shape[0]
    if bias_hat is not None:
        bias_hat = as_float(bias_hat, omegas).expand(K, 3)
    gyro_cov = as_float(gyro_cov, omegas)
    pre = rotation_init(bias_hat, dtype=omegas.dtype, device=omegas.device, batch_shape=(K,))
    for s in range(omegas.shape[1]):
        pre = integrate_rotation(pre, gyro_cov, omegas[:, s], dts[:, s])
    if single:
        pre = PreintegratedRotation(*(f[0] for f in pre))
    return pre


def bias_corrected_deltaR(pre: PreintegratedRotation, bias):
    """biasCorrectedDeltaRij: deltaR * Exp(H (b - b_hat))."""
    incr = bias - pre.bias_hat
    return pre.deltaR @ so3.expmap((pre.delRdelBiasOmega @ incr[..., None])[..., 0])


@lru_cache(maxsize=None)
def ahrs_factor() -> FactorType:
    """Vars (Rot3_i, Rot3_j, Vector3 gyro bias); params = a PreintegratedRotation.
    r = Log((Ri^T Rj)^T * deltaR_corrected) (AHRSFactor::evaluateError).
    Whiten with the inverse square root of pre.cov."""

    def residual(xs, params):
        Ri, Rj, bias = xs
        corrected = bias_corrected_deltaR(params, bias)
        actual = so3.between(Ri, Rj)
        return so3.logmap(so3.between(actual, corrected))

    return FactorType(
        name="AHRSFactor",
        var_types=("Rot3", "Rot3", "Vector3"),
        resid_dim=3,
        residual=residual,
    )
