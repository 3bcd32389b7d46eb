"""IMU preintegration, batched over intervals.

Port of gtsam_petercdev_tpu/navigation/preintegration.py: the reference's
ManifoldPreintegration state (gtsam/navigation/ManifoldPreintegration.{h,cpp}:
deltaR / deltaP / deltaV and the five bias Jacobians) with the 9x9
covariance propagation of PreintegratedImuMeasurements::integrateMeasurement
(ImuFactor.h:68-134); bias correction, prediction and error follow
PreintegrationBase::{biasCorrectedDelta (ManifoldPreintegration.cpp:112),
correctPIM (NavState.cpp:439), predict (PreintegrationBase.cpp:117),
computeError (:143)} as pure functions, so `torch.func.jacfwd` gives the
exact factor Jacobians.

Every function is written over leading batch dims. `preintegrate` replaces
the JAX package's `lax.scan` by a Python loop over the samples in which each
step advances K intervals at once: a whole drive's factors integrate in one
pass of S steps.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gtsam_petercdev_torch.device import as_float, resolve_device
from gtsam_petercdev_torch.geometry import so3
from gtsam_petercdev_torch.navigation.navstate import NavState, local as ns_local, retract as ns_retract


class PreintegrationParams(NamedTuple):
    accel_cov: torch.Tensor  # [3,3] continuous-time accelerometer noise cov
    gyro_cov: torch.Tensor  # [3,3]
    integration_cov: torch.Tensor  # [3,3] position integration noise
    n_gravity: torch.Tensor  # [3] gravity in nav frame (e.g. (0,0,-9.81))
    # Combined variant only:
    bias_acc_cov: Optional[torch.Tensor] = None  # [3,3] random walk
    bias_omega_cov: Optional[torch.Tensor] = None  # [3,3]
    bias_acc_omega_init: Optional[torch.Tensor] = None  # [6,6] initial bias cov


def default_params(g: float = 9.81, accel_sigma=0.1, gyro_sigma=0.01,
                   integration_sigma=1e-4, dtype=torch.float64,
                   device="cuda") -> PreintegrationParams:
    """MakeSharedU analog (gravity along -z)."""
    dev = resolve_device(device)
    I3 = torch.eye(3, dtype=dtype, device=dev)
    return PreintegrationParams(
        accel_cov=I3 * accel_sigma**2,
        gyro_cov=I3 * gyro_sigma**2,
        integration_cov=I3 * integration_sigma**2,
        n_gravity=torch.tensor([0.0, 0.0, -g], dtype=dtype, device=dev),
        bias_acc_cov=I3 * 1e-3,
        bias_omega_cov=I3 * 1e-3,
        bias_acc_omega_init=torch.eye(6, dtype=dtype, device=dev) * 1e-5,
    )


class PIM(NamedTuple):
    """Preintegrated IMU measurements; every field has the same leading
    batch dims (none for one interval, [K] for K intervals)."""

    deltaR: torch.Tensor  # [..., 3, 3]
    deltaP: torch.Tensor  # [..., 3]
    deltaV: torch.Tensor  # [..., 3]
    delRdelBiasOmega: torch.Tensor  # [..., 3, 3]
    delPdelBiasAcc: torch.Tensor  # [..., 3, 3]
    delPdelBiasOmega: torch.Tensor  # [..., 3, 3]
    delVdelBiasAcc: torch.Tensor  # [..., 3, 3]
    delVdelBiasOmega: torch.Tensor  # [..., 3, 3]
    cov: torch.Tensor  # [..., 9, 9] (θ,p,v) preintegration covariance
    bias_hat: torch.Tensor  # [..., 6] (acc, gyro) used during integration
    deltaT: torch.Tensor  # [...] total time


def pim_init(bias_hat=None, dtype=torch.float64, device="cuda", batch_shape=()) -> PIM:
    """Empty PIM of `batch_shape` intervals (or bias_hat's leading dims)."""
    dev = resolve_device(device)
    if bias_hat is not None:
        bias_hat = as_float(bias_hat).to(device=dev, dtype=dtype)
        batch_shape = tuple(bias_hat.shape[:-1])
    batch_shape = tuple(batch_shape)

    def zeros(*shape):
        return torch.zeros(batch_shape + shape, dtype=dtype, device=dev)

    return PIM(
        deltaR=torch.eye(3, dtype=dtype, device=dev).expand(batch_shape + (3, 3)).clone(),
        deltaP=zeros(3),
        deltaV=zeros(3),
        delRdelBiasOmega=zeros(3, 3),
        delPdelBiasAcc=zeros(3, 3),
        delPdelBiasOmega=zeros(3, 3),
        delVdelBiasAcc=zeros(3, 3),
        delVdelBiasOmega=zeros(3, 3),
        cov=zeros(9, 9),
        bias_hat=zeros(6) if bias_hat is None else bias_hat,
        deltaT=zeros(),
    )


def _mT(x):
    return x.transpose(-1, -2)


def integrate_measurement(pim: PIM, params: PreintegrationParams, acc, omega, dt) -> PIM:
    """One IMU sample per interval (ManifoldPreintegration::update + cov
    propagation): acc, omega [..., 3], dt [...] (or a number), dt > 0."""
    dt = torch.as_tensor(dt, dtype=pim.cov.dtype, device=pim.cov.device)
    dtv, dtm = dt[..., None], dt[..., None, None]
    ba, bg = pim.bias_hat[..., :3], pim.bias_hat[..., 3:]
    a = acc - ba
    w = omega - bg
    wdt = w * dtv
    incrR = so3.expmap(wdt)
    Jr = so3.expmap_derivative(wdt)
    R = pim.deltaR
    Ra = so3.rotate(R, a)

    dt22v, dt22m = 0.5 * dtv * dtv, 0.5 * dtm * dtm
    new_deltaP = pim.deltaP + pim.deltaV * dtv + Ra * dt22v
    new_deltaV = pim.deltaV + Ra * dtv
    new_deltaR = R @ incrR

    aH = so3.hat(a)
    RaH = R @ aH  # deltaR_old * [a]x
    new_delPdelBiasAcc = pim.delPdelBiasAcc + pim.delVdelBiasAcc * dtm - R * dt22m
    new_delPdelBiasOmega = (
        pim.delPdelBiasOmega + pim.delVdelBiasOmega * dtm - dt22m * (RaH @ pim.delRdelBiasOmega)
    )
    new_delVdelBiasAcc = pim.delVdelBiasAcc - R * dtm
    new_delVdelBiasOmega = pim.delVdelBiasOmega - dtm * (RaH @ pim.delRdelBiasOmega)
    new_delRdelBiasOmega = _mT(incrR) @ pim.delRdelBiasOmega - Jr * dtm

    # covariance propagation: cov' = A cov A^T + B (aCov/dt) B^T + C (wCov/dt) C^T
    I3 = torch.eye(3, dtype=R.dtype, device=R.device).expand(R.shape)
    Z3 = torch.zeros_like(R)
    A = torch.cat(
        [
            torch.cat([_mT(incrR), Z3, Z3], dim=-1),
            torch.cat([-RaH * dt22m, I3, I3 * dtm], dim=-1),
            torch.cat([-RaH * dtm, Z3, I3], dim=-1),
        ],
        dim=-2,
    )
    B = torch.cat([Z3, R * dt22m, R * dtm], dim=-2)  # [..., 9, 3] wrt acc noise
    C = torch.cat([Jr * dtm, Z3, Z3], dim=-2)  # [..., 9, 3] wrt gyro noise
    cov = (
        A @ pim.cov @ _mT(A)
        + B @ (params.accel_cov / dtm) @ _mT(B)
        + C @ (params.gyro_cov / dtm) @ _mT(C)
    )
    # the JAX package's .at[3:6, 3:6].add, out of place
    cov = cov + torch.nn.functional.pad(params.integration_cov * dtm, (3, 3, 3, 3))

    return pim._replace(
        deltaR=new_deltaR,
        deltaP=new_deltaP,
        deltaV=new_deltaV,
        delRdelBiasOmega=new_delRdelBiasOmega,
        delPdelBiasAcc=new_delPdelBiasAcc,
        delPdelBiasOmega=new_delPdelBiasOmega,
        delVdelBiasAcc=new_delVdelBiasAcc,
        delVdelBiasOmega=new_delVdelBiasOmega,
        cov=cov,
        deltaT=pim.deltaT + dt,
    )


def preintegrate(params: PreintegrationParams, acc, omega, dts, bias_hat=None) -> PIM:
    """Integrate sample streams: one [S, 3] stream (acc, omega [S, 3], dts
    [S]: the JAX signature, an unbatched PIM) or K intervals at once (acc,
    omega [K, S, 3], dts [K, S]; bias_hat [6] or [K, 6]: a PIM of [K]).

    A loop of S steps, each advancing every interval by one sample. So every
    interval of a batch has the same number S of samples, and each dt > 0:
    the noise terms divide by it (`accel_cov / dt`). Ragged streams are out
    of scope. The tensors stay on their device; nothing is copied."""
    acc = as_float(acc)
    omega = as_float(omega, acc)
    dts = as_float(dts, acc)
    single = acc.ndim == 2
    if single:
        acc, omega, dts = acc[None], omega[None], dts[None]
    K = acc.shape[0]
    if bias_hat is not None:
        bias_hat = as_float(bias_hat, acc).expand(K, 6)
    pim = pim_init(bias_hat, dtype=acc.dtype, device=acc.device, batch_shape=(K,))
    for s in range(acc.shape[1]):
        pim = integrate_measurement(pim, params, acc[:, s], omega[:, s], dts[:, s])
    if single:
        pim = PIM(*(f[0] for f in pim))
    return pim


# --- bias correction, prediction, error --------------------------------------


def _mv(M, x):
    return (M @ x[..., None])[..., 0]


def bias_corrected_delta(pim: PIM, bias):
    """ManifoldPreintegration::biasCorrectedDelta (first-order in bias incr)."""
    incr = bias - pim.bias_hat
    dba, dbg = incr[..., :3], incr[..., 3:]
    corrected_R = pim.deltaR @ so3.expmap(_mv(pim.delRdelBiasOmega, dbg))
    theta = so3.logmap(corrected_R)
    dP = pim.deltaP + _mv(pim.delPdelBiasAcc, dba) + _mv(pim.delPdelBiasOmega, dbg)
    dV = pim.deltaV + _mv(pim.delVdelBiasAcc, dba) + _mv(pim.delVdelBiasOmega, dbg)
    return torch.cat([theta, dP, dV], dim=-1)


def correct_pim(state: NavState, xi, dt, n_gravity):
    """NavState::correctPIM (NavState.cpp:439): add gravity + initial velocity.
    dt [...] (the intervals' deltaT)."""
    dtv = as_float(dt, xi)[..., None]
    dt22 = 0.5 * dtv * dtv
    dP = xi[..., 3:6] + dtv * so3.unrotate(state.R, state.v) + dt22 * so3.unrotate(state.R, n_gravity)
    dV = xi[..., 6:9] + dtv * so3.unrotate(state.R, n_gravity)
    return torch.cat([xi[..., :3], dP, dV], dim=-1)


def predict(pim: PIM, params: PreintegrationParams, state: NavState, bias) -> NavState:
    """PreintegrationBase::predict."""
    xi = bias_corrected_delta(pim, bias)
    xi = correct_pim(state, xi, pim.deltaT, params.n_gravity)
    return ns_retract(state, xi)


def compute_error(pim: PIM, params: PreintegrationParams,
                  state_i: NavState, state_j: NavState, bias):
    """PreintegrationBase::computeError: local(state_j, predict(state_i))."""
    predicted = predict(pim, params, state_i, bias)
    return ns_local(state_j, predicted)
